// Fused bucket CG (K3) of the bucketed sparse ALS engine, for Hopper (sm_90a).
//
//   cmf_bucket_cg: for every padded row r of one bucket, warm-started truncated CG on
//
//     (gfix + diag(lam_row_r) + sum_l cw[r,l] m_l m_l^T) a_r = r0_r + sum_l cv[r,l] m_l,
//     m_l = mat[idx[r,l]],
//
//   from a0_r for n_steps steps.  mat:[S,K] is bf16 (CG bulk iterations) or f32;
//   idx:[R,L] int32; cw, cv:[R,L] f32 (zero on padding slots); gfix:[K,K] f32
//   symmetric; lam_row, r0 (optional), a0 and out:[R,K] f32; length:[R] int32 real
//   slots per row.
//
// It replaces cmfrec_tpu/ops/sparse_cg.py::bucket_cg (Pallas body _cg_kernel) and
// ::bucket_cg_packed (_cg_kernel_packed, a TPU lane packing for K <= 64 with no
// Hopper counterpart: this kernel takes any K that is a multiple of 8, up to what a
// row's CG vectors leave of the opt-in shared memory).
// The TPU kernel took a slab ms[R,L,K] gathered by XLA; this one gathers each m_l
// itself from the index array.
//
// Numerics follow the plain twin (cmfrec_torch/ops/sparse_cg.py::bucket_cg_ref, the
// rounding points of rowsolve._part_matvec): with a bf16 mat the direction v,
// t_l = (m_l . v) * cw_l and cv_l are rounded to bf16 where they meet m_l; every
// product is an f32 FMA (no tensor cores) and every sum f32, in a fixed order, so two
// launches on the same inputs give the same bits.  Stop rule of
// rowsolve.cg_iterations: a row is live iff its initial r.r > 1e-12 and freezes once
// r.r <= 1e-8; the remaining steps of a frozen row are exact no-ops, so it leaves
// the loop.
//
// What bounds it on an H100: bytes.  Each slot needs idx, cw and cv (12 B) and its
// gathered row (2K B in bf16) once, against ~(n_steps+2)*4K flops a slot (~9 flop/B
// at K=56); the 2K^2 flops of gfix v a row and pass weigh in the narrow buckets.  The
// first design (one block of 4-16 warps a row, gfix read through L2 by K threads, a
// single warp for the CG scalars, rows staged only under 40 KB) ran at 2.7% of that
// bound on the LastFM-shaped layout: the widest buckets (40 rows) left most SMs idle,
// the narrowest (60k-100k rows at L = 32-48) spent their time on barriers and gfix,
// and every wider row re-gathered its slots from L2 on all four passes.
//
// This design: one kernel, three bucket classes, which the wrapper picks from
// (R, L, K) (ops/sparse_cg.py: k3_plan):
//   narrow  (L <= 128): a warp a row, 8 rows a block; the CG scalars are warp
//           shuffles, no block barrier after the start;
//   middle: a block of 4 or 8 warps a row;
//   wide    (few rows): a thread-block cluster of 2-8 blocks a row, each block over a
//           contiguous range of the row's slots; after each pass the blocks' partial
//           [K] sums meet through distributed shared memory, added in rank order after
//           a cluster barrier, and every rank carries the same CG state (same inputs,
//           same order: the same bits), rank 0 writing the result.
// In all classes gfix sits in shared memory (K <= 96; wider K reads it through L1),
// staged once a block: the blocks the card holds at once walk the rows.  A row's
// slots are staged in shared memory on the first pass and read there on the later
// ones whenever they fit the team's share of the block's budget, which the planner
// sizes for two blocks an SM; longer rows re-gather.  Inside a pass, a warp takes
// four slots at once, 8 lanes a slot, each lane 16 bytes of the row (8 bf16 or 4 f32
// coordinates), with 1-4 such groups of slots in flight and the next groups' idx and
// cw already loaded: a slot's dot product is 3 shuffles of 8 lanes, and its partial
// sums stay in registers until the end of the pass.
//
// Past K = kTiledMaxK (256) the per-lane register arrays of a pass (NP = K / 32 or
// K / 64 pieces of 16 bytes) would spill, so the planner sends every bucket to a
// block a row (middle or wide, narrow rows too), and a pass takes one slot a warp:
// the 32 lanes walk the row's 16-byte pieces, the slot's dot product is a warp sum,
// and the warp's running sums red[0:K] (red[K:2K]) stay in shared memory, each lane
// adding into its own pieces (slot_pass_loop, NP = 0).  A simple design for
// correctness at any K; the row's vectors in shared memory, (8 + 2 warps) K floats,
// set the limit.
//
// Class boundaries, from phase 6 of chip_smoke.py at the LastFM-shaped layout (K=56):
// a warp a row serves the 60k-100k-row buckets at L = 32-48 best, since it keeps
// every scalar in shuffles and needs no barrier; up to L = 128 the eight rows of a
// block still stage whole (or nearly) within the two-blocks-an-SM budget, and a
// smaller budget for three blocks an SM read no faster.  A cluster serves a bucket
// whose rows alone would leave the card under two blocks an SM (the widest
// buckets hold 40-400 rows), or whose rows would not stage in one block.  Where the
// time goes after this design: the narrow buckets (more than half of a WRMF
// iteration), whose warps issue ~20 instructions a slot and pass around 2K FMAs and
// the K^2 of gfix v a row; the bound counts only bytes.
//
// Build: with masked_matmul.cu into libcmfrec_kernels (cmfrec_torch/ops/_cuda.py):
//        nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c -Xcompiler -fPIC

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cgs = cooperative_groups;

namespace {

constexpr float kSkipTol = 1e-12f;
constexpr float kFreezeTol = 1e-8f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
constexpr int kGfixSmemMaxK = 96;  // gfix in shared memory up to this K (36 KB)
constexpr int kTiledMaxK = 256;    // register-tiled passes up to this K; past it, loops

// Shared memory of one launch (ops/sparse_cg.py: smem_bytes computes the same):
// [gfix K x K f32, if K <= kGfixSmemMaxK] [teams x team vectors] [teams x stage]
__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline size_t team_floats(int K, int tw) {
  return static_cast<size_t>(8 + 2 * tw) * K + 32;  // a r p q, red[tw][2K], part[2][2K], scal
}
__host__ __device__ inline size_t base_bytes(int K, int teams, int tw) {
  const size_t g = K <= kGfixSmemMaxK ? static_cast<size_t>(K) * K : 0;
  return align16((g + teams * team_floats(K, tw)) * sizeof(float));
}
__host__ __device__ inline size_t stage_bytes(int slots, int K, int esz) {
  return align16(static_cast<size_t>(slots) * (static_cast<size_t>(K) * esz + 4));
}

struct Params {
  const void* mat;
  const int* idx;
  const float* cw;
  const float* cv;
  const float* gfix;
  const float* lam_row;  // may be null
  const float* r0;       // may be null
  const float* a0;
  const int* length;
  float* out;
  int R, L, K, n_steps;
  int cluster;      // blocks a row (1: no cluster)
  int stage_slots;  // slots a team may stage in shared memory
};

// 16 bytes of a row of mat, widened: 8 bf16 or 4 f32 coordinates.
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int n = 4;
  static __device__ __forceinline__ void widen(const uint4& v, float* x) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <> struct Vec<uint16_t> {  // bf16 bits
  static constexpr int n = 8;
  static __device__ __forceinline__ void widen(const uint4& v, float* x) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[2 * e] = __uint_as_float(u[e] << 16);
      x[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

enum Stage { kNoStage = 0, kWriteStage = 1, kReadStage = 2 };

// One pass of warp `wt` of a team of `tw` warps over the slots [lo, hi) of its row with
// direction v (shared memory, f32): red[0:K] = this warp's sum of t_l m_l,
// t_l = round(round(v) . m_l * cw_l), and (RHS) red[K:2K] = its sum of round(cv_l) m_l.
// Lane = 8 * grp + sub: slot group grp (of 4), coordinates i * 8 * CPL + sub * CPL + e.
template <typename T, int NP, bool RHS, int MODE>
__device__ __forceinline__ void slot_pass(const T* __restrict__ mat, const int* __restrict__ idx_r,
                                          const float* __restrict__ cw_r,
                                          const float* __restrict__ cv_r, const float* v,
                                          float* red, T* slab, float* scw,
                                          int lo, int hi, int K, int wt, int tw) {
  using V = Vec<T>;
  constexpr int CPL = V::n, SW = 8 * CPL;
  constexpr int U = NP == 1 ? 4 : (NP == 2 ? 2 : 1);  // slot groups in flight
  const int lane = threadIdx.x & 31, grp = lane >> 3, sub = lane & 7;

  float vr[NP][CPL];
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int e = 0; e < CPL; ++e) {
      const int c = i * SW + sub * CPL + e;
      vr[i][e] = c < K ? V::round(v[c]) : 0.f;
    }
  float acc[NP][CPL] = {}, racc[RHS ? NP : 1][CPL] = {};
  const int stride = tw * 4 * U;
  // gathering passes fetch the next iteration's idx, cw (and cv) while this
  // iteration's rows load and compute, so a row's load waits on one latency
  int nidx[U];
  float nw[U], ncv[U];
  auto fetch = [&](int l0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = l0 + 4 * u + grp;
      const bool ok = l < hi;
      nidx[u] = ok ? __ldg(idx_r + l) : 0;
      nw[u] = ok ? __ldg(cw_r + l) : 0.f;
      if constexpr (RHS) ncv[u] = ok ? __ldg(cv_r + l) : 0.f;
    }
  };
  if constexpr (MODE != kReadStage) fetch(lo + wt * 4 * U);
  for (int l0 = lo + wt * 4 * U; l0 < hi; l0 += stride) {
    float x[U][NP][CPL], w[U], cvl[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = l0 + 4 * u + grp;
      const bool ok = l < hi;
      uint4 m[NP];
      w[u] = 0.f;
      cvl[u] = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) m[i] = make_uint4(0, 0, 0, 0);
      if (ok) {
        if constexpr (MODE == kReadStage) {
          const T* src = slab + static_cast<size_t>(l - lo) * K;
          w[u] = scw[l - lo];
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            const int c0 = i * SW + sub * CPL;
            if (c0 < K) m[i] = *reinterpret_cast<const uint4*>(src + c0);
          }
        } else {
          const T* src = mat + static_cast<size_t>(nidx[u]) * K;
          w[u] = nw[u];
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            const int c0 = i * SW + sub * CPL;
            if (c0 < K) m[i] = __ldg(reinterpret_cast<const uint4*>(src + c0));
          }
          if constexpr (RHS) cvl[u] = ncv[u];
        }
        if constexpr (MODE == kWriteStage) {
          T* dst = slab + static_cast<size_t>(l - lo) * K;
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            const int c0 = i * SW + sub * CPL;
            if (c0 < K) *reinterpret_cast<uint4*>(dst + c0) = m[i];
          }
          if (sub == 0) scw[l - lo] = w[u];
        }
      }
#pragma unroll
      for (int i = 0; i < NP; ++i) V::widen(m[i], x[u][i]);
    }
    if constexpr (MODE != kReadStage) fetch(l0 + stride);
    float d[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      d[u] = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int e = 0; e < CPL; ++e) d[u] = fmaf(x[u][i][e], vr[i][e], d[u]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) d[u] += __shfl_xor_sync(kFull, d[u], o);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float t = V::round(d[u] * w[u]);
      const float cr = V::round(cvl[u]);
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int e = 0; e < CPL; ++e) {
          acc[i][e] = fmaf(t, x[u][i][e], acc[i][e]);
          if constexpr (RHS) racc[i][e] = fmaf(cr, x[u][i][e], racc[i][e]);
        }
    }
  }
  // the four slot groups' sums, in a fixed order
#pragma unroll
  for (int i = 0; i < NP; ++i)
#pragma unroll
    for (int e = 0; e < CPL; ++e) {
      acc[i][e] += __shfl_xor_sync(kFull, acc[i][e], 8);
      acc[i][e] += __shfl_xor_sync(kFull, acc[i][e], 16);
      if constexpr (RHS) {
        racc[i][e] += __shfl_xor_sync(kFull, racc[i][e], 8);
        racc[i][e] += __shfl_xor_sync(kFull, racc[i][e], 16);
      }
    }
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        const int c = i * SW + sub * CPL + e;
        if (c < K) {
          red[c] = acc[i][e];
          if constexpr (RHS) red[K + c] = racc[i][e];
        }
      }
  }
}

// slot_pass's work past kTiledMaxK: warp `wt` takes slots lo + wt, lo + wt + tw, ...
// one at a time, lane `lane` the row's 16-byte pieces c0 = CPL * lane + 32 * CPL * i,
// and sums t_l m_l (and round(cv_l) m_l) into red in shared memory, slot by slot.
template <typename T, bool RHS, int MODE>
__device__ __forceinline__ void slot_pass_loop(const T* __restrict__ mat,
                                               const int* __restrict__ idx_r,
                                               const float* __restrict__ cw_r,
                                               const float* __restrict__ cv_r, const float* v,
                                               float* red, T* slab, float* scw, int lo, int hi,
                                               int K, int wt, int tw) {
  using V = Vec<T>;
  constexpr int CPL = V::n;
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < (RHS ? 2 * K : K); c += 32) red[c] = 0.f;
  __syncwarp();
  for (int l = lo + wt; l < hi; l += tw) {
    const T* src;
    float w, cvl = 0.f;
    if constexpr (MODE == kReadStage) {
      src = slab + static_cast<size_t>(l - lo) * K;
      w = scw[l - lo];
    } else {
      src = mat + static_cast<size_t>(__ldg(idx_r + l)) * K;
      w = __ldg(cw_r + l);
      if constexpr (RHS) cvl = __ldg(cv_r + l);
    }
    T* dst = slab + static_cast<size_t>(l - lo) * K;
    float d = 0.f;
    for (int c0 = CPL * lane; c0 < K; c0 += 32 * CPL) {
      const uint4 m = MODE == kReadStage ? *reinterpret_cast<const uint4*>(src + c0)
                                         : __ldg(reinterpret_cast<const uint4*>(src + c0));
      if constexpr (MODE == kWriteStage) *reinterpret_cast<uint4*>(dst + c0) = m;
      float x[CPL];
      V::widen(m, x);
#pragma unroll
      for (int e = 0; e < CPL; ++e) d = fmaf(x[e], V::round(v[c0 + e]), d);
    }
    d = warp_sum(d);
    if (MODE == kWriteStage && lane == 0) scw[l - lo] = w;
    const float t = V::round(d * w);
    const float cr = V::round(cvl);
    for (int c0 = CPL * lane; c0 < K; c0 += 32 * CPL) {
      // the lane's own pieces again: from the stage it wrote, or through L1
      const uint4 m = MODE == kNoStage ? __ldg(reinterpret_cast<const uint4*>(src + c0))
                                       : *reinterpret_cast<const uint4*>(dst + c0);
      float x[CPL];
      V::widen(m, x);
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        red[c0 + e] = fmaf(t, x[e], red[c0 + e]);
        if constexpr (RHS) red[K + c0 + e] = fmaf(cr, x[e], red[K + c0 + e]);
      }
    }
  }
}

// One pass over the slots [lo, hi): slot_pass's register tiles (NP > 0) or, past
// kTiledMaxK, slot_pass_loop (NP = 0).
template <typename T, int NP, bool RHS, int MODE>
__device__ __forceinline__ void run_pass(const T* __restrict__ mat, const int* __restrict__ idx_r,
                                         const float* __restrict__ cw_r,
                                         const float* __restrict__ cv_r, const float* v,
                                         float* red, T* slab, float* scw, int lo, int hi, int K,
                                         int wt, int tw) {
  if constexpr (NP == 0)
    slot_pass_loop<T, RHS, MODE>(mat, idx_r, cw_r, cv_r, v, red, slab, scw, lo, hi, K, wt, tw);
  else
    slot_pass<T, NP, RHS, MODE>(mat, idx_r, cw_r, cv_r, v, red, slab, scw, lo, hi, K, wt, tw);
}

// One row's CG, by its team (and, with C > 1, the cluster's other blocks).  Each
// thread of the team owns coordinate pairs (c, c+1), c = 2 * (tt + tn * i), in every
// K-vector operation.
template <typename T, int NP, bool WR>
__device__ __forceinline__ void cg_row(const Params& P, int row, int rank, int tw, int tt,
                                       int tn, int wt, int lane, int warp, const float* G,
                                       float* s_a, float* s_r, float* s_p, float* s_q,
                                       float* s_red, float* s_part, float* s_scal, T* slab,
                                       float* scw) {
  const int K = P.K, C = P.cluster;
  const T* mat = static_cast<const T*>(P.mat);
  const int len = min(P.length[row], P.L);
  int lo = 0, hi = len;
  if (C > 1) {
    const int per = (len + C - 1) / C;
    lo = min(len, rank * per);
    hi = min(len, lo + per);
  }
  const bool staged = hi - lo <= P.stage_slots;
  const size_t rL = static_cast<size_t>(row) * P.L, rK = static_cast<size_t>(row) * K;
  const int* idx_r = P.idx + rL;
  const float* cw_r = P.cw + rL;
  const float* cv_r = P.cv + rL;
  const float* lam_r = P.lam_row ? P.lam_row + rK : nullptr;
  const float* r0_r = P.r0 ? P.r0 + rK : nullptr;

  auto f2 = [](const float* p) { return *reinterpret_cast<const float2*>(p); };
  auto st2 = [](float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; };
  auto team_sync = [&]() {
    if constexpr (WR) __syncwarp(); else __syncthreads();
  };
  auto team_sum = [&](float x) {
    x = warp_sum(x);
    if constexpr (WR) {
      __syncwarp();
      return x;
    }
    if (lane == 0) s_scal[warp] = x;
    __syncthreads();
    float s = 0.f;
    for (int w = 0; w < tw; ++w) s += s_scal[w];
    __syncthreads();
    return s;
  };
  // Sum the team's (and the cluster's) partials of one pass into the caller's
  // per-pair function f(c, mv, rhs); the cluster's in rank order.
  int buf = 0;
  auto combine = [&](bool rhs_too, auto&& f) {
    const int nv = rhs_too ? 2 : 1;
    for (int c = 2 * tt; c < K; c += 2 * tn) {
      float2 s[2] = {{0.f, 0.f}, {0.f, 0.f}};
      for (int w = 0; w < tw; ++w)
        for (int j = 0; j < nv; ++j) {
          const float2 x = f2(s_red + w * 2 * K + j * K + c);
          s[j].x += x.x;
          s[j].y += x.y;
        }
      if (C > 1) {
        for (int j = 0; j < nv; ++j) st2(s_part + buf * 2 * K + j * K + c, s[j]);
      } else {
        f(c, s[0], s[1]);
      }
    }
    if (C > 1) {
      cgs::cluster_group cluster = cgs::this_cluster();
      cluster.sync();
      for (int c = 2 * tt; c < K; c += 2 * tn) {
        float2 s[2] = {{0.f, 0.f}, {0.f, 0.f}};
        for (int q = 0; q < C; ++q) {
          const float* part = cluster.map_shared_rank(s_part, q) + buf * 2 * K;
          for (int j = 0; j < nv; ++j) {
            const float2 x = f2(part + j * K + c);
            s[j].x += x.x;
            s[j].y += x.y;
          }
        }
        f(c, s[0], s[1]);
      }
      buf ^= 1;
    }
  };
  // (v @ gfix)[c:c+2]: v four at a time, even and odd j in two chains
  auto gv = [&](const float* v, int c) {
    float2 e = {0.f, 0.f}, o = {0.f, 0.f};
    for (int j = 0; j < K; j += 4) {
      const float4 vj = *reinterpret_cast<const float4*>(v + j);
      const float2 g0 = f2(G + j * K + c), g1 = f2(G + (j + 1) * K + c);
      const float2 g2 = f2(G + (j + 2) * K + c), g3 = f2(G + (j + 3) * K + c);
      e.x = fmaf(g0.x, vj.x, e.x);
      e.y = fmaf(g0.y, vj.x, e.y);
      o.x = fmaf(g1.x, vj.y, o.x);
      o.y = fmaf(g1.y, vj.y, o.y);
      e.x = fmaf(g2.x, vj.z, e.x);
      e.y = fmaf(g2.y, vj.z, e.y);
      o.x = fmaf(g3.x, vj.w, o.x);
      o.y = fmaf(g3.y, vj.w, o.y);
    }
    return make_float2(e.x + o.x, e.y + o.y);
  };

  for (int c = 2 * tt; c < K; c += 2 * tn) st2(s_a + c, f2(P.a0 + rK + c));
  team_sync();

  // rhs and A a0 in one pass; r = rhs - A a0, p = r
  float* red = s_red + wt * 2 * K;
  if (staged)
    run_pass<T, NP, true, kWriteStage>(mat, idx_r, cw_r, cv_r, s_a, red, slab, scw, lo,
                                        hi, K, wt, tw);
  else
    run_pass<T, NP, true, kNoStage>(mat, idx_r, cw_r, cv_r, s_a, red, slab, scw, lo, hi,
                                     K, wt, tw);
  team_sync();
  float part = 0.f;
  combine(true, [&](int c, float2 mv, float2 rhs) {
    const float2 g = gv(s_a, c), a = f2(s_a + c);
    mv.x += g.x;
    mv.y += g.y;
    if (lam_r) {
      const float2 l = f2(lam_r + c);
      mv.x += l.x * a.x;
      mv.y += l.y * a.y;
    }
    if (r0_r) {
      const float2 b = f2(r0_r + c);
      rhs.x += b.x;
      rhs.y += b.y;
    }
    const float2 res = make_float2(rhs.x - mv.x, rhs.y - mv.y);
    st2(s_r + c, res);
    st2(s_p + c, res);
    part = fmaf(res.x, res.x, part);
    part = fmaf(res.y, res.y, part);
  });
  float rz = team_sum(part);
  bool live = rz > kSkipTol;

  for (int step = 0; step < P.n_steps && live; ++step) {
    if (staged)
      run_pass<T, NP, false, kReadStage>(mat, idx_r, cw_r, cv_r, s_p, red, slab, scw, lo,
                                          hi, K, wt, tw);
    else
      run_pass<T, NP, false, kNoStage>(mat, idx_r, cw_r, cv_r, s_p, red, slab, scw, lo,
                                        hi, K, wt, tw);
    team_sync();
    part = 0.f;
    combine(false, [&](int c, float2 q, float2) {
      const float2 g = gv(s_p, c), p = f2(s_p + c);
      q.x += g.x;
      q.y += g.y;
      if (lam_r) {
        const float2 l = f2(lam_r + c);
        q.x += l.x * p.x;
        q.y += l.y * p.y;
      }
      st2(s_q + c, q);
      part = fmaf(p.x, q.x, part);
      part = fmaf(p.y, q.y, part);
    });
    const float denom = team_sum(part);
    const float alpha = rz / (denom == 0.f ? 1.f : denom);
    part = 0.f;
    for (int c = 2 * tt; c < K; c += 2 * tn) {
      const float2 p = f2(s_p + c), q = f2(s_q + c), a = f2(s_a + c), r = f2(s_r + c);
      st2(s_a + c, make_float2(a.x + alpha * p.x, a.y + alpha * p.y));
      const float2 res = make_float2(r.x - alpha * q.x, r.y - alpha * q.y);
      st2(s_r + c, res);
      part = fmaf(res.x, res.x, part);
      part = fmaf(res.y, res.y, part);
    }
    const float rz_new = team_sum(part);
    live = rz_new > kFreezeTol;
    if (live) {
      const float beta = rz_new / (rz == 0.f ? 1.f : rz);
      for (int c = 2 * tt; c < K; c += 2 * tn) {
        const float2 p = f2(s_p + c), r = f2(s_r + c);
        st2(s_p + c, make_float2(r.x + beta * p.x, r.y + beta * p.y));
      }
      rz = rz_new;
    }
    team_sync();
  }
  if (rank == 0)
    for (int c = 2 * tt; c < K; c += 2 * tn) st2(P.out + rK + c, f2(s_a + c));
}

// WR: a warp a row (8 rows a block), else a block (or cluster) a row.
template <typename T, int NP, bool WR>
__global__ void __launch_bounds__(kMaxThreads)
    bucket_cg_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = P.K, C = P.cluster;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tw = WR ? 1 : nw;            // warps of a team (one row)
  const int teams = WR ? nw : 1;
  const int team = WR ? warp : 0;
  const int tt = WR ? lane : threadIdx.x;  // thread of the team
  const int tn = 32 * tw;
  const int wt = WR ? 0 : warp;            // warp of the team

  const bool gsm = K <= kGfixSmemMaxK;
  float* s_gfix = reinterpret_cast<float*>(smem);
  float* tb = s_gfix + (gsm ? K * K : 0) + team * team_floats(K, tw);
  float* s_a = tb;
  float* s_r = tb + K;
  float* s_p = tb + 2 * K;
  float* s_q = tb + 3 * K;
  float* s_red = tb + 4 * K;         // [tw][2K]
  float* s_part = s_red + tw * 2 * K;  // [2][2K], read by the cluster's other blocks
  float* s_scal = s_part + 4 * K;    // [tw]
  const size_t sb = stage_bytes(P.stage_slots, K, sizeof(T));
  unsigned char* stage = smem + base_bytes(K, teams, tw) + team * sb;
  T* slab = reinterpret_cast<T*>(stage);
  float* scw = reinterpret_cast<float*>(stage + static_cast<size_t>(P.stage_slots) * K * sizeof(T));

  if (gsm) {  // all copies in flight at once, one wait
    for (int i = threadIdx.x; i < K * K / 4; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(s_gfix + 4 * i))),
                   "l"(P.gfix + 4 * i)
                   : "memory");
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();  // in WR mode the only block-wide barrier

  // Resident blocks walk the rows (a cluster takes one row): gfix is
  // staged once a block, not once a row.
  const int rank = WR ? 0 : blockIdx.x % C;
  const int stride = WR ? gridDim.x * nw : gridDim.x / C;
  for (int row = WR ? blockIdx.x * nw + warp : blockIdx.x / C; row < P.R; row += stride)
    cg_row<T, NP, WR>(P, row, rank, tw, tt, tn, wt, lane, warp, gsm ? s_gfix : P.gfix, s_a, s_r,
                      s_p, s_q, s_red, s_part, s_scal, slab, scw);
  if (C > 1) cgs::this_cluster().sync();  // no block leaves while others read its part
}

template <typename T, int NP>
cudaError_t launch(const Params& P, int threads, int warp_rows, cudaStream_t st) {
  if (threads % 32 || threads < 32 || threads > kMaxThreads || P.cluster < 1 || P.cluster > 8 ||
      P.stage_slots < 0 || (warp_rows && P.cluster != 1))
    return cudaErrorInvalidValue;
  const int nw = threads / 32;
  const int teams = warp_rows ? nw : 1, tw = warp_rows ? 1 : nw;
  const size_t smem = base_bytes(P.K, teams, tw) + teams * stage_bytes(P.stage_slots, P.K, sizeof(T));
  const void* kernel;
  if constexpr (NP == 0) {  // past kTiledMaxK: a block (or cluster) a row only
    if (warp_rows) return cudaErrorInvalidValue;
    kernel = reinterpret_cast<const void*>(bucket_cg_kernel<T, 0, false>);
  } else {
    kernel = warp_rows ? reinterpret_cast<const void*>(bucket_cg_kernel<T, NP, true>)
                       : reinterpret_cast<const void*>(bucket_cg_kernel<T, NP, false>);
  }
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && smem > static_cast<size_t>(optin)) err = cudaErrorInvalidValue;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  // without a cluster, at most the blocks the card holds at once (they walk the rows)
  int grid = warp_rows ? (P.R + nw - 1) / nw : P.R * P.cluster, per_sm = 0, sms = 0;
  if (err == cudaSuccess && P.cluster == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err == cudaSuccess && P.cluster == 1)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (P.cluster == 1 && per_sm > 0) grid = min(grid, per_sm * sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = P.cluster > 1 ? 1 : 0;
  void* args[] = {const_cast<Params*>(&P)};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

template <typename T>
cudaError_t dispatch(const Params& P, int threads, int warp_rows, cudaStream_t st) {
  constexpr int SW = 8 * Vec<T>::n;
  if (P.K > kTiledMaxK) return launch<T, 0>(P, threads, warp_rows, st);
  switch ((P.K + SW - 1) / SW) {
    case 1: return launch<T, 1>(P, threads, warp_rows, st);
    case 2: return launch<T, 2>(P, threads, warp_rows, st);
    case 3: return launch<T, 3>(P, threads, warp_rows, st);
    case 4: return launch<T, 4>(P, threads, warp_rows, st);
    default:
      if constexpr (SW == 32) {
        switch ((P.K + SW - 1) / SW) {
          case 5: return launch<T, 5>(P, threads, warp_rows, st);
          case 6: return launch<T, 6>(P, threads, warp_rows, st);
          case 7: return launch<T, 7>(P, threads, warp_rows, st);
          case 8: return launch<T, 8>(P, threads, warp_rows, st);
        }
      }
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (bound with ctypes).  The caller guarantees K % 8 == 0, K >= 8 (past
// 256 a block or cluster a row, warp_rows 0), R >= 1, L >= 1, contiguous row-major tensors on the current device, 16-byte-aligned
// base pointers and idx values in [0, S).  lam_row and r0 may be null.  The launch
// plan: `threads` a block (32-256), warp_rows (a warp a row, 8 rows a block of 256)
// or a block of `threads` a row in clusters of `cluster` blocks (1-8), and up to
// `stage_slots` slots a row (or a cluster rank's range) staged in shared memory.
// Returns the launch's cudaError_t (0 on success); the kernel runs asynchronously on
// `stream`.
extern "C" int cmf_bucket_cg(const void* mat, const void* idx, const void* cw, const void* cv,
                             const void* gfix, const void* lam_row, const void* r0,
                             const void* a0, const void* length, void* out, int R, int L, int K,
                             int n_steps, int mat_f32, int threads, int warp_rows, int cluster,
                             int stage_slots, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params P{mat, static_cast<const int*>(idx), static_cast<const float*>(cw),
                 static_cast<const float*>(cv), static_cast<const float*>(gfix),
                 static_cast<const float*>(lam_row), static_cast<const float*>(r0),
                 static_cast<const float*>(a0), static_cast<const int*>(length),
                 static_cast<float*>(out), R, L, K, n_steps, cluster, stage_slots};
  return static_cast<int>(mat_f32 ? dispatch<float>(P, threads, warp_rows, st)
                                  : dispatch<uint16_t>(P, threads, warp_rows, st));
}
