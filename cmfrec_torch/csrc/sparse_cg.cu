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
// Past K = kTiledMaxK (256) the per-lane register arrays of slot_pass (NP = K / 32 or
// K / 64 pieces of 16 bytes) would spill.  Up to kRowsMaxK (1024) the rows design
// (bucket_cg_rows_kernel, below) takes over: several rows a block share each read of
// gfix, and a warp's slot sums stay in registers with a lane's pieces along the row.
// Past it the loop design: a block (or cluster) a row, a pass one slot a warp, the 32
// lanes walking the row's 16-byte pieces, the slot's dot product a warp sum, and the
// warp's running sums red[0:K] (red[K:2K]) in shared memory, each lane adding into its
// own pieces (slot_pass_loop, NP = 0); the row's vectors in shared memory, (8 + 2
// warps) K floats, set its limit (ops/sparse_cg.py: k_fits).  The loop design reads
// 22.1 ms at K = 304 on phase 30's rows of chip_smoke.py, 12.7 of it in its slot
// passes and 8.3 in gfix v (scripts/time_k3_wide_torch.py, NVIDIA H100 80GB HBM3,
// 700 W), where the rows design reads 3.5.
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

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

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
  int rows;         // past kTiledMaxK: rows a block of the rows design (0: the loop design)
};

// Probe builds past kTiledMaxK leave one part of the work out, so that
// scripts/time_k3_wide_torch.py can split a launch's time (their results are not
// K3's): no slot passes (the slot sums are zero), no gfix v, and no stop rule (every
// row runs every step, so that the variants do the same steps).  A probe build is this
// file compiled alone with -DCMF_K3_PROBE=<bits> (ops/_cuda.py: probe_libs); the
// library of the ops is compiled without it, and kProbe is 0 there.
constexpr int kProbeNoSlots = 1;
constexpr int kProbeNoGv = 2;
constexpr int kProbeNoStop = 4;
#ifndef CMF_K3_PROBE
#define CMF_K3_PROBE 0
#endif
constexpr int kProbe = CMF_K3_PROBE;

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
  if constexpr ((kProbe & kProbeNoSlots) != 0) return;
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
  constexpr bool no_stop = NP == 0 && (kProbe & kProbeNoStop) != 0;
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
    if constexpr (NP == 0 && (kProbe & kProbeNoGv) != 0) return e;
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
  bool live = rz > kSkipTol || no_stop;

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
    live = rz_new > kFreezeTol || no_stop;
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

// ------------------------------------------------------------------ rows design
// Past kTiledMaxK up to kRowsMaxK.  A block holds `rows` rows (1, 2, 4 or 8), each
// by a team of the block's warps / rows warps (a warp a row in the narrow class); a
// row of the wide class is a cluster's, one row a block, each rank over a range of its
// slots.  The block's rows run their CG in step, so that each pass forms v gfix for
// all of them at once: thread t owns the column pairs c = 2 (t + blockDim.x i) of
// every row, and each float2 of gfix it reads from L2 serves `rows` rows (gfix is read
// once a block and pass, not once a row and pass, by every thread).  Rows that skip or
// freeze stay in the block's barriers, their updates skipped.
//
// A pass over a row's slots: a warp takes U slots at once, its 32 lanes over each
// slot's 16-byte pieces (lane's pieces lane + 32 i, NP of them, the row's K <= KMAX),
// each piece held in registers between the slot's dot product (a warp sum) and its
// accumulation, so it is read once a pass; the next U slots' idx, cw (and cv) are in
// flight meanwhile.  The slot sums stay in registers for the whole pass and are
// written once, to the warp's red[K] in shared memory.  The first stage_slots slots of
// a row (or rank range) are staged in shared memory on the first pass and read there
// on the later ones; the rest re-gather.
//
// What bounds it: operations, the 2K^2 f32 FMAs of gfix v a row and pass against the
// slots' bytes; what limits it on an H100 (scripts/time_k3_wide_torch.py): at K = 304
// the slot passes' gathers (2/3 of a launch), at K = 1024 gfix's reads from L2, once a
// block and pass (half of a launch), at ~4.4-4.8 TB/s.  At K < 2 blockDim.x part of
// the block idles in gv_rows; a version that gave every thread work (four lanes a
// column pair, each over a quarter of j, added by shuffles) read slower, 4.3 against
// 3.9 ms at K = 304 and 22.9 against 19.0 at K = 1024 on phase 30's rows, so the L2's
// rate, not the idle threads, limits it.
//
// Shared memory (ops/sparse_cg.py: rows_smem_bytes): a, r, p [rows][K]; red [warps][K]
// (a team's first warp's red holds q after the pass's combine); with a cluster part
// [2][K]; scal [2][warps][rows]; rz [kMaxRows]; then each team's stage.
constexpr int kRowsMaxK = 1024;
constexpr int kMaxRows = 8;

__host__ __device__ inline size_t rows_base_bytes(int K, int rows, int nw, int cluster) {
  const size_t f =
      static_cast<size_t>(3 * rows + nw + (cluster > 1 ? 2 : 0)) * K + 2 * nw * rows + kMaxRows;
  return align16(f * sizeof(float));
}

// Slots [lo, hi) of a row by warp wt of its team of tw warps, slot l staged at slab
// index l - s0: acc += t_l m_l, t_l = round(round(v) . m_l * cw_l) (vr: round(v) at the
// lane's pieces), and (RHS) racc += round(cv_l) m_l.  The warp takes U slots at once
// and keeps two such groups in flight: the next group's pieces load while this one's
// are summed, and the idx, cw (and cv) of the group after it load meanwhile.
template <typename T, int NP, int U, bool RHS, int MODE>
__device__ __forceinline__ void rows_pass(const T* __restrict__ mat, const int* __restrict__ idx_r,
                                          const float* __restrict__ cw_r,
                                          const float* __restrict__ cv_r,
                                          const float (&vr)[NP][Vec<T>::n],
                                          float (&acc)[NP][Vec<T>::n],
                                          float (&racc)[NP][Vec<T>::n], T* slab, float* scw,
                                          int lo, int hi, int s0, int K, int wt, int tw) {
  using V = Vec<T>;
  constexpr int CPL = V::n;
  const int lane = threadIdx.x & 31;
  const int stride = tw * U, first = lo + wt * U;
  if (first >= hi) return;
  int nidx[U];
  float nw[U], ncv[U];
  auto fetch = [&](int g0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = g0 + u;
      const bool ok = l < hi;
      nidx[u] = ok ? __ldg(idx_r + l) : 0;
      nw[u] = ok ? __ldg(cw_r + l) : 0.f;
      if constexpr (RHS) ncv[u] = ok ? __ldg(cv_r + l) : 0.f;
    }
  };
  // the pieces and coefficients of the group at g0 (zero past hi)
  auto load = [&](int g0, uint4 (&m)[U][NP], float (&w)[U], float (&cvl)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int l = g0 + u;
      w[u] = 0.f;
      cvl[u] = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) m[u][i] = make_uint4(0, 0, 0, 0);
      if (l < hi) {
        if constexpr (MODE == kReadStage) {
          const T* src = slab + static_cast<size_t>(l - s0) * K;
          w[u] = scw[l - s0];
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            const int c0 = (lane + 32 * i) * CPL;
            if (c0 < K) m[u][i] = *reinterpret_cast<const uint4*>(src + c0);
          }
        } else {
          const T* src = mat + static_cast<size_t>(nidx[u]) * K;
          w[u] = nw[u];
          if constexpr (RHS) cvl[u] = ncv[u];
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            const int c0 = (lane + 32 * i) * CPL;
            if (c0 < K) m[u][i] = __ldg(reinterpret_cast<const uint4*>(src + c0));
          }
        }
      }
    }
  };
  uint4 m[U][NP];
  float w[U], cvl[U];
  if constexpr (MODE != kReadStage) fetch(first);
  load(first, m, w, cvl);
  if constexpr (MODE != kReadStage) fetch(first + stride);
  for (int g0 = first; g0 < hi; g0 += stride) {
    uint4 mn[U][NP];
    float wn[U], cn[U];
    load(g0 + stride, mn, wn, cn);
    if constexpr (MODE != kReadStage) fetch(g0 + 2 * stride);
    if constexpr (MODE == kWriteStage)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int l = g0 + u;
        if (l < hi) {
          T* dst = slab + static_cast<size_t>(l - s0) * K;
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            const int c0 = (lane + 32 * i) * CPL;
            if (c0 < K) *reinterpret_cast<uint4*>(dst + c0) = m[u][i];
          }
          if (lane == 0) scw[l - s0] = w[u];
        }
      }
    float d[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      d[u] = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        float x[CPL];
        V::widen(m[u][i], x);
#pragma unroll
        for (int e = 0; e < CPL; ++e) d[u] = fmaf(x[e], vr[i][e], d[u]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) d[u] += __shfl_xor_sync(kFull, d[u], o);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float t = V::round(d[u] * w[u]);
      const float cr = V::round(cvl[u]);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        float x[CPL];
        V::widen(m[u][i], x);
#pragma unroll
        for (int e = 0; e < CPL; ++e) {
          acc[i][e] = fmaf(t, x[e], acc[i][e]);
          if constexpr (RHS) racc[i][e] = fmaf(cr, x[e], racc[i][e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      w[u] = wn[u];
      cvl[u] = cn[u];
#pragma unroll
      for (int i = 0; i < NP; ++i) m[u][i] = mn[u][i];
    }
  }
}

// round(v) at the lane's pieces of a row's vector v (shared memory)
template <typename T, int NP>
__device__ __forceinline__ void rows_load_v(const float* v, int K, float (&vr)[NP][Vec<T>::n]) {
  constexpr int CPL = Vec<T>::n;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c0 = (lane + 32 * i) * CPL;
#pragma unroll
    for (int e = 0; e < CPL; e += 4) {
      const float4 x = c0 < K ? *reinterpret_cast<const float4*>(v + c0 + e)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      vr[i][e] = Vec<T>::round(x.x);
      vr[i][e + 1] = Vec<T>::round(x.y);
      vr[i][e + 2] = Vec<T>::round(x.z);
      vr[i][e + 3] = Vec<T>::round(x.w);
    }
  }
}

// the warp's sums at its lanes' pieces into its red[K]
template <typename T, int NP>
__device__ __forceinline__ void rows_store(float* red, int K, const float (&x)[NP][Vec<T>::n]) {
  constexpr int CPL = Vec<T>::n;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c0 = (lane + 32 * i) * CPL;
    if (c0 < K)
#pragma unroll
      for (int e = 0; e < CPL; e += 4)
        *reinterpret_cast<float4*>(red + c0 + e) =
            make_float4(x[i][e], x[i][e + 1], x[i][e + 2], x[i][e + 3]);
  }
}

// What a block's stages share: its rows' vectors and the row group.
// The rows' r.r lives in s_rz (thread 0 writes it), which rows are live in a bit
// mask: neither takes registers through the slot passes.
struct RowsCtx {
  const Params* P;
  float *s_a, *s_r, *s_p, *s_red, *s_part, *s_scal, *s_rz;
  int row0, tw, nw;
};

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void st2(float* p, float2 v) { *reinterpret_cast<float2*>(p) = v; }

// (v_r @ gfix)[c:c+2] for the RB rows' v (shared memory [RB][K]): v four at a time,
// even and odd j in two chains, as the loop design's gv, a row at a time
template <int RB>
__device__ __forceinline__ void gv_rows(const float* __restrict__ G, const float* v, int K, int c,
                                        float2 (&out)[RB]) {
  float2 e[RB], o[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) e[r] = o[r] = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int j = 0; j < K; j += 4) {
    const float2 g0 = __ldg(reinterpret_cast<const float2*>(G + static_cast<size_t>(j) * K + c));
    const float2 g1 = __ldg(reinterpret_cast<const float2*>(G + static_cast<size_t>(j + 1) * K + c));
    const float2 g2 = __ldg(reinterpret_cast<const float2*>(G + static_cast<size_t>(j + 2) * K + c));
    const float2 g3 = __ldg(reinterpret_cast<const float2*>(G + static_cast<size_t>(j + 3) * K + c));
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float4 vj = *reinterpret_cast<const float4*>(v + r * K + j);
      e[r].x = fmaf(g0.x, vj.x, e[r].x);
      e[r].y = fmaf(g0.y, vj.x, e[r].y);
      o[r].x = fmaf(g1.x, vj.y, o[r].x);
      o[r].y = fmaf(g1.y, vj.y, o[r].y);
      e[r].x = fmaf(g2.x, vj.z, e[r].x);
      e[r].y = fmaf(g2.y, vj.z, e[r].y);
      o[r].x = fmaf(g3.x, vj.w, o[r].x);
      o[r].y = fmaf(g3.y, vj.w, o[r].y);
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) out[r] = make_float2(e[r].x + o[r].x, e[r].y + o[r].y);
}

// The teams' slot sums of one pass, each row's warps in order (and, with a cluster,
// the ranks' in rank order), handed to f(c, s[RB]) at every column pair c of the
// thread.
template <int RB, typename F>
__device__ __forceinline__ void rows_combine(const RowsCtx& X, int& pbuf, F&& f) {
  const int K = X.P->K, C = X.P->cluster;
  for (int c = 2 * threadIdx.x; c < K; c += 2 * blockDim.x) {
    float2 s[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      s[r] = make_float2(0.f, 0.f);
      for (int w = 0; w < X.tw; ++w) {
        const float2 x = ld2(X.s_red + (r * X.tw + w) * K + c);
        s[r].x += x.x;
        s[r].y += x.y;
      }
    }
    if (RB == 1 && C > 1)
      st2(X.s_part + pbuf * K + c, s[0]);
    else
      f(c, s);
  }
  if (RB == 1 && C > 1) {
    cgs::cluster_group cluster = cgs::this_cluster();
    cluster.sync();
    for (int c = 2 * threadIdx.x; c < K; c += 2 * blockDim.x) {
      float2 s[RB];
      s[0] = make_float2(0.f, 0.f);
      for (int q = 0; q < C; ++q) {
        const float2 x = ld2(cluster.map_shared_rank(X.s_part, q) + pbuf * K + c);
        s[0].x += x.x;
        s[0].y += x.y;
      }
      f(c, s);
    }
    pbuf ^= 1;
  }
}

// Each of x[RB] summed over the block: warp sums, then the warps' in order.
template <int RB>
__device__ __forceinline__ void rows_block_sums(const RowsCtx& X, float (&x)[RB], int& sbuf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < RB; ++r) x[r] += __shfl_xor_sync(kFull, x[r], o);
  float* sc = X.s_scal + sbuf * X.nw * RB;
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < RB; ++r) sc[warp * RB + r] = x[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float s = 0.f;
    for (int w = 0; w < X.nw; ++w) s += sc[w * RB + r];
    x[r] = s;
  }
  sbuf ^= 1;
}

// First pass, part 1: A a0 = slot sums + a0 gfix + lam a0 into s_r.
template <int RB>
__device__ __forceinline__ void rows_stage_mv(const RowsCtx& X, int& pbuf) {
  const Params& P = *X.P;
  const int K = P.K;
  rows_combine<RB>(X, pbuf, [&](int c, float2 (&s)[RB]) {
    float2 g[RB];
    if constexpr ((kProbe & kProbeNoGv) != 0) {
#pragma unroll
      for (int r = 0; r < RB; ++r) g[r] = make_float2(0.f, 0.f);
    } else {
      gv_rows<RB>(P.gfix, X.s_a, K, c, g);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float2 mv = s[r];
      mv.x += g[r].x;
      mv.y += g[r].y;
      const int row = X.row0 + r;
      if (P.lam_row && row < P.R) {
        const float2 l = ld2(P.lam_row + static_cast<size_t>(row) * K + c);
        const float2 a = ld2(X.s_a + r * K + c);
        mv.x += l.x * a.x;
        mv.y += l.y * a.y;
      }
      st2(X.s_r + r * K + c, mv);
    }
  });
}

// First pass, part 2: r = p = rhs - A a0 (rhs: slot sums + r0); rz = r.r.  Returns
// the rows that are live: real rows whose r.r passes the skip tolerance.
template <int RB>
__device__ __forceinline__ unsigned rows_stage_res(const RowsCtx& X, int& pbuf, int& sbuf) {
  const Params& P = *X.P;
  const int K = P.K;
  float part[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) part[r] = 0.f;
  rows_combine<RB>(X, pbuf, [&](int c, float2 (&s)[RB]) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float2 rhs = s[r];
      const int row = X.row0 + r;
      if (P.r0 && row < P.R) {
        const float2 b = ld2(P.r0 + static_cast<size_t>(row) * K + c);
        rhs.x += b.x;
        rhs.y += b.y;
      }
      const float2 mv = ld2(X.s_r + r * K + c);
      const float2 res = make_float2(rhs.x - mv.x, rhs.y - mv.y);
      st2(X.s_r + r * K + c, res);
      st2(X.s_p + r * K + c, res);
      part[r] = fmaf(res.x, res.x, part[r]);
      part[r] = fmaf(res.y, res.y, part[r]);
    }
  });
  rows_block_sums<RB>(X, part, sbuf);
  unsigned live = 0;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (threadIdx.x == 0) X.s_rz[r] = part[r];
    if (X.row0 + r < P.R && (part[r] > kSkipTol || (kProbe & kProbeNoStop) != 0)) live |= 1u << r;
  }
  return live;
}

// One CG step of the live rows after their slot pass: q = A p (into the team's first
// red), alpha, a += alpha p, r -= alpha q, and p = r + beta p for the rows that stay
// live.
template <int RB>
__device__ __forceinline__ void rows_stage_step(const RowsCtx& X, int& pbuf, int& sbuf,
                                                unsigned& live) {
  const Params& P = *X.P;
  const int K = P.K;
  float part[RB], rz[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    part[r] = 0.f;
    rz[r] = X.s_rz[r];
  }
  rows_combine<RB>(X, pbuf, [&](int c, float2 (&s)[RB]) {
    float2 g[RB];
    if constexpr ((kProbe & kProbeNoGv) != 0) {
#pragma unroll
      for (int r = 0; r < RB; ++r) g[r] = make_float2(0.f, 0.f);
    } else {
      gv_rows<RB>(P.gfix, X.s_p, K, c, g);
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float2 q = s[r];
      const float2 p = ld2(X.s_p + r * K + c);
      q.x += g[r].x;
      q.y += g[r].y;
      const int row = X.row0 + r;
      if (P.lam_row && row < P.R) {
        const float2 l = ld2(P.lam_row + static_cast<size_t>(row) * K + c);
        q.x += l.x * p.x;
        q.y += l.y * p.y;
      }
      st2(X.s_red + r * X.tw * K + c, q);
      part[r] = fmaf(p.x, q.x, part[r]);
      part[r] = fmaf(p.y, q.y, part[r]);
    }
  });
  rows_block_sums<RB>(X, part, sbuf);
  float alpha[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    alpha[r] = rz[r] / (part[r] == 0.f ? 1.f : part[r]);
    part[r] = 0.f;
  }
  for (int c = 2 * threadIdx.x; c < K; c += 2 * blockDim.x)
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (!(live >> r & 1u)) continue;
      const float2 p = ld2(X.s_p + r * K + c), q = ld2(X.s_red + r * X.tw * K + c);
      const float2 a = ld2(X.s_a + r * K + c), rr = ld2(X.s_r + r * K + c);
      st2(X.s_a + r * K + c, make_float2(a.x + alpha[r] * p.x, a.y + alpha[r] * p.y));
      const float2 res = make_float2(rr.x - alpha[r] * q.x, rr.y - alpha[r] * q.y);
      st2(X.s_r + r * K + c, res);
      part[r] = fmaf(res.x, res.x, part[r]);
      part[r] = fmaf(res.y, res.y, part[r]);
    }
  rows_block_sums<RB>(X, part, sbuf);
  bool stay[RB];
  float beta[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    stay[r] = (live >> r & 1u) && (part[r] > kFreezeTol || (kProbe & kProbeNoStop) != 0);
    beta[r] = part[r] / (rz[r] == 0.f ? 1.f : rz[r]);
  }
  for (int c = 2 * threadIdx.x; c < K; c += 2 * blockDim.x)
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (!stay[r]) continue;
      const float2 p = ld2(X.s_p + r * K + c), rr = ld2(X.s_r + r * K + c);
      st2(X.s_p + r * K + c, make_float2(rr.x + beta[r] * p.x, rr.y + beta[r] * p.y));
    }
  live = 0;
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (stay[r] && threadIdx.x == 0) X.s_rz[r] = part[r];
    if (stay[r]) live |= 1u << r;
  }
}

// f<RB>() for the block's rows a block (a run-time value): the stages alone are
// compiled for each, the slot passes once.
#define ROWS_DISPATCH(RB, CALL)          \
  switch (RB) {                          \
    case 1: { constexpr int R_ = 1; CALL; } break; \
    case 2: { constexpr int R_ = 2; CALL; } break; \
    case 4: { constexpr int R_ = 4; CALL; } break; \
    default: { constexpr int R_ = 8; CALL; } break; \
  }

template <typename T, int KMAX>
__global__ void __launch_bounds__(kMaxThreads, KMAX <= 512 ? 2 : 1)
    bucket_cg_rows_kernel(const Params P) {
  using V = Vec<T>;
  // slots a group (two groups in flight): a group's pieces at most 4 a lane
  constexpr int CPL = V::n, NP = KMAX / (32 * CPL), U = NP <= 2 ? 4 / NP : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = P.K, C = P.cluster, RB = P.rows;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int tw = nw / RB, tm = warp / tw, wt = warp % tw;
  RowsCtx X;
  X.P = &P;
  X.s_a = reinterpret_cast<float*>(smem);
  X.s_r = X.s_a + RB * K;
  X.s_p = X.s_r + RB * K;
  X.s_red = X.s_p + RB * K;
  X.s_part = X.s_red + nw * K;
  X.s_scal = X.s_part + (C > 1 ? 2 * K : 0);
  X.s_rz = X.s_scal + 2 * nw * RB;
  X.tw = tw;
  X.nw = nw;
  constexpr bool no_slots = (kProbe & kProbeNoSlots) != 0;
  unsigned char* stage =
      smem + rows_base_bytes(K, RB, nw, C) + tm * stage_bytes(P.stage_slots, K, sizeof(T));
  T* slab = reinterpret_cast<T*>(stage);
  float* scw = reinterpret_cast<float*>(stage + static_cast<size_t>(P.stage_slots) * K * sizeof(T));
  const T* mat = static_cast<const T*>(P.mat);
  float* red = X.s_red + warp * K;
  const int rank = blockIdx.x % C;
  const int groups = (P.R + RB - 1) / RB;
  int pbuf = 0, sbuf = 0;

  // Resident blocks walk the row groups (a cluster takes one row)
  for (int g = blockIdx.x / C; g < groups; g += gridDim.x / C) {
    X.row0 = g * RB;
    const int row = X.row0 + tm;
    const int len = row < P.R ? min(P.length[row], P.L) : 0;
    int lo = 0, hi = len;
    if (C > 1) {
      const int per = (len + C - 1) / C;
      lo = min(len, rank * per);
      hi = min(len, lo + per);
    }
    const int mid = lo + min(P.stage_slots, hi - lo);  // [lo, mid) staged
    const size_t rL = static_cast<size_t>(row < P.R ? row : 0) * P.L;
    const int* idx_r = P.idx + rL;
    const float* cw_r = P.cw + rL;
    const float* cv_r = P.cv + rL;

    for (int i = threadIdx.x; i < RB * K / 4; i += blockDim.x) {
      const int r = i / (K / 4), c = 4 * (i % (K / 4));
      *reinterpret_cast<float4*>(X.s_a + r * K + c) =
          X.row0 + r < P.R
              ? *reinterpret_cast<const float4*>(P.a0 + static_cast<size_t>(X.row0 + r) * K + c)
              : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    // rhs and A a0 in one pass over the slots; r = p = rhs - A a0
    float vr[NP][CPL], acc[NP][CPL], racc[NP][CPL];
    rows_load_v<T, NP>(X.s_a + tm * K, K, vr);
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int e = 0; e < CPL; ++e) acc[i][e] = racc[i][e] = 0.f;
    // A row of no slots (padding past R too) skips the pass.  The branch also steers
    // nvcc's register allocation of the K <= 512 kernel: 32 B of stack with it, 112
    // without, and a launch faster by a seventh at K = 304 (PERF.md section 6).
    if (!no_slots && len > 0) {
      rows_pass<T, NP, U, true, kWriteStage>(mat, idx_r, cw_r, cv_r, vr, acc, racc, slab, scw,
                                             lo, mid, lo, K, wt, tw);
      rows_pass<T, NP, U, true, kNoStage>(mat, idx_r, cw_r, cv_r, vr, acc, racc, slab, scw,
                                          mid, hi, lo, K, wt, tw);
    }
    rows_store<T, NP>(red, K, acc);
    __syncthreads();
    ROWS_DISPATCH(RB, rows_stage_mv<R_>(X, pbuf));
    __syncthreads();
    rows_store<T, NP>(red, K, racc);
    __syncthreads();
    unsigned live = 0;
    ROWS_DISPATCH(RB, live = rows_stage_res<R_>(X, pbuf, sbuf));

    for (int step = 0; step < P.n_steps; ++step) {
      if (!live) break;  // the same in every thread of the block (and cluster)
      const bool mine = live >> tm & 1u;
      rows_load_v<T, NP>(X.s_p + tm * K, K, vr);
#pragma unroll
      for (int i = 0; i < NP; ++i)
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[i][e] = 0.f;
      if (mine && !no_slots) {
        rows_pass<T, NP, U, false, kReadStage>(mat, idx_r, cw_r, cv_r, vr, acc, racc, slab,
                                               scw, lo, mid, lo, K, wt, tw);
        rows_pass<T, NP, U, false, kNoStage>(mat, idx_r, cw_r, cv_r, vr, acc, racc, slab, scw,
                                             mid, hi, lo, K, wt, tw);
      }
      rows_store<T, NP>(red, K, acc);
      __syncthreads();
      ROWS_DISPATCH(RB, rows_stage_step<R_>(X, pbuf, sbuf, live));
      __syncthreads();
    }
    if (rank == 0)
      for (int i = threadIdx.x; i < RB * K / 4; i += blockDim.x) {
        const int r = i / (K / 4), c = 4 * (i % (K / 4));
        if (X.row0 + r < P.R)
          *reinterpret_cast<float4*>(P.out + static_cast<size_t>(X.row0 + r) * K + c) =
              *reinterpret_cast<const float4*>(X.s_a + r * K + c);
      }
    __syncthreads();  // the next group's a0 overwrites s_a
  }
  if (C > 1) cgs::this_cluster().sync();  // no block leaves while others read its part
}

// The launch: at most the blocks the card holds at once without a cluster (they walk
// the rows), every row's C blocks with one; `grid` the blocks that cover the rows.
// The kernel's attribute and its resident blocks an SM are worked out once per
// (device, kernel, threads, shared memory) and kept.
cudaError_t start(const void* kernel, const Params& P, int threads, size_t smem, int grid,
                  cudaStream_t st) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, int, size_t>, std::pair<int, int>> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::pair<int, int> fit;  // resident blocks an SM, SMs
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_tuple(dev, kernel, threads, smem);
    auto hit = known.find(key);
    if (hit == known.end()) {
      int optin = 0, per_sm = 0, sms = 0;
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err == cudaSuccess && smem > static_cast<size_t>(optin)) err = cudaErrorInvalidValue;
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return err;
      hit = known.emplace(key, std::make_pair(per_sm, sms)).first;
    }
    fit = hit->second;
  }
  if (P.cluster == 1 && fit.first > 0) grid = min(grid, fit.first * fit.second);
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

template <typename T, int KMAX>
cudaError_t launch_rows(const Params& P, int threads, cudaStream_t st) {
  const int nw = threads / 32, RB = P.rows;
  if (threads % 32 || threads < 32 || threads > kMaxThreads || P.cluster < 1 || P.cluster > 8 ||
      P.stage_slots < 0 || !(RB == 1 || RB == 2 || RB == 4 || RB == 8) || nw % RB ||
      (P.cluster > 1 && RB != 1) || P.K <= kTiledMaxK || P.K > KMAX)
    return cudaErrorInvalidValue;
  const size_t smem =
      rows_base_bytes(P.K, RB, nw, P.cluster) + RB * stage_bytes(P.stage_slots, P.K, sizeof(T));
  const int grid = P.cluster > 1 ? P.R * P.cluster : (P.R + RB - 1) / RB;
  return start(reinterpret_cast<const void*>(bucket_cg_rows_kernel<T, KMAX>), P, threads, smem,
               grid, st);
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
  const int grid = warp_rows ? (P.R + nw - 1) / nw : P.R * P.cluster;
  return start(kernel, P, threads, smem, grid, st);
}

template <typename T>
cudaError_t dispatch(const Params& P, int threads, int warp_rows, cudaStream_t st) {
  constexpr int SW = 8 * Vec<T>::n;
  if (P.K > kTiledMaxK && P.rows > 0)
    return P.K <= 512 ? launch_rows<T, 512>(P, threads, st) : launch_rows<T, kRowsMaxK>(P, threads, st);
  if (P.rows != 0) return cudaErrorInvalidValue;
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

// C interface (bound with ctypes).  The caller guarantees K % 8 == 0, K >= 8, R >= 1,
// L >= 1, contiguous row-major tensors on the current device, 16-byte-aligned base
// pointers and idx values in [0, S).  lam_row and r0 may be null.  The launch plan
// (ops/sparse_cg.py: k3_plan): `threads` a block (32-256); up to K = 256 warp_rows (a
// warp a row, 8 rows a block of 256) or a block of `threads` a row in clusters of
// `cluster` blocks (1-8); past it, `rows` rows a block of the rows design (1, 2, 4 or
// 8, up to K = 1024; with a cluster 1) or 0, the loop design (a block or cluster a
// row); up to `stage_slots` slots a row (or a cluster rank's range) staged in shared
// memory.  Returns the launch's cudaError_t (0 on
// success); the kernel runs asynchronously on `stream`.
extern "C" int cmf_bucket_cg(const void* mat, const void* idx, const void* cw, const void* cv,
                             const void* gfix, const void* lam_row, const void* r0,
                             const void* a0, const void* length, void* out, int R, int L, int K,
                             int n_steps, int mat_f32, int threads, int warp_rows, int cluster,
                             int stage_slots, int rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= kTiledMaxK && rows != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Params P{mat, static_cast<const int*>(idx), static_cast<const float*>(cw),
                 static_cast<const float*>(cv), static_cast<const float*>(gfix),
                 static_cast<const float*>(lam_row), static_cast<const float*>(r0),
                 static_cast<const float*>(a0), static_cast<const int*>(length),
                 static_cast<float*>(out), R, L, K, n_steps, cluster, stage_slots, rows};
  return static_cast<int>(mat_f32 ? dispatch<float>(P, threads, warp_rows, st)
                                  : dispatch<uint16_t>(P, threads, warp_rows, st));
}
