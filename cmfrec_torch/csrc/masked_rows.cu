// K1 with f32 operands on sparse systems, for Hopper (sm_90a): the CG operator of the
// dense-masked ALS engine walked over each row's observed entries.
//
//   cmf_rowlist_build:  the row lists of W [R, S] (an int8 0/1 mask or f32 weights):
//                       off [R + 1], the column ids of each row's nonzero entries in
//                       column order, their weights (f32 W), and the chunk table
//   cmf_gram_rows:      out[r] = sum over the entries e of row r of
//                                w_e (Q[r] . Be[s_e]) Be[s_e]           [R, K] f32
//
// This is masked_gram_matvec's ((Q Be^T) * W) Be (csrc/masked_matmul.cu, K1) for f32
// operands, computed on the entries that W holds rather than on every cell of the dense
// form.  It replaces no TPU kernel: the JAX package runs its f32 K1 on the dense form
// (cmfrec_tpu/ops/masked_matmul.py::masked_gram_matvec), which on the TPU's matrix unit
// costs little.  On an H100 the dense f32 K1 is bound by f32 FMA (4 R S K operations,
// 2.85 ms at the flagship's 69,888 x 10,688 and K = 64), while ML10M's 9.5M ratings fill
// 1.27% of those cells: 4 K operations an entry are 0.036 ms of the same FMA units.  The
// engine takes these kernels where W's density lies under ROWS_MAX_DENSITY
// (ops/masked_matmul.py, measured on the card), and the dense kernels elsewhere.
//
// What bounds it on an H100: each entry gathers one row of Be (K * 4 bytes: 256 B at
// K = 64) from L2, where Be lives whole (2.7 MB on the A side, 17.9 MB on the B side, of
// the 50 MB L2), and does 4 K FMA operations on it.  The gathers, 2.4 GB a flagship call,
// are what limits it; device memory sees only the ids (4 B an entry), the weights (4 B,
// f32 W only), Q and out, once.  The design:
//
//  * A warp takes one chunk of at most `chunk` (ROW_CHUNK, 2048) consecutive entries of one
//    row, so a row of tens of thousands of entries (the most-rated items) spreads over
//    many warps and a short row costs one.  The chunk table (choff: a row's first chunk;
//    crow: a chunk's row, R past the last) is built with the lists, once a fit.
//  * Eight lanes take one entry, four entries a warp at once: each lane holds K / 8
//    consecutive-by-16-bytes columns of Q[r] and of its accumulator in registers, and
//    reads its part of Be[s] as float4s, so the eight lanes of an entry read 128
//    contiguous bytes at a time.  The dot needs three shuffles for four entries, and
//    the four groups' accumulators are added by two rounds of shuffles once a chunk.
//  * The warp reads 32 ids at once, coalesced, and hands them out by shuffles; the Be
//    rows of up to four steps (16 entries) are requested before any is used, so that
//    enough gathers are in flight to cover L2's latency.
//  * No float atomics: a chunk of a row with one chunk writes out[r]; the chunks of a
//    longer row write their partial sums to scratch, and rowlist_sum_kernel adds them in
//    chunk order (and writes the zero rows of rows without entries).  Every sum runs in
//    a fixed order, so two calls on the same inputs give the same bits.
//  * K = 64 to 256 (kMaxK, masked_matmul.TILED_MAX_K), in steps of 64; past it the
//    engine keeps the dense kernels (the density rule takes K).
//
// Measured at ML10M's shape (9.5M entries, 1.27% of 69,888 x 10,688; K = 64, int8 mask;
// NVIDIA H100 80GB HBM3, 700 W; scripts/time_k1_rows_torch.py): 0.236 ms a call on the A
// side and 0.295 ms on the B side at 2048 entries a chunk (1024: 0.238 / 0.299; 512:
// 0.250 / 0.323; 256: 0.254 / 0.347; 4096: 0.235 / 0.311: past 2048 the B side's
// longest rows fall to too few warps), against the dense f32 K1's 4.71 / 4.65 ms; the
// 2.43 GB of Be rows it gathers then pass at 10.3 / 8.2 TB/s.  Its time grows with the
// entries (21.5 / 24.3 ms x the density, with cells added uniformly), the dense kernel's
// does not: they cost the same at 22.1% / 19.1%, hence masked_matmul.ROWS_MAX_DENSITY =
// 0.18.  The lists' build reads W twice (count, fill): 0.8-1.0 ms a side.
//
// Build: compiled with the other sources of cmfrec_torch/csrc into one library
// (ops/_cuda.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 256;                 // threads a block
constexpr int WARPS = NT / 32;
constexpr int GROUP = 8;                // lanes an entry
constexpr int PER_STEP = 32 / GROUP;    // entries a warp takes at once
constexpr int STEPS = 32 / PER_STEP;    // steps over a batch of 32 ids
constexpr int kMaxK = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float dot4(float4 a, float4 b, float d) {
  d = fmaf(a.x, b.x, d);
  d = fmaf(a.y, b.y, d);
  d = fmaf(a.z, b.z, d);
  return fmaf(a.w, b.w, d);
}

__device__ __forceinline__ void axpy4(float c, float4 b, float4& acc) {
  acc.x = fmaf(c, b.x, acc.x);
  acc.y = fmaf(c, b.y, acc.y);
  acc.z = fmaf(c, b.z, acc.z);
  acc.w = fmaf(c, b.w, acc.w);
}

// One warp a chunk of one row's entries.  KT = K / 64, so a lane holds V = 2 KT float4s
// of Q[r] and of its accumulator: float4 i of lane g (of its group of eight) is columns
// 32 i + 4 g .. + 3.  U steps' gathers are in flight together.
template <int KT, bool WEIGHTED>
__global__ void __launch_bounds__(NT)
    rowlist_gram_kernel(const float* __restrict__ Q, const float* __restrict__ Be,
                        const int* __restrict__ off, const int* __restrict__ ids,
                        const float* __restrict__ wts, const int* __restrict__ choff,
                        const int* __restrict__ crow, float* __restrict__ out,
                        float* __restrict__ part, int R, int slots, int chunk, int cap) {
  constexpr int V = 2 * KT;
  constexpr int K = 64 * KT;
  constexpr int U = KT >= 3 ? 1 : 4 / KT;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= slots) return;
  const int r = crow[c];
  if (r >= R) return;
  const int c0 = choff[r];
  const int e0 = off[r] + (c - c0) * chunk;
  const int e1 = min(min(e0 + chunk, off[r + 1]), cap);
  const int g = lane & (GROUP - 1);
  const int sub = lane / GROUP;

  float4 q[V], acc[V];
  const float4* Qr = reinterpret_cast<const float4*>(Q + static_cast<size_t>(r) * K);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    q[i] = __ldg(Qr + i * GROUP + g);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int e = e0; e < e1; e += 32) {
    const int left = e1 - e;
    const int id = lane < left ? __ldg(ids + e + lane) : -1;
    float w = 1.f;
    if (WEIGHTED) w = lane < left ? __ldg(wts + e + lane) : 0.f;
#pragma unroll
    for (int t0 = 0; t0 < STEPS; t0 += U) {
      if (t0 * PER_STEP >= left) break;  // the same on every lane
      float4 b[U][V];
      float ws[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int src = (t0 + u) * PER_STEP + sub;
        const int s = __shfl_sync(FULL, id, src);
        ws[u] = WEIGHTED ? __shfl_sync(FULL, w, src) : 1.f;
        const float4* Bs = reinterpret_cast<const float4*>(Be + static_cast<size_t>(max(s, 0)) * K);
#pragma unroll
        for (int i = 0; i < V; ++i)
          b[u][i] = s >= 0 ? __ldg(Bs + i * GROUP + g) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) d = dot4(q[i], b[u][i], d);
        // the group's eight partial dots, added as a butterfly: every lane of the group
        // ends with the same bits (each level adds the same two values)
        d += __shfl_xor_sync(FULL, d, 1);
        d += __shfl_xor_sync(FULL, d, 2);
        d += __shfl_xor_sync(FULL, d, 4);
        if (WEIGHTED) d *= ws[u];
#pragma unroll
        for (int i = 0; i < V; ++i) axpy4(d, b[u][i], acc[i]);
      }
    }
  }

  // the four groups' sums, again as a butterfly, then each float4 written by one group
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int m = GROUP; m < 32; m <<= 1) {
      acc[i].x += __shfl_xor_sync(FULL, acc[i].x, m);
      acc[i].y += __shfl_xor_sync(FULL, acc[i].y, m);
      acc[i].z += __shfl_xor_sync(FULL, acc[i].z, m);
      acc[i].w += __shfl_xor_sync(FULL, acc[i].w, m);
    }
  }
  const bool alone = choff[r + 1] - c0 == 1;
  float4* dst = reinterpret_cast<float4*>(alone ? out + static_cast<size_t>(r) * K
                                                : part + static_cast<size_t>(c) * K);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (i % PER_STEP == sub) dst[i * GROUP + g] = acc[i];
}

// out[r] = the partial sums of row r's chunks added in chunk order, for rows of two or
// more chunks; zero for rows without entries; rows of one chunk were written whole.
__global__ void __launch_bounds__(NT)
    rowlist_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                       const int* __restrict__ choff, int R, int K4) {
  const size_t i = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  if (i >= static_cast<size_t>(R) * K4) return;
  const int r = static_cast<int>(i / K4);
  const int j = static_cast<int>(i - static_cast<size_t>(r) * K4);
  const int c0 = choff[r];
  const int n = choff[r + 1] - c0;
  if (n == 1) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < n; ++z) {
    const float4 v = part[static_cast<size_t>(c0 + z) * K4 + j];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  out[i] = s;
}

// ------------------------------------------------------------- the lists
// The nonzero entries among a 16-byte vector of W, one bit each in column order.
__device__ __forceinline__ unsigned nonzero_bits(uint4 v, int8_t) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if ((w[k >> 2] >> (8 * (k & 3))) & 0xffu) bits |= 1u << k;
  return bits;
}

__device__ __forceinline__ unsigned nonzero_bits(uint4 v, float) {
  return (__uint_as_float(v.x) != 0.f) | (__uint_as_float(v.y) != 0.f) << 1 |
         (__uint_as_float(v.z) != 0.f) << 2 | (__uint_as_float(v.w) != 0.f) << 3;
}

__device__ __forceinline__ float entry_weight(uint4 v, int k, float) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  return __uint_as_float(w[k]);
}

__device__ __forceinline__ float entry_weight(uint4, int, int8_t) { return 1.f; }

// The sum of x over the block; every thread gets it.
__device__ __forceinline__ int block_sum(int x, int* scratch) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(FULL, x, m);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = x;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += scratch[w];
  __syncthreads();
  return t;
}

// A block a row: off[r + 1] = the row's nonzero entries, choff[r + 1] = its chunks.
template <typename WT>
__global__ void __launch_bounds__(NT)
    rowlist_count_kernel(const WT* __restrict__ W, int S, int chunk, int* __restrict__ off,
                         int* __restrict__ choff) {
  __shared__ int scratch[WARPS];
  const int r = blockIdx.x;
  const uint4* row = reinterpret_cast<const uint4*>(W + static_cast<size_t>(r) * S);
  const int n16 = S / (16 / static_cast<int>(sizeof(WT)));
  int n = 0;
  for (int j = threadIdx.x; j < n16; j += NT) n += __popc(nonzero_bits(row[j], WT()));
  n = block_sum(n, scratch);
  if (threadIdx.x == 0) {
    off[r + 1] = n;
    choff[r + 1] = (n + chunk - 1) / chunk;
  }
}

// One block: off[1..R] and choff[1..R] (counts) into their running sums, off[0] =
// choff[0] = 0.  Each thread sums a contiguous run of rows.
__global__ void __launch_bounds__(1024) rowlist_scan_kernel(int* __restrict__ off,
                                                            int* __restrict__ choff, int R) {
  __shared__ int tot[2][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (R + 1023) / 1024;
  const int lo = min(R, static_cast<int>(threadIdx.x) * per), hi = min(R, lo + per);
  int a = 0, b = 0;
  for (int i = lo; i < hi; ++i) {
    a += off[i + 1];
    b += choff[i + 1];
  }
  // inclusive scans within the warp, then of the warps' totals
  int ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int ya = __shfl_up_sync(FULL, ia, o), yb = __shfl_up_sync(FULL, ib, o);
    if (lane >= o) {
      ia += ya;
      ib += yb;
    }
  }
  if (lane == 31) {
    tot[0][warp] = ia;
    tot[1][warp] = ib;
  }
  __syncthreads();
  if (warp == 0) {
    int ta = tot[0][lane], tb = tot[1][lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int ya = __shfl_up_sync(FULL, ta, o), yb = __shfl_up_sync(FULL, tb, o);
      if (lane >= o) {
        ta += ya;
        tb += yb;
      }
    }
    tot[0][lane] = ta;
    tot[1][lane] = tb;
  }
  __syncthreads();
  int pa = ia - a + (warp ? tot[0][warp - 1] : 0);
  int pb = ib - b + (warp ? tot[1][warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    pa += off[i + 1];
    off[i + 1] = pa;
    pb += choff[i + 1];
    choff[i + 1] = pb;
  }
  if (threadIdx.x == 0) {
    off[0] = 0;
    choff[0] = 0;
  }
}

// A block a row: the column ids of its nonzero entries in column order from off[r]
// (and their weights, f32 W), and crow over its chunks.  Tiles of NT 16-byte vectors;
// each thread's place in a tile is a block-wide scan of the entries before it.
template <typename WT>
__global__ void __launch_bounds__(NT)
    rowlist_fill_kernel(const WT* __restrict__ W, int S, const int* __restrict__ off,
                        const int* __restrict__ choff, int* __restrict__ ids,
                        float* __restrict__ wts, int* __restrict__ crow, int slots, int cap) {
  __shared__ int tot[WARPS];
  constexpr int E = 16 / sizeof(WT);  // entries a vector
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = choff[r] + threadIdx.x; c < min(choff[r + 1], slots); c += NT) crow[c] = r;
  const uint4* row = reinterpret_cast<const uint4*>(W + static_cast<size_t>(r) * S);
  const int n16 = S / E;
  int base = off[r];
  for (int j0 = 0; j0 < n16; j0 += NT) {
    const int j = j0 + threadIdx.x;
    const uint4 v = j < n16 ? row[j] : make_uint4(0u, 0u, 0u, 0u);
    const unsigned bits = nonzero_bits(v, WT());
    const int n = __popc(bits);
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) tot[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int t = tot[w];
      before += w < warp ? t : 0;
      total += t;
    }
    __syncthreads();
    int pos = base + before + incl - n;
    for (unsigned m = bits; m; m &= m - 1, ++pos) {
      const int k = __ffs(m) - 1;
      if (pos < cap) {
        ids[pos] = j * E + k;
        if (wts) wts[pos] = entry_weight(v, k, WT());
      }
    }
    base += total;
  }
}

template <typename WT>
cudaError_t build(const void* W, int R, int S, int chunk, int* off, int* choff, int* ids,
                  float* wts, int* crow, int slots, int cap, cudaStream_t st) {
  const WT* w = static_cast<const WT*>(W);
  rowlist_count_kernel<WT><<<R, NT, 0, st>>>(w, S, chunk, off, choff);
  rowlist_scan_kernel<<<1, 1024, 0, st>>>(off, choff, R);
  rowlist_fill_kernel<WT><<<R, NT, 0, st>>>(w, S, off, choff, ids, wts, crow, slots, cap);
  return cudaGetLastError();
}

template <int KT>
cudaError_t gram(bool weighted, const float* Q, const float* Be, const int* off,
                 const int* ids, const float* wts, const int* choff, const int* crow,
                 float* out, float* part, int R, int slots, int chunk, int cap,
                 cudaStream_t st) {
  const unsigned blocks = (slots + WARPS - 1) / WARPS;
  if (weighted)
    rowlist_gram_kernel<KT, true><<<blocks, NT, 0, st>>>(Q, Be, off, ids, wts, choff, crow,
                                                         out, part, R, slots, chunk, cap);
  else
    rowlist_gram_kernel<KT, false><<<blocks, NT, 0, st>>>(Q, Be, off, ids, wts, choff, crow,
                                                          out, part, R, slots, chunk, cap);
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes).  Tensors are contiguous on the current device; the
// kernels run asynchronously on `stream`.  Returns the launches' cudaError_t (0 on
// success).
//
// cmf_rowlist_build: W [R, S], w_type 0 an int8 mask or 1 f32 weights, S a multiple of
// 64 and W 16-byte aligned.  Writes off [R + 1] and choff [R + 1] (int32: a row's first
// entry and first chunk of `chunk` entries), ids [cap] (int32: the first off[R] used),
// wts [cap] (f32 W only; may be null for an int8 W) and crow [slots] (int32: a chunk's
// row), which the caller has filled with R; cap bounds the entries and slots the chunks
// (the caller's bounds: cap >= W's nonzero entries, slots >= cap / chunk + R).  Entries
// past cap are dropped rather than written.
extern "C" int cmf_rowlist_build(const void* W, int R, int S, int w_type, int chunk, void* off,
                                 void* choff, void* ids, void* wts, void* crow, int slots,
                                 int cap, void* stream) {
  if (R <= 0 || S <= 0 || S % 64 || chunk <= 0 || (w_type == 1 && !wts))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(off);
  int* co = static_cast<int*>(choff);
  int* id = static_cast<int*>(ids);
  int* cr = static_cast<int*>(crow);
  switch (w_type) {
    case 0:
      return static_cast<int>(build<int8_t>(W, R, S, chunk, o, co, id, nullptr, cr, slots, cap, st));
    case 1:
      return static_cast<int>(
          build<float>(W, R, S, chunk, o, co, id, static_cast<float*>(wts), cr, slots, cap, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// cmf_gram_rows: Q [R, K] and Be [S, K] f32 (16-byte aligned), K a multiple of 64 up to
// 256, the lists of cmf_rowlist_build (wts null for an int8 mask), part [slots, K] f32
// scratch; out [R, K] f32.
extern "C" int cmf_gram_rows(const void* Q, const void* Be, const void* off, const void* ids,
                             const void* wts, const void* choff, const void* crow, void* out,
                             void* part, int R, int K, int slots, int chunk, int cap,
                             void* stream) {
  if (R <= 0 || K <= 0 || K % 64 || K > kMaxK || chunk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const float*>(Q);
  const auto* be = static_cast<const float*>(Be);
  const auto* o = static_cast<const int*>(off);
  const auto* id = static_cast<const int*>(ids);
  const auto* w = static_cast<const float*>(wts);
  const auto* co = static_cast<const int*>(choff);
  const auto* cr = static_cast<const int*>(crow);
  auto* dst = static_cast<float*>(out);
  auto* pt = static_cast<float*>(part);
  const bool weighted = w != nullptr;
  cudaError_t err;
  switch (K / 64) {
    case 1: err = gram<1>(weighted, q, be, o, id, w, co, cr, dst, pt, R, slots, chunk, cap, st); break;
    case 2: err = gram<2>(weighted, q, be, o, id, w, co, cr, dst, pt, R, slots, chunk, cap, st); break;
    case 3: err = gram<3>(weighted, q, be, o, id, w, co, cr, dst, pt, R, slots, chunk, cap, st); break;
    default: err = gram<4>(weighted, q, be, o, id, w, co, cr, dst, pt, R, slots, chunk, cap, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int K4 = K / 4;
  const size_t n = static_cast<size_t>(R) * K4;
  rowlist_sum_kernel<<<static_cast<unsigned>((n + NT - 1) / NT), NT, 0, st>>>(
      static_cast<const float4*>(static_cast<const void*>(pt)), static_cast<float4*>(out), co, R, K4);
  return static_cast<int>(cudaGetLastError());
}
