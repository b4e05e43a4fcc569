// Batched cyclic coordinate descent (non-negative least squares and/or the elastic
// net) of the ALS solves with nonneg, nonneg_C, nonneg_D or l1_lambda, for Hopper
// (sm_90a).
//
//   cmf_cd_solve: for every row r, from a_r = 0, minimise
//
//     0.5 a^T G_r a - rhs_r^T a + l1_r^T |a|        (under nonneg: subject to a >= 0)
//
//   by sweeps over the K coordinates in order.  Coordinate k takes
//     num = rhs_r[k] - sum_j G_r[k,j] a[j] + a[k] G_r[k,k]
//     a[k] = max(num - l1, 0) / d                    (nonneg)
//     a[k] = sign(num) max(|num| - l1, 0) / d        (otherwise)
//   with d = G_r[k,k], or 1 where that is <= 0.  A row stops after the first sweep
//   that moves no coordinate by more than tol, or after max_steps sweeps.
//
//   G: [R,K,K] with row stride g_stride elements (K*K, or 0 for one G shared by every
//   row); rhs, out: [R,K]; l1: [K] (l1_stride 0) or [R,K] (l1_stride K); sweeps:
//   optional int32 [R], the sweeps each row ran.  float or double throughout.
//
// It replaces no TPU kernel: cmfrec_tpu/ops/rowsolve.py::solve_cd (:279) is XLA, a
// fori_loop over the coordinates inside a scan over the sweeps, whose frozen rows
// ("done") are the rows that leave the loop here.  Its plain twin is
// cmfrec_torch/ops/rowsolve.py::solve_cd, which computes the same in the same order of
// coordinates.
//
// What bounds it on an H100: operations, 2K^2 FMA-flops a row and sweep against K^2
// elements of G read once (~K/2 flop/B at 4 B), so the f32 rate (67 TFLOP/s) or the
// f64 rate.  In practice the latency of each coordinate's chain bounds it, since
// coordinate k+1 needs a[k], and with it how many rows the SMs hold at once.
//
// The first design (a warp a row, G read from memory at every coordinate of every
// sweep, lane 0's loads of G_kk, rhs_k and l1_k after a five-shuffle reduction) took
// ~2,000 cycles a coordinate and 83 ms for phase 26's A half-step of chip_smoke.py,
// 127x its bound.  This design keeps everything a sweep reads on chip:
//
//  * Staged path (K <= kStagedMaxK = 128): L lanes a row (L the power of two
//    >= K/4, so 32/L rows a warp: two at K = 56), each lane owning four
//    consecutive coordinates.  A block's rows copy their G from device memory
//    once a solve into shared memory (a G of row stride 0 once a block), and each
//    lane loads its coordinates' rhs, l1, G_kk, d and 1/d into registers before
//    the first sweep.  A sweep then reads only shared memory (each row's G once,
//    16 or 32 bytes a lane and coordinate) and shuffles.  Rows resident an SM
//    are what the shared memory holds (16 at K = 56 in f32), and a row's
//    coordinates run one after the other, so the chain of a coordinate, the
//    instructions a warp issues for it and the shared-memory bytes it reads are
//    what the design shortens.
//  * The chain of a coordinate is the gradient form: each lane keeps
//    g[k] = rhs[k] - sum_j G[k,j] a[j] for its coordinates.  Coordinate k is
//    num = g[k] + a[k] G[k,k], the twin's own term added back as the twin adds it.
//    The lane that owns four coordinates takes them alone, one after the other,
//    updating its own copy of their g by each change (the 4 x 4 block of G it
//    holds), so their chain is arithmetic only: an add, the update, a subtraction
//    and an FMA a coordinate.  Then one round of shuffles broadcasts the block's
//    changes and final values, and every lane subtracts delta * G[j,k] from its
//    g[j] (G staged transposed, so a lane's four G[j,k] are one 16-byte shared
//    load) and adds G[j,k] a[k] to a fresh sum of G a: the next sweep starts from
//    rhs - G a summed from the sweep's final a, not carried by the changes, so
//    rounding cannot build up across sweeps (at the cost of one more shuffle and
//    four FMAs a coordinate, where a separate pass would read G from shared memory
//    a second time).  The sweep's largest change is max |a - a0| over the row's
//    lanes, a0 the sweep's start.  Numerics against the twin: num is the twin's
//    sum taken in another order (the sweep start's sum over all j, then the
//    changes of the coordinates before k), so the results differ by rounding
//    only, as the first design's did.  Keeping the own term in g keeps the twin's
//    rounding at a fixed point too: a g without it settles exactly where the
//    twin's rounding keeps moving.  The twin's dot form on the same staging (each
//    lane's four products summed over the row's lanes by a butterfly of log2 L
//    shuffles a coordinate) measured 282 cycles a coordinate against this form's
//    87 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), so the kernel has this form
//    only.
//  * x / d is x * (1/d) with one Newton correction, q + (x - q d) / d, which rounds
//    as the division does (Markstein); 1/d is formed once.
//  * Streamed path (K > kStagedMaxK): a warp a row, the dot form, rhs, l1, G_kk, d,
//    1/d and a in shared memory, and the row of G read from memory (L2) at every
//    coordinate: one row's G no longer fits a share of the SM at the staged path's
//    rows a block.  Where a row's six K-vectors do not fit the opt-in shared memory
//    (K > 4,842 in double, 9,685 in float on an H100), the same kernel keeps them in a
//    scratch in device memory that the wrapper allocates, [rows in flight, 6, K], and
//    the resident warps walk the rows: the same arithmetic in the same order, so the
//    same bits as the shared-memory configuration wherever both can run.

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlots = 4;         // coordinates a lane owns on the staged path
constexpr int kStagedMaxK = 128;  // 32 lanes x 4 coordinates
constexpr int kStreamWarps = 8;
constexpr int kStageBatch = 8;    // G's loads a thread issues before it stores them

// a * b rounded, never contracted into an FMA (the twin rounds the product)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// a[k]'s new value from num: x / d formed as q = x (1/d), corrected once.
template <typename T>
__device__ __forceinline__ T cd_step(T num, T l1, T d, T rinv, int nonneg) {
  T x;
  if (nonneg) {
    x = fmax(num - l1, T(0));
  } else {
    const T mag = fmax(fabs(num) - l1, T(0));
    x = num > T(0) ? mag : (num < T(0) ? -mag : T(0));
  }
  const T q = x * rinv;
  return fma(fma(-q, d, x), rinv, q);
}

// S consecutive elements of shared memory (16-byte aligned) in 16-byte loads.
template <int S>
__device__ __forceinline__ void loadv(float (&v)[S], const float* p) {
#pragma unroll
  for (int c = 0; c < S; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + c);
    v[c] = x.x, v[c + 1] = x.y, v[c + 2] = x.z, v[c + 3] = x.w;
  }
}
template <int S>
__device__ __forceinline__ void loadv(double (&v)[S], const double* p) {
#pragma unroll
  for (int c = 0; c < S; c += 2) {
    const double2 x = *reinterpret_cast<const double2*>(p + c);
    v[c] = x.x, v[c + 1] = x.y;
  }
}

struct Args {
  const void* G;
  long long g_stride;
  const void* rhs;
  const void* l1;
  int l1_stride;
  void* out;
  int* sweeps;
  void* scratch;     // streamed path's [scratch_rows, 6, K] vectors, or null: shared memory
  int scratch_rows;  // rows in flight (a multiple of the warps a block)
  int R, K, nonneg, max_steps;
  double tol;
};

// A staged G is KP x KP (K rounded up to a multiple of kSlots, zero past K), so
// that a coordinate past K is an exact no-op (G_kk = 0: d = 1, and rhs, l1, a and
// num are 0) and no loop over the coordinates needs a bound check; after the
// block's staged Gs come the kSlots L zeros that lanes past KP read.
__host__ __device__ inline int staged_kp(int K) { return (K + kSlots - 1) / kSlots * kSlots; }
__host__ __device__ inline size_t staged_smem(int K, int L, int rows_pb, bool shared_g,
                                              size_t esz) {
  const size_t kp = staged_kp(K);
  return ((shared_g ? 1 : rows_pb) * kp * kp + static_cast<size_t>(kSlots) * L) * esz;
}

// ------------------------------------------------------------------ staged
// Block: blockDim.x / 32 warps, 32 / L rows a warp, rows_pb = blockDim.x / L rows.
template <typename T>
__global__ void __launch_bounds__(256)
    cd_staged_kernel(const Args A, int L) {
  constexpr int S = kSlots;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const T* G = static_cast<const T*>(A.G);
  const T* rhs = static_cast<const T*>(A.rhs);
  const T* l1v = static_cast<const T*>(A.l1);
  T* out = static_cast<T*>(A.out);
  const int K = A.K, KP = staged_kp(K), KP2 = KP * KP;
  const int rows_pb = blockDim.x / L;
  const bool shared_g = A.g_stride == 0;
  const int nstaged = shared_g ? 1 : rows_pb;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_pb;

  // stage: every element once, in G's own order, kStageBatch loads in flight a
  // thread before their stores; zeros past K and past R
  const int total = nstaged * KP2;
  for (int e0 = threadIdx.x; e0 < total; e0 += kStageBatch * blockDim.x) {
    T v[kStageBatch];
#pragma unroll
    for (int q = 0; q < kStageBatch; ++q) {
      const int e = e0 + q * blockDim.x;
      const int b = e / KP2, rem = e - b * KP2, i = rem / KP, j = rem - i * KP;
      const long long r = row0 + b;
      v[q] = e < total && i < K && j < K && r < A.R
                 ? G[r * A.g_stride + static_cast<long long>(i) * K + j] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kStageBatch; ++q) {
      const int e = e0 + q * blockDim.x;
      if (e >= total) break;
      const int b = e / KP2, rem = e - b * KP2, i = rem / KP, j = rem - i * KP;
      // G[i,j] at (j, i), so that a lane's S G[i,k] of column k lie together
      smem[b * KP2 + j * KP + i] = v[q];
    }
  }
  for (int e = threadIdx.x; e < S * L; e += blockDim.x) smem[nstaged * KP2 + e] = T(0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int sub = lane % L, base = lane - sub;  // lane within its row; the row's first
  const int rb = threadIdx.x / L;                // row within the block
  const long long r = row0 + rb;
  const int k0 = S * sub;                        // this lane's first coordinate
  const T* Gs = smem + (shared_g ? 0 : rb * KP2) + k0;
  bool live = r < A.R;
  const long long rc = live ? r : 0;

  // gr: rhs - G a for this lane's coordinates, a as the sweep left it
  T a[S], rv[S], l1[S], d[S], rinv[S], gkk[S], gr[S];
#pragma unroll
  for (int t = 0; t < S; ++t) {
    const int k = k0 + t;
    const bool ok = live && k < K;
    a[t] = T(0);
    rv[t] = ok ? rhs[rc * K + k] : T(0);
    gr[t] = rv[t];
    l1[t] = ok ? l1v[rc * A.l1_stride + k] : T(0);
    gkk[t] = ok ? G[rc * A.g_stride + static_cast<long long>(k) * K + k] : T(0);
    d[t] = gkk[t] <= T(0) ? T(1) : gkk[t];
    rinv[t] = T(1) / d[t];
  }
  const T tol = static_cast<T>(A.tol);
  int steps = 0;
  for (int s = 0; s < A.max_steps; ++s) {
    if (!__any_sync(kFull, live)) break;
    T a0[S], ga[S];  // a at the sweep's start; G a over the coordinates done
#pragma unroll
    for (int t = 0; t < S; ++t) {
      a0[t] = a[t];
      ga[t] = T(0);
    }
    for (int i0 = 0; i0 < KP; i0 += S) {
      // the block's columns: cur[u][t] is G[k0 + t, i0 + u].  Loaded here
      // rather than a block ahead, whose register copies cost more issue slots
      // than the load's latency
      T cur[S][S];
#pragma unroll
      for (int u = 0; u < S; ++u) loadv<S>(cur[u], Gs + (i0 + u) * KP);
      const int owner = base + i0 / S;
      const bool mine = lane == owner;
      // the owner takes its S coordinates alone: coordinate i0 + u is
      // gl[u] + a[u] G_kk, gl its gradient after coordinates i0 .. i0 + u - 1
      // (cur[u][v] = G[i0 + v, i0 + u] in the owner's lane)
      T gl[S], dl[S], al[S];
#pragma unroll
      for (int u = 0; u < S; ++u) gl[u] = gr[u];
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const T nw = cd_step(gl[u] + mul_rn(a[u], gkk[u]), l1[u], d[u], rinv[u], A.nonneg);
        const T raw = nw - a[u];
#pragma unroll
        for (int v = u + 1; v < S; ++v) gl[v] = fma(-raw, cur[u][v], gl[v]);
        dl[u] = live ? raw : T(0);
        if (live) a[u] = mine ? nw : a[u];
        al[u] = a[u];
      }
      // then one round of shuffles broadcasts the block's changes and final
      // values: the running gradient takes the changes, G a the values
#pragma unroll
      for (int u = 0; u < S; ++u) {
        const T du = __shfl_sync(kFull, dl[u], owner);
        const T au = __shfl_sync(kFull, al[u], owner);
#pragma unroll
        for (int t = 0; t < S; ++t) {
          gr[t] = fma(-du, cur[u][t], gr[t]);
          ga[t] = fma(cur[u][t], au, ga[t]);
        }
      }
    }
    // the next sweep starts from rhs - G a, summed afresh from this sweep's
    // final values rather than carried by the changes, so that rounding does
    // not build up across sweeps
#pragma unroll
    for (int t = 0; t < S; ++t) gr[t] = rv[t] - ga[t];
    // the sweep's largest change, over the row's lanes
    T md = T(0);
#pragma unroll
    for (int t = 0; t < S; ++t) md = fmax(md, fabs(a[t] - a0[t]));
    for (int off = L >> 1; off > 0; off >>= 1) md = fmax(md, __shfl_xor_sync(kFull, md, off));
    if (live) {
      ++steps;
      live = !(md <= tol);
    }
  }
  if (r < A.R) {
#pragma unroll
    for (int t = 0; t < S; ++t)
      if (k0 + t < K) out[r * K + k0 + t] = a[t];
    if (A.sweeps != nullptr && sub == 0) A.sweeps[r] = steps;
  }
}

// ---------------------------------------------------------------- streamed
// A warp a row; the row's six K-vectors in shared memory or, with A.scratch, in the
// warp's slot of the scratch in device memory; G's row k read from memory at
// coordinate k (the dot form).  The warps walk the rows (with shared memory the grid
// covers them, one row a warp).
template <typename T>
__global__ void __launch_bounds__(kStreamWarps * 32)
    cd_stream_kernel(const Args A) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = A.K, warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long slot = static_cast<long long>(blockIdx.x) * warps + warp;
  T* a = A.scratch != nullptr ? static_cast<T*>(A.scratch) + slot * 6 * K
                              : reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * 6 * K;
  T* rv = a + K;
  T* l1 = a + 2 * K;
  T* gkk = a + 3 * K;
  T* d = a + 4 * K;
  T* rinv = a + 5 * K;
  const T tol = static_cast<T>(A.tol);
  // whole warps leave: no barrier below spans warps
  for (long long r = slot; r < A.R; r += static_cast<long long>(gridDim.x) * warps) {
    const T* Gr = static_cast<const T*>(A.G) + r * A.g_stride;
    for (int j = lane; j < K; j += 32) {
      a[j] = T(0);
      rv[j] = static_cast<const T*>(A.rhs)[r * K + j];
      l1[j] = static_cast<const T*>(A.l1)[r * A.l1_stride + j];
      gkk[j] = Gr[static_cast<long long>(j) * K + j];
      d[j] = gkk[j] <= T(0) ? T(1) : gkk[j];
      rinv[j] = T(1) / d[j];
    }
    __syncwarp();
    int steps = 0;
    for (int s = 0; s < A.max_steps; ++s) {
      T md = T(0);  // the same in every lane
      for (int k = 0; k < K; ++k) {
        const T* gk = Gr + static_cast<long long>(k) * K;
        T part = T(0);
        for (int j = lane; j < K; j += 32) part += gk[j] * a[j];
        const T dot = warp_sum(part);
        const T ak = a[k];
        const T nw = cd_step((rv[k] - dot) + mul_rn(ak, gkk[k]), l1[k], d[k], rinv[k], A.nonneg);
        md = fmax(md, fabs(nw - ak));
        __syncwarp();
        if (lane == 0) a[k] = nw;
        __syncwarp();
      }
      ++steps;
      if (md <= tol) break;
    }
    for (int j = lane; j < K; j += 32) static_cast<T*>(A.out)[r * K + j] = a[j];
    if (A.sweeps != nullptr && lane == 0) A.sweeps[r] = steps;
    __syncwarp();  // the next row's start overwrites a
  }
}


int staged_lanes(int K) {
  int L = 1;
  while (L * kSlots < K) L <<= 1;
  return L;
}

// A solve's launch: staged (1) or streamed (0), lanes a row, warps a block, rows a
// block, resident blocks an SM, shared memory a block, and whether the streamed
// path's vectors live in a scratch in device memory (1).  The layout of cmf_cd_plan.
struct Config {
  int staged, lanes, warps, rows_pb, blocks, smem, scratch;
};

// The launch of a solve of width K (shared_g: G of row stride 0) on the current
// device within `optin` bytes of shared memory a block (0 or more than the card's
// opt-in: the card's), worked out (the kernel's attributes set, the occupancy asked)
// the first time it is asked for and kept.  Staged: the warps a block (1, 2, 4 or 8)
// that keep the most rows resident an SM (ties: fewer warps).  Streamed: up to
// kStreamWarps warps, as many as the shared memory holds the six K-vectors of; where
// it holds not one warp's, kStreamWarps warps with the vectors in a scratch
// (ops/coord_descent.py: stream_plan models the choice).
template <typename T>
cudaError_t config(int K, bool shared_g, int optin, Config* out) {
  static std::mutex mu;
  // (device, +-K: -K shared G, the shared memory allowed)
  static std::map<std::pair<std::pair<int, int>, int>, Config> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int card = 0;
  e = cudaDeviceGetAttribute(&card, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (optin <= 0 || optin > card) optin = card;
  const std::pair<std::pair<int, int>, int> key{{dev, shared_g ? -K : K}, optin};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return cudaSuccess;
  }
  Config c{};
  if (K <= kStagedMaxK) {
    const void* kernel = reinterpret_cast<const void*>(cd_staged_kernel<T>);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, card);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    const int L = staged_lanes(K);
    for (int w = 1; w <= 8; w <<= 1) {
      const int rows_pb = w * 32 / L;
      const size_t smem = staged_smem(K, L, rows_pb, shared_g, sizeof(T));
      if (smem > static_cast<size_t>(optin)) break;
      int blocks = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, 32 * w, smem);
      if (e != cudaSuccess) return e;
      if (blocks * rows_pb > c.blocks * c.rows_pb)
        c = Config{1, L, w, rows_pb, blocks, static_cast<int>(smem), 0};
    }
    if (c.blocks == 0) return cudaErrorInvalidValue;
  } else {
    const size_t row_bytes = static_cast<size_t>(6) * K * sizeof(T);
    int warps = kStreamWarps;
    while (warps > 1 && warps * row_bytes > static_cast<size_t>(optin)) warps >>= 1;
    const int scratch = warps * row_bytes > static_cast<size_t>(optin);
    if (scratch) warps = kStreamWarps;
    const size_t smem = scratch ? 0 : warps * row_bytes;
    int blocks = 0;
    e = cudaFuncSetAttribute(cd_stream_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             card);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cd_stream_kernel<T>, warps * 32,
                                                        smem);
    if (e != cudaSuccess) return e;
    if (blocks == 0) return cudaErrorInvalidValue;
    c = Config{0, 32, warps, warps, blocks, static_cast<int>(smem), scratch};
  }
  cache.emplace(key, c);
  *out = c;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(Args A, int optin, cudaStream_t st) {
  if (A.R <= 0 || A.K <= 0) return cudaErrorInvalidValue;
  Config c{};
  const cudaError_t e = config<T>(A.K, A.g_stride == 0, optin, &c);
  if (e != cudaSuccess) return e;
  long long blocks = (static_cast<long long>(A.R) + c.rows_pb - 1) / c.rows_pb;
  if (c.scratch) {  // the warps the scratch has room for walk the rows
    if (A.scratch == nullptr || A.scratch_rows < c.warps || A.scratch_rows % c.warps)
      return cudaErrorInvalidValue;
    blocks = A.scratch_rows / c.warps;
  } else {
    A.scratch = nullptr;
  }
  if (c.staged)
    cd_staged_kernel<T><<<static_cast<unsigned>(blocks), c.warps * 32, c.smem, st>>>(A, c.lanes);
  else
    cd_stream_kernel<T><<<static_cast<unsigned>(blocks), c.warps * 32, c.smem, st>>>(A);
  return cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes).  G, rhs, l1 and out are contiguous in the layouts
// above, on the current device, 16-byte aligned; K >= 1, R >= 1.  `optin`: the shared
// memory a block the launch may take (0: the card's opt-in).  Where cmf_cd_plan
// reports the scratch configuration, `scratch` is [scratch_rows, 6, K] of the type,
// scratch_rows a multiple of the plan's warps a block (otherwise both are ignored).
// Returns the launch's cudaError_t (0 on success); the kernel runs asynchronously on
// `stream`.
extern "C" int cmf_cd_solve(const void* G, long long g_stride, const void* rhs,
                            const void* l1, int l1_stride, void* out, void* sweeps,
                            void* scratch, int scratch_rows, int R, int K, int nonneg,
                            int max_steps, double tol, int is_f64, int optin, void* stream) {
  const Args A{G, g_stride, rhs, l1, l1_stride, out, static_cast<int*>(sweeps), scratch,
               scratch_rows, R, K, nonneg, max_steps, tol};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(is_f64 ? launch<double>(A, optin, st) : launch<float>(A, optin, st));
}

// The launch that cmf_cd_solve takes at width K (shared_g: G of row stride 0) within
// `optin` bytes of shared memory (0: the card's) on the current device, from the same
// record: out = {staged, lanes a row, warps a block, rows a block, resident blocks an
// SM, shared memory bytes a block, scratch}.
extern "C" int cmf_cd_plan(int K, int shared_g, int is_f64, int optin, int* out) {
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Config c{};
  const cudaError_t e = is_f64 ? config<double>(K, shared_g != 0, optin, &c)
                               : config<float>(K, shared_g != 0, optin, &c);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int v[7] = {c.staged, c.lanes, c.warps, c.rows_pb, c.blocks, c.smem, c.scratch};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return cudaSuccess;
}
