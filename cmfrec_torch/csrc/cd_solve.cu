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
// ("done") are the rows that leave the loop here.  In plain torch every coordinate
// step is a handful of small launches over [R] vectors (K of them a sweep, up to
// max_steps sweeps a bucket), which on a card is all launch latency.  Its plain twin
// is cmfrec_torch/ops/rowsolve.py::solve_cd, which computes the same in the same
// order of coordinates.
//
// What bounds it on an H100: operations, 2K^2 FMA-flops a row and sweep against K^2
// elements of G read once (~K/2 flop/B at 4 B), so the f32 rate (67 TFLOP/s) or the
// f64 rate; in practice the latency of each coordinate's chain (the row's loads, a
// shuffle reduction, lane 0's update), since coordinate k+1 needs a[k].
//
// This first design: one warp a row, 8 warps a block, the row's a in shared memory
// (K values a warp, no limit on K: above 48 KB a block takes fewer warps, then opts in
// to more shared memory).  For coordinate k the warp reads G_r[k,:] coalesced, each
// lane forms its partial sum over its coordinates j = lane, lane+32, ..., a shuffle
// reduction gives every lane the sum, lane 0 computes and writes a[k] and the row's
// largest change, and __syncwarp publishes it.  G is read again every sweep (from L2
// or L1 when it is there); shared-memory tiles of G and two rows a warp are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__global__ void cd_solve_kernel(const T* __restrict__ G, long long g_stride,
                                const T* __restrict__ rhs, const T* __restrict__ l1,
                                int l1_stride, T* __restrict__ out, int* __restrict__ sweeps,
                                int R, int K, int nonneg, int max_steps, T tol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  T* a = reinterpret_cast<T*>(smem_raw) + static_cast<size_t>(warp) * K;
  const long long r = static_cast<long long>(blockIdx.x) * warps + warp;
  if (r >= R) return;  // whole warps leave: no barrier below spans warps

  const T* Gr = G + r * g_stride;
  const T* rr = rhs + r * K;
  const T* lr = l1 + r * l1_stride;
  for (int j = lane; j < K; j += 32) a[j] = T(0);
  __syncwarp();

  int steps = 0;
  for (int s = 0; s < max_steps; ++s) {
    T max_delta = T(0);  // held by lane 0
    for (int k = 0; k < K; ++k) {
      const T* gk = Gr + static_cast<long long>(k) * K;
      T part = T(0);
      for (int j = lane; j < K; j += 32) part += gk[j] * a[j];
      const T dot = warp_sum(part);
      if (lane == 0) {
        const T ak = a[k];
        const T gkk = gk[k];
        const T d = gkk <= T(0) ? T(1) : gkk;
        const T num = (rr[k] - dot) + ak * gkk;
        const T l1k = lr[k];
        T nw;
        if (nonneg) {
          nw = fmax(num - l1k, T(0)) / d;
        } else {
          const T mag = fmax(fabs(num) - l1k, T(0));
          nw = (num > T(0) ? mag : (num < T(0) ? -mag : T(0))) / d;
        }
        a[k] = nw;
        max_delta = fmax(max_delta, fabs(nw - ak));
      }
      __syncwarp();
    }
    ++steps;
    if (__shfl_sync(kFull, max_delta, 0) <= tol) break;
  }
  for (int j = lane; j < K; j += 32) out[r * K + j] = a[j];
  if (sweeps != nullptr && lane == 0) sweeps[r] = steps;
}

template <typename T>
cudaError_t launch(const void* G, long long g_stride, const void* rhs, const void* l1,
                   int l1_stride, void* out, int* sweeps, int R, int K, int nonneg,
                   int max_steps, double tol, cudaStream_t st) {
  if (R <= 0 || K <= 0) return cudaErrorInvalidValue;
  const size_t row_bytes = static_cast<size_t>(K) * sizeof(T);
  int warps = kWarps;
  while (warps > 1 && warps * row_bytes > 48 * 1024) warps >>= 1;
  const size_t smem = warps * row_bytes;
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return e;
    if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
    e = cudaFuncSetAttribute(cd_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (static_cast<long long>(R) + warps - 1) / warps;
  cd_solve_kernel<T><<<static_cast<unsigned>(blocks), warps * 32, smem, st>>>(
      static_cast<const T*>(G), g_stride, static_cast<const T*>(rhs),
      static_cast<const T*>(l1), l1_stride, static_cast<T*>(out), sweeps, R, K, nonneg,
      max_steps, static_cast<T>(tol));
  return cudaGetLastError();
}

}  // namespace

extern "C" int cmf_cd_solve(const void* G, long long g_stride, const void* rhs,
                            const void* l1, int l1_stride, void* out, void* sweeps, int R,
                            int K, int nonneg, int max_steps, double tol, int is_f64,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* sw = static_cast<int*>(sweeps);
  return static_cast<int>(
      is_f64 ? launch<double>(G, g_stride, rhs, l1, l1_stride, out, sw, R, K, nonneg,
                              max_steps, tol, st)
             : launch<float>(G, g_stride, rhs, l1, l1_stride, out, sw, R, K, nonneg,
                             max_steps, tol, st));
}
