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
// ::bucket_cg_packed (_cg_kernel_packed, which packs two slab entries per 128-lane row
// for K <= 64, a TPU lane-layout trick with no Hopper counterpart: this kernel takes
// any K that is a multiple of 8 up to 256).  The TPU kernel took a slab ms[R,L,K]
// gathered by XLA; this one gathers each m_l itself from the index array.
//
// Numerics follow the plain twin (cmfrec_torch/ops/sparse_cg.py::bucket_cg_ref, the
// rounding points of rowsolve._part_matvec): with a bf16 mat the direction v,
// t_l = (m_l . v) * cw_l and cv_l are rounded to bf16 where they meet m_l; every
// product is exact in f32 and every sum f32.  (The Pallas body multiplies in bf16
// before summing, sparse_cg.py:66; its JAX test allows 2e-2 against
// solve_cg(mxu_bf16=True) for that.)  Stop rule of rowsolve.cg_iterations: a row is
// live iff its initial r.r > 1e-12, and freezes once r.r <= 1e-8; the remaining steps
// of a frozen row are exact no-ops, so its block leaves the loop.
//
// Layout: one block per row.  Warps take chunks of kGroup consecutive slots, strided
// by the block's warp count, up to length[r]; a lane holds the coordinate pairs
// 2*lane + 64*i of a gathered row, so a warp reads each row as one contiguous 2K-byte
// (bf16) or 4K-byte (f32) segment.  A warp starts its kGroup rows' loads before their
// dot products, whose shuffle reductions then run side by side.  Each warp
// accumulates t_l m_l in registers; the block adds the warps' partials through shared
// memory, and warp 0 does the K-vector work and the CG scalars.  gfix v is formed by
// all threads from gfix read through L1/L2 (at K = 256 it is 256 KB and would not fit
// shared memory).  The rhs build shares the first pass with the first matvec.
//
// A row whose gathered rows and cw fit kStageBytes of shared memory stages them on the
// first pass and the later passes read them there; a wider row re-gathers from global
// memory on every pass (the opposing matrix, 18-40 MB in bf16 at the LastFM shape,
// mostly stays in the 50 MB L2).
//
// What bounds it on an H100: bytes in the wide buckets.  Each slot needs idx, cw and cv
// (12 B) and its gathered row (2K B in bf16), against ~(n_steps+2)*4K flops (~9 flop/B
// at K=56), far below the ridge.  In the narrow buckets the K x K gfix product of each
// row and pass (2K^2 flops) outweighs the few slots, and f32 operations bound it
// there.  Known costs, for later work: the widest buckets hold few rows (40
// at L = 31,592 at the LastFM shape) and underfill the 132 SMs (a split-L variant
// would fix that), and the narrow buckets (60k-100k rows at L = 32-48) want several
// rows per block.
//
// Build: with masked_matmul.cu into libcmfrec_kernels (cmfrec_torch/ops/_cuda.py):
//        nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kSkipTol = 1e-12f;
constexpr float kFreezeTol = 1e-8f;
constexpr int kGroup = 4;                // slots a warp loads before reducing
constexpr size_t kStageBytes = 40 * 1024;  // gathered rows + cw staged per block
constexpr unsigned kFull = 0xffffffffu;

// A pair of neighbouring coordinates of one row of mat, as loaded.
template <typename T> struct Op;

template <> struct Op<float> {
  using Raw = float2;
  static __device__ __forceinline__ Raw ldg(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ float lo(Raw v) { return v.x; }
  static __device__ __forceinline__ float hi(Raw v) { return v.y; }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <> struct Op<uint16_t> {  // bf16 bits
  using Raw = uint32_t;
  static __device__ __forceinline__ Raw ldg(const uint16_t* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return 0u; }
  static __device__ __forceinline__ float lo(Raw v) { return __uint_as_float(v << 16); }
  static __device__ __forceinline__ float hi(Raw v) { return __uint_as_float(v & 0xffff0000u); }
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

// One pass over the row's slots with direction v (shared memory, f32):
//   red[warp][:]  = this warp's sum of t_l m_l,  t_l = round(round(v) . m_l * cw_l)
//   red2[warp][:] = this warp's sum of round(cv_l) m_l            (RHS only)
//   g[:]          = gfix v
template <typename T, int NP, bool RHS>
__device__ __forceinline__ void slot_pass(const T* __restrict__ mat, const int* __restrict__ idx_r,
                                          const float* __restrict__ cw_r,
                                          const float* __restrict__ cv_r,
                                          const float* __restrict__ gfix, const float* v,
                                          float* red, float* red2, float* g, T* slab,
                                          float* scw, int len, int K, int stage) {
  using O = Op<T>;
  using Raw = typename O::Raw;
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  float vr[NP][2];
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c = 2 * lane + 64 * i;
    vr[i][0] = c < K ? O::round(v[c]) : 0.f;
    vr[i][1] = c < K ? O::round(v[c + 1]) : 0.f;
  }
  float acc[NP][2] = {}, racc[NP][2] = {};
  for (int l0 = warp * kGroup; l0 < len; l0 += nw * kGroup) {
    Raw m[kGroup][NP];
    float w[kGroup], cvl[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int l = l0 + q;
      const bool ok = l < len;  // warp-uniform
      w[q] = 0.f;
      cvl[q] = 0.f;
      if (ok && stage == kReadStage) {
        const T* src = slab + static_cast<size_t>(l) * K;
        w[q] = scw[l];
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int c = 2 * lane + 64 * i;
          m[q][i] = c < K ? *reinterpret_cast<const Raw*>(src + c) : O::zero();
        }
      } else if (ok) {
        const T* src = mat + static_cast<size_t>(__ldg(idx_r + l)) * K;
        w[q] = __ldg(cw_r + l);
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int c = 2 * lane + 64 * i;
          m[q][i] = c < K ? O::ldg(src + c) : O::zero();
        }
      } else {
#pragma unroll
        for (int i = 0; i < NP; ++i) m[q][i] = O::zero();
      }
      if (RHS && ok) cvl[q] = __ldg(cv_r + l);
    }
    if (stage == kWriteStage) {
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        const int l = l0 + q;
        if (l >= len) break;
        T* dst = slab + static_cast<size_t>(l) * K;
#pragma unroll
        for (int i = 0; i < NP; ++i) {
          const int c = 2 * lane + 64 * i;
          if (c < K) *reinterpret_cast<Raw*>(dst + c) = m[q][i];
        }
        if (lane == 0) scw[l] = w[q];
      }
    }
    float d[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      d[q] = 0.f;
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        d[q] = fmaf(O::lo(m[q][i]), vr[i][0], d[q]);
        d[q] = fmaf(O::hi(m[q][i]), vr[i][1], d[q]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < kGroup; ++q) d[q] += __shfl_xor_sync(kFull, d[q], o);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const float t = O::round(d[q] * w[q]);
      const float cr = O::round(cvl[q]);
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        acc[i][0] = fmaf(t, O::lo(m[q][i]), acc[i][0]);
        acc[i][1] = fmaf(t, O::hi(m[q][i]), acc[i][1]);
        if (RHS) {
          racc[i][0] = fmaf(cr, O::lo(m[q][i]), racc[i][0]);
          racc[i][1] = fmaf(cr, O::hi(m[q][i]), racc[i][1]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int c = 2 * lane + 64 * i;
    if (c < K) {
      red[warp * K + c] = acc[i][0];
      red[warp * K + c + 1] = acc[i][1];
      if (RHS) {
        red2[warp * K + c] = racc[i][0];
        red2[warp * K + c + 1] = racc[i][1];
      }
    }
  }
  for (int c = threadIdx.x; c < K; c += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < K; ++j) s = fmaf(__ldg(gfix + static_cast<size_t>(j) * K + c), v[j], s);
    g[c] = s;
  }
}

template <typename T, int NP>
__global__ void __launch_bounds__(512)
    bucket_cg_kernel(const T* __restrict__ mat, const int* __restrict__ idx,
                     const float* __restrict__ cw, const float* __restrict__ cv,
                     const float* __restrict__ gfix, const float* __restrict__ lam_row,
                     const float* __restrict__ r0, const float* __restrict__ a0,
                     const int* __restrict__ length, float* __restrict__ out, int L, int K,
                     int n_steps, size_t stage_offset, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* s_a = reinterpret_cast<float*>(smem);
  float* s_r = s_a + K;
  float* s_p = s_r + K;
  float* s_q = s_p + K;
  float* s_g = s_q + K;
  float* s_red = s_g + K;           // [nw][K]
  float* s_red2 = s_red + nw * K;   // [nw][K]
  float* s_scal = s_red2 + nw * K;  // rz, live
  T* s_slab = reinterpret_cast<T*>(smem + stage_offset);  // [L][K] when staged
  float* s_cw = reinterpret_cast<float*>(s_slab + static_cast<size_t>(L) * K);

  const size_t row = blockIdx.x;
  const int len = min(length[row], L);
  const int* idx_r = idx + row * L;
  const float* cw_r = cw + row * L;
  const float* cv_r = cv + row * L;
  const float* lam_r = lam_row ? lam_row + row * K : nullptr;

  for (int c = threadIdx.x; c < K; c += blockDim.x) s_a[c] = a0[row * K + c];
  __syncthreads();

  // rhs and A a0 in one pass; r = rhs - A a0, p = r
  slot_pass<T, NP, true>(mat, idx_r, cw_r, cv_r, gfix, s_a, s_red, s_red2, s_g, s_slab, s_cw,
                         len, K, staged ? kWriteStage : kNoStage);
  __syncthreads();
  if (warp == 0) {
    float part = 0.f;
    for (int c = lane; c < K; c += 32) {
      float mv = 0.f, rhs = 0.f;
      for (int w = 0; w < nw; ++w) {
        mv += s_red[w * K + c];
        rhs += s_red2[w * K + c];
      }
      mv += s_g[c];
      if (lam_r) mv += lam_r[c] * s_a[c];
      if (r0) rhs += r0[row * K + c];
      const float res = rhs - mv;
      s_r[c] = res;
      s_p[c] = res;
      part = fmaf(res, res, part);
    }
    const float rz = warp_sum(part);
    if (lane == 0) {
      s_scal[0] = rz;
      s_scal[1] = rz > kSkipTol ? 1.f : 0.f;
    }
  }
  __syncthreads();

  for (int step = 0; step < n_steps; ++step) {
    if (s_scal[1] == 0.f) break;  // frozen (or skipped): the rest are no-ops
    slot_pass<T, NP, false>(mat, idx_r, cw_r, cv_r, gfix, s_p, s_red, s_red2, s_g, s_slab, s_cw,
                            len, K, staged ? kReadStage : kNoStage);
    __syncthreads();
    if (warp == 0) {
      const float rz = s_scal[0];
      float part = 0.f;
      for (int c = lane; c < K; c += 32) {
        float q = 0.f;
        for (int w = 0; w < nw; ++w) q += s_red[w * K + c];
        q += s_g[c];
        if (lam_r) q += lam_r[c] * s_p[c];
        s_q[c] = q;
        part = fmaf(s_p[c], q, part);
      }
      const float denom = warp_sum(part);
      const float alpha = rz / (denom == 0.f ? 1.f : denom);
      part = 0.f;
      for (int c = lane; c < K; c += 32) {
        s_a[c] += alpha * s_p[c];
        const float res = s_r[c] - alpha * s_q[c];
        s_r[c] = res;
        part = fmaf(res, res, part);
      }
      const float rz_new = warp_sum(part);
      const bool live = rz_new > kFreezeTol;
      if (live) {
        const float beta = rz_new / (rz == 0.f ? 1.f : rz);
        for (int c = lane; c < K; c += 32) s_p[c] = s_r[c] + beta * s_p[c];
      }
      if (lane == 0) {
        if (live) s_scal[0] = rz_new;
        s_scal[1] = live ? 1.f : 0.f;
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < K; c += blockDim.x) out[row * K + c] = s_a[c];
}

template <typename T, int NP>
cudaError_t launch(const void* mat, const void* idx, const void* cw, const void* cv,
                   const void* gfix, const void* lam_row, const void* r0, const void* a0,
                   const void* length, void* out, int R, int L, int K, int n_steps,
                   cudaStream_t stream) {
  const int nw = L >= 4096 ? 16 : (L >= 512 ? 8 : 4);
  const size_t base = ((static_cast<size_t>(5 + 2 * nw) * K + 4) * sizeof(float) + 15) / 16 * 16;
  const size_t stage = static_cast<size_t>(L) * K * sizeof(T) + static_cast<size_t>(L) * sizeof(float);
  const int staged = stage <= kStageBytes;
  const size_t smem = base + (staged ? stage : 0);
  auto kernel = bucket_cg_kernel<T, NP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<R, nw * 32, smem, stream>>>(
      static_cast<const T*>(mat), static_cast<const int*>(idx), static_cast<const float*>(cw),
      static_cast<const float*>(cv), static_cast<const float*>(gfix),
      static_cast<const float*>(lam_row), static_cast<const float*>(r0),
      static_cast<const float*>(a0), static_cast<const int*>(length), static_cast<float*>(out),
      L, K, n_steps, base, staged);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* mat, const void* idx, const void* cw, const void* cv,
                     const void* gfix, const void* lam_row, const void* r0, const void* a0,
                     const void* length, void* out, int R, int L, int K, int n_steps,
                     cudaStream_t st) {
  switch ((K + 63) / 64) {
    case 1:
      return launch<T, 1>(mat, idx, cw, cv, gfix, lam_row, r0, a0, length, out, R, L, K, n_steps, st);
    case 2:
      return launch<T, 2>(mat, idx, cw, cv, gfix, lam_row, r0, a0, length, out, R, L, K, n_steps, st);
    case 3:
      return launch<T, 3>(mat, idx, cw, cv, gfix, lam_row, r0, a0, length, out, R, L, K, n_steps, st);
    case 4:
      return launch<T, 4>(mat, idx, cw, cv, gfix, lam_row, r0, a0, length, out, R, L, K, n_steps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (bound with ctypes).  The caller guarantees K % 8 == 0, 8 <= K <= 256,
// R >= 1, L >= 1, contiguous row-major tensors on the current device, 16-byte-aligned
// base pointers and idx values in [0, S).  lam_row and r0 may be null.
// Returns the launch's cudaError_t (0 on success); the kernel runs asynchronously on
// `stream`.
extern "C" int cmf_bucket_cg(const void* mat, const void* idx, const void* cw, const void* cv,
                             const void* gfix, const void* lam_row, const void* r0,
                             const void* a0, const void* length, void* out, int R, int L, int K,
                             int n_steps, int mat_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      mat_f32 ? dispatch<float>(mat, idx, cw, cv, gfix, lam_row, r0, a0, length, out, R, L, K,
                                n_steps, st)
              : dispatch<uint16_t>(mat, idx, cw, cv, gfix, lam_row, r0, a0, length, out, R, L,
                                   K, n_steps, st));
}
