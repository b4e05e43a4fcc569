// The first design of K1's bf16 kernel (gram_bf16_kernel: synchronous
// 64-wide tiles, mma.sync products, no split-S), which k1_probes.cu
// instantiates whole and with one piece changed, and the helpers it shares
// with K2 and the production K1 in masked_matmul.cu.  See masked_matmul.cu
// for what K1 computes.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;  // rows of Q / X / W per block (4 warps of 16 rows)
constexpr int BS = 64;  // width of the S tile streamed through shared memory
constexpr int BN = 64;  // output columns per block; gridDim.y = K / BN

using bf16_t = __nv_bfloat16;

// Padding of a shared-memory W tile row, in elements: spreads the fragment
// reads of eight rows over distinct banks.
template <typename WT> struct WPad;
template <> struct WPad<int8_t> { static constexpr int v = 16; };
template <> struct WPad<bf16_t> { static constexpr int v = 8; };
template <> struct WPad<float> { static constexpr int v = 8; };

__device__ __forceinline__ float bf16_bits_to_float(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

__device__ __forceinline__ float to_f32(int8_t w) { return static_cast<float>(w); }
__device__ __forceinline__ float to_f32(float w) { return w; }
__device__ __forceinline__ float to_f32(bf16_t w) { return __bfloat162float(w); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bits(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// D += A B for one 16x8x16 bf16 tile, f32 accumulate (PTX fragment layouts).
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Copy `rows` rows of `row_bytes` bytes (a multiple of 16) from global memory
// into shared memory, 16 bytes a thread.
template <int NT>
__device__ __forceinline__ void copy_tile(void* dst, int dst_stride, const void* src,
                                          size_t src_stride, int rows, int row_bytes) {
  const int per_row = row_bytes / 16;
  const int total = rows * per_row;
  for (int i = threadIdx.x; i < total; i += NT) {
    const int r = i / per_row;
    const int c = i - r * per_row;
    const uint4* s = reinterpret_cast<const uint4*>(
        static_cast<const char*>(src) + r * src_stride + c * 16);
    uint4* d = reinterpret_cast<uint4*>(static_cast<char*>(dst) + r * dst_stride + c * 16);
    *d = *s;
  }
}

// out[16 rows of this warp, BN cols] += P[16, BS] Be[s0:s0+BS, n0:n0+BN], where
// p[j][0] / p[j][1] hold P's rows g / g+8 at columns 8j+2t, 8j+2t+1 as bf16x2
// (the layout of an m16n8 accumulator fragment, reused as A fragments).
__device__ __forceinline__ void accumulate_out(float (&acc_o)[8][4], const uint32_t (&p)[8][2],
                                               const uint16_t* Bs, int ldk, int n0, int g,
                                               int t) {
#pragma unroll
  for (int kk = 0; kk < BS / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const uint16_t* bb = Bs + (kk * 16 + 2 * t) * ldk + n0 + c * 8 + g;
      const uint32_t b0 = pack_bits(bb[0], bb[ldk]);
      const uint32_t b1 = pack_bits(bb[8 * ldk], bb[9 * ldk]);
      mma_bf16(acc_o[c], p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1], b0,
               b1);
    }
  }
}

// Rows `row` and `row + 8` of an [R, *] f32 output with row stride `ldo`.
__device__ __forceinline__ void store_out_bf16(float* out, const float (&acc_o)[8][4],
                                               size_t row, size_t ldo, int n0, int t) {
#pragma unroll
  for (int c = 0; c < BN / 8; ++c) {
    float* o = out + row * ldo + n0 + c * 8 + 2 * t;
    *reinterpret_cast<float2*>(o) = make_float2(acc_o[c][0], acc_o[c][1]);
    *reinterpret_cast<float2*>(o + 8 * ldo) = make_float2(acc_o[c][2], acc_o[c][3]);
  }
}

// What gram_bf16_kernel does with each S tile.  kFull is K1 whole; the
// others are the probes of its time (k1_probes.cu), each with one piece
// changed.
enum class Body : int {
  kFull = 0,  // ((Q Be^T) * W) Be, T*W rounded to bf16 once
  kDots = 1,  // both products, no W tile loaded, T rounded to bf16
  kDot1 = 2,  // the first product only: T's row sums broadcast over K
  kWsum = 3,  // the W tiles only, copied as K1 copies them: their row sums
  kSel = 4,   // the mask applied as a select: W != 0 ? T : 0
  kBft = 5,   // T rounded to bf16 before the multiply by W
  kPart = 6,  // kFull over one S chunk a block (gridDim.z chunks): partial
              // sums to [R, gridDim.z, K]
};

// T * W as the second product's operand (before its rounding to bf16).  A
// bf16 W meets T rounded to bf16, as on the TPU (masked_matmul.py:94).
template <typename WT, Body B>
__device__ __forceinline__ float mask(float t, WT w) {
  if constexpr (B == Body::kDots) {
    return t;
  } else if constexpr (B == Body::kSel) {
    return to_f32(w) != 0.f ? t : 0.f;
  } else if constexpr (B == Body::kBft || std::is_same<WT, bf16_t>::value) {
    return round_bf16(t) * to_f32(w);
  } else {
    return t * to_f32(w);
  }
}

// ---------------------------------------------------------------- K1, bf16
// WARPS warps; warp w owns rows 16w..16w+15 of the block's 16 * WARPS.  With
// 8 warps R need not be a multiple of the block: the rows past R are not
// loaded and their results are not stored.  `chunk` is read by kPart only.
template <typename WT, Body B = Body::kFull, int WARPS = 4>
__global__ void __launch_bounds__(32 * WARPS)
    gram_bf16_kernel(const uint16_t* __restrict__ Q, const uint16_t* __restrict__ Be,
                     const WT* __restrict__ W, float* __restrict__ out, int R, int S, int K,
                     int chunk) {
  constexpr int NT = 32 * WARPS, BMR = 16 * WARPS;
  constexpr bool load_qb = B != Body::kWsum;
  constexpr bool load_w = B != Body::kDots && B != Body::kDot1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = K + 8;
  constexpr int ldw = BS + WPad<WT>::v;
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Bs = Qs + BMR * ldk;
  WT* Ws = reinterpret_cast<WT*>(Bs + BS * ldk);

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * BMR;
  const int n0 = blockIdx.y * BN;
  int rows = BMR;
  if constexpr (BMR != BM) rows = min(BMR, R - static_cast<int>(row0));
  int s_begin = 0, s_end = S;
  size_t ldo = K;
  if constexpr (B == Body::kPart) {
    s_begin = blockIdx.z * chunk;
    s_end = min(S, s_begin + chunk);
    ldo = static_cast<size_t>(gridDim.z) * K;
    out += static_cast<size_t>(blockIdx.z) * K;
  }

  if constexpr (load_qb)
    copy_tile<NT>(Qs, ldk * 2, Q + row0 * K, static_cast<size_t>(K) * 2, rows, K * 2);

  float acc_o[8][4] = {};
  float rsum[2] = {};  // kDot1 / kWsum: row sums of rows g and g+8
  for (int s0 = s_begin; s0 < s_end; s0 += BS) {
    __syncthreads();  // the previous tile is consumed
    if constexpr (load_qb)
      copy_tile<NT>(Bs, ldk * 2, Be + static_cast<size_t>(s0) * K, static_cast<size_t>(K) * 2,
                    BS, K * 2);
    if constexpr (load_w)
      copy_tile<NT>(Ws, ldw * sizeof(WT), W + row0 * S + s0,
                    static_cast<size_t>(S) * sizeof(WT), rows, BS * sizeof(WT));
    __syncthreads();

    if constexpr (B == Body::kWsum) {
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const WT* w0 = Ws + (wr + g) * ldw + j * 8 + 2 * t;
        const WT* w1 = w0 + 8 * ldw;
        rsum[0] += to_f32(w0[0]) + to_f32(w0[1]);
        rsum[1] += to_f32(w1[0]) + to_f32(w1[1]);
      }
      continue;
    }

    // T[16, BS] = Q[16, K] Be_tile^T
    float acc_t[8][4] = {};
    for (int kk = 0; kk < K; kk += 16) {
      const uint16_t* qa = Qs + (wr + g) * ldk + kk + 2 * t;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(qa);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(qa + 8 * ldk);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(qa + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(qa + 8 * ldk + 8);
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        const uint16_t* bb = Bs + (j * 8 + g) * ldk + kk + 2 * t;
        mma_bf16(acc_t[j], a0, a1, a2, a3, *reinterpret_cast<const uint32_t*>(bb),
                 *reinterpret_cast<const uint32_t*>(bb + 8));
      }
    }
    if constexpr (B == Body::kDot1) {
#pragma unroll
      for (int j = 0; j < BS / 8; ++j) {
        rsum[0] += acc_t[j][0] + acc_t[j][1];
        rsum[1] += acc_t[j][2] + acc_t[j][3];
      }
      continue;
    }
    // T * W in f32, rounded once to bf16
    uint32_t p[8][2];
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) {
      const WT* w0 = Ws + (wr + g) * ldw + j * 8 + 2 * t;
      const WT* w1 = w0 + 8 * ldw;
      p[j][0] = pack_bf16(mask<WT, B>(acc_t[j][0], w0[0]), mask<WT, B>(acc_t[j][1], w0[1]));
      p[j][1] = pack_bf16(mask<WT, B>(acc_t[j][2], w1[0]), mask<WT, B>(acc_t[j][3], w1[1]));
    }
    accumulate_out(acc_o, p, Bs, ldk, n0, g, t);
  }
  if constexpr (B == Body::kDot1 || B == Body::kWsum) {
    // the four lanes of a row hold its partial sums; broadcast over K
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(0xffffffffu, rsum[i], 2);
    }
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      acc_o[c][0] = acc_o[c][1] = rsum[0];
      acc_o[c][2] = acc_o[c][3] = rsum[1];
    }
  }
  if (BMR == BM || wr < rows) store_out_bf16(out, acc_o, row0 + wr + g, ldo, n0, t);
}

// Shared memory of gram_bf16_kernel<WT, *, WARPS> at width K.
template <typename WT, int WARPS = 4>
size_t gram_bf16_smem(int K) {
  return static_cast<size_t>(16 * WARPS + BS) * (K + 8) * 2 +
         static_cast<size_t>(16 * WARPS) * (BS + WPad<WT>::v) * sizeof(WT);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
