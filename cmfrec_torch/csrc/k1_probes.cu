// Probes of K1's time on Hopper (sm_90a): the first design of K1's bf16
// kernel, whole or with one piece changed, and a W-stream kernel at several
// tile geometries.
//
// They replace the TPU probes of the Pallas K1 body:
//   P1 scripts/sweep_kernel_probe2.py  call3 (p_full, p_dots, p_dot1, p_wsum)
//                                      and part_call (p_part)
//   P2 scripts/sweep_kernel_variants.py make_call (v0, vbf, vsel, vw16, vbig)
//   P3 scripts/sweep_kernel_probe3.py  make_wsum (the W stream at several
//                                      block geometries, int8 and bf16 W)
//
// cmf_k1_probe launches gram_bf16_kernel<WT, Body, WARPS> (masked_gram.cuh):
// the first design of K1 (synchronous 64-wide tiles, mma.sync products, no
// split-S), whole (Body::kFull, the yardstick of the production K1 in
// masked_matmul.cu) or with the piece named by `body` changed, with 4 warps
// (64-row blocks) or 8 (128-row blocks: vbig).  kPart splits S into
// `chunk`-wide pieces over gridDim.z and writes partial sums to
// out[R, ceil(S / chunk), K], which the caller sums; the others write
// out[R, K].
//
// cmf_w_stream streams W through shared memory in (TR x TC) tiles, copied
// as K1 copies its W tiles (synchronously, 16 bytes a thread), and writes
// each row's sum broadcast over out[R, K]: the W stream's floor at each tile
// geometry.  It reads the tile back from shared memory 16 bytes a thread
// (int8 summed with __dp4a), so the sum costs little beside the copy.
//
// What bounds them on an H100: the W stream (0.75 GB int8 at the flagship
// shape) at 3.35 TB/s, and for the bodies with products K1's 4*R*S*K bf16
// operations at 989 TFLOP/s.  These kernels are simple on purpose (no
// pipelining, no wgmma): they measure where that design of K1 spends its time.

#include "masked_gram.cuh"

namespace {

__device__ __forceinline__ float sum16(const uint4& v, int8_t) {
  int s = __dp4a(static_cast<int>(v.x), 0x01010101, 0);
  s = __dp4a(static_cast<int>(v.y), 0x01010101, s);
  s = __dp4a(static_cast<int>(v.z), 0x01010101, s);
  s = __dp4a(static_cast<int>(v.w), 0x01010101, s);
  return static_cast<float>(s);
}

__device__ __forceinline__ float sum16(const uint4& v, bf16_t) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s += bf16_bits_to_float(static_cast<uint16_t>(w[i] & 0xffffu)) +
         bf16_bits_to_float(static_cast<uint16_t>(w[i] >> 16));
  return s;
}

// 128 threads.  A block owns TR rows (the last block may hold fewer) and
// walks S in TC-wide tiles (the last may be narrower).  Below 128 rows, TPR =
// 128 / TR neighbouring threads share a row; from 128 rows on, a thread owns
// TR / 128 rows.
template <typename WT, int TR, int TC>
__global__ void __launch_bounds__(128)
    w_stream_kernel(const WT* __restrict__ W, float* __restrict__ out, int R, int S, int K) {
  constexpr int NT = 128;
  constexpr int TPR = TR >= NT ? 1 : NT / TR;  // threads per row
  constexpr int RPT = TR >= NT ? TR / NT : 1;  // rows per thread
  constexpr int LDB = TC * sizeof(WT) + 16;    // shared-memory row, bytes
  extern __shared__ __align__(16) unsigned char smem[];

  const int rr = threadIdx.x / TPR, tr = threadIdx.x % TPR;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * TR;
  const int rows = min(TR, R - static_cast<int>(row0));
  float acc[RPT] = {};
  for (int s0 = 0; s0 < S; s0 += TC) {
    const int chunks = min(TC, S - s0) * static_cast<int>(sizeof(WT)) / 16;
    __syncthreads();
    copy_tile<NT>(smem, LDB, W + row0 * S + s0, static_cast<size_t>(S) * sizeof(WT), rows,
                  chunks * 16);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rr + i * (NT / TPR);
      if (r < rows)
        for (int c = tr; c < chunks; c += TPR)
          acc[i] += sum16(*reinterpret_cast<const uint4*>(smem + r * LDB + c * 16), WT{});
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int off = TPR / 2; off > 0; off /= 2)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    const int r = rr + i * (NT / TPR);
    if (r < rows)
      for (int k = tr; k < K; k += TPR) out[(row0 + r) * K + k] = acc[i];
  }
}

template <typename WT, Body B, int WARPS>
cudaError_t probe(const void* Q, const void* Be, const void* W, void* out, int R, int S, int K,
                  int chunk, cudaStream_t stream) {
  constexpr int BMR = 16 * WARPS;
  const dim3 grid((R + BMR - 1) / BMR, K / BN, B == Body::kPart ? (S + chunk - 1) / chunk : 1);
  return launch(gram_bf16_kernel<WT, B, WARPS>, grid, 32 * WARPS, gram_bf16_smem<WT, WARPS>(K),
                stream, static_cast<const uint16_t*>(Q), static_cast<const uint16_t*>(Be),
                static_cast<const WT*>(W), static_cast<float*>(out), R, S, K, chunk);
}

template <typename WT>
cudaError_t probe_w(const void* Q, const void* Be, const void* W, void* out, int R, int S,
                    int K, int body, int warps, int chunk, cudaStream_t st) {
  if (warps == 8) {
    if (body != static_cast<int>(Body::kBft)) return cudaErrorInvalidValue;
    return probe<WT, Body::kBft, 8>(Q, Be, W, out, R, S, K, chunk, st);
  }
  if (warps != 4) return cudaErrorInvalidValue;
  switch (static_cast<Body>(body)) {
    case Body::kFull: return probe<WT, Body::kFull, 4>(Q, Be, W, out, R, S, K, chunk, st);
    case Body::kDots: return probe<WT, Body::kDots, 4>(Q, Be, W, out, R, S, K, chunk, st);
    case Body::kDot1: return probe<WT, Body::kDot1, 4>(Q, Be, W, out, R, S, K, chunk, st);
    case Body::kWsum: return probe<WT, Body::kWsum, 4>(Q, Be, W, out, R, S, K, chunk, st);
    case Body::kSel: return probe<WT, Body::kSel, 4>(Q, Be, W, out, R, S, K, chunk, st);
    case Body::kBft: return probe<WT, Body::kBft, 4>(Q, Be, W, out, R, S, K, chunk, st);
    case Body::kPart: return probe<WT, Body::kPart, 4>(Q, Be, W, out, R, S, K, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename WT, int TR, int TC>
cudaError_t stream_tile(const void* W, void* out, int R, int S, int K, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(TR) * (TC * sizeof(WT) + 16);
  return launch(w_stream_kernel<WT, TR, TC>, dim3((R + TR - 1) / TR), 128, smem, st,
                static_cast<const WT*>(W), static_cast<float*>(out), R, S, K);
}

// The tile geometries (rows x columns) of cmf_w_stream; the Python wrapper
// lists the same ones (ops/k1_probes.py: W_STREAM_TILES).
template <typename WT>
cudaError_t stream_w(const void* W, void* out, int R, int S, int K, int tr, int tc,
                     cudaStream_t st) {
  if (tr == 64 && tc == 64) return stream_tile<WT, 64, 64>(W, out, R, S, K, st);
  if (tr == 128 && tc == 64) return stream_tile<WT, 128, 64>(W, out, R, S, K, st);
  if (tr == 512 && tc == 64) return stream_tile<WT, 512, 64>(W, out, R, S, K, st);
  if (tr == 64 && tc == 256) return stream_tile<WT, 64, 256>(W, out, R, S, K, st);
  if (tr == 256 && tc == 256) return stream_tile<WT, 256, 256>(W, out, R, S, K, st);
  if (tr == 16 && tc == 2048) return stream_tile<WT, 16, 2048>(W, out, R, S, K, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// C interface (bound with ctypes).  The caller guarantees what K1 needs
// (masked_matmul.cu) with bf16 Q/Be, chunk a positive multiple of 64 for
// kPart, and for cmf_w_stream R % 64 == 0, S % 64 == 0 and K > 0.  w_type:
// 0 an int8 mask, 2 bf16 weights (as cmf_masked_gram_matvec).  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for a combination that is not
// built).
extern "C" int cmf_k1_probe(const void* Q, const void* Be, const void* W, void* out, int R,
                            int S, int K, int w_type, int body, int warps, int chunk,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_type == 0)
    return static_cast<int>(probe_w<int8_t>(Q, Be, W, out, R, S, K, body, warps, chunk, st));
  if (w_type == 2)
    return static_cast<int>(probe_w<bf16_t>(Q, Be, W, out, R, S, K, body, warps, chunk, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int cmf_w_stream(const void* W, void* out, int R, int S, int K, int w_type,
                            int tile_rows, int tile_cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_type == 0)
    return static_cast<int>(stream_w<int8_t>(W, out, R, S, K, tile_rows, tile_cols, st));
  if (w_type == 2)
    return static_cast<int>(stream_w<bf16_t>(W, out, R, S, K, tile_rows, tile_cols, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
