// Fused masked-Gram kernels of the dense-masked ALS engine, for Hopper (sm_90a).
//
//   K1  cmf_masked_gram_matvec:  out = ((Q Be^T) * W) Be     the CG operator
//   K2  cmf_masked_rhs:          out = ((X - mb) * W) Be     the CG right-hand side
//
// Q:[R,K] and Be:[S,K] are bf16 (bulk iterations) or f32 (the polish and exact
// mode); W:[R,S] is an int8 0/1 mask, bf16 or f32 weights; X:[R,S] holds the
// raw bf16 ratings and mb:[S] the f32 mean plus opposing bias.  out:[R,K] is
// f32.
//
// They replace cmfrec_tpu/ops/masked_matmul.py::masked_gram_matvec (Pallas body
// _matvec_kernel) and ::masked_rhs (_rhs_kernel).  As there, the [R,S]
// intermediate never reaches device memory: a block owns BM rows and BN output
// columns and walks the whole S axis in BS-wide tiles, so the TPU's sequential
// grid axis becomes a loop inside the block and nothing crosses blocks (no
// atomics).  With bf16 operands, T*W is formed in f32 and rounded to bf16 once,
// exactly where the TPU kernel rounds it (masked_matmul.py:96); a bf16 W meets
// T rounded to bf16 first (:94).  K2 and the f32 K1 widen any W to f32.
//
// What bounds them on an H100: one pass over W (1 B/entry int8, 2 B bf16, 4 B f32), plus X
// (2 B/entry) for K2, against 4*R*S*K flops for K1.  At the flagship shape
// (69888 x 10688, K=64) that is ~0.75 GB and ~191 GFLOP per K1 call, near the
// bf16 ridge, so K1 wants the tensor cores: the bf16 variants use mma.sync
// m16n8k16 with the first product's accumulator fragments re-packed in
// registers as the second product's A operand (T never touches shared memory).
// The f32 variants are plain FMA loops over shared-memory tiles (true f32, no
// TF32).  This is the simple first version: no cp.async/TMA pipelining, no
// wgmma, no split-S.  The B half-step has only ~167 row blocks for 132 SMs and a
// 69878-long S loop, so it underfills the card; split-S is later work.  The
// bf16 K1 (gram_bf16_kernel) lives in masked_gram.cuh, which k1_probes.cu
// shares to time its pieces.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcmfrec_kernels.so masked_matmul.cu

#include "masked_gram.cuh"

namespace {

// ---------------------------------------------------------------- K2, bf16
template <typename WT>
__global__ void __launch_bounds__(128)
    rhs_bf16_kernel(const uint16_t* __restrict__ X, const WT* __restrict__ W,
                    const float* __restrict__ mb, const uint16_t* __restrict__ Be,
                    float* __restrict__ out, int S, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = K + 8;
  constexpr int ldx = BS + 8;
  constexpr int ldw = BS + WPad<WT>::v;
  uint16_t* Bs = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Xs = Bs + BS * ldk;
  WT* Ws = reinterpret_cast<WT*>(Xs + BM * ldx);
  float* mbs = reinterpret_cast<float*>(Ws + BM * ldw);

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  float acc_o[8][4] = {};
  for (int s0 = 0; s0 < S; s0 += BS) {
    __syncthreads();
    copy_tile<128>(Bs, ldk * 2, Be + static_cast<size_t>(s0) * K, static_cast<size_t>(K) * 2,
                   BS, K * 2);
    copy_tile<128>(Xs, ldx * 2, X + row0 * S + s0, static_cast<size_t>(S) * 2, BM, BS * 2);
    copy_tile<128>(Ws, ldw * sizeof(WT), W + row0 * S + s0, static_cast<size_t>(S) * sizeof(WT),
                   BM, BS * sizeof(WT));
    copy_tile<128>(mbs, BS * 4, mb + s0, 0, 1, BS * 4);
    __syncthreads();

    // V = (X - mb) * W in f32, rounded once to bf16, built directly as A fragments
    uint32_t p[8][2];
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) {
      const int s = j * 8 + 2 * t;
      const uint16_t* x0 = Xs + (wr + g) * ldx + s;
      const uint16_t* x1 = x0 + 8 * ldx;
      const WT* w0 = Ws + (wr + g) * ldw + s;
      const WT* w1 = w0 + 8 * ldw;
      p[j][0] = pack_bf16((bf16_bits_to_float(x0[0]) - mbs[s]) * to_f32(w0[0]),
                          (bf16_bits_to_float(x0[1]) - mbs[s + 1]) * to_f32(w0[1]));
      p[j][1] = pack_bf16((bf16_bits_to_float(x1[0]) - mbs[s]) * to_f32(w1[0]),
                          (bf16_bits_to_float(x1[1]) - mbs[s + 1]) * to_f32(w1[1]));
    }
    accumulate_out(acc_o, p, Bs, ldk, n0, g, t);
  }
  store_out_bf16(out, acc_o, row0 + wr + g, K, n0, t);
}

// ------------------------------------------------------- f32 (FMA) helpers
// 256 threads as a 16x16 grid; thread (ty, tx) owns rows ty+16i and columns
// tx+16j (i, j < 4) of each 64x64 tile.
constexpr int LDT = BS + 1;

__device__ __forceinline__ void load_f32_tile(float* dst, int ld, const float* src, int rows,
                                              int K) {
  for (int i = threadIdx.x; i < rows * K; i += 256) {
    const int r = i / K;
    const int c = i - r * K;
    dst[r * ld + c] = src[static_cast<size_t>(r) * K + c];
  }
}

// acc_o += Ts[BM, BS] Bs[BS, n0:n0+BN]
__device__ __forceinline__ void accumulate_out_f32(float (&acc_o)[4][4], const float* Ts,
                                                   const float* Bs, int ldk, int n0, int ty,
                                                   int tx) {
  for (int s = 0; s < BS; ++s) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Ts[(ty + 16 * i) * LDT + s];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[s * ldk + n0 + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_o[i][j] = fmaf(a[i], b[j], acc_o[i][j]);
  }
}

__device__ __forceinline__ void store_out_f32(float* out, const float (&acc_o)[4][4],
                                              size_t row0, int K, int n0, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(row0 + ty + 16 * i) * K + n0 + tx + 16 * j] = acc_o[i][j];
}

// ----------------------------------------------------------------- K1, f32
template <typename WT>
__global__ void __launch_bounds__(256)
    gram_f32_kernel(const float* __restrict__ Q, const float* __restrict__ Be,
                    const WT* __restrict__ W, float* __restrict__ out, int S, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = K + 1;
  float* Qs = reinterpret_cast<float*>(smem);
  float* Bs = Qs + BM * ldk;
  float* Ts = Bs + BS * ldk;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  load_f32_tile(Qs, ldk, Q + row0 * K, BM, K);

  float acc_o[4][4] = {};
  for (int s0 = 0; s0 < S; s0 += BS) {
    __syncthreads();
    load_f32_tile(Bs, ldk, Be + static_cast<size_t>(s0) * K, BS, K);
    __syncthreads();

    float acc[4][4] = {};
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * ldk + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * ldk + k];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, s = tx + 16 * j;
        Ts[r * LDT + s] = acc[i][j] * to_f32(W[(row0 + r) * S + s0 + s]);
      }
    __syncthreads();
    accumulate_out_f32(acc_o, Ts, Bs, ldk, n0, ty, tx);
  }
  store_out_f32(out, acc_o, row0, K, n0, ty, tx);
}

// ----------------------------------------------------------------- K2, f32
template <typename WT>
__global__ void __launch_bounds__(256)
    rhs_f32_kernel(const uint16_t* __restrict__ X, const WT* __restrict__ W,
                   const float* __restrict__ mb, const float* __restrict__ Be,
                   float* __restrict__ out, int S, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = K + 1;
  float* Bs = reinterpret_cast<float*>(smem);
  float* Ts = Bs + BS * ldk;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  float acc_o[4][4] = {};
  for (int s0 = 0; s0 < S; s0 += BS) {
    __syncthreads();
    load_f32_tile(Bs, ldk, Be + static_cast<size_t>(s0) * K, BS, K);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, s = tx + 16 * j;
        const size_t e = (row0 + r) * S + s0 + s;
        Ts[r * LDT + s] = (bf16_bits_to_float(X[e]) - mb[s0 + s]) * to_f32(W[e]);
      }
    __syncthreads();
    accumulate_out_f32(acc_o, Ts, Bs, ldk, n0, ty, tx);
  }
  store_out_f32(out, acc_o, row0, K, n0, ty, tx);
}

// ---------------------------------------------------------------- launch
template <typename WT>
cudaError_t gram(const void* Q, const void* Be, const void* W, void* out, int R, int S, int K,
                 bool op_f32, cudaStream_t stream) {
  const dim3 grid(R / BM, K / BN);
  if (op_f32) {
    const size_t smem = (static_cast<size_t>(BM + BS) * (K + 1) + BM * LDT) * sizeof(float);
    return launch(gram_f32_kernel<WT>, grid, 256, smem, stream, static_cast<const float*>(Q),
                  static_cast<const float*>(Be), static_cast<const WT*>(W),
                  static_cast<float*>(out), S, K);
  }
  return launch(gram_bf16_kernel<WT>, grid, 128, gram_bf16_smem<WT>(K), stream,
                static_cast<const uint16_t*>(Q), static_cast<const uint16_t*>(Be),
                static_cast<const WT*>(W), static_cast<float*>(out), R, S, K, 0);
}

template <typename WT>
cudaError_t rhs(const void* X, const void* W, const void* mb, const void* Be, void* out, int R,
                int S, int K, bool op_f32, cudaStream_t stream) {
  const dim3 grid(R / BM, K / BN);
  if (op_f32) {
    const size_t smem = (static_cast<size_t>(BS) * (K + 1) + BM * LDT) * sizeof(float);
    return launch(rhs_f32_kernel<WT>, grid, 256, smem, stream, static_cast<const uint16_t*>(X),
                  static_cast<const WT*>(W), static_cast<const float*>(mb),
                  static_cast<const float*>(Be), static_cast<float*>(out), S, K);
  }
  const size_t smem = static_cast<size_t>(BS) * (K + 8) * 2 + static_cast<size_t>(BM) * (BS + 8) * 2 +
                      static_cast<size_t>(BM) * (BS + WPad<WT>::v) * sizeof(WT) + BS * sizeof(float);
  return launch(rhs_bf16_kernel<WT>, grid, 128, smem, stream, static_cast<const uint16_t*>(X),
                static_cast<const WT*>(W), static_cast<const float*>(mb),
                static_cast<const uint16_t*>(Be), static_cast<float*>(out), S, K);
}

}  // namespace

// C interface (bound with ctypes).  The caller guarantees R % 64 == 0,
// S % 64 == 0, K % 64 == 0, K <= 256, contiguous row-major tensors on the
// current device, and 16-byte-aligned base pointers.  w_type: 0 an int8
// mask, 1 f32 weights, 2 bf16 weights.  Returns the launch's cudaError_t (0
// on success); the kernel runs asynchronously on `stream`.
extern "C" int cmf_masked_gram_matvec(const void* Q, const void* Be, const void* W, void* out,
                                      int R, int S, int K, int op_f32, int w_type,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w_type) {
    case 0: return static_cast<int>(gram<int8_t>(Q, Be, W, out, R, S, K, op_f32, st));
    case 1: return static_cast<int>(gram<float>(Q, Be, W, out, R, S, K, op_f32, st));
    case 2: return static_cast<int>(gram<bf16_t>(Q, Be, W, out, R, S, K, op_f32, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int cmf_masked_rhs(const void* X, const void* W, const void* mb, const void* Be,
                              void* out, int R, int S, int K, int op_f32, int w_type,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (w_type) {
    case 0: return static_cast<int>(rhs<int8_t>(X, W, mb, Be, out, R, S, K, op_f32, st));
    case 1: return static_cast<int>(rhs<float>(X, W, mb, Be, out, R, S, K, op_f32, st));
    case 2: return static_cast<int>(rhs<bf16_t>(X, W, mb, Be, out, R, S, K, op_f32, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cmf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
