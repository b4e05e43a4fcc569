// Fused masked-Gram kernels of the dense-masked ALS engine, for Hopper (sm_90a).
//
//   K1  cmf_masked_gram_matvec:  out = ((Q Be^T) * W) Be     the CG operator
//   K2  cmf_masked_rhs:          out = ((X - mb) * W) Be     the CG right-hand side
//       (configurations from cmf_gram_geometry / cmf_rhs_geometry)
//
// Q:[R,K] and Be:[S,K] are bf16 (bulk iterations) or f32 (the polish and exact
// mode); W:[R,S] is an int8 0/1 mask, bf16 or f32 weights; X:[R,S] holds the
// raw bf16 ratings and mb:[S] the f32 mean plus opposing bias.  out:[R,K] is
// f32.
//
// They replace cmfrec_tpu/ops/masked_matmul.py::masked_gram_matvec (Pallas body
// _matvec_kernel) and ::masked_rhs (_rhs_kernel).  As there, the [R,S]
// intermediate never reaches device memory: a block owns a row block and 64
// output columns (past K = 256 as many as its registers hold) and walks S in
// tiles.  With bf16 operands, T*W is formed in
// f32 and rounded to bf16 once, exactly where the TPU kernel rounds it
// (masked_matmul.py:96); a bf16 W meets T rounded to bf16 first (:94).  K2
// and the f32 K1 widen any W to f32.
//
// What bounds them on an H100: one pass over W (1 B/entry int8, 2 B bf16, 4 B
// f32), plus X (2 B/entry) for K2, against 4*R*S*K operations for K1.  At the
// flagship shape (69888 x 10688, K=64) a K1 call reads ~0.75 GB (0.23 ms at
// 3.35 TB/s) and does ~191 GFLOP: 0.19 ms on bf16 tensor cores, 2.85 ms in
// f32 FMA.  So the bf16 K1 is bound by bytes and the f32 K1 by operations.
//
// K1 (both variants) splits S over gridDim.z when the row blocks alone would
// not fill the card (the B half-step has 84-167 row blocks for 132 SMs): the
// wrapper (ops/masked_matmul.py: split_chunk) picks the chunk from R, S,
// the card's SM count and the blocks an SM the kernel's configuration
// keeps resident (cmf_gram_geometry, asked once a device, K and type), each
// chunk's block writes its partial [R, K] sums, and
// sum_chunks_kernel adds the partials in chunk order.  No atomics: two calls
// on the same inputs give the same bits.
//
// gram_bf16_wgmma_kernel, bound by bytes: 128-row blocks of two warpgroups
// (each Be tile read from L2 serves 128 rows), two blocks an SM.  Be and W
// tiles stream by cp.async through a ring of three stages (two where three
// would not leave two blocks an SM), so the next tiles' loads overlap this
// tile's products: at K=64 with an int8 W a stage is 128 columns of S, 32
// KB, and the W tile rows are XOR-permuted by 16-byte chunk (swz) rather
// than padded, which is what lets three stages fit.  Both products run on
// wgmma: T = Q Be^T with Q and the Be tile in shared memory as core
// matrices (K-major); T's accumulator fragments are masked in registers and
// re-packed as the register A operand of out += P Be, which reads the same
// Be tile MN-major; that product stays in flight while the next 64 columns'
// T is issued.  Every launch still moves each Be tile from L2 once per row
// block and issues its copies from the same warps that run the products;
// TMA with a producer warp is the untried next step.
//
// gram_f32_tile8_kernel, bound by f32 FMA (true f32, no TF32): 128-row
// blocks of 128 threads, each thread an 8x8 register tile in both products,
// fed by 16-byte shared loads (4 loads for 64 FMAs); Q and T*W staged
// transposed in shared memory, Be and W tiles by a cp.async double buffer.
// Where its tiles do not fit shared memory (K > 128), gram_f32_ring_kernel
// does the same with 64-row blocks and 8x4 thread tiles.
//
// K2 is K1's second product with V = (X - mb) * W as its A operand, bound by
// bytes in both variants (X at 2 B and an int8 W at 1 B an entry, ~2.24 GB a
// flagship call, 0.67 ms; its 96 GFLOP take 0.1 ms on tensor cores and 1.43
// ms in f32 FMA, so the f32 K2 sits near its FMA bound).  Both split S like
// K1 (split_chunk on K2's own geometry, cmf_rhs_geometry; the same
// sum_chunks_kernel), which fills the card at the B side's 84 row blocks.
// rhs_bf16_wgmma_kernel: 128-row blocks of two warpgroups; X, W (rows
// XOR-permuted by swz), mb and the block's 64 columns of Be stream through a
// three-stage cp.async ring of 64-wide S tiles (two where three do not
// leave two blocks an SM); V is formed in f32 from the staged tiles, rounded
// to bf16 once and packed as the register A operand of wgmma against the Be
// tile read MN-major.  rhs_f32_tile8_kernel: gram_f32_tile8_kernel's second
// half, V staged transposed, a cp.async double buffer, 8x8 thread tiles of
// true f32 FMA.  The first design (rhs_bf16_kernel: synchronous copies,
// mma.sync, no split; rhs_f32_kernel: 4x4 thread tiles of scalar loads) is
// gone.  Past K = 256 the bf16 K2 runs rhs_bf16_wide_kernel (the section "K2
// past K = 256" below): a block owns as many output columns as its registers
// hold, all of K = 320, so X and W leave device memory once and V is formed
// once an S tile; the f32 K2 keeps rhs_f32_tile8_kernel at any K.
//
// Past K = 256 (kTiledMaxK) K1 runs its wide configurations (the section "K1 past
// K = 256" below): a block owns as many output columns as its registers hold, all
// of K = 320, so the scores are computed once; bf16 operands on wgmma
// (gram_bf16_whole_kernel with Q and the whole-K Be tiles held where they fit,
// else gram_bf16_wide_kernel streaming the K chunks), f32 operands on
// register-tiled FMA (gram_f32_wide_kernel, both ways); with bf16 operands the
// rounding of T*W to bf16 follows T summed in order in f32, as the twin sums it.
//
// The first design of the bf16 K1 (gram_bf16_kernel: synchronous 64-wide
// tiles, mma.sync, no split-S) stays in masked_gram.cuh as the base of the
// probes in k1_probes.cu (Body::kFull is that design whole).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcmfrec_kernels.so masked_matmul.cu

#include <cuda.h>  // CUtensorMap; the encoder is reached through the runtime

#include <algorithm>

#include "masked_gram.cuh"

namespace {

// ------------------------------------------------------------ async copies
// Stages of the f32 K1's tile rings: the next tile loads while this one is
// used.  (The bf16 K1 takes its stage count as a template parameter.)
constexpr int STAGES = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// copy_tile's layout, issued as cp.async (16 bytes a thread) without waiting.
template <int NT>
__device__ __forceinline__ void copy_tile_async(void* dst, int dst_stride, const void* src,
                                                size_t src_stride, int rows, int row_bytes) {
  const int per_row = row_bytes / 16;
  // chunk i = threadIdx.x + NT * n is (row r, column c); step (r, c) without dividing
  const int dr = NT / per_row, dc = NT - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  for (; r < rows; r += dr, c += dc) {
    if (c >= per_row) {
      c -= per_row;
      if (++r >= rows) break;
    }
    cp_async16(static_cast<char*>(dst) + r * dst_stride + c * 16,
               static_cast<const char*>(src) + r * src_stride + c * 16);
  }
}

// Byte b of row r of a shared-memory tile of RB-byte rows (RB a power of
// two, at least 64) whose 16-byte chunks are XOR-permuted by row, so that
// the same column of eight consecutive rows lies in eight distinct bank
// groups without padding the rows.
template <int RB>
__device__ __forceinline__ int swz(int r, int b) {
  static_assert(RB >= 64 && (RB & (RB - 1)) == 0, "rows of 2^n >= 64 bytes");
  const int x = RB >= 128 ? (r & 7) : ((r >> 1) & 3);  // 64-byte rows: two to a 128-byte line
  return r * RB + ((((b >> 4) ^ x)) << 4) + (b & 15);
}

// copy_tile_async into a tile laid out by swz<RB>: rows of row_bytes <= RB.
template <int NT, int RB>
__device__ __forceinline__ void copy_swz_async(void* dst, const void* src, size_t src_stride,
                                               int rows, int row_bytes) {
  const int per_row = row_bytes / 16;
  const int dr = NT / per_row, dc = NT - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  for (; r < rows; r += dr, c += dc) {
    if (c >= per_row) {
      c -= per_row;
      if (++r >= rows) break;
    }
    cp_async16(static_cast<char*>(dst) + swz<RB>(r, c * 16),
               static_cast<const char*>(src) + r * src_stride + c * 16);
  }
}

// The first `width` columns of a [rows, K] bf16 row-major block (K * 2 bytes a
// row) into shared memory as wgmma core matrices without swizzle: 8 rows x 16
// bytes, 128 contiguous bytes each, width / 8 of them along the row (128 bytes
// apart), then the next 8 rows (width * 16 bytes on).
template <int NT>
__device__ __forceinline__ void copy_core_async(void* dst, const void* src, int rows, int K,
                                                int width) {
  const int per_row = width / 8;
  const int dr = NT / per_row, dc = NT - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  for (; r < rows; r += dr, c += dc) {
    if (c >= per_row) {
      c -= per_row;
      if (++r >= rows) break;
    }
    cp_async16(static_cast<char*>(dst) + (r >> 3) * (width * 16) + c * 128 + (r & 7) * 16,
               static_cast<const char*>(src) + static_cast<size_t>(r) * K * 2 + c * 16);
  }
}

// Whole rows (width = K).
template <int NT>
__device__ __forceinline__ void copy_core_async(void* dst, const void* src, int rows, int K) {
  copy_core_async<NT>(dst, src, rows, K, K);
}

// The S range of this block's chunk (gridDim.z chunks of `chunk` columns;
// the last may be shorter), and its output: out itself for one chunk, else
// the chunk's [R, K] slice of the partial sums.
struct Chunk {
  int s_begin, s_end;
  float* out;
  __device__ Chunk(float* base, int R, int S, int K, int chunk)
      : s_begin(blockIdx.z * chunk),
        s_end(min(S, static_cast<int>(blockIdx.z) * chunk + chunk)),
        out(base + static_cast<size_t>(blockIdx.z) * R * K) {}
};

// 128-row blocks of 8 warps (two warpgroups) for the bf16 K1.
constexpr int RING_BM = 128;
constexpr int RING_NT = 256;

// ------------------------------------------------------------ wgmma helpers
// A shared-memory matrix descriptor without swizzle: start address, and the
// bytes between core matrices along K (lbo) and along M or N (sbo).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator across a wait.
__device__ __forceinline__ void fence_acc(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[j][i])::"memory");
}

#define WGMMA_D32                                                                          \
  "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), \
      "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]),            \
      "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),            \
      "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]),            \
      "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]),            \
      "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
#define WGMMA_D32_LIST                                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64, 64] (+)= A B, A and B bf16 in shared memory, both K-major; d's
// fragment j of a warp holds its rows g, g+8 at columns 8j+2t, 8j+2t+1.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WGMMA_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64, 64] += A B, A bf16 in registers (mma.sync's A fragment layout per
// warp), B bf16 in shared memory MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WGMMA_D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// ----------------------------------------------------------- K1, bf16 wgmma
// Warpgroup w owns rows 64w..64w+63 of the block's 128 (a warpgroup whose
// rows are all past R loads nothing and skips the products).  BSS columns
// of S a ring stage, processed 64 at a time, STG stages.  Q and the Be
// tiles are stored as wgmma core matrices (copy_core_async), W tiles row
// by row, permuted by swz.
template <typename WT, int BSS, int STG>
size_t gram_bf16_wgmma_smem(int K) {
  return static_cast<size_t>(RING_BM) * K * 2 +
         static_cast<size_t>(STG) * (static_cast<size_t>(BSS) * K * 2 +
                                     static_cast<size_t>(RING_BM) * BSS * sizeof(WT));
}

template <typename WT, int BSS, int STG>
__global__ void __launch_bounds__(RING_NT, 2)
    gram_bf16_wgmma_kernel(const uint16_t* __restrict__ Q, const uint16_t* __restrict__ Be,
                           const WT* __restrict__ W, float* __restrict__ part, int R, int S,
                           int K, int chunk) {
  static_assert(STG >= 2, "a ring of at least two stages");
  constexpr int RB = BSS * sizeof(WT);  // bytes of a W tile row
  extern __shared__ __align__(16) unsigned char smem[];
  const int core_row = K * 16;  // bytes from one 8-row group of core matrices to the next
  unsigned char* Qs = smem;
  unsigned char* Bring = Qs + RING_BM * K * 2;
  unsigned char* Wring = Bring + STG * BSS * K * 2;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int wgr = (threadIdx.x >> 7) * 64;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * RING_BM;
  const int rows = min(RING_BM, R - static_cast<int>(row0));
  const int n0 = blockIdx.y * BN;
  const Chunk ch(part, R, S, K, chunk);
  const int ntiles = (ch.s_end - ch.s_begin + BSS - 1) / BSS;

  auto load = [&](int tile) {
    const int s0 = ch.s_begin + tile * BSS;
    const int width = min(BSS, ch.s_end - s0);
    const int slot = tile % STG;
    copy_core_async<RING_NT>(Bring + slot * BSS * K * 2, Be + static_cast<size_t>(s0) * K,
                             width, K);
    copy_swz_async<RING_NT, RB>(Wring + slot * RING_BM * RB, W + row0 * S + s0,
                                static_cast<size_t>(S) * sizeof(WT), rows, width * sizeof(WT));
  };
  copy_core_async<RING_NT>(Qs, Q + row0 * K, rows, K);
#pragma unroll
  for (int st = 0; st < STG - 1; ++st) {
    if (st < ntiles) load(st);
    cp_async_commit();
  }

  const bool active = wgr < rows;
  float acc_o[8][4] = {};
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STG - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // tile it-1 is read
    fence_acc(acc_o);
    __syncthreads();
    if (it + STG - 1 < ntiles) load(it + STG - 1);
    cp_async_commit();
    if (!active) continue;
    const unsigned char* Bs = Bring + (it % STG) * BSS * K * 2;
    const unsigned char* Ws = Wring + (it % STG) * RING_BM * RB;
    const int width = min(BSS, ch.s_end - ch.s_begin - it * BSS);
    for (int h = 0; h < width; h += 64) {
      // T[64, 64] = Q[64, K] Be[h:h+64]^T
      float acc_t[8][4] = {};
      wgmma_fence();
      for (int kk = 0; kk < K / 16; ++kk)
        wgmma_ss(acc_t, gmma_desc(Qs + (wgr >> 3) * core_row + kk * 256, 128, core_row),
                 gmma_desc(Bs + (h >> 3) * core_row + kk * 256, 128, core_row), kk);
      wgmma_commit_wait();
      fence_acc(acc_t);
      uint32_t p[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int b = (h + j * 8 + 2 * t) * static_cast<int>(sizeof(WT));
        const WT* w0 = reinterpret_cast<const WT*>(Ws + swz<RB>(wr + g, b));
        const WT* w1 = reinterpret_cast<const WT*>(Ws + swz<RB>(wr + g + 8, b));
        p[j][0] = pack_bf16(mask<WT, Body::kFull>(acc_t[j][0], w0[0]),
                            mask<WT, Body::kFull>(acc_t[j][1], w0[1]));
        p[j][1] = pack_bf16(mask<WT, Body::kFull>(acc_t[j][2], w1[0]),
                            mask<WT, Body::kFull>(acc_t[j][3], w1[1]));
      }
      // out[64, 64] += P[64, 64] Be[h:h+64, n0:n0+64]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const unsigned char* b = Bs + ((h + kk * 16) >> 3) * core_row + (n0 >> 3) * 128;
        wgmma_rs(acc_o, p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1],
                 gmma_desc(b, core_row, 128));
      }
      // left in flight: the next half's T (or the next tile's wait) follows
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc_o);
  cp_async_wait<0>();
  if (wr < rows) store_out_bf16(ch.out, acc_o, row0 + wr + g, K, n0, t);
}

// ------------------------------------------------------------- K1, f32 ring
// For K where gram_f32_tile8_kernel's tiles do not fit shared memory (K >
// 128): 64-row blocks of 128 threads as 8 x 16; thread (ty, tx) owns rows
// ty + 8i (i < 8) of the block's 64 and, in T, columns tx + 16j of the S
// tile (j < BSS / 16), in the output columns n0 + 4tx .. n0 + 4tx + 3.
constexpr int F32_NT = 128;

template <typename WT, int BSS = 32>
size_t gram_f32_ring_smem(int K) {
  return static_cast<size_t>(BM) * (K + 4) * 4 + static_cast<size_t>(BM) * (BSS + 16) * 4 +
         static_cast<size_t>(STAGES) * (static_cast<size_t>(BSS) * (K + 4) * 4 +
                                        static_cast<size_t>(BM) * (BSS + WPad<WT>::v) *
                                            sizeof(WT));
}

__device__ __forceinline__ void fma4(float& acc, const float4& a, const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

template <typename WT, int BSS = 32>
__global__ void __launch_bounds__(F32_NT, 1)
    gram_f32_ring_kernel(const float* __restrict__ Q, const float* __restrict__ Be,
                         const WT* __restrict__ W, float* __restrict__ part, int R, int S, int K,
                         int chunk) {
  constexpr int TJ = BSS / 16;
  constexpr int ldp = BSS + 16;  // two rows 16 banks apart: P's stores do not conflict
  constexpr int ldw = BSS + WPad<WT>::v;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = K + 4;  // odd in 16-byte units: 8 rows' float4 reads spread over the banks
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ps = Qs + BM * ldk;
  float* Bring = Ps + BM * ldp;
  WT* Wring = reinterpret_cast<WT*>(Bring + STAGES * BSS * ldk);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const Chunk ch(part, R, S, K, chunk);
  const int ntiles = (ch.s_end - ch.s_begin) / BSS;  // chunk and S are multiples of BSS

  auto load = [&](int tile) {
    const int s0 = ch.s_begin + tile * BSS;
    const int slot = tile % STAGES;
    copy_tile_async<F32_NT>(Bring + slot * BSS * ldk, ldk * 4, Be + static_cast<size_t>(s0) * K,
                            static_cast<size_t>(K) * 4, BSS, K * 4);
    copy_tile_async<F32_NT>(Wring + slot * BM * ldw, ldw * sizeof(WT), W + row0 * S + s0,
                            static_cast<size_t>(S) * sizeof(WT), BM, BSS * sizeof(WT));
  };
  copy_tile_async<F32_NT>(Qs, ldk * 4, Q + row0 * K, static_cast<size_t>(K) * 4, BM, K * 4);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) load(st);
    cp_async_commit();
  }

  float acc_o[8][4] = {};
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `it` landed; tile it-1 and its P are consumed
    if (it + STAGES - 1 < ntiles) load(it + STAGES - 1);
    cp_async_commit();
    const float* Bs = Bring + (it % STAGES) * BSS * ldk;
    const WT* Ws = Wring + (it % STAGES) * BM * ldw;

    // T[64, BSS] = Q Be_tile^T, k in order (f32 FMA)
    float acc[8][TJ] = {};
#pragma unroll 2
    for (int k = 0; k < K; k += 4) {
      float4 a[8], b[TJ];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 8 * i) * ldk + k);
#pragma unroll
      for (int j = 0; j < TJ; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * ldk + k);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TJ; ++j) fma4(acc[i][j], a[i], b[j]);
    }
    // P = T * W, staged row-major for the second product
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) {
        const int r = ty + 8 * i, s = tx + 16 * j;
        Ps[r * ldp + s] = acc[i][j] * to_f32(Ws[r * ldw + s]);
      }
    __syncthreads();

    // out[64, n0:n0+64] += P Be_tile[:, n0:n0+64], s in order
#pragma unroll 2
    for (int s = 0; s < BSS; s += 4) {
      float4 a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(Ps + (ty + 8 * i) * ldp + s);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = *reinterpret_cast<const float4*>(Bs + (s + q) * ldk + n0 + 4 * tx);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc_o[i][0] = fmaf(av[q], b[q].x, acc_o[i][0]);
          acc_o[i][1] = fmaf(av[q], b[q].y, acc_o[i][1]);
          acc_o[i][2] = fmaf(av[q], b[q].z, acc_o[i][2]);
          acc_o[i][3] = fmaf(av[q], b[q].w, acc_o[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(ch.out + (row0 + ty + 8 * i) * K + n0 + 4 * tx) =
        make_float4(acc_o[i][0], acc_o[i][1], acc_o[i][2], acc_o[i][3]);
}

// ------------------------------------------------ K1, f32, 8x8 thread tiles
// 128-row blocks of 128 threads as 16 x 8: thread (ty, tx) owns rows
// 8ty..8ty+7, columns 8tx..8tx+7 of T's 64-wide S tile, and output columns
// n0 + 8tx..n0 + 8tx + 7: 64 FMAs for every four 16-byte shared loads in
// both products.  Q is staged transposed (Qt[k][r]) and T * W transposed
// (Pt[s][r]), so a thread's eight rows are two float4s; Be tiles keep their
// [s][k] layout for both products, with each row's 16-byte chunks permuted
// (chunk c of row s at c ^ (s / 8 % 8)) so that the first product's loads
// from eight rows 8 apart hit distinct banks; Pt's float4s are permuted the
// same way.  Rows past R (a last block of 64) are computed from whatever
// their shared memory holds and never stored.
constexpr int F8_BM = 128;
constexpr int F8_NT = 128;
constexpr int F8_BSS = 64;

template <typename WT>
size_t gram_f32_tile8_smem(int K) {
  return static_cast<size_t>(K) * F8_BM * 4 + static_cast<size_t>(F8_BSS) * F8_BM * 4 +
         static_cast<size_t>(STAGES) * (static_cast<size_t>(F8_BSS) * K * 4 +
                                        static_cast<size_t>(F8_BM) * F8_BSS * sizeof(WT));
}

// Eight consecutive W entries, widened to f32.
__device__ __forceinline__ void load_w8(float (&w)[8], const int8_t* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    w[e] = static_cast<float>(static_cast<int8_t>(v.x >> (8 * e)));
    w[4 + e] = static_cast<float>(static_cast<int8_t>(v.y >> (8 * e)));
  }
}

__device__ __forceinline__ void load_w8(float (&w)[8], const bf16_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    w[2 * e] = bf16_bits_to_float(static_cast<uint16_t>(u[e] & 0xffffu));
    w[2 * e + 1] = bf16_bits_to_float(static_cast<uint16_t>(u[e] >> 16));
  }
}

__device__ __forceinline__ void load_w8(float (&w)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w;
  w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
}

template <typename WT>
__global__ void __launch_bounds__(F8_NT, 1)
    gram_f32_tile8_kernel(const float* __restrict__ Q, const float* __restrict__ Be,
                          const WT* __restrict__ W, float* __restrict__ part, int R, int S,
                          int K, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qt = reinterpret_cast<float*>(smem);  // [K][F8_BM]
  float* Pt = Qt + K * F8_BM;                  // [F8_BSS][F8_BM], float4s permuted
  float* Bring = Pt + F8_BSS * F8_BM;          // STAGES x [F8_BSS][K], chunks permuted
  WT* Wring = reinterpret_cast<WT*>(Bring + STAGES * F8_BSS * K);  // STAGES x [F8_BM][F8_BSS]

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * F8_BM;
  const int rows = min(F8_BM, R - static_cast<int>(row0));
  const int n0 = blockIdx.y * BN;
  const Chunk ch(part, R, S, K, chunk);
  const int ntiles = (ch.s_end - ch.s_begin) / F8_BSS;  // chunk and S are multiples of 64
  const int kc = K / 4;                                  // 16-byte chunks in a Be row

  auto load = [&](int tile) {
    const int s0 = ch.s_begin + tile * F8_BSS;
    float* Bs = Bring + (tile % STAGES) * F8_BSS * K;
    const float* src = Be + static_cast<size_t>(s0) * K;
    for (int i = threadIdx.x; i < F8_BSS * kc; i += F8_NT) {
      const int s = i / kc, c = i - s * kc;
      cp_async16(Bs + s * K + ((c ^ ((s >> 3) & 7)) << 2), src + s * K + c * 4);
    }
    copy_tile_async<F8_NT>(Wring + (tile % STAGES) * F8_BM * F8_BSS, F8_BSS * sizeof(WT),
                           W + row0 * S + s0, static_cast<size_t>(S) * sizeof(WT), rows,
                           F8_BSS * sizeof(WT));
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) load(st);
    cp_async_commit();
  }
  // Qt[k][r] = Q[row0 + r][k]; thread r % 128 takes row r, four k at a time
  for (int i = threadIdx.x; i < F8_BM * kc; i += F8_NT) {
    const int r = i % F8_BM, c = i / F8_BM;
    if (r < rows) {
      const float4 q = *reinterpret_cast<const float4*>(Q + (row0 + r) * K + c * 4);
      Qt[(4 * c) * F8_BM + r] = q.x;
      Qt[(4 * c + 1) * F8_BM + r] = q.y;
      Qt[(4 * c + 2) * F8_BM + r] = q.z;
      Qt[(4 * c + 3) * F8_BM + r] = q.w;
    }
  }

  float acc_o[8][8] = {};
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `it` (and Qt) landed; tile it-1 and its Pt are consumed
    if (it + STAGES - 1 < ntiles) load(it + STAGES - 1);
    cp_async_commit();
    const float* Bs = Bring + (it % STAGES) * F8_BSS * K;
    const WT* Ws = Wring + (it % STAGES) * F8_BM * F8_BSS;

    // T[8ty + i][8tx + j] = sum over k in order of Q[.][k] Be[.][k]
    float acc[8][8] = {};
#pragma unroll 2
    for (int c = 0; c < kc; ++c) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)  // row 8tx + j: its chunk c sits at c ^ tx
        b[j] = *reinterpret_cast<const float4*>(Bs + (8 * tx + j) * K + ((c ^ (tx & 7)) << 2));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 a0 = *reinterpret_cast<const float4*>(Qt + (4 * c + e) * F8_BM + 8 * ty);
        const float4 a1 = *reinterpret_cast<const float4*>(Qt + (4 * c + e) * F8_BM + 8 * ty + 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float bv = e == 0 ? b[j].x : e == 1 ? b[j].y : e == 2 ? b[j].z : b[j].w;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(av[i], bv, acc[i][j]);
        }
      }
    }
    // P = T * W, stored transposed: Pt[s][r], float4 of rows r..r+3 at r ^ 4 * (s / 8 % 8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float w[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_w8(w[i], Ws + (8 * ty + 4 * h + i) * F8_BSS + 8 * tx);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(Pt + (8 * tx + j) * F8_BM + ((8 * ty + 4 * h) ^ (4 * tx))) =
            make_float4(acc[4 * h][j] * w[0][j], acc[4 * h + 1][j] * w[1][j],
                        acc[4 * h + 2][j] * w[2][j], acc[4 * h + 3][j] * w[3][j]);
    }
    __syncthreads();

    // out[8ty + i][n0 + 8tx + j] += sum over s in order of P[.][s] Be[s][.]
#pragma unroll 8
    for (int s = 0; s < F8_BSS; ++s) {
      const int sw = (s >> 3) & 7;
      const float* prow = Pt + s * F8_BM;
      const float4 a0 = *reinterpret_cast<const float4*>(prow + ((8 * ty) ^ (4 * sw)));
      const float4 a1 = *reinterpret_cast<const float4*>(prow + ((8 * ty + 4) ^ (4 * sw)));
      const int c0 = (n0 >> 2) + 2 * tx;
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + s * K + ((c0 ^ sw) << 2));
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + s * K + (((c0 + 1) ^ sw) << 2));
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc_o[i][j] = fmaf(av[i], bv[j], acc_o[i][j]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (8 * ty + i >= rows) break;
    float* o = ch.out + (row0 + 8 * ty + i) * K + n0 + 8 * tx;
    *reinterpret_cast<float4*>(o) = make_float4(acc_o[i][0], acc_o[i][1], acc_o[i][2], acc_o[i][3]);
    *reinterpret_cast<float4*>(o + 4) =
        make_float4(acc_o[i][4], acc_o[i][5], acc_o[i][6], acc_o[i][7]);
  }
}

// ------------------------------------------------- K1's split-S reduction
// out = sum over z of part[z], z in order (n4 float4s a chunk).
__global__ void __launch_bounds__(256)
    sum_chunks_kernel(const float4* __restrict__ part, float4* __restrict__ out, int chunks,
                      size_t n4) {
  for (size_t i = static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x; i < n4;
       i += static_cast<size_t>(gridDim.x) * 256) {
    float4 s = part[i];
    for (int z = 1; z < chunks; ++z) {
      const float4 v = part[z * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

// ---------------------------------------------------------- K2, bf16 wgmma
// K1's second product with V = (X - mb) * W as its A operand: 128-row
// blocks of two warpgroups, BSS columns of S a ring stage (processed 64 at
// a time), STG stages streamed by cp.async: the X and W tiles row by row,
// permuted by swz; the 64 output columns of the Be tile (n0..n0+63, the
// only ones the block uses) as wgmma core matrices, read MN-major; mb's
// BSS entries.  V is formed in f32 from the staged tiles and rounded to
// bf16 once (masked_rhs_ref's rounding point), in the register A fragments
// of wgmma.
template <typename WT, int BSS, int STG>
size_t rhs_bf16_wgmma_smem(int) {
  return static_cast<size_t>(STG) * (static_cast<size_t>(BSS) * BN * 2 +
                                     static_cast<size_t>(RING_BM) * BSS * (2 + sizeof(WT)) +
                                     BSS * sizeof(float));
}

// rows x 64 bf16 columns (128 bytes a row, src_stride bytes apart) into
// shared memory as wgmma core matrices: 8 rows x 16 bytes, 128 contiguous
// bytes each, 8 of them along the columns, then the next 8 rows (1 KB on).
template <int NT>
__device__ __forceinline__ void copy_core64_async(void* dst, const void* src, size_t src_stride,
                                                  int rows) {
  for (int i = threadIdx.x; i < rows * 8; i += NT) {
    const int r = i >> 3, c = i & 7;
    cp_async16(static_cast<char*>(dst) + (r >> 3) * 1024 + c * 128 + (r & 7) * 16,
               static_cast<const char*>(src) + r * src_stride + c * 16);
  }
}

template <typename WT, int BSS, int STG>
__global__ void __launch_bounds__(RING_NT, 2)
    rhs_bf16_wgmma_kernel(const uint16_t* __restrict__ X, const WT* __restrict__ W,
                          const float* __restrict__ mb, const uint16_t* __restrict__ Be,
                          float* __restrict__ part, int R, int S, int K, int chunk) {
  static_assert(STG >= 2, "a ring of at least two stages");
  constexpr int RW = BSS * sizeof(WT);  // bytes of a W tile row
  constexpr int RX = BSS * 2;           // bytes of an X tile row
  constexpr int SB = BSS * BN * 2;      // bytes of a Be tile
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* Bring = smem;
  unsigned char* Xring = Bring + STG * SB;
  unsigned char* Wring = Xring + STG * RING_BM * RX;
  float* Mring = reinterpret_cast<float*>(Wring + STG * RING_BM * RW);

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int wgr = (threadIdx.x >> 7) * 64;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * RING_BM;
  const int rows = min(RING_BM, R - static_cast<int>(row0));
  const int n0 = blockIdx.y * BN;
  const Chunk ch(part, R, S, K, chunk);
  const int ntiles = (ch.s_end - ch.s_begin + BSS - 1) / BSS;

  auto load = [&](int tile) {
    const int s0 = ch.s_begin + tile * BSS;
    const int width = min(BSS, ch.s_end - s0);
    const int slot = tile % STG;
    copy_core64_async<RING_NT>(Bring + slot * SB, Be + static_cast<size_t>(s0) * K + n0,
                               static_cast<size_t>(K) * 2, width);
    copy_swz_async<RING_NT, RX>(Xring + slot * RING_BM * RX, X + row0 * S + s0,
                                static_cast<size_t>(S) * 2, rows, width * 2);
    copy_swz_async<RING_NT, RW>(Wring + slot * RING_BM * RW, W + row0 * S + s0,
                                static_cast<size_t>(S) * sizeof(WT), rows, width * sizeof(WT));
    copy_tile_async<RING_NT>(Mring + slot * BSS, 0, mb + s0, 0, 1, width * 4);
  };
#pragma unroll
  for (int st = 0; st < STG - 1; ++st) {
    if (st < ntiles) load(st);
    cp_async_commit();
  }

  const bool active = wgr < rows;
  float acc_o[8][4] = {};
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STG - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // tile it-1 is read
    fence_acc(acc_o);
    __syncthreads();
    if (it + STG - 1 < ntiles) load(it + STG - 1);
    cp_async_commit();
    if (!active) continue;
    const unsigned char* Bs = Bring + (it % STG) * SB;
    const unsigned char* Xs = Xring + (it % STG) * RING_BM * RX;
    const unsigned char* Ws = Wring + (it % STG) * RING_BM * RW;
    const float* ms = Mring + (it % STG) * BSS;
    const int width = min(BSS, ch.s_end - ch.s_begin - it * BSS);
    for (int h = 0; h < width; h += 64) {
      uint32_t p[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = h + j * 8 + 2 * t;
        const uint16_t* x0 = reinterpret_cast<const uint16_t*>(Xs + swz<RX>(wr + g, 2 * s));
        const uint16_t* x1 = reinterpret_cast<const uint16_t*>(Xs + swz<RX>(wr + g + 8, 2 * s));
        const WT* w0 = reinterpret_cast<const WT*>(Ws + swz<RW>(wr + g, s * sizeof(WT)));
        const WT* w1 = reinterpret_cast<const WT*>(Ws + swz<RW>(wr + g + 8, s * sizeof(WT)));
        p[j][0] = pack_bf16((bf16_bits_to_float(x0[0]) - ms[s]) * to_f32(w0[0]),
                            (bf16_bits_to_float(x0[1]) - ms[s + 1]) * to_f32(w0[1]));
        p[j][1] = pack_bf16((bf16_bits_to_float(x1[0]) - ms[s]) * to_f32(w1[0]),
                            (bf16_bits_to_float(x1[1]) - ms[s + 1]) * to_f32(w1[1]));
      }
      // out[64, 64] += V[64, 64] Be[h:h+64, n0:n0+64]
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc_o, p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1],
                 gmma_desc(Bs + ((h + kk * 16) >> 3) * 1024, 1024, 128));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc_o);
  cp_async_wait<0>();
  if (wr < rows) store_out_bf16(ch.out, acc_o, row0 + wr + g, K, n0, t);
}

// ------------------------------------------------ K2, f32, 8x8 thread tiles
// The second half of gram_f32_tile8_kernel: 128-row blocks of 128 threads
// as 16 x 8; thread (ty, tx) forms V = (X - mb) * W at rows 8ty..8ty+7 and
// columns 8tx..8tx+7 of a 64-wide S tile, stores it transposed (Pt[s][r],
// float4s permuted as there), then owns rows 8ty..8ty+7 and output columns
// n0 + 8tx..n0 + 8tx + 7 of out += V Be_tile.  X, W, mb and the 64 columns
// of Be the block uses stream by a cp.async double buffer; true f32 FMA.
template <typename WT>
size_t rhs_f32_tile8_smem(int) {
  return static_cast<size_t>(F8_BSS) * F8_BM * 4 +
         static_cast<size_t>(STAGES) *
             (static_cast<size_t>(F8_BSS) * BN * 4 +
              static_cast<size_t>(F8_BM) * F8_BSS * (2 + sizeof(WT)) + F8_BSS * 4);
}

template <typename WT>
__global__ void __launch_bounds__(F8_NT, 1)
    rhs_f32_tile8_kernel(const uint16_t* __restrict__ X, const WT* __restrict__ W,
                         const float* __restrict__ mb, const float* __restrict__ Be,
                         float* __restrict__ part, int R, int S, int K, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Pt = reinterpret_cast<float*>(smem);          // [F8_BSS][F8_BM], float4s permuted
  float* Bring = Pt + F8_BSS * F8_BM;                  // STAGES x [F8_BSS][BN]
  uint16_t* Xring = reinterpret_cast<uint16_t*>(Bring + STAGES * F8_BSS * BN);
  WT* Wring = reinterpret_cast<WT*>(Xring + STAGES * F8_BM * F8_BSS);
  float* Mring = reinterpret_cast<float*>(Wring + STAGES * F8_BM * F8_BSS);

  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * F8_BM;
  const int rows = min(F8_BM, R - static_cast<int>(row0));
  const int n0 = blockIdx.y * BN;
  const Chunk ch(part, R, S, K, chunk);
  const int ntiles = (ch.s_end - ch.s_begin) / F8_BSS;  // chunk and S are multiples of 64

  auto load = [&](int tile) {
    const int s0 = ch.s_begin + tile * F8_BSS;
    const int slot = tile % STAGES;
    copy_tile_async<F8_NT>(Bring + slot * F8_BSS * BN, BN * 4,
                           Be + static_cast<size_t>(s0) * K + n0, static_cast<size_t>(K) * 4,
                           F8_BSS, BN * 4);
    copy_tile_async<F8_NT>(Xring + slot * F8_BM * F8_BSS, F8_BSS * 2, X + row0 * S + s0,
                           static_cast<size_t>(S) * 2, rows, F8_BSS * 2);
    copy_tile_async<F8_NT>(Wring + slot * F8_BM * F8_BSS, F8_BSS * sizeof(WT), W + row0 * S + s0,
                           static_cast<size_t>(S) * sizeof(WT), rows, F8_BSS * sizeof(WT));
    copy_tile_async<F8_NT>(Mring + slot * F8_BSS, 0, mb + s0, 0, 1, F8_BSS * 4);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) load(st);
    cp_async_commit();
  }

  float acc_o[8][8] = {};
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile `it` landed; tile it-1 and its Pt are consumed
    if (it + STAGES - 1 < ntiles) load(it + STAGES - 1);
    cp_async_commit();
    const float* Bs = Bring + (it % STAGES) * F8_BSS * BN;
    const uint16_t* Xs = Xring + (it % STAGES) * F8_BM * F8_BSS;
    const WT* Ws = Wring + (it % STAGES) * F8_BM * F8_BSS;
    const float* ms = Mring + (it % STAGES) * F8_BSS;

    // V = (X - mb) * W, stored transposed: Pt[s][r], float4 of rows r..r+3 at r ^ 4 * (s / 8 % 8)
    float m8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) m8[j] = ms[8 * tx + j];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 8 * ty + 4 * h + i;
        float w[8], x[8];
        load_w8(w, Ws + r * F8_BSS + 8 * tx);
        load_w8(x, reinterpret_cast<const bf16_t*>(Xs + r * F8_BSS + 8 * tx));
#pragma unroll
        for (int j = 0; j < 8; ++j) v[i][j] = (x[j] - m8[j]) * w[j];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(Pt + (8 * tx + j) * F8_BM + ((8 * ty + 4 * h) ^ (4 * tx))) =
            make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
    }
    __syncthreads();

    // out[8ty + i][n0 + 8tx + j] += sum over s in order of V[.][s] Be[s][.]
#pragma unroll 8
    for (int s = 0; s < F8_BSS; ++s) {
      const int sw = (s >> 3) & 7;
      const float* prow = Pt + s * F8_BM;
      const float4 a0 = *reinterpret_cast<const float4*>(prow + ((8 * ty) ^ (4 * sw)));
      const float4 a1 = *reinterpret_cast<const float4*>(prow + ((8 * ty + 4) ^ (4 * sw)));
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + s * BN + 8 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + s * BN + 8 * tx + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc_o[i][j] = fmaf(av[i], bv[j], acc_o[i][j]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (8 * ty + i >= rows) break;
    float* o = ch.out + (row0 + 8 * ty + i) * K + n0 + 8 * tx;
    *reinterpret_cast<float4*>(o) = make_float4(acc_o[i][0], acc_o[i][1], acc_o[i][2], acc_o[i][3]);
    *reinterpret_cast<float4*>(o + 4) =
        make_float4(acc_o[i][4], acc_o[i][5], acc_o[i][6], acc_o[i][7]);
  }
}

// ------------------------------------------------------ K1 past K = 256
// The tiled K1 kernels above hold a row block's Q and an S tile of Be at the full K
// in shared memory and own 64 output columns a block, which stops fitting past K =
// kTiledMaxK (256).  Past it K1 runs a wide configuration: a block owns a row block
// and a chunk of output columns as wide as its registers hold (wide_col_chunk: the
// fewest even chunks of at most the configuration's tiles of 64; K = 320 in one
// chunk, so the scores are computed once), and walks its S range tile by tile.  No
// register array grows with K, and a shared buffer does so only in the
// configuration that holds Q whole, which the geometry query takes only where it
// fits: every K that is a multiple of 64 runs.
//
// bf16 operands, both products on wgmma, 128-row blocks of two warpgroups, 64-wide
// S tiles.  T[64, 64] = Q Be^T by wgmma_ss (Q and Be as core matrices, K-major),
// T masked and rounded to bf16 in registers as gram_bf16_wgmma_kernel does and
// re-packed as the register A operand of out[64, 64q ..] += P Be[S tile, c0 + 64q
// ..] by wgmma_rs (Be read MN-major).  The rounding of T*W to bf16 flips with the
// last bits of T, and the tensor cores sum T in another order than the in-order
// f32 sum (the plain twin's): at the flagship's A side such flips alone put the
// result 5.7e-4 (K = 320) to 1.4e-3 (K = 1024) of max|twin| away from the twin.  So
// where the value to round lies within NEAR_ULPS f32 ulps of a bf16 rounding
// midpoint (near_bf16_midpoint; ~0.4% of the entries of nonzero W), T is summed
// again in order by FMA from Q's and Be's rows (dot_in_order) and the rounding
// follows that sum.
//  - gram_bf16_whole_kernel (configuration 5, where it fits: K = 320 and 384 but
//    for K = 384 on f32 weights): Q held whole, the whole-K Be tile and W tile in a
//    two-stage cp.async ring; T's K/16 wgmma steps in one chain, issued while the
//    last tile's output product runs; up to WH_TILES = 5 output tiles (160
//    accumulator registers a thread); the rows of the in-order sum read from
//    shared memory.
//  - gram_bf16_wide_kernel (configuration 6): the scores' K in WD_KC-wide chunks
//    that stream with the chunks of Q through a four-stage cp.async ring; each
//    chunk's T in fresh accumulators, added in f32 in chunk order (one accumulator
//    over K = 1024 drifts far enough from the in-order sum to flip roundings
//    outside NEAR_ULPS); the S tile's W and its Be columns of the block's chunk
//    (Bo) by a double buffer that the tile's first K chunk loads; up to WB_TILES =
//    4 output tiles beside T's two sets of accumulators; the rows of the in-order
//    sum read from device memory.
// Bound by their tensor-core work (4RSK operations: 0.97 ms at the flagship's A
// side at K = 320 against 0.27 ms for its 0.89 GB of W, operands and output).
//
// gram_f32_wide_kernel (f32 operands, true f32 FMA): 64-row blocks of 256 threads,
// 32-wide S tiles; Q and the whole-K Be tile held where they fit (configuration 7:
// K = 320, and 384 but on f32 weights), else the K chunks of Q and Be streamed as
// in gram_bf16_wide_kernel, two stages deep (8).  The score product splits
// each K chunk into quarters, one
// to each 64 threads: thread (rg, sg) sums an 8 x 4 tile, rows rg + 8i and S
// columns sg + 8j, over its quarter (12 16-byte shared loads for 128 FMAs); the
// quarters' sums are added in a fixed order through shared memory, masked and
// stored transposed (P[s][r]).  The output product gives thread (ty, tx) rows
// 8ty..8ty+7 and columns 4tx + 128m (and 2tx past the last full 128), fed by two
// 16-byte loads of P that every lane of a warp shares and one load of Bo for each
// 128 columns: 80 FMAs for five loads at 320 columns; at most WF_TILES = 8 tiles of
// 64 columns (128 accumulator registers).  Bound by f32 FMA (4RSK operations, 14.3
// ms at the flagship's A side at K = 320).
constexpr int kTiledMaxK = 256;
constexpr int WD_KC = 64;     // K chunk of the streamed configurations
constexpr int WB_BSS = 64;    // bf16: S tile
constexpr int WH_TILES = 5;   // bf16, Q held whole: output tiles of 64 columns a block at most
constexpr int WB_TILES = 4;   // bf16, Q streamed: the same
constexpr int WF_NT = 256;    // f32: threads a block
constexpr int WF_BM = 64;     // f32: rows a block
constexpr int WF_BSS = 32;    // f32: S tile
constexpr int WF_TILES = 8;   // f32: output tiles of 64 columns a block at most
constexpr int WF_LDK = WD_KC + 4;  // f32 ring rows: 17 16-byte units, 8 rows on 8 bank groups
constexpr int WF_LDP = WF_BM + 4;  // Pt rows

// The wide K1's output columns a block: the fewest chunks of at most `most`
// tiles of 64 columns, as even as whole tiles allow (K = 320: one chunk at 5 or
// 8 tiles; K = 1024: four of 256 at 4, two of 512 at 8).
int wide_col_chunk(int K, int most) {
  const int tiles = K / BN;
  const int chunks = (tiles + most - 1) / most;
  return (tiles + chunks - 1) / chunks * BN;
}

// The column chunks of a wide configuration's row block: blockIdx.x runs over
// them fastest, so the blocks of one row block run side by side and read its Q
// and W rows once from device memory.
__host__ __device__ __forceinline__ int wide_col_blocks(int K, int col_chunk) {
  return (K + col_chunk - 1) / col_chunk;
}

// d += a, fragment by fragment (f32, round to nearest).
__device__ __forceinline__ void add_acc(float (&d)[8][4], const float (&a)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) d[j][i] += a[j][i];
}

// f32 ulps around a bf16 rounding midpoint within which the bf16 wide kernels
// decide the rounding from the in-order sum: ~2^-16 of the value, ~0.4% of the
// entries.  The in-order sum lies some sqrt(K) / 2 ulps from the exact one and
// the tensor cores' T a few more, well inside the window; a flip the window
// missed would show against the twin as 1e-4 to 1e-3 of max|twin| at the
// flagship's shapes, where the kernels read ~1e-5 and less.
constexpr int NEAR_ULPS = 128;

// Whether rounding x to bf16 (to nearest) could go the other way for an x up to
// NEAR_ULPS f32 ulps off: its low 16 bits lie near the midpoint 0x8000.
__device__ __forceinline__ bool near_bf16_midpoint(float x) {
  const int low = static_cast<int>(__float_as_uint(x) & 0xffffu);
  return abs(low - 0x8000) < NEAR_ULPS;
}

// The value of T that mask<WT, kFull> rounds to bf16 first: T itself against a
// bf16 W (T is rounded before the multiply), else T * w.
template <typename WT>
__device__ __forceinline__ float first_rounded(float t, WT w) {
  if constexpr (std::is_same<WT, bf16_t>::value) return t;
  else return t * to_f32(w);
}

// sum over k in order of q[k] b[k] in f32 (fmaf from 0): the order of the plain
// twin's f32 product.  q and b are bf16 rows of K whose 8-entry pieces lie STEP
// bytes apart: 16 in a row-major array, 128 in core matrices.
template <int STEP>
__device__ __forceinline__ float dot_in_order(const unsigned char* q, const unsigned char* b,
                                              int K) {
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < K / 8; ++c) {
    const uint4 qv = *reinterpret_cast<const uint4*>(q + c * STEP);
    const uint4 bv = *reinterpret_cast<const uint4*>(b + c * STEP);
    const uint32_t qs[4] = {qv.x, qv.y, qv.z, qv.w}, bs[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc = fmaf(__uint_as_float(qs[e] << 16), __uint_as_float(bs[e] << 16), acc);
      acc = fmaf(__uint_as_float(qs[e] & 0xffff0000u), __uint_as_float(bs[e] & 0xffff0000u), acc);
    }
  }
  return acc;
}

// P = T * W of a warp's 16 rows and the S tile's 64 columns, packed as wgmma_rs's A
// fragments (mask<WT, kFull>, the first rounding decided as the in-order sum
// decides it).  t: T's accumulator fragments (rows wr + g, + 8; columns 8j + 2t,
// + 1); Ws: the tile's W rows by swz<RB>; qrow(r), brow(s): the bf16 rows of Q (the
// block's row r) and Be (the tile's row s) whose 8-entry pieces lie STEP bytes
// apart, for dot_in_order.
template <typename WT, int RB, int STEP, typename QRow, typename BRow>
__device__ __forceinline__ void mask_pack(uint32_t (&p)[8][2], float (&t)[8][4],
                                          const unsigned char* Ws, int wr, int g, int tq, int K,
                                          QRow qrow, BRow brow) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    WT w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = wr + g + (e >> 1) * 8, s = j * 8 + 2 * tq + (e & 1);
      w[e] = *reinterpret_cast<const WT*>(Ws + swz<RB>(r, s * static_cast<int>(sizeof(WT))));
      if (to_f32(w[e]) != 0.f && near_bf16_midpoint(first_rounded(t[j][e], w[e])))
        t[j][e] = dot_in_order<STEP>(qrow(r), brow(s), K);
    }
    p[j][0] = pack_bf16(mask<WT, Body::kFull>(t[j][0], w[0]), mask<WT, Body::kFull>(t[j][1], w[1]));
    p[j][1] = pack_bf16(mask<WT, Body::kFull>(t[j][2], w[2]), mask<WT, Body::kFull>(t[j][3], w[3]));
  }
}

template <typename WT>
size_t gram_bf16_whole_smem(int K) {
  return static_cast<size_t>(RING_BM) * K * 2 +
         2 * (static_cast<size_t>(WB_BSS) * K * 2 +
              static_cast<size_t>(RING_BM) * WB_BSS * sizeof(WT));
}

template <typename WT>
__global__ void __launch_bounds__(RING_NT, 1)
    gram_bf16_whole_kernel(const uint16_t* __restrict__ Q, const uint16_t* __restrict__ Be,
                           const WT* __restrict__ W, float* __restrict__ part, int R, int S,
                           int K, int chunk, int col_chunk) {
  constexpr int STG = 2;
  constexpr int RB = WB_BSS * sizeof(WT);  // bytes of a W tile row
  extern __shared__ __align__(16) unsigned char smem[];
  const int core_row = K * 16;  // bytes from one 8-row group of core matrices to the next
  unsigned char* Qs = smem;                                // [128, K]
  unsigned char* Bring = Qs + RING_BM * K * 2;             // STG x [64, K]
  unsigned char* Wring = Bring + STG * WB_BSS * K * 2;     // STG x [128, 64] W, swz

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int wgr = (threadIdx.x >> 7) * 64;
  const size_t row0 = static_cast<size_t>(blockIdx.x / wide_col_blocks(K, col_chunk)) * RING_BM;
  const int rows = min(RING_BM, R - static_cast<int>(row0));
  const int c0 = blockIdx.x % wide_col_blocks(K, col_chunk) * col_chunk;
  const int nct = min(col_chunk, K - c0) / BN;
  const Chunk ch(part, R, S, K, chunk);
  const int ntiles = (ch.s_end - ch.s_begin) / WB_BSS;  // chunk and S are multiples of 64

  auto load = [&](int tile) {
    const int s0 = ch.s_begin + tile * WB_BSS;
    copy_core_async<RING_NT>(Bring + (tile % STG) * WB_BSS * K * 2,
                             Be + static_cast<size_t>(s0) * K, WB_BSS, K);
    copy_swz_async<RING_NT, RB>(Wring + (tile % STG) * RING_BM * RB, W + row0 * S + s0,
                                static_cast<size_t>(S) * sizeof(WT), rows, RB);
  };
  copy_core_async<RING_NT>(Qs, Q + row0 * K, rows, K);
  if (ntiles > 0) load(0);
  cp_async_commit();

  const bool active = wgr < rows;
  float acc_o[WH_TILES][8][4] = {};
  for (int it = 0; it < ntiles; ++it) {
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
    __syncthreads();  // tile it landed
    const unsigned char* Bs = Bring + (it % STG) * WB_BSS * K * 2;
    const unsigned char* Ws = Wring + (it % STG) * RING_BM * RB;
    // T[64, 64] = Q[64, K] Be[S tile]^T, while tile it-1's output product runs
    float acc_t[8][4] = {};
    if (active) {
      wgmma_fence();
      for (int kk = 0; kk < K / 16; ++kk)
        wgmma_ss(acc_t, gmma_desc(Qs + (wgr >> 3) * core_row + kk * 256, 128, core_row),
                 gmma_desc(Bs + kk * 256, 128, core_row), kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");  // tile it-1 is read
#pragma unroll
      for (int q = 0; q < WH_TILES; ++q) fence_acc(acc_o[q]);
    }
    __syncthreads();  // both warpgroups are done with tile it-1's stage
    if (it + 1 < ntiles) load(it + 1);
    cp_async_commit();
    if (!active) continue;
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc_t);
    uint32_t p[8][2];
    mask_pack<WT, RB, 128>(
        p, acc_t, Ws, wr, g, t, K,
        [&](int r) { return Qs + (r >> 3) * core_row + (r & 7) * 16; },
        [&](int s) { return Bs + (s >> 3) * core_row + (s & 7) * 16; });
    // out[64, c0 + 64q ..] += P[64, 64] Be[S tile, c0 + 64q ..], in flight until the next tile
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < WH_TILES; ++q) {
      if (q >= nct) break;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc_o[q], p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1],
                 gmma_desc(Bs + 2 * kk * core_row + ((c0 >> 3) + 8 * q) * 128, core_row, 128));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < WH_TILES; ++q) fence_acc(acc_o[q]);
  cp_async_wait<0>();
  if (wr >= rows) return;
#pragma unroll
  for (int q = 0; q < WH_TILES; ++q) {
    if (q >= nct) break;
    store_out_bf16(ch.out, acc_o[q], row0 + wr + g, K, c0 + q * BN, t);
  }
}

template <typename WT, int STG>
size_t gram_bf16_wide_smem(int K) {
  const size_t nc = wide_col_chunk(K, WB_TILES);
  return static_cast<size_t>(STG) * (RING_BM * WD_KC * 2 + WB_BSS * WD_KC * 2) +
         2 * (WB_BSS * nc * 2 + static_cast<size_t>(RING_BM) * WB_BSS * sizeof(WT));
}

template <typename WT, int STG>
__global__ void __launch_bounds__(RING_NT, 1)
    gram_bf16_wide_kernel(const uint16_t* __restrict__ Q, const uint16_t* __restrict__ Be,
                          const WT* __restrict__ W, float* __restrict__ part, int R, int S,
                          int K, int chunk, int col_chunk) {
  static_assert(STG >= 2, "a ring of at least two stages");
  constexpr int RB = WB_BSS * sizeof(WT);      // bytes of a W tile row
  constexpr int QC = RING_BM * WD_KC * 2;      // bytes of a stage's Q chunk
  constexpr int STAGE = QC + WB_BSS * WD_KC * 2;
  constexpr int CORE = WD_KC * 16;  // from one 8-row group of a chunk's core matrices to the next
  extern __shared__ __align__(16) unsigned char smem[];
  const int bo_bytes = WB_BSS * col_chunk * 2;
  unsigned char* ring = smem;                // STG x {Q chunk [128, 64], Be chunk [64, 64]}
  unsigned char* Bo = ring + STG * STAGE;    // 2 x [64, col_chunk]
  unsigned char* Wt = Bo + 2 * bo_bytes;     // 2 x [128, 64] W, swz

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int wgr = (threadIdx.x >> 7) * 64;
  const size_t row0 = static_cast<size_t>(blockIdx.x / wide_col_blocks(K, col_chunk)) * RING_BM;
  const int rows = min(RING_BM, R - static_cast<int>(row0));
  const int c0 = blockIdx.x % wide_col_blocks(K, col_chunk) * col_chunk;
  const int ncols = min(col_chunk, K - c0);  // the last chunk may be narrower
  const int nct = ncols / BN;
  const int core_o = ncols * 16;  // from one 8-row group of Bo's core matrices to the next
  const Chunk ch(part, R, S, K, chunk);
  const int nkc = K / WD_KC;  // > STG (K > 256): a W / Bo buffer is free before it reloads
  const int ntiles = (ch.s_end - ch.s_begin) / WB_BSS;  // chunk and S are multiples of 64
  const int steps = ntiles * nkc;

  // step u: K chunk kc of S tile it (and, first in the tile, its W and Bo)
  auto load = [&](int u) {
    const int it = u / nkc, kc = u - it * nkc;
    const int s0 = ch.s_begin + it * WB_BSS;
    unsigned char* st = ring + (u % STG) * STAGE;
    copy_core_async<RING_NT>(st, Q + row0 * K + kc * WD_KC, rows, K, WD_KC);
    copy_core_async<RING_NT>(st + QC, Be + static_cast<size_t>(s0) * K + kc * WD_KC, WB_BSS, K,
                             WD_KC);
    if (kc == 0) {
      copy_core_async<RING_NT>(Bo + (it & 1) * bo_bytes, Be + static_cast<size_t>(s0) * K + c0,
                               WB_BSS, K, ncols);
      copy_swz_async<RING_NT, RB>(Wt + (it & 1) * RING_BM * RB, W + row0 * S + s0,
                                  static_cast<size_t>(S) * sizeof(WT), rows, RB);
    }
  };
#pragma unroll
  for (int st = 0; st < STG - 1; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }

  const bool active = wgr < rows;
  float acc_o[WB_TILES][8][4] = {};
  float acc_t[8][4] = {};  // one K chunk's T, on the tensor cores
  int u = 0;
  for (int it = 0; it < ntiles; ++it) {
    float tsum[8][4] = {};  // T: the chunks' sums added in f32, in chunk order
    for (int kc = 0; kc < nkc; ++kc, ++u) {
      cp_async_wait<STG - 2>();
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");  // step u-1 is read
      fence_acc(acc_t);
#pragma unroll
      for (int q = 0; q < WB_TILES; ++q) fence_acc(acc_o[q]);
      __syncthreads();
      if (u + STG - 1 < steps) load(u + STG - 1);
      cp_async_commit();
      if (!active) continue;
      if (kc > 0) add_acc(tsum, acc_t);
      // T_kc[64, 64] = Q[64, chunk kc] Be[S tile, chunk kc]^T, in flight until the next step
      const unsigned char* st = ring + (u % STG) * STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WD_KC / 16; ++kk)
        wgmma_ss(acc_t, gmma_desc(st + (wgr >> 3) * CORE + kk * 256, 128, CORE),
                 gmma_desc(st + QC + kk * 256, 128, CORE), kk);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    if (!active) continue;
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc_t);
    add_acc(tsum, acc_t);
    const int s0 = ch.s_begin + it * WB_BSS;
    uint32_t p[8][2];
    mask_pack<WT, RB, 16>(
        p, tsum, Wt + (it & 1) * RING_BM * RB, wr, g, t, K,
        [&](int r) { return reinterpret_cast<const unsigned char*>(Q + (row0 + r) * K); },
        [&](int s) {
          return reinterpret_cast<const unsigned char*>(Be + static_cast<size_t>(s0 + s) * K);
        });
    // out[64, c0 + 64q ..] += P[64, 64] Bo[64, 64q ..], in flight until the next step
    const unsigned char* bo = Bo + (it & 1) * bo_bytes;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < WB_TILES; ++q) {
      if (q >= nct) break;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc_o[q], p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1],
                 gmma_desc(bo + 2 * kk * core_o + q * 1024, core_o, 128));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < WB_TILES; ++q) fence_acc(acc_o[q]);
  cp_async_wait<0>();
  if (wr >= rows) return;
#pragma unroll
  for (int q = 0; q < WB_TILES; ++q) {
    if (q >= nct) break;
    store_out_bf16(ch.out, acc_o[q], row0 + wr + g, K, c0 + q * BN, t);
  }
}

// WHOLE: Q held whole ([64][K + 4]) and the whole-K Be tile in a two-stage ring
// ([32][K + 4]), which the output product reads too; else the K chunks streamed in
// a two-stage ring and the tile's Be columns of the block's chunk (Bo) by a
// double buffer.
constexpr int WF_STG = 2;

template <typename WT, bool WHOLE>
size_t gram_f32_wide_smem(int K) {
  const size_t nc = wide_col_chunk(K, WF_TILES);
  const size_t rest = 2 * static_cast<size_t>(WF_BM) * (WF_BSS + WPad<WT>::v) * sizeof(WT) +
                      2 * static_cast<size_t>(WF_BSS) * WF_LDP * 4;
  if (WHOLE) return static_cast<size_t>(WF_BM + 2 * WF_BSS) * (K + 4) * 4 + rest;
  return static_cast<size_t>(WF_STG) * (WF_BM + WF_BSS) * WF_LDK * 4 + 2 * WF_BSS * nc * 4 +
         rest;
}

template <typename WT, bool WHOLE>
__global__ void __launch_bounds__(WF_NT, 1)
    gram_f32_wide_kernel(const float* __restrict__ Q, const float* __restrict__ Be,
                         const WT* __restrict__ W, float* __restrict__ part, int R, int S, int K,
                         int chunk, int col_chunk) {
  constexpr int STG = WF_STG;
  constexpr int ldw = WF_BSS + WPad<WT>::v;
  constexpr int TB = WF_BSS * WF_LDP;  // floats of a [32][LDP] T buffer
  extern __shared__ __align__(16) unsigned char smem[];
  // rows of the Q and Be tiles the score product reads: a chunk's, or the whole K's
  const int ldk = WHOLE ? K + 4 : WF_LDK;
  const int stage = WHOLE ? WF_BSS * ldk : (WF_BM + WF_BSS) * WF_LDK;  // floats
  const int bo_n = WHOLE ? 0 : WF_BSS * col_chunk;
  float* Qw = reinterpret_cast<float*>(smem);  // WHOLE: [64][K + 4]
  float* ring = Qw + (WHOLE ? WF_BM * ldk : 0);
  float* Bo = ring + (WHOLE ? 2 : STG) * stage;  // 2 x [32][col_chunk] (not WHOLE)
  float* Tb = Bo + 2 * bo_n;  // 2 x [32][LDP]: two quarters' T, transposed; P in the first
  WT* Wt = reinterpret_cast<WT*>(Tb + 2 * TB);  // 2 x [64][ldw]

  // score product: quarter kq of every K chunk, rows rg + 8i, S columns sg + 8j
  const int kq = threadIdx.x >> 6;
  const int rg = (threadIdx.x & 63) >> 3, sg = threadIdx.x & 7;
  // T * W: S column ps, rows pr..pr+7; output: rows 8ty.., columns 4tx + 128m (+ 2tx)
  const int ps = threadIdx.x >> 3, pr = (threadIdx.x & 7) * 8;
  const int ty = threadIdx.x >> 5, tx = threadIdx.x & 31;
  const int rb = blockIdx.x / wide_col_blocks(K, col_chunk);
  const size_t row0 = static_cast<size_t>(rb) * WF_BM;
  const int c0 = blockIdx.x % wide_col_blocks(K, col_chunk) * col_chunk;
  const int nc = min(col_chunk, K - c0);
  const int nm = nc / 128, tail = nc % 128;  // full 128-column groups, and 64 more or none
  const Chunk ch(part, R, S, K, chunk);
  const int nkc = K / WD_KC;  // > STG (K > 256): a W / Bo buffer is free before it reloads
  const int ntiles = (ch.s_end - ch.s_begin) / WF_BSS;
  // steps of the ring: a K chunk of an S tile, or (WHOLE) an S tile
  const int per_tile = WHOLE ? 1 : nkc;
  const int steps = ntiles * per_tile;

  auto load = [&](int u) {
    const int it = u / per_tile, kc = u - it * per_tile;
    const int s0 = ch.s_begin + it * WF_BSS;
    if (WHOLE) {
      copy_tile_async<WF_NT>(ring + (it & 1) * stage, ldk * 4, Be + static_cast<size_t>(s0) * K,
                             static_cast<size_t>(K) * 4, WF_BSS, K * 4);
    } else {
      float* st = ring + (u % STG) * stage;
      copy_tile_async<WF_NT>(st, WF_LDK * 4, Q + row0 * K + kc * WD_KC,
                             static_cast<size_t>(K) * 4, WF_BM, WD_KC * 4);
      copy_tile_async<WF_NT>(st + WF_BM * WF_LDK, WF_LDK * 4,
                             Be + static_cast<size_t>(s0) * K + kc * WD_KC,
                             static_cast<size_t>(K) * 4, WF_BSS, WD_KC * 4);
      if (kc == 0)  // the chunk's own columns: the last chunk may be narrower
        copy_tile_async<WF_NT>(Bo + (it & 1) * bo_n, col_chunk * 4,
                               Be + static_cast<size_t>(s0) * K + c0,
                               static_cast<size_t>(K) * 4, WF_BSS, nc * 4);
    }
    if (kc == 0)
      copy_tile_async<WF_NT>(Wt + (it & 1) * WF_BM * ldw, ldw * sizeof(WT), W + row0 * S + s0,
                             static_cast<size_t>(S) * sizeof(WT), WF_BM, WF_BSS * sizeof(WT));
  };
  if (WHOLE)
    copy_tile_async<WF_NT>(Qw, ldk * 4, Q + row0 * K, static_cast<size_t>(K) * 4, WF_BM, K * 4);
  constexpr int AHEAD = WHOLE ? 1 : STG - 1;  // steps loaded ahead
#pragma unroll
  for (int st = 0; st < AHEAD; ++st) {
    if (st < steps) load(st);
    cp_async_commit();
  }

  // out[8ty + i][c0 + 128m + 4tx + e] at acc[i][4m + e]; the 64-column tail at m = nm, e < 2
  float acc[8][4 * (WF_TILES / 2)] = {};
  int u = 0;
  for (int it = 0; it < ntiles; ++it) {
    // this quarter's T[rg + 8i][sg + 8j], k in order within the quarter
    float t[8][4] = {};
    for (int kc = 0; kc < nkc; ++kc) {
      const float *Qc, *Bc;
      if (WHOLE) {
        if (kc == 0) {
          cp_async_wait<0>();
          __syncthreads();  // tile it landed; tile it-1 (and its P) is consumed
          if (u + 1 < steps) load(u + 1);
          cp_async_commit();
          ++u;
        }
        Qc = Qw + kc * WD_KC;
        Bc = ring + (it & 1) * stage + kc * WD_KC;
      } else {
        cp_async_wait<STG - 2>();
        __syncthreads();  // step u landed; step u-1 (and tile it-1's P) is consumed
        if (u + STG - 1 < steps) load(u + STG - 1);
        cp_async_commit();
        Qc = ring + (u % STG) * stage;
        Bc = Qc + WF_BM * WF_LDK;
        ++u;
      }
#pragma unroll
      for (int k = kq * (WD_KC / 4); k < (kq + 1) * (WD_KC / 4); k += 4) {
        float4 b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(Bc + (sg + 8 * j) * ldk + k);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(Qc + (rg + 8 * i) * ldk + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) fma4(t[i][j], a, b[j]);
        }
      }
    }
    // T = (quarter 0 + quarter 2) + (quarter 1 + quarter 3), through Tb (transposed)
    if (kq >= 2) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Tb[(kq - 2) * TB + (sg + 8 * j) * WF_LDP + rg + 8 * i] = t[i][j];
    }
    __syncthreads();
    if (kq < 2) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* pp = Tb + kq * TB + (sg + 8 * j) * WF_LDP + rg + 8 * i;
          *pp = t[i][j] + *pp;
        }
    }
    __syncthreads();
    // P = T * W into the first buffer, each thread its own eight entries
    {
      const WT* Ws = Wt + (it & 1) * WF_BM * ldw;
      float* p0 = Tb + ps * WF_LDP + pr;
      const float* p1 = Tb + TB + ps * WF_LDP + pr;
      const float4 a0 = *reinterpret_cast<const float4*>(p0);
      const float4 a1 = *reinterpret_cast<const float4*>(p0 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(p1);
      const float4 b1 = *reinterpret_cast<const float4*>(p1 + 4);
      const float tv[8] = {a0.x + b0.x, a0.y + b0.y, a0.z + b0.z, a0.w + b0.w,
                           a1.x + b1.x, a1.y + b1.y, a1.z + b1.z, a1.w + b1.w};
      float pv[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) pv[e] = tv[e] * to_f32(Ws[(pr + e) * ldw + ps]);
      *reinterpret_cast<float4*>(p0) = make_float4(pv[0], pv[1], pv[2], pv[3]);
      *reinterpret_cast<float4*>(p0 + 4) = make_float4(pv[4], pv[5], pv[6], pv[7]);
    }
    __syncthreads();
    // out[8ty + i][.] += sum over s in order of P[.][s] Bo[s][.] (WHOLE: the Be tile's columns)
    const float* B = WHOLE ? ring + (it & 1) * stage + c0 : Bo + (it & 1) * bo_n;
    const int ldb = WHOLE ? ldk : col_chunk;
#pragma unroll 2
    for (int s = 0; s < WF_BSS; ++s) {
      const float4 a0 = *reinterpret_cast<const float4*>(Tb + s * WF_LDP + 8 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(Tb + s * WF_LDP + 8 * ty + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int m = 0; m < WF_TILES / 2; ++m) {
        if (m < nm) {
          const float4 b = *reinterpret_cast<const float4*>(B + s * ldb + 128 * m + 4 * tx);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][4 * m] = fmaf(av[i], b.x, acc[i][4 * m]);
            acc[i][4 * m + 1] = fmaf(av[i], b.y, acc[i][4 * m + 1]);
            acc[i][4 * m + 2] = fmaf(av[i], b.z, acc[i][4 * m + 2]);
            acc[i][4 * m + 3] = fmaf(av[i], b.w, acc[i][4 * m + 3]);
          }
        } else if (m == nm && tail) {
          const float2 b = *reinterpret_cast<const float2*>(B + s * ldb + 128 * m + 2 * tx);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][4 * m] = fmaf(av[i], b.x, acc[i][4 * m]);
            acc[i][4 * m + 1] = fmaf(av[i], b.y, acc[i][4 * m + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* o = ch.out + (row0 + 8 * ty + i) * K + c0;
#pragma unroll
    for (int m = 0; m < WF_TILES / 2; ++m) {
      if (m < nm)
        *reinterpret_cast<float4*>(o + 128 * m + 4 * tx) =
            make_float4(acc[i][4 * m], acc[i][4 * m + 1], acc[i][4 * m + 2], acc[i][4 * m + 3]);
      else if (m == nm && tail)
        *reinterpret_cast<float2*>(o + 128 * m + 2 * tx) =
            make_float2(acc[i][4 * m], acc[i][4 * m + 1]);
    }
  }
}

// ------------------------------------------------------ K2 past K = 256
// rhs_bf16_wgmma_kernel owns 64 output columns a block, and its launcher makes
// gridDim.y = K / 64 with blockIdx.x over the row blocks fastest, so past K = 256
// each of the K / 64 column groups streams the whole X and W from device memory and
// forms V = (X - mb) * W again: 5 x 2.24 GB at the flagship's A side at K = 320, 16 x
// at K = 1024.  rhs_bf16_wide_kernel (bf16 operands, any W type) serves K2 past
// kTiledMaxK instead, and is bound by the bytes of X and W (0.70 ms at K = 320 on an
// H100) up to K ~ 450, by its 2RSK tensor-core operations past that (1.55 ms at K =
// 1024):
//  - a block owns a 128-row block (two warpgroups of 64 rows) and as many output
//    columns as its registers hold: RW_TILES tiles of 64, 32 f32 accumulators a
//    thread each (160 at K = 320, all of it in one chunk); blockIdx.x runs over a row
//    block's column chunks fastest (wide_col_blocks), so at K = 1024 its four chunks
//    run side by side and X and W leave device memory once;
//  - V is formed in f32 from the staged X, W and mb once an S tile and a block, and
//    rounded to bf16 once (masked_rhs_ref's rounding point), as wgmma_rs's register A
//    operand of the chunk's output tiles, against the S tile's Be columns of the
//    chunk read MN-major;
//  - the tiles come by the Tensor Memory Accelerator through a ring of 64-wide S
//    tiles (three stages where they fit, else two), thread 0 asking for them on the
//    stage's mbarrier: X and W as 2-D boxes of [128 rows, 64 columns] that land as
//    swz lays them out (128 B rows by 128B swizzle, an int8 W's 64 B rows by 64B, an
//    f32 W as two 128 B halves), mb's 256 bytes by a bulk copy, the chunk's Be
//    columns as [64 S rows, 64 columns] tiles by 128B swizzle (wgmma's MN-major
//    layout of that swizzle).  The first design streamed them by cp.async from all
//    threads (2.47 ms at K = 320, the copies alone 2.14, X and W's 1.05: the block's
//    requests, not device memory, set the pace); a cluster of two row blocks
//    multicasting each Be tile read slower than TMA alone (1.86 ms), its blocks
//    waiting on each other at every stage (PERF.md);
//  - V of tile it is formed while tile it-1's products run (two sets of A registers,
//    wgmma.wait_group 1), and every warp runs the products whatever rows it holds (a
//    ragged last block's second warpgroup computes on zeros and stores nothing): no
//    wgmma or wait sits on a path the compiler could take for divergent (C7518
//    serializes them).
// Split-S as the tiled kernels: no atomics, two calls give the same bits.
constexpr int RW_TILES = 5;  // output tiles of 64 columns a block at most
constexpr int RW_BSS = 64;   // S tile

// Probe builds leave one part of rhs_bf16_wide_kernel's work out, so that
// scripts/time_k2_wide_torch.py can split a launch's time (their results are not
// K2's): no V and no products (the copies alone), no Be copies (the products read
// whatever the ring holds).  A probe build is this file compiled alone with
// -DCMF_K2_PROBE=<bits> (ops/_cuda.py: probe_libs); the ops' library is compiled
// without it, and kK2Probe is 0 there.
constexpr int kK2ProbeNoMath = 1;
constexpr int kK2ProbeNoBe = 2;
#ifndef CMF_K2_PROBE
#define CMF_K2_PROBE 0
#endif
constexpr int kK2Probe = CMF_K2_PROBE;

// Two consecutive W entries, widened to f32.
__device__ __forceinline__ float2 load_w2(const int8_t* p) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(p);
  return make_float2(static_cast<float>(static_cast<int8_t>(v & 0xff)),
                     static_cast<float>(static_cast<int8_t>(v >> 8)));
}

__device__ __forceinline__ float2 load_w2(const bf16_t* p) {
  const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
  return make_float2(bf16_bits_to_float(static_cast<uint16_t>(v & 0xffffu)),
                     bf16_bits_to_float(static_cast<uint16_t>(v >> 16)));
}

__device__ __forceinline__ float2 load_w2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of parity `parity` to complete; a fault in the protocol traps (a
// launch error) after ~10 s rather than holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
      "%3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// A 128B-swizzled MN-major operand of 64 columns: 128 B rows, 8-row groups 1024 B
// apart (SBO); LBO, the stride to the next 64 columns, is not read at N = 64.
__device__ __forceinline__ uint64_t gmma_desc_sw128(const void* p) {
  return gmma_desc(p, 8192, 1024) | (1ull << 62);
}

// Bytes of a ring stage: nc / 64 Be tiles [64, 64] (8 KB each), X [128, 64], W
// [128, 64], mb (a 1 KB slot), each 1024-aligned for the swizzle.
template <typename WT>
__host__ __device__ __forceinline__ size_t rhs_wide_stage(size_t nc) {
  return nc / 64 * 8192 + static_cast<size_t>(RING_BM) * RW_BSS * (2 + sizeof(WT)) + 1024;
}

template <typename WT, int STG>
size_t rhs_bf16_wide_smem(int K) {
  return 1024 + STG * rhs_wide_stage<WT>(wide_col_chunk(K, RW_TILES)) + STG * sizeof(uint64_t);
}

// Byte of W entry (r, s) in a stage's W tile as TMA lays it out (an f32 W in two
// halves of 32 columns).
template <typename WT>
__device__ __forceinline__ int w_tile_byte(int r, int s) {
  if constexpr (sizeof(WT) == 4) return (s >> 5) * (RING_BM * 128) + swz<128>(r, (s & 31) * 4);
  else return swz<RW_BSS * sizeof(WT)>(r, s * static_cast<int>(sizeof(WT)));
}

// One warp's share of a stage: V = (X - mb) * W of its 16 rows and the S tile's 64
// columns, rounded to bf16 into p as wgmma_rs's A fragments (rows wr + g, + 8;
// columns 8j + 2t, + 1), then out[64, 64q ..] += V Be[S tile, 64q ..] for the chunk's
// nct tiles (Be tiles at Bs + 8192 q; X, W and mb at Bs + xo, wo, mo), committed and
// left in flight.  (One instruction over several tiles, N up to 256, read 5% faster
// at K = 1024 and no faster at 320.)
template <typename WT>
__device__ __forceinline__ void rhs_wide_products(float (&acc)[RW_TILES][8][4],
                                                  uint32_t (&p)[8][2], const unsigned char* Bs,
                                                  int xo, int wo, int mo, int nct, int wr, int g,
                                                  int t) {
  constexpr int RX = RW_BSS * 2;  // bytes of an X tile row
  if constexpr (kK2Probe & kK2ProbeNoMath) return;
  const unsigned char* Xs = Bs + xo;
  const unsigned char* Ws = Bs + wo;
  const float* ms = reinterpret_cast<const float*>(Bs + mo);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int s = j * 8 + 2 * t;
    const float2 m = *reinterpret_cast<const float2*>(ms + s);
    const uint32_t x0 = *reinterpret_cast<const uint32_t*>(Xs + swz<RX>(wr + g, 2 * s));
    const uint32_t x1 = *reinterpret_cast<const uint32_t*>(Xs + swz<RX>(wr + g + 8, 2 * s));
    const float2 w0 = load_w2(reinterpret_cast<const WT*>(Ws + w_tile_byte<WT>(wr + g, s)));
    const float2 w1 = load_w2(reinterpret_cast<const WT*>(Ws + w_tile_byte<WT>(wr + g + 8, s)));
    p[j][0] = pack_bf16((bf16_bits_to_float(static_cast<uint16_t>(x0 & 0xffffu)) - m.x) * w0.x,
                        (bf16_bits_to_float(static_cast<uint16_t>(x0 >> 16)) - m.y) * w0.y);
    p[j][1] = pack_bf16((bf16_bits_to_float(static_cast<uint16_t>(x1 & 0xffffu)) - m.x) * w1.x,
                        (bf16_bits_to_float(static_cast<uint16_t>(x1 >> 16)) - m.y) * w1.y);
  }
  wgmma_fence();
#pragma unroll
  for (int q = 0; q < RW_TILES; ++q) {
    if (q >= nct) break;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(acc[q], p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0], p[2 * kk + 1][1],
               gmma_desc_sw128(Bs + q * 8192 + kk * 2048));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <typename WT, int STG>
__global__ void __launch_bounds__(RING_NT, 1)
    rhs_bf16_wide_kernel(const __grid_constant__ CUtensorMap tmX,
                         const __grid_constant__ CUtensorMap tmW,
                         const __grid_constant__ CUtensorMap tmB, const float* __restrict__ mb,
                         float* __restrict__ part, int R, int S, int K, int chunk, int col_chunk) {
  static_assert(STG >= 2, "a ring of at least two stages");
  constexpr int XB = RING_BM * RW_BSS * 2, WB = RING_BM * RW_BSS * sizeof(WT);
  constexpr bool kBe = !(kK2Probe & kK2ProbeNoBe);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int stage = static_cast<int>(rhs_wide_stage<WT>(col_chunk));
  const int xo = col_chunk / BN * 8192, wo = xo + XB, mo = wo + WB;  // a stage's X, W, mb
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STG * stage);  // a stage's tiles landed

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (threadIdx.x >> 5) * 16;
  const int row0 = blockIdx.x / wide_col_blocks(K, col_chunk) * RING_BM;
  const int rows = min(RING_BM, R - row0);
  const int c0 = blockIdx.x % wide_col_blocks(K, col_chunk) * col_chunk;
  const int nct = min(col_chunk, K - c0) / BN;  // the last chunk may be narrower
  const Chunk ch(part, R, S, K, chunk);
  const int ntiles = (ch.s_end - ch.s_begin) / RW_BSS;  // chunk and S are multiples of 64
  const uint32_t tile_bytes = XB + WB + RW_BSS * sizeof(float) + (kBe ? nct * 8192 : 0);

  if (threadIdx.x == 0) {
    for (int i = 0; i < STG; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: tile `tile` into its stage (rows past R arrive as zeros)
  auto issue = [&](int tile) {
    unsigned char* st = smem + (tile % STG) * stage;
    uint64_t* bar = full + tile % STG;
    const int s0 = ch.s_begin + tile * RW_BSS;
    mbar_expect_tx(bar, tile_bytes);
    tma_2d(st + xo, &tmX, s0, row0, bar);
    tma_2d(st + wo, &tmW, s0, row0, bar);
    if constexpr (sizeof(WT) == 4) tma_2d(st + wo + RING_BM * 128, &tmW, s0 + 32, row0, bar);
    bulk_copy(st + mo, mb + s0, RW_BSS * sizeof(float), bar);
    if constexpr (kBe)
      for (int q = 0; q < nct; ++q) tma_2d(st + q * 8192, &tmB, c0 + q * BN, s0, bar);
  };
  if (threadIdx.x == 0)
    for (int tile = 0; tile < STG - 1 && tile < ntiles; ++tile) issue(tile);

  float acc[RW_TILES][8][4] = {};
  uint32_t pa[8][2], pb[8][2];  // V of the even and of the odd tiles
  // tile it's products, once its stage has landed
  auto products = [&](int it, uint32_t (&p)[8][2]) {
    mbar_wait(full + it % STG, (it / STG) & 1);
    rhs_wide_products<WT>(acc, p, smem + (it % STG) * stage, xo, wo, mo, nct, wr, g, t);
  };
  // after them: tile it-1's awaited; once both warpgroups are done with its stage,
  // tile it + STG - 1 goes there
  auto end = [&](int it) {
    if constexpr (!(kK2Probe & kK2ProbeNoMath))
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0 && it + STG - 1 < ntiles) issue(it + STG - 1);
  };
  int it = 0;
  for (; it + 1 < ntiles; it += 2) {
    products(it, pa);
    end(it);
    products(it + 1, pb);
    end(it + 1);
  }
  if (it < ntiles) {
    products(it, pa);
    end(it);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < RW_TILES; ++q) fence_acc(acc[q]);
  if (wr >= rows) return;
#pragma unroll
  for (int q = 0; q < RW_TILES; ++q) {
    if (q >= nct) break;
    store_out_bf16(ch.out, acc[q], static_cast<size_t>(row0 + wr + g), K, c0 + q * BN, t);
  }
}

// ---------------------------------------------------------------- launch
// The kernel configurations of K1 (op 0) and K2 (op 1) for W type WT,
// numbered as the C interface numbers them, bf16 operands first, each in
// the order the geometry query prefers them.  K1: 0-2 bf16 (three 128-wide
// stages, three 64-wide, two 64-wide), 3-4 f32 (8x8 thread tiles, then the
// 8x4 ring for K > 128), and past K = 256 only the wide ones: 5-6 bf16
// (Q and the whole-K Be tiles held, then the K chunks streamed), 7-8 f32
// (the same).  K2: 0-1 bf16 up to K = 256 (three 64-wide stages, two; a
// block owns 64 output columns and reads only those of Be), 2 f32 at any K
// (the same), and past K = 256 3-4 bf16 (rhs_bf16_wide_kernel, three
// stages, two).
constexpr int OP_GRAM = 0, OP_RHS = 1;
constexpr int CONFIGS[2] = {9, 5};
constexpr int GRAM_WIDE = 5;      // K1's first wide configuration (bf16)
constexpr int GRAM_WIDE_F32 = 7;  // and its first f32 one
constexpr int RHS_WIDE = 3;       // K2's first wide configuration (bf16 only)

// The configurations the geometry query tries, in order: [first, last].
void config_range(int op, int K, bool op_f32, int* first, int* last) {
  if (op == OP_GRAM && K > kTiledMaxK) {
    *first = op_f32 ? GRAM_WIDE_F32 : GRAM_WIDE;
    *last = op_f32 ? CONFIGS[OP_GRAM] - 1 : GRAM_WIDE_F32 - 1;
  } else if (op == OP_GRAM) {
    *first = op_f32 ? 3 : 0;
    *last = op_f32 ? 4 : 2;
  } else if (op_f32) {
    *first = *last = 2;
  } else {
    *first = K > kTiledMaxK ? RHS_WIDE : 0;
    *last = K > kTiledMaxK ? CONFIGS[OP_RHS] - 1 : 1;
  }
}

// Whether configuration `variant` of `op` runs at width K (for either operand type).
bool takes_k(int op, int variant, int K) {
  for (int f32 = 0; f32 < 2; ++f32) {
    int first = 0, last = 0;
    config_range(op, K, f32, &first, &last);
    if (first <= variant && variant <= last) return true;
  }
  return false;
}

struct GramConfig {
  const void* kernel;
  int threads, row_tile, s_tile;
  int min_blocks;  // resident blocks an SM it is chosen for (0: the last resort)
  size_t smem;
  bool tma = false;  // the kernel takes TMA maps of X, W and Be (K2 past kTiledMaxK)
};

template <typename WT>
GramConfig gram_config(int variant, int K) {
  switch (variant) {
    case 0: return {reinterpret_cast<const void*>(gram_bf16_wgmma_kernel<WT, 128, 3>), RING_NT,
                    RING_BM, 128, 2, gram_bf16_wgmma_smem<WT, 128, 3>(K)};
    case 1: return {reinterpret_cast<const void*>(gram_bf16_wgmma_kernel<WT, 64, 3>), RING_NT,
                    RING_BM, 64, 2, gram_bf16_wgmma_smem<WT, 64, 3>(K)};
    case 2: return {reinterpret_cast<const void*>(gram_bf16_wgmma_kernel<WT, 64, 2>), RING_NT,
                    RING_BM, 64, 0, gram_bf16_wgmma_smem<WT, 64, 2>(K)};
    case 3: return {reinterpret_cast<const void*>(gram_f32_tile8_kernel<WT>), F8_NT, F8_BM,
                    F8_BSS, 1, gram_f32_tile8_smem<WT>(K)};
    case 4: return {reinterpret_cast<const void*>(gram_f32_ring_kernel<WT>), F32_NT, BM, 32, 0,
                    gram_f32_ring_smem<WT>(K)};
    case 5: return {reinterpret_cast<const void*>(gram_bf16_whole_kernel<WT>), RING_NT,
                    RING_BM, WB_BSS, 1, gram_bf16_whole_smem<WT>(K)};
    case 6: return {reinterpret_cast<const void*>(gram_bf16_wide_kernel<WT, 4>), RING_NT,
                    RING_BM, WB_BSS, 0, gram_bf16_wide_smem<WT, 4>(K)};
    case 7: return {reinterpret_cast<const void*>(gram_f32_wide_kernel<WT, true>), WF_NT, WF_BM,
                    WF_BSS, 1, gram_f32_wide_smem<WT, true>(K)};
    default: return {reinterpret_cast<const void*>(gram_f32_wide_kernel<WT, false>), WF_NT, WF_BM,
                     WF_BSS, 0, gram_f32_wide_smem<WT, false>(K)};
  }
}

template <typename WT>
GramConfig rhs_config(int variant, int K) {
  switch (variant) {
    case 0: return {reinterpret_cast<const void*>(rhs_bf16_wgmma_kernel<WT, 64, 3>), RING_NT,
                    RING_BM, 64, 2, rhs_bf16_wgmma_smem<WT, 64, 3>(K)};
    case 1: return {reinterpret_cast<const void*>(rhs_bf16_wgmma_kernel<WT, 64, 2>), RING_NT,
                    RING_BM, 64, 0, rhs_bf16_wgmma_smem<WT, 64, 2>(K)};
    case 2: return {reinterpret_cast<const void*>(rhs_f32_tile8_kernel<WT>), F8_NT, F8_BM,
                    F8_BSS, 0, rhs_f32_tile8_smem<WT>(K)};
    case 3: return {reinterpret_cast<const void*>(rhs_bf16_wide_kernel<WT, 3>), RING_NT,
                    RING_BM, RW_BSS, 1, rhs_bf16_wide_smem<WT, 3>(K), true};
    default: return {reinterpret_cast<const void*>(rhs_bf16_wide_kernel<WT, 2>), RING_NT,
                     RING_BM, RW_BSS, 0, rhs_bf16_wide_smem<WT, 2>(K), true};
  }
}

template <typename WT>
GramConfig config(int op, int variant, int K) {
  return op == OP_GRAM ? gram_config<WT>(variant, K) : rhs_config<WT>(variant, K);
}

// Whether configuration `variant` of `op` is a wide one: a block owns a chunk of
// the output columns (col_chunk_of) and blockIdx.x runs over them fastest.
bool is_wide(int op, int variant) {
  return variant >= (op == OP_GRAM ? GRAM_WIDE : RHS_WIDE);
}

// The output columns a block of K1's (K2's) configuration `variant` owns.
int col_chunk_of(int op, int variant, int K) {
  if (!is_wide(op, variant)) return BN;
  if (op == OP_RHS) return wide_col_chunk(K, RW_TILES);
  return wide_col_chunk(K, variant >= GRAM_WIDE_F32 ? WF_TILES
                           : variant == GRAM_WIDE  ? WH_TILES
                                                   : WB_TILES);
}

// The first configuration of `op` for these operands that fits the current
// device with its min_blocks resident an SM (the last one whatever fits):
// raises its kernel's shared-memory limit there to the device's opt-in
// maximum (the limit is the kernel's, whatever K it runs at), and writes
// geo = {configuration, row tile, S tile, resident blocks an SM, output
// columns a block, shared memory a block in bytes}.
template <typename WT>
cudaError_t geometry(int op, int K, bool op_f32, int* geo) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int first = 0, last = 0;
  config_range(op, K, op_f32, &first, &last);
  for (int v = first; v <= last; ++v) {
    const GramConfig c = config<WT>(op, v, K);
    if (c.smem > static_cast<size_t>(optin)) {
      if (v == last) return cudaErrorInvalidValue;
      continue;
    }
    err = cudaFuncSetAttribute(c.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, c.kernel, c.threads, c.smem);
    if (err != cudaSuccess) return err;
    if (blocks >= c.min_blocks || v == last) {
      geo[0] = v;
      geo[1] = c.row_tile;
      geo[2] = c.s_tile;
      geo[3] = blocks;
      geo[4] = col_chunk_of(op, v, K);
      geo[5] = static_cast<int>(c.smem);
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

// CUDA's cuTensorMapEncodeTiled, reached through the runtime's entry-point query (no
// link to libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map of a row-major [rows, cols] array of `esz`-byte entries whose boxes are
// [box_rows, box_cols], rows past the array arriving as zeros.
cudaError_t map_2d(CUtensorMap* m, CUtensorMapDataType type, int esz, const void* base, int rows,
                   int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esz};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(m, type, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// How a W tile travels by TMA: its type, box columns (an f32 W's 64 in two boxes) and
// swizzle (as swz lays out its rows).
template <typename WT> struct WMap;
template <> struct WMap<int8_t> {
  static constexpr CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int cols = 64;
  static constexpr CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_64B;
};
template <> struct WMap<bf16_t> {
  static constexpr CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int cols = 64;
  static constexpr CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
};
template <> struct WMap<float> {
  static constexpr CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static constexpr int cols = 32;
  static constexpr CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B;
};

// K2 by a TMA configuration (rhs_bf16_wide_kernel): the maps of X, W and Be.
template <typename WT>
cudaError_t run_tma(const GramConfig& c, const void* const (&ptrs)[4], float* part, int R, int S,
                    int K, int chunk, int col_chunk, cudaStream_t st) {
  CUtensorMap maps[3];
  cudaError_t err = map_2d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptrs[0], R, S, RING_BM,
                           RW_BSS, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = map_2d(&maps[1], WMap<WT>::type, sizeof(WT), ptrs[1], R, S, RING_BM, WMap<WT>::cols,
                 WMap<WT>::swizzle);
  if (err == cudaSuccess)
    err = map_2d(&maps[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptrs[3], S, K, RW_BSS, BN,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const unsigned row_blocks = (R + RING_BM - 1) / RING_BM;
  const dim3 grid(row_blocks * wide_col_blocks(K, col_chunk), 1, (S + chunk - 1) / chunk);
  const void* mb = ptrs[2];
  void* args[] = {&maps[0], &maps[1], &maps[2], &mb, &part, &R, &S, &K, &chunk, &col_chunk};
  return cudaLaunchKernel(c.kernel, grid, dim3(c.threads), args, c.smem, st);
}

// K1 or K2 into `part` (out itself for one chunk) with configuration
// `variant`, whose shared-memory limit geometry() has set on this device;
// ptrs are the kernel's leading pointers in its order (three for K1).
// col_chunk: the output columns a block owns, as geometry() gave them
// (col_chunk_of); the wide configurations run only past kTiledMaxK, and the
// tiled bf16 ones only up to it.
template <typename WT>
cudaError_t run(int op, int variant, const void* const (&ptrs)[4], float* part, int R, int S,
                int K, int chunk, int col_chunk, cudaStream_t st) {
  if (variant < 0 || variant >= CONFIGS[op]) return cudaErrorInvalidValue;
  const bool wide = is_wide(op, variant);
  if (!takes_k(op, variant, K) || col_chunk != col_chunk_of(op, variant, K))
    return cudaErrorInvalidValue;
  const GramConfig c = config<WT>(op, variant, K);
  if (chunk % c.s_tile) return cudaErrorInvalidValue;
  if (c.tma) return run_tma<WT>(c, ptrs, part, R, S, K, chunk, col_chunk, st);
  const unsigned row_blocks = (R + c.row_tile - 1) / c.row_tile;
  const unsigned col_blocks = wide_col_blocks(K, col_chunk);
  const dim3 grid(wide ? row_blocks * col_blocks : row_blocks, wide ? 1 : col_blocks,
                  (S + chunk - 1) / chunk);
  const void* p0 = ptrs[0];
  const void* p1 = ptrs[1];
  const void* p2 = ptrs[2];
  const void* p3 = ptrs[3];
  void* gram_args[] = {&p0, &p1, &p2, &part, &R, &S, &K, &chunk, &col_chunk};
  void* rhs_args[] = {&p0, &p1, &p2, &p3, &part, &R, &S, &K, &chunk, &col_chunk};
  return cudaLaunchKernel(c.kernel, grid, dim3(c.threads), op == OP_GRAM ? gram_args : rhs_args,
                          c.smem, st);
}

// One wrapper call of K1 or K2: the kernel over ceil(S / chunk) chunks of S,
// then, for more than one, sum_chunks_kernel adding the partial sums in
// chunk order into out.
int run_split(int op, const void* const (&ptrs)[4], void* out, void* part, int R, int S, int K,
              int chunk, int col_chunk, int variant, int w_type, cudaStream_t st) {
  if (chunk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (S + chunk - 1) / chunk;
  float* dst = static_cast<float*>(chunks > 1 ? part : out);
  cudaError_t err;
  switch (w_type) {
    case 0: err = run<int8_t>(op, variant, ptrs, dst, R, S, K, chunk, col_chunk, st); break;
    case 1: err = run<float>(op, variant, ptrs, dst, R, S, K, chunk, col_chunk, st); break;
    case 2: err = run<bf16_t>(op, variant, ptrs, dst, R, S, K, chunk, col_chunk, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || chunks == 1) return static_cast<int>(err);
  const size_t n4 = static_cast<size_t>(R) * K / 4;
  const int blocks = static_cast<int>(std::min<size_t>((n4 + 255) / 256, 4096));
  sum_chunks_kernel<<<blocks, 256, 0, st>>>(static_cast<const float4*>(part),
                                            static_cast<float4*>(out), chunks, n4);
  return static_cast<int>(cudaGetLastError());
}

int geometry_of(int op, int K, int op_f32, int w_type, int* geo) {
  switch (w_type) {
    case 0: return static_cast<int>(geometry<int8_t>(op, K, op_f32, geo));
    case 1: return static_cast<int>(geometry<float>(op, K, op_f32, geo));
    case 2: return static_cast<int>(geometry<bf16_t>(op, K, op_f32, geo));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C interface (bound with ctypes).  The caller guarantees R % 64 == 0,
// S % 64 == 0, K % 64 == 0, contiguous row-major tensors on the current
// device, and 16-byte-aligned base pointers.  w_type: 0 an int8 mask, 1 f32
// weights, 2 bf16 weights.  Returns the launch's cudaError_t (0 on success);
// the kernels run asynchronously on `stream`.
//
// K1 and K2 run the configuration `variant` that cmf_gram_geometry /
// cmf_rhs_geometry chose on this device for the operands' type, W type and
// K, and split S into ceil(S / chunk) chunks, chunk a positive multiple of
// that configuration's S tile; with more than one chunk, `part` holds
// chunks x R x K f32 partial sums (scratch), else it is not read.
// col_chunk is the output columns a block owns, as the geometry query gave
// them: 64 for the tiled configurations, wide_col_chunk for the wide ones.
extern "C" int cmf_masked_gram_matvec(const void* Q, const void* Be, const void* W, void* out,
                                      void* part, int R, int S, int K, int chunk, int col_chunk,
                                      int variant, int w_type, void* stream) {
  const void* const ptrs[4] = {Q, Be, W, nullptr};
  return run_split(OP_GRAM, ptrs, out, part, R, S, K, chunk, col_chunk, variant, w_type,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int cmf_masked_rhs(const void* X, const void* W, const void* mb, const void* Be,
                              void* out, void* part, int R, int S, int K, int chunk,
                              int col_chunk, int variant, int w_type, void* stream) {
  const void* const ptrs[4] = {X, W, mb, Be};
  return run_split(OP_RHS, ptrs, out, part, R, S, K, chunk, col_chunk, variant, w_type,
                   static_cast<cudaStream_t>(stream));
}

// K1's (K2's) configuration at width K for these operand and W types on the
// current device (and its shared-memory limit set there): geo =
// {configuration, row tile, S tile, resident blocks an SM, output columns a
// block, shared memory a block in bytes}.
extern "C" int cmf_gram_geometry(int K, int op_f32, int w_type, int* geo) {
  return geometry_of(OP_GRAM, K, op_f32, w_type, geo);
}

extern "C" int cmf_rhs_geometry(int K, int op_f32, int w_type, int* geo) {
  return geometry_of(OP_RHS, K, op_f32, w_type, geo);
}

extern "C" const char* cmf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
