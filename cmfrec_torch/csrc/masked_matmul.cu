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
// output columns and walks S in tiles.  With bf16 operands, T*W is formed in
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
// gone.
//
// The first design of the bf16 K1 (gram_bf16_kernel: synchronous 64-wide
// tiles, mma.sync, no split-S) stays in masked_gram.cuh as the base of the
// probes in k1_probes.cu (Body::kFull is that design whole).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libcmfrec_kernels.so masked_matmul.cu

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

// A [rows, K] bf16 row-major block (K * 2 bytes a row) into shared memory as
// wgmma core matrices without swizzle: 8 rows x 16 bytes, 128 contiguous
// bytes each, K / 8 of them along K (128 bytes apart), then the next 8 rows
// (K * 16 bytes on).
template <int NT>
__device__ __forceinline__ void copy_core_async(void* dst, const void* src, int rows, int K) {
  const int per_row = K / 8;
  const int dr = NT / per_row, dc = NT - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  for (; r < rows; r += dr, c += dc) {
    if (c >= per_row) {
      c -= per_row;
      if (++r >= rows) break;
    }
    cp_async16(static_cast<char*>(dst) + (r >> 3) * (K * 16) + c * 128 + (r & 7) * 16,
               static_cast<const char*>(src) + static_cast<size_t>(r) * K * 2 + c * 16);
  }
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
// in shared memory, which stops fitting past K = kTiledMaxK (256).  gram_wide_kernel
// takes any K (a multiple of 64) by walking K in chunks: a block owns 64 rows and a
// chunk of up to 256 output columns (gridDim.y chunks of col_chunk columns, the last
// narrower), and for each 64-wide S tile accumulates its [64 x 64] scores over the
// whole K, 32 at a time from Q and Be chunks staged as f32, then masks and rounds
// them as the tiled kernels do and adds their product with the tile's Be columns of
// its chunk.  Each column chunk recomputes the scores.  A simple kernel, correct at
// any K: true f32 FMA for both operand types (bf16 x bf16 products are exact in
// f32), 256 threads as 16 x 16, thread (ty, tx) owning rows ty + 16i (i < 4), in
// the scores S columns tx + 16j (j < 4), in the output columns 4tx + 64q + e of the
// chunk (q, e < 4).
constexpr int kTiledMaxK = 256;
constexpr int WD_NT = 256;
constexpr int WD_BM = 64;          // rows a block
constexpr int WD_BS = 64;          // S tile
constexpr int WD_BK = 32;          // K chunk of the scores
constexpr int WD_MAXC = 256;       // output columns a block
constexpr int WD_LDK = WD_BK + 4;  // 9 16-byte units a row: 8 rows' float4s on 8 bank groups
constexpr int WD_LDP = WD_BS + 4;

template <typename TO, typename WT>
size_t gram_wide_smem(int) {
  return static_cast<size_t>(2 * WD_BM * WD_LDK + WD_BM * WD_LDP + WD_BS * WD_MAXC) * 4;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const bf16_t* p) { return __bfloat162float(*p); }

template <typename TO, typename WT>
__global__ void __launch_bounds__(WD_NT, 1)
    gram_wide_kernel(const TO* __restrict__ Q, const TO* __restrict__ Be,
                     const WT* __restrict__ W, float* __restrict__ part, int R, int S, int K,
                     int chunk, int col_chunk) {
  constexpr bool kBf16 = std::is_same<TO, bf16_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // [64][WD_LDK]
  float* Bs = Qs + WD_BM * WD_LDK;             // [64][WD_LDK]
  float* Ps = Bs + WD_BS * WD_LDK;             // [64][WD_LDP]
  float* Bo = Ps + WD_BM * WD_LDP;             // [64][WD_MAXC]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t row0 = static_cast<size_t>(blockIdx.x) * WD_BM;
  const int c0 = blockIdx.y * col_chunk;
  const int kc = min(col_chunk, K - c0);
  const Chunk ch(part, R, S, K, chunk);

  float acc[4][16] = {};
  for (int s0 = ch.s_begin; s0 < ch.s_end; s0 += WD_BS) {
    // T[64, 64] = Q Be_tile^T over the whole K, k in order
    float t[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += WD_BK) {
      __syncthreads();  // the last chunk's (and tile's) reads are done
      for (int e = threadIdx.x; e < WD_BM * WD_BK; e += WD_NT) {
        const int r = e / WD_BK, k = e - r * WD_BK;
        Qs[r * WD_LDK + k] = load_f32(Q + (row0 + r) * K + k0 + k);
        Bs[r * WD_LDK + k] = load_f32(Be + static_cast<size_t>(s0 + r) * K + k0 + k);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < WD_BK; k += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * WD_LDK + k);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * WD_LDK + k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) fma4(t[i][j], a[i], b[j]);
      }
    }
    // P = T * W as the tiled kernels form it; the tile's Be columns of the chunk
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, sc = tx + 16 * j;
        const WT w = W[(row0 + r) * S + s0 + sc];
        Ps[r * WD_LDP + sc] = kBf16 ? round_bf16(mask<WT, Body::kFull>(t[i][j], w))
                                    : t[i][j] * to_f32(w);
      }
    for (int e = threadIdx.x; e < WD_BS * kc; e += WD_NT) {
      const int sr = e / kc, c = e - sr * kc;
      Bo[sr * WD_MAXC + c] = load_f32(Be + static_cast<size_t>(s0 + sr) * K + c0 + c);
    }
    __syncthreads();
    // out[64, chunk] += P Bo, s in order
#pragma unroll 4
    for (int sc = 0; sc < WD_BS; ++sc) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * WD_LDP + sc];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (4 * tx + 64 * q >= kc) break;
        const float4 b = *reinterpret_cast<const float4*>(Bo + sc * WD_MAXC + 4 * tx + 64 * q);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * q] = fmaf(p[i], b.x, acc[i][4 * q]);
          acc[i][4 * q + 1] = fmaf(p[i], b.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(p[i], b.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(p[i], b.w, acc[i][4 * q + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (4 * tx + 64 * q >= kc) break;
      *reinterpret_cast<float4*>(ch.out + (row0 + ty + 16 * i) * K + c0 + 4 * tx + 64 * q) =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
    }
}

// ---------------------------------------------------------------- launch
// The kernel configurations of K1 (op 0) and K2 (op 1) for W type WT,
// numbered as the C interface numbers them, bf16 operands first, each in
// the order the geometry query prefers them.  K1: 0-2 bf16 (three 128-wide
// stages, three 64-wide, two 64-wide), 3-4 f32 (8x8 thread tiles, then the
// 8x4 ring for K > 128), and past K = 256 only 5 (bf16) or 6 (f32),
// gram_wide_kernel.  K2: 0-1 bf16 (three 64-wide stages, two), 2 f32, at any
// K (a block owns 64 output columns and reads only those of Be).
constexpr int OP_GRAM = 0, OP_RHS = 1;
constexpr int CONFIGS[2] = {7, 3};
constexpr int GRAM_WIDE = 5;  // K1's first wide configuration (bf16; +1 f32)

// The configurations the geometry query tries, in order: [first, last].
void config_range(int op, int K, bool op_f32, int* first, int* last) {
  if (op == OP_GRAM && K > kTiledMaxK) {
    *first = *last = GRAM_WIDE + (op_f32 ? 1 : 0);
  } else if (op == OP_GRAM) {
    *first = op_f32 ? 3 : 0;
    *last = op_f32 ? 4 : 2;
  } else {
    *first = op_f32 ? 2 : 0;
    *last = op_f32 ? 2 : 1;
  }
}

struct GramConfig {
  const void* kernel;
  int threads, row_tile, s_tile;
  int min_blocks;  // resident blocks an SM it is chosen for (0: the last resort)
  size_t smem;
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
    case 5: return {reinterpret_cast<const void*>(gram_wide_kernel<bf16_t, WT>), WD_NT, WD_BM,
                    WD_BS, 0, gram_wide_smem<bf16_t, WT>(K)};
    default: return {reinterpret_cast<const void*>(gram_wide_kernel<float, WT>), WD_NT, WD_BM,
                     WD_BS, 0, gram_wide_smem<float, WT>(K)};
  }
}

template <typename WT>
GramConfig rhs_config(int variant, int K) {
  switch (variant) {
    case 0: return {reinterpret_cast<const void*>(rhs_bf16_wgmma_kernel<WT, 64, 3>), RING_NT,
                    RING_BM, 64, 2, rhs_bf16_wgmma_smem<WT, 64, 3>(K)};
    case 1: return {reinterpret_cast<const void*>(rhs_bf16_wgmma_kernel<WT, 64, 2>), RING_NT,
                    RING_BM, 64, 0, rhs_bf16_wgmma_smem<WT, 64, 2>(K)};
    default: return {reinterpret_cast<const void*>(rhs_f32_tile8_kernel<WT>), F8_NT, F8_BM,
                     F8_BSS, 0, rhs_f32_tile8_smem<WT>(K)};
  }
}

template <typename WT>
GramConfig config(int op, int variant, int K) {
  return op == OP_GRAM ? gram_config<WT>(variant, K) : rhs_config<WT>(variant, K);
}

// The first configuration of `op` for these operands that fits the current
// device with its min_blocks resident an SM (the last one whatever fits):
// raises its kernel's shared-memory limit there to the device's opt-in
// maximum (the limit is the kernel's, whatever K it runs at), and writes
// geo = {configuration, row tile, S tile, resident blocks an SM}.
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
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;
}

// K1 or K2 into `part` (out itself for one chunk) with configuration
// `variant`, whose shared-memory limit geometry() has set on this device;
// ptrs are the kernel's leading pointers in its order (three for K1).
// col_chunk: the output columns a block owns, BN for the tiled kernels, a
// multiple of BN up to WD_MAXC for gram_wide_kernel.
template <typename WT>
cudaError_t run(int op, int variant, const void* const (&ptrs)[4], float* part, int R, int S,
                int K, int chunk, int col_chunk, cudaStream_t st) {
  if (variant < 0 || variant >= CONFIGS[op]) return cudaErrorInvalidValue;
  const bool wide = op == OP_GRAM && variant >= GRAM_WIDE;
  if (wide ? (col_chunk % BN || col_chunk < BN || col_chunk > WD_MAXC) : col_chunk != BN)
    return cudaErrorInvalidValue;
  const GramConfig c = config<WT>(op, variant, K);
  if (chunk % c.s_tile) return cudaErrorInvalidValue;
  const dim3 grid((R + c.row_tile - 1) / c.row_tile, (K + col_chunk - 1) / col_chunk,
                  (S + chunk - 1) / chunk);
  const void* p0 = ptrs[0];
  const void* p1 = ptrs[1];
  const void* p2 = ptrs[2];
  const void* p3 = ptrs[3];
  void* gram_args[] = {&p0, &p1, &p2, &part, &R, &S, &K, &chunk, &col_chunk};
  void* rhs_args[] = {&p0, &p1, &p2, &p3, &part, &R, &S, &K, &chunk};
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
// chunks x R x K f32 partial sums (scratch), else it is not read.  K1's
// col_chunk is the output columns a block owns: 64 for the tiled
// configurations, a multiple of 64 up to 256 for the wide ones.
extern "C" int cmf_masked_gram_matvec(const void* Q, const void* Be, const void* W, void* out,
                                      void* part, int R, int S, int K, int chunk, int col_chunk,
                                      int variant, int w_type, void* stream) {
  const void* const ptrs[4] = {Q, Be, W, nullptr};
  return run_split(OP_GRAM, ptrs, out, part, R, S, K, chunk, col_chunk, variant, w_type,
                   static_cast<cudaStream_t>(stream));
}

extern "C" int cmf_masked_rhs(const void* X, const void* W, const void* mb, const void* Be,
                              void* out, void* part, int R, int S, int K, int chunk, int variant,
                              int w_type, void* stream) {
  const void* const ptrs[4] = {X, W, mb, Be};
  return run_split(OP_RHS, ptrs, out, part, R, S, K, chunk, BN, variant, w_type,
                   static_cast<cudaStream_t>(stream));
}

// K1's (K2's) configuration at width K for these operand and W types on the
// current device (and its shared-memory limit set there): geo =
// {configuration, row tile, S tile, resident blocks an SM}.
extern "C" int cmf_gram_geometry(int K, int op_f32, int w_type, int* geo) {
  return geometry_of(OP_GRAM, K, op_f32, w_type, geo);
}

extern "C" int cmf_rhs_geometry(int K, int op_f32, int w_type, int* geo) {
  return geometry_of(OP_RHS, K, op_f32, w_type, geo);
}

extern "C" const char* cmf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
