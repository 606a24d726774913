// Fused decoder + softmax cross-entropy on bfloat16 operands: the mean over
// valid rows of logsumexp(h @ W^T + b) - (h @ W^T + b)[label], and its
// gradient, without the (M, V) logits ever reaching device memory.
//
// Replaces the three TPU kernels of tlie_tpu/ops/fused_xent.py where their
// operands are bfloat16 (tlie_tpu/training/scan_loop.py:265-267 casts h, W
// and b to bfloat16 under model.compute_dtype: bfloat16 and train.fused_xent):
//   tlie_fused_xent_fwd_bf16 <- _fwd (pallas_call at :126, body _fwd_kernel :82)
//   tlie_fused_xent_dh_bf16  <- the dh pallas_call at :228 (_bwd_dh_kernel :179)
//   tlie_fused_xent_dw_bf16  <- the dW/db pallas_call at :246 (_bwd_dw_kernel :199)
// They compute what those compute on bfloat16 operands, rounding where they
// round (:23-29, _cast_for_dot :173, _vjp_bwd :290-295):
//   logits:  products of bfloat16 values, exact in float32, summed in
//            float32; the bias widened to float32 and added to them;
//   lse, the picked logit and the loss: float32;
//   t:       (softmax - onehot) * g on valid rows, float32, rounded to
//            bfloat16 before both products;
//   dh = bf16(t) W, dW = h^T bf16(t): summed in float32 and rounded to
//            bfloat16 once, when written;
//   db:      the float32 sum over rows of the unrounded t, rounded once.
//
// Layout, as fused_xent.cu: h (M, D) row-major, W read as the (V, D) rows of
// the nn.Linear weight cast to bfloat16, labels int64 (-100 where ignored),
// dW written as (V, D) rows. loss, lse, gscale are float32.
//
// Bound on the H100: operations. At the LM head's shapes (M 8192, D 512, V
// 50257) the forward is 2*M*D*V = 421.6 GFLOP and each backward kernel
// recomputes the logits and does one more product of that size (843 GFLOP):
// 0.43 and 0.85 ms at 989 TFLOP/s of dense bfloat16. The operands are 8.4 MB
// (h) and 51.5 MB (W): 0.018 ms at 3.35 TB/s.
//
// Tiles: bfloat16 in shared memory in boxes of 64 columns (128 bytes) by
// the tile's rows, 128-byte swizzled (swz, below), landed by the tensor
// memory accelerator or 16-byte cp.async where D % 8 == 0 and h and W are
// 16-byte aligned, else by ordinary loads in the same layout. Products:
// wgmma (sm_90a) reading those boxes by descriptor, or at 32 rows a block
// one mma.sync.aligned.m16n8k16 on bfloat16 fragments read by ldmatrix
// (the float32 kernels take three TF32 m16n8k8s for each depth of 8). The
// logits sum kBK = 64 deep into fresh sums, a box each, added in float32.
//
// Design of the forward (xent_fwd_bf16_kernel<kHRows>, below): a block owns
// kHRows = 128 rows of h (64 where D > 512), resident, and walks its split of
// the vocabulary in tiles of kVT = 32 rows (16) through a ring of three W
// slots, each tile landed once by the tensor memory accelerator two tiles
// ahead of its products; its bias words land with it by cp.async. Both
// warpgroups form logits on wgmma (at 128 rows each its 64 rows by the
// tile's 32 vocabulary rows, m64n32k16; at 64 rows each the same 64 rows by
// 8 of the tile's 16, m64n8k16), a box each, summed in order, then the CUDA
// cores apply the bias, the column mask, the label pick and the running
// (max, sum-exp); a second launch merges the splits in order. Shared memory
// at D 512: 1,024 (alignment) + 131,072 (h) + 98,304 (three slots) + 384
// (bias words) + 32 = 230,816 bytes, one block an SM; the wrapper's splits
// fill one wave (2 at
// the LM shape: 128 blocks, each reading all of W once a split, 3.3 GB of L2
// reads a launch, where 64 rows a block and h copied again each tile read
// 9.7 GB).
//
// Design of dh and dW/db: one walk (bwd_walk_bf16, below), the same for
// both with the roles of h and W swapped. A block owns kRows resident rows
// (dh: 64 rows of h, dW: 64 vocabulary rows of W; 32 where D > 512) and
// streams the other operand once, in tiles of kHQ = kRows rows.
//   accumulator: the block's output rows in registers, never in shared
//            memory: 64 x 512 float32 over 8 warps is 128 floats a lane
//            (warp (band, split) holds its band's 16 rows and one half of
//            the columns; at 32 rows, a quarter of D <= 1024).
//   tiles:   the block's resident rows land once and stay (64 KB at D 512);
//            the streamed tiles go through two slots of 64 KB, tile qt + 1
//            landing by the tensor memory accelerator (zero past the rows and
//            D; an mbarrier a slot) while tile qt is multiplied; each tile
//            lands once and serves both products. Shared memory at D 512: 1,024 (alignment) + 65,536
//            (resident) + 131,072 (two slots) + 16,384 (the softmax
//            exchange) + 1,024 (the tiles' words: dW's labels and lse, dh's
//            bias) + 16 = 215,056 bytes, one block an SM; a third slot does
//            not fit.
//   logits:  at 64 rows a block, each warpgroup (the four bands of a
//            split) forms its 64 x 32 of S on wgmma (m64n32k16, both
//            operands by descriptor from the swizzled boxes), a box (64
//            deep, kBK) a fresh sum added in float32 (with two boxes in
//            flight, the next one's products beside this one's adds, dW/db
//            took longer); at 32 rows each warp on mma.sync.
//   t:       each warp forms p = exp(S + b - lse) of its own streamed rows
//            once, the band's warps exchange p through shared memory
//            (float32), and each forms t = (p - onehot) g for the whole tile
//            in registers, rounds it to bfloat16 and packs it as the A
//            fragments of the second product (the m16n8 accumulator layout
//            is the m16n8k16 A layout): t itself never reaches shared
//            memory; db sums the unrounded t.
//   output:  at 64 rows, each warpgroup adds bf16(t) times the streamed
//            tile into its 64 x 256 of the output on wgmma (m64n64k16, A =
//            t from registers, B = the streamed box read [q][d], MN-major),
//            a box of 64 columns a fresh sum over the tile's kHQ rows added
//            to the registers' accumulator; at 32 rows each warp on mma.sync
//            from ldmatrix.trans.
//   grid:    dh ceil(M / 64) blocks (128 at the LM shape: one wave on 132
//            SMs), dW/db ceil(V / 64) (786: six waves).
//   L2 bytes at the LM shape: dh's 128 blocks each read W once (51.5 MB),
//            6.6 GB a launch (a dh that recomputed the logits from copies
//            and landed W again for its second product read 13.2 GB);
//            dW/db's 786 blocks each read h once (8.39 MB), 6.70 GB.
//
// ptxas: registers and spill bytes of every kernel: chip_smoke.py's build
// phase prints them (nvcc -Xptxas -v, sm_90a) and fails on a spill, and its
// cuobjdump -sass check demands HMMA.16816.F32.BF16 (mma.sync) of the 32-row
// dh and dW/db kernels and a bfloat16 HGMMA (wgmma) of the others.
//
// Columns past V (the ragged last vocabulary tile, 50257 = 1570 * 32 + 17
// in the forward, 785 * 64 + 17 in dh) and rows past M are never read: the
// copies zero-fill them and the statistics and t skip them (the TPU's
// _col_mask and its zeroed W rows, :184). Depth past D reads as zeros. The
// dW/db kernel forms t on vocabulary rows past V from their zero W rows and
// writes neither their dW nor db.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;   // depth of one fresh sum of the logits
constexpr int kChunk = 8; // bfloat16 elements in one 16-byte copy
constexpr int kMergeThreads = 256;
constexpr int64_t kIgnore = -100;
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ int64_t imin(int64_t x, int64_t y) { return x < y ? x : y; }

// Running (max, sum-exp) merge of (m2, s2) into (m, s).
__device__ __forceinline__ void merge_stats(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// 16 bytes from global to shared memory, not through registers; where `in`
// is false nothing is read and the bytes are zeroed.
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits until at most the kN latest of the thread's cp.async groups are in flight.
template <int kN>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kN) : "memory");
}

// Four 8 x 8 matrices of 16-bit elements from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8. Without .trans lane l receives row
// l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of each matrix, one register a
// matrix; with .trans the same of the transposed matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += a · b for one 16 x 8 x 16 fragment (PTX "mma.m16n8k16", .bf16, float32
// accumulators): with g = lane / 4 and t = lane % 4, a holds A(g, 2t..2t+1),
// A(g+8, 2t..2t+1), A(g, 2t+8..2t+9), A(g+8, 2t+8..2t+9); b holds B(2t..2t+1,
// g), B(2t+8..2t+9, g); c = C(g, 2t), C(g, 2t+1), C(g+8, 2t), C(g+8, 2t+1).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// -- the swizzled tiles ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared memory, zero where `in` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(in ? 4 : 0));
}

// Two 8 x 8 matrices; lanes 0-15 give the addresses, as ldmatrix_x4's first two.
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The kernels' tiles in shared memory: boxes of 64 columns (128
// bytes) by the tile's rows, each row's eight 16-byte chunks stored at
// chunk ^ (row % 8) (the 128-byte swizzle the tensor memory accelerator
// writes and wgmma reads; ldmatrix's eight rows of a matrix then fall on
// distinct banks), boxes 1024-byte aligned. Element 8 c of row r of a tile
// of `rows` rows, c counting 16-byte chunks over the whole row:
__device__ __forceinline__ const bf16* swz(const bf16* tile, int rows, int r, int c) {
  return tile + (c >> 3) * rows * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
}

// Lands `rows` rows of m from row r0 (zero past r_lim and past D) into the
// swizzled tile dst of `rows` rows, Dpad columns: 16-byte cp.async where
// `vec` (D % 8 == 0, so a chunk is inside or out; the caller waits for
// them), else ordinary loads, done on return. All the block's threads take
// part.
__device__ __forceinline__ void land_rows_swz(bf16* dst, const bf16* m, int64_t r0, int rows,
                                              int64_t r_lim, int64_t D, int Dpad, bool vec) {
  const int cpr = Dpad / kChunk;  // 16-byte chunks of a row
  if (vec) {
    for (int e = threadIdx.x; e < rows * cpr; e += kThreads) {
      const int r = e / cpr, c = e % cpr;
      const bool in = r0 + r < r_lim && kChunk * c < D;
      cp_async16(const_cast<bf16*>(swz(dst, rows, r, c)), in ? m + (r0 + r) * D + kChunk * c : m,
                 in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * Dpad; e += kThreads) {
      const int r = e / Dpad, c = e % Dpad;
      const_cast<bf16*>(swz(dst, rows, r, c / kChunk))[c % kChunk] =
          r0 + r < r_lim && c < D ? m[(r0 + r) * D + c] : __float2bfloat16_rn(0.f);
    }
  }
}

// -- the tensor memory accelerator and mbarriers (sm_90) ---------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}
// The issuing thread's arrival, announcing `bytes` to land on the barrier.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// One box of the tensor map (columns x.., rows y..) into shared memory,
// completing on `bar`; zero past the tensor's edges.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// -- wgmma (sm_90a) -------------------------------------------------------------

// Makes this thread's writes to shared memory (cp.async landings and
// ordinary stores) visible to the tensor cores' asynchronous reads, before
// a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The descriptor of a K-major bfloat16 operand in swizzled boxes (swz):
// bits 0-13 the start address >> 4, 32-45 the stride between 8-row groups
// (1024 bytes) >> 4, 62-63 the layout (1: 128-byte swizzle; the leading
// offset is unused by it). A 16-deep step starts 32 bytes on in its box.
__device__ __forceinline__ uint64_t sw128_desc(const bf16* p) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         static_cast<uint64_t>(1) << 16 | static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// The descriptor of an MN-major bfloat16 operand in the same boxes, read
// [k][n]: the 64 n of a box contiguous, k rows 128 bytes apart; the
// leading offset steps to the next box of n (`rows` rows on), the stride to
// the next 8 rows of k (1024 bytes).
__device__ __forceinline__ uint64_t sw128_mn_desc(const bf16* p, int rows) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         static_cast<uint64_t>((rows * 128) >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}

// Orders the operands against the asynchronous product: every read or write
// of them stays on its side of the wgmma that follows or the wait that
// precedes, and registers an asynchronous product reads stay live until
// its wait.
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int r = 0; r < kN; ++r) asm volatile("" : "+f"(d[r])::"memory");
}
template <int kN>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[kN][4]) {
#pragma unroll
  for (int k = 0; k < kN; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}

template <int kB, int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kB][kN]) {
#pragma unroll
  for (int k = 0; k < kB; ++k) fence_operands(d[k]);
}

template <typename T>
__device__ __forceinline__ void wgmma_fence(T& d) {
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

template <int kN>
__device__ __forceinline__ void wgmma_commit_wait(float (&d)[kN]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(d);
}

// d (+)= A B^T for the warpgroup's 64 x 32 tile, 16 deep, A (64 x 16) and B
// (32 x 16) K-major in shared memory; d (16 floats a thread) in the m16n8
// accumulator layout of each warp's 16 rows, n8 fragment j in d[4 j..].
// Where `accumulate` is false d is overwritten: a fresh sum.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da, uint64_t db,
                                                bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate ? 1 : 0));
}

// The same for a 64 x 8 tile, B (8 x 16); d 4 floats a thread.
__device__ __forceinline__ void wgmma_m64n8k16(float (&d)[4], uint64_t da, uint64_t db,
                                               bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate ? 1 : 0));
}

// d (+)= A B for the warpgroup's 64 x 64 tile, 16 deep: A (64 x 16) from
// registers, each warp's 16 rows as an m16n8k16 A fragment; B (16 x 64)
// MN-major in shared memory (the transposed form); d as wgmma_m64n32k16's,
// 32 floats a thread.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db, bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate ? 1 : 0));
}

// -- dh and dW/db ------------------------------------------------------------------

// The backward kernels' plan for kRows resident rows a block (64 where D <=
// 512, 32 where D <= 1024): dh keeps rows of h and streams W's, dW/db keeps
// vocabulary rows of W and streams h's. kBands bands of 16 resident rows,
// each split over kSplit warps; a streamed tile of kHQ = kRows rows; warp
// (band, split) forms the logits of its band's 16 resident rows and kQW of
// the tile's rows, and holds the output (dh or dW) of its 16 rows and D /
// kSplit of the (padded) columns.
template <int kRows>
struct BwdPlan {
  static constexpr int kBands = kRows / 16;
  static constexpr int kSplit = kWarps / kBands;
  static constexpr int kHQ = kRows;
  static constexpr int kQW = kHQ / kSplit;  // streamed rows of the logits a warp forms
  static constexpr int kQN = kQW / 8;       // their n8 fragments
  static constexpr int kHN = kHQ / 8;       // n8 fragments of the whole tile
  static constexpr int kMaxD = 512 * (64 / kRows);
  static_assert(kBands * kSplit == kWarps && kQN >= 1 && kHQ % 16 == 0, "the warps tile the block");
};
// output columns a warp holds at most (128 floats a lane), over the n8 fragments of acc
constexpr int kAccCols = 256;
// Pairs of n8 fragments of the output a warp keeps in flight on mma.sync,
// each a fresh sum.
constexpr int kAccGroup = 2;
static_assert(kAccCols / 16 % kAccGroup == 0, "whole groups");
constexpr int kBox = 64;  // columns of a swizzled box (128 bytes)

__host__ __device__ constexpr int64_t bwd_depth(int64_t D) { return (D + kBK - 1) / kBK * kBK; }

// Bytes of the backward kernels' dynamic shared memory: 1024 to align the
// boxes; the block's resident rows and two streamed tiles, Dpad bfloat16 a
// row; the warps' softmax for the exchange, kWarps x kQN x 32 float4; two
// tiles' words of their rows (dW: labels and lse; dh: the bias); two
// mbarriers.
template <int kRows>
__host__ __device__ constexpr int64_t bwd_smem_bytes(int64_t Dpad) {
  using PL = BwdPlan<kRows>;
  return 1024 + (kRows + 2 * PL::kHQ) * Dpad * 2 + kWarps * PL::kQN * 32 * 16 +
         2 * PL::kHQ * 8 + 2 * 8;
}

// The backward kernels' walk, for dh (kDh) or dW/db: grid ceil(R / kRows)
// with R = M for dh and V for dW, dynamic shared memory bwd_smem_bytes(Dpad),
// Dpad = D rounded up to kBK. Block x owns the resident rows [x kRows, (x +
// 1) kRows) (dh: rows of h; dW: vocabulary rows, W's): they land once
// (cp.async) and stay; the other operand's rows (dh: W's, dW: h's) stream
// through two slots in tiles of kHQ rows, tile qt + 1 landing by the tensor
// memory accelerator (`map`, the streamed operand's; one thread issues its
// boxes; an mbarrier a slot says when they are in) while tile qt is
// multiplied, where `tma` (D % 8 == 0, h and W 16-byte aligned), else by
// ordinary loads. Each streamed tile lands once and serves both products.
// Per tile, warp (band, split):
//   the logits S[r][q] = res_r . str_q of its band's 16 resident rows and
//     streamed rows [split kQW, +kQW) of the tile, kBK deep into fresh sums,
//     float32: at 64 rows a block the warpgroup (the four bands of one split)
//     forms its 64 x 32 on wgmma from the swizzled boxes, at 32 rows each
//     warp on mma.sync;
//   p = exp(S + b_v - lse_p) of those, each exp once (0 on rows of h past M
//     or ignored, and on vocabulary rows past V where they stream); the
//     exchange: each warp's p to shared memory, a barrier of the band's
//     kSplit warps, every warp reads the band's 16 x kHQ back in the m16n8
//     accumulator layout;
//   t = (p - onehot) * g, float32 (dW: db summed from it by split 0), rounded
//     to bfloat16 and packed into the A fragments of the second product as it
//     is formed (the m16n8 accumulator layout is the m16n8k16 A layout);
//   out[r][d] += bf16(t) str over the tile's kHQ rows, into fresh sums added
//     to the accumulator in registers (dh: bf16(t) W; dW: bf16(t)^T h), the
//     streamed rows read [q][d] from the same slot the logits read them.
template <int kRows, bool kDh>
__device__ __forceinline__ void bwd_walk_bf16(
    const CUtensorMap* map, const bf16* __restrict__ h, const bf16* __restrict__ w,
    const bf16* __restrict__ b, const int64_t* __restrict__ labels,
    const float* __restrict__ lse, const float* __restrict__ gscale, bf16* __restrict__ out,
    bf16* __restrict__ db, int64_t M, int64_t D, int64_t V, bool tma) {
  using PL = BwdPlan<kRows>;
  constexpr int kHQ = PL::kHQ, kQN = PL::kQN, kHN = PL::kHN;
  // the resident operand and the streamed one, and their rows
  const bf16* __restrict__ res = kDh ? h : w;
  const bf16* __restrict__ str = kDh ? w : h;
  const int64_t n_res = kDh ? M : V, n_str = kDh ? V : M;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int Dpad = static_cast<int>(bwd_depth(D));
  bf16* rs = reinterpret_cast<bf16*>(smem);                      // resident rows, kRows x Dpad, swizzled
  bf16* ss = rs + kRows * Dpad;                                  // streamed, 2 slots of kHQ x Dpad
  float4* xch = reinterpret_cast<float4*>(ss + 2 * kHQ * Dpad);  // [kWarps][kQN][32]
  // a slot's words of its rows: dW the labels' low words and lse, [2][kHQ]
  // each; dh the word of b that holds each row's bias, [2][kHQ]
  int* lab_s = reinterpret_cast<int*>(xch + kWarps * kQN * 32);
  float* lse_s = reinterpret_cast<float*>(lab_s + 2 * kHQ);
  uint32_t* bias_s = reinterpret_cast<uint32_t*>(lab_s);
  uint64_t* bars = reinterpret_cast<uint64_t*>(lse_s + 2 * kHQ);  // a slot's boxes

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int lr = lane % 8, lm = lane / 8;
  const int band = warp % PL::kBands, split = warp / PL::kBands;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  // the warp's output columns: whole boxes at 64 rows a block (wgmma's)
  const int dcols = PL::kSplit == 2 ? (Dpad / 2 + kBox - 1) / kBox * kBox : Dpad / PL::kSplit;
  const int d0 = split * dcols;
  const float g_scale = *gscale;
  const int n_qt = static_cast<int>((n_str + kHQ - 1) / kHQ);
  // dh: where b[0] sits in its 4-byte word (b need not be 4-byte aligned):
  // the bias of streamed row qc (q0 even) is half (b_half + qc) % 2 of its word
  const int b_half = static_cast<int>(reinterpret_cast<uintptr_t>(b) >> 1 & 1);

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
  }
  __syncthreads();

  // starts landing streamed tile qt into slot qt % 2 (its boxes by the tensor
  // memory accelerator, or by ordinary loads), its rows' words by cp.async
  auto issue = [&](int qt) {
    const int sl = qt % 2;
    const int64_t q0 = static_cast<int64_t>(qt) * kHQ;
    bf16* dst = ss + sl * kHQ * Dpad;
    if (!tma) {
      land_rows_swz(dst, str, q0, kHQ, n_str, D, Dpad, false);
    } else if (tid == 0) {
      mbar_expect(&bars[sl], static_cast<uint32_t>(kHQ * Dpad * 2));
      for (int c = 0; c < Dpad / kBox; ++c)
        tma_load(dst + c * kHQ * kBox, map, c * kBox, static_cast<int>(q0), &bars[sl]);
    }
    if (tid < kHQ) {
      const bool in = q0 + tid < n_str;
      if constexpr (kDh) {
        // the aligned 4-byte word that holds b[q0 + tid]
        const uintptr_t word = reinterpret_cast<uintptr_t>(in ? b + q0 + tid : b) & ~uintptr_t{3};
        cp_async4(bias_s + sl * kHQ + tid, reinterpret_cast<const void*>(word), in);
      } else {
        // the low word of each int64 label (V < 2^31; -100 stays -100)
        cp_async4(lab_s + sl * kHQ + tid, in ? labels + q0 + tid : labels, in);
        cp_async4(lse_s + sl * kHQ + tid, in ? lse + q0 + tid : lse, in);
      }
    }
    cp_async_commit();
  };

  // what the thread's resident rows r0 + 16 band + g + 8 hh fix. dW
  // (vocabulary rows): each row's bias and index, which the labels match;
  // rows past V form t from zero W rows, and neither their dW nor db is
  // written. dh (rows of h): each row's lse and label, -100 past M.
  float bias[2], r_lse[2], db_acc[2] = {0.f, 0.f};
  int v32[2], r_lab[2];
  bool r_in[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t r = r0 + 16 * band + g + 8 * hh;
    r_in[hh] = r < n_res;
    if constexpr (kDh) {
      r_lse[hh] = r_in[hh] ? lse[r] : 0.f;
      r_lab[hh] = r_in[hh] ? static_cast<int>(labels[r]) : static_cast<int>(kIgnore);
    } else {
      v32[hh] = static_cast<int>(r);
      bias[hh] = r_in[hh] ? __bfloat162float(b[r]) : 0.f;
    }
  }
  float acc[kAccCols / 8][4];  // the output of the warp's 16 rows and columns d0 + 8 n + ..
#pragma unroll
  for (int n = 0; n < kAccCols / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;

  // its cp.async (where tma) in the same group as tile 0's words
  land_rows_swz(rs, res, r0, kRows, n_res, D, Dpad, tma);
  issue(0);
  for (int qt = 0; qt < n_qt; ++qt) {
    const int sl = qt % 2;
    cp_async_wait_all();
    if (tma) mbar_wait(&bars[sl], (qt / 2) & 1);
    fence_proxy_async();  // the resident rows and ordinary landings, for wgmma's reads
    __syncthreads();  // tile qt is in; every warp is past tile qt - 1 (its slot, the exchange)
    if (qt + 1 < n_qt) issue(qt + 1);
    const bf16* ht = ss + sl * kHQ * Dpad;
    const int64_t q0 = static_cast<int64_t>(qt) * kHQ;
    const int q_rows = static_cast<int>(imin(n_str - q0, kHQ));  // rows of the tile inside

    // the logits of the band's 16 rows and the warp's kQW streamed rows
    float s[kQN][4];
#pragma unroll
    for (int n = 0; n < kQN; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = 0.f;
    if constexpr (PL::kSplit == 2) {
      // warpgroup `split` forms all 64 rows x its 32 streamed rows on wgmma,
      // both operands read from the swizzled boxes by descriptor, a box (kBK
      // deep) a fresh sum
      static_assert(kBK == kBox && PL::kQW % 8 == 0, "a fresh sum a box");
      for (int k0 = 0; k0 < Dpad; k0 += kBK) {
        const bf16* wa = rs + k0 * kRows;
        const bf16* hb = ht + k0 * kHQ + split * PL::kQW * kBox;
        float c[kQN * 4] = {};
        wgmma_fence(c);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_m64n32k16(c, sw128_desc(wa + 16 * kk), sw128_desc(hb + 16 * kk), kk > 0);
        wgmma_commit_wait(c);
#pragma unroll
        for (int n = 0; n < kQN; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[n][r] += c[4 * n + r];
      }
    } else {
      for (int k0 = 0; k0 < Dpad; k0 += kBK) {
        float c[kQN][4];
#pragma unroll
        for (int n = 0; n < kQN; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) c[n][r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const int kc = k0 / 8 + 2 * kk;  // the step's first 16-byte chunk
          uint32_t a[4], r[2];
          ldmatrix_x4(a, swz(rs, kRows, 16 * band + lr + 8 * (lm % 2), kc + lm / 2));
          ldmatrix_x2(r, swz(ht, kHQ, split * PL::kQW + lr, kc + lm % 2));
          mma_bf16(c[0], a, r[0], r[1]);
        }
#pragma unroll
        for (int n = 0; n < kQN; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[n][r] += c[n][r];
      }
    }

    // the softmax p = exp(S + b_v - lse_p) of the warp's own streamed rows,
    // each exp formed once; the exchange: the band's 16 x kHQ of p, every
    // warp of the band all of them
#pragma unroll
    for (int n = 0; n < kQN; ++n) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = split * PL::kQW + 8 * n + 2 * t4 + e;
        if constexpr (kDh) {
          // 0 on vocabulary rows past V and on rows of h past M or ignored
          const uint32_t word = bias_s[sl * kHQ + qc] >> (16 * ((b_half + qc) & 1));
          const float bq = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(word)));
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            pv[2 * hh + e] = qc < q_rows && r_lab[hh] != kIgnore
                                 ? expf(s[n][2 * hh + e] + bq - r_lse[hh])
                                 : 0.f;
        } else {
          // 0 on rows of h past M or ignored
          const float l = lse_s[sl * kHQ + qc];
          const bool q_ok = qc < q_rows && lab_s[sl * kHQ + qc] != kIgnore;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            pv[2 * hh + e] = q_ok ? expf(s[n][2 * hh + e] + bias[hh] - l) : 0.f;
        }
      }
      xch[(warp * kQN + n) * 32 + lane] = make_float4(pv[0], pv[1], pv[2], pv[3]);
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + band), "r"(32 * PL::kSplit) : "memory");

    // t, rounded to bfloat16 into the A fragments of out += bf16(t) str: n8
    // fragment m of the tile (its rows 8 m.., held by split m / kQN) is half
    // m % 2 of the A fragment of depths 16 (m / 2)..
    uint32_t ta[kHQ / 16][4];
#pragma unroll
    for (int m = 0; m < kHN; ++m) {
      const int owner = band + PL::kBands * (m / kQN);
      const float4 f = xch[(owner * kQN + m % kQN) * 32 + lane];
      const float pv[4] = {f.x, f.y, f.z, f.w};
      float t[2][2];  // [row g, g + 8][column pair]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = 8 * m + 2 * t4 + e;
        if constexpr (kDh) {
          // p is 0 past V and on ignored rows, whose label matches no v
          const int v = static_cast<int>(q0) + qc;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            t[hh][e] = (pv[2 * hh + e] - (v == r_lab[hh] ? 1.f : 0.f)) * g_scale;
        } else {
          // p is 0 on rows past M or ignored, where no onehot is subtracted
          const int lab = qc < q_rows ? lab_s[sl * kHQ + qc] : static_cast<int>(kIgnore);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            t[hh][e] = (pv[2 * hh + e] - (v32[hh] == lab ? 1.f : 0.f)) * g_scale;
            if (split == 0) db_acc[hh] += t[hh][e];
          }
        }
      }
      ta[m / 2][2 * (m % 2)] = pack_bf16(t[0][0], t[0][1]);
      ta[m / 2][2 * (m % 2) + 1] = pack_bf16(t[1][0], t[1][1]);
    }

    // out += bf16(t) str over the tile's kHQ rows: fresh sums, added to acc
    if constexpr (PL::kSplit == 2) {
      // warpgroup `split` into its 64 rows x dcols on wgmma, A = t from the
      // warps' registers, B = the streamed box [q][d] read MN-major, a box
      // (64 columns) a fresh sum
#pragma unroll
      for (int j = 0; j < kAccCols / kBox; ++j) {
        if (kBox * j >= dcols || d0 + kBox * j >= Dpad) continue;  // uniform over the warpgroup
        const bf16* hb = ht + (d0 / kBox + j) * kHQ * kBox;
        float c[32] = {};
        wgmma_fence(c);
#pragma unroll
        for (int kk = 0; kk < kHQ / 16; ++kk)
          wgmma_m64n64k16_rs(c, ta[kk], sw128_mn_desc(hb + 16 * kk * kBox, kHQ), kk > 0);
        wgmma_commit_wait(c);
        fence_operands(ta);
#pragma unroll
        for (int n = 0; n < kBox / 8; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[kBox / 8 * j + n][r] += c[4 * n + r];
      }
    } else {
      // each warp into its 16 rows x dcols on mma.sync, kAccGroup pairs of n8
      // fragments at a time
#pragma unroll
      for (int j0 = 0; j0 < kAccCols / 16; j0 += kAccGroup) {
        if (16 * j0 >= dcols) continue;  // uniform over the warp
        float c[2 * kAccGroup][4];
#pragma unroll
        for (int n = 0; n < 2 * kAccGroup; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) c[n][r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kHQ / 16; ++kk) {
#pragma unroll
          for (int u = 0; u < kAccGroup; ++u) {
            if (16 * (j0 + u) >= dcols) continue;
            // B = the tile's [q][d] block, transposed as it is read: matrices
            // (q +0, d +0), (+8, +0), (+0, +8), (+8, +8), two n8 fragments a load
            uint32_t r[4];
            ldmatrix_x4_trans(r, swz(ht, kHQ, 16 * kk + lr + 8 * (lm % 2),
                                     (d0 + 16 * (j0 + u)) / 8 + lm / 2));
            mma_bf16(c[2 * u], ta[kk], r[0], r[1]);
            mma_bf16(c[2 * u + 1], ta[kk], r[2], r[3]);
          }
        }
#pragma unroll
        for (int u = 0; u < 2 * kAccGroup; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[2 * j0 + u][r] += c[u][r];
      }
    }
  }
  cp_async_wait_all();

  // the output rounded to bfloat16 once: dh (M, D), or dW as (V, D) rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t r = r0 + 16 * band + g + 8 * hh;
    if (!r_in[hh]) continue;
    bf16* row = out + r * D;
#pragma unroll
    for (int n = 0; n < kAccCols / 8; ++n) {
      const int col = d0 + 8 * n + 2 * t4;
      if (8 * n >= dcols) continue;
      if (D % 2 == 0 && col + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[n][2 * hh], acc[n][2 * hh + 1]);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < D) row[col + e] = __float2bfloat16_rn(acc[n][2 * hh + e]);
      }
    }
  }
  // db: the four lanes of a quad hold the same rows (split 0 summed every column)
  if constexpr (!kDh) {
    if (split == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = db_acc[hh];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t4 == 0 && r_in[hh]) db[r0 + 16 * band + g + 8 * hh] = __float2bfloat16_rn(v);
      }
    }
  }
}

// dh (M, D): the walk with kPRows rows of h a block, W streamed (`w_map`);
// db unused.
template <int kPRows>
__global__ void __launch_bounds__(kThreads, 1)
xent_dh_bf16_kernel(const __grid_constant__ CUtensorMap w_map, const bf16* __restrict__ h,
                    const bf16* __restrict__ w, const bf16* __restrict__ b,
                    const int64_t* __restrict__ labels, const float* __restrict__ lse,
                    const float* __restrict__ gscale, bf16* __restrict__ dh,
                    bf16* __restrict__ db, int64_t M, int64_t D, int64_t V, bool tma) {
  bwd_walk_bf16<kPRows, true>(&w_map, h, w, b, labels, lse, gscale, dh, db, M, D, V, tma);
}

// dW as (V, D) rows and db: the walk with kVRows vocabulary rows a block, h
// streamed (`h_map`).
template <int kVRows>
__global__ void __launch_bounds__(kThreads, 1)
xent_dw_bf16_kernel(const __grid_constant__ CUtensorMap h_map, const bf16* __restrict__ h,
                    const bf16* __restrict__ w, const bf16* __restrict__ b,
                    const int64_t* __restrict__ labels, const float* __restrict__ lse,
                    const float* __restrict__ gscale, bf16* __restrict__ dw,
                    bf16* __restrict__ db, int64_t M, int64_t D, int64_t V, bool tma) {
  bwd_walk_bf16<kVRows, false>(&h_map, h, w, b, labels, lse, gscale, dw, db, M, D, V, tma);
}

// The tensor map of a row-major matrix of `rows` rows of D bfloat16 (h or
// W) in boxes of kBox columns by `box_rows` rows, 128-byte swizzled, zero
// past its edges, by cuTensorMapEncodeTiled; false where it is missing or
// refuses the map.
bool rows_tensor_map(CUtensorMap* map, const bf16* m, int64_t rows, int64_t D, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {kBox, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(m), dims, strides, box,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dh (kDh) or dW/db with kRows resident rows a block.
template <int kRows, bool kDh>
int launch_bwd_rows(const bf16* h, const bf16* w, const bf16* b, const int64_t* labels,
                    const float* lse, const float* gscale, bf16* out, bf16* db, int64_t M,
                    int64_t D, int64_t V, cudaStream_t s) {
  using PL = BwdPlan<kRows>;
  const int64_t smem = bwd_smem_bytes<kRows>(bwd_depth(D));
  if (bwd_depth(D) > PL::kMaxD || V > INT32_MAX || M > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // boxes by the tensor memory accelerator where rows are whole 16-byte
  // chunks (D % 8 == 0) from 16-byte aligned h and W and the streamed
  // operand holds a whole box of rows; else ordinary loads. The map is the
  // streamed operand's: W's for dh, h's for dW.
  CUtensorMap map{};
  const bool tma = D % kChunk == 0 && (kDh ? V : M) >= PL::kHQ &&
                   (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  if (tma && !rows_tensor_map(&map, kDh ? w : h, kDh ? V : M, D, PL::kHQ))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = kDh ? xent_dh_bf16_kernel<kRows> : xent_dw_bf16_kernel<kRows>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(((kDh ? M : V) + kRows - 1) / kRows));
  kernel<<<grid, kThreads, smem, s>>>(map, h, w, b, labels, lse, gscale, out, db, M, D, V, tma);
  return static_cast<int>(cudaGetLastError());
}

// -- the forward --------------------------------------------------------------------

// The forward's plan for kHRows rows of h a block (128 where D <= 512, 64
// where D <= 1024): the rows resident (128 KB at the largest D of each),
// the vocabulary streamed in tiles of kVT = kHRows / 4 rows (32 KB at the
// largest D) through a ring of kFwdSlots slots. Both warpgroups form logits
// on wgmma from the swizzled boxes: at 128 rows warpgroup j the rows 64 j..
// by the tile's 32 vocabulary rows (m64n32k16), at 64 rows both the same 64
// rows, warpgroup j the tile's vocabulary rows 8 j.. (m64n8k16).
template <int kHRows>
struct FwdPlan {
  static constexpr int kVT = kHRows / 4;              // vocabulary rows of a tile
  static constexpr bool kShare = kHRows == 64;        // both warpgroups on the same rows
  static constexpr int kN = kShare ? kVT / 2 : kVT;   // a warpgroup's vocabulary rows of a tile
  static constexpr int kNF = kN / 8;                  // their n8 fragments
  static constexpr int kMaxD = 512 * 128 / kHRows;
  static constexpr int kBoxes = kMaxD / kBox;         // boxes of a row at most
  static_assert(kNF == 1 || kNF == 4, "m64n8k16 or m64n32k16");
};
constexpr int kFwdSlots = 3;  // W tiles (and their bias words) in flight or in use

// Bytes of the forward's dynamic shared memory: 1024 to align the boxes;
// the block's rows of h and kFwdSlots tiles of W, Dpad bfloat16 a row, and
// their bias words; kFwdSlots + 1 mbarriers (the W slots, h). At D 512:
// 1,024 + 131,072 + 98,304 + 384 + 32 = 230,816 bytes.
template <int kHRows>
__host__ __device__ constexpr int64_t fwd_smem_bytes(int64_t Dpad) {
  using PL = FwdPlan<kHRows>;
  return 1024 + (kHRows + kFwdSlots * PL::kVT) * Dpad * 2 + kFwdSlots * PL::kVT * 4 +
         (kFwdSlots + 1) * 8;
}

// The logits of one W tile for a warpgroup's 64 rows of h (from `ha`, in
// boxes of kHRows rows) and its kN vocabulary rows of the tile (from `wb`,
// in boxes of kVT rows), on wgmma into c: a box (kBK deep) a fresh sum in
// its own accumulators. Committed, not waited for.
template <int kHRows>
__device__ __forceinline__ void fwd_products(
    float (&c)[FwdPlan<kHRows>::kBoxes][FwdPlan<kHRows>::kNF * 4], const bf16* ha,
    const bf16* wb, int n_box) {
  using PL = FwdPlan<kHRows>;
  static_assert(kBK == kBox, "a fresh sum a box");
  wgmma_fence(c);
#pragma unroll
  for (int k = 0; k < PL::kBoxes; ++k) {
    if (k >= n_box) continue;  // uniform over the block
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da = sw128_desc(ha + k * kHRows * kBox + 16 * kk);
      const uint64_t db = sw128_desc(wb + k * PL::kVT * kBox + 16 * kk);
      if constexpr (PL::kNF == 4)
        wgmma_m64n32k16(c[k], da, db, kk > 0);
      else
        wgmma_m64n8k16(c[k], da, db, kk > 0);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits for the products in flight and sums their boxes in order into x.
template <int kHRows>
__device__ __forceinline__ void fwd_logits(
    float (&x)[FwdPlan<kHRows>::kNF * 4],
    float (&c)[FwdPlan<kHRows>::kBoxes][FwdPlan<kHRows>::kNF * 4], int n_box) {
  using PL = FwdPlan<kHRows>;
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(c);
#pragma unroll
  for (int r = 0; r < PL::kNF * 4; ++r) x[r] = 0.f;
#pragma unroll
  for (int k = 0; k < PL::kBoxes; ++k) {
    if (k >= n_box) continue;
#pragma unroll
    for (int r = 0; r < PL::kNF * 4; ++r) x[r] += c[k][r];
  }
}

// Forward, first launch: grid (ceil(M / kHRows), splits). Block (x, y)
// walks vocabulary tiles [y tiles_per_split, (y + 1) tiles_per_split) of
// kVT rows for the rows [x kHRows, (x + 1) kHRows) of h and writes each
// row's partial (max, sum-exp, picked logit) at part[{0, 1, 2} * splits * M
// + y * M + row]; a split past the last tile writes (-1e30, 0, 0). The rows
// of h land once (by the tensor memory accelerator where `tma`, else by
// ordinary loads) and stay; W's tiles land the same way into a ring of
// kFwdSlots slots, each with its bias words by cp.async. Per tile i the
// thread:
//   forms the logits of its warpgroup's rows and vocabulary rows on wgmma,
//     each kBK-deep box a fresh sum in its own accumulators, and sums the
//     boxes in order;
//   applies the bias (widened to float32), the column mask (v < V), the
//     label pick and the running max and sum-exp of its rows, over its own
//     columns;
// then a barrier frees tile i's slot and tile i + kFwdSlots is issued into
// it. At the end the four lanes of a quad merge their statistics, and at 64
// rows the two warpgroups theirs, in order, so the result does not depend
// on scheduling. Two arrangements that overlap the products with the
// statistics were slower on an H100: tile i + 1's products issued before
// tile i's statistics (their 128 accumulator floats a lane live across
// them: 255 registers, 1.96 ms against 1.56 at the LM shape), and the two
// warpgroups taking turns at the tensor cores, each one's statistics beside
// the other's products (1.67 ms against 1.54): the statistics, with one
// block of 8 warps an SM, hold the walk more than the products do.
template <int kHRows>
__global__ void __launch_bounds__(kThreads, 1)
xent_fwd_bf16_kernel(const __grid_constant__ CUtensorMap h_map,
                     const __grid_constant__ CUtensorMap w_map, const bf16* __restrict__ h,
                     const bf16* __restrict__ w, const bf16* __restrict__ b,
                     const int64_t* __restrict__ labels, float* __restrict__ part, int64_t M,
                     int64_t D, int64_t V, int64_t tiles_per_split, bool tma) {
  using PL = FwdPlan<kHRows>;
  constexpr int kVT = PL::kVT, kNF = PL::kNF, kBoxes = PL::kBoxes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int Dpad = static_cast<int>(bwd_depth(D));
  const int n_box = Dpad / kBox;
  bf16* hs = reinterpret_cast<bf16*>(smem);                               // kHRows x Dpad, swizzled
  bf16* ws = hs + kHRows * Dpad;                                          // kFwdSlots x kVT x Dpad
  uint32_t* bias_s = reinterpret_cast<uint32_t*>(ws + kFwdSlots * kVT * Dpad);  // [kFwdSlots][kVT]
  uint64_t* bars = reinterpret_cast<uint64_t*>(bias_s + kFwdSlots * kVT);  // the W slots, then h

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wg = warp / 4;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kHRows;
  const int64_t split = blockIdx.y, splits = gridDim.y;
  const int64_t n_tiles = (V + kVT - 1) / kVT;
  const int64_t tile0 = split * tiles_per_split;
  const int n = static_cast<int>(imin(n_tiles, tile0 + tiles_per_split) - imin(n_tiles, tile0));
  const int v_end = static_cast<int>(V);  // V < 2^31
  // the warpgroup's rows of the block and vocabulary rows of a tile
  const int a_row0 = PL::kShare ? 0 : 64 * wg, b_row0 = PL::kShare ? PL::kN * wg : 0;
  // where b[0] sits in its 4-byte word: the bias of tile row qc (q0 even) is
  // half (b_half + qc) % 2 of the word that holds it
  const int b_half = static_cast<int>(reinterpret_cast<uintptr_t>(b) >> 1 & 1);

  if (tid == 0) {
    for (int k = 0; k <= kFwdSlots; ++k) mbar_init(&bars[k]);
  }
  __syncthreads();

  // starts landing tile i of the split and its bias words into slot i %
  // kFwdSlots; one cp.async group a call, empty past the last tile, so that
  // waiting for all but the kFwdSlots - 1 latest finds the oldest tile's
  auto issue = [&](int i) {
    if (i < n) {
      const int64_t q0 = (tile0 + i) * kVT;
      bf16* dst = ws + i % kFwdSlots * kVT * Dpad;
      if (!tma) {
        land_rows_swz(dst, w, q0, kVT, V, D, Dpad, false);
        fence_proxy_async();
      } else if (tid == 0) {
        uint64_t* bar = &bars[i % kFwdSlots];
        mbar_expect(bar, static_cast<uint32_t>(kVT * Dpad * 2));
        for (int c = 0; c < n_box; ++c)
          tma_load(dst + c * kVT * kBox, &w_map, c * kBox, static_cast<int>(q0), bar);
      }
      if (tid < kVT) {
        const bool in = q0 + tid < V;
        const uintptr_t word = reinterpret_cast<uintptr_t>(in ? b + q0 + tid : b) & ~uintptr_t{3};
        cp_async4(bias_s + i % kFwdSlots * kVT + tid, reinterpret_cast<const void*>(word), in);
      }
    }
    cp_async_commit();
  };

  // the block's rows of h
  if (!tma) {
    land_rows_swz(hs, h, r0, kHRows, M, D, Dpad, false);
    fence_proxy_async();
  } else if (tid == 0) {
    mbar_expect(&bars[kFwdSlots], static_cast<uint32_t>(kHRows * Dpad * 2));
    for (int c = 0; c < n_box; ++c)
      tma_load(hs + c * kHRows * kBox, &h_map, c * kBox, static_cast<int>(r0), &bars[kFwdSlots]);
  }
  for (int i = 0; i < kFwdSlots; ++i) issue(i);

  // the thread's rows a_row0 + 16 (warp % 4) + g + 8 hh: statistics, labels
  float m[2], s[2], pk[2];
  int lab[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t row = r0 + a_row0 + 16 * (warp % 4) + g + 8 * hh;
    m[hh] = kNegBig;
    s[hh] = 0.f;
    pk[hh] = 0.f;
    lab[hh] = row < M ? static_cast<int>(labels[row]) : static_cast<int>(kIgnore);
  }

  float c[kBoxes][kNF * 4];  // a tile's products, a box each
  float x[kNF * 4];          // its logits
  // the warpgroup's rows of h
  const bf16* ha = hs + a_row0 * kBox;

  if (tma) mbar_wait(&bars[kFwdSlots], 0);
  cp_async_wait_group<kFwdSlots - 1>();  // tile 0's bias words
  __syncthreads();  // ... seen by all, and the ordinary landings of h and tile 0
  for (int i = 0; i < n; ++i) {
    if (tma) mbar_wait(&bars[i % kFwdSlots], (i / kFwdSlots) & 1);
    fwd_products<kHRows>(c, ha, ws + i % kFwdSlots * kVT * Dpad + b_row0 * kBox, n_box);
    fwd_logits<kHRows>(x, c, n_box);

    // tile i's statistics over the thread's columns q0 + b_row0 + 8 j + 2 t4 + e
    const int q0 = static_cast<int>((tile0 + i) * kVT);
    const bool inside = q0 + kVT <= v_end;  // no column of the tile past V
    const uint32_t* bw = bias_s + i % kFwdSlots * kVT;
    float bias[kNF][2];
#pragma unroll
    for (int j = 0; j < kNF; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = b_row0 + 8 * j + 2 * t4 + e;
        const uint32_t word = bw[qc] >> (16 * ((b_half + qc) & 1));
        bias[j][e] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(word)));
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float tmax = kNegBig;
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = q0 + b_row0 + 8 * j + 2 * t4 + e;
          float& xv = x[4 * j + 2 * hh + e];
          xv = inside || v < v_end ? xv + bias[j][e] : kNegBig;
          tmax = fmaxf(tmax, xv);
          if (v == lab[hh]) pk[hh] += xv;
        }
      const float mn = fmaxf(m[hh], tmax);
      float add = 0.f;
#pragma unroll
      for (int j = 0; j < kNF; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (inside || q0 + b_row0 + 8 * j + 2 * t4 + e < v_end)
            add += expf(x[4 * j + 2 * hh + e] - mn);
      s[hh] = s[hh] * expf(m[hh] - mn) + add;
      m[hh] = mn;
    }

    cp_async_wait_group<kFwdSlots - 2>();  // tile i + 1's bias words
    __syncthreads();  // ... seen by all; every warp past tile i's slot
    issue(i + kFwdSlots);
  }
  cp_async_wait_all();

  // the four lanes of a quad share their rows; at 64 rows the two
  // warpgroups theirs, through shared memory, warpgroup 0 first
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[hh], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[hh], off);
      const float po = __shfl_xor_sync(0xffffffffu, pk[hh], off);
      merge_stats(m[hh], s[hh], mo, so);
      pk[hh] += po;
    }
  }
  constexpr int kSrc = PL::kShare ? 2 : 1;  // statistics of a row
  float* stats = reinterpret_cast<float*>(ws);  // [3][kSrc][kHRows], the ring is done with
  __syncthreads();
  if (t4 == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = a_row0 + 16 * (warp % 4) + g + 8 * hh;
      const int src = PL::kShare ? wg : 0;
      stats[(0 * kSrc + src) * kHRows + r] = m[hh];
      stats[(1 * kSrc + src) * kHRows + r] = s[hh];
      stats[(2 * kSrc + src) * kHRows + r] = pk[hh];
    }
  }
  __syncthreads();
  for (int r = tid; r < kHRows; r += kThreads) {
    const int64_t row = r0 + r;
    if (row >= M) continue;
    float mm = kNegBig, ss = 0.f, pp = 0.f;
#pragma unroll
    for (int k = 0; k < kSrc; ++k) {
      merge_stats(mm, ss, stats[(0 * kSrc + k) * kHRows + r], stats[(1 * kSrc + k) * kHRows + r]);
      pp += stats[(2 * kSrc + k) * kHRows + r];
    }
    part[(0 * splits + split) * M + row] = mm;
    part[(1 * splits + split) * M + row] = ss;
    part[(2 * splits + split) * M + row] = pp;
  }
}

template <int kHRows>
int launch_fwd_rows(const bf16* h, const bf16* w, const bf16* b, const int64_t* labels,
                    float* part, int64_t M, int64_t D, int64_t V, int64_t splits,
                    cudaStream_t s) {
  using PL = FwdPlan<kHRows>;
  if (bwd_depth(D) > PL::kMaxD || V > INT32_MAX || M > INT32_MAX || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the rows of h and W's tiles by the tensor memory accelerator where rows
  // are whole 16-byte chunks from 16-byte aligned h and W, and each operand
  // holds a whole box of rows; else ordinary loads
  CUtensorMap h_map{}, w_map{};
  const bool tma = D % kChunk == 0 && M >= kHRows && V >= PL::kVT &&
                   (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  if (tma && !(rows_tensor_map(&h_map, h, M, D, kHRows) &&
               rows_tensor_map(&w_map, w, V, D, PL::kVT)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = fwd_smem_bytes<kHRows>(bwd_depth(D));
  cudaError_t err = cudaFuncSetAttribute(
      xent_fwd_bf16_kernel<kHRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = (V + PL::kVT - 1) / PL::kVT;
  const dim3 grid(static_cast<unsigned int>((M + kHRows - 1) / kHRows),
                  static_cast<unsigned int>(splits));
  xent_fwd_bf16_kernel<kHRows><<<grid, kThreads, smem, s>>>(
      h_map, w_map, h, w, b, labels, part, M, D, V, (n_tiles + splits - 1) / splits, tma);
  return static_cast<int>(cudaGetLastError());
}

// Forward, second launch: one thread per row merges the splits in order into
// lse and the row's loss (0 where the label is ignored).
__global__ void xent_fwd_bf16_merge_kernel(const float* __restrict__ part,
                                           const int64_t* __restrict__ labels,
                                           float* __restrict__ loss, float* __restrict__ lse,
                                           int64_t M, int64_t splits) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kMergeThreads + threadIdx.x;
  if (row >= M) return;
  float m = kNegBig, s = 0.f, pk = 0.f;
  for (int64_t y = 0; y < splits; ++y) {
    merge_stats(m, s, part[(0 * splits + y) * M + row], part[(1 * splits + y) * M + row]);
    pk += part[(2 * splits + y) * M + row];
  }
  const float l = m + logf(s);
  lse[row] = l;
  loss[row] = labels[row] != kIgnore ? l - pk : 0.f;
}

}  // namespace

// Row loss and lse of the forward, float32, from bfloat16 h, W and b. `part`
// holds 3 * splits * M floats of scratch; any splits >= 1 (a split past the
// last vocabulary tile writes neutral partials;
// tlie_tpu_torch/ops/fused_xent.py picks them by the kernel's tiles, 128
// rows of h and 32 of W where D <= 512, 64 and 16 above). Two launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tlie_fused_xent_fwd_bf16(const bf16* h, const bf16* w, const bf16* b,
                                        const int64_t* labels, float* loss, float* lse,
                                        float* part, int64_t M, int64_t D, int64_t V,
                                        int64_t splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = bwd_depth(D) <= FwdPlan<128>::kMaxD
                      ? launch_fwd_rows<128>(h, w, b, labels, part, M, D, V, splits, s)
                      : launch_fwd_rows<64>(h, w, b, labels, part, M, D, V, splits, s);
  if (err != 0) return err;
  const dim3 merge_grid(static_cast<unsigned int>((M + kMergeThreads - 1) / kMergeThreads));
  xent_fwd_bf16_merge_kernel<<<merge_grid, kMergeThreads, 0, s>>>(part, labels, loss, lse, M,
                                                                  splits);
  return static_cast<int>(cudaGetLastError());
}

// dh (M, D), bfloat16, for the cotangent *gscale on every valid row's loss.
extern "C" int tlie_fused_xent_dh_bf16(const bf16* h, const bf16* w, const bf16* b,
                                       const int64_t* labels, const float* lse,
                                       const float* gscale, bf16* dh,
                                       int64_t M, int64_t D, int64_t V, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bwd_depth(D) <= BwdPlan<64>::kMaxD
             ? launch_bwd_rows<64, true>(h, w, b, labels, lse, gscale, dh, nullptr, M, D, V, s)
             : launch_bwd_rows<32, true>(h, w, b, labels, lse, gscale, dh, nullptr, M, D, V, s);
}

// dW (V, D) and db (V,), bfloat16, for the cotangent *gscale on every valid
// row's loss.
extern "C" int tlie_fused_xent_dw_bf16(const bf16* h, const bf16* w, const bf16* b,
                                       const int64_t* labels, const float* lse,
                                       const float* gscale, bf16* dw, bf16* db,
                                       int64_t M, int64_t D, int64_t V, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bwd_depth(D) <= BwdPlan<64>::kMaxD
             ? launch_bwd_rows<64, false>(h, w, b, labels, lse, gscale, dw, db, M, D, V, s)
             : launch_bwd_rows<32, false>(h, w, b, labels, lse, gscale, dw, db, M, D, V, s);
}
