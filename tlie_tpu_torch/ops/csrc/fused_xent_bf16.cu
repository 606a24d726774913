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
// Design of the forward and dh: the float32 kernels' structure
// (fused_xent.cu, which stays as it is), on 2-byte operands:
//   products: one mma.sync.aligned.m16n8k16 on bfloat16 fragments with
//            float32 accumulators for each depth of 16 (the float32 kernels
//            take three TF32 m16n8k8s for each depth of 8).
//   tiles:   bfloat16 in shared memory, landed by 16-byte cp.async (8
//            elements a copy) where D % 8 == 0 and h and W are 16-byte
//            aligned, else by ordinary loads; fragments read by ldmatrix
//            (.trans for the second product's [q][d] block). Row strides of
//            16 bytes past a multiple of 128, so each 8 x 8 matrix an
//            ldmatrix reads hits every bank once.
//   forward: xent_fwd_bf16_kernel<kFwdRows>: 64 rows of h a block, the
//            vocabulary split across blocks (about 32 blocks per SM), the
//            running (max, sum-exp, picked) kept in registers, merged in a
//            fixed order, then a second launch merges the splits in order.
//   dh:      xent_dh_bf16_kernel<kPRows>: kPRows rows of h a block. Per
//            128-row tile of the vocabulary the block recomputes the
//            logits, forms t, writes bf16(t) to shared memory and adds
//            bf16(t) @ W_tile into a (kPRows, D) float32 accumulator in
//            shared memory. One block owns its output: no atomics,
//            deterministic. The logits sum 64 deep (kBK) into fresh
//            accumulators, then a float32 add; the second product sums one
//            tile's 128 rows into fresh accumulators, then adds them to the
//            shared accumulator. kPRows 64 for D <= 512 (accumulator 133 KB,
//            206 KB of shared memory in all), 32 above (D <= 1024: 132 KB,
//            187 KB); the forward 58 KB, two blocks an SM.
//
// Design of dW and db (xent_dw_bf16_kernel<kVRows>, below): a block owns
// kVRows = 64 vocabulary rows (32 where D > 512) and walks all of h once,
// in q-tiles of kHQ = kVRows rows.
//   accumulator: dW of the block's rows in registers, never in shared
//            memory: 64 x 512 float32 over 8 warps is 128 floats a lane
//            (warp (band, split) holds its band's 16 rows and one half of
//            the columns; at 32 rows, a quarter of D <= 1024).
//   tiles:   the block's W rows land once and stay (64 KB at D 512); the
//            q-tiles of h stream through two slots of 64 KB, tile qt + 1
//            landing by the tensor memory accelerator (boxes of 64 columns
//            by kHQ rows, 128-byte swizzled, zero past M and D; an mbarrier
//            a slot) while tile qt is multiplied; each tile lands once and
//            serves both products. Where D % 8 != 0 or a base is not
//            16-byte aligned, tiles land by ordinary loads in the same
//            layout. Shared memory at D 512: 1,024 (alignment) + 65,536 (W)
//            + 131,072 (two slots) + 16,384 (the softmax exchange) + 1,024
//            (labels and lse) + 16 = 215,056 bytes, one block an SM; a third
//            slot does not fit.
//   logits:  at 64 rows a block, each warpgroup (the four bands of a
//            split) forms its 64 x 32 of S = W h^T on wgmma
//            (m64n32k16, both operands by descriptor from the swizzled
//            boxes), a box (64 deep, kBK) a fresh sum added in float32 (with
//            two boxes in flight, the next one's products beside this one's
//            adds, it took longer); at 32 rows each warp on mma.sync.
//   t:       each warp forms p = exp(S + b - lse) of its own q-rows once,
//            the band's warps exchange p through shared memory (float32),
//            and each forms t = (p - onehot) g for the whole tile in
//            registers, rounds it to bfloat16 and packs it as the A
//            fragments of the second product (the m16n8 accumulator layout
//            is the m16n8k16 A layout): t itself never reaches shared
//            memory; db sums the unrounded t.
//   dW:      at 64 rows, each warpgroup adds bf16(t) h into its 64 x 256 of
//            dW on wgmma (m64n64k16, A = t from registers, B = the h box
//            read [q][d], MN-major), a box of 64 columns a fresh sum over
//            the tile's kHQ rows added to the registers' accumulator; at 32
//            rows each warp on mma.sync from ldmatrix.trans.
//   L2 bytes at the LM shape: each of the 786 blocks reads h once (8.39
//            MB), its W rows (65,536) and the labels' low words and lse
//            (65,536): 6.70 GB a launch, where the design it replaced read
//            h twice a block (13.2 GB of h).
//   ptxas:   registers and spill bytes of every kernel: chip_smoke.py's
//            build phase prints them (nvcc -Xptxas -v, sm_90a), and its
//            cuobjdump -sass check demands HMMA.16816.F32.BF16 (mma.sync) of
//            every tensor-core kernel here and accepts HGMMA (wgmma) beside
//            it in the dW/db kernel.
// Columns past V (the ragged last vocabulary tile, 50257 = 392 * 128 + 81)
// and rows past M are never read: the copies zero-fill them and the
// statistics and t skip them (the TPU's _col_mask and its zeroed W rows,
// :184). Depth past D reads as zeros. The dW/db kernel forms t on vocabulary
// rows past V from their zero W rows and writes neither their dW nor db.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 128;   // rows of the streamed operand per tile
constexpr int kBK = 64;   // depth of one shared-memory step of the logits
constexpr int kTD = 128;  // output columns per chunk of the backward's second product
constexpr int kKC = 32;   // depth (rows of q) of one shared-memory step of that product
constexpr int kChunk = 8; // bfloat16 elements in one 16-byte copy
constexpr int kMergeThreads = 256;
constexpr int64_t kIgnore = -100;
constexpr float kNegBig = -1e30f;
// Row strides of the shared tiles, in bfloat16 elements: 16 bytes past a
// multiple of 128, so the eight 16-byte rows of an ldmatrix matrix fall on
// distinct banks.
constexpr int kBKPad = kBK + 8;  // the logits' operands, [row][k] (144 bytes)
constexpr int kTPad = kQ + 8;    // bf16(t), [p][q] (272 bytes)
constexpr int kCPad = kTD + 8;   // a Q block of the second product, [q][d] (272 bytes)
constexpr int kOutPad = 8;       // the float32 accumulator, [p][d] (float2 updates)

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

// A thread's share of 16-byte copies of (kR x kC) blocks of a row-major
// matrix of bfloat16 with rows of D (D % 8 == 0, the matrix 16-byte
// aligned): rows tid / (kC / 8) + it * kRows and columns 8 (tid % (kC / 8))
// + 0..7 of each block, neighbouring threads on neighbouring bytes of a row.
// Made where the block's first row r0 is fixed, so that a step only moves
// the block.
template <int kR, int kC, int kLd>
struct Copy16 {
  static constexpr int kTPR = kC / kChunk, kRows = kThreads / kTPR;
  static_assert(kR % kRows == 0 && kLd % kChunk == 0, "whole 16-byte copies");
  const bf16* m;    // the matrix
  const bf16* src;  // the thread's first element of the block at (r0, 0)
  int rows, cols;   // rows from it on, and columns from it on, inside the matrix
  int dst;          // its offset in a shared block
  int block_rows;   // rows from r0 on inside the matrix, the same for all threads

  __device__ __forceinline__ Copy16(const bf16* m_, int64_t r0, int64_t r_lim, int64_t D) {
    const int r = threadIdx.x / kTPR, c = kChunk * (threadIdx.x % kTPR);
    m = m_;
    src = m_ + (r0 + r) * D + c;
    rows = static_cast<int>(r_lim - r0 - r);
    cols = static_cast<int>(D - c);
    dst = r * kLd + c;
    block_rows = static_cast<int>(r_lim - r0);
  }

  // Starts copying the block at rows r0 + dr.., columns dc.. into `block`,
  // zero past the matrix. A zero-filled copy is handed m itself as its
  // source, so that no copy gets an address outside the matrix; the test is
  // made once for the whole block, and a block inside the matrix copies
  // without it.
  __device__ __forceinline__ void start(bf16* block, int dr, int64_t dc, int64_t D) const {
    if (dr + kR <= block_rows && dc + kC <= D) {
#pragma unroll
      for (int it = 0; it < kR / kRows; ++it)
        cp_async16(block + dst + it * kRows * kLd, src + (dr + it * kRows) * D + dc, true);
    } else {
#pragma unroll
      for (int it = 0; it < kR / kRows; ++it) {
        const int rr = dr + it * kRows;
        const bool in = rr < rows && dc < cols;
        cp_async16(block + dst + it * kRows * kLd, in ? src + rr * D + dc : m, in);
      }
    }
  }
};

// The same block by ordinary loads and stores, for any D and alignment:
// rows r0.. (below r_lim) and columns c0.. (below D), zero past the matrix.
template <int kR, int kC, int kLd>
__device__ __forceinline__ void copy_block_scalar(bf16* block, const bf16* __restrict__ m,
                                                  int64_t r0, int64_t r_lim, int64_t c0,
                                                  int64_t D) {
  static_assert(kR * kC % kThreads == 0, "whole copies");
  for (int it = 0; it < kR * kC / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / kC, c = e % kC;
    const int64_t row = r0 + r, col = c0 + c;
    block[r * kLd + c] = row < r_lim && col < D ? m[row * D + col] : __float2bfloat16_rn(0.f);
  }
}

// The warps' tiling of a (kPRows x 128) tile: kWM warps along P by kWN along
// the columns, each holding 32 x (8 kNT) as 2 x kNT fragments of 16 x 8.
template <int kPRows>
struct Tiling {
  static constexpr int kWM = kPRows / 32;
  static constexpr int kWN = kWarps / kWM;
  static constexpr int kNT = kQ / (8 * kWN);
  static_assert(kWM * kWN == kWarps && kNT * 8 * kWN == kQ && kNT % 2 == 0,
                "8 warps tile kPRows x 128, column fragments in pairs");
};

// s = P[p0, p0 + kPRows) · Q[q0, q0 + kQ)ᵀ over depth D for the calling
// thread's fragment elements (Tiling, C layout of mma_bf16). Rows past
// p_rows / q_rows and depth past D read as 0. Each kBK-deep step is summed
// on the tensor cores into fresh accumulators and then added to s in
// float32. The steps' operands are copied into the two halves of buf in
// turn, the next while the tensor cores work on this one. Needs all threads
// past their last use of buf on entry; on return some may still read it.
template <int kPRows>
__device__ __forceinline__ void logits_tile_bf16(
    const bf16* __restrict__ Pm, int64_t p0, int64_t p_rows,
    const bf16* __restrict__ Qm, int64_t q0, int64_t q_rows, int64_t D, bool vec,
    bf16* buf, float (&s)[2][Tiling<kPRows>::kNT][4]) {
  using TL = Tiling<kPRows>;
  constexpr int kNT = TL::kNT;
  constexpr int kStage = (kPRows + kQ) * kBKPad;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lr = lane % 8, lm = lane / 8;  // the lane's row and matrix in an ldmatrix
  const int m0 = 32 * (warp / TL::kWN), n0 = 8 * kNT * (warp % TL::kWN);
  const Copy16<kPRows, kBK, kBKPad> p_copy(Pm, p0, p_rows, D);
  const Copy16<kQ, kBK, kBKPad> q_copy(Qm, q0, q_rows, D);
  auto start = [&](int64_t k0, bf16* st) {
    if (vec) {
      p_copy.start(st, 0, k0, D);
      q_copy.start(st + kPRows * kBKPad, 0, k0, D);
    } else {
      copy_block_scalar<kPRows, kBK, kBKPad>(st, Pm, p0, p_rows, k0, D);
      copy_block_scalar<kQ, kBK, kBKPad>(st + kPRows * kBKPad, Qm, q0, q_rows, k0, D);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[i][j][r] = 0.f;

  const int n_steps = static_cast<int>((D + kBK - 1) / kBK);
  start(0, buf);
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait_all();
    __syncthreads();  // this step's operands are in; the other half is free
    if (step + 1 < n_steps)
      start(static_cast<int64_t>(step + 1) * kBK, buf + (step + 1) % 2 * kStage);
    const bf16* Ps = buf + step % 2 * kStage;
    const bf16* Qs = Ps + kPRows * kBKPad;
    float c[2][kNT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) c[i][j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // A: rows m0 + 16 i.., matrices (rows +0, k +0), (+8, +0), (+0, +8), (+8, +8)
      uint32_t a[2][4], bq[kNT][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], Ps + (m0 + 16 * i + lr + 8 * (lm % 2)) * kBKPad + kk + 8 * (lm / 2));
      // B = Q rows [n][k]: matrices (n +0, k +0), (+0, +8), (+8, +0), (+8, +8),
      // two column fragments a load
#pragma unroll
      for (int jj = 0; jj < kNT / 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4(r, Qs + (n0 + 16 * jj + lr + 8 * (lm / 2)) * kBKPad + kk + 8 * (lm % 2));
        bq[2 * jj][0] = r[0];
        bq[2 * jj][1] = r[1];
        bq[2 * jj + 1][0] = r[2];
        bq[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_bf16(c[i][j], a[i], bq[j][0], bq[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[i][j][r] += c[i][j][r];
  }
}

// Forward: rows of h per block (P = rows of h, Q = vocabulary), as the
// float32 forward's (fused_xent.cu), so that both split the vocabulary alike
// (tlie_tpu_torch/ops/fused_xent.py, forward_splits).
constexpr int kFwdRows = 64;

// Bytes of the forward's dynamic shared memory: the two-step operand buffer
// of the logits and the (max, sum-exp, picked) triples of the kWN warps of a
// row band, [3][kWN][kPRows] floats.
template <int kPRows>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return 2 * (kPRows + kQ) * kBKPad * 2 + 3 * Tiling<kPRows>::kWN * kPRows * 4;
}

// Forward, first launch: grid (ceil(M / kPRows), splits). Block (x, y) walks
// vocabulary tiles [y * tiles_per_split, (y + 1) * tiles_per_split) for rows
// [x * kPRows, (x + 1) * kPRows) and writes each row's partial (max, sum-exp,
// picked logit) at part[{0, 1, 2} * splits * M + y * M + row]. The bias (widened
// to float32), the column mask (v < V), the label pick and the running max and
// sum-exp are applied to the logits in registers, each thread keeping the
// statistics of its own columns of its four rows; at the end the four lanes
// of a quad merge theirs, then the kWN warps of a row band merge in order
// through shared memory, so the result does not depend on scheduling.
template <int kPRows>
__global__ void __launch_bounds__(kThreads, 2)
xent_fwd_bf16_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                     const bf16* __restrict__ b, const int64_t* __restrict__ labels,
                     float* __restrict__ part, int64_t M, int64_t D, int64_t V,
                     int64_t tiles_per_split) {
  using TL = Tiling<kPRows>;
  constexpr int kNT = TL::kNT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* buf = reinterpret_cast<bf16*>(smem);                             // the logits' operands
  float* stats = reinterpret_cast<float*>(buf + 2 * (kPRows + kQ) * kBKPad);  // [3][kWN][kPRows]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wn = warp % TL::kWN;
  const int m0 = 32 * (warp / TL::kWN), n0 = 8 * kNT * wn;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPRows;
  const int64_t split = blockIdx.y, splits = gridDim.y;
  const int64_t n_tiles = (V + kQ - 1) / kQ;
  const int64_t tile0 = split * tiles_per_split;
  const int64_t tile1 = imin(n_tiles, tile0 + tiles_per_split);
  const bool vec = D % kChunk == 0 &&
                   (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;

  // the thread's rows m0 + 16 i + 8 hh + g
  float m[2][2], s[2][2], pk[2][2];
  int64_t lab[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t row = p0 + m0 + 16 * i + 8 * hh + g;
      m[i][hh] = kNegBig;
      s[i][hh] = 0.f;
      pk[i][hh] = 0.f;
      lab[i][hh] = row < M ? labels[row] : kIgnore;
    }

  for (int64_t tile = tile0; tile < tile1; ++tile) {
    const int64_t q0 = tile * kQ;
    float x[2][kNT][4];
    logits_tile_bf16<kPRows>(h, p0, M, w, q0, V, D, vec, buf, x);
    // the thread's columns q0 + n0 + 8 j + 2 t4 + e
    float bias[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t v = q0 + n0 + 8 * j + 2 * t4 + e;
        bias[j][e] = v < V ? __bfloat162float(b[v]) : 0.f;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float tmax = kNegBig;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t v = q0 + n0 + 8 * j + 2 * t4 + e;
            float& xv = x[i][j][2 * hh + e];
            xv = v < V ? xv + bias[j][e] : kNegBig;
            tmax = fmaxf(tmax, xv);
            if (v == lab[i][hh]) pk[i][hh] += xv;
          }
        const float mn = fmaxf(m[i][hh], tmax);
        float add = 0.f;
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (q0 + n0 + 8 * j + 2 * t4 + e < V) add += expf(x[i][j][2 * hh + e] - mn);
        s[i][hh] = s[i][hh] * expf(m[i][hh] - mn) + add;
        m[i][hh] = mn;
      }
    __syncthreads();  // every thread is past the logits' last read of buf
  }

  // the four lanes of a quad share their rows; then the kWN warps of a row
  // band, in order
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[i][hh], off);
        const float so = __shfl_xor_sync(0xffffffffu, s[i][hh], off);
        const float po = __shfl_xor_sync(0xffffffffu, pk[i][hh], off);
        merge_stats(m[i][hh], s[i][hh], mo, so);
        pk[i][hh] += po;
      }
      if (t4 == 0) {
        const int r = m0 + 16 * i + 8 * hh + g;
        stats[(0 * TL::kWN + wn) * kPRows + r] = m[i][hh];
        stats[(1 * TL::kWN + wn) * kPRows + r] = s[i][hh];
        stats[(2 * TL::kWN + wn) * kPRows + r] = pk[i][hh];
      }
    }
  __syncthreads();
  for (int r = tid; r < kPRows; r += kThreads) {
    const int64_t row = p0 + r;
    if (row >= M) continue;
    float mm = kNegBig, ss = 0.f, pp = 0.f;
#pragma unroll
    for (int k = 0; k < TL::kWN; ++k) {
      merge_stats(mm, ss, stats[(0 * TL::kWN + k) * kPRows + r],
                  stats[(1 * TL::kWN + k) * kPRows + r]);
      pp += stats[(2 * TL::kWN + k) * kPRows + r];
    }
    part[(0 * splits + split) * M + row] = mm;
    part[(1 * splits + split) * M + row] = ss;
    part[(2 * splits + split) * M + row] = pp;
  }
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

// bfloat16 elements of the two-step operand buffer: two steps of the logits'
// operands or two Q blocks of the second product, whichever is larger.
__host__ __device__ constexpr int bwd_buf_elems(int kPRows) {
  return 2 * ((kPRows + kQ) * kBKPad > kKC * kCPad ? (kPRows + kQ) * kBKPad : kKC * kCPad);
}

// dh: grid ceil(M / kPRows), dynamic shared memory dh_smem_bytes (Dpad = D
// rounded up to kTD); P = the rows of h, Q = the vocabulary (W's rows).
// gscale points at g / n_valid.
template <int kPRows>
__global__ void __launch_bounds__(kThreads, 1)
xent_dh_bf16_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                    const bf16* __restrict__ b, const int64_t* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ gscale,
                    bf16* __restrict__ out, int64_t M, int64_t D, int64_t V, int64_t Dpad) {
  using TL = Tiling<kPRows>;
  constexpr int kNT = TL::kNT;
  constexpr int kCStage = kKC * kCPad;
  const int64_t ostride = Dpad + kOutPad;
  extern __shared__ __align__(16) unsigned char smem[];
  float* out_s = reinterpret_cast<float*>(smem);                  // [kPRows][ostride]
  bf16* buf = reinterpret_cast<bf16*>(out_s + kPRows * ostride);  // one product's operands
  bf16* Ts = buf + bwd_buf_elems(kPRows);                         // bf16(t), [kPRows][kTPad]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int lr = lane % 8, lm = lane / 8;
  const int m0 = 32 * (warp / TL::kWN), n0 = 8 * kNT * (warp % TL::kWN);
  const bf16* __restrict__ Pm = h;
  const bf16* __restrict__ Qm = w;
  const int64_t p_rows = M;
  const int64_t q_rows = V;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPRows;
  const float g_scale = *gscale;
  const bool vec = D % kChunk == 0 &&
                   (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;

  for (int64_t e = tid; e < kPRows * ostride; e += kThreads) out_s[e] = 0.f;

  // what the P side fixes for the thread's fragment rows m0 + 16 i + 8 hh + g:
  // a row of h, its lse and label
  float p_lse[2][2];
  int64_t p_lab[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t p = p0 + m0 + 16 * i + 8 * hh + g;
      const bool in = p < p_rows;
      p_lse[i][hh] = in ? lse[p] : 0.f;
      p_lab[i][hh] = in ? labels[p] : kIgnore;
    }

  const int n_dc = static_cast<int>(Dpad / kTD);  // column chunks of the second product
  for (int64_t q0 = 0; q0 < q_rows; q0 += kQ) {
    float s[2][kNT][4];
    logits_tile_bf16<kPRows>(Pm, p0, p_rows, Qm, q0, q_rows, D, vec, buf, s);

    // t = (exp(logit - lse) - onehot) * g on valid rows, 0 elsewhere, in
    // float32, rounded to bfloat16 into Ts[p][q], the two neighbouring
    // columns of a fragment as one bfloat16 pair
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int qc = n0 + 8 * j + 2 * t4;
      bool q_in[2];
      float q_bias[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t q = q0 + qc + e;
        q_in[e] = q < q_rows;
        q_bias[e] = q_in[e] ? __bfloat162float(b[q]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pc = m0 + 16 * i + 8 * hh + g;
          const int64_t p = p0 + pc;
          float t[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t v = q0 + qc + e;
            const int64_t lab = p_lab[i][hh];
            const float l = p_lse[i][hh];
            const float bias = q_bias[e];
            t[e] = 0.f;
            if (q_in[e] && p < p_rows && lab != kIgnore) {
              t[e] = (expf(s[i][j][2 * hh + e] + bias - l) - (v == lab ? 1.f : 0.f)) * g_scale;
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(&Ts[pc * kTPad + qc]) =
              __floats2bfloat162_rn(t[0], t[1]);
        }
    }

    __syncthreads();  // t is in; every thread is past the logits' last read of buf

    // out[p][:] += sum over the tile's q of bf16(t)[p][q] * Q[q][:], by column
    // chunks of kTD, each summed over the tile's kQ rows (kKC at a time) on
    // the tensor cores and then added to out_s in float32; the Q blocks are
    // copied into the two halves of buf in turn, as in logits_tile_bf16
    constexpr int kSteps = kQ / kKC;
    const Copy16<kKC, kTD, kCPad> c_copy(Qm, q0, q_rows, D);
    auto start = [&](int step, bf16* st) {
      const int kc = step % kSteps * kKC;
      const int64_t d0 = static_cast<int64_t>(step / kSteps) * kTD;
      if (vec)
        c_copy.start(st, kc, d0, D);
      else
        copy_block_scalar<kKC, kTD, kCPad>(st, Qm, q0 + kc, q_rows, d0, D);
      cp_async_commit();
    };
    const int n_steps = n_dc * kSteps;
    start(0, buf);
    float acc[2][kNT][4];
    for (int step = 0; step < n_steps; ++step) {
      cp_async_wait_all();
      __syncthreads();
      if (step + 1 < n_steps) start(step + 1, buf + (step + 1) % 2 * kCStage);
      const bf16* Cs = buf + step % 2 * kCStage;
      const int kc = step % kSteps * kKC;
      if (kc == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 16) {
        uint32_t a[2][4], bq[kNT][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(a[i], Ts + (m0 + 16 * i + lr + 8 * (lm % 2)) * kTPad + kc + kk + 8 * (lm / 2));
        // B = the Q block [q][d], transposed as it is read: matrices (q +0,
        // d +0), (+8, +0), (+0, +8), (+8, +8), two column fragments a load
#pragma unroll
        for (int jj = 0; jj < kNT / 2; ++jj) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, Cs + (kk + lr + 8 * (lm % 2)) * kCPad + n0 + 16 * jj + 8 * (lm / 2));
          bq[2 * jj][0] = r[0];
          bq[2 * jj][1] = r[1];
          bq[2 * jj + 1][0] = r[2];
          bq[2 * jj + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j) mma_bf16(acc[i][j], a[i], bq[j][0], bq[j][1]);
      }
      if (kc + kKC == kQ) {
        // each thread owns these elements of out_s: no race
        const int64_t d0 = static_cast<int64_t>(step / kSteps) * kTD;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int j = 0; j < kNT; ++j) {
              float2* o = reinterpret_cast<float2*>(
                  &out_s[(m0 + 16 * i + 8 * hh + g) * ostride + d0 + n0 + 8 * j + 2 * t4]);
              float2 x = *o;
              x.x += acc[i][j][2 * hh];
              x.y += acc[i][j][2 * hh + 1];
              *o = x;
            }
      }
    }
    __syncthreads();  // every thread is past its last read of buf and Ts
  }

  // the float32 sums rounded to bfloat16 once
  for (int64_t e = tid; e < kPRows * D; e += kThreads) {
    const int64_t r = e / D, d = e % D;
    if (p0 + r < p_rows) out[(p0 + r) * D + d] = __float2bfloat16_rn(out_s[r * ostride + d]);
  }
}

int64_t padded_depth(int64_t D) { return (D + kTD - 1) / kTD * kTD; }

// Bytes of dh's dynamic shared memory: the (kPRows, Dpad) float32
// accumulator (rows padded by kOutPad), the two-step bfloat16 operand buffer
// of either product, and bf16(t).
int64_t dh_smem_bytes(int kPRows, int64_t Dpad) {
  return kPRows * (Dpad + kOutPad) * 4 + (bwd_buf_elems(kPRows) + kPRows * kTPad) * 2;
}

template <int kPRows>
int launch_dh_rows(const bf16* h, const bf16* w, const bf16* b, const int64_t* labels,
                   const float* lse, const float* gscale, bf16* dh, int64_t M, int64_t D,
                   int64_t V, cudaStream_t s) {
  const int64_t Dpad = padded_depth(D);
  const size_t smem = static_cast<size_t>(dh_smem_bytes(kPRows, Dpad));
  cudaError_t err = cudaFuncSetAttribute(
      xent_dh_bf16_kernel<kPRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((M + kPRows - 1) / kPRows));
  xent_dh_bf16_kernel<kPRows><<<grid, kThreads, smem, s>>>(h, w, b, labels, lse, gscale, dh, M,
                                                           D, V, Dpad);
  return static_cast<int>(cudaGetLastError());
}

// -- dW and db ----------------------------------------------------------------------

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

// The dW/db kernel's tiles in shared memory: boxes of 64 columns (128
// bytes) by the tile's rows, each row's eight 16-byte chunks stored at
// chunk ^ (row % 8) (the 128-byte swizzle the tensor memory accelerator
// writes and wgmma reads; ldmatrix's eight rows of a matrix then fall on
// distinct banks), boxes 1024-byte aligned. Element 8 c of row r of a tile
// of `rows` rows, c counting 16-byte chunks over the whole row:
__device__ __forceinline__ const bf16* swz(const bf16* tile, int rows, int r, int c) {
  return tile + (c >> 3) * rows * 64 + r * 64 + (((c & 7) ^ (r & 7)) << 3);
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

template <int kN>
__device__ __forceinline__ void wgmma_fence(float (&d)[kN]) {
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

// The dW/db kernel's plan for kVRows vocabulary rows a block (64 where D <=
// 512, 32 where D <= 1024): kBands bands of 16 rows, each split over
// kSplit warps; a q-tile of kHQ = kVRows rows of h; warp (band, split) forms
// the logits of its band's 16 rows and kQW of the q-tile's rows, and holds
// dW of its 16 rows and D / kSplit of the (padded) columns.
template <int kVRows>
struct DwPlan {
  static constexpr int kBands = kVRows / 16;
  static constexpr int kSplit = kWarps / kBands;
  static constexpr int kHQ = kVRows;
  static constexpr int kQW = kHQ / kSplit;  // q-rows of the logits a warp forms
  static constexpr int kQN = kQW / 8;       // their n8 fragments
  static constexpr int kHN = kHQ / 8;       // n8 fragments of the whole q-tile
  static constexpr int kMaxD = 512 * (64 / kVRows);
  static_assert(kBands * kSplit == kWarps && kQN >= 1 && kHQ % 16 == 0, "the warps tile the block");
};
// dW columns a warp holds at most (128 floats a lane), over the n8 fragments of acc
constexpr int kDwCols = 256;
// Pairs of n8 fragments of dW a warp keeps in flight, each a fresh sum.
constexpr int kDwGroup = 2;
static_assert(kDwCols / 16 % kDwGroup == 0, "whole groups");
constexpr int kBox = 64;  // columns of a swizzled box (128 bytes)

__host__ __device__ constexpr int64_t dw_depth(int64_t D) { return (D + kBK - 1) / kBK * kBK; }

// Bytes of the dW/db kernel's dynamic shared memory: 1024 to align the
// boxes; the block's W rows and two q-tiles of h, Dpad bfloat16 a row; the
// warps' softmax for the exchange, kWarps x kQN x 32 float4; two q-tiles'
// labels and lse; two mbarriers.
template <int kVRows>
__host__ __device__ constexpr int64_t dw_smem_bytes(int64_t Dpad) {
  using PL = DwPlan<kVRows>;
  return 1024 + (kVRows + 2 * PL::kHQ) * Dpad * 2 + kWarps * PL::kQN * 32 * 16 +
         2 * PL::kHQ * 8 + 2 * 8;
}

// grid ceil(V / kVRows), dynamic shared memory dw_smem_bytes(Dpad), Dpad =
// D rounded up to kBK. Block x owns vocabulary rows [x kVRows, (x + 1)
// kVRows): their W rows land once (cp.async) and stay; the q-tiles of h
// stream through two slots, tile qt + 1 landing by the tensor memory
// accelerator (one thread issues its boxes; an mbarrier a slot says when
// they are in) while tile qt is multiplied, where `tma` (D % 8 == 0, h
// 16-byte aligned), else by ordinary loads. Per q-tile, warp (band, split):
//   the logits S[v][q] = W_v . h_q of its band's 16 v and q-rows [split
//     kQW, +kQW) of the tile, kBK deep into fresh sums, float32: at 64 rows
//     a block the warpgroup (the four bands of one split) forms its 64 x 32
//     on wgmma from the swizzled W and h boxes, at 32 rows each warp on
//     mma.sync;
//   p = exp(S + b_v - lse_q) of those, each exp once (0 on rows past M or
//     ignored); the exchange: each warp's p to shared memory, a barrier of
//     the band's kSplit warps, every warp reads the band's 16 x kHQ back in
//     the m16n8 accumulator layout;
//   t = (p - onehot) * g, float32 (db summed from it by split 0), rounded to
//     bfloat16 and packed into the A fragments of the second product as it
//     is formed (the m16n8 accumulator layout is the m16n8k16 A layout);
//   dW[v][d] += bf16(t) h over the tile's kHQ rows on mma.sync, into fresh
//     sums added to the accumulator in registers, h read [q][d] by
//     ldmatrix.trans from the same slot the logits read [q][d].
template <int kVRows>
__global__ void __launch_bounds__(kThreads, 1)
xent_dw_bf16_kernel(const __grid_constant__ CUtensorMap h_map, const bf16* __restrict__ h,
                    const bf16* __restrict__ w, const bf16* __restrict__ b,
                    const int64_t* __restrict__ labels, const float* __restrict__ lse,
                    const float* __restrict__ gscale, bf16* __restrict__ dw,
                    bf16* __restrict__ db, int64_t M, int64_t D, int64_t V, bool tma) {
  using PL = DwPlan<kVRows>;
  constexpr int kHQ = PL::kHQ, kQN = PL::kQN, kHN = PL::kHN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  const int Dpad = static_cast<int>(dw_depth(D));
  bf16* ws = reinterpret_cast<bf16*>(smem);                    // W rows, kVRows x Dpad, swizzled
  bf16* hs = ws + kVRows * Dpad;                               // h, 2 slots of kHQ x Dpad
  float4* xch = reinterpret_cast<float4*>(hs + 2 * kHQ * Dpad);  // [kWarps][kQN][32]
  int* lab_s = reinterpret_cast<int*>(xch + kWarps * kQN * 32);  // [2][kHQ], the low words
  float* lse_s = reinterpret_cast<float*>(lab_s + 2 * kHQ);       // [2][kHQ]
  uint64_t* bars = reinterpret_cast<uint64_t*>(lse_s + 2 * kHQ);  // a slot's boxes of h

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int lr = lane % 8, lm = lane / 8;
  const int band = warp % PL::kBands, split = warp / PL::kBands;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kVRows;
  // the warp's dW columns: whole boxes at 64 rows a block (wgmma's)
  const int dcols = PL::kSplit == 2 ? (Dpad / 2 + kBox - 1) / kBox * kBox : Dpad / PL::kSplit;
  const int d0 = split * dcols;
  const float g_scale = *gscale;
  const int n_qt = static_cast<int>((M + kHQ - 1) / kHQ);
  const int cpr = Dpad / kChunk;  // 16-byte chunks of a row

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
  }
  __syncthreads();

  // Lands `rows` rows of m from row r0 (zero past r_lim and past D) into the
  // swizzled tile dst of `rows` rows: 16-byte cp.async where tma (D % 8 ==
  // 0, so a chunk is inside or out), else ordinary loads, done on return.
  auto land_rows = [&](bf16* dst, const bf16* m, int64_t r0, int rows, int64_t r_lim) {
    if (tma) {
      for (int e = tid; e < rows * cpr; e += kThreads) {
        const int r = e / cpr, c = e % cpr;
        const bool in = r0 + r < r_lim && kChunk * c < D;
        cp_async16(const_cast<bf16*>(swz(dst, rows, r, c)), in ? m + (r0 + r) * D + kChunk * c : m,
                   in);
      }
    } else {
      for (int e = tid; e < rows * Dpad; e += kThreads) {
        const int r = e / Dpad, c = e % Dpad;
        const_cast<bf16*>(swz(dst, rows, r, c / kChunk))[c % kChunk] =
            r0 + r < r_lim && c < D ? m[(r0 + r) * D + c] : __float2bfloat16_rn(0.f);
      }
    }
  };
  // starts landing q-tile qt of h into slot qt % 2 (its boxes by the tensor
  // memory accelerator, or by ordinary loads), its labels and lse by cp.async
  auto issue = [&](int qt) {
    const int sl = qt % 2;
    const int64_t q0 = static_cast<int64_t>(qt) * kHQ;
    bf16* dst = hs + sl * kHQ * Dpad;
    if (!tma) {
      land_rows(dst, h, q0, kHQ, M);
    } else if (tid == 0) {
      mbar_expect(&bars[sl], static_cast<uint32_t>(kHQ * Dpad * 2));
      for (int c = 0; c < Dpad / kBox; ++c)
        tma_load(dst + c * kHQ * kBox, &h_map, c * kBox, static_cast<int>(q0), &bars[sl]);
    }
    if (tid < kHQ) {
      const bool in = q0 + tid < M;
      // the low word of each int64 label (V < 2^31; -100 stays -100)
      cp_async4(lab_s + sl * kHQ + tid, in ? labels + q0 + tid : labels, in);
      cp_async4(lse_s + sl * kHQ + tid, in ? lse + q0 + tid : lse, in);
    }
    cp_async_commit();
  };

  // what the thread's rows fix: vocabulary rows v0 + 16 band + g + 8 hh
  // (rows past V form t from zero W rows; neither their dW nor db is written)
  float bias[2], db_acc[2] = {0.f, 0.f};
  bool v_in[2];
  int v32[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t v = v0 + 16 * band + g + 8 * hh;
    v_in[hh] = v < V;
    v32[hh] = static_cast<int>(v);
    bias[hh] = v_in[hh] ? __bfloat162float(b[v]) : 0.f;
  }
  float acc[kDwCols / 8][4];  // dW of the warp's 16 rows and columns d0 + 8 n + ..
#pragma unroll
  for (int n = 0; n < kDwCols / 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;

  land_rows(ws, w, v0, kVRows, V);  // its cp.async in the same group as q-tile 0's labels
  issue(0);
  for (int qt = 0; qt < n_qt; ++qt) {
    const int sl = qt % 2;
    cp_async_wait_all();
    if (tma) mbar_wait(&bars[sl], (qt / 2) & 1);
    fence_proxy_async();  // the W rows and ordinary landings, for wgmma's reads
    __syncthreads();  // tile qt is in; every warp is past tile qt - 1 (its slot, the exchange)
    if (qt + 1 < n_qt) issue(qt + 1);
    const bf16* ht = hs + sl * kHQ * Dpad;
    const int64_t q0 = static_cast<int64_t>(qt) * kHQ;
    const int q_rows = static_cast<int>(imin(M - q0, kHQ));  // rows of the tile inside M

    // the logits of the band's 16 rows and the warp's kQW q-rows
    float s[kQN][4];
#pragma unroll
    for (int n = 0; n < kQN; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[n][r] = 0.f;
    if constexpr (PL::kSplit == 2) {
      // warpgroup `split` forms all 64 rows x its 32 q-rows on wgmma, both
      // operands read from the swizzled boxes by descriptor, a box (kBK
      // deep) a fresh sum
      static_assert(kBK == kBox && PL::kQW % 8 == 0, "a fresh sum a box");
      for (int k0 = 0; k0 < Dpad; k0 += kBK) {
        const bf16* wa = ws + k0 * kVRows;
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
          ldmatrix_x4(a, swz(ws, kVRows, 16 * band + lr + 8 * (lm % 2), kc + lm / 2));
          ldmatrix_x2(r, swz(ht, kHQ, split * PL::kQW + lr, kc + lm % 2));
          mma_bf16(c[0], a, r[0], r[1]);
        }
#pragma unroll
        for (int n = 0; n < kQN; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[n][r] += c[n][r];
      }
    }

    // the softmax p = exp(S + b_v - lse_q) of the warp's own q-rows (0 on
    // rows past M or ignored), each exp formed once; the exchange: the
    // band's 16 x kHQ of p, every warp of the band all of them
#pragma unroll
    for (int n = 0; n < kQN; ++n) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qc = split * PL::kQW + 8 * n + 2 * t4 + e;
        const float l = lse_s[sl * kHQ + qc];
        const bool q_ok = qc < q_rows && lab_s[sl * kHQ + qc] != kIgnore;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          pv[2 * hh + e] = q_ok ? expf(s[n][2 * hh + e] + bias[hh] - l) : 0.f;
      }
      xch[(warp * kQN + n) * 32 + lane] = make_float4(pv[0], pv[1], pv[2], pv[3]);
    }
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + band), "r"(32 * PL::kSplit) : "memory");

    // t, rounded to bfloat16 into the A fragments of dW += bf16(t) h: n8
    // fragment m of the q-tile (rows 8 m.. of it, held by split m / kQN) is
    // half m % 2 of the A fragment of depths 16 (m / 2)..
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
        // p is 0 on rows past M or ignored, where no onehot is subtracted
        const int lab = qc < q_rows ? lab_s[sl * kHQ + qc] : static_cast<int>(kIgnore);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          t[hh][e] = (pv[2 * hh + e] - (v32[hh] == lab ? 1.f : 0.f)) * g_scale;
          if (split == 0) db_acc[hh] += t[hh][e];
        }
      }
      ta[m / 2][2 * (m % 2)] = pack_bf16(t[0][0], t[0][1]);
      ta[m / 2][2 * (m % 2) + 1] = pack_bf16(t[1][0], t[1][1]);
    }

    // dW += bf16(t) h over the tile's kHQ rows: fresh sums, added to acc
    if constexpr (PL::kSplit == 2) {
      // warpgroup `split` into its 64 rows x dcols on wgmma, A = t from the
      // warps' registers, B = the box of h [q][d] read MN-major, a box (64
      // columns) a fresh sum
#pragma unroll
      for (int j = 0; j < kDwCols / kBox; ++j) {
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
      // each warp into its 16 rows x dcols on mma.sync, kDwGroup pairs of n8
      // fragments at a time
#pragma unroll
      for (int j0 = 0; j0 < kDwCols / 16; j0 += kDwGroup) {
        if (16 * j0 >= dcols) continue;  // uniform over the warp
        float c[2 * kDwGroup][4];
#pragma unroll
        for (int n = 0; n < 2 * kDwGroup; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) c[n][r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kHQ / 16; ++kk) {
#pragma unroll
          for (int u = 0; u < kDwGroup; ++u) {
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
        for (int u = 0; u < 2 * kDwGroup; ++u)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[2 * j0 + u][r] += c[u][r];
      }
    }
  }
  cp_async_wait_all();

  // dW rounded to bfloat16 once, as (V, D) rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t v = v0 + 16 * band + g + 8 * hh;
    if (!v_in[hh]) continue;
    bf16* row = dw + v * D;
#pragma unroll
    for (int n = 0; n < kDwCols / 8; ++n) {
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
  if (split == 0) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float v = db_acc[hh];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (t4 == 0 && v_in[hh]) db[v0 + 16 * band + g + 8 * hh] = __float2bfloat16_rn(v);
    }
  }
}

// The tensor map of h (M rows of D bfloat16) in boxes of kBox columns by
// `rows` rows, 128-byte swizzled, zero past its edges, by
// cuTensorMapEncodeTiled; false where it is missing or refuses the map.
bool h_tensor_map(CUtensorMap* map, const bf16* h, int64_t M, int64_t D, int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {kBox, static_cast<cuuint32_t>(rows)};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(h), dims, strides, box,
                steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kVRows>
int launch_dw_rows(const bf16* h, const bf16* w, const bf16* b, const int64_t* labels,
                   const float* lse, const float* gscale, bf16* dw, bf16* db, int64_t M,
                   int64_t D, int64_t V, cudaStream_t s) {
  const int64_t smem = dw_smem_bytes<kVRows>(dw_depth(D));
  if (dw_depth(D) > DwPlan<kVRows>::kMaxD || V > INT32_MAX || M > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  // boxes by the tensor memory accelerator where rows are whole 16-byte
  // chunks (D % 8 == 0) from 16-byte aligned h and W; else ordinary loads
  CUtensorMap map{};
  const bool tma = D % kChunk == 0 &&
                   (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;
  if (tma && !h_tensor_map(&map, h, M, D, DwPlan<kVRows>::kHQ))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      xent_dw_bf16_kernel<kVRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((V + kVRows - 1) / kVRows));
  xent_dw_bf16_kernel<kVRows><<<grid, kThreads, smem, s>>>(map, h, w, b, labels, lse, gscale, dw,
                                                           db, M, D, V, tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Row loss and lse of the forward, float32, from bfloat16 h, W and b. `part`
// holds 3 * splits * M floats of scratch; splits is at most ceil(V / 128),
// and the rows are tiled by kFwdRows (tlie_tpu_torch/ops/fused_xent.py splits
// by the same tile). Two launches on `stream`; returns cudaGetLastError() (0
// on success).
extern "C" int tlie_fused_xent_fwd_bf16(const bf16* h, const bf16* w, const bf16* b,
                                        const int64_t* labels, float* loss, float* lse,
                                        float* part, int64_t M, int64_t D, int64_t V,
                                        int64_t splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (V + kQ - 1) / kQ;
  const int64_t tiles_per_split = (n_tiles + splits - 1) / splits;
  const int smem = fwd_smem_bytes<kFwdRows>();
  cudaError_t err = cudaFuncSetAttribute(
      xent_fwd_bf16_kernel<kFwdRows>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((M + kFwdRows - 1) / kFwdRows),
                  static_cast<unsigned int>(splits));
  xent_fwd_bf16_kernel<kFwdRows><<<grid, kThreads, smem, s>>>(h, w, b, labels, part, M, D, V,
                                                              tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
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
  // 64 rows of h a block where the accumulator fits beside them (D <= 512:
  // 133 KB of it, 206 KB in all), 32 above (D <= 1024: 132 KB, 187 KB)
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return padded_depth(D) <= 512
             ? launch_dh_rows<64>(h, w, b, labels, lse, gscale, dh, M, D, V, s)
             : launch_dh_rows<32>(h, w, b, labels, lse, gscale, dh, M, D, V, s);
}

// dW (V, D) and db (V,), bfloat16, for the cotangent *gscale on every valid
// row's loss.
extern "C" int tlie_fused_xent_dw_bf16(const bf16* h, const bf16* w, const bf16* b,
                                       const int64_t* labels, const float* lse,
                                       const float* gscale, bf16* dw, bf16* db,
                                       int64_t M, int64_t D, int64_t V, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dw_depth(D) <= DwPlan<64>::kMaxD
             ? launch_dw_rows<64>(h, w, b, labels, lse, gscale, dw, db, M, D, V, s)
             : launch_dw_rows<32>(h, w, b, labels, lse, gscale, dw, db, M, D, V, s);
}
