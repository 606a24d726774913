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
// Design. The float32 kernels' structure (fused_xent.cu, which stays as it
// is), on 2-byte operands:
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
//   backward: xent_bwd_bf16_kernel<kVocabIsP, kPRows>: dh (P = rows of h,
//            Q = vocabulary) or dW and db (P = vocabulary, Q = rows of h).
//            Per 128-row tile of Q the block recomputes the logits, forms t,
//            writes bf16(t) to shared memory and adds bf16(t) @ Q_tile (or
//            its transpose) into a (kPRows, D) float32 accumulator in shared
//            memory. One block owns its output: no atomics, deterministic.
//   sums:    no tensor-core sum is deeper than one shared-memory step: the
//            logits 64 deep (kBK) into fresh accumulators, then a float32
//            add; the second product sums one tile's 128 rows of q into
//            fresh accumulators, then adds them to the shared accumulator.
//   plans:   kPRows 64 for D <= 512 (accumulator 133 KB, 206 KB of shared
//            memory in all), kPRows 32 above (D <= 1024: 132 KB, 187 KB);
//            the forward 58 KB, two blocks an SM.
//   ptxas:   registers a thread, no spills, for <dh, 64>, <dh, 32>, <dW, 64>,
//            <dW, 32>: 194, 190, 194, 182; the forward <64>: 122 (nvcc
//            -Xptxas -v, CUDA 12.8, sm_90a). cuobjdump -sass holds
//            HMMA.16816.F32.BF16 in all five (chip_smoke.py's build phase
//            counts them and fails on none).
// Columns past V (the ragged last vocabulary tile, 50257 = 392 * 128 + 81)
// and rows past M are never read: the copies zero-fill them and the
// statistics and t skip them (the TPU's _col_mask and its zeroed W rows,
// :184). Depth past D reads as zeros.

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

// Backward: grid ceil(P rows / kPRows), dynamic shared memory bwd_smem_bytes
// (Dpad = D rounded up to kTD). kVocabIsP false computes dh (P = h, Q = W),
// true computes dW and db (P = W, Q = h). gscale points at g / n_valid.
template <bool kVocabIsP, int kPRows>
__global__ void __launch_bounds__(kThreads, 1)
xent_bwd_bf16_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
                     const bf16* __restrict__ b, const int64_t* __restrict__ labels,
                     const float* __restrict__ lse, const float* __restrict__ gscale,
                     bf16* __restrict__ out, bf16* __restrict__ db,
                     int64_t M, int64_t D, int64_t V, int64_t Dpad) {
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
  const bf16* __restrict__ Pm = kVocabIsP ? w : h;
  const bf16* __restrict__ Qm = kVocabIsP ? h : w;
  const int64_t p_rows = kVocabIsP ? V : M;
  const int64_t q_rows = kVocabIsP ? M : V;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPRows;
  const float g_scale = *gscale;
  const bool vec = D % kChunk == 0 &&
                   (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;

  for (int64_t e = tid; e < kPRows * ostride; e += kThreads) out_s[e] = 0.f;

  // what the P side fixes for the thread's fragment rows m0 + 16 i + 8 hh + g:
  // a row (its lse and label) or a vocabulary entry (its bias)
  float p_lse[2][2], p_bias[2][2], db_acc[2][2];
  int64_t p_lab[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t p = p0 + m0 + 16 * i + 8 * hh + g;
      const bool in = p < p_rows;
      p_lse[i][hh] = (!kVocabIsP && in) ? lse[p] : 0.f;
      p_lab[i][hh] = (!kVocabIsP && in) ? labels[p] : kIgnore;
      p_bias[i][hh] = (kVocabIsP && in) ? __bfloat162float(b[p]) : 0.f;
      db_acc[i][hh] = 0.f;
    }

  const int n_dc = static_cast<int>(Dpad / kTD);  // column chunks of the second product
  for (int64_t q0 = 0; q0 < q_rows; q0 += kQ) {
    float s[2][kNT][4];
    logits_tile_bf16<kPRows>(Pm, p0, p_rows, Qm, q0, q_rows, D, vec, buf, s);

    // t = (exp(logit - lse) - onehot) * g on valid rows, 0 elsewhere, in
    // float32 (db sums it so), rounded to bfloat16 into Ts[p][q], the two
    // neighbouring columns of a fragment as one bfloat16 pair
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int qc = n0 + 8 * j + 2 * t4;
      bool q_in[2];
      float q_lse[2], q_bias[2];
      int64_t q_lab[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t q = q0 + qc + e;
        q_in[e] = q < q_rows;
        q_lse[e] = (kVocabIsP && q_in[e]) ? lse[q] : 0.f;
        q_lab[e] = (kVocabIsP && q_in[e]) ? labels[q] : kIgnore;
        q_bias[e] = (!kVocabIsP && q_in[e]) ? __bfloat162float(b[q]) : 0.f;
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
            const int64_t v = kVocabIsP ? p : q0 + qc + e;
            const int64_t lab = kVocabIsP ? q_lab[e] : p_lab[i][hh];
            const float l = kVocabIsP ? q_lse[e] : p_lse[i][hh];
            const float bias = kVocabIsP ? p_bias[i][hh] : q_bias[e];
            t[e] = 0.f;
            if (q_in[e] && p < p_rows && lab != kIgnore) {
              t[e] = (expf(s[i][j][2 * hh + e] + bias - l) - (v == lab ? 1.f : 0.f)) * g_scale;
            }
            db_acc[i][hh] += t[e];
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
  if (kVocabIsP) {
    // the four lanes of a quad share their rows, the kWN warps of a row band
    // hold other columns: sum the lanes, then the warps in order (through
    // Ts, free since the last tile)
    auto db_s = reinterpret_cast<float (*)[kPRows]>(Ts);  // [kWN][kPRows]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float v = db_acc[i][hh];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t4 == 0) db_s[warp % TL::kWN][m0 + 16 * i + 8 * hh + g] = v;
      }
    __syncthreads();
    for (int r = tid; r < kPRows; r += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int wn = 0; wn < TL::kWN; ++wn) sum += db_s[wn][r];
      if (p0 + r < V) db[p0 + r] = __float2bfloat16_rn(sum);
    }
  }
}

int64_t padded_depth(int64_t D) { return (D + kTD - 1) / kTD * kTD; }

// Bytes of the backward's dynamic shared memory: the (kPRows, Dpad) float32
// accumulator (rows padded by kOutPad), the two-step bfloat16 operand buffer
// of either product, and bf16(t).
int64_t bwd_smem_bytes(int kPRows, int64_t Dpad) {
  return kPRows * (Dpad + kOutPad) * 4 + (bwd_buf_elems(kPRows) + kPRows * kTPad) * 2;
}

template <bool kVocabIsP, int kPRows>
int launch_bwd_rows(const bf16* h, const bf16* w, const bf16* b, const int64_t* labels,
                    const float* lse, const float* gscale, bf16* out, bf16* db,
                    int64_t M, int64_t D, int64_t V, cudaStream_t s) {
  const int64_t Dpad = padded_depth(D);
  const size_t smem = static_cast<size_t>(bwd_smem_bytes(kPRows, Dpad));
  cudaError_t err = cudaFuncSetAttribute(
      xent_bwd_bf16_kernel<kVocabIsP, kPRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = kVocabIsP ? V : M;
  const dim3 grid(static_cast<unsigned int>((rows + kPRows - 1) / kPRows));
  xent_bwd_bf16_kernel<kVocabIsP, kPRows><<<grid, kThreads, smem, s>>>(
      h, w, b, labels, lse, gscale, out, db, M, D, V, Dpad);
  return static_cast<int>(cudaGetLastError());
}

// 64 rows of the block's own operand where the accumulator fits beside them
// (D <= 512: 133 KB of it, 206 KB in all), 32 above (D <= 1024: 132 KB, 187 KB).
template <bool kVocabIsP>
int launch_bwd(const bf16* h, const bf16* w, const bf16* b, const int64_t* labels,
               const float* lse, const float* gscale, bf16* out, bf16* db,
               int64_t M, int64_t D, int64_t V, cudaStream_t s) {
  return padded_depth(D) <= 512
             ? launch_bwd_rows<kVocabIsP, 64>(h, w, b, labels, lse, gscale, out, db, M, D, V, s)
             : launch_bwd_rows<kVocabIsP, 32>(h, w, b, labels, lse, gscale, out, db, M, D, V, s);
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
  return launch_bwd<false>(h, w, b, labels, lse, gscale, dh, nullptr, M, D, V,
                           static_cast<cudaStream_t>(stream));
}

// dW (V, D) and db (V,), bfloat16, for the cotangent *gscale on every valid
// row's loss.
extern "C" int tlie_fused_xent_dw_bf16(const bf16* h, const bf16* w, const bf16* b,
                                       const int64_t* labels, const float* lse,
                                       const float* gscale, bf16* dw, bf16* db,
                                       int64_t M, int64_t D, int64_t V, void* stream) {
  return launch_bwd<true>(h, w, b, labels, lse, gscale, dw, db, M, D, V,
                          static_cast<cudaStream_t>(stream));
}
