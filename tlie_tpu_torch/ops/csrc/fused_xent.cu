// Fused decoder + softmax cross-entropy, float32: the mean over valid rows of
// logsumexp(h @ W^T + b) - (h @ W^T + b)[label], and its gradient, without
// the (M, V) logits ever reaching device memory.
//
// Replaces the three TPU kernels of tlie_tpu/ops/fused_xent.py:
//   tlie_fused_xent_fwd_f32 <- _fwd (pallas_call at :126, body _fwd_kernel)
//   tlie_fused_xent_dh_f32  <- the dh pallas_call at :228 (_bwd_dh_kernel)
//   tlie_fused_xent_dw_f32  <- the dW/db pallas_call at :246 (_bwd_dw_kernel)
// What they compute is carried over, not their blocks.
//
// Layout. h is (M, D) row-major. The decoder weight is read as W (V, D)
// row-major: the nn.Linear weight itself, whose transpose is the (D, V)
// kernel of the JAX layout, so no copy of it is made. labels are int64,
// -100 where ignored. dW is written as (V, D) row-major.
//
// Bound on the H100: operations. At the LM head's shapes (M 8192, D 512,
// V 50257) the forward is 2*M*D*V = 421.6 GFLOP and each backward kernel
// recomputes the logits and does one more product of that size (843
// GFLOP): 6.3, 12.6 and 12.6 ms at 67 TFLOP/s of float32 outside the tensor
// cores. All three run on the tensor cores as three TF32 products each
// (below): 3 * 421.6 GFLOP at 495 TFLOP/s of dense TF32 is 2.6 ms for the
// forward, 3 * 843 GFLOP 5.1 ms for each backward kernel. The operands are
// 16.8 MB (h) and 103 MB (W).
//
// Forward, xent_fwd_kernel<kFwdRows>. P = 64 rows of h, Q = vocabulary: a
// block takes the logits of each 128-row vocabulary tile of its share from
// logits_tile_tc (the backward's, below) and folds bias, the column mask,
// the label pick and a running (max, sum-exp) into the C fragments in
// registers, each thread for its own columns of its four rows; at the end
// the quad's lanes merge theirs, then the row band's warps, in order, through
// shared memory. Its shared memory is the two-step operand buffer alone (61
// KB; no accumulator), so two blocks share an SM and the row tile is twice
// the SIMT kernel's 32: W (103 MB) is streamed M / 64 = 128 times a launch,
// and each block rereads its 64 rows of h for every tile, 19.8 GB from L2 in
// all at the LM's shape. The TPU keeps the row tile for the whole
// vocabulary; here the vocabulary is split across blocks too (about 32
// blocks per SM, which shortens the last wave's tail) and a second launch
// merges the partial triples of each row (in split order, so the result
// does not depend on scheduling).
//
// Backward. One kernel, xent_bwd_kernel<kVocabIsP, kPRows>, for both:
//   dh:      P = rows of h, Q = vocabulary. Per 128-row vocabulary tile the
//            block recomputes the logits, forms t = (softmax - onehot) * g on
//            valid rows, and adds t @ W_tile into a (kPRows, D) accumulator in
//            shared memory.
//   dW, db:  P = vocabulary, Q = rows of h: the same loop with the roles
//            swapped, adding t^T @ h_tile into the kPRows rows of dW the block
//            owns, and the sums of t into db. A block owns its output, so
//            neither needs atomics, and both are deterministic.
// Both products run on the tensor cores, mma.sync.aligned.m16n8k8 on TF32
// with float32 accumulators, as three products of a split operand
// (tf32_mma.cuh):
//   split:   x = big + small, big = TF32(x), small = TF32(x - big), both
//            rounded to nearest with ties away from zero (the rounding of
//            cvt.rna.tf32.f32, written as an integer add and mask: ptxas
//            makes cvt.rna four instructions, a finite test and a select
//            around the same two); |x - big - small| <= 2^-22 |x|. Each
//            product is small*big + big*small + big*big, the small ones
//            first; small*small (2^-24 relative) is left out. The split is
//            made in registers as each fragment is read from shared memory,
//            so the tiles stay one float32 plane (two planes would not fit
//            beside the accumulator) and land there by cp.async untouched.
//   tiles:   8 warps; a (kPRows x 128) tile of either product is 2 x 4 warps
//            of 32 x 32 (kPRows 64) or 1 x 8 of 32 x 16 (kPRows 32), each warp
//            2 x kNT fragments of 16 x 8. The logits read P and Q
//            K-contiguous (.row.col); the second product reads t from
//            shared memory, where the logits' C fragments leave it, and the
//            Q block [q][d] with the transposed index. Within each depth-8
//            step the depth is permuted the same way for both operands so
//            that a lane's two values of a row are neighbours (one 8-byte
//            read); the row strides make every fragment read hit each bank
//            once.
//   sums:    no tensor-core sum is deeper than one shared-memory step: the
//            logits are summed 32 deep (kBK) into fresh accumulators and
//            then added in float32; the second product sums one tile's 128
//            rows of q into fresh accumulators and adds them to the shared
//            accumulator with an ordinary float32 add. The tensor cores may
//            not round to nearest; bounding their depth keeps dh's sum over
//            50,257 vocabulary entries at float32 quality.
//   plans:   kPRows 64 for D <= 512 (accumulator 133 KB, 224 KB of shared
//            memory in all), kPRows 32 above (D <= 1024: 132 KB, 196 KB); one
//            block of 256 threads per SM. The operands of each step are
//            copied with cp.async into one half of a two-step buffer while
//            the tensor cores work on the other, 16 bytes a copy where D %
//            4 == 0 and the operands are 16-byte aligned, else 4. A
//            zero-filled copy past the matrix is handed the matrix's first
//            address, so no copy gets an address outside it; the 16-byte
//            copies test for that once a block, and copy a block that lies
//            inside the matrix without the test.
//   traffic: each block streams the other operand twice per launch, once in
//            depth steps for the logits and once in column blocks for the
//            second product, and rereads its own kPRows rows per tile: (kPRows +
//            2 * 128) * D * 4 bytes a tile, 33.0 GB from L2 per launch at the
//            LM's shape for either kernel (128 blocks x 393 tiles for dh,
//            786 x 64 for dW).
//   ptxas:   registers a thread, no spills, for <dh, 64>, <dh, 32>, <dW, 64>,
//            <dW, 32>: 178, 133, 171, 121; the forward <64>: 128, its cap for
//            two blocks an SM (146 uncapped, at one block an SM: 9.48
//            against 7.58 ms) (nvcc -Xptxas -v, sm_90a).
//   SASS:    cuobjdump -sass of the built library holds HMMA.1688.F32.TF32 in
//            all five (chip_smoke.py's build phase counts them and fails on
//            none).
//   bound:   at the LM's shape both kernels are held by the rate of
//            mma.sync on TF32, well below the tensor cores' 495 TFLOP/s:
//            wgmma with TMA is the next step (PERF.md).
// Columns past V (the ragged last vocabulary tile, e.g. 50257 = 392 * 128 +
// 81) are never read: the loads test the bound and the statistics skip
// them, as the TPU's _col_mask sets them to -1e30. Depth past D and rows past
// the operands are read as zeros; t is 0 on ignored rows.

#include <cuda_runtime.h>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 128;   // rows of the streamed operand per tile
constexpr int kTD = 128;  // output columns per chunk of the backward's second product
constexpr int kKC = 32;   // depth of one shared-memory step of that product
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

// -- the products on the tensor cores -----------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;          // depth of one shared-memory step of the logits
// Row strides of the shared tiles, in floats, chosen so that a warp's
// fragment reads hit every bank once: float2 reads at (8g + 2t) where the
// stride is 8 modulo 32, float reads at (8t + g) where it is 4.
constexpr int kBKPad = kBK + 8;  // the logits' operands, [row][k]
constexpr int kTPad = kQ + 8;    // t, [p][q]
constexpr int kCPad = kTD + 4;   // a Q block of the second product, [q][d]
constexpr int kOutPad = 8;       // the accumulator, [p][d] (float2 updates)

// A thread's share of 16-byte copies of (kR x kC) blocks of a row-major
// matrix of floats with rows of D (D % 4 == 0, the matrix 16-byte aligned):
// rows tid / (kC / 4) + it * kRows and columns 4 (tid % (kC / 4)) + 0..3 of
// each block, neighbouring threads on neighbouring bytes of a row. Made where
// the block's first row r0 is fixed, so that a step only moves the block.
template <int kR, int kC, int kLd>
struct Copy16 {
  static constexpr int kTPR = kC / 4, kRows = kThreads / kTPR;
  static_assert(kR % kRows == 0 && kLd % 4 == 0, "whole 16-byte copies");
  const float* m;    // the matrix
  const float* src;  // the thread's first float of the block at (r0, 0)
  int rows, cols;    // rows from it on, and columns from it on, inside the matrix
  int dst;           // its offset in a shared block
  int block_rows;    // rows from r0 on inside the matrix, the same for all threads

  __device__ __forceinline__ Copy16(const float* m_, int64_t r0, int64_t r_lim, int64_t D) {
    const int r = threadIdx.x / kTPR, c = 4 * (threadIdx.x % kTPR);
    m = m_;
    src = m_ + (r0 + r) * D + c;
    rows = static_cast<int>(r_lim - r0 - r);
    cols = static_cast<int>(D - c);
    dst = r * kLd + c;
    block_rows = static_cast<int>(r_lim - r0);
  }

  // Starts copying the block at rows r0 + dr.., columns dc.. into `block`,
  // zero past the matrix. A block that reaches past the matrix hands its
  // zero-filled copies m itself as their source (as copy_block4 does), so
  // that no copy gets an address outside the matrix; the test is made once
  // for the whole block, and a block inside the matrix copies without it.
  __device__ __forceinline__ void start(float* block, int dr, int64_t dc, int64_t D) const {
    if (dr + kR <= block_rows && dc + kC <= D) {
#pragma unroll
      for (int it = 0; it < kR / kRows; ++it)
        cp_async(block + dst + it * kRows * kLd, src + (dr + it * kRows) * D + dc, true, 16);
    } else {
#pragma unroll
      for (int it = 0; it < kR / kRows; ++it) {
        const int rr = dr + it * kRows;
        const bool in = rr < rows && dc < cols;
        cp_async(block + dst + it * kRows * kLd, in ? src + rr * D + dc : m, in, 16);
      }
    }
  }
};

// The same block copy 4 bytes at a time, for any D and alignment.
template <int kR, int kC, int kLd>
__device__ __forceinline__ void copy_block4(float* block, const float* __restrict__ m,
                                            int64_t r0, int64_t r_lim, int64_t c0, int64_t D) {
  static_assert(kR * kC % kThreads == 0, "whole copies");
#pragma unroll 4
  for (int it = 0; it < kR * kC / kThreads; ++it) {
    const int e = threadIdx.x + it * kThreads, r = e / kC, c = e % kC;
    const int64_t row = r0 + r, col = c0 + c;
    const bool in = row < r_lim && col < D;
    cp_async(block + r * kLd + c, in ? m + row * D + col : m, in, 4);
  }
}

// The warps' tiling of a (kPRows x 128) tile: kWM warps along P by kWN along
// the columns, each holding 32 x (8 kNT) as 2 x kNT fragments of 16 x 8.
template <int kPRows>
struct Tiling {
  static constexpr int kWM = kPRows / 32;
  static constexpr int kWN = kWarps / kWM;
  static constexpr int kNT = kQ / (8 * kWN);
  static_assert(kWM * kWN == kWarps && kNT * 8 * kWN == kQ, "8 warps tile kPRows x 128");
};

// s = P[p0, p0 + kPRows) · Q[q0, q0 + kQ)ᵀ over depth D for the calling thread's
// fragment elements (Tiling, C layout of mma_tf32). Rows past p_rows / q_rows
// and depth past D read as 0. Each kBK-deep step is summed on the tensor
// cores into fresh accumulators and then added to s in float32, so no
// tensor-core sum is deeper than kBK. The steps' operands are copied into the
// two halves of buf in turn, the next while the tensor cores work on this
// one. Needs all threads past their last use of buf on entry; on return some
// may still read it.
template <int kPRows>
__device__ __forceinline__ void logits_tile_tc(
    const float* __restrict__ Pm, int64_t p0, int64_t p_rows,
    const float* __restrict__ Qm, int64_t q0, int64_t q_rows, int64_t D, bool vec,
    float* buf, float (&s)[2][Tiling<kPRows>::kNT][4]) {
  using TL = Tiling<kPRows>;
  constexpr int kNT = TL::kNT;
  constexpr int kStage = (kPRows + kQ) * kBKPad;
  const int warp = threadIdx.x / 32;
  const int m0 = 32 * (warp / TL::kWN), n0 = 8 * kNT * (warp % TL::kWN);
  const Copy16<kPRows, kBK, kBKPad> p_copy(Pm, p0, p_rows, D);
  const Copy16<kQ, kBK, kBKPad> q_copy(Qm, q0, q_rows, D);
  auto start = [&](int64_t k0, float* st) {
    if (vec) {
      p_copy.start(st, 0, k0, D);
      q_copy.start(st + kPRows * kBKPad, 0, k0, D);
    } else {
      copy_block4<kPRows, kBK, kBKPad>(st, Pm, p0, p_rows, k0, D);
      copy_block4<kQ, kBK, kBKPad>(st + kPRows * kBKPad, Qm, q0, q_rows, k0, D);
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
    const auto Ps = reinterpret_cast<const float (*)[kBKPad]>(buf + step % 2 * kStage);
    const auto Qs = Ps + kPRows;
    float c[2][kNT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) c[i][j][r] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8)
      mma_step_3xtf32<2, kNT>(
          c,
          [&](int m, int t) {
            return *reinterpret_cast<const float2*>(&Ps[m0 + m][kk + 2 * t]);
          },
          [&](int n, int t) {
            return *reinterpret_cast<const float2*>(&Qs[n0 + n][kk + 2 * t]);
          });
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[i][j][r] += c[i][j][r];
  }
}

// Forward: rows of h per block (P = rows of h, Q = vocabulary). 64 rows
// stream W half as often as the SIMT kernel's 32 and leave two blocks to an
// SM (128 registers, 64 KB of shared memory each); 128 rows would halve the
// streaming again, but take 236 registers and one block an SM, and measured
// slower on the H100 (7.57 against 7.35 ms at the LM's shape).
constexpr int kFwdRows = 64;

// Floats of the forward's dynamic shared memory: the two-step operand buffer
// of the logits and the (max, sum-exp, picked) triples of the kWN warps of a
// row band, [3][kWN][kPRows].
template <int kPRows>
__host__ __device__ constexpr int fwd_smem_floats() {
  return 2 * (kPRows + kQ) * kBKPad + 3 * Tiling<kPRows>::kWN * kPRows;
}

// Forward, first launch: grid (ceil(M / kPRows), splits). Block (x, y) walks
// vocabulary tiles [y * tiles_per_split, (y + 1) * tiles_per_split) for rows
// [x * kPRows, (x + 1) * kPRows) and writes each row's partial (max, sum-exp,
// picked logit) at part[{0, 1, 2} * splits * M + y * M + row]. The logits of
// a tile come from logits_tile_tc in the C layout; bias, the column mask
// (v < V), the label pick and the running max and sum-exp are applied to
// them in registers, each thread keeping the statistics of its own columns
// of its four rows. At the end the four lanes of a quad (which share rows)
// merge theirs, then the kWN warps of a row band merge in order through
// shared memory, so the result does not depend on scheduling.
template <int kPRows>
__global__ void __launch_bounds__(kThreads, 2)
xent_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ b, const int64_t* __restrict__ labels,
                float* __restrict__ part, int64_t M, int64_t D, int64_t V,
                int64_t tiles_per_split) {
  using TL = Tiling<kPRows>;
  constexpr int kNT = TL::kNT;
  extern __shared__ __align__(16) float smem[];
  float* buf = smem;                                     // the logits' operands
  float* stats = smem + 2 * (kPRows + kQ) * kBKPad;      // [3][kWN][kPRows]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wn = warp % TL::kWN;
  const int m0 = 32 * (warp / TL::kWN), n0 = 8 * kNT * wn;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPRows;
  const int64_t split = blockIdx.y, splits = gridDim.y;
  const int64_t n_tiles = (V + kQ - 1) / kQ;
  const int64_t tile0 = split * tiles_per_split;
  const int64_t tile1 = imin(n_tiles, tile0 + tiles_per_split);
  const bool vec =
      D % 4 == 0 && (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;

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
    logits_tile_tc<kPRows>(h, p0, M, w, q0, V, D, vec, buf, x);
    // the thread's columns q0 + n0 + 8 j + 2 t4 + e
    float bias[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t v = q0 + n0 + 8 * j + 2 * t4 + e;
        bias[j][e] = v < V ? b[v] : 0.f;
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
__global__ void xent_fwd_merge_kernel(const float* __restrict__ part,
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

// Floats of the two-step operand buffer: two steps of the logits' operands
// or two Q blocks of the second product, whichever is larger.
__host__ __device__ constexpr int bwd_buf_floats(int kPRows) {
  return 2 * ((kPRows + kQ) * kBKPad > kKC * kCPad ? (kPRows + kQ) * kBKPad : kKC * kCPad);
}

// Backward: grid ceil(P rows / kPRows), dynamic shared memory bwd_smem_floats
// (Dpad = D rounded up to kTD). kVocabIsP false computes dh (P = h, Q = W),
// true computes dW and db (P = W, Q = h). gscale points at g / n_valid.
template <bool kVocabIsP, int kPRows>
__global__ void __launch_bounds__(kThreads, 1)
xent_bwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ b, const int64_t* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ gscale,
                float* __restrict__ out, float* __restrict__ db,
                int64_t M, int64_t D, int64_t V, int64_t Dpad) {
  using TL = Tiling<kPRows>;
  constexpr int kNT = TL::kNT;
  constexpr int kCStage = kKC * kCPad;
  const int64_t ostride = Dpad + kOutPad;
  extern __shared__ __align__(16) float smem[];
  float* out_s = smem;               // [kPRows][ostride]
  float* buf = smem + kPRows * ostride;  // two steps' operands of one product at a time
  auto Ts = reinterpret_cast<float (*)[kTPad]>(buf + bwd_buf_floats(kPRows));  // [kPRows][kTPad]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int m0 = 32 * (warp / TL::kWN), n0 = 8 * kNT * (warp % TL::kWN);
  const float* __restrict__ Pm = kVocabIsP ? w : h;
  const float* __restrict__ Qm = kVocabIsP ? h : w;
  const int64_t p_rows = kVocabIsP ? V : M;
  const int64_t q_rows = kVocabIsP ? M : V;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kPRows;
  const float g_scale = *gscale;
  const bool vec =
      D % 4 == 0 && (reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w)) % 16 == 0;

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
      p_bias[i][hh] = (kVocabIsP && in) ? b[p] : 0.f;
      db_acc[i][hh] = 0.f;
    }

  const int n_dc = static_cast<int>(Dpad / kTD);  // column chunks of the second product
  for (int64_t q0 = 0; q0 < q_rows; q0 += kQ) {
    float s[2][kNT][4];
    logits_tile_tc<kPRows>(Pm, p0, p_rows, Qm, q0, q_rows, D, vec, buf, s);

    // t = (exp(logit - lse) - onehot) * g on valid rows, 0 elsewhere, into
    // Ts[p][q], the two neighbouring columns of a fragment together
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
        q_bias[e] = (!kVocabIsP && q_in[e]) ? b[q] : 0.f;
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
          *reinterpret_cast<float2*>(&Ts[pc][qc]) = make_float2(t[0], t[1]);
        }
    }

    __syncthreads();  // t is in; every thread is past the logits' last read of buf

    // out[p][:] += sum over the tile's q of t[p][q] * Q[q][:], by column
    // chunks of kTD, each summed over the tile's kQ rows (kKC at a time) on
    // the tensor cores and then added to out_s in float32; the Q blocks are
    // copied into the two halves of buf in turn, as in logits_tile_tc
    constexpr int kSteps = kQ / kKC;
    const Copy16<kKC, kTD, kCPad> c_copy(Qm, q0, q_rows, D);
    auto start = [&](int step, float* st) {
      const int kc = step % kSteps * kKC;
      const int64_t d0 = static_cast<int64_t>(step / kSteps) * kTD;
      if (vec)
        c_copy.start(st, kc, d0, D);
      else
        copy_block4<kKC, kTD, kCPad>(st, Qm, q0 + kc, q_rows, d0, D);
      cp_async_commit();
    };
    const int n_steps = n_dc * kSteps;
    start(0, buf);
    float acc[2][kNT][4];
    for (int step = 0; step < n_steps; ++step) {
      cp_async_wait_all();
      __syncthreads();
      if (step + 1 < n_steps) start(step + 1, buf + (step + 1) % 2 * kCStage);
      const auto Cs = reinterpret_cast<const float (*)[kCPad]>(buf + step % 2 * kCStage);
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
      for (int kk = 0; kk < kKC; kk += 8)
        mma_step_3xtf32<2, kNT>(
            acc,
            [&](int m, int t) {
              return *reinterpret_cast<const float2*>(&Ts[m0 + m][kc + kk + 2 * t]);
            },
            [&](int n, int t) {
              return make_float2(Cs[kk + 2 * t][n0 + n], Cs[kk + 2 * t + 1][n0 + n]);
            });
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

  for (int64_t e = tid; e < kPRows * D; e += kThreads) {
    const int64_t r = e / D, d = e % D;
    if (p0 + r < p_rows) out[(p0 + r) * D + d] = out_s[r * ostride + d];
  }
  if (kVocabIsP) {
    // the four lanes of a quad share their rows, the kWN warps of a row band
    // hold other columns: sum the lanes, then the warps in order (through
    // Ts, free since the last tile)
    auto db_s = reinterpret_cast<float (*)[kPRows]>(&Ts[0][0]);  // [kWN][kPRows]
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
      if (p0 + r < V) db[p0 + r] = sum;
    }
  }
}

int64_t padded_depth(int64_t D) { return (D + kTD - 1) / kTD * kTD; }

// Floats of the backward's dynamic shared memory: the (kPRows, Dpad) float32
// accumulator (rows padded by kOutPad), the two-step operand buffer of either
// product, and t.
int64_t bwd_smem_floats(int kPRows, int64_t Dpad) {
  return kPRows * (Dpad + kOutPad) + bwd_buf_floats(kPRows) + kPRows * kTPad;
}

template <bool kVocabIsP, int kPRows>
int launch_bwd_rows(const float* h, const float* w, const float* b, const int64_t* labels,
               const float* lse, const float* gscale, float* out, float* db,
               int64_t M, int64_t D, int64_t V, cudaStream_t s) {
  const int64_t Dpad = padded_depth(D);
  const size_t smem = static_cast<size_t>(bwd_smem_floats(kPRows, Dpad)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      xent_bwd_kernel<kVocabIsP, kPRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = kVocabIsP ? V : M;
  const dim3 grid(static_cast<unsigned int>((rows + kPRows - 1) / kPRows));
  xent_bwd_kernel<kVocabIsP, kPRows><<<grid, kThreads, smem, s>>>(
      h, w, b, labels, lse, gscale, out, db, M, D, V, Dpad);
  return static_cast<int>(cudaGetLastError());
}

// 64 rows of the block's own operand where the accumulator fits beside them
// (D <= 512: 133 KB of it, 224 KB in all), 32 above (D <= 1024: 132 KB, 196 KB).
template <bool kVocabIsP>
int launch_bwd(const float* h, const float* w, const float* b, const int64_t* labels,
               const float* lse, const float* gscale, float* out, float* db,
               int64_t M, int64_t D, int64_t V, cudaStream_t s) {
  return padded_depth(D) <= 512
             ? launch_bwd_rows<kVocabIsP, 64>(h, w, b, labels, lse, gscale, out, db, M, D, V, s)
             : launch_bwd_rows<kVocabIsP, 32>(h, w, b, labels, lse, gscale, out, db, M, D, V, s);
}

}  // namespace

// Row loss and lse of the forward. `part` holds 3 * splits * M floats of
// scratch; splits is at most ceil(V / 128), and the rows are tiled by
// kFwdRows (tlie_tpu_torch/ops/fused_xent.py splits by the same tile). Two
// launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int tlie_fused_xent_fwd_f32(const float* h, const float* w, const float* b,
                                       const int64_t* labels, float* loss, float* lse,
                                       float* part, int64_t M, int64_t D, int64_t V,
                                       int64_t splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (V + kQ - 1) / kQ;
  const int64_t tiles_per_split = (n_tiles + splits - 1) / splits;
  const int smem = fwd_smem_floats<kFwdRows>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      xent_fwd_kernel<kFwdRows>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>((M + kFwdRows - 1) / kFwdRows),
                  static_cast<unsigned int>(splits));
  xent_fwd_kernel<kFwdRows><<<grid, kThreads, smem, s>>>(h, w, b, labels, part, M, D, V,
                                                         tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 merge_grid(static_cast<unsigned int>((M + kMergeThreads - 1) / kMergeThreads));
  xent_fwd_merge_kernel<<<merge_grid, kMergeThreads, 0, s>>>(part, labels, loss, lse, M, splits);
  return static_cast<int>(cudaGetLastError());
}

// dh (M, D) for the cotangent *gscale on every valid row's loss.
extern "C" int tlie_fused_xent_dh_f32(const float* h, const float* w, const float* b,
                                      const int64_t* labels, const float* lse,
                                      const float* gscale, float* dh,
                                      int64_t M, int64_t D, int64_t V, void* stream) {
  return launch_bwd<false>(h, w, b, labels, lse, gscale, dh, nullptr, M, D, V,
                           static_cast<cudaStream_t>(stream));
}

// dW (V, D) and db (V,) for the cotangent *gscale on every valid row's loss.
extern "C" int tlie_fused_xent_dw_f32(const float* h, const float* w, const float* b,
                                      const int64_t* labels, const float* lse,
                                      const float* gscale, float* dw, float* db,
                                      int64_t M, int64_t D, int64_t V, void* stream) {
  return launch_bwd<true>(h, w, b, labels, lse, gscale, dw, db, M, D, V,
                          static_cast<cudaStream_t>(stream));
}
