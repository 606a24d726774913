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
// GFLOP), against 67 TFLOP/s of float32 outside the tensor cores: 6.3, 12.6
// and 12.6 ms. The operands are 16.8 MB (h) and 103 MB (W).
//
// Design. Every kernel is one tiled float32 SIMT product on shared-memory
// tiles (no TF32: parity is held at float32). 256 threads each hold a 4 x 4
// tile of a 32 x 128 block of logits: 32 rows of the block's own operand
// (the "P" side) against 128 rows of the streamed operand (the "Q" side),
// both read K-contiguous in depth steps of 16 through padded shared memory.
//   forward: P = rows of h, Q = vocabulary. A block walks its share of the
//            vocabulary tiles keeping a running (max, sum-exp, picked logit)
//            per row and thread; the 32 threads of a warp merge theirs at
//            the end. The TPU keeps the row tile for the whole vocabulary;
//            here M / 32 = 256 row tiles would fill the card once, so the
//            vocabulary is split across blocks too and a second launch
//            merges the partial triples of each row (in split order, so the
//            result does not depend on scheduling).
//   dh:      P = rows of h, Q = vocabulary. Per vocabulary tile the block
//            recomputes the logits, forms t = (softmax - onehot) * g on valid
//            rows, and adds t @ W_tile into a (32, D) accumulator in shared
//            memory.
//   dW, db:  P = vocabulary, Q = rows of h: the same loop with the roles
//            swapped, adding t^T @ h_tile into the (32, D) rows of dW the
//            block owns, and the sums of t into db. A block owns its output,
//            so neither backward needs atomics, and both are deterministic.
// Columns past V (the ragged last vocabulary tile, e.g. 50257 = 392 * 128 +
// 81) are never read: the loads test the bound and the statistics skip
// them, as the TPU's _col_mask sets them to -1e30.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kP = 32;    // rows of the block's own operand
constexpr int kQ = 128;   // rows of the streamed operand per tile
constexpr int kK = 16;    // depth of one shared-memory step of the logits product
constexpr int kTD = 128;  // output columns per chunk of the backward's second product
constexpr int kKC = 32;   // depth of one shared-memory step of that product
constexpr int kPad = 4;   // row padding of the shared tiles (keeps float4 alignment)
constexpr int kMergeThreads = 256;
constexpr int64_t kIgnore = -100;
constexpr float kNegBig = -1e30f;
static_assert(kP * kK % kThreads == 0 && kQ * kK % kThreads == 0 &&
              kKC * kTD % kThreads == 0, "tile loads split evenly over the threads");
static_assert(kP == 4 * (kThreads / 32) && kQ == 4 * 32 && kTD == 4 * 32,
              "each thread holds a 4 x 4 tile: 8 warps of P rows, 32 lanes of columns");

__device__ __forceinline__ int64_t imin(int64_t x, int64_t y) { return x < y ? x : y; }

// acc[i][j] = sum_k P[p0 + 4*ty + i][k] * Q[q0 + 4*tx + j][k] for the calling
// thread (ty = tid / 32, tx = tid % 32). Both operands are row-major with
// rows of length D; rows past p_rows / q_rows and depth past D read as 0.
// Starts and ends with all threads past their last use of Ps and Qs.
__device__ __forceinline__ void logits_tile(
    const float* __restrict__ Pm, int64_t p0, int64_t p_rows,
    const float* __restrict__ Qm, int64_t q0, int64_t q_rows, int64_t D,
    float (*Ps)[kP + kPad], float (*Qs)[kQ + kPad], float acc[4][4]) {
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < D; k0 += kK) {
    // 16 neighbouring threads read 16 neighbouring floats of one row
#pragma unroll
    for (int it = 0; it < kP * kK / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e / kK, c = e % kK;
      const int64_t row = p0 + r, k = k0 + c;
      Ps[c][r] = (row < p_rows && k < D) ? Pm[row * D + k] : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kQ * kK / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e / kK, c = e % kK;
      const int64_t row = q0 + r, k = k0 + c;
      Qs[c][r] = (row < q_rows && k < D) ? Qm[row * D + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&Ps[c][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Qs[c][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Running (max, sum-exp) merge of (m2, s2) into (m, s).
__device__ __forceinline__ void merge_stats(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// Forward, first launch: grid (ceil(M / kP), splits). Block (x, y) walks
// vocabulary tiles [y * tiles_per_split, (y + 1) * tiles_per_split) for rows
// [x * kP, x * kP + kP) and writes each row's partial (max, sum-exp, picked
// logit) at part[{0, 1, 2} * splits * M + y * M + row].
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ b, const int64_t* __restrict__ labels,
                float* __restrict__ part, int64_t M, int64_t D, int64_t V,
                int64_t tiles_per_split) {
  __shared__ __align__(16) float Ps[kK][kP + kPad];
  __shared__ __align__(16) float Qs[kK][kQ + kPad];
  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kP;
  const int64_t split = blockIdx.y, splits = gridDim.y;
  const int64_t n_tiles = (V + kQ - 1) / kQ;
  const int64_t tile0 = split * tiles_per_split;
  const int64_t tile1 = imin(n_tiles, tile0 + tiles_per_split);

  float m[4], s[4], pk[4];
  int64_t lab[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t row = p0 + ty * 4 + i;
    m[i] = kNegBig;
    s[i] = 0.f;
    pk[i] = 0.f;
    lab[i] = row < M ? labels[row] : kIgnore;
  }

  for (int64_t tile = tile0; tile < tile1; ++tile) {
    const int64_t q0 = tile * kQ;
    float acc[4][4];
    logits_tile(h, p0, M, w, q0, V, D, Ps, Qs, acc);
    int64_t v[4];
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = q0 + tx * 4 + j;
      bias[j] = v[j] < V ? b[v[j]] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x[4], tmax = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[j] = v[j] < V ? acc[i][j] + bias[j] : kNegBig;
        tmax = fmaxf(tmax, x[j]);
        if (v[j] == lab[i]) pk[i] += x[j];
      }
      const float mn = fmaxf(m[i], tmax);
      float add = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (v[j] < V) add += expf(x[j] - mn);
      s[i] = s[i] * expf(m[i] - mn) + add;
      m[i] = mn;
    }
  }

  // the 32 threads of a warp share their rows: merge across them
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float so = __shfl_xor_sync(0xffffffffu, s[i], off);
      const float po = __shfl_xor_sync(0xffffffffu, pk[i], off);
      merge_stats(m[i], s[i], mo, so);
      pk[i] += po;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t row = p0 + ty * 4 + i;
      if (row < M) {
        part[(0 * splits + split) * M + row] = m[i];
        part[(1 * splits + split) * M + row] = s[i];
        part[(2 * splits + split) * M + row] = pk[i];
      }
    }
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

// Backward: grid ceil(P rows / kP), dynamic shared memory kP * Dpad floats
// (Dpad = D rounded up to kTD). kVocabIsP false computes dh (P = h, Q = W),
// true computes dW and db (P = W, Q = h). gscale points at g / n_valid.
template <bool kVocabIsP>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const float* __restrict__ h, const float* __restrict__ w,
                const float* __restrict__ b, const int64_t* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ gscale,
                float* __restrict__ out, float* __restrict__ db,
                int64_t M, int64_t D, int64_t V, int64_t Dpad) {
  extern __shared__ __align__(16) float out_s[];  // [kP][Dpad]
  __shared__ __align__(16) float Ps[kK][kP + kPad];
  __shared__ __align__(16) float Qs[kK][kQ + kPad];
  __shared__ __align__(16) float Ts[kQ][kP + kPad];  // t, transposed: [q][p]
  __shared__ __align__(16) float Cs[kKC][kTD + kPad];

  const int tid = threadIdx.x, ty = tid / 32, tx = tid % 32;
  const float* __restrict__ Pm = kVocabIsP ? w : h;
  const float* __restrict__ Qm = kVocabIsP ? h : w;
  const int64_t p_rows = kVocabIsP ? V : M;
  const int64_t q_rows = kVocabIsP ? M : V;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * kP;
  const float g = *gscale;

  for (int64_t e = tid; e < kP * Dpad; e += kThreads) out_s[e] = 0.f;

  // what the P side fixes: a row (its lse and label) or a vocabulary entry (its bias)
  float p_lse[4], p_bias[4];
  int64_t p_lab[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t p = p0 + ty * 4 + i;
    const bool in = p < p_rows;
    p_lse[i] = (!kVocabIsP && in) ? lse[p] : 0.f;
    p_lab[i] = (!kVocabIsP && in) ? labels[p] : kIgnore;
    p_bias[i] = (kVocabIsP && in) ? b[p] : 0.f;
  }
  float db_acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int64_t q0 = 0; q0 < q_rows; q0 += kQ) {
    float acc[4][4];
    logits_tile(Pm, p0, p_rows, Qm, q0, q_rows, D, Ps, Qs, acc);

    // t = (exp(logit - lse) - onehot) * g on valid rows, 0 elsewhere
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t q = q0 + tx * 4 + j;
      const bool q_in = q < q_rows;
      const float q_lse = (kVocabIsP && q_in) ? lse[q] : 0.f;
      const int64_t q_lab = (kVocabIsP && q_in) ? labels[q] : kIgnore;
      const float q_bias = (!kVocabIsP && q_in) ? b[q] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t p = p0 + ty * 4 + i;
        const int64_t v = kVocabIsP ? p : q;
        const int64_t lab = kVocabIsP ? q_lab : p_lab[i];
        const float l = kVocabIsP ? q_lse : p_lse[i];
        const float bias = kVocabIsP ? p_bias[i] : q_bias;
        float t = 0.f;
        if (q_in && p < p_rows && lab != kIgnore) {
          t = (expf(acc[i][j] + bias - l) - (v == lab ? 1.f : 0.f)) * g;
        }
        Ts[tx * 4 + j][ty * 4 + i] = t;
        db_acc[i] += t;
      }
    }
    __syncthreads();

    // out[p][:] += sum over the tile's q of t[p][q] * Q[q][:], by column chunks
    for (int64_t d0 = 0; d0 < D; d0 += kTD) {
      float acc2[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;
      for (int n0 = 0; n0 < kQ; n0 += kKC) {
        // 128 neighbouring threads read one row's 128 neighbouring floats
#pragma unroll
        for (int it = 0; it < kKC * kTD / kThreads; ++it) {
          const int e = tid + it * kThreads, n = e / kTD, c = e % kTD;
          const int64_t q = q0 + n0 + n, d = d0 + c;
          Cs[n][c] = (q < q_rows && d < D) ? Qm[q * D + d] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int n = 0; n < kKC; ++n) {
          const float4 a = *reinterpret_cast<const float4*>(&Ts[n0 + n][ty * 4]);
          const float4 c = *reinterpret_cast<const float4*>(&Cs[n][tx * 4]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc2[i][j] = fmaf(av[i], cv[j], acc2[i][j]);
        }
        __syncthreads();
      }
      // each thread owns these elements of out_s: no race
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out_s[(ty * 4 + i) * Dpad + d0 + tx * 4 + j] += acc2[i][j];
    }
  }
  __syncthreads();

  for (int64_t e = tid; e < kP * D; e += kThreads) {
    const int64_t r = e / D, d = e % D;
    if (p0 + r < p_rows) out[(p0 + r) * D + d] = out_s[r * Dpad + d];
  }
  if (kVocabIsP) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        db_acc[i] += __shfl_xor_sync(0xffffffffu, db_acc[i], off);
      const int64_t v = p0 + ty * 4 + i;
      if (tx == 0 && v < V) db[v] = db_acc[i];
    }
  }
}

int64_t padded_depth(int64_t D) { return (D + kTD - 1) / kTD * kTD; }

template <bool kVocabIsP>
int launch_bwd(const float* h, const float* w, const float* b, const int64_t* labels,
               const float* lse, const float* gscale, float* out, float* db,
               int64_t M, int64_t D, int64_t V, cudaStream_t s) {
  const int64_t Dpad = padded_depth(D);
  const size_t smem = static_cast<size_t>(kP * Dpad) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      xent_bwd_kernel<kVocabIsP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = kVocabIsP ? V : M;
  const dim3 grid(static_cast<unsigned int>((rows + kP - 1) / kP));
  xent_bwd_kernel<kVocabIsP><<<grid, kThreads, smem, s>>>(
      h, w, b, labels, lse, gscale, out, db, M, D, V, Dpad);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Row loss and lse of the forward. `part` holds 3 * splits * M floats of
// scratch; splits is at most ceil(V / 128). Two launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int tlie_fused_xent_fwd_f32(const float* h, const float* w, const float* b,
                                       const int64_t* labels, float* loss, float* lse,
                                       float* part, int64_t M, int64_t D, int64_t V,
                                       int64_t splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_tiles = (V + kQ - 1) / kQ;
  const int64_t tiles_per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid(static_cast<unsigned int>((M + kP - 1) / kP),
                  static_cast<unsigned int>(splits));
  xent_fwd_kernel<<<grid, kThreads, 0, s>>>(h, w, b, labels, part, M, D, V, tiles_per_split);
  cudaError_t err = cudaGetLastError();
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
