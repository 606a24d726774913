// Causal softmax attention, float32, and its gradient:
//
//   o[b,i,h,:] = sum_{j<=i} softmax_j(scale * q[b,i,h,:] . k[b,j,h,:]) * v[b,j,h,:]
//   lse[b,h,i] = log sum_{j<=i} exp(scale * q_i . k_j)
//
// with the (L, L) scores never in device memory.
//
// Replaces the three TPU kernels that tlie_tpu/ops/attention.py:49
// (_pallas_flash_attention) reaches through JAX's Pallas TPU flash kernel
// (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0):
//   tlie_flash_attention_fwd_f32     <- the pallas_call at :758 (_flash_attention_kernel :331)
//   tlie_flash_attention_bwd_dkv_f32 <- the pallas_call at :1121 (_flash_attention_dkv_kernel :796)
//   tlie_flash_attention_bwd_dq_f32  <- the pallas_call at :1456 (_flash_attention_dq_kernel :1146)
// What they compute is carried over, not their blocks. The TPU saves the row
// max m and sum l, each broadcast to 128 lanes; here the forward writes one
// log-sum-exp a row, and the backward recomputes P = exp(scale S - lse).
// di = rowsum(o * do) comes in precomputed, as the TPU computes it in XLA.
//
// Layout. q, k and v are (B, L, H, D) with the last dimension contiguous and
// any batch, row and head strides (the port's MHA splits them out of the
// Wqkv projection as views, and the kernels read them in place). o, do, dq,
// dk and dv are contiguous (B, L, H, D); lse and di contiguous (B, H, L).
// D <= 128.
//
// Bound on the H100: operations. At the MQAR shape (B 64, L 512, H 1,
// D 128) the causal pairs are 64 * 512 * 513 / 2 = 8.4 M; the forward does
// two products over them (q.k and p v, 4D flops a pair), 4.3 GFLOP: 0.064 ms
// at 67 TFLOP/s of float32 outside the tensor cores, 0.026 ms as three TF32
// products at 495 TFLOP/s on them, against 67 MB of operands, 0.020 ms at
// 3.35 TB/s. dK/dV does four products (8D a pair): 0.052 ms as three TF32
// products on the tensor cores; dQ three (6D): 0.039 ms so.
//
// Forward, on the tensor cores (mma.sync m16n8k8 on TF32, float32
// accumulators, each product as three TF32 products of a split operand:
// tf32_mma.cuh). A block of 4 warps owns 64 rows of i of one (b, h); each
// warp owns 16 whole rows, so the online softmax needs only the quad of
// lanes that shares a row. q is copied once into shared memory, k_j and v_j
// land by cp.async for each j-tile j <= i (v_j while S is formed), S = q k_j^T
// is summed 32 deep into fresh accumulators and then added in float32, the
// running row max m and sum l rescale the o accumulator by exp(m_old -
// m_new), and P passes through the warp's slice of shared memory (the space
// k_j held) from the C layout into the A layout for o += P v_j, summed over
// the tile's 64 j into fresh accumulators for each 64-column half of D.
// Two blocks share an SM (103 KB of shared memory each, 232 registers a
// thread, no spills: nvcc -Xptxas -v, sm_90a). It writes o / l and
// lse = m + log l.
//
// dK/dV, on the tensor cores too, each product summed no deeper than kFresh
// = 8 before a float32 add (dk and dv sum over up to L rows of i, and their
// gradients over every position into Wqkv): block (b h, j-tile) of 8 warps
// in two groups of 4, each warp 16 whole rows of j, walking the i-tiles
// i >= j. Group B forms S^T = k_j q_i^T over D, P^T = exp(scale S^T -
// lse_i) where j <= i < L, publishes P^T in shared memory and adds dv +=
// P^T do_i; group A forms dP^T = v_j do_i^T over D, dS^T = P^T (dP^T -
// di_i) and adds dk += dS^T q_i (times scale once, at the store). Each of
// the four products is formed once per tile pair, two in each group: at the
// MQAR shape 4 x 4 warps x 8 fragments x 16 depth steps of 8 x 3 = 6,144
// mma.sync. It is the decay attention's bwd_j (decay_attention.cu) with the
// softmax's elementwise step in place of the decay: both groups run one code
// for their first product and one for their second. ptxas (nvcc -Xptxas
// -v, sm_90a, CUDA 12.8): 218 registers, 174,592 bytes of dynamic shared
// memory, one block of 8 warps an SM, no spills.
//
// dQ, on the tensor cores too: dK/dV mirrored, as the decay attention's
// bwd_i mirrors its bwd_j. Block (b h, i-tile) of 8 warps in two groups of
// 4, each warp 16 whole rows of i, walking the j-tiles j <= i; q_i and do_i
// land once and stay put, k_j and v_j land for each j-tile in four depth
// quarters. Group B forms S = q_i k_j^T over D, P = exp(scale S - lse_i)
// where j <= i < L, and publishes P in shared memory; group A forms dP =
// do_i v_j^T over D and, after the block's barrier, dS = P (dP - di_i) in
// place of its rows of P; then both groups add dS k_j to dq, group A
// columns 0-63 of D and group B columns 64-127, kFresh = 8 deep before each
// float32 add as in dK/dV (dq sums over up to L rows of j, and its gradient
// over every position into Wqkv), times scale once, at the store. Each of
// the three products is formed once per tile pair: at the MQAR shape 2 x 4
// warps x 8 fragments x 16 depth steps of 8 x 3 (S, dP) + 8 warps x 8 x 8
// x 3 (dq) = 4,608 mma.sync. Where D <= 64 dq has no columns 64-127: group
// B forms S and P, then waits at the barriers while group A adds dS k_j
// alone (at D 64, dq's 768 mma.sync, a third of a tile pair's 2,304, run
// on half the warps). ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 181
// registers, 157,184 bytes of dynamic shared memory, one block of 8 warps
// an SM, no spills.
//
// Each output element has one writer, so there are no atomics and every
// launch is deterministic. exp is taken only where j <= i (and i < L); a
// masked logit never reaches an exp. Rows past L (a ragged last tile) load
// as 0, keep m = -inf without ever forming -inf - (-inf), and are not
// stored. The tiles whose blocks walk the most (the last i-tiles forward and
// in dQ, the first j-tiles in dK/dV) are launched first.

#include <cuda_runtime.h>
#include <math.h>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kMaxD = 128;  // head dims up to two 64-wide column tiles

struct Dims {
  int64_t L, H, D;
  int64_t q_bs, q_ls, q_hs;  // batch, row and head strides of q, in elements
  int64_t k_bs, k_ls, k_hs;
  int64_t v_bs, v_ls, v_hs;
  float scale;
};

// -- the forward on the tensor cores ---------------------------------------------

constexpr int kFwdThreads = 128;   // 4 warps, each 16 whole rows of the block's 64
constexpr int kSK = 32;            // depth of one fresh tensor-core sum of S
// Row strides of the shared tiles, in floats: float2 fragment reads at
// (8g + 2t) hit every bank once where the stride is 8 modulo 32 (q, k, P),
// float reads at (8t + g) where it is 4 (v).
constexpr int kQKLd = kMaxD + 8;
constexpr int kVLd = kMaxD + 4;
constexpr int kPLd = kT + 8;
// q, k_j (whose space the warps' P slices take once S is formed) and v_j:
// 103,424 bytes, two blocks to an SM.
constexpr int kFwdSmemFloats = 2 * kT * kQKLd + kT * kVLd;
static_assert((kFwdThreads / 32) * 16 == kT && (kFwdThreads / 32) * 16 * kPLd <= kT * kQKLd,
              "4 warps of 16 rows; their P slices fit where k_j was");

// Starts copying rows [0, 64) and columns [0, width) of a tile whose first
// row is `src` (rows ld apart) into dst (rows kLd apart), zero where the row
// is at or past `rows` or the column at or past D. 16 bytes a copy where
// `vec` (D % 4 == 0 and every row 16-byte aligned), else 4. A zero-filled
// copy is handed `src` itself, so no copy gets an address outside the tensor.
template <int kLd>
__device__ __forceinline__ void copy_fwd_tile(float* dst, const float* __restrict__ src,
                                              int64_t ld, int64_t rows, int64_t D, int width,
                                              bool vec) {
  if (vec) {
    const int per_row = width / 4;
    for (int e = threadIdx.x; e < kT * per_row; e += kFwdThreads) {
      const int r = e / per_row, c = 4 * (e % per_row);
      const bool in = r < rows && c < D;
      cp_async(dst + r * kLd + c, in ? src + r * ld + c : src, in, 16);
    }
  } else {
    for (int e = threadIdx.x; e < kT * width; e += kFwdThreads) {
      const int r = e / width, c = e % width;
      const bool in = r < rows && c < D;
      cp_async(dst + r * kLd + c, in ? src + r * ld + c : src, in, 4);
    }
  }
}

// grid (B * H, ceil(L / 64)), dynamic shared memory kFwdSmemFloats;
// i-tile = last - blockIdx.y. Warp w owns rows 16w.. of the i-tile; lane
// (g, t4) holds rows 16w + g and 16w + g + 8 of each C fragment, columns
// 8n + 2t4 and 8n + 2t4 + 1. Per j-tile: k_j and v_j land by cp.async (v_j
// while S is formed); S = q k_j^T on the tensor cores, kSK deep into fresh
// accumulators, then a float32 add; the online softmax on the C fragments
// (max and sum across the quad that shares a row); P through the warp's
// slice of shared memory into the A layout; o += P v_j, the tile's 64 j
// summed into fresh accumulators for each 64-column half of D, then a
// float32 add.
__global__ void __launch_bounds__(kFwdThreads, 2)
flash_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;              // [kT][kQKLd]
  float* ks = qs + kT * kQKLd;   // [kT][kQKLd], then the P slices [4][16][kPLd]
  float* vs = ks + kT * kQKLd;   // [kT][kVLd]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * warp;
  float* ps = ks + r0 * kPLd;    // the warp's P slice
  const int64_t bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int64_t i0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kT;
  const float* qb = q + b * d.q_bs + h * d.q_hs;
  const float* kb = k + b * d.k_bs + h * d.k_hs;
  const float* vb = v + b * d.v_bs + h * d.v_hs;
  // columns copied (zero past D): whole 64-column halves
  const int width = d.D <= kT ? kT : 2 * kT;
  const bool vec =
      d.D % 4 == 0 &&
      (d.q_bs | d.q_ls | d.q_hs | d.k_bs | d.k_ls | d.k_hs | d.v_bs | d.v_ls | d.v_hs) % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 == 0;

  float acc[2][8][4];  // o of the thread's two rows, by 64-column half
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[hf][n][r] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  copy_fwd_tile<kQKLd>(qs, qb + i0 * d.q_ls, d.q_ls, d.L - i0, d.D, width, vec);
  for (int64_t j0 = 0; j0 <= i0; j0 += kT) {
    copy_fwd_tile<kQKLd>(ks, kb + j0 * d.k_ls, d.k_ls, d.L - j0, d.D, width, vec);
    cp_async_commit();  // (q's copies go with the first k_j's)
    copy_fwd_tile<kVLd>(vs, vb + j0 * d.v_ls, d.v_ls, d.L - j0, d.D, width, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // q and k_j are in

    float s[1][8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[0][n][r] = 0.f;
    for (int k0 = 0; k0 < width; k0 += kSK) {
      float c[1][8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) c[0][n][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSK; kk += 8)
        mma_step_3xtf32<1, 8>(
            c,
            [&](int mm, int t) {
              return *reinterpret_cast<const float2*>(&qs[(r0 + mm) * kQKLd + k0 + kk + 2 * t]);
            },
            [&](int n, int t) {
              return *reinterpret_cast<const float2*>(&ks[n * kQKLd + k0 + kk + 2 * t]);
            });
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[0][n][r] += c[0][n][r];
    }
    __syncthreads();  // every warp is past its reads of k_j: the P slices take its place

    // the online softmax on the C fragments; exp only where j <= i < L
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t i = i0 + r0 + g + 8 * hh;
      float tmax = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t j = j0 + 8 * n + 2 * t4 + e;
          float& x = s[0][n][2 * hh + e];
          x *= d.scale;
          if (j <= i && i < d.L) tmax = fmaxf(tmax, x);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[hh], tmax);
      // a row with no valid entry yet (only rows past L) keeps m = -inf,
      // p = 0 and its (zero) accumulator: no -inf - (-inf) is formed
      const bool live = m_new != -INFINITY;
      const float alpha = live ? expf(m[hh] - m_new) : 1.f;
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t j = j0 + 8 * n + 2 * t4 + e;
          p[e] = (j <= i && i < d.L) ? expf(s[0][n][2 * hh + e] - m_new) : 0.f;
          psum += p[e];
        }
        *reinterpret_cast<float2*>(&ps[(g + 8 * hh) * kPLd + 8 * n + 2 * t4]) =
            make_float2(p[0], p[1]);
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      l[hh] = l[hh] * alpha + psum;
      m[hh] = m_new;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[hf][n][2 * hh + e] *= alpha;
    }
    cp_async_wait<0>();
    __syncthreads();  // v_j and every warp's P slice are in

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (hf * kT >= width) break;  // uniform over the block
      float c[1][8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) c[0][n][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kT; kk += 8)
        mma_step_3xtf32<1, 8>(
            c,
            [&](int mm, int t) {
              return *reinterpret_cast<const float2*>(&ps[mm * kPLd + kk + 2 * t]);
            },
            [&](int n, int t) {
              const float* col = vs + (kk + 2 * t) * kVLd + hf * kT + n;
              return make_float2(col[0], col[kVLd]);
            });
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[hf][n][r] += c[0][n][r];
    }
    __syncthreads();  // every warp is past its reads of v_j and of its P slice
  }

  const int64_t ld = d.H * d.D;
  float* ob = o + (b * d.L * d.H + h) * d.D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t i = i0 + r0 + g + 8 * hh;
    if (i >= d.L) continue;
    const float inv = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
    if (t4 == 0) lse[bh * d.L + i] = m[hh] + logf(l[hh]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t col = hf * kT + 8 * n + 2 * t4 + e;
          if (col < d.D) ob[i * ld + col] = acc[hf][n][2 * hh + e] * inv;
        }
  }
}

// -- dK/dV on the tensor cores -----------------------------------------------------

// the backward kernels: two groups of 4 warps, each warp 16 whole rows of
// the block's tile (j for dK/dV, i for dQ)
constexpr int kBwdThreads = 256;
// Row strides of the backward kernels' shared tiles, in floats: the operand
// tiles are read as float2 at (8g + 2t) along their rows in the first
// products and as float at (8t + g) down their columns in the second (8
// modulo 32 serves both); the P^T and dS^T slices at (4g + t) in the A
// layout (4 modulo 32), as are dQ's P and dS.
constexpr int kTLd = kMaxD + 8;
constexpr int kDLd = kT + 4;
// k_j, q_i, v_j and do_i, P^T and dS^T, lse_i and di_i: 174,592 bytes
constexpr int kDkvSmemFloats = 4 * kT * kTLd + 2 * kT * kDLd + 2 * kT;
static_assert(kMaxD == 4 * kStep, "a row of D is four depth quarters");

// grid (B * H, ceil(L / 64)), dynamic shared memory kDkvSmemFloats; block
// (b h, j-tile = blockIdx.y) walks the i-tiles i >= j. Warps 0-3 are group A
// (dP^T = v_j do_i^T, dS^T = P^T (dP^T - di_i), dk += dS^T q_i), warps 4-7
// group B (S^T = k_j q_i^T, P^T = exp(scale S^T - lse_i), dv += P^T do_i);
// warp w of either holds rows 16 (w % 4) + g and + 8 of the j-tile, and
// columns 8n + 2t4 and + 1 of each C fragment (i for S^T and dP^T, D for the
// accumulators). k_j and v_j land once and stay put; q_i and do_i land by
// cp.async in four depth quarters, each group copying the one its first
// product reads and waiting only for its own, at its own barrier; after the
// block's barrier group A reads the P^T group B published, and each group's
// second product reads the tile the other group copied.
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ dout,
                               const float* __restrict__ lse, const float* __restrict__ di,
                               float* __restrict__ dk, float* __restrict__ dv, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* tk = smem;                 // k_j [kT][kTLd]
  float* tq = tk + kT * kTLd;       // q_i
  float* tv = tq + kT * kTLd;       // v_j
  float* tdo = tv + kT * kTLd;      // do_i
  float* pts = tdo + kT * kTLd;     // P^T [kT][kDLd] (group B)
  float* dss = pts + kT * kDLd;     // dS^T [kT][kDLd] (group A)
  float* rows_i = dss + kT * kDLd;  // [lse_i | di_i][kT]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const bool grp_b = warp >= 4;
  const int gtid = threadIdx.x % 128;
  const int r0 = 16 * (warp % 4);
  const int64_t bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int64_t j0 = static_cast<int64_t>(blockIdx.y) * kT;
  const int64_t ld = d.H * d.D;  // row stride of the contiguous (B, L, H, D) tensors
  const float* qb = q + b * d.q_bs + h * d.q_hs;
  const float* dob = dout + (b * d.L * d.H + h) * d.D;
  const bool vec =
      d.D % 4 == 0 &&
      (d.q_bs | d.q_ls | d.q_hs | d.k_bs | d.k_ls | d.k_hs | d.v_bs | d.v_ls | d.v_hs) % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  // the group's first product: rows of the j-tile (k_j or v_j) times rows of
  // the i-tile (q_i or do_i) over D
  const float* own = grp_b ? k + b * d.k_bs + h * d.k_hs + j0 * d.k_ls
                           : v + b * d.v_bs + h * d.v_hs + j0 * d.v_ls;
  const int64_t ld_own = grp_b ? d.k_ls : d.v_ls, ld_walk = grp_b ? d.q_ls : ld;
  float* tile_own = grp_b ? tk : tv;
  float* tile_walk = grp_b ? tq : tdo;

  float acc[2][8][4];  // dk (group A) or dv (group B) of the thread's two rows, by 64-column half
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[hf][n][r] = 0.f;
  float f[1][8][4];  // S^T (group B) or dP^T (group A)

  for (int64_t i0 = j0; i0 < d.L; i0 += kT) {
    const bool first = i0 == j0;
    const float* walk = grp_b ? qb + i0 * d.q_ls : dob + i0 * ld;
    if (gtid < kT)  // lse_i (group B), di_i (group A); 0 past L
      rows_i[(grp_b ? 0 : kT) + gtid] =
          i0 + gtid < d.L ? (grp_b ? lse : di)[bh * d.L + i0 + gtid] : 0.f;
    zero_frags(f);
#pragma unroll 1
    for (int qq = 0; qq < 4; ++qq) {  // a copy group a depth quarter
      if (first)
        copy_tile<kTLd, kStep>(tile_own + qq * kStep, own + qq * kStep, ld_own, d.L - j0,
                               d.D - qq * kStep, vec, grp_b ? k : v, gtid, 128);
      copy_tile<kTLd, kStep>(tile_walk + qq * kStep, walk + qq * kStep, ld_walk, d.L - i0,
                             d.D - qq * kStep, vec, grp_b ? q : dout, gtid, 128);
      cp_async_commit();
    }
#pragma unroll 1
    for (int qq = 0; qq < 4; ++qq) {
      cp_async_wait_n(3 - qq);
      group_sync(grp_b ? 2 : 1);  // quarter qq of both tiles is in
      if (qq * kStep < d.D)
        product_nt32<kTLd>(f[0], tile_own + r0 * kTLd + qq * kStep, tile_walk + qq * kStep);
    }
    if (grp_b) {  // P^T = exp(scale S^T - lse_i) where j <= i < L, published for group A
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int lj = r0 + g + 8 * hh;
        const int64_t j = j0 + lj;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int li = 8 * n + 2 * t4 + e;
            const int64_t i = i0 + li;
            p[e] = j <= i && i < d.L ? expf(f[0][n][2 * hh + e] * d.scale - rows_i[li]) : 0.f;
          }
          *reinterpret_cast<float2*>(&pts[lj * kDLd + 8 * n + 2 * t4]) = make_float2(p[0], p[1]);
        }
      }
    }
    __syncthreads();  // P^T is published; q_i and do_i are in
    if (!grp_b) {  // dS^T = P^T (dP^T - di_i) into the warp's rows
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int lj = r0 + g + 8 * hh;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int li = 8 * n + 2 * t4;
          const float2 p = *reinterpret_cast<const float2*>(&pts[lj * kDLd + li]);
          *reinterpret_cast<float2*>(&dss[lj * kDLd + li]) =
              make_float2(p.x * (f[0][n][2 * hh] - rows_i[kT + li]),
                          p.y * (f[0][n][2 * hh + 1] - rows_i[kT + li + 1]));
        }
      }
      __syncwarp();
    }
    // the second products, one code for both groups: dv += P^T do_i (group
    // B), dk += dS^T q_i (group A), each over the i-tile's 64 rows
    const float* slice = (grp_b ? pts : dss) + r0 * kDLd;
    const float* tile = grp_b ? tdo : tq;
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      // acc[0] is the half in hand: the two swap places after each half
      if (hf * kT < d.D) product_64<kDLd, kTLd>(acc[0], slice, tile + hf * kT);  // uniform
      swap_frags(acc[0], acc[1]);
    }
    __syncthreads();  // every warp is past the i-tile's tiles and slices
  }

  const float sc = grp_b ? 1.f : d.scale;  // dk is scaled once, here
  float* out = (grp_b ? dv : dk) + (b * d.L * d.H + h) * d.D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t j = j0 + r0 + g + 8 * hh;
    if (j >= d.L) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int64_t col = hf * kT + 8 * n + 2 * t4 + e;
          if (col < d.D) out[j * ld + col] = acc[hf][n][2 * hh + e] * sc;
        }
  }
}

// -- dQ on the tensor cores ---------------------------------------------------------

// q_i, k_j, do_i and v_j, P (then dS), lse_i and di_i: 157,184 bytes
constexpr int kDqSmemFloats = 4 * kT * kTLd + kT * kDLd + 2 * kT;

// grid (B * H, ceil(L / 64)), dynamic shared memory kDqSmemFloats; block
// (b h, i-tile = last - blockIdx.y) walks the j-tiles j <= i. Warps 0-3 are
// group A (dP = do_i v_j^T, then dS = P (dP - di_i)), warps 4-7 group B (S =
// q_i k_j^T, P = exp(scale S - lse_i)); warp w of either holds rows 16 (w %
// 4) + g and + 8 of the i-tile, and columns 8n + 2t4 and + 1 of each C
// fragment (j for S and dP, D for dq). q_i and do_i land once and stay put;
// k_j and v_j land by cp.async in four depth quarters, each group copying
// the one its first product reads and waiting only for its own, at its own
// barrier. After the block's barrier group A turns the P group B published
// into dS in place; after the next, both groups add dS k_j to dq (the k_j
// group B copied), group A into columns 0-63 of D, group B into 64-127.
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_attention_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ di,
                              float* __restrict__ dq, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* tq = smem;                 // q_i [kT][kTLd]
  float* tk = tq + kT * kTLd;       // k_j
  float* tdo = tk + kT * kTLd;      // do_i
  float* tv = tdo + kT * kTLd;      // v_j
  float* ps = tv + kT * kTLd;       // P, then dS [kT][kDLd]
  float* rows_i = ps + kT * kDLd;   // [lse_i | di_i][kT]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const bool grp_b = warp >= 4;
  const int gtid = threadIdx.x % 128;
  const int r0 = 16 * (warp % 4);
  const int64_t bh = blockIdx.x, b = bh / d.H, h = bh % d.H;
  const int64_t i0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kT;
  const int64_t ld = d.H * d.D;  // row stride of the contiguous (B, L, H, D) tensors
  const bool vec =
      d.D % 4 == 0 &&
      (d.q_bs | d.q_ls | d.q_hs | d.k_bs | d.k_ls | d.k_hs | d.v_bs | d.v_ls | d.v_hs) % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout)) % 16 == 0;
  // the group's first product: rows of the i-tile (q_i or do_i) times rows of
  // the j-tile (k_j or v_j) over D
  const float* own = grp_b ? q + b * d.q_bs + h * d.q_hs + i0 * d.q_ls
                           : dout + (b * d.L * d.H + h) * d.D + i0 * ld;
  const float* walk = grp_b ? k + b * d.k_bs + h * d.k_hs : v + b * d.v_bs + h * d.v_hs;
  const int64_t ld_own = grp_b ? d.q_ls : ld, ld_walk = grp_b ? d.k_ls : d.v_ls;
  float* tile_own = grp_b ? tq : tdo;
  float* tile_walk = grp_b ? tk : tv;
  if (gtid < kT)  // lse_i (group B), di_i (group A); 0 past L
    rows_i[(grp_b ? 0 : kT) + gtid] =
        i0 + gtid < d.L ? (grp_b ? lse : di)[bh * d.L + i0 + gtid] : 0.f;

  float acc[8][4];  // dq of the thread's two rows, in the group's 64 columns of D
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
  float f[1][8][4];  // S (group B) or dP (group A)

  for (int64_t j0 = 0; j0 <= i0; j0 += kT) {
    const bool first = j0 == 0;
    zero_frags(f);
#pragma unroll 1
    for (int qq = 0; qq < 4; ++qq) {  // a copy group a depth quarter
      if (first)
        copy_tile<kTLd, kStep>(tile_own + qq * kStep, own + qq * kStep, ld_own, d.L - i0,
                               d.D - qq * kStep, vec, grp_b ? q : dout, gtid, 128);
      copy_tile<kTLd, kStep>(tile_walk + qq * kStep, walk + j0 * ld_walk + qq * kStep, ld_walk,
                             d.L - j0, d.D - qq * kStep, vec, grp_b ? k : v, gtid, 128);
      cp_async_commit();
    }
#pragma unroll 1
    for (int qq = 0; qq < 4; ++qq) {
      cp_async_wait_n(3 - qq);
      group_sync(grp_b ? 2 : 1);  // quarter qq of both tiles is in
      if (qq * kStep < d.D)
        product_nt32<kTLd>(f[0], tile_own + r0 * kTLd + qq * kStep, tile_walk + qq * kStep);
    }
    if (grp_b) {  // P = exp(scale S - lse_i) where j <= i < L, published for group A
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int li = r0 + g + 8 * hh;
        const int64_t i = i0 + li;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t j = j0 + 8 * n + 2 * t4 + e;
            p[e] = j <= i && i < d.L ? expf(f[0][n][2 * hh + e] * d.scale - rows_i[li]) : 0.f;
          }
          *reinterpret_cast<float2*>(&ps[li * kDLd + 8 * n + 2 * t4]) = make_float2(p[0], p[1]);
        }
      }
    }
    __syncthreads();  // P is published; k_j and v_j are in
    if (!grp_b) {  // dS = P (dP - di_i), in place of the warp's rows of P
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int li = r0 + g + 8 * hh;
        const float dii = rows_i[kT + li];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float2* x = reinterpret_cast<float2*>(&ps[li * kDLd + 8 * n + 2 * t4]);
          const float2 p = *x;
          *x = make_float2(p.x * (f[0][n][2 * hh] - dii), p.y * (f[0][n][2 * hh + 1] - dii));
        }
      }
    }
    __syncthreads();  // dS is in
    // the second product, one code for both groups: dq += dS k_j over the
    // j-tile's 64 rows, each group into its 64 columns of D
    if ((grp_b ? kT : 0) < d.D)  // uniform over the group
      product_64<kDLd, kTLd>(acc, ps + r0 * kDLd, tk + (grp_b ? kT : 0));
    __syncthreads();  // every warp is past the j-tile's tiles and dS
  }

  float* out = dq + (b * d.L * d.H + h) * d.D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t i = i0 + r0 + g + 8 * hh;
    if (i >= d.L) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t col = (grp_b ? kT : 0) + 8 * n + 2 * t4 + e;
        if (col < d.D) out[i * ld + col] = acc[n][2 * hh + e] * d.scale;  // scaled once, here
      }
  }
}

constexpr int64_t kMaxGridY = 65535;

int64_t tiles(int64_t n) { return (n + kT - 1) / kT; }

bool bad_shape(int64_t B, int64_t L, int64_t H, int64_t D) {
  return B < 1 || L < 1 || H < 1 || D < 1 || D > kMaxD || tiles(L) > kMaxGridY ||
         B * H > INT32_MAX;
}

dim3 grid_of(int64_t B, int64_t L, int64_t H) {
  return dim3(static_cast<unsigned int>(B * H), static_cast<unsigned int>(tiles(L)));
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a shape it does not take.
// Shapes: B, L, H >= 1, 1 <= D <= 128; strides in elements.
extern "C" int tlie_flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                                            float* o, float* lse, int64_t B, int64_t L,
                                            int64_t H, int64_t D, int64_t q_bs, int64_t q_ls,
                                            int64_t q_hs, int64_t k_bs, int64_t k_ls,
                                            int64_t k_hs, int64_t v_bs, int64_t v_ls,
                                            int64_t v_hs, float scale, void* stream) {
  if (bad_shape(B, L, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{L, H, D, q_bs, q_ls, q_hs, k_bs, k_ls, k_hs, v_bs, v_ls, v_hs, scale};
  const int smem = kFwdSmemFloats * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_fwd_kernel<<<grid_of(B, L, H), kFwdThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(q, k, v, o, lse, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tlie_flash_attention_bwd_dkv_f32(const float* q, const float* k, const float* v,
                                                const float* dout, const float* lse,
                                                const float* di, float* dk, float* dv,
                                                int64_t B, int64_t L, int64_t H, int64_t D,
                                                int64_t q_bs, int64_t q_ls, int64_t q_hs,
                                                int64_t k_bs, int64_t k_ls, int64_t k_hs,
                                                int64_t v_bs, int64_t v_ls, int64_t v_hs,
                                                float scale, void* stream) {
  if (bad_shape(B, L, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{L, H, D, q_bs, q_ls, q_hs, k_bs, k_ls, k_hs, v_bs, v_ls, v_hs, scale};
  const int smem = kDkvSmemFloats * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dkv_kernel<<<grid_of(B, L, H), kBwdThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(q, k, v, dout, lse, di,
                                                                        dk, dv, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tlie_flash_attention_bwd_dq_f32(const float* q, const float* k, const float* v,
                                               const float* dout, const float* lse,
                                               const float* di, float* dq, int64_t B, int64_t L,
                                               int64_t H, int64_t D, int64_t q_bs, int64_t q_ls,
                                               int64_t q_hs, int64_t k_bs, int64_t k_ls,
                                               int64_t k_hs, int64_t v_bs, int64_t v_ls,
                                               int64_t v_hs, float scale, void* stream) {
  if (bad_shape(B, L, H, D)) return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{L, H, D, q_bs, q_ls, q_hs, k_bs, k_ls, k_hs, v_bs, v_ls, v_hs, scale};
  const int smem = kDqSmemFloats * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_bwd_dq_kernel<<<grid_of(B, L, H), kBwdThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(q, k, v, dout, lse, di,
                                                                       dq, d);
  return static_cast<int>(cudaGetLastError());
}
