// SSD intra-chunk decay attention, float32, and its gradient:
//
//   y[bg,h,i,:] = sum_{j<=i} (C[bg,i,:] . B[bg,j,:]) * exp(cs[bg,h,i] - cs[bg,h,j]) * x[bg,h,j,:]
//
// with C and B shared by the Hg heads of a group. The (Q, Q) scores never
// reach device memory.
//
// Replaces the three TPU kernels of tlie_tpu/ops/pallas_ssd.py:
//   tlie_decay_attention_fwd_f32   <- _fwd (pallas_call at :252, body _fwd_kernel)
//   tlie_decay_attention_bwd_i_f32 <- the pallas_call at :272 (_bwd_i_kernel): dC, +dcs_i
//   tlie_decay_attention_bwd_j_f32 <- the pallas_call at :293 (_bwd_j_kernel): dB, dx, -dcs_j
// What they compute is carried over, not their blocks.
//
// Layout. C and B are (BG, Q, N) with the last dimension contiguous and any
// batch and row strides (the port slices them out of the conv output without
// a copy). cs is (BG, Hg, Q); x, y, dy and dx are (BG, Hg, Q, P); dC and dB
// are (BG, Q, N); dcs_i and dcs_j are (BG, Hg, Q). All of those contiguous.
//
// Bound on the H100: operations. At the MQAR Mamba-2 shape (BG 64, Q 512,
// N 128, Hg 1, P 128) the causal pairs are 64 * 512 * 513 / 2 = 8.4 M; the
// forward does two products over them (C.B over N, S @ x over P), 4.3 GFLOP,
// against 67 MB of operands, 0.020 ms at 3.35 TB/s. bwd_i does three
// products and bwd_j four. The forward and bwd_j run on the tensor cores, as
// three TF32 products for each product at 495 TFLOP/s: 0.026 and 0.052 ms;
// bwd_i runs float32 outside them, 0.096 ms at 67 TFLOP/s.
//
// Every kernel: each output element has one writer, so there are no atomics
// and every launch is deterministic. Entries above the diagonal are never
// multiplied by an exp: the decay is only evaluated where j <= i < Q, and the
// rows and columns past Q (a ragged last tile) are loaded as 0 and not
// stored. The decay is exp(cs_i - cs_j), never exp(cs_i) * exp(-cs_j): |cs|
// reaches hundreds at Q = 512. The tiles whose blocks walk the most (the last
// i-tiles forward, the first j-tiles in bwd_j) launch first.
//
// The forward and bwd_j, on the tensor cores (mma.sync m16n8k8 on TF32,
// float32 accumulators, each product as three TF32 products of a split
// operand: tf32_mma.cuh). No tensor-core sum runs deeper than kFresh = 8
// (one m16n8k8 step) before a float32 add; the operands land in
// shared-memory steps of 32 over N or P, one tile's 64 over i or j. The
// columns of y and dx are cut into slabs of 128: two heads where P <= 64
// (one 64-column half each), else a 128-wide slice of one head's P; at the
// MQAR shape one slab holds them all.
//
//   forward: block (bg, slab, i-tile) of 4 warps, each warp 16 whole rows of
//            i. For each j-tile j <= i: S = C_i B_j^T over N, in depth steps
//            of 32 that land by cp.async in a two-stage ring (the next step,
//            and at a tile's end the next tile's first, lands while this one
//            is multiplied); x_j lands while S is formed; S times the head's
//            decay on the C fragments, through the warp's slice of shared
//            memory (in the ring stage the last step used) into the A layout;
//            y += S x_j over the tile's 64 j.
//            C_i B_j^T is formed once per tile pair and slab: once at the
//            MQAR shape, ceil(Hg / 2) times where P <= 64 (4 at the WikiText
//            Mamba-2 shape, Hg 8, P 64), Hg * ceil(P / 128) times where P > 64.
//            mma.sync per tile pair at the MQAR shape: 2 products x 4 warps
//            x 8 fragments of 8 columns x 16 depth steps of 8 x 3 = 3,072.
//   bwd_j:   block (bg, j-tile, s) of 8 warps in two groups of 4, each warp
//            16 whole rows of j, walking the i-tiles i >= j. Group B forms
//            CB^T = B_j C_i^T over N (and publishes it in shared memory),
//            then per head of slab s S^T = CB^T * decay^T into its warps'
//            slices and dx += S^T dy_i. Group A forms dS^T = x_j dy_i^T over
//            P for every head, Dh = dS^T * decay^T, dcs_j -= rowsum(Dh *
//            CB^T) on the CUDA cores (block s = 0 only) and dCB^T += Dh in
//            its warps' slices, then dB += dCB^T C_i for the N-slice
//            [128 s, 128 s + 128). At the MQAR shape that forms each of the
//            four products once per tile pair, two in each group: 4 x 4 warps
//            x 8 x 16 x 3 = 6,144 mma.sync. There are max(ceil(N / 128),
//            slabs) blocks per (bg, j-tile); where that is more than one, CB^T
//            is formed once per slab and each head's dS^T once per N-slice (4
//            and 4 times at the WikiText Mamba-2 shape). Why two groups: dB
//            (64 x N) and dx (64 x P) take 64 floats a lane each at N = P =
//            128, and one group of 4 warps cannot hold both beside CB^T and a
//            fresh sum. The step's tiles (64 x 128) land by cp.async in four
//            depth quarters; a group waits only for its own, at its own
//            barrier. B_j stays put across the i-tiles where N <= 128, x_j
//            where Hg * ceil(P / 128) = 1; group A's dB then reads the C_i
//            group B copied, and group B's dx the dy_i group A copied. Both
//            groups run one code for their first product and one for their
//            second, with their own operands: with a copy of each product
//            for each group and the quarters unrolled (1,536 HMMA
//            instructions of SASS against 288) the kernel took 0.496 ms
//            against 0.279 at the MQAR shape, in one call on an H100 80GB
//            HBM3 at 700 W (PERF.md).
//
// ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.8): the forward 222 registers,
// 75,776 bytes of dynamic shared memory, two blocks an SM; bwd_j 254
// registers, 194,560 bytes, one block of 8 warps an SM; no spills.
//
// bwd_i: float32 SIMT tile products on shared memory. A block of 256 threads
// owns a 64 x 64 output tile, each thread a 4 x 4 piece of it: block (bg,
// i-tile, N-slice) walks heads, and for each the j-tiles j <= i: dS = dy_i .
// x_j over P, times the decay, then times B_j into the dC accumulator (dC
// sums over heads). The blocks of the first N-slice also form C_i . B_j and
// sum dS * decay * CB over j: dcs_i, one row per head. Its 64-wide tiles keep
// four shared tiles in 43.5 KB of static shared memory whatever N, P and Hg
// are.

#include <cuda_runtime.h>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, each a 4 x 4 piece
constexpr int kT = 64;         // tile edge: rows of i, j, N and P
constexpr int kK = 16;         // depth of one shared-memory step of a C.B or dy.x tile
constexpr int kPad = 4;        // row padding of the shared tiles (keeps float4 alignment)
static_assert(kT * kK % kThreads == 0 && kT * kT % kThreads == 0,
              "tile loads split evenly over the threads");
static_assert(kT == 4 * 16 && kThreads == 16 * 16, "16 x 16 threads of 4 x 4 pieces");

struct Smem {
  __align__(16) float a[kK][kT + kPad];  // depth-major step of the first operand
  __align__(16) float b[kK][kT + kPad];  // depth-major step of the second operand
  __align__(16) float s[kT][kT + kPad];  // scaled scores, s[k][row] for the second product
  __align__(16) float v[kT][kT + kPad];  // value tile, v[k][col]
  float cs_own[kT];                       // cs of the block's own rows
  float cs_other[kT];                     // cs of the walked tile
};

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
}

// acc[r][c] = sum_k A[4ty + r][k] * Bm[4tx + c][k] over k < K, where A and Bm
// point at the first row of their 64-row tiles, rows are lda / ldb apart,
// depth is contiguous, and rows at or past a_rows / b_rows read as 0.
// Starts and ends with every thread past its last use of sm.a and sm.b.
__device__ __forceinline__ void tile_nt(const float* __restrict__ A, int64_t a_rows, int64_t lda,
                                        const float* __restrict__ Bm, int64_t b_rows,
                                        int64_t ldb, int64_t K, Smem& sm, float acc[4][4]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  zero(acc);
  for (int64_t k0 = 0; k0 < K; k0 += kK) {
    // 16 neighbouring threads read 16 neighbouring floats of one row
#pragma unroll
    for (int it = 0; it < kT * kK / kThreads; ++it) {
      const int e = tid + it * kThreads, r = e / kK, c = e % kK;
      const int64_t k = k0 + c;
      sm.a[c][r] = (r < a_rows && k < K) ? A[r * lda + k] : 0.f;
      sm.b[c][r] = (r < b_rows && k < K) ? Bm[r * ldb + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kK; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.a[c][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sm.b[c][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }
}

// sm.v[r][c] = V[r * ldv + c] for r < rows, c < cols, else 0.
__device__ __forceinline__ void load_values(const float* __restrict__ V, int64_t rows,
                                            int64_t cols, int64_t ldv, Smem& sm) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int it = 0; it < kT * kT / kThreads; ++it) {
    const int e = tid + it * kThreads, r = e / kT, c = e % kT;
    sm.v[r][c] = (r < rows && c < cols) ? V[r * ldv + c] : 0.f;
  }
}

// cs of up to 64 rows into dst (0 past `rows`).
__device__ __forceinline__ void load_cs(const float* __restrict__ cs, int64_t rows, float* dst) {
  const int tid = threadIdx.x;
  if (tid < kT) dst[tid] = tid < rows ? cs[tid] : 0.f;
}

// acc[r][c] += sum_k sm.s[k][4ty + r] * sm.v[k][4tx + c]: the second product,
// after a __syncthreads() that published sm.s and sm.v.
__device__ __forceinline__ void tile_sv(const Smem& sm, float acc[4][4]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll 8
  for (int k = 0; k < kT; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&sm.s[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&sm.v[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
  }
}

// Row sums of the 16 threads that share ty (16 neighbouring lanes of a warp).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Store the thread's 4 x 4 piece at rows row0 + 4ty + r, columns col0 + 4tx + c.
__device__ __forceinline__ void store_tile(float* __restrict__ out, int64_t row0, int64_t rows,
                                           int64_t col0, int64_t cols, int64_t ld,
                                           const float acc[4][4]) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t row = row0 + ty * 4 + r;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t col = col0 + tx * 4 + c;
      if (col < cols) out[row * ld + col] = acc[r][c];
    }
  }
}

struct Dims {
  int64_t Q, N, Hg, P;
  int64_t c_bs, c_ld, b_bs, b_ld;  // batch and row strides of C and B, in elements
};

// grid (BG, ceil(N / 64), ceil(Q / 64))
__global__ void __launch_bounds__(kThreads)
decay_attention_bwd_i_kernel(const float* __restrict__ C, const float* __restrict__ B,
                             const float* __restrict__ cs, const float* __restrict__ x,
                             const float* __restrict__ dy, float* __restrict__ dC,
                             float* __restrict__ dcs_i, Dims d) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t bg = blockIdx.x;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * kT;
  const int64_t i0 = static_cast<int64_t>(blockIdx.z) * kT;
  const bool first_slice = blockIdx.y == 0;  // uniform over the block
  const float* Cb = C + bg * d.c_bs;
  const float* Bb = B + bg * d.b_bs;

  float acc[4][4], ds[4][4], cb[4][4];
  zero(acc);
  zero(cb);
  for (int64_t h = 0; h < d.Hg; ++h) {
    const int64_t bgh = bg * d.Hg + h;
    const float* csh = cs + bgh * d.Q;
    const float* xh = x + bgh * d.Q * d.P;
    const float* dyh = dy + bgh * d.Q * d.P;
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    load_cs(csh + i0, d.Q - i0, sm.cs_own);
    for (int64_t j0 = 0; j0 <= i0; j0 += kT) {
      load_cs(csh + j0, d.Q - j0, sm.cs_other);
      tile_nt(dyh + i0 * d.P, d.Q - i0, d.P, xh + j0 * d.P, d.Q - j0, d.P, d.P, sm, ds);
      if (first_slice)
        tile_nt(Cb + i0 * d.c_ld, d.Q - i0, d.c_ld, Bb + j0 * d.b_ld, d.Q - j0, d.b_ld, d.N,
                sm, cb);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int li = ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int lj = tx * 4 + c;
          const int64_t i = i0 + li, j = j0 + lj;
          float dsd = 0.f;
          if (j <= i && i < d.Q) dsd = ds[r][c] * expf(sm.cs_own[li] - sm.cs_other[lj]);
          part[r] = fmaf(dsd, cb[r][c], part[r]);
          sm.s[lj][li] = dsd;
        }
      }
      load_values(Bb + j0 * d.b_ld + n0, d.Q - j0, d.N - n0, d.b_ld, sm);
      __syncthreads();
      tile_sv(sm, acc);
      __syncthreads();
    }
    if (first_slice) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float total = sum16(part[r]);
        const int64_t i = i0 + ty * 4 + r;
        if (tx == 0 && i < d.Q) dcs_i[bgh * d.Q + i] = total;
      }
    }
  }
  store_tile(dC + bg * d.Q * d.N, i0, d.Q, n0, d.N, d.N, acc);
}

// -- the forward and bwd_j on the tensor cores -------------------------------------

constexpr int kSK = 32;  // depth of one shared-memory step of a product over N or P
// depth of one fresh tensor-core sum (three chained HMMAs a fragment) before
// its float32 add. The tensor cores truncate their sums: where a fresh sum
// ran 32 deep (64 in the second products) the small products met a large
// accumulator, and the bias toward zero that left summed, not averaged, over
// the 32,768 positions of the MQAR Mamba-2's dt_bias gradient (card against
// CPU: 0.832 of its tolerance, against 0.066 at 8 and 0.040 with the float32
// SIMT kernels). The loops over fresh sums stay rolled: unrolled at 8 deep
// they spill.
constexpr int kFresh = 8;
constexpr int kW = 128;  // columns of a slab of y or dx, and of a bwd_j operand tile

// The heads and columns of P that the two 64-column halves of a slab hold.
struct Slab {
  int64_t head[2], off[2];  // head, and its first column of P
  int cols[2];              // columns inside P (0: the half holds nothing)
  // by a half that is not known at compile time, without an indexed load
  __device__ int64_t head_of(int hf) const { return hf ? head[1] : head[0]; }
  __device__ int cols_of(int hf) const { return hf ? cols[1] : cols[0]; }
};

__host__ __device__ __forceinline__ int64_t slab_count(int64_t Hg, int64_t P) {
  return P <= kT ? (Hg + 1) / 2 : Hg * ((P + kW - 1) / kW);
}

__device__ __forceinline__ Slab slab_of(int64_t s, const Dims& d) {
  Slab sl;
  const int64_t ps = (d.P + kW - 1) / kW;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    sl.head[hf] = d.P <= kT ? 2 * s + hf : s / ps;
    sl.off[hf] = d.P <= kT ? 0 : s % ps * kW + hf * kT;
    const int64_t c = d.P - sl.off[hf];
    sl.cols[hf] = sl.head[hf] < d.Hg && c > 0 ? static_cast<int>(c < kT ? c : kT) : 0;
  }
  return sl;
}

// Starts copying rows [0, 64) and columns [0, kWidth) of a tile whose first
// row is `src` (rows ld apart) into dst (rows kLd apart), zero where the row
// is at or past `rows` or the column at or past `cols`, spread over n threads
// of which this is `tid`. 16 bytes a copy where `vec` (cols, the strides and
// the base all multiples of 4 floats), else 4. A zero-filled copy is handed
// `safe`, the tensor's first element, so no copy gets an address outside it.
template <int kLd, int kWidth>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, int64_t ld, int64_t rows,
                                          int64_t cols, bool vec, const float* safe, int tid,
                                          int n) {
  if (vec) {
    for (int e = tid; e < kT * kWidth / 4; e += n) {
      const int r = e / (kWidth / 4), c = 4 * (e % (kWidth / 4));
      const bool in = r < rows && c < cols;
      cp_async(dst + r * kLd + c, in ? src + r * ld + c : safe, in, 16);
    }
  } else {
    for (int e = tid; e < kT * kWidth; e += n) {
      const int r = e / kWidth, c = e % kWidth;
      const bool in = r < rows && c < cols;
      cp_async(dst + r * kLd + c, in ? src + r * ld + c : safe, in, 4);
    }
  }
}

// Waits until at most n (0 to 3) of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>();
  }
}

// The barrier of one group of 128 threads (ids 1 and 2; __syncthreads is 0).
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void zero_frags(float (&c)[1][8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[0][n][r] = 0.f;
}

__device__ __forceinline__ void add_frags(float (&acc)[8][4], const float (&c)[1][8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] += c[0][n][r];
}

// acc += the warp's 16 rows of A times a 64-deep tile V (64 x 8 columns),
// kFresh deep at a time into a fresh sum that is then added in float32, the
// depth in natural order (a lane's slots t and t + 4 take depth t and
// t + 4): A's rows kALd apart at `a` (float reads at (4g + t) where kALd is 4
// modulo 32), V's rows kVLd apart at `v` (float reads at (8t + g) where kVLd
// is 8 modulo 32). The second products of bwd_j.
template <int kALd, int kVLd>
__device__ __forceinline__ void product_64(float (&acc)[8][4], const float* a, const float* v) {
#pragma unroll 1
  for (int k0 = 0; k0 < kT; k0 += kFresh) {
    float c[1][8][4];
    zero_frags(c);
#pragma unroll
    for (int kk = k0; kk < k0 + kFresh; kk += 8)
      mma_step_3xtf32<1, 8>(
          c,
          [&](int mm, int t) {
            const float* row = a + mm * kALd + kk + t;
            return make_float2(row[0], row[4]);
          },
          [&](int n, int t) {
            const float* col = v + (kk + t) * kVLd + n;
            return make_float2(col[0], col[4 * kVLd]);
          });
    add_frags(acc, c);
  }
}

// acc += 32 deep of the warp's 16 rows of A times the 64 rows of Bm
// (A Bm^T), kFresh deep at a time as above, both row-major, rows kLd apart,
// read as float2 at the depth pairs (2t, 2t + 1) (every bank once where kLd
// is 8 modulo 32).
template <int kLd>
__device__ __forceinline__ void product_nt32(float (&acc)[8][4], const float* a, const float* bm) {
#pragma unroll 1
  for (int k0 = 0; k0 < kSK; k0 += kFresh) {
    float c[1][8][4];
    zero_frags(c);
#pragma unroll
    for (int kk = k0; kk < k0 + kFresh; kk += 8)
      mma_step_3xtf32<1, 8>(
          c,
          [&](int mm, int t) {
            return *reinterpret_cast<const float2*>(a + mm * kLd + kk + 2 * t);
          },
          [&](int n, int t) {
            return *reinterpret_cast<const float2*>(bm + n * kLd + kk + 2 * t);
          });
    add_frags(acc, c);
  }
}

__device__ __forceinline__ void swap_frags(float (&a)[8][4], float (&b)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float t = a[n][r];
      a[n][r] = b[n][r];
      b[n][r] = t;
    }
}

constexpr int kFwdThreads = 128;  // 4 warps, each 16 whole rows of the block's 64
// Row strides of the forward's shared tiles, in floats: float2 reads at
// (8g + 2t) hit every bank once where the stride is 8 modulo 32 (the C and B
// steps, S), float reads at (8t + g) where it is 4 (x_j).
constexpr int kStepLd = kSK + 8;
constexpr int kStepFloats = 2 * kT * kStepLd;  // a ring stage: C_i's and B_j's rows of a step
constexpr int kSLd = kT + 8;
constexpr int kXLd = kW + 4;
// the two ring stages, x_j, and cs of the block's rows and of the walked
// rows for each half: 75,776 bytes
constexpr int kFwdSmemFloats = 2 * kStepFloats + kT * kXLd + 4 * kT;
static_assert(kT * kSLd <= kStepFloats, "the warps' S slices fit in one ring stage");
static_assert((kFwdThreads / 32) * 16 == kT, "4 warps of 16 rows");

// grid (BG * slabs, ceil(Q / 64)), dynamic shared memory kFwdSmemFloats;
// i-tile = last - blockIdx.y. Warp w owns rows 16w.. of the i-tile; lane
// (g, t4) holds rows 16w + g and 16w + g + 8 of each C fragment, columns
// 8n + 2t4 and 8n + 2t4 + 1. The walk is a sequence of depth steps, nk to a
// j-tile; step q lands in ring stage q % 2 while step q - 1 is multiplied.
__global__ void __launch_bounds__(kFwdThreads, 2)
decay_attention_fwd_kernel(const float* __restrict__ C, const float* __restrict__ B,
                           const float* __restrict__ cs, const float* __restrict__ x,
                           float* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                  // [2][C_i rows | B_j rows of a depth step]
  float* xs = ring + 2 * kStepFloats;  // [kT][kXLd]: x_j, a 64-column half for each half
  float* cs_i = xs + kT * kXLd;        // [2][kT]: cs of the block's rows, by half
  float* cs_j = cs_i + 2 * kT;         // [2][kT]: cs of the walked tile's rows, by half
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = 16 * warp;
  const int64_t n_slabs = slab_count(d.Hg, d.P);
  const int64_t bg = blockIdx.x / n_slabs;
  const Slab sl = slab_of(blockIdx.x % n_slabs, d);
  const bool two = d.P <= kT;  // the halves are two heads, each with its own S
  const int64_t i0 = static_cast<int64_t>(gridDim.y - 1 - blockIdx.y) * kT;
  const float* Ci = C + bg * d.c_bs + i0 * d.c_ld;
  const float* Bb = B + bg * d.b_bs;
  const bool vec_cb = (d.N | d.c_bs | d.c_ld | d.b_bs | d.b_ld) % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(B)) % 16 == 0;
  const bool vec_x = d.P % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int nk = static_cast<int>((d.N + kSK - 1) / kSK);
  const int n_j = static_cast<int>(i0 / kT) + 1;
  const int total = n_j * nk;

  auto start_step = [&](int q) {
    const int64_t j0 = static_cast<int64_t>(q / nk) * kT;
    const int64_t k0 = static_cast<int64_t>(q % nk) * kSK;
    float* st = ring + (q & 1) * kStepFloats;
    copy_tile<kStepLd, kSK>(st, Ci + k0, d.c_ld, d.Q - i0, d.N - k0, vec_cb, C, tid,
                            kFwdThreads);
    copy_tile<kStepLd, kSK>(st + kT * kStepLd, Bb + j0 * d.b_ld + k0, d.b_ld, d.Q - j0,
                            d.N - k0, vec_cb, B, tid, kFwdThreads);
    cp_async_commit();
  };
  // cs of up to 64 rows from row0 of each half's head (0 past Q or Hg)
  auto load_cs_halves = [&](int64_t row0, float* dst) {
    if (tid < 2 * kT) {
      const int hf = tid / kT, r = tid % kT;
      dst[tid] = sl.cols_of(hf) > 0 && row0 + r < d.Q
                     ? cs[(bg * d.Hg + sl.head_of(hf)) * d.Q + row0 + r] : 0.f;
    }
  };

  float acc[2][8][4];  // y of the thread's two rows, by half
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[hf][n][r] = 0.f;

  load_cs_halves(i0, cs_i);
  start_step(0);
  for (int jt = 0; jt < n_j; ++jt) {
    const int64_t j0 = static_cast<int64_t>(jt) * kT;
    float s[1][8][4];
    zero_frags(s);
    for (int kq = 0; kq < nk; ++kq) {
      const int q = jt * nk + kq;
      // at kq == 1 the newest group in flight is x_j's, not needed yet
      if (kq == 1) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();  // step q is in; every warp is past step q - 1 and the last tile's S x
      if (q + 1 < total) start_step(q + 1);
      if (kq == 0) {  // x_j and its cs
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (sl.cols[hf] > 0)
            copy_tile<kXLd, kT>(xs + hf * kT,
                                x + ((bg * d.Hg + sl.head[hf]) * d.Q + j0) * d.P + sl.off[hf],
                                d.P, d.Q - j0, sl.cols[hf], vec_x, x, tid, kFwdThreads);
        cp_async_commit();
        load_cs_halves(j0, cs_j);
      }
      const float* st = ring + (q & 1) * kStepFloats;
      product_nt32<kStepLd>(s[0], st + r0 * kStepLd, st + kT * kStepLd);
    }
    const int q_last = jt * nk + nk - 1;
    __syncthreads();  // every warp is past its reads of the last step: its stage takes the S slices
    float* ss = ring + (q_last & 1) * kStepFloats + r0 * kSLd;  // the warp's S slice
    // S times the decay of half hf's head, into the slice; exp only where j <= i < Q
    auto write_s = [&](int hf) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int li = r0 + g + 8 * hh;
        const int64_t i = i0 + li;
        const float ci = cs_i[hf * kT + li];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int lj = 8 * n + 2 * t4 + e;
            v[e] = j0 + lj <= i && i < d.Q ? s[0][n][2 * hh + e] * expf(ci - cs_j[hf * kT + lj])
                                          : 0.f;
          }
          *reinterpret_cast<float2*>(&ss[(g + 8 * hh) * kSLd + 8 * n + 2 * t4]) =
              make_float2(v[0], v[1]);
        }
      }
    };
    write_s(0);
    // x_j is in once at most the next tile's first step is in flight
    if (nk >= 2 && q_last + 1 < total) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();  // x_j and every warp's S slice are in
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (sl.cols[hf] == 0) continue;  // uniform over the block
      if (hf == 1 && two) {  // the second head's S, in place of the first's
        __syncwarp();
        write_s(1);
        __syncwarp();
      }
#pragma unroll 1
      for (int k0 = 0; k0 < kT; k0 += kFresh) {
        float c[1][8][4];
        zero_frags(c);
#pragma unroll
        for (int kk = k0; kk < k0 + kFresh; kk += 8)
          mma_step_3xtf32<1, 8>(
              c,
              [&](int mm, int t) {
                return *reinterpret_cast<const float2*>(&ss[mm * kSLd + kk + 2 * t]);
              },
              [&](int n, int t) {
                const float* col = xs + (kk + 2 * t) * kXLd + hf * kT + n;
                return make_float2(col[0], col[kXLd]);
              });
        add_frags(acc[hf], c);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t i = i0 + r0 + g + 8 * hh;
    if (i >= d.Q) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (sl.cols[hf] == 0) continue;
      float* yr = y + ((bg * d.Hg + sl.head[hf]) * d.Q + i) * d.P + sl.off[hf];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t4 + e;
          if (col < sl.cols[hf]) yr[col] = acc[hf][n][2 * hh + e];
        }
    }
  }
}

constexpr int kBwdThreads = 256;  // two groups of 4 warps, each warp 16 whole rows of the j-tile
// Row strides of bwd_j's shared tiles, in floats. The operand tiles are read
// as float2 at (8g + 2t) along their rows in the first products and as float
// at (8t + g) down their columns in the second: 8 modulo 32 serves both. The
// Dh and S^T slices are read at (4g + t) in the A layout: 4 modulo 32. CB^T is
// read back at the C-layout positions it was written: 8.
constexpr int kTLd = kW + 8;
constexpr int kDLd = kT + 4;
constexpr int kCBLd = kT + 8;
// B_j, C_i, x_j and dy_i, CB^T, the Dh and S^T slices, and cs: 194,560 bytes
constexpr int kBwdSmemFloats = 4 * kT * kTLd + kT * kCBLd + 2 * kT * kDLd + 8 * kT;

// grid (BG, max(ceil(N / 128), slabs), ceil(Q / 64)), dynamic shared memory
// kBwdSmemFloats; block (bg, s, j-tile). Warps 0-3 are group A (dB's N-slice
// s, and dcs_j where s = 0), warps 4-7 group B (dx of slab s); warp w of
// either holds rows 16 (w % 4) + g and + 8 of the j-tile, and columns
// 8n + 2t4 and + 1 of each C fragment (i for CB^T and dS^T, N or P for the
// accumulators). Each i-tile is a sequence of steps: group B forms CB^T over
// the ceil(N / 128) 128-wide chunks of N, group A each head's dS^T over the
// ceil(P / 128) chunks of P (starting late enough that CB^T is published
// before it needs it for dcs_j); then each group's second product.
__global__ void __launch_bounds__(kBwdThreads, 1)
decay_attention_bwd_j_kernel(const float* __restrict__ C, const float* __restrict__ B,
                             const float* __restrict__ cs, const float* __restrict__ x,
                             const float* __restrict__ dy, float* __restrict__ dB,
                             float* __restrict__ dx, float* __restrict__ dcs_j, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* tb = smem;              // B_j: a 128-wide chunk of N
  float* tc = tb + kT * kTLd;    // C_i: the same chunk; group A's N-slice for dB
  float* tx = tc + kT * kTLd;    // x_j of a head: a 128-wide chunk of P
  float* ty = tx + kT * kTLd;    // dy_i of the same; slab s for dx
  float* cbs = ty + kT * kTLd;   // CB^T [kT][kCBLd]
  float* dhs = cbs + kT * kCBLd; // dCB^T = sum over heads of Dh [kT][kDLd] (group A)
  float* sts = dhs + kT * kDLd;  // S^T of a head [kT][kDLd] (group B)
  float* cs_a = sts + kT * kDLd; // [head parity][j, i][kT] (group A)
  float* cs_b = cs_a + 4 * kT;   // [half][j, i][kT] (group B)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const bool grp_b = warp >= 4;
  const int gtid = threadIdx.x % 128;
  const int r0 = 16 * (warp % 4);
  const int64_t bg = blockIdx.x, s = blockIdx.y;
  const int64_t j0 = static_cast<int64_t>(blockIdx.z) * kT;
  const int64_t nN = (d.N + kW - 1) / kW, nP = (d.P + kW - 1) / kW;
  const int64_t n_slabs = slab_count(d.Hg, d.P);
  const Slab sl = slab_of(s < n_slabs ? s : 0, d);
  const bool two = d.P <= kT;
  const bool a_on = s < nN, b_on = s < n_slabs;
  const int64_t a_steps = d.Hg * nP;
  // group A's first step: where it needs CB^T (s = 0), its first head ends no
  // earlier than group B's last chunk
  const int64_t a0 = s == 0 && nN > nP ? nN - nP : 0;
  const int64_t b_steps = b_on ? nN : 0, a_end = a_on ? a0 + a_steps : 0;
  const int64_t n_steps = b_steps > a_end ? b_steps : a_end;
  // B_j, and x_j, stay put across the i-tiles; then the C_i and dy_i of the
  // step are also the second products' operands
  const bool one_n = nN == 1, one_p = a_steps == 1;
  const float* Cb = C + bg * d.c_bs;
  const float* Bj = B + bg * d.b_bs + j0 * d.b_ld;
  const float* xb = x + bg * d.Hg * d.Q * d.P;
  const float* dyb = dy + bg * d.Hg * d.Q * d.P;
  const bool vec_cb = (d.N | d.c_bs | d.c_ld | d.b_bs | d.b_ld) % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(B)) % 16 == 0;
  const bool vec_p = d.P % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16 == 0;

  float acc[2][8][4];  // dB (group A) or dx (group B) of the thread's two rows, by half
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[hf][n][r] = 0.f;
  float f[1][8][4];  // CB^T (group B), or dS^T of the current head (group A)
  float dcs_prev[2] = {0.f, 0.f};  // dcs_j so far of the head's rows (group A, block s = 0)

  for (int64_t i0 = j0; i0 < d.Q; i0 += kT) {
    const bool first = i0 == j0;
    const float* Ci = Cb + i0 * d.c_ld;
    if (grp_b && b_on) {  // cs of the slab's heads, rows j and i
      for (int e = gtid; e < 4 * kT; e += 128) {
        const int hf = e / (2 * kT), r = e % kT;
        const int64_t row = (e / kT % 2 ? i0 : j0) + r;
        cs_b[e] = sl.cols_of(hf) > 0 && row < d.Q
                      ? cs[(bg * d.Hg + sl.head_of(hf)) * d.Q + row] : 0.f;
      }
    }
    for (int64_t k = 0; k < n_steps; ++k) {
      const bool b_step = grp_b && b_on && k < nN;
      const bool a_step = !grp_b && a_on && k >= a0 && k < a0 + a_steps;
      const int64_t h = a_step ? (k - a0) / nP : 0, p0 = a_step ? (k - a0) % nP * kW : 0;
      if (b_step || a_step) {
        // the group's product of the step, one code for both: rows of the
        // j-tile (B_j or x_j of head h) times rows of the i-tile (C_i or
        // dy_i of head h) over the chunk [c0, c0 + 128) of N or P
        const int64_t c0 = b_step ? k * kW : p0, depth = b_step ? d.N : d.P;
        const float* src_j = b_step ? Bj : xb + (h * d.Q + j0) * d.P;
        const float* src_i = b_step ? Ci : dyb + (h * d.Q + i0) * d.P;
        const int64_t ld_j = b_step ? d.b_ld : d.P, ld_i = b_step ? d.c_ld : d.P;
        float* tile_j = b_step ? tb : tx;
        float* tile_i = b_step ? tc : ty;
        const bool vec = b_step ? vec_cb : vec_p;
        const bool copy_j = !(b_step ? one_n : one_p) || first;
        if (b_step ? k == 0 : p0 == 0) zero_frags(f);
        if (a_step && p0 == 0) {  // head h's cs; its dcs_j so far, in flight meanwhile
          float* csh = cs_a + (h & 1) * 2 * kT;
          const int64_t row = (gtid / kT ? i0 : j0) + gtid % kT;
          csh[gtid] = row < d.Q ? cs[(bg * d.Hg + h) * d.Q + row] : 0.f;
          if (s == 0 && !first && t4 == 0) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int64_t j = j0 + r0 + g + 8 * hh;
              dcs_prev[hh] = j < d.Q ? dcs_j[(bg * d.Hg + h) * d.Q + j] : 0.f;
            }
          }
        }
#pragma unroll 1
        for (int q = 0; q < 4; ++q) {  // a copy group a depth quarter
          const int64_t cq = c0 + q * kSK;
          if (copy_j)
            copy_tile<kTLd, kSK>(tile_j + q * kSK, src_j + cq, ld_j, d.Q - j0, depth - cq, vec,
                                 b_step ? B : x, gtid, 128);
          copy_tile<kTLd, kSK>(tile_i + q * kSK, src_i + cq, ld_i, d.Q - i0, depth - cq, vec,
                               b_step ? C : dy, gtid, 128);
          cp_async_commit();
        }
#pragma unroll 1
        for (int q = 0; q < 4; ++q) {
          cp_async_wait_n(3 - q);
          group_sync(grp_b ? 2 : 1);  // quarter q of both tiles is in
          if (c0 + q * kSK < depth)
            product_nt32<kTLd>(f[0], tile_j + r0 * kTLd + q * kSK, tile_i + q * kSK);
        }
        if (b_step && k == nN - 1) {  // publish CB^T for group A's dcs_j
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int n = 0; n < 8; ++n)
              *reinterpret_cast<float2*>(&cbs[(r0 + g + 8 * hh) * kCBLd + 8 * n + 2 * t4]) =
                  make_float2(f[0][n][2 * hh], f[0][n][2 * hh + 1]);
        }
      }
      __syncthreads();  // the step's tiles are free again; CB^T is published
      if (a_step && p0 + kW >= d.P) {  // head h's dS^T is whole: Dh, dcs_j, dCB^T
        const float* csh = cs_a + (h & 1) * 2 * kT;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int lj = r0 + g + 8 * hh;
          const int64_t j = j0 + lj;
          const float cj = csh[lj];
          float part = 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            float dh[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int li = 8 * n + 2 * t4 + e;
              const int64_t i = i0 + li;
              dh[e] = j <= i && i < d.Q ? f[0][n][2 * hh + e] * expf(csh[kT + li] - cj) : 0.f;
            }
            if (s == 0) {
              const float2 cb =
                  *reinterpret_cast<const float2*>(&cbs[lj * kCBLd + 8 * n + 2 * t4]);
              part = fmaf(dh[0], cb.x, part);
              part = fmaf(dh[1], cb.y, part);
            }
            float2* o = reinterpret_cast<float2*>(&dhs[lj * kDLd + 8 * n + 2 * t4]);
            if (h == 0) {
              *o = make_float2(dh[0], dh[1]);
            } else {
              const float2 prev = *o;
              *o = make_float2(prev.x + dh[0], prev.y + dh[1]);
            }
          }
          if (s == 0) {
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            if (t4 == 0 && j < d.Q) dcs_j[(bg * d.Hg + h) * d.Q + j] = dcs_prev[hh] - part;
          }
        }
      }
    }

    // the second products, one code for both groups: dB += dCB^T C_i over
    // the N-slice [128 s, 128 s + 128) (group A), dx += S^T dy_i for the
    // slab's heads (group B), each over the i-tile's 64 rows
    if (grp_b ? b_on : a_on) {
      if (!grp_b && !one_n) {  // C_i's N-slice s
#pragma unroll 1
        for (int q = 0; q < 4; ++q)
          copy_tile<kTLd, kSK>(tc + q * kSK, Ci + s * kW + q * kSK, d.c_ld, d.Q - i0,
                               d.N - s * kW - q * kSK, vec_cb, C, gtid, 128);
        cp_async_commit();
      } else if (grp_b && !one_p) {  // dy_i of the slab
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (sl.cols[hf] > 0)
            copy_tile<kTLd, kT>(ty + hf * kT,
                                dyb + (sl.head[hf] * d.Q + i0) * d.P + sl.off[hf], d.P,
                                d.Q - i0, sl.cols[hf], vec_p, dy, gtid, 128);
        cp_async_commit();
      }
      cp_async_wait<0>();
      group_sync(grp_b ? 2 : 1);  // the tile and every warp's dCB^T are in
      const float* slice = (grp_b ? sts : dhs) + r0 * kDLd;
      const float* tile = grp_b ? ty : tc;
#pragma unroll 1
      for (int hf = 0; hf < 2; ++hf) {
        // acc[0] is the half in hand: the two swap places after each half
        if (grp_b ? sl.cols_of(hf) > 0 : s * kW + hf * kT < d.N) {  // uniform
          if (grp_b && (hf == 0 || two)) {  // S^T of the half's head into the warp's slice
            __syncwarp();
            const float* ch = cs_b + hf * 2 * kT;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int lj = r0 + g + 8 * hh;
              const int64_t j = j0 + lj;
              const float cj = ch[lj];
#pragma unroll
              for (int n = 0; n < 8; ++n) {
                float v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int li = 8 * n + 2 * t4 + e;
                  const int64_t i = i0 + li;
                  v[e] = j <= i && i < d.Q ? f[0][n][2 * hh + e] * expf(ch[kT + li] - cj)
                                           : 0.f;
                }
                *reinterpret_cast<float2*>(&sts[lj * kDLd + 8 * n + 2 * t4]) =
                    make_float2(v[0], v[1]);
              }
            }
            __syncwarp();
          }
          product_64<kDLd, kTLd>(acc[0], slice, tile + hf * kT);
        }
        swap_frags(acc[0], acc[1]);
      }
    }
    __syncthreads();  // every warp is past the i-tile's tiles and slices
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t j = j0 + r0 + g + 8 * hh;
    if (j >= d.Q) continue;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float* out;
      int64_t cols;
      if (grp_b) {
        if (!b_on || sl.cols[hf] == 0) continue;
        out = dx + ((bg * d.Hg + sl.head[hf]) * d.Q + j) * d.P + sl.off[hf];
        cols = sl.cols[hf];
      } else {
        if (!a_on) continue;
        out = dB + (bg * d.Q + j) * d.N + s * kW + hf * kT;
        cols = d.N - s * kW - hf * kT;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t4 + e;
          if (col < cols) out[col] = acc[hf][n][2 * hh + e];
        }
    }
  }
}

constexpr int64_t kMaxGridYZ = 65535;

int64_t tiles(int64_t n) { return (n + kT - 1) / kT; }

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a shape the grid cannot hold.
// Shapes: BG, Q, N, Hg, P >= 1; strides in elements.
extern "C" int tlie_decay_attention_fwd_f32(const float* C, const float* B, const float* cs,
                                            const float* x, float* y, int64_t BG, int64_t Q,
                                            int64_t N, int64_t Hg, int64_t P, int64_t c_bs,
                                            int64_t c_ld, int64_t b_bs, int64_t b_ld,
                                            void* stream) {
  const int64_t slabs = slab_count(Hg, P);
  if (tiles(Q) > kMaxGridYZ || BG * slabs > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld};
  const int smem = kFwdSmemFloats * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      decay_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(BG * slabs), static_cast<unsigned int>(tiles(Q)));
  decay_attention_fwd_kernel<<<grid, kFwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      C, B, cs, x, y, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tlie_decay_attention_bwd_i_f32(const float* C, const float* B, const float* cs,
                                              const float* x, const float* dy, float* dC,
                                              float* dcs_i, int64_t BG, int64_t Q, int64_t N,
                                              int64_t Hg, int64_t P, int64_t c_bs, int64_t c_ld,
                                              int64_t b_bs, int64_t b_ld, void* stream) {
  if (tiles(N) > kMaxGridYZ || tiles(Q) > kMaxGridYZ || BG > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld};
  const dim3 grid(static_cast<unsigned int>(BG), static_cast<unsigned int>(tiles(N)),
                  static_cast<unsigned int>(tiles(Q)));
  decay_attention_bwd_i_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      C, B, cs, x, dy, dC, dcs_i, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tlie_decay_attention_bwd_j_f32(const float* C, const float* B, const float* cs,
                                              const float* x, const float* dy, float* dB,
                                              float* dx, float* dcs_j, int64_t BG, int64_t Q,
                                              int64_t N, int64_t Hg, int64_t P, int64_t c_bs,
                                              int64_t c_ld, int64_t b_bs, int64_t b_ld,
                                              void* stream) {
  const int64_t n_slices = (N + kW - 1) / kW, slabs = slab_count(Hg, P);
  const int64_t blocks = n_slices > slabs ? n_slices : slabs;
  if (blocks > kMaxGridYZ || tiles(Q) > kMaxGridYZ || BG > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld};
  const int smem = kBwdSmemFloats * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      decay_attention_bwd_j_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(BG), static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(tiles(Q)));
  decay_attention_bwd_j_kernel<<<grid, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      C, B, cs, x, dy, dB, dx, dcs_j, d);
  return static_cast<int>(cudaGetLastError());
}
