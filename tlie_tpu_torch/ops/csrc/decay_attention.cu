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
// 0.064 ms at 67 TFLOP/s of float32 outside the tensor cores, against 67 MB
// of operands, 0.020 ms at 3.35 TB/s. bwd_i does three products and bwd_j
// four.
//
// Design. Every product is a float32 SIMT tile product on shared memory (no
// TF32: parity is held at float32). A block of 256 threads owns a 64 x 64
// output tile, each thread a 4 x 4 piece of it, and walks the 64-wide tiles
// of the other sequence index that the causal mask leaves:
//   forward: block (bg, h, i-tile, P-slice) walks j-tiles j <= i: the C_i . B_j
//            tile over N, scaled by the head's decay into shared memory, then
//            times the x_j tile into the y accumulator.
//   bwd_i:   block (bg, i-tile, N-slice) walks heads, and for each the j-tiles
//            j <= i: dS = dy_i . x_j over P, times the decay, then times B_j
//            into the dC accumulator (dC sums over heads). The blocks of the
//            first N-slice also form C_i . B_j and sum dS * decay * CB over j:
//            dcs_i, one row per head.
//   bwd_j:   block (bg, j-tile, slice) walks i-tiles i >= j. A slice is either
//            an N-slice of dB (heads walked inside, as in bwd_i, the first
//            slice also writing dcs_j = -sum_i dS * decay * CB) or one head's
//            P-slice of dx = S^T dy.
// Each output element has one writer, so there are no atomics and every
// launch is deterministic. Entries above the diagonal are never multiplied
// by an exp: the decay is only evaluated where j <= i, and the rows and
// columns past Q (a ragged last tile) are loaded as 0 and masked. The decay
// is exp(cs_i - cs_j), never exp(cs_i) * exp(-cs_j): |cs| reaches hundreds
// at Q = 512.
//
// The 64-wide tiles keep all four shared tiles in 43.5 KB of static shared
// memory whatever N, P and Hg are, so one kernel serves the MQAR shape and
// the WikiText Mamba-2 shape (Hg 8, P 64, N 512, Q 1024) alike; the heads of
// a group are looped, not held in registers.

#include <cuda_runtime.h>
#include <cstdint>

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

// grid (BG * Hg, ceil(P / 64), ceil(Q / 64))
__global__ void __launch_bounds__(kThreads)
decay_attention_fwd_kernel(const float* __restrict__ C, const float* __restrict__ B,
                           const float* __restrict__ cs, const float* __restrict__ x,
                           float* __restrict__ y, Dims d) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t bgh = blockIdx.x, bg = bgh / d.Hg;
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * kT;
  const int64_t i0 = static_cast<int64_t>(blockIdx.z) * kT;
  const float* Cb = C + bg * d.c_bs;
  const float* Bb = B + bg * d.b_bs;
  const float* csh = cs + bgh * d.Q;
  const float* xh = x + bgh * d.Q * d.P;

  float acc[4][4], cb[4][4];
  zero(acc);
  load_cs(csh + i0, d.Q - i0, sm.cs_own);
  for (int64_t j0 = 0; j0 <= i0; j0 += kT) {
    load_cs(csh + j0, d.Q - j0, sm.cs_other);
    tile_nt(Cb + i0 * d.c_ld, d.Q - i0, d.c_ld, Bb + j0 * d.b_ld, d.Q - j0, d.b_ld, d.N, sm, cb);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int li = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lj = tx * 4 + c;
        const int64_t i = i0 + li, j = j0 + lj;
        float s = 0.f;
        if (j <= i && i < d.Q) s = cb[r][c] * expf(sm.cs_own[li] - sm.cs_other[lj]);
        sm.s[lj][li] = s;
      }
    }
    load_values(xh + j0 * d.P + p0, d.Q - j0, d.P - p0, d.P, sm);
    __syncthreads();
    tile_sv(sm, acc);
    __syncthreads();
  }
  store_tile(y + bgh * d.Q * d.P, i0, d.Q, p0, d.P, d.P, acc);
}

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

// grid (BG, ceil(N / 64) + Hg * ceil(P / 64), ceil(Q / 64)): slices below
// ceil(N / 64) are dB's (and, the first, dcs_j's), the rest dx's per head.
__global__ void __launch_bounds__(kThreads)
decay_attention_bwd_j_kernel(const float* __restrict__ C, const float* __restrict__ B,
                             const float* __restrict__ cs, const float* __restrict__ x,
                             const float* __restrict__ dy, float* __restrict__ dB,
                             float* __restrict__ dx, float* __restrict__ dcs_j, Dims d) {
  __shared__ Smem sm;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t bg = blockIdx.x;
  const int64_t n_slices = (d.N + kT - 1) / kT, p_slices = (d.P + kT - 1) / kT;
  const int64_t slice = blockIdx.y;
  const int64_t j0 = static_cast<int64_t>(blockIdx.z) * kT;
  const float* Cb = C + bg * d.c_bs;
  const float* Bb = B + bg * d.b_bs;

  // the block's rows are j (4ty + r), the walked columns i (4tx + c); the
  // shared scores are stored s[i][j] for the second product over i
  float acc[4][4], ds[4][4], cb[4][4];
  zero(acc);
  zero(cb);
  if (slice < n_slices) {  // dB, and dcs_j on the first slice
    const int64_t n0 = slice * kT;
    const bool first_slice = slice == 0;
    for (int64_t h = 0; h < d.Hg; ++h) {
      const int64_t bgh = bg * d.Hg + h;
      const float* csh = cs + bgh * d.Q;
      const float* xh = x + bgh * d.Q * d.P;
      const float* dyh = dy + bgh * d.Q * d.P;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      load_cs(csh + j0, d.Q - j0, sm.cs_own);
      for (int64_t i0 = j0; i0 < d.Q; i0 += kT) {
        load_cs(csh + i0, d.Q - i0, sm.cs_other);
        tile_nt(xh + j0 * d.P, d.Q - j0, d.P, dyh + i0 * d.P, d.Q - i0, d.P, d.P, sm, ds);
        if (first_slice)
          tile_nt(Bb + j0 * d.b_ld, d.Q - j0, d.b_ld, Cb + i0 * d.c_ld, d.Q - i0, d.c_ld, d.N,
                  sm, cb);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int lj = ty * 4 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int li = tx * 4 + c;
            const int64_t j = j0 + lj, i = i0 + li;
            float dsd = 0.f;
            if (j <= i && i < d.Q) dsd = ds[r][c] * expf(sm.cs_other[li] - sm.cs_own[lj]);
            part[r] = fmaf(dsd, cb[r][c], part[r]);
            sm.s[li][lj] = dsd;
          }
        }
        load_values(Cb + i0 * d.c_ld + n0, d.Q - i0, d.N - n0, d.c_ld, sm);
        __syncthreads();
        tile_sv(sm, acc);
        __syncthreads();
      }
      if (first_slice) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float total = sum16(part[r]);
          const int64_t j = j0 + ty * 4 + r;
          if (tx == 0 && j < d.Q) dcs_j[bgh * d.Q + j] = -total;
        }
      }
    }
    store_tile(dB + bg * d.Q * d.N, j0, d.Q, n0, d.N, d.N, acc);
  } else {  // dx of one head and P-slice: S^T dy
    const int64_t h = (slice - n_slices) / p_slices;
    const int64_t p0 = (slice - n_slices) % p_slices * kT;
    const int64_t bgh = bg * d.Hg + h;
    const float* csh = cs + bgh * d.Q;
    const float* dyh = dy + bgh * d.Q * d.P;
    load_cs(csh + j0, d.Q - j0, sm.cs_own);
    for (int64_t i0 = j0; i0 < d.Q; i0 += kT) {
      load_cs(csh + i0, d.Q - i0, sm.cs_other);
      tile_nt(Bb + j0 * d.b_ld, d.Q - j0, d.b_ld, Cb + i0 * d.c_ld, d.Q - i0, d.c_ld, d.N, sm,
              cb);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int lj = ty * 4 + r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int li = tx * 4 + c;
          const int64_t j = j0 + lj, i = i0 + li;
          float s = 0.f;
          if (j <= i && i < d.Q) s = cb[r][c] * expf(sm.cs_other[li] - sm.cs_own[lj]);
          sm.s[li][lj] = s;
        }
      }
      load_values(dyh + i0 * d.P + p0, d.Q - i0, d.P - p0, d.P, sm);
      __syncthreads();
      tile_sv(sm, acc);
      __syncthreads();
    }
    store_tile(dx + bgh * d.Q * d.P, j0, d.Q, p0, d.P, d.P, acc);
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
  if (tiles(P) > kMaxGridYZ || tiles(Q) > kMaxGridYZ || BG * Hg > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld};
  const dim3 grid(static_cast<unsigned int>(BG * Hg), static_cast<unsigned int>(tiles(P)),
                  static_cast<unsigned int>(tiles(Q)));
  decay_attention_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
  const int64_t slices = tiles(N) + Hg * tiles(P);
  if (slices > kMaxGridYZ || tiles(Q) > kMaxGridYZ || BG > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld};
  const dim3 grid(static_cast<unsigned int>(BG), static_cast<unsigned int>(slices),
                  static_cast<unsigned int>(tiles(Q)));
  decay_attention_bwd_j_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      C, B, cs, x, dy, dB, dx, dcs_j, d);
  return static_cast<int>(cudaGetLastError());
}
