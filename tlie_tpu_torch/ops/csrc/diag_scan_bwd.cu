// Backward of the diagonal linear recurrence h_t = a_t * h_{t-1} + b_t
// (diag_scan.cu), float32, real or complex as (re, im) planes.  With the
// cotangent g on h, in logical time (reversed when the forward was):
//   d_t  = conj(a_{t+1}) * d_{t+1} + g_t     (d_L = 0, a_L taken as 0)  -> db
//   da_t = d_t * conj(h_{t-1})               (h_{-1} = 0)
// and da is summed inside the kernels over every axis along which the
// forward read `a` at stride 0, so it comes out at a's own shape.
//
// Replaces the TPU backward of tlie_tpu/ops/pallas_scan.py
// (_scan_core_real_bwd, _scan_core_pair_bwd): the same pallas_call
// (_run_scan_planes) run again on flipped, shifted and conjugated planes,
// then da_t = d_t * conj(h_{t-1}) in full (B, L, N) before the broadcast sum.
// Here the shift, the conjugate and the flip are index arithmetic, and for
// the LRU's (N,) decay the (B, L, N) da is never written.
//
// Bound on the H100: memory. g and h are read once, d is written once; a and
// da are (N,) for the LRU. At B=64, L=512, N=128, complex: 6 x 16.8 MB, about
// 30 us at 3.35 TB/s.
//
// Design: the forward kernel's layout run right to left. A block owns 32
// neighbouring channels of one batch row and splits time into kChunks chunks,
// one warp each.
//   pass 1: each thread folds its chunk, last step first, into (A, D): the
//           product of its conj(a_{t+1}) and its scan from a zero state;
//   carry:  thread `chunk` folds the chunks after it, through shared memory;
//   pass 2: each thread walks its chunk again from that state, writes d and
//           folds d_t * conj(h_{t-1}) into a running sum (or writes it, where
//           `a` varies in time).
// Where a is read at time stride 0 the running sums of the kChunks warps are
// added in shared memory, one partial per (batch row, channel). Where a is
// also shared across the batch (stride 0), a second kernel adds the partials
// over the batch rows in a fixed order: a deterministic two-stage sum rather
// than atomicAdd, so the result does not change from run to run.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 32;  // channels per block
constexpr int kChunks = 8;  // time chunks per block, one warp each
constexpr int kSumThreads = 256;

__device__ __forceinline__ int64_t imin(int64_t x, int64_t y) { return x < y ? x : y; }

template <bool kComplex>
__global__ void __launch_bounds__(kLanes * kChunks)
diag_scan_bwd_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
                     const float* __restrict__ h_re, const float* __restrict__ h_im,
                     const float* __restrict__ g_re, const float* __restrict__ g_im,
                     float* __restrict__ d_re, float* __restrict__ d_im,
                     float* __restrict__ da_re, float* __restrict__ da_im,
                     int64_t L, int64_t N, int64_t n_tiles,
                     int64_t a_bstride, int64_t a_tstride, int reverse) {
  __shared__ float agg[4][kChunks][kLanes];
  __shared__ float red[2][kChunks][kLanes];

  const int lane = threadIdx.x;
  const int chunk = threadIdx.y;
  const int64_t batch = blockIdx.x / n_tiles;
  const int64_t n = (blockIdx.x % n_tiles) * kLanes + lane;
  const bool active = n < N;

  const int64_t span = (L + kChunks - 1) / kChunks;
  const int64_t t0 = imin(L, chunk * span);
  const int64_t t1 = imin(L, t0 + span);
  const int64_t x_off = batch * L * N + n;
  const int64_t a_off = batch * a_bstride + n;
  // logical step t is physical time index t_base + t_sign * t
  const int64_t t_sign = reverse ? -1 : 1;
  const int64_t t_base = reverse ? L - 1 : 0;

  // conj(a_{t+1}), zero past the last step
  auto alpha = [&](int64_t t, float& ar, float& ai) {
    ar = 0.f;
    ai = 0.f;
    if (t + 1 < L) {
      const int64_t q = a_off + (t_base + t_sign * (t + 1)) * a_tstride;
      ar = a_re[q];
      if constexpr (kComplex) ai = -a_im[q];
    }
  };

  // pass 1: aggregate of this chunk, from its last step down
  float Ar = 1.f, Ai = 0.f, Dr = 0.f, Di = 0.f;
  if (active) {
    for (int64_t t = t1 - 1; t >= t0; --t) {
      float ar, ai;
      alpha(t, ar, ai);
      const int64_t x = x_off + (t_base + t_sign * t) * N;
      if constexpr (kComplex) {
        const float dr = ar * Dr - ai * Di + g_re[x];
        const float di = ar * Di + ai * Dr + g_im[x];
        const float pr = ar * Ar - ai * Ai;
        const float pi = ar * Ai + ai * Ar;
        Dr = dr; Di = di; Ar = pr; Ai = pi;
      } else {
        Dr = ar * Dr + g_re[x];
        Ar = ar * Ar;
      }
    }
  }
  agg[0][chunk][lane] = Ar;
  agg[1][chunk][lane] = Ai;
  agg[2][chunk][lane] = Dr;
  agg[3][chunk][lane] = Di;
  __syncthreads();

  // state entering this chunk from the right: fold the later chunks in order
  float cr = 0.f, ci = 0.f;
  for (int j = kChunks - 1; j > chunk; --j) {
    const float pr = agg[0][j][lane], pi = agg[1][j][lane];
    const float nr = pr * cr - pi * ci + agg[2][j][lane];
    const float ni = pr * ci + pi * cr + agg[3][j][lane];
    cr = nr; ci = ni;
  }

  // pass 2: rescan from the carried state, write d, form d_t * conj(h_{t-1})
  float sr = 0.f, si = 0.f;
  if (active) {
    for (int64_t t = t1 - 1; t >= t0; --t) {
      float ar, ai;
      alpha(t, ar, ai);
      const int64_t x = x_off + (t_base + t_sign * t) * N;
      float hr = 0.f, hi = 0.f;
      if (t > 0) {
        const int64_t xp = x_off + (t_base + t_sign * (t - 1)) * N;
        hr = h_re[xp];
        if constexpr (kComplex) hi = h_im[xp];
      }
      float dar, dai = 0.f;
      if constexpr (kComplex) {
        const float nr = ar * cr - ai * ci + g_re[x];
        const float ni = ar * ci + ai * cr + g_im[x];
        cr = nr; ci = ni;
        d_re[x] = cr;
        d_im[x] = ci;
        dar = cr * hr + ci * hi;
        dai = ci * hr - cr * hi;
      } else {
        cr = ar * cr + g_re[x];
        d_re[x] = cr;
        dar = cr * hr;
      }
      if (a_tstride == 0) {
        sr += dar;
        si += dai;
      } else {
        da_re[x] = dar;
        if constexpr (kComplex) da_im[x] = dai;
      }
    }
  }
  if (a_tstride != 0) return;

  // sum over time: add the chunks' running sums in a fixed order
  red[0][chunk][lane] = sr;
  red[1][chunk][lane] = si;
  __syncthreads();
  if (chunk == 0 && active) {
    float tr = 0.f, ti = 0.f;
    for (int j = 0; j < kChunks; ++j) {
      tr += red[0][j][lane];
      ti += red[1][j][lane];
    }
    da_re[batch * N + n] = tr;
    if constexpr (kComplex) da_im[batch * N + n] = ti;
  }
}

// out[m] = sum over r of part[r * M + m], rows in order
__global__ void sum_rows_kernel(const float* __restrict__ part_re,
                                const float* __restrict__ part_im,
                                float* __restrict__ out_re, float* __restrict__ out_im,
                                int64_t rows, int64_t M) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (m >= M) return;
  float sr = 0.f, si = 0.f;
  for (int64_t r = 0; r < rows; ++r) {
    sr += part_re[r * M + m];
    if (part_im != nullptr) si += part_im[r * M + m];
  }
  out_re[m] = sr;
  if (out_im != nullptr) out_im[m] = si;
}

}  // namespace

// h, g and d are contiguous (batch, L, N); a is read as by the forward, at
// a[batch * a_bstride + t * a_tstride + n].  da is written at a's reduced
// shape: (a_bstride ? batch : 1, a_tstride ? L : 1, N), contiguous.  Where
// a_bstride == 0 and batch > 1, `part` (batch x the rest of that shape) holds
// the per-row partials that a second launch adds into da; elsewhere `part`
// is not read.  For the real recurrence the *_im pointers are ignored.
// `reverse` is the forward's flag.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int tlie_diag_scan_bwd_f32(const float* a_re, const float* a_im,
                                      const float* h_re, const float* h_im,
                                      const float* g_re, const float* g_im,
                                      float* d_re, float* d_im,
                                      float* part_re, float* part_im,
                                      float* da_re, float* da_im,
                                      int64_t batch, int64_t L, int64_t N,
                                      int64_t a_bstride, int64_t a_tstride,
                                      int is_complex, int reverse, void* stream) {
  const bool reduce = a_bstride == 0 && batch > 1;
  float* out_re = reduce ? part_re : da_re;
  float* out_im = reduce ? part_im : da_im;
  const int64_t n_tiles = (N + kLanes - 1) / kLanes;
  const dim3 grid(static_cast<unsigned int>(batch * n_tiles));
  const dim3 block(kLanes, kChunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_complex) {
    diag_scan_bwd_kernel<true><<<grid, block, 0, s>>>(
        a_re, a_im, h_re, h_im, g_re, g_im, d_re, d_im, out_re, out_im,
        L, N, n_tiles, a_bstride, a_tstride, reverse);
  } else {
    diag_scan_bwd_kernel<false><<<grid, block, 0, s>>>(
        a_re, nullptr, h_re, nullptr, g_re, nullptr, d_re, nullptr, out_re, nullptr,
        L, N, n_tiles, a_bstride, a_tstride, reverse);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !reduce) return static_cast<int>(err);
  const int64_t M = (a_tstride != 0 ? L : 1) * N;
  const dim3 sum_grid(static_cast<unsigned int>((M + kSumThreads - 1) / kSumThreads));
  sum_rows_kernel<<<sum_grid, kSumThreads, 0, s>>>(
      part_re, is_complex ? part_im : nullptr, da_re, is_complex ? da_im : nullptr,
      batch, M);
  return static_cast<int>(cudaGetLastError());
}
