// Diagonal linear recurrence h_t = a_t * h_{t-1} + b_t with h_{-1} = 0,
// inclusive, float32, real or complex as (re, im) planes, forward in time or,
// with `reverse`, right to left (h_t = a_t * h_{t+1} + b_t, h_L = 0).
//
// Replaces the TPU kernel tlie_tpu/ops/pallas_scan.py::_run_scan_planes
// (bodies _complex_kernel and _real_kernel, reached from
// pallas_diag_linear_scan).  The TPU flips the planes in memory for the
// reverse scan; here `reverse` only maps logical step t to physical index
// L-1-t, so nothing is copied.  The backward is diag_scan_bwd.cu.
//
// Bound on the H100: memory. Every element of b is read once and every
// element of h written once, with a handful of flops per element. At the
// LRU's shape (B=64, L=512, N=128, complex) that is 33.6 MB of b, 33.6 MB of
// h and 0.5 MB of a broadcast a: about 20 us at 3.35 TB/s.
//
// Design. The TPU kernel walks time chunks on a sequential grid and carries
// the state in VMEM scratch between grid steps. Blocks on Hopper run in no
// order, so here the carry stays inside one block: a block owns 32
// neighbouring channels (one warp row, 128-byte coalesced loads) of one
// batch row and splits time into kChunks chunks, one warp each.
//   pass 1: each thread folds its chunk into (A, H): the product of its
//           a_t and its scan from a zero state;
//   carry:  thread `chunk` folds the aggregates of the chunks before it,
//           through shared memory, into its starting state;
//   pass 2: each thread walks its chunk again from that state and writes h.
// Pass 2 reads a and b again; a block's slice (32 channels x L) is small,
// so the second read is served by L2, and device memory sees each byte once.
// `a` is read through a batch stride and a time stride, so a decay shared
// across the batch (stride 0) or constant in time is never materialised.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 32;  // channels per block
constexpr int kChunks = 8;  // time chunks per block, one warp each

__device__ __forceinline__ int64_t imin(int64_t x, int64_t y) { return x < y ? x : y; }

template <bool kComplex>
__global__ void __launch_bounds__(kLanes * kChunks)
diag_scan_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
                 const float* __restrict__ b_re, const float* __restrict__ b_im,
                 float* __restrict__ h_re, float* __restrict__ h_im,
                 int64_t L, int64_t N, int64_t n_tiles,
                 int64_t a_bstride, int64_t a_tstride, int reverse) {
  __shared__ float agg[4][kChunks][kLanes];

  const int lane = threadIdx.x;
  const int chunk = threadIdx.y;
  const int64_t batch = blockIdx.x / n_tiles;
  const int64_t n = (blockIdx.x % n_tiles) * kLanes + lane;
  const bool active = n < N;

  const int64_t span = (L + kChunks - 1) / kChunks;
  const int64_t t0 = imin(L, chunk * span);
  const int64_t t1 = imin(L, t0 + span);
  const int64_t b_off = batch * L * N + n;
  const int64_t a_off = batch * a_bstride + n;
  // logical step t is physical time index p = t_base + t_sign * t
  const int64_t t_sign = reverse ? -1 : 1;
  const int64_t t_base = reverse ? L - 1 : 0;

  // pass 1: aggregate of this chunk
  float Ar = 1.f, Ai = 0.f, Hr = 0.f, Hi = 0.f;
  if (active) {
#pragma unroll 8
    for (int64_t t = t0; t < t1; ++t) {
      const int64_t p = t_base + t_sign * t;
      const float ar = a_re[a_off + p * a_tstride];
      const float br = b_re[b_off + p * N];
      if constexpr (kComplex) {
        const float ai = a_im[a_off + p * a_tstride];
        const float bi = b_im[b_off + p * N];
        const float hr = ar * Hr - ai * Hi + br;
        const float hi = ar * Hi + ai * Hr + bi;
        const float pr = ar * Ar - ai * Ai;
        const float pi = ar * Ai + ai * Ar;
        Hr = hr; Hi = hi; Ar = pr; Ai = pi;
      } else {
        Hr = ar * Hr + br;
        Ar = ar * Ar;
      }
    }
  }
  agg[0][chunk][lane] = Ar;
  agg[1][chunk][lane] = Ai;
  agg[2][chunk][lane] = Hr;
  agg[3][chunk][lane] = Hi;
  __syncthreads();

  // state entering this chunk: fold the earlier chunks in order
  float cr = 0.f, ci = 0.f;
  for (int j = 0; j < chunk; ++j) {
    const float pr = agg[0][j][lane], pi = agg[1][j][lane];
    const float nr = pr * cr - pi * ci + agg[2][j][lane];
    const float ni = pr * ci + pi * cr + agg[3][j][lane];
    cr = nr; ci = ni;
  }
  if (!active) return;

  // pass 2: rescan from the carried state and write h
#pragma unroll 8
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t p = t_base + t_sign * t;
    const float ar = a_re[a_off + p * a_tstride];
    const float br = b_re[b_off + p * N];
    if constexpr (kComplex) {
      const float ai = a_im[a_off + p * a_tstride];
      const float bi = b_im[b_off + p * N];
      const float nr = ar * cr - ai * ci + br;
      const float ni = ar * ci + ai * cr + bi;
      cr = nr; ci = ni;
      h_re[b_off + p * N] = cr;
      h_im[b_off + p * N] = ci;
    } else {
      cr = ar * cr + br;
      h_re[b_off + p * N] = cr;
    }
  }
}

}  // namespace

// b and h are contiguous (batch, L, N); a is read at
// a[batch * a_bstride + t * a_tstride + n]. For the real recurrence the
// *_im pointers are ignored. `reverse` scans right to left. Launches on
// `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int tlie_diag_scan_f32(const float* a_re, const float* a_im,
                                  const float* b_re, const float* b_im,
                                  float* h_re, float* h_im,
                                  int64_t batch, int64_t L, int64_t N,
                                  int64_t a_bstride, int64_t a_tstride,
                                  int is_complex, int reverse, void* stream) {
  const int64_t n_tiles = (N + kLanes - 1) / kLanes;
  const dim3 grid(static_cast<unsigned int>(batch * n_tiles));
  const dim3 block(kLanes, kChunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_complex) {
    diag_scan_kernel<true><<<grid, block, 0, s>>>(
        a_re, a_im, b_re, b_im, h_re, h_im, L, N, n_tiles, a_bstride, a_tstride,
        reverse);
  } else {
    diag_scan_kernel<false><<<grid, block, 0, s>>>(
        a_re, nullptr, b_re, nullptr, h_re, nullptr, L, N, n_tiles, a_bstride,
        a_tstride, reverse);
  }
  return static_cast<int>(cudaGetLastError());
}
