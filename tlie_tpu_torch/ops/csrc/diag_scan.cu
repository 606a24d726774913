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
// element of h written once, with a handful of flops per element; a is read
// once a block where it is the same at every step. At the LRU's shape (B=64,
// L=512, N=128, complex; and at the LM's B=8, L=1024, N=512, the same 4.2 M
// elements) that is 33.6 MB of b, 33.6 MB of h and a's (N,) pair: about
// 20 us at 3.35 TB/s.
//
// Design. The TPU kernel walks time chunks on a sequential grid and carries
// the state in VMEM scratch between grid steps. Blocks on Hopper run in no
// order, so the carry stays inside one block, as in diag_scan_bwd.cu: a
// block owns kLanes = 16 neighbouring channels of one batch row (64-byte row
// segments: 512 blocks at the MQAR shape, 256 at the LM's, for 132 SMs) and
// walks time from the left (from the right under `reverse`) in rounds of
// kRound = kChunks x kSpan steps, kChunks = 16 chunks of kSpan steps, one
// thread per (channel, chunk). In each round:
//   loads:  each thread issues every load of its chunk at once (b_t, and
//           a_t where a varies in time), unrolled, into registers, where b
//           stays until pass 2: b is read from device memory once;
//   pass 1: each thread folds its chunk from a zero state into (A, H): the
//           product of its a_t and its scan;
//   carry:  every thread folds the round's 16 aggregates through shared
//           memory, in chunk order, starting from the state the round before
//           handed on, and keeps the state entering its own chunk and the one
//           leaving the round (the next round's carry, in registers);
//   pass 2: each thread rescans its chunk from its state, out of registers,
//           and writes h.
// The serial chains are kSpan steps, twice, and 16 folds a round; every
// chunk's loads are in flight at once. Steps past L load as the identity
// (a 1, b 0), so a ragged L needs nothing else. `a` is read through a batch
// stride and a time stride, so a decay shared across the batch (stride 0) or
// constant in time is never materialised; where it is constant in time each
// thread loads it once, before the first round. No atomics, and the fold
// order is fixed: two launches give the same bits.
//
// kSpan and the launch bound were chosen on the card: chip_smoke.py ran from
// git archives of this source and of copies with kSpan 8 at four blocks an SM
// and kSpan 32 at one, in one call; PERF.md §6 holds the times.
//
// ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.8), 8,192 bytes of shared memory
// and "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads" for
// each instantiation: complex with a constant in time (the LRU's) 128
// registers and real 89, two blocks of 8 warps an SM (the launch bound);
// where a varies in time 192 (complex) and 190 (real), one block an SM.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 16;     // channels per block
constexpr int kChunks = 16;    // chunks of a round, one thread row each
constexpr int kSpan = 16;      // steps of a chunk, held in registers from pass 1 to pass 2
constexpr int kRound = kChunks * kSpan;
constexpr int kThreads = kLanes * kChunks;

// kATime: a varies in time (a_tstride != 0), so each step loads its own a_t.
template <bool kComplex, bool kATime>
__global__ void __launch_bounds__(kThreads, kATime ? 1 : 2)
diag_scan_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
                 const float* __restrict__ b_re, const float* __restrict__ b_im,
                 float* __restrict__ h_re, float* __restrict__ h_im,
                 int64_t L, int64_t N, int64_t n_tiles,
                 int64_t a_bstride, int64_t a_tstride, int reverse) {
  __shared__ float agg[2][4][kChunks][kLanes];  // by round parity: A re, A im, H re, H im

  const int lane = threadIdx.x;
  const int chunk = threadIdx.y;
  const int64_t batch = blockIdx.x / n_tiles;
  const int64_t n = (blockIdx.x % n_tiles) * kLanes + lane;
  const bool active = n < N;

  const int64_t x_off = batch * L * N + n;
  const int64_t a_off = batch * a_bstride + n;
  // logical step t is physical time index t_base + t_sign * t
  const int64_t t_sign = reverse ? -1 : 1;
  const int64_t t_base = reverse ? L - 1 : 0;
  // a, where it is the same at every step (the identity in idle lanes)
  float car = 1.f, cai = 0.f;
  if (!kATime && active) {
    car = a_re[a_off];
    if constexpr (kComplex) cai = a_im[a_off];
  }

  float cr = 0.f, ci = 0.f;  // h leaving the round before (the same in every chunk)
  const int64_t rounds = (L + kRound - 1) / kRound;
  for (int64_t r = 0; r < rounds; ++r) {
    const int64_t t0 = r * kRound + chunk * kSpan;  // the chunk's first logical step
    const int64_t p0 = t_base + t_sign * t0;        // its physical time index
    const int64_t x0 = x_off + p0 * N;
    const int64_t step = t_sign * N;  // from one logical step to the next
    const int64_t q0 = a_off + p0 * a_tstride, a_step = t_sign * a_tstride;
    // steps of the chunk inside [0, L): the rest are the identity
    const int64_t left = L - t0;
    const int n_in = active ? static_cast<int>(left < 0 ? 0 : (left < kSpan ? left : kSpan)) : 0;
    // the chunk's operands: b_t, and a_t where it varies in time
    float br[kSpan], bi[kSpan];
    float ar[kATime ? kSpan : 1], ai[kATime ? kSpan : 1];
#pragma unroll
    for (int s = 0; s < kSpan; ++s) {
      const bool in = s < n_in;
      br[s] = in ? b_re[x0 + s * step] : 0.f;
      bi[s] = 0.f;
      if constexpr (kComplex) bi[s] = in ? b_im[x0 + s * step] : 0.f;
      if constexpr (kATime) {
        ar[s] = in ? a_re[q0 + s * a_step] : 1.f;
        ai[s] = 0.f;
        if constexpr (kComplex) ai[s] = in ? a_im[q0 + s * a_step] : 0.f;
      }
    }
    // a_t of step s
    auto alpha = [&](int s, float& xr, float& xi) {
      if constexpr (kATime) {
        xr = ar[s];
        xi = ai[s];
      } else {
        xr = s < n_in ? car : 1.f;
        xi = s < n_in ? cai : 0.f;
      }
    };

    // pass 1: the chunk's aggregate, from a zero state
    float Ar = 1.f, Ai = 0.f, Hr = 0.f, Hi = 0.f;
#pragma unroll
    for (int s = 0; s < kSpan; ++s) {
      float xr, xi;
      alpha(s, xr, xi);
      if constexpr (kComplex) {
        const float hr = xr * Hr - xi * Hi + br[s];
        const float hi = xr * Hi + xi * Hr + bi[s];
        const float pr = xr * Ar - xi * Ai;
        const float pi = xr * Ai + xi * Ar;
        Hr = hr; Hi = hi; Ar = pr; Ai = pi;
      } else {
        Hr = xr * Hr + br[s];
        Ar = xr * Ar;
      }
    }
    float (&ag)[4][kChunks][kLanes] = agg[r & 1];
    ag[0][chunk][lane] = Ar;
    ag[2][chunk][lane] = Hr;
    if constexpr (kComplex) {
      ag[1][chunk][lane] = Ai;
      ag[3][chunk][lane] = Hi;
    }
    __syncthreads();  // (the other parity's aggregates are free again: every
                      // thread has folded them before arriving here)

    // carry: fold the round's chunks in order from the round's carry; keep
    // the state entering this chunk, and the state leaving the round
    float er = 0.f, ei = 0.f;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (j == chunk) { er = cr; ei = ci; }
      if constexpr (kComplex) {
        const float pr = ag[0][j][lane], pi = ag[1][j][lane];
        const float nr = pr * cr - pi * ci + ag[2][j][lane];
        const float ni = pr * ci + pi * cr + ag[3][j][lane];
        cr = nr; ci = ni;
      } else {
        cr = ag[0][j][lane] * cr + ag[2][j][lane];
      }
    }

    // pass 2: rescan from the state entering the chunk and write h. The
    // store addresses are formed here again, from a copy of x0 the compiler
    // cannot see through: kept from the loads, they would hold registers
    // across the passes.
    int64_t y0 = x0;
    asm volatile("" : "+l"(y0));
#pragma unroll
    for (int s = 0; s < kSpan; ++s) {
      float xr, xi;
      alpha(s, xr, xi);
      const int64_t y = y0 + s * step;
      if constexpr (kComplex) {
        const float nr = xr * er - xi * ei + br[s];
        const float ni = xr * ei + xi * er + bi[s];
        er = nr; ei = ni;
        if (s < n_in) {
          h_re[y] = er;
          h_im[y] = ei;
        }
      } else {
        er = xr * er + br[s];
        if (s < n_in) h_re[y] = er;
      }
    }
  }
}

template <bool kComplex, bool kATime>
void launch(dim3 grid, cudaStream_t s, const float* a_re, const float* a_im,
            const float* b_re, const float* b_im, float* h_re, float* h_im, int64_t L,
            int64_t N, int64_t n_tiles, int64_t a_bstride, int64_t a_tstride, int reverse) {
  diag_scan_kernel<kComplex, kATime><<<grid, dim3(kLanes, kChunks), 0, s>>>(
      a_re, a_im, b_re, b_im, h_re, h_im, L, N, n_tiles, a_bstride, a_tstride, reverse);
}

}  // namespace

// b and h are contiguous (batch, L, N); a is read at
// a[batch * a_bstride + t * a_tstride + n]. For the real recurrence the
// *_im pointers are ignored. `reverse` scans right to left. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int tlie_diag_scan_f32(const float* a_re, const float* a_im,
                                  const float* b_re, const float* b_im,
                                  float* h_re, float* h_im,
                                  int64_t batch, int64_t L, int64_t N,
                                  int64_t a_bstride, int64_t a_tstride,
                                  int is_complex, int reverse, void* stream) {
  const int64_t n_tiles = (N + kLanes - 1) / kLanes;
  const dim3 grid(static_cast<unsigned int>(batch * n_tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a_time = a_tstride != 0;
  if (is_complex && a_time)
    launch<true, true>(grid, s, a_re, a_im, b_re, b_im, h_re, h_im, L, N, n_tiles, a_bstride,
                       a_tstride, reverse);
  else if (is_complex)
    launch<true, false>(grid, s, a_re, a_im, b_re, b_im, h_re, h_im, L, N, n_tiles, a_bstride,
                        a_tstride, reverse);
  else if (a_time)
    launch<false, true>(grid, s, a_re, nullptr, b_re, nullptr, h_re, nullptr, L, N, n_tiles,
                        a_bstride, a_tstride, reverse);
  else
    launch<false, false>(grid, s, a_re, nullptr, b_re, nullptr, h_re, nullptr, L, N, n_tiles,
                         a_bstride, a_tstride, reverse);
  return static_cast<int>(cudaGetLastError());
}
