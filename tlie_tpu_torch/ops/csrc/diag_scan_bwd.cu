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
// da are (N,) for the LRU. At B=64, L=512, N=128, complex (and at the LM's
// B=8, L=1024, N=512, the same 4.2 M elements): 6 x 16.8 MB, about 30 us at
// 3.35 TB/s.
//
// Design. A block owns kLanes = 16 neighbouring channels of one batch row
// (64-byte row segments: 512 blocks at the MQAR shape, 256 at the LM's, to
// fill 132 SMs two blocks deep) and walks time from the right in rounds of
// kRound = 256 steps, cut into kChunks = 16 chunks of kSpan = 16 steps, one
// thread per (channel, chunk). In each round:
//   loads:  each thread issues every load of its chunk at once (g_t,
//           h_{t-1}, and a_{t+1} where a varies in time), unrolled, into
//           registers, where g stays until pass 2: g is read from device
//           memory once;
//   pass 1: each thread folds its chunk, last step first, into (A, D): the
//           product of its conj(a_{t+1}) and its scan from a zero state;
//   carry:  every thread folds the round's 16 aggregates through shared
//           memory, right to left, starting from the state that the round
//           to its right handed on, and keeps the state entering its own
//           chunk and the one leaving the round (the next round's carry);
//   pass 2: each thread walks its chunk again from its state, in
//           registers, writes d and folds d_t * conj(h_{t-1}) into a running
//           sum (or writes it, where `a` varies in time).
// The serial chains are 16 steps, twice, and 16 folds a round; every
// chunk's loads are in flight at once.
// Steps past L fold as the identity (a 1, g 0), so a ragged L needs nothing
// else. Where a is read at time stride 0 the 16 chunks' running sums are
// added in shared memory in chunk order, one partial per (batch row,
// channel). Where a is also shared across the batch (stride 0), a second
// kernel adds the partials over the batch rows, one warp an output: lane l
// adds rows l, l + 32, ... in order, then the 32 sums meet in a fixed
// butterfly. A deterministic two-stage sum rather than atomicAdd: the
// result does not change from run to run.
//
// Bytes read at the MQAR shape: g and h once each (4 x 16.8 MB), the (N,)
// a once a block; written: d once (2 x 16.8 MB), the partials and da
// (64 x 128 x 2 floats, then 128 x 2). A copy of this design that landed
// each round in shared memory by cp.async, two rounds in flight, took the
// same time alone and longer inside the LRU step (PERF.md, PR 14).
//
// ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.8): complex with an (N,) or (B, N)
// a, the LRU's, 128 registers, 10,240 bytes of shared memory, two blocks of
// 8 warps an SM (the launch bound); real 112 and the same; where a varies in
// time 193 (complex) and 211 (real) registers, one block an SM; no spills.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 16;   // channels per block
constexpr int kChunks = 16;  // chunks of a round, one thread row each
constexpr int kSpan = 16;    // steps of a chunk, held in registers from pass 1 to pass 2
constexpr int kRound = kChunks * kSpan;
constexpr int kThreads = kLanes * kChunks;
constexpr int kSumThreads = 256;

// kATime: a varies in time (a_tstride != 0), so each step has its own
// conj(a_{t+1}) and writes its own da_t.
template <bool kComplex, bool kATime>
__global__ void __launch_bounds__(kThreads, kATime ? 1 : 2)
diag_scan_bwd_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
                     const float* __restrict__ h_re, const float* __restrict__ h_im,
                     const float* __restrict__ g_re, const float* __restrict__ g_im,
                     float* __restrict__ d_re, float* __restrict__ d_im,
                     float* __restrict__ da_re, float* __restrict__ da_im,
                     int64_t L, int64_t N, int64_t n_tiles,
                     int64_t a_bstride, int64_t a_tstride, int reverse) {
  __shared__ float agg[2][4][kChunks][kLanes];  // by round parity: A re, A im, D re, D im
  __shared__ float red[2][kChunks][kLanes];

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
  // conj(a), where it is the same at every step
  float car = 0.f, cai = 0.f;
  if (!kATime && active) {
    car = a_re[a_off];
    if constexpr (kComplex) cai = -a_im[a_off];
  }

  float cr = 0.f, ci = 0.f;  // d entering the round from the right (the same in every chunk)
  float sr = 0.f, si = 0.f;  // sum over time of d_t * conj(h_{t-1}) (where !kATime)
  const int64_t rounds = (L + kRound - 1) / kRound;
  for (int64_t r = rounds - 1; r >= 0; --r) {
    const int64_t t0 = r * kRound + chunk * kSpan;  // the chunk's first logical step
    const int64_t x0 = x_off + (t_base + t_sign * t0) * N;
    const int64_t step = t_sign * N;  // from one logical step to the next
    // the chunk's operands: g_t, h_{t-1}, and conj(a_{t+1}) where it varies
    // in time; all zero past L
    float gr[kSpan], gi[kSpan], hr[kSpan], hi[kSpan];
    float ar[kATime ? kSpan : 1], ai[kATime ? kSpan : 1];
#pragma unroll
    for (int s = 0; s < kSpan; ++s) {
      const int64_t t = t0 + s, x = x0 + s * step;
      const bool in = active && t < L;
      gr[s] = in ? g_re[x] : 0.f;
      hr[s] = in && t > 0 ? h_re[x - step] : 0.f;
      gi[s] = hi[s] = 0.f;
      if constexpr (kComplex) {
        gi[s] = in ? g_im[x] : 0.f;
        hi[s] = in && t > 0 ? h_im[x - step] : 0.f;
      }
      if constexpr (kATime) {
        const bool next = in && t + 1 < L;
        const int64_t q = a_off + (t_base + t_sign * (t + 1)) * a_tstride;
        ar[s] = next ? a_re[q] : 0.f;
        ai[s] = 0.f;
        if constexpr (kComplex) ai[s] = next ? -a_im[q] : 0.f;
      }
    }
    // conj(a_{t+1}) of step s: 0 at L - 1, the identity (1) past L
    auto alpha = [&](int s, float& xr, float& xi) {
      const int64_t t = t0 + s;
      if constexpr (kATime) {
        xr = t < L ? ar[s] : 1.f;
        xi = ai[s];
      } else {
        xr = t + 1 < L ? car : (t < L ? 0.f : 1.f);
        xi = t + 1 < L ? cai : 0.f;
      }
    };

    // pass 1: the chunk's aggregate, from its last step down
    float Ar = 1.f, Ai = 0.f, Dr = 0.f, Di = 0.f;
#pragma unroll
    for (int s = kSpan - 1; s >= 0; --s) {
      float xr, xi;
      alpha(s, xr, xi);
      if constexpr (kComplex) {
        const float dr = xr * Dr - xi * Di + gr[s];
        const float di = xr * Di + xi * Dr + gi[s];
        const float pr = xr * Ar - xi * Ai;
        const float pi = xr * Ai + xi * Ar;
        Dr = dr; Di = di; Ar = pr; Ai = pi;
      } else {
        Dr = xr * Dr + gr[s];
        Ar = xr * Ar;
      }
    }
    float (&ag)[4][kChunks][kLanes] = agg[r & 1];
    ag[0][chunk][lane] = Ar;
    ag[2][chunk][lane] = Dr;
    if constexpr (kComplex) {
      ag[1][chunk][lane] = Ai;
      ag[3][chunk][lane] = Di;
    }
    __syncthreads();  // (the other parity's aggregates are free again: every
                      // thread has folded them before arriving here)

    // carry: fold the round's chunks right to left from the round's carry;
    // keep the state entering this chunk, and the state leaving the round
    float er = 0.f, ei = 0.f;
#pragma unroll
    for (int j = kChunks - 1; j >= 0; --j) {
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

    // pass 2: rescan from the state entering the chunk, write d, form
    // d_t * conj(h_{t-1}). The store addresses are formed here again, from
    // a copy of x0 the compiler cannot see through: kept from the loads,
    // 16 of them would hold 32 registers across the passes.
    int64_t y0 = x0;
    asm volatile("" : "+l"(y0));
#pragma unroll
    for (int s = kSpan - 1; s >= 0; --s) {
      const int64_t t = t0 + s, x = y0 + s * step;
      const bool in = active && t < L;
      float xr, xi, dar, dai = 0.f;
      alpha(s, xr, xi);
      if constexpr (kComplex) {
        const float nr = xr * er - xi * ei + gr[s];
        const float ni = xr * ei + xi * er + gi[s];
        er = nr; ei = ni;
        if (in) {
          d_re[x] = er;
          d_im[x] = ei;
        }
        dar = er * hr[s] + ei * hi[s];
        dai = ei * hr[s] - er * hi[s];
      } else {
        er = xr * er + gr[s];
        if (in) d_re[x] = er;
        dar = er * hr[s];
      }
      if constexpr (kATime) {
        if (in) {
          da_re[x] = dar;
          if constexpr (kComplex) da_im[x] = dai;
        }
      } else {
        sr += dar;
        si += dai;
      }
    }
  }
  if constexpr (kATime) return;

  // sum over time: add the chunks' running sums in chunk order
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

// out[m] = sum over r of part[r * M + m], one warp an m: lane l adds rows l,
// l + 32, ... in order, then the lanes' sums meet in a fixed butterfly
__global__ void __launch_bounds__(kSumThreads)
sum_rows_kernel(const float* __restrict__ part_re, const float* __restrict__ part_im,
                float* __restrict__ out_re, float* __restrict__ out_im, int64_t rows,
                int64_t M) {
  const int64_t m = static_cast<int64_t>(blockIdx.x) * (kSumThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;  // the whole warp
  float sr = 0.f, si = 0.f;
  for (int64_t r = lane; r < rows; r += 32) {
    sr += part_re[r * M + m];
    if (part_im != nullptr) si += part_im[r * M + m];
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    sr += __shfl_xor_sync(0xffffffffu, sr, o);
    si += __shfl_xor_sync(0xffffffffu, si, o);
  }
  if (lane == 0) {
    out_re[m] = sr;
    if (out_im != nullptr) out_im[m] = si;
  }
}

template <bool kComplex, bool kATime>
void launch(dim3 grid, cudaStream_t s, const float* a_re, const float* a_im, const float* h_re,
            const float* h_im, const float* g_re, const float* g_im, float* d_re, float* d_im,
            float* da_re, float* da_im, int64_t L, int64_t N, int64_t n_tiles,
            int64_t a_bstride, int64_t a_tstride, int reverse) {
  diag_scan_bwd_kernel<kComplex, kATime><<<grid, dim3(kLanes, kChunks), 0, s>>>(
      a_re, a_im, h_re, h_im, g_re, g_im, d_re, d_im, da_re, da_im, L, N, n_tiles, a_bstride,
      a_tstride, reverse);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool a_time = a_tstride != 0;
  if (is_complex && a_time)
    launch<true, true>(grid, s, a_re, a_im, h_re, h_im, g_re, g_im, d_re, d_im, out_re, out_im,
                       L, N, n_tiles, a_bstride, a_tstride, reverse);
  else if (is_complex)
    launch<true, false>(grid, s, a_re, a_im, h_re, h_im, g_re, g_im, d_re, d_im, out_re, out_im,
                        L, N, n_tiles, a_bstride, a_tstride, reverse);
  else if (a_time)
    launch<false, true>(grid, s, a_re, nullptr, h_re, nullptr, g_re, nullptr, d_re, nullptr,
                        out_re, nullptr, L, N, n_tiles, a_bstride, a_tstride, reverse);
  else
    launch<false, false>(grid, s, a_re, nullptr, h_re, nullptr, g_re, nullptr, d_re, nullptr,
                         out_re, nullptr, L, N, n_tiles, a_bstride, a_tstride, reverse);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !reduce) return static_cast<int>(err);
  const int64_t M = (a_time ? L : 1) * N;
  const int64_t per_block = kSumThreads / 32;
  const dim3 sum_grid(static_cast<unsigned int>((M + per_block - 1) / per_block));
  sum_rows_kernel<<<sum_grid, kSumThreads, 0, s>>>(
      part_re, is_complex ? part_im : nullptr, da_re, is_complex ? da_im : nullptr,
      batch, M);
  return static_cast<int>(cudaGetLastError());
}
