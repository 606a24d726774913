// SSD intra-chunk decay attention on float32 operands, and its gradient:
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
// The three on bfloat16 operands are decay_attention_bf16.cu's.
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
// products and bwd_j four. All three run on the tensor cores, as three TF32
// products for each product at 495 TFLOP/s: 0.026, 0.039 and 0.052 ms.
//
// Every kernel: each output element has one writer, so there are no atomics
// and every launch is deterministic. Entries above the diagonal are never
// multiplied by an exp: the decay is only evaluated where j <= i < Q, and the
// rows and columns past Q (a ragged last tile) are loaded as 0 and not
// stored. The decay is exp(cs_i - cs_j), never exp(cs_i) * exp(-cs_j): |cs|
// reaches hundreds at Q = 512. The tiles whose blocks walk the most (the last
// i-tiles forward and in bwd_i, the first j-tiles in bwd_j) launch first.
//
// On the tensor cores: mma.sync m16n8k8 on TF32, float32 accumulators, each
// product as three TF32 products of a split operand, summed no deeper than
// kFresh = 8 (one m16n8k8 step) before a float32 add (tf32_mma.cuh); the
// operands land in shared-memory steps of 32 over N or P, one tile's 64 over
// i or j. The columns of y and dx are cut into slabs of 128: two heads where
// P <= 64 (one 64-column half each), else a 128-wide slice of one head's P;
// at the MQAR shape one slab holds them all.
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
//   bwd_i:   bwd_j mirrored: block (bg, s, i-tile) of 8 warps in two groups
//            of 4, each warp 16 whole rows of i, walking the j-tiles j <= i.
//            Group B forms CB = C_i B_j^T over N (block s = 0 only: CB serves
//            dcs_i alone) and publishes it; group A forms each head's dS =
//            dy_i x_j^T over P, Dh = dS * decay, dcs_i += rowsum(Dh * CB) on
//            the CUDA cores (block s = 0) and dCB += Dh in shared memory; then
//            both groups add dCB B_j to dC, group A 64 columns of each of the
//            block's 128-wide chunks of N and group B the other 64. At the
//            MQAR shape each of the three products is formed once per tile
//            pair: 2 x 4 warps x 8 x 16 x 3 (CB and dS) + 8 warps x 8 x 8 x 3
//            (dC) = 4,608 mma.sync. A block holds dC for kIChunks = 2 chunks
//            of N; where N > 256 there are ceil(N / 256) blocks per (bg,
//            i-tile), CB is formed once per tile pair and each head's dS
//            once per block: at the WikiText Mamba-2 shape CB once and dS
//            twice (8 and 8 with the float32 SIMT kernel it replaced). C_i
//            stays put across the j-tiles where N <= 128, dy_i where Hg *
//            ceil(P / 128) = 1, and there dC reads the B_j group B copied for
//            CB.
//
// ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.8): the forward 222 registers,
// 75,776 bytes of dynamic shared memory, two blocks an SM; bwd_j 254
// registers, 194,560 bytes, and bwd_i 216 registers, 176,128 bytes, one
// block of 8 warps an SM; no spills.

#include <cuda_runtime.h>
#include <cstdint>

#include "tf32_mma.cuh"

namespace {

struct Dims {
  int64_t Q, N, Hg, P;
  int64_t c_bs, c_ld, b_bs, b_ld;  // batch and row strides of C and B, in elements
};

constexpr int kW = 128;  // columns of a slab of y or dx, and of a backward operand tile

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

constexpr int kFwdThreads = 128;  // 4 warps, each 16 whole rows of the block's 64
// Row strides of the forward's shared tiles, in floats: float2 reads at
// (8g + 2t) hit every bank once where the stride is 8 modulo 32 (the C and B
// steps, S), float reads at (8t + g) where it is 4 (x_j).
constexpr int kStepLd = kStep + 8;
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
                      (reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(B)) %
                              (4 * sizeof(float)) == 0;
  const bool vec_x = d.P % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(float)) == 0;
  const int nk = static_cast<int>((d.N + kStep - 1) / kStep);
  const int n_j = static_cast<int>(i0 / kT) + 1;
  const int total = n_j * nk;

  auto start_step = [&](int q) {
    const int64_t j0 = static_cast<int64_t>(q / nk) * kT;
    const int64_t k0 = static_cast<int64_t>(q % nk) * kStep;
    float* st = ring + (q & 1) * kStepFloats;
    copy_tile<kStepLd, kStep>(st, Ci + k0, d.c_ld, d.Q - i0, d.N - k0, vec_cb, C, tid,
                            kFwdThreads);
    copy_tile<kStepLd, kStep>(st + kT * kStepLd, Bb + j0 * d.b_ld + k0, d.b_ld, d.Q - j0,
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
            v[e] = j0 + lj <= i && i < d.Q
                       ? s[0][n][2 * hh + e] * expf(ci - cs_j[hf * kT + lj])
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
                      (reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(B)) %
                              (4 * sizeof(float)) == 0;
  const bool vec_p = d.P % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) %
                             (4 * sizeof(float)) == 0;

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
          const int64_t cq = c0 + q * kStep;
          if (copy_j)
            copy_tile<kTLd, kStep>(tile_j + q * kStep, src_j + cq, ld_j, d.Q - j0, depth - cq, vec,
                                 b_step ? B : x, gtid, 128);
          copy_tile<kTLd, kStep>(tile_i + q * kStep, src_i + cq, ld_i, d.Q - i0, depth - cq, vec,
                               b_step ? C : dy, gtid, 128);
          cp_async_commit();
        }
#pragma unroll 1
        for (int q = 0; q < 4; ++q) {
          cp_async_wait_n(3 - q);
          group_sync(grp_b ? 2 : 1);  // quarter q of both tiles is in
          if (c0 + q * kStep < depth)
            product_nt32<kTLd>(f[0], tile_j + r0 * kTLd + q * kStep, tile_i + q * kStep);
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
            // the sum over heads
            float2* o = reinterpret_cast<float2*>(&dhs[lj * kDLd + 8 * n + 2 * t4]);
            float2 sum = make_float2(dh[0], dh[1]);
            if (h > 0) {
              const float2 prev = *o;
              sum = make_float2(prev.x + dh[0], prev.y + dh[1]);
            }
            *o = sum;
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
          copy_tile<kTLd, kStep>(tc + q * kStep, Ci + s * kW + q * kStep, d.c_ld, d.Q - i0,
                               d.N - s * kW - q * kStep, vec_cb, C, gtid, 128);
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
                  v[e] = j <= i && i < d.Q
                             ? f[0][n][2 * hh + e] * expf(ch[kT + li] - cj)
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

// The 128-wide chunks of N that one bwd_i block holds dC for: 64 floats of
// dC a lane, as bwd_j's accumulators. Where N > 128 each block forms every
// head's dS for its own chunks, ceil(N / (128 kIChunks)) times per tile
// pair. At the WikiText Mamba-2 shape (N 512) 2 forms dS twice against 4
// times with 1, in half the blocks: chip_smoke.py's timing of bwd_i there,
// run from this tree and from a copy with kIChunks = 1, decided it
// (PERF.md, row 3); at the MQAR shape, one chunk either way. A dC
// accumulator of all 512 columns in shared memory (128 KB) does not fit
// beside the four 64 x 128 operand tiles (139 KB).
constexpr int kIChunks = 2;
static_assert(kIChunks == 1 || kIChunks == 2, "dC's chunks swap through acc[0]");
// C_i, B_j, dy_i and x_j, CB, dCB and cs: 176,128 bytes
constexpr int kBwdISmemFloats = 4 * kT * kTLd + kT * kCBLd + kT * kDLd + 4 * kT;

// grid (BG, ceil(N / (128 kIChunks)), ceil(Q / 64)), dynamic shared memory
// kBwdISmemFloats; block (bg, s, i-tile), i-tile = last - blockIdx.z. Warps
// 0-3 are group A (each head's dS = dy_i x_j^T over P, Dh = dS * decay, dcs_i
// += rowsum(Dh * CB) where s = 0, dCB = sum over heads of Dh), warps 4-7
// group B (CB = C_i B_j^T over N, where s = 0); warp w of either holds rows
// 16 (w % 4) + g and + 8 of the i-tile, and columns 8n + 2t4 and + 1 of each
// C fragment (j for CB and dS, N for dC). Each j-tile is a sequence of steps,
// as in bwd_j: group B forms CB over the ceil(N / 128) chunks of N, group A
// each head's dS over the ceil(P / 128) chunks of P (starting late enough
// that CB is published before it needs it for dcs_i); then both groups add
// dCB B_j to dC, group A the first 64 columns of each of the block's chunks
// of N, group B the last 64.
__global__ void __launch_bounds__(kBwdThreads, 1)
decay_attention_bwd_i_kernel(const float* __restrict__ C, const float* __restrict__ B,
                             const float* __restrict__ cs, const float* __restrict__ x,
                             const float* __restrict__ dy, float* __restrict__ dC,
                             float* __restrict__ dcs_i, Dims d) {
  extern __shared__ __align__(16) float smem[];
  float* tc = smem;              // C_i: a 128-wide chunk of N; dC's second chunk of B_j
  float* tb = tc + kT * kTLd;    // B_j: the same chunk; dC's first chunk of B_j
  float* ty = tb + kT * kTLd;    // dy_i of a head: a 128-wide chunk of P
  float* tx = ty + kT * kTLd;    // x_j of the same
  float* cbs = tx + kT * kTLd;   // CB [kT][kCBLd]
  float* dhs = cbs + kT * kCBLd; // dCB = sum over heads of Dh [kT][kDLd]
  float* cs_a = dhs + kT * kDLd; // [head parity][i, j][kT] (group A)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const bool grp_b = warp >= 4;
  const int gtid = threadIdx.x % 128;
  const int r0 = 16 * (warp % 4);
  const int64_t bg = blockIdx.x, s = blockIdx.y;
  const int64_t i0 = static_cast<int64_t>(gridDim.z - 1 - blockIdx.z) * kT;
  const int64_t nN = (d.N + kW - 1) / kW, nP = (d.P + kW - 1) / kW;
  const int64_t a_steps = d.Hg * nP;
  // CB serves dcs_i alone: block s = 0 forms it, and there group A's first
  // head ends no earlier than group B's last chunk
  const int64_t b_steps = s == 0 ? nN : 0;
  const int64_t a0 = s == 0 && nN > nP ? nN - nP : 0;
  const int64_t n_steps = b_steps > a0 + a_steps ? b_steps : a0 + a_steps;
  // C_i, and dy_i, stay put across the j-tiles; where N <= 128 the B_j that
  // group B copied is also dC's operand
  const bool one_n = nN == 1, one_p = a_steps == 1;
  const float* Ci = C + bg * d.c_bs + i0 * d.c_ld;
  const float* Bb = B + bg * d.b_bs;
  const float* xb = x + bg * d.Hg * d.Q * d.P;
  const float* dyb = dy + bg * d.Hg * d.Q * d.P;
  const bool vec_cb = (d.N | d.c_bs | d.c_ld | d.b_bs | d.b_ld) % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(B)) %
                              (4 * sizeof(float)) == 0;
  const bool vec_p = d.P % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) %
                             (4 * sizeof(float)) == 0;

  float acc[kIChunks][8][4];  // dC of the thread's two rows, by chunk
#pragma unroll
  for (int c = 0; c < kIChunks; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[c][n][r] = 0.f;
  float f[1][8][4];  // CB (group B), or dS of the current head (group A)
  float dcs_prev[2] = {0.f, 0.f};  // dcs_i so far of the head's rows (group A, block s = 0)

  for (int64_t j0 = 0; j0 <= i0; j0 += kT) {
    const bool first = j0 == 0;
    const float* Bj = Bb + j0 * d.b_ld;
    for (int64_t k = 0; k < n_steps; ++k) {
      const bool b_step = grp_b && k < b_steps;
      const bool a_step = !grp_b && k >= a0 && k < a0 + a_steps;
      const int64_t h = a_step ? (k - a0) / nP : 0, p0 = a_step ? (k - a0) % nP * kW : 0;
      if (b_step || a_step) {
        // the group's product of the step, one code for both: rows of the
        // i-tile (C_i, or dy_i of head h) times rows of the j-tile (B_j, or
        // x_j of head h) over the chunk [c0, c0 + 128) of N or P
        const int64_t c0 = b_step ? k * kW : p0, depth = b_step ? d.N : d.P;
        const float* src_i = b_step ? Ci : dyb + (h * d.Q + i0) * d.P;
        const float* src_j = b_step ? Bj : xb + (h * d.Q + j0) * d.P;
        const int64_t ld_i = b_step ? d.c_ld : d.P, ld_j = b_step ? d.b_ld : d.P;
        float* tile_i = b_step ? tc : ty;
        float* tile_j = b_step ? tb : tx;
        const bool vec = b_step ? vec_cb : vec_p;
        const bool copy_i = !(b_step ? one_n : one_p) || first;
        if (b_step ? k == 0 : p0 == 0) zero_frags(f);
        if (a_step && p0 == 0) {  // head h's cs; its dcs_i so far, in flight meanwhile
          float* csh = cs_a + (h & 1) * 2 * kT;
          const int64_t row = (gtid / kT ? j0 : i0) + gtid % kT;
          csh[gtid] = row < d.Q ? cs[(bg * d.Hg + h) * d.Q + row] : 0.f;
          if (s == 0 && !first && t4 == 0) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int64_t i = i0 + r0 + g + 8 * hh;
              dcs_prev[hh] = i < d.Q ? dcs_i[(bg * d.Hg + h) * d.Q + i] : 0.f;
            }
          }
        }
#pragma unroll 1
        for (int q = 0; q < 4; ++q) {  // a copy group a depth quarter
          const int64_t cq = c0 + q * kStep;
          if (copy_i)
            copy_tile<kTLd, kStep>(tile_i + q * kStep, src_i + cq, ld_i, d.Q - i0, depth - cq,
                                   vec, b_step ? C : dy, gtid, 128);
          copy_tile<kTLd, kStep>(tile_j + q * kStep, src_j + cq, ld_j, d.Q - j0, depth - cq, vec,
                                 b_step ? B : x, gtid, 128);
          cp_async_commit();
        }
#pragma unroll 1
        for (int q = 0; q < 4; ++q) {
          cp_async_wait_n(3 - q);
          group_sync(grp_b ? 2 : 1);  // quarter q of both tiles is in
          if (c0 + q * kStep < depth)
            product_nt32<kTLd>(f[0], tile_i + r0 * kTLd + q * kStep, tile_j + q * kStep);
        }
        if (b_step && k == nN - 1) {  // publish CB for group A's dcs_i
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int n = 0; n < 8; ++n)
              *reinterpret_cast<float2*>(&cbs[(r0 + g + 8 * hh) * kCBLd + 8 * n + 2 * t4]) =
                  make_float2(f[0][n][2 * hh], f[0][n][2 * hh + 1]);
        }
      }
      __syncthreads();  // the step's tiles are free again; CB is published
      if (a_step && p0 + kW >= d.P) {  // head h's dS is whole: Dh, dcs_i, dCB
        const float* csh = cs_a + (h & 1) * 2 * kT;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int li = r0 + g + 8 * hh;
          const int64_t i = i0 + li;
          const float ci = csh[li];
          float part = 0.f;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            float dh[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int lj = 8 * n + 2 * t4 + e;
              const int64_t j = j0 + lj;
              dh[e] = j <= i && i < d.Q ? f[0][n][2 * hh + e] * expf(ci - csh[kT + lj]) : 0.f;
            }
            if (s == 0) {
              const float2 cb =
                  *reinterpret_cast<const float2*>(&cbs[li * kCBLd + 8 * n + 2 * t4]);
              part = fmaf(dh[0], cb.x, part);
              part = fmaf(dh[1], cb.y, part);
            }
            // the sum over heads
            float2* o = reinterpret_cast<float2*>(&dhs[li * kDLd + 8 * n + 2 * t4]);
            float2 sum = make_float2(dh[0], dh[1]);
            if (h > 0) {
              const float2 prev = *o;
              sum = make_float2(prev.x + dh[0], prev.y + dh[1]);
            }
            *o = sum;
          }
          if (s == 0) {
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            if (t4 == 0 && i < d.Q) dcs_i[(bg * d.Hg + h) * d.Q + i] = dcs_prev[hh] + part;
          }
        }
      }
    }

    // the second product, one code for both groups: dC += dCB B_j over the
    // j-tile's 64 rows, group A into the first 64 columns of each of the
    // block's chunks of N, group B into the last 64
    if (!one_n) {  // the block's chunks of B_j
#pragma unroll
      for (int c = 0; c < kIChunks; ++c) {
        const int64_t n0 = (s * kIChunks + c) * kW;
        if (n0 < d.N)
          copy_tile<kTLd, kW>(c ? tc : tb, Bj + n0, d.b_ld, d.Q - j0, d.N - n0, vec_cb, B,
                              threadIdx.x, kBwdThreads);
      }
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();  // the chunks and every warp's dCB are in
#pragma unroll 1
    for (int c = 0; c < kIChunks; ++c) {
      // acc[0] is the chunk in hand: the two swap places after each chunk
      if ((s * kIChunks + c) * kW + (grp_b ? kT : 0) < d.N)  // uniform over the group
        product_64<kDLd, kTLd>(acc[0], dhs + r0 * kDLd, (c ? tc : tb) + (grp_b ? kT : 0));
      if constexpr (kIChunks == 2) swap_frags(acc[0], acc[kIChunks - 1]);
    }
    __syncthreads();  // every warp is past the j-tile's tiles and dCB
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int64_t i = i0 + r0 + g + 8 * hh;
    if (i >= d.Q) continue;
#pragma unroll
    for (int c = 0; c < kIChunks; ++c) {
      const int64_t n0 = (s * kIChunks + c) * kW + (grp_b ? kT : 0);
      float* out = dC + (bg * d.Q + i) * d.N + n0;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * n + 2 * t4 + e;
          if (n0 + col < d.N) out[col] = acc[c][n][2 * hh + e];
        }
    }
  }
}

constexpr int64_t kMaxGridYZ = 65535;

int64_t tiles(int64_t n) { return (n + kT - 1) / kT; }

int launch_fwd(const float* C, const float* B, const float* cs, const float* x, float* y,
               int64_t BG, int64_t Q, int64_t N, int64_t Hg, int64_t P, int64_t c_bs,
               int64_t c_ld, int64_t b_bs, int64_t b_ld, void* stream) {
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

int launch_bwd_i(const float* C, const float* B, const float* cs, const float* x,
                 const float* dy, float* dC, float* dcs_i, int64_t BG, int64_t Q, int64_t N,
                 int64_t Hg, int64_t P, int64_t c_bs, int64_t c_ld, int64_t b_bs, int64_t b_ld,
                 void* stream) {
  const int64_t blocks = (N + kIChunks * kW - 1) / (kIChunks * kW);
  if (blocks > kMaxGridYZ || tiles(Q) > kMaxGridYZ || BG > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld};
  const int smem = kBwdISmemFloats * static_cast<int>(sizeof(float));
  const cudaError_t err = cudaFuncSetAttribute(
      decay_attention_bwd_i_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(BG), static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(tiles(Q)));
  decay_attention_bwd_i_kernel
      <<<grid, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(C, B, cs, x, dy, dC,
                                                                      dcs_i, d);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_j(const float* C, const float* B, const float* cs, const float* x,
                 const float* dy, float* dB, float* dx, float* dcs_j, int64_t BG, int64_t Q,
                 int64_t N, int64_t Hg, int64_t P, int64_t c_bs, int64_t c_ld, int64_t b_bs,
                 int64_t b_ld, void* stream) {
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
  decay_attention_bwd_j_kernel
      <<<grid, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(C, B, cs, x, dy, dB, dx,
                                                                      dcs_j, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a shape the grid cannot hold.
// Shapes: BG, Q, N, Hg, P >= 1; strides in elements.
extern "C" int tlie_decay_attention_fwd_f32(const float* C, const float* B, const float* cs,
                                            const float* x, float* y, int64_t BG, int64_t Q,
                                            int64_t N, int64_t Hg, int64_t P, int64_t c_bs,
                                            int64_t c_ld, int64_t b_bs, int64_t b_ld,
                                            void* stream) {
  return launch_fwd(C, B, cs, x, y, BG, Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld, stream);
}

extern "C" int tlie_decay_attention_bwd_i_f32(const float* C, const float* B, const float* cs,
                                              const float* x, const float* dy, float* dC,
                                              float* dcs_i, int64_t BG, int64_t Q, int64_t N,
                                              int64_t Hg, int64_t P, int64_t c_bs, int64_t c_ld,
                                              int64_t b_bs, int64_t b_ld, void* stream) {
  return launch_bwd_i(C, B, cs, x, dy, dC, dcs_i, BG, Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld,
                      stream);
}

extern "C" int tlie_decay_attention_bwd_j_f32(const float* C, const float* B, const float* cs,
                                              const float* x, const float* dy, float* dB,
                                              float* dx, float* dcs_j, int64_t BG, int64_t Q,
                                              int64_t N, int64_t Hg, int64_t P, int64_t c_bs,
                                              int64_t c_ld, int64_t b_bs, int64_t b_ld,
                                              void* stream) {
  return launch_bwd_j(C, B, cs, x, dy, dB, dx, dcs_j, BG, Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld,
                      stream);
}
