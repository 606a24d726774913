// The SSD decay attention's forward and both its backward kernels on
// bfloat16 operands, designed for Hopper's shared memory and mma.sync:
//
//   y[bg,h,i,:] = sum_{j<=i} bf16(C_i . B_j * exp(cs_i - cs_j)) * x[bg,h,j,:]
//
// Replaces, on bfloat16 operands, the three TPU kernels of tlie_tpu/ops/pallas_ssd.py:
//   tlie_decay_attention_fwd_bf16   <- _fwd (pallas_call at :252, body _fwd_kernel :103)
//   tlie_decay_attention_bwd_i_bf16 <- the pallas_call at :272 (_bwd_i_kernel :132): dC, +dcs_i
//   tlie_decay_attention_bwd_j_bf16 <- the pallas_call at :293 (_bwd_j_kernel :174): dB, dx, -dcs_j
// The float32 kernels are decay_attention.cu's, whose header gives the
// layout: C and B (BG, Q, N) with any batch and row strides and the last
// dimension contiguous, cs (BG, Hg, Q) float32, x, y, dy, dx (BG, Hg, Q, P),
// dC and dB (BG, Q, N), dcs_i and dcs_j (BG, Hg, Q) float32, all but C and
// B contiguous.
//
// What they compute, as the Pallas kernels on bfloat16 operands: C.B summed
// in float32 from exact products of bfloat16 values; the score S = C.B *
// exp(cs_i - cs_j) rounded to bfloat16 (to nearest even) before S x
// (forward) and S^T dy (bwd_j); dS^T = x dy^T in float32, dcs_j = -sum_i
// dS^T * decay * C.B in float32; dCB^T = sum over heads of dS^T * decay,
// summed in float32 in the order h = 0 .. Hg - 1 and rounded to bfloat16
// after the last head, before dCB^T C; bwd_i the same mirrored (dS = dy x^T,
// dcs_i = +sum_j dS * decay * C.B, dCB rounded after the last head before
// dCB B); y, dC, dB and dx rounded to bfloat16 once from their float32
// sums. The decay is exp(cs_i - cs_j), never a product of
// two exps, and is evaluated only where j <= i < Q. Each output element has
// one writer: no atomics, and every launch is deterministic.
//
// Bound on the H100: at the WikiText Mamba-2 shape (BG 8, Q 1024, N 512, Hg
// 8, P 64) the forward moves 33.8 MB (0.010 ms at 3.35 TB/s), bwd_i does
// 12.9 GFLOP and bwd_j 17.2 GFLOP of bfloat16 products over the causal pairs
// (0.013 and 0.017 ms at 989 TFLOP/s). None is near its bound: the time
// goes to the walk over the tile pairs and its epilogues (PERF.md).
//
// Design, for both kernels:
//   tiles:  bfloat16 in shared memory, 64 x 64 (kT x kT) a tile, rows kLd =
//           72 elements apart (144 bytes: the eight 16-byte rows of an
//           ldmatrix matrix fall on distinct banks), landed by 16-byte
//           cp.async where N, P, C's and B's strides and the four base
//           pointers allow 8-element alignment (kVec, decided on the host
//           and compiled apart), else by ordinary loads (the ragged (3, 77,
//           40, 3, 33) of the tests, C or xdt off a 16-byte boundary).
//           Fragments come by ldmatrix, .trans for the operands read
//           [k][n]: x_j in S x, dy_i in S^T dy, C_i in dCB^T C.
//   steps:  a tile pair is a fixed sequence of stages, each two 64 x 64
//           tiles (and 64 floats of cs where a score needs it) in one slot
//           of a ring of kStages = 3, 64 deep a barrier. The ring runs
//           kAhead = 2 stages ahead across tile boundaries: stage q + 2,
//           the next tile's first ones included, is issued right after the
//           barrier of stage q, before q is multiplied and before any
//           epilogue, so no stage waits on memory unless the products are
//           faster than the copies. The issue side walks the stages with
//           counters (no division by a runtime size on the way).
//   warps:  8 warps in four row bands of 16 rows of the block's tile; the
//           two warps of a band split the other tile's 64 rows (or the
//           accumulator's columns) into halves.
//   sums:   every product is one mma.sync.m16n8k16 on bfloat16 fragments
//           into a fresh float32 sum (kFreshBf16 = 16 deep) that is then
//           added to its float32 accumulator.
//   pairs:  a block walks two tiles, the one with the longest walk and the
//           one with the shortest (tiles t and last - t: i-tiles in the
//           forward and bwd_i, which walk j <= i, j-tiles in bwd_j, which
//           walk i >= j), so every block walks tiles + 1 tile pairs and none
//           waits on a long one at the end; the ring runs on from the first
//           tile into the second.
//
//   forward: block (bg, slab, pair of i-tiles). A slab is up to 2 kFC
//           chunks of y's columns, a chunk 64 columns of one head's P
//           (chunk = h * ceil(P / 64) + p-part); warp band r holds y of its
//           16 rows for kFC chunks (half c: chunks c kFC .. c kFC + kFC - 1
//           of the slab), kFC = 2 at the WikiText shape (two slabs of four
//           heads), 1 at the MQAR shape (Hg 1, P 128: one slab). For each
//           j-tile: ceil(N / 64) stages of C_i B_j^T, each warp forming its
//           band's 16 rows x 32 j of C.B; the halves meet in shared memory
//           (float32), each warp reads its band's 16 x 64 back into
//           registers, and kFC stages of x_j chunks follow, where each warp
//           forms S of its chunk's head from those registers (the exp, the
//           mask, the rounding), packs it as the A fragments of S x_j as it
//           goes (the m16n8 accumulator layout is the m16n8k16 A layout)
//           and multiplies. C.B is formed once per tile pair and slab: twice
//           at the WikiText shape (the float32 kernel: ceil(Hg / 2) = 4
//           times), once at the MQAR shape; each exp once (twice where P >
//           64: each chunk of a head forms it). Why not one slab of eight
//           heads at the WikiText shape: 4 chunks a warp (128 floats of y a
//           lane) beside C.B spilled, and 64 blocks of tile pairs leave half
//           the card idle. mma.sync per tile pair and slab at the WikiText
//           shape: 8 warps x (4 n8 x 4 k16 x 8 steps + 2 chunks x 8 n8 x 4
//           k16) = 6,144.
//   bwd_j:  block (bg, s, pair of j-tiles), walking the i-tiles i >= j;
//           warp (r, c) owns rows 16 r .. of the j-tile and i-half c (32
//           columns) of every score-like tile. Per i-tile: ceil(N / 64)
//           stages of CB^T = B_j C_i^T; then, for each head in order,
//           ceil(P / 64) stages of dS^T = x_j dy_i^T, after the head's last
//           of which the warp forms, on its 16 x 32, decay^T (one exp an
//           element), Dh = dS^T * decay^T, the row sums of Dh * CB^T for
//           dcs_j (block s = 0), dCB^T += Dh (registers, float32, head after
//           head) and, for the heads of the block's dx chunks, S^T =
//           bf16(CB^T * decay^T) into shared memory; after the last head
//           dCB^T goes to shared memory as bfloat16. Then kParts stages of
//           the second products: the band's warp c = 0 adds dCB^T C_i over
//           64 columns of the block's slice of N to dB, the warp c = 1 adds
//           S^T dy_i for one 64-column chunk to dx, each 32 mma.sync a
//           stage, so the two halves of a band do equal work in every stage
//           and no warp idles.
//           Split between blocks: a warp holds kParts x 64 columns of dB or
//           dx (kParts x 32 floats a lane), so a block holds kParts x 64 of
//           dB's N and as many columns of dx's chunks, and there are
//           max(ceil(N / (64 kParts)), ceil(chunks / kParts)) blocks per
//           (bg, j-tile pair). Every block forms CB^T, every head's dS^T
//           and every exp for itself (dCB^T needs all heads, S^T needs
//           CB^T): kParts = 4 at the WikiText shape (dB 64 x 512 and dx 8 x
//           64 x 64, 128 KB each, in two blocks of 128 KB), so 2 x each (the
//           float32 kernel: 4 x CB^T, 4 x each dS^T, 5 x each exp); kParts
//           = 2 and one block at the MQAR shape, once each. A lane holds
//           kRegParts = 1 part in registers and parks the others in shared
//           memory, each coming into registers for its second product: with
//           two parts (or all four) in registers ptxas spilled.
//           mma.sync per tile pair and block at the WikiText shape: 8 warps
//           x (4 n8 x 4 k16 x (8 + 8) stages + 4 x 32) = 12,288.
//   bwd_i:  bwd_j mirrored. Block (bg, s, pair of i-tiles), walking the
//           j-tiles j <= i; warp (r, c) owns rows 16 r .. of the i-tile and
//           j-half c (32 columns) of every score-like tile. Per j-tile: in
//           block s = 0 only (CB serves dcs_i alone), ceil(N / 64) stages of
//           CB = C_i B_j^T; then, for each head in order, ceil(P / 64)
//           stages of dS = dy_i x_j^T, after the head's last of which the
//           warp forms, on its 16 x 32, the decay (one exp an element), Dh =
//           dS * decay, the row sums of Dh * CB for dcs_i (block s = 0, the
//           two halves' partials summed through shared memory when the
//           i-tile ends) and dCB += Dh (registers, float32, head after head);
//           after the last head dCB goes to shared memory as bfloat16. Then
//           kParts stages of dC += dCB B_j, each B_j's columns [128 (kParts
//           s + q), +128) as two tiles read [j][n] by ldmatrix.trans, warp c
//           adding the second 64 into its part q (32 mma.sync a stage).
//           Split between blocks: a warp holds kParts x 64 columns of dC, so
//           a block holds kParts x 128 of N and there are ceil(N / (128
//           kParts)) blocks per (bg, i-tile pair), each forming every head's
//           dS and exp for itself. kParts = 2 at the WikiText shape: dC (64 x
//           512 float32, 128 KB a tile) over two blocks, each with one part
//           in registers and one parked in shared memory as bwd_j parks its
//           (one block holding all four parts, one in registers, took longer,
//           PERF.md row 3b); kParts = 1 and one block where N <= 128 (the
//           MQAR shape). mma.sync per tile pair at the WikiText shape: 8
//           warps x (4 n8 x 4 k16 x (8 + 8) + 2 x 32) = 2,560 in block s = 0,
//           8 x (4 x 4 x 8 + 2 x 32) = 1,536 in block s = 1.
// Each tile's values live only inside its loop (C.B, CB^T, dS^T and dCB^T
// are zeroed where a tile or head starts), so the accumulators and one
// tile's fragments are all a warp holds at a time.
// Shared memory: the ring 56,832 bytes; the forward's C.B 18,432; bwd_j's
// S^T slots kParts x 9,216, dCB^T 9,216, CB^T 18,432 (float32: each lane
// parks its own elements there between heads), the parked accumulator
// parts 32,768 each and the dcs_j partials 512 Hg (223,744 bytes at the
// WikiText shape; where Hg leaves no room for kParts = 4, kParts = 2);
// bwd_i's dCB 9,216, CB 18,432 (float32, as bwd_j's CB^T), the parked dC
// parts 32,768 each and the dcs_i partials 512 Hg (121,344 bytes at the
// WikiText shape; where Hg leaves no room for kParts = 2, kParts = 1).
// ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.8): see PERF.md; chip_smoke.py
// prints each kernel's registers and spill bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;           // rows of an i- or j-tile, and columns of a stage's tile
constexpr int kFreshBf16 = 16;   // depth of one fresh tensor-core sum: one m16n8k16
constexpr int kLd = kT + 8;      // row stride of a bfloat16 tile in shared memory (144 bytes)
constexpr int kCBLd = kT + 8;    // row stride of the forward's float32 C.B, in floats
constexpr int kStages = 3;       // slots of the ring
constexpr int kAhead = 2;        // stages issued ahead of the one multiplied
constexpr int kThreads = 256;    // 8 warps: 4 row bands x 2 halves
constexpr int kChunk = 8;        // bfloat16 elements in one 16-byte copy
constexpr int kTileElems = kT * kLd;
// a ring slot: two tiles and two rows of kT floats of cs
constexpr int kSlotBytes = 2 * kTileElems * 2 + 2 * kT * 4;
static_assert(kAhead < kStages, "a slot is reissued only after every warp has left it");
static_assert(kSlotBytes % 16 == 0 && (2 * kTileElems * 2) % 16 == 0, "16-byte alignment");

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// -- copies ------------------------------------------------------------------------

// 16 (or 4) bytes from global to shared memory, not through registers; where
// `in` is false nothing is read and the bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(a), "l"(src),
               "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One element by an ordinary load and store, zero where `in` is false.
__device__ __forceinline__ void copy_scalar(bf16* dst, const bf16* src, bool in) {
  *dst = in ? *src : __float2bfloat16_rn(0.f);
}

// Starts landing rows [0, 64) and columns [0, 64) of the tile whose first
// element is `src` (rows ld apart) in `dst`, zero at or past `rows` rows or
// `cols` columns (either may be <= 0). By 16-byte cp.async where kVec (cols
// a multiple of 8 where it is below 64, ld a multiple of 8, src 16-byte
// aligned), else by ordinary loads (done on return). A zero-filled copy is
// handed `safe`, an element of the tensor at a 16-byte boundary where kVec,
// so no copy gets an address outside it.
template <bool kVec>
__device__ __forceinline__ void land_tile(bf16* dst, const bf16* src, int ld, int rows, int cols,
                                          const bf16* safe) {
  if constexpr (kVec) {
#pragma unroll
    for (int it = 0; it < kT * kT / kChunk / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads, r = e / (kT / kChunk),
                c = kChunk * (e % (kT / kChunk));
      const bool in = r < rows && c < cols;
      cp_async16(dst + r * kLd + c, in ? src + r * ld + c : safe, in);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kT * kT / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads, r = e / kT, c = e % kT;
      const bool in = r < rows && c < cols;
      copy_scalar(dst + r * kLd + c, in ? src + r * ld + c : safe, in);
    }
  }
}

// Starts landing kT floats of cs from `src` (0 at or past `rows`), by threads 0-63.
__device__ __forceinline__ void land_cs(float* dst, const float* src, int rows,
                                        const float* safe) {
  const int r = threadIdx.x;
  if (r < kT) {
    const bool in = r < rows;
    cp_async4(dst + r, in ? src + r : safe, in);
  }
}

// -- tensor cores --------------------------------------------------------------------

// Four 8 x 8 matrices of 16-bit elements from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8. Without .trans lane l receives row
// l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of each matrix, one register a
// matrix; with .trans the same of the transposed matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// acc += a · b for one 16 x 8 x 16 fragment (PTX "mma.m16n8k16", .bf16) summed
// into a fresh float32 sum first, then added: with g = lane / 4 and t =
// lane % 4, a holds A(g, 2t..2t+1), A(g+8, 2t..2t+1), A(g, 2t+8..2t+9),
// A(g+8, 2t+8..2t+9); b holds B(2t..2t+1, g), B(2t+8..2t+9, g); acc holds
// C(g, 2t), C(g, 2t+1), C(g+8, 2t), C(g+8, 2t+1).
__device__ __forceinline__ void mma_fresh(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] += c[r];
}

static_assert(kFreshBf16 == 16, "a fresh sum is one m16n8k16");

// the bfloat16 pair (lo, hi) in one register, lo in the low half, each
// rounded to nearest even: two neighbouring elements of an A fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The decay exp(cs_i - cs_j) of one element.
__device__ __forceinline__ float decay_exp(float d) { return expf(d); }

// The first products: acc[0..3] += the 16 rows (r0..) of tile `ta` times the
// 32 rows (c0..) of tile `tb`, over the tiles' 64 columns (A B^T, both
// [row][k]): n8 fragment n of acc holds columns c0 + 8 n.. .
template <int kN>
__device__ __forceinline__ void product_nt(float (&acc)[kN][4], const bf16* ta, const bf16* tb,
                                           int r0, int c0) {
  static_assert(kN >= 4, "four n8 fragments");
  const int lane = threadIdx.x % 32, lr = lane % 8, lm = lane / 8;
#pragma unroll
  for (int kk = 0; kk < kT; kk += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, ta + (r0 + lr + 8 * (lm % 2)) * kLd + kk + 8 * (lm / 2));
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      // matrices (n +0, k +0), (+0, +8), (+8, +0), (+8, +8): two n8 fragments
      uint32_t r[4];
      ldmatrix_x4(r, tb + (c0 + 16 * jj + lr + 8 * (lm / 2)) * kLd + kk + 8 * (lm % 2));
      mma_fresh(acc[2 * jj], a, r[0], r[1]);
      mma_fresh(acc[2 * jj + 1], a, r[2], r[3]);
    }
  }
}

// The second products: acc += A (the warp's 16 rows, 64 deep) times the
// [k][n] tile `tv` (64 x 64); afrag(kk, a) gives the A fragment of depths
// 16 kk .. 16 kk + 15. The four depth steps are unrolled where kUnrolled
// (the forward's A fragments come from registers, indexed by kk), else
// rolled, which holds fewer fragments in flight.
template <bool kUnrolled, class AFrag>
__device__ __forceinline__ void product_kn(float (&acc)[8][4], AFrag afrag, const bf16* tv) {
  const int lane = threadIdx.x % 32, lr = lane % 8, lm = lane / 8;
  auto step = [&](int kk) {
    uint32_t a[4];
    afrag(kk, a);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      // matrices (k +0, n +0), (+8, +0), (+0, +8), (+8, +8), transposed
      uint32_t r[4];
      ldmatrix_x4_trans(r, tv + (16 * kk + lr + 8 * (lm % 2)) * kLd + 16 * jj + 8 * (lm / 2));
      mma_fresh(acc[2 * jj], a, r[0], r[1]);
      mma_fresh(acc[2 * jj + 1], a, r[2], r[3]);
    }
  };
  if constexpr (kUnrolled) {
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) step(kk);
  } else {
#pragma unroll 1
    for (int kk = 0; kk < kT / 16; ++kk) step(kk);
  }
}

// The A fragment of depths 16 kk.. from a bfloat16 [row][k] block in shared
// memory (rows kLd apart), for the warp's 16 rows from r0.
__device__ __forceinline__ void afrag_smem(uint32_t (&a)[4], const bf16* t, int r0, int kk) {
  const int lane = threadIdx.x % 32, lr = lane % 8, lm = lane / 8;
  ldmatrix_x4(a, t + (r0 + lr + 8 * (lm % 2)) * kLd + 16 * kk + 8 * (lm / 2));
}

template <int kN>
__device__ __forceinline__ void zero(float (&c)[kN][4]) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[n][r] = 0.f;
}

struct Dims {
  int64_t Q, N, Hg, P;
  int64_t c_bs, c_ld, b_bs, b_ld;  // batch and row strides of C and B, in elements
};

__host__ __device__ __forceinline__ int64_t parts(int64_t n) { return (n + kT - 1) / kT; }

// Whether C, B, x and dy land by 16-byte copies (the kernels' kVec): N, P,
// C's and B's batch and row strides allow 8-element alignment and the four
// bases 16-byte alignment. Else every tile lands by ordinary loads.
bool vec_tiles(const bf16* C, const bf16* B, const bf16* x, const bf16* dy, const Dims& d) {
  return (d.N | d.P | d.c_bs | d.c_ld | d.b_bs | d.b_ld) % kChunk == 0 &&
         (reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(B) |
          reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dy)) % 16 == 0;
}

// -- forward -------------------------------------------------------------------------

constexpr int kFwdSmemBytes = kStages * kSlotBytes + kT * kCBLd * 4;

// The tiles of a block that walks a pair of them: tile `last - p`, the
// longest walk, then tile p, the shortest (one tile where they are the same),
// so that every pair walks tiles + 1 tile pairs and the blocks end together.
struct TilePair {
  int first, second, n;  // the two tiles, and how many (1 or 2)
  __device__ TilePair(int tiles, int p, bool long_first) {
    first = long_first ? tiles - 1 - p : p;
    second = long_first ? p : tiles - 1 - p;
    n = first == second ? 1 : 2;
  }
};

// grid (BG * slabs, ceil(tiles / 2)), dynamic shared memory kFwdSmemBytes;
// block (bg, slab, pair of i-tiles). Warp w: band r = w % 4 (rows 16 r.. of
// the i-tile), half c = w / 4. A tile pair (i-tile, j-tile) is n_st = ceil(N
// / 64) + kFC stages: stage k < nN holds C_i's and B_j's columns [64 k,
// 64 k + 64), stage nN + q the x_j chunks q (half 0) and kFC + q (half 1)
// of the slab with their heads' cs of the j-tile.
template <int kFC, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
decay_attention_fwd_bf16_kernel(const bf16* __restrict__ C, const bf16* __restrict__ B,
                                const float* __restrict__ cs, const bf16* __restrict__ x,
                                bf16* __restrict__ y, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cbx = reinterpret_cast<float*>(smem + kStages * kSlotBytes);  // C.B [kT][kCBLd]
  // the head and first column of P of each of the slab's chunks (-1: past the last)
  __shared__ int2 chunk_hp[2 * kFC];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int band = warp % 4, half = warp / 4, r0 = 16 * band;
  const int nP = static_cast<int>(parts(d.P)), n_chunks = static_cast<int>(d.Hg) * nP;
  const int slabs = (n_chunks + 2 * kFC - 1) / (2 * kFC);
  const int64_t bg = blockIdx.x / slabs;
  const int chunk0 = blockIdx.x % slabs * 2 * kFC;
  const TilePair tp(static_cast<int>(parts(d.Q)), blockIdx.y, true);
  const int nN = static_cast<int>(parts(d.N));
  const int n_st = nN + kFC;
  const int Q = static_cast<int>(d.Q), N = static_cast<int>(d.N), P = static_cast<int>(d.P);
  const int c_ld = static_cast<int>(d.c_ld), b_ld = static_cast<int>(d.b_ld);
  const bf16* Cb = C + bg * d.c_bs;  // the batch's C, B, x and cs; each also the
  const bf16* Bb = B + bg * d.b_bs;  // address a zero-filled copy is handed
  const bf16* xb = x + bg * d.Hg * d.Q * d.P;
  const float* csb = cs + bg * d.Hg * d.Q;
  if (threadIdx.x < 2 * kFC) {
    const int ch = chunk0 + threadIdx.x;
    chunk_hp[threadIdx.x] = ch < n_chunks ? make_int2(ch / nP, ch % nP * kT) : make_int2(-1, 0);
  }
  __syncthreads();

  auto slot = [&](int q) { return reinterpret_cast<bf16*>(smem + q % kStages * kSlotBytes); };
  auto slot_cs = [&](int q) {
    return reinterpret_cast<float*>(smem + q % kStages * kSlotBytes + 2 * kTileElems * 2);
  };
  // the stage the next issue lands (stage qi, in slot qi): its i-tile (first
  // or second), j-tile and step
  int c_tile = 0, c_jt = 0, c_k = 0;
  auto issue = [&](int qi) {
    if (c_tile < tp.n) {
      const int it = c_tile == 0 ? tp.first : tp.second;
      const int i0 = it * kT, j0 = c_jt * kT;
      bf16* st = slot(qi);
      if (c_k < nN) {
        const int n0 = c_k * kT;
        land_tile<kVec>(st, Cb + static_cast<int64_t>(i0) * c_ld + n0, c_ld, Q - i0, N - n0, Cb);
        land_tile<kVec>(st + kTileElems, Bb + static_cast<int64_t>(j0) * b_ld + n0, b_ld, Q - j0,
                        N - n0, Bb);
      } else {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int2 hp = chunk_hp[hf * kFC + c_k - nN];
          if (hp.x >= 0) {
            const int64_t row = static_cast<int64_t>(hp.x) * Q + j0;
            land_tile<kVec>(st + hf * kTileElems, xb + row * P + hp.y, P, Q - j0, P - hp.y, xb);
            land_cs(slot_cs(qi) + hf * kT, csb + row, Q - j0, csb);
          }
        }
      }
      if (++c_k == n_st) {  // an i-tile t walks j-tiles 0..t
        c_k = 0;
        if (++c_jt > it) {
          c_jt = 0;
          ++c_tile;
        }
      }
    }
    cp_async_commit();  // one group a stage, empty past the end
  };
  int q = 0;  // the next stage to multiply
  // waits for stage q, lets every warp past the stage before, issues stage
  // q + kAhead into that stage's slot and returns q
  auto next = [&]() {
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    issue(q + kAhead);
    return q++;
  };

#pragma unroll
  for (int a = 0; a < kAhead; ++a) issue(a);
  for (int tt = 0; tt < tp.n; ++tt) {
    const int it = tt == 0 ? tp.first : tp.second;
    const int64_t i0 = static_cast<int64_t>(it) * kT;
    const int rows = static_cast<int>(imin(d.Q - i0, kT));  // rows of the i-tile inside Q
    // cs of the warp's two rows for each of its chunks' heads
    float csi[kFC][2];
#pragma unroll
    for (int c = 0; c < kFC; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int2 hp = chunk_hp[half * kFC + c];
        const int li = r0 + g + 8 * hh;
        csi[c][hh] = hp.x >= 0 && li < rows ? csb[hp.x * d.Q + i0 + li] : 0.f;
      }
    float acc[kFC][8][4];
#pragma unroll
    for (int c = 0; c < kFC; ++c) zero(acc[c]);
    for (int jt = 0; jt <= it; ++jt) {
      // the last j of the tile (local) that row g + 8 hh reaches, -1 past Q
      int lim[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int li = r0 + g + 8 * hh;
        lim[hh] = li < rows ? (it - jt) * kT + li : -1;
      }
      float cb[8][4];  // C.B: the warp's 16 x 32 while it is formed, then its band's 16 x 64
      zero(cb);
      for (int k = 0; k < nN; ++k) {
        const bf16* st = slot(next());
        product_nt(cb, st, st + kTileElems, r0, 32 * half);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)  // the warp's 16 x 32 to shared memory
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<float2*>(&cbx[(r0 + g + 8 * hh) * kCBLd + 32 * half + 8 * n + 2 * t4]) =
              make_float2(cb[n][2 * hh], cb[n][2 * hh + 1]);
#pragma unroll
      for (int c = 0; c < kFC; ++c) {
        const int sq = next();
        if (c == 0) {  // the band's 16 x 64 of C.B, both halves (in since this barrier)
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 v = *reinterpret_cast<const float2*>(
                  &cbx[(r0 + g + 8 * hh) * kCBLd + 8 * n + 2 * t4]);
              cb[n][2 * hh] = v.x;
              cb[n][2 * hh + 1] = v.y;
            }
        }
        if (chunk_hp[half * kFC + c].x < 0) continue;  // uniform over the warp
        const float* csj = slot_cs(sq) + half * kT;
        // S of the chunk's head, packed into A fragments as it is formed: the
        // fragment of depths (j) 16 kk.. is n8 fragments 2 kk and 2 kk + 1
        product_kn<true>(acc[c], [&](int kk, uint32_t (&a)[4]) {
          float s[2][2][2];  // [n8 of the pair][row g, g + 8][column pair]
#pragma unroll
          for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int lj = 16 * kk + 8 * u + 2 * t4 + e;
                s[u][hh][e] = lj <= lim[hh]
                                  ? cb[2 * kk + u][2 * hh + e] * decay_exp(csi[c][hh] - csj[lj])
                                  : 0.f;
              }
          a[0] = pack_bf16(s[0][0][0], s[0][0][1]);
          a[1] = pack_bf16(s[0][1][0], s[0][1][1]);
          a[2] = pack_bf16(s[1][0][0], s[1][0][1]);
          a[3] = pack_bf16(s[1][1][0], s[1][1][1]);
        }, slot(sq) + half * kTileElems);
      }
    }
    // y of the i-tile, rounded to bfloat16 once
#pragma unroll
    for (int c = 0; c < kFC; ++c) {
      const int2 hp = chunk_hp[half * kFC + c];
      if (hp.x < 0) continue;
      const int p0 = hp.y;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int li = r0 + g + 8 * hh;
        if (li >= rows) continue;
        bf16* yr = y + ((bg * d.Hg + hp.x) * d.Q + i0 + li) * d.P + p0;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * n + 2 * t4 + e;
            if (p0 + col < d.P) yr[col] = __float2bfloat16_rn(acc[c][n][2 * hh + e]);
          }
      }
    }
  }
  cp_async_wait<0>();
}

// -- bwd_j ---------------------------------------------------------------------------

// Accumulator parts a bwd_j lane holds in registers (32 floats); the rest
// wait in shared memory and come into registers for their second products.
constexpr int kRegParts = 1;
// floats of one parked part: 8 warps x 32 lanes x a lane's 32
constexpr int kParkedPartFloats = kThreads * 32;

// Bytes of bwd_j's dynamic shared memory: the ring, kParts S^T slots, dCB^T,
// CB^T (float32), the parked accumulator parts and the two halves' dcs_j
// partials.
__host__ __device__ constexpr int64_t bwd_j_smem_bytes(int kParts, int64_t Hg) {
  return kStages * kSlotBytes + (kParts + 1) * kTileElems * 2 + kT * kCBLd * 4 +
         (kParts > kRegParts ? kParts - kRegParts : 0) * kParkedPartFloats * 4 + 2 * Hg * kT * 4;
}

// grid (BG, blocks, ceil(tiles / 2)), dynamic shared memory
// bwd_j_smem_bytes; block (bg, s, pair of j-tiles). Warp w: band r = w % 4
// (rows 16 r.. of the j-tile), half c = w / 4 (i-columns 32 c.. of each
// score-like tile; dB if 0, dx if 1). A tile pair (j-tile, i-tile) is n_st =
// nN + Hg nP + kParts stages: stage k < nN holds B_j's and C_i's columns
// [64 k, 64 k + 64); stage nN + h nP + p head h's x_j and dy_i columns
// [64 p, 64 p + 64), with cs of the i-tile and the j-tile in its last; stage
// nN + Hg nP + q the block's C_i columns [64 (kParts s + q), +64) and dy_i
// of its chunk kParts s + q.
template <int kParts, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
decay_attention_bwd_j_bf16_kernel(const bf16* __restrict__ C, const bf16* __restrict__ B,
                                  const float* __restrict__ cs, const bf16* __restrict__ x,
                                  const bf16* __restrict__ dy, bf16* __restrict__ dB,
                                  bf16* __restrict__ dx, float* __restrict__ dcs_j, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stx = reinterpret_cast<bf16*>(smem + kStages * kSlotBytes);  // S^T slots [kParts][kT][kLd]
  bf16* dcbx = stx + kParts * kTileElems;                             // dCB^T [kT][kLd]
  float* cbs = reinterpret_cast<float*>(dcbx + kTileElems);           // CB^T [kT][kCBLd]
  float4* parked = reinterpret_cast<float4*>(cbs + kT * kCBLd);       // parts >= kRegParts
  float* dcs_acc = reinterpret_cast<float*>(parked) +                 // [2][Hg][kT]
                   (kParts > kRegParts ? kParts - kRegParts : 0) * kParkedPartFloats;
  // the head and first column of P of each of the block's dx chunks (-1: past the last)
  __shared__ int2 chunk_hp[kParts];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int band = warp % 4, half = warp / 4, r0 = 16 * band;
  const int64_t bg = blockIdx.x;
  const int s = blockIdx.y;
  const int tiles = static_cast<int>(parts(d.Q));
  const TilePair tp(tiles, blockIdx.z, false);  // j-tile p walks tiles - p i-tiles
  const int nN = static_cast<int>(parts(d.N)), nP = static_cast<int>(parts(d.P));
  const int Hg = static_cast<int>(d.Hg), n_chunks = Hg * nP;
  const int n_st = nN + Hg * nP + kParts;
  const int chunk0 = s * kParts, col0 = chunk0 * kT;  // the block's first dx chunk, dB column
  // the heads of the block's dx chunks, each with an S^T slot
  const int h_first = chunk0 / nP;
  const int h_last = chunk0 < n_chunks ? (min(chunk0 + kParts, n_chunks) - 1) / nP : -1;
  const int Q = static_cast<int>(d.Q), N = static_cast<int>(d.N), P = static_cast<int>(d.P);
  const int c_ld = static_cast<int>(d.c_ld), b_ld = static_cast<int>(d.b_ld);
  const bf16* Cb = C + bg * d.c_bs;  // the batch's C, B, x, dy and cs; each also the
  const bf16* Bb = B + bg * d.b_bs;  // address a zero-filled copy is handed
  const bf16* xb = x + bg * d.Hg * d.Q * d.P;
  const bf16* dyb = dy + bg * d.Hg * d.Q * d.P;
  const float* csb = cs + bg * d.Hg * d.Q;
  if (threadIdx.x < kParts) {
    const int ch = chunk0 + threadIdx.x;
    chunk_hp[threadIdx.x] = ch < n_chunks ? make_int2(ch / nP, ch % nP * kT) : make_int2(-1, 0);
  }
  if (s == 0)
    for (int e = threadIdx.x; e < 2 * Hg * kT; e += kThreads) dcs_acc[e] = 0.f;
  __syncthreads();

  auto slot = [&](int q) { return reinterpret_cast<bf16*>(smem + q % kStages * kSlotBytes); };
  auto slot_cs = [&](int q) {
    return reinterpret_cast<float*>(smem + q % kStages * kSlotBytes + 2 * kTileElems * 2);
  };
  // the stage the next issue lands (stage qi, in slot qi): its j-tile (first
  // or second), i-tile, step, and within the dS^T steps head and part of P
  int c_tile = 0, c_it = tp.first, c_k = 0, c_h = 0, c_p = 0;
  auto issue = [&](int qi) {
    if (c_tile < tp.n) {
      const int j0 = (c_tile == 0 ? tp.first : tp.second) * kT, i0 = c_it * kT;
      bf16* st = slot(qi);
      if (c_k < nN) {
        const int n0 = c_k * kT;
        land_tile<kVec>(st, Bb + static_cast<int64_t>(j0) * b_ld + n0, b_ld, Q - j0, N - n0, Bb);
        land_tile<kVec>(st + kTileElems, Cb + static_cast<int64_t>(i0) * c_ld + n0, c_ld, Q - i0,
                        N - n0, Cb);
      } else if (c_h < Hg) {
        const int64_t hrow = static_cast<int64_t>(c_h) * Q;
        const int p0 = c_p * kT;
        land_tile<kVec>(st, xb + (hrow + j0) * P + p0, P, Q - j0, P - p0, xb);
        land_tile<kVec>(st + kTileElems, dyb + (hrow + i0) * P + p0, P, Q - i0, P - p0, dyb);
        if (c_p == nP - 1) {  // the head's last step: cs of the i-tile and of the j-tile
          land_cs(slot_cs(qi), csb + hrow + i0, Q - i0, csb);
          land_cs(slot_cs(qi) + kT, csb + hrow + j0, Q - j0, csb);
        }
        if (++c_p == nP) {
          c_p = 0;
          ++c_h;
        }
      } else {
        const int q2 = c_k - nN - Hg * nP;
        const int n0 = col0 + q2 * kT;
        const int2 hp = chunk_hp[q2];
        if (n0 < N)
          land_tile<kVec>(st, Cb + static_cast<int64_t>(i0) * c_ld + n0, c_ld, Q - i0, N - n0, Cb);
        if (hp.x >= 0)
          land_tile<kVec>(st + kTileElems, dyb + (static_cast<int64_t>(hp.x) * Q + i0) * P + hp.y,
                          P, Q - i0, P - hp.y, dyb);
      }
      if (++c_k == n_st) {  // a j-tile t walks i-tiles t..tiles - 1
        c_k = c_h = 0;
        if (++c_it == tiles) {
          ++c_tile;
          c_it = tp.second;
        }
      }
    }
    cp_async_commit();  // one group a stage, empty past the end
  };
  int q = 0;  // the next stage to multiply
  // waits for stage q, lets every warp past the stage before, issues stage
  // q + kAhead into that stage's slot and returns q
  auto next = [&]() {
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    issue(q + kAhead);
    return q++;
  };

#pragma unroll
  for (int a = 0; a < kAhead; ++a) issue(a);
  for (int tt = 0; tt < tp.n; ++tt) {
    const int jt = tt == 0 ? tp.first : tp.second;
    const int64_t j0 = static_cast<int64_t>(jt) * kT;
    // dB (half 0) or dx (half 1) of the warp's 16 rows: parts below kRegParts
    // in registers, the others parked in shared memory, the lane's 32 floats
    // of a part as 8 float4 a lane apart
    constexpr int kInRegs = kParts < kRegParts ? kParts : kRegParts;
    float acc[kInRegs][8][4];
#pragma unroll
    for (int c = 0; c < kInRegs; ++c) zero(acc[c]);
    auto park = [&](int c, int n) {
      return parked + ((warp * (kParts - kInRegs) + c - kInRegs) * 8 + n) * 32 + lane;
    };
#pragma unroll
    for (int c = kInRegs; c < kParts; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) *park(c, n) = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int it = jt; it < tiles; ++it) {
      const int64_t i0 = static_cast<int64_t>(it) * kT;
      const int cols = static_cast<int>(imin(d.Q - i0, kT));  // columns of the i-tile inside Q
      {
        float cb[4][4];  // the warp's 16 x 32 of CB^T, to shared memory when whole
        zero(cb);
        for (int k = 0; k < nN; ++k) {  // CB^T = B_j C_i^T
          const bf16* st = slot(next());
          product_nt(cb, st, st + kTileElems, r0, 32 * half);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(
                &cbs[(r0 + g + 8 * hh) * kCBLd + 32 * half + 8 * n + 2 * t4]) =
                make_float2(cb[n][2 * hh], cb[n][2 * hh + 1]);
      }
      float dcb[4][4];  // the warp's 16 x 32 of dCB^T, head after head
      for (int h = 0; h < Hg; ++h) {
        float ds[4][4];  // the warp's 16 x 32 of head h's dS^T = x_j dy_i^T
        zero(ds);
        int sq = 0;
        for (int p = 0; p < nP; ++p) {
          sq = next();
          const bf16* st = slot(sq);
          product_nt(ds, st, st + kTileElems, r0, 32 * half);
        }
        // head h's dS^T is whole: the epilogue on the warp's 16 x 32
        const float* csi = slot_cs(sq);
        const float* csj = csi + kT;
        const bool own = h >= h_first && h <= h_last;  // S^T of a head of the block's dx
        bf16* sts = stx + (own ? h - h_first : 0) * kTileElems;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int lj = r0 + g + 8 * hh;
          const int lo = lj - (it - jt) * kT;  // the first i (local) with i >= j
          const float cj = csj[lj];
          float part = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = 32 * half + 8 * n + 2 * t4;
            const float2 ci = *reinterpret_cast<const float2*>(&csi[col]);
            // CB^T at the lane's own elements, as it wrote them
            const float2 cb2 = *reinterpret_cast<const float2*>(&cbs[lj * kCBLd + col]);
            float st2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int li = col + e;
              const float cb = e ? cb2.y : cb2.x;
              const float dec =
                  li >= lo && li < cols ? decay_exp((e ? ci.y : ci.x) - cj) : 0.f;
              const float dh = ds[n][2 * hh + e] * dec;
              part = fmaf(dh, cb, part);
              // the sum over heads in order, from head 0's own
              dcb[n][2 * hh + e] = h > 0 ? dcb[n][2 * hh + e] + dh : dh;
              st2[e] = cb * dec;
            }
            if (own)
              *reinterpret_cast<__nv_bfloat162*>(&sts[lj * kLd + col]) =
                  __floats2bfloat162_rn(st2[0], st2[1]);
          }
          if (s == 0) {
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            if (t4 == 0) dcs_acc[(half * Hg + h) * kT + lj] += part;
          }
        }
      }
      // the sum over heads is whole: rounded to bfloat16 for dCB^T C_i
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<__nv_bfloat162*>(
              &dcbx[(r0 + g + 8 * hh) * kLd + 32 * half + 8 * n + 2 * t4]) =
              __floats2bfloat162_rn(dcb[n][2 * hh], dcb[n][2 * hh + 1]);
      // the second products: dB += dCB^T C_i (half 0), dx += S^T dy_i (half 1)
#pragma unroll
      for (int c = 0; c < kParts; ++c) {
        const bf16* st = slot(next());
        const int2 hp = chunk_hp[c];
        if (half == 0 ? col0 + c * kT >= d.N : hp.x < 0) continue;  // uniform over the warp
        const bf16* a_src = half == 0 ? dcbx : stx + (hp.x - h_first) * kTileElems;
        auto afrag = [&](int kk, uint32_t (&a)[4]) { afrag_smem(a, a_src, r0, kk); };
        if (c < kInRegs) {
          product_kn<false>(acc[c < kInRegs ? c : 0], afrag, st + half * kTileElems);
        } else {  // a parked part: in, multiplied, back
          float pa[8][4];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float4 v = *park(c, n);
            pa[n][0] = v.x, pa[n][1] = v.y, pa[n][2] = v.z, pa[n][3] = v.w;
          }
          product_kn<false>(pa, afrag, st + half * kTileElems);
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *park(c, n) = make_float4(pa[n][0], pa[n][1], pa[n][2], pa[n][3]);
        }
      }
    }
    __syncthreads();  // the dcs_j partials of the j-tile are whole
    if (s == 0) {
      for (int e = threadIdx.x; e < Hg * kT; e += kThreads) {
        const int h = e / kT, lj = e % kT;
        float* a0 = &dcs_acc[h * kT + lj];
        float* a1 = &dcs_acc[(Hg + h) * kT + lj];
        if (j0 + lj < d.Q) dcs_j[(bg * d.Hg + h) * d.Q + j0 + lj] = -(*a0 + *a1);
        *a0 = 0.f;  // for the pair's next j-tile (its epilogues come after the next barrier)
        *a1 = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < kParts; ++c) {
      float v[8][4];  // the part's float32 sums
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (c < kInRegs) {
#pragma unroll
          for (int r = 0; r < 4; ++r) v[n][r] = acc[c < kInRegs ? c : 0][n][r];
        } else {
          const float4 pv = *park(c, n);
          v[n][0] = pv.x, v[n][1] = pv.y, v[n][2] = pv.z, v[n][3] = pv.w;
        }
      }
      int64_t cols;
      bf16* out;
      if (half == 0) {
        const int64_t n0 = col0 + c * kT;
        if (n0 >= d.N) continue;
        cols = d.N - n0;
        out = dB + (bg * d.Q + j0) * d.N + n0;
      } else {
        const int2 hp = chunk_hp[c];
        if (hp.x < 0) continue;
        cols = d.P - hp.y;
        out = dx + ((bg * d.Hg + hp.x) * d.Q + j0) * d.P + hp.y;
      }
      const int64_t ld = half == 0 ? d.N : d.P;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int lj = r0 + g + 8 * hh;
        if (j0 + lj >= d.Q) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * n + 2 * t4 + e;
            if (col < cols) out[lj * ld + col] = __float2bfloat16_rn(v[n][2 * hh + e]);
          }
      }
    }
  }
  cp_async_wait<0>();
}

// -- bwd_i ---------------------------------------------------------------------------

// Bytes of bwd_i's dynamic shared memory: the ring, dCB (bfloat16), CB
// (float32), the parked dC parts and the two halves' dcs_i partials.
__host__ __device__ constexpr int64_t bwd_i_smem_bytes(int kParts, int64_t Hg) {
  return kStages * kSlotBytes + kTileElems * 2 + kT * kCBLd * 4 +
         (kParts > kRegParts ? kParts - kRegParts : 0) * kParkedPartFloats * 4 + 2 * Hg * kT * 4;
}

// grid (BG, blocks, ceil(tiles / 2)), dynamic shared memory
// bwd_i_smem_bytes; block (bg, s, pair of i-tiles). Warp w: band r = w % 4
// (rows 16 r.. of the i-tile), half c = w / 4 (j-columns 32 c.. of each
// score-like tile; dC columns 64 c.. of each 128-wide part). A tile pair
// (i-tile, j-tile) is n_st = nCB + Hg nP + kParts stages: stage k < nCB
// (nCB = nN in block s = 0, else 0) holds C_i's and B_j's columns [64 k,
// 64 k + 64); stage nCB + h nP + p head h's dy_i and x_j columns [64 p,
// 64 p + 64), with cs of the i-tile and the j-tile in its last; stage nCB +
// Hg nP + q B_j's columns [128 (kParts s + q), +128) as two tiles, one for
// each half.
template <int kParts, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
decay_attention_bwd_i_bf16_kernel(const bf16* __restrict__ C, const bf16* __restrict__ B,
                                  const float* __restrict__ cs, const bf16* __restrict__ x,
                                  const bf16* __restrict__ dy, bf16* __restrict__ dC,
                                  float* __restrict__ dcs_i, Dims d) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* dcbx = reinterpret_cast<bf16*>(smem + kStages * kSlotBytes);  // dCB [kT][kLd]
  float* cbs = reinterpret_cast<float*>(dcbx + kTileElems);           // CB [kT][kCBLd]
  float4* parked = reinterpret_cast<float4*>(cbs + kT * kCBLd);       // parts >= kRegParts
  float* dcs_acc = reinterpret_cast<float*>(parked) +                 // [2][Hg][kT]
                   (kParts > kRegParts ? kParts - kRegParts : 0) * kParkedPartFloats;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int band = warp % 4, half = warp / 4, r0 = 16 * band;
  const int64_t bg = blockIdx.x;
  const int s = blockIdx.y;
  const TilePair tp(static_cast<int>(parts(d.Q)), blockIdx.z, true);  // i-tile t walks 0..t
  const int nN = static_cast<int>(parts(d.N)), nP = static_cast<int>(parts(d.P));
  const int Hg = static_cast<int>(d.Hg);
  const int nCB = s == 0 ? nN : 0;  // CB serves dcs_i alone: block s = 0 forms it
  const int n_st = nCB + Hg * nP + kParts;
  const int col0 = s * kParts * 2 * kT;  // the block's first column of dC
  const int Q = static_cast<int>(d.Q), N = static_cast<int>(d.N), P = static_cast<int>(d.P);
  const int c_ld = static_cast<int>(d.c_ld), b_ld = static_cast<int>(d.b_ld);
  const bf16* Cb = C + bg * d.c_bs;  // the batch's C, B, x, dy and cs; each also the
  const bf16* Bb = B + bg * d.b_bs;  // address a zero-filled copy is handed
  const bf16* xb = x + bg * d.Hg * d.Q * d.P;
  const bf16* dyb = dy + bg * d.Hg * d.Q * d.P;
  const float* csb = cs + bg * d.Hg * d.Q;
  if (s == 0)
    for (int e = threadIdx.x; e < 2 * Hg * kT; e += kThreads) dcs_acc[e] = 0.f;
  __syncthreads();

  auto slot = [&](int q) { return reinterpret_cast<bf16*>(smem + q % kStages * kSlotBytes); };
  auto slot_cs = [&](int q) {
    return reinterpret_cast<float*>(smem + q % kStages * kSlotBytes + 2 * kTileElems * 2);
  };
  // the stage the next issue lands (stage qi, in slot qi): its i-tile (first
  // or second), j-tile, step, and within the dS steps head and part of P
  int c_tile = 0, c_jt = 0, c_k = 0, c_h = 0, c_p = 0;
  auto issue = [&](int qi) {
    if (c_tile < tp.n) {
      const int it = c_tile == 0 ? tp.first : tp.second;
      const int i0 = it * kT, j0 = c_jt * kT;
      bf16* st = slot(qi);
      if (c_k < nCB) {
        const int n0 = c_k * kT;
        land_tile<kVec>(st, Cb + static_cast<int64_t>(i0) * c_ld + n0, c_ld, Q - i0, N - n0, Cb);
        land_tile<kVec>(st + kTileElems, Bb + static_cast<int64_t>(j0) * b_ld + n0, b_ld, Q - j0,
                        N - n0, Bb);
      } else if (c_h < Hg) {
        const int64_t hrow = static_cast<int64_t>(c_h) * Q;
        const int p0 = c_p * kT;
        land_tile<kVec>(st, dyb + (hrow + i0) * P + p0, P, Q - i0, P - p0, dyb);
        land_tile<kVec>(st + kTileElems, xb + (hrow + j0) * P + p0, P, Q - j0, P - p0, xb);
        if (c_p == nP - 1) {  // the head's last step: cs of the i-tile and of the j-tile
          land_cs(slot_cs(qi), csb + hrow + i0, Q - i0, csb);
          land_cs(slot_cs(qi) + kT, csb + hrow + j0, Q - j0, csb);
        }
        if (++c_p == nP) {
          c_p = 0;
          ++c_h;
        }
      } else {
        const int n0 = col0 + (c_k - nCB - Hg * nP) * 2 * kT;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (n0 + hf * kT < N)
            land_tile<kVec>(st + hf * kTileElems,
                            Bb + static_cast<int64_t>(j0) * b_ld + n0 + hf * kT, b_ld, Q - j0,
                            N - n0 - hf * kT, Bb);
      }
      if (++c_k == n_st) {  // an i-tile t walks j-tiles 0..t
        c_k = c_h = 0;
        if (++c_jt > it) {
          c_jt = 0;
          ++c_tile;
        }
      }
    }
    cp_async_commit();  // one group a stage, empty past the end
  };
  int q = 0;  // the next stage to multiply
  // waits for stage q, lets every warp past the stage before, issues stage
  // q + kAhead into that stage's slot and returns q
  auto next = [&]() {
    cp_async_wait<kAhead - 1>();
    __syncthreads();
    issue(q + kAhead);
    return q++;
  };

#pragma unroll
  for (int a = 0; a < kAhead; ++a) issue(a);
  for (int tt = 0; tt < tp.n; ++tt) {
    const int it = tt == 0 ? tp.first : tp.second;
    const int64_t i0 = static_cast<int64_t>(it) * kT;
    const int rows = static_cast<int>(imin(d.Q - i0, kT));  // rows of the i-tile inside Q
    // dC of the warp's 16 rows and 64 columns of each part: parts below
    // kRegParts in registers, the others parked in shared memory, the lane's
    // 32 floats of a part as 8 float4 a lane apart
    constexpr int kInRegs = kParts < kRegParts ? kParts : kRegParts;
    float acc[kInRegs][8][4];
#pragma unroll
    for (int c = 0; c < kInRegs; ++c) zero(acc[c]);
    auto park = [&](int c, int n) {
      return parked + ((warp * (kParts - kInRegs) + c - kInRegs) * 8 + n) * 32 + lane;
    };
#pragma unroll
    for (int c = kInRegs; c < kParts; ++c)
#pragma unroll
      for (int n = 0; n < 8; ++n) *park(c, n) = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int jt = 0; jt <= it; ++jt) {
      if (s == 0) {
        float cb[4][4];  // the warp's 16 x 32 of CB, to shared memory when whole
        zero(cb);
        for (int k = 0; k < nN; ++k) {  // CB = C_i B_j^T
          const bf16* st = slot(next());
          product_nt(cb, st, st + kTileElems, r0, 32 * half);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(
                &cbs[(r0 + g + 8 * hh) * kCBLd + 32 * half + 8 * n + 2 * t4]) =
                make_float2(cb[n][2 * hh], cb[n][2 * hh + 1]);
      }
      // the last j of the tile (local) that row g + 8 hh reaches, -1 past Q
      int lim[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int li = r0 + g + 8 * hh;
        lim[hh] = li < rows ? (it - jt) * kT + li : -1;
      }
      float dcb[4][4];  // the warp's 16 x 32 of dCB, head after head
      for (int h = 0; h < Hg; ++h) {
        float ds[4][4];  // the warp's 16 x 32 of head h's dS = dy_i x_j^T
        zero(ds);
        int sq = 0;
        for (int p = 0; p < nP; ++p) {
          sq = next();
          const bf16* st = slot(sq);
          product_nt(ds, st, st + kTileElems, r0, 32 * half);
        }
        // head h's dS is whole: the epilogue on the warp's 16 x 32
        const float* csi = slot_cs(sq);
        const float* csj = csi + kT;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int li = r0 + g + 8 * hh;
          const float ci = csi[li];
          float part = 0.f;
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = 32 * half + 8 * n + 2 * t4;
            const float2 cj = *reinterpret_cast<const float2*>(&csj[col]);
            // CB at the lane's own elements, as it wrote them (block s = 0)
            const float2 cb2 = s == 0 ? *reinterpret_cast<const float2*>(&cbs[li * kCBLd + col])
                                      : make_float2(0.f, 0.f);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dec = col + e <= lim[hh] ? decay_exp(ci - (e ? cj.y : cj.x)) : 0.f;
              const float dh = ds[n][2 * hh + e] * dec;
              part = fmaf(dh, e ? cb2.y : cb2.x, part);
              // the sum over heads in order, from head 0's own
              dcb[n][2 * hh + e] = h > 0 ? dcb[n][2 * hh + e] + dh : dh;
            }
          }
          if (s == 0) {
            part += __shfl_xor_sync(0xffffffffu, part, 1);
            part += __shfl_xor_sync(0xffffffffu, part, 2);
            if (t4 == 0) dcs_acc[(half * Hg + h) * kT + li] += part;
          }
        }
      }
      // the sum over heads is whole: rounded to bfloat16 for dCB B_j
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          *reinterpret_cast<__nv_bfloat162*>(
              &dcbx[(r0 + g + 8 * hh) * kLd + 32 * half + 8 * n + 2 * t4]) =
              __floats2bfloat162_rn(dcb[n][2 * hh], dcb[n][2 * hh + 1]);
      // the second products: dC += dCB B_j, half c into columns 64 c.. of each part
      auto afrag = [&](int kk, uint32_t (&a)[4]) { afrag_smem(a, dcbx, r0, kk); };
#pragma unroll
      for (int c = 0; c < kParts; ++c) {
        const bf16* st = slot(next());
        if (col0 + (2 * c + half) * kT >= N) continue;  // uniform over the warp
        if (c < kInRegs) {
          product_kn<false>(acc[c < kInRegs ? c : 0], afrag, st + half * kTileElems);
        } else {  // a parked part: in, multiplied, back
          float pa[8][4];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float4 v = *park(c, n);
            pa[n][0] = v.x, pa[n][1] = v.y, pa[n][2] = v.z, pa[n][3] = v.w;
          }
          product_kn<false>(pa, afrag, st + half * kTileElems);
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *park(c, n) = make_float4(pa[n][0], pa[n][1], pa[n][2], pa[n][3]);
        }
      }
    }
    __syncthreads();  // the dcs_i partials of the i-tile are whole
    if (s == 0) {
      for (int e = threadIdx.x; e < Hg * kT; e += kThreads) {
        const int h = e / kT, li = e % kT;
        float* a0 = &dcs_acc[h * kT + li];
        float* a1 = &dcs_acc[(Hg + h) * kT + li];
        if (li < rows) dcs_i[(bg * d.Hg + h) * d.Q + i0 + li] = *a0 + *a1;
        *a0 = 0.f;  // for the pair's next i-tile (its epilogues come after the next barrier)
        *a1 = 0.f;
      }
    }
#pragma unroll
    for (int c = 0; c < kParts; ++c) {
      const int n0 = col0 + (2 * c + half) * kT;
      if (n0 >= N) continue;
      float v[8][4];  // the part's float32 sums
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (c < kInRegs) {
#pragma unroll
          for (int r = 0; r < 4; ++r) v[n][r] = acc[c < kInRegs ? c : 0][n][r];
        } else {
          const float4 pv = *park(c, n);
          v[n][0] = pv.x, v[n][1] = pv.y, v[n][2] = pv.z, v[n][3] = pv.w;
        }
      }
      bf16* out = dC + (bg * d.Q + i0) * d.N + n0;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int li = r0 + g + 8 * hh;
        if (li >= rows) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 8 * n + 2 * t4 + e;
            if (n0 + col < N) out[li * d.N + col] = __float2bfloat16_rn(v[n][2 * hh + e]);
          }
      }
    }
  }
  cp_async_wait<0>();
}

constexpr int64_t kMaxGridYZ = 65535;
constexpr int64_t kMaxSmem = 232448;  // 227 KB, the most a block may take on the H100

int64_t tiles(int64_t n) { return (n + kT - 1) / kT; }

// The kernels hold Q, N, P, Hg, the row strides and the chunk count in int,
// and offsets inside a tile as int products: each below 2^24.
bool fits_int(const Dims& d) {
  constexpr int64_t kMax = int64_t{1} << 24;
  return d.Q < kMax && d.N < kMax && d.P < kMax && d.Hg < kMax && d.c_ld < kMax &&
         d.b_ld < kMax && d.Hg * parts(d.P) < kMax;
}

template <int kFC, bool kVec>
int launch_fwd(const bf16* C, const bf16* B, const float* cs, const bf16* x, bf16* y,
               const Dims& d, int64_t BG, cudaStream_t stream) {
  const int64_t slabs = (d.Hg * parts(d.P) + 2 * kFC - 1) / (2 * kFC);
  if (tiles(d.Q) > kMaxGridYZ || BG * slabs > INT32_MAX || !fits_int(d))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(decay_attention_fwd_bf16_kernel<kFC, kVec>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kFwdSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(BG * slabs),
                  static_cast<unsigned int>((tiles(d.Q) + 1) / 2));
  decay_attention_fwd_bf16_kernel<kFC, kVec><<<grid, kThreads, kFwdSmemBytes, stream>>>(
      C, B, cs, x, y, d);
  return static_cast<int>(cudaGetLastError());
}

template <int kParts, bool kVec>
int launch_bwd_j(const bf16* C, const bf16* B, const float* cs, const bf16* x, const bf16* dy,
                 bf16* dB, bf16* dx, float* dcs_j, const Dims& d, int64_t BG,
                 cudaStream_t stream) {
  const int64_t w = kParts * kT;
  const int64_t by_n = (d.N + w - 1) / w, by_p = (d.Hg * parts(d.P) + kParts - 1) / kParts;
  const int64_t blocks = by_n > by_p ? by_n : by_p;
  const int64_t smem = bwd_j_smem_bytes(kParts, d.Hg);
  if (blocks > kMaxGridYZ || tiles(d.Q) > kMaxGridYZ || BG > INT32_MAX || smem > kMaxSmem ||
      !fits_int(d))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(decay_attention_bwd_j_bf16_kernel<kParts, kVec>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(BG), static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>((tiles(d.Q) + 1) / 2));
  decay_attention_bwd_j_bf16_kernel<kParts, kVec><<<grid, kThreads, smem, stream>>>(
      C, B, cs, x, dy, dB, dx, dcs_j, d);
  return static_cast<int>(cudaGetLastError());
}

template <int kParts, bool kVec>
int launch_bwd_i(const bf16* C, const bf16* B, const float* cs, const bf16* x, const bf16* dy,
                 bf16* dC, float* dcs_i, const Dims& d, int64_t BG, cudaStream_t stream) {
  const int64_t w = 2 * kParts * kT;
  const int64_t blocks = (d.N + w - 1) / w;
  const int64_t smem = bwd_i_smem_bytes(kParts, d.Hg);
  if (blocks > kMaxGridYZ || tiles(d.Q) > kMaxGridYZ || BG > INT32_MAX || smem > kMaxSmem ||
      !fits_int(d))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(decay_attention_bwd_i_bf16_kernel<kParts, kVec>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned int>(BG), static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>((tiles(d.Q) + 1) / 2));
  decay_attention_bwd_i_bf16_kernel<kParts, kVec><<<grid, kThreads, smem, stream>>>(
      C, B, cs, x, dy, dC, dcs_i, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry launches one kernel on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a shape the grid (or, for
// bwd_j, shared memory: Hg up to about 190; for bwd_i about 280) cannot
// hold, or with a size or row stride of 2^24 or more. Shapes: BG, Q, N,
// Hg, P >= 1; strides in elements; C, B, x, dy and the outputs bfloat16, cs,
// dcs_i and dcs_j float32.
extern "C" int tlie_decay_attention_fwd_bf16(const bf16* C, const bf16* B, const float* cs,
                                             const bf16* x, bf16* y, int64_t BG, int64_t Q,
                                             int64_t N, int64_t Hg, int64_t P, int64_t c_bs,
                                             int64_t c_ld, int64_t b_bs, int64_t b_ld,
                                             void* stream) {
  const Dims d{Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // y chunks a warp holds: one where a slab of two holds them all (the MQAR
  // shape), else two (the WikiText Mamba-2's eight chunks in two slabs)
  const bool one = Hg * parts(P) <= 2;
  if (vec_tiles(C, B, x, x, d))
    return one ? launch_fwd<1, true>(C, B, cs, x, y, d, BG, s)
               : launch_fwd<2, true>(C, B, cs, x, y, d, BG, s);
  return one ? launch_fwd<1, false>(C, B, cs, x, y, d, BG, s)
             : launch_fwd<2, false>(C, B, cs, x, y, d, BG, s);
}

extern "C" int tlie_decay_attention_bwd_j_bf16(const bf16* C, const bf16* B, const float* cs,
                                               const bf16* x, const bf16* dy, bf16* dB,
                                               bf16* dx, float* dcs_j, int64_t BG, int64_t Q,
                                               int64_t N, int64_t Hg, int64_t P, int64_t c_bs,
                                               int64_t c_ld, int64_t b_bs, int64_t b_ld,
                                               void* stream) {
  const Dims d{Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128 columns of dB and of dx a block where both fit (or where 256 would
  // not fit beside Hg's dcs_j partials in shared memory), else 256
  const bool two = (N <= 2 * kT && Hg * parts(P) <= 2) || bwd_j_smem_bytes(4, Hg) > kMaxSmem;
  if (vec_tiles(C, B, x, dy, d))
    return two ? launch_bwd_j<2, true>(C, B, cs, x, dy, dB, dx, dcs_j, d, BG, s)
               : launch_bwd_j<4, true>(C, B, cs, x, dy, dB, dx, dcs_j, d, BG, s);
  return two ? launch_bwd_j<2, false>(C, B, cs, x, dy, dB, dx, dcs_j, d, BG, s)
             : launch_bwd_j<4, false>(C, B, cs, x, dy, dB, dx, dcs_j, d, BG, s);
}

extern "C" int tlie_decay_attention_bwd_i_bf16(const bf16* C, const bf16* B, const float* cs,
                                               const bf16* x, const bf16* dy, bf16* dC,
                                               float* dcs_i, int64_t BG, int64_t Q, int64_t N,
                                               int64_t Hg, int64_t P, int64_t c_bs,
                                               int64_t c_ld, int64_t b_bs, int64_t b_ld,
                                               void* stream) {
  const Dims d{Q, N, Hg, P, c_bs, c_ld, b_bs, b_ld};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128 columns of dC a block where N holds no more (or where 256 would not
  // fit beside Hg's dcs_i partials in shared memory), else 256: two blocks an
  // i-tile pair at the WikiText Mamba-2's N, which beat one block of 512
  // (PERF.md, row 3b)
  const bool one = N <= 2 * kT || bwd_i_smem_bytes(2, Hg) > kMaxSmem;
  if (vec_tiles(C, B, x, dy, d))
    return one ? launch_bwd_i<1, true>(C, B, cs, x, dy, dC, dcs_i, d, BG, s)
               : launch_bwd_i<2, true>(C, B, cs, x, dy, dC, dcs_i, d, BG, s);
  return one ? launch_bwd_i<1, false>(C, B, cs, x, dy, dC, dcs_i, d, BG, s)
             : launch_bwd_i<2, false>(C, B, cs, x, dy, dC, dcs_i, d, BG, s);
}
