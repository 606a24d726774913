// TF32 tensor-core products at float32 accuracy, and asynchronous copies to
// shared memory: the pieces that fused_xent.cu, flash_attention.cu and
// decay_attention.cu share, and the warp products on 64-row tiles that the
// decay attention's kernels and the flash attention's dK/dV run.
//
// A product runs as three TF32 products of a split operand: x = big + small,
// big = TF32(x), small = TF32(x - big), |x - big - small| <= 2^-22 |x|; each
// product is small*big + big*small + big*big, the small ones first
// (small*small, 2^-24 relative, is left out). The split is made in
// registers as each fragment is read from shared memory. The tensor cores
// may not round their sums to nearest, so a caller sums no deeper than one
// shared-memory step into fresh accumulators before an ordinary float32 add.

#pragma once

#include <cstdint>

namespace {

// x rounded to TF32 (10 stored mantissa bits), to nearest with ties away from
// 0: the rounding of cvt.rna.tf32.f32, equal to it for every finite x and for
// +-inf. ptxas turns cvt.rna into four instructions (this add and mask, and a
// finite test and a select around them); written out it is two.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + r with big, small TF32 and |r| <= 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c += a · b for one 16 x 8 x 8 fragment (PTX "mma.m16n8k8", .tf32): with
// g = lane / 4 and t = lane % 4, a = A(g, t), A(g+8, t), A(g, t+4), A(g+8, t+4);
// b = B(t, g), B(t+4, g); c = C(g, 2t), C(g, 2t+1), C(g+8, 2t), C(g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One depth-8 step of a warp's (16 kMT) x (8 kNT) tile in three TF32
// products, c += As·Bb + Ab·Bs + Ab·Bb (the two small ones first). a(m, t)
// returns A's values at a lane's k slots t and t + 4 of row m, b(n, t) B's
// at the same slots of column n, for m < 16 kMT, n < 8 kNT, read from shared
// memory; each value is split where it is read. Which depth each slot takes
// is the caller's choice, the same for both operands: depth 2t and 2t + 1,
// so that a lane reads a row's two values as one float2, or depth t and
// t + 4, where reading a column by rows 4 apart suits the strides better.
template <int kMT, int kNT, class A, class B>
__device__ __forceinline__ void mma_step_3xtf32(float (&c)[kMT][kNT][4], A a, B b) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  uint32_t ab[kMT][4], as[kMT][4], bb[kNT][2], bs[kNT][2];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    const float2 lo = a(16 * i + g, t), hi = a(16 * i + g + 8, t);
    split_tf32(lo.x, ab[i][0], as[i][0]);
    split_tf32(hi.x, ab[i][1], as[i][1]);
    split_tf32(lo.y, ab[i][2], as[i][2]);
    split_tf32(hi.y, ab[i][3], as[i][3]);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float2 v = b(8 * j + g, t);
    split_tf32(v.x, bb[j][0], bs[j][0]);
    split_tf32(v.y, bb[j][1], bs[j][1]);
  }
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(c[i][j], as[i], bb[j]);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(c[i][j], ab[i], bs[j]);
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j) mma_tf32(c[i][j], ab[i], bb[j]);
}

// 16 (or 4) bytes from global to shared memory, not through registers; where
// `in` is false nothing is read and the bytes are zeroed.
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool in, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits until at most kPending of the committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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

// -- warp products on 64-row tiles ---------------------------------------------------

constexpr int kT = 64;     // tile edge: a tile's rows, and a warp's 16 of them times 4
constexpr int kStep = 32;  // depth of one shared-memory step of a first product
// depth of one fresh tensor-core sum (three chained HMMAs a fragment) before
// its float32 add. The tensor cores truncate their sums: where a fresh sum
// ran 32 deep (64 in the second products) the small products met a large
// accumulator, and the bias toward zero that left summed, not averaged, over
// the 32,768 positions of the MQAR Mamba-2's dt_bias gradient (card against
// CPU: 0.832 of its tolerance, against 0.066 at 8 and 0.040 with the float32
// SIMT kernels). The loops over fresh sums stay rolled: unrolled at 8 deep
// they spill.
constexpr int kFresh = 8;

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

// acc += the warp's 16 rows of A times a 64-deep tile V (64 x 8 columns),
// kFresh deep at a time into a fresh sum that is then added in float32, the
// depth in natural order (a lane's slots t and t + 4 take depth t and
// t + 4): A's rows kALd apart at `a` (float reads at (4g + t) where kALd is 4
// modulo 32), V's rows kVLd apart at `v` (float reads at (8t + g) where kVLd
// is 8 modulo 32). The second products.
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

// acc += kStep deep of the warp's 16 rows of A times the 64 rows of Bm
// (A Bm^T), kFresh deep at a time as above, both row-major, rows kLd apart,
// read as float2 at the depth pairs (2t, 2t + 1) (every bank once where kLd
// is 8 modulo 32). The first products.
template <int kLd>
__device__ __forceinline__ void product_nt32(float (&acc)[8][4], const float* a, const float* bm) {
#pragma unroll 1
  for (int k0 = 0; k0 < kStep; k0 += kFresh) {
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

}  // namespace
