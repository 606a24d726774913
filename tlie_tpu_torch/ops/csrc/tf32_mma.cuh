// TF32 tensor-core products at float32 accuracy, and asynchronous copies to
// shared memory: the pieces that fused_xent.cu and flash_attention.cu share.
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

}  // namespace
