// TF32x3 warp matrix products: fp32-accurate GEMM steps on the tensor
// cores, shared by winograd_tc.cuh (winograd_streamed.cu and
// winograd_strided_streamed.cu), separable_streamed.cu and matmul.cu.
//
// One TF32 tensor-core product keeps 10 of fp32's 23 mantissa bits, about
// 1e-3 relative error on a long sum: past the kernels' fp32 contract. So
// each fp32 operand is split into two TF32 halves, a = hi + lo with
// hi = rna(a) and lo = rna(a - hi) (a - hi is exact in fp32), and each
// multiply-add issues three products into the fp32 accumulator:
// hi*lo + lo*hi first (the small cross terms), then hi*hi. The dropped
// lo*lo term is below 2^-22 of the product, so the result keeps fp32-level
// error at a third of the TF32 rate (495 / 3 = 165 TFLOP/s dense on an
// H100 SXM, against 67 for fp32 FMAs on the CUDA cores).
//
// The tensor cores add each product group into the fp32 accumulator with
// rounding toward zero, a bias that grows with the number of adds into
// one register (a 256-deep F(4x4, 3x3) point-GEMM read 2.1e-5 of its
// output against the fp32 plain version when every k-step added into the
// running sum). So the kernels sum one C step's products into a zeroed
// fragment and add that to the running sum with an fp32 add, which rounds
// to nearest: the biased rounding spans one C step.
//
// A filter widened from bf16 or int8 (at most 8 significant bits) is exact
// in TF32: its lo half is 0, so the kernels drop that product (kBLo false)
// and issue two.
//
// The instruction is mma.sync m16n8k8 (row.col, tf32 in, f32 accumulate):
// it takes its fragments from registers, so the kernels feed it
// transform-domain tiles in any order. Fragment layout for lane l, with
// g = l / 4 and t = l % 4 (PTX ISA, "Matrix Fragments for mma.m16n8k8"):
//   A (16 x 8, row-major):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)
//                           a3 (g + 8, t + 4)
//   B (8 x 8, k x n):       b0 (t, g)  b1 (t + 4, g)
//   C (16 x 8):             c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)
//                           c3 (g + 8, 2t + 1)

#pragma once

#include "common.cuh"

namespace {

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// fp32 -> TF32, round to nearest (ties away from zero); the low 13 bits of
// the result are 0, so it reads back as the rounded fp32 value.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The loads below take the tile pointer already offset to the lane's
// element: p + (lane / 4) * ld + lane % 4 for A, p + (lane % 4) * ld +
// lane / 4 for B, computed once per kernel.

// A fragment from a row-major fp32 tile: element (r, k) at p[r * ld + k].
__device__ __forceinline__ void load_a(FragA& a, const float* p, int ld) {
  split_tf32(p[0], a.hi[0], a.lo[0]);
  split_tf32(p[8 * ld], a.hi[1], a.lo[1]);
  split_tf32(p[4], a.hi[2], a.lo[2]);
  split_tf32(p[8 * ld + 4], a.hi[3], a.lo[3]);
}

// A fragment already split: hi and lo tiles of uint32 TF32 values, element
// (r, k) at hi[r * ld + k].
__device__ __forceinline__ void load_a_split(FragA& a, const uint32_t* hi,
                                             const uint32_t* lo, int ld) {
  const int o[4] = {0, 8 * ld, 4, 8 * ld + 4};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a.hi[i] = hi[o[i]];
    a.lo[i] = lo[o[i]];
  }
}

// B fragment from a k-major tile of widened values: element (k, n) at
// widen(p[k * ld + n]). With kLo false the lo half is left unset (the
// caller's filter is exact in TF32).
template <bool kLo, typename U>
__device__ __forceinline__ void load_b(FragB& b, const U* p, int ld) {
  const float v0 = widen(p[0]);
  const float v1 = widen(p[4 * ld]);
  if constexpr (kLo) {
    split_tf32(v0, b.hi[0], b.lo[0]);
    split_tf32(v1, b.hi[1], b.lo[1]);
  } else {
    b.hi[0] = __float_as_uint(v0);
    b.hi[1] = __float_as_uint(v1);
  }
}

// d += a * b, one m16n8k8 TF32 product with fp32 accumulation.
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in fp32-level precision: the cross terms, then hi * hi.
template <bool kBLo>
__device__ __forceinline__ void mma_tf32x3(float d[4], const FragA& a,
                                           const FragB& b) {
  if constexpr (kBLo) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.hi);
}

// cp.async of 16 bytes, global -> shared, bypassing L1 (the operand is read
// once per block), and its group fences.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem));
}
// The same with zero fill: the first `bytes` (0 or 16) of the 16 come from
// gmem, the rest are zeros; with 0 nothing is read, so a masked-off lane
// may pass any valid pointer.
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
// 4 bytes with zero fill (`bytes` 0 or 4), for operands whose rows are not
// 16-byte aligned.
__device__ __forceinline__ void cp_async4_zfill(void* smem, const void* gmem,
                                                int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
// Wait until at most kPending of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// Bytes between two rows of a staged (k, n) B tile of n values of `size`
// bytes: a multiple of 16 (cp.async) that is 32 or 96 mod 128, so the four
// k rows of a B fragment fall on distinct banks.
constexpr int u_row_bytes(int n, int size) {
  int b = n * size;
  b = (b + 15) / 16 * 16;
  while (b % 128 != 32 && b % 128 != 96) b += 16;
  return b;
}

}  // namespace
