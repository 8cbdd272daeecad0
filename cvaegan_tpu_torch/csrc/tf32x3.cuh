// Float32-accurate products on Hopper's tensor cores, shared by the
// port's kernels (`fused_mlp4.cu`, `block_attention.cu`).
//
// mma.sync.m16n8k8 with TF32 operands, in three passes: each operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), rounded to nearest as
// cvt.rna.tf32.f32 rounds (without it the unit truncates the low 13
// mantissa bits), and a.b ~ hi.lo + lo.hi + hi.hi, small terms first. One
// TF32 pass keeps ~3 decimal digits; three keep float32's tolerances.
// `cvt.rna.tf32.f32` compiles to a guarded multi-instruction sequence on
// sm_90a, so the same rounding is done here by two integer instructions.
//
// Fragments (PTX ISA, m16n8k8 .tf32; g = lane / 4, t = lane % 4):
//   A (16 x 8)  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8)   b0 (t, g)  b1 (t + 4, g)
//   C (16 x 8)  c0 (g, 2t) c1 (g, 2t + 1) c2 (g + 8, 2t) c3 (g + 8, 2t + 1)
//
// The unit adds into its float32 accumulator with truncation, so a sum
// over many products drifts toward zero; the kernels sum a bounded number
// of products in the accumulator and fold that partial sum into a float32
// register sum with a rounded add.
//
// Also the cp.async copies both kernels stage their tiles with.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the low 13 bits cleared), in two integer instructions.
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 relative, both exact TF32 values.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
}

// {hi(a), hi(b), lo(a), lo(b)}: a B fragment {a, b} with its hi and lo, as
// the kernels store it in their split tiles; each pair is the register
// pair an mma takes, so a 16-byte load feeds the three passes as it is.
__device__ __forceinline__ float4 split2(float a, float b) {
  uint32_t ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  return make_float4(__uint_as_float(ah), __uint_as_float(bh), __uint_as_float(al),
                     __uint_as_float(bl));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b0)),
        "r"(__float_as_uint(b1)));
}

// c += a b in three TF32 passes, the small terms first; b = {hi(b0),
// hi(b1), lo(b0), lo(b1)} from a split tile.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float4 b) {
  mma(c, ah, b.z, b.w);
  mma(c, al, b.x, b.y);
  mma(c, ah, b.x, b.y);
}

// 16 bytes from device memory into shared memory, bypassing L1; with
// `valid` false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(to), "l"(src), "r"(valid ? 16 : 0));
}

// One float, for rows that are not 16-byte aligned; zero-filled likewise.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(to), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

}  // namespace
