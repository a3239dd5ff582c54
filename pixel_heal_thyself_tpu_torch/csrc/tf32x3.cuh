// f32 products on Hopper's tensor cores at f32 accuracy: mma.sync m16n8k8
// with tf32 operands, each operand split in registers as a = a_hi + a_lo
// (a_hi = tf32(a), a_lo = tf32(a - a_hi), both rounded to nearest, ties away
// from zero, as cvt.rna.tf32.f32) and the product taken as a_lo.b_hi +
// a_hi.b_lo + a_hi.b_hi ("3xTF32"; the dropped a_lo.b_lo is below 2^-21 of
// |a||b|). One tf32 pass keeps 10 mantissa bits (relative error ~2^-11 a
// product), which the fused Mamba2 kernels' f32 bounds do not admit.
//
// Two measured choices (PERF.md, PR 8). The split rounds with integer adds
// and masks instead of cvt.rna: a_lo is passed with its half ulp added and
// its low 13 bits left for the tensor core to ignore, which rounds it the
// same way (the launches ran 11-26% faster than with two cvt per element).
// The tensor cores round their f32 sums toward zero, so a long chain of
// mma.sync into one accumulator drifts toward zero with the chain's length
// (on the prod generator's own inputs K7's entering states drifted well
// past the scalar-FMA body's deviation); mma3 therefore sums each k-step's
// products in fragments of their own, started at zero, and adds those to
// the accumulator with f32 adds, which round to nearest.
//
// Fragments (PTX ISA, mma.m16n8k8 .tf32; g = lane / 4, c = lane % 4):
//   A (16 x 8, row): a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4)
//   B (8 x 8, col):  b0 (c, g), b1 (c + 4, g)
//   D (16 x 8):      d0 (g, 2c), d1 (g, 2c + 1), d2 (g + 8, 2c), d3 (g + 8, 2c + 1)
// The loaders take the operand as a functor get(row, col), so a caller reads
// any layout (a transpose, a packed triangle) and folds a scale into the
// element before it is split. ssd_chain.cuh and ssd_bwd.cu (K7, K8) use it;
// sm90_probe.cu holds it against an f64 product on one tile.
//
// PHT_TF32X3_DIAG (bench_ssd_tc.py's variants only; wrong results but for
// 1): 1 splits with cvt.rna.tf32.f32, 2 takes one tf32 pass (a_hi.b_hi),
// 3 skips the mma.sync but keeps the loads and splits.
#pragma once

#include <stdint.h>

#ifndef PHT_TF32X3_DIAG
#define PHT_TF32X3_DIAG 0
#endif

namespace pht {
namespace tf32 {

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// x = hi + lo: hi = x rounded to tf32 (half an ulp added to the magnitude,
// then the low 13 bits cleared); lo = x - hi (exact) with half an ulp added,
// which the tensor core's reading of its top 19 bits completes to tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
#if PHT_TF32X3_DIAG == 1
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
#else
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
#endif
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a . b, the sum started at zero
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// acc += a . b at f32 accuracy: this k-step's cross terms and its main term
// summed apart from zero, then added with round-to-nearest f32 adds
__device__ __forceinline__ void mma3(float (&acc)[4], const FragA& a, const FragB& b) {
#if PHT_TF32X3_DIAG == 2
  float big[4];
  mma0(big, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += big[i];
#elif PHT_TF32X3_DIAG == 3
#pragma unroll
  for (int i = 0; i < 4; ++i)
    acc[i] += __uint_as_float((a.hi[i] ^ a.lo[i] ^ b.hi[i & 1] ^ b.lo[i & 1]) & 0x3f800000u) * 0.f;
#else
  float small[4], big[4];
  mma0(small, a.lo, b.hi);
  mma(small, a.hi, b.lo);
  mma0(big, a.hi, b.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += big[i] + small[i];
#endif
}

// A rows r0..r0+15, k columns k0..k0+7
template <class Get>
__device__ __forceinline__ FragA load_a(Get get, int r0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  FragA f;
  split(get(r0 + g, k0 + c), f.hi[0], f.lo[0]);
  split(get(r0 + g + 8, k0 + c), f.hi[1], f.lo[1]);
  split(get(r0 + g, k0 + c + 4), f.hi[2], f.lo[2]);
  split(get(r0 + g + 8, k0 + c + 4), f.hi[3], f.lo[3]);
  return f;
}

// A whose elements a0..a3 sit at p[o0..o3] (a packed layout whose offsets
// the caller computes once)
__device__ __forceinline__ FragA load_a_at(const float* p, int o0, int o1, int o2, int o3) {
  FragA f;
  split(p[o0], f.hi[0], f.lo[0]);
  split(p[o1], f.hi[1], f.lo[1]);
  split(p[o2], f.hi[2], f.lo[2]);
  split(p[o3], f.hi[3], f.lo[3]);
  return f;
}

// B k rows k0..k0+7, columns n0..n0+7
template <class Get>
__device__ __forceinline__ FragB load_b(Get get, int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, c = threadIdx.x & 3;
  FragB f;
  split(get(k0 + c, n0 + g), f.hi[0], f.lo[0]);
  split(get(k0 + c + 4, n0 + g), f.hi[1], f.lo[1]);
  return f;
}

// the row and column of accumulator element i (0..3) of the tile at (r0, n0)
__device__ __forceinline__ int acc_row(int r0, int i) {
  return r0 + ((threadIdx.x & 31) >> 2) + 8 * (i >> 1);
}
__device__ __forceinline__ int acc_col(int n0, int i) {
  return n0 + 2 * (threadIdx.x & 3) + (i & 1);
}

}  // namespace tf32
}  // namespace pht
