// TF32 tensor-core helpers shared by the one-hot dot kernel
// (bucket_sums_dot.cu) and the micro-benchmark's tensor-core kernels
// (microbench_dot.cu): the rounding of float32 operands to TF32 and the
// mma.sync.m16n8k8 product through raw PTX, whose fragment layout is
// fixed (the wmma API hides it), so operands can be formed in registers.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tf32 {

constexpr uint32_t kOne = 0x3f800000u;  // 1.0f

// Row tiles a warp holds at NT column tiles: RT x NT accumulator tiles of
// 4 registers stay within 64 registers (128 at NT = 16 signed).
__host__ __device__ constexpr int row_tiles(int nt, bool with_signed) {
  const int t = 16 / (nt * (with_signed ? 2 : 1));
  return t < 1 ? 1 : t > 4 ? 4 : t;
}

// TF32 operands: the tensor cores read the top 19 bits of a float32
// register (sign, exponent, 10 mantissa bits) and ignore the other 13.
// Adding half a TF32 unit to the bit pattern first rounds the magnitude
// to nearest, ties away, as cvt.rna.tf32.f32 does; on the same pattern a
// signed integer max with 0 is relu (a negative float is a negative
// integer, -0 the most negative).
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) + 0x1000u;
}
__device__ __forceinline__ uint32_t tf32_relu(float x) {
  return static_cast<uint32_t>(max(__float_as_int(x) + 0x1000, 0));
}
// x as the TF32 value nearest it and the TF32 value nearest the rest
// (3xTF32: hi b + lo b + hi b_lo carries x b to ~2^-22 of itself).
__device__ __forceinline__ uint32_t tf32_rest(float x, uint32_t hi) {
  return tf32(x - __uint_as_float(hi & 0xffffe000u));
}

// d += a [16 x 8] . b [8 x 8], TF32 operands, float32 accumulators.
// Fragments (g = lane / 4, q = lane % 4): a = rows (g, g + 8) x k (q,
// q + 4) as a[0] (g, q), a[1] (g + 8, q), a[2] (g, q + 4), a[3] (g + 8,
// q + 4); b = k (q, q + 4) x column g; d = rows (g, g + 8) x columns
// (2q, 2q + 1) as d[0] (g, 2q), d[1] (g, 2q + 1), d[2] (g + 8, 2q),
// d[3] (g + 8, 2q + 1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma_tf32
