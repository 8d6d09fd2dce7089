// bf16 helpers for the kernels of this directory: 32-bit fragment loads,
// bf16 pair packing and rounding, packed bf16 multiplies and adds, the
// interleaved rotary embedding of a bf16 pair, and the m16n8k16 product with
// float32 accumulation.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// bf16 pairs: a * b and a + b, each rounded once to nearest even (the .rn
// form is never contracted into an fma, which would skip a rounding).
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The interleaved rotary embedding of one pair (x[2j], x[2j+1]) with its
// tables' pairs c and s (bf16): x * c + rotate_half(x) * s in bf16, each
// product and the sum rounded once, as the JAX kernel body rounds
// x * cos + bf16(x @ P) * sin (P the pair swap, so x @ P = rotate_half(x)
// = (-x[2j+1], x[2j]) exactly).
__device__ __forceinline__ uint32_t rope_pair_bf16(uint32_t x, uint32_t c, uint32_t s) {
  const uint32_t xr = __byte_perm(x, 0, 0x1032) ^ 0x8000u;  // swap the halves, negate the low one
  return add_bf16x2(mul_bf16x2(x, c), mul_bf16x2(xr, s));
}

// The bf16 pairs of the 16-byte chunk at dims c .. c + 7 of row `row` of a
// contiguous float32 [n, D] table, each rounded to nearest even.
template <int D>
__device__ __forceinline__ uint4 table_chunk_bf16(const float* t, int row, int c) {
  const float4* p = reinterpret_cast<const float4*>(t + static_cast<long long>(row) * D + c);
  const float4 a = p[0], b = p[1];
  return make_uint4(pack_f32(a.x, a.y), pack_f32(a.z, a.w), pack_f32(b.x, b.y), pack_f32(b.z, b.w));
}

// rope_pair_bf16 over a 16-byte chunk of a row and its tables' chunks.
__device__ __forceinline__ uint4 rope_chunk_bf16(uint4 x, uint4 c, uint4 s) {
  return make_uint4(rope_pair_bf16(x.x, c.x, s.x), rope_pair_bf16(x.y, c.y, s.y), rope_pair_bf16(x.z, c.z, s.z),
                    rope_pair_bf16(x.w, c.w, s.w));
}

// c += a (16x16, row-major) * b (16x8, column-major); bf16 in, float32 accumulate.
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
