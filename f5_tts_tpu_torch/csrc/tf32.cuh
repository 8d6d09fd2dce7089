// 3xTF32 on Hopper's tensor cores for the float32 attention kernels at
// d = 64 (flash_attention_fwd.cu, flash_attention_bwd.cu): the operand
// split, the TF32 products, and the float32 pre-pass that rotates, splits
// and pads the kernels' inputs once per call.
//
// 3xTF32. A float32 x is split into hi = cvt.rna.tf32.f32(x) and
// lo = cvt.rna.tf32.f32(x - hi) (x - hi is exact), so |x - hi - lo| <=
// 2^-22 |x|. A product a b is summed as lo_a hi_b + hi_a lo_b, then
// hi_a hi_b, with float32 accumulation; lo_a lo_b, below 2^-22 of the
// product, is dropped. That is as accurate as float32 FMA (the CPU tests
// emulate it against the JAX kernel, tests/test_torch_f32_attention.py:
// about 1e-6 where the float32 tolerance is 1e-4), where one TF32 product
// (hi_a hi_b) misses that tolerance (5e-4 to 9e-4).
// Three TF32 products run at a third of 495 TFLOP/s: 165 TFLOP/s of
// float32-accurate products, against 67 on the FMA units.
//
// Which instruction takes which product. wgmma takes TF32 operands only
// K-major (its transpose bit exists for 16-bit types only), so:
//   - the score-shaped products (S = Q' K'^T, dP = g V^T and their
//     transposes) have both operands K-major in the [rows, 64] tiles and run
//     as wgmma.m64n64k8 with both operands in shared memory
//     (`wgmma_tf32_ss`, csrc/hopper.cuh);
//   - the P V shaped products (O += P V, dV += P^T g, dK' += dS^T Q',
//     dQ' += dS K') contract over the streamed tile's rows, which makes that
//     tile MN-major. They run as mma.sync.m16n8k8.tf32 (`pv_3xtf32`): P or
//     dS comes from the score accumulator's registers, split there, and the
//     B fragments are read by threads from the same swizzled TMA tile the
//     score product used. A K-major copy for wgmma would add two tiles (hi,
//     lo) per operand to every pipeline stage: the backward's stage would
//     grow from 64 to 128 KB and no two stages would fit.
//   The score accumulator's layout is mma.sync's C layout, so a thread holds
//   columns 2t and 2t + 1 of each 8-column block, where the m16n8k8 A
//   fragment wants columns t and t + 4. The product sums over that index,
//   so `pv_3xtf32` permutes it instead of moving registers: A fragment
//   column t is column 2t, t + 4 is 2t + 1, and B fragment row t reads tile
//   row 2t, t + 4 row 2t + 1.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

// ---------------------------------------------------------------- the split

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void tf32_split4(float4 x, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  tf32_split(x.x, h[0], l[0]);
  tf32_split(x.y, h[1], l[1]);
  tf32_split(x.z, h[2], l[2]);
  tf32_split(x.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// The same split in integer operations, bit for bit: the rounding adds half
// of the 13 dropped bits' range to the pattern and clears them, which rounds
// the magnitude half away from zero (ops/flash_attention.py
// `tf32_split_plain` computes it so). cvt is a conversion, which runs at a
// fraction of the integer and float32 rate; the float32 dequantizing matmul
// splits every weight and activation it reads with this form.
__device__ __forceinline__ uint32_t tf32_round_int(float x) { return (__float_as_uint(x) + 0x1000u) & ~0x1FFFu; }

__device__ __forceinline__ void tf32_split_int(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round_int(x);
  lo = tf32_round_int(x - __uint_as_float(hi));
}

__device__ __forceinline__ void tf32_split4_int(float4 x, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  tf32_split_int(x.x, h[0], l[0]);
  tf32_split_int(x.y, h[1], l[1]);
  tf32_split_int(x.z, h[2], l[2]);
  tf32_split_int(x.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// ---------------------------------------------------------------- tiles

constexpr int TC_BM = 64;             // rows of a streamed tile (queries or keys)
constexpr int TC_D = 64;              // the head dim these kernels take
constexpr int TC_PANEL = TC_BM * 128;  // bytes of one 32-column panel of a streamed [64 x 64] float32 tile
constexpr int TC_ROW_PAD = 128;       // the row stats and key biases are padded to a multiple of this

// The pipeline's shared memory: WGS consumer warpgroups of 64 owned rows
// each; OWNED owned [64 WGS x 64] float32 tiles (an operand's hi and lo
// halves are two tiles), loaded once; STAGES ring stages of four streamed
// [64 x 64] tiles (two operands, hi and lo) and 1 KB of row stats or key
// biases. A [64 x 64] float32 tile is 16 KB (two 128-byte swizzled panels
// of 32 columns): the forward owns Q' (2 x 32 KB for 128 rows), the
// backward kernels two operands of 64 rows (4 x 16 KB), and each has two
// 65 KB stages: 195 KB of the 227 KB a block may use, one block an SM.
template <int WGS, int OWNED>
struct TcShape {
  static constexpr int ROWS = 64 * WGS;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  static constexpr int STAGES = 2;
  static constexpr int TILE = 2 * TC_PANEL;
  static constexpr int OWN_PANEL = ROWS * 128;
  static constexpr int OWN = 2 * OWN_PANEL;
  static constexpr int STAGE = 4 * TILE + 1024;
  static constexpr int BAR_OFF = OWNED * OWN + STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + slack to align the base to 1024
};

// c += a (16 x 8, row-major) * b (8 x 8, column-major); TF32 in, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The score-shaped product in 3xTF32: d (64 x 64) = A B^T over the 64 dims,
// A an owned tile (descriptors of its hi and lo halves, panels `a_panel`
// bytes apart), B a streamed tile (hi and lo). Cross terms first, then
// hi hi. The caller fences, commits and waits.
__device__ __forceinline__ void scores_3xtf32(float (&d)[32], uint64_t ah, uint64_t al, int a_panel, uint64_t bh,
                                              uint64_t bl) {
#pragma unroll
  for (int kc = 0; kc < TC_D / 8; ++kc) {
    wgmma_tf32_ss(d, kmajor(al, kc, a_panel), kmajor(bh, kc, TC_PANEL), kc > 0);
    wgmma_tf32_ss(d, kmajor(ah, kc, a_panel), kmajor(bl, kc, TC_PANEL), 1);
  }
#pragma unroll
  for (int kc = 0; kc < TC_D / 8; ++kc) wgmma_tf32_ss(d, kmajor(ah, kc, a_panel), kmajor(bh, kc, TC_PANEL), 1);
}

// The P V shaped product in 3xTF32: acc (a warp's 16 rows x 64 columns) +=
// X B, where X (16 x 64) sits in the score accumulator's layout (x[4 i + e]:
// row g + 8 (e >> 1), column 8 i + 2 t + (e & 1)) and is split here, and B
// is a streamed [64 x 64] tile (hi and lo halves) whose rows are the
// product's k. acc has the same layout over the 64 output columns.
__device__ __forceinline__ void pv_3xtf32(float (&acc)[32], const float (&x)[32], const unsigned char* bh,
                                          const unsigned char* bl) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // The B fragments of k step kc read tile rows 8 kc + 2t and 8 kc + 2t + 1
  // at column 8 nb + g. TMA wrote the tile as two 32-column panels with the
  // 128-byte swizzle (16-byte chunk j of row r at chunk j ^ (r % 8)); r % 8 is
  // 2t or 2t + 1 in every k step, so each thread's offsets are 16 values
  // (k step 0's) plus 1024 bytes a k step.
  int off[2][TC_D / 8];
#pragma unroll
  for (int nb = 0; nb < TC_D / 8; ++nb) {
#pragma unroll
    for (int odd = 0; odd < 2; ++odd) {
      const int r = 2 * t + odd;
      off[odd][nb] = (nb >> 2) * TC_PANEL + r * 128 + ((((2 * nb + (g >> 2)) & 7) ^ r) << 4) + ((g & 3) << 2);
    }
  }
#pragma unroll
  for (int kc = 0; kc < TC_BM / 8; ++kc) {
    uint32_t ah[4], al[4];
    tf32_split(x[4 * kc + 0], ah[0], al[0]);  // (g, k 2t)
    tf32_split(x[4 * kc + 2], ah[1], al[1]);  // (g + 8, k 2t)
    tf32_split(x[4 * kc + 1], ah[2], al[2]);  // (g, k 2t + 1)
    tf32_split(x[4 * kc + 3], ah[3], al[3]);  // (g + 8, k 2t + 1)
    const unsigned char* kh = bh + kc * 1024;
    const unsigned char* kl = bl + kc * 1024;
#pragma unroll
    for (int nb = 0; nb < TC_D / 8; ++nb) {
      const uint32_t h0 = *reinterpret_cast<const uint32_t*>(kh + off[0][nb]);
      const uint32_t h1 = *reinterpret_cast<const uint32_t*>(kh + off[1][nb]);
      const uint32_t l0 = *reinterpret_cast<const uint32_t*>(kl + off[0][nb]);
      const uint32_t l1 = *reinterpret_cast<const uint32_t*>(kl + off[1][nb]);
      mma_tf32(&acc[4 * nb], al, h0, h1);
      mma_tf32(&acc[4 * nb], ah, l0, l1);
      mma_tf32(&acc[4 * nb], ah, h0, h1);
    }
  }
}

// ---------------------------------------------------------------- the pre-pass

// The float32 pre-pass reads q, k, v (and in the backward g, the forward's
// output and lse) through their (batch, head, row) strides and writes, once
// per call:
//   - the TF32 halves of rope(q), rope(k), v (and g) as contiguous
//     [b, h, n, 64] float32 tensors, which TMA reads (the rotation in
//     float32 with unrounded tables, as the JAX kernel computes it for
//     float32 inputs; each K tile was rotated again by every block before);
//   - the backward's row stats (lse, delta = rowsum(g * out)) in float32,
//     padded with (FLT_MAX, 0), which make P = 0 for rows past n;
//   - each key's bias, 0, -1e30 masked, -FLT_MAX past n, padded too: TMA's
//     zero fill of a ragged tile cannot change the result.
// Null split pointers skip the split (d = 128 and 256, whose FMA kernels
// need only the stats and biases). A query block (flash_attention_fwd.cu)
// has n query rows against nk keys: q, g, out, lse and the stats take the
// query rows, k, v, the mask and the key biases the keys; query row i is
// rotated by table row q_off + i, key row i by row i.
struct TcPrep {
  const float* q;
  const float* k;
  const float* v;
  const float* g;       // null in the forward
  const float* out;     // null in the forward
  const float* lse;     // [b, h, n]; null in the forward
  const uint8_t* mask;  // [b, nk] or null
  const float* cos;     // [nk, d] or null
  const float* sin;
  float* qh;  // [b, h, n, d], or null; the same for ql, gh, gl
  float* ql;
  float* kh;  // [b, h, nk, d], or null; the same for kl, vh, vl
  float* kl;
  float* vh;
  float* vl;
  float* gh;  // null in the forward
  float* gl;
  float2* stats;  // [b, h, n_pad], or null in the forward
  float* kbias;   // [b, nk_pad]
  int h, n, n_pad;
  int nk, nk_pad, q_off;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long g_sb, g_sh, g_sn;
  long long o_sb, o_sh, o_sn;
};

constexpr int TC_PREP_TPR = 16;  // threads a row

// x * cos + rotate_half(x) * sin on one float4 chunk from an even column c
// of row `row`, each product and sum rounded once, as the plain version.
template <int D>
__device__ __forceinline__ float4 tc_rope(float4 x, const float* cos, const float* sin, int row, int c) {
  const float4 cs = *reinterpret_cast<const float4*>(cos + static_cast<long long>(row) * D + c);
  const float4 sn = *reinterpret_cast<const float4*>(sin + static_cast<long long>(row) * D + c);
  return make_float4(__fadd_rn(__fmul_rn(x.x, cs.x), -__fmul_rn(x.y, sn.x)),
                     __fadd_rn(__fmul_rn(x.y, cs.y), __fmul_rn(x.x, sn.y)),
                     __fadd_rn(__fmul_rn(x.z, cs.z), -__fmul_rn(x.w, sn.z)),
                     __fadd_rn(__fmul_rn(x.w, cs.w), __fmul_rn(x.z, sn.w)));
}

__device__ __forceinline__ void tc_store_split(float* hi, float* lo, long long o, float4 x) {
  float4 h, l;
  tf32_split4(x, h, l);
  *reinterpret_cast<float4*>(hi + o) = h;
  *reinterpret_cast<float4*>(lo + o) = l;
}

// The rows of a (b, h) pair that the pre-pass walks: the query rows' and the
// keys' padding, whichever is longer.
__host__ __device__ inline int tc_prep_rows(const TcPrep& p) { return p.n_pad > p.nk_pad ? p.n_pad : p.nk_pad; }

// One launch over the (b, h, max(n_pad, nk_pad)) rows, TC_PREP_TPR threads a
// row: row i is query row i where i < n and key row i where i < nk.
template <int D>
__global__ void __launch_bounds__(256) tc_prep_kernel(const TcPrep p, long long rows) {
  constexpr int CH = D / 4 / TC_PREP_TPR;  // float4 chunks a thread
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = idx / TC_PREP_TPR;
  if (row >= rows) return;  // rows is a multiple of TC_ROW_PAD, so whole warps leave together
  const int sub = static_cast<int>(idx % TC_PREP_TPR);
  const int per = tc_prep_rows(p);
  const long long bh = row / per;
  const int i = static_cast<int>(row % per);
  const int b = static_cast<int>(bh / p.h), h = static_cast<int>(bh % p.h);
  const bool q_valid = i < p.n, k_valid = i < p.nk;
  float delta = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = (sub + TC_PREP_TPR * j) * 4;
    const long long oq = (bh * p.n + i) * D + c, ok = (bh * p.nk + i) * D + c;
    if (p.qh != nullptr && q_valid) {
      float4 x = *reinterpret_cast<const float4*>(p.q + b * p.q_sb + h * p.q_sh + i * p.q_sn + c);
      if (p.cos != nullptr) x = tc_rope<D>(x, p.cos, p.sin, i + p.q_off, c);
      tc_store_split(p.qh, p.ql, oq, x);
    }
    if (p.qh != nullptr && k_valid) {
      float4 y = *reinterpret_cast<const float4*>(p.k + b * p.k_sb + h * p.k_sh + i * p.k_sn + c);
      if (p.cos != nullptr) y = tc_rope<D>(y, p.cos, p.sin, i, c);
      tc_store_split(p.kh, p.kl, ok, y);
      tc_store_split(p.vh, p.vl, ok, *reinterpret_cast<const float4*>(p.v + b * p.v_sb + h * p.v_sh + i * p.v_sn + c));
    }
    if (p.stats != nullptr && q_valid) {
      const float4 gv = *reinterpret_cast<const float4*>(p.g + b * p.g_sb + h * p.g_sh + i * p.g_sn + c);
      const float4 ov = *reinterpret_cast<const float4*>(p.out + b * p.o_sb + h * p.o_sh + i * p.o_sn + c);
      delta += gv.x * ov.x + gv.y * ov.y + gv.z * ov.z + gv.w * ov.w;
      if (p.gh != nullptr) tc_store_split(p.gh, p.gl, oq, gv);
    }
  }
  if (p.stats != nullptr) {
#pragma unroll
    for (int off = TC_PREP_TPR / 2; off > 0; off >>= 1) delta += __shfl_xor_sync(0xffffffffu, delta, off);
  }
  if (sub == 0) {
    if (p.stats != nullptr && i < p.n_pad) {
      p.stats[bh * p.n_pad + i] = q_valid ? make_float2(p.lse[bh * p.n + i], delta) : make_float2(FLT_MAX, 0.f);
    }
    if (h == 0 && i < p.nk_pad) {
      const uint8_t* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * p.nk;
      p.kbias[static_cast<long long>(b) * p.nk_pad + i] =
          !k_valid ? -FLT_MAX : (mask != nullptr && !mask[i]) ? -1e30f : 0.f;
    }
  }
}

template <int D>
cudaError_t launch_tc_prep(const TcPrep& p, int b, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * p.h * tc_prep_rows(p);
  const long long threads = rows * TC_PREP_TPR;
  tc_prep_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(p, rows);
  return cudaGetLastError();
}

// A 4-d tensor map of a contiguous [b, h, n, 64] float32 tensor: dims
// (64, n, h, b), [64 rows x 32 columns] boxes, 128-byte swizzle.
inline cudaError_t tc_head_map(CUtensorMap* map, const void* base, int b, int h, int n) {
  const uint64_t row = TC_D * sizeof(float);
  const uint64_t dims[4] = {TC_D, static_cast<uint64_t>(n), static_cast<uint64_t>(h), static_cast<uint64_t>(b)};
  const uint64_t strides[3] = {row, row * n, row * n * h};
  const uint32_t box[4] = {32, TC_BM, 1, 1};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// Point p's stats, kbias and TF32 halves into `scratch`, one float32 buffer
// the caller allocates (ops/flash_attention.py `_f32_scratch` sizes it): the
// row stats (2 b h n_pad floats, backward only), the key biases (b nk_pad),
// then `splits` tensors, hi then lo of each (6 in the forward: q' [b, h, n,
// 64], k' and v [b, h, nk, 64]; 8 in the backward, g [b, h, n, 64] last;
// none at d = 128 and 256). Every part starts 16-byte aligned (TMA's rule).
inline void tc_carve(TcPrep& p, float* scratch, int b, bool stats, int splits) {
  float* at = scratch;
  p.stats = nullptr;
  if (stats) {
    p.stats = reinterpret_cast<float2*>(at);
    at += 2LL * b * p.h * p.n_pad;
  }
  p.kbias = at;
  at += static_cast<long long>(b) * p.nk_pad;
  float** halves[8] = {&p.qh, &p.ql, &p.kh, &p.kl, &p.vh, &p.vl, &p.gh, &p.gl};
  for (int i = 0; i < 8; ++i) {
    *halves[i] = i < splits ? at : nullptr;
    const int rows = i < 2 || i >= 6 ? p.n : p.nk;
    if (i < splits) at += static_cast<long long>(b) * p.h * rows * TC_D;
  }
}
