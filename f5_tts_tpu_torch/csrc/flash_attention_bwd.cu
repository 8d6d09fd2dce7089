// Flash-attention backward for Hopper (sm_90a): a bf16 kernel pair on the
// tensor cores and a float32 kernel pair on the FMA units.
//
// Replaces the Pallas TPU kernel of the JAX package:
// f5_tts_tpu/ops/flash_attention.py, `_flash_attention_bwd_call` (kernel body
// `_make_bwd_kernel`, reached through the custom VJP `_flash_bwd`). It
// computes what that kernel computes, for the forward
// out = softmax(rope(q) rope(k)^T * scale - (1 - mask) * 1e30) v:
//   P   = the probabilities, recomputed with the same scale, key-mask bias and
//         interleaved RoPE (tables rounded to bf16 in the bf16 kernels);
//   dV  = P^T g;
//   dS  = P * (g V^T - delta) * scale, with delta = rowsum(g * out) computed
//         outside the kernel, as in JAX;
//   dQ' = dS K',  dK' = dS^T Q';
//   dQ, dK = the RoPE backward of dQ', dK': dx = dx' cos + (dx' sin) P^T,
//         i.e. dx[2j] = dx'[2j] cos[2j] + dx'[2j+1] sin[2j+1] and
//         dx[2j+1] = dx'[2j+1] cos[2j+1] - dx'[2j] sin[2j].
// Products accumulate in float32 and dq, dk, dv are written in float32; the
// Python wrapper casts them to q's dtype. In the bf16 kernels P (for dV) and
// dS are rounded to bf16 before their products, as the JAX kernel does.
//
// What bounds it on this card. Per (b, h) the work is 10 n^2 d FLOP (five
// n x n x d products, one of them recomputing S twice) against ~8 n d bytes,
// so at n = 1024, d = 64 it wants the tensor cores. The TPU kernel holds all
// of K and V of one head in VMEM and accumulates dK and dV across the
// sequential q-block grid in its output refs. Hopper blocks run in parallel
// and in no order, so nothing can be carried between them; this design
// splits the work in two kernels that need no float atomics and are
// deterministic:
//   - dkdv: one block per 64-key tile owns dK and dV of those keys in
//     registers and streams Q', g and the row statistics over all queries;
//   - dq: one block per 64-query tile owns dQ in registers and streams K'
//     and V over all keys.
// The row statistics come from the forward: P = exp(s - lse) with the
// log-sum-exp K1 saved (flash_attention_fwd.cu), so no pass rescans a row.
// A row whose keys are all masked has lse ~ -1e30, where m + log(l) loses
// log(l); such a row is uniform over the n keys (as the forward and the
// plain version make it), so the kernels give it P = 1/n directly.
//
// bf16 design: 4 warps per 64-row tile, 16 rows each; every product runs
// through mma.sync m16n8k16 (bf16 operands, float32 accumulation), and a
// score accumulator's register layout is reused as the A operand of the next
// product, so P and dS never leave registers. Each warp owns DC output
// columns (64, or 128 at d = 256), so d = 128 and 256 run 8 warps that share
// their 16 rows' score products; the accumulators stay within 255 registers.
// Tiles stage through shared memory (4 tiles of 64 x (d + 8) bf16).
//
// float32 design: 8 lanes per row, each owning d/8 of the row's dims in
// float4 chunks, as the float32 forward; a score is a partial dot product
// summed over the row's 8 lanes with shuffles. No TF32.
//
// q, k, v and g are addressed through (batch, head, row) strides, so
// [b, n, h, d] projection views are read without a transpose copy; the head
// dim must be contiguous and rows 16-byte aligned. Rows and keys past n (the
// ragged last tile) are zero-filled and contribute exactly 0.
// cp.async / TMA pipelining, wgmma and warp specialisation are not used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;  // rows per tile (queries or keys)
constexpr int PAD = 8;  // bf16 padding per shared-memory row: conflict-free fragment loads
constexpr float MASKED = -1e30f;
constexpr float FULLY_MASKED = -1e29f;  // an lse below this marks a row with every key masked

template <int D>
struct Shape {
  static constexpr int DC = D <= 128 ? 64 : 128;  // output columns per warp
  static constexpr int WARPS = 4 * (D / DC);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + PAD;
};

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* g;
  const float* lse;     // [b, h, n]
  const float* delta;   // [b, h, n]
  const uint8_t* mask;  // [b, n] or null
  const float* cos;     // [n, d] or null
  const float* sin;     // [n, d] or null
  float* dq;            // [b, h, n, d], contiguous
  float* dk;
  float* dv;
  int n;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long g_sb, g_sh, g_sn;
  float scale;
};

// the additive bias of one key: 0, MASKED, or -FLT_MAX past n
__device__ __forceinline__ float key_bias(const uint8_t* mask, int key, int n) {
  return key >= n ? -FLT_MAX : (mask != nullptr && !mask[key]) ? MASKED : 0.f;
}

// P of one (row, key) from the scaled score s, the key's bias and the row's lse
__device__ __forceinline__ float prob(float s, float bias, float lse, float inv_n) {
  if (lse < FULLY_MASKED) return bias == -FLT_MAX ? 0.f : inv_n;
  return __expf(s + bias - lse);
}

__device__ __forceinline__ float prob_f32(float s, float bias, float lse, float inv_n) {
  if (lse < FULLY_MASKED) return bias == -FLT_MAX ? 0.f : inv_n;
  return expf(s + bias - lse);
}

// ---------------------------------------------------------------- bf16

// Copy rows [row0, row0 + 64) of one head into shared memory (row stride
// D + PAD), zero-filling rows >= n. With tables, rotate each (2j, 2j+1) pair
// as the forward does.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g, long long sn,
                                          int row0, int n, const float* cos, const float* sin) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BM * CHUNKS; i += Shape<D>::THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) {
      val = *reinterpret_cast<const uint4*>(g + row * sn + c);
      if (cos != nullptr) {
        const float4* cr = reinterpret_cast<const float4*>(cos + static_cast<long long>(row) * D + c);
        const float4* sr = reinterpret_cast<const float4*>(sin + static_cast<long long>(row) * D + c);
        const float4 c0 = cr[0], c1 = cr[1], s0 = sr[0], s1 = sr[1];
        const float cs[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float ss[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 xf = __bfloat1622float2(x[j]);
          const float ce = round_bf16(cs[2 * j]), co = round_bf16(cs[2 * j + 1]);
          const float se = round_bf16(ss[2 * j]), so = round_bf16(ss[2 * j + 1]);
          x[j] = __floats2bfloat162_rn(xf.x * ce - xf.y * se, xf.y * co + xf.x * so);
        }
      }
    }
    *reinterpret_cast<uint4*>(s + r * (D + PAD) + c) = val;
  }
}

// acc [16 rows x 8*NT cols] += A (16 x D, rows `arow0..` of sA) * B^T, where
// B's rows are the 8*NT rows of sB: the score-shaped product S = A B^T.
template <int D, int NT>
__device__ __forceinline__ void scores(float (&acc)[NT][4], const __nv_bfloat16* sA, int arow0,
                                       const __nv_bfloat16* sB) {
  constexpr int LD = D + PAD;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const __nv_bfloat16* a = sA + (arow0 + g) * LD + kc * 16 + 2 * t;
    const uint32_t a0 = ld32(a), a1 = ld32(a + 8 * LD), a2 = ld32(a + 8), a3 = ld32(a + 8 * LD + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const __nv_bfloat16* b = sB + (nt * 8 + g) * LD + kc * 16 + 2 * t;
      mma_16816(acc[nt], a0, a1, a2, a3, ld32(b), ld32(b + 8));
    }
  }
}

// acc [16 x DC] += X (16 x 64, score-shaped registers, rounded to bf16) *
// sB[0:64, c0:c0+DC], the P V shaped product.
template <int D>
__device__ __forceinline__ void product(float (&acc)[Shape<D>::DC / 8][4], const float (&x)[BM / 8][4],
                                        const __nv_bfloat16* sB, int c0) {
  constexpr int LD = D + PAD;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int kc = 0; kc < BM / 16; ++kc) {
    const uint32_t a0 = pack_f32(x[2 * kc][0], x[2 * kc][1]);
    const uint32_t a1 = pack_f32(x[2 * kc][2], x[2 * kc][3]);
    const uint32_t a2 = pack_f32(x[2 * kc + 1][0], x[2 * kc + 1][1]);
    const uint32_t a3 = pack_f32(x[2 * kc + 1][2], x[2 * kc + 1][3]);
#pragma unroll
    for (int dt = 0; dt < Shape<D>::DC / 8; ++dt) {
      const __nv_bfloat16* b = sB + (kc * 16 + 2 * t) * LD + c0 + dt * 8 + g;
      mma_16816(acc[dt], a0, a1, a2, a3, pack_bf16(b[0], b[LD]), pack_bf16(b[8 * LD], b[9 * LD]));
    }
  }
}

// Write a thread's share of a [16 x DC] float32 accumulator for rows
// row0 + g and row0 + g + 8, applying the RoPE backward with the rows' tables.
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[Shape<D>::DC / 8][4], int row0,
                                           int c0, int n, const float* cos, const float* sin) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int dt = 0; dt < Shape<D>::DC / 8; ++dt) {
      const int col = c0 + dt * 8 + 2 * t;
      float x0 = acc[dt][2 * r], x1 = acc[dt][2 * r + 1];
      if (cos != nullptr) {
        const long long o = static_cast<long long>(row) * D + col;
        const float ce = round_bf16(cos[o]), co = round_bf16(cos[o + 1]);
        const float se = round_bf16(sin[o]), so = round_bf16(sin[o + 1]);
        const float y0 = x0 * ce + x1 * so, y1 = x1 * co - x0 * se;
        x0 = y0;
        x1 = y1;
      }
      *reinterpret_cast<float2*>(out + static_cast<long long>(row) * D + col) = make_float2(x0, x1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Shape<D>::THREADS) flash_bwd_dkdv_kernel(const Params<__nv_bfloat16> p) {
  using S = Shape<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BM * LD;
  __nv_bfloat16* sQ = sV + BM * LD;
  __nv_bfloat16* sG = sQ + BM * LD;
  float* sLse = reinterpret_cast<float*>(sG + BM * LD);
  float* sDelta = sLse + BM;

  const int k0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (warp % 4) * 16;     // warp's first key within the tile
  const int c0 = (warp / 4) * S::DC;  // warp's first output column
  const long long bh = static_cast<long long>(b) * gridDim.y + h;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* gg = p.g + b * p.g_sb + h * p.g_sh;
  const float* lse = p.lse + bh * p.n;
  const float* delta = p.delta + bh * p.n;
  const uint8_t* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * p.n;
  const float inv_n = 1.f / p.n;

  load_tile<D>(sK, kg, p.k_sn, k0, p.n, p.cos, p.sin);
  load_tile<D>(sV, vg, p.v_sn, k0, p.n, nullptr, nullptr);
  // this thread's keys: wr + g (index 0) and wr + g + 8 (index 1)
  const float bias[2] = {key_bias(mask, k0 + wr + g, p.n), key_bias(mask, k0 + wr + g + 8, p.n)};

  float dk[S::DC / 8][4], dv[S::DC / 8][4];
#pragma unroll
  for (int i = 0; i < S::DC / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int q0 = 0; q0 < p.n; q0 += BM) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile<D>(sQ, qg, p.q_sn, q0, p.n, p.cos, p.sin);
    load_tile<D>(sG, gg, p.g_sn, q0, p.n, nullptr, nullptr);
    if (threadIdx.x < BM) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < p.n ? lse[row] : FLT_MAX;  // rows past n get P = 0
      sDelta[threadIdx.x] = row < p.n ? delta[row] : 0.f;
    }
    __syncthreads();

    // P^T: the warp's 16 keys against the tile's 64 queries
    float pt[BM / 8][4];
    scores<D, BM / 8>(pt, sK, wr, sQ);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pt[nt][e] = prob(pt[nt][e] * p.scale, bias[e >> 1], sLse[nt * 8 + 2 * t + (e & 1)], inv_n);
      }
    }
    // dV += P^T g
    product<D>(dv, pt, sG, c0);
    // dS^T = P^T * (V g^T - delta) * scale
    float ds[BM / 8][4];
    scores<D, BM / 8>(ds, sV, wr, sG);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[nt][e] = pt[nt][e] * (ds[nt][e] - sDelta[nt * 8 + 2 * t + (e & 1)]) * p.scale;
      }
    }
    // dK' += dS^T Q'
    product<D>(dk, ds, sQ, c0);
  }

  float* dk_out = p.dk + bh * p.n * D;
  float* dv_out = p.dv + bh * p.n * D;
  store_rows<D>(dk_out, dk, k0 + wr, c0, p.n, p.cos, p.sin);
  store_rows<D>(dv_out, dv, k0 + wr, c0, p.n, nullptr, nullptr);
}

template <int D>
__global__ void __launch_bounds__(Shape<D>::THREADS) flash_bwd_dq_kernel(const Params<__nv_bfloat16> p) {
  using S = Shape<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sG = sQ + BM * LD;
  __nv_bfloat16* sK = sG + BM * LD;
  __nv_bfloat16* sV = sK + BM * LD;
  float* sBias = reinterpret_cast<float*>(sV + BM * LD);

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (warp % 4) * 16;     // warp's first query row within the tile
  const int c0 = (warp / 4) * S::DC;  // warp's first output column
  const long long bh = static_cast<long long>(b) * gridDim.y + h;

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* gg = p.g + b * p.g_sb + h * p.g_sh;
  const uint8_t* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * p.n;
  const float inv_n = 1.f / p.n;

  load_tile<D>(sQ, qg, p.q_sn, q0, p.n, p.cos, p.sin);
  load_tile<D>(sG, gg, p.g_sn, q0, p.n, nullptr, nullptr);
  // this thread's rows: wr + g (index 0) and wr + g + 8 (index 1)
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    lse[r] = row < p.n ? p.lse[bh * p.n + row] : FLT_MAX;
    delta[r] = row < p.n ? p.delta[bh * p.n + row] : 0.f;
  }

  float dq[S::DC / 8][4];
#pragma unroll
  for (int i = 0; i < S::DC / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int k0 = 0; k0 < p.n; k0 += BM) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile<D>(sK, kg, p.k_sn, k0, p.n, p.cos, p.sin);
    load_tile<D>(sV, vg, p.v_sn, k0, p.n, nullptr, nullptr);
    if (threadIdx.x < BM) sBias[threadIdx.x] = key_bias(mask, k0 + threadIdx.x, p.n);
    __syncthreads();

    // P: the warp's 16 queries against the tile's 64 keys
    float pr[BM / 8][4];
    scores<D, BM / 8>(pr, sQ, wr, sK);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr[nt][e] = prob(pr[nt][e] * p.scale, sBias[nt * 8 + 2 * t + (e & 1)], lse[e >> 1], inv_n);
      }
    }
    // dS = P * (g V^T - delta) * scale
    float ds[BM / 8][4];
    scores<D, BM / 8>(ds, sG, wr, sV);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = pr[nt][e] * (ds[nt][e] - delta[e >> 1]) * p.scale;
    }
    // dQ' += dS K'
    product<D>(dq, ds, sK, c0);
  }

  store_rows<D>(p.dq + bh * p.n * D, dq, q0 + wr, c0, p.n, p.cos, p.sin);
}

template <int D>
cudaError_t launch(const Params<__nv_bfloat16>& p, int b, int h, cudaStream_t stream) {
  const int smem = 4 * BM * Shape<D>::LD * static_cast<int>(sizeof(__nv_bfloat16)) +
                   2 * BM * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BM - 1) / BM, h, b);
  flash_bwd_dkdv_kernel<D><<<grid, Shape<D>::THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<grid, Shape<D>::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- float32

constexpr int F_BM = 32;  // rows per block (keys for dkdv, queries for dq), 4 per warp
constexpr int F_THREADS = 256;
constexpr int F_LANES = 8;  // lanes per row

// The RoPE forward on one float4 chunk starting at an even lane (tables not
// rounded): lane 2j takes -x[2j+1], lane 2j+1 takes x[2j].
template <int D>
__device__ __forceinline__ float4 rope_chunk(float4 x, const float* cos, const float* sin, int row, int c) {
  const float4 cs = *reinterpret_cast<const float4*>(cos + static_cast<long long>(row) * D + c);
  const float4 sn = *reinterpret_cast<const float4*>(sin + static_cast<long long>(row) * D + c);
  return make_float4(x.x * cs.x - x.y * sn.x, x.y * cs.y + x.x * sn.y,
                     x.z * cs.z - x.w * sn.z, x.w * cs.w + x.z * sn.w);
}

// The RoPE backward on one float4 chunk starting at an even lane.
template <int D>
__device__ __forceinline__ float4 rope_chunk_bwd(float4 x, const float* cos, const float* sin, int row, int c) {
  const float4 cs = *reinterpret_cast<const float4*>(cos + static_cast<long long>(row) * D + c);
  const float4 sn = *reinterpret_cast<const float4*>(sin + static_cast<long long>(row) * D + c);
  return make_float4(x.x * cs.x + x.y * sn.y, x.y * cs.y - x.x * sn.x,
                     x.z * cs.z + x.w * sn.w, x.w * cs.w - x.z * sn.z);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}

__device__ __forceinline__ void axpy4(float4& y, float a, float4 x) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// Load one row's float4 chunks (lane `sub` takes chunks sub, sub + 8, ...),
// zeros past n, rotated when tables are given.
template <int D>
__device__ __forceinline__ void load_row(float4 (&x)[D / 4 / F_LANES], const float* base, long long sn, int row,
                                         int n, int sub, const float* cos, const float* sin) {
#pragma unroll
  for (int i = 0; i < D / 4 / F_LANES; ++i) {
    const int c = (sub + F_LANES * i) * 4;
    x[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) {
      x[i] = *reinterpret_cast<const float4*>(base + row * sn + c);
      if (cos != nullptr) x[i] = rope_chunk<D>(x[i], cos, sin, row, c);
    }
  }
}

// Stage rows [row0, row0 + F_BM) of two heads' tensors into shared memory
// [F_BM][D], the first rotated when tables are given; zeros past n.
template <int D>
__device__ __forceinline__ void stage_pair(float* sA, float* sB, const float* a, long long a_sn, const float* b,
                                           long long b_sn, int row0, int n, const float* cos, const float* sin) {
  for (int i = threadIdx.x; i < F_BM * D / 4; i += F_THREADS) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    const int row = row0 + r;
    float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av;
    if (row < n) {
      av = *reinterpret_cast<const float4*>(a + row * a_sn + c);
      bv = *reinterpret_cast<const float4*>(b + row * b_sn + c);
      if (cos != nullptr) av = rope_chunk<D>(av, cos, sin, row, c);
    }
    *reinterpret_cast<float4*>(sA + r * D + c) = av;
    *reinterpret_cast<float4*>(sB + r * D + c) = bv;
  }
}

template <int D>
__device__ __forceinline__ void store_row(float* out, const float4 (&x)[D / 4 / F_LANES], int row, int n, int sub,
                                          const float* cos, const float* sin) {
  if (row >= n) return;
#pragma unroll
  for (int i = 0; i < D / 4 / F_LANES; ++i) {
    const int c = (sub + F_LANES * i) * 4;
    const float4 y = cos != nullptr ? rope_chunk_bwd<D>(x[i], cos, sin, row, c) : x[i];
    *reinterpret_cast<float4*>(out + static_cast<long long>(row) * D + c) = y;
  }
}

template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_bwd_dkdv_f32_kernel(const Params<float> p) {
  constexpr int CH = D / 4 / F_LANES;  // float4 chunks per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [F_BM][D]
  float* sG = sQ + F_BM * D;
  float* sLse = sG + F_BM * D;
  float* sDelta = sLse + F_BM;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int sub = threadIdx.x % F_LANES;
  const int key = blockIdx.x * F_BM + threadIdx.x / F_LANES;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  const uint8_t* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * p.n;
  const float* lse = p.lse + bh * p.n;
  const float* delta = p.delta + bh * p.n;
  const float inv_n = 1.f / p.n;

  float4 k[CH], v[CH], dk[CH], dv[CH];
  load_row<D>(k, p.k + b * p.k_sb + h * p.k_sh, p.k_sn, key, p.n, sub, p.cos, p.sin);
  load_row<D>(v, p.v + b * p.v_sb + h * p.v_sh, p.v_sn, key, p.n, sub, nullptr, nullptr);
#pragma unroll
  for (int i = 0; i < CH; ++i) dk[i] = dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float bias = key_bias(mask, key, p.n);

  for (int q0 = 0; q0 < p.n; q0 += F_BM) {
    __syncthreads();  // the previous tile is consumed by every warp
    stage_pair<D>(sQ, sG, p.q + b * p.q_sb + h * p.q_sh, p.q_sn, p.g + b * p.g_sb + h * p.g_sh, p.g_sn, q0, p.n,
                  p.cos, p.sin);
    if (threadIdx.x < F_BM) {
      const int row = q0 + threadIdx.x;
      sLse[threadIdx.x] = row < p.n ? lse[row] : FLT_MAX;
      sDelta[threadIdx.x] = row < p.n ? delta[row] : 0.f;
    }
    __syncthreads();

    for (int j = 0; j < F_BM; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = (sub + F_LANES * i) * 4;
        s = dot4(k[i], *reinterpret_cast<const float4*>(sQ + j * D + c), s);
        dp = dot4(v[i], *reinterpret_cast<const float4*>(sG + j * D + c), dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const float pj = prob_f32(s * p.scale, bias, sLse[j], inv_n);
      const float ds = pj * (dp - sDelta[j]) * p.scale;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = (sub + F_LANES * i) * 4;
        axpy4(dv[i], pj, *reinterpret_cast<const float4*>(sG + j * D + c));
        axpy4(dk[i], ds, *reinterpret_cast<const float4*>(sQ + j * D + c));
      }
    }
  }

  store_row<D>(p.dk + bh * p.n * D, dk, key, p.n, sub, p.cos, p.sin);
  store_row<D>(p.dv + bh * p.n * D, dv, key, p.n, sub, nullptr, nullptr);
}

template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_bwd_dq_f32_kernel(const Params<float> p) {
  constexpr int CH = D / 4 / F_LANES;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // [F_BM][D]
  float* sV = sK + F_BM * D;
  float* sBias = sV + F_BM * D;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int sub = threadIdx.x % F_LANES;
  const int row = blockIdx.x * F_BM + threadIdx.x / F_LANES;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  const uint8_t* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * p.n;
  const float inv_n = 1.f / p.n;

  float4 q[CH], g[CH], dq[CH];
  load_row<D>(q, p.q + b * p.q_sb + h * p.q_sh, p.q_sn, row, p.n, sub, p.cos, p.sin);
  load_row<D>(g, p.g + b * p.g_sb + h * p.g_sh, p.g_sn, row, p.n, sub, nullptr, nullptr);
#pragma unroll
  for (int i = 0; i < CH; ++i) dq[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float lse = row < p.n ? p.lse[bh * p.n + row] : FLT_MAX;
  const float delta = row < p.n ? p.delta[bh * p.n + row] : 0.f;

  for (int k0 = 0; k0 < p.n; k0 += F_BM) {
    __syncthreads();  // the previous tile is consumed by every warp
    stage_pair<D>(sK, sV, p.k + b * p.k_sb + h * p.k_sh, p.k_sn, p.v + b * p.v_sb + h * p.v_sh, p.v_sn, k0, p.n,
                  p.cos, p.sin);
    if (threadIdx.x < F_BM) sBias[threadIdx.x] = key_bias(mask, k0 + threadIdx.x, p.n);
    __syncthreads();

    for (int j = 0; j < F_BM; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int c = (sub + F_LANES * i) * 4;
        s = dot4(q[i], *reinterpret_cast<const float4*>(sK + j * D + c), s);
        dp = dot4(g[i], *reinterpret_cast<const float4*>(sV + j * D + c), dp);
      }
      s = row_sum(s);
      dp = row_sum(dp);
      const float ds = prob_f32(s * p.scale, sBias[j], lse, inv_n) * (dp - delta) * p.scale;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        axpy4(dq[i], ds, *reinterpret_cast<const float4*>(sK + j * D + (sub + F_LANES * i) * 4));
      }
    }
  }

  store_row<D>(p.dq + bh * p.n * D, dq, row, p.n, sub, p.cos, p.sin);
}

template <int D>
cudaError_t launch_f32(const Params<float>& p, int b, int h, cudaStream_t stream) {
  const int smem = (2 * F_BM * D + 2 * F_BM) * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + F_BM - 1) / F_BM, h, b);
  flash_bwd_dkdv_f32_kernel<D><<<grid, F_THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<D><<<grid, F_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
Params<T> make_params(const void* q, const void* k, const void* v, const void* g, const void* lse,
                      const void* delta, const void* mask, const void* cos, const void* sin, void* dq, void* dk,
                      void* dv, int n, const long long* strides, float scale) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.g = static_cast<const T*>(g);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.mask = static_cast<const uint8_t*>(mask);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.n = n;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_sn = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_sn = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_sn = strides[8];
  p.g_sb = strides[9]; p.g_sh = strides[10]; p.g_sn = strides[11];
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 on success). q, k, v, g are
// [b, h, n, d] with (batch, head, row) strides in elements in `strides`
// (q, k, v, g in turn) and a contiguous head dim; lse and delta are
// contiguous float32 [b, h, n]; dq, dk, dv contiguous float32 [b, h, n, d].
int f5_flash_attention_bwd(const void* q, const void* k, const void* v, const void* g, const void* lse,
                           const void* delta, const void* mask, const void* cos, const void* sin, void* dq,
                           void* dk, void* dv, int b, int h, int n, int d, const long long* strides, float scale,
                           void* stream) {
  const auto p = make_params<__nv_bfloat16>(q, k, v, g, lse, delta, mask, cos, sin, dq, dk, dv, n, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch<64>(p, b, h, s));
    case 128: return static_cast<int>(launch<128>(p, b, h, s));
    case 256: return static_cast<int>(launch<256>(p, b, h, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The float32 kernels; the same arguments as f5_flash_attention_bwd.
int f5_flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* g, const void* lse,
                               const void* delta, const void* mask, const void* cos, const void* sin, void* dq,
                               void* dk, void* dv, int b, int h, int n, int d, const long long* strides,
                               float scale, void* stream) {
  const auto p = make_params<float>(q, k, v, g, lse, delta, mask, cos, sin, dq, dk, dv, n, strides, scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch_f32<64>(p, b, h, s));
    case 128: return static_cast<int>(launch_f32<128>(p, b, h, s));
    case 256: return static_cast<int>(launch_f32<256>(p, b, h, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* f5_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
