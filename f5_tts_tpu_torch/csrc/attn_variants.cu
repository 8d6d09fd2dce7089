// The probe tools' `attn_flat` for Hopper (sm_90a), bf16 on the tensor
// cores with mma.sync.
//
// Replaces the Pallas TPU kernel tools/attn_variants.py `attn_flat` (body
// `_attn_kernel_flat`) of the JAX package's probe tools: one head of a flat
// b * h grid per step. The function: softmax(q k^T * scale) v with no mask.
// (`attn_pack2`, the same function, and the RoPE probe kernels,
// flash_bhnd_rope and flash_nhd, run the TMA + wgmma core in
// attn_rope_wgmma.cu.)
//
// What bounds it on this card. Per head the work is 4 n^2 d FLOP against
// 4 n d bf16 values of q, k, v and the output: at n = 1024, d = 64 about 128
// FLOP per byte, so it wants the tensor cores. The TPU kernel holds a whole
// head's sequence in VMEM; K and V of one head at n = 1024, d = 64 are
// 256 KB of bf16 against 227 KB of shared memory per block here, so this
// kernel tiles.
//
// Design (the same plan as the attention forward in
// flash_attention_fwd.cu, sharing its bf16 helpers through mma_bf16.cuh but
// with new kernels, so that the probes compare distinct kernels):
//   - a block of 4 warps owns one head of the flat b * h index and a 64-row
//     q tile of it, 16 rows per warp;
//   - K and V stream through shared memory in 64-row tiles with an online
//     softmax (running max and sum in float32, output accumulated in float32
//     registers); keys past n score -inf and are zero-filled, so they add
//     exactly 0;
//   - both products run on mma.sync m16n8k16 (bf16 operands, float32
//     accumulation); the score accumulator is the A operand of the second
//     product, so P stays in registers. P is rounded to bf16 unnormalised
//     against the running max, where the Pallas body rounds it against the
//     row's final max: both divide the float32 PV sum by the float32 sum of
//     the unrounded p, and the two differ by bf16 rounding of p only;
//   - q, k, v and the output are addressed through (batch, head, row)
//     strides; the head dim must be contiguous and rows 16-byte aligned.
// cp.async / TMA double buffering, wgmma and warp specialisation are not
// used (attn_rope_wgmma.cu's core is that design).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int BM = 64;  // query rows per head group, 16 per warp
constexpr int BN = 64;  // keys per K/V tile
constexpr int THREADS = 4 * 32;  // the warps of one head
constexpr int PAD = 8;  // bf16 padding per shared-memory row: conflict-free fragment loads

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int bh, h, n;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  float scale;
};

// Copy rows [row0, row0 + 64) of one head into shared memory (row stride
// D + PAD) with the block's threads, zero-filling rows >= n.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g, long long sn,
                                          int row0, int n, int tid) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < BN * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) val = *reinterpret_cast<const uint4*>(g + row * sn + c);
    *reinterpret_cast<uint4*>(s + r * (D + PAD) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) attn_variant_kernel(const Params p) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BM * LD;
  __nv_bfloat16* sV = sK + BN * LD;

  const int q0 = blockIdx.x * BM;
  const int head = blockIdx.y;
  const int b = head / p.h;
  const int h = head % p.h;
  const int lane = tid % 32;
  const int g = lane / 4;  // row within the 8-row group of an mma fragment
  const int t = lane % 4;  // column pair within the fragment
  const int wr = (tid / 32) * 16;  // warp's first row within the tile

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;

  load_tile<D>(sQ, qg, p.q_sn, q0, p.n, tid);

  // thread's rows: wr + g (index 0) and wr + g + 8 (index 1)
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < p.n; k0 += BN) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile<D>(sK, kg, p.k_sn, k0, p.n, tid);
    load_tile<D>(sV, vg, p.v_sn, k0, p.n, tid);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const __nv_bfloat16* qa = sQ + (wr + g) * LD + kc * 16 + 2 * t;
      const uint32_t a0 = ld32(qa), a1 = ld32(qa + 8 * LD), a2 = ld32(qa + 8), a3 = ld32(qa + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const __nv_bfloat16* kb = sK + (nt * 8 + g) * LD + kc * 16 + 2 * t;
        mma_16816(s[nt], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
      }
    }

    // scale (keys past n at -inf), online softmax update; the first tile
    // always holds key 0, so the running max is finite from then on
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = key < p.n ? s[nt][e] * p.scale : -INFINITY;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[nt][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      alpha[r] = __expf(m[r] - mt[r]);
      m[r] = mt[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = __expf(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    }

    // O += P V, P rounded to bf16 straight from the score registers
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint32_t a0 = pack_f32(s[2 * kc][0], s[2 * kc][1]);
      const uint32_t a1 = pack_f32(s[2 * kc][2], s[2 * kc][3]);
      const uint32_t a2 = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      const uint32_t a3 = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vb = sV + (kc * 16 + 2 * t) * LD + dt * 8 + g;
        mma_16816(acc[dt], a0, a1, a2, a3, pack_bf16(vb[0], vb[LD]), pack_bf16(vb[8 * LD], vb[9 * LD]));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + wr + g + 8 * r;
    if (row < p.n) {
      const float inv = 1.f / l[r];
      __nv_bfloat16* orow = og + row * p.o_sn + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8) = pack_f32(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
      }
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int smem = (BM + 2 * BN) * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err = cudaFuncSetAttribute(attn_variant_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BM - 1) / BM, p.bh);
  attn_variant_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 on success). bh = b * h heads of
// a flat index, head i at batch row i / h and head i % h; strides are in
// elements, the head dim contiguous.
int f5_attn_variant(const void* q, const void* k, const void* v, void* o, int bh, int h, int n, int d,
                    long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                    long long k_sh, long long k_sn, long long v_sb, long long v_sh, long long v_sn,
                    long long o_sb, long long o_sh, long long o_sn, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.bh = bh;
  p.h = h;
  p.n = n;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.scale = scale;
  if (bh < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch<64>(p, s));
    case 128: return static_cast<int>(launch<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* f5_attn_variant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
