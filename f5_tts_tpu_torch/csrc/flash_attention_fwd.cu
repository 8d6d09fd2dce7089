// Flash-attention forward for Hopper (sm_90a): in bf16 a rotation pre-pass
// and the TMA-fed wgmma attention core (csrc/attn_core.cuh) at d = 64 and
// 128, an mma.sync kernel at d = 256; in float32 a kernel on the tensor
// cores in 3xTF32 at d = 64 (TMA + wgmma), and a kernel on the FMA units at
// d = 128 and 256.
//
// Replaces the Pallas TPU kernel of the JAX package:
// f5_tts_tpu/ops/flash_attention.py, `_flash_attention_call` (kernel body
// `_make_kernel`, wrapper `flash_attention`). It computes the same function:
// non-causal softmax(q k^T * scale - (1 - mask) * 1e30) v over [b, h, n, d],
// with an optional key-padding mask and an optional interleaved rotary
// embedding of q and k, x * cos + bf16(x @ P) * sin with P the pair swap
// (rotate_half), computed in q's dtype. Softmax statistics are float32.
//
// What bounds it on this card. Per (b, h) the work is 4 n^2 d FLOP against
// 4 n d bytes of q, k, v and the output, so at the model's n = 1024, d = 64
// (about 500 FLOP a byte) it is bound by the tensor cores, which only wgmma
// drives at full rate. The TPU kernel held all of K and V of one head in
// fast memory (1 MB at n = 4096); a Hopper block has 227 KB of shared
// memory, so K and V stream through it in tiles with an online softmax.
//
// bf16 at d = 64 and 128 (every sampling and CFM training call of the
// models). The first kernel (mma.sync, 4 warps a 64-row q tile) staged
// 64-row K/V tiles with plain loads between two __syncthreads, rotated every
// K tile again in every block that read it (16 times a head at n = 1024),
// read P V's B fragments from shared memory element by element, and rounded
// the rotation once in float32 where the JAX body rounds three times. This
// design is two launches:
//   - a pre-pass (flash_fwd_prepass_kernel) rotates q and k once into a
//     bf16 scratch [2, b * h, n_pad, d] (rope(q), then rope(k); n_pad a
//     multiple of 128, rows past n zero) with the JAX body's roundings,
//     bf16(bf16(x * cos) + bf16(rotate_half(x) * sin)), cos and sin rounded to
//     bf16 (packed bf16 multiplies and adds; the pair swap is a lane swap in
//     registers, exact as the body's x @ P is), each thread taking one
//     16-byte chunk of a row for PRE_HEADS heads with the row's tables read
//     once; and, with a key mask, each key's bias [b, n_pad] (0 kept, -1e30
//     masked or past n: the body's -(1 - mask) * 1e30). Without RoPE it
//     writes only the biases, and the core reads q and k in place; with
//     neither, the core runs alone. A model that rotates only its first
//     heads (E2 TTS's UNetT, RoPE on head 0) passes rope_heads: the other
//     heads' chunks go to the scratch as they were loaded;
//   - the core, with the key bias when there is a mask, reads q and k (or
//     the scratch's halves) and v through tensor maps over their (batch,
//     head, row) strides and writes the output through its strides, and the
//     row log-sum-exp for the backward when asked.
// bf16 at d = 256 keeps the first kernel (a warpgroup's 64 x 256 float32
// accumulator does not fit beside the scores, as in the backward): one
// block of 4 warps per (64-row q tile, head, batch row), 64-row K/V tiles
// through shared memory, both products on mma.sync m16n8k16 with P kept in
// registers, masked keys at -1e30 and keys past n at -FLT_MAX, the rotation
// in registers while a tile is copied (the same roundings as the pre-pass).

// The float32 kernels compute the same function to float32 accuracy, as the
// JAX kernel does for float32 inputs (HIGHEST precision): no bf16 rounding of
// P or of the rotated q and k, tables not rounded. They serve models whose
// compute dtype is float32, such as the duration predictor.
//
// At d = 64 (the duration predictor's head dim), 3xTF32 on the tensor cores
// (csrc/tf32.cuh gives the split, its accuracy and which instruction takes
// which product). The first float32 kernel, on the FMA units, reached 10.6
// TFLOP/s of the 67 the FMA units offer on the H100 (0.81 ms at
// [2, 16, 1024, 64]): 8 lanes shared a row, so a score cost a lane 8 FMAs,
// 3 shuffles and 3 adds; its K/V tiles were staged with plain loads between
// two __syncthreads, so no copy overlapped compute; every block rotated every
// K tile it staged (32 times a head at n = 1024); and it set the
// shared-memory limit on every launch. This design:
//   - a pre-pass kernel (`tc_prep_kernel`) writes rope(q), rope(k) and v
//     once, split into TF32 halves, and each key's bias padded to 128 keys;
//   - the main kernel is warp specialised: one producer warp loads the
//     block's 128 rows of Q' (hi, lo) once and keeps a 2-stage ring of K'
//     and V tiles (hi, lo: 64 KB) and their key biases filled with TMA
//     copies, each stage guarded by a full and an empty mbarrier; two
//     consumer warpgroups (64 query rows each) run S = Q' K'^T as 24
//     wgmma.m64n64k8.tf32 from shared memory (the cross terms, then hi hi),
//     the online softmax in registers, and O += P V as mma.sync.m16n8k8.tf32
//     with P split in registers and V's fragments read from the stage;
//   - 195 KB of shared memory, one block an SM; the limit is raised once per
//     device.
// At d = 128 and 256 (no model of the repo uses them in float32) the first
// kernel stays: one block of 8 warps per 32-row q tile, 8 lanes a row each
// owning d/8 of its dims in float4 chunks, 32-row K/V tiles staged through
// shared memory, RoPE in registers, the same online softmax and masking.
//
// Every kernel optionally writes the per-row log-sum-exp of the scaled,
// biased scores, m + log(l) in float32 [b, h, n], when the lse pointer is not
// null: the backward (flash_attention_bwd.cu) recomputes P = exp(s - lse)
// from it instead of rescanning a whole row of keys.
//
// A query block (sequence parallelism in training: a slot's n rows of the
// sequence, from row q_off, against all nk keys its group gathered): the
// bf16 pre-pass + core at d = 64 and 128 and the float32 3xTF32 kernel at
// d = 64 take q [b, h, n, d] against k and v [b, h, nk, d], a key mask
// [b, nk] and tables [nk, d], whose rows q_off .. q_off + n - 1 rotate the
// queries and rows 0 .. nk - 1 the keys. Only the pre-passes know the
// offset; the query grid, the scratch rows and the lse cover n, the key loop
// and the key biases nk. The other kernels (bf16 d = 256, float32 d = 128
// and 256) take n = nk and q_off = 0 only: their entry points refuse a block.
//
// The Python wrapper raises ValueError for any dtype but bf16 and float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "attn_core.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr int BM = 64;  // query rows per block, 16 per warp
constexpr int BN = 64;  // keys per K/V tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;  // bf16 padding per shared-memory row: conflict-free fragment loads
constexpr float MASKED = -1e30f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;           // [b, h, n] or null
  const uint8_t* mask;  // [b, n] or null
  const float* cos;     // [n, d] or null
  const float* sin;     // [n, d] or null
  int n;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  float scale;
};

// Copy rows [row0, row0 + 64) of one head into shared memory (row stride
// D + PAD), zero-filling rows >= n. With tables, rotate each (2j, 2j+1) pair
// (rope_pair_bf16: the JAX body's three roundings, tables rounded to bf16).
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g, long long sn,
                                          int row0, int n, const float* cos, const float* sin) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BN * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) {
      val = *reinterpret_cast<const uint4*>(g + row * sn + c);
      if (cos != nullptr) val = rope_chunk_bf16(val, table_chunk_bf16<D>(cos, row, c), table_chunk_bf16<D>(sin, row, c));
    }
    *reinterpret_cast<uint4*>(s + r * (D + PAD) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + BM * LD;
  __nv_bfloat16* sV = sK + BN * LD;
  float* sBias = reinterpret_cast<float*>(sV + BN * LD);  // per-key additive bias

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row group of an mma fragment
  const int t = lane % 4;  // column pair within the fragment
  const int wr = (threadIdx.x / 32) * 16;  // warp's first row within the q tile

  const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
  const uint8_t* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * p.n;

  load_tile<D>(sQ, qg, p.q_sn, q0, p.n, p.cos, p.sin);

  // thread's rows: wr + g (index 0) and wr + g + 8 (index 1)
  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < p.n; k0 += BN) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile<D>(sK, kg, p.k_sn, k0, p.n, p.cos, p.sin);
    load_tile<D>(sV, vg, p.v_sn, k0, p.n, nullptr, nullptr);
    if (threadIdx.x < BN) {
      const int key = k0 + threadIdx.x;
      sBias[threadIdx.x] = key >= p.n ? -FLT_MAX : (mask != nullptr && !mask[key]) ? MASKED : 0.f;
    }
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

    // scale, bias, online softmax update
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = s[nt][e] * p.scale + sBias[nt * 8 + 2 * t + (e & 1)];
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
      if (p.lse != nullptr && t == 0) {
        p.lse[(static_cast<long long>(b) * gridDim.y + h) * p.n + row] = m[r] + logf(l[r]);
      }
      __nv_bfloat16* orow = og + row * p.o_sn + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8) = pack_f32(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
      }
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int b, int h, cudaStream_t stream) {
  const int smem = (BM + 2 * BN) * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16)) +
                   BN * static_cast<int>(sizeof(float));
  static std::atomic<bool> raised[MAX_DEVICES];
  const cudaError_t err = raise_smem_limit(reinterpret_cast<const void*>(flash_fwd_kernel<D>), smem, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BM - 1) / BM, h, b);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------ bf16, d = 64 and 128: pre-pass + the core

constexpr int PRE_THREADS = 256;
constexpr int PRE_HEADS = 4;  // heads a pre-pass thread rotates with its chunk of the tables

struct PrepassParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const uint8_t* mask;  // [b, nk] or null
  const float* cos;     // [nk, d] or null: key row i takes row i, query row i row q_off + i
  const float* sin;
  __nv_bfloat16* rot;   // rope(q) [b * h, n_pad, d], then rope(k) [b * h, nk_pad, d]; written when cos is not null
  float* kbias;         // [b, nk_pad], written when mask is not null
  int b, h, n, n_pad;   // the query rows
  int nk, nk_pad, q_off;  // the keys, and the queries' first table row
  int rope_heads;       // heads 0 .. rope_heads - 1 are rotated, the others copied as they are
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
};

// One thread per 16-byte chunk of a scratch row (grid x over
// max(n_pad, nk_pad) * D / 8 chunks) and PRE_HEADS heads (grid y); the heads'
// q and k chunks are loaded before any is rotated, so eight loads are in
// flight a thread. The first row of blocks also writes the key biases of its
// rows. Without an offset a row's tables serve both its query and its key.
// Heads from rope_heads on are copied unrotated (RoPE on a subset of heads).
template <int D>
__global__ void __launch_bounds__(PRE_THREADS) flash_fwd_prepass_kernel(const PrepassParams p) {
  constexpr int CH = D / 8;
  const int i = blockIdx.x * PRE_THREADS + threadIdx.x;
  const int row = i / CH, c = (i % CH) * 8;
  if (row >= max(p.n_pad, p.nk_pad)) return;
  const bool q_valid = row < p.n, k_valid = row < p.nk;
  if (p.kbias != nullptr && blockIdx.y == 0 && c == 0 && row < p.nk_pad) {
    for (int b = 0; b < p.b; ++b) {
      p.kbias[static_cast<long long>(b) * p.nk_pad + row] =
          k_valid && p.mask[static_cast<long long>(b) * p.nk + row] ? 0.f : MASKED;
    }
  }
  if (p.cos == nullptr) return;
  const int bh = p.b * p.h;
  uint4 x[2 * PRE_HEADS];
#pragma unroll
  for (int j = 0; j < PRE_HEADS; ++j) {
    const int head = blockIdx.y * PRE_HEADS + j;
    x[2 * j] = x[2 * j + 1] = make_uint4(0u, 0u, 0u, 0u);
    if (head < bh) {
      const int b = head / p.h, h = head % p.h;
      if (q_valid) x[2 * j] = *reinterpret_cast<const uint4*>(p.q + b * p.q_sb + h * p.q_sh + row * p.q_sn + c);
      if (k_valid) x[2 * j + 1] = *reinterpret_cast<const uint4*>(p.k + b * p.k_sb + h * p.k_sh + row * p.k_sn + c);
    }
  }
  // the chunk's tables as bf16 pairs, zero past the rows (zero rows stay zero)
  uint4 kc = make_uint4(0u, 0u, 0u, 0u), ks = kc, qc = kc, qs = kc;
  if (k_valid) {
    kc = table_chunk_bf16<D>(p.cos, row, c);
    ks = table_chunk_bf16<D>(p.sin, row, c);
  }
  if (p.q_off == 0) {  // q_off + n <= nk: a valid query row is a valid key row
    qc = kc;
    qs = ks;
  } else if (q_valid) {
    qc = table_chunk_bf16<D>(p.cos, row + p.q_off, c);
    qs = table_chunk_bf16<D>(p.sin, row + p.q_off, c);
  }
  __nv_bfloat16* rot_k = p.rot + static_cast<long long>(bh) * p.n_pad * D;
#pragma unroll
  for (int j = 0; j < 2 * PRE_HEADS; ++j) {
    const int head = blockIdx.y * PRE_HEADS + j / 2;
    if (head >= bh) continue;
    const bool turn = head % p.h < p.rope_heads;
    if (j % 2 == 0 && row < p.n_pad) {
      *reinterpret_cast<uint4*>(p.rot + (static_cast<long long>(head) * p.n_pad + row) * D + c) =
          turn ? rope_chunk_bf16(x[j], qc, qs) : x[j];
    } else if (j % 2 == 1 && row < p.nk_pad) {
      *reinterpret_cast<uint4*>(rot_k + (static_cast<long long>(head) * p.nk_pad + row) * D + c) =
          turn ? rope_chunk_bf16(x[j], kc, ks) : x[j];
    }
  }
}

template <int D>
cudaError_t launch_fwd_prepass(const PrepassParams& p, cudaStream_t stream) {
  const int bh = p.b * p.h;
  const dim3 grid((p.n_pad > p.nk_pad ? p.n_pad : p.nk_pad) * (D / 8) / PRE_THREADS,
                  p.cos == nullptr ? 1 : (bh + PRE_HEADS - 1) / PRE_HEADS);
  flash_fwd_prepass_kernel<D><<<grid, PRE_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

// The pre-pass (when there is a rotation or a mask), then the core: over the
// scratch's parts, contiguous [b, h, n_pad, d] and [b, h, nk_pad, d], or over
// q and k in place (rows past n or nk arrive as TMA's zero fill); with the
// key biases when there is a mask, and writing the lse when asked.
template <int D>
cudaError_t launch_core_fwd(const PrepassParams& pp, const void* v, long long v_sb, long long v_sh, long long v_sn,
                            const CoreParams& c, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (pp.cos != nullptr || pp.mask != nullptr) err = launch_fwd_prepass<D>(pp, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap q_map, k_map;
  if (pp.cos != nullptr) {
    const long long hq = static_cast<long long>(pp.n_pad) * D, hk = static_cast<long long>(pp.nk_pad) * D;
    err = tile_map<D>(&q_map, pp.rot, pp.n_pad, pp.h, pp.b, D, hq, pp.h * hq);
    if (err == cudaSuccess) {
      err = tile_map<D>(&k_map, pp.rot + pp.b * pp.h * hq, pp.nk_pad, pp.h, pp.b, D, hk, pp.h * hk);
    }
  } else {
    err = tile_map<D>(&q_map, pp.q, pp.n, pp.h, pp.b, pp.q_sn, pp.q_sh, pp.q_sb);
    if (err == cudaSuccess) err = tile_map<D>(&k_map, pp.k, pp.nk, pp.h, pp.b, pp.k_sn, pp.k_sh, pp.k_sb);
  }
  if (err != cudaSuccess) return err;
  const bool bias = pp.mask != nullptr, lse = c.lse != nullptr;
  auto run = [&](auto launch) { return launch(q_map, k_map, v, v_sb, v_sh, v_sn, pp.b, c, stream); };
  if (bias) return lse ? run(launch_core<D, true, true>) : run(launch_core<D, true, false>);
  return lse ? run(launch_core<D, false, true>) : run(launch_core<D, false, false>);
}

PrepassParams prepass_params(const void* q, const void* k, const void* mask, const void* cos, const void* sin,
                             void* rot, void* kbias, int b, int h, int n, int nk, int n_pad, int nk_pad, int q_off,
                             int rope_heads, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                             long long k_sh, long long k_sn) {
  PrepassParams p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.mask = static_cast<const uint8_t*>(mask);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.rot = static_cast<__nv_bfloat16*>(rot);
  p.kbias = static_cast<float*>(kbias);
  p.b = b;
  p.h = h;
  p.n = n;
  p.n_pad = n_pad;
  p.nk = nk;
  p.nk_pad = nk_pad;
  p.q_off = q_off;
  p.rope_heads = rope_heads;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  return p;
}

// The scratch the pre-pass writes must be there for what it writes, n_pad
// and nk_pad the rows the core's blocks and key tiles cover, and the tables
// must hold the query block's rows.
bool core_args_ok(const PrepassParams& p) {
  return p.b >= 1 && p.h >= 1 && p.n >= 1 && p.nk >= 1 && p.n_pad >= p.n && p.n_pad % ROW_PAD == 0 &&
         p.nk_pad >= p.nk && p.nk_pad % ROW_PAD == 0 && p.q_off >= 0 && p.rope_heads >= 0 && p.rope_heads <= p.h &&
         (p.cos == nullptr || (p.rot != nullptr && p.q_off + p.n <= p.nk)) &&
         (p.mask == nullptr || p.kbias != nullptr);
}

// ---------------------------------------------------------------- float32

struct ParamsF32 {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;           // [b, h, n] or null
  const uint8_t* mask;  // [b, nk] or null
  const float* cos;     // [nk, d] or null
  const float* sin;     // [nk, d] or null
  int n;                // the query rows
  int nk, q_off;        // the keys, and the queries' first table row (nk = n, q_off = 0 but at d = 64)
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  float scale;
};

// ------------------------------------------ float32, d = 64: 3xTF32, TMA + wgmma

using FwdTc = TcShape<2, 2>;  // two consumer warpgroups, 128 query rows; Q' hi and lo owned

// One block per (128 query rows, head, batch row). The producer (lane 0 of
// the last warp) loads the block's Q' (hi, lo) once, then streams K' and V
// (hi, lo) and the key biases of each 64-key tile through the ring.
__global__ void __launch_bounds__(FwdTc::THREADS, 1)
flash_fwd_f32_tc_kernel(const __grid_constant__ CUtensorMap qh_map, const __grid_constant__ CUtensorMap ql_map,
                        const __grid_constant__ CUtensorMap kh_map, const __grid_constant__ CUtensorMap kl_map,
                        const __grid_constant__ CUtensorMap vh_map, const __grid_constant__ CUtensorMap vl_map,
                        const ParamsF32 p, const float* kbias, int nk_pad) {
  using S = FwdTc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQh = smem;
  unsigned char* sQl = smem + S::OWN;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* full = own + 1;
  uint64_t* empty = full + S::STAGES;
  // a stage: K' hi, K' lo, V hi, V lo, then 64 key biases
  auto stage = [&](int s) { return smem + 2 * S::OWN + s * S::STAGE; };

  const int q0 = blockIdx.x * S::ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tiles = (p.nk + TC_BM - 1) / TC_BM;

  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], S::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= S::CONSUMERS) {  // producer warp
    if (threadIdx.x == S::CONSUMERS) {
      mbar_arrive_expect_tx(own, 2 * S::OWN);
      for (int pn = 0; pn < 2; ++pn) {
        for (int r = 0; r < 2; ++r) {
          const int off = pn * S::OWN_PANEL + r * TC_PANEL;
          tma_load_4d(sQh + off, &qh_map, own, pn * 32, q0 + r * TC_BM, h, b);
          tma_load_4d(sQl + off, &ql_map, own, pn * 32, q0 + r * TC_BM, h, b);
        }
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % S::STAGES;
        if (it >= S::STAGES) mbar_wait(&empty[s], (it / S::STAGES - 1) & 1);
        unsigned char* st = stage(s);
        mbar_arrive_expect_tx(&full[s], 4 * S::TILE + TC_BM * 4);
        for (int pn = 0; pn < 2; ++pn) {
          const int off = pn * TC_PANEL;
          tma_load_4d(st + off, &kh_map, &full[s], pn * 32, it * TC_BM, h, b);
          tma_load_4d(st + S::TILE + off, &kl_map, &full[s], pn * 32, it * TC_BM, h, b);
          tma_load_4d(st + 2 * S::TILE + off, &vh_map, &full[s], pn * 32, it * TC_BM, h, b);
          tma_load_4d(st + 3 * S::TILE + off, &vl_map, &full[s], pn * 32, it * TC_BM, h, b);
        }
        bulk_load(st + 4 * S::TILE, kbias + static_cast<long long>(b) * nk_pad + it * TC_BM, TC_BM * 4, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = wg * 64 + (threadIdx.x / 32 % 4) * 16;  // this warp's first query in the block

  // thread's rows: row0 + g (index 0) and row0 + g + 8 (index 1)
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX};
  float l[2] = {0.f, 0.f};

  mbar_wait(own, 0);
  const uint64_t qh_desc = sw128_desc(sQh + wg * TC_PANEL), ql_desc = sw128_desc(sQl + wg * TC_PANEL);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % S::STAGES;
    mbar_wait(&full[s], (it / S::STAGES) & 1);
    const unsigned char* st = stage(s);
    const float* bias = reinterpret_cast<const float*>(st + 4 * S::TILE);

    float sc[32];
    wgmma_fence();
    scores_3xtf32(sc, qh_desc, ql_desc, S::OWN_PANEL, sw128_desc(st), sw128_desc(st + S::TILE));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale, bias, online softmax update
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * i + e] = sc[4 * i + e] * p.scale + bias[8 * i + 2 * t + (e & 1)];
        mt[e >> 1] = fmaxf(mt[e >> 1], sc[4 * i + e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      alpha[r] = expf(m[r] - mt[r]);
      m[r] = mt[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sc[i] = expf(sc[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += sc[i];
    }

    // O += P V
    pv_3xtf32(acc, sc, st + 2 * S::TILE, st + 3 * S::TILE);
    mbar_arrive(&empty[s]);
  }

  float* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + row0 + g + 8 * r;
    if (row < p.n) {
      const float inv = 1.f / l[r];
      if (p.lse != nullptr && t == 0) {
        p.lse[(static_cast<long long>(b) * gridDim.y + h) * p.n + row] = m[r] + logf(l[r]);
      }
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        *reinterpret_cast<float2*>(og + row * p.o_sn + 8 * nb + 2 * t) =
            make_float2(acc[4 * nb + 2 * r] * inv, acc[4 * nb + 2 * r + 1] * inv);
      }
    }
  }
}

// The pre-pass into `scratch` (laid out by `tc_carve`), then the main kernel.
cudaError_t launch_f32_tc(const ParamsF32& p, float* scratch, int b, int h, cudaStream_t stream) {
  TcPrep pp{};
  pp.q = p.q;
  pp.k = p.k;
  pp.v = p.v;
  pp.mask = p.mask;
  pp.cos = p.cos;
  pp.sin = p.sin;
  pp.h = h;
  pp.n = p.n;
  pp.n_pad = align_up(p.n, TC_ROW_PAD);
  pp.nk = p.nk;
  pp.nk_pad = align_up(p.nk, TC_ROW_PAD);
  pp.q_off = p.q_off;
  pp.q_sb = p.q_sb; pp.q_sh = p.q_sh; pp.q_sn = p.q_sn;
  pp.k_sb = p.k_sb; pp.k_sh = p.k_sh; pp.k_sn = p.k_sn;
  pp.v_sb = p.v_sb; pp.v_sh = p.v_sh; pp.v_sn = p.v_sn;
  tc_carve(pp, scratch, b, false, 6);
  cudaError_t err = launch_tc_prep<TC_D>(pp, b, stream);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[6];
  float* halves[6] = {pp.qh, pp.ql, pp.kh, pp.kl, pp.vh, pp.vl};
  for (int i = 0; i < 6 && err == cudaSuccess; ++i) err = tc_head_map(&maps[i], halves[i], b, h, i < 2 ? p.n : p.nk);
  if (err != cudaSuccess) return err;
  static std::atomic<bool> raised[MAX_DEVICES];
  err = raise_smem_limit(reinterpret_cast<const void*>(flash_fwd_f32_tc_kernel), FwdTc::SMEM, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + FwdTc::ROWS - 1) / FwdTc::ROWS, h, b);
  flash_fwd_f32_tc_kernel<<<grid, FwdTc::THREADS, FwdTc::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                                         maps[4], maps[5], p, pp.kbias, pp.nk_pad);
  return cudaGetLastError();
}

// ------------------------------------------ float32, d = 128 and 256: FMA

constexpr int F_BM = 32;  // query rows per block, 4 per warp
constexpr int F_BN = 32;  // keys per K/V tile
constexpr int F_THREADS = 256;
constexpr int F_LANES = 8;  // lanes per query row

// x * cos + rotate_half(x) * sin on one float4 chunk that starts at an even
// lane of row `row`: lane 2j takes -x[2j+1], lane 2j+1 takes x[2j].
template <int D>
__device__ __forceinline__ float4 rope_chunk(float4 x, const float* cos, const float* sin, int row, int c) {
  const float4 cs = *reinterpret_cast<const float4*>(cos + static_cast<long long>(row) * D + c);
  const float4 sn = *reinterpret_cast<const float4*>(sin + static_cast<long long>(row) * D + c);
  return make_float4(__fadd_rn(__fmul_rn(x.x, cs.x), -__fmul_rn(x.y, sn.x)),
                     __fadd_rn(__fmul_rn(x.y, cs.y), __fmul_rn(x.x, sn.y)),
                     __fadd_rn(__fmul_rn(x.z, cs.z), -__fmul_rn(x.w, sn.z)),
                     __fadd_rn(__fmul_rn(x.w, cs.w), __fmul_rn(x.z, sn.w)));
}

template <int D>
__global__ void __launch_bounds__(F_THREADS) flash_fwd_f32_kernel(const ParamsF32 p) {
  constexpr int CH = D / 4 / F_LANES;  // float4 chunks per lane
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // [F_BN][D]
  float* sV = sK + F_BN * D;
  float* sBias = sV + F_BN * D;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int lane = threadIdx.x % 32;
  const int sub = lane % F_LANES;  // lane within the query row
  const int row = blockIdx.x * F_BM + threadIdx.x / F_LANES;

  const float* qg = p.q + b * p.q_sb + h * p.q_sh;
  const float* kg = p.k + b * p.k_sb + h * p.k_sh;
  const float* vg = p.v + b * p.v_sb + h * p.v_sh;
  float* og = p.o + b * p.o_sb + h * p.o_sh;
  const uint8_t* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * p.n;

  float4 q[CH], acc[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) {
    const int c = (sub + F_LANES * i) * 4;
    q[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < p.n) {
      q[i] = *reinterpret_cast<const float4*>(qg + row * p.q_sn + c);
      if (p.cos != nullptr) q[i] = rope_chunk<D>(q[i], p.cos, p.sin, row, c);
    }
  }
  float m = -FLT_MAX, l = 0.f;

  for (int k0 = 0; k0 < p.n; k0 += F_BN) {
    __syncthreads();  // the previous tile is consumed by every warp
    for (int i = threadIdx.x; i < F_BN * D / 4; i += F_THREADS) {
      const int r = i / (D / 4);
      const int c = (i % (D / 4)) * 4;
      const int key = k0 + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (key < p.n) {
        kv = *reinterpret_cast<const float4*>(kg + key * p.k_sn + c);
        vv = *reinterpret_cast<const float4*>(vg + key * p.v_sn + c);
        if (p.cos != nullptr) kv = rope_chunk<D>(kv, p.cos, p.sin, key, c);
      }
      *reinterpret_cast<float4*>(sK + r * D + c) = kv;
      *reinterpret_cast<float4*>(sV + r * D + c) = vv;
    }
    if (threadIdx.x < F_BN) {
      const int key = k0 + threadIdx.x;
      sBias[threadIdx.x] = key >= p.n ? -FLT_MAX : (mask != nullptr && !mask[key]) ? MASKED : 0.f;
    }
    __syncthreads();

    float s[F_BN];
    float mt = m;
#pragma unroll
    for (int j = 0; j < F_BN; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + j * D + (sub + F_LANES * i) * 4);
        part = fmaf(q[i].x, kv.x, part);
        part = fmaf(q[i].y, kv.y, part);
        part = fmaf(q[i].z, kv.z, part);
        part = fmaf(q[i].w, kv.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      s[j] = part * p.scale + sBias[j];
      mt = fmaxf(mt, s[j]);
    }
    const float alpha = expf(m - mt);
    m = mt;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < F_BN; ++j) {
      const float pj = expf(s[j] - m);
      l += pj;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(sV + j * D + (sub + F_LANES * i) * 4);
        acc[i].x = fmaf(pj, vv.x, acc[i].x);
        acc[i].y = fmaf(pj, vv.y, acc[i].y);
        acc[i].z = fmaf(pj, vv.z, acc[i].z);
        acc[i].w = fmaf(pj, vv.w, acc[i].w);
      }
    }
  }

  if (row < p.n) {
    const float inv = 1.f / l;
    if (p.lse != nullptr && sub == 0) {
      p.lse[(static_cast<long long>(b) * gridDim.y + h) * p.n + row] = m + logf(l);
    }
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = (sub + F_LANES * i) * 4;
      *reinterpret_cast<float4*>(og + row * p.o_sn + c) =
          make_float4(acc[i].x * inv, acc[i].y * inv, acc[i].z * inv, acc[i].w * inv);
    }
  }
}

template <int D>
cudaError_t launch_f32(const ParamsF32& p, int b, int h, cudaStream_t stream) {
  const int smem = (2 * F_BN * D + F_BN) * static_cast<int>(sizeof(float));
  static std::atomic<bool> raised[MAX_DEVICES];
  const cudaError_t err = raise_smem_limit(reinterpret_cast<const void*>(flash_fwd_f32_kernel<D>), smem, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + F_BM - 1) / F_BM, h, b);
  flash_fwd_f32_kernel<D><<<grid, F_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The bf16 mma.sync kernel (d = 256). Returns the cudaError_t of the launch
// (0 on success). Strides are in elements; the head dim is contiguous.
int f5_flash_attention_fwd(const void* q, const void* k, const void* v, void* o, void* lse, const void* mask,
                           const void* cos, const void* sin, int b, int h, int n, int d,
                           long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                           long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                           long long v_sn, long long o_sb, long long o_sh, long long o_sn,
                           float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.mask = static_cast<const uint8_t*>(mask);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.n = n;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 256: return static_cast<int>(launch<256>(p, b, h, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bf16 at d = 64 and 128: the pre-pass into `rot` (with cos) and `kbias`
// (with a mask), then the core. q and o [b, h, n, d], k and v [b, h, nk, d]
// by (batch, head, row) strides in elements, the head dim contiguous,
// strides multiples of 8 and the tensors 16-byte aligned, v without a zero
// stride (q and k too without cos: the core reads them through tensor maps);
// mask [b, nk], cos and sin [nk, d] with q_off + n <= nk (query row i is
// rotated by table row q_off + i, key row i by row i); rot bf16 [b * h,
// n_pad, d] then [b * h, nk_pad, d], kbias [b, nk_pad] float32 (16-byte
// aligned), n_pad and nk_pad multiples of 128; lse [b, h, n] or null;
// heads 0 .. rope_heads - 1 rotated (0 <= rope_heads <= h), the others
// not. The tensors on `device`, the stream one of its streams. Returns the
// cudaError_t (0 on success).
int f5_flash_attention_fwd_core(const void* q, const void* k, const void* v, void* o, void* lse, const void* mask,
                                const void* cos, const void* sin, void* rot, void* kbias, int b, int h, int n,
                                int nk, int n_pad, int nk_pad, int q_off, int d, int rope_heads, long long q_sb,
                                long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn,
                                long long v_sb, long long v_sh, long long v_sn, long long o_sb, long long o_sh,
                                long long o_sn,
                                float scale, int device, void* stream) {
  const PrepassParams pp = prepass_params(q, k, mask, cos, sin, rot, kbias, b, h, n, nk, n_pad, nk_pad, q_off,
                                          rope_heads, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn);
  if (!core_args_ok(pp)) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  CoreParams c{};
  c.o = static_cast<__nv_bfloat16*>(o);
  c.lse = static_cast<float*>(lse);
  c.kbias = pp.kbias;
  c.h = h;
  c.n = n;
  c.n_pad = n_pad;
  c.nk = nk;
  c.nk_pad = nk_pad;
  c.o_sb = o_sb; c.o_sh = o_sh; c.o_sn = o_sn;
  c.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch_core_fwd<64>(pp, v, v_sb, v_sh, v_sn, c, s));
    case 128: return static_cast<int>(launch_core_fwd<128>(pp, v, v_sb, v_sh, v_sn, c, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pre-pass alone (the arguments of f5_flash_attention_fwd_core that it
// reads); with neither cos nor mask it launches nothing.
int f5_flash_fwd_prepass(const void* q, const void* k, const void* mask, const void* cos, const void* sin, void* rot,
                         void* kbias, int b, int h, int n, int nk, int n_pad, int nk_pad, int q_off, int d,
                         int rope_heads, long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
                         long long k_sn, int device, void* stream) {
  const PrepassParams pp = prepass_params(q, k, mask, cos, sin, rot, kbias, b, h, n, nk, n_pad, nk_pad, q_off,
                                          rope_heads, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn);
  if (!core_args_ok(pp)) return static_cast<int>(cudaErrorInvalidValue);
  if (cos == nullptr && mask == nullptr) return 0;
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch_fwd_prepass<64>(pp, s));
    case 128: return static_cast<int>(launch_fwd_prepass<128>(pp, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The float32 kernels; the arguments of f5_flash_attention_fwd, at d = 64
// the pre-pass's float32 scratch (`tc_carve`, csrc/tf32.cuh; null at d = 128
// and 256), and a query block as f5_flash_attention_fwd_core takes it (q
// [b, h, n, d] against k, v [b, h, nk, d], tables [nk, d] from row q_off for
// the queries) at d = 64 only: d = 128 and 256 take nk = n and q_off = 0.
int f5_flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse, const void* mask,
                               const void* cos, const void* sin, void* scratch, int b, int h, int n, int nk,
                               int q_off, int d,
                               long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                               long long k_sh, long long k_sn, long long v_sb, long long v_sh,
                               long long v_sn, long long o_sb, long long o_sh, long long o_sn,
                               float scale, void* stream) {
  ParamsF32 p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.mask = static_cast<const uint8_t*>(mask);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.n = n;
  p.nk = nk;
  p.q_off = q_off;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || nk < 1 || q_off < 0 || (cos != nullptr && q_off + n > nk) || (d != TC_D && (nk != n || q_off != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 64: return static_cast<int>(launch_f32_tc(p, static_cast<float*>(scratch), b, h, s));
    case 128: return static_cast<int>(launch_f32<128>(p, b, h, s));
    case 256: return static_cast<int>(launch_f32<256>(p, b, h, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* f5_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
