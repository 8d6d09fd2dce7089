// The TMA-fed wgmma attention forward for Hopper (sm_90a), bf16: the core
// that the attention forward (K1, flash_attention_fwd.cu) and the probe
// tools' variants (attn_rope_wgmma.cu) launch over q, k and v, or over a
// pre-pass's rotated scratch.
//
// It computes softmax(q k^T * scale + bias) v for q [b, h, n, d] against k
// and v [b, h, nk, d] (nk = n but for a query block, whose rows attend to
// every key: sequence parallelism's slot against its group's gathered keys),
// d 64 or 128, for q, k, v and the output addressed through (batch, head, row)
// strides: q, k and v through 4-d tensor maps with coordinates (column, row,
// head, batch row), the output by its strides. Two compile-time options:
//   - BIAS false (the probe tools, and K1 without a key mask): the online
//     softmax keeps the running max of the raw scores and scales it
//     afterwards, in base 2 with scale * log2(e) folded in;
//   - BIAS true, a key bias (K1 with a key mask): the producer brings
//     each key tile's 128 float32 biases (0 or -1e30, [b, nk_pad] from the
//     pre-pass) into the stage with one bulk copy beside K and V, and the
//     consumers form x = s * scale * log2(e) + bias * log2(e) before the
//     running max, so the max is taken over the biased scores. -1e30 * log2(e)
//     is finite in float32: a row whose first tile is all masked has a finite
//     running max of about -1.44e30, the score added to it vanishes, and
//     exp2 of the later differences is exactly 0 or 1; only keys past n are
//     -inf (by index), so a row with every key masked averages its nk keys,
//     not nk_pad.
//   - LSE (K1 for training): the epilogue also writes the row
//     log-sum-exp of the scaled, biased scores in natural log,
//     (m2 + log2(l)) * ln(2) with m2 the base-2 running max, float32
//     [b, h, n] (the backward reads it); rows past n are not written.
// With both off the kernel is the probe tools' core as it was before it had
// them (the same code, so their outputs keep their bits).
//
// Design: one block per (128 query rows, head, batch row); one producer warp
// loads the block's Q once and streams 128-key tiles of K and V (and of the
// biases) through a ring of 3 stages (2 at d = 128) by TMA with the 128-byte
// swizzle, each stage with a full and an empty mbarrier, refilled only after
// all 256 consumer threads have arrived on its empty barrier, which each
// does after its last wgmma on the stage has completed. Two consumer
// warpgroups of 64 query rows run S = Q K^T on wgmma.m64n128k16 (both
// operands K-major in shared memory), the online softmax in float32
// registers, and O += P V on wgmma with P rounded to bf16 register A
// fragments against the running max and V an MN-major operand (the
// transpose bit), a tile's two products and softmax in turn; the other
// warpgroup's work fills the tensor cores meanwhile. Keys past n (the last
// tile's zero rows: a scratch's padding, or TMA's zero fill) score -inf by
// index; query rows past n are zero and not written. Nothing in the core
// knows a query block's place in the sequence: only its rotation does (the
// pre-pass). The epilogue divides by
// the row sum and writes bf16 through the output's strides. No atomics: the
// kernel is deterministic.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BOX = 64;         // rows of a TMA box
constexpr int KN = 128;         // keys a streamed tile, two boxes a panel
constexpr int WGS = 2;          // consumer warpgroups, 64 query rows each
constexpr int ROWS = 64 * WGS;  // query rows a block owns
constexpr int ROW_PAD = 128;    // n_pad and nk_pad are multiples of this (= ROWS)
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The core's arguments besides its three tensor maps.
struct CoreParams {
  __nv_bfloat16* o;    // [b, h, n, d] by (batch, head, row) strides
  float* lse;          // [b, h, n], written only with LSE
  const float* kbias;  // [b, nk_pad] key biases, read only with BIAS
  int h, n, n_pad;     // the query rows, and their padding to ROWS (the grid)
  int nk, nk_pad;      // the keys, and the key biases' row length
  long long o_sb, o_sh, o_sn;
  float scale;
};

template <int D, bool BIAS>
struct FwdShape {
  static constexpr int PANELS = D / 64;          // 64-dim panels of a tile (128-byte swizzled rows)
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  static constexpr int BOXES = KN / BOX;          // TMA boxes of a key tile's panel
  static constexpr int BOX_BYTES = BOX * 128;     // one 64-row box of one panel
  static constexpr int KPANEL = KN * 128;         // bytes of one panel of a key tile
  static constexpr int TILE = PANELS * KPANEL;    // a streamed K or V tile
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int OWN_PANEL = ROWS * 128;    // bytes of one panel of the owned Q
  static constexpr int OWN = PANELS * OWN_PANEL;
  static constexpr int BIAS_BYTES = KN * 4;
  static constexpr int STAGE = 2 * TILE + (BIAS ? 1024 : 0);  // K, V, then the biases (1024 keeps stages aligned)
  static constexpr int BAR_OFF = OWN + STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + slack to align the base to 1024
};

// Descriptor of k16 step kc of an MN-major operand: 16 rows of 128 bytes a step.
__device__ __forceinline__ uint64_t mnmajor(uint64_t desc, int kc) { return desc + ((kc * 16 * 128) >> 4); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Round a [64 x 16 KC] score-shaped accumulator to bf16 A fragments, one per k16 step.
template <int KC>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[KC][4], const float (&x)[8 * KC]) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    a[kc][0] = pack_f32(x[8 * kc + 0], x[8 * kc + 1]);
    a[kc][1] = pack_f32(x[8 * kc + 2], x[8 * kc + 3]);
    a[kc][2] = pack_f32(x[8 * kc + 4], x[8 * kc + 5]);
    a[kc][3] = pack_f32(x[8 * kc + 6], x[8 * kc + 7]);
  }
}

// One block per (128 query rows, head, batch row). The producer (lane 0 of
// the last warp) loads the block's Q once, then streams K and V (and the
// biases) of each KN-key tile through the ring. Each consumer warpgroup owns
// 64 queries; a thread holds rows row0 + g and row0 + g + 8 of them.
template <int D, bool BIAS, bool LSE>
__global__ void __launch_bounds__(FwdShape<D, BIAS>::THREADS, 1)
attn_core_fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const CoreParams p) {
  using S = FwdShape<D, BIAS>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* full = own + 1;
  uint64_t* empty = full + S::STAGES;
  auto stage = [&](int s) { return smem + S::OWN + s * S::STAGE; };

  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tiles = (p.nk + KN - 1) / KN;

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
    if (threadIdx.x == S::CONSUMERS) {  // every map's coordinates: (dim, row, head, batch row)
      mbar_arrive_expect_tx(own, S::OWN);
      for (int pn = 0; pn < S::PANELS; ++pn) {
        for (int r = 0; r < WGS; ++r) {
          tma_load_4d(sQ + pn * S::OWN_PANEL + r * S::BOX_BYTES, &q_map, own, pn * 64, q0 + r * BOX, h, b);
        }
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % S::STAGES;
        if (it >= S::STAGES) mbar_wait(&empty[s], (it / S::STAGES - 1) & 1);
        unsigned char* st = stage(s);
        mbar_arrive_expect_tx(&full[s], 2 * S::TILE + (BIAS ? S::BIAS_BYTES : 0));
        for (int pn = 0; pn < S::PANELS; ++pn) {
          for (int x = 0; x < S::BOXES; ++x) {
            const int off = pn * S::KPANEL + x * S::BOX_BYTES, row = it * KN + x * BOX;
            tma_load_4d(st + off, &k_map, &full[s], pn * 64, row, h, b);
            tma_load_4d(st + S::TILE + off, &v_map, &full[s], pn * 64, row, h, b);
          }
        }
        if constexpr (BIAS) {
          bulk_load(st + 2 * S::TILE, p.kbias + static_cast<long long>(b) * p.nk_pad + it * KN, S::BIAS_BYTES,
                    &full[s]);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = wg * 64 + (threadIdx.x / 32 % 4) * 16;  // this warp's first query in the block
  const float sl2 = p.scale * LOG2E;                       // scale * log2(e): softmax in base 2

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max of rows g and g + 8: of the raw scores without a bias, of the base-2 biased ones with it
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  mbar_wait(own, 0);
  const uint64_t q_desc = sw128_desc(sQ + wg * S::BOX_BYTES);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % S::STAGES;
    mbar_wait(&full[s], (it / S::STAGES) & 1);
    unsigned char* st = stage(s);

    float sc[KN / 2];
    const uint64_t k_desc = sw128_desc(st);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      wgmma_ss(sc, kmajor(q_desc, kc, S::OWN_PANEL), kmajor(k_desc, kc, S::KPANEL), kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    if constexpr (BIAS) {  // x = s * scale * log2(e) + bias * log2(e); column 8 j + 2 t (+1) of the tile
      const float2* bias = reinterpret_cast<const float2*>(st + 2 * S::TILE);
#pragma unroll
      for (int j = 0; j < KN / 8; ++j) {
        const float2 bv = bias[4 * j + t];
        sc[4 * j + 0] = fmaf(sc[4 * j + 0], sl2, bv.x * LOG2E);
        sc[4 * j + 1] = fmaf(sc[4 * j + 1], sl2, bv.y * LOG2E);
        sc[4 * j + 2] = fmaf(sc[4 * j + 2], sl2, bv.x * LOG2E);
        sc[4 * j + 3] = fmaf(sc[4 * j + 3], sl2, bv.y * LOG2E);
      }
    }
    // keys past nk (zero rows) score -inf; the first tile
    // holds key 0, so the running max is finite from then on
    const int k0 = it * KN;
    if (k0 + KN > p.nk) {
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) {
        if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= p.nk) sc[i] = -INFINITY;
      }
    }
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], sc[i]);
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      alpha[r] = exp2_approx(BIAS ? m[r] - mt[r] : (m[r] - mt[r]) * sl2);
      m[r] = mt[r];
      ms[r] = BIAS ? mt[r] : mt[r] * sl2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      sc[i] = exp2_approx(BIAS ? sc[i] - ms[(i >> 1) & 1] : fmaf(sc[i], sl2, -ms[(i >> 1) & 1]));
      l[(i >> 1) & 1] += sc[i];
    }

    // O += P V: P rounded to bf16 from the score registers, V MN-major
    uint32_t pa[KN / 16][4];
    to_a_frags<KN / 16>(pa, sc);
    const uint64_t v_desc = sw128_desc(st + S::TILE, S::KPANEL);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kc = 0; kc < KN / 16; ++kc) wgmma_rs<1>(acc, pa[kc], mnmajor(v_desc, kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* og = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + row0 + g + 8 * r;
    if (row < p.n) {
      const float inv = 1.f / l[r];
      if constexpr (LSE) {
        if (t == 0) {
          const float m2 = BIAS ? m[r] : m[r] * sl2;
          p.lse[(static_cast<long long>(b) * p.h + h) * p.n + row] = (m2 + log2f(l[r])) * LN2;
        }
      }
      __nv_bfloat16* orow = og + row * p.o_sn + 2 * t;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<uint32_t*>(orow + 8 * i) = pack_f32(acc[4 * i + 2 * r] * inv, acc[4 * i + 2 * r + 1] * inv);
      }
    }
  }
}

// A 4-d tensor map over bf16 rows of D with three outer strides in elements:
// dims (D, rows, d2, d3), 64 x 64 boxes, 128-byte swizzle.
template <int D>
cudaError_t tile_map(CUtensorMap* map, const void* base, int rows, int d2, int d3, long long s_row, long long s2,
                     long long s3) {
  const uint64_t dims[4] = {D, static_cast<uint64_t>(rows), static_cast<uint64_t>(d2), static_cast<uint64_t>(d3)};
  const uint64_t strides[3] = {static_cast<uint64_t>(s_row) * 2, static_cast<uint64_t>(s2) * 2,
                               static_cast<uint64_t>(s3) * 2};
  const uint32_t box[4] = {64, BOX, 1, 1};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

// The core over q and k as tensor maps with coordinates (dim, row, head,
// batch row), and over v [b, h, nk, d] by its (batch, head, row) strides;
// one block a ROWS query rows of n_pad.
template <int D, bool BIAS, bool LSE>
cudaError_t launch_core(const CUtensorMap& q_map, const CUtensorMap& k_map, const void* v, long long v_sb,
                        long long v_sh, long long v_sn, int b, const CoreParams& p, cudaStream_t stream) {
  using S = FwdShape<D, BIAS>;
  CUtensorMap v_map;
  cudaError_t err = tile_map<D>(&v_map, v, p.nk, p.h, b, v_sn, v_sh, v_sb);
  if (err != cudaSuccess) return err;
  static std::atomic<bool> raised[MAX_DEVICES];
  err = raise_smem_limit(reinterpret_cast<const void*>(attn_core_fwd_kernel<D, BIAS, LSE>), S::SMEM, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_pad / ROWS, p.h, b);
  attn_core_fwd_kernel<D, BIAS, LSE><<<grid, S::THREADS, S::SMEM, stream>>>(q_map, k_map, v_map, p);
  return cudaGetLastError();
}

// Makes `device` current for the launches and the caller's device current
// again after them (the tensors' device need not be the current one).
struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) {
      err = cudaSetDevice(device);
    } else {
      prev = -1;
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace
