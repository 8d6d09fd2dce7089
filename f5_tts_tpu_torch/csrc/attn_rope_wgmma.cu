// The probe tools' attention without a mask for Hopper (sm_90a), bf16: a
// TMA-fed wgmma attention forward (the core), after a rotation pre-pass for
// the RoPE variants.
//
// Replaces the Pallas TPU kernels of the JAX package's probe tools:
//   - tools/fusion_probe.py `flash_bhnd_rope` (body `_kernel_bhnd_rope`),
//     q, k, v and the output in [b, h, n, d];
//   - tools/fusion_probe.py `flash_nhd` (body `_kernel_nhd`), the same
//     function in [b, n, h, d];
//   - tools/attn_variants.py `attn_pack2` (body `_attn_kernel_pack2`),
//     the same function without the rotation: the core alone, reading q and
//     k in place (f5_attention). The Pallas kernel's two heads a grid step
//     are a TPU grid choice; here each head has its own blocks, and b * h
//     may be odd.
// Every layout takes the same kernels: q, k, v and the output are addressed
// through (batch, head, row) strides, so a [b, n, h, d] view is read and
// written in place. The RoPE function: softmax(rope(q) rope(k)^T * scale) v
// with no mask, where rope(x) = bf16(bf16(x * cos) + bf16(bf16(x @ P) *
// sin)), cos, sin and P rounded to bf16 and x @ P accumulated in float32.
// P [d, d] is an input (a pair swap in the tools, but not hard-wired here).
//
// What bounds it on this card. Per head the work is 4 n^2 d FLOP, plus
// 4 n d^2 for the rotation of q and k as a product, against 4 n d bf16 values
// of q, k, v and the output: at [2, 16, 1024, 64] 8.6 GFLOP against 17 MB,
// about 500 FLOP a byte, bound by the tensor cores (9.2 us at 989 TFLOP/s),
// which only wgmma drives at full rate. The first kernel of these functions
// (an mma.sync template, 14x that bound) rotated every K tile again in every
// block that read it (16 times a head at n = 1024: a third product, float32
// tables read element by element, an extra barrier), staged tiles with plain
// loads between two __syncthreads with one buffer, and built the P V
// product's B fragments from scalar shared-memory loads. This design:
//   - a pre-pass kernel, one launch, rotates q and k once: each block takes
//     64 rows of PRE_HEADS heads; each warp starts the cp.async copies of its
//     16 rows of q and k of those heads, while the block stages P^T (bf16)
//     and the rows' cos and sin (rounded to bf16) in shared memory once;
//     then each warp takes x @ P on mma.sync (float32 sums), applies the
//     Pallas body's roundings with packed bf16 multiplies and adds (each
//     rounded once to nearest, as the body's bf16 ops) and writes the rows
//     as bf16 scratch
//     [2, b * h, n_pad, d] (rope(q), then rope(k)), n_pad a multiple of 128
//     and rows past n zero;
//   - the main kernel (the core) is warp specialised: a block owns 128
//     query rows of one head, two consumer warpgroups of 64; one producer
//     warp loads the block's Q once and streams 128-key tiles of K and of
//     V through a ring of 3 stages (2 at d = 128: 160 KB) by TMA, with the
//     128-byte swizzle; Q, K and V each through a 4-d map with coordinates
//     (column, row, head, batch): over the scratch's halves (rope(q),
//     rope(k)) after the pre-pass, over q and k's own (batch, head, row)
//     strides without it, and over v's always; each stage has
//     a full and an empty mbarrier, and a stage is refilled only after all
//     256 consumer threads have arrived on its empty barrier, which each
//     does after its last wgmma on the stage has completed. 128-key tiles
//     halve the per-tile softmax reductions and barrier waits of 64-key
//     ones, at about 160 registers a thread and one block an SM;
//   - S = Q K^T runs on wgmma.m64n128k16 with both operands K-major in
//     shared memory; the online softmax runs in float32 registers, in base 2 with
//     the scale folded in; keys past n (the last tile's zero rows: the
//     scratch's padding, or TMA's zero fill) score -inf by index; query rows
//     past n are zero and not written; P is rounded to bf16 A fragments against the running
//     max (the Pallas body rounds against the row's final max: both divide
//     the float32 P V sum by the float32 sum of the unrounded p, and differ
//     by the bf16 rounding of p only); O += P V runs on wgmma with P from
//     registers and V as an MN-major operand (the transpose bit), so no
//     thread loads an operand element by element;
//   - each warpgroup runs a tile's two products and its softmax in turn;
//     the other warpgroup's work fills the tensor cores meanwhile. (Issuing
//     tile it's scores beside tile it - 1's P V, FA3's overlap within a
//     warpgroup, ran slower on the H100 in both forms tried: ptxas
//     serialized the wgmmas and spilled at d = 128);
//   - the epilogue divides by the row sum and writes bf16 through the
//     output's strides. No atomics: the kernels are deterministic.
// Without the rotation (attn_pack2), the earlier kernel was an mma.sync
// template (csrc/attn_variants.cu, which keeps attn_flat): 8x the 8.69 us
// bound at [2, 16, 1024, 64]. The core runs it with the same arithmetic as
// the RoPE variants, with no pre-pass and no scratch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int BOX = 64;         // rows of a TMA box
constexpr int KN = 128;         // keys a streamed tile, two boxes a panel
constexpr int WGS = 2;          // consumer warpgroups, 64 query rows each
constexpr int ROWS = 64 * WGS;  // query rows a block owns
constexpr int ROW_PAD = 128;    // n_pad is a multiple of this (= ROWS)
constexpr int PAD = 8;          // bf16 padding per shared-memory row of the pre-pass
constexpr int PRE_ROWS = 64;    // rows a pre-pass block rotates, 16 a warp
constexpr int PRE_HEADS = 2;    // heads a pre-pass block rotates, 4 warps each
constexpr int PRE_THREADS = 128 * PRE_HEADS;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* cos;  // [n, d]
  const float* sin;  // [n, d]
  const float* P;    // [d, d]
  __nv_bfloat16* rot;  // [2, b * h, n_pad, d]: rope(q), then rope(k); unused without the rotation
  int b, h, n, n_pad;  // n_pad: n rounded up to a multiple of ROW_PAD
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  float scale;
};

// ---------------------------------------------------------------- pre-pass

template <int D>
constexpr int prepass_smem() {  // P^T, the two tables' rows, and q and k rows of PRE_HEADS heads
  return (D + (2 + 2 * PRE_HEADS) * PRE_ROWS) * (D + PAD) * static_cast<int>(sizeof(__nv_bfloat16));
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

// Rotate one warp's 16 staged rows (wr .. wr + 15 of sX) in place:
// x <- bf16(bf16(x * c) + bf16(bf16(x @ P) * s)); sPT holds P transposed,
// sC and sS the rows' tables, all in bf16 with row stride D + PAD.
template <int D>
__device__ __forceinline__ void rope_rows(__nv_bfloat16* sX, const __nv_bfloat16* sPT, const __nv_bfloat16* sC,
                                          const __nv_bfloat16* sS, int wr, int g, int t) {
  constexpr int LD = D + PAD;
  float xp[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) xp[i][0] = xp[i][1] = xp[i][2] = xp[i][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const __nv_bfloat16* xa = sX + (wr + g) * LD + kc * 16 + 2 * t;
    const uint32_t a0 = ld32(xa), a1 = ld32(xa + 8 * LD), a2 = ld32(xa + 8), a3 = ld32(xa + 8 * LD + 8);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const __nv_bfloat16* pb = sPT + (nt * 8 + g) * LD + kc * 16 + 2 * t;
      mma_16816(xp[nt], a0, a1, a2, a3, ld32(pb), ld32(pb + 8));
    }
  }
  // the thread's own elements: rows wr + g + 8 r, columns nt * 8 + 2 t (+1), as bf16 pairs
  uint32_t xs[D / 8][2];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) xs[nt][r] = ld32(sX + (wr + g + 8 * r) * LD + nt * 8 + 2 * t);
  }
  __syncwarp();  // every lane has read its A fragments before any element is overwritten
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int off = (wr + g + 8 * r) * LD;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const uint32_t xpr = pack_f32(xp[nt][2 * r], xp[nt][2 * r + 1]);  // bf16(x @ P)
      *reinterpret_cast<uint32_t*>(sX + off + col) =
          add_bf16x2(mul_bf16x2(xs[nt][r], ld32(sC + off + col)), mul_bf16x2(xpr, ld32(sS + off + col)));
    }
  }
  __syncwarp();
}

// A 16-byte copy into shared memory that does not wait (cp.async); with
// `valid` false it writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// One launch over (n_pad / PRE_ROWS row tiles, heads / PRE_HEADS); four
// warps a head, 16 rows a warp. Each warp starts the copies of its rows of
// q and k first (cp.async, rows past n zero-filled), so they are in flight
// while the block stages P^T and the tables; rows past n meet zero tables
// too and rotate to exactly zero.
template <int D>
__global__ void __launch_bounds__(PRE_THREADS) rope_prepass_kernel(const Params p) {
  constexpr int LD = D + PAD;
  constexpr int CH = D / 8;               // 16-byte chunks a row
  constexpr int PER_LANE = 16 * CH / 32;  // chunks of a warp's 16 rows, per lane
  constexpr int TILE = PRE_ROWS * LD;     // one staged [PRE_ROWS][LD] tile
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sPT = reinterpret_cast<__nv_bfloat16*>(smem);  // [D][LD]
  __nv_bfloat16* sC = sPT + D * LD;                              // [PRE_ROWS][LD]
  __nv_bfloat16* sS = sC + TILE;
  __nv_bfloat16* sX = sS + TILE;  // [PRE_HEADS][2][PRE_ROWS][LD]: each head's q rows, then its k rows

  const int r0 = blockIdx.x * PRE_ROWS;
  const int bh = p.b * p.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int j = warp / 4;            // the warp's head in the block
  const int wr = (warp % 4) * 16;    // the warp's first row in the tile
  const int head = blockIdx.y * PRE_HEADS + j;
  const bool active = head < bh;     // the last block of an odd b * h has a head fewer
  __nv_bfloat16* sq = sX + 2 * j * TILE;
  __nv_bfloat16* sk = sq + TILE;

  if (active) {
    const int b = head / p.h, h = head % p.h;
    const __nv_bfloat16* qg = p.q + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* kg = p.k + b * p.k_sb + h * p.k_sh;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int idx = lane + 32 * i, r = wr + idx / CH, c = (idx % CH) * 8, row = r0 + r;
      const bool valid = row < p.n;
      const int src = valid ? row : 0;
      cp_async16(sq + r * LD + c, qg + src * p.q_sn + c, valid);
      cp_async16(sk + r * LD + c, kg + src * p.k_sn + c, valid);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  constexpr int P_PER_THREAD = D * D / 4 / PRE_THREADS;  // float4 chunks of P
#pragma unroll
  for (int u = 0; u < P_PER_THREAD; ++u) {
    // P[r][c .. c + 3] -> sPT[c .. c + 3][r], lanes on consecutive rows r so that the stores miss each other's banks
    const int i = threadIdx.x + u * PRE_THREADS, r = i % D, c = (i / D) * 4;
    const float4 pv = *reinterpret_cast<const float4*>(p.P + r * D + c);
    sPT[c * LD + r] = __float2bfloat16(pv.x);
    sPT[(c + 1) * LD + r] = __float2bfloat16(pv.y);
    sPT[(c + 2) * LD + r] = __float2bfloat16(pv.z);
    sPT[(c + 3) * LD + r] = __float2bfloat16(pv.w);
  }
  constexpr int T_PER_THREAD = PRE_ROWS * D / 4 / PRE_THREADS;  // float4 chunks of a table's rows
#pragma unroll
  for (int u = 0; u < T_PER_THREAD; ++u) {
    const int i = threadIdx.x + u * PRE_THREADS, r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), sv = cv;
    if (r0 + r < p.n) {
      cv = *reinterpret_cast<const float4*>(p.cos + static_cast<long long>(r0 + r) * D + c);
      sv = *reinterpret_cast<const float4*>(p.sin + static_cast<long long>(r0 + r) * D + c);
    }
    __nv_bfloat162* dc = reinterpret_cast<__nv_bfloat162*>(sC + r * LD + c);
    __nv_bfloat162* ds = reinterpret_cast<__nv_bfloat162*>(sS + r * LD + c);
    dc[0] = __floats2bfloat162_rn(cv.x, cv.y);
    dc[1] = __floats2bfloat162_rn(cv.z, cv.w);
    ds[0] = __floats2bfloat162_rn(sv.x, sv.y);
    ds[1] = __floats2bfloat162_rn(sv.z, sv.w);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (!active) return;
#pragma unroll
  for (int tk = 0; tk < 2; ++tk) {
    __nv_bfloat16* sx = tk == 0 ? sq : sk;
    rope_rows<D>(sx, sPT, sC, sS, wr, g, t);
    __nv_bfloat16* out = p.rot + (static_cast<long long>(tk * bh + head) * p.n_pad + r0 + wr) * D;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      const int idx = lane + 32 * i, r = idx / CH, c = (idx % CH) * 8;
      *reinterpret_cast<uint4*>(out + r * D + c) = *reinterpret_cast<const uint4*>(sx + (wr + r) * LD + c);
    }
  }
}

// ---------------------------------------------------------------- main kernel

template <int D>
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
  static constexpr int STAGE = 2 * TILE;          // K, then V
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
// the last warp) loads the block's Q once, then streams K and V of each
// KN-key tile through the ring. Each consumer warpgroup owns 64 queries; a
// thread holds rows row0 + g and row0 + g + 8 of them.
template <int D>
__global__ void __launch_bounds__(FwdShape<D>::THREADS, 1)
attn_core_fwd_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const Params p) {
  using S = FwdShape<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* full = own + 1;
  uint64_t* empty = full + S::STAGES;
  auto stage = [&](int s) { return smem + S::OWN + s * S::STAGE; };

  const int q0 = blockIdx.x * ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tiles = (p.n + KN - 1) / KN;

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
        mbar_arrive_expect_tx(&full[s], S::STAGE);
        for (int pn = 0; pn < S::PANELS; ++pn) {
          for (int x = 0; x < S::BOXES; ++x) {
            const int off = pn * S::KPANEL + x * S::BOX_BYTES, row = it * KN + x * BOX;
            tma_load_4d(st + off, &k_map, &full[s], pn * 64, row, h, b);
            tma_load_4d(st + S::TILE + off, &v_map, &full[s], pn * 64, row, h, b);
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = wg * 64 + (threadIdx.x / 32 % 4) * 16;  // this warp's first query in the block
  const float sl2 = p.scale * 1.4426950408889634f;         // scale * log2(e): softmax in base 2

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores of rows g and g + 8
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

    // keys past n (zero rows) score -inf; the first tile
    // holds key 0, so the running max is finite from then on
    const int k0 = it * KN;
    if (k0 + KN > p.n) {
#pragma unroll
      for (int i = 0; i < KN / 2; ++i) {
        if (k0 + 8 * (i / 4) + 2 * t + (i & 1) >= p.n) sc[i] = -INFINITY;
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
      alpha[r] = exp2_approx((m[r] - mt[r]) * sl2);
      m[r] = mt[r];
      ms[r] = mt[r] * sl2;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) {
      sc[i] = exp2_approx(fmaf(sc[i], sl2, -ms[(i >> 1) & 1]));
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

template <int D>
cudaError_t launch_prepass(const Params& p, cudaStream_t stream) {
  static std::atomic<bool> raised[MAX_DEVICES];
  cudaError_t err = raise_smem_limit(reinterpret_cast<const void*>(rope_prepass_kernel<D>), prepass_smem<D>(), raised);
  if (err != cudaSuccess) return err;
  const int bh = p.b * p.h;
  const dim3 grid(p.n_pad / PRE_ROWS, (bh + PRE_HEADS - 1) / PRE_HEADS);
  rope_prepass_kernel<D><<<grid, PRE_THREADS, prepass_smem<D>(), stream>>>(p);
  return cudaGetLastError();
}

// The core over q and k as tensor maps with coordinates (dim, row, head,
// batch row), and over v by its strides.
template <int D>
cudaError_t launch_core(const CUtensorMap& q_map, const CUtensorMap& k_map, const Params& p, cudaStream_t stream) {
  using S = FwdShape<D>;
  CUtensorMap v_map;
  cudaError_t err = tile_map<D>(&v_map, p.v, p.n, p.h, p.b, p.v_sn, p.v_sh, p.v_sb);
  if (err != cudaSuccess) return err;
  static std::atomic<bool> raised[MAX_DEVICES];
  err = raise_smem_limit(reinterpret_cast<const void*>(attn_core_fwd_kernel<D>), S::SMEM, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_pad / ROWS, p.h, p.b);
  attn_core_fwd_kernel<D><<<grid, S::THREADS, S::SMEM, stream>>>(q_map, k_map, v_map, p);
  return cudaGetLastError();
}

// The pre-pass, then the core over the scratch's halves, each a contiguous
// [b, h, n_pad, d].
template <int D>
cudaError_t launch_rope_attention(const Params& p, cudaStream_t stream) {
  cudaError_t err = launch_prepass<D>(p, stream);
  if (err != cudaSuccess) return err;
  const long long hn = static_cast<long long>(p.n_pad) * D;
  CUtensorMap q_map, k_map;
  err = tile_map<D>(&q_map, p.rot, p.n_pad, p.h, p.b, D, hn, p.h * hn);
  if (err == cudaSuccess) err = tile_map<D>(&k_map, p.rot + p.b * p.h * hn, p.n_pad, p.h, p.b, D, hn, p.h * hn);
  if (err != cudaSuccess) return err;
  return launch_core<D>(q_map, k_map, p, stream);
}

// The core alone, over q and k in place (rows past n arrive as TMA's zero fill).
template <int D>
cudaError_t launch_plain_attention(const Params& p, cudaStream_t stream) {
  CUtensorMap q_map, k_map;
  cudaError_t err = tile_map<D>(&q_map, p.q, p.n, p.h, p.b, p.q_sn, p.q_sh, p.q_sb);
  if (err == cudaSuccess) err = tile_map<D>(&k_map, p.k, p.n, p.h, p.b, p.k_sn, p.k_sh, p.k_sb);
  if (err != cudaSuccess) return err;
  return launch_core<D>(q_map, k_map, p, stream);
}

Params make_params(const void* q, const void* k, const void* cos, const void* sin, const void* P, void* rot, int b,
                   int h, int n, int n_pad, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                   long long k_sh, long long k_sn) {
  Params p{};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.P = static_cast<const float*>(P);
  p.rot = static_cast<__nv_bfloat16*>(rot);
  p.b = b;
  p.h = h;
  p.n = n;
  p.n_pad = n_pad;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  return p;
}

bool shape_ok(int b, int h, int n, int n_pad) {
  return b >= 1 && h >= 1 && n >= 1 && n_pad >= n && n_pad % ROW_PAD == 0;
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

extern "C" {

// The pre-pass alone: rot [2, b * h, n_pad, d] <- rope(q), rope(k), rows past
// n zero. q and k [b, h, n, d] by (batch, head, row) strides in elements, the
// head dim contiguous; cos, sin [n, d] and P [d, d] float32, contiguous;
// n_pad a multiple of 128; the tensors on `device`, the stream one of its
// streams. Returns the cudaError_t (0 on success).
int f5_rope_prepass(const void* q, const void* k, const void* cos, const void* sin, const void* P, void* rot, int b,
                    int h, int n, int n_pad, int d, long long q_sb, long long q_sh, long long q_sn, long long k_sb,
                    long long k_sh, long long k_sn, int device, void* stream) {
  if (!shape_ok(b, h, n, n_pad)) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  const Params p = make_params(q, k, cos, sin, P, rot, b, h, n, n_pad, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch_prepass<64>(p, s));
    case 128: return static_cast<int>(launch_prepass<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The pre-pass into `rot` (as f5_rope_prepass), then the attention, o written
// through its strides. v and o [b, h, n, d] by (batch, head, row) strides.
int f5_rope_attention(const void* q, const void* k, const void* v, void* o, const void* cos, const void* sin,
                      const void* P, void* rot, int b, int h, int n, int n_pad, int d, long long q_sb,
                      long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn,
                      long long v_sb, long long v_sh, long long v_sn, long long o_sb, long long o_sh,
                      long long o_sn, float scale, int device, void* stream) {
  if (!shape_ok(b, h, n, n_pad)) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  Params p = make_params(q, k, cos, sin, P, rot, b, h, n, n_pad, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch_rope_attention<64>(p, s));
    case 128: return static_cast<int>(launch_rope_attention<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The attention without the rotation (the core alone): q, k, v and o
// [b, h, n, d] by (batch, head, row) strides in elements, the head dim
// contiguous, strides multiples of 8 and the tensors 16-byte aligned, none
// with a zero stride (a tensor map takes none).
int f5_attention(const void* q, const void* k, const void* v, void* o, int b, int h, int n, int d, long long q_sb,
                 long long q_sh, long long q_sn, long long k_sb, long long k_sh, long long k_sn, long long v_sb,
                 long long v_sh, long long v_sn, long long o_sb, long long o_sh, long long o_sn, float scale,
                 int device, void* stream) {
  const int n_pad = align_up(n, ROW_PAD);
  if (!shape_ok(b, h, n, n_pad)) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.err != cudaSuccess) return static_cast<int>(scope.err);
  Params p = make_params(q, k, nullptr, nullptr, nullptr, nullptr, b, h, n, n_pad, q_sb, q_sh, q_sn, k_sb, k_sh,
                         k_sn);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return static_cast<int>(launch_plain_attention<64>(p, s));
    case 128: return static_cast<int>(launch_plain_attention<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* f5_rope_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
