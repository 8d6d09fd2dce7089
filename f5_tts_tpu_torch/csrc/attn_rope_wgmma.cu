// The probe tools' attention without a mask for Hopper (sm_90a), bf16: the
// TMA-fed wgmma attention forward (the core, csrc/attn_core.cuh), after a
// rotation pre-pass for the RoPE variants.
//
// Replaces the Pallas TPU kernels of the JAX package's probe tools:
//   - tools/fusion_probe.py `flash_bhnd_rope` (body `_kernel_bhnd_rope`),
//     q, k, v and the output in [b, h, n, d];
//   - tools/fusion_probe.py `flash_nhd` (body `_kernel_nhd`), the same
//     function in [b, n, h, d];
//   - tools/attn_variants.py `attn_pack2` (body `_attn_kernel_pack2`) and
//     `attn_flat` (body `_attn_kernel_flat`), the same function without the
//     rotation: the core alone, reading q and k in place (f5_attention). The
//     Pallas kernels' two heads a grid step (pack2) and flat b * h grid
//     (flat) are TPU grid choices; here each head has its own blocks, and
//     b * h may be odd.
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
//   - the core (csrc/attn_core.cuh, without a key bias or an lse) reads Q, K and V
//     each through a 4-d map with coordinates (column, row, head, batch):
//     over the scratch's halves (rope(q), rope(k)) after the pre-pass, over
//     q and k's own (batch, head, row) strides without it, and over v's
//     always. 128-key tiles halve the per-tile softmax reductions and
//     barrier waits of 64-key ones, at about 160 registers a thread and one
//     block an SM. P is rounded to bf16 against the running max (the Pallas
//     body rounds against the row's final max: both divide the float32 P V
//     sum by the float32 sum of the unrounded p, and differ by the bf16
//     rounding of p only). (Issuing tile it's scores beside tile it - 1's
//     P V, FA3's overlap within a warpgroup, ran slower on the H100 in both
//     forms tried: ptxas serialized the wgmmas and spilled at d = 128.)
// Without the rotation (attn_pack2, attn_flat), the earlier kernels were
// mma.sync templates: 8x the 8.69 us bound at [2, 16, 1024, 64]. The core
// runs them with the same arithmetic as the RoPE variants, with no pre-pass
// and no scratch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attn_core.cuh"
#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

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

// The core's arguments from the entry points' (no key bias, no lse).
CoreParams core_params(const Params& p) {
  CoreParams c{};
  c.o = p.o;
  c.h = p.h;
  c.n = p.n;
  c.n_pad = p.n_pad;
  c.nk = p.n;
  c.nk_pad = p.n_pad;
  c.o_sb = p.o_sb; c.o_sh = p.o_sh; c.o_sn = p.o_sn;
  c.scale = p.scale;
  return c;
}

template <int D>
cudaError_t run_core(const CUtensorMap& q_map, const CUtensorMap& k_map, const Params& p, cudaStream_t stream) {
  return launch_core<D, false, false>(q_map, k_map, p.v, p.v_sb, p.v_sh, p.v_sn, p.b, core_params(p), stream);
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
  return run_core<D>(q_map, k_map, p, stream);
}

// The core alone, over q and k in place (rows past n arrive as TMA's zero fill).
template <int D>
cudaError_t launch_plain_attention(const Params& p, cudaStream_t stream) {
  CUtensorMap q_map, k_map;
  cudaError_t err = tile_map<D>(&q_map, p.q, p.n, p.h, p.b, p.q_sn, p.q_sh, p.q_sb);
  if (err == cudaSuccess) err = tile_map<D>(&k_map, p.k, p.n, p.h, p.b, p.k_sn, p.k_sh, p.k_sb);
  if (err != cudaSuccess) return err;
  return run_core<D>(q_map, k_map, p, stream);
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
