// Flash-attention backward for Hopper (sm_90a): in bf16 a single pass on the
// tensor cores at d = 64 and a kernel pair at d = 128 and 256; in float32 a
// kernel pair on the tensor cores in 3xTF32 at d = 64 and on the FMA units at
// d = 128 and 256.
//
// Replaces the Pallas TPU kernel of the JAX package:
// f5_tts_tpu/ops/flash_attention.py, `_flash_attention_bwd_call` (kernel body
// `_make_bwd_kernel`, reached through the custom VJP `_flash_bwd`). It
// computes what that kernel computes, for the forward
// out = softmax(rope(q) rope(k)^T * scale - (1 - mask) * 1e30) v:
//   P   = the probabilities, recomputed with the same scale, key-mask bias and
//         interleaved RoPE (tables rounded to bf16 in the bf16 kernels);
//   dV  = P^T g;
//   dS  = P * (g V^T - delta) * scale, with delta = rowsum(g * out) (the JAX
//         package computes it outside its kernel; here both paths'
//         pre-pass kernels do);
//   dQ' = dS K',  dK' = dS^T Q';
//   dQ, dK = the RoPE backward of dQ', dK': dx = dx' cos + (dx' sin) P^T,
//         i.e. dx[2j] = dx'[2j] cos[2j] + dx'[2j+1] sin[2j+1] and
//         dx[2j+1] = dx'[2j+1] cos[2j+1] - dx'[2j] sin[2j].
// The bf16 path also takes a model that rotates only its first rope_heads
// heads (E2 TTS's UNetT: head 0): the pre-pass copies the other heads' q
// and k as they are, and their dQ and dK get no RoPE backward.
// Products accumulate in float32. In the bf16 path P (for dV) and dS are
// rounded to bf16 before their products, as the JAX kernel does, and dq, dk,
// dv are written in bf16, one rounding of the float32 sum; the float32 path
// writes float32.
//
// The TPU kernel holds all of K and V of one head in VMEM and accumulates dK
// and dV across the sequential q-block grid in its output refs. Hopper
// blocks run in parallel and in no order, so a sum across blocks needs
// either a second kernel or an order that the blocks keep themselves.
//
// bf16 at d = 64 (every bf16 training path): one pass over the keys,
// 10 n^2 d FLOP per (b, h), what the gradient needs. A block owns 128 keys
// (dK and dV in registers) and streams Q', g and the row stats of each
// 64-query tile; per tile it computes S^T, dP^T, dV += P^T g,
// dK' += dS^T Q' and the tile's dQ' partial dS K' over its 128 keys
// (dS^T goes through shared memory as bf16). The partials of one (b, h,
// query tile) are summed in float32 in global memory, [b, h, tiles, 64 x 64]
// in the consumers' fragment order, by a dQ warp that adds each with a bulk
// reduce-add (cp.reduce.async.bulk .add.f32) from shared memory, the first
// one a plain bulk store (no zeroing). A conversion kernel
// (flash_bwd_dq_wgmma_kernel_sum) then applies the RoPE backward to the sum
// and writes bf16 dq.
// The sum is deterministic: the partials of a tile are added in a fixed
// order of the key blocks, kept by a counter a tile in global memory (the
// pre-pass zeroes it): the block in place p waits until the counter reads p
// (ld.acquire), adds, waits for the add to complete and increments it
// (red.release). The order: query tile i of a call is tile G = q_off / 64 + i
// of the keys' sequence (key_tiles of them), block j's add into it has the
// key (G + j) mod key_tiles, and each tile's partials are added in the order
// of their keys; each block visits its tiles in the order of their keys too.
// So a block's predecessor in every tile's order got there a step earlier
// and no wait builds up along the J blocks (with every block visiting tile k
// at step k and adding j-th, block j trails block 0 by j adds: 9-10% slower at
// [16, 16, 2400, 64] on the H100), and the order depends on the tile's place
// in the sequence alone: a query block's dq (sequence parallelism) at a
// tile-aligned offset equals the full call's rows bit for bit.
// No deadlock. Each block adds in the increasing order of its keys, and its
// predecessor's add has the key one less, so no cycle of waits exists; a
// wait needs the awaited block to be running. Blocks take their (key block,
// b, h) from a ticket counter in the order they start (atomicAdd, reset by
// the pre-pass), key block fastest, so every (b, h) but the one whose tickets
// are being handed out has started all its blocks, and finishes on its own,
// freeing SMs for the rest, if all J blocks of a (b, h) fit on the card at
// once. The launcher rotates where 2 J <= the SM count (one block an SM) and
// the call's tiles lie in the keys' sequence, else every block visits tile k
// at step k and adds j-th (it then waits only on lower tickets, which have
// all started).
// What bounds it (H100, 700 W): at [16, 16, 2400, 64] the 10 n^2 d take
// 0.954 ms at the tensor cores' peak; a call takes 2.77 ms (34.5%; SDPA's
// backward 2.45, the kernel pair this pass replaced 4.96), of which the pass
// 2.51, the pre-pass 0.16 and the conversion 0.11; at [4, 16, 1024, 64]
// 0.181 ms (24%; SDPA's backward 0.139, the pair 0.283). The pass waits on
// latency more than on the tensor cores: each warpgroup runs its products,
// its softmax and dS math and its stores mostly one after another, and both
// warpgroups meet at every tile for dQ'. Two attempts to overlap more were
// slower: a two-tile software pipeline (the next tile's softmax behind the
// previous tile's products) and a dQ' partial a warpgroup summed in shared
// memory (no meeting).
//
// bf16 at d = 128 (no configuration trains it) keeps a kernel pair that needs
// no float atomics and no ordering, at 14 n^2 d (S and dP computed in both):
//   - dkdv: a block owns dK and dV of a run of keys in registers and streams
//     Q', g and the row stats over all queries;
//   - dq: a block owns dQ of a run of queries and streams K', V and the key
//     biases over all keys.
// At d = 256 the mma.sync pair below does the same. The float32 path keeps
// its pair at every d (see below). The row statistics come from the
// forward: P = exp(s - lse) with the log-sum-exp K1 saved
// (flash_attention_fwd.cu), so no pass rescans a row. A row whose keys are
// all masked has lse ~ -1e30, where m + log(l) loses log(l); such a row is
// uniform over the n keys (as the forward and the plain version make it), so
// the kernels give it P = 1/n directly.
//
// What bounds it on this card. At n = 1024, d = 64 the work is far above the
// ridge point: it is bound by the tensor cores, which only wgmma drives at
// full rate. The first bf16 version (mma.sync, 55.7 TFLOP/s counted on the
// H100) staged every tile with plain loads between two __syncthreads, so no
// copy overlapped a product; rotated each Q (or K) tile again in every block
// (16 times per head at n = 1024); built the B operand of the P V shaped
// products from scalar shared-memory loads; and left delta and three
// float32-to-bf16 casts to PyTorch around it. This design:
//   - a pre-pass kernel, one launch over the rows, writes rope(q) and rope(k)
//     once as bf16 scratch (tables rounded to bf16, each product and the sum
//     rounded to bf16, as the JAX body and the forward round), the row statistics
//     (lse, delta = rowsum(g * out) in float32) padded to a multiple of 128
//     rows with (FLT_MAX, 0), and each key's bias (0, -1e30 masked, -FLT_MAX
//     past n), so rows and keys past n contribute exactly 0 whatever TMA's
//     zero fill brings;
//   - the TMA + wgmma kernels (the pass at d = 64, the pair at d = 128) are
//     warp specialised: one producer warp keeps a ring of 3 (2 for the pair
//     at d = 128) shared-memory stages filled with TMA copies (4-d tensor
//     maps over the (batch, head, row) strides, so v and g are read in place
//     from [b, n, h, d] projection views; 128-byte swizzle) and bulk copies
//     of the row stats or key biases, each stage guarded by a full and an
//     empty mbarrier; consumer warpgroups (64 owned rows each; two at d = 64,
//     one at d = 128 to stay within 255 registers) run wgmma.m64nNk16: the
//     score-shaped products with both operands in shared memory (K-major),
//     the P V shaped ones with P or dS as bf16 register A fragments and the
//     streamed tile as an MN-major B operand (wgmma's transpose bit, no
//     scalar loads), the pass's dQ' with dS^T and K' both MN-major in shared
//     memory. The pass's producer and dQ warps sit in a third warpgroup
//     that gives its registers to the two consumer warpgroups (setmaxnreg:
//     168 to 24 and 240); P is exp2 of one FMA of the score with the scale
//     and bias in log2 units, without a branch;
//   - at d = 256 the dK and dV accumulators of 64 rows would need 256
//     registers a thread, so d = 256 keeps the first version's mma.sync
//     kernels (4 or 8 warps a 64-row tile, tiles staged through padded
//     shared memory), reading the pre-pass's outputs;
//   - the epilogue applies the RoPE backward in registers (the pair
//     (2j, 2j+1) sits in one thread's accumulator) and writes bf16.
//
// The float32 path computes the same function to float32 accuracy (the JAX
// kernel's HIGHEST precision for float32 inputs: tables not rounded, no
// rounding of P or dS) and writes float32. Its first kernels ran on the FMA
// units: 10.7 TFLOP/s counted at 10 n^2 d on the H100 (2.0 ms at
// [4, 8, 1024, 64], slower than the plain PyTorch version), 8 lanes sharing a
// row (8 FMAs, 3 shuffles and 3 adds a score), tiles staged with plain loads
// between two __syncthreads, every Q (or K) tile rotated again in every
// block, delta left to a PyTorch reduction. This design:
//   - a float32 pre-pass (`tc_prep_kernel`, csrc/tf32.cuh, shared with the
//     forward) writes once per call: rope(q), rope(k), v and g split into
//     TF32 halves (at d = 64), the row stats (lse, delta = rowsum(g * out)
//     in float32) padded with (FLT_MAX, 0), and the key biases padded with
//     -FLT_MAX, to a multiple of 128 rows;
//   - at d = 64 (the duration predictor's head dim, the only float32
//     training path) a dK/dV and a dQ kernel, each block owning 64 rows, on
//     3xTF32 products (csrc/tf32.cuh gives the split and which instruction
//     takes which product): the score-shaped products (S^T = K' Q'^T,
//     dP^T = V g^T, S = Q' K'^T, dP = g V^T) as wgmma.m64n64k8.tf32 with both
//     operands in shared memory, cross terms then hi hi; the P V shaped ones
//     (dV += P^T g, dK' += dS^T Q', dQ' += dS K') as mma.sync.m16n8k8.tf32
//     with P^T or dS split in registers and the B fragments read from the
//     streamed g, Q' or K' tile, which wgmma could only take as a K-major
//     copy (two more 16 KB tiles a stage per operand). Shared memory a
//     block: the two owned operands, hi and lo, 4 x 16 KB, loaded once by
//     TMA; two stages of two streamed operands, hi and lo, 4 x 16 KB each,
//     plus 1 KB of row stats or key biases; 195 KB of the 227 KB, one block
//     an SM. Two consumer warpgroups work on the block's 64 rows and take
//     the streamed tiles in turn, each from its own stage, which its first
//     thread refills by TMA once the warpgroup is past a tile: one
//     warpgroup's softmax and mma.sync overlap the other's wgmma. There is no
//     producer warp: a ninth warp puts three warps on one of the SM's four
//     sub-partitions and caps every thread at 168 registers, where the dK/dV
//     kernel spills. The second warpgroup's accumulators are added to the
//     first's through shared memory at the end, in a fixed order, after a
//     barrier (every warp reads the whole stage for its B fragments, so the
//     stage is free only when all are past their last tile). No float
//     atomics: both kernels stay deterministic;
//   - at d = 128 and 256 (no model of the repo trains them in float32) the
//     first FMA kernels stay, reading the pre-pass's row stats: 8 lanes per
//     row, each owning d/8 of the row's dims in float4 chunks, RoPE applied
//     while rows are staged.
//
// q, k, v and g are addressed through (batch, head, row) strides, so
// [b, n, h, d] projection views are read without a transpose copy; the head
// dim must be contiguous and rows 16-byte aligned.
//
// A query block (sequence parallelism in training, as the forward takes it:
// q, g, out and lse of a slot's n rows of the sequence from row q_off,
// against k and v [b, h, nk, d] of the whole group): the bf16 kernels at
// d = 64 and 128 and the 3xTF32 kernels at d = 64. dq, delta and the row
// stats are n rows, dk and dv nk rows; the pre-passes rotate query row i by
// table row q_off + i and key row i by row i, and the RoPE backward of dq
// uses the query rows' tables. The pass's and the dK/dV kernel's grids cover
// the keys and stream the n query rows, the dQ kernel's the reverse. A
// slot's dk and dv are its share of the keys' gradient: the caller sums them
// over the group. The mma.sync and FMA kernels (bf16 d = 256, float32 d = 128
// and 256) take nk = n and q_off = 0 only: the entry points refuse a block.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr int BM = 64;  // rows per tile (queries or keys)
constexpr int PAD = 8;  // bf16 padding per shared-memory row of the mma.sync kernels
constexpr float MASKED = -1e30f;
constexpr float FULLY_MASKED = -1e29f;  // an lse below this marks a row with every key masked
constexpr float LOG2E = 1.4426950408889634f;

// The float32 kernels' arguments.
template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const T* g;
  const float2* stats;  // [b, h, n_pad]: (lse, delta) of each query row, (FLT_MAX, 0) past n (the pre-pass)
  const float* kbias;   // [b, nk_pad]: each key's additive bias (the pre-pass)
  const uint8_t* mask;  // [b, nk] or null
  const float* cos;     // [nk, d] or null
  const float* sin;     // [nk, d] or null
  float* dq;            // [b, h, n, d], contiguous float32
  float* dk;            // [b, h, nk, d]
  float* dv;
  int n, n_pad;         // the query rows
  int nk, nk_pad, q_off;  // the keys, and the queries' first table row
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

constexpr int ROW_PAD = 128;  // the row statistics and key biases are padded to a multiple of this

// The bf16 path's arguments: the pre-pass reads q, k, g, out, lse, the mask
// and the tables and writes qr, kr, stats and kbias; the main kernels read
// qr, kr, v, g (through tensor maps or strides), stats and kbias, and the
// tables for the RoPE backward, and write bf16 dq, dk, dv.
struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;
  const __nv_bfloat16* out;
  const float* lse;     // [b, h, n]
  const uint8_t* mask;  // [b, nk] or null
  const float* cos;     // [nk, d] or null
  const float* sin;
  __nv_bfloat16* qr;    // rope(q) [b, h, n, d] and rope(k) [b, h, nk, d], contiguous
  __nv_bfloat16* kr;
  float2* stats;        // [b, h, n_pad]: (lse, delta) of each query row; (FLT_MAX, 0) past n
  float* kbias;         // [b, nk_pad]: each key's additive bias; -FLT_MAX past nk
  __nv_bfloat16* dq;    // [b, h, n, d] contiguous
  __nv_bfloat16* dk;    // [b, h, nk, d] contiguous
  __nv_bfloat16* dv;
  float* dq_acc;          // d = 64: the dQ' sums [b, h, tiles, 64 x 64] in the consumers' fragment order (the pass)
  int* dq_count;          // d = 64: [b, h, tiles] adds made to each query tile's sum; null at d = 128 and 256
  int* dq_ticket;         // d = 64: the blocks' start order (one counter after dq_count)
  int key_blocks;         // d = 64: 128-key blocks of the pass
  int key_tiles;          // d = 64: 64-row tiles of the keys: the query tiles of the whole sequence
  int dq_rotate;          // d = 64: each tile's dQ' partials added in the rotated order (see the source note)
  int h, n, n_pad;        // the query rows
  int nk, nk_pad, q_off;  // the keys, and the queries' first table row
  int rope_heads;         // heads 0 .. rope_heads - 1 are rotated, the others not
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long g_sb, g_sh, g_sn;
  long long o_sb, o_sh, o_sn;
  float scale;
};

// Head h's rotary table: `table` where the head is rotated, else null (the
// pre-pass copies it as it is and the epilogue applies no RoPE backward).
__device__ __forceinline__ const float* head_table(const BwdParams& p, const float* table, int h) {
  return h < p.rope_heads ? table : nullptr;
}

// Copy one 16-byte chunk (8 dims from an even dim c) of a row, rotated with
// the row's tables when given (rope_chunk_bf16: the JAX body's x * cos +
// bf16(x @ P) * sin with each product and the sum rounded to bf16, cos and
// sin rounded first, as the forward's pre-pass rotates, so the scores
// recomputed here are the forward's).
template <int D>
__device__ __forceinline__ void copy_rotated_chunk(__nv_bfloat16* dst, const __nv_bfloat16* src, const float* cos,
                                                   const float* sin, int row, int c) {
  uint4 val = *reinterpret_cast<const uint4*>(src);
  if (cos != nullptr) val = rope_chunk_bf16(val, table_chunk_bf16<D>(cos, row, c), table_chunk_bf16<D>(sin, row, c));
  *reinterpret_cast<uint4*>(dst) = val;
}

// The rows of a (b, h) pair that the pre-pass walks: the query rows' and the
// keys' padding, whichever is longer.
__host__ __device__ inline int prepass_rows(const BwdParams& p) { return p.n_pad > p.nk_pad ? p.n_pad : p.nk_pad; }

// The pre-pass: one launch over the (b, h, max(n_pad, nk_pad)) rows, D / 8
// threads a row (row i is query row i where i < n and key row i where
// i < nk). Writes qr = rope(q) and kr = rope(k) once (every main-kernel block
// used to rotate each tile it read), stats = (lse, rowsum(g * out)) in
// float32, and from the h = 0 rows each key's bias (0, MASKED, or -FLT_MAX
// past nk).
template <int D>
__global__ void __launch_bounds__(256) flash_bwd_prepass_kernel(const BwdParams p, long long rows) {
  constexpr int TPR = D / 8;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = idx / TPR;
  if (row >= rows) return;  // rows is a multiple of ROW_PAD, so whole warps leave together
  const int sub = static_cast<int>(idx % TPR);
  const int per = prepass_rows(p);
  const long long bh = row / per;
  const int i = static_cast<int>(row % per);
  const int b = static_cast<int>(bh / p.h), h = static_cast<int>(bh % p.h);
  const int c = sub * 8;
  float delta = 0.f;
  const float* turn = head_table(p, p.cos, h);
  if (i < p.nk) {
    copy_rotated_chunk<D>(p.kr + (bh * p.nk + i) * D + c, p.k + b * p.k_sb + h * p.k_sh + i * p.k_sn + c, turn,
                          p.sin, i, c);
  }
  if (i < p.n) {
    const long long o = (bh * p.n + i) * D + c;
    copy_rotated_chunk<D>(p.qr + o, p.q + b * p.q_sb + h * p.q_sh + i * p.q_sn + c, turn, p.sin, i + p.q_off, c);
    const uint4 gv = *reinterpret_cast<const uint4*>(p.g + b * p.g_sb + h * p.g_sh + i * p.g_sn + c);
    const uint4 ov = *reinterpret_cast<const uint4*>(p.out + b * p.o_sb + h * p.o_sh + i * p.o_sn + c);
    const __nv_bfloat162* gx = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* ox = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 gf = __bfloat1622float2(gx[j]), of = __bfloat1622float2(ox[j]);
      delta += gf.x * of.x + gf.y * of.y;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) delta += __shfl_xor_sync(0xffffffffu, delta, off);
  if (sub == 0) {
    if (i < p.n_pad) {
      p.stats[bh * p.n_pad + i] = i < p.n ? make_float2(p.lse[bh * p.n + i], delta) : make_float2(FLT_MAX, 0.f);
    }
    if (h == 0 && i < p.nk_pad) {
      const uint8_t* mask = p.mask == nullptr ? nullptr : p.mask + static_cast<long long>(b) * p.nk;
      p.kbias[static_cast<long long>(b) * p.nk_pad + i] = key_bias(mask, i, p.nk);
    }
    if (p.dq_count != nullptr && i < p.n && i % BM == 0) p.dq_count[bh * ((p.n + BM - 1) / BM) + i / BM] = 0;
    if (p.dq_count != nullptr && bh == 0 && i == 0) *p.dq_ticket = 0;
  }
}

// The RoPE backward of one (2j, 2j+1) pair of a gradient row, tables rounded
// to bf16: dx[2j] = dx'[2j] c[2j] + dx'[2j+1] s[2j+1], dx[2j+1] =
// dx'[2j+1] c[2j+1] - dx'[2j] s[2j]. Returns the pair rounded once to bf16.
template <int D>
__device__ __forceinline__ __nv_bfloat162 rope_bwd_pair(float x0, float x1, const float* cos, const float* sin,
                                                        int row, int col) {
  if (cos != nullptr) {
    const long long o = static_cast<long long>(row) * D + col;
    const float ce = round_bf16(cos[o]), co = round_bf16(cos[o + 1]);
    const float se = round_bf16(sin[o]), so = round_bf16(sin[o + 1]);
    const float y0 = x0 * ce + x1 * so, y1 = x1 * co - x0 * se;
    x0 = y0;
    x1 = y1;
  }
  return __floats2bfloat162_rn(x0, x1);
}

// ------------------------------------------ bf16, d = 64 and 128: TMA + wgmma

template <int D>
struct WShape {  // the pair at d = 128 (d = 64 takes the single pass)
  static constexpr int WGS = 1;                 // consumer warpgroups, 64 owned rows each (255 registers)
  static constexpr int ROWS = 64 * WGS;         // rows a block owns (keys for dK/dV, queries for dQ)
  static constexpr int PANELS = D / 64;         // 64-dim panels of a tile (128-byte swizzled rows)
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  static constexpr int STAGES = 2;
  static constexpr int PANEL = BM * 128;         // bytes of one 64-row panel of a streamed tile
  static constexpr int TILE = PANELS * PANEL;    // a streamed 64-row tile
  static constexpr int OWN_PANEL = ROWS * 128;   // bytes of one panel of an owned tile
  static constexpr int OWN = PANELS * OWN_PANEL;
  static constexpr int STAGE = 2 * TILE + 1024;  // two tiles + 512 B of row stats or 256 B of key biases
  static constexpr int BAR_OFF = 2 * OWN + STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;  // + slack to align the base to 1024
};

// Descriptor of k16 step kc of an MN-major operand: 16 rows of 128 bytes a step.
__device__ __forceinline__ uint64_t mnmajor(uint64_t desc, int kc) { return desc + ((kc * 16 * 128) >> 4); }

// Round a [64 x 64] score-shaped accumulator to bf16 A fragments, one per k16 step.
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = pack_f32(x[8 * kc + 0], x[8 * kc + 1]);
    a[kc][1] = pack_f32(x[8 * kc + 2], x[8 * kc + 3]);
    a[kc][2] = pack_f32(x[8 * kc + 4], x[8 * kc + 5]);
    a[kc][3] = pack_f32(x[8 * kc + 6], x[8 * kc + 7]);
  }
}

// Store a thread's share of a [64 x D] accumulator (rows row0 + g and
// row0 + g + 8 of the block's rows) as bf16 rows of a contiguous [n, D]
// head, with the RoPE backward when tables are given (row i by table row
// t_off + i).
template <int D>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, const float (&acc)[D / 2], int row0, int n,
                                          const float* cos, const float* sin, int t_off) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + g + 8 * hi;
    if (row >= n) continue;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * D + col) =
          rope_bwd_pair<D>(acc[4 * i + 2 * hi], acc[4 * i + 2 * hi + 1], cos, sin, row + t_off, col);
    }
  }
}

// dK, dV for ROWS keys. The producer (lane 0 of the last warp) loads the
// block's K' and V once and then streams Q', g and the row stats of each
// 64-query tile through the ring. Each consumer warpgroup owns 64 keys:
// S^T = K' Q'^T and dP^T = V g^T from shared memory (K-major), P^T and
// dS^T in registers, then dV += P^T g and dK' += dS^T Q' with P^T and dS^T
// as bf16 A fragments and g, Q' as MN-major B operands (wgmma's transpose).
template <int D>
__global__ void __launch_bounds__(WShape<D>::THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap qr_map, const __grid_constant__ CUtensorMap kr_map,
                            const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap g_map,
                            const BwdParams p) {
  using W = WShape<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + W::OWN;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + W::BAR_OFF);
  uint64_t* full = own + 1;
  uint64_t* empty = full + W::STAGES;
  auto stage = [&](int s) { return smem + 2 * W::OWN + s * W::STAGE; };

  const int k0 = blockIdx.x * W::ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.h + h;
  const int tiles = (p.n + BM - 1) / BM;

  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= W::CONSUMERS) {  // producer warp
    if (threadIdx.x == W::CONSUMERS) {
      mbar_arrive_expect_tx(own, 2 * W::OWN);
      for (int pn = 0; pn < W::PANELS; ++pn) {
        for (int r = 0; r < W::WGS; ++r) {
          const int off = pn * W::OWN_PANEL + r * W::PANEL;
          tma_load_4d(sK + off, &kr_map, own, pn * 64, k0 + r * BM, h, b);
          tma_load_4d(sV + off, &v_map, own, pn * 64, k0 + r * BM, h, b);
        }
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % W::STAGES;
        if (it >= W::STAGES) mbar_wait(&empty[s], (it / W::STAGES - 1) & 1);
        unsigned char* st = stage(s);
        mbar_arrive_expect_tx(&full[s], 2 * W::TILE + BM * 8);
        for (int pn = 0; pn < W::PANELS; ++pn) {
          tma_load_4d(st + pn * W::PANEL, &qr_map, &full[s], pn * 64, it * BM, h, b);
          tma_load_4d(st + W::TILE + pn * W::PANEL, &g_map, &full[s], pn * 64, it * BM, h, b);
        }
        bulk_load(st + 2 * W::TILE, p.stats + bh * p.n_pad + it * BM, BM * 8, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = wg * 64 + (threadIdx.x / 32 % 4) * 16;  // this warp's first key in the block
  const float* kbias = p.kbias + static_cast<long long>(b) * p.nk_pad + k0 + row0 + g;
  const float bias[2] = {kbias[0], kbias[8]};  // keys row0 + g and row0 + g + 8
  const float inv_n = 1.f / p.nk;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(own, 0);
  const uint64_t k_desc = sw128_desc(sK + wg * W::PANEL);
  const uint64_t v_desc = sw128_desc(sV + wg * W::PANEL);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % W::STAGES;
    mbar_wait(&full[s], (it / W::STAGES) & 1);
    unsigned char* st = stage(s);
    const float2* stats = reinterpret_cast<const float2*>(st + 2 * W::TILE);

    float sc[32], dp[32];
    const uint64_t q_desc = sw128_desc(st), g_desc = sw128_desc(st + W::TILE);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      wgmma_ss(sc, kmajor(k_desc, kc, W::OWN_PANEL), kmajor(q_desc, kc, W::PANEL), kc > 0);
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      wgmma_ss(dp, kmajor(v_desc, kc, W::OWN_PANEL), kmajor(g_desc, kc, W::PANEL), kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P^T = exp(s + bias - lse); dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 sd = stats[8 * i + 2 * t + (e & 1)];
        const float pr = prob(sc[4 * i + e] * p.scale, bias[e >> 1], sd.x, inv_n);
        sc[4 * i + e] = pr;
        dp[4 * i + e] = pr * (dp[4 * i + e] - sd.y) * p.scale;
      }
    }
    uint32_t pa[4][4], da[4][4];
    to_a_frags(pa, sc);  // P rounded to bf16 before dV
    to_a_frags(da, dp);  // dS rounded to bf16 before dK
    const uint64_t gt_desc = sw128_desc(st + W::TILE, W::PANEL), qt_desc = sw128_desc(st, W::PANEL);
    wgmma_fence();
    fence_regs(dv);
    fence_regs(dk);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(dv, pa[kc], mnmajor(gt_desc, kc), 1);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(dk, da[kc], mnmajor(qt_desc, kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&empty[s]);
  }

  store_acc<D>(p.dk + bh * p.nk * D, dk, k0 + row0, p.nk, head_table(p, p.cos, h), p.sin, 0);
  store_acc<D>(p.dv + bh * p.nk * D, dv, k0 + row0, p.nk, nullptr, nullptr, 0);
}

// dQ for ROWS queries. The producer loads the block's Q' and g once and then
// streams K', V and the key biases of each 64-key tile. Each consumer
// warpgroup owns 64 queries: S = Q' K'^T and dP = g V^T from shared memory,
// P and dS in registers, dQ' += dS K' with K' as the MN-major B operand.
// Two blocks share an SM: this kernel waits on latency more than on the
// tensor cores (at d = 64, which it ran before the single pass, four consumer
// warpgroups an SM beat two even though ptxas then serialized the wgmmas of
// a warpgroup to fit 112 registers a thread: 0.287 against 0.310 ms a
// backward call at the CFM training shape on the H100).
template <int D>
__global__ void __launch_bounds__(WShape<D>::THREADS, 2)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qr_map, const __grid_constant__ CUtensorMap kr_map,
                          const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap g_map,
                          const BwdParams p) {
  using W = WShape<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sQ = smem;
  unsigned char* sG = smem + W::OWN;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + W::BAR_OFF);
  uint64_t* full = own + 1;
  uint64_t* empty = full + W::STAGES;
  auto stage = [&](int s) { return smem + 2 * W::OWN + s * W::STAGE; };

  const int q0 = blockIdx.x * W::ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * p.h + h;
  const int tiles = (p.nk + BM - 1) / BM;

  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= W::CONSUMERS) {  // producer warp
    if (threadIdx.x == W::CONSUMERS) {
      mbar_arrive_expect_tx(own, 2 * W::OWN);
      for (int pn = 0; pn < W::PANELS; ++pn) {
        for (int r = 0; r < W::WGS; ++r) {
          const int off = pn * W::OWN_PANEL + r * W::PANEL;
          tma_load_4d(sQ + off, &qr_map, own, pn * 64, q0 + r * BM, h, b);
          tma_load_4d(sG + off, &g_map, own, pn * 64, q0 + r * BM, h, b);
        }
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % W::STAGES;
        if (it >= W::STAGES) mbar_wait(&empty[s], (it / W::STAGES - 1) & 1);
        unsigned char* st = stage(s);
        mbar_arrive_expect_tx(&full[s], 2 * W::TILE + BM * 4);
        for (int pn = 0; pn < W::PANELS; ++pn) {
          tma_load_4d(st + pn * W::PANEL, &kr_map, &full[s], pn * 64, it * BM, h, b);
          tma_load_4d(st + W::TILE + pn * W::PANEL, &v_map, &full[s], pn * 64, it * BM, h, b);
        }
        bulk_load(st + 2 * W::TILE, p.kbias + static_cast<long long>(b) * p.nk_pad + it * BM, BM * 4, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = wg * 64 + (threadIdx.x / 32 % 4) * 16;  // this warp's first query in the block
  const float2* stats = p.stats + bh * p.n_pad + q0 + row0 + g;
  const float2 sd[2] = {stats[0], stats[8]};  // rows row0 + g and row0 + g + 8
  const float inv_n = 1.f / p.nk;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(own, 0);
  const uint64_t q_desc = sw128_desc(sQ + wg * W::PANEL);
  const uint64_t g_desc = sw128_desc(sG + wg * W::PANEL);

  for (int it = 0; it < tiles; ++it) {
    const int s = it % W::STAGES;
    mbar_wait(&full[s], (it / W::STAGES) & 1);
    unsigned char* st = stage(s);
    const float* kb = reinterpret_cast<const float*>(st + 2 * W::TILE);

    float sc[32], dp[32];
    const uint64_t k_desc = sw128_desc(st), v_desc = sw128_desc(st + W::TILE);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      wgmma_ss(sc, kmajor(q_desc, kc, W::OWN_PANEL), kmajor(k_desc, kc, W::PANEL), kc > 0);
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      wgmma_ss(dp, kmajor(g_desc, kc, W::OWN_PANEL), kmajor(v_desc, kc, W::PANEL), kc > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta) scale, P = exp(s + bias - lse)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = prob(sc[4 * i + e] * p.scale, kb[8 * i + 2 * t + (e & 1)], sd[e >> 1].x, inv_n);
        dp[4 * i + e] = pr * (dp[4 * i + e] - sd[e >> 1].y) * p.scale;
      }
    }
    uint32_t da[4][4];
    to_a_frags(da, dp);  // dS rounded to bf16 before dQ
    const uint64_t kt_desc = sw128_desc(st, W::PANEL);
    wgmma_fence();
    fence_regs(dq);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(dq, da[kc], mnmajor(kt_desc, kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(&empty[s]);
  }

  store_acc<D>(p.dq + bh * p.n * D, dq, q0 + row0, p.n, head_table(p, p.cos, h), p.sin, p.q_off);
}

// A 4-d tensor map of a [b, h, n, D] bf16 tensor with (batch, head, row)
// strides in elements: dims (D, n, h, b), 64 x 64 boxes, 128-byte swizzle.
template <int D>
cudaError_t head_map(CUtensorMap* map, const void* base, int b, int h, int n, long long sb, long long sh,
                     long long sn) {
  const uint64_t dims[4] = {D, static_cast<uint64_t>(n), static_cast<uint64_t>(h), static_cast<uint64_t>(b)};
  const uint64_t strides[3] = {static_cast<uint64_t>(sn) * 2, static_cast<uint64_t>(sh) * 2,
                               static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {64, BM, 1, 1};
  return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
cudaError_t launch_wgmma(const BwdParams& p, int b, cudaStream_t stream) {
  using W = WShape<D>;
  const long long hq = static_cast<long long>(p.n) * D, hk = static_cast<long long>(p.nk) * D;
  CUtensorMap qr_map, kr_map, v_map, g_map;
  cudaError_t err = head_map<D>(&qr_map, p.qr, b, p.h, p.n, p.h * hq, hq, D);
  if (err == cudaSuccess) err = head_map<D>(&kr_map, p.kr, b, p.h, p.nk, p.h * hk, hk, D);
  if (err == cudaSuccess) err = head_map<D>(&v_map, p.v, b, p.h, p.nk, p.v_sb, p.v_sh, p.v_sn);
  if (err == cudaSuccess) err = head_map<D>(&g_map, p.g, b, p.h, p.n, p.g_sb, p.g_sh, p.g_sn);
  if (err != cudaSuccess) return err;
  static std::atomic<bool> dkdv_raised[MAX_DEVICES], dq_raised[MAX_DEVICES];
  err = raise_smem_limit(reinterpret_cast<const void*>(flash_bwd_dkdv_wgmma_kernel<D>), W::SMEM, dkdv_raised);
  if (err == cudaSuccess) {
    err = raise_smem_limit(reinterpret_cast<const void*>(flash_bwd_dq_wgmma_kernel<D>), W::SMEM, dq_raised);
  }
  if (err != cudaSuccess) return err;
  const dim3 keys((p.nk + W::ROWS - 1) / W::ROWS, p.h, b), queries((p.n + W::ROWS - 1) / W::ROWS, p.h, b);
  flash_bwd_dkdv_wgmma_kernel<D><<<keys, W::THREADS, W::SMEM, stream>>>(qr_map, kr_map, v_map, g_map, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D><<<queries, W::THREADS, W::SMEM, stream>>>(qr_map, kr_map, v_map, g_map, p);
  return cudaGetLastError();
}

// ------------------------------------------ bf16, d = 64: one pass (dK, dV and dQ)

// The shared memory of the pass: K' and V of the block's 128 keys, a ring of
// STAGES stages (Q' and g of one 64-query tile and its row stats), two
// buffers of dS^T (the block's keys against one query tile, bf16, 128-byte
// swizzled rows of 64 queries) and two of the tile's dQ' partial (float32,
// in the consumers' fragment order).
struct PassShape {
  static constexpr int ROWS = 128;                // keys a block owns: two consumer warpgroups of 64
  static constexpr int CONSUMERS = 256;
  // + a warpgroup that gives its registers to the consumers (setmaxnreg moves them within the block, so it has
  // to free what the consumers take: 4 x 32 x (168 - 24) = 2 x 128 x (240 - 168)), of which one warp is the
  // producer and one the dQ warp
  static constexpr int THREADS = CONSUMERS + 128;
  static constexpr int STAGES = 3;
  static constexpr int TILE = BM * 128;           // 64 rows of 64 bf16
  static constexpr int OWN = ROWS * 128;          // K' or V of the block's keys
  static constexpr int STAGE = 2 * TILE + 1024;   // Q', g and 512 B of row stats
  static constexpr int DS = ROWS * 128;
  static constexpr int DQ = BM * 64 * 4;
  static constexpr int STAGE_OFF = 2 * OWN;
  static constexpr int DS_OFF = STAGE_OFF + STAGES * STAGE;
  static constexpr int DQ_OFF = DS_OFF + 2 * DS;
  static constexpr int BAR_OFF = DQ_OFF + 2 * DQ;
  static constexpr int SMEM = BAR_OFF + (1 + 2 * STAGES + 4) * 8 + 16 + 1024;  // + the ticket, + alignment slack
};

// The order of the pass (see the source note). Query tile i of a call is
// tile G = q_off / 64 + i of the sequence, and key block j's add into it has
// the key (G + j) mod key_tiles. Rotated, each tile's partials are added in
// the order of their keys and each block visits its tiles in the order of
// their keys: pass_tile gives the tile of block j's step k, pass_place
// block j's place in tile i's order. Otherwise block j visits tile k at step
// k and adds j-th.
__device__ __forceinline__ int pass_tile(const BwdParams& p, int k, int j, int tiles) {
  if (!p.dq_rotate) return k;
  const int first = p.key_tiles - (p.q_off / BM + j) % p.key_tiles;  // the first tile whose key wrapped past 0
  return first < tiles ? (k + first) % tiles : k;
}

__device__ __forceinline__ int pass_place(const BwdParams& p, int i, int j) {
  if (!p.dq_rotate) return j;
  const int w = p.key_tiles - (p.q_off / BM + i);  // blocks j >= w have wrapped keys, the smallest
  return j >= w ? j - w : j + (p.key_blocks > w ? p.key_blocks - w : 0);
}

// dK, dV and the dQ' partials of 128 keys in one pass over the query tiles.
// Thread roles: two consumer warpgroups (64 keys each), then a warpgroup that
// gives its registers to the consumers, of which two warps work: the producer
// warp (lane 0 loads K' and V once, then streams Q', g and the row stats of
// each query tile through the ring) and the dQ warp (lane 0 adds each tile's
// partial into the float32 sum in global memory, in the tile's fixed order).
// Per query tile each consumer warpgroup computes S^T = K' Q'^T and
// dP^T = V g^T (shared memory, K-major), P^T and dS^T in registers,
// dV += P^T g and dK' += dS^T Q' (register A, MN-major B), writes dS^T to
// shared memory as bf16 and, once both warpgroups have, dQ' = dS K' over
// the block's 128 keys for its half of the 64 columns (both operands
// MN-major in shared memory). Each step waits for its S^T and dP^T, issues
// dV's product before the dS math and the next tile's S^T and dP^T before it
// waits for dV, dK' and dQ'. (Reading S^T while dP^T was still in flight made
// ptxas serialise every wgmma of the kernel.)
__global__ void __launch_bounds__(PassShape::THREADS, 1)
flash_bwd_dkdv_wgmma_kernel_dq(const __grid_constant__ CUtensorMap qr_map, const __grid_constant__ CUtensorMap kr_map,
                               const __grid_constant__ CUtensorMap v_map, const __grid_constant__ CUtensorMap g_map,
                               const BwdParams p) {
  using W = PassShape;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* sK = smem;
  unsigned char* sV = smem + W::OWN;
  unsigned char* sDS = smem + W::DS_OFF;
  unsigned char* sDQ = smem + W::DQ_OFF;
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + W::BAR_OFF);
  uint64_t* full = own + 1;
  uint64_t* empty = full + W::STAGES;
  uint64_t* dq_full = empty + W::STAGES;
  uint64_t* dq_empty = dq_full + 2;
  int* ticket = reinterpret_cast<int*>(dq_empty + 2);
  auto stage = [&](int s) { return smem + W::STAGE_OFF + s * W::STAGE; };

  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W::CONSUMERS);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&dq_full[s], W::CONSUMERS);
      mbar_init(&dq_empty[s], 1);
    }
    mbar_fence_init();
    *ticket = atomicAdd(p.dq_ticket, 1);  // blocks take their work in the order they start
  }
  __syncthreads();

  const int J = p.key_blocks;
  const int j = *ticket % J;
  const long long bh = *ticket / J;
  const int h = static_cast<int>(bh % p.h), b = static_cast<int>(bh / p.h);
  const int k0 = j * W::ROWS;
  const int tiles = (p.n + BM - 1) / BM;

  if (threadIdx.x >= W::CONSUMERS) {
    setmaxnreg_dec<24>();
    const bool producer = threadIdx.x < W::CONSUMERS + 32;
    if (threadIdx.x % 32 != 0 || threadIdx.x >= W::CONSUMERS + 64) return;
    if (producer) {
      mbar_arrive_expect_tx(own, 2 * W::OWN);
      for (int r = 0; r < 2; ++r) {
        tma_load_4d(sK + r * W::TILE, &kr_map, own, 0, k0 + r * BM, h, b);
        tma_load_4d(sV + r * W::TILE, &v_map, own, 0, k0 + r * BM, h, b);
      }
      for (int k = 0; k < tiles; ++k) {
        const int s = k % W::STAGES;
        if (k >= W::STAGES) mbar_wait(&empty[s], (k / W::STAGES - 1) & 1);
        const int i = pass_tile(p, k, j, tiles);
        unsigned char* st = stage(s);
        mbar_arrive_expect_tx(&full[s], 2 * W::TILE + BM * 8);
        tma_load_4d(st, &qr_map, &full[s], 0, i * BM, h, b);
        tma_load_4d(st + W::TILE, &g_map, &full[s], 0, i * BM, h, b);
        bulk_load(st + 2 * W::TILE, p.stats + bh * p.n_pad + i * BM, BM * 8, &full[s]);
      }
    } else {
      // The ordered float32 sum: the block in place `place` of tile i waits
      // until the tile's count says `place` partials are in, adds its own
      // (the first stores it, so the sum needs no zeroing), waits for the
      // write to complete and counts it.
      float* acc = p.dq_acc + bh * tiles * (BM * 64);
      int* count = p.dq_count + bh * tiles;
      for (int k = 0; k < tiles; ++k) {
        const int buf = k & 1;
        const int i = pass_tile(p, k, j, tiles);
        const int place = pass_place(p, i, j);
        mbar_wait(&dq_full[buf], (k >> 1) & 1);
        if (place > 0) {
          while (ld_acquire_gpu(count + i) != place) {
          }
        }
        fence_proxy_async_global();
        float* dst = acc + static_cast<long long>(i) * (BM * 64);
        if (place == 0) {
          bulk_store(dst, sDQ + buf * W::DQ, W::DQ);
        } else {
          bulk_reduce_add_f32(dst, sDQ + buf * W::DQ, W::DQ);
        }
        bulk_commit();
        bulk_wait<0>();
        fence_proxy_async_global();
        red_release_gpu_add(count + i, 1);
        mbar_arrive(&dq_empty[buf]);
      }
    }
    return;
  }

  setmaxnreg_inc<240>();
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = wg * 64 + (threadIdx.x / 32 % 4) * 16;  // this warp's first key in the block
  const float* kbias = p.kbias + static_cast<long long>(b) * p.nk_pad + k0 + row0 + g;
  // keys row0 + g and row0 + g + 8: the bias in log2 units, and P of a row with every key masked
  const float bias2[2] = {kbias[0] * LOG2E, kbias[8] * LOG2E};
  const float uniform[2] = {kbias[0] == -FLT_MAX ? 0.f : 1.f / p.nk, kbias[8] == -FLT_MAX ? 0.f : 1.f / p.nk};
  const float scale2 = p.scale * LOG2E;

  float dk[32], dv[32], dq[16], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) dq[i] = 0.f;

  mbar_wait(own, 0);
  const uint64_t k_desc = sw128_desc(sK + wg * W::TILE);
  const uint64_t v_desc = sw128_desc(sV + wg * W::TILE);
  const uint64_t kn_desc = sw128_desc(sK + wg * 64);  // dQ's B: columns 32 wg .. 32 wg + 31 of the 128 keys' K'

  // S^T and dP^T of step k, committed as two groups
  auto scores = [&](int k) {
    const int s = k % W::STAGES;
    mbar_wait(&full[s], (k / W::STAGES) & 1);
    unsigned char* st = stage(s);
    const uint64_t q_desc = sw128_desc(st), g_desc = sw128_desc(st + W::TILE);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_ss(sc, kmajor(k_desc, kc, W::OWN), kmajor(q_desc, kc, W::TILE), kc > 0);
    wgmma_commit();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_ss(dp, kmajor(v_desc, kc, W::OWN), kmajor(g_desc, kc, W::TILE), kc > 0);
    wgmma_commit();
  };

  // step k of the pass; the last issues no next tile, so the loop's steps all take one path
  auto step = [&](int k, auto last) {
    const int s = k % W::STAGES;
    unsigned char* st = stage(s);
    const float2* stats = reinterpret_cast<const float2*>(st + 2 * W::TILE);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P^T = exp(s + bias - lse), rounded to bf16 for dV
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float lse = stats[8 * i + 2 * t + c].x;
        const float lse2 = lse * LOG2E;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int e = 4 * i + 2 * hi + c;
          const float pr = exp2f(fmaf(sc[e], scale2, bias2[hi]) - lse2);
          sc[e] = lse < FULLY_MASKED ? uniform[hi] : pr;
        }
      }
    }
    uint32_t pa[4][4];
    to_a_frags(pa, sc);
    const uint64_t gt_desc = sw128_desc(st + W::TILE, W::TILE), qt_desc = sw128_desc(st, W::TILE);
    wgmma_fence();
    fence_regs(dv);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(dv, pa[kc], mnmajor(gt_desc, kc), 1);
    wgmma_commit();

    // dS^T = P^T (dP^T - delta) scale, rounded to bf16 for dK and dQ
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[4 * i + e] = sc[4 * i + e] * (dp[4 * i + e] - stats[8 * i + 2 * t + (e & 1)].y) * p.scale;
      }
    }
    uint32_t da[4][4];
    to_a_frags(da, dp);
    // dS^T into shared memory: key row R, queries 8 c .. 8 c + 7 in 16-byte chunk c ^ (R % 8)
    unsigned char* ds = sDS + (k & 1) * W::DS;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = row0 + g + 8 * (r & 1), c = 2 * kc + (r >> 1);
        *reinterpret_cast<uint32_t*>(ds + row * 128 + ((c ^ g) << 4) + 4 * t) = da[kc][r];
      }
    }
    fence_proxy_async();
    wgmma_fence();
    fence_regs(dk);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<1>(dk, da[kc], mnmajor(qt_desc, kc), 1);
    wgmma_commit();

    // dQ' = dS K' over the block's keys, once both warpgroups' dS^T is in
    bar_sync(1, W::CONSUMERS);
    const uint64_t ds_desc = sw128_desc(ds);
    wgmma_fence();
    fence_regs(dq);
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) wgmma_ss_t<1, 1>(dq, mnmajor(ds_desc, kc), mnmajor(kn_desc, kc), kc > 0);
    wgmma_commit();

    if constexpr (decltype(last)::value) {
      wgmma_wait<0>();
    } else {
      scores(k + 1);
      wgmma_wait<2>();
    }
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(dq);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      fence_regs(pa[kc]);
      fence_regs(da[kc]);
    }
    mbar_arrive(&empty[s]);

    // the partial to the dQ warp: float4 i of thread x of warpgroup w at (w * 4 + i) * 128 + x
    const int buf = k & 1;
    if (k >= 2) mbar_wait(&dq_empty[buf], ((k >> 1) - 1) & 1);
    float4* part = reinterpret_cast<float4*>(sDQ + buf * W::DQ) + wg * 512 + threadIdx.x % 128;
#pragma unroll
    for (int i = 0; i < 4; ++i) part[i * 128] = make_float4(dq[4 * i], dq[4 * i + 1], dq[4 * i + 2], dq[4 * i + 3]);
    fence_proxy_async();
    mbar_arrive(&dq_full[buf]);
  };

  scores(0);
  for (int k = 0; k + 1 < tiles; ++k) step(k, std::false_type{});
  step(tiles - 1, std::true_type{});

  store_acc<64>(p.dk + bh * p.nk * 64, dk, k0 + row0, p.nk, head_table(p, p.cos, h), p.sin, 0);
  store_acc<64>(p.dv + bh * p.nk * 64, dv, k0 + row0, p.nk, nullptr, nullptr, 0);
}

// dQ from the pass's float32 sums, rounded once to bf16 after the RoPE
// backward with the query rows' tables (row q_off + i) on rotated heads. One
// thread takes the four float4s of a quad (lanes t = 0..3 of the fragment
// order): columns 32 w + 8 c .. + 7 of rows r and r + 8, two 16-byte stores.
__global__ void __launch_bounds__(256) flash_bwd_dq_wgmma_kernel_sum(const BwdParams p, long long count) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= count) return;
  const int tiles = (p.n + BM - 1) / BM;
  const int c = static_cast<int>(idx % 4), g = static_cast<int>(idx / 4 % 8);
  const int warp = static_cast<int>(idx / 32 % 4), wg = static_cast<int>(idx / 128 % 2);
  const long long tile = idx / 256;  // over (b, h, tiles)
  const float4* src = reinterpret_cast<const float4*>(p.dq_acc) + tile * 1024 + (wg * 4 + c) * 128 + warp * 32 + g * 4;
  const long long bh = tile / tiles;
  const int row = static_cast<int>(tile % tiles) * BM + warp * 16 + g;
  const int col = wg * 32 + c * 8;
  const float* cos = head_table(p, p.cos, static_cast<int>(bh % p.h));
  float4 v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) v[t] = src[t];
  __nv_bfloat16* out = p.dq + bh * p.n * 64 + col;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = row + 8 * hi;
    if (r >= p.n) continue;
    uint4 packed;
    __nv_bfloat162* pair = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      pair[t] = rope_bwd_pair<64>(hi ? v[t].z : v[t].x, hi ? v[t].w : v[t].y, cos, p.sin, r + p.q_off, col + 2 * t);
    }
    *reinterpret_cast<uint4*>(out + static_cast<long long>(r) * 64) = packed;
  }
}

cudaError_t launch_pass(BwdParams p, int b, cudaStream_t stream) {
  using W = PassShape;
  const long long hq = static_cast<long long>(p.n) * 64, hk = static_cast<long long>(p.nk) * 64;
  CUtensorMap qr_map, kr_map, v_map, g_map;
  cudaError_t err = head_map<64>(&qr_map, p.qr, b, p.h, p.n, p.h * hq, hq, 64);
  if (err == cudaSuccess) err = head_map<64>(&kr_map, p.kr, b, p.h, p.nk, p.h * hk, hk, 64);
  if (err == cudaSuccess) err = head_map<64>(&v_map, p.v, b, p.h, p.nk, p.v_sb, p.v_sh, p.v_sn);
  if (err == cudaSuccess) err = head_map<64>(&g_map, p.g, b, p.h, p.n, p.g_sb, p.g_sh, p.g_sn);
  if (err != cudaSuccess) return err;
  static std::atomic<bool> raised[MAX_DEVICES];
  err = raise_smem_limit(reinterpret_cast<const void*>(flash_bwd_dkdv_wgmma_kernel_dq), W::SMEM, raised);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (p.n + BM - 1) / BM;
  p.key_blocks = (p.nk + W::ROWS - 1) / W::ROWS;
  p.key_tiles = (p.nk + BM - 1) / BM;
  // rotated where the call's tiles are tiles of the keys' sequence (a query block lies inside it) and every
  // block of a (b, h) fits on the card at once (one block an SM, with room to spare)
  p.dq_rotate = p.q_off / BM + tiles <= p.key_tiles && 2 * p.key_blocks <= sms;
  const long long blocks = static_cast<long long>(p.key_blocks) * p.h * b;
  flash_bwd_dkdv_wgmma_kernel_dq<<<static_cast<unsigned>(blocks), W::THREADS, W::SMEM, stream>>>(qr_map, kr_map, v_map,
                                                                                                  g_map, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long count = static_cast<long long>(b) * p.h * tiles * 256;
  flash_bwd_dq_wgmma_kernel_sum<<<static_cast<unsigned>((count + 255) / 256), 256, 0, stream>>>(p, count);
  return cudaGetLastError();
}

// ------------------------------------------ bf16, d = 256: mma.sync

// At d = 256 a warpgroup owning 64 rows would hold 64 x 256 float32 dK and
// dV accumulators (256 registers a thread) beside the score tiles, past the
// 255-register limit, so d = 256 keeps the first version's mma.sync kernels,
// reading the pre-pass's qr, kr, stats and key biases.

template <int D>
struct Shape {
  static constexpr int DC = D <= 128 ? 64 : 128;  // output columns per warp
  static constexpr int WARPS = 4 * (D / DC);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int LD = D + PAD;
};

// Copy rows [row0, row0 + 64) of one head into shared memory (row stride
// D + PAD), zero-filling rows >= n.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, const __nv_bfloat16* g, long long sn, int row0, int n) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BM * CHUNKS; i += Shape<D>::THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) val = *reinterpret_cast<const uint4*>(g + row * sn + c);
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

// Write a thread's share of a [16 x DC] accumulator for rows row0 + g and
// row0 + g + 8 as bf16, applying the RoPE backward with the rows' tables.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[Shape<D>::DC / 8][4], int row0,
                                           int c0, int n, const float* cos, const float* sin) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n) continue;
#pragma unroll
    for (int dt = 0; dt < Shape<D>::DC / 8; ++dt) {
      const int col = c0 + dt * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * D + col) =
          rope_bwd_pair<D>(acc[dt][2 * r], acc[dt][2 * r + 1], cos, sin, row, col);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Shape<D>::THREADS) flash_bwd_dkdv_kernel(const BwdParams p) {
  using S = Shape<D>;
  constexpr int LD = S::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + BM * LD;
  __nv_bfloat16* sQ = sV + BM * LD;
  __nv_bfloat16* sG = sQ + BM * LD;
  float2* sStats = reinterpret_cast<float2*>(sG + BM * LD);

  const int k0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (warp % 4) * 16;     // warp's first key within the tile
  const int c0 = (warp / 4) * S::DC;  // warp's first output column
  const long long bh = static_cast<long long>(b) * gridDim.y + h;

  const __nv_bfloat16* qg = p.qr + bh * p.n * D;
  const __nv_bfloat16* kg = p.kr + bh * p.n * D;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* gg = p.g + b * p.g_sb + h * p.g_sh;
  const float2* stats = p.stats + bh * p.n_pad;
  const float* kbias = p.kbias + static_cast<long long>(b) * p.n_pad;
  const float inv_n = 1.f / p.n;

  load_tile<D>(sK, kg, D, k0, p.n);
  load_tile<D>(sV, vg, p.v_sn, k0, p.n);
  // this thread's keys: wr + g (index 0) and wr + g + 8 (index 1)
  const float bias[2] = {kbias[k0 + wr + g], kbias[k0 + wr + g + 8]};

  float dk[S::DC / 8][4], dv[S::DC / 8][4];
#pragma unroll
  for (int i = 0; i < S::DC / 8; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int q0 = 0; q0 < p.n; q0 += BM) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile<D>(sQ, qg, D, q0, p.n);
    load_tile<D>(sG, gg, p.g_sn, q0, p.n);
    if (threadIdx.x < BM) sStats[threadIdx.x] = stats[q0 + threadIdx.x];  // rows past n: P = 0
    __syncthreads();

    // P^T: the warp's 16 keys against the tile's 64 queries
    float pt[BM / 8][4];
    scores<D, BM / 8>(pt, sK, wr, sQ);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pt[nt][e] = prob(pt[nt][e] * p.scale, bias[e >> 1], sStats[nt * 8 + 2 * t + (e & 1)].x, inv_n);
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
        ds[nt][e] = pt[nt][e] * (ds[nt][e] - sStats[nt * 8 + 2 * t + (e & 1)].y) * p.scale;
      }
    }
    // dK' += dS^T Q'
    product<D>(dk, ds, sQ, c0);
  }

  store_rows<D>(p.dk + bh * p.n * D, dk, k0 + wr, c0, p.n, head_table(p, p.cos, h), p.sin);
  store_rows<D>(p.dv + bh * p.n * D, dv, k0 + wr, c0, p.n, nullptr, nullptr);
}

template <int D>
__global__ void __launch_bounds__(Shape<D>::THREADS) flash_bwd_dq_kernel(const BwdParams p) {
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

  const __nv_bfloat16* qg = p.qr + bh * p.n * D;
  const __nv_bfloat16* kg = p.kr + bh * p.n * D;
  const __nv_bfloat16* vg = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* gg = p.g + b * p.g_sb + h * p.g_sh;
  const float* kbias = p.kbias + static_cast<long long>(b) * p.n_pad;
  const float inv_n = 1.f / p.n;

  load_tile<D>(sQ, qg, D, q0, p.n);
  load_tile<D>(sG, gg, p.g_sn, q0, p.n);
  // this thread's rows: wr + g (index 0) and wr + g + 8 (index 1)
  const float2 sd[2] = {p.stats[bh * p.n_pad + q0 + wr + g], p.stats[bh * p.n_pad + q0 + wr + g + 8]};

  float dq[S::DC / 8][4];
#pragma unroll
  for (int i = 0; i < S::DC / 8; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int k0 = 0; k0 < p.n; k0 += BM) {
    __syncthreads();  // the previous tile is consumed by every warp
    load_tile<D>(sK, kg, D, k0, p.n);
    load_tile<D>(sV, vg, p.v_sn, k0, p.n);
    if (threadIdx.x < BM) sBias[threadIdx.x] = kbias[k0 + threadIdx.x];
    __syncthreads();

    // P: the warp's 16 queries against the tile's 64 keys
    float pr[BM / 8][4];
    scores<D, BM / 8>(pr, sQ, wr, sK);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pr[nt][e] = prob(pr[nt][e] * p.scale, sBias[nt * 8 + 2 * t + (e & 1)], sd[e >> 1].x, inv_n);
      }
    }
    // dS = P * (g V^T - delta) * scale
    float ds[BM / 8][4];
    scores<D, BM / 8>(ds, sG, wr, sV);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nt][e] = pr[nt][e] * (ds[nt][e] - sd[e >> 1].y) * p.scale;
    }
    // dQ' += dS K'
    product<D>(dq, ds, sK, c0);
  }

  store_rows<D>(p.dq + bh * p.n * D, dq, q0 + wr, c0, p.n, head_table(p, p.cos, h), p.sin);
}

template <int D>
cudaError_t launch_mma(const BwdParams& p, int b, cudaStream_t stream) {
  const int smem = 4 * BM * Shape<D>::LD * static_cast<int>(sizeof(__nv_bfloat16)) +
                   BM * static_cast<int>(sizeof(float2));
  static std::atomic<bool> dkdv_raised[MAX_DEVICES], dq_raised[MAX_DEVICES];
  cudaError_t err = raise_smem_limit(reinterpret_cast<const void*>(flash_bwd_dkdv_kernel<D>), smem, dkdv_raised);
  if (err == cudaSuccess) {
    err = raise_smem_limit(reinterpret_cast<const void*>(flash_bwd_dq_kernel<D>), smem, dq_raised);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + BM - 1) / BM, p.h, b);
  flash_bwd_dkdv_kernel<D><<<grid, Shape<D>::THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D><<<grid, Shape<D>::THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The pre-pass, then the main kernels of d: the single pass and its dQ
// conversion at d = 64, the TMA + wgmma pair at d = 128, the mma.sync pair at
// d = 256 (chosen by d, see above).
template <int D>
cudaError_t launch(const BwdParams& p, int b, cudaStream_t stream) {
  const long long rows = static_cast<long long>(b) * p.h * prepass_rows(p);
  const long long threads = rows * (D / 8);
  flash_bwd_prepass_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0, stream>>>(p, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (D == 256) {
    return launch_mma<D>(p, b, stream);
  } else if constexpr (D == 64) {
    return launch_pass(p, b, stream);
  } else {
    return launch_wgmma<D>(p, b, stream);
  }
}

// ---------------------------------------------------------------- float32
// ------------------------------------------ d = 128 and 256: FMA

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
  const float2* stats = p.stats + bh * p.n_pad;
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
    if (threadIdx.x < F_BM) {  // rows past n: (FLT_MAX, 0), P = 0
      const float2 sd = stats[q0 + threadIdx.x];
      sLse[threadIdx.x] = sd.x;
      sDelta[threadIdx.x] = sd.y;
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
  const float2 sd = p.stats[bh * p.n_pad + row];  // (FLT_MAX, 0) past n
  const float lse = sd.x, delta = sd.y;

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
  static std::atomic<bool> dkdv_raised[MAX_DEVICES], dq_raised[MAX_DEVICES];
  cudaError_t err = raise_smem_limit(reinterpret_cast<const void*>(flash_bwd_dkdv_f32_kernel<D>), smem, dkdv_raised);
  if (err == cudaSuccess) {
    err = raise_smem_limit(reinterpret_cast<const void*>(flash_bwd_dq_f32_kernel<D>), smem, dq_raised);
  }
  if (err != cudaSuccess) return err;
  const dim3 grid((p.n + F_BM - 1) / F_BM, h, b);
  flash_bwd_dkdv_f32_kernel<D><<<grid, F_THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_kernel<D><<<grid, F_THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------ d = 64: 3xTF32, TMA + wgmma

// 64 owned rows, two owned operands (hi and lo). Two consumer warpgroups work
// on the same 64 rows and take the streamed tiles in turn (tile i from stage
// i % 2), so the SM has two warpgroups' work to overlap without more shared
// memory. No producer warp: each warpgroup refills its own stage, so the
// block is 8 warps, two on each of the SM's four sub-partitions, and a
// thread may hold 255 registers (a ninth warp puts three warps on one
// sub-partition and caps every thread at 168, where the dK/dV kernel spills).
using BwdTc = TcShape<1, 4>;
constexpr int BWD_TC_THREADS = 2 * BwdTc::CONSUMERS;

__device__ __forceinline__ void tc_init_barriers(uint64_t* own, uint64_t* full) {
  if (threadIdx.x == 0) {
    mbar_init(own, 1);
    for (int s = 0; s < BwdTc::STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// The owned rows' four tiles (two operands, hi and lo), once; one thread.
__device__ __forceinline__ void tc_load_owned(unsigned char* smem, uint64_t* own, const CUtensorMap* const (&maps)[4],
                                              int row0, int h, int b) {
  mbar_arrive_expect_tx(own, 4 * BwdTc::OWN);
  for (int i = 0; i < 4; ++i) {
    for (int pn = 0; pn < 2; ++pn) {
      tma_load_4d(smem + i * BwdTc::OWN + pn * BwdTc::OWN_PANEL, maps[i], own, pn * 32, row0, h, b);
    }
  }
}

// Streamed tile `it` into stage `st`: four tiles (two operands, hi and lo)
// and `extra_bytes` of row stats or key biases from `extra` (extra_bytes a
// tile); one thread.
__device__ __forceinline__ void tc_load_tile(unsigned char* st, uint64_t* full, const CUtensorMap* const (&maps)[4],
                                             const unsigned char* extra, int extra_bytes, int it, int h, int b) {
  mbar_arrive_expect_tx(full, 4 * BwdTc::TILE + extra_bytes);
  for (int i = 0; i < 4; ++i) {
    for (int pn = 0; pn < 2; ++pn) {
      tma_load_4d(st + i * BwdTc::TILE + pn * TC_PANEL, maps[i], full, pn * 32, it * TC_BM, h, b);
    }
  }
  bulk_load(st + 4 * BwdTc::TILE, extra + static_cast<long long>(it) * extra_bytes, extra_bytes, full);
}

// After a warpgroup's tile `it`: once all its threads are done with the
// stage, its first thread loads tile it + 2 there.
__device__ __forceinline__ void tc_refill(unsigned char* st, uint64_t* full, const CUtensorMap* const (&maps)[4],
                                          const unsigned char* extra, int extra_bytes, int it, int tiles, int h,
                                          int b) {
  if (it + 2 >= tiles) return;
  bar_sync(2 + threadIdx.x / 128, 128);
  if (threadIdx.x % 128 == 0) tc_load_tile(st, full, maps, extra, extra_bytes, it + 2, h, b);
}

// Store a warp's share of a [64 x 64] float32 accumulator (rows row0 + g and
// row0 + g + 8 of a contiguous [n, 64] head), with the RoPE backward when
// tables are given (row i by table row t_off + i): dx[2j] = dx'[2j] c[2j] +
// dx'[2j+1] s[2j+1], dx[2j+1] = dx'[2j+1] c[2j+1] - dx'[2j] s[2j], each
// product and sum rounded once, as the plain version.
__device__ __forceinline__ void tc_store(float* out, const float (&acc)[32], int row0, int n, const float* cos,
                                         const float* sin, int t_off) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + g + 8 * hi;
    if (row >= n) continue;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const int col = 8 * nb + 2 * t;
      const long long o = static_cast<long long>(row) * TC_D + col;
      float x0 = acc[4 * nb + 2 * hi], x1 = acc[4 * nb + 2 * hi + 1];
      if (cos != nullptr) {
        const long long ot = static_cast<long long>(row + t_off) * TC_D + col;
        const float2 c = *reinterpret_cast<const float2*>(cos + ot), sn = *reinterpret_cast<const float2*>(sin + ot);
        const float y0 = __fadd_rn(__fmul_rn(x0, c.x), __fmul_rn(x1, sn.y));
        const float y1 = __fsub_rn(__fmul_rn(x1, c.y), __fmul_rn(x0, sn.x));
        x0 = y0;
        x1 = y1;
      }
      *reinterpret_cast<float2*>(out + o) = make_float2(x0, x1);
    }
  }
}

// Sum the second warpgroup's accumulator into the first's, in a fixed order
// (deterministic): once every warp is past its last tile (a warp still reads
// the whole stage for its B fragments, so the stage is free only then), the
// second writes it to slot `slot` of its stage, and the first adds it after
// a second barrier.
template <int N>
__device__ __forceinline__ void tc_sum_split(unsigned char* smem, float (&acc)[N], int slot) {
  using S = BwdTc;
  static_assert(2 * N * 128 * 4 <= S::STAGE, "two slots of partial sums fit in a stage");
  float* part = reinterpret_cast<float*>(smem + 4 * S::OWN + S::STAGE) + slot * N * 128;  // stage 1
  const int tid = threadIdx.x % 128;
  bar_sync(1, BWD_TC_THREADS);
  if (threadIdx.x >= 128) {
#pragma unroll
    for (int i = 0; i < N; ++i) part[i * 128 + tid] = acc[i];
  }
  bar_sync(1, BWD_TC_THREADS);
  if (threadIdx.x < 128) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += part[i * 128 + tid];
  }
}

// dK, dV for 64 keys. Owned: K' and V (hi, lo); streamed: Q' and g (hi,
// lo) and the row stats of each 64-query tile. S^T = K' Q'^T and
// dP^T = V g^T as wgmma (both operands K-major), P^T and dS^T in registers,
// then dV += P^T g and dK' += dS^T Q' as mma.sync with g and Q' read from
// the stage. The two warpgroups take the query tiles in turn.
__global__ void __launch_bounds__(BWD_TC_THREADS, 1)
flash_bwd_dkdv_f32_tc_kernel(const __grid_constant__ CUtensorMap qh_map, const __grid_constant__ CUtensorMap ql_map,
                             const __grid_constant__ CUtensorMap kh_map, const __grid_constant__ CUtensorMap kl_map,
                             const __grid_constant__ CUtensorMap vh_map, const __grid_constant__ CUtensorMap vl_map,
                             const __grid_constant__ CUtensorMap gh_map, const __grid_constant__ CUtensorMap gl_map,
                             const Params<float> p) {
  using S = BwdTc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);  // K' hi, K' lo, V hi, V lo, then the stages
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* full = own + 1;
  const int k0 = blockIdx.x * S::ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  const int tiles = (p.n + TC_BM - 1) / TC_BM;  // query tiles
  const int split = threadIdx.x / 128;  // this warpgroup takes tiles split, split + 2, ... into stage split
  unsigned char* st = smem + 4 * S::OWN + split * S::STAGE;  // Q' hi, Q' lo, g hi, g lo, row stats
  // the maps stay in parameter space, where TMA reads them
  const CUtensorMap* const streamed[4] = {&qh_map, &ql_map, &gh_map, &gl_map};
  const unsigned char* stats_src = reinterpret_cast<const unsigned char*>(p.stats + bh * p.n_pad);
  tc_init_barriers(own, full);
  if (threadIdx.x == 0) {
    const CUtensorMap* const owned[4] = {&kh_map, &kl_map, &vh_map, &vl_map};
    tc_load_owned(smem, own, owned, k0, h, b);
  }
  if (threadIdx.x % 128 == 0 && split < tiles) tc_load_tile(st, &full[split], streamed, stats_src, TC_BM * 8, split, h, b);

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = (threadIdx.x / 32 % 4) * 16;  // this warp's first key in the block
  const float* kbias = p.kbias + static_cast<long long>(b) * p.nk_pad + k0 + row0 + g;
  const float bias[2] = {kbias[0], kbias[8]};  // keys row0 + g and row0 + g + 8
  const float inv_n = 1.f / p.nk;

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(own, 0);
  const uint64_t kh = sw128_desc(smem), kl = sw128_desc(smem + S::OWN);
  const uint64_t vh = sw128_desc(smem + 2 * S::OWN), vl = sw128_desc(smem + 3 * S::OWN);

  for (int it = split; it < tiles; it += 2) {
    mbar_wait(&full[split], (it / 2) & 1);
    const float2* stats = reinterpret_cast<const float2*>(st + 4 * S::TILE);

    float sc[32], dp[32];
    wgmma_fence();
    scores_3xtf32(sc, kh, kl, S::OWN_PANEL, sw128_desc(st), sw128_desc(st + S::TILE));
    scores_3xtf32(dp, vh, vl, S::OWN_PANEL, sw128_desc(st + 2 * S::TILE), sw128_desc(st + 3 * S::TILE));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // P^T = exp(s + bias - lse); dS^T = P^T (dP^T - delta) scale
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 sd = stats[8 * i + 2 * t + (e & 1)];
        const float pr = prob_f32(sc[4 * i + e] * p.scale, bias[e >> 1], sd.x, inv_n);
        sc[4 * i + e] = pr;
        dp[4 * i + e] = pr * (dp[4 * i + e] - sd.y) * p.scale;
      }
    }
    pv_3xtf32(dv, sc, st + 2 * S::TILE, st + 3 * S::TILE);  // dV += P^T g
    pv_3xtf32(dk, dp, st, st + S::TILE);                    // dK' += dS^T Q'
    tc_refill(st, &full[split], streamed, stats_src, TC_BM * 8, it, tiles, h, b);
  }

  tc_sum_split(smem, dk, 0);
  tc_sum_split(smem, dv, 1);
  if (split == 0) {
    tc_store(p.dk + bh * p.nk * TC_D, dk, k0 + row0, p.nk, p.cos, p.sin, 0);
    tc_store(p.dv + bh * p.nk * TC_D, dv, k0 + row0, p.nk, nullptr, nullptr, 0);
  }
}

// dQ for 64 queries. Owned: Q' and g (hi, lo); streamed: K' and V (hi, lo)
// and the key biases of each 64-key tile. S = Q' K'^T and dP = g V^T as
// wgmma, P and dS in registers, dQ' += dS K' as mma.sync with K' read from
// the stage. The two warpgroups take the key tiles in turn.
__global__ void __launch_bounds__(BWD_TC_THREADS, 1)
flash_bwd_dq_f32_tc_kernel(const __grid_constant__ CUtensorMap qh_map, const __grid_constant__ CUtensorMap ql_map,
                           const __grid_constant__ CUtensorMap kh_map, const __grid_constant__ CUtensorMap kl_map,
                           const __grid_constant__ CUtensorMap vh_map, const __grid_constant__ CUtensorMap vl_map,
                           const __grid_constant__ CUtensorMap gh_map, const __grid_constant__ CUtensorMap gl_map,
                           const Params<float> p) {
  using S = BwdTc;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);  // Q' hi, Q' lo, g hi, g lo, then the stages
  uint64_t* own = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* full = own + 1;
  const int q0 = blockIdx.x * S::ROWS;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * gridDim.y + h;
  const int tiles = (p.nk + TC_BM - 1) / TC_BM;  // key tiles
  const int split = threadIdx.x / 128;  // this warpgroup takes tiles split, split + 2, ... into stage split
  unsigned char* st = smem + 4 * S::OWN + split * S::STAGE;  // K' hi, K' lo, V hi, V lo, key biases
  const CUtensorMap* const streamed[4] = {&kh_map, &kl_map, &vh_map, &vl_map};
  const unsigned char* bias_src = reinterpret_cast<const unsigned char*>(p.kbias + static_cast<long long>(b) * p.nk_pad);
  tc_init_barriers(own, full);
  if (threadIdx.x == 0) {
    const CUtensorMap* const owned[4] = {&qh_map, &ql_map, &gh_map, &gl_map};
    tc_load_owned(smem, own, owned, q0, h, b);
  }
  if (threadIdx.x % 128 == 0 && split < tiles) tc_load_tile(st, &full[split], streamed, bias_src, TC_BM * 4, split, h, b);

  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = (threadIdx.x / 32 % 4) * 16;  // this warp's first query in the block
  const float2* rs = p.stats + bh * p.n_pad + q0 + row0 + g;
  const float2 sd[2] = {rs[0], rs[8]};  // rows row0 + g and row0 + g + 8
  const float inv_n = 1.f / p.nk;

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  mbar_wait(own, 0);
  const uint64_t qh = sw128_desc(smem), ql = sw128_desc(smem + S::OWN);
  const uint64_t gh = sw128_desc(smem + 2 * S::OWN), gl = sw128_desc(smem + 3 * S::OWN);

  for (int it = split; it < tiles; it += 2) {
    mbar_wait(&full[split], (it / 2) & 1);
    const float* kb = reinterpret_cast<const float*>(st + 4 * S::TILE);

    float sc[32], dp[32];
    wgmma_fence();
    scores_3xtf32(sc, qh, ql, S::OWN_PANEL, sw128_desc(st), sw128_desc(st + S::TILE));
    scores_3xtf32(dp, gh, gl, S::OWN_PANEL, sw128_desc(st + 2 * S::TILE), sw128_desc(st + 3 * S::TILE));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    // dS = P (dP - delta) scale, P = exp(s + bias - lse)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pr = prob_f32(sc[4 * i + e] * p.scale, kb[8 * i + 2 * t + (e & 1)], sd[e >> 1].x, inv_n);
        dp[4 * i + e] = pr * (dp[4 * i + e] - sd[e >> 1].y) * p.scale;
      }
    }
    pv_3xtf32(dq, dp, st, st + S::TILE);  // dQ' += dS K'
    tc_refill(st, &full[split], streamed, bias_src, TC_BM * 4, it, tiles, h, b);
  }

  tc_sum_split(smem, dq, 0);
  if (split == 0) tc_store(p.dq + bh * p.n * TC_D, dq, q0 + row0, p.n, p.cos, p.sin, p.q_off);
}

cudaError_t launch_f32_tc(const Params<float>& p, const TcPrep& pp, int b, int h, cudaStream_t stream) {
  CUtensorMap maps[8];
  const float* halves[8] = {pp.qh, pp.ql, pp.kh, pp.kl, pp.vh, pp.vl, pp.gh, pp.gl};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 8 && err == cudaSuccess; ++i) {
    err = tc_head_map(&maps[i], halves[i], b, h, i < 2 || i >= 6 ? p.n : p.nk);  // q' and g: the query rows
  }
  if (err != cudaSuccess) return err;
  static std::atomic<bool> dkdv_raised[MAX_DEVICES], dq_raised[MAX_DEVICES];
  err = raise_smem_limit(reinterpret_cast<const void*>(flash_bwd_dkdv_f32_tc_kernel), BwdTc::SMEM, dkdv_raised);
  if (err == cudaSuccess) {
    err = raise_smem_limit(reinterpret_cast<const void*>(flash_bwd_dq_f32_tc_kernel), BwdTc::SMEM, dq_raised);
  }
  if (err != cudaSuccess) return err;
  const dim3 keys((p.nk + BwdTc::ROWS - 1) / BwdTc::ROWS, h, b);
  const dim3 queries((p.n + BwdTc::ROWS - 1) / BwdTc::ROWS, h, b);
  flash_bwd_dkdv_f32_tc_kernel<<<keys, BWD_TC_THREADS, BwdTc::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                                              maps[4], maps[5], maps[6], maps[7], p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_f32_tc_kernel<<<queries, BWD_TC_THREADS, BwdTc::SMEM, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                                                            maps[4], maps[5], maps[6], maps[7], p);
  return cudaGetLastError();
}

// The float32 backward: the pre-pass (at every d: the row stats and key
// biases; at d = 64 also the TF32 halves), then the 3xTF32 kernels at d = 64
// or the FMA kernels at d = 128 and 256.
template <int D>
cudaError_t launch_f32_all(Params<float>& p, TcPrep& pp, float* scratch, int b, int h, cudaStream_t stream) {
  tc_carve(pp, scratch, b, true, D == TC_D ? 8 : 0);
  p.stats = pp.stats;
  p.kbias = pp.kbias;
  const cudaError_t err = launch_tc_prep<D>(pp, b, stream);
  if (err != cudaSuccess) return err;
  if constexpr (D == TC_D) {
    return launch_f32_tc(p, pp, b, h, stream);
  } else {
    return launch_f32<D>(p, b, h, stream);
  }
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launches (0 on success). The bf16 backward:
// q, g and out are [b, h, n, d], k and v [b, h, nk, d], with (batch, head,
// row) strides in elements in `strides` (q, k, v, g, out in turn) and a
// contiguous head dim; lse is contiguous float32 [b, h, n], the mask
// [b, nk], the tables [nk, d] (query row i takes row q_off + i, with
// q_off + n <= nk). Scratch the caller allocates: qr bf16 [b, h, n, d], kr
// bf16 [b, h, nk, d], stats float32 [b, h, n_pad, 2] and kbias float32
// [b, nk_pad], n_pad and nk_pad = n and nk rounded up to a multiple of 128.
// dq is contiguous bf16 [b, h, n, d], dk and dv [b, h, nk, d]. At d = 64
// `dq_scratch` holds the pass's dQ' sums, float32 [b, h, tiles, 64 x 64]
// with tiles = ceil(n / 64), then b h tiles + 1 int32 counters (the pre-pass
// sets them); it is null at d = 128 and 256. At d = 256, nk = n and
// q_off = 0. Heads 0 .. rope_heads - 1 are rotated (0 <= rope_heads <= h),
// the others not.
int f5_flash_attention_bwd(const void* q, const void* k, const void* v, const void* g, const void* out,
                           const void* lse, const void* mask, const void* cos, const void* sin, void* qr, void* kr,
                           void* stats, void* kbias, void* dq, void* dk, void* dv, void* dq_scratch, int b, int h,
                           int n, int nk, int q_off, int d, int rope_heads, const long long* strides, float scale,
                           void* stream) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.g = static_cast<const __nv_bfloat16*>(g);
  p.out = static_cast<const __nv_bfloat16*>(out);
  p.lse = static_cast<const float*>(lse);
  p.mask = static_cast<const uint8_t*>(mask);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.qr = static_cast<__nv_bfloat16*>(qr);
  p.kr = static_cast<__nv_bfloat16*>(kr);
  p.stats = static_cast<float2*>(stats);
  p.kbias = static_cast<float*>(kbias);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dq_acc = nullptr;
  p.dq_count = p.dq_ticket = nullptr;
  p.key_blocks = p.key_tiles = p.dq_rotate = 0;
  if (d == 64 && dq_scratch != nullptr) {
    const long long sums = static_cast<long long>(b) * h * ((n + BM - 1) / BM);
    p.dq_acc = static_cast<float*>(dq_scratch);
    p.dq_count = reinterpret_cast<int*>(p.dq_acc + sums * BM * 64);
    p.dq_ticket = p.dq_count + sums;
  }
  p.h = h;
  p.n = n;
  p.n_pad = (n + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  p.nk = nk;
  p.nk_pad = (nk + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
  p.q_off = q_off;
  p.rope_heads = rope_heads;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_sn = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_sn = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_sn = strides[8];
  p.g_sb = strides[9]; p.g_sh = strides[10]; p.g_sn = strides[11];
  p.o_sb = strides[12]; p.o_sh = strides[13]; p.o_sn = strides[14];
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || nk < 1 || q_off < 0 || (cos != nullptr && q_off + n > nk) || (d == 256 && (nk != n || q_off != 0)) ||
      rope_heads < 0 || rope_heads > h || (d == 64) != (dq_scratch != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 64: return static_cast<int>(launch<64>(p, b, s));
    case 128: return static_cast<int>(launch<128>(p, b, s));
    case 256: return static_cast<int>(launch<256>(p, b, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The float32 kernels. Returns the cudaError_t of the launches (0 on
// success). The shapes, strides and tables of f5_flash_attention_bwd; a
// query block (nk != n or q_off != 0) at d = 64 only. `scratch` is the
// pre-pass's float32 scratch (`tc_carve`, csrc/tf32.cuh: the row stats, key
// biases and, at d = 64, the TF32 halves); dq is contiguous float32
// [b, h, n, d], dk and dv [b, h, nk, d].
int f5_flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* g, const void* out,
                               const void* lse, const void* mask, const void* cos, const void* sin, void* scratch,
                               void* dq, void* dk, void* dv, int b, int h, int n, int nk, int q_off, int d,
                               const long long* strides, float scale, void* stream) {
  Params<float> p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.g = static_cast<const float*>(g);
  p.mask = static_cast<const uint8_t*>(mask);
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.n = n;
  p.n_pad = align_up(n, TC_ROW_PAD);
  p.nk = nk;
  p.nk_pad = align_up(nk, TC_ROW_PAD);
  p.q_off = q_off;
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_sn = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_sn = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_sn = strides[8];
  p.g_sb = strides[9]; p.g_sh = strides[10]; p.g_sn = strides[11];
  p.scale = scale;
  TcPrep pp{};
  pp.q = p.q;
  pp.k = p.k;
  pp.v = p.v;
  pp.g = p.g;
  pp.out = static_cast<const float*>(out);
  pp.lse = static_cast<const float*>(lse);
  pp.mask = p.mask;
  pp.cos = p.cos;
  pp.sin = p.sin;
  pp.h = h;
  pp.n = n;
  pp.n_pad = p.n_pad;
  pp.nk = nk;
  pp.nk_pad = p.nk_pad;
  pp.q_off = q_off;
  pp.q_sb = p.q_sb; pp.q_sh = p.q_sh; pp.q_sn = p.q_sn;
  pp.k_sb = p.k_sb; pp.k_sh = p.k_sh; pp.k_sn = p.k_sn;
  pp.v_sb = p.v_sb; pp.v_sh = p.v_sh; pp.v_sn = p.v_sn;
  pp.g_sb = p.g_sb; pp.g_sh = p.g_sh; pp.g_sn = p.g_sn;
  pp.o_sb = strides[12]; pp.o_sh = strides[13]; pp.o_sn = strides[14];
  float* sc = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || nk < 1 || q_off < 0 || (cos != nullptr && q_off + n > nk) || (d != TC_D && (nk != n || q_off != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (d) {
    case 64: return static_cast<int>(launch_f32_all<64>(p, pp, sc, b, h, s));
    case 128: return static_cast<int>(launch_f32_all<128>(p, pp, sc, b, h, s));
    case 256: return static_cast<int>(launch_f32_all<256>(p, pp, sc, b, h, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* f5_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
