// Weight-only int4/int8 dequantizing matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package: f5_tts_tpu/ops/qmatmul.py,
// `_qmm_call` (kernel body `_qmm_kernel`, wrapper `qmatmul`). It computes the
// same function:
//   y[m, n] = x[m, k] @ W[k, n] (+ bias[n]),
//   W[k, n] = q[n, k] * scales[n, k / 64] + biases[n, k / 64],
// with each weight dequantized in float32 from the stored scales and biases
// (q * s, then + b, each rounded once, as the plain version does), rounded
// to x's dtype, multiplied with float32 accumulation, and written in x's
// dtype. The linear's bias, when given, is added to that rounded output and
// rounded again, as `y + bias` after the matmul would be. The codes are int8
// (int4 codes are stored one per byte, centred by -8); the layout is
// PyTorch's [out, in] for q and [out, in / 64] for the scales and biases, so
// one output column's k-run is contiguous.
//
// What bounds it on this card. At the main path's m = 2048 a linear does
// 2 m k n FLOP against k n bytes of codes, far above the ridge point: it is
// compute-bound, and only wgmma reaches the tensor cores' full rate. The
// first version staged x and the codes with plain loads, dequantized into
// shared memory and ran mma.sync, so loads, dequantization and products
// never overlapped (96 TFLOP/s against cuBLAS's 288 on the same product).
// At the time-conditioning linears' m = 31 the kernel is bound by the bytes
// of the codes, and a 64-row token tile wasted half its rows. The TPU kernel
// held whole [k, 512] weight slabs in VMEM; here W streams through shared
// memory one 64-wide quantization group at a time.
//
// Design, bf16 activations (qmm_wgmma_kernel): the operands are swapped,
// y^T = W x^T, so the weight is wgmma's A operand (64 output columns per
// block, one consumer warpgroup) and the activations its B operand (TN
// tokens, 32, 64 or 128 by m, so m = 31 wastes one row of 32, not 33 of
// 64). A producer warp keeps a ring of 4 to 8 stages filled by TMA: each
// stage holds the x tile [TN][64] (128-byte swizzle, the K-major B layout)
// and the int8 code tile [64][64] (64-byte swizzle, so the consumers' 16-bit
// fragment reads hit 16 distinct banks), with a full and an empty mbarrier.
// The consumer warpgroup dequantizes the code tile straight into wgmma's
// A-fragment registers (q * s, then + b, in float32 with round-to-nearest,
// then one bf16 rounding: the plain version's rounding) with the group's
// scale and bias read one stage ahead, and runs wgmma.m64nTNk16 with A from
// registers. The epilogue rounds to bf16, adds the bias, rounds again, and
// writes y through a shared-memory tile so the transposed accumulator is
// stored as coalesced rows. The tensor maps are kept per host thread, keyed
// on the tensor's address and shape: the codes' map once per weight, x's
// for every activation buffer seen (PyTorch's caching allocator hands the
// same buffers out again and again). Scales and biases are read
// by the consumers directly (two of each per thread and stage), not by TMA.
// Rows past m and columns past n arrive as TMA's zero fill and are not
// written, so any m >= 1 and any n are taken; k must be a multiple of 64.
//
// Design, float32 activations (qmm_tf32_kernel): the product is float32-
// accurate 3xTF32 on the tensor cores (csrc/tf32.cuh explains the split),
// bound at [2048, 1024, 1024] by 3 x 2 m k n TF32 operations (26 us at
// 495 / 3 TFLOP/s). The first version was a SIMT FMA tile that staged x
// transposed with scalar loads (bank conflicts, two __syncthreads a k step,
// nothing overlapped): 10x that bound and slower than its plain version.
// This one keeps the bf16 kernel's orientation, since TF32 wgmma takes its
// operands K-major only and both W [n, k] and x [m, k] are K-major:
//   - the weight is A, from registers: each code is dequantized exactly as
//     above (in float32, not rounded to bf16), split into TF32 hi and lo
//     A fragments, and multiplied by wgmma.m64nTNk8.tf32. Codes become floats
//     and values are split without conversion instructions (integer and
//     float32 operations only), which run at a fraction of those rates;
//   - x is B, from shared memory: a producer warp fills a ring of stages by
//     TMA (x [TN][64] float32 as two 128-byte swizzled 32-column panels, and
//     the code tiles), with full and empty mbarriers as above. The consumers
//     split each landed x tile in shared memory, hi in place and lo into one
//     of two lo tiles, fence the writes to the async proxy and sync, so
//     wgmma reads both halves; the next tile is split while a stage's
//     products run. A per-call split pre-pass would move about 24 MB at
//     m = 2048 and add a launch and fresh tensor maps to the m = 31 calls;
//   - per k8 step lo_W hi_x, hi_W lo_x, then hi_W hi_x, float32 sums; each
//     k8 step's A fragments are dequantized while the steps before it run;
//   - a block has one consumer warpgroup (64 weight rows) or two that share
//     each x tile and its split (x is then read from L2 and split half as
//     often), and a token tile of 32, 64 or 128. A block's time grows far
//     less than its work, so the plan (ops/qmatmul.py `plan_f32`) takes the
//     most work a block that still leaves about three quarters of a wave of
//     blocks: two warpgroups and 128 tokens at the DiT blocks' m = 2048,
//     one and 32 tokens at m = 31;
//   - the epilogue adds the linear's bias in float32 and writes y's rows
//     through a shared-memory tile. The float32 x maps have caches of their
//     own (f5_qmatmul_x32_maps_encoded counts them).
//
// The scales and biases may be float32 or bf16 (a bf16 model casts them with
// its other float tensors); they are read as float32 either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <unordered_map>

#include "hopper.cuh"
#include "mma_bf16.cuh"
#include "tf32.cuh"

namespace {

constexpr int GROUP = 64;  // quantization group along k

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float dequant(int8_t code, float s, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(code), s), b);
}

// ------------------------------------------------------------- bf16, TMA + wgmma

constexpr int W_ROWS = 64;  // weight rows (output columns) per block: one consumer warpgroup
constexpr int W_CONSUMERS = 128;
constexpr int W_THREADS = W_CONSUMERS + 32;  // warps 0-3 consume, warp 4 produces
constexpr int EPI_LD = W_ROWS + 8;           // bf16 row stride of the epilogue tile

// Shared memory of the bf16 kernel for TN tokens per block: a ring of
// stages, each an x tile [TN][64] bf16 (128-byte swizzled rows, written by
// TMA) and a code tile [64][64] int8 (64-byte swizzled rows), then the
// epilogue tile [TN][EPI_LD] bf16 and the full / empty barriers.
template <int TN>
struct QmmTile {
  static constexpr int STAGES = TN >= 128 ? 4 : 8;
  static constexpr int X_BYTES = TN * GROUP * 2;
  static constexpr int W_BYTES = W_ROWS * GROUP;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;  // a multiple of 1024
  static constexpr int EPI_OFF = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = align_up(EPI_OFF + TN * EPI_LD * 2, 8);
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + slack to align the base to 1024
};

// The byte offset of code (row r, k c) in a 64-byte-swizzled [64][64] int8
// tile: TMA's 64-byte swizzle XORs the 16-byte chunk index (address bits
// 4-5) with address bits 7-8, here (r / 2) % 4.
__device__ __forceinline__ int code_offset(int r, int c) {
  return r * GROUP + ((((c >> 4) ^ (r >> 1)) & 3) << 4) + (c & 15);
}

__device__ __forceinline__ uint32_t dequant_pair(const unsigned char* tile, int r, int c, float s, float b) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(tile + code_offset(r, c));
  return pack_f32(dequant(static_cast<int8_t>(v & 0xff), s, b), dequant(static_cast<int8_t>(v >> 8), s, b));
}

// y^T tile [64 output columns][TN tokens] = W x^T: the dequantized weight is
// wgmma's A operand (registers), the x tile its B operand (shared memory,
// K-major, since x is [m, k] row-major). Warp 4's lane 0 keeps the ring of
// stages filled with TMA copies; warps 0-3 wait for a stage, dequantize the
// 64 x 64 code tile into A fragments (each k step of 64 is one quantization
// group, so a row needs one scale and one bias per stage), run four
// wgmma.m64nTNk16, and release the stage.
template <int TN, typename ST>
__global__ void __launch_bounds__(W_THREADS)
qmm_wgmma_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap q_map,
                 const ST* __restrict__ scales, const ST* __restrict__ biases,
                 const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, int m, int n, int k) {
  using T = QmmTile<TN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int n0 = blockIdx.x * W_ROWS;
  const int m0 = blockIdx.y * TN;
  const int groups = k / GROUP;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == W_CONSUMERS / 32) {  // producer
    if (lane == 0) {
      for (int kb = 0; kb < groups; ++kb) {
        const int s = kb % STAGES;
        if (kb >= STAGES) mbar_wait(&empty[s], (kb / STAGES - 1) & 1);
        unsigned char* stage = smem + s * T::STAGE_BYTES;
        mbar_arrive_expect_tx(&full[s], T::STAGE_BYTES);
        tma_load_2d(stage, &x_map, &full[s], kb * GROUP, m0);
        tma_load_2d(stage + T::X_BYTES, &q_map, &full[s], kb * GROUP, n0);
      }
    }
    return;
  }

  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's weight rows in the tile: r0 and r0 + 8
  const int col0 = n0 + r0, col1 = col0 + 8;
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;

  // this group's scale and bias for the thread's two rows; rows past n read
  // nothing (their codes are TMA's zero fill and their outputs are dropped)
  auto group_sb = [&](int kb, float (&sb)[4]) {
    sb[0] = col0 < n ? load_f32(scales + static_cast<long long>(col0) * groups + kb) : 0.f;
    sb[1] = col0 < n ? load_f32(biases + static_cast<long long>(col0) * groups + kb) : 0.f;
    sb[2] = col1 < n ? load_f32(scales + static_cast<long long>(col1) * groups + kb) : 0.f;
    sb[3] = col1 < n ? load_f32(biases + static_cast<long long>(col1) * groups + kb) : 0.f;
  };
  float next[4];
  group_sb(0, next);

  for (int kb = 0; kb < groups; ++kb) {
    const int s = kb % STAGES;
    const float sb[4] = {next[0], next[1], next[2], next[3]};
    if (kb + 1 < groups) group_sb(kb + 1, next);  // in flight while this stage is processed
    mbar_wait(&full[s], (kb / STAGES) & 1);
    const unsigned char* stage = smem + s * T::STAGE_BYTES;
    const unsigned char* codes = stage + T::X_BYTES;

    // A fragments of the four k16 steps: a0 (row r0, k 2t), a1 (r0 + 8, 2t),
    // a2 (r0, 2t + 8), a3 (r0 + 8, 2t + 8), dequantized q * s + b in float32
    // and rounded once to bf16
    uint32_t a[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const int c = kc * 16 + 2 * t;
      a[kc][0] = dequant_pair(codes, r0, c, sb[0], sb[1]);
      a[kc][1] = dequant_pair(codes, r0 + 8, c, sb[2], sb[3]);
      a[kc][2] = dequant_pair(codes, r0, c + 8, sb[0], sb[1]);
      a[kc][3] = dequant_pair(codes, r0 + 8, c + 8, sb[2], sb[3]);
    }
    const uint64_t x_desc = sw128_desc(stage);
    wgmma_fence();
    fence_regs(acc);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs<0>(acc, a[kc], x_desc + (kc * 32 >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[s]);
  }

  // Epilogue: round to bf16, add the linear's bias in bf16 and round again,
  // stage y's tile [TN tokens][64 columns] in shared memory, then write it
  // row by row so the stores are coalesced.
  __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(smem + T::EPI_OFF);
#pragma unroll
  for (int i = 0; i < TN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1);
      const int tok = 8 * i + 2 * t + (e & 1);
      __nv_bfloat16 out = __float2bfloat16(acc[4 * i + e]);
      if (bias != nullptr && n0 + r < n) out = __float2bfloat16(__bfloat162float(out) + __bfloat162float(bias[n0 + r]));
      epi[tok * EPI_LD + r] = out;
    }
  }
  bar_sync(1, W_CONSUMERS);
  if (n % 8 == 0) {  // 16-byte rows of 8 columns, each wholly inside or outside [0, n)
    for (int i = threadIdx.x; i < TN * (W_ROWS / 8); i += W_CONSUMERS) {
      const int tok = i / (W_ROWS / 8), c = (i % (W_ROWS / 8)) * 8;
      if (m0 + tok < m && n0 + c < n) {
        *reinterpret_cast<uint4*>(y + static_cast<long long>(m0 + tok) * n + n0 + c) =
            *reinterpret_cast<const uint4*>(epi + tok * EPI_LD + c);
      }
    }
  } else {
    for (int i = threadIdx.x; i < TN * W_ROWS; i += W_CONSUMERS) {
      const int tok = i / W_ROWS, c = i % W_ROWS;
      if (m0 + tok < m && n0 + c < n) y[static_cast<long long>(m0 + tok) * n + n0 + c] = epi[tok * EPI_LD + c];
    }
  }
}

// ------------------------------------------------------------- float32, 3xTF32 TMA + wgmma

// Shared memory of the float32 kernel for TN tokens and WGS consumer
// warpgroups of 64 weight rows each: a ring of stages, each an x tile
// [TN][64] float32 as two 32-column panels (128-byte swizzled rows, written
// by TMA; the consumers overwrite it in place with its TF32 hi half) and WGS
// code tiles [64][64] int8 (64-byte swizzle); then two lo tiles in the x
// tile's layout, taken in turn, and the full / empty barriers. The epilogue
// tile [TN][EPI_LD] float32 reuses the ring.
template <int TN, int WGS>
struct QmmTf32Tile {
  static constexpr int ROWS = W_ROWS * WGS;  // weight rows (output columns) per block
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  static constexpr int STAGES = TN == 32 ? 8 : TN == 64 ? 4 : 3;
  static constexpr int PANEL = TN * 128;  // one 32-column panel of an x tile
  static constexpr int X_BYTES = 2 * PANEL;
  static constexpr int W_BYTES = W_ROWS * GROUP;
  static constexpr int STAGE_BYTES = X_BYTES + WGS * W_BYTES;  // a multiple of 1024
  static constexpr int LO_OFF = STAGES * STAGE_BYTES;
  static constexpr int EPI_LD = ROWS + 4;  // float32 row stride of the epilogue tile
  static constexpr int BAR_OFF = LO_OFF + 2 * X_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + slack to align the base to 1024
  static_assert(TN * EPI_LD * 4 <= LO_OFF, "the epilogue tile fits in the ring");
  static_assert(SMEM <= 232448, "a block may use at most 227 KB of shared memory");
};

// Split a landed x tile into TF32 halves: hi in place, lo into `lo` at the
// same offsets. The split is elementwise, so the swizzled layout carries
// over to both halves.
template <int BYTES, int THREADS>
__device__ __forceinline__ void split_tile(unsigned char* x, unsigned char* lo, int tid) {
  float4* px = reinterpret_cast<float4*>(x);
  float4* pl = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int j = 0; j < BYTES / 16 / THREADS; ++j) {
    const int i = tid + j * THREADS;
    float4 h, l;
    tf32_split4_int(px[i], h, l);
    px[i] = h;
    pl[i] = l;
  }
}

// The A fragments of k8 step kc of a 64-wide quantization group for rows lr
// and lr + 8 of a code tile: weight (q * s, then + b, in float32 with
// round-to-nearest, the plain version's dequantization), split into TF32
// halves; (lr, 8 kc + t), (lr + 8, 8 kc + t), (lr, 8 kc + t + 4) and
// (lr + 8, 8 kc + t + 4). sb holds the two rows' scale and bias. A row's
// eight codes of the step are one 8-byte load (the 64-byte swizzle moves
// 16-byte chunks, so they stay together), and a code becomes a float
// without a conversion instruction: its byte with the sign bit flipped
// (code + 128) under the exponent bits of 2^23 is the float 2^23 + code +
// 128, and subtracting 2^23 + 128 is exact.
__device__ __forceinline__ void dequant_tf32(const unsigned char* codes, int kc, int lr, int t,
                                             const float (&sb)[4], uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
  for (int hi_row = 0; hi_row < 2; ++hi_row) {
    const uint2 v = *reinterpret_cast<const uint2*>(codes + code_offset(lr + 8 * hi_row, 8 * kc));
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // k 8 kc + t, then 8 kc + t + 4
      const uint32_t bits = __byte_perm((half ? v.y : v.x) ^ 0x80808080u, 0x4B000000u, 0x7650u | t);
      const float code = __uint_as_float(bits) - 8388736.f;
      const float w = __fadd_rn(__fmul_rn(code, sb[2 * hi_row]), sb[2 * hi_row + 1]);
      tf32_split_int(w, ah[2 * half + hi_row], al[2 * half + hi_row]);
    }
  }
}

// y^T tile [64 WGS output columns][TN tokens] = W x^T in 3xTF32. The last
// warp's lane 0 keeps the ring of stages filled with TMA copies; the consumer
// warpgroups split each landed x tile into TF32 halves in shared memory
// (together, since they share it), and each dequantizes its own 64 x 64 code
// tile into hi and lo A fragments and runs, per k8 step, lo_W hi_x, hi_W
// lo_x and hi_W hi_x as wgmma.m64nTNk8 with A from registers. A k8 step is
// dequantized while the products of the steps before it run, and the next
// tile is split while the stage's last products run; a consumer arrives on
// a stage's empty barrier only after its products there have completed.
template <int TN, int WGS, typename ST>
__global__ void __launch_bounds__(QmmTf32Tile<TN, WGS>::THREADS, 1)
qmm_tf32_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap q_map,
                const ST* __restrict__ scales, const ST* __restrict__ biases, const float* __restrict__ bias,
                float* __restrict__ y, int m, int n, int k) {
  using T = QmmTf32Tile<TN, WGS>;
  constexpr int STAGES = T::STAGES;
  constexpr int KC = GROUP / 8;  // k8 steps a group
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* empty = full + STAGES;
  auto stage = [&](int s) { return smem + s * T::STAGE_BYTES; };
  auto lo_tile = [&](int kb) { return smem + T::LO_OFF + (kb & 1) * T::X_BYTES; };

  const int n0 = blockIdx.x * T::ROWS;
  const int m0 = blockIdx.y * TN;
  const int groups = k / GROUP;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= T::CONSUMERS) {  // producer
    if (tid == T::CONSUMERS) {
      for (int kb = 0; kb < groups; ++kb) {
        const int s = kb % STAGES;
        if (kb >= STAGES) mbar_wait(&empty[s], (kb / STAGES - 1) & 1);
        unsigned char* st = stage(s);
        mbar_arrive_expect_tx(&full[s], T::STAGE_BYTES);
        tma_load_2d(st, &x_map, &full[s], kb * GROUP, m0);
        tma_load_2d(st + T::PANEL, &x_map, &full[s], kb * GROUP + 32, m0);
        for (int w = 0; w < WGS; ++w) {
          tma_load_2d(st + T::X_BYTES + w * T::W_BYTES, &q_map, &full[s], kb * GROUP, n0 + w * W_ROWS);
        }
      }
    }
    return;
  }

  const int wg = tid / 128, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int lr = (tid / 32 % 4) * 16 + g;  // this thread's rows in its warpgroup's code tile: lr and lr + 8
  const int col0 = n0 + wg * W_ROWS + lr, col1 = col0 + 8;
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;

  // this group's scale and bias for the thread's two rows; rows past n read
  // nothing (their codes are TMA's zero fill and their outputs are dropped)
  auto group_sb = [&](int kb, float (&sb)[4]) {
    sb[0] = col0 < n ? load_f32(scales + static_cast<long long>(col0) * groups + kb) : 0.f;
    sb[1] = col0 < n ? load_f32(biases + static_cast<long long>(col0) * groups + kb) : 0.f;
    sb[2] = col1 < n ? load_f32(scales + static_cast<long long>(col1) * groups + kb) : 0.f;
    sb[3] = col1 < n ? load_f32(biases + static_cast<long long>(col1) * groups + kb) : 0.f;
  };
  float next[4];
  group_sb(0, next);

  mbar_wait(&full[0], 0);
  split_tile<T::X_BYTES, T::CONSUMERS>(stage(0), lo_tile(0), tid);
  fence_proxy_async();
  bar_sync(1, T::CONSUMERS);

  for (int kb = 0; kb < groups; ++kb) {
    const int s = kb % STAGES;
    const float sb[4] = {next[0], next[1], next[2], next[3]};
    if (kb + 1 < groups) group_sb(kb + 1, next);  // in flight while this stage is processed
    const unsigned char* codes = stage(s) + T::X_BYTES + wg * T::W_BYTES;
    const uint64_t xh = sw128_desc(stage(s)), xl = sw128_desc(lo_tile(kb));
    uint32_t ah[KC][4], al[KC][4];
    fence_regs(acc);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      dequant_tf32(codes, kc, lr, t, sb, ah[kc], al[kc]);
      fence_regs(ah[kc]);  // this step's A registers are written before the fence, and the fence
      fence_regs(al[kc]);  // before the products that read them
      wgmma_fence();
      wgmma_tf32_rs(acc, al[kc], kmajor(xh, kc, T::PANEL), 1);
      wgmma_tf32_rs(acc, ah[kc], kmajor(xl, kc, T::PANEL), 1);
      wgmma_tf32_rs(acc, ah[kc], kmajor(xh, kc, T::PANEL), 1);
    }
    wgmma_commit();
    if (kb + 1 < groups) {  // split the next tile while this stage's products run
      const int s1 = (kb + 1) % STAGES;
      mbar_wait(&full[s1], ((kb + 1) / STAGES) & 1);
      split_tile<T::X_BYTES, T::CONSUMERS>(stage(s1), lo_tile(kb + 1), tid);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      fence_regs(ah[kc]);
      fence_regs(al[kc]);
    }
    mbar_arrive(&empty[s]);
    // every consumer's products on this stage are done (so the lo tile they
    // read may be written again) and the next tile's halves are in place
    bar_sync(1, T::CONSUMERS);
  }

  // Epilogue: add the linear's bias in float32, stage y's tile [TN tokens]
  // [64 WGS columns] in shared memory (the ring, free now), then write it
  // row by row so the stores are coalesced.
  float* epi = reinterpret_cast<float*>(smem);
  const int r0 = wg * W_ROWS + lr;
  const float bias0 = bias != nullptr && col0 < n ? bias[col0] : 0.f;
  const float bias1 = bias != nullptr && col1 < n ? bias[col1] : 0.f;
#pragma unroll
  for (int i = 0; i < TN / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int tok = 8 * i + 2 * t + (e & 1);
      float out = acc[4 * i + e];
      if (bias != nullptr) out += e >> 1 ? bias1 : bias0;
      epi[tok * T::EPI_LD + r0 + 8 * (e >> 1)] = out;
    }
  }
  bar_sync(1, T::CONSUMERS);
  if (n % 4 == 0) {  // 16-byte rows of 4 columns, each wholly inside or outside [0, n)
    for (int i = tid; i < TN * (T::ROWS / 4); i += T::CONSUMERS) {
      const int tok = i / (T::ROWS / 4), c = (i % (T::ROWS / 4)) * 4;
      if (m0 + tok < m && n0 + c < n) {
        *reinterpret_cast<float4*>(y + static_cast<long long>(m0 + tok) * n + n0 + c) =
            *reinterpret_cast<const float4*>(epi + tok * T::EPI_LD + c);
      }
    }
  } else {
    for (int i = tid; i < TN * T::ROWS; i += T::CONSUMERS) {
      const int tok = i / T::ROWS, c = i % T::ROWS;
      if (m0 + tok < m && n0 + c < n) y[static_cast<long long>(m0 + tok) * n + n0 + c] = epi[tok * T::EPI_LD + c];
    }
  }
}

// Tensor maps encoded so far, over all host threads: of bf16 x
// (f5_qmatmul_x_maps_encoded), of float32 x (f5_qmatmul_x32_maps_encoded)
// and of int8 codes (f5_qmatmul_codes_maps_encoded).
std::atomic<long long> x_maps_encoded{0};
std::atomic<long long> x32_maps_encoded{0};
std::atomic<long long> codes_maps_encoded{0};

// Tensor maps kept per host thread, keyed on a tensor's address; an entry
// is used only for the same two extents, so a hit is the map the encoder
// would make again.
struct MapEntry {
  CUtensorMap map;
  int rows = 0, cols = 0;
};
using MapCache = std::unordered_map<const void*, MapEntry>;

// The cached map of `p` [rows, cols], else a new one from `encode(map)`,
// counted in `encoded`.
template <typename Encode>
cudaError_t cached_map(MapCache& cache, const void* p, int rows, int cols, std::atomic<long long>& encoded,
                       const Encode& encode, const CUtensorMap** out) {
  const auto hit = cache.find(p);
  if (hit != cache.end() && hit->second.rows == rows && hit->second.cols == cols) {
    *out = &hit->second.map;
    return cudaSuccess;
  }
  if (cache.size() >= 4096) cache.clear();  // bound the cache of a long-lived thread
  MapEntry& e = cache[p];
  const cudaError_t err = encode(&e.map);
  if (err != cudaSuccess) {
    cache.erase(p);
    return err;
  }
  e.rows = rows;
  e.cols = cols;
  ++encoded;
  *out = &e.map;
  return cudaSuccess;
}

// The tensor map of x [m, k] bf16 in [TN][64] boxes with the 128-byte
// swizzle. PyTorch's caching allocator hands the same activation buffers
// out again and again, so the maps of every address seen are kept and a
// sampling request encodes few (chip_smoke.py counts them): an encode costs
// host time, and the sampling path is bound by the host.
template <int TN>
cudaError_t x_tensor_map(const void* x, int m, int k, const CUtensorMap** out) {
  static thread_local MapCache cache;
  return cached_map(cache, x, m, k, x_maps_encoded, [&](CUtensorMap* map) {
    const uint64_t dims[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
    const uint64_t strides[1] = {static_cast<uint64_t>(k) * 2};
    const uint32_t box[2] = {GROUP, TN};
    return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  }, out);
}

// The tensor map of x [m, k] float32 in [TN][32] boxes (one 128-byte
// panel) with the 128-byte swizzle, kept as the bf16 maps are but in caches
// of their own: PyTorch's allocator can hand a float32 buffer out at an
// address where a bf16 one of the same shape was mapped.
template <int TN>
cudaError_t x32_tensor_map(const void* x, int m, int k, const CUtensorMap** out) {
  static thread_local MapCache cache;
  return cached_map(cache, x, m, k, x32_maps_encoded, [&](CUtensorMap* map) {
    const uint64_t dims[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(m)};
    const uint64_t strides[1] = {static_cast<uint64_t>(k) * 4};
    const uint32_t box[2] = {32, TN};
    return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, x, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  }, out);
}

// The tensor map of int8 codes q [n, k] in [64][64] boxes with the 64-byte
// swizzle: encoded once per weight (a model holds a few hundred), and a
// buffer swapped in at another address or with another shape gets its own.
cudaError_t codes_tensor_map(const void* q, int n, int k, const CUtensorMap** out) {
  static thread_local MapCache cache;
  return cached_map(cache, q, n, k, codes_maps_encoded, [&](CUtensorMap* map) {
    const uint64_t dims[2] = {static_cast<uint64_t>(k), static_cast<uint64_t>(n)};
    const uint64_t strides[1] = {static_cast<uint64_t>(k)};
    const uint32_t box[2] = {GROUP, W_ROWS};
    return encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B);
  }, out);
}

template <int TN, typename ST>
cudaError_t launch_wgmma(const void* x, const void* q, const ST* s, const ST* b, const void* bias, void* y, int m,
                         int n, int k, cudaStream_t stream) {
  const CUtensorMap* x_map;
  const CUtensorMap* q_map;
  cudaError_t err = x_tensor_map<TN>(x, m, k, &x_map);
  if (err == cudaSuccess) err = codes_tensor_map(q, n, k, &q_map);
  if (err != cudaSuccess) return err;
  static std::atomic<bool> raised[MAX_DEVICES];
  err = raise_smem_limit(reinterpret_cast<const void*>(qmm_wgmma_kernel<TN, ST>), QmmTile<TN>::SMEM, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + W_ROWS - 1) / W_ROWS, (m + TN - 1) / TN);
  qmm_wgmma_kernel<TN, ST><<<grid, W_THREADS, QmmTile<TN>::SMEM, stream>>>(
      *x_map, *q_map, s, b, static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), m, n, k);
  return cudaGetLastError();
}

template <int TN, int WGS, typename ST>
cudaError_t launch_tf32(const void* x, const void* q, const ST* s, const ST* b, const void* bias, void* y, int m,
                        int n, int k, cudaStream_t stream) {
  using T = QmmTf32Tile<TN, WGS>;
  const CUtensorMap* x_map;
  const CUtensorMap* q_map;
  cudaError_t err = x32_tensor_map<TN>(x, m, k, &x_map);
  if (err == cudaSuccess) err = codes_tensor_map(q, n, k, &q_map);
  if (err != cudaSuccess) return err;
  static std::atomic<bool> raised[MAX_DEVICES];
  err = raise_smem_limit(reinterpret_cast<const void*>(qmm_tf32_kernel<TN, WGS, ST>), T::SMEM, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + T::ROWS - 1) / T::ROWS, (m + TN - 1) / TN);
  qmm_tf32_kernel<TN, WGS, ST><<<grid, T::THREADS, T::SMEM, stream>>>(
      *x_map, *q_map, s, b, static_cast<const float*>(bias), static_cast<float*>(y), m, n, k);
  return cudaGetLastError();
}

// The token tile bn and the weight rows a block are the caller's launch
// plan (ops/qmatmul.py `plan`, `plan_f32`).
template <typename ST>
cudaError_t launch(const void* x, const void* q, const void* scales, const void* biases, const void* bias,
                   void* y, int m, int n, int k, bool x_bf16, int bn, int rows, cudaStream_t stream) {
  const ST* s = static_cast<const ST*>(scales);
  const ST* b = static_cast<const ST*>(biases);
  if (x_bf16) {
    if (rows != W_ROWS) return cudaErrorInvalidValue;
    switch (bn) {
      case 32: return launch_wgmma<32, ST>(x, q, s, b, bias, y, m, n, k, stream);
      case 64: return launch_wgmma<64, ST>(x, q, s, b, bias, y, m, n, k, stream);
      case 128: return launch_wgmma<128, ST>(x, q, s, b, bias, y, m, n, k, stream);
      default: return cudaErrorInvalidValue;
    }
  }
  if (rows == 2 * W_ROWS) {
    return bn == 128 ? launch_tf32<128, 2, ST>(x, q, s, b, bias, y, m, n, k, stream) : cudaErrorInvalidValue;
  }
  if (rows != W_ROWS) return cudaErrorInvalidValue;
  switch (bn) {
    case 32: return launch_tf32<32, 1, ST>(x, q, s, b, bias, y, m, n, k, stream);
    case 64: return launch_tf32<64, 1, ST>(x, q, s, b, bias, y, m, n, k, stream);
    case 128: return launch_tf32<128, 1, ST>(x, q, s, b, bias, y, m, n, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// y [m, n] = x [m, k] @ dequant(q [n, k], scales, biases [n, k / 64]) (+ bias [n]).
// x, bias and y are bf16 when x_bf16, else float32; scales and biases are
// bf16 when s_bf16, else float32. All contiguous; k % 64 == 0; x and q
// 16-byte aligned. bn is the token tile (32, 64 or 128) and rows the weight
// rows a block: 64, or for float32 activations 128 with bn = 128. Returns
// the cudaError_t of the launch (0 on success).
int f5_qmatmul(const void* x, const void* q, const void* scales, const void* biases, const void* bias,
               void* y, int m, int n, int k, int x_bf16, int s_bf16, int bn, int rows, void* stream) {
  if (m < 1 || n < 1 || k < GROUP || k % GROUP != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_bf16) {
    return static_cast<int>(launch<__nv_bfloat16>(x, q, scales, biases, bias, y, m, n, k, x_bf16, bn, rows, st));
  }
  return static_cast<int>(launch<float>(x, q, scales, biases, bias, y, m, n, k, x_bf16, bn, rows, st));
}

// The number of tensor maps of bf16 x, of float32 x and of codes encoded so
// far, over all host threads.
long long f5_qmatmul_x_maps_encoded() { return x_maps_encoded.load(); }
long long f5_qmatmul_x32_maps_encoded() { return x32_maps_encoded.load(); }
long long f5_qmatmul_codes_maps_encoded() { return codes_maps_encoded.load(); }

const char* f5_qmatmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
