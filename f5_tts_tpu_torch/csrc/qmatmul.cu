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
// compute-bound and wants the tensor cores. At the time-conditioning
// linears' m = 31 it is bound by the bytes of W; there the int8 codes are
// half the bf16 weight's bytes. The TPU kernel held whole [k, 512] weight
// slabs in VMEM; here W streams through shared memory in 64 x 64 tiles.
//
// Design:
//   - one block of 4 warps per 64 x 64 output tile; each warp owns a 32 x 32
//     quarter (2 x 4 mma tiles);
//   - the k loop steps by one quantization group (64), so one scale and one
//     bias per output column serve a whole tile;
//   - bf16 activations: the x tile is copied to shared memory as is; the
//     code tile is read as 16-byte chunks of int8, dequantized in float32 in
//     registers and stored as bf16 [n][k] rows, which is the column-major B
//     operand of mma.sync.m16n8k16 (bf16 in, float32 accumulate);
//   - float32 activations: a SIMT tile with float32 FMA (no TF32), each of
//     256 threads owning a 4 x 4 block of outputs, x and W staged k-major;
//   - rows past m and columns past n are zero-filled when staged and not
//     written, so any m >= 1 and any n are taken; k must be a multiple of 64;
//   - the scales and biases may be float32 or bf16 (a bf16 model casts them
//     with its other float tensors); they are read as float32 either way.
//
// cp.async / TMA double buffering, wgmma and a persistent schedule are not
// used yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_bf16.cuh"

namespace {

constexpr int GROUP = 64;  // quantization group along k
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = GROUP;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float dequant(int8_t code, float s, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(code), s), b);
}

// ------------------------------------------------------------- bf16, mma.sync

constexpr int T_THREADS = 128;
constexpr int LD = BK + 8;  // bf16 row stride in shared memory: conflict-free fragment loads

template <typename ST>
__global__ void __launch_bounds__(T_THREADS)
qmm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                const ST* __restrict__ scales, const ST* __restrict__ biases,
                const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y, int m, int n,
                int k) {
  __shared__ __align__(16) __nv_bfloat16 sX[BM * LD];  // [m][k]
  __shared__ __align__(16) __nv_bfloat16 sW[BN * LD];  // [n][k]

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row group of an mma fragment
  const int t = lane % 4;  // column pair within the fragment
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const int groups = k / GROUP;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    __syncthreads();  // the previous tiles are consumed by every warp
    // x tile: 64 rows x 8 chunks of 8 bf16
    for (int i = threadIdx.x; i < BM * (BK / 8); i += T_THREADS) {
      const int r = i / (BK / 8);
      const int c = (i % (BK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < m) val = *reinterpret_cast<const uint4*>(x + static_cast<long long>(m0 + r) * k + k0 + c);
      *reinterpret_cast<uint4*>(sX + r * LD + c) = val;
    }
    // code tile: 64 columns x 4 chunks of 16 int8, dequantized to bf16
    for (int i = threadIdx.x; i < BN * (BK / 16); i += T_THREADS) {
      const int r = i / (BK / 16);
      const int c = (i % (BK / 16)) * 16;
      uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
      if (n0 + r < n) {
        const long long col = n0 + r;
        const int4 codes = *reinterpret_cast<const int4*>(q + col * k + k0 + c);
        const float s = load_f32(scales + col * groups + k0 / GROUP);
        const float b = load_f32(biases + col * groups + k0 / GROUP);
        const int8_t* cb = reinterpret_cast<const int8_t*>(&codes);
        __nv_bfloat162* wl = reinterpret_cast<__nv_bfloat162*>(&lo);
        __nv_bfloat162* wh = reinterpret_cast<__nv_bfloat162*>(&hi);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          wl[e] = __floats2bfloat162_rn(dequant(cb[2 * e], s, b), dequant(cb[2 * e + 1], s, b));
          wh[e] = __floats2bfloat162_rn(dequant(cb[8 + 2 * e], s, b), dequant(cb[9 + 2 * e], s, b));
        }
      }
      *reinterpret_cast<uint4*>(sW + r * LD + c) = lo;
      *reinterpret_cast<uint4*>(sW + r * LD + c + 8) = hi;
    }
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* pa = sX + (wm + mi * 16 + g) * LD + kc * 16 + 2 * t;
        a[mi][0] = ld32(pa);
        a[mi][1] = ld32(pa + 8 * LD);
        a[mi][2] = ld32(pa + 8);
        a[mi][3] = ld32(pa + 8 * LD + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* pb = sW + (wn + ni * 8 + g) * LD + kc * 16 + 2 * t;
        const uint32_t b0 = ld32(pb), b1 = ld32(pb + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_16816(acc[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b0, b1);
      }
    }
  }

  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn + ni * 8 + 2 * t + (e & 1);
        if (row < m && col < n) {
          __nv_bfloat16 out = __float2bfloat16(acc[mi][ni][e]);
          if (bias != nullptr) out = __float2bfloat16(__bfloat162float(out) + __bfloat162float(bias[col]));
          y[static_cast<long long>(row) * n + col] = out;
        }
      }
    }
  }
}

// ------------------------------------------------------------- float32, FMA

constexpr int F_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int F_PAD = 4;

template <typename ST>
__global__ void __launch_bounds__(F_THREADS)
qmm_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q, const ST* __restrict__ scales,
               const ST* __restrict__ biases, const float* __restrict__ bias, float* __restrict__ y, int m,
               int n, int k) {
  __shared__ float sX[BK][BM + F_PAD];  // [k][m]
  __shared__ float sW[BK][BN + F_PAD];  // [k][n]

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ty = threadIdx.x / 16;  // rows ty + 16 i
  const int tx = threadIdx.x % 16;  // columns tx + 16 j
  const int groups = k / GROUP;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < BM * BK; i += F_THREADS) {
      const int r = i / BK;
      const int c = i % BK;
      sX[c][r] = m0 + r < m ? x[static_cast<long long>(m0 + r) * k + k0 + c] : 0.f;
    }
    for (int i = threadIdx.x; i < BN * BK; i += F_THREADS) {
      const int r = i / BK;
      const int c = i % BK;
      float w = 0.f;
      if (n0 + r < n) {
        const long long col = n0 + r;
        w = dequant(q[col * k + k0 + c], load_f32(scales + col * groups + k0 / GROUP),
                    load_f32(biases + col * groups + k0 / GROUP));
      }
      sW[c][r] = w;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sX[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sW[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + ty + 16 * i;
      const int col = n0 + tx + 16 * j;
      if (row < m && col < n) {
        y[static_cast<long long>(row) * n + col] = bias != nullptr ? acc[i][j] + bias[col] : acc[i][j];
      }
    }
  }
}

template <typename ST>
cudaError_t launch(const void* x, const void* q, const void* scales, const void* biases, const void* bias,
                   void* y, int m, int n, int k, bool x_bf16, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const int8_t* qc = static_cast<const int8_t*>(q);
  const ST* s = static_cast<const ST*>(scales);
  const ST* b = static_cast<const ST*>(biases);
  if (x_bf16) {
    qmm_bf16_kernel<ST><<<grid, T_THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), qc, s, b, static_cast<const __nv_bfloat16*>(bias),
        static_cast<__nv_bfloat16*>(y), m, n, k);
  } else {
    qmm_f32_kernel<ST><<<grid, F_THREADS, 0, stream>>>(static_cast<const float*>(x), qc, s, b,
                                                       static_cast<const float*>(bias),
                                                       static_cast<float*>(y), m, n, k);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// y [m, n] = x [m, k] @ dequant(q [n, k], scales, biases [n, k / 64]) (+ bias [n]).
// x, bias and y are bf16 when x_bf16, else float32; scales and biases are
// bf16 when s_bf16, else float32. All contiguous; k % 64 == 0; x and q
// 16-byte aligned. Returns the cudaError_t of the launch (0 on success).
int f5_qmatmul(const void* x, const void* q, const void* scales, const void* biases, const void* bias,
               void* y, int m, int n, int k, int x_bf16, int s_bf16, void* stream) {
  if (m < 1 || n < 1 || k < GROUP || k % GROUP != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_bf16) return static_cast<int>(launch<__nv_bfloat16>(x, q, scales, biases, bias, y, m, n, k, x_bf16, st));
  return static_cast<int>(launch<float>(x, q, scales, biases, bias, y, m, n, k, x_bf16, st));
}

const char* f5_qmatmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
