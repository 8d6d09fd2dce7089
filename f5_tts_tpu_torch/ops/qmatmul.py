"""Weight-only int4/int8 dequantizing matmul: the CUDA kernel's wrapper and
its plain version.

The kernel (csrc/qmatmul.cu, whose header note gives its design) is built
by ops/cuda_build.py at first use and called through ctypes on PyTorch's
current stream. It is a TMA + wgmma pipeline: with bf16 activations in
bf16 (`plan` chooses its token tile from m), with float32 ones in 3xTF32
(`plan_f32` chooses its token tile and its weight rows a block). The
kernel's library keeps the TMA tensor maps of the codes and of x, keyed on
each tensor's address and shape, with the float32 x maps apart from the
bf16 ones, so a swapped buffer gets its own map (`maps_encoded` counts
them).

Layout (PyTorch's [out, in]): codes q int8 [n, k], centred by -2^(bits-1);
scales and biases [n, k / 64] in float32 or the model's compute dtype;
dequant(W)[j, i] = q[j, i] * scales[j, i // 64] + biases[j, i // 64].

`qmatmul` calls the registered operator `torch.ops.f5_tts_tpu_torch.qmatmul`
(`qmatmul_op`), which launches the kernel for CUDA tensors and runs
`qmatmul_plain` for CPU tensors. Both compute x @ dequant(W)^T (+ bias) with W dequantized in
float32 and rounded to x's dtype. `qmatmul.launches` counts the kernel's
launches with bf16 activations, `qmatmul.launches_f32` with float32 ones.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from f5_tts_tpu_torch.ops import cuda_build

SOURCE = cuda_build.CSRC / "qmatmul.cu"
GROUP_SIZE = 64
_DTYPES = (torch.bfloat16, torch.float32)
W_ROWS = 64  # output columns per consumer warpgroup
TOKEN_TILES = (32, 64, 128)
# the float32 kernel's plans, (token tile, weight rows a block), the most work a block first: two consumer
# warpgroups sharing each x tile, then one. A block's time grows far less than its work, so the plan takes the
# most work a block that still leaves this many blocks, about three quarters of a wave on the H100's 132 SMs
F32_PLANS = ((128, 128), (128, 64), (64, 64), (32, 64))
F32_MIN_BLOCKS = 96
# the float32 kernel's shared memory (csrc/qmatmul.cu `QmmTf32Tile`): ring stages by token tile, each an x
# tile [tile][64] float32 and a [64][64] int8 code tile a warpgroup; two lo tiles; barriers; 1 KB of slack
F32_STAGES = {32: 8, 64: 4, 128: 3}
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on the H100


def token_tile(m: int) -> int:
    """The bf16 kernel's token tile (wgmma's N) for m rows of x: the
    smallest of TOKEN_TILES that holds m, else the largest."""
    return 32 if m <= 32 else 64 if m <= 64 else 128


def plan(m: int, n: int) -> tuple[int, tuple[int, int]]:
    """The bf16 kernel's launch plan for x [m, k] and n output columns: the
    token tile and the grid (column blocks of 64, token blocks)."""
    tile = token_tile(m)
    return tile, (-(-n // W_ROWS), -(-m // tile))


def plan_f32(m: int, n: int) -> tuple[int, int, tuple[int, int]]:
    """The float32 kernel's launch plan for x [m, k] and n output columns:
    the token tile, the weight rows a block and the grid (column blocks,
    token blocks). The first of F32_PLANS whose token tile is at most the
    bf16 kernel's for m and whose grid has F32_MIN_BLOCKS blocks; where none
    has, the one with the most blocks."""
    plans = [(tile, rows, (-(-n // rows), -(-m // tile))) for tile, rows in F32_PLANS if tile <= token_tile(m)]
    return next((p for p in plans if p[2][0] * p[2][1] >= F32_MIN_BLOCKS), plans[-1])


def f32_smem_bytes(tile: int, rows: int) -> int:
    """The float32 kernel's dynamic shared memory for a plan's token tile
    and weight rows."""
    x_tile = tile * GROUP_SIZE * 4
    stages = F32_STAGES[tile]
    return stages * (x_tile + (rows // W_ROWS) * W_ROWS * GROUP_SIZE) + 2 * x_tile + 2 * stages * 8 + 1024


def dequantize_kernel(q: torch.Tensor, scales: torch.Tensor, biases: torch.Tensor) -> torch.Tensor:
    """Codes [n, k] with group scales and biases [n, k / 64] -> float32
    weight [n, k]: q * s, then + b."""
    n, k = q.shape
    w = q.float().view(n, k // GROUP_SIZE, GROUP_SIZE) * scales.float()[..., None] + biases.float()[..., None]
    return w.view(n, k)


def qmatmul_plain(
    x: torch.Tensor,  # [..., k]
    q: torch.Tensor,  # [n, k] int8
    scales: torch.Tensor,  # [n, k / 64]
    biases: torch.Tensor,  # [n, k / 64]
    bias: torch.Tensor | None = None,  # [n]
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: dequantize in float32, round
    to x's dtype, matmul, then add the bias in x's dtype."""
    y = torch.matmul(x, dequantize_kernel(q, scales, biases).to(x.dtype).t())
    return y if bias is None else y + bias.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build(SOURCE)[0]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.f5_qmatmul.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.f5_qmatmul.restype = i32
    for counter in (lib.f5_qmatmul_x_maps_encoded, lib.f5_qmatmul_x32_maps_encoded,
                    lib.f5_qmatmul_codes_maps_encoded):
        counter.argtypes = []
        counter.restype = ctypes.c_longlong
    lib.f5_qmatmul_error_string.argtypes = [i32]
    lib.f5_qmatmul_error_string.restype = ctypes.c_char_p
    return lib


def maps_encoded() -> dict:
    """The TMA tensor maps the kernel's library has encoded so far, of bf16 x
    ("x"), of float32 x ("x_f32") and of the codes (each cached by address
    and shape; builds the library)."""
    lib = _library()
    return {"x": lib.f5_qmatmul_x_maps_encoded(), "x_f32": lib.f5_qmatmul_x32_maps_encoded(),
            "codes": lib.f5_qmatmul_codes_maps_encoded()}


def qmatmul(
    x: torch.Tensor,  # [..., k]
    q: torch.Tensor,  # [n, k] int8
    scales: torch.Tensor,  # [n, k / 64]
    biases: torch.Tensor,  # [n, k / 64]
    bias: torch.Tensor | None = None,  # [n]
) -> torch.Tensor:
    """x @ dequant(W)^T (+ bias) -> [..., n] in x's dtype, through the
    registered operator `torch.ops.f5_tts_tpu_torch.qmatmul`: CPU tensors run
    the plain version; CUDA tensors launch the kernel whatever m is, and
    anything it does not take raises ValueError. A program traced with
    torch.export records the operator."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qmatmul runs on CPU or CUDA tensors, not {x.device.type}")
    return qmatmul_op(x, q, scales, biases, bias)


@torch.library.custom_op("f5_tts_tpu_torch::qmatmul", mutates_args=(), device_types="cpu",
                         schema="(Tensor x, Tensor q, Tensor scales, Tensor biases, Tensor? bias) -> Tensor")
def qmatmul_op(x, q, scales, biases, bias):
    """K3 as an operator; this body is the CPU one, the plain version."""
    return qmatmul_plain(x, q, scales, biases, bias)


@qmatmul_op.register_fake
def _qmatmul_fake(x, q, scales, biases, bias):
    return x.new_empty((*x.shape[:-1], q.shape[0]))


@qmatmul_op.register_kernel("cuda")
def _qmatmul_cuda(x, q, scales, biases, bias):
    n, k = q.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"qmatmul takes bfloat16 or float32 activations, not {x.dtype}")
    if k % GROUP_SIZE or x.shape[-1] != k:
        raise ValueError(f"qmatmul needs x [..., {k}] with k a multiple of {GROUP_SIZE}; got x {tuple(x.shape)}")
    if q.dtype != torch.int8 or not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("qmatmul needs contiguous, 16-byte aligned int8 codes")
    for name, t in (("scales", scales), ("biases", biases)):
        if t.shape != (n, k // GROUP_SIZE) or t.dtype not in _DTYPES or t.dtype != scales.dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous [{n}, {k // GROUP_SIZE}] bfloat16 or float32, "
                             "the same dtype for both")
    if bias is not None:
        if bias.shape != (n,):
            raise ValueError(f"bias must be [{n}]")
        bias = bias.to(x.dtype).contiguous()
    for name, t in (("q", q), ("scales", scales), ("biases", biases), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")

    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    m = x2.shape[0]
    y = torch.empty(m, n, dtype=x.dtype, device=x.device)
    if m:
        x_bf16 = x.dtype == torch.bfloat16
        tile, rows = (token_tile(m), W_ROWS) if x_bf16 else plan_f32(m, n)[:2]
        with torch.cuda.device(x.device):
            err = _library().f5_qmatmul(
                x2.data_ptr(), q.data_ptr(), scales.data_ptr(), biases.data_ptr(),
                None if bias is None else bias.data_ptr(), y.data_ptr(),
                m, n, k, int(x_bf16), int(scales.dtype == torch.bfloat16),
                tile, rows, torch.cuda.current_stream(x.device).cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"qmatmul kernel launch failed: {_library().f5_qmatmul_error_string(err).decode()}")
        if x_bf16:
            qmatmul.launches += 1
        else:
            qmatmul.launches_f32 += 1
    return y.view(*lead, n)


qmatmul.launches = 0
qmatmul.launches_f32 = 0
