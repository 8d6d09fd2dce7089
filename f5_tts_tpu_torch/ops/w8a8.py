"""W8A8 int8-compute linear: the Triton kernels' wrappers and their plain
versions.

The counterpart of the JAX package's `_w8a8_matmul` (`utils/modules.py`),
which XLA fuses around one int8 x int8 -> int32 product (no Pallas kernel):
  - each row (token) of x is quantized against its own absmax:
    sx = max(max|x|, 1e-12) * (1/127) in float32, and
    codes = clip(round_half_even(x / sx), -127, 127) as int8;
  - acc = codes @ w8^T, summed exactly in int32;
  - y = (float32(acc) * (sx * w8_scale)) rounded to x's dtype, and then the
    bias, rounded to x's dtype, added in that dtype (as the JAX linear adds
    it after the product).

On the card one linear is three launches: `quantize_rows` (Triton: one
program a row, the absmax, a correctly rounded division, `rint` and the
clip; padded rows past m write zero codes), the product by
`torch._int_mm` (cuBLASLt; the JAX package leaves it to XLA too) on w8
stored [out, in] and passed as its transpose, and `rescale_bias` (Triton:
the float32 rescale, the rounding and the bias add, each rounded as
written: `mul_rn` and `add_rn` keep ptxas from contracting them into one
FMA). Both kernels are memory-bound elementwise and row-reduction passes.
`torch._int_mm` on the card wants more than 16 rows, so fewer are padded
to 32 with zero codes and the padding is never read back.

`quantize_rows` and `rescale_bias` are registered torch operators
(`torch.ops.f5_tts_tpu_torch.quantize_rows` and `.rescale_bias`), so a
program traced with torch.export records them; CPU tensors run the plain
versions inside them (the product stays `torch._int_mm`, exact on either
device), and CUDA tensors launch the kernels or raise. Counts:
`w8a8_linear.launches` (linears on the card), `quantize_rows.launches` and
`rescale_bias.launches` (each kernel).
"""

from __future__ import annotations

import functools

import torch

from f5_tts_tpu_torch.ops.cuda_build import import_triton

QMAX = 127
SX_FLOOR = 1e-12
INV_QMAX = 1.0 / QMAX  # the JAX expression's constant, a float32 multiplier
_DTYPES = (torch.bfloat16, torch.float32)
MAX_K = 16384  # one row in one block
MIN_INT_MM_ROWS = 17  # torch._int_mm on CUDA wants m > 16
PAD_ROWS = 32
RESCALE_BLOCK = (32, 128)  # (rows, columns) a program


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [m, k] -> (codes int8 [m, k], sx float32 [m]): the JAX expression's
    order, float32 throughout, `torch.round` rounding half to even."""
    xf = x.float()
    sx = xf.abs().amax(dim=-1).clamp_min(SX_FLOOR) * INV_QMAX
    return torch.round(xf / sx[:, None]).clamp_(-QMAX, QMAX).to(torch.int8), sx


def rescale_bias_plain(acc: torch.Tensor, sx: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
                       dtype: torch.dtype) -> torch.Tensor:
    """acc int32 [m, n], sx [m], scale [n] -> float32(acc) * (sx * scale)
    rounded to `dtype`, then + bias in `dtype`."""
    y = (acc.float() * (sx[:, None] * scale.float()[None, :])).to(dtype)
    return y if bias is None else y + bias.to(dtype)


def int8_product_plain(codes: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """codes int8 [m, k] @ w8 int8 [n, k]^T -> int32 [m, n], exactly: a
    float64 product holds every partial sum (at most 127^2 k) exactly, on
    any device and at any m."""
    return torch.matmul(codes.double(), w8.double().t()).to(torch.int32)


def w8a8_linear_plain(x: torch.Tensor, w8: torch.Tensor, w8_scale: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., k] through the W8A8 linear (w8 int8 [n, k], w8_scale float32
    [n], bias [n]) -> [..., n] in x's dtype: the plain versions chained."""
    k, n = x.shape[-1], w8.shape[0]
    codes, sx = quantize_rows_plain(x.reshape(-1, k))
    y = rescale_bias_plain(int8_product_plain(codes, w8), sx, w8_scale, bias, x.dtype)
    return y.view(*x.shape[:-1], n)


@functools.lru_cache(maxsize=None)
def _kernels():
    triton = import_triton()
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def quantize_rows_kernel(x_ptr, q_ptr, sx_ptr, m, k, x_row, floor, inv_qmax, BLOCK_K: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_K)
        in_row = cols < k
        x = tl.load(x_ptr + row * x_row + cols, mask=in_row & (row < m), other=0.0).to(tl.float32)
        sx = tl.maximum(tl.max(tl.abs(x), axis=0), floor) * inv_qmax
        q = libdevice.rint(tl.math.div_rn(x, tl.zeros_like(x) + sx))
        q = tl.minimum(tl.maximum(q, -127.0), 127.0)
        tl.store(q_ptr + row * k + cols, q.to(tl.int8), mask=in_row)
        tl.store(sx_ptr + row, sx)

    @triton.jit
    def rescale_bias_kernel(acc_ptr, sx_ptr, scale_ptr, bias_ptr, out_ptr, m, n, HAS_BIAS: tl.constexpr,
                            BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)
        row_ok, col_ok = rows < m, cols < n
        keep = row_ok[:, None] & col_ok[None, :]
        offs = rows[:, None].to(tl.int64) * n + cols[None, :]
        acc = tl.load(acc_ptr + offs, mask=keep, other=0).to(tl.float32)
        sx = tl.load(sx_ptr + rows, mask=row_ok, other=0.0)
        scale = tl.load(scale_ptr + cols, mask=col_ok, other=0.0)
        factor = libdevice.mul_rn(sx[:, None] + tl.zeros_like(acc), scale[None, :] + tl.zeros_like(acc))
        y = libdevice.mul_rn(acc, factor).to(out_ptr.dtype.element_ty)
        if HAS_BIAS:
            bias = tl.load(bias_ptr + cols, mask=col_ok, other=0.0).to(tl.float32)
            y = libdevice.add_rn(y.to(tl.float32), bias[None, :] + tl.zeros_like(acc)).to(out_ptr.dtype.element_ty)
        tl.store(out_ptr + offs, y, mask=keep)

    return triton, quantize_rows_kernel, rescale_bias_kernel


def _check_device(fn: str, x: torch.Tensor) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn} runs on CPU or CUDA tensors, not {x.device.type}")


def quantize_rows(x: torch.Tensor, rows: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [m, k] (bf16 or float32, unit stride along k) -> (codes int8
    [rows, k], sx float32 [rows]); rows past m (up to `rows`, default m)
    hold zero codes. Through the registered operator: CPU tensors run the
    plain version on x padded with zero rows."""
    _check_device("quantize_rows", x)
    return quantize_rows_op(x, x.shape[0] if rows is None else rows)


@torch.library.custom_op("f5_tts_tpu_torch::quantize_rows", mutates_args=(), device_types="cpu",
                         schema="(Tensor x, int rows) -> (Tensor, Tensor)")
def quantize_rows_op(x, rows):
    """`quantize_rows` as an operator; this body is the CPU one: the plain
    version over x and rows - m zero rows, whose codes are zero, as the
    kernel writes them."""
    return quantize_rows_plain(torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0])))


@quantize_rows_op.register_fake
def _quantize_rows_fake(x, rows):
    return x.new_empty((rows, x.shape[1]), dtype=torch.int8), x.new_empty((rows,), dtype=torch.float32)


@quantize_rows_op.register_kernel("cuda")
def _quantize_rows_cuda(x, rows):
    if x.ndim != 2 or x.dtype not in _DTYPES or x.stride(-1) != 1:
        raise ValueError(f"quantize_rows takes x [m, k] in {_DTYPES} with unit stride along k; "
                         f"got {x.dtype} {tuple(x.shape)} strides {x.stride()}")
    m, k = x.shape
    if not 1 <= k <= MAX_K or rows < m:
        raise ValueError(f"quantize_rows takes 1 <= k <= {MAX_K} and rows >= m; got k {k}, m {m}, rows {rows}")
    codes = torch.empty(rows, k, dtype=torch.int8, device=x.device)
    sx = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        triton, kernel, _ = _kernels()
        with torch.cuda.device(x.device):
            kernel[(rows,)](x, codes, sx, m, k, x.stride(0), SX_FLOOR, INV_QMAX,
                            BLOCK_K=triton.next_power_of_2(k), num_warps=4)
        quantize_rows.launches += 1
    return codes, sx


def rescale_bias(acc: torch.Tensor, sx: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
                 dtype: torch.dtype) -> torch.Tensor:
    """acc int32 [m, n] (contiguous), sx float32 [m], scale float32 [n],
    bias [n] in `dtype` or None -> [m, n] in `dtype`, as
    `rescale_bias_plain`, through the registered operator: CPU tensors run
    the plain version."""
    _check_device("rescale_bias", acc)
    return rescale_bias_op(acc, sx, scale, bias, dtype)


@torch.library.custom_op("f5_tts_tpu_torch::rescale_bias", mutates_args=(), device_types="cpu",
                         schema="(Tensor acc, Tensor sx, Tensor scale, Tensor? bias, ScalarType dtype) -> Tensor")
def rescale_bias_op(acc, sx, scale, bias, dtype):
    """`rescale_bias` as an operator; this body is the CPU one, the plain
    version."""
    return rescale_bias_plain(acc, sx, scale, bias, dtype)


@rescale_bias_op.register_fake
def _rescale_bias_fake(acc, sx, scale, bias, dtype):
    return acc.new_empty(acc.shape, dtype=dtype)


@rescale_bias_op.register_kernel("cuda")
def _rescale_bias_cuda(acc, sx, scale, bias, dtype):
    m, n = acc.shape
    if acc.dtype != torch.int32 or not acc.is_contiguous() or dtype not in _DTYPES:
        raise ValueError(f"rescale_bias takes contiguous int32 acc and an output dtype in {_DTYPES}")
    for name, t, size, want in (("sx", sx, m, torch.float32), ("scale", scale, n, torch.float32),
                                ("bias", bias, n, dtype)):
        if t is not None and (t.shape != (size,) or t.dtype != want or not t.is_contiguous()
                              or t.device != acc.device):
            raise ValueError(f"{name} must be contiguous [{size}] {want} on {acc.device}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty(m, n, dtype=dtype, device=acc.device)
    if m and n:
        triton, _, kernel = _kernels()
        bm, bn = RESCALE_BLOCK
        with torch.cuda.device(acc.device):
            kernel[(triton.cdiv(m, bm), triton.cdiv(n, bn))](
                acc, sx, scale, acc if bias is None else bias, out, m, n, HAS_BIAS=bias is not None,
                BLOCK_M=bm, BLOCK_N=bn, num_warps=4)
        rescale_bias.launches += 1
    return out


def w8a8_linear(x: torch.Tensor, w8: torch.Tensor, w8_scale: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., k] @ the W8A8 weight (w8 int8 [n, k], w8_scale float32 [n])
    (+ bias) -> [..., n] in x's dtype: `quantize_rows`, torch._int_mm and
    `rescale_bias`, which launch the kernels for CUDA tensors and run the
    plain versions for CPU ones (the product is exact in int32 on either);
    anything they do not take raises ValueError. A program traced with
    torch.export records the two operators and the product."""
    _check_device("w8a8_linear", x)
    n, k = w8.shape
    if x.dtype not in _DTYPES or x.shape[-1] != k:
        raise ValueError(f"w8a8_linear takes x [..., {k}] in {_DTYPES}; got {x.dtype} {tuple(x.shape)}")
    if k % 8 or n % 8:
        raise ValueError(f"torch._int_mm needs k and n multiples of 8; got k {k}, n {n}")
    if w8.dtype != torch.int8 or not w8.is_contiguous():
        raise ValueError("w8 must be contiguous int8 [n, k]")
    for name, t in (("w8", w8), ("w8_scale", w8_scale), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if bias is not None:
        bias = bias.to(x.dtype)
    x2 = x.reshape(-1, k)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    m = x2.shape[0]
    if not m:
        return x.new_empty(*x.shape[:-1], n)
    rows = m if m >= MIN_INT_MM_ROWS else PAD_ROWS
    codes, sx = quantize_rows(x2, rows)
    acc = torch._int_mm(codes, w8.t())
    y = rescale_bias(acc[:m], sx[:m], w8_scale, bias, x.dtype)
    if x.device.type == "cuda" and not torch.compiler.is_exporting():  # a trace launches nothing
        w8a8_linear.launches += 1
    return y.view(*x.shape[:-1], n)


quantize_rows.launches = 0
rescale_bias.launches = 0
w8a8_linear.launches = 0
