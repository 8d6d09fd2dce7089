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

Under tensor parallelism (parallel/mesh.py) the row-parallel linears
(attention to_out, feed-forward w2) see a slice of the features, but each
row must be quantized against its absmax over all of them. There
`quantize_rows` is cut in two: `row_absmax` (a Triton kernel, one program a
row, the slice's max |x|) and `quantize_scaled` (`quantize_rows`'s kernel
reading that absmax where it would take its own), with the group's max
taken between them; the slots' int32 products are summed,
which is exact, before `rescale_bias` (`w8a8_row_parallel`). Both are
memory-bound row passes, with plain versions beside them and counts
`row_absmax.launches` and `quantize_scaled.launches`.
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


def row_absmax_plain(x: torch.Tensor) -> torch.Tensor:
    """x [m, k] -> max |x| of each row, float32 [m]."""
    return x.float().abs().amax(dim=-1)


def quantize_scaled_plain(x: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [m, k] quantized against the row absmax `amax` [m] -> (codes int8
    [m, k], sx float32 [m]): sx = max(amax, 1e-12) * (1/127), codes =
    clip(round_half_even(x / sx), -127, 127), float32 throughout."""
    sx = amax.float().clamp_min(SX_FLOOR) * INV_QMAX
    return torch.round(x.float() / sx[:, None]).clamp_(-QMAX, QMAX).to(torch.int8), sx


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [m, k] -> (codes int8 [m, k], sx float32 [m]): the JAX expression's
    order, each row against its own absmax."""
    return quantize_scaled_plain(x, row_absmax_plain(x))


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
    def quantize_rows_kernel(x_ptr, amax_ptr, q_ptr, sx_ptr, m, k, x_row, floor, inv_qmax, HAS_AMAX: tl.constexpr,
                             BLOCK_K: tl.constexpr):
        # HAS_AMAX: the row's absmax is read from amax_ptr (a tensor-parallel group's), not taken over x
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_K)
        in_row = cols < k
        x = tl.load(x_ptr + row * x_row + cols, mask=in_row & (row < m), other=0.0).to(tl.float32)
        if HAS_AMAX:
            amax = tl.load(amax_ptr + row, mask=row < m, other=0.0)
        else:
            amax = tl.max(tl.abs(x), axis=0)
        sx = tl.maximum(amax, floor) * inv_qmax
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


@functools.lru_cache(maxsize=None)
def _row_absmax_kernel():
    """The first half of `quantize_rows` cut where a tensor-parallel group
    takes the max of its slots' row absmax; the second half is
    `quantize_rows_kernel` with HAS_AMAX."""
    triton = import_triton()
    import triton.language as tl

    @triton.jit
    def row_absmax_kernel(x_ptr, amax_ptr, k, x_row, BLOCK_K: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_K)
        x = tl.load(x_ptr + row * x_row + cols, mask=cols < k, other=0.0).to(tl.float32)
        tl.store(amax_ptr + row, tl.max(tl.abs(x), axis=0))

    return triton, row_absmax_kernel


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
    return _quantize_cuda("quantize_rows", x, None, rows)


def _check_rows(fn: str, x: torch.Tensor) -> None:
    if x.ndim != 2 or x.dtype not in _DTYPES or x.stride(-1) != 1 or not 1 <= x.shape[1] <= MAX_K:
        raise ValueError(f"{fn} takes x [m, k] in {_DTYPES} with unit stride along k and 1 <= k <= {MAX_K}; "
                         f"got {x.dtype} {tuple(x.shape)} strides {x.stride()}")


def _quantize_cuda(fn: str, x: torch.Tensor, amax: torch.Tensor | None, rows: int):
    """`quantize_rows_kernel` over CUDA x [m, k] into `rows` rows, each row
    against its own absmax, or against `amax` float32 [m] where given;
    counted in `quantize_rows.launches` or `quantize_scaled.launches`."""
    _check_rows(fn, x)
    m, k = x.shape
    if rows < m:
        raise ValueError(f"{fn} takes rows >= m; got m {m}, rows {rows}")
    if amax is not None and (amax.shape != (m,) or amax.dtype != torch.float32 or not amax.is_contiguous()
                             or amax.device != x.device):
        raise ValueError(f"{fn} takes a contiguous float32 amax [{m}] on {x.device}; "
                         f"got {amax.dtype} {tuple(amax.shape)} on {amax.device}")
    codes = torch.empty(rows, k, dtype=torch.int8, device=x.device)
    sx = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        triton, kernel, _ = _kernels()
        with torch.cuda.device(x.device):
            kernel[(rows,)](x, x if amax is None else amax, codes, sx, m, k, x.stride(0), SX_FLOOR, INV_QMAX,
                            HAS_AMAX=amax is not None, BLOCK_K=triton.next_power_of_2(k), num_warps=4)
        (quantize_rows if amax is None else quantize_scaled).launches += 1
    return codes, sx


def row_absmax(x: torch.Tensor) -> torch.Tensor:
    """x [m, k] (bf16 or float32, unit stride along k) -> max |x| of each
    row, float32 [m]: a Triton kernel for a CUDA tensor, one program a row;
    the plain version for a CPU one. Counted in `row_absmax.launches`."""
    _check_device("row_absmax", x)
    if x.device.type == "cpu":
        return row_absmax_plain(x)
    _check_rows("row_absmax", x)
    m, k = x.shape
    amax = torch.empty(m, dtype=torch.float32, device=x.device)
    if m:
        triton, kernel = _row_absmax_kernel()
        with torch.cuda.device(x.device):
            kernel[(m,)](x, amax, k, x.stride(0), BLOCK_K=triton.next_power_of_2(k), num_warps=4)
        row_absmax.launches += 1
    return amax


def quantize_scaled(x: torch.Tensor, amax: torch.Tensor, rows: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """x [m, k] quantized against the row absmax `amax` float32 [m] (taken
    over more columns than x holds: a tensor-parallel group's max) ->
    (codes int8 [rows, k], sx float32 [rows]), as `quantize_scaled_plain`;
    rows past m (up to `rows`, default m) hold zero codes. For CUDA tensors
    `quantize_rows`'s kernel with the absmax read, not taken; the plain
    version on x padded with zero rows for CPU ones. Counted in
    `quantize_scaled.launches`."""
    _check_device("quantize_scaled", x)
    rows = x.shape[0] if rows is None else rows
    if x.device.type == "cpu":
        pad = rows - x.shape[0]
        return quantize_scaled_plain(torch.nn.functional.pad(x, (0, 0, 0, pad)),
                                     torch.nn.functional.pad(amax, (0, pad)))
    return _quantize_cuda("quantize_scaled", x, amax, rows)


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


def _linear_operands(x: torch.Tensor, w8: torch.Tensor, w8_scale: torch.Tensor, bias: torch.Tensor | None):
    """Check a W8A8 linear's operands; returns (x as [m, k] with unit stride
    along k, the bias in x's dtype, the rows quantized: m, or 32 below 17)."""
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
    x2 = x.reshape(-1, k)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    m = x2.shape[0]
    return x2, None if bias is None else bias.to(x.dtype), m if m >= MIN_INT_MM_ROWS else PAD_ROWS


def w8a8_linear(x: torch.Tensor, w8: torch.Tensor, w8_scale: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [..., k] @ the W8A8 weight (w8 int8 [n, k], w8_scale float32 [n])
    (+ bias) -> [..., n] in x's dtype: `quantize_rows`, torch._int_mm and
    `rescale_bias`, which launch the kernels for CUDA tensors and run the
    plain versions for CPU ones (the product is exact in int32 on either);
    anything they do not take raises ValueError. A program traced with
    torch.export records the two operators and the product."""
    x2, bias, rows = _linear_operands(x, w8, w8_scale, bias)
    m, n = x2.shape[0], w8.shape[0]
    if not m:
        return x.new_empty(*x.shape[:-1], n)
    codes, sx = quantize_rows(x2, rows)
    acc = torch._int_mm(codes, w8.t())
    y = rescale_bias(acc[:m], sx[:m], w8_scale, bias, x.dtype)
    if x.device.type == "cuda" and not torch.compiler.is_exporting():  # a trace launches nothing
        w8a8_linear.launches += 1
    return y.view(*x.shape[:-1], n)


def w8a8_row_parallel(x: torch.Tensor, w8: torch.Tensor, w8_scale: torch.Tensor, bias: torch.Tensor | None = None):
    """A generator: one slot's share of a row-parallel W8A8 linear of a
    tensor-parallel group (parallel/mesh.py), whose x [..., k] and w8
    [n, k] hold the slot's slice of the input features. JAX's
    `_w8a8_matmul` takes each row's absmax over the whole feature axis (a
    max across the group under GSPMD), so: `row_absmax` of the slice,
    yield ("max", it) and be sent the group's; `quantize_scaled` against
    it and torch._int_mm, yield ("sum", the int32 products), which sum
    exactly; then `rescale_bias` with the bias, added once. The unsharded
    W8A8 linear's bits, to the last one. Counted in `w8a8_linear.launches`
    on the card."""
    x2, bias, rows = _linear_operands(x, w8, w8_scale, bias)
    m, n = x2.shape[0], w8.shape[0]
    amax = yield "max", row_absmax(x2)
    codes, sx = quantize_scaled(x2, amax, rows)
    acc = yield "sum", torch._int_mm(codes, w8.t())
    y = rescale_bias(acc[:m], sx[:m], w8_scale, bias, x.dtype)
    if x.device.type == "cuda":
        w8a8_linear.launches += 1
    return y.view(*x.shape[:-1], n)


quantize_rows.launches = 0
rescale_bias.launches = 0
row_absmax.launches = 0
quantize_scaled.launches = 0
w8a8_linear.launches = 0
