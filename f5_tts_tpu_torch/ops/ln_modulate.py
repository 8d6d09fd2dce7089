"""LayerNorm + modulate, the DiT's AdaLN: the Triton kernels' wrappers, their
plain versions, the registered operator and the autograd function.

The function is a LayerNorm with no affine over the last axis of x [b, n, d]
(float32 statistics, eps 1e-6), then `y * (1 + scale) + shift` with scale
and shift [b, d] (or [1, d], broadcast over the batch) broadcast over the
rows. It is the counterpart of the Pallas probe kernel `ln_modulate_pallas`
of the JAX package's `tools/fusion_probe.py` (body `_ln_mod_kernel`, P5),
and the DiT calls it at each of its 2 depth + 1 norms (models/blocks.py
`AdaLayerNormZero`, the feed-forward norm of `DiTBlock.steps`,
`AdaLayerNormZeroFinal`) through `ln_modulate`:
  - CPU tensors run `ln_modulate_chain`, the blocks' own expression:
    `layer_norm(x)` rounded to x's dtype, then modulated in that dtype
    (through autograd when a gradient is wanted);
  - CUDA tensors launch the forward kernel, which computes
    `ln_modulate_plain`: the statistics and the modulation in float32, one
    rounding to the output's dtype. In bf16 the card thus rounds once where
    the CPU rounds after the norm and after each step of the modulation;
  - with a gradient (`LnModulateFn`) the forward kernel also writes each
    row's mean and rstd in float32 ([b, n]; the backward reads them rather
    than recomputing them), x and those are all that is saved, and the
    backward kernel writes dx = rstd (g - mean(g) - xhat mean(g xhat)) with
    g = dy (1 + scale), all in float32, and for each tile of TILE rows of
    one batch item the partial column sums of dy xhat and dy in float32,
    which torch then sums over the tiles in a fixed order: dscale and
    dshift, deterministic (no atomics). `ln_modulate_bwd_plain` is its
    function;
  - without one (sampling, serving, exported programs) the call is the
    registered operator `torch.ops.f5_tts_tpu_torch.ln_modulate`
    (`ln_modulate_op`), so a program traced with torch.export records one
    call a norm, which runs the chain on the CPU and the kernel on the card.

The port computes every row for any n. The TPU kernel's grid is n // 256
blocks of 256 rows, so it leaves rows past n // 256 * 256 unwritten; the two
agree wherever the TPU kernel writes.

Both kernels are bound by bytes (a row reduction over d and an elementwise
epilogue): the forward reads x and writes the output, 4 bytes an element in
bf16, the backward reads x and dy and writes dx, 6 bytes an element, plus
the partial sums. A program takes whole rows (d in one block of the next
power of two), ROWS of them at a time, each program's rows within one batch
item so that scale and shift load once. The row count, the tile count and
the batch strides are not specialised by Triton, so one compile serves
every sequence length. The kernels compile at first use; Triton's cache
goes under the git-ignored `build/` directory beside the package unless
TRITON_CACHE_DIR is set. Counts: `ln_modulate.launches` (forward kernel)
and `ln_modulate.launches_bwd` (backward kernel).
"""

from __future__ import annotations

import functools

import torch

from f5_tts_tpu_torch.ops.cuda_build import import_triton
from f5_tts_tpu_torch.utils.modules import layer_norm

EPS = 1e-6
_DTYPES = (torch.bfloat16, torch.float32)
MAX_DIM = 16384  # one row in one block
TILE = 32  # rows of one batch item a backward program sums its partials over


def ln_modulate_chain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The DiT blocks' AdaLN expression, which CPU tensors run: the
    LayerNorm rounded to x's dtype, then `* (1 + scale) + shift` in the
    promoted dtype of x, scale and shift."""
    return layer_norm(x, eps=EPS) * (1 + scale[:, None]) + shift[:, None]


def ln_modulate_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """x [b, n, d], scale and shift [b or 1, d] -> [b, n, d] in the promoted
    dtype of the three, with the Pallas body's arithmetic (and the forward
    kernel's): float32 mean, centred variance, rsqrt, then
    y * (1 + scale) + shift in float32, rounded once."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    out = y * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]
    return out.to(_out_dtype(x, scale, shift))


def ln_stats_plain(x: torch.Tensor, eps: float = EPS) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's float32 mean and rstd [b, n], as the forward kernel writes
    them for the backward."""
    xf = x.float()
    mean = xf.mean(dim=-1)
    xc = xf - mean[..., None]
    return mean, torch.rsqrt((xc * xc).mean(dim=-1) + eps)


def ln_modulate_bwd_plain(x, dy, scale, mean, rstd) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel's function, in float32: (dx [b, n, d], dscale
    and dshift [b, d], summed over the batch too where scale is [1, d])."""
    xhat = (x.float() - mean[..., None]) * rstd[..., None]
    dyf = dy.float()
    g = dyf * (1.0 + scale.float()[:, None, :])
    dx = rstd[..., None] * (g - g.mean(dim=-1, keepdim=True) - xhat * (g * xhat).mean(dim=-1, keepdim=True))
    dscale, dshift = (dyf * xhat).sum(dim=1), dyf.sum(dim=1)
    if scale.shape[0] == 1:
        dscale, dshift = dscale.sum(dim=0, keepdim=True), dshift.sum(dim=0, keepdim=True)
    return dx, dscale, dshift


def _out_dtype(x, scale, shift) -> torch.dtype:
    return torch.promote_types(torch.promote_types(x.dtype, scale.dtype), shift.dtype)


@functools.lru_cache(maxsize=None)
def _kernels():
    triton = import_triton()
    import triton.language as tl

    @triton.jit(do_not_specialize=["n", "sx_b", "so_b"])
    def ln_modulate_fwd_kernel(x_ptr, scale_ptr, shift_ptr, out_ptr, mean_ptr, rstd_ptr, n, d, sx_b, sx_n, ss_b,
                               st_b, so_b, so_n, eps, ROWS: tl.constexpr, BLOCK_D: tl.constexpr,
                               STATS: tl.constexpr):
        bi = tl.program_id(1).to(tl.int64)
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK_D)
        live = rows < n
        keep = live[:, None] & (cols < d)[None, :]
        r = rows.to(tl.int64)[:, None]
        x = tl.load(x_ptr + bi * sx_b + r * sx_n + cols[None, :], mask=keep, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / d
        xc = tl.where(keep, x - mean[:, None], 0.0)
        rstd = tl.rsqrt(tl.sum(xc * xc, axis=1) / d + eps)
        s = tl.load(scale_ptr + bi * ss_b + cols, mask=cols < d, other=0.0).to(tl.float32)
        t = tl.load(shift_ptr + bi * st_b + cols, mask=cols < d, other=0.0).to(tl.float32)
        y = xc * rstd[:, None] * (1.0 + s[None, :]) + t[None, :]
        tl.store(out_ptr + bi * so_b + r * so_n + cols[None, :], y.to(out_ptr.dtype.element_ty), mask=keep)
        if STATS:
            tl.store(mean_ptr + bi * n + rows, mean, mask=live)
            tl.store(rstd_ptr + bi * n + rows, rstd, mask=live)

    @triton.jit(do_not_specialize=["n", "tiles", "sx_b", "sg_b", "sd_b"])
    def ln_modulate_bwd_kernel(x_ptr, dy_ptr, scale_ptr, mean_ptr, rstd_ptr, dx_ptr, part_ptr, n, d, tiles, sx_b,
                               sx_n, sg_b, sg_n, ss_b, sd_b, sd_n, TILE: tl.constexpr, ROWS: tl.constexpr,
                               BLOCK_D: tl.constexpr):
        tile = tl.program_id(0)
        bi = tl.program_id(1).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        s1 = 1.0 + tl.load(scale_ptr + bi * ss_b + cols, mask=cols < d, other=0.0).to(tl.float32)
        acc_s = tl.zeros([BLOCK_D], dtype=tl.float32)
        acc_t = tl.zeros([BLOCK_D], dtype=tl.float32)
        for r0 in range(0, TILE, ROWS):
            rows = tile * TILE + r0 + tl.arange(0, ROWS)
            live = rows < n
            keep = live[:, None] & (cols < d)[None, :]
            r = rows.to(tl.int64)[:, None]
            x = tl.load(x_ptr + bi * sx_b + r * sx_n + cols[None, :], mask=keep, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + bi * sg_b + r * sg_n + cols[None, :], mask=keep, other=0.0).to(tl.float32)
            mean = tl.load(mean_ptr + bi * n + rows, mask=live, other=0.0)
            rstd = tl.load(rstd_ptr + bi * n + rows, mask=live, other=0.0)
            xhat = tl.where(keep, (x - mean[:, None]) * rstd[:, None], 0.0)
            g = dy * s1[None, :]
            c1 = tl.sum(g * xhat, axis=1) / d
            c2 = tl.sum(g, axis=1) / d
            dx = rstd[:, None] * (g - c2[:, None] - xhat * c1[:, None])
            tl.store(dx_ptr + bi * sd_b + r * sd_n + cols[None, :], dx.to(dx_ptr.dtype.element_ty), mask=keep)
            acc_s += tl.sum(dy * xhat, axis=0)
            acc_t += tl.sum(dy, axis=0)
        part = part_ptr + ((bi * tiles + tile) * 2) * d + cols  # part [b, tiles, 2, d]
        tl.store(part, acc_s, mask=cols < d)
        tl.store(part + d, acc_t, mask=cols < d)

    return triton, ln_modulate_fwd_kernel, ln_modulate_bwd_kernel


def _block(d: int) -> tuple[int, int, int, int]:
    """(BLOCK_D, the forward's ROWS, the backward's ROWS, num_warps): whole
    rows, about 1024 elements a step forward and 2048 backward, the fastest
    of a sweep at [16, 2400, 1024] bf16 on the H100 (TILE too)."""
    block_d = 1 << (d - 1).bit_length()
    return block_d, max(1, 1024 // block_d), max(1, 2048 // block_d), min(16, max(4, block_d // 512))


def _checked(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    """The kernels' inputs, or ValueError: x [b, n, d] with its last axis
    dense (made so otherwise), scale and shift [b or 1, d] with theirs
    dense; returns x and each one's batch stride (0 where it is [1, d])."""
    if x.device.type != "cuda":
        raise ValueError(f"the ln_modulate kernels take CUDA tensors, not {x.device.type}")
    if x.ndim != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"ln_modulate takes x [b, n, d] in {_DTYPES}; got {x.dtype} {tuple(x.shape)}")
    b, n, d = x.shape
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"ln_modulate takes 1 <= d <= {MAX_DIM}; got {d}")
    strides = []
    for name, t in (("scale", scale), ("shift", shift)):
        if t.ndim != 2 or t.shape[1] != d or t.shape[0] not in (1, b) or t.device != x.device or t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be [{b} or 1, {d}] in {_DTYPES} on {x.device}; got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.stride(1) != 1:
            raise ValueError(f"{name} must be dense along d; got strides {t.stride()}")
        strides.append(_batch_stride(t))
    return (x if x.stride(-1) == 1 else x.contiguous()), strides


def _batch_stride(t: torch.Tensor) -> int:
    """A [b or 1, d] tensor's batch stride as the kernels read it: 0 where
    it is broadcast over the batch."""
    return 0 if t.shape[0] == 1 else t.stride(0)


def _forward(x, scale, shift, stats: bool):
    """Launch the forward kernel on checked inputs; returns (x as the kernel
    read it, out, mean, rstd), the statistics None without `stats`."""
    x, (ss_b, st_b) = _checked(x, scale, shift)
    b, n, d = x.shape
    out = torch.empty((b, n, d), dtype=_out_dtype(x, scale, shift), device=x.device)
    mean = rstd = None
    if stats:
        mean, rstd = (torch.empty((b, n), dtype=torch.float32, device=x.device) for _ in range(2))
    if b * n:
        triton, kernel, _ = _kernels()
        block_d, rows, _, warps = _block(d)
        with torch.cuda.device(x.device):
            kernel[(triton.cdiv(n, rows), b)](
                x, scale, shift, out, mean if stats else out, rstd if stats else out, n, d, x.stride(0),
                x.stride(1), ss_b, st_b, out.stride(0), out.stride(1), EPS, ROWS=rows, BLOCK_D=block_d,
                STATS=stats, num_warps=warps)
        ln_modulate.launches += 1
    return x, out, mean, rstd


def _backward(x, dy, scale, mean, rstd, shift_dtype: torch.dtype):
    """Launch the backward kernel; returns (dx in x's dtype, dscale in
    scale's, dshift in `shift_dtype`), dscale and dshift in scale's shape."""
    b, n, d = x.shape
    if dy.stride(-1) != 1:
        dy = dy.contiguous()
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    tiles = -(-n // TILE)
    part = torch.empty((b, tiles, 2, d), dtype=torch.float32, device=x.device)
    if b * n:
        triton, _, kernel = _kernels()
        block_d, _, rows, warps = _block(d)
        with torch.cuda.device(x.device):
            kernel[(tiles, b)](x, dy, scale, mean, rstd, dx, part, n, d, tiles, x.stride(0), x.stride(1),
                               dy.stride(0), dy.stride(1), _batch_stride(scale), dx.stride(0), dx.stride(1),
                               TILE=TILE, ROWS=min(rows, TILE), BLOCK_D=block_d, num_warps=warps)
        ln_modulate.launches_bwd += 1
    sums = part.sum(dim=1)  # [b, 2, d], over the tiles in a fixed order
    if scale.shape[0] == 1:
        sums = sums.sum(dim=0, keepdim=True)
    return dx, sums[:, 0].to(scale.dtype), sums[:, 1].to(shift_dtype)


@torch.library.custom_op("f5_tts_tpu_torch::ln_modulate", mutates_args=(), device_types="cpu",
                         schema="(Tensor x, Tensor scale, Tensor shift) -> Tensor")
def ln_modulate_op(x, scale, shift):
    """LayerNorm + modulate as an operator; this body is the CPU one, the
    blocks' chain."""
    return ln_modulate_chain(x, scale, shift)


@ln_modulate_op.register_kernel("cuda")
def _ln_modulate_cuda(x, scale, shift):
    return _forward(x, scale, shift, stats=False)[1]


@ln_modulate_op.register_fake
def _ln_modulate_fake(x, scale, shift):
    return x.new_empty(x.shape, dtype=_out_dtype(x, scale, shift))


class LnModulateFn(torch.autograd.Function):
    """LayerNorm + modulate on CUDA tensors with its backward kernel;
    gradients flow to x, scale and shift. Saves x and each row's float32
    mean and rstd, no float32 copy of the activations."""

    @staticmethod
    def forward(ctx, x, scale, shift):
        x, out, mean, rstd = _forward(x, scale, shift, stats=True)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.shift_dtype = shift.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        x, scale, mean, rstd = ctx.saved_tensors
        return _backward(x, dy, scale, mean, rstd, ctx.shift_dtype)


def ln_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """LayerNorm (no affine, float32 statistics, eps 1e-6) of x [b, n, d],
    then `* (1 + scale) + shift` with scale and shift [b or 1, d]; every
    row. Differentiable in all three. CPU tensors run the blocks' chain
    (`ln_modulate_chain`); CUDA tensors launch the kernels (see the module's
    docstring), and anything they do not take raises ValueError."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad or shift.requires_grad):
        if x.device.type == "cpu":
            return ln_modulate_chain(x, scale, shift)
        return LnModulateFn.apply(x, scale, shift)
    return ln_modulate_op(x, scale, shift)


ln_modulate.launches = 0
ln_modulate.launches_bwd = 0
