"""RMSNorm as E2 TTS's UNetT takes it: the Triton kernels' wrappers, their
plain versions and the autograd function.

The function is x_transformers' RMSNorm, which the published UNetT
imports: `F.normalize(x, dim=-1) * sqrt(d) * g`, that is
y = x / max(||x||, 1e-12) * sqrt(d) * g over the last axis of x [..., d]
with a learned g [d]. The UNetT calls it at 2 depth + 1 norms (each
layer's attention and feed-forward norms and the final one). It replaces
no TPU kernel: the JAX package has no UNetT. It is added because the
unfused chain (a square, a sum, a clamp, a division, two products and the
casts, each a launch and a pass over the activations, forward and
backward) is what the DiT's AdaLN cost before its fusion
(ops/ln_modulate.py).
  - CPU tensors run `rms_norm_plain`, the kernels' function (through
    autograd when a gradient is wanted);
  - CUDA tensors launch the forward kernel: each row's inverse norm
    r = 1 / max(||x||, eps) and y = x r sqrt(d) g in float32, rounded once
    to x's dtype. With a gradient (`RmsNormFn`) it also writes r, float32
    [rows], and saves x, g and r; the backward kernel writes
    dx = r (u - xhat sum(u xhat)) with u = dy sqrt(d) g and xhat = x r, and
    for each tile of TILE rows the float32 partial column sums of
    dy xhat sqrt(d), which torch sums over the tiles in a fixed order: dg,
    deterministic (no atomics). `rms_norm_bwd_plain` is its function.

Both kernels are bound by bytes: the forward reads x and writes y (4 bytes
an element in bf16) and r, the backward reads x, dy and r and writes dx (6
bytes an element) and the partials. A program takes whole rows (d in one
block of the next power of two), over the rows of x taken as one [m, d]
matrix (x is made contiguous). The row and tile counts are not
specialised by Triton, so one compile serves every shape of a width. The
kernels compile at first use (Triton's cache as in ops/ln_modulate.py).
Counts: `rms_norm.launches` (forward kernel) and `rms_norm.launches_bwd`
(backward kernel).
"""

from __future__ import annotations

import functools
import math

import torch

from f5_tts_tpu_torch.ops.cuda_build import import_triton

EPS = 1e-12  # F.normalize's floor on the norm
_DTYPES = (torch.bfloat16, torch.float32)
MAX_DIM = 16384  # one row in one block
TILE = 32  # rows a backward program sums its partials over


def rms_norm_stats_plain(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Each row's float32 inverse norm 1 / max(||x||, eps), x's shape
    without its last axis, as the forward kernel writes it."""
    return 1.0 / x.float().square().sum(dim=-1).sqrt().clamp_min(eps)


def rms_norm_plain(x: torch.Tensor, g: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """x [..., d], g [d] -> x / max(||x||, eps) * sqrt(d) * g in float32,
    rounded once to x's dtype (the forward kernel's function)."""
    r = rms_norm_stats_plain(x, eps)
    return (x.float() * r[..., None] * (math.sqrt(x.shape[-1]) * g.float())).to(x.dtype)


def rms_norm_bwd_plain(x: torch.Tensor, dy: torch.Tensor, g: torch.Tensor,
                       r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's function, in float32: (dx [..., d], dg [d])."""
    xhat = x.float() * r[..., None]
    dyf = dy.float()
    s = math.sqrt(x.shape[-1])
    u = dyf * (s * g.float())
    dx = r[..., None] * (u - xhat * (u * xhat).sum(dim=-1, keepdim=True))
    return dx, (dyf * xhat).reshape(-1, x.shape[-1]).sum(dim=0) * s


@functools.lru_cache(maxsize=None)
def _kernels():
    triton = import_triton()
    import triton.language as tl

    @triton.jit(do_not_specialize=["m"])
    def rms_norm_fwd_kernel(x_ptr, g_ptr, out_ptr, r_ptr, m, d, scale, eps, ROWS: tl.constexpr,
                            BLOCK_D: tl.constexpr, STATS: tl.constexpr):
        rows = tl.program_id(0) * ROWS + tl.arange(0, ROWS)
        cols = tl.arange(0, BLOCK_D)
        live = rows < m
        keep = live[:, None] & (cols < d)[None, :]
        off = rows.to(tl.int64)[:, None] * d + cols[None, :]
        x = tl.load(x_ptr + off, mask=keep, other=0.0).to(tl.float32)
        r = 1.0 / tl.maximum(tl.sqrt(tl.sum(x * x, axis=1)), eps)
        sg = scale * tl.load(g_ptr + cols, mask=cols < d, other=0.0).to(tl.float32)
        y = x * r[:, None] * sg[None, :]
        tl.store(out_ptr + off, y.to(out_ptr.dtype.element_ty), mask=keep)
        if STATS:
            tl.store(r_ptr + rows, r, mask=live)

    @triton.jit(do_not_specialize=["m", "tiles"])
    def rms_norm_bwd_kernel(x_ptr, dy_ptr, g_ptr, r_ptr, dx_ptr, part_ptr, m, d, tiles, scale, TILE: tl.constexpr,
                            ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        tile = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        sg = scale * tl.load(g_ptr + cols, mask=cols < d, other=0.0).to(tl.float32)
        acc = tl.zeros([BLOCK_D], dtype=tl.float32)
        for r0 in range(0, TILE, ROWS):
            rows = tile * TILE + r0 + tl.arange(0, ROWS)
            live = rows < m
            keep = live[:, None] & (cols < d)[None, :]
            off = rows.to(tl.int64)[:, None] * d + cols[None, :]
            x = tl.load(x_ptr + off, mask=keep, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + off, mask=keep, other=0.0).to(tl.float32)
            r = tl.load(r_ptr + rows, mask=live, other=0.0)
            xhat = x * r[:, None]
            u = dy * sg[None, :]
            c = tl.sum(u * xhat, axis=1)
            dx = r[:, None] * (u - xhat * c[:, None])
            tl.store(dx_ptr + off, dx.to(dx_ptr.dtype.element_ty), mask=keep)
            acc += tl.sum(dy * xhat, axis=0)
        tl.store(part_ptr + tile.to(tl.int64) * d + cols, acc * scale, mask=cols < d)  # part [tiles, d]

    return triton, rms_norm_fwd_kernel, rms_norm_bwd_kernel


def _block(d: int) -> tuple[int, int, int, int]:
    """(BLOCK_D, the forward's ROWS, the backward's ROWS, num_warps): whole
    rows, about 1024 elements a step forward and 2048 backward, as the AdaLN
    kernels (ops/ln_modulate.py), which have the same shape of work."""
    block_d = 1 << (d - 1).bit_length()
    return block_d, max(1, 1024 // block_d), max(1, 2048 // block_d), min(16, max(4, block_d // 512))


def _checked(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x made contiguous for the kernels, or ValueError: x [..., d] in
    bf16 or float32 on the card, g [d] beside it."""
    if x.device.type != "cuda":
        raise ValueError(f"the rms_norm kernels take CUDA tensors, not {x.device.type}")
    if x.ndim < 1 or x.dtype not in _DTYPES:
        raise ValueError(f"rms_norm takes x [..., d] in {_DTYPES}; got {x.dtype} {tuple(x.shape)}")
    d = x.shape[-1]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"rms_norm takes 1 <= d <= {MAX_DIM}; got {d}")
    if g.shape != (d,) or g.device != x.device or g.dtype not in _DTYPES or g.stride(0) != 1:
        raise ValueError(f"g must be a dense [{d}] vector in {_DTYPES} on {x.device}; got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    return x.contiguous()


def _forward(x, g, stats: bool):
    """Launch the forward kernel on checked inputs; returns (x as the kernel
    read it, out in x's dtype, the rows' inverse norms or None)."""
    x = _checked(x, g)
    d = x.shape[-1]
    m = x.numel() // d
    out = torch.empty_like(x)
    r = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device) if stats else None
    if m:
        triton, kernel, _ = _kernels()
        block_d, rows, _, warps = _block(d)
        with torch.cuda.device(x.device):
            kernel[(triton.cdiv(m, rows),)](x, g, out, r if stats else out, m, d, math.sqrt(d), EPS, ROWS=rows,
                                            BLOCK_D=block_d, STATS=stats, num_warps=warps)
        rms_norm.launches += 1
    return x, out, r


def _backward(x, dy, g, r):
    """Launch the backward kernel; returns (dx in x's dtype, dg in g's)."""
    d = x.shape[-1]
    m = x.numel() // d
    dy = dy.contiguous()
    dx = torch.empty_like(x)
    tiles = -(-m // TILE)
    part = torch.empty((tiles, d), dtype=torch.float32, device=x.device)
    if m:
        triton, _, kernel = _kernels()
        block_d, _, rows, warps = _block(d)
        with torch.cuda.device(x.device):
            kernel[(tiles,)](x, dy, g, r, dx, part, m, d, tiles, math.sqrt(d), TILE=TILE, ROWS=min(rows, TILE),
                             BLOCK_D=block_d, num_warps=warps)
        rms_norm.launches_bwd += 1
    return dx, part.sum(dim=0).to(g.dtype)  # over the tiles in a fixed order


class RmsNormFn(torch.autograd.Function):
    """RMSNorm on CUDA tensors with its backward kernel; gradients flow to x
    and g. Saves x, g and each row's float32 inverse norm."""

    @staticmethod
    def forward(ctx, x, g):
        x, out, r = _forward(x, g, stats=True)
        ctx.save_for_backward(x, g, r)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, g, r = ctx.saved_tensors
        return _backward(x, dy, g, r)


def rms_norm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x / max(||x||, 1e-12) * sqrt(d) * g over the last axis of x [..., d],
    in x's dtype; differentiable in x and g. CPU tensors run
    `rms_norm_plain`; CUDA tensors launch the kernels (see the module's
    docstring), and anything they do not take raises ValueError."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, g)
    if torch.is_grad_enabled() and (x.requires_grad or g.requires_grad):
        return RmsNormFn.apply(x, g)
    return _forward(x, g, stats=False)[1]


rms_norm.launches = 0
rms_norm.launches_bwd = 0
