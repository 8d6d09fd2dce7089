"""LayerNorm + modulate: the Triton kernel's wrapper and its plain version.

The counterpart of the Pallas probe kernel `ln_modulate_pallas` of the JAX
package's `tools/fusion_probe.py` (body `_ln_mod_kernel`): a LayerNorm with
no affine over the last axis (float32 statistics, eps 1e-6), then
`y * (1 + scale) + shift` in float32 with scale and shift [b, d] broadcast
over the rows, cast to x's dtype.

The port computes every row for any n. The TPU kernel's grid is n // 256
blocks of 256 rows, so it leaves rows past n // 256 * 256 unwritten; the two
agree wherever the TPU kernel writes.

The kernel is Triton (the work is one row reduction over d plus an
elementwise epilogue, memory-bound): one program per row, the whole row in
one block of the next power of two above d, statistics in float32. It is
compiled at first use; Triton's cache goes under the git-ignored `build/`
directory beside the package unless TRITON_CACHE_DIR is set. CPU tensors
run `ln_modulate_plain`; CUDA tensors launch the kernel, counted by
`ln_modulate.launches`.
"""

from __future__ import annotations

import functools

import torch

from f5_tts_tpu_torch.ops.cuda_build import import_triton

EPS = 1e-6
_DTYPES = (torch.bfloat16, torch.float32)
MAX_DIM = 16384  # one row in one block


def ln_modulate_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """x [b, n, d], scale and shift [b, d] -> [b, n, d] in x's dtype, with
    the Pallas body's arithmetic: float32 mean, centred variance, rsqrt,
    then y * (1 + scale) + shift in float32."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _kernel():
    triton = import_triton()
    import triton.language as tl

    @triton.jit
    def ln_modulate_kernel(x_ptr, scale_ptr, shift_ptr, out_ptr, n, d, sx_b, sx_n, ss_b, st_b, so_b, so_n,
                           eps, BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        b = row // n
        i = row % n
        cols = tl.arange(0, BLOCK_D)
        keep = cols < d
        x = tl.load(x_ptr + b * sx_b + i * sx_n + cols, mask=keep, other=0.0).to(tl.float32)
        mu = tl.sum(x, axis=0) / d
        xc = tl.where(keep, x - mu, 0.0)
        var = tl.sum(xc * xc, axis=0) / d
        y = xc * tl.rsqrt(var + eps)
        s = tl.load(scale_ptr + b * ss_b + cols, mask=keep, other=0.0).to(tl.float32)
        t = tl.load(shift_ptr + b * st_b + cols, mask=keep, other=0.0).to(tl.float32)
        out = y * (1.0 + s) + t
        tl.store(out_ptr + b * so_b + i * so_n + cols, out.to(out_ptr.dtype.element_ty), mask=keep)

    return triton, ln_modulate_kernel


def ln_modulate(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """LayerNorm (no affine, float32 statistics) of x [b, n, d], then
    `* (1 + scale) + shift` with scale and shift [b, d]; every row, in x's
    dtype. CPU tensors run the plain version; CUDA tensors launch the Triton
    kernel, and anything it does not take raises ValueError."""
    if x.device.type == "cpu":
        return ln_modulate_plain(x, scale, shift, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_modulate runs on CPU or CUDA tensors, not {x.device.type}")
    if x.ndim != 3 or x.dtype not in _DTYPES:
        raise ValueError(f"ln_modulate takes x [b, n, d] in {_DTYPES}; got {x.dtype} {tuple(x.shape)}")
    b, n, d = x.shape
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"ln_modulate takes 1 <= d <= {MAX_DIM}; got {d}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.shape != (b, d) or t.device != x.device:
            raise ValueError(f"{name} must be [{b}, {d}] on {x.device}; got {tuple(t.shape)} on {t.device}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    scale, shift = scale.contiguous(), shift.contiguous()
    out = torch.empty((b, n, d), dtype=x.dtype, device=x.device)
    if b * n:
        triton, kernel = _kernel()
        with torch.cuda.device(x.device):
            kernel[(b * n,)](x, scale, shift, out, n, d, x.stride(0), x.stride(1), scale.stride(0),
                             shift.stride(0), out.stride(0), out.stride(1), eps,
                             BLOCK_D=triton.next_power_of_2(d), num_warps=4)
        ln_modulate.launches += 1
    return out


ln_modulate.launches = 0
