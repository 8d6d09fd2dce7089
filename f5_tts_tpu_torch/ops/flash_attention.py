"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions and the autograd function that joins them.

The kernels are compiled with nvcc for sm_90a into shared libraries with a
plain C interface at first use (ops/cuda_build.py) and called through ctypes
on PyTorch's current stream:
  - K1, the forward (csrc/flash_attention_fwd.cu), which can also write each
    row's log-sum-exp for the backward;
  - K2, the backward (csrc/flash_attention_bwd.cu): dq, dk and dv in float32
    from q, k, v, the output's gradient, the log-sum-exp and
    delta = rowsum(g * out).
Each comes in bf16 on the tensor cores and in float32 on the FMA units (no
TF32), for models whose compute dtype is float32. The source notes give the
designs.

`flash_attention` computes softmax(rope(q) rope(k)^T * scale, keys masked by
key_mask) v. When q, k or v requires grad it goes through `FlashAttentionFn`,
whose backward launches K2 for CUDA tensors and runs
`flash_attention_bwd_plain` for CPU tensors; otherwise (every sampling path,
under torch.no_grad) it launches K1 alone, or runs `flash_attention_plain`
for CPU tensors. Counts: `flash_attention.launches` and `.launches_f32` (K1
bf16 and float32), `.launches_bwd` and `.launches_bwd_f32` (K2).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb, rotate_half
from f5_tts_tpu_torch.ops import cuda_build
from f5_tts_tpu_torch.ops.attention import sdpa_reference

SOURCE = cuda_build.CSRC / "flash_attention_fwd.cu"
BWD_SOURCE = cuda_build.CSRC / "flash_attention_bwd.cu"
HEAD_DIMS = (64, 128, 256)
# the C entry point of each kernel, by dtype
_ENTRY = {torch.bfloat16: "f5_flash_attention_fwd", torch.float32: "f5_flash_attention_fwd_f32"}
_BWD_ENTRY = {torch.bfloat16: "f5_flash_attention_bwd", torch.float32: "f5_flash_attention_bwd_f32"}


# ------------------------------------------------------------ plain versions


def _rotated(q, k, rope):
    if rope is None:
        return q, k
    return apply_rotary_pos_emb(q, rope), apply_rotary_pos_emb(k, rope)


def _logits(q, k, scale, key_mask):
    """Scaled float32 scores, masked keys at the float32 minimum."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], torch.finfo(torch.float32).min)
    return logits


def flash_attention_plain(
    q: torch.Tensor,  # [b, h, n, d]
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    key_mask: torch.Tensor | None = None,  # [b, n] bool, True = keep
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,  # (cos, sin), each [n, d] f32
) -> torch.Tensor:
    """K1's function in plain PyTorch: rotary embedding, then
    `sdpa_reference`."""
    q, k = _rotated(q, k, rope)
    return sdpa_reference(q, k, v, scale, key_mask)


def attention_lse_plain(q, k, scale, key_mask=None, rope=None) -> torch.Tensor:
    """The per-row log-sum-exp of the scaled scores that K1 writes for the
    backward, [b, h, n] float32. A row whose keys are all masked is left
    out of the comparison: K1 biases masked keys by -1e30, where this
    version masks with the float32 minimum."""
    q, k = _rotated(q, k, rope)
    return torch.logsumexp(_logits(q, k, scale, key_mask), dim=-1)


def flash_attention_bwd_plain(
    q: torch.Tensor,  # [b, h, n, d]
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,  # the forward's output
    g: torch.Tensor,  # its gradient
    scale: float,
    key_mask: torch.Tensor | None = None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's function in plain PyTorch, float32 dq, dk, dv: the probabilities
    recomputed in float32, delta = rowsum(g * out), dV = P^T g,
    dS = P (g V^T - delta) scale (P and dS rounded to q's dtype before their
    products, as the kernels do), dQ' = dS K', dK' = dS^T Q', then the RoPE
    backward dx = dx' cos + (dx' sin) P^T = dx' cos - rotate_half(dx' sin)."""
    dtype = q.dtype
    qr, kr = _rotated(q, k, rope)
    probs = torch.softmax(_logits(qr, kr, scale, key_mask), dim=-1)
    gf = g.float()
    delta = (gf * out.float()).sum(dim=-1, keepdim=True)
    dv = torch.matmul(probs.to(dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    ds = (probs * (dp - delta) * scale).to(dtype).float()
    dq = torch.matmul(ds, kr.float())
    dk = torch.matmul(ds.transpose(-1, -2), qr.float())
    if rope is not None:
        n = q.shape[-2]
        cos, sin = (t[-n:].to(dtype).float() for t in rope)
        dq = dq * cos - rotate_half(dq * sin)
        dk = dk * cos - rotate_half(dk * sin)
    return dq, dk, dv


# ------------------------------------------------------------ the kernels


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build(SOURCE)[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 8 + [i32] * 4 + [i64] * 12 + [ctypes.c_float, ptr]
        fn.restype = i32
    lib.f5_cuda_error_string.argtypes = [i32]
    lib.f5_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build(BWD_SOURCE)[0]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in _BWD_ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 12 + [i32] * 4 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ptr]
        fn.restype = i32
    lib.f5_cuda_error_string.argtypes = [i32]
    lib.f5_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _layout_ok(x: torch.Tensor) -> bool:
    per16 = 16 // x.element_size()  # elements in 16 bytes
    return x.stride(3) == 1 and not any(s % per16 for s in x.stride()[:3]) and not x.data_ptr() % 16


def _check_bhnd(x: torch.Tensor, name: str, q: torch.Tensor) -> None:
    if x.shape != q.shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(q.shape)}")
    if x.dtype not in _ENTRY or x.dtype != q.dtype:
        raise ValueError(f"the attention kernels take bfloat16 or float32 (all alike); {name} is {x.dtype}")
    if x.device != q.device:
        raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if not _layout_ok(x):
        raise ValueError(
            f"{name} needs a contiguous head dim, strides that are multiples of {16 // x.element_size()} "
            f"and a 16-byte aligned start; got strides {x.stride()}"
        )


def _checked(q, k, v, key_mask, rope):
    """Validate the kernels' inputs; returns (key_mask, cos, sin) as the
    kernels take them."""
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if n < 1:
        raise ValueError("flash_attention needs at least one key")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_bhnd(x, name, q)
    if key_mask is not None:
        if key_mask.shape != (b, n) or key_mask.dtype != torch.bool or key_mask.device != q.device:
            raise ValueError(f"key_mask must be bool [{b}, {n}] on {q.device}")
        key_mask = key_mask.contiguous()
    cos = sin = None
    if rope is not None:
        cos, sin = rope
        for name, tab in (("cos", cos), ("sin", sin)):
            if (tab.shape != (n, d) or tab.dtype != torch.float32 or tab.device != q.device
                    or not tab.is_contiguous() or tab.data_ptr() % 16):
                raise ValueError(f"rope {name} must be a contiguous float32 [{n}, {d}] table on {q.device}")
    return key_mask, cos, sin


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.f5_cuda_error_string(err).decode()}")


def _forward_kernel(q, k, v, scale, key_mask, cos, sin, with_lse: bool):
    """Launch K1 on checked inputs; returns (out, lse or None). The output
    has q's strides when q is dense, else it is contiguous; d stays
    innermost, so the other strides are multiples of d."""
    b, h, n, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    lib = _library()
    with torch.cuda.device(q.device):
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(key_mask),
            _ptr(cos), _ptr(sin), b, h, n, d, *strides, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, lib, "flash attention")
    if q.dtype == torch.float32:
        flash_attention.launches_f32 += 1
    else:
        flash_attention.launches += 1
    return out, lse


def _backward_kernel(q, k, v, out, lse, g, scale, key_mask, cos, sin):
    """Launch K2; returns float32 (dq, dk, dv), contiguous [b, h, n, d]. g
    is taken as a strided view when its layout allows, else made
    contiguous."""
    b, h, n, d = q.shape
    if g.dtype != q.dtype:
        raise ValueError(f"the output's gradient is {g.dtype}, the inputs {q.dtype}")
    if not _layout_ok(g):
        g = g.contiguous()
    delta = (g.float() * out.float()).sum(dim=-1)  # [b, h, n], as the JAX backward computes it
    dq, dk, dv = (torch.empty((b, h, n, d), dtype=torch.float32, device=q.device) for _ in range(3))
    strides = (ctypes.c_longlong * 12)(*[s for x in (q, k, v, g) for s in x.stride()[:3]])
    lib = _bwd_library()
    with torch.cuda.device(q.device):
        err = getattr(lib, _BWD_ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _ptr(key_mask), _ptr(cos), _ptr(sin), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, n, d, strides, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, lib, "flash attention backward")
    if q.dtype == torch.float32:
        flash_attention.launches_bwd_f32 += 1
    else:
        flash_attention.launches_bwd += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention with K1 forward and K2 backward on CUDA tensors, the plain
    versions on CPU tensors. Gradients flow to q, k and v; the mask and the
    rotary tables are constants."""

    @staticmethod
    def forward(ctx, q, k, v, scale, key_mask, cos, sin):
        rope = None if cos is None else (cos, sin)
        lse = None
        if q.device.type == "cpu":
            out = flash_attention_plain(q, k, v, scale, key_mask, rope)
        else:
            key_mask, cos, sin = _checked(q, k, v, key_mask, rope)
            out, lse = _forward_kernel(q, k, v, scale, key_mask, cos, sin, with_lse=True)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse, key_mask, cos, sin)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, key_mask, cos, sin = ctx.saved_tensors
        if q.device.type == "cpu":
            rope = None if cos is None else (cos, sin)
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, g, ctx.scale, key_mask, rope)
        else:
            dq, dk, dv = _backward_kernel(q, k, v, out, lse, g, ctx.scale, key_mask, cos, sin)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [b, h, n, d]
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    key_mask: torch.Tensor | None = None,  # [b, n] bool, True = keep
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,  # (cos, sin), each [n, d] f32
) -> torch.Tensor:
    """Non-causal attention with an optional key mask and in-kernel rotary
    embedding. CPU tensors run the plain versions; CUDA tensors launch the
    kernels of their dtype (bfloat16 or float32), and anything the kernels
    do not take raises ValueError. Differentiable in q, k and v.

    The output has q's shape and dtype (and q's strides when q is dense), so
    a q viewed from a [b, n, h*d] projection gives an output that reshapes
    back to [b, n, h*d] without a copy."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, not {q.device.type}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        cos, sin = (None, None) if rope is None else rope
        return FlashAttentionFn.apply(q, k, v, scale, key_mask, cos, sin)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, key_mask, rope)
    key_mask, cos, sin = _checked(q, k, v, key_mask, rope)
    return _forward_kernel(q, k, v, scale, key_mask, cos, sin, with_lse=False)[0]


flash_attention.launches = 0
flash_attention.launches_f32 = 0
flash_attention.launches_bwd = 0
flash_attention.launches_bwd_f32 = 0
