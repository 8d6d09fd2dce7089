"""The probe tools' attention variants: the CUDA kernels' wrappers and their
plain versions.

Four functions, one kernel template (csrc/attn_variants.cu, whose header
note gives the design), each with its own launch count:
  - `attn_pack2` and `attn_flat`: softmax(q k^T * scale) v over [b, h, n, d]
    with no mask and no rotary embedding; the kernel takes two heads per
    block for the first and one for the second;
  - `flash_bhnd_rope` ([b, h, n, d]) and `flash_nhd` ([b, n, h, d]): the same
    attention after a rotary embedding of q and k written as a product with
    an input matrix P, x * cos + (x @ P) * sin, computed in q's dtype.

They are the counterparts of the Pallas probe kernels of the JAX package's
`tools/attn_variants.py` and `tools/fusion_probe.py`, and the plain versions
round where those kernel bodies round: float32 scores times `scale`;
p = exp(s - rowmax) in float32, cast unnormalised to v's dtype for the PV
product; PV in float32 divided by the float32 row sum of p; the output cast
to q's dtype. For the rotary embedding, cos, sin and P are cast to q's dtype
first, x @ P is taken in float32 and cast back, and each product and the sum
round to q's dtype. The tables' first n rows are used.

CPU tensors run the plain versions (any dtype, any n, any head dim); CUDA
tensors launch the kernel, which takes bfloat16 at head dims 64 and 128 and
raises ValueError for anything else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from f5_tts_tpu_torch.ops import cuda_build
from f5_tts_tpu_torch.ops.flash_attention import _layout_ok

SOURCE = cuda_build.CSRC / "attn_variants.cu"
HEAD_DIMS = (64, 128)
MAX_HEAD_BLOCKS = 65535  # the grid's y dimension


# ------------------------------------------------------------ plain versions


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Softmax attention over [..., n, d] with the Pallas probe kernels'
    rounding points (module docstring)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / denom).to(q.dtype)


def rope_plain(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """x * cos + (x @ P) * sin on x [..., n, d] in x's dtype: the tables' first
    n rows and P cast to x's dtype, x @ P in float32 cast back."""
    n = x.shape[-2]
    dt = x.dtype
    cos, sin, P = cos[:n].to(dt), sin[:n].to(dt), P.to(dt)
    return x * cos + torch.matmul(x.float(), P.float()).to(dt) * sin


def flash_bhnd_rope_plain(q, k, v, cos, sin, P, scale: float) -> torch.Tensor:
    """`flash_bhnd_rope`'s function on [b, h, n, d]."""
    return attention_plain(rope_plain(q, cos, sin, P), rope_plain(k, cos, sin, P), v, scale)


def flash_nhd_plain(q, k, v, cos, sin, P, scale: float) -> torch.Tensor:
    """`flash_nhd`'s function on [b, n, h, d]."""
    bhnd = [t.transpose(1, 2) for t in (q, k, v)]
    return flash_bhnd_rope_plain(*bhnd, cos, sin, P, scale).transpose(1, 2)


# ------------------------------------------------------------ the kernel


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build(SOURCE)[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.f5_attn_variant.argtypes = [ptr] * 7 + [i32] * 5 + [i64] * 12 + [ctypes.c_float, ptr]
    lib.f5_attn_variant.restype = i32
    lib.f5_attn_variant_error_string.argtypes = [i32]
    lib.f5_attn_variant_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, q, k, v, rope, heads_per_block: int) -> None:
    """Raise ValueError for CUDA inputs the kernel does not take; q, k, v are
    [b, h, n, d] views."""
    b, h, n, d = q.shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name} runs bfloat16 on the card (head dims {HEAD_DIMS}); got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} runs head dims {HEAD_DIMS} in bfloat16 on the card; got head dim {d}")
    if n < 1:
        raise ValueError(f"{name} needs at least one key")
    for label, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{label} is {x.dtype} {tuple(x.shape)} on {x.device}; "
                             f"q is {q.dtype} {tuple(q.shape)} on {q.device}")
        if not _layout_ok(x):
            raise ValueError(f"{name} needs a contiguous head dim, strides that are multiples of 8 and a "
                             f"16-byte aligned start; {label} has strides {x.stride()}")
    if rope is not None:
        cos, sin, P = rope
        for label, t in (("cos", cos), ("sin", sin)):
            if t.ndim != 2 or t.shape[0] < n or t.shape[1] != d or t.device != q.device:
                raise ValueError(f"{label} must be [n' >= {n}, {d}] on {q.device}; got {tuple(t.shape)}")
        if P.shape != (d, d) or P.device != q.device:
            raise ValueError(f"P must be [{d}, {d}] on {q.device}; got {tuple(P.shape)}")
    if -(-b * h // heads_per_block) > MAX_HEAD_BLOCKS:
        raise ValueError(f"{name} takes at most {MAX_HEAD_BLOCKS * heads_per_block} heads; got b * h = {b * h}")


def _launch(q, k, v, o, scale: float, heads_per_block: int, rope) -> None:
    """Launch the kernel on [b, h, n, d] views (o written in place)."""
    b, h, n, d = q.shape
    cos = sin = P = None
    if rope is not None:
        cos, sin, P = (t.float().contiguous() for t in (rope[0][:n], rope[1][:n], rope[2]))
    strides = [s for x in (q, k, v, o) for s in x.stride()[:3]]
    lib = _library()
    with torch.cuda.device(q.device):
        err = lib.f5_attn_variant(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            None if P is None else P.data_ptr(),
            b * h, h, n, d, heads_per_block, *strides, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"attention variant kernel launch failed: {lib.f5_attn_variant_error_string(err).decode()}")


def _run(fn, name: str, q, k, v, scale, heads_per_block: int, rope=None, nhd: bool = False) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {q.device.type}")
    out = torch.empty_like(q)
    views = [t.transpose(1, 2) if nhd else t for t in (q, k, v, out)]
    _check(name, *views[:3], rope, heads_per_block)
    _launch(*views, scale, heads_per_block, rope)
    fn.launches += 1
    return out


def attn_pack2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention over [b, h, n, d], no mask, no rotary embedding; on the card
    two heads of the flat b * h index per block (the last block of an odd
    b * h takes one)."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    return _run(attn_pack2, "attn_pack2", q, k, v, scale, 2)


def attn_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """`attn_pack2`'s function; on the card one head of the flat b * h index
    per block."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    return _run(attn_flat, "attn_flat", q, k, v, scale, 1)


def flash_bhnd_rope(q, k, v, cos, sin, P, scale: float) -> torch.Tensor:
    """Attention over [b, h, n, d] after the rotary embedding
    x * cos + (x @ P) * sin of q and k; cos and sin [n' >= n, d] (first n
    rows), P [d, d]."""
    if q.device.type == "cpu":
        return flash_bhnd_rope_plain(q, k, v, cos, sin, P, scale)
    return _run(flash_bhnd_rope, "flash_bhnd_rope", q, k, v, scale, 1, (cos, sin, P))


def flash_nhd(q, k, v, cos, sin, P, scale: float) -> torch.Tensor:
    """`flash_bhnd_rope`'s function on q, k, v and the output in the
    [b, n, h, d] layout, read and written in place through strides."""
    if q.device.type == "cpu":
        return flash_nhd_plain(q, k, v, cos, sin, P, scale)
    return _run(flash_nhd, "flash_nhd", q, k, v, scale, 1, (cos, sin, P), nhd=True)


for _fn in (attn_pack2, attn_flat, flash_bhnd_rope, flash_nhd):
    _fn.launches = 0
