"""The probe tools' attention variants: the CUDA kernels' wrappers and their
plain versions.

Four functions, each with its own launch count (one a wrapper call):
  - `attn_pack2` and `attn_flat`: softmax(q k^T * scale) v over [b, h, n, d]
    with no mask and no rotary embedding. Both run the TMA + wgmma attention
    core (csrc/attn_core.cuh, built from csrc/attn_rope_wgmma.cu) over q, k
    and v in place: the Pallas kernels' two grids (two heads a step, a flat
    b * h index) are TPU grid choices, and on the card each head has its own
    blocks;
  - `flash_bhnd_rope` ([b, h, n, d]) and `flash_nhd` ([b, n, h, d]): the same
    attention after a rotary embedding of q and k written as a product with
    an input matrix P, x * cos + (x @ P) * sin, computed in q's dtype. Both
    run csrc/attn_rope_wgmma.cu: a pre-pass that rotates q and k once into a
    bf16 scratch (`rope_prepass_plain` is its function), then the core over
    the scratch and v. The sources' header notes give the designs.

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

ROPE_SOURCE = cuda_build.CSRC / "attn_rope_wgmma.cu"
HEAD_DIMS = (64, 128)
MAX_HEAD_BLOCKS = 65535  # the grid's y dimension
ROPE_ROW_PAD = 128  # the RoPE kernels' scratch rows: n rounded up to a multiple of this


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


def rope_prepass_plain(q, k, cos, sin, P, n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The RoPE kernels' pre-pass: rope(q) and rope(k) of [b, h, n, d] views
    as [b * h, n_pad, d] in q's dtype, rows n to n_pad zero."""
    b, h, n, d = q.shape
    out = []
    for x in (q, k):
        pad = x.new_zeros(b * h, n_pad, d)
        pad[:, :n] = rope_plain(x, cos, sin, P).reshape(b * h, n, d)
        out.append(pad)
    return out[0], out[1]


# ------------------------------------------------------------ the kernel


@functools.lru_cache(maxsize=None)
def _core_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build(ROPE_SOURCE)[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.f5_rope_prepass.argtypes = [ptr] * 6 + [i32] * 5 + [i64] * 6 + [i32, ptr]
    lib.f5_rope_prepass.restype = i32
    lib.f5_rope_attention.argtypes = [ptr] * 8 + [i32] * 5 + [i64] * 12 + [ctypes.c_float, i32, ptr]
    lib.f5_rope_attention.restype = i32
    lib.f5_attention.argtypes = [ptr] * 4 + [i32] * 4 + [i64] * 12 + [ctypes.c_float, i32, ptr]
    lib.f5_attention.restype = i32
    lib.f5_rope_attention_error_string.argtypes = [i32]
    lib.f5_rope_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, q, k, v, rope, nhd: bool = False) -> tuple:
    """Raise ValueError for CUDA inputs the kernels do not take; q, k, v are
    [b, h, n, d], or [b, n, h, d] with `nhd`. Returns (b, h, n, d) and the
    (batch, head, row) strides of q, k and v, nine ints. Each tensor's
    strides and address are read once, and devices as indices: the RoPE
    kernels' whole call takes a few tens of us of device time, so the host's
    work shows."""
    shape = q.shape
    b, h, n, d = (shape[0], shape[2], shape[1], shape[3]) if nhd else shape
    if q.dtype != torch.bfloat16:
        raise ValueError(f"{name} runs bfloat16 on the card (head dims {HEAD_DIMS}); got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name} runs head dims {HEAD_DIMS} in bfloat16 on the card; got head dim {d}")
    if n < 1:
        raise ValueError(f"{name} needs at least one key")
    dev = q.get_device()
    strides = []
    for label, x in (("q", q), ("k", k), ("v", v)):
        if x.shape != shape or x.dtype != q.dtype or x.get_device() != dev:
            raise ValueError(f"{label} is {x.dtype} {tuple(x.shape)} on {x.device}; "
                             f"q is {q.dtype} {tuple(shape)} on {q.device}")
        s = x.stride()
        if s[3] != 1 or s[0] % 8 or s[1] % 8 or s[2] % 8 or x.data_ptr() % 16:  # 16 bytes: 8 bf16
            raise ValueError(f"{name} needs a contiguous head dim, strides that are multiples of 8 and a "
                             f"16-byte aligned start; {label} has strides {s}")
        strides += (s[0], s[2], s[1]) if nhd else s[:3]
    if rope is not None:
        cos, sin, P = rope
        for label, t in (("cos", cos), ("sin", sin)):
            if t.ndim != 2 or t.shape[0] < n or t.shape[1] != d or t.get_device() != dev:
                raise ValueError(f"{label} must be [n' >= {n}, {d}] on {q.device}; got {tuple(t.shape)}")
        if P.shape != (d, d) or P.get_device() != dev:
            raise ValueError(f"P must be [{d}, {d}] on {q.device}; got {tuple(P.shape)}")
    if b * h > MAX_HEAD_BLOCKS:
        raise ValueError(f"{name} takes at most {MAX_HEAD_BLOCKS} heads; got b * h = {b * h}")
    return b, h, n, d, strides


# ------------------------------------------------------------ the TMA + wgmma core


def _core_error(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.f5_rope_attention_error_string(err).decode()}")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """t as a tensor map can take it: copied contiguous if a stride is zero
    (an expanded tensor), else as it is."""
    return t.contiguous() if 0 in t.stride() else t


def _run_core(fn, name: str, q, k, v, scale: float) -> torch.Tensor:
    """The core alone over [b, h, n, d] tensors in place, on the current
    stream of q's device (which need not be the current device): one count
    on `fn`."""
    if not q.is_cuda:
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {q.device.type}")
    q, k, v = _dense(q), _dense(k), _dense(v)
    b, h, n, d, strides = _check(name, q, k, v, None)
    out = torch.empty_like(q)
    dev = q.get_device()
    lib = _core_library()
    err = lib.f5_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n, d, *strides, *out.stride()[:3],
        float(scale), dev, torch._C._cuda_getCurrentRawStream(dev),  # the raw stream getter torch's compiled code calls
    )
    _core_error(lib, err, "attention core")
    fn.launches += 1
    return out


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A table or P as the RoPE kernels read it: float32 and contiguous (no
    copy when it already is; the kernels read a table's first n rows)."""
    return t if t.dtype == torch.float32 and t.is_contiguous() else t.float().contiguous()


def _run_rope(fn, name: str, q, k, v, cos, sin, P, scale: float, nhd: bool) -> torch.Tensor:
    """The pre-pass into a fresh scratch, then the attention kernel, on the
    current stream of q's device (which need not be the current device):
    one count on `fn`."""
    if not q.is_cuda:
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {q.device.type}")
    v = _dense(v)  # q and k are read by the pre-pass, v by a tensor map
    b, h, n, d, strides = _check(name, q, k, v, (cos, sin, P), nhd)
    out = torch.empty_like(q)
    s = out.stride()
    n_pad = -(-n // ROPE_ROW_PAD) * ROPE_ROW_PAD
    cos, sin, P = _f32(cos), _f32(sin), _f32(P)
    rot = q.new_empty((2, b * h, n_pad, d))
    dev = q.get_device()
    lib = _core_library()
    err = lib.f5_rope_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), cos.data_ptr(), sin.data_ptr(), P.data_ptr(),
        rot.data_ptr(), b, h, n, n_pad, d, *strides, *((s[0], s[2], s[1]) if nhd else s[:3]), float(scale),
        dev, torch._C._cuda_getCurrentRawStream(dev),  # the raw stream getter torch's compiled code calls
    )
    _core_error(lib, err, "RoPE attention kernel")
    fn.launches += 1
    return out


def attn_pack2(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention over [b, h, n, d], no mask, no rotary embedding; on the card
    the TMA + wgmma core, 128 query rows of one head per block, reading q, k
    and v through their strides."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    return _run_core(attn_pack2, "attn_pack2", q, k, v, scale)


def attn_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """`attn_pack2`'s function (the Pallas kernel's flat b * h grid); on the
    card the same TMA + wgmma core, counted on `attn_flat`."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale)
    return _run_core(attn_flat, "attn_flat", q, k, v, scale)


def flash_bhnd_rope(q, k, v, cos, sin, P, scale: float) -> torch.Tensor:
    """Attention over [b, h, n, d] after the rotary embedding
    x * cos + (x @ P) * sin of q and k; cos and sin [n' >= n, d] (first n
    rows), P [d, d]."""
    if q.is_cpu:
        return flash_bhnd_rope_plain(q, k, v, cos, sin, P, scale)
    return _run_rope(flash_bhnd_rope, "flash_bhnd_rope", q, k, v, cos, sin, P, scale, nhd=False)


def flash_nhd(q, k, v, cos, sin, P, scale: float) -> torch.Tensor:
    """`flash_bhnd_rope`'s function on q, k, v and the output in the
    [b, n, h, d] layout, read and written in place through strides."""
    if q.is_cpu:
        return flash_nhd_plain(q, k, v, cos, sin, P, scale)
    return _run_rope(flash_nhd, "flash_nhd", q, k, v, cos, sin, P, scale, nhd=True)


def rope_prepass(q, k, cos, sin, P, n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The RoPE kernels' pre-pass alone (`rope_prepass_plain`'s function):
    rope(q), rope(k) of [b, h, n, d] views as [b * h, n_pad, d]; on the card
    n_pad is a multiple of ROPE_ROW_PAD and the two are views of one
    scratch."""
    if q.is_cpu:
        return rope_prepass_plain(q, k, cos, sin, P, n_pad)
    if not q.is_cuda:
        raise ValueError(f"rope_prepass runs on CPU or CUDA tensors, not {q.device.type}")
    b, h, n, d, strides = _check("rope_prepass", q, k, k, (cos, sin, P))
    if n_pad < n or n_pad % ROPE_ROW_PAD:
        raise ValueError(f"n_pad must be a multiple of {ROPE_ROW_PAD} of at least n = {n}; got {n_pad}")
    cos, sin, P = _f32(cos), _f32(sin), _f32(P)
    rot = q.new_empty((2, b * h, n_pad, d))
    dev = q.get_device()
    lib = _core_library()
    err = lib.f5_rope_prepass(
        q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(), P.data_ptr(), rot.data_ptr(),
        b, h, n, n_pad, d, *strides[:6], dev, torch._C._cuda_getCurrentRawStream(dev),
    )
    _core_error(lib, err, "RoPE pre-pass kernel")
    rope_prepass.launches += 1
    return rot[0], rot[1]


for _fn in (attn_pack2, attn_flat, flash_bhnd_rope, flash_nhd, rope_prepass):
    _fn.launches = 0
