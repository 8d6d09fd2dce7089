"""Flash attention, forward and backward: the CUDA kernels' wrappers, their
plain versions and the autograd function that joins them.

The kernels are compiled with nvcc for sm_90a into shared libraries with a
plain C interface at first use (ops/cuda_build.py) and called through ctypes
on PyTorch's current stream:
  - K1, the forward (csrc/flash_attention_fwd.cu), which can also write each
    row's log-sum-exp for the backward. In bf16 at d = 64 and 128 a
    pre-pass rotates q and k once into a bf16 scratch and writes each key's
    bias (`flash_prepass` launches it alone; `flash_prepass_plain` is its
    function), then the TMA + wgmma attention core (csrc/attn_core.cuh)
    reads the scratch (or q and k in place without RoPE) and v; at d = 256
    an mma.sync kernel;
  - K2, the backward (csrc/flash_attention_bwd.cu): dq, dk and dv from q,
    k, v, the output, its gradient and the log-sum-exp. A pre-pass kernel
    rotates q and k once and computes delta = rowsum(g * out); in bf16 at
    d = 64 one TMA + wgmma pass over the keys then writes dk and dv and sums
    dq' in float32 in a fixed order (the wrapper allocates the sum and its
    counters), and a conversion kernel writes bf16 dq; at d = 128 a TMA +
    wgmma kernel pair (mma.sync at d = 256) writes bf16 gradients, and the
    float32 kernels float32 ones. `bwd_prepass_plain`, `bwd_main_plain` and
    `bwd_epilogue_plain` are the stages' plain versions;
    `flash_attention_bwd_plain` composes them.
Each comes in bf16 and in float32, for models whose compute dtype is
float32. At d = 64 the float32 kernels run on the tensor cores in 3xTF32
(each operand split into two TF32 halves, three products: as accurate as
float32 FMA; `tf32_split_plain` is the split), after a pre-pass that
rotates and splits the inputs into scratch the wrapper allocates; at d = 128
and 256 on the FMA units. The source notes give the designs.

`flash_attention` computes softmax(rope(q) rope(k)^T * scale, keys masked by
key_mask) v. With `rope_heads` only heads 0 .. rope_heads - 1 are rotated
and the others attend unrotated (E2 TTS's UNetT rotates head 0 alone): the
bf16 pre-passes of K1 (d = 64 and 128) and K2 copy the other heads as they
are and K2's epilogue un-rotates only the first heads' dQ and dK; the
float32 kernels and K1 at d = 256 raise ValueError for it. Such a call goes
through `FlashAttentionFn` or the kernels' wrappers, as a query block does.
`rope_heads=None` (or the head count) rotates every head: the kernels'
launches and bits are those of a call without it. q may be a query block:
[b, h, n_q, d] rows from `q_offset` of a sequence whose n_k keys k and v hold (sequence parallelism in training, a
slot's frames against the keys its group gathered); the tables are the keys'
[n_k, d], and the queries take rows q_offset .. q_offset + n_q - 1 of them.
On the card the bf16 kernels at d = 64 and 128 and the float32 ones at d = 64
take a block; elsewhere a block raises ValueError. A block goes through
`FlashAttentionFn` (with grad) or the kernels' wrappers, never through the
registered operator, whose schema artifacts record.
When q, k or v requires grad it goes through `FlashAttentionFn`,
whose backward launches K2 for CUDA tensors and runs
`flash_attention_bwd_plain` for CPU tensors; otherwise (every sampling path,
under torch.no_grad) it calls K1 alone as the registered operator
`torch.ops.f5_tts_tpu_torch.flash_attention_fwd` (`flash_attention_fwd`),
which launches the kernel for CUDA tensors and runs `flash_attention_plain`
for CPU tensors; `FlashAttentionFn` calls it too, for the kernel and its
log-sum-exp. A program traced with torch.export records the operator, so it
launches the kernel wherever its inputs lie on the card. Counts: `flash_attention.launches` and `.launches_f32` (K1
bf16 and float32; one a call, pre-pass included), `.launches_bwd` and
`.launches_bwd_f32` (K2), of which `.launches_bwd_fused` took the single
pass (bf16, d = 64), `flash_prepass.launches` (K1's pre-pass alone).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb, rotate_half
from f5_tts_tpu_torch.ops import cuda_build
from f5_tts_tpu_torch.ops.attention import sdpa_reference
from f5_tts_tpu_torch.ops.attn_variants import _dense

SOURCE = cuda_build.CSRC / "flash_attention_fwd.cu"
BWD_SOURCE = cuda_build.CSRC / "flash_attention_bwd.cu"
HEAD_DIMS = (64, 128, 256)
CORE_HEAD_DIMS = (64, 128)  # bf16 head dims on the pre-pass + TMA/wgmma core; d = 256 keeps mma.sync
CORE_ROW_PAD = 128  # the core's scratch rows and key biases: n rounded up to a multiple of this
MASKED = -1e30  # the key bias of a masked key: the JAX kernel body's -(1 - mask) * 1e30
# the C entry point of each kernel, by dtype
_ENTRY = {torch.bfloat16: "f5_flash_attention_fwd", torch.float32: "f5_flash_attention_fwd_f32"}
_BWD_ENTRY = {torch.bfloat16: "f5_flash_attention_bwd", torch.float32: "f5_flash_attention_bwd_f32"}
BWD_ROW_PAD = 128  # the row statistics and key biases of the pre-passes are padded to a multiple of this many rows
TC_HEAD_DIM = 64  # the head dim of the float32 kernels on the tensor cores (3xTF32)
PASS_HEAD_DIM = 64  # the bf16 head dim whose backward is one pass over the keys (dK, dV and dQ)
PASS_TILE = 64  # the single pass's query tile: dQ' is summed per tile


# ------------------------------------------------------------ plain versions


def _tables(rope, n_q: int, n_k: int, q_offset: int):
    """(the queries' (cos, sin), the keys' (cos, sin)): the keys take the
    table's last n_k rows, the queries n_q rows from q_offset of those.
    Sliced here, because `apply_rotary_pos_emb` rotates by a table's last
    rows, which would turn a query block as if it ended the sequence."""
    base = rope[0].shape[0] - n_k
    rows = slice(base + q_offset, base + q_offset + n_q)
    return tuple(t[rows] for t in rope), tuple(t[base:] for t in rope)


def partial_heads(rope_heads: int | None, heads: int) -> int | None:
    """`rope_heads` where it leaves heads unrotated, else None (every head
    rotated); ValueError outside 0 .. heads."""
    if rope_heads is None:
        return None
    if not 0 <= rope_heads <= heads:
        raise ValueError(f"rope_heads must lie in 0 .. {heads}; got {rope_heads}")
    return rope_heads if rope_heads < heads else None


def rotate_heads(x: torch.Tensor, tab, rope_heads: int | None = None) -> torch.Tensor:
    """`apply_rotary_pos_emb` of x [b, h, n, d] on its heads 0 ..
    rope_heads - 1 (every head with None); the others as they are."""
    if rope_heads is None:
        return apply_rotary_pos_emb(x, tab)
    return torch.cat([apply_rotary_pos_emb(x[:, :rope_heads], tab), x[:, rope_heads:]], dim=1)


def _rotated(q, k, rope, q_offset: int = 0, rope_heads: int | None = None):
    if rope is None:
        return q, k
    q_tab, k_tab = _tables(rope, q.shape[-2], k.shape[-2], q_offset)
    return rotate_heads(q, q_tab, rope_heads), rotate_heads(k, k_tab, rope_heads)


def _logits(q, k, scale, key_mask):
    """Scaled float32 scores, masked keys at the float32 minimum."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        logits = logits.masked_fill(~key_mask[:, None, None, :], torch.finfo(torch.float32).min)
    return logits


def flash_attention_plain(
    q: torch.Tensor,  # [b, h, n_q, d]
    k: torch.Tensor,  # [b, h, n_k, d]; v too
    v: torch.Tensor,
    scale: float,
    key_mask: torch.Tensor | None = None,  # [b, n_k] bool, True = keep
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,  # (cos, sin), each [n_k, d] f32
    q_offset: int = 0,  # the queries' first table row
    rope_heads: int | None = None,  # the rotated heads (the first ones); None: all
) -> torch.Tensor:
    """K1's function in plain PyTorch: rotary embedding, then
    `sdpa_reference`."""
    q, k = _rotated(q, k, rope, q_offset, rope_heads)
    return sdpa_reference(q, k, v, scale, key_mask)


def attention_lse_plain(q, k, scale, key_mask=None, rope=None, q_offset: int = 0,
                        rope_heads: int | None = None) -> torch.Tensor:
    """The per-row log-sum-exp of the scaled scores that K1 writes for the
    backward, [b, h, n_q] float32. A row whose keys are all masked is left
    out of the comparison: K1 biases masked keys by -1e30, where this
    version masks with the float32 minimum."""
    q, k = _rotated(q, k, rope, q_offset, rope_heads)
    return torch.logsumexp(_logits(q, k, scale, key_mask), dim=-1)


def flash_prepass_plain(
    q: torch.Tensor,  # [b, h, n, d]
    k: torch.Tensor,
    key_mask: torch.Tensor | None,  # [b, n] bool, True = keep
    rope: tuple[torch.Tensor, torch.Tensor] | None,  # (cos, sin), each [n, d] f32
    n_pad: int,
    rope_heads: int | None = None,  # the rotated heads (the first ones); None: all
) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """K1's bf16 pre-pass in plain PyTorch: rope(q) and rope(k) as
    [b * h, n_pad, d] in q's dtype, rows n to n_pad zero (None without
    `rope`), and each key's bias [b, n_pad] float32, 0 kept and -1e30
    masked or past n (None without `key_mask`). The rotation is
    `apply_rotary_pos_emb`'s: x * cos + rotate_half(x) * sin in q's dtype,
    the tables cast first, each product and the sum rounded. Heads from
    `rope_heads` on are copied unrotated."""
    b, h, n, d = q.shape
    qr = kr = kbias = None
    if rope is not None:
        qr, kr = (x.new_zeros(b * h, n_pad, d) for x in (q, k))
        for pad, x in ((qr, q), (kr, k)):
            pad[:, :n] = rotate_heads(x, rope, rope_heads).reshape(b * h, n, d)
    if key_mask is not None:
        kbias = torch.full((b, n_pad), MASKED, dtype=torch.float32, device=q.device)
        kbias[:, :n] = torch.where(key_mask, 0.0, MASKED)
    return qr, kr, kbias


def bwd_prepass_plain(
    q: torch.Tensor,  # [b, h, n_q, d]
    k: torch.Tensor,  # [b, h, n_k, d]
    g: torch.Tensor,  # the output's gradient
    out: torch.Tensor,  # the forward's output
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
    q_offset: int = 0,
    rope_heads: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pre-pass of K2's bf16 path in plain PyTorch: the rotated q', k'
    in q's dtype (heads from `rope_heads` on as they are) and
    delta = rowsum(g * out) in float32, [b, h, n_q]."""
    qr, kr = _rotated(q, k, rope, q_offset, rope_heads)
    return qr, kr, (g.float() * out.float()).sum(dim=-1)


def bwd_main_plain(
    qr: torch.Tensor,  # [b, h, n_q, d], rotated
    kr: torch.Tensor,  # [b, h, n_k, d], rotated; v too
    v: torch.Tensor,
    g: torch.Tensor,
    delta: torch.Tensor,  # [b, h, n_q] float32
    scale: float,
    key_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's main kernels in plain PyTorch, float32 dQ', dK', dV: the
    probabilities recomputed in float32, dV = P^T g, dS = P (g V^T - delta)
    scale (P and dS rounded to q's dtype before their products, as the
    kernels do), dQ' = dS K', dK' = dS^T Q'."""
    dtype = qr.dtype
    probs = torch.softmax(_logits(qr, kr, scale, key_mask), dim=-1)
    gf = g.float()
    dv = torch.matmul(probs.to(dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, v.float().transpose(-1, -2))
    ds = (probs * (dp - delta[..., None]) * scale).to(dtype).float()
    return torch.matmul(ds, kr.float()), torch.matmul(ds.transpose(-1, -2), qr.float()), dv


def bwd_epilogue_plain(
    dqr: torch.Tensor,  # [b, h, n_q, d] float32
    dkr: torch.Tensor,  # [b, h, n_k, d] float32; dv too
    dv: torch.Tensor,
    rope: tuple[torch.Tensor, torch.Tensor] | None,
    dtype: torch.dtype,  # the inputs' dtype: the tables are rounded to it
    out_dtype: torch.dtype = torch.float32,
    q_offset: int = 0,
    rope_heads: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's epilogue in plain PyTorch: the RoPE backward
    dx = dx' cos + (dx' sin) P^T = dx' cos - rotate_half(dx' sin) of dQ'
    (by the queries' table rows) and dK' (by the keys'), on heads 0 ..
    rope_heads - 1 (every head with None), then one rounding of dq, dk, dv
    to `out_dtype` (the kernels write q's dtype)."""
    if rope is not None:
        def backward(x, tab):
            cos, sin = (t.to(dtype).float() for t in tab)
            if rope_heads is None:
                return x * cos - rotate_half(x * sin)
            turned = x[:, :rope_heads]
            return torch.cat([turned * cos - rotate_half(turned * sin), x[:, rope_heads:]], dim=1)

        q_tab, k_tab = _tables(rope, dqr.shape[-2], dkr.shape[-2], q_offset)
        dqr, dkr = backward(dqr, q_tab), backward(dkr, k_tab)
    return dqr.to(out_dtype), dkr.to(out_dtype), dv.to(out_dtype)


def tf32_split_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 kernels' operand split (3xTF32) in plain PyTorch,
    bit-exact to `cvt.rna.tf32.f32`: hi is x rounded to TF32 (10 mantissa
    bits, to nearest, ties away from zero), lo is x - hi (exact in float32)
    rounded the same way, so |x - hi - lo| <= 2^-22 |x| for normal x. The
    kernels sum lo*hi' + hi*lo' and then hi*hi' on the tensor cores. Used by
    the tests and chip_smoke.py, not by the wrappers."""

    def rna(t: torch.Tensor) -> torch.Tensor:
        # float32 bits are sign and magnitude: adding half of the 13 dropped
        # bits' range to the pattern rounds the magnitude half away from zero
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    x = x.float()
    hi = rna(x)
    return hi, rna(x - hi)


def flash_attention_bwd_plain(
    q: torch.Tensor,  # [b, h, n_q, d]
    k: torch.Tensor,  # [b, h, n_k, d]; v too
    v: torch.Tensor,
    out: torch.Tensor,  # the forward's output
    g: torch.Tensor,  # its gradient
    scale: float,
    key_mask: torch.Tensor | None = None,
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,
    out_dtype: torch.dtype = torch.float32,
    q_offset: int = 0,
    rope_heads: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's function in plain PyTorch, the pre-pass, main and epilogue
    stages in turn: dq, dk, dv in `out_dtype` (float32 unless asked). For a
    query block dk and dv are the block's share of the keys' gradient."""
    qr, kr, delta = bwd_prepass_plain(q, k, g, out, rope, q_offset, rope_heads)
    return bwd_epilogue_plain(*bwd_main_plain(qr, kr, v, g, delta, scale, key_mask), rope, q.dtype, out_dtype,
                              q_offset, rope_heads)


# ------------------------------------------------------------ the kernels


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build(SOURCE)[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tail = [i64] * 12 + [ctypes.c_float, ptr]
    lib.f5_flash_attention_fwd.argtypes = [ptr] * 8 + [i32] * 4 + tail
    # + the pre-pass's scratch; b, h, n, nk, q_off, d
    lib.f5_flash_attention_fwd_f32.argtypes = [ptr] * 9 + [i32] * 6 + tail
    # b, h, n, nk, n_pad, nk_pad, q_off, d, rope_heads
    lib.f5_flash_attention_fwd_core.argtypes = [ptr] * 10 + [i32] * 9 + [i64] * 12 + [ctypes.c_float, i32, ptr]
    lib.f5_flash_fwd_prepass.argtypes = [ptr] * 7 + [i32] * 9 + [i64] * 6 + [i32, ptr]
    for name in (*_ENTRY.values(), "f5_flash_attention_fwd_core", "f5_flash_fwd_prepass"):
        getattr(lib, name).restype = i32
    lib.f5_cuda_error_string.argtypes = [i32]
    lib.f5_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build(BWD_SOURCE)[0]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    # b, h, n, nk, q_off, d (and rope_heads in bf16)
    lib.f5_flash_attention_bwd.argtypes = [ptr] * 17 + [i32] * 7 + [strides, ctypes.c_float, ptr]
    lib.f5_flash_attention_bwd_f32.argtypes = [ptr] * 13 + [i32] * 6 + [strides, ctypes.c_float, ptr]
    for name in _BWD_ENTRY.values():
        getattr(lib, name).restype = i32
    lib.f5_cuda_error_string.argtypes = [i32]
    lib.f5_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _layout_ok(x: torch.Tensor) -> bool:
    per16 = 16 // x.element_size()  # elements in 16 bytes
    return x.stride(3) == 1 and not any(s % per16 for s in x.stride()[:3]) and not x.data_ptr() % 16


def _check_bhnd(x: torch.Tensor, name: str, q: torch.Tensor, shape: tuple) -> None:
    if x.shape != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if x.dtype not in _ENTRY or x.dtype != q.dtype:
        raise ValueError(f"the attention kernels take bfloat16 or float32 (all alike); {name} is {x.dtype}")
    if x.device != q.device:
        raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if not _layout_ok(x):
        raise ValueError(
            f"{name} needs a contiguous head dim, strides that are multiples of {16 // x.element_size()} "
            f"and a 16-byte aligned start; got strides {x.stride()}"
        )


def is_block(q: torch.Tensor, k: torch.Tensor, q_offset: int) -> bool:
    """Whether q is a query block: other rows than k's, or an offset."""
    return q.shape[-2] != k.shape[-2] or q_offset != 0


def block_covered(dtype: torch.dtype, d: int) -> bool:
    """Whether the kernels take a query block at this dtype and head dim:
    bf16 at d = 64 and 128 (the pre-pass + core, K2's wgmma pair) and float32
    at d = 64 (3xTF32)."""
    return (dtype == torch.bfloat16 and d in CORE_HEAD_DIMS) or (dtype == torch.float32 and d == TC_HEAD_DIM)


def _checked(q, k, v, key_mask, rope, q_offset: int = 0, rope_heads: int | None = None):
    """Validate the kernels' inputs; returns (key_mask, cos, sin) as the
    kernels take them. q may differ from k and v in its rows only (a query
    block, where `block_covered`); `rope_heads` below the head count only in
    bf16 at head dims 64 and 128."""
    b, h, n, d = q.shape
    n_k = k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if n < 1 or n_k < 1:
        raise ValueError("flash_attention needs at least one query and one key")
    for name, x, shape in (("q", q, (b, h, n, d)), ("k", k, (b, h, n_k, d)), ("v", v, (b, h, n_k, d))):
        _check_bhnd(x, name, q, shape)
    if is_block(q, k, q_offset):
        if not block_covered(q.dtype, d):
            raise ValueError(f"the attention kernels take a query block (n_q {n} against n_k {n_k} keys from row "
                             f"{q_offset}) in bfloat16 at head dims {CORE_HEAD_DIMS} and float32 at "
                             f"{TC_HEAD_DIM}; got {q.dtype} at {d}")
        if q_offset < 0 or q_offset + n > n_k:
            raise ValueError(f"a query block of {n} rows from row {q_offset} does not lie in {n_k} keys")
    if partial_heads(rope_heads, h) is not None and not (q.dtype == torch.bfloat16 and d in CORE_HEAD_DIMS):
        raise ValueError(f"the attention kernels rotate a subset of heads (rope_heads {rope_heads} of {h}) in "
                         f"bfloat16 at head dims {CORE_HEAD_DIMS}; got {q.dtype} at {d}")
    if key_mask is not None:
        if key_mask.shape != (b, n_k) or key_mask.dtype != torch.bool or key_mask.device != q.device:
            raise ValueError(f"key_mask must be bool [{b}, {n_k}] on {q.device}")
        key_mask = key_mask.contiguous()
    cos = sin = None
    if rope is not None:
        cos, sin = rope
        for name, tab in (("cos", cos), ("sin", sin)):
            if (tab.shape != (n_k, d) or tab.dtype != torch.float32 or tab.device != q.device
                    or not tab.is_contiguous() or tab.data_ptr() % 16):
                raise ValueError(f"rope {name} must be a contiguous float32 [{n_k}, {d}] table on {q.device}")
    return key_mask, cos, sin


def _ptr(x: torch.Tensor | None):
    return None if x is None else x.data_ptr()


def _f32_scratch(b: int, h: int, n: int, d: int, backward: bool, device, n_k: int | None = None):
    """The float32 kernels' pre-pass scratch (laid out by `tc_carve` in
    csrc/tf32.cuh): the backward's row stats (2 b h n_pad floats), the key
    biases (b nk_pad), and at d = 64 the TF32 halves of rope(q) [b, h, n, d],
    rope(k) and v [b, h, n_k, d] (and g [b, h, n, d] in the backward). None
    for the forward at d = 128 and 256, which has no pre-pass. n_k defaults
    to n."""
    n_k = n if n_k is None else n_k
    n_pad, nk_pad = (-(-x // BWD_ROW_PAD) * BWD_ROW_PAD for x in (n, n_k))
    stats = 2 * b * h * n_pad if backward else 0
    if d != TC_HEAD_DIM:
        floats = stats + b * nk_pad if backward else 0
    else:
        floats = stats + b * nk_pad + 2 * b * h * d * ((2 if backward else 1) * n + 2 * n_k)
    return torch.empty(floats, dtype=torch.float32, device=device) if floats else None


def _raise_on(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: {lib.f5_cuda_error_string(err).decode()}")


def _core_scratch(b: int, h: int, n_pad: int, d: int, rotate: bool, masked: bool, device, nk_pad: int | None = None):
    """One allocation for what K1's bf16 pre-pass writes: the rotated q,
    bf16 [b * h, n_pad, d], and k, [b * h, nk_pad, d] (with RoPE), then the
    key biases, float32 [b, nk_pad] (with a mask); nk_pad defaults to n_pad.
    Returns (buffer, rot pointer, kbias pointer); the pointers are None for
    what is not written."""
    nk_pad = n_pad if nk_pad is None else nk_pad
    rot_bytes = 2 * b * h * (n_pad + nk_pad) * d if rotate else 0
    bias_bytes = 4 * b * nk_pad if masked else 0
    if not rot_bytes + bias_bytes:
        return None, None, None
    buf = torch.empty(rot_bytes + bias_bytes, dtype=torch.uint8, device=device)
    base = buf.data_ptr()
    return buf, base if rotate else None, base + rot_bytes if masked else None


def _core_forward(q, k, v, scale, key_mask, cos, sin, with_lse: bool, q_offset: int = 0,
                  rope_heads: int | None = None):
    """K1 bf16 at d = 64 and 128 on checked inputs: the pre-pass (with RoPE
    or a mask), then the core, on the current stream of q's device (which
    need not be the current device). Returns (out, lse or None)."""
    b, h, n, d = q.shape
    n_k = k.shape[2]
    out = torch.empty_like(q)
    if cos is None:  # the core reads q and k through tensor maps
        q, k = _dense(q), _dense(k)
    v = _dense(v)
    dev = q.get_device()
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    n_pad, nk_pad = (-(-x // CORE_ROW_PAD) * CORE_ROW_PAD for x in (n, n_k))
    _, rot, kbias = _core_scratch(b, h, n_pad, d, cos is not None, key_mask is not None, q.device, nk_pad)
    lib = _library()
    err = lib.f5_flash_attention_fwd_core(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(key_mask), _ptr(cos), _ptr(sin),
        rot, kbias, b, h, n, n_k, n_pad, nk_pad, q_offset, d, h if rope_heads is None else rope_heads,
        *[s for x in (q, k, v, out) for s in x.stride()[:3]],
        float(scale), dev, torch._C._cuda_getCurrentRawStream(dev),  # the raw stream getter torch's compiled code calls
    )
    _raise_on(err, lib, "flash attention")
    flash_attention.launches += 1
    return out, lse


def _forward_kernel(q, k, v, scale, key_mask, cos, sin, with_lse: bool, q_offset: int = 0,
                    rope_heads: int | None = None):
    """Launch K1 on checked inputs; returns (out, lse or None). The output
    has q's strides when q is dense, else it is contiguous; d stays
    innermost, so the other strides are multiples of d. A query block or a
    subset of rotated heads (`_checked` let it through) goes to a kernel
    that takes one."""
    b, h, n, d = q.shape
    n_k = k.shape[2]
    if q.dtype == torch.bfloat16 and d in CORE_HEAD_DIMS:
        return _core_forward(q, k, v, scale, key_mask, cos, sin, with_lse, q_offset, rope_heads)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device) if with_lse else None
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    lib = _library()
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _ptr(lse), _ptr(key_mask), _ptr(cos), _ptr(sin)]
    dims = (b, h, n, d)
    if q.dtype == torch.float32:
        ptrs.append(_ptr(_f32_scratch(b, h, n, d, False, q.device, n_k)))
        dims = (b, h, n, n_k, q_offset, d)
    with torch.cuda.device(q.device):
        err = getattr(lib, _ENTRY[q.dtype])(
            *ptrs, *dims, *strides, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _raise_on(err, lib, "flash attention")
    if q.dtype == torch.float32:
        flash_attention.launches_f32 += 1
    else:
        flash_attention.launches += 1
    return out, lse


def flash_prepass(q, k, key_mask, rope, n_pad: int, rope_heads: int | None = None):
    """K1's bf16 pre-pass alone (`flash_prepass_plain`'s function): on the
    card rope(q) and rope(k) as [b * h, n_pad, d] views of one scratch (heads
    from `rope_heads` on unrotated) and the key biases [b, n_pad], for bf16
    at head dims 64 and 128 and n_pad a multiple of CORE_ROW_PAD. CPU
    tensors run the plain version."""
    if q.device.type == "cpu":
        return flash_prepass_plain(q, k, key_mask, rope, n_pad, rope_heads)
    key_mask, cos, sin = _checked(q, k, k, key_mask, rope, 0, rope_heads)
    b, h, n, d = q.shape
    if q.dtype != torch.bfloat16 or d not in CORE_HEAD_DIMS:
        raise ValueError(f"the pre-pass takes bfloat16 at head dims {CORE_HEAD_DIMS}; got {q.dtype}, {d}")
    if n_pad < n or n_pad % CORE_ROW_PAD:
        raise ValueError(f"n_pad must be a multiple of {CORE_ROW_PAD} of at least n = {n}; got {n_pad}")
    scratch, rot, kbias = _core_scratch(b, h, n_pad, d, cos is not None, key_mask is not None, q.device)
    dev = q.get_device()
    lib = _library()
    err = lib.f5_flash_fwd_prepass(
        q.data_ptr(), k.data_ptr(), _ptr(key_mask), _ptr(cos), _ptr(sin), rot, kbias, b, h, n, n, n_pad, n_pad, 0, d,
        h if rope_heads is None else rope_heads, *q.stride()[:3], *k.stride()[:3], dev,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    _raise_on(err, lib, "flash attention pre-pass")
    flash_prepass.launches += 1
    rot_bytes = 4 * b * h * n_pad * d if cos is not None else 0
    qr = kr = bias = None
    if cos is not None:
        qr, kr = scratch[:rot_bytes].view(torch.bfloat16).view(2, b * h, n_pad, d).unbind(0)
    if key_mask is not None:
        bias = scratch[rot_bytes:].view(torch.float32).view(b, n_pad)
    return qr, kr, bias


def _backward_kernel(q, k, v, out, lse, g, scale, key_mask, cos, sin, q_offset: int = 0,
                     rope_heads: int | None = None):
    """Launch K2; returns (dq, dk, dv) in q's dtype, contiguous
    [b, h, n, d] (dk and dv [b, h, n_k, d] for a query block: its share of
    the keys' gradient). g (and v) are taken as strided views when their
    layout allows, else made contiguous. The pre-pass, then the main
    kernels, with the pre-pass's scratch (and at bf16 d = 64 the single
    pass's float32 dq' sum) allocated here. Heads from `rope_heads` on are
    not rotated (bf16 only)."""
    return _backward_launch(q, k, v, out, lse, g, scale, key_mask, cos, sin, q_offset, rope_heads)[:3]


def _backward_launch(q, k, v, out, lse, g, scale, key_mask, cos, sin, q_offset: int = 0,
                     rope_heads: int | None = None):
    """`_backward_kernel`'s launch; returns (dq, dk, dv, qr, kr), where qr
    and kr are the bf16 pre-pass's rope(q) [b, h, n, d] and rope(k)
    [b, h, n_k, d] (None in float32)."""
    b, h, n, d = q.shape
    n_k = k.shape[2]
    if g.dtype != q.dtype:
        raise ValueError(f"the output's gradient is {g.dtype}, the inputs {q.dtype}")
    # TMA reads v and g by their strides, and takes no zero stride (an expanded gradient)
    if not _layout_ok(g) or 0 in g.stride():
        g = g.contiguous()
    if 0 in v.stride():
        v = v.contiguous()
    lib = _bwd_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (ctypes.c_longlong * 15)(*[s for x in (q, k, v, g, out) for s in x.stride()[:3]])
    def rows(m, dtype):
        return torch.empty((b, h, m, d), dtype=dtype, device=q.device)

    if q.dtype == torch.float32:
        if rope_heads is not None and rope_heads < h:
            raise ValueError(f"the float32 attention backward rotates every head; got rope_heads {rope_heads} of {h}")
        scratch = _f32_scratch(b, h, n, d, True, q.device, n_k)
        dq, dk, dv = rows(n, torch.float32), rows(n_k, torch.float32), rows(n_k, torch.float32)
        with torch.cuda.device(q.device):
            err = lib.f5_flash_attention_bwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(), lse.data_ptr(),
                _ptr(key_mask), _ptr(cos), _ptr(sin), scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), b, h, n, n_k, q_offset, d, strides, float(scale), stream,
            )
        _raise_on(err, lib, "flash attention backward")
        flash_attention.launches_bwd_f32 += 1
        return dq, dk, dv, None, None
    n_pad, nk_pad = (-(-x // BWD_ROW_PAD) * BWD_ROW_PAD for x in (n, n_k))
    qr, dq = rows(n, q.dtype), rows(n, q.dtype)
    kr, dk, dv = rows(n_k, q.dtype), rows(n_k, q.dtype), rows(n_k, q.dtype)
    stats = torch.empty((b, h, n_pad, 2), dtype=torch.float32, device=q.device)
    kbias = torch.empty((b, nk_pad), dtype=torch.float32, device=q.device)
    fused = d == PASS_HEAD_DIM
    # the single pass's scratch: dQ' summed in float32 per 64-query tile, then each tile's count of adds
    sums = b * h * -(-n // PASS_TILE)
    dq_scratch = torch.empty(sums * PASS_TILE * d + sums + 1, dtype=torch.float32, device=q.device) if fused else None
    with torch.cuda.device(q.device):
        err = lib.f5_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _ptr(key_mask), _ptr(cos), _ptr(sin), qr.data_ptr(), kr.data_ptr(), stats.data_ptr(),
            kbias.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), _ptr(dq_scratch), b, h, n, n_k, q_offset,
            d, h if rope_heads is None else rope_heads, strides, float(scale), stream,
        )
    _raise_on(err, lib, "flash attention backward")
    flash_attention.launches_bwd += 1
    flash_attention.launches_bwd_fused += fused
    return dq, dk, dv, qr, kr


# ------------------------------------------------------------ the registered operator

# K1 as a torch operator, so that a traced program (torch.export) records one call where the wrapper runs:
# the fake version gives the output's shape, dtype and strides without data, CPU tensors run the plain version
# and CUDA tensors launch the kernel (its launch counts stay in `_forward_kernel`)
FWD_OP_SCHEMA = ("(Tensor q, Tensor k, Tensor v, float scale, Tensor? key_mask, Tensor? cos, Tensor? sin, "
                 "bool with_lse) -> (Tensor, Tensor)")


def _no_lse(q: torch.Tensor) -> torch.Tensor:
    return q.new_empty((0,), dtype=torch.float32)


@torch.library.custom_op("f5_tts_tpu_torch::flash_attention_fwd", mutates_args=(), device_types="cpu",
                         schema=FWD_OP_SCHEMA)
def flash_attention_fwd(q, k, v, scale, key_mask, cos, sin, with_lse):
    """K1 as an operator: (out with q's strides where q is dense, the
    per-row log-sum-exp [b, h, n] float32 with `with_lse`, else an empty
    [0]). This body is the CPU one, the plain versions."""
    rope = None if cos is None else (cos, sin)
    out = torch.empty_like(q)
    out.copy_(flash_attention_plain(q, k, v, scale, key_mask, rope))
    lse = attention_lse_plain(q, k, scale, key_mask, rope) if with_lse else _no_lse(q)
    return out, lse


@flash_attention_fwd.register_kernel("cuda")
def _flash_attention_fwd_cuda(q, k, v, scale, key_mask, cos, sin, with_lse):
    key_mask, cos, sin = _checked(q, k, v, key_mask, None if cos is None else (cos, sin))
    out, lse = _forward_kernel(q, k, v, scale, key_mask, cos, sin, with_lse=with_lse)
    return out, _no_lse(q) if lse is None else lse


@flash_attention_fwd.register_fake
def _flash_attention_fwd_fake(q, k, v, scale, key_mask, cos, sin, with_lse):
    b, h, n, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, n) if with_lse else (0,), dtype=torch.float32)


class FlashAttentionFn(torch.autograd.Function):
    """Attention with K1 forward and K2 backward on CUDA tensors, the plain
    versions on CPU tensors. Gradients flow to q, k and v; the mask, the
    rotary tables, the query offset and the rotated heads are constants. A
    query block or a subset of rotated heads launches K1 through its wrapper
    (`_forward_kernel`), not the registered operator."""

    @staticmethod
    def forward(ctx, q, k, v, scale, key_mask, cos, sin, q_offset=0, rope_heads=None):
        rope = None if cos is None else (cos, sin)
        rope_heads = None if rope is None else partial_heads(rope_heads, q.shape[1])
        lse = None
        if q.device.type == "cpu":
            out = flash_attention_plain(q, k, v, scale, key_mask, rope, q_offset, rope_heads)
        else:
            key_mask, cos, sin = _checked(q, k, v, key_mask, rope, q_offset, rope_heads)
            if is_block(q, k, q_offset) or rope_heads is not None:
                out, lse = _forward_kernel(q, k, v, scale, key_mask, cos, sin, True, q_offset, rope_heads)
            else:
                out, lse = flash_attention_fwd(q, k, v, scale, key_mask, cos, sin, True)
        ctx.scale, ctx.q_offset, ctx.rope_heads = scale, q_offset, rope_heads
        ctx.save_for_backward(q, k, v, out, lse, key_mask, cos, sin)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, key_mask, cos, sin = ctx.saved_tensors
        if q.device.type == "cpu":
            rope = None if cos is None else (cos, sin)
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, g, ctx.scale, key_mask, rope, out_dtype=q.dtype,
                                                   q_offset=ctx.q_offset, rope_heads=ctx.rope_heads)
        else:
            dq, dk, dv = _backward_kernel(q, k, v, out, lse, g, ctx.scale, key_mask, cos, sin, ctx.q_offset,
                                          ctx.rope_heads)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # [b, h, n_q, d]
    k: torch.Tensor,  # [b, h, n_k, d]; v too
    v: torch.Tensor,
    scale: float,
    key_mask: torch.Tensor | None = None,  # [b, n_k] bool, True = keep
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,  # (cos, sin), each [n_k, d] f32
    q_offset: int = 0,  # a query block's first row in the keys' sequence
    rope_heads: int | None = None,  # the rotated heads, the first ones; None: every head
) -> torch.Tensor:
    """Non-causal attention with an optional key mask and in-kernel rotary
    embedding. CPU tensors run the plain versions; CUDA tensors launch the
    kernels of their dtype (bfloat16 or float32), and anything the kernels
    do not take raises ValueError. Differentiable in q, k and v. q may be a
    query block, and `rope_heads` may rotate only the first heads (see the
    module's docstring).

    The output has q's shape and dtype (and q's strides when q is dense), so
    a q viewed from a [b, n, h*d] projection gives an output that reshapes
    back to [b, n, h*d] without a copy."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, not {q.device.type}")
    cos, sin = (None, None) if rope is None else rope
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, scale, key_mask, cos, sin, q_offset, rope_heads)
    rope_heads = None if rope is None else partial_heads(rope_heads, q.shape[1])
    if is_block(q, k, q_offset) or rope_heads is not None:
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, scale, key_mask, rope, q_offset, rope_heads)
        key_mask, cos, sin = _checked(q, k, v, key_mask, rope, q_offset, rope_heads)
        return _forward_kernel(q, k, v, float(scale), key_mask, cos, sin, False, q_offset, rope_heads)[0]
    return flash_attention_fwd(q, k, v, float(scale), key_mask, cos, sin, False)[0]


flash_attention.launches = 0
flash_attention.launches_f32 = 0
flash_attention.launches_bwd = 0
flash_attention.launches_bwd_f32 = 0
flash_attention.launches_bwd_fused = 0
flash_prepass.launches = 0
