"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

The kernels (csrc/flash_attention_fwd.cu, whose header note gives their
design) are compiled with nvcc for sm_90a into a shared library with a plain
C interface at first use (ops/cuda_build.py) and called through ctypes on
PyTorch's current stream. There are two: bf16 on the tensor cores, and
float32 on the FMA units (no TF32), for models whose compute dtype is
float32.

`flash_attention` launches the kernel of q's dtype for CUDA tensors and runs
`flash_attention_plain` for CPU tensors. Both compute
softmax(rope(q) rope(k)^T * scale, keys masked by key_mask) v.
`flash_attention.launches` counts launches of the bf16 kernel,
`flash_attention.launches_f32` those of the float32 kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb
from f5_tts_tpu_torch.ops import cuda_build
from f5_tts_tpu_torch.ops.attention import sdpa_reference

SOURCE = cuda_build.CSRC / "flash_attention_fwd.cu"
HEAD_DIMS = (64, 128, 256)
# the C entry point of each kernel, by dtype
_ENTRY = {torch.bfloat16: "f5_flash_attention_fwd", torch.float32: "f5_flash_attention_fwd_f32"}


def flash_attention_plain(
    q: torch.Tensor,  # [b, h, n, d]
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    key_mask: torch.Tensor | None = None,  # [b, n] bool, True = keep
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,  # (cos, sin), each [n, d] f32
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: rotary embedding, then
    `sdpa_reference`."""
    if rope is not None:
        q = apply_rotary_pos_emb(q, rope)
        k = apply_rotary_pos_emb(k, rope)
    return sdpa_reference(q, k, v, scale, key_mask)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build(SOURCE)[0]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr] * 7 + [i32] * 4 + [i64] * 12 + [ctypes.c_float, ptr]
        fn.restype = i32
    lib.f5_cuda_error_string.argtypes = [i32]
    lib.f5_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_bhnd(x: torch.Tensor, name: str, q: torch.Tensor) -> None:
    if x.shape != q.shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(q.shape)}")
    if x.dtype not in _ENTRY or x.dtype != q.dtype:
        raise ValueError(f"the attention kernels take bfloat16 or float32 (all alike); {name} is {x.dtype}")
    per16 = 16 // x.element_size()  # elements in 16 bytes
    if x.stride(3) != 1 or any(s % per16 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name} needs a contiguous head dim, strides that are multiples of {per16} and a "
            f"16-byte aligned start; got strides {x.stride()}"
        )


def flash_attention(
    q: torch.Tensor,  # [b, h, n, d]
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    key_mask: torch.Tensor | None = None,  # [b, n] bool, True = keep
    rope: tuple[torch.Tensor, torch.Tensor] | None = None,  # (cos, sin), each [n, d] f32
) -> torch.Tensor:
    """Non-causal attention with an optional key mask and in-kernel rotary
    embedding. CPU tensors run the plain version; CUDA tensors launch the
    kernel of their dtype (bfloat16 or float32), and anything the kernels do
    not take raises ValueError.

    The output has q's shape and dtype (and q's strides when q is dense), so
    a q viewed from a [b, n, h*d] projection gives an output that reshapes
    back to [b, n, h*d] without a copy."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, key_mask, rope)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, not {q.device.type}")
    b, h, n, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if n < 1:
        raise ValueError("flash_attention needs at least one key")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
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

    # q's strides when q is dense, else contiguous; d stays innermost, so the
    # other strides are multiples of d
    out = torch.empty_like(q)
    strides = [s for x in (q, k, v, out) for s in x.stride()[:3]]
    with torch.cuda.device(q.device):
        err = getattr(_library(), _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            None if cos is None else cos.data_ptr(),
            None if sin is None else sin.data_ptr(),
            b, h, n, d, *strides, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: {_library().f5_cuda_error_string(err).decode()}"
        )
    if q.dtype == torch.float32:
        flash_attention.launches_f32 += 1
    else:
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.launches_f32 = 0
