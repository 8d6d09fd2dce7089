"""Flash-attention forward: the CUDA kernel's wrapper and its plain version.

The kernel (csrc/flash_attention_fwd.cu, whose header note gives its design)
is compiled with nvcc for sm_90a into a shared library with a plain C
interface at first use, under build/f5_tts_tpu_torch/ beside the package,
and called through ctypes on PyTorch's current stream.

`flash_attention` launches the kernel for CUDA tensors and runs
`flash_attention_plain` for CPU tensors. Both compute
softmax(rope(q) rope(k)^T * scale, keys masked by key_mask) v.
`flash_attention.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from f5_tts_tpu_torch.models.rope import apply_rotary_pos_emb
from f5_tts_tpu_torch.ops.attention import sdpa_reference

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "flash_attention_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "f5_tts_tpu_torch"
HEAD_DIMS = (64, 128, 256)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the attention kernel")


def build() -> Path:
    """Compile the kernel library if no build of the current source exists;
    return its path. The file name carries the source's hash."""
    src = SOURCE.read_bytes()
    lib = BUILD_DIR / f"libflash_attention_fwd_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    (BUILD_DIR / "flash_attention_fwd.build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.f5_flash_attention_fwd.argtypes = (
        [ptr] * 7 + [i32] * 4 + [i64] * 12 + [ctypes.c_float, ptr]
    )
    lib.f5_flash_attention_fwd.restype = i32
    lib.f5_cuda_error_string.argtypes = [i32]
    lib.f5_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_bhnd(x: torch.Tensor, name: str, shape: torch.Size) -> None:
    if x.shape != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the attention kernel takes bfloat16 only; {name} is {x.dtype}")
    if x.stride(3) != 1 or any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
        raise ValueError(
            f"{name} needs a contiguous head dim, strides that are multiples of 8 and a "
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
    kernel, and anything the kernel does not take raises ValueError.

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
        _check_bhnd(x, name, q.shape)
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
        err = _library().f5_flash_attention_fwd(
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
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
