"""ctypes binding for the native C++ WAV decoder (`wav_decoder.cpp`).

The library builds with g++ at first use (`library()`), into
build/f5_tts_tpu_torch/libwav_decoder_<sha256 of the source, 16 hex>.so
beside the package, as `ops/cuda_build.py` names the CUDA libraries; never
next to the sources. Importing this module builds nothing. When the library
cannot be built or loaded, `library()` raises ImportError carrying the
compiler's stderr, and keeps raising it without building again, so the data
loader (`data/libritts.py` `_read_audio`) falls back to the Python reader
once and says so. ctypes releases the GIL for the length of each call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from f5_tts_tpu_torch.ops.cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "wav_decoder.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: str | None = None


def library_path() -> Path:
    return BUILD_DIR / f"libwav_decoder_{hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    except OSError as e:
        raise ImportError(f"could not run g++ to build {lib.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise ImportError(f"g++ failed to build {lib.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent builder cannot leave a torn library


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    f32p, i32, i64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int64
    lib.f5_wav_decode.restype = ctypes.c_int
    lib.f5_wav_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(f32p), ctypes.POINTER(i64),
                                  ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.f5_wav_decode_batch.restype = ctypes.c_int
    lib.f5_wav_decode_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), i32, i32, ctypes.POINTER(f32p),
                                        ctypes.POINTER(i64), ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.f5_free.restype = None
    lib.f5_free.argtypes = [f32p]
    return lib


def library() -> ctypes.CDLL:
    """The decoder library, built on the first call; ImportError when it
    cannot be built or loaded (the same error on every later call)."""
    global _lib, _error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None and _error is None:
            path = library_path()
            try:
                if not path.exists():
                    _build(path)
                _lib = _load(path)
            except ImportError as e:
                _error = str(e)
            except OSError as e:  # a corrupt or foreign library
                _error = f"{path} is unusable: {e}"
        if _error is not None:
            raise ImportError(_error)
        return _lib


def _take(lib: ctypes.CDLL, ptr, num_frames: int, channels: int) -> np.ndarray:
    count = num_frames * channels
    arr = np.ctypeslib.as_array(ptr, shape=(count,)).copy()
    lib.f5_free(ptr)
    if channels > 1:
        arr = arr.reshape(num_frames, channels)
    return arr


def wav_decode(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode one WAV -> (float32 samples [n] or [n, c], sample_rate);
    ValueError when the file cannot be decoded."""
    lib = library()
    samples = ctypes.POINTER(ctypes.c_float)()
    num_frames, channels, sample_rate = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.f5_wav_decode(str(path).encode(), ctypes.byref(samples), ctypes.byref(num_frames),
                           ctypes.byref(channels), ctypes.byref(sample_rate))
    if rc != 0:
        raise ValueError(f"failed to decode {path} (rc={rc})")
    return _take(lib, samples, num_frames.value, channels.value), sample_rate.value


def wav_decode_batch(paths: list, num_threads: int = 8) -> list[tuple[np.ndarray, int] | None]:
    """Decode many files on `num_threads` native threads; a file that cannot
    be decoded gives None in its place."""
    lib = library()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    samples = (ctypes.POINTER(ctypes.c_float) * n)()
    num_frames = (ctypes.c_int64 * n)()
    channels = (ctypes.c_int32 * n)()
    rates = (ctypes.c_int32 * n)()
    lib.f5_wav_decode_batch(c_paths, n, num_threads, samples, num_frames, channels, rates)
    return [None if num_frames[i] < 0 or not samples[i]
            else (_take(lib, samples[i], num_frames[i], channels[i]), rates[i]) for i in range(n)]
