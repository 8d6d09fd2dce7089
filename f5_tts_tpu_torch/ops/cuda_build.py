"""Build the port's CUDA kernels: nvcc for sm_90a into shared libraries with
a plain C interface, loaded through ctypes.

Each source under csrc/ compiles on its own into
build/f5_tts_tpu_torch/lib<stem>_<hash>.so beside the package, at first use;
the file name carries the hash of the source and of the headers under csrc/,
so an edited source or header rebuilds. The
compiler's output (with ptxas register and spill counts) goes to
<stem>.build.log in the same directory. `build` starts one nvcc per missing
library, all at once, and waits for them together.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "f5_tts_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")


def import_triton():
    """Import Triton with its kernel cache under BUILD_DIR/triton (beside the
    package, git-ignored) unless TRITON_CACHE_DIR is set. Call it only where
    a kernel launches: Triton exists on the card's machine only."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton

    return triton


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def log_path(source: Path) -> Path:
    return BUILD_DIR / f"{source.stem}.build.log"


def build(*sources: Path) -> list[Path]:
    """Compile every source whose library does not exist yet, with one nvcc
    process each, started together; return the library paths in order."""
    libs = [library_path(s) for s in sources]
    jobs = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        with open(log_path(src), "w") as log:
            proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                    stdout=log, stderr=subprocess.STDOUT)
        jobs.append((src, lib, tmp, proc))
    failed = []
    for src, lib, tmp, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"nvcc failed to build {src.name}:\n{log_path(src).read_text()}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs
