"""Tiny configurations and cells for CPU tests: a copy of the benchmark's
files under a temporary root, with each cell's configuration cut to a
width and depth that the CPU runs in seconds and its traffic shortened."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TINY_DIT = {"dim": 64, "depth": 2, "heads": 2, "dim_head": 32, "ff_mult": 2, "text_dim": 64,
            "conv_layers": 1, "compute_dtype": "float32"}
TINY_TRAFFIC = {
    "train_steps": {"max_frames": 600, "max_samples": 4, "pool": 16, "reference_frames": 300,
                    "seconds": {"median": 1.5, "sigma": 0.5, "min": 0.5, "max": 3.0}},
}


def tiny_root(tmp: Path, dtype: str = "float32") -> Path:
    """A root with every cell of the benchmark, each at the tiny sizes."""
    root = tmp / "bench"
    for kind in ("workloads", "configs", "traffic"):
        shutil.copytree(ROOT / kind, root / kind, ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    for path in (root / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["dit"].update(TINY_DIT, compute_dtype=dtype)
        path.write_text(json.dumps(c))
    for path in (root / "traffic").glob("*.json"):
        m = json.loads(path.read_text())
        m.update(TINY_TRAFFIC[m["kind"]])
        path.write_text(json.dumps(m))
    return root


def write_cell(root: Path, name: str, **cell) -> None:
    (root / "workloads" / f"{name}.json").write_text(json.dumps(cell))
