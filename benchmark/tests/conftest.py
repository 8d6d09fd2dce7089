"""The tiny roots of the hand-run tests (`tiny.py`) for every cell: a
configuration with a `unett` block (E2 TTS's UNetT) is cut to a tiny width
and depth as a `dit` block is, and the `unett_steps` traffic is shortened
as `train_steps` is."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark.tests import tiny

TINY_UNETT = {"dim": 64, "depth": 4, "heads": 4, "dim_head": 16}
tiny.TINY_TRAFFIC.setdefault("unett_steps", tiny.TINY_TRAFFIC["train_steps"])


def tiny_root(tmp: Path, dtype: str = "float32") -> Path:
    """`tiny.tiny_root`, with the UNetT's configurations cut too."""
    root = tmp / "bench"
    for kind in ("workloads", "configs", "traffic"):
        shutil.copytree(tiny.ROOT / kind, root / kind, ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    for path in (root / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        if "unett" in c:
            c["unett"].update(TINY_UNETT, compute_dtype=dtype)
        else:
            c["dit"].update(tiny.TINY_DIT, compute_dtype=dtype)
        path.write_text(json.dumps(c))
    for path in (root / "traffic").glob("*.json"):
        m = json.loads(path.read_text())
        m.update(tiny.TINY_TRAFFIC[m["kind"]])
        path.write_text(json.dumps(m))
    return root


tiny.tiny_root = tiny_root
