"""What the harness and the reference load, by whole top-level module
names: never JAX, jaxlib, flax or the JAX package (whose name the port's
begins with), and for the reference nothing of the port either."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "f5_tts_tpu"}


def loaded_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=REPO, capture_output=True, text=True, check=True)
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_the_harness_loads_no_jax():
    code = ("import importlib, pkgutil, benchmark\n"
            "for m in pkgutil.walk_packages(benchmark.__path__, 'benchmark.'):\n"
            "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
            "import f5_tts_tpu_torch.training.trainer, f5_tts_tpu_torch.models.cfm")
    top = loaded_after(code)
    assert not top & FORBIDDEN
    assert "f5_tts_tpu_torch" in top


def test_the_reference_loads_nothing_of_the_program():
    top = loaded_after("import benchmark.reference.model, benchmark.reference.train")
    assert not top & (FORBIDDEN | {"f5_tts_tpu_torch"})


def test_reference_sources_import_only_plain_libraries():
    allowed = {"__future__", "math", "numpy", "torch", "benchmark"}
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)
                if n.startswith("benchmark"):
                    assert n.startswith("benchmark.reference"), (path.name, n)


def test_a_run_checks_its_modules():
    from benchmark import run as R

    assert set(R.FORBIDDEN) == FORBIDDEN
    assert json.loads((REPO / "BENCHMARK.json").read_text())["command"][:3] == ["python3", "-m", "benchmark.run"]
