"""Runs one cell of the benchmark once and prints its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `benchmark/workloads/<cell>.json` (its configuration, traffic
mix and chips), its configuration `benchmark/configs/<config>.json`, its
traffic mix `benchmark/traffic/<traffic>.json`, whose `kind` names the
module under `benchmark/traffic/` that sets the program up, warms it up,
drives it for `--seconds` and hands back its outputs. With `--trace 0` the
result holds the cell's end-to-end metrics; with `--trace 1`, every
per-layer metric whose reader under `benchmark/metrics/` finds something
to read. After the window the outputs are held against the plain
reference (`benchmark/reference/`); the numbers compared and their limits
close standard error and the result line, which is the last line of
standard output.

It needs as many CUDA devices as the cell asks for, and exits non-zero
without a result otherwise, or when JAX or the JAX package was imported.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pkgutil  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "f5_tts_tpu")


@dataclass
class Check:
    """One number compared with the reference and its limit: the run is
    correct when every number is finite and at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a traffic module hands back after its window."""

    end_to_end: dict  # name -> (value, unit)
    attempted: int
    failed: int
    observation: dict  # what the per-layer readers read
    release: object  # () -> None: drops the program's state
    check: object  # () -> list[Check], run after `release`
    extra: dict = field(default_factory=dict)


class Run:
    """One run's settings and clocks, handed to the traffic module."""

    def __init__(self, args, cell: dict, config: dict, mix: dict, device):
        from benchmark.trace import Tracer

        self.workload, self.seed, self.seconds = args.workload, int(args.seed), float(args.seconds)
        self.trace = bool(int(args.trace))
        self.cell, self.config, self.mix, self.device = cell, config, mix, device
        self.tracer = Tracer(self.trace and device.type == "cuda")
        self.setup_s = None
        self.peak_setup = 0
        self.peak_window = 0
        self.fault = self.control = None

    def begin_window(self) -> float:
        """Ends set-up: its seconds from the process's start, and resets
        the memory peak for the window."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peak_setup = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        now = time.perf_counter()
        self.setup_s = now - T0
        return now

    def end_window(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            self.peak_window = torch.cuda.max_memory_allocated(self.device)


def load(root: Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def per_layer(observation: dict) -> dict:
    """Every reader under benchmark/metrics/ that finds something to read."""
    import benchmark.metrics as pkg

    out = {}
    for info in sorted(pkgutil.iter_modules(pkg.__path__), key=lambda m: m.name):
        mod = importlib.import_module(f"benchmark.metrics.{info.name}")
        value = mod.read(observation)
        if value is not None:
            out[mod.NAME] = {"value": float(value), "unit": mod.UNIT}
    return out


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def main(argv=None, *, require_cuda: bool = True, root: Path = HERE, device: str | None = None, **options) -> int:
    """One run. Tests and the readings of the controls pass `options`: a
    `fault` planted in the timed path, or a `control` precision at which
    the reference takes the program's place."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    cell = load(root, "workloads", args.workload)
    config = load(root, "configs", cell["config"])
    mix = load(root, "traffic", cell["traffic"])

    import torch

    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"this cell needs {cell['chips']} CUDA device(s); {have} available", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device or "cpu")

    traffic = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
    run = Run(args, cell, config, mix, dev)
    run.fault, run.control = options.get("fault"), options.get("control")
    outcome: Outcome = traffic.run(run)
    run.tracer.finish()

    observation = dict(outcome.observation, trace=run.tracer.summary, peak_window_bytes=run.peak_window,
                       window_kind=mix["kind"])
    metrics = per_layer(observation) if run.trace else {
        **{k: {"value": float(v), "unit": u} for k, (v, u) in outcome.end_to_end.items()},
        "setup_s": {"value": float(run.setup_s), "unit": "s"},
    }
    device = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(max(run.peak_setup, run.peak_window)),
    }
    summary = run.tracer.summary
    if run.trace and summary is not None:
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)

    outcome.release()
    outcome.observation = observation = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = outcome.check()
    check_s = time.perf_counter() - t
    correct = bool(checks) and all(c.ok for c in checks)

    bad = forbidden_modules()
    if bad:
        print(f"the run imported {', '.join(bad)}", file=sys.stderr)
        return 3

    result = {"correct": correct, "attempted": int(outcome.attempted), "failed": int(outcome.failed),
              "metrics": metrics, "device": device}
    if run.trace and summary is not None:
        result["breakdown"] = summary.breakdown()
    result.update(outcome.extra, reference_s=check_s, trace_read_s=run.tracer.seconds)
    result["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else None, "limit": c.limit}
                        for c in checks}
    for c in checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
