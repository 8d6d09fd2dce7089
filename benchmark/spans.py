"""The traced stretch by the program's training-step spans
(f5_tts_tpu_torch/training/trainer.py `_build_step`): the device seconds
each part of the step launched, the device's idle time inside the steps,
and the steps' device-to-host copies.

It works on the chrome-trace events that benchmark/trace.py loads. A
kernel, copy or set belongs to the part (`train.forward`,
`train.backward`, `train.update`) in which its launch (a CUDA runtime or
CUDA-driver-API call, found through its `correlation` id) starts, whichever
host thread made the call: autograd launches the backward from its own
thread while the step's thread waits inside `train.backward`. A part's
seconds are the union of its device intervals, clipped to the stretch.
The stretch's seconds and busy seconds are the `Summary`'s of
benchmark/trace.py, the denominator of `idle.train`.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from benchmark.metrics.k1_roofline_train import KERNELS as K1_KERNELS
from benchmark.trace import DEVICE_CATS, STRETCH

STEP = "train.step"
PHASES = ("train.forward", "train.backward", "train.update")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
UNMATCHED_SHARE = 0.01


@dataclass
class Spans:
    steps: int = 0  # `train.step` spans that start in the stretch
    device_s: dict = field(default_factory=dict)  # part -> device seconds launched in it
    step_idle_s: float = 0.0  # idle inside `train.step` spans
    host_reads: int = 0  # device-to-host copies launched inside `train.step` spans
    unmatched_s: float = 0.0  # device seconds whose launch the trace lacks


def union(intervals) -> list[list[float]]:
    """Sorted, merged [start, end) intervals."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    return merged


def overlap(xs: list, ys: list) -> float:
    """The length two sorted lists of disjoint intervals share."""
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += max(0.0, min(b, ys[k][1]) - max(a, ys[k][0]))
            k += 1
    return total


def _inside(intervals: list, t: float) -> bool:
    i = bisect.bisect_right([a for a, _ in intervals], t) - 1
    return i >= 0 and t < intervals[i][1]


def _seconds(intervals) -> float:
    return sum(b - a for a, b in union(intervals)) * 1e-6


def reduce(events: list[dict]) -> Spans | None:
    """The stretch's device seconds by part, its idle inside the steps and
    the steps' copies to the host, or None without a stretch."""
    marks = [e for e in events if e.get("name") == STRETCH and "dur" in e]
    if not marks:
        return None
    w0 = min(e["ts"] for e in marks)
    w1 = max(e["ts"] + e["dur"] for e in marks)
    spans = {name: union((e["ts"], min(e["ts"] + e["dur"], w1)) for e in events
                         if e.get("cat") == "user_annotation" and e.get("name") == name and "dur" in e
                         and w0 <= e["ts"] < w1)
             for name in PHASES + (STEP,)}
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    by_part: dict[str, list] = {part: [] for part in PHASES}
    every, unmatched, reads = [], [], 0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)
        if b <= a:
            continue
        every.append((a, b))
        t = launch.get(e.get("args", {}).get("correlation"))
        if t is None:
            unmatched.append((a, b))
            continue
        for part in PHASES:
            if _inside(spans[part], t):
                by_part[part].append((a, b))
        if e["cat"] == "gpu_memcpy" and "DtoH" in e.get("name", "") and _inside(spans[STEP], t):
            reads += 1
    steps = spans[STEP]
    return Spans(steps=sum(1 for e in events if e.get("cat") == "user_annotation" and e.get("name") == STEP
                           and "dur" in e and w0 <= e["ts"] < w1),
                 device_s={part: _seconds(by_part[part]) for part in PHASES},
                 step_idle_s=(sum(b - a for a, b in steps) - overlap(union(every), steps)) * 1e-6,
                 host_reads=reads, unmatched_s=_seconds(unmatched))


def readings(obs: dict) -> dict | None:
    """The five per-layer numbers of a traced training run: each part's
    device seconds and the idle inside the steps as shares of the stretch
    (%), and the device-to-host reads a step. None where the run lacks the
    reduction (`spans`) or the stretch its steps, where the trace lacks K1
    launches the shapes predict, or where kernels with no launch found
    hold more than 1% of the busy time."""
    sp, t = obs.get("spans"), obs.get("trace")
    traced = [s for s in obs.get("steps", []) if s.get("traced")] if obs.get("kind") == "train" else []
    if sp is None or t is None or not traced or sp.steps == 0 or t.window_s <= 0 or t.busy_s <= 0:
        return None
    if sp.unmatched_s > UNMATCHED_SHARE * t.busy_s:
        return None
    if t.kernel_seconds(K1_KERNELS[0])[1] != obs["config"]["dit"]["depth"] * len(traced):
        return None
    share = 100.0 / t.window_s
    return {"forward.train": share * sp.device_s["train.forward"],
            "backward.train": share * sp.device_s["train.backward"],
            "update.train": share * sp.device_s["train.update"],
            "step_idle.train": share * sp.step_idle_s,
            "host_reads.train": sp.host_reads / sp.steps}
