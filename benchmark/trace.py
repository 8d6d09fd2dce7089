"""torch.profiler over a stretch of the window, reduced to what the
per-layer metrics and the result's `breakdown` read: the device's busy
time (the union of kernel, copy and set intervals), each kernel's time by
name, and the idle gaps by what the host was doing then.

The stretch is marked by a `bench.stretch` annotation; the trace is
written to TMPDIR, read, and deleted.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")
STRETCH = "bench.stretch"


@dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)  # name -> [seconds, launches]
    idle_by_host: dict = field(default_factory=dict)  # host activity -> seconds

    def kernel_seconds(self, *patterns: str) -> tuple[float, int]:
        """Seconds and launches of the kernels whose name holds a pattern."""
        s, n = 0.0, 0
        for name, (sec, count) in self.kernels.items():
            if any(p in name for p in patterns):
                s, n = s + sec, n + count
        return s, n

    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:120], s] for n, (s, _) in ops], "idle_gaps": [[n[:120], s] for n, s in gaps]}


def summarize(events: list[dict]) -> Summary:
    marks = [e for e in events if e.get("name") == STRETCH and "dur" in e]
    if not marks:
        return Summary()
    w0 = min(e["ts"] for e in marks)
    w1 = max(e["ts"] + e["dur"] for e in marks)
    dev = sorted((max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1), e.get("name", "?"))
                 for e in events if e.get("cat") in DEVICE_CATS and e.get("ts", 0) < w1
                 and e.get("ts", 0) + e.get("dur", 0) > w0)
    s = Summary(window_s=(w1 - w0) * 1e-6)
    for a, b, name in dev:
        k = s.kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) * 1e-6
        k[1] += 1
    merged: list[list[float]] = []
    for a, b, _ in dev:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    s.busy_s = sum(b - a for a, b in merged) * 1e-6
    gaps, last = [], w0
    for a, b in merged:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    if w1 > last:
        gaps.append((last, w1))
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "?")) for e in events
                  if e.get("cat") in HOST_CATS and e.get("name") != STRETCH and "dur" in e)
    starts = [h[0] for h in host]
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:2000]:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid)
        name = "no host activity traced"
        for j in range(i - 1, max(-1, i - 4000), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        s.idle_by_host[name] = s.idle_by_host.get(name, 0.0) + (b - a) * 1e-6
    return s


class Tracer:
    """Profiles one stretch of a run (`stretch()`), when tracing is on, and
    reduces it (`finish()`) once the window has closed."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: Summary | None = None
        self.seconds = 0.0
        self._prof = None

    @contextlib.contextmanager
    def stretch(self):
        """Profile the block: the stretch starts when the device has
        finished what came before and ends when it has finished what the
        block queued."""
        if not self.enabled or self._prof is not None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        try:
            with record_function(STRETCH):
                yield
                torch.cuda.synchronize()
        finally:
            self._prof.__exit__(None, None, None)

    def finish(self) -> None:
        if self._prof is None or self.summary is not None:
            return
        t = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        self.summary = summarize(events)
        self.seconds = time.perf_counter() - t
