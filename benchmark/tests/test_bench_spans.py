"""The reduction of a traced stretch by the program's spans
(benchmark/spans.py) on a chrome trace built here, every number worked out
by hand; and the per-layer readers that were there before the spans read
the same values with and without them."""

from __future__ import annotations

import importlib

import pytest

from benchmark import spans as S
from benchmark.trace import summarize

DIT = {"dim": 128, "depth": 1, "heads": 2, "dim_head": 64, "ff_mult": 2, "mel_dim": 100, "text_dim": 64,
       "conv_layers": 1, "conv_mult": 2}
READERS = ("mfu_train", "k1_roofline_train", "k2_roofline_train", "idle_train", "peak_gib_train")
US = 1e-6


def _trace(uncorrelated_us: float = 4.0, k1_per_step: int = 1) -> list[dict]:
    """Two steps in a stretch of 1000 us. Each step at offset o (0, 400):
    the feed's kernel, launched outside the spans at o + 50, runs
    [o + 60, o + 100); the step [o + 100, o + 400) holds the forward
    [o + 110, o + 200), the backward [o + 200, o + 330) and the update
    [o + 330, o + 390). The forward launches a device-to-host copy (device
    [o + 113, o + 115)) and K1 ([o + 120, o + 180)); the backward launches
    K2 from a second thread through `cuLaunchKernelEx` ([o + 210, o + 300)) and an
    elementwise kernel from the step's thread ([o + 300, o + 320)); the
    update one kernel ([o + 335, o + 375)); the step itself, after the
    update, one more ([o + 395, o + 398)). Between the steps a
    device-to-host copy launched outside the spans runs [450, 452), and
    one kernel with no launch in the trace runs [900, 900 + uncorrelated)."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.stretch", "ts": 0.0, "dur": 1000.0, "tid": 1}]
    corr = iter(range(1, 1000))

    def span(name, a, b):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name, "ts": float(a), "dur": float(b - a), "tid": 1})

    def device(cat, name, launch_at, a, b, call="cudaLaunchKernel", launch_cat="cuda_runtime", tid=1):
        c = next(corr)
        ev.append({"ph": "X", "cat": launch_cat, "name": call, "ts": float(launch_at), "dur": 2.0, "tid": tid,
                   "args": {"correlation": c}})
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": float(a), "dur": float(b - a), "tid": 7,
                   "args": {"correlation": c, "stream": 7}})

    for o in (0, 400):
        device("kernel", "feed_kernel", o + 50, o + 60, o + 100)
        span("train.step", o + 100, o + 400)
        span("train.forward", o + 110, o + 200)
        device("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", o + 112, o + 113, o + 115, call="cudaMemcpyAsync")
        for i in range(k1_per_step):
            device("kernel", "void attn_core_fwd_kernel<64>(Params)", o + 116 + i, o + 120 + 30 * i,
                   o + 180 - 30 * (k1_per_step - 1 - i))
        span("train.backward", o + 200, o + 330)
        device("kernel", "flash_bwd_dkdv_wgmma_kernel", o + 210, o + 210, o + 300, call="cuLaunchKernelEx",
               launch_cat="cuda_driver", tid=2)
        device("kernel", "elementwise_kernel_128", o + 220, o + 300, o + 320)
        span("train.update", o + 330, o + 390)
        device("kernel", "multi_tensor_apply_kernel", o + 335, o + 335, o + 375)
        device("kernel", "vectorized_elementwise_kernel", o + 395, o + 395, o + 398)
    device("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 450, 450, 452, call="cudaMemcpyAsync")
    ev.append({"ph": "X", "cat": "kernel", "name": "orphan_kernel", "ts": 900.0, "dur": uncorrelated_us, "tid": 7,
               "args": {"stream": 7}})
    return ev


def _obs(events: list[dict]) -> dict:
    return {"kind": "train", "config": {"dit": DIT}, "steps": [{"b": 2, "n": 64, "traced": True}] * 2,
            "trace": summarize(events), "spans": S.reduce(events), "peak_window_bytes": 3 * 2**30}


def test_every_part_by_hand():
    sp = S.reduce(_trace())
    assert sp.steps == 2
    # each step: the forward's copy 2 and K1 60, the backward's K2 90 (second thread) and elementwise 20,
    # the update's 40; the step's own kernel after the update (3) is in none of the parts
    assert sp.device_s == pytest.approx({"train.forward": 124 * US, "train.backward": 220 * US,
                                         "train.update": 80 * US})
    assert sp.unmatched_s == pytest.approx(4 * US)
    # idle a step: [100, 110), [110, 113), [115, 120), [180, 200), [200, 210), [320, 330), [330, 335),
    # [375, 390), [390, 395), [398, 400); the gaps between the steps are not the steps'
    assert sp.step_idle_s == pytest.approx(2 * 85 * US)
    assert sp.host_reads == 2  # the copy between the steps is not the step's


def test_the_five_readings_by_hand():
    got = S.readings(_obs(_trace()))
    assert got == pytest.approx({"forward.train": 12.4, "backward.train": 22.0, "update.train": 8.0,
                                 "step_idle.train": 17.0, "host_reads.train": 1.0})
    # busy outside the parts: the feed 2 x 40, the copy between the steps 2, the steps' own 2 x 3, the orphan 4
    rest = 100 * (80 + 2 + 6 + 4) * US / (1000 * US)
    idle = importlib.import_module("benchmark.metrics.idle_train").read(_obs(_trace()))
    parts = got["forward.train"] + got["backward.train"] + got["update.train"]
    assert idle == pytest.approx(48.4)
    assert parts + rest + idle == pytest.approx(100.0)


@pytest.mark.parametrize("broken", ["no_steps", "k1_count", "unmatched", "no_spans", "no_stretch"])
def test_nothing_to_read(broken):
    events = _trace(uncorrelated_us=6.0 if broken == "unmatched" else 4.0,
                    k1_per_step=2 if broken == "k1_count" else 1)
    if broken == "no_steps":
        events = [e for e in events if e.get("name") != "train.step"]
    if broken == "no_stretch":
        events = [e for e in events if e.get("name") != "bench.stretch"]
        assert S.reduce(events) is None
    obs = _obs(events)
    if broken == "no_spans":
        obs.pop("spans")
    assert S.readings(obs) is None


@pytest.mark.parametrize("reader", READERS)
def test_the_earlier_readers_see_no_spans(reader):
    mod = importlib.import_module(f"benchmark.metrics.{reader}")
    events = _trace()
    plain = [e for e in events if e.get("name") not in (S.STEP,) + S.PHASES]
    assert len(plain) == len(events) - 8
    with_spans, without = mod.read(_obs(events)), mod.read(_obs(plain))
    assert with_spans is not None and with_spans == without
