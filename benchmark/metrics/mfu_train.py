"""The whole step's share of the chip's bf16 dense peak: the model's
operations in the traced steps, from their shapes (benchmark/flops.py),
over the traced stretch's seconds times 989 TFLOP/s. The stretch is one
whole cycle of the batches, timed from the device's idle before it to
its idle after it; the profiler's start and stop lie outside it."""

from benchmark.flops import PEAK_BF16_FLOPS, train_step_flops

NAME = "mfu.train"
UNIT = "%"


def read(obs: dict):
    t = obs.get("trace")
    traced = [s for s in obs.get("steps", []) if s.get("traced")] if obs.get("kind") == "train" else []
    if t is None or t.window_s <= 0 or not traced:
        return None
    flops = sum(train_step_flops(obs["config"], s["b"], s["n"]) for s in traced)
    return 100.0 * flops / (t.window_s * PEAK_BF16_FLOPS)
