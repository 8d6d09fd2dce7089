"""The whole UNetT training step's share of the chip's bf16 dense peak: the
model's operations in the traced steps, from their shapes
(benchmark/flops_unett.py: the layers, the skip merges, the input
embedding and the head, and (n + 1)^2 attention pairs over every layer,
forward times 3), over the traced stretch's seconds times 989 TFLOP/s."""

from benchmark.flops import PEAK_BF16_FLOPS
from benchmark.flops_unett import train_step_flops

NAME = "mfu.unett_train"
UNIT = "%"


def read(obs: dict):
    t = obs.get("trace")
    traced = [s for s in obs.get("steps", []) if s.get("traced")] if obs.get("kind") == "unett_train" else []
    if t is None or t.window_s <= 0 or not traced:
        return None
    flops = sum(train_step_flops(obs["config"], s["b"], s["n"]) for s in traced)
    return 100.0 * flops / (t.window_s * PEAK_BF16_FLOPS)
