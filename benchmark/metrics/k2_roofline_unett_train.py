"""K2's share of its roofline in the traced UNetT steps: one attention
backward a layer and step over n + 1 rows at 10 b h (n + 1)^2 d operations
(the work the gradient needs, not the 14 that the kernel executes), over
the device time of K2's pre-pass, dK/dV and dQ kernels."""

from benchmark.flops import k2_call, least_seconds
from benchmark.metrics.k2_roofline_train import KERNELS

NAME = "k2_roofline.unett_train"
UNIT = "%"


def read(obs: dict):
    t = obs.get("trace")
    traced = [s for s in obs.get("steps", []) if s.get("traced")] if obs.get("kind") == "unett_train" else []
    if t is None or not traced:
        return None
    c = obs["config"]["unett"]
    seconds, _ = t.kernel_seconds(*KERNELS)
    if seconds <= 0 or t.kernel_seconds(KERNELS[1])[1] != c["depth"] * len(traced):
        return None
    least = c["depth"] * sum(least_seconds(*k2_call(c, s["b"], s["n"] + 1)) for s in traced)
    return 100.0 * least / seconds
