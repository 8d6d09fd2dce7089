"""K1's share of its roofline in the traced UNetT steps: one forward with
its log-sum-exp a layer and step over every padded row and the time token
(n + 1 queries and keys, no mask), over the device time of K1's kernels,
its pre-pass (RoPE on the first `pe_attn_head` heads) included."""

from benchmark.flops import k1_call, least_seconds
from benchmark.metrics.k1_roofline_train import KERNELS

NAME = "k1_roofline.unett_train"
UNIT = "%"


def read(obs: dict):
    t = obs.get("trace")
    traced = [s for s in obs.get("steps", []) if s.get("traced")] if obs.get("kind") == "unett_train" else []
    if t is None or not traced:
        return None
    c = obs["config"]["unett"]
    seconds, _ = t.kernel_seconds(*KERNELS)
    if seconds <= 0 or t.kernel_seconds(KERNELS[0])[1] != c["depth"] * len(traced):
        return None
    least = c["depth"] * sum(least_seconds(*k1_call(c, [s["n"] + 1] * s["b"], s["n"] + 1, lse=True))
                             for s in traced)
    return 100.0 * least / seconds
