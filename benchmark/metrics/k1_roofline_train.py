"""K1's share of its roofline in the traced training steps: one forward
with its log-sum-exp a block and step, over every padded frame (the
training forward passes no mask), over the device time of K1's kernels,
its pre-pass included."""

from benchmark.flops import k1_call, least_seconds

NAME = "k1_roofline.train"
UNIT = "%"
KERNELS = ("attn_core_fwd_kernel", "flash_fwd_prepass_kernel")


def read(obs: dict):
    t = obs.get("trace")
    traced = [s for s in obs.get("steps", []) if s.get("traced")] if obs.get("kind") == "train" else []
    if t is None or not traced:
        return None
    c = obs["config"]["dit"]
    seconds, _ = t.kernel_seconds(*KERNELS)
    if seconds <= 0 or t.kernel_seconds(KERNELS[0])[1] != c["depth"] * len(traced):
        return None
    least = c["depth"] * sum(least_seconds(*k1_call(c, [s["n"]] * s["b"], s["n"], lse=True)) for s in traced)
    return 100.0 * least / seconds
