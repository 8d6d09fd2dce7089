"""The RMSNorm kernels' share of their roofline in the traced UNetT steps:
the least time of their bytes (benchmark/flops_unett.py `rms_norm_bytes`:
x read, y written, g read and each row's inverse norm written forward; x,
dy and the inverse norms read, g read, dx and dg's partial sums written
backward) over the device time of the forward and backward kernels. None
unless the trace holds exactly 2 depth + 1 launches of each a step (a run
with activation checkpointing launches the forwards twice)."""

from benchmark.flops_unett import rms_norm_calls, rms_norm_least_seconds

NAME = "rmsnorm_roofline.unett_train"
UNIT = "%"
KERNELS = ("rms_norm_fwd_kernel", "rms_norm_bwd_kernel")


def read(obs: dict):
    t = obs.get("trace")
    traced = [s for s in obs.get("steps", []) if s.get("traced")] if obs.get("kind") == "unett_train" else []
    if t is None or not traced:
        return None
    calls = rms_norm_calls(obs["config"]["unett"]) * len(traced)
    if any(t.kernel_seconds(k)[1] != calls for k in KERNELS):
        return None
    seconds, _ = t.kernel_seconds(*KERNELS)
    if seconds <= 0:
        return None
    least = sum(rms_norm_least_seconds(obs["config"], s["b"], s["n"]) for s in traced)
    return 100.0 * least / seconds
