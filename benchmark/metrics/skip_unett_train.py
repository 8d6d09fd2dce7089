"""The share of the traced stretch that the device spent on the UNetT's
skip merges (models/unett.py: the second half's concatenation and its
bias-free projection), forward and backward: the work launched inside the
`unett.skip` ranges and inside the autograd nodes they recorded, from the
cell's tracer (benchmark/traffic/unett_steps.py `skip_seconds`). None
without a trace, or where no range was found."""

NAME = "skip.unett_train"
UNIT = "%"


def read(obs: dict):
    t = obs.get("trace")
    skip = getattr(t, "skip_s", None)
    if obs.get("kind") != "unett_train" or t is None or t.window_s <= 0 or not skip:
        return None
    return 100.0 * skip / t.window_s
