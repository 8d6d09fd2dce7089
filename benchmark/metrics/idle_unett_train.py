"""The share of the UNetT cell's traced stretch in which no kernel, copy
or set ran on the device: the complement of the union of their
intervals, as `idle.train` reads the DiT cell's."""

NAME = "idle.unett_train"
UNIT = "%"


def read(obs: dict):
    t = obs.get("trace")
    if obs.get("kind") != "unett_train" or t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
