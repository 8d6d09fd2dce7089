"""The device memory held at most during the window (the allocator's
peak, reset when the window opens), which bounds the batch a card takes."""

NAME = "peak_gib.train"
UNIT = "GiB"


def read(obs: dict):
    if obs.get("kind") != "train" or not obs.get("peak_window_bytes"):
        return None
    return obs["peak_window_bytes"] / 2**30
