"""The device memory held at most during the UNetT cell's window (the
allocator's peak, reset when the window opens): the model, AdamW's
moments, the EMA and the activations of the widest batch, with the skip
sources held from the first half of the layers to the second."""

NAME = "peak_gib.unett_train"
UNIT = "GiB"


def read(obs: dict):
    if obs.get("kind") != "unett_train" or not obs.get("peak_window_bytes"):
        return None
    return obs["peak_window_bytes"] / 2**30
