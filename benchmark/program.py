"""The system under test, built as a configuration file states it: the
port's model objects with the benchmark's seeded weights loaded into them.
"""

from __future__ import annotations

import torch

from benchmark import weights as W


def dit_config(config: dict):
    from f5_tts_tpu_torch.config import DiTConfig

    return DiTConfig(**config["dit"])


def cfm_config(config: dict):
    from f5_tts_tpu_torch.config import CFMConfig

    return CFMConfig(**dict(config["cfm"], frac_lengths_mask=tuple(config["cfm"]["frac_lengths_mask"])))


def build_dit(config: dict, seed: int, device):
    """The DiT (float32 master weights) with the seed's weights."""
    from f5_tts_tpu_torch.models.dit import DiT

    with torch.device(device):
        dit = DiT(dit_config(config))
    dit.load_state_dict(W.make(W.dit_spec(config["dit"]), W.sub_seed(seed, "dit"), device), strict=True)
    return dit
