"""Mask utilities (the inference subset of the JAX package's `utils/masks.py`)."""

from __future__ import annotations

import torch


def lens_to_mask(t: torch.Tensor, length: int) -> torch.Tensor:
    """Boolean [b, length] mask, True for positions < t[i]."""
    seq = torch.arange(length, device=t.device)
    return seq[None, :] < t[:, None]
