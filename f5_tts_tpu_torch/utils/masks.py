"""Mask utilities (the inference subset of the JAX package's `utils/masks.py`)."""

from __future__ import annotations

import torch


def lens_to_mask(t: torch.Tensor, length: int) -> torch.Tensor:
    """Boolean [b, length] mask, True for positions < t[i]."""
    seq = torch.arange(length, device=t.device)
    return seq[None, :] < t[:, None]


def maybe_masked_mean(t: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean over the sequence axis of t [b, n, d], restricted to mask [b, n]
    when given -> [b, d]. A row with no valid position gives 0."""
    if mask is None:
        return t.mean(dim=1)
    num = torch.where(mask[..., None], t, torch.zeros_like(t)).sum(dim=1)
    den = mask.sum(dim=-1).clamp(min=1)
    return num / den[:, None].to(t.dtype)
