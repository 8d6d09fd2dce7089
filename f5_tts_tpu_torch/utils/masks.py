"""Mask utilities (the port of the JAX package's `utils/masks.py`)."""

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


def mask_from_start_end_indices(start: torch.Tensor, end: torch.Tensor, max_length: int) -> torch.Tensor:
    """[b, max_length] mask, True on [start, end)."""
    seq = torch.arange(max_length, device=start.device)
    return (seq[None, :] >= start[:, None]) & (seq[None, :] < end[:, None])


def mask_from_frac_lengths(
    seq_len: torch.Tensor,  # [b] int lengths
    frac_lengths: torch.Tensor,  # [b] span fraction of each length
    rand: torch.Tensor,  # [b] U(0, 1) draw that places each span
    max_length: int,
) -> torch.Tensor:
    """A contiguous span covering `frac_lengths` of each sequence, starting
    at floor((len - span) * rand): the infill training mask. The uniform
    comes in as a tensor, so a caller can feed any generator's draw."""
    lengths = (frac_lengths * seq_len).to(torch.int32)
    max_start = seq_len - lengths
    start = (max_start * rand).to(torch.int32).clamp(min=0)
    return mask_from_start_end_indices(start, start + lengths, max_length)
