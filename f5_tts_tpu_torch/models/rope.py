"""Rotary position embeddings (the port of the JAX package's `models/rope.py`).

Two uses in the model:
  - the interleaved-pair rotary embedding of attention q/k: each frequency
    fills two adjacent lanes ((d r) with r=2), and rotate_half swaps within
    pairs;
  - a precomputed [cos|sin] table used as an absolute positional embedding
    by the text branch.
"""

from __future__ import annotations

import numpy as np
import torch


def rotary_freqs(
    seq_len: int, dim: int, base: float = 10000.0, device: torch.device | str | None = None
) -> torch.Tensor:
    """Interleaved rotary frequency table [seq_len, dim], float32:
    freqs[t, 2j] == freqs[t, 2j+1] == t * base^{-2j/dim}."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(seq_len, dtype=torch.float32, device=device)
    return torch.outer(t, inv_freq).repeat_interleave(2, dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Pairwise rotation (x0, x1) -> (-x1, x0) on the last axis."""
    x = x.unflatten(-1, (-1, 2))
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], dim=-1).flatten(-2)


def apply_rotary_pos_emb(t: torch.Tensor, freqs) -> torch.Tensor:
    """Rotate the first rot_dim channels of t [..., n, d] by the *last* n rows
    of `freqs`, a raw frequency table [n', rot_dim] or a (cos, sin) pair.
    The tables are cast to t's dtype first."""
    if isinstance(freqs, tuple):
        cos, sin = freqs
    else:
        cos, sin = torch.cos(freqs), torch.sin(freqs)
    rot_dim, seq_len = cos.shape[-1], t.shape[-2]
    cos = cos[-seq_len:, :].to(t.dtype)
    sin = sin[-seq_len:, :].to(t.dtype)
    t_rot, t_pass = t[..., :rot_dim], t[..., rot_dim:]
    t_rot = (t_rot * cos) + (rotate_half(t_rot) * sin)
    if t_pass.shape[-1] == 0:
        return t_rot
    return torch.cat([t_rot, t_pass], dim=-1)


def precompute_freqs_cis(dim: int, end: int, theta: float = 10000.0) -> np.ndarray:
    """Absolute sin/cos positional table [end, dim] = concat[cos, sin],
    computed host-side."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float32) / dim))
    t = np.arange(end)
    freqs = np.outer(t, freqs).astype(np.float32)
    return np.concatenate([np.cos(freqs), np.sin(freqs)], axis=-1)


def get_pos_embed_indices(start: torch.Tensor, length: int, max_pos: int) -> torch.Tensor:
    """Position indices [b, length], clamped to max_pos - 1."""
    pos = start[:, None] + torch.arange(length, device=start.device)[None, :]
    return pos.clamp(max=max_pos - 1)
