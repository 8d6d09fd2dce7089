"""Host-side sampling helpers that the live sampler (models/cfm.py) and the
artifact loader (export.py) share: the duration clamp, the sway time grid
and the initial noise. An artifact server imports them without the model
code."""

from __future__ import annotations

import numpy as np
import torch


def clamp_duration(
    duration: np.ndarray, lens: np.ndarray, text_lens: np.ndarray, max_duration: int
) -> np.ndarray:
    """Durations are at least max(text_lens, ref_lens) + 1 frames and at most
    max_duration."""
    eff_lens = np.maximum(np.asarray(text_lens, np.int32), np.asarray(lens, np.int32))
    duration = np.maximum(eff_lens + 1, np.asarray(duration, np.int32))
    return np.clip(duration, 0, max_duration)


def sway_time_grid(steps: int, sway_sampling_coef: float | None, t_start: float = 0.0) -> np.ndarray:
    """linspace warped by sway sampling t += s*(cos(pi/2 t) - 1 + t)."""
    t = np.linspace(t_start, 1.0, steps, dtype=np.float32)
    if sway_sampling_coef is not None:
        t = t + sway_sampling_coef * (np.cos(np.pi / 2 * t) - 1 + t)
    return t


def draw_noise(seed: int, shared: bool, batch: int, padded_len: int, mel_dim: int,
               device: torch.device | str) -> torch.Tensor:
    """The sampler's initial noise y0 [batch, padded_len, mel_dim] float32,
    from a generator on `device` seeded with `seed`. With `shared`, one draw
    [padded_len, mel_dim] expanded over the batch: a fixed seed gives the
    SAME noise to every batch row, as the reference does."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if shared:
        return torch.randn(padded_len, mel_dim, generator=gen, device=device).expand(batch, padded_len, mel_dim)
    return torch.randn(batch, padded_len, mel_dim, generator=gen, device=device)
