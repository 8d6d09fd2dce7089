"""STFT / log-mel front-end (the port of the JAX package's `audio/mel.py`).

Semantics kept: the torch-compatible HTK filterbank computed host-side, a
periodic Hann window, *constant* zero padding of n_fft//2 on both sides
(`torch.stft(center=True)` would pad by reflection), the last frame dropped,
and a log floor of 1e-5. Output layout is [b, frames, n_mels].
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def mel_filters(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    f_min: float = 0.0,
    f_max: float | None = None,
) -> np.ndarray:
    """HTK mel filterbank without normalization, [n_mels, n_fft//2 + 1]."""

    def hz_to_mel(freq: float) -> float:
        return 2595.0 * math.log10(1.0 + freq / 700.0)

    def mel_to_hz(mels: np.ndarray) -> np.ndarray:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)

    f_max = f_max or sample_rate / 2
    n_freqs = n_fft // 2 + 1
    # integer-division nyquist endpoint, as torchaudio does
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs, dtype=np.float32)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2, dtype=np.float32)
    f_pts = mel_to_hz(m_pts).astype(np.float32)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]  # [n_freqs, n_mels + 2]
    down_slopes = (-slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return np.ascontiguousarray(fb.T.astype(np.float32))


@lru_cache(maxsize=None)
def hanning(size: int) -> np.ndarray:
    """Periodic Hann window (`torch.hann_window(periodic=True)`)."""
    return np.hanning(size + 1)[:-1].astype(np.float32)


def log_mel_spectrogram(
    audio: torch.Tensor,
    sample_rate: int = 24_000,
    n_mels: int = 100,
    n_fft: int = 1024,
    hop_length: int = 256,
) -> torch.Tensor:
    """[t] or [b, t] float32 audio -> [b, t // hop_length, n_mels]."""
    if audio.ndim == 1:
        audio = audio[None, :]
    device = audio.device
    pad = n_fft // 2
    x = F.pad(audio.float(), (pad, pad))  # constant zeros
    frames = x.unfold(-1, n_fft, hop_length)  # [b, frames, n_fft]
    window = torch.as_tensor(hanning(n_fft), device=device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    magnitudes = spec[:, :-1, :].abs()  # the last frame is dropped
    filters = torch.as_tensor(mel_filters(sample_rate, n_fft, n_mels), device=device)
    return torch.log(torch.clamp(magnitudes @ filters.T, min=1e-5))
