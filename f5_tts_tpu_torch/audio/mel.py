"""STFT / log-mel front-end (the port of the JAX package's `audio/mel.py`).

Semantics kept: the torch-compatible HTK filterbank computed host-side, a
periodic Hann window, *constant* zero padding of n_fft//2 on both sides
(`torch.stft(center=True)` would pad by reflection), the last frame dropped,
and a log floor of 1e-5. Output layout is [b, frames, n_mels]. `stft` and
`frame_signal` are the JAX module's one-signal helpers, with its framing
(hop `noverlap`, `nperseg // 2` zeros each side); `MelSpec` binds the
front-end to an `AudioConfig`.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from f5_tts_tpu_torch.config import AudioConfig


@lru_cache(maxsize=None)
def mel_filters(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    f_min: float = 0.0,
    f_max: float | None = None,
    norm: str | None = None,
    mel_scale: str = "htk",
) -> np.ndarray:
    """Torch-compatible mel filterbank, [n_mels, n_fft//2 + 1]: the HTK
    scale without normalization by default, or the Slaney scale and area
    normalization (`mel_scale="slaney"`, `norm="slaney"`)."""
    f_sp, min_log_hz, logstep = 200.0 / 3, 1000.0, math.log(6.4) / 27.0
    min_log_mel = min_log_hz / f_sp

    def hz_to_mel(freq: float) -> float:
        if mel_scale == "htk":
            return 2595.0 * math.log10(1.0 + freq / 700.0)
        if freq >= min_log_hz:
            return min_log_mel + math.log(freq / min_log_hz) / logstep
        return freq / f_sp

    def mel_to_hz(mels: np.ndarray) -> np.ndarray:
        if mel_scale == "htk":
            return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
        return np.where(mels >= min_log_mel, min_log_hz * np.exp(logstep * (mels - min_log_mel)), f_sp * mels)

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
    if norm == "slaney":
        fb *= (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return np.ascontiguousarray(fb.T.astype(np.float32))


@lru_cache(maxsize=None)
def hanning(size: int) -> np.ndarray:
    """Periodic Hann window (`torch.hann_window(periodic=True)`)."""
    return np.hanning(size + 1)[:-1].astype(np.float32)


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Overlapping frames of a 1-D signal -> [num_frames, frame_length], with
    num_frames = (len - frame_length + hop) // hop."""
    return x.unfold(-1, frame_length, hop)


def stft(
    x: torch.Tensor,
    window: torch.Tensor,
    nperseg: int = 256,
    noverlap: int | None = None,
    nfft: int | None = None,
) -> torch.Tensor:
    """STFT of a 1-D signal -> complex [frames, nfft//2 + 1]: `nperseg // 2`
    zeros on both sides, frames of `nperseg` every `noverlap` samples
    (default nfft // 4; the name is the JAX module's), each windowed by
    `window[:nperseg]` and zero-padded to `nfft`. The JAX function pads the
    frames before it windows them, so with `nfft` > `nperseg` its product
    does not broadcast and it raises; here the window comes first."""
    if nfft is None:
        nfft = nperseg
    if noverlap is None:
        noverlap = nfft // 4
    padding = nperseg // 2
    frames = frame_signal(F.pad(x, (padding, padding)), nperseg, noverlap)
    frames = frames * window[None, :nperseg].to(frames.dtype)
    if nfft > nperseg:
        frames = F.pad(frames, (0, nfft - nperseg))
    return torch.fft.rfft(frames, dim=-1)


def log_mel_spectrogram(
    audio: torch.Tensor,
    sample_rate: int = 24_000,
    n_mels: int = 100,
    n_fft: int = 1024,
    hop_length: int = 256,
    padding: int = 0,
) -> torch.Tensor:
    """[t] or [b, t] float32 audio, with `padding` zeros appended ->
    [b, (t + padding) // hop_length, n_mels]."""
    if audio.ndim == 1:
        audio = audio[None, :]
    if padding > 0:
        audio = F.pad(audio, (0, padding))
    device = audio.device
    pad = n_fft // 2
    x = F.pad(audio.float(), (pad, pad))  # constant zeros
    frames = x.unfold(-1, n_fft, hop_length)  # [b, frames, n_fft]
    window = torch.as_tensor(hanning(n_fft), device=device)
    spec = torch.fft.rfft(frames * window, dim=-1)
    magnitudes = spec[:, :-1, :].abs()  # the last frame is dropped
    filters = torch.as_tensor(mel_filters(sample_rate, n_fft, n_mels), device=device)
    return torch.log(torch.clamp(magnitudes @ filters.T, min=1e-5))


class MelSpec:
    """The log-mel front-end bound to its parameters: `MelSpec(...)(audio)`
    is `log_mel_spectrogram(audio, ...)`."""

    def __init__(self, sample_rate: int = 24_000, n_fft: int = 1024, hop_length: int = 256, n_mels: int = 100):
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels

    @classmethod
    def from_config(cls, cfg: AudioConfig) -> "MelSpec":
        return cls(cfg.sample_rate, cfg.n_fft, cfg.hop_length, cfg.n_mels)

    def __call__(self, audio: torch.Tensor) -> torch.Tensor:
        return log_mel_spectrogram(audio, sample_rate=self.sample_rate, n_mels=self.n_mels, n_fft=self.n_fft,
                                   hop_length=self.hop_length)
