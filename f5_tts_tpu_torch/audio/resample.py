"""Host-side sample-rate conversion for prompt audio, a copy of the JAX
package's `audio/resample.py` (the port cannot import that package without
JAX).

The CLI and the server refuse reference audio off the model's rate unless
asked to resample it (`--resample-ref`). Clips are seconds long, so this is
noise next to synthesis. Polyphase via scipy when present, an FFT method on
bare numpy otherwise; both band-limited, both fine for speech prompts.
"""

from __future__ import annotations

import numpy as np


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample a mono float waveform [n] from orig_sr to target_sr.

    Returns float32. Identity (same object) when the rates already match.
    """
    if orig_sr == target_sr:
        return audio
    if audio.ndim != 1:
        raise ValueError(f"resample expects mono [n] audio, got shape {audio.shape}")
    if orig_sr <= 0 or target_sr <= 0:
        raise ValueError(f"sample rates must be positive, got {orig_sr}->{target_sr}")
    try:
        from math import gcd

        from scipy.signal import resample_poly

        g = gcd(orig_sr, target_sr)
        out = resample_poly(audio.astype(np.float64), target_sr // g, orig_sr // g)
        return out.astype(np.float32)
    except ImportError:
        return _resample_fft(audio, orig_sr, target_sr)


def _resample_fft(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """FFT-method resampling: keep the spectrum below the smaller Nyquist,
    re-synthesize at the new length. Exact for band-limited signals; the
    whole-clip FFT is acceptable because prompts are short."""
    n_in = audio.shape[0]
    n_out = int(round(n_in * target_sr / orig_sr))
    spec = np.fft.rfft(audio.astype(np.float64))
    bins_out = n_out // 2 + 1
    out_spec = np.zeros(bins_out, dtype=complex)
    k = min(spec.shape[0], bins_out)
    out_spec[:k] = spec[:k]
    if k < spec.shape[0] and k > 0:
        # energy at the (shared) Nyquist bin would otherwise double-count
        out_spec[k - 1] = out_spec[k - 1].real
    return (np.fft.irfft(out_spec, n=n_out) * (n_out / n_in)).astype(np.float32)
