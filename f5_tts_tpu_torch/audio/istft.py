"""Inverse STFT with a per-request count of valid frames (the port of the
JAX package's `audio/istft.py`).

torch.istft semantics with center=True (per-frame irfft, synthesis window,
overlap-add, division by the summed squared-window envelope, n_fft//2
trimmed from both ends), plus `valid_frames`, which torch.istft has no
counterpart for: frames past it leave both the overlap-add and the envelope.

The imaginary parts of the DC and Nyquist bins are dropped before the
inverse FFT, as numpy's and the CPU's irfft drop them. cuFFT's C2R leaves
them undefined: with them in, a frame's samples on the card change with the
plan, and so with the batch size.
"""

from __future__ import annotations

import torch


def istft(
    spec: torch.Tensor,  # complex [b, frames, n_fft//2 + 1]
    window: torch.Tensor,  # [n_fft]
    n_fft: int,
    hop_length: int,
    valid_frames: int | None = None,
) -> torch.Tensor:
    """Returns the waveform [b, (frames - 1) * hop_length].

    With `valid_frames`, the first (valid_frames - 1) * hop_length samples
    equal istft(spec[:, :valid_frames]), so a bucket-padded batch decodes
    like the trimmed one."""
    if n_fft % hop_length != 0:
        raise ValueError("n_fft must be a multiple of hop_length")
    ratio = n_fft // hop_length
    b, frames = spec.shape[0], spec.shape[1]

    valid = None
    if valid_frames is not None:
        valid = torch.arange(frames, device=spec.device) < valid_frames
        spec = spec * valid[None, :, None].to(spec.dtype)

    bins = spec.shape[-1]
    inner = (torch.arange(bins, device=spec.device) % (bins - 1) != 0).to(spec.real.dtype)  # 0 at DC, Nyquist
    spec = torch.complex(spec.real, spec.imag * inner)
    ywin = torch.fft.irfft(spec, n=n_fft, dim=-1) * window  # [b, frames, n_fft]

    # overlap-add: frame i covers blocks [i, i + ratio); block m sums chunk j
    # of frame m - j
    chunks = ywin.reshape(b, frames, ratio, hop_length)
    out = torch.zeros(b, frames + ratio - 1, hop_length, dtype=ywin.dtype, device=ywin.device)
    w2 = window.square().reshape(ratio, hop_length)
    env = torch.zeros(frames + ratio - 1, hop_length, dtype=w2.dtype, device=w2.device)
    frame_w = 1.0 if valid is None else valid.to(w2.dtype)[:, None]
    for j in range(ratio):
        out[:, j : j + frames] += chunks[:, :, j]
        env[j : j + frames] += w2[j][None, :] * frame_w
    y = out.reshape(b, -1) / torch.clamp(env.reshape(-1), min=1e-11)
    pad = n_fft // 2
    return y[:, pad:-pad]
