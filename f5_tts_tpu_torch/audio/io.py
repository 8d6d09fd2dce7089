"""Host-side WAV read/write, a copy of the JAX package's `audio/io.py` (the
port cannot import that package without JAX).

PCM WAV I/O on the stdlib `wave` module, with soundfile used when it is
installed. Covers PCM 8/16/24/32-bit and IEEE float32.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples in [-1, 1] (mono: [n]; multi-channel:
    [n, c]), sample_rate)."""
    try:
        import soundfile as sf  # pragma: no cover - environment dependent

        data, sr = sf.read(str(path))
        return data.astype(np.float32), sr
    except ImportError:
        pass

    path = Path(path)
    # IEEE-float wavs are rejected by the `wave` module on some versions;
    # parse the RIFF header ourselves when needed.
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path} is not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            payload = f.read(size + (size & 1))
            if chunk_id == b"fmt ":
                if len(payload) < 16:
                    raise ValueError(f"{path}: truncated fmt chunk")
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif chunk_id == b"data":
                data = payload[:size]
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")

    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 3 and bits == 32:  # IEEE float
        samples = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_format in (1, 0xFFFE):  # PCM (or extensible, assume PCM)
        if bits == 16:
            samples = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            samples = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            samples = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            samples = ints.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAV format code {audio_format}")

    if channels > 1:
        samples = samples.reshape(-1, channels)
    return samples, sr


def write_wav(path: str | Path, samples: np.ndarray, sample_rate: int) -> None:
    """Write float samples in [-1, 1] as 16-bit PCM WAV."""
    try:
        import soundfile as sf  # pragma: no cover - environment dependent

        sf.write(str(path), np.asarray(samples), sample_rate)
        return
    except ImportError:
        pass

    samples = np.asarray(samples, dtype=np.float32)
    pcm = np.clip(samples, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    channels = 1 if pcm.ndim == 1 else pcm.shape[1]
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
