"""LibriTTS-R layout on a local directory: scan, duration filter, decode
(the local half of the JAX package's `data/libritts.py`; the corpus
download is not ported, so the directory must already hold the clips).

Each `<id>.wav` with a sibling `<id>.normalized.txt` is a sample; the file
size sets its duration (16-bit mono at 24 kHz assumed) for the
`max_duration` filter; decode drops clips at other sample rates, averages
channels to mono and turns the transcript into byte-level ids.
"""

from __future__ import annotations

import os
import threading
import warnings
from pathlib import Path

import numpy as np

from f5_tts_tpu_torch.data.loader import BYTE_VOCAB, SAMPLE_RATE, Stream
from f5_tts_tpu_torch.utils.tokenizer import list_str_to_idx

_routes_lock = threading.Lock()
# files read by each decoder since the last reset_decode_routes()
_routes = {"native": 0, "python": 0}


def decode_routes() -> dict[str, int]:
    """Files read by the native C++ decoder and by the Python reader."""
    with _routes_lock:
        return dict(_routes)


def reset_decode_routes() -> None:
    with _routes_lock:
        for k in _routes:
            _routes[k] = 0


def wav_duration_from_size(path: Path) -> float:
    """File-size duration: 16-bit mono 24 kHz assumed."""
    bytes_per_second = SAMPLE_RATE * 2
    return os.path.getsize(path) / bytes_per_second


def scan_samples(dir: Path, max_duration: float = 30) -> list[dict]:
    """All .wav files with sibling .normalized.txt transcripts, duration-filtered."""
    out = []
    for wav in sorted(Path(dir).rglob("*.wav")):
        transcript = wav.with_suffix(".normalized.txt")
        if not transcript.exists():
            continue
        if wav_duration_from_size(wav) > max_duration:
            continue
        out.append({"file": wav, "transcript_file": transcript})
    return out


def decode_sample(sample: dict) -> dict | None:
    """One scanned sample -> {"audio" float32 [n], "transcript" int32 [nt]},
    or None when the file cannot be read or is not at 24 kHz."""
    try:
        text = Path(sample["transcript_file"]).read_text().strip()
        audio, sr = _read_audio(sample["file"])
    except (OSError, ValueError):
        return None
    if sr != SAMPLE_RATE:
        return None
    if audio.ndim > 1:
        audio = audio.mean(axis=-1)
    transcript = list_str_to_idx(text, BYTE_VOCAB)[0]
    return {"audio": audio.astype(np.float32), "transcript": transcript.astype(np.int32)}


def _read_audio(path) -> tuple[np.ndarray, int]:
    """The native decoder, or the Python reader when the native library
    cannot be built (with a warning carrying the build error); each call
    counts its route (`decode_routes`)."""
    from f5_tts_tpu_torch.ops import native

    try:
        native.library()
    except ImportError as e:
        warnings.warn(f"native WAV decoder unavailable, reading WAVs in Python: {e}", RuntimeWarning,
                      stacklevel=2)
        route = "python"
    else:
        route = "native"
    with _routes_lock:
        _routes[route] += 1
    if route == "native":
        return native.wav_decode(path)
    from f5_tts_tpu_torch.audio.io import read_wav

    return read_wav(path)


def load_dir(dir, max_duration: float = 30) -> Stream:
    """The scanned-sample stream of a directory tree; pipe it through
    data.loader.make_training_pipeline for batches."""
    samples = scan_samples(Path(dir).expanduser(), max_duration=max_duration)
    print(f"Found {len(samples)} files at {dir}")
    return Stream.from_list(samples)
