"""LibriTTS-R: a split's archive already on disk, extraction, directory
scanning, decode (the port of the JAX package's `data/libritts.py`, whose
download is not ported).

`load_libritts_r(root, split)` takes the split's archive under `root`
(default `$F5_TTS_CACHE/libritts_r`, the JAX package's cache, so one archive
serves both): `<root>/<name>.tar` if present, else `<root>/<name>.tar.gz`,
which it gunzips and removes, as the JAX function does after a download.
It extracts the tar into `root` unless `<root>/LibriTTS_R/<split>` exists,
and scans that directory (`load_dir`). With neither file present it raises
ValueError naming the file expected: there is no network to download from.

Each `<id>.wav` with a sibling `<id>.normalized.txt` is a sample; the file
size sets its duration (16-bit mono at 24 kHz assumed) for the
`max_duration` filter; decode drops clips at other sample rates, averages
channels to mono and turns the transcript into byte-level ids.
"""

from __future__ import annotations

import gzip
import os
import shutil
import tarfile
import threading
import warnings
from pathlib import Path

import numpy as np

from f5_tts_tpu_torch.data.loader import BYTE_VOCAB, SAMPLE_RATE, Stream
from f5_tts_tpu_torch.utils.tokenizer import list_str_to_idx

CACHE_DIR = Path(os.environ.get("F5_TTS_CACHE", Path.home() / ".cache" / "f5_tts_tpu"))

# split -> (the public archive's URL, its md5), as the JAX package lists them; the URL's file name is the one
# looked for under root
SPLITS = {
    "dev-clean": (
        "https://www.openslr.org/resources/141/dev_clean.tar.gz",
        "2c1f5312914890634cc2d15783032ff3",
    ),
    "dev-other": (
        "https://www.openslr.org/resources/141/dev_other.tar.gz",
        "62d3a80ad8a282b6f31b3904f0507e4f",
    ),
    "test-clean": (
        "https://www.openslr.org/resources/141/test_clean.tar.gz",
        "4d373d453eb96c0691e598061bbafab7",
    ),
    "test-other": (
        "https://www.openslr.org/resources/141/test_other.tar.gz",
        "dbc0959d8bdb6d52200595cabc9995ae",
    ),
    "train-clean-100": (
        "https://www.openslr.org/resources/141/train_clean_100.tar.gz",
        "6df668d8f5f33e70876bfa33862ad02b",
    ),
    "train-clean-360": (
        "https://www.openslr.org/resources/141/train_clean_360.tar.gz",
        "382eb3e64394b3da6a559f864339b22c",
    ),
    "train-other-500": (
        "https://www.openslr.org/resources/141/train_other_500.tar.gz",
        "a37a8e9f4fe79d20601639bf23d1add8",
    ),
}


def load_libritts_r_tarfile(
    root=None, split: str = "dev-clean", quiet: bool = False, validate_download: bool = True
) -> Path:
    """The split's decompressed tar under `root` (see the module's note);
    returns its path. `quiet` and `validate_download` are the JAX
    signature's: the md5 check there follows a download, which is not
    ported."""
    if split not in SPLITS:
        raise ValueError(f"Unknown libritts_r split '{split}'. It should be one of [{', '.join(SPLITS)}]")
    root = Path(root) if root is not None else CACHE_DIR / "libritts_r"
    url, _ = SPLITS[split]
    target_compressed = root / Path(url).name
    target = root / target_compressed.name.replace(".gz", "")
    if not target.is_file():
        if not target_compressed.is_file():
            raise ValueError(
                f"{target_compressed} (or {target.name}) is not there, and the PyTorch package does not download "
                f"the corpus (downloading is not ported): place the {split} archive ({url}) under {root}")
        with gzip.open(target_compressed, "rb") as fin, open(target, "wb") as fout:
            shutil.copyfileobj(fin, fout)
        target_compressed.unlink()
    return target


def load_libritts_r(
    root=None,
    split: str = "dev-clean",
    quiet: bool = False,
    validate_download: bool = True,
    max_duration: float = 30,
) -> tuple[Stream, Path]:
    """The split's archive under `root`, extracted there, scanned
    (`load_dir`): returns (the sample stream, the split's directory)."""
    target = load_libritts_r_tarfile(root=root, split=split, quiet=quiet, validate_download=validate_download)
    path = target.parent / "LibriTTS_R" / split
    if not path.exists():
        with tarfile.open(target) as tar:
            tar.extractall(path=target.parent, filter="data")
    return load_dir(path, max_duration=max_duration), path


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
