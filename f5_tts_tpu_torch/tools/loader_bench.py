"""Host data-pipeline throughput: the native C++ WAV decoder against the
Python reader, and the training pipeline's rate with the host mel and with
raw audio (the port of the JAX package's `tools/loader_bench.py`).

It writes a synthetic LibriTTS-layout corpus of `clips` clips of `seconds`
seconds (16-bit mono 24 kHz noise, numpy seed 0) to a temporary directory
and measures, on this host's CPU:
- native and Python decode, clips/s (one thread, every file once);
- scan -> threaded decode -> batches of 8, audio seconds per second, with
  the host mel (`collate_audio_batch`) and with raw audio
  (`collate_raw_audio_batch`, the on-device mel's batches).

    python -m f5_tts_tpu_torch.tools.loader_bench [--clips 256] [--seconds 6] [--threads 8]

prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from f5_tts_tpu_torch.audio.io import read_wav, write_wav
from f5_tts_tpu_torch.data.libritts import SAMPLE_RATE, decode_sample, load_dir
from f5_tts_tpu_torch.data.loader import collate_audio_batch, collate_raw_audio_batch

def make_corpus(root: Path, clips: int, seconds: float) -> None:
    rng = np.random.default_rng(0)
    d = root / "train" / "0" / "0"
    d.mkdir(parents=True)
    n = int(seconds * SAMPLE_RATE)
    for i in range(clips):
        wave = (0.1 * rng.standard_normal(n)).astype(np.float32)
        write_wav(d / f"clip_{i}.wav", wave, SAMPLE_RATE)
        (d / f"clip_{i}.normalized.txt").write_text(f"synthetic clip number {i}")


def run_pipeline(root: Path, threads: int, raw: bool) -> tuple[int, float]:
    collate = collate_raw_audio_batch if raw else collate_audio_batch
    stream = load_dir(root, max_duration=30)
    t0 = time.perf_counter()
    n = 0
    for batch in stream.map(decode_sample, num_threads=threads).batch(8, collate):
        n += len(batch["mel_len"])
    return n, time.perf_counter() - t0


def decode_rate(files: list[Path], fn) -> float:
    t0 = time.perf_counter()
    for f in files:
        fn(str(f))
    return len(files) / (time.perf_counter() - t0)


def measure(clips: int = 256, seconds: float = 6.0, threads: int = 8) -> dict:
    """The rates above on a fresh corpus; raises ImportError when the
    native decoder cannot be built."""
    from f5_tts_tpu_torch.ops.native import wav_decode

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        make_corpus(root, clips, seconds)
        files = sorted(root.rglob("*.wav"))
        native_rate = decode_rate(files, wav_decode)
        python_rate = decode_rate(files, read_wav)
        n_mel, dt_mel = run_pipeline(root, threads, raw=False)
        n_raw, dt_raw = run_pipeline(root, threads, raw=True)
    return {
        "native_decode_clips_per_s": native_rate,
        "python_decode_clips_per_s": python_rate,
        "native_speedup": native_rate / python_rate,
        "pipeline_hostmel_audio_s_per_s": n_mel * seconds / dt_mel,
        "pipeline_rawaudio_audio_s_per_s": n_raw * seconds / dt_raw,
        "clips": clips,
        "clip_seconds": seconds,
        "threads": threads,
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clips", type=int, default=256)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.clips, args.seconds, args.threads)))


if __name__ == "__main__":
    main()
