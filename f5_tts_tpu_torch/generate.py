"""Generation API, CLI and live playback: the port of the JAX package's
`generate.py`.

    f5-tts-tpu-torch --model <snapshot dir> --text "Hello there." --output out.wav
    python -m f5_tts_tpu_torch.generate --device cpu ...   # the card is the default

The flag surface, sentence splitting, duration heuristic, RMS normalisation,
reference trimming and the three synthesis branches are the JAX function's:
one sentence (or an explicit duration) in one call; sentence by sentence
into a live player; or every sentence at once, sub-batched by duration
bucket. `--model` takes a local snapshot directory (`save_pretrained`'s
layout): downloading from the hub is not ported. `--w8a8` samples with
W8A8 int8 compute (`DiTConfig.int8_compute`: int8 weights and per-token
int8 activations in the DiT blocks' attention and feed-forward linears);
`--q` with `--w8a8` raises ValueError, as in the JAX package.
`--mesh-data`/`--mesh-model` above 1 sample over a grid of the devices of
`--device`'s type (parallel/mesh.py): every CUDA card, or the one CPU
device, so too few of them raise the JAX package's ValueError.
"""

from __future__ import annotations

import argparse
import copy
import datetime
import re
import sys
from importlib import resources
from threading import Event, Lock
from typing import Literal, Optional

import numpy as np

from f5_tts_tpu_torch.audio.io import read_wav, write_wav
from f5_tts_tpu_torch.audio.resample import resample
from f5_tts_tpu_torch.utils.sampling import clamp_duration
from f5_tts_tpu_torch.utils.tokenizer import convert_char_to_pinyin

# Defaults for the model-free helpers only (`estimated_duration`); with a
# model in hand, the sample rate and hop come from its AudioConfig.
SAMPLE_RATE = 24_000
HOP_LENGTH = 256
FRAMES_PER_SEC = SAMPLE_RATE / HOP_LENGTH
TARGET_RMS = 0.1

DEFAULT_REF_TEXT = "Some call me nature, others call me mother nature."

# ------------------------------------------------------------------ utilities


def split_sentences(text: str) -> list[str]:
    """Split on sentence-final punctuation, keeping the delimiter. A trailing
    fragment with no final punctuation is kept as its own sentence."""
    parts = re.compile(r"([.!?;:])").split(text)
    sentences = [parts[i] + parts[i + 1] for i in range(0, len(parts) - 1, 2)]
    if len(parts) % 2 == 1 and parts[-1].strip():
        sentences.append(parts[-1])
    return [s.strip() for s in sentences if s.strip()]


def estimated_duration(
    ref_audio: np.ndarray,
    ref_text: str,
    gen_text: str,
    speed: float = 1.0,
    *,
    hop_length: int = HOP_LENGTH,
    frames_per_second: float = FRAMES_PER_SEC,
) -> float:
    """Byte-length-ratio duration heuristic with ZH pause-punctuation
    weighting. Returns seconds; model-aware callers pass their AudioConfig's
    hop and frame rate."""
    ref_audio_len = ref_audio.shape[0] // hop_length
    zh_pause_punc = r"。，、；：？！"
    ref_text_len = len(ref_text.encode("utf-8")) + 3 * len(re.findall(zh_pause_punc, ref_text))
    gen_text_len = len(gen_text.encode("utf-8")) + 3 * len(re.findall(zh_pause_punc, gen_text))
    duration_in_frames = ref_audio_len + int(ref_audio_len / ref_text_len * gen_text_len / speed)
    return duration_in_frames / frames_per_second


# ------------------------------------------------------------------ playback


class AudioPlayer:
    """Live playback on a sounddevice OutputStream fed from one growable
    ring buffer addressed by monotonically increasing absolute read/write
    cursors (ring index = cursor % capacity): the PortAudio callback is two
    bounded copies, and "drained" is read == write. Requires the optional
    `sounddevice` package."""

    def __init__(self, sample_rate: int = 24_000, buffer_size: int = 2048):
        import sounddevice as sd  # optional dependency

        self._sd = sd
        self.sample_rate = sample_rate
        self.buffer_size = buffer_size
        # ~1 s of headroom to start; _reserve regrows geometrically under load
        self._ring = np.zeros(max(8 * buffer_size, sample_rate), np.float32)
        self._rd = 0  # absolute cursors: total samples consumed / produced
        self._wr = 0
        self._cursor_lock = Lock()
        self.playing = False
        self.drain_event = Event()
        self.drain_event.set()  # nothing pending yet
        self._stream = None

    # -- producer side ------------------------------------------------------

    def _reserve(self, extra: int) -> None:
        """Grow the ring (holding _cursor_lock) so `extra` more samples fit;
        pending samples are linearized to the front of the new buffer."""
        pending = self._wr - self._rd
        if pending + extra <= self._ring.size:
            return
        cap = self._ring.size
        while pending + extra > cap:
            cap *= 2
        fresh = np.zeros(cap, np.float32)
        if pending:
            idx = (self._rd + np.arange(pending)) % self._ring.size
            fresh[:pending] = self._ring[idx]
        self._ring = fresh
        self._rd, self._wr = 0, pending

    def queue_audio(self, samples) -> None:
        samples = np.asarray(samples, np.float32).reshape(-1)
        if samples.size:
            with self._cursor_lock:
                # cleared inside the lock: outside it, the callback could see
                # rd == wr and set the event between the clear and the write
                self.drain_event.clear()
                self._reserve(samples.size)
                cap = self._ring.size
                at = self._wr % cap
                head = min(samples.size, cap - at)
                self._ring[at : at + head] = samples[:head]
                if samples.size > head:
                    self._ring[: samples.size - head] = samples[head:]
                self._wr += samples.size
        if not self.playing:
            self.play()

    # -- consumer side (PortAudio thread) ------------------------------------

    def _callback(self, outdata, frames, time, status):
        outdata[:, 0] = 0.0  # underruns play silence
        with self._cursor_lock:
            take = min(frames, self._wr - self._rd)
            if take:
                cap = self._ring.size
                at = self._rd % cap
                head = min(take, cap - at)
                outdata[:head, 0] = self._ring[at : at + head]
                if take > head:
                    outdata[head:take, 0] = self._ring[: take - head]
                self._rd += take
            if self._rd == self._wr:
                self.drain_event.set()

    # -- lifecycle ------------------------------------------------------------

    def play(self) -> None:
        if self.playing:
            return
        self._stream = self._sd.OutputStream(
            samplerate=self.sample_rate,
            channels=1,
            callback=self._callback,
            blocksize=self.buffer_size,
        )
        self._stream.start()
        self.playing = True

    def wait_for_drain(self):
        return self.drain_event.wait()

    def stop(self) -> None:
        if not self.playing:
            return
        self.wait_for_drain()
        # PortAudio's StopStream blocks until the buffers handed to the
        # device finish playing
        self._stream.stop()
        self._stream.close()
        self._stream = None
        self.playing = False


# ------------------------------------------------------------------ generation


def _load_ref_audio(
    ref_audio_path: Optional[str],
    ref_audio_text: Optional[str],
    sample_rate: int = SAMPLE_RATE,
    resample_ref: bool = False,
):
    """(mono float32 samples, transcript) of the reference: the file at
    `ref_audio_path`, or the bundled clip with its transcript. Audio off
    `sample_rate` raises ValueError unless `resample_ref`."""
    if ref_audio_path is None:
        wav_path = resources.files("f5_tts_tpu_torch").joinpath("assets/test_en_1_ref_short.wav")
        with resources.as_file(wav_path) as p:
            audio, sr = read_wav(p)
        ref_audio_text = ref_audio_text or DEFAULT_REF_TEXT
    else:
        audio, sr = read_wav(ref_audio_path)
    if audio.ndim > 1:
        audio = audio.mean(axis=-1)
    if sr != sample_rate:
        if not resample_ref:
            which = (
                f"the bundled reference clip is {sr} Hz but the model expects "
                f"{sample_rate} Hz; pass --ref-audio matching the model's "
                "sample rate or use --resample-ref"
                if ref_audio_path is None
                else f"Reference audio must have a sample rate of {sample_rate} Hz "
                "(or pass --resample-ref)"
            )
            raise ValueError(which)
        print(f"Resampling reference audio {sr} Hz -> {sample_rate} Hz")
        audio = resample(audio.astype(np.float32), sr, sample_rate)
    return audio.astype(np.float32), ref_audio_text


def load_model(model_name: str, quantization_bits: int | None = None, device: str = "cuda",
               int8_compute: bool = False):
    """`F5TTS.from_pretrained` on a local snapshot directory (anything else
    raises ValueError, since downloading from the hub is not ported), with
    `int8_compute` (W8A8) turned on when asked."""
    from f5_tts_tpu_torch.models.cfm import F5TTS  # here: the artifact server imports this module without it

    model = F5TTS.from_pretrained(model_name, device=device, quantization_bits=quantization_bits)
    if int8_compute:
        model.dit_cfg = model.dit_cfg.replace(int8_compute=True)
    return model


def refuse_unported(int8_compute: bool, quantization_bits: int | None) -> None:
    """The flags refused before anything loads: --q with --w8a8 (ValueError,
    as in the JAX package)."""
    if int8_compute and quantization_bits:
        raise ValueError(
            "--q (weight-only group-64 snapshots) and --w8a8 (int8 compute "
            "from float kernels) are separate paths and cannot be combined"
        )


def cli_mesh(mesh_data: int, mesh_model: int, device: str):
    """The mesh of --mesh-data/--mesh-model over the devices of `device`'s
    type (every CUDA card, or the one CPU device), or None when both are 1.
    Built before the model loads, so that too few devices (ValueError)
    refuse the run first."""
    if mesh_data <= 1 and mesh_model <= 1:
        return None
    from f5_tts_tpu_torch.parallel.mesh import create_mesh, device_list

    return create_mesh(data=mesh_data, model=mesh_model, devices=device_list(device))


def generate(
    generation_text: str,
    duration: Optional[float] = None,
    estimate_duration: bool = False,
    model_name: str = "lucasnewman/f5-tts-mlx",
    ref_audio_path: Optional[str] = None,
    ref_audio_text: Optional[str] = None,
    steps: int = 8,
    method: Literal["euler", "midpoint", "rk4"] = "rk4",
    cfg_strength: float = 2.0,
    sway_sampling_coef: float = -1.0,
    speed: float = 1.0,
    seed: Optional[int] = None,
    quantization_bits: Optional[int] = None,
    output_path: Optional[str] = None,
    int8_compute: bool = False,
    model=None,
    play: Optional[bool] = None,
    cfg_interval: Optional[tuple] = None,
    mesh=None,
    resample_ref: bool = False,
    device: str = "cuda",
) -> np.ndarray:
    """End-to-end synthesis; returns the generated waveform (the reference
    trimmed off) as float32 numpy. Pass `model` to reuse a loaded F5TTS
    across calls (it is not changed: with `int8_compute` or `mesh`, a
    shallow copy samples W8A8 or over the mesh); else `model_name`, a
    snapshot directory, is loaded onto `device`. `mesh` (parallel/mesh.py
    `create_mesh`) samples over that device grid (`F5TTS.use_mesh`)."""
    refuse_unported(int8_compute, quantization_bits)
    if model is None:
        model = load_model(model_name, quantization_bits, device, int8_compute)
    elif int8_compute or mesh is not None:
        # never change a caller's model: a later model.sample() must not run W8A8 or sharded because of one
        # call here; the attributes set below rebind on the copy
        model = copy.copy(model)
        if int8_compute:
            model.dit_cfg = model.dit_cfg.replace(int8_compute=True)
    if mesh is not None:
        model.use_mesh(mesh)
    sr = model.audio_cfg.sample_rate
    hop = model.audio_cfg.hop_length
    fps = model.audio_cfg.frames_per_second

    if play is None:
        play = output_path is None
    player = None
    if play:
        try:
            player = AudioPlayer(sample_rate=sr)
        except (ImportError, OSError) as e:
            print(f"live playback unavailable ({e}); synthesizing without it")

    audio, ref_audio_text = _load_ref_audio(
        ref_audio_path, ref_audio_text, sample_rate=sr, resample_ref=resample_ref
    )
    ref_audio_duration = audio.shape[0] / sr
    print(f"Got reference audio with duration: {ref_audio_duration:.2f} seconds")

    rms = float(np.sqrt(np.mean(np.square(audio))))
    if 0 < rms < TARGET_RMS:  # 0: an all-silent ref must not divide to NaN
        audio = audio * TARGET_RMS / rms

    sentences = split_sentences(generation_text)
    is_single = len(sentences) <= 1 or duration is not None
    start_date = datetime.datetime.now()
    sampler = dict(steps=steps, method=method, speed=speed, cfg_strength=cfg_strength,
                   sway_sampling_coef=sway_sampling_coef, seed=seed, return_trajectory=False,
                   cfg_interval=cfg_interval)

    def frames(text_piece: str) -> int:
        return int(estimated_duration(audio, ref_audio_text, text_piece, speed,
                                      hop_length=hop, frames_per_second=fps) * fps)

    def synth_one(text_piece: str, dur_frames):
        text = convert_char_to_pinyin([ref_audio_text + " " + text_piece])
        wave, _ = model.sample(audio[None, :], text=text, duration=dur_frames, **sampler)
        return wave.float().cpu().numpy()[audio.shape[0]:]

    if is_single:
        dur_frames = None
        if duration is not None:
            dur_frames = int(duration * fps)
        elif estimate_duration:
            dur_frames = frames(generation_text)
        wave = synth_one(generation_text, dur_frames)
        if player is not None:
            player.queue_audio(wave)
    elif player is not None:
        # sentence by sentence, each queued for playback when it is ready
        out = []
        for sentence in sentences:
            piece = synth_one(sentence, frames(sentence) if estimate_duration else None)
            out.append(piece)
            player.queue_audio(piece)
        wave = np.concatenate(out, axis=0)
    else:
        # every sentence at once, sub-batched by duration bucket
        texts = convert_char_to_pinyin([ref_audio_text + " " + s for s in sentences])
        ref_mel = model._mel_spec(audio[None, :])  # one reference for every sentence
        ref_frames = ref_mel.shape[1]

        text_ids = model._tokenize(texts)
        if estimate_duration or model.duration_predictor is None:
            durations = np.array([frames(s) for s in sentences], dtype=np.int32)
        else:
            durations = model.predict_duration(ref_mel.expand(len(sentences), -1, -1), text_ids, speed)
        # the clamp sample() applies, so that each piece trims right
        text_lens = (text_ids != -1).sum(axis=-1)
        durations = clamp_duration(
            durations, np.full_like(text_lens, ref_frames), text_lens, model.cfm_cfg.max_duration,
        )

        # each sentence is padded only to its own duration bucket
        bucket = model.cfm_cfg.duration_bucket
        groups: dict[int, list[int]] = {}
        for i, d in enumerate(durations):
            groups.setdefault(-(-max(int(d), 1) // bucket), []).append(i)

        pieces: list = [None] * len(sentences)
        for _, idxs in sorted(groups.items()):
            waves, _ = model.sample(
                ref_mel.expand(len(idxs), -1, -1),
                text=text_ids[idxs],
                duration=durations[idxs],
                **sampler,
            )
            waves = waves.float().cpu().numpy()
            if waves.ndim == 1:
                waves = waves[None, :]
            for j, i in enumerate(idxs):
                end = min((int(durations[i]) - 1) * hop, waves.shape[1])
                pieces[i] = waves[j, ref_frames * hop : end]
        wave = np.concatenate(pieces, axis=0)

    generated_duration = wave.shape[0] / sr
    print(f"Generated {generated_duration:.2f}s of audio in {datetime.datetime.now() - start_date}.")

    if output_path is not None:
        write_wav(output_path, wave, sr)
    if player is not None:
        player.stop()
    return wave


# ------------------------------------------------------------------ CLI


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's flag surface, plus --device."""
    parser = argparse.ArgumentParser(description="Generate audio from text using f5-tts-tpu (PyTorch)")
    parser.add_argument("--model", type=str, default="lucasnewman/f5-tts-mlx",
                        help="Local snapshot directory of the model (downloads are not ported)")
    parser.add_argument("--text", type=str, default=None,
                        help="Text to generate speech from (leave blank to input via stdin)")
    parser.add_argument("--duration", type=float, default=None,
                        help="Duration of the generated audio in seconds")
    parser.add_argument("--estimate-duration", action="store_true", default=False,
                        help="Estimate duration with a text-length heuristic instead of the duration predictor model")
    parser.add_argument("--ref-audio", type=str, default=None,
                        help="Path to the reference audio file")
    parser.add_argument("--ref-text", type=str, default=None,
                        help="Text spoken in the reference audio")
    parser.add_argument("--output", type=str, default=None,
                        help="Path to save the generated audio output")
    parser.add_argument("--steps", type=int, default=8,
                        help="Number of steps to take when sampling the neural ODE")
    parser.add_argument("--method", type=str, default="rk4", choices=["euler", "midpoint", "rk4"],
                        help="Method to use for sampling the neural ODE")
    parser.add_argument("--cfg", type=float, default=2.0,
                        help="Strength of classifier free guidance")
    parser.add_argument("--sway-coef", type=float, default=-1.0,
                        help="Coefficient for sway sampling")
    parser.add_argument("--speed", type=float, default=1.0,
                        help="Speed factor for the duration heuristic")
    parser.add_argument("--seed", type=int, default=None,
                        help="Seed for noise generation")
    parser.add_argument("--q", type=int, default=None,
                        help="Number of bits to use for quantization. 4 and 8 are supported.")
    parser.add_argument("--cfg-interval", type=str, default=None,
                        help="Apply CFG only for flow times in LO,HI (e.g. '0,0.7')")
    parser.add_argument("--w8a8", action="store_true", default=False,
                        help="int8-compute (W8A8) inference: int8 weights and activations in the DiT blocks")
    parser.add_argument("--mesh-data", type=int, default=1,
                        help="Shard batched sampling over N devices of --device's type (data parallel)")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="Tensor-parallel ways over attention heads / FF hidden")
    parser.add_argument("--resample-ref", action="store_true", default=False,
                        help="Resample reference audio to the model's rate instead of rejecting it")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device to load the model onto: the card by default, 'cpu' on request")
    return parser


def main(argv: list[str] | None = None):
    args = build_parser().parse_args(argv)
    refuse_unported(args.w8a8, args.q)
    mesh = cli_mesh(args.mesh_data, args.mesh_model, args.device)

    if args.text is None:
        if not sys.stdin.isatty():
            args.text = sys.stdin.read().strip()
        else:
            print("Please enter the text to generate:")
            args.text = input("> ").strip()

    generate(
        generation_text=args.text,
        duration=args.duration,
        estimate_duration=args.estimate_duration,
        model_name=args.model,
        ref_audio_path=args.ref_audio,
        ref_audio_text=args.ref_text,
        steps=args.steps,
        method=args.method,
        cfg_strength=args.cfg,
        sway_sampling_coef=args.sway_coef,
        speed=args.speed,
        seed=args.seed,
        quantization_bits=args.q,
        output_path=args.output,
        int8_compute=args.w8a8,
        cfg_interval=tuple(float(x) for x in args.cfg_interval.split(",")) if args.cfg_interval else None,
        mesh=mesh,
        resample_ref=args.resample_ref,
        device=args.device,
    )


if __name__ == "__main__":
    main()
