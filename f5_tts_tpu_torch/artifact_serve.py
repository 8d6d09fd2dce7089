"""Deployment server backed by exported sampler artifacts, with
micro-batching (the port of the JAX package's `artifact_serve.py`).

The consumer side of `export.py`: a serving host that carries this
package's host utilities (the mel front-end, the tokenizer, WAV plumbing),
its registered kernels (`ops/`) and artifact files. It imports no model
code (`models/cfm.py`, `models/dit.py`, `models/duration.py`), reads no
snapshot, and traces nothing at request time: each artifact is a fixed
`torch.export` program. Concurrent requests are grouped by the live
server's micro-batch scheduler (`serve.MicroBatcher`): compatible requests
(one bucket and sampler scalars) run as ONE call of a batch-N artifact.
Long text streams sentence by sentence via `/synthesize_stream`.

    f5-tts-tpu-torch-export --model SNAP --out b1_768.bin --batch 1 --padded-len 768 \\
        --steps 8 --method rk4 --external-weights
    f5-tts-tpu-torch-export --model SNAP --out b4_768.bin --batch 4 --padded-len 768 \\
        --steps 8 --method rk4 --external-weights
    f5-tts-tpu-torch-artifact-serve --artifact b1_768.bin --artifact b4_768.bin \\
        --vocab SNAP/vocab.txt --ref ref.wav --ref-text "..."

Requests take the smallest bucket length that fits their clamped duration;
within a length, the scheduler takes the batch variant that best fits the
group and fills unused slots with copies of the last item (the program
masks each item by its lens and duration). `duration` is client-supplied
seconds; a request without it resolves through the trained duration
predictor when a `--duration-artifact` (`f5-tts-tpu-torch-export
--duration`) is loaded, or through the byte-length heuristic otherwise or
under `estimate_duration`, as the live server does.

Unlike the JAX server, a `/synthesize` request whose duration the
predictor sets is planned in the batcher thread (`_predict_durations`,
before grouping, as the live server's `serve.py` does), never in the
handler thread before the backlog bound. A stream still plans every
sentence before it commits its response, so that it never truncates one
it has started, but it holds a backlog slot for each sentence first.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
import traceback
from concurrent.futures import InvalidStateError
from concurrent.futures import TimeoutError as FuturesTimeoutError
from dataclasses import dataclass
from http.server import ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import torch

from f5_tts_tpu_torch.audio.mel import log_mel_spectrogram
from f5_tts_tpu_torch.config import AudioConfig
from f5_tts_tpu_torch.export import load_duration, load_sampler, prep_duration_inputs, prep_inputs
from f5_tts_tpu_torch.generate import estimated_duration
from f5_tts_tpu_torch.serve import MicroBatcher, Overloaded, _Request
from f5_tts_tpu_torch.utils.tokenizer import (
    convert_char_to_pinyin,
    list_str_to_idx,
    list_str_to_tensor,
    load_vocab,
)


@dataclass
class Bucket:
    sampler: object  # export.LoadedProgram
    spec: object  # SamplerSpec (sampling buckets) | DurationSpec (predictor)
    path: str


class ArtifactSampler:
    """The device surface: a set of (padded_len, batch) artifact buckets on
    one device, a mel front-end, and a lock that keeps device work to one
    thread at a time (the batcher's, and a stream handler's planning)."""

    def __init__(self, artifact_paths: list[str], vocab_path: str | None = None,
                 duration_artifact: str | None = None, device: str | torch.device | None = None):
        if not artifact_paths:
            raise ValueError("need at least one --artifact")
        self.buckets: list[Bucket] = []
        for p in artifact_paths:
            t0 = time.perf_counter()
            sampler, spec = load_sampler(p, device)
            if len(sampler.program.graph_signature.user_outputs) != 2:
                raise ValueError(f"{p} is a mel-only artifact (--mel-only); this server needs the vocoded wave: "
                                 "export it again without --mel-only")
            self.buckets.append(Bucket(sampler, spec, p))
            print(f"loaded {p} (bucket {spec.padded_len} x{spec.batch}, {spec.steps} steps): "
                  f"{time.perf_counter() - t0:.1f} s")
        self.buckets.sort(key=lambda b: (b.spec.padded_len, b.spec.batch))
        s0 = self.buckets[0].spec
        self.device = self.buckets[0].sampler.device
        for b in self.buckets[1:]:
            if (b.spec.hop_length, b.spec.sample_rate, b.spec.mel_dim) != (s0.hop_length, s0.sample_rate, s0.mel_dim):
                raise ValueError(f"{b.path}: audio constants differ from {self.buckets[0].path}; all artifacts must "
                                 "come from the same model")
            if b.sampler.device != self.device:
                raise ValueError(f"{b.path} is loaded on {b.sampler.device}, {self.buckets[0].path} on {self.device}")
        self.spec = s0  # the shared audio-domain constants
        self.lengths = sorted({b.spec.padded_len for b in self.buckets})
        self.max_batch = max(b.spec.batch for b in self.buckets)
        self.audio_cfg = AudioConfig(sample_rate=s0.sample_rate, hop_length=s0.hop_length, n_mels=s0.mel_dim)
        self.vocab = load_vocab(vocab_path) if vocab_path else None
        self._device_lock = threading.Lock()

        # the trained duration predictor (export.py export_duration); without it, requests that omit
        # `duration` take the byte-length heuristic (the live server's two tiers)
        self.duration: Bucket | None = None
        if duration_artifact:
            dsampler, dspec = load_duration(duration_artifact, self.device)
            if dspec.batch != 1:
                raise ValueError(f"{duration_artifact}: duration artifact batch={dspec.batch}; this server predicts "
                                 "one request at a time: export with --batch 1")
            if (dspec.hop_length, dspec.sample_rate, dspec.mel_dim) != (s0.hop_length, s0.sample_rate, s0.mel_dim):
                raise ValueError(f"{duration_artifact}: audio constants differ from {self.buckets[0].path}; the "
                                 "duration artifact must come from the same model family")
            self.duration = Bucket(dsampler, dspec, duration_artifact)

    def _mel(self, audio: np.ndarray) -> torch.Tensor:
        """Waves [b, t] -> log-mel [b, t // hop, n_mels] on the device."""
        a = self.audio_cfg
        return log_mel_spectrogram(torch.as_tensor(audio, device=self.device), a.sample_rate, a.n_mels, a.n_fft,
                                   a.hop_length)

    def tokenize(self, texts: list[str]) -> np.ndarray:
        if self.vocab is not None:
            return list_str_to_idx(convert_char_to_pinyin(texts), self.vocab)
        return list_str_to_tensor(texts)

    def pick_length(self, needed_frames: int) -> int:
        """The smallest bucket length whose window holds `needed_frames`,
        which must be the CLAMPED requirement max(duration, ref_frames + 1,
        text_len + 1) (`plan` computes it): prep_inputs raises the duration
        to at least lens + 1."""
        for length in self.lengths:
            if needed_frames <= length:
                return length
        raise ValueError(f"duration {needed_frames} frames exceeds the largest artifact bucket "
                         f"({self.lengths[-1]}); export a bigger one")

    def pick_artifact(self, length: int, k: int) -> Bucket:
        """The batch variant of bucket `length` that best serves k requests:
        the smallest batch >= k, else the largest (the caller chunks)."""
        variants = [b for b in self.buckets if b.spec.padded_len == length]
        if not variants:
            raise ValueError(f"no artifact with padded_len={length}")
        for b in variants:  # sorted by batch ascending
            if b.spec.batch >= k:
                return b
        return variants[-1]

    def warmup(self) -> None:
        """Run every artifact once on silence (and the duration predictor),
        through `synthesize_chunk` and `_predict_duration_frames`, so the
        first request pays none of the first-use costs (kernel builds,
        cuBLAS and cuDNN plans, allocator growth)."""
        hop = self.audio_cfg.hop_length
        silence = np.zeros(4 * hop, np.float32)
        pad_ids = np.full((4,), -1, np.int32)
        for b in self.buckets:
            t0 = time.perf_counter()
            bb = b.spec.batch
            self.synthesize_chunk(b, [pad_ids] * bb, [silence] * bb, [8] * bb, sway_sampling_coef=-1.0, seed=0)
            print(f"warmed {b.path} (bucket {b.spec.padded_len} x{bb}): {time.perf_counter() - t0:.1f} s")
        if self.duration is not None:
            t0 = time.perf_counter()
            self._predict_duration_frames(silence, "", "warm up", 1.0)
            print(f"warmed {self.duration.path} (duration predictor): {time.perf_counter() - t0:.1f} s")

    def _ref_frames(self, ref_audio: np.ndarray) -> int:
        """Frames of reference an artifact can condition on: lens must stay
        below the largest bucket window (prep_inputs clamps the duration to
        lens + 1) and below max_duration."""
        hop = self.audio_cfg.hop_length
        return min(ref_audio.shape[0] // hop, self.lengths[-1] - 1, self.spec.max_duration - 1)

    def _predict_duration_frames(self, ref_audio: np.ndarray, ref_text: str, text: str, speed: float,
                                 text_ids: np.ndarray | None = None) -> int:
        """Total frames from the exported duration predictor, as the live
        path: the reference mel over the artifact's fixed window with `lens`
        marking the real frames, seconds -> frames at sample_rate // hop,
        divided by speed. A reference longer than the window is
        prefix-truncated (predicting the full duration from a prefix is the
        predictor's training task)."""
        d = self.duration.spec
        hop = self.audio_cfg.hop_length
        ref_frames = max(min(ref_audio.shape[0] // hop, d.padded_len), 1)
        buf = np.zeros((1, d.padded_len * hop), np.float32)
        n = min(ref_audio.shape[0], ref_frames * hop)
        buf[0, :n] = ref_audio[:n]
        if text_ids is None:
            text_ids = self.tokenize([ref_text + " " + text])
        with self._device_lock, torch.inference_mode():
            mel = self._mel(buf)[:, :d.padded_len]
            cond = torch.where(torch.arange(mel.shape[1], device=mel.device)[None, :, None] < ref_frames, mel, 0.0)
            args = prep_duration_inputs(d, cond, text_ids, lens=np.array([ref_frames], np.int32))
            seconds = float(self.duration.sampler.call(*args)[0])
        frame_rate = d.sample_rate // d.hop_length
        # the live path's rounding order: seconds * frame_rate truncates before the speed division
        return max(int(int(seconds * frame_rate) / speed), 1)

    def plan(self, text: str, ref_audio: np.ndarray, ref_text: str, duration_frames: int | None, *,
             speed: float = 1.0, estimate: bool = False) -> tuple[int, np.ndarray, int]:
        """What a request needs before it runs: total frames (the trained
        predictor when a duration artifact is loaded and `estimate` does not
        force the byte-length heuristic), token ids, and the bucket length.
        Raises ValueError for anything no bucket can hold."""
        hop = self.audio_cfg.hop_length
        text_ids = self.tokenize([ref_text + " " + text])
        if duration_frames is None:
            use_predictor = self.duration is not None and not estimate
            # text longer than the predictor's window cannot be truncated meaningfully: the heuristic then
            if use_predictor and int((text_ids != -1).sum(axis=-1).max()) > self.duration.spec.padded_len:
                use_predictor = False
            if use_predictor:
                duration_frames = self._predict_duration_frames(ref_audio, ref_text, text, speed, text_ids=text_ids)
            else:
                fps = self.audio_cfg.frames_per_second
                duration_frames = int(estimated_duration(ref_audio, ref_text, text, speed, hop_length=hop,
                                                         frames_per_second=fps) * fps)
        duration_frames = min(max(duration_frames, 1), self.spec.max_duration)
        # bucket by the CLAMPED requirement: prep_inputs raises the duration to at least lens + 1
        text_len = int((text_ids != -1).sum(axis=-1).max()) if text_ids.size else 0
        length = self.pick_length(max(duration_frames, self._ref_frames(ref_audio) + 1, text_len + 1))
        return duration_frames, text_ids, length

    def needs_predictor(self, duration_frames: int | None, estimate: bool) -> bool:
        """Whether `plan` would run the duration artifact on the device."""
        return duration_frames is None and not estimate and self.duration is not None

    def synthesize_chunk(self, art: Bucket, text_ids_list: list[np.ndarray], ref_audios: list[np.ndarray],
                         durations: list[int], *, sway_sampling_coef: float | None = -1.0,
                         seed: int = 0) -> list[np.ndarray]:
        """Up to art.spec.batch requests -> one artifact call -> each item's
        generated-region wave (reference trimmed at its frame edge, as the
        live server trims). Unused slots hold copies of the last item."""
        hop = self.audio_cfg.hop_length
        L = art.spec.padded_len
        b = art.spec.batch
        k = len(text_ids_list)
        if k > b or k == 0:
            raise ValueError(f"chunk of {k} items for a batch-{b} artifact")
        nt = max(ids.shape[0] for ids in text_ids_list)
        ref_buf = np.zeros((b, L * hop), np.float32)
        text_mat = np.full((b, max(nt, 1)), -1, np.int32)
        lens = np.ones((b,), np.int32)
        durs = np.ones((b,), np.int32)
        for i in range(b):
            src = min(i, k - 1)
            r = ref_audios[src]
            rf = min(self._ref_frames(r), L - 1)
            n = min(r.shape[0], rf * hop)
            ref_buf[i, :n] = r[:n]
            ids = text_ids_list[src]
            text_mat[i, :ids.shape[0]] = ids
            lens[i] = max(rf, 1)
            durs[i] = durations[src]

        with self._device_lock, torch.inference_mode():
            # the mel over the bucket's fixed window stays on the device; frames past each item's lens are
            # masked inside the program
            cond = self._mel(ref_buf)[:, :L]
            args = prep_inputs(art.spec, cond, text_mat, durs, lens=lens, sway_sampling_coef=sway_sampling_coef,
                               seed=seed)
            waves = art.sampler.call(*args)[1].float().cpu().numpy()
        lens_used, durs_used = args[1], args[2]
        return [waves[i, int(lens_used[i]) * hop:min((int(durs_used[i]) - 1) * hop, waves.shape[1])]
                for i in range(k)]

    def synthesize(self, text: str, ref_audio: np.ndarray, ref_text: str, duration_frames: int | None, *,
                   speed: float = 1.0, sway_sampling_coef: float | None = -1.0, seed: int = 0,
                   estimate: bool = False) -> np.ndarray:
        """One request -> its generated-region float wave: the direct API,
        the same code path as a batch of one."""
        duration_frames, text_ids, length = self.plan(text, ref_audio, ref_text, duration_frames, speed=speed,
                                                      estimate=estimate)
        art = self.pick_artifact(length, 1)
        return self.synthesize_chunk(art, [np.asarray(text_ids[0])], [ref_audio], [duration_frames],
                                     sway_sampling_coef=sway_sampling_coef, seed=seed)[0]


class ArtifactBatcher(MicroBatcher):
    """serve.MicroBatcher over artifacts: the same scheduler (rank, then
    shortest job first, bounded backlog, deadlines), with groups keyed on
    the planned bucket and run through batch-N artifacts. A request that
    arrives without a duration is planned here, in the batcher thread,
    with the duration artifact (`_predict_durations`)."""

    def __init__(self, sampler: ArtifactSampler, **kw):
        # the base scheduler reads the model's device (run), configs and nothing else: a shim stands in
        shim = SimpleNamespace(
            cfm_cfg=SimpleNamespace(duration_bucket=sampler.lengths[0], max_duration=sampler.spec.max_duration),
            audio_cfg=sampler.audio_cfg,
            device=sampler.device,
        )
        super().__init__(model=shim, **kw)
        self.sampler = sampler

    def reserve(self, n: int) -> None:
        """Count `n` requests toward the backlog bound before they exist,
        or raise Overloaded; each request built on the reservation is
        submitted with `counted=True` (or the slots freed with `unreserve`)."""
        with self._count_lock:
            if self._outstanding + n > self.max_queue:
                raise Overloaded(f"request queue full ({self.max_queue} pending); retry later")
            self._outstanding += n

    def unreserve(self, n: int) -> None:
        with self._count_lock:
            self._outstanding -= n

    def submit(self, req: _Request):
        if not req.counted:
            return super().submit(req)
        # a reserved slot: already counted
        if req.deadline is None and self.request_timeout_s:
            req.deadline = req.t_submit + self.request_timeout_s
        try:
            self.queue.put_nowait(req)
        except queue.Full:
            self._release([req])
            raise Overloaded(f"request queue full ({self.queue.maxsize} pending); retry later") from None
        return req.future

    def _predict_durations(self, reqs: list[_Request]) -> None:
        """Plan the requests that arrived without a duration: frames (the
        duration artifact), token ids and the bucket. A failure fails only
        its own request."""
        for r in reqs:
            try:
                r.duration_frames, ids, r.bucket_len = self.sampler.plan(r.text, r.ref_audio, r.ref_text, None,
                                                                         speed=r.speed)
                r.text_ids = np.asarray(ids[0])
            except Exception as e:
                if not r.future.done():
                    r.future.set_exception(e)

    def _group_key(self, r: _Request) -> tuple:
        # steps, method and cfg_strength are baked into each artifact; sway and seed are one scalar a call, so
        # they partition. The layout is the base scheduler's: [0] scales job cost, [5] bucket, [6] rank
        if r.bucket_len is None and r.duration_frames is not None:
            # a directly submitted request with an explicit duration: plan its bucket here; an unservable one
            # fails its own future and keys into the dead group below, which _run_group drains as a no-op
            try:
                if r.text_ids is None:
                    r.text_ids = np.asarray(self.sampler.tokenize([r.ref_text + " " + r.text])[0])
                text_len = int((r.text_ids != -1).sum())
                ref_frames = self.sampler._ref_frames(r.ref_audio)
                r.bucket_len = self.sampler.pick_length(max(r.duration_frames, ref_frames + 1, text_len + 1))
            except Exception as e:
                if not r.future.done():
                    r.future.set_exception(e)
        return (1, "", 0.0, r.sway, r.seed, r.bucket_len or 0, r.stream_rank)

    def _run_group(self, group: list[_Request]) -> None:
        try:
            # requests whose future settled (failed planning, cancelled, expired) never reach the device
            live = [r for r in group if not r.future.done()]
            if not live:
                return
            s = self.sampler
            length = live[0].bucket_len
            remaining = list(live)
            while remaining:
                art = s.pick_artifact(length, len(remaining))
                chunk, remaining = remaining[:art.spec.batch], remaining[art.spec.batch:]
                waves = s.synthesize_chunk(
                    art, [np.asarray(r.text_ids) for r in chunk], [r.ref_audio for r in chunk],
                    [r.duration_frames for r in chunk], sway_sampling_coef=group[0].sway,
                    seed=group[0].seed if group[0].seed is not None else 0,
                )
                for r, w in zip(chunk, waves):
                    try:
                        r.future.set_result(w)
                    except InvalidStateError:
                        pass  # cancelled mid-synthesis; group-mates unaffected
        except Exception as e:  # pragma: no cover - error propagation
            for r in group:
                if not r.future.done():
                    try:
                        r.future.set_exception(e)
                    except InvalidStateError:
                        pass
        finally:
            self._release(group)


def make_handler(batcher: ArtifactBatcher, default_ref, allow_resample: bool = False):
    from f5_tts_tpu_torch.generate import split_sentences
    from f5_tts_tpu_torch.serve import (
        BadRequest,
        JsonHTTPHandler,
        _pcm16,
        _wav_bytes,
        _wav_stream_header,
        resolve_ref_payload,
    )

    sampler = batcher.sampler
    acfg = sampler.audio_cfg
    # the longest reference a bucket can condition on: lens stays below the window (the clamp to lens + 1)
    max_ref_samples = (sampler.lengths[-1] - 1) * acfg.hop_length
    timeout = (batcher.request_timeout_s + 30) if batcher.request_timeout_s else None

    def parse_params(payload):
        """The sampler knobs of both endpoints; BadRequest (400) for a
        malformed value."""
        try:
            speed = float(payload.get("speed", 1.0))
            sway = payload.get("sway_sampling_coef", -1.0)
            sway = None if sway is None else float(sway)
            seed = int(payload.get("seed", 0))
            duration = payload.get("duration")
            duration = None if duration is None else float(duration)
        except (TypeError, ValueError) as e:
            raise BadRequest(f"bad parameter: {e}") from None
        if not speed > 0:
            raise BadRequest("speed must be > 0")
        return speed, sway, seed, duration

    def build_request(text, ref_audio, ref_text, *, speed, sway, seed, duration_frames, estimate,
                      stream_rank=0, plan=True) -> _Request:
        """A batcher request; with `plan`, planned here (frames, ids and
        bucket; ValueError for anything no bucket holds), else left to the
        batcher thread with `duration_frames=None`."""
        req = _Request(text=text, ref_audio=ref_audio, ref_text=ref_text, duration_frames=None, steps=0, method="",
                       cfg_strength=0.0, sway=sway, seed=seed, speed=speed, stream_rank=stream_rank)
        if plan:
            req.duration_frames, ids, req.bucket_len = sampler.plan(text, ref_audio, ref_text, duration_frames,
                                                                    speed=speed, estimate=estimate)
            req.text_ids = np.asarray(ids[0])
        return req

    class Handler(JsonHTTPHandler):
        def do_GET(self):
            if self.path == "/healthz":
                self._json_response(200, {
                    "buckets": [{"padded_len": b.spec.padded_len, "batch": b.spec.batch, "steps": b.spec.steps,
                                 "method": b.spec.method, "cfg_strength": b.spec.cfg_strength}
                                for b in sampler.buckets],
                    "sample_rate": acfg.sample_rate,
                    "duration_predictor": (None if sampler.duration is None
                                           else {"padded_len": sampler.duration.spec.padded_len}),
                })
            else:
                self._json_error(404, "unknown path")

        def _overloaded(self):
            self._json_response(503, {"error": "server overloaded; retry later"},
                                extra_headers=(("Retry-After", "1"),))
            self.close_connection = True

        def do_POST(self):
            if self.path == "/synthesize_stream":
                return self._synthesize_stream()
            if self.path != "/synthesize":
                return self._json_error(404, "unknown path")
            payload = self._read_payload()
            if payload is None:
                return
            text = payload.get("text")
            if not text or not isinstance(text, str):
                return self._json_error(400, "missing 'text'")
            try:
                ref_audio, ref_text = resolve_ref_payload(payload, default_ref, acfg.sample_rate,
                                                          max_ref_samples=max_ref_samples,
                                                          allow_resample=allow_resample)
                speed, sway, seed, duration = parse_params(payload)
            except BadRequest as e:
                return self._json_error(400, str(e))
            estimate = bool(payload.get("estimate_duration"))
            frames = None if duration is None or estimate else int(duration * acfg.frames_per_second)
            try:
                # a duration the predictor sets is planned in the batcher thread, after the backlog bound
                req = build_request(text, ref_audio, ref_text, speed=speed, sway=sway, seed=seed,
                                    duration_frames=frames, estimate=estimate,
                                    plan=not sampler.needs_predictor(frames, estimate))
                wave = batcher.submit(req).result(timeout=timeout)
            except Overloaded:
                return self._overloaded()
            except (TimeoutError, FuturesTimeoutError):
                return self._json_error(504, "request expired before synthesis finished")
            except ValueError as e:
                return self._json_error(400, str(e))
            except Exception as e:
                return self._json_error(500, f"synthesis failed: {e}")
            body = _wav_bytes(wave, acfg.sample_rate)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _write_chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        def _synthesize_stream(self):
            """Sentence-streamed synthesis: split the text, hold a backlog
            slot for every sentence, plan each (an unservable one 400s the
            request before the stream commits), submit them all (the first
            sentence at rank 0, so it runs alone and first), then stream
            each sentence's PCM as chunked WAV as soon as it is ready."""
            payload = self._read_payload()
            if payload is None:
                return
            text = payload.get("text")
            if not text or not isinstance(text, str):
                return self._json_error(400, "missing 'text'")
            if payload.get("duration") is not None:
                return self._json_error(400, "duration is per-request; unsupported with streaming "
                                             "(durations are resolved per sentence)")
            try:
                ref_audio, ref_text = resolve_ref_payload(payload, default_ref, acfg.sample_rate,
                                                          max_ref_samples=max_ref_samples,
                                                          allow_resample=allow_resample)
                speed, sway, seed, _ = parse_params(payload)
            except BadRequest as e:
                return self._json_error(400, str(e))

            estimate = bool(payload.get("estimate_duration"))
            sentences = split_sentences(text) or [text]
            try:
                batcher.reserve(len(sentences))
            except Overloaded:
                return self._overloaded()
            try:
                reqs = [build_request(s, ref_audio, ref_text, speed=speed, sway=sway, seed=seed,
                                      duration_frames=None, estimate=estimate, stream_rank=0 if i == 0 else 1)
                        for i, s in enumerate(sentences)]
            except Exception as e:
                batcher.unreserve(len(sentences))
                if isinstance(e, ValueError):
                    return self._json_error(400, str(e))
                return self._json_error(500, f"duration resolution failed: {e}")
            for r in reqs:
                r.counted = True
            # the queue holds at most the backlog bound, which the reservation already counted
            futures = [batcher.submit(r) for r in reqs]

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._write_chunk(_wav_stream_header(acfg.sample_rate))
            try:
                for fut in futures:
                    pcm = _pcm16(fut.result(timeout=timeout))
                    # a zero-length chunk IS the terminator: never one mid-stream
                    if pcm:
                        self._write_chunk(pcm)
            except Exception:
                # the status line is out: truncate the stream so the client sees a hard error, log it, and
                # cancel the sentences still queued so the batcher stops synthesizing for a dead connection
                print("mid-stream synthesis failed:", file=sys.stderr)
                traceback.print_exc()
                for f in futures:
                    f.cancel()
                self.close_connection = True
                return
            self.wfile.write(b"0\r\n\r\n")

    return Handler


def serve_artifacts(
    artifact_paths: list[str],
    *,
    vocab_path: str | None = None,
    default_ref=None,
    default_ref_sr: int | None = None,
    host: str = "0.0.0.0",
    port: int = 8931,
    allow_resample: bool = False,
    duration_artifact: str | None = None,
    max_wait_ms: float = 50.0,
    max_queue: int = 64,
    request_timeout_s: float = 300.0,
    device: str | torch.device | None = None,
) -> ThreadingHTTPServer:
    """Load the artifacts onto `device` (the card by default), start the
    batcher thread and return the HTTP server (not yet serving: call
    `serve_forever`; `.batcher.stop()` and `.shutdown()` stop it)."""
    sampler = ArtifactSampler(artifact_paths, vocab_path, duration_artifact=duration_artifact, device=device)
    if default_ref is not None and default_ref_sr is not None:
        # the header records the model's sample rate; a default reference at another rate would condition
        # on wrong-speed mel frames
        model_sr = sampler.audio_cfg.sample_rate
        if default_ref_sr != model_sr:
            if not allow_resample:
                raise ValueError(f"default reference is {default_ref_sr} Hz but the artifact's model expects "
                                 f"{model_sr} Hz; resample it or pass --resample-ref")
            from f5_tts_tpu_torch.audio.resample import resample

            audio, text = default_ref
            default_ref = (resample(audio, default_ref_sr, model_sr), text)
    batcher = ArtifactBatcher(sampler, max_batch=sampler.max_batch, max_wait_ms=max_wait_ms, max_queue=max_queue,
                              request_timeout_s=request_timeout_s)
    batcher.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(batcher, default_ref, allow_resample))
    httpd.sampler = sampler
    httpd.batcher = batcher  # a handle for shutdown and tests
    print(f"artifact server on {host}:{httpd.server_address[1]}, buckets "
          f"{[(b.spec.padded_len, b.spec.batch) for b in sampler.buckets]}")
    return httpd


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", action="append", required=True,
                    help="sampler artifact (repeat for several duration buckets and/or batch variants)")
    ap.add_argument("--vocab", default=None,
                    help="vocab.txt for the pinyin/vocab tokenizer; omit for the byte tokenizer (must match the "
                         "exported model's training)")
    ap.add_argument("--duration-artifact", default=None,
                    help="exported duration predictor (f5-tts-tpu-torch-export --duration); resolves requests that "
                         "omit 'duration' with the trained model instead of the byte-length heuristic")
    ap.add_argument("--ref", default=None, help="default reference WAV")
    ap.add_argument("--ref-text", default=None)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8931)
    ap.add_argument("--max-wait-ms", type=float, default=50.0, help="micro-batch gather window")
    ap.add_argument("--max-queue", type=int, default=64, help="pending-request bound; beyond it requests get 503")
    ap.add_argument("--request-timeout", type=float, default=300.0,
                    help="seconds before a queued request expires (504)")
    ap.add_argument("--warmup", action="store_true", help="run every artifact once before accepting traffic")
    ap.add_argument("--resample-ref", action="store_true", default=False,
                    help="resample off-rate reference audio (the default --ref and per-request ref_audio_b64) to "
                         "the model's rate instead of rejecting it")
    ap.add_argument("--device", default=None,
                    help="device to load the artifacts onto: the card by default; another device type (cpu) "
                         "moves artifacts exported for the card")
    args = ap.parse_args(argv)

    default_ref = None
    default_ref_sr = None
    if args.ref:
        from f5_tts_tpu_torch.audio.io import read_wav

        audio, default_ref_sr = read_wav(args.ref)
        if args.ref_text is None:
            ap.error("--ref needs --ref-text")
        audio = (audio if audio.ndim == 1 else audio.mean(axis=-1)).astype("float32")
        default_ref = (audio, args.ref_text)

    httpd = serve_artifacts(
        args.artifact, vocab_path=args.vocab, default_ref=default_ref, default_ref_sr=default_ref_sr,
        host=args.host, port=args.port, allow_resample=args.resample_ref, duration_artifact=args.duration_artifact,
        max_wait_ms=args.max_wait_ms, max_queue=args.max_queue, request_timeout_s=args.request_timeout,
        device=args.device,
    )
    if args.warmup:
        httpd.sampler.warmup()
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        httpd.batcher.stop()


if __name__ == "__main__":
    main()
