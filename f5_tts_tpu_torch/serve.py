"""Serving: an HTTP synthesis API with a micro-batcher, the port of the JAX
package's `serve.py`.

Concurrent requests are grouped by a dynamic micro-batcher and run as one
batched `F5TTS.sample` call on the card. Mixed reference audios, texts and
durations batch together through the per-item lens/duration support;
requests are grouped by sampler settings, duration bucket and stream rank.
One thread, the batcher's, drives the device, under `torch.inference_mode`
and with the current CUDA device set to the model's.

Run:  f5-tts-tpu-torch-serve --model <snapshot dir> --port 8930 [--device cpu]
API:
  GET  /healthz                -> {"status": "ok"}
  POST /synthesize  (JSON)     -> audio/wav bytes
        {"text": "...", "ref_text": "...", "ref_audio_b64": <optional wav>,
         "duration": <optional seconds>, "steps": 8, "method": "rk4",
         "cfg_strength": 2.0, "sway_sampling_coef": -1.0, "seed": null,
         "speed": 1.0, "estimate_duration": false}
        Duration resolution mirrors the CLI (generate.py): an explicit
        "duration" wins; "estimate_duration": true forces the byte-length
        heuristic; otherwise the model's duration predictor runs as one
        batched forward in the batcher thread (the heuristic when the model
        has none).
  POST /synthesize_stream (JSON, the same payload without "duration")
        -> chunked audio/wav: the text is split into sentences
        (generate.py:split_sentences), all sentences are submitted at once
        (so compatible ones still batch), and each sentence's PCM streams
        out the moment it is ready.

`--w8a8` serves with W8A8 int8 compute (int8 weights and per-token int8
activations in the DiT blocks); `--q` with `--w8a8` is refused. Not
ported: the JAX server's XLA:CPU memory-map guard (no counterpart in
PyTorch) and its compilation cache. `--mesh-data`/`--mesh-model` serve over
a grid of the devices of `--device`'s type (`F5TTS.use_mesh`): each
micro-batch group is split over the data rows.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import math
import queue
import struct
import sys
import tempfile
import threading
import time
import traceback
import wave as wave_mod
from concurrent.futures import (
    Future,
    InvalidStateError,
    TimeoutError as FuturesTimeoutError,
)
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from f5_tts_tpu_torch.audio.io import read_wav
from f5_tts_tpu_torch.generate import (
    DEFAULT_REF_TEXT,
    TARGET_RMS,
    _load_ref_audio,
    cli_mesh,
    estimated_duration,
    load_model,
    refuse_unported,
    split_sentences,
)
from f5_tts_tpu_torch.utils.sampling import clamp_duration
from f5_tts_tpu_torch.utils.tokenizer import convert_char_to_pinyin

# Largest accepted request body (JSON incl. base64 reference audio). Bounds
# host memory per in-flight connection; a ~44 s 24 kHz mono WAV is ~2.8 MB
# base64, so the default leaves generous headroom.
MAX_BODY_BYTES = 32 << 20


class Overloaded(RuntimeError):
    """Raised by MicroBatcher.submit when the bounded queue is full; the HTTP
    layer maps it to 503 + Retry-After."""


class BadRequest(ValueError):
    """A request-payload problem the client must fix; the HTTP layer maps it
    to 400."""


def resolve_ref_payload(payload, default_ref, sample_rate: int,
                        max_ref_samples: int | None = None,
                        allow_resample: bool = False):
    """Resolve a request's reference audio: decode `ref_audio_b64` (WAV) or
    fall back to `default_ref`, validate rate/length/transcript, downmix to
    mono, and RMS-normalize quiet references (reference: generate.py:147-156).
    With `allow_resample` (server flag --resample-ref), off-rate references
    are resampled on the host instead of rejected.
    Returns (ref_audio float32 [n], ref_text); raises BadRequest on any
    client-fixable problem."""
    if "ref_audio_b64" in payload:
        try:
            raw = base64.b64decode(payload["ref_audio_b64"])
            with tempfile.NamedTemporaryFile(suffix=".wav") as f:
                f.write(raw)
                f.flush()
                ref_audio, sr = read_wav(f.name)
        except Exception as e:
            raise BadRequest(f"bad ref audio: {e}") from None
        if sr != sample_rate:
            if not allow_resample:
                raise BadRequest(
                    f"reference audio must be {sample_rate} Hz "
                    "(or start the server with --resample-ref)"
                )
            if ref_audio.ndim > 1:
                ref_audio = ref_audio.mean(axis=-1)
            from f5_tts_tpu_torch.audio.resample import resample

            ref_audio = resample(ref_audio.astype(np.float32), sr, sample_rate)
        # length cap applies at the MODEL rate (post-resample)
        if max_ref_samples is not None and ref_audio.shape[0] > max_ref_samples:
            raise BadRequest(
                f"reference audio is {ref_audio.shape[0] / sample_rate:.1f}s; "
                "the model conditions on at most "
                f"{max_ref_samples / sample_rate:.1f}s"
            )
        if ref_audio.ndim > 1:
            ref_audio = ref_audio.mean(axis=-1)
        ref_text = payload.get("ref_text")
        if not ref_text:
            raise BadRequest("ref_text required with ref_audio_b64")
    else:
        if default_ref is None:
            raise BadRequest(
                "no default reference at the model's sample rate; "
                "pass ref_audio_b64"
            )
        ref_audio, ref_text = default_ref
        ref_text = payload.get("ref_text", ref_text)
    if not ref_text:
        raise BadRequest("ref_text must be non-empty")

    rms = float(np.sqrt(np.mean(np.square(ref_audio)))) if ref_audio.size else 0.0
    if 0 < rms < TARGET_RMS:
        ref_audio = ref_audio * TARGET_RMS / rms
    return ref_audio.astype(np.float32), ref_text


class JsonHTTPHandler(BaseHTTPRequestHandler):
    """HTTP plumbing: HTTP/1.1, quiet logs, JSON responses, and error
    responses that close the connection (an error path may not have drained
    the request body; under keep-alive the leftover bytes would be parsed as
    the connection's next request)."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json_response(self, code: int, obj, extra_headers=()):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        for k, v in extra_headers:
            self.send_header(k, v)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json_error(self, code: int, msg: str):
        self._json_response(code, {"error": msg})
        self.close_connection = True

    def _read_payload(self):
        """Parse the JSON body, or send an error response and return None."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            if length > MAX_BODY_BYTES:
                self._json_error(
                    413, f"request body exceeds {MAX_BODY_BYTES} bytes")
                return None
            if length < 0:
                # rfile.read(-1) would read until EOF — an unbounded
                # client-controlled buffer that bypasses the body cap
                self._json_error(400, "invalid Content-Length")
                return None
            return json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._json_error(400, "invalid JSON body")
            return None


@dataclass
class _Request:
    text: str
    ref_audio: np.ndarray
    ref_text: str
    # None = resolve with the model's trained duration predictor inside the
    # batcher thread (the single thread allowed to touch the device) before
    # grouping; an int is frames, already final.
    duration_frames: int | None
    steps: int
    method: str
    cfg_strength: float
    sway: float
    seed: int | None
    # Streaming latency hint: 0 = "the client is waiting on THIS audio right
    # now" (normal requests, a stream's first sentence), 1 = backfill (a
    # stream's later sentences). Rank partitions groups — otherwise a stream's
    # tail sentences batch WITH its head and time-to-first-audio collapses to
    # whole-request latency — and rank-0 groups always dispatch first.
    stream_rank: int = 0
    speed: float = 1.0
    # token-id cache filled by MicroBatcher._tokenize (a request can pass
    # through duration prediction AND synthesis; tokenize once)
    text_ids: np.ndarray | None = None
    # the artifact server's planned bucket length (artifact_serve.py); the
    # live server buckets by duration_frames
    bucket_len: int | None = None
    future: Future = field(default_factory=Future)
    # enqueue time, for the scheduler's anti-starvation aging (monotonic)
    t_submit: float = field(default_factory=time.monotonic)
    # absolute monotonic deadline; expired requests fail with TimeoutError
    # and are skipped by the scheduler instead of synthesized for nobody
    # (None = filled from the batcher's request_timeout_s at submit)
    deadline: float | None = None
    # True while this request counts toward the batcher's backlog bound
    # (set by submit, cleared by _release); direct-path requests
    # (warmup/tests via _process_batch) never count
    counted: bool = False

    def group_key(self, bucket: int) -> tuple:
        # sampler settings + duration bucket + stream rank partition; the
        # reference length does not (_run_group pads every reference to one
        # window)
        dur_bucket = math.ceil(max(self.duration_frames, 1) / bucket)
        return (self.steps, self.method, self.cfg_strength, self.sway, self.seed,
                dur_bucket, self.stream_rank)


class MicroBatcher(threading.Thread):
    """Collects requests for up to `max_wait_ms`, groups compatible ones, and
    runs each group as one batched sample() call. Its thread is the only one
    that drives the device: `run` sets the model's CUDA device (the current
    device is per thread) and runs under `torch.inference_mode` (grad mode
    is per thread too, so the caller's does not carry over)."""

    def __init__(
        self,
        model,
        max_batch: int = 8,
        max_wait_ms: float = 50.0,
        starvation_s: float = 10.0,
        max_queue: int = 64,
        request_timeout_s: float = 300.0,
    ):
        super().__init__(daemon=True)
        self.model = model
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        # anti-starvation bound: a backfill (rank-1) group whose oldest
        # request has waited this long runs AHEAD of fresh rank-0 groups —
        # strict rank priority would otherwise starve stream tails forever
        # under sustained rank-0 traffic
        self.starvation_s = starvation_s
        # overload protection: the backlog is BOUNDED — beyond max_queue
        # outstanding requests (queued PLUS drained-but-unserved), submit
        # raises Overloaded (-> HTTP 503) instead of accumulating
        # unserviceable work; and every request carries a deadline after
        # which it fails fast instead of being synthesized for a client
        # that already gave up. The bound is an explicit counter, not the
        # queue's maxsize: the batcher drains the queue into its internal
        # pending list between groups, so queue occupancy alone would free
        # slots while the true backlog keeps growing.
        self.request_timeout_s = request_timeout_s
        self.max_queue = max(1, max_queue)
        self.queue: queue.Queue[_Request] = queue.Queue(maxsize=self.max_queue)
        self._outstanding = 0
        self._count_lock = threading.Lock()
        self._stop_evt = threading.Event()  # NOT `_stop`: Thread.join() calls the internal Thread._stop

    def submit(self, req: _Request) -> Future:
        if req.deadline is None and self.request_timeout_s:
            req.deadline = req.t_submit + self.request_timeout_s
        with self._count_lock:
            if self._outstanding >= self.max_queue:
                raise Overloaded(
                    f"request queue full ({self.max_queue} pending); retry later"
                )
            self._outstanding += 1
        req.counted = True
        try:
            self.queue.put_nowait(req)
        except queue.Full:
            self._release([req])
            raise Overloaded(
                f"request queue full ({self.queue.maxsize} pending); retry later"
            ) from None
        return req.future

    def _release(self, reqs: list[_Request]) -> None:
        """Free backlog slots for requests that left the system (served,
        expired, failed, or dropped)."""
        n = 0
        for r in reqs:
            if r.counted:
                r.counted = False
                n += 1
        if n:
            with self._count_lock:
                self._outstanding -= n

    def stop(self):
        self._stop_evt.set()

    def run(self):
        device = self.model.device
        if device.type == "cuda":
            torch.cuda.set_device(device)
        with torch.inference_mode():
            pending: list[_Request] = []
            while not self._stop_evt.is_set():
                if not pending:
                    try:
                        pending.append(self.queue.get(timeout=0.1))
                    except queue.Empty:
                        continue
                    # gather window: let concurrent arrivals form a batch
                    deadline = time.monotonic() + self.max_wait
                    while len(pending) < self.max_batch:
                        timeout = deadline - time.monotonic()
                        if timeout <= 0:
                            break
                        try:
                            pending.append(self.queue.get(timeout=timeout))
                        except queue.Empty:
                            break
                pending = self._step(pending, drain=True)

    def _process_batch(self, batch: list[_Request]) -> None:
        """Resolve deferred durations, group, and run every group (the whole
        post-gather path; direct-call entry for tests/warmup — does NOT drain
        the live queue)."""
        pending = list(batch)
        with torch.inference_mode():
            while pending:
                pending = self._step(pending, drain=False)

    def _step(self, pending: list[_Request], drain: bool) -> list[_Request]:
        """Run ONE group from `pending` and return what's left.

        Scheduling: resolve deferred durations, group by compatibility, pick
        the single best group — rank first (someone is waiting on rank-0
        audio NOW; rank-1 is a stream's backfill), then shortest-job-first —
        capped at max_batch items, run it, then (with drain=True) pull any
        requests that arrived DURING the run back into contention. Re-sorting
        between groups bounds head-of-line blocking: a rank-0 arrival waits
        for at most the group in flight, never for an entire backfill queue
        dispatched before it. (Groups run one at a time: the card serializes
        them anyway.)"""
        pending = self._expire(pending)
        need_prediction = [r for r in pending if r.duration_frames is None]
        if need_prediction:
            try:
                self._predict_durations(need_prediction)
            except Exception as e:
                for r in need_prediction:
                    if not r.future.done():
                        r.future.set_exception(e)
            # drop anything unresolved OR already failed (a partially
            # filled batch must not synthesize for a failed future:
            # set_result on it would raise and poison its group-mates)
            alive = [r for r in pending
                     if r.duration_frames is not None and not r.future.done()]
            kept = set(map(id, alive))
            self._release([r for r in pending if id(r) not in kept])
            pending = alive
        if not pending:
            return pending

        groups: dict[tuple, list[_Request]] = {}
        for r in pending:
            groups.setdefault(self._group_key(r), []).append(r)

        now = time.monotonic()

        def priority(kv):
            key, reqs = kv
            rank = key[6]
            # aging: a group past the starvation bound outranks EVERYTHING
            # (rank -1) — ANY rank: rank-1 backfill would starve under
            # sustained rank-0 arrivals, and a long rank-0 request would
            # starve under sustained SHORT rank-0 arrivals (shortest-job-
            # first picks the cheaper bucket every step). Among aged groups,
            # oldest-first so the longest-waiting one finally runs.
            waited = now - min(r.t_submit for r in reqs)
            if waited > self.starvation_s:
                return (-1, -waited)
            return (rank, key[5] * key[0] * min(len(reqs), self.max_batch))

        key, group = min(groups.items(), key=priority)
        group = group[: self.max_batch]
        self._run_group(group)

        chosen = set(map(id, group))
        remaining = [r for r in pending if id(r) not in chosen]
        if drain:
            while True:
                try:
                    remaining.append(self.queue.get_nowait())
                except queue.Empty:
                    break
        return remaining

    def _group_key(self, r: _Request) -> tuple:
        """Compatibility key for batching. The tuple layout is load-bearing
        for the scheduler: [0] scales job cost, [5] is the duration bucket,
        [6] the stream rank."""
        return r.group_key(self.model.cfm_cfg.duration_bucket)

    def _expire(self, pending: list[_Request]) -> list[_Request]:
        """Fail past-deadline requests with TimeoutError and drop anything
        whose future is already settled (expired, cancelled, or failed during
        duration prediction) — synthesizing for a finished future would both
        waste a group slot and poison its group-mates' set_result."""
        now = time.monotonic()
        alive, dropped = [], []
        for r in pending:
            if r.future.done():
                dropped.append(r)
                continue
            if r.deadline is not None and now > r.deadline:
                r.future.set_exception(
                    TimeoutError("request expired before synthesis started")
                )
                dropped.append(r)
                continue
            alive.append(r)
        self._release(dropped)
        return alive

    def _ref_lens(self, reqs: list[_Request]) -> np.ndarray:
        hop = self.model.audio_cfg.hop_length
        max_duration = self.model.cfm_cfg.max_duration
        return np.array(
            [min(r.ref_audio.shape[0] // hop, max_duration) for r in reqs],
            dtype=np.int32,
        )

    def _padded_refs(self, reqs: list[_Request]) -> np.ndarray:
        """References padded into one fixed-size window of max_duration * hop
        samples, whose mel every request of a group shares a shape with (as
        in the JAX server); the mel is then cut to the group's bucket."""
        pad_samples = self.model.cfm_cfg.max_duration * self.model.audio_cfg.hop_length
        audio = np.zeros((len(reqs), pad_samples), dtype=np.float32)
        for i, r in enumerate(reqs):
            n = min(r.ref_audio.shape[0], pad_samples)
            audio[i, :n] = r.ref_audio[:n]
        return audio

    def _tokenize(self, reqs: list[_Request]) -> np.ndarray:
        """Token ids for a batch, cached per request: pinyin conversion +
        vocab lookup run once even when a request passes through both
        _predict_durations and _run_group."""
        for r in reqs:
            if r.text_ids is None:
                r.text_ids = np.asarray(
                    self.model._tokenize(convert_char_to_pinyin([r.ref_text + " " + r.text]))
                )[0]
        nt = max(r.text_ids.shape[0] for r in reqs)
        out = np.full((len(reqs), nt), -1, dtype=np.int32)
        for i, r in enumerate(reqs):
            out[i, : r.text_ids.shape[0]] = r.text_ids
        return out

    def _predict_durations(self, reqs: list[_Request]) -> None:
        """Resolve duration_frames with the trained duration predictor (one
        batched forward; reference semantics: cfm.py:253-262 + generate.py's
        predictor-by-default behavior). Runs in the batcher thread — the only
        thread allowed to drive the device. Host-side failures (a degenerate
        ref for the heuristic fallback) fail only the offending request."""
        if self.model.duration_predictor is None:
            # loader configured without a predictor: fall back to the CLI's
            # byte-length heuristic rather than failing the request
            acfg = self.model.audio_cfg
            for r in reqs:
                try:
                    r.duration_frames = int(
                        estimated_duration(
                            r.ref_audio, r.ref_text, r.text, r.speed,
                            hop_length=acfg.hop_length,
                            frames_per_second=acfg.frames_per_second,
                        )
                        * acfg.frames_per_second
                    )
                except Exception as e:
                    r.future.set_exception(e)
            return

        bucket = self.model.cfm_cfg.duration_bucket
        max_duration = self.model.cfm_cfg.max_duration
        lens = self._ref_lens(reqs)
        window = min(max(bucket, -(-int(lens.max()) // bucket) * bucket), max_duration)
        cond_mel = self.model._mel_spec(self._padded_refs(reqs))[:, :window]
        text_ids = self._tokenize(reqs)
        # pad text to a multiple so compiles stay bounded (−1 = padding id)
        nt = text_ids.shape[1]
        text_ids = np.pad(text_ids, ((0, 0), (0, -nt % 64)), constant_values=-1)
        frames = self.model.predict_duration(cond_mel, text_ids, lens=lens)
        for r, f in zip(reqs, frames):
            r.duration_frames = max(int(f / r.speed), 1)

    def _run_group(self, group: list[_Request]) -> None:
        try:
            max_duration = self.model.cfm_cfg.max_duration
            bucket = self.model.cfm_cfg.duration_bucket
            hop = self.model.audio_cfg.hop_length

            lens = self._ref_lens(group)
            text_ids = self._tokenize(group)
            durations = np.array([r.duration_frames for r in group], dtype=np.int32)
            # the same clamp sample() applies, so per-item trimming stays
            # aligned with what was actually generated
            text_lens = (text_ids != -1).sum(axis=-1).astype(np.int32)
            durations = clamp_duration(durations, lens, text_lens, max_duration)

            # trim the fixed-window mel to the duration bucket sample() will
            # use anyway
            padded_est = min(
                max(bucket, -(-int(durations.max()) // bucket) * bucket), max_duration
            )
            cond_mel = self.model._mel_spec(self._padded_refs(group))[:, :padded_est]

            r0 = group[0]
            wave, _ = self.model.sample(
                cond_mel,
                text=text_ids,
                duration=durations,
                lens=lens,
                steps=r0.steps,
                method=r0.method,
                cfg_strength=r0.cfg_strength,
                sway_sampling_coef=r0.sway,
                seed=r0.seed,
                return_trajectory=False,
            )
            wave = wave.float().cpu().numpy()
            if wave.ndim == 1:
                wave = wave[None, :]
            for i, r in enumerate(group):
                # frame-quantized boundaries: generated content starts at the
                # reference's mel-frame edge, not the raw sample count
                start = int(lens[i]) * hop
                end = (int(durations[i]) - 1) * hop
                try:
                    r.future.set_result(wave[i, start : min(end, wave.shape[1])])
                except InvalidStateError:
                    # cancelled mid-synthesis (e.g. a stream's all-or-nothing
                    # shed): its result is discarded; group-mates unaffected
                    pass
        except Exception as e:  # pragma: no cover - error propagation
            for r in group:
                if not r.future.done():
                    try:
                        r.future.set_exception(e)
                    except InvalidStateError:
                        pass
        finally:
            self._release(group)


def _valid_speed(payload) -> bool:
    try:
        return float(payload.get("speed", 1.0)) > 0
    except (TypeError, ValueError):
        return False


def _pcm16(samples: np.ndarray) -> bytes:
    return (np.clip(samples, -1, 1) * 32767.0).astype("<i2").tobytes()


def _wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(_pcm16(samples))
    return buf.getvalue()


def _wav_stream_header(sample_rate: int) -> bytes:
    """A 44-byte PCM16 mono WAV header with unknown (0xFFFFFFFF) sizes — the
    standard convention for live WAV streams; players read until EOF."""
    return b"".join(
        [
            b"RIFF", struct.pack("<I", 0xFFFFFFFF), b"WAVE",
            b"fmt ", struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                 sample_rate * 2, 2, 16),
            b"data", struct.pack("<I", 0xFFFFFFFF),
        ]
    )


def make_handler(batcher: MicroBatcher, default_ref: tuple[np.ndarray, str],
                 allow_resample: bool = False):
    # audio-domain arithmetic (sample-rate checks, WAV headers, seconds ->
    # frames) follows the SERVED MODEL's AudioConfig, not module constants
    acfg = batcher.model.audio_cfg
    # longest reference the model can condition on: anything past the
    # max_duration window would be silently truncated by the fixed mel
    # window (_padded_refs) — reject it up front instead
    max_ref_samples = batcher.model.cfm_cfg.max_duration * acfg.hop_length

    class Handler(JsonHTTPHandler):
        def do_GET(self):
            if self.path == "/healthz":
                self._json_response(200, {"status": "ok"})
            else:
                self._json_error(404, "not found")

        def _overloaded(self):
            self._json_response(503, {"error": "server overloaded; retry later"},
                                extra_headers=(("Retry-After", "1"),))
            self.close_connection = True

        def _resolve_ref(self, payload):
            """Returns (ref_audio, ref_text) RMS-normalized, or None after
            having sent an error response."""
            try:
                return resolve_ref_payload(payload, default_ref,
                                           acfg.sample_rate,
                                           max_ref_samples=max_ref_samples,
                                           allow_resample=allow_resample)
            except BadRequest as e:
                self._json_error(400, str(e))
                return None

        def _build_request(self, payload, text, ref_audio, ref_text, dur_frames):
            try:
                seed = payload.get("seed")
                req = _Request(
                    text=text,
                    ref_audio=ref_audio,
                    ref_text=ref_text,
                    duration_frames=dur_frames,
                    steps=int(payload.get("steps", 8)),
                    method=str(payload.get("method", "rk4")),
                    cfg_strength=float(payload.get("cfg_strength", 2.0)),
                    sway=float(payload.get("sway_sampling_coef", -1.0)),
                    seed=None if seed is None else int(seed),
                    speed=float(payload.get("speed", 1.0)),
                )
            except (TypeError, ValueError) as e:
                # a client-fixable input, not a server failure: a bad numeric
                # would otherwise surface as 500 from the generic handler (or,
                # for seed, fail the whole group inside the batcher)
                self._json_error(400, f"bad parameter: {e}")
                return None
            if req.method not in ("euler", "midpoint", "rk4"):
                self._json_error(400, f"unknown method: {req.method}")
                return None
            if not (req.speed > 0):
                self._json_error(400, "speed must be > 0")
                return None
            if not (1 <= req.steps <= 256):
                self._json_error(400, "steps must be in [1, 256]")
                return None
            if not (math.isfinite(req.cfg_strength) and math.isfinite(req.sway)):
                self._json_error(400, "cfg_strength/sway must be finite")
                return None
            return req

        def _resolve_duration(self, payload, text, ref_audio, ref_text):
            """Frames, or None to defer to the trained duration predictor in
            the batcher thread (mirrors the CLI: explicit duration >
            --estimate-duration heuristic > predictor, generate.py).

            Speed semantics intentionally differ between the two automatic
            paths, matching the reference's own disagreement: the predictor
            divides the TOTAL duration by speed (reference cfm.py:253-262),
            the heuristic scales only the generated portion
            (reference generate.py:104-111)."""
            if payload.get("duration") is not None:
                try:
                    seconds = float(payload["duration"])
                except (TypeError, ValueError) as e:
                    raise BadRequest(f"bad duration: {e}") from None
                return int(seconds * acfg.frames_per_second)
            if payload.get("estimate_duration"):
                return int(
                    estimated_duration(ref_audio, ref_text, text,
                                       float(payload.get("speed", 1.0)),
                                       hop_length=acfg.hop_length,
                                       frames_per_second=acfg.frames_per_second)
                    * acfg.frames_per_second
                )
            return None

        def do_POST(self):
            if self.path == "/synthesize":
                return self._synthesize()
            if self.path == "/synthesize_stream":
                return self._synthesize_stream()
            return self._json_error(404, "not found")

        def _synthesize(self):
            payload = self._read_payload()
            if payload is None:
                return
            text = payload.get("text")
            if not text or not isinstance(text, str):
                return self._json_error(400, "missing required field: text")
            if not _valid_speed(payload):
                return self._json_error(400, "speed must be a number > 0")

            try:
                ref = self._resolve_ref(payload)
                if ref is None:
                    return
                ref_audio, ref_text = ref
                dur_frames = self._resolve_duration(payload, text, ref_audio, ref_text)
                req = self._build_request(payload, text, ref_audio, ref_text, dur_frames)
                if req is None:
                    return

                # +30 s of synthesis headroom past the queue deadline;
                # --request-timeout 0 disables expiry, so wait indefinitely
                # instead of inheriting a spurious 30 s HTTP cutoff
                samples = batcher.submit(req).result(
                    timeout=(batcher.request_timeout_s + 30)
                    if batcher.request_timeout_s else None
                )
                body = _wav_bytes(samples, acfg.sample_rate)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            except BadRequest as e:
                self._json_error(400, str(e))
            except Overloaded:
                self._overloaded()
            except (TimeoutError, FuturesTimeoutError):
                self._json_error(504, "request expired before synthesis finished")
            except Exception as e:
                self._json_error(500, f"synthesis failed: {e}")

        def _write_chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode())
            self.wfile.write(data)
            self.wfile.write(b"\r\n")

        def _synthesize_stream(self):
            payload = self._read_payload()
            if payload is None:
                return
            text = payload.get("text")
            if not text or not isinstance(text, str):
                return self._json_error(400, "missing required field: text")
            if not _valid_speed(payload):
                return self._json_error(400, "speed must be a number > 0")
            if payload.get("duration") is not None:
                return self._json_error(
                    400, "duration is per-request; unsupported with streaming "
                    "(durations are resolved per sentence)")

            try:
                ref = self._resolve_ref(payload)
                if ref is None:
                    return
                ref_audio, ref_text = ref
                sentences = split_sentences(text) or [text]
                reqs = []
                for i, s in enumerate(sentences):
                    dur = self._resolve_duration(payload, s, ref_audio, ref_text)
                    req = self._build_request(payload, s, ref_audio, ref_text, dur)
                    if req is None:
                        return
                    # first sentence dispatches alone (and ahead of any
                    # backfill): time-to-first-audio = ONE sentence's latency
                    req.stream_rank = 0 if i == 0 else 1
                    reqs.append(req)

                # submit ALL sentences before streaming: compatible ones land
                # in the same micro-batch groups (length-grouped), while the
                # client hears sentence 0 as soon as its group finishes
                futures = []
                try:
                    for r in reqs:
                        futures.append(batcher.submit(r))
                except Overloaded:
                    # all-or-nothing: cancel already-queued sentences (the
                    # scheduler drops settled futures) rather than stream a
                    # request the queue can't hold in full
                    for f in futures:
                        f.cancel()
                    return self._overloaded()
            except BadRequest as e:
                return self._json_error(400, str(e))
            except Exception as e:
                return self._json_error(500, f"synthesis failed: {e}")

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._write_chunk(_wav_stream_header(acfg.sample_rate))
            try:
                for fut in futures:
                    pcm = _pcm16(fut.result(
                        timeout=(batcher.request_timeout_s + 30)
                        if batcher.request_timeout_s else None))
                    # a zero-length chunk IS the chunked-encoding terminator —
                    # never emit one mid-stream (possible when a sentence's
                    # clamped duration leaves no generated frames)
                    if pcm:
                        self._write_chunk(pcm)
            except Exception:
                # status line is already out — truncate the stream so the
                # client sees a hard error rather than silent-complete audio;
                # log it server-side (the truncation alone is undiagnosable)
                # and cancel the sentences still queued so the batcher stops
                # synthesizing for a dead connection
                print("mid-stream synthesis failed:", file=sys.stderr)
                traceback.print_exc()
                for f in futures:
                    f.cancel()
                self.close_connection = True
                return
            self.wfile.write(b"0\r\n\r\n")

    return Handler


def warmup(model, durations_sec: list[float], steps: int = 8, method: str = "rk4",
           cfg_strength: float = 2.0, batch_sizes: tuple[int, ...] = (1,),
           batcher: "MicroBatcher | None" = None) -> None:
    """Run the duration buckets and batch sizes a deployment expects once,
    so that the first real request does not pay the first-use costs (kernel
    builds, cuBLAS and cuDNN plans, allocator growth). With a live batcher
    the requests go through its queue and thread (the full request path:
    mel, tokenize, sample, trim); else they run here, directly, under
    `torch.inference_mode`."""
    sr = model.audio_cfg.sample_rate
    ref = np.zeros((sr,), dtype=np.float32)
    for b in batch_sizes:
        for sec in durations_sec:
            frames = int(sec * model.audio_cfg.frames_per_second)
            reqs = [
                _Request(
                    text="warmup", ref_audio=ref, ref_text="warmup",
                    duration_frames=frames, steps=steps, method=method,
                    cfg_strength=cfg_strength, sway=-1.0, seed=0,
                )
                for _ in range(b)
            ]
            if batcher is not None and batcher.is_alive():
                # through the live queue: the batcher thread is the one to
                # warm (its CUDA device and grad mode are its own)
                for f in [batcher.submit(r) for r in reqs]:
                    f.result()
            else:
                target = batcher if batcher is not None else MicroBatcher(model)
                with torch.inference_mode():
                    target._run_group(reqs)
                for r in reqs:
                    r.future.result()
            print(f"warmed batch={b} duration={sec}s")

    if model.duration_predictor is not None:
        # default requests resolve durations with the predictor: warm it
        # too, or the first real request pays it (and head-of-line blocks
        # everything in its poll window)
        req = _Request(text="warmup", ref_audio=ref, ref_text="warmup",
                       duration_frames=None, steps=steps, method=method,
                       cfg_strength=cfg_strength, sway=-1.0, seed=0)
        if batcher is not None and batcher.is_alive():
            batcher.submit(req).result()
        else:
            target = batcher if batcher is not None else MicroBatcher(model)
            with torch.inference_mode():
                target._predict_durations([req])
                target._run_group([req])
            req.future.result()
        print("warmed duration predictor")


def serve(model, host: str = "0.0.0.0", port: int = 8930,
          max_batch: int = 8, max_wait_ms: float = 50.0,
          max_queue: int = 64,
          request_timeout_s: float = 300.0,
          allow_resample: bool = False) -> ThreadingHTTPServer:
    """Start the batching server (returns the running HTTPServer; call
    .shutdown() to stop)."""
    try:
        default_ref = _load_ref_audio(None, DEFAULT_REF_TEXT,
                                      sample_rate=model.audio_cfg.sample_rate,
                                      resample_ref=allow_resample)
    except ValueError as e:
        # non-24kHz model: the bundled clip can't serve as the default
        print(f"warning: {e}; requests must supply ref_audio_b64")
        default_ref = None
    batcher = MicroBatcher(model, max_batch=max_batch, max_wait_ms=max_wait_ms,
                           max_queue=max_queue,
                           request_timeout_s=request_timeout_s)
    batcher.start()
    httpd = ThreadingHTTPServer(
        (host, port),
        make_handler(batcher, default_ref, allow_resample=allow_resample),
    )
    httpd.batcher = batcher  # keep a handle for shutdown
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    print(f"f5-tts-tpu (PyTorch) serving on {host}:{httpd.server_address[1]}")
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(description="f5-tts-tpu synthesis server (PyTorch)")
    ap.add_argument("--model", default="lucasnewman/f5-tts-mlx",
                    help="local snapshot directory of the model (downloads are not ported)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8930)
    ap.add_argument("--q", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=50.0)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="pending-request bound; beyond it requests get 503 + Retry-After")
    ap.add_argument("--request-timeout", type=float, default=300.0,
                    help="seconds before a queued request expires (504)")
    ap.add_argument("--w8a8", action="store_true", default=False,
                    help="int8-compute (W8A8) inference: int8 weights and activations in the DiT blocks")
    ap.add_argument("--mesh-data", type=int, default=1,
                    help="shard micro-batch groups over N devices of --device's type (data parallel)")
    ap.add_argument("--mesh-model", type=int, default=1,
                    help="tensor-parallel ways over attention heads / FF hidden")
    ap.add_argument("--warmup", type=str, default=None,
                    help="comma-separated durations (seconds) to pre-compile, e.g. '8,16,30'")
    ap.add_argument("--warmup-steps", type=int, default=8)
    ap.add_argument("--warmup-batches", type=str, default="1",
                    help="comma-separated batch sizes to pre-compile, e.g. '1,4,8'")
    ap.add_argument("--resample-ref", action="store_true", default=False,
                    help="resample off-rate reference audio to the model's rate instead of rejecting the request")
    ap.add_argument("--device", default="cuda",
                    help="device to load the model onto: the card by default, 'cpu' on request")
    args = ap.parse_args(argv)
    if args.w8a8 and args.q:
        ap.error("--q and --w8a8 cannot be combined: int8 compute quantizes "
                 "activations against FLOAT kernels (load the float snapshot)")
    refuse_unported(args.w8a8, args.q)
    mesh = cli_mesh(args.mesh_data, args.mesh_model, args.device)

    model = load_model(args.model, args.q, args.device, args.w8a8)
    if mesh is not None:
        model.use_mesh(mesh)
        print(f"serving over a {args.mesh_data}x{args.mesh_model} device mesh: {mesh}")
    httpd = serve(model, args.host, args.port, args.max_batch, args.max_wait_ms,
                  max_queue=args.max_queue, request_timeout_s=args.request_timeout,
                  allow_resample=args.resample_ref)
    if args.warmup:
        warmup(model, [float(s) for s in args.warmup.split(",")],
               steps=args.warmup_steps,
               batch_sizes=tuple(int(b) for b in args.warmup_batches.split(",")),
               batcher=httpd.batcher)
        print("warmup complete")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        httpd.batcher.stop()
        httpd.shutdown()


if __name__ == "__main__":
    main()
