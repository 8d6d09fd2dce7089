"""The port's serving layer (`f5_tts_tpu_torch/serve.py`): every behaviour
`tests/test_serve.py` pins for the JAX server but its XLA memory-map guard,
driven over a real socket with a tiny port model on the CPU, plus the
scheduler's and the duration resolution's parity with the JAX package's
`MicroBatcher`.

Tiny configs of `tests/test_serve.py`: the DiT at dim 64, depth 2, 2 heads
x 32, text_dim 32 (dim 32, depth 1 for the scheduler-only batchers), Vocos
at dim 64, 64-frame buckets; random weights from a seeded generator, or
the JAX package's moved over by `params_from_jax` where the two are
compared.
"""

import base64
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.parse
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu import serve as jserve
from f5_tts_tpu.config import CFMConfig as JaxCFMConfig
from f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from f5_tts_tpu.config import DurationConfig as JaxDurationConfig
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor
from f5_tts_tpu_torch import serve as tserve
from f5_tts_tpu_torch.audio.io import write_wav
from f5_tts_tpu_torch.config import CFMConfig, DiTConfig, DurationConfig, VocosConfig
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.serve import MicroBatcher, _Request, serve

DIT = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
           text_num_embeds=256, text_dim=32, conv_layers=1)
SMALL_DIT = dict(dim=32, depth=1, heads=2, dim_head=16, ff_mult=2, mel_dim=100,
                 text_num_embeds=256, text_dim=16, conv_layers=1)
DUR = dict(dim=32, depth=1, heads=2, dim_head=16, ff_mult=2, text_dim=16, conv_layers=1)
VOCOS = dict(dim=64, intermediate_dim=128, num_layers=2)
# the bundled clip is 127,987 samples: 499 reference frames at hop 256
REF_FRAMES = 127_987 // 256


def _tiny_model(dit=DIT, cfm=None, predictor=False):
    g = torch.Generator().manual_seed(0)
    return F5TTS.init(
        g, DiTConfig(**dit), device="cpu", cfm_cfg=cfm or CFMConfig(duration_bucket=64),
        vocoder=Vocos.init(g, VocosConfig(**VOCOS), device="cpu"),
        duration_predictor=DurationPredictor.init(g, DurationConfig(**DUR), device="cpu") if predictor else None,
    )


def _start(model, **kw):
    httpd = serve(model, host="127.0.0.1", port=0, **kw)
    httpd.url = f"http://127.0.0.1:{httpd.server_address[1]}"
    return httpd


def _stop(httpd):
    httpd.batcher.stop()
    httpd.shutdown()
    httpd.batcher.join(timeout=30)
    assert not httpd.batcher.is_alive()


@pytest.fixture(scope="module")
def server():
    httpd = _start(_tiny_model(), max_batch=4, max_wait_ms=80.0)
    yield httpd
    _stop(httpd)


@pytest.fixture(scope="module")
def server_with_predictor():
    httpd = _start(_tiny_model(predictor=True), max_batch=4, max_wait_ms=50.0)
    yield httpd
    _stop(httpd)


def _post(url, payload, path="/synthesize", timeout=300):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def _http_error(url, payload, path="/synthesize", timeout=60):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, payload, path, timeout)
    return e.value


def _pcm_samples(seconds):
    """Samples of a /synthesize answer with the bundled reference and an
    explicit duration: the frames past the reference, less the last."""
    return (int(seconds * 24_000 / 256) - 1 - REF_FRAMES) * 256


# ---------------------------------------------------------------- HTTP surface


def test_healthz(server):
    with urllib.request.urlopen(server.url + "/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}


def test_synthesize_returns_wav(server):
    with _post(server.url, {"text": "hello world", "duration": 6.5, "steps": 2,
                            "method": "euler", "seed": 0}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        body = r.read()
    assert body[:4] == b"RIFF"
    assert len(body) == 44 + 2 * _pcm_samples(6.5)


def test_concurrent_requests_batched(server, monkeypatch):
    """Three parallel requests of one bucket complete, at least two of them
    in one group."""
    sizes = []
    real = server.batcher._run_group
    monkeypatch.setattr(server.batcher, "_run_group", lambda g: (sizes.append(len(g)), real(g))[1])
    results = {}

    def hit(i):
        with _post(server.url, {"text": f"request number {i}", "duration": 6.5,
                                "steps": 2, "method": "euler", "seed": 0}) as r:
            results[i] = r.read()

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert len(results) == 3
    assert all(v[:4] == b"RIFF" and len(v) == 44 + 2 * _pcm_samples(6.5) for v in results.values())
    assert sum(sizes) == 3 and max(sizes) > 1


def test_custom_ref_audio(server, tmp_path):
    ref = (0.2 * np.sin(2 * np.pi * 220 * np.arange(24_000) / 24_000)).astype(np.float32)
    p = tmp_path / "ref.wav"
    write_wav(p, ref, 24_000)
    b64 = base64.b64encode(p.read_bytes()).decode()
    with _post(server.url, {"text": "custom voice", "ref_audio_b64": b64, "ref_text": "a tone",
                            "duration": 4.0, "steps": 2, "method": "euler"}) as r:
        body = r.read()
    assert body[:4] == b"RIFF"
    assert len(body) == 44 + 2 * (int(4.0 * 24_000 / 256) - 1 - 24_000 // 256) * 256


def test_resolve_ref_payload_resamples_off_rate_audio(tmp_path):
    """Off-rate ref_audio_b64 is a 400 by default, but allow_resample
    converts it on the host; the length cap applies at the model rate."""
    from f5_tts_tpu_torch.serve import BadRequest, resolve_ref_payload

    tone = (0.2 * np.sin(2 * np.pi * 220 * np.arange(16_000) / 16_000)).astype(np.float32)
    p = tmp_path / "ref16k.wav"
    write_wav(p, tone, 16_000)
    payload = {"ref_audio_b64": base64.b64encode(p.read_bytes()).decode(), "ref_text": "a tone"}
    with pytest.raises(BadRequest, match="24000 Hz"):
        resolve_ref_payload(payload, None, 24_000)
    audio, text = resolve_ref_payload(payload, None, 24_000, allow_resample=True)
    assert text == "a tone"
    assert abs(audio.shape[0] - 24_000) <= 2
    with pytest.raises(BadRequest, match="conditions on at most"):
        resolve_ref_payload(payload, None, 24_000, max_ref_samples=12_000, allow_resample=True)


def test_missing_text_rejected(server):
    e = _http_error(server.url, {"duration": 2.0})
    assert e.code == 400
    assert "text" in json.loads(e.read())["error"]


def test_bad_method_rejected(server):
    assert _http_error(server.url, {"text": "x", "duration": 6.0, "method": "dopri5"}).code == 400


def test_invalid_json_rejected(server):
    req = urllib.request.Request(server.url + "/synthesize", data=b"{not json", method="POST",
                                 headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_unknown_route(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server.url + "/nope", timeout=30)
    assert e.value.code == 404
    assert _http_error(server.url, {"text": "x"}, path="/nope").code == 404


def _read_chunks(url, path, payload):
    """POST over a raw socket and split the chunked body into its chunks."""
    u = urllib.parse.urlparse(url)
    body = json.dumps(payload).encode()
    req = (f"POST {path} HTTP/1.1\r\nHost: {u.hostname}\r\nContent-Type: application/json\r\n"
           f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n").encode() + body
    with socket.create_connection((u.hostname, u.port), timeout=300) as s:
        s.settimeout(300)
        s.sendall(req)
        raw = b""
        while chunk := s.recv(65536):
            raw += chunk
    head, _, body = raw.partition(b"\r\n\r\n")
    chunks = []
    while body:
        size_hex, _, rest = body.partition(b"\r\n")
        size = int(size_hex, 16)
        if size == 0:
            break
        chunks.append(rest[:size])
        body = rest[size + 2:]
    return head, chunks


def test_synthesize_stream_chunks(server):
    """/synthesize_stream sends a WAV stream header, then one PCM chunk per
    sentence."""
    head, chunks = _read_chunks(server.url, "/synthesize_stream", {
        "text": "first sentence here. and then a second one. finally a third!",
        "steps": 2, "method": "euler", "seed": 0})
    assert b"200" in head.split(b"\r\n")[0]
    assert b"Transfer-Encoding: chunked" in head
    assert len(chunks) == 4
    assert chunks[0][:4] == b"RIFF" and len(chunks[0]) == 44
    assert all(len(c) > 1000 and len(c) % 2 == 0 for c in chunks[1:])


def test_synthesize_stream_rejects_duration(server):
    assert _http_error(server.url, {"text": "hello there", "duration": 5.0},
                       path="/synthesize_stream").code == 400


def test_http_body_size_cap(server):
    """A Content-Length beyond MAX_BODY_BYTES is a 413 before the body is
    read."""
    u = urllib.parse.urlsplit(server.url)
    with socket.create_connection((u.hostname, u.port), timeout=30) as s:
        s.sendall(b"POST /synthesize HTTP/1.1\r\nHost: t\r\nContent-Type: application/json\r\n"
                  + f"Content-Length: {tserve.MAX_BODY_BYTES + 1}\r\n\r\n".encode())
        status = s.makefile("rb").readline()
    assert b"413" in status


def test_negative_content_length_rejected(server):
    import http.client

    conn = http.client.HTTPConnection(server.url.split("//")[1], timeout=30)
    try:
        conn.putrequest("POST", "/synthesize", skip_accept_encoding=True)
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", "-1")
        conn.endheaders()
        assert conn.getresponse().status == 400
    finally:
        conn.close()


@pytest.mark.parametrize("field, value", [("duration", "abc"), ("steps", "many"), ("seed", "lucky"),
                                          ("cfg_strength", "strong")])
def test_malformed_numeric_fields_return_400(server, field, value):
    assert _http_error(server.url, {"text": "hi", field: value}).code == 400


def test_expired_request_returns_504():
    """A request whose deadline passes before its synthesis starts gets 504."""
    httpd = _start(_tiny_model(SMALL_DIT), request_timeout_s=1e-6)
    try:
        assert _http_error(httpd.url, {"text": "late", "duration": 1.0, "steps": 2,
                                       "method": "euler"}).code == 504
    finally:
        _stop(httpd)


def test_http_queue_full_returns_503():
    """With the batcher parked and its queue full, a POST gets 503 and
    Retry-After, and a stream is shed all or nothing."""
    httpd = _start(_tiny_model(SMALL_DIT), max_queue=1)
    try:
        httpd.batcher.stop()
        httpd.batcher.join(timeout=5)
        httpd.batcher.queue.put_nowait(_mk_req("filler", 64))
        e = _http_error(httpd.url, {"text": "flooded", "duration": 1.0, "steps": 2, "method": "euler"})
        assert e.code == 503 and e.headers["Retry-After"] is not None
        e = _http_error(httpd.url, {"text": "one. two. three.", "steps": 2, "method": "euler",
                                    "estimate_duration": True}, path="/synthesize_stream")
        assert e.code == 503
    finally:
        httpd.shutdown()


def test_oversized_ref_audio_rejected(tmp_path):
    """A reference longer than the model's conditioning window is a 400."""
    httpd = _start(_tiny_model(SMALL_DIT, cfm=CFMConfig(duration_bucket=64, max_duration=128)))
    try:
        long_ref = tmp_path / "long.wav"
        write_wav(long_ref, np.zeros(48_000, np.float32), 24_000)  # 2 s > the 128-frame window
        e = _http_error(httpd.url, {"text": "too long a reference", "duration": 1.0, "steps": 2,
                                    "method": "euler", "ref_text": "ref",
                                    "ref_audio_b64": base64.b64encode(long_ref.read_bytes()).decode()})
        assert e.code == 400 and b"conditions on at most" in e.read()
    finally:
        _stop(httpd)


# ---------------------------------------------------------------- durations


def test_duration_predictor_resolves_in_batcher(server_with_predictor):
    with _post(server_with_predictor.url, {"text": "predict my duration please", "steps": 2,
                                           "method": "euler", "seed": 0}) as r:
        assert r.read()[:4] == b"RIFF"


def test_predict_durations_resolves_none(server_with_predictor):
    """One batched predictor forward fills every deferred request's frames,
    honouring its speed."""
    ref = np.zeros((12_000,), dtype=np.float32)
    reqs = [_Request(text="short text", ref_audio=ref, ref_text="ref", duration_frames=None, steps=2,
                     method="euler", cfg_strength=2.0, sway=-1.0, seed=0, speed=s) for s in (1.0, 2.0)]
    server_with_predictor.batcher._predict_durations(reqs)
    assert all(isinstance(r.duration_frames, int) and r.duration_frames >= 1 for r in reqs)
    assert reqs[1].duration_frames <= reqs[0].duration_frames


def test_estimate_duration_flag_bypasses_predictor(server_with_predictor, monkeypatch):
    model = server_with_predictor.batcher.model
    calls = []
    real = model.predict_duration
    monkeypatch.setattr(model, "predict_duration", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    with _post(server_with_predictor.url, {"text": "use the heuristic instead", "estimate_duration": True,
                                           "steps": 2, "method": "euler", "seed": 0}) as r:
        assert r.read()[:4] == b"RIFF"
    assert calls == []


def test_batcher_thread_runs_without_grad(server_with_predictor, monkeypatch):
    """Grad mode is per thread: the batcher's device work (the predictor,
    outside sample's no_grad, and sampling) runs in inference mode, and no
    tensor it returns requires grad."""
    model = server_with_predictor.batcher.model
    seen = []
    real_predict, real_sample = model.predict_duration, model.sample

    def predict(*a, **k):
        seen.append(("predict", torch.is_grad_enabled(), torch.is_inference_mode_enabled()))
        return real_predict(*a, **k)

    def sample(*a, **k):
        seen.append(("sample", torch.is_grad_enabled(), torch.is_inference_mode_enabled()))
        wave, traj = real_sample(*a, **k)
        seen.append(("result", wave.requires_grad or traj.requires_grad, None))
        return wave, traj

    monkeypatch.setattr(model, "predict_duration", predict)
    monkeypatch.setattr(model, "sample", sample)
    with _post(server_with_predictor.url, {"text": "no gradients here", "steps": 2, "method": "euler",
                                           "seed": 0}) as r:
        assert r.read()[:4] == b"RIFF"
    assert seen == [("predict", False, True), ("sample", False, True), ("result", False, None)]


def test_degenerate_request_does_not_poison_batch():
    """A request whose duration resolution fails (an empty ref_text through
    the heuristic) fails alone."""
    b = MicroBatcher(_tiny_model())
    ref = np.zeros((12_000,), dtype=np.float32)
    good = _Request(text="fine request", ref_audio=ref, ref_text="ref", duration_frames=None, steps=2,
                    method="euler", cfg_strength=2.0, sway=-1.0, seed=0)
    bad = _Request(text="bad request", ref_audio=ref, ref_text="", duration_frames=None, steps=2,
                   method="euler", cfg_strength=2.0, sway=-1.0, seed=0)
    b._process_batch([good, bad])
    assert good.future.result(timeout=300) is not None
    with pytest.raises(ZeroDivisionError):
        bad.future.result(timeout=5)


def test_warmup_runs_the_predictor_path(server_with_predictor, monkeypatch):
    """warmup() without a live batcher also runs the duration predictor."""
    model = server_with_predictor.batcher.model
    calls = []
    real = model.predict_duration
    monkeypatch.setattr(model, "predict_duration", lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    tserve.warmup(model, [1.0], steps=2, method="euler", batcher=None)
    assert calls == [1]


def test_predict_durations_match_jax():
    """The same padded references and texts through both packages' batchers,
    the predictor's weights moved over by params_from_jax: the same frames,
    or one apart where the float seconds round to frames differently."""
    jax_dp = JaxDurationPredictor.init(jax.random.key(7), JaxDurationConfig(**DUR, use_flash_attention=False))
    rng = np.random.default_rng(1)  # the JAX init leaves GRN gamma/beta at zero
    for blk in jax_dp.params["text_embed"]["blocks"]:
        blk["grn"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)) for k, v in blk["grn"].items()}
    jax_model = JaxF5TTS.init(jax.random.key(0), JaxDiTConfig(**SMALL_DIT, use_flash_attention=False),
                              cfm_cfg=JaxCFMConfig(duration_bucket=64), duration_predictor=jax_dp)
    port_dp = DurationPredictor(DurationConfig(**DUR))
    port_dp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_dp.params), port_dp.cfg))
    port = F5TTS(DiT(DiTConfig(**SMALL_DIT)), DiTConfig(**SMALL_DIT), cfm_cfg=CFMConfig(duration_bucket=64),
                 duration_predictor=port_dp)

    def requests(pkg):
        out = []
        for i, (n, text, speed) in enumerate([(12_000, "short text", 1.0), (30_000, "a longer text to say", 1.0),
                                              (20_000, "short text", 2.0), (41_000, "one more, please!", 0.8)]):
            ref = (0.2 * np.sin(2 * np.pi * (150 + 40 * i) * np.arange(n) / 24_000)).astype(np.float32)
            out.append(pkg._Request(text=text, ref_audio=ref, ref_text="a reference", duration_frames=None,
                                    steps=2, method="euler", cfg_strength=2.0, sway=-1.0, seed=0, speed=speed))
        return out

    jreqs, treqs = requests(jserve), requests(tserve)
    jserve.MicroBatcher(jax_model)._predict_durations(jreqs)
    MicroBatcher(port)._predict_durations(treqs)
    jframes = [r.duration_frames for r in jreqs]
    tframes = [r.duration_frames for r in treqs]
    assert all(isinstance(f, int) for f in tframes)
    assert len(set(jframes)) > 1  # the requests are told apart
    assert np.abs(np.array(jframes) - np.array(tframes)).max() <= 1, (jframes, tframes)


# ---------------------------------------------------------------- scheduler


class _Recording:
    """A package's MicroBatcher whose _run_group records each group and
    settles its futures without synthesis."""

    def __new__(cls, pkg, model, **kw):
        class Rec(pkg.MicroBatcher):
            def __init__(self, model, **kw):
                super().__init__(model, **kw)
                self.dispatched = []

            def _run_group(self, group):
                self.dispatched.append([r.text for r in group])
                for r in group:
                    if not r.future.done():
                        r.future.set_result(np.zeros(8, np.float32))
                self._release(group)

        return Rec(model, **kw)


BUCKETED = types.SimpleNamespace(cfm_cfg=CFMConfig(duration_bucket=64))


def _mk_req(text, dur_frames, rank=0, pkg=tserve, **kw):
    return pkg._Request(text=text, ref_audio=np.zeros(2048, np.float32), ref_text="r", duration_frames=dur_frames,
                        steps=kw.pop("steps", 2), method="euler", cfg_strength=2.0, sway=-1.0, seed=0,
                        stream_rank=rank, **kw)


@pytest.mark.parametrize("seed", range(6))
def test_scheduler_matches_jax(seed):
    """The same requests (ranks, duration buckets, step counts, ages past and
    short of the starvation bound, a burst arriving after the first group)
    through both packages' `_step`: the same groups in the same order."""
    rng = np.random.default_rng(seed)
    base = time.monotonic()
    spec = [(f"r{i}", int(rng.choice([40, 100, 130, 700, 1400])), int(rng.integers(0, 2)),
             int(rng.choice([2, 4])), float(rng.choice([0.0, 6.0, 12.0]))) for i in range(14)]
    orders = []
    for pkg in (jserve, tserve):
        b = _Recording(pkg, BUCKETED, max_batch=3, starvation_s=10.0)
        reqs = [_mk_req(t, d, rank, pkg, steps=steps, t_submit=base - age) for t, d, rank, steps, age in spec]
        pending = b._step(reqs[:9], drain=True)
        for r in reqs[9:]:
            b.queue.put(r)
        pending = b._step(pending, drain=True)
        while pending:
            pending = b._step(pending, drain=False)
        orders.append(b.dispatched)
    assert orders[0] == orders[1]
    assert sorted(t for g in orders[1] for t in g) == sorted(s[0] for s in spec)
    assert max(map(len, orders[1])) <= 3


def test_group_size_capped_at_max_batch():
    b = _Recording(tserve, BUCKETED, max_batch=3)
    b._process_batch([_mk_req(f"t{i}", 100) for i in range(7)])
    sizes = [len(g) for g in b.dispatched]
    assert sum(sizes) == 7 and max(sizes) <= 3


def test_rank0_arrival_preempts_remaining_backfill():
    b = _Recording(tserve, BUCKETED, max_batch=2)
    pending = b._step([_mk_req(f"b{i}", 700, rank=1) for i in range(6)], drain=True)
    b.queue.put(_mk_req("urgent", 100, rank=0))
    pending = b._step(pending, drain=True)
    pending = b._step(pending, drain=True)
    while pending:
        pending = b._step(pending, drain=False)
    order = b.dispatched
    assert order.index(["urgent"]) <= 2 < len(order) - 1


def test_aged_backfill_outranks_fresh_rank0():
    b = _Recording(tserve, BUCKETED, max_batch=2, starvation_s=5.0)
    old = _mk_req("old-backfill", 700, rank=1, t_submit=time.monotonic() - 10.0)
    b._step([old, _mk_req("fresh-urgent", 100, rank=0)], drain=False)
    assert b.dispatched[0] == ["old-backfill"]
    b.dispatched.clear()
    b._step([_mk_req("young-backfill", 700, rank=1), _mk_req("urgent", 100, rank=0)], drain=False)
    assert b.dispatched[0] == ["urgent"]


def test_aged_long_rank0_outranks_fresh_short_rank0():
    b = _Recording(tserve, BUCKETED, max_batch=2, starvation_s=5.0)
    long_old = _mk_req("long-starving", 1400, t_submit=time.monotonic() - 10.0)
    b._step([long_old, _mk_req("short-fresh", 100)], drain=False)
    assert b.dispatched[0] == ["long-starving"]
    b.dispatched.clear()
    b._step([_mk_req("long-young", 1400), _mk_req("short", 100)], drain=False)
    assert b.dispatched[0] == ["short"]


def test_bounded_queue_raises_overloaded():
    b = MicroBatcher(BUCKETED, max_queue=2)  # not started
    b.submit(_mk_req("a", 64))
    b.submit(_mk_req("b", 64))
    with pytest.raises(tserve.Overloaded, match="queue full"):
        b.submit(_mk_req("c", 64))


def test_backlog_bound_counts_drained_requests():
    """The bound is the whole backlog, queued and drained into the
    batcher's pending list, not the queue's occupancy."""
    b = MicroBatcher(BUCKETED, max_queue=2)
    b.submit(_mk_req("a", 64))
    b.submit(_mk_req("b", 64))
    drained = [b.queue.get_nowait(), b.queue.get_nowait()]
    with pytest.raises(tserve.Overloaded):
        b.submit(_mk_req("c", 64))
    b._release(drained[:1])
    b.submit(_mk_req("d", 64))
    with pytest.raises(tserve.Overloaded):
        b.submit(_mk_req("e", 64))


def test_expired_request_fails_fast_and_skips_synthesis():
    b = _Recording(tserve, BUCKETED)
    dead = _mk_req("expired", 64, deadline=time.monotonic() - 1.0)
    live = _mk_req("live", 64)
    b._process_batch([dead, live])
    with pytest.raises(TimeoutError):
        dead.future.result(timeout=5)
    assert live.future.result(timeout=5) is not None
    assert b.dispatched == [["live"]]


def test_cancelled_request_does_not_poison_group():
    b = MicroBatcher(_tiny_model(SMALL_DIT))
    gone, live = _mk_req("gone", 64), _mk_req("live", 64)
    assert gone.future.cancel()
    b._run_group([gone, live])
    wave = live.future.result(timeout=5)
    assert isinstance(wave, np.ndarray) and wave.dtype == np.float32
    assert gone.future.cancelled()


# ---------------------------------------------------------------- latency tool


def test_serve_latency_measure_drives_a_server(server, monkeypatch):
    """The latency tool's three measurements run against a live server (the
    tiny model on the CPU, at 2 Euler steps and 2 warm runs: a check of the
    requests it makes, not a time)."""
    from f5_tts_tpu_torch.tools import serve_latency

    monkeypatch.setattr(serve_latency, "SAMPLER", {"steps": 2, "method": "euler", "seed": 0})
    monkeypatch.setattr(serve_latency, "WARM_RUNS", 2)
    result = serve_latency.measure(server.server_address[1])
    assert len(result["warm_runs_s"]) == 2
    assert 0 < result["stream_ttfa_s"] <= result["stream_total_s"]
    assert result["mixed_load_small_request_s"] > 0 and result["burst_total_s"] > 0


@pytest.mark.parametrize("argv, error", [(["--device", "cpu"], RuntimeError)])
def test_serve_latency_refusals(argv, error):
    from f5_tts_tpu_torch.tools import serve_latency

    with pytest.raises(error):
        serve_latency.main(argv)


@pytest.mark.parametrize("argv, error", [(["--mesh-data", "2"], ValueError),  # a mesh of the one CPU device
                                         (["--mesh-model", "4"], ValueError),
                                         (["--q", "4", "--w8a8"], SystemExit),
                                         (["--model", "no/such/dir"], ValueError)])
def test_server_main_refusals(argv, error):
    """What the server cannot run is refused before a model loads."""
    with pytest.raises(error) as caught:
        tserve.main(argv + ["--device", "cpu"])
    if argv[0].startswith("--mesh"):  # refused by create_mesh, before the model loads
        assert str(caught.value) == f"mesh {'2x1x1' if argv[0] == '--mesh-data' else '1x1x4'} needs " \
            f"{2 if argv[0] == '--mesh-data' else 4} devices, have 1"


def test_server_main_w8a8_serves_int8_compute(tmp_path, monkeypatch):
    """--w8a8 loads the snapshot, sets int8_compute on the served model and
    serves: one /synthesize answers with a WAV of the asked length, sampled
    through W8A8 linears."""
    from f5_tts_tpu_torch.models.quant import W8A8Linear

    _tiny_model().save_pretrained(tmp_path)
    started = []
    real_serve = tserve.serve

    class Started(Exception):
        """Leaves main before it waits forever; the test stops the server."""

    def serve_and_stop(model, *args, **kw):
        started.append((model, real_serve(model, "127.0.0.1", 0, *args[2:], **kw)))
        raise Started

    monkeypatch.setattr(tserve, "serve", serve_and_stop)
    with pytest.raises(Started):
        tserve.main(["--model", str(tmp_path), "--w8a8", "--device", "cpu", "--max-batch", "1"])
    model, httpd = started[0]
    try:
        assert model.dit_cfg.int8_compute
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        with _post(url, {"text": "hello world", "duration": 6.5, "steps": 2, "method": "euler", "seed": 0}) as r:
            body = r.read()
        assert r.status == 200 and len(body) == 44 + 2 * _pcm_samples(6.5)
        assert all(isinstance(blk.attn.to_q, W8A8Linear) for blk in model._inference_dit().transformer_blocks)
    finally:
        _stop(httpd)
