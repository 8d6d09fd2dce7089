"""The PyTorch port's artifact server (f5_tts_tpu_torch/artifact_serve.py) on
the CPU: the counterparts of `tests/test_artifact_serve.py` (bucket choice,
the smallest fitting batch, the HTTP answer against a direct call, errors,
a mel-only artifact refused, /healthz and warm-up, the duration artifact,
streaming, concurrent against serial, cancelled requests that never run),
and that a predictor duration is resolved in the batcher thread.

The tiny model is the port's own (dim 64, depth 2, 64-frame buckets, 2
Euler steps), exported on the CPU and served with device="cpu"; the server
loads only the artifacts.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request
import wave as wave_mod

import numpy as np
import pytest
import torch

from f5_tts_tpu_torch import export as E
from f5_tts_tpu_torch.artifact_serve import ArtifactBatcher, ArtifactSampler, serve_artifacts
from f5_tts_tpu_torch.config import CFMConfig, DiTConfig, DurationConfig, VocosConfig
from f5_tts_tpu_torch.generate import estimated_duration, split_sentences
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.serve import _Request, resolve_ref_payload

HOP = 256
SR = 24_000
CPU = "cpu"


@pytest.fixture(scope="module")
def model():
    g = torch.Generator().manual_seed(0)
    cfg = DiTConfig(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=256,
                    text_dim=32, conv_layers=1)
    return F5TTS.init(g, cfg, device=CPU, cfm_cfg=CFMConfig(duration_bucket=64),
                      vocoder=Vocos.init(g, VocosConfig(dim=32, intermediate_dim=64, num_layers=2), device=CPU))


def _export(model, path, **kw):
    E.save_sampler(E.export_sampler(model, steps=2, method="euler", embed_weights=False, device=CPU, **kw), path,
                   model=model, extra_meta={"method": "euler", "cfg_strength": 2.0})
    return str(path)


@pytest.fixture(scope="module")
def artifacts(model, tmp_path_factory):
    """Two buckets (64 and 128 frames) at batch 1, and the 64 bucket at
    batch 4."""
    tmp = tmp_path_factory.mktemp("artifacts")
    return {"b1_64": _export(model, tmp / "b1_64.bin", batch=1, padded_len=64),
            "b1_128": _export(model, tmp / "b1_128.bin", batch=1, padded_len=128),
            "b4_64": _export(model, tmp / "b4_64.bin", batch=4, padded_len=64)}


@pytest.fixture(scope="module")
def duration_artifact(tmp_path_factory):
    """A tiny exported duration predictor with the default audio constants."""
    g = torch.Generator().manual_seed(7)
    dp = DurationPredictor.init(g, DurationConfig(dim=32, depth=1, heads=2, dim_head=16, ff_mult=2, text_dim=16,
                                                  conv_layers=1), device=CPU)
    p = tmp_path_factory.mktemp("dur") / "dur.bin"
    E.save_duration(E.export_duration(dp, padded_len=64, device=CPU), p, predictor=dp)
    return str(p), dp


@pytest.fixture(scope="module")
def ref():
    rng = np.random.default_rng(0)
    return (0.1 * rng.standard_normal(20 * HOP)).astype(np.float32)  # 20 frames


def _start(paths, ref, **kw):
    httpd = serve_artifacts(paths, default_ref=(ref, "ref words"), host="127.0.0.1", port=0, device=CPU, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd


def _stop(httpd):
    httpd.batcher.stop()
    httpd.shutdown()
    httpd.batcher.join(timeout=60)


@pytest.fixture(scope="module")
def server(artifacts, ref):
    url, httpd = _start([artifacts["b1_64"], artifacts["b1_128"]], ref)
    yield url, httpd
    _stop(httpd)


def _post(url, payload, path="/synthesize", timeout=120):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def _pcm(body: bytes) -> np.ndarray:
    with wave_mod.open(io.BytesIO(body)) as w:
        assert w.getframerate() == SR
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def _as_pcm(wave: np.ndarray) -> np.ndarray:
    return (np.clip(wave, -1, 1) * 32767.0).astype("<i2")


def test_default_ref_rate_validated(artifacts, ref):
    """A default reference at the wrong rate fails at start-up, or is
    resampled with allow_resample."""
    with pytest.raises(ValueError, match="16000 Hz"):
        serve_artifacts([artifacts["b1_64"]], default_ref=(ref, "x"), default_ref_sr=16_000, host="127.0.0.1",
                        port=0, device=CPU)
    httpd = serve_artifacts([artifacts["b1_64"]], default_ref=(ref, "x"), default_ref_sr=16_000, host="127.0.0.1",
                            port=0, allow_resample=True, device=CPU)
    httpd.batcher.stop()
    httpd.server_close()


def test_bucket_selection(server):
    _, httpd = server
    s = httpd.sampler
    assert [b.spec.padded_len for b in s.buckets] == [64, 128]
    assert (s.pick_length(40), s.pick_length(64), s.pick_length(65)) == (64, 64, 128)
    with pytest.raises(ValueError, match="largest artifact bucket"):
        s.pick_length(129)


def test_pick_artifact_prefers_smallest_fitting_batch(artifacts):
    s = ArtifactSampler([artifacts["b1_64"], artifacts["b4_64"]], device=CPU)
    assert s.max_batch == 4
    assert [s.pick_artifact(64, k).spec.batch for k in (1, 2, 4, 9)] == [1, 4, 4, 4]
    with pytest.raises(ValueError, match="padded_len"):
        s.pick_artifact(128, 1)


def test_artifacts_load_on_the_card_by_default(artifacts):
    """Artifacts exported on the CPU do not silently serve anywhere else:
    the default device is the card, and moving them must be asked for."""
    with pytest.raises(ValueError, match="exported for cpu"):
        ArtifactSampler([artifacts["b1_64"]])


def test_http_synthesize_matches_direct_export_call(server, artifacts, ref):
    """The HTTP answer equals `synthesize` (the same reference
    preprocessing), and that equals the artifact called directly."""
    url, httpd = server
    with _post(url, {"text": "hello world", "duration": 0.5, "seed": 3}) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        pcm_http = _pcm(r.read())
    assert pcm_http.size > 0 and pcm_http.size % HOP == 0
    ref_n, _ = resolve_ref_payload({}, (ref, "ref words"), SR)
    frames = int(0.5 * SR / HOP)
    wave = httpd.sampler.synthesize("hello world", ref_n, "ref words", frames, seed=3)
    np.testing.assert_array_equal(pcm_http, _as_pcm(wave))

    s, spec = E.load_sampler(artifacts["b1_64"], device=CPU)
    from f5_tts_tpu_torch.audio.mel import log_mel_spectrogram

    rf = ref_n.shape[0] // HOP
    buf = np.zeros((1, 64 * HOP), np.float32)
    buf[0, :rf * HOP] = ref_n[:rf * HOP]
    ids = httpd.sampler.tokenize(["ref words hello world"])
    args = E.prep_inputs(spec, log_mel_spectrogram(torch.tensor(buf))[:, :64], ids, frames,
                         lens=np.array([rf]), seed=3)
    direct = s.call(*args)[1][0].numpy()
    np.testing.assert_array_equal(wave, direct[int(args[1][0]) * HOP:(int(args[2][0]) - 1) * HOP])


def test_http_bucket_upgrade_and_estimate(server):
    url, _ = server
    with _post(url, {"text": "a longer utterance for the bigger bucket", "duration": 1.2}) as r:
        assert r.status == 200
    with _post(url, {"text": "hi", "estimate_duration": True}) as r:
        assert r.status == 200


def test_http_errors(server):
    url, _ = server
    for payload in ({"duration": 0.5}, {"text": "way too long", "duration": 10.0},
                    {"text": "x", "speed": "fast"}, {"text": "x", "speed": 0}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, payload)
        assert e.value.code == 400, payload
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(b"\x00\x00" * 1600)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, {"text": "x", "duration": 0.5, "ref_text": "y",
                    "ref_audio_b64": base64.b64encode(buf.getvalue()).decode()})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, {"text": "x"}, path="/nope")
    assert e.value.code == 404


def test_mel_only_artifact_rejected_cleanly(model, tmp_path):
    p = _export(model, tmp_path / "melonly.bin", batch=1, with_vocoder=False)
    with pytest.raises(ValueError, match="mel-only"):
        ArtifactSampler([p], device=CPU)


def test_healthz_and_warmup(server):
    url, httpd = server
    httpd.sampler.warmup()
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        info = json.loads(r.read())
    assert [b["padded_len"] for b in info["buckets"]] == [64, 128]
    assert all(b["steps"] == 2 and b["method"] == "euler" and b["cfg_strength"] == 2.0 for b in info["buckets"])
    assert info["duration_predictor"] is None and info["sample_rate"] == SR


def test_duration_artifact_resolves_missing_duration(artifacts, ref, duration_artifact):
    """A request without a duration takes the exported predictor's frames
    (the live predictor over the same window, at sample_rate // hop,
    divided by speed); estimate=True still takes the heuristic."""
    path, dp = duration_artifact
    s = ArtifactSampler([artifacts["b1_64"], artifacts["b1_128"]], duration_artifact=path, device=CPU)
    frames = s._predict_duration_frames(ref, "ref words", "hello", 1.0)
    ref_frames = ref.shape[0] // HOP
    buf = np.zeros((1, 64 * HOP), np.float32)
    buf[0, :ref_frames * HOP] = ref[:ref_frames * HOP]
    cond = s._mel(buf)[:, :64].clone()
    cond[:, ref_frames:] = 0.0
    text = np.pad(s.tokenize(["ref words hello"]), ((0, 0), (0, 64 - 15)), constant_values=-1)
    with torch.no_grad():
        sec = float(dp.seconds(cond, torch.tensor(text), torch.tensor([ref_frames]))[0])
    assert frames == max(int(sec * (SR // HOP)), 1)
    assert s._predict_duration_frames(ref, "ref words", "hello", 2.0) == max(int(int(sec * (SR // HOP)) / 2.0), 1)

    w_pred = s.synthesize("hello", ref, "ref words", None, seed=5)
    np.testing.assert_array_equal(w_pred, s.synthesize("hello", ref, "ref words", frames, seed=5))
    heur = int(estimated_duration(ref, "ref words", "hello", 1.0) * (SR / HOP))
    np.testing.assert_array_equal(s.synthesize("hello", ref, "ref words", None, seed=5, estimate=True),
                                  s.synthesize("hello", ref, "ref words", heur, seed=5))


def test_predictor_durations_resolve_in_the_batcher_thread(artifacts, ref, duration_artifact):
    """A /synthesize without a duration is planned in the batcher thread
    (after the backlog bound), never in the HTTP handler's; healthz names
    the predictor's window."""
    path, _ = duration_artifact
    url, httpd = _start([artifacts["b1_64"], artifacts["b1_128"]], ref, duration_artifact=path)
    threads = []
    call = httpd.sampler.duration.sampler.call

    def recording(*args):
        threads.append(threading.current_thread())
        return call(*args)

    httpd.sampler.duration.sampler.call = recording
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["duration_predictor"] == {"padded_len": 64}
        with _post(url, {"text": "hi", "seed": 1}) as r:
            assert r.status == 200 and r.read()
        assert threads == [httpd.batcher]
        with _post(url, {"text": "hi", "seed": 1, "estimate_duration": True}) as r:
            assert r.status == 200
        assert threads == [httpd.batcher]  # the heuristic runs no predictor
    finally:
        _stop(httpd)


def test_duration_artifact_batch_validated(artifacts, tmp_path):
    g = torch.Generator().manual_seed(8)
    dp = DurationPredictor.init(g, DurationConfig(dim=32, depth=1, heads=2, dim_head=16, ff_mult=2, text_dim=16,
                                                  conv_layers=1), device=CPU)
    p = tmp_path / "dur_b2.bin"
    E.save_duration(E.export_duration(dp, batch=2, padded_len=64, device=CPU), p, predictor=dp)
    with pytest.raises(ValueError, match="batch=2"):
        ArtifactSampler([artifacts["b1_64"]], duration_artifact=str(p), device=CPU)


def test_synthesize_stream_matches_per_sentence_synthesis(server, ref):
    """/synthesize_stream's PCM is the concatenation of each sentence's
    synthesis at the same planned durations, in order."""
    url, httpd = server
    text = "Hi there. Also this one."
    with _post(url, {"text": text, "seed": 4}, path="/synthesize_stream", timeout=300) as r:
        assert r.headers["Content-Type"] == "audio/wav"
        body = r.read()
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    s = httpd.sampler
    ref_n, _ = resolve_ref_payload({}, (ref, "ref words"), SR)
    parts = []
    for sent in split_sentences(text):
        wave = s.synthesize(sent, ref_n, "ref words", s.plan(sent, ref_n, "ref words", None)[0], seed=4)
        if wave.size:
            parts.append(_as_pcm(wave))
    np.testing.assert_array_equal(np.frombuffer(body[44:], "<i2"), np.concatenate(parts))


def test_synthesize_stream_rejects_request_duration_and_unservable_sentences(server):
    """A stream takes no duration, and a sentence no bucket can hold fails
    the whole request with a 400 before the stream commits; its backlog
    slots are freed."""
    url, httpd = server
    for payload in ({"text": "Hello.", "duration": 1.0},
                    {"text": "Short one. " + "word " * 400 + ".", "estimate_duration": True}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, payload, path="/synthesize_stream", timeout=60)
        assert e.value.code == 400
    assert httpd.batcher._outstanding == 0


def test_stream_holds_backlog_slots_before_planning(artifacts, ref):
    """With the backlog full, a stream gets 503 before it plans anything."""
    url, httpd = _start([artifacts["b1_64"]], ref, max_queue=2)
    try:
        httpd.batcher.reserve(2)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, {"text": "One. Two.", "estimate_duration": True}, path="/synthesize_stream")
        assert e.value.code == 503
        httpd.batcher.unreserve(2)
        with _post(url, {"text": "One. Two.", "estimate_duration": True}, path="/synthesize_stream") as r:
            assert r.status == 200 and len(r.read()) > 44
        assert httpd.batcher._outstanding == 0
    finally:
        _stop(httpd)


def test_clamp_aware_bucket_upgrade(server):
    """A reference that pushes the duration clamp past the small bucket
    routes to the larger one instead of failing."""
    _, httpd = server
    s = httpd.sampler
    long_ref = (0.1 * np.random.default_rng(1).standard_normal(100 * HOP)).astype(np.float32)
    assert s.synthesize("hi", long_ref, "ref words", 110).size == (110 - 1 - 100) * HOP
    assert s.synthesize("hi", long_ref, "ref words", 40).size == 0


def _counting(sampler, calls):
    orig = sampler.synthesize_chunk

    def counting(art, ids, refs, durs, **kw):
        calls.append((art.spec.batch, len(ids)))
        return orig(art, ids, refs, durs, **kw)

    sampler.synthesize_chunk = counting


def test_concurrent_requests_batch_and_match_serial(artifacts, ref):
    """Four concurrent requests run as one call of the batch-4 artifact,
    each equal to the serial direct call (batch 1) within one PCM step."""
    url, httpd = _start([artifacts["b1_64"], artifacts["b4_64"]], ref, max_wait_ms=500)
    calls = []
    _counting(httpd.sampler, calls)
    texts = [f"hello number {i}" for i in range(4)]
    results = {}

    def post_one(i):
        with _post(url, {"text": texts[i], "duration": 0.5, "seed": 3}) as r:
            results[i] = r.read()

    try:
        threads = [threading.Thread(target=post_one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(results) == [0, 1, 2, 3]
        assert any(b == 4 and k > 1 for b, k in calls) and len(calls) < 4, calls
        ref_n, _ = resolve_ref_payload({}, (ref, "ref words"), SR)
        for i in range(4):
            pcm_http = _pcm(results[i])
            pcm_direct = _as_pcm(httpd.sampler.synthesize(texts[i], ref_n, "ref words", int(0.5 * SR / HOP), seed=3))
            assert pcm_http.shape == pcm_direct.shape
            np.testing.assert_allclose(pcm_http.astype(np.int32), pcm_direct.astype(np.int32), atol=1)
    finally:
        _stop(httpd)


def test_artifact_bench_measures_sequential_and_concurrent_throughput(artifacts, ref):
    """serve_latency's artifact bench on a batch-1 + batch-4 server: both
    rates come back positive and the concurrent requests ran as batch-4
    calls."""
    from f5_tts_tpu_torch.tools.serve_latency import artifact_measure

    url, httpd = _start([artifacts["b1_64"], artifacts["b4_64"]], ref, max_wait_ms=500)
    calls = []
    _counting(httpd.sampler, calls)
    try:
        r = artifact_measure(httpd.server_address[1], n_requests=4,
                             payload={"text": "a throughput probe", "duration": 0.5, "seed": 0})
    finally:
        _stop(httpd)
    assert r["sequential_utt_s"] > 0 and r["concurrent_utt_s"] > 0
    assert calls[:5] == [(1, 1)] * 5 and any(b == 4 and k > 1 for b, k in calls[5:]), calls


def test_stream_sentences_batch_through_backfill_group(artifacts, ref):
    """A 3-sentence stream: sentence 0 runs alone at rank 0, the other two
    share one call."""
    url, httpd = _start([artifacts["b1_64"], artifacts["b4_64"]], ref, max_wait_ms=200)
    calls = []
    _counting(httpd.sampler, calls)
    try:
        with _post(url, {"text": "One two. Three four. Five six.", "estimate_duration": True, "seed": 1},
                   path="/synthesize_stream", timeout=300) as r:
            assert r.headers.get("Transfer-Encoding") == "chunked"
            assert len(r.read()) > 44
        assert len(calls) == 2 and calls[0][1] == 1 and calls[1][1] == 2, calls
    finally:
        _stop(httpd)


def test_unservable_direct_request_fails_without_killing_batcher(artifacts, ref):
    """A directly submitted request no bucket holds fails its own future,
    and the batcher thread serves the next one."""
    batcher = ArtifactBatcher(ArtifactSampler([artifacts["b1_64"]], device=CPU), max_wait_ms=10.0)
    batcher.start()
    try:
        kw = dict(ref_audio=ref, ref_text="ref words", steps=2, method="euler", cfg_strength=2.0, sway=-1.0, seed=0)
        with pytest.raises(ValueError):
            batcher.submit(_Request(text="too long", duration_frames=10_000, **kw)).result(timeout=60)
        wave = batcher.submit(_Request(text="short", duration_frames=40, **kw)).result(timeout=60)
        assert wave.ndim == 1 and wave.size > 0
    finally:
        batcher.stop()
        batcher.join(timeout=60)


def test_cancelled_requests_never_reach_device(artifacts, ref):
    sampler = ArtifactSampler([artifacts["b1_64"]], device=CPU)
    calls = []
    _counting(sampler, calls)
    batcher = ArtifactBatcher(sampler, max_wait_ms=500.0)
    batcher.start()
    try:
        futs = [batcher.submit(_Request(text=f"t {i}", ref_audio=ref, ref_text="ref words", duration_frames=40,
                                        steps=2, method="euler", cfg_strength=2.0, sway=-1.0, seed=0))
                for i in range(3)]
        if not (futs[1].cancel() and futs[2].cancel()):
            pytest.skip("batcher dispatched before cancel (loaded host)")
        assert futs[0].result(timeout=60).ndim == 1
        assert sum(k for _, k in calls) == 1, calls
    finally:
        batcher.stop()
        batcher.join(timeout=60)
