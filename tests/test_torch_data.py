"""The port's training data pipeline (`f5_tts_tpu_torch/data`,
`parallel/distributed.py`) against the JAX package's, on the CPU.

The stream combinators; the same WAV tree and seed through both packages'
`make_training_pipeline` (host mel and raw audio), `dynamic_batch` and
per-process sharding; and the first raw-audio batch through both packages'
train steps with the same draws. Audio, lengths and transcripts are equal
bit for bit (both decode with the same C++ source through g++); the host
mel within 1e-4 absolute, the tolerance of the mel test in
`tests/test_torch_ops.py`; the loss within rtol 1e-4, as
`tests/test_torch_training.py` holds the from-audio step.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu import config as jcfg
from f5_tts_tpu.data import libritts as JLT
from f5_tts_tpu.data import loader as JL
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.training import trainer as JT
from f5_tts_tpu_torch import config as tcfg
from f5_tts_tpu_torch.data import libritts as LT
from f5_tts_tpu_torch.data import loader as L
from f5_tts_tpu_torch.models.cfm import CFMDraws
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.parallel import distributed as D
from f5_tts_tpu_torch.audio.io import write_wav_format
from f5_tts_tpu_torch.training import trainer as T

MEL_TOL = 1e-4
FRAMES = 64  # pad_frame_multiple of the tree's batches: its clips span several buckets


def write_tree(root, n_clips=12, seed=0):
    """A LibriTTS-layout tree: `n_clips` 16-bit clips of 0.3 to 2.5 s, one
    24-bit and one float32 clip, one 16 kHz clip (dropped by decode) and one
    file that is not a WAV (dropped by decode, or raising under sharding)."""
    rng = np.random.default_rng(seed)
    d = root / "19" / "198"
    d.mkdir(parents=True, exist_ok=True)
    clips = [(f"c{i:02d}", "pcm16", 24_000) for i in range(n_clips)]
    clips += [("deep24", "pcm24", 24_000), ("float", "float32", 24_000), ("rate16k", "pcm16", 16_000)]
    for name, fmt, sr in clips:
        n = int(rng.uniform(0.3, 2.5) * sr)
        write_wav_format(d / f"{name}.wav", (0.1 * rng.standard_normal(n)).astype(np.float32), sr, fmt)
        (d / f"{name}.normalized.txt").write_text(f"clip {name} says {rng.integers(1000)} words.")
    (d / "broken.wav").write_bytes(b"this is not a wav file at all" * 50)
    (d / "broken.normalized.txt").write_text("broken clip")
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("wavs"))


def _assert_same_batches(got: list, ref: list):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in ("audio", "mel_len", "transcript"):
            if k in r:
                assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        if "mel_spec" in r:
            assert g["mel_spec"].dtype == np.float32 and g["mel_spec"].shape == r["mel_spec"].shape
            np.testing.assert_allclose(g["mel_spec"], np.asarray(r["mel_spec"]), atol=MEL_TOL, rtol=0)
            assert np.all(g["mel_spec"][np.arange(g["mel_spec"].shape[1])[None, :] >= g["mel_len"][:, None]] == 0)


# ------------------------------------------------------------------ Stream


def test_stream_combinators():
    s = L.Stream.from_list([1, 2, 3])
    assert list(s.repeat(2)) == [1, 2, 3, 1, 2, 3]
    assert sorted(s.shuffle(2, seed=0)) == [1, 2, 3]
    assert list(s.map(lambda x: x * 2)) == [2, 4, 6]
    assert list(s.map(lambda x: None if x == 2 else x)) == [1, 3]
    assert list(s.filter(lambda x: x > 1)) == [2, 3]
    assert list(s.batch(2, lambda b: b)) == [[1, 2], [3]]
    assert list(s.batch(2, lambda b: b, drop_remainder=True)) == [[1, 2]]
    assert list(s.prefetch(2)) == [1, 2, 3]
    assert list(s) == [1, 2, 3]  # streams restart cleanly


def test_stream_prefetch_propagates_errors():
    def boom():
        yield 1
        raise RuntimeError("decode failed")

    with pytest.raises(RuntimeError, match="decode failed"):
        list(L.Stream(boom).prefetch(2))


@pytest.mark.parametrize("seed", [0, 5, None])
def test_shuffle_gives_the_jax_order(seed):
    items = list(range(57))
    got = list(L.Stream.from_list(items).repeat(2).shuffle(9, seed=seed))
    assert sorted(got) == sorted(items * 2)
    if seed is not None:
        assert got == list(JL.Stream.from_list(items).repeat(2).shuffle(9, seed=seed))


def test_dynamic_batch_respects_frame_budget_and_matches_jax():
    rng = np.random.default_rng(0)
    samples = [{"audio": np.zeros(int(n), np.float32), "transcript": np.array([1], np.int32)}
               for n in rng.integers(256 * 4, 256 * 40, size=50)]
    max_frames = 120
    batches = list(L.Stream.from_list(samples).dynamic_batch(buffer_size=25, max_frames=max_frames,
                                                             collate=lambda b: b, seed=0))
    assert sum(len(b) for b in batches) == 50  # nothing dropped
    for b in batches:
        frames = [x["audio"].shape[0] // 256 for x in b]
        assert len(b) * max(frames) <= max_frames or len(b) == 1
    ref = list(JL.Stream.from_list(samples).dynamic_batch(buffer_size=25, max_frames=max_frames,
                                                          collate=lambda b: b, seed=0))
    assert [[id(x) for x in b] for b in batches] == [[id(x) for x in b] for b in ref]


def test_threaded_map_keeps_order():
    rng = np.random.default_rng(1)
    delays = rng.uniform(0, 0.004, size=40)

    def fn(i):
        time.sleep(delays[i])
        return None if i % 7 == 3 else i * 10

    got = list(L.Stream.from_list(list(range(40))).map(fn, num_threads=5))
    assert got == [i * 10 for i in range(40) if i % 7 != 3]


@pytest.mark.parametrize("prefetch", [False, True])
def test_early_close_of_a_threaded_stream_leaves_nothing_running(prefetch):
    """The trainer breaks at total_steps: close() returns, no decode runs
    after it, and the decode pool and the prefetch thread are gone."""
    lock = threading.Lock()
    state = {"running": 0, "started": 0}

    def fn(i):
        with lock:
            state["running"] += 1
            state["started"] += 1
        time.sleep(0.01)
        with lock:
            state["running"] -= 1
        return i

    threads_before = set(threading.enumerate())
    stream = L.Stream.from_list(list(range(1000))).map(fn, num_threads=4)
    if prefetch:
        stream = stream.prefetch(2)
    it = iter(stream)
    assert [next(it) for _ in range(5)] == [0, 1, 2, 3, 4]
    t0 = time.perf_counter()
    it.close()
    assert time.perf_counter() - t0 < 5
    started = state["started"]
    assert state["running"] == 0
    assert started < 30  # the in-flight window, not the whole upstream
    time.sleep(0.05)
    assert state["started"] == started
    deadline = time.perf_counter() + 5
    while set(threading.enumerate()) - threads_before and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert not set(threading.enumerate()) - threads_before


# ------------------------------------------------------------------ collation


def test_collate_audio_batch_matches_jax():
    rng = np.random.default_rng(2)
    samples = [{"audio": (0.1 * rng.standard_normal(256 * n + 77)).astype(np.float32),
                "transcript": rng.integers(0, 255, t).astype(np.int32)} for n, t in ((10, 5), (7, 9), (3, 1))]
    got = L.collate_audio_batch(samples, pad_frame_multiple=8)
    assert got["mel_spec"].shape == (3, 16, 100)  # 10 frames pad to 16
    np.testing.assert_array_equal(got["mel_len"], [10, 7, 3])
    assert np.all(got["mel_spec"][1, 7:] == 0.0) and np.any(got["mel_spec"][1, :7] != 0.0)
    _assert_same_batches([got], [JL.collate_audio_batch(samples, pad_frame_multiple=8)])
    _assert_same_batches([L.collate_raw_audio_batch(samples, 8)], [JL.collate_raw_audio_batch(samples, 8)])
    x = np.arange(10.0).reshape(2, 5)
    np.testing.assert_array_equal(L.pad_to_multiple(x, 1, 4, -1.0), JL.pad_to_multiple(x, 1, 4, -1.0))


# ------------------------------------------------------------------ the pipeline


@pytest.mark.parametrize("on_device_mel", [True, False])
def test_pipeline_gives_the_jax_batches(tree, on_device_mel):
    kw = dict(batch_size=3, epochs=2, shuffle_buffer=5, num_threads=3, pad_frame_multiple=FRAMES, seed=3,
              drop_remainder=False, on_device_mel=on_device_mel)
    got = list(L.make_training_pipeline(LT.load_dir(tree, max_duration=30), **kw))
    ref = list(JL.make_training_pipeline(JLT.load_dir(tree, max_duration=30), **kw))
    _assert_same_batches(got, ref)
    assert len({b["mel_len"].shape[0] for b in got}) == 2  # full batches and the remainder
    assert len({(b["audio"] if on_device_mel else b["mel_spec"]).shape[1] for b in got}) >= 2
    assert sum(len(b["mel_len"]) for b in got) == 2 * 14  # 12 + 24-bit + float32 clips


def test_dynamic_batch_pipeline_gives_the_jax_batches(tree):
    def batches(pkg, libritts):
        return list(libritts.load_dir(tree).map(libritts.decode_sample, num_threads=2).dynamic_batch(
            buffer_size=8, max_frames=400, collate=lambda b: pkg.collate_audio_batch(b, FRAMES), seed=1))

    got = batches(L, LT)
    _assert_same_batches(got, batches(JL, JLT))
    assert len({len(b["mel_len"]) for b in got}) >= 2


def test_scan_and_decode_match_jax(tree):
    samples = LT.scan_samples(tree, max_duration=30)
    assert samples == JLT.scan_samples(tree, max_duration=30)
    assert len(LT.scan_samples(tree, max_duration=1.0)) < len(samples)  # the file-size filter
    for s in samples:
        got, ref = LT.decode_sample(s), JLT.decode_sample(s)
        assert (got is None) == (ref is None), s
        if ref is not None:
            assert got["audio"].dtype == np.float32 and got["transcript"].dtype == np.int32
            np.testing.assert_array_equal(got["audio"], ref["audio"])
            np.testing.assert_array_equal(got["transcript"], ref["transcript"])
    dropped = {s["file"].stem for s in samples if LT.decode_sample(s) is None}
    assert dropped == {"rate16k", "broken"}


# ------------------------------------------------------------------ sharding


def test_process_count_and_index_without_a_process_group():
    assert (D.process_count(), D.process_index()) == (1, 0)
    assert D.process_local_batch_slice(6) == slice(0, 6)


def test_process_local_batch_slice(monkeypatch):
    monkeypatch.setattr(D, "process_count", lambda: 4)
    slices = []
    for i in range(4):
        monkeypatch.setattr(D, "process_index", lambda i=i: i)
        slices.append(D.process_local_batch_slice(16))
    assert slices == [slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]
    assert sorted(i for s in slices for i in range(s.start, s.stop)) == list(range(16))


def test_stream_shard_partitions_windows():
    items = list(range(10))  # global batch 4: two full windows, two items dropped
    shards = [list(L.Stream.from_list(items).shard(4, slice(2 * p, 2 * p + 2))) for p in range(2)]
    assert shards == [[0, 1, 4, 5], [2, 3, 6, 7]]
    assert shards == [list(JL.Stream.from_list(items).shard(4, slice(2 * p, 2 * p + 2))) for p in range(2)]


def _clean_tree(tmp_path, n):
    rng = np.random.default_rng(0)
    d = tmp_path / "clips" / "0"
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        write_wav_format(d / f"c{i}.wav", (0.1 * rng.standard_normal(24_000)).astype(np.float32), 24_000)
        (d / f"c{i}.normalized.txt").write_text(f"clip number {i}")
    return tmp_path / "clips"


@pytest.mark.parametrize("on_device_mel", [True, False])
def test_pipeline_shard_by_process_stacks_into_the_jax_global_batches(tree, monkeypatch, on_device_mel):
    """Across mocked process ids, the per-process batches stack back into
    the unsharded global batches of both packages."""
    clean = _clean_tree(tree.parent / f"clean_{on_device_mel}", 8)
    kw = dict(batch_size=4, epochs=1, shuffle_buffer=8, num_threads=1, seed=11, on_device_mel=on_device_mel,
              pad_frame_multiple=FRAMES)
    global_batches = list(L.make_training_pipeline(LT.load_dir(clean), **kw))
    _assert_same_batches(global_batches, list(JL.make_training_pipeline(JLT.load_dir(clean), **kw)))

    monkeypatch.setattr(D, "process_count", lambda: 2)
    local = []
    for p in range(2):
        monkeypatch.setattr(D, "process_index", lambda p=p: p)
        local.append(list(L.make_training_pipeline(LT.load_dir(clean), shard_by_process=True, **kw)))
    assert len(local[0]) == len(local[1]) == len(global_batches)
    stacked = [{k: np.concatenate([l0[k], l1[k]]) for k in l0} for l0, l1 in zip(*local)]
    assert all(len(b["mel_len"]) == 2 for part in local for b in part)
    _assert_same_batches(stacked, global_batches)


def test_pipeline_shard_requires_seed_and_divisibility(tmp_path, monkeypatch):
    root = _clean_tree(tmp_path, 2)
    monkeypatch.setattr(D, "process_count", lambda: 2)
    monkeypatch.setattr(D, "process_index", lambda: 0)
    with pytest.raises(ValueError, match="requires a seed"):
        L.make_training_pipeline(LT.load_dir(root), batch_size=4, shard_by_process=True)
    with pytest.raises(ValueError, match="not divisible"):
        L.make_training_pipeline(LT.load_dir(root), batch_size=5, seed=1, shard_by_process=True)


def test_shard_mode_decode_failure_raises(tmp_path, monkeypatch):
    """Under shard_by_process an undecodable clip raises; without sharding it
    is skipped, as in the JAX package."""
    root = _clean_tree(tmp_path, 4)
    (root / "0" / "c1.wav").write_bytes(b"not a wav file")
    monkeypatch.setattr(D, "process_count", lambda: 1)
    monkeypatch.setattr(D, "process_index", lambda: 0)

    def pipeline(pkg, libritts, **kw):
        return pkg.make_training_pipeline(libritts.load_dir(root), batch_size=2, epochs=1, shuffle_buffer=8,
                                          num_threads=1, seed=11, on_device_mel=True, pad_frame_multiple=64,
                                          **kw)

    with pytest.raises(RuntimeError, match="desynchronize"):
        list(pipeline(L, LT, shard_by_process=True))
    got = list(pipeline(L, LT))
    assert len(got) >= 1  # unsharded: a silent skip
    _assert_same_batches(got, list(pipeline(JL, JLT)))


# ------------------------------------------------------------------ the slice as a whole

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=256, text_dim=32,
            conv_layers=1)


def _jax_draws(key, b, n, cfm=jcfg.CFMConfig()) -> CFMDraws:
    """The draws of JAX `cfm_loss(key)`, split exactly as it splits them."""
    k_frac, k_span, k_x0, k_time, k_adrop, k_tdrop, _ = jax.random.split(key, 7)
    lo, hi = cfm.frac_lengths_mask
    t = lambda a: torch.tensor(np.asarray(a))
    return CFMDraws(
        frac_lengths=t(jax.random.uniform(k_frac, (b,), minval=lo, maxval=hi)),
        span_start=t(jax.random.uniform(k_span, (b,))),
        x0=t(jax.random.normal(k_x0, (b, n, 100), dtype=jnp.float32)),
        time=t(jax.random.uniform(k_time, (b,), dtype=jnp.float32)),
        audio_drop=t(jax.random.uniform(k_adrop, (1,))),
        text_drop=t(jax.random.uniform(k_tdrop, (1,))),
    )


def test_first_pipeline_batch_trains_to_the_jax_loss(tree):
    """The first raw-audio batch of each package's pipeline through each
    package's from-audio train step, with the same parameters and draws."""
    kw = dict(batch_size=2, epochs=1, shuffle_buffer=6, num_threads=2, pad_frame_multiple=FRAMES, seed=5,
              on_device_mel=True)
    batch = next(iter(L.make_training_pipeline(LT.load_dir(tree), **kw)))
    jbatch = next(iter(JL.make_training_pipeline(JLT.load_dir(tree), **kw)))
    _assert_same_batches([batch], [jbatch])
    n = batch["audio"].shape[1] // 256
    text = T.batch_text(batch, n, torch.device("cpu"))
    key = jax.random.key(8)

    jparams = JaxF5TTS.init(jax.random.key(0), jcfg.DiTConfig(**TINY)).params
    jopt = JT.make_optimizer(1e-3, 1e-2, 0, 100)
    _, jloss = jax.jit(JT.make_train_step_from_audio(jcfg.DiTConfig(**TINY), jcfg.CFMConfig(), jopt))(
        JT.init_train_state(jparams, jopt), jnp.asarray(jbatch["audio"]), jnp.asarray(text.numpy()),
        jnp.asarray(jbatch["mel_len"]), key)

    dit = DiT(tcfg.DiTConfig(**TINY))
    dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), dit.cfg))
    opt = T.make_optimizer(1e-3, 1e-2, 0, 100)
    loss = T.make_train_step_from_audio(tcfg.CFMConfig(), opt)(
        T.init_train_state(dit, opt), torch.from_numpy(batch["audio"]), text, torch.from_numpy(batch["mel_len"]),
        draws=_jax_draws(key, 2, n))
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
