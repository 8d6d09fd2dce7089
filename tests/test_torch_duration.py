"""The PyTorch port's duration predictor against the JAX package, on the CPU
in float32 at a tiny width (dim 64, depth 2, 2 heads x 32, text_dim 32, one
ConvNeXt block).

JAX parameters come from `DurationPredictor.init` and reach the port through
`params_from_jax`; inputs are made with numpy from a seed. Tolerances: 1e-5
for the norms, 1e-4 for the predicted seconds (two blocks of float32 matmuls,
convs and softmax summed in another order), 1e-3 for the wave of a sample
whose duration the predictor set; durations in frames are integers and must
be equal.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu import config as jcfg
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor
from f5_tts_tpu.models.vocos import Vocos as JaxVocos
from f5_tts_tpu.utils import masks as jmasks
from f5_tts_tpu.utils import modules as jm
from f5_tts_tpu_torch import config as tcfg
from f5_tts_tpu_torch.audio.mel import log_mel_spectrogram
from f5_tts_tpu_torch.models.cfm import F5TTS, clamp_duration
from f5_tts_tpu_torch.models.convert import convert_duration_state, params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.utils import masks as tmasks
from f5_tts_tpu_torch.utils import modules as tm

DIT = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
           text_num_embeds=256, text_dim=32, conv_layers=1)
DUR = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32, conv_layers=1)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
VOCAB = {c: i for i, c in enumerate([""] + [chr(c) for c in range(ord(" "), ord(" ") + 95)])}
MANIFESTS = Path(__file__).parent / "manifests"


def _close(t: torch.Tensor, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def test_config_matches_jax():
    for name in ("AudioConfig", "DiTConfig", "DurationConfig", "CFMConfig", "VocosConfig"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)()), name
    assert dataclasses.asdict(tcfg.DURATION_V2) == dataclasses.asdict(jcfg.DURATION_V2)


def test_rms_norm_and_masked_mean():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    _close(tm.rms_norm(torch.tensor(x), torch.tensor(scale)), jm.rms_norm(x, {"scale": scale}), 1e-5)
    mask = np.array([[True] * 4 + [False] * 3, [False] * 7])
    for m in (None, mask):
        _close(tmasks.maybe_masked_mean(torch.tensor(x), None if m is None else torch.tensor(m)),
               jmasks.maybe_masked_mean(x, None if m is None else jnp.asarray(m)), 1e-6)


@pytest.fixture(scope="module")
def predictors():
    jax_dp = JaxDurationPredictor.init(jax.random.key(3), jcfg.DurationConfig(**DUR), vocab_char_map=VOCAB)
    rng = np.random.default_rng(1)  # the JAX init leaves GRN gamma/beta at zero
    for blk in jax_dp.params["text_embed"]["blocks"]:
        blk["grn"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
                      for k, v in blk["grn"].items()}
    port_dp = DurationPredictor(tcfg.DurationConfig(**DUR))
    port_dp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_dp.params), port_dp.cfg))
    return jax_dp, port_dp


def _inputs(n_mel, n_text, seed):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((2, n_mel, 100)).astype(np.float32)
    text = rng.integers(0, 96, (2, n_text)).astype(np.int32)
    text[1, n_text // 2:] = -1
    return mel, text


@pytest.mark.parametrize("case", ["no lens", "lens", "text longer than mel"])
def test_duration_forward_matches_jax(predictors, case):
    jax_dp, port_dp = predictors
    mel, text = _inputs(10 if case == "text longer than mel" else 40, 30, seed=2)
    lens = np.array([40, 23]) if case == "lens" else None
    ref = jax_dp(jnp.asarray(mel), jnp.asarray(text), lens=None if lens is None else jnp.asarray(lens))
    got = port_dp(mel, text, lens=lens)
    assert got.shape == (2,) and got.dtype == torch.float32
    _close(got, ref, 1e-4)


def test_duration_forward_from_raw_wave(predictors):
    jax_dp, port_dp = predictors
    rng = np.random.default_rng(4)
    wave = (0.1 * rng.standard_normal((1, 24_000 // 4))).astype(np.float32)
    text = rng.integers(0, 96, (1, 12)).astype(np.int32)
    _close(port_dp(wave, text), jax_dp(jnp.asarray(wave), jnp.asarray(text)), 1e-4)


@pytest.fixture(scope="module")
def models(predictors):
    """A tiny F5TTS with the duration predictor in both packages."""
    jax_dp, port_dp = predictors
    jax_model = JaxF5TTS.init(
        jax.random.key(0), jcfg.DiTConfig(**DIT), cfm_cfg=jcfg.CFMConfig(duration_bucket=64),
        vocab_char_map=VOCAB, vocoder=JaxVocos.init(jax.random.key(1), jcfg.VocosConfig(**VOCOS)).decode,
        duration_predictor=jax_dp,
    )
    dit = DiT(tcfg.DiTConfig(**DIT))
    dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_model.params), dit.cfg))
    vocos = Vocos(tcfg.VocosConfig(**VOCOS))
    vocos.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jax_model._vocoder.__self__.params), vocos.cfg))
    port = F5TTS(dit, dit.cfg, cfm_cfg=tcfg.CFMConfig(duration_bucket=64), vocab_char_map=VOCAB,
                 vocoder=vocos, duration_predictor=port_dp)
    return jax_model, port


@pytest.mark.parametrize("speed", [1.0, 0.3])
def test_predict_duration_matches_jax(models, speed):
    """Frames = seconds * (sample_rate // hop_length) / speed, truncated."""
    jax_model, port = models
    mel, text = _inputs(40, 30, seed=5)
    for lens in (None, np.array([40, 17])):
        ref = jax_model.predict_duration(jnp.asarray(mel), jnp.asarray(text), speed,
                                         lens=None if lens is None else jnp.asarray(lens))
        got = port.predict_duration(mel, text, speed, lens=lens)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("speed", [1.0, 0.25])
def test_sample_without_duration_matches_jax(models, speed):
    """`sample(duration=None)` on a raw reference wave: the predictor's
    duration, clamped, sets the wave's length; the same y0 on both sides."""
    jax_model, port = models
    sr = 24_000
    rng = np.random.default_rng(6)
    wave = (0.1 * np.sin(2 * np.pi * 220 * np.arange(sr // 2) / sr)
            + 0.01 * rng.standard_normal(sr // 2)).astype(np.float32)
    # the noise covers the clamped duration, which the predictor sets
    mel = log_mel_spectrogram(torch.tensor(wave))
    ids = port._tokenize(["hello there"])
    frames = int(clamp_duration(port.predict_duration(mel, ids, speed), [mel.shape[1]], [ids.shape[1]], 4096)[0])
    if speed < 1:  # the slower speed lies above the clamp
        assert frames > mel.shape[1] + 1
    y0 = rng.standard_normal((1, frames, 100)).astype(np.float32)
    kw = dict(steps=3, method="euler", cfg_strength=2.0, speed=speed)
    ref_wave, _ = jax_model.sample(jnp.asarray(wave)[None], ["hello there"], y0=jnp.asarray(y0), **kw)
    got_wave, _ = port.sample(wave[None], ["hello there"], y0=y0, **kw)
    assert got_wave.shape == ref_wave.shape == ((frames - 1) * 256,)
    _close(got_wave, ref_wave, 1e-3)


def test_sample_without_duration_or_predictor_raises(models):
    _, port = models
    bare = F5TTS(port.dit, port.dit_cfg, vocab_char_map=VOCAB)
    with pytest.raises(ValueError, match="duration predictor"):
        bare.sample(np.zeros((1, 10, 100), np.float32), ["hi"], steps=2)


def test_duration_snapshot_round_trip(models, tmp_path):
    """JAX save_pretrained -> the port's from_pretrained carries the
    predictor and its config; the port's save_pretrained writes the same
    duration_v2.safetensors back, and JAX's from_pretrained reads it."""
    from safetensors.numpy import load_file as ref_load

    from f5_tts_tpu_torch.utils.safetensors import load_file

    jax_model, port = models
    jax_model.save_pretrained(tmp_path / "jax")
    loaded = F5TTS.from_pretrained(tmp_path / "jax", device="cpu")
    assert loaded.duration_predictor.cfg == port.duration_predictor.cfg
    sa, sb = loaded.duration_predictor.state_dict(), port.duration_predictor.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)
    loaded.save_pretrained(tmp_path / "port")
    ours = load_file(tmp_path / "port" / "duration_v2.safetensors")
    theirs = ref_load(str(tmp_path / "jax" / "duration_v2.safetensors"))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    back = JaxF5TTS.from_pretrained(str(tmp_path / "port"))
    assert back._duration_predictor.cfg == jax_model._duration_predictor.cfg
    for a, b in zip(jax.tree.leaves(back._duration_predictor.params),
                    jax.tree.leaves(jax_model._duration_predictor.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_published_duration_manifest_loads():
    """A zero-filled dict with the names and shapes of the published
    duration_v2.safetensors converts at the published width (DURATION_V2,
    the published vocab's 2545 symbols), every key consumed."""
    from manifests.gen_manifests import parse

    manifest = parse((MANIFESTS / "duration_v2.txt").read_text())
    raw = {k: np.zeros(shape, np.float32) for k, (shape, _) in manifest.items()}
    cfg = tcfg.DURATION_V2.replace(text_num_embeds=2545)
    state = convert_duration_state(raw, cfg)
    with torch.device("meta"):
        ref = DurationPredictor(cfg).state_dict()
    assert sorted(state) == sorted(ref)
    for k, v in state.items():
        assert v.shape == ref[k].shape, k
    with pytest.raises(ValueError, match="unconsumed"):
        convert_duration_state({**raw, "transformer.extra.weight": np.zeros(1)}, cfg)
