"""The PyTorch port's duration-predictor artifacts
(f5_tts_tpu_torch/export.py `export_duration`) on the CPU, at the tiny
width of `tests/test_export_duration.py` (dim 32, depth 2, 2 heads x 16,
text_dim 16, one ConvNeXt block, a 64-frame window).

The JAX predictor's parameters reach the port through `params_from_jax`.
Tolerances: the port's artifact against the JAX package's duration
artifact on the same numpy inputs 1e-4 relative (float32 matmuls, convs
and softmax summed in another order); against the port's live forward
over the same window 1e-6 relative (the same operators; it comes out
equal); external against embedded weights exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu import export as JE
from f5_tts_tpu.config import DurationConfig as JaxDurationConfig
from f5_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor
from f5_tts_tpu_torch import export as E
from f5_tts_tpu_torch.config import DiTConfig, DurationConfig, VocosConfig
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.vocos import Vocos

WINDOW = 64
DUR = dict(dim=32, depth=2, heads=2, dim_head=16, ff_mult=2, text_dim=16, conv_layers=1)


@pytest.fixture(scope="module")
def predictors():
    """The same random tiny predictor in both packages."""
    jax_dp = JaxDurationPredictor.init(jax.random.key(0), JaxDurationConfig(**DUR, use_flash_attention=False))
    rng = np.random.default_rng(1)  # the JAX init leaves GRN gamma/beta at zero
    for blk in jax_dp.params["text_embed"]["blocks"]:
        blk["grn"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)) for k, v in blk["grn"].items()}
    port_dp = DurationPredictor(DurationConfig(**DUR))
    port_dp.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_dp.params), port_dp.cfg))
    return jax_dp, port_dp


@pytest.fixture(scope="module")
def artifacts(predictors, tmp_path_factory):
    """The port's artifact with embedded and with external weights, and the
    JAX package's (embedded)."""
    jax_dp, port_dp = predictors
    tmp = tmp_path_factory.mktemp("duration_artifacts")
    out = {}
    for embed in (True, False):
        p = tmp / f"port_{embed}.bin"
        E.save_duration(E.export_duration(port_dp, padded_len=WINDOW, embed_weights=embed, device="cpu"), p,
                        predictor=port_dp)
        out[embed] = E.load_duration(p, device="cpu") + (str(p),)
    p = tmp / "jax.bin"
    JE.save_duration(JE.export_duration(jax_dp, padded_len=WINDOW), p, predictor=jax_dp)
    out["jax"] = JE.load_duration(p) + (str(p),)
    return out


def _inputs(frames=50, text_len=10):
    rng = np.random.RandomState(3)
    mel = (rng.randn(1, frames, 100) * 0.1).astype(np.float32)
    text = np.full((1, text_len), -1, np.int32)
    text[0, :6] = [5, 6, 7, 8, 9, 10]
    return mel, text


@pytest.mark.parametrize("lens", [None, 50, 10])
def test_port_artifact_matches_the_jax_artifact(artifacts, lens):
    """The same numpy mel, text and lens through the port's artifact and
    the JAX package's: seconds within 1e-4 relative; `lens` changes the
    prediction on both sides alike."""
    port, spec, _ = artifacts[False]
    jax_art, jspec, _ = artifacts["jax"]
    assert (spec.batch, spec.padded_len, spec.mel_dim, spec.text_num_embeds) == \
        (jspec.batch, jspec.padded_len, jspec.mel_dim, jspec.text_num_embeds) == (1, WINDOW, 100, 256)
    mel, text = _inputs()
    kw = {} if lens is None else {"lens": np.array([lens], np.int32)}
    got = float(port.call(*E.prep_duration_inputs(spec, mel, text, **kw))[0])
    ref = float(np.asarray(jax_art.call(*JE.prep_duration_inputs(jspec, mel, text, **kw)))[0])
    assert got == pytest.approx(ref, rel=1e-4) and got > 0


def test_prep_duration_inputs_equal_the_jax_package(artifacts):
    _, spec, _ = artifacts[True]
    _, jspec, _ = artifacts["jax"]
    mel, text = _inputs()
    for kw in ({}, {"lens": np.array([70], np.int32)}, {"lens": np.array([0], np.int32)}):
        got = E.prep_duration_inputs(spec, mel, text, **kw)
        ref = JE.prep_duration_inputs(jspec, mel, text, **kw)
        for g, r in zip(got, ref):
            assert np.asarray(g).dtype == np.asarray(r).dtype
            np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_artifact_matches_live_forward_and_external_equals_embedded(predictors, artifacts):
    """The artifact against the port's live forward over the same window
    (`DurationPredictor.seconds`, which `forward` runs), and the external
    weights flavor against the embedded one, bit for bit."""
    _, port_dp = predictors
    emb, spec, _ = artifacts[True]
    ext, _, _ = artifacts[False]
    assert isinstance(ext, E.BoundSampler) and not isinstance(emb, E.BoundSampler)
    mel, text = _inputs()
    args = E.prep_duration_inputs(spec, mel, text, lens=np.array([37], np.int32))
    a, b = emb.call(*args), ext.call(*args)
    assert torch.equal(a, b)
    live = port_dp(torch.tensor(args[0]), args[1], lens=args[2])
    assert float(a[0]) == pytest.approx(float(live[0]), rel=1e-6)


def test_kind_is_checked_both_ways(artifacts, tmp_path):
    """A duration artifact does not load as a sampler, nor a sampler as a
    duration artifact."""
    _, _, path = artifacts[True]
    with pytest.raises(ValueError, match="duration"):
        E.load_sampler(path, device="cpu")
    g = torch.Generator().manual_seed(0)
    model = F5TTS.init(g, DiTConfig(dim=32, depth=1, heads=2, dim_head=16, ff_mult=2, mel_dim=100,
                                    text_num_embeds=256, text_dim=16, conv_layers=1), device="cpu")
    p = tmp_path / "sampler.bin"
    E.save_sampler(E.export_sampler(model, batch=1, steps=2, method="euler", with_vocoder=False, device="cpu"),
                   p, model=model)
    with pytest.raises(ValueError, match="not a duration artifact"):
        E.load_duration(p, device="cpu")
    with pytest.raises(ValueError, match="save_duration takes a duration export"):
        E.save_duration(E.export_sampler(model, batch=1, steps=2, method="euler", with_vocoder=False,
                                         device="cpu"), tmp_path / "x.bin", predictor=None)


def test_prep_validation(artifacts):
    _, spec, _ = artifacts[True]
    mel, text = _inputs()
    bad = text.copy()
    bad[0, 0] = 256
    with pytest.raises(ValueError, match="out of range"):
        E.prep_duration_inputs(spec, mel, bad)
    with pytest.raises(ValueError, match="exceeds the duration"):
        E.prep_duration_inputs(spec, mel, np.full((1, WINDOW + 8), 3, np.int32))
    with pytest.raises(ValueError, match="does not fit"):
        E.prep_duration_inputs(spec, np.zeros((1, WINDOW + 1, 100), np.float32), text)


def test_cli_duration_export(tmp_path):
    """f5-tts-tpu-torch-export --duration from a snapshot, end to end; a
    snapshot without a predictor errors; --no-flash raises."""
    vocab = {chr(i + 97): i for i in range(26)}
    g = torch.Generator().manual_seed(0)
    cfg = DiTConfig(dim=64, depth=1, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=25, text_dim=32,
                    conv_layers=1)
    dur = DurationPredictor.init(g, DurationConfig(**{**DUR, "text_num_embeds": 25}), device="cpu")
    voc = Vocos.init(g, VocosConfig(dim=32, intermediate_dim=64, num_layers=1), device="cpu")
    model = F5TTS.init(g, cfg, device="cpu", vocab_char_map=vocab, duration_predictor=dur, vocoder=voc)
    snap = tmp_path / "snap"
    model.save_pretrained(snap)
    out = tmp_path / "dur.bin"
    E.main(["--model", str(snap), "--out", str(out), "--duration", "--padded-len", str(WINDOW),
            "--external-weights", "--device", "cpu"])
    loaded, spec = E.load_duration(out, device="cpu")
    assert (spec.padded_len, spec.text_num_embeds) == (WINDOW, 25)
    mel, text = _inputs(text_len=8)
    assert float(loaded.call(*E.prep_duration_inputs(spec, mel, np.clip(text, -1, 24)))[0]) > 0
    with pytest.raises(ValueError, match="no-flash"):
        E.main(["--model", str(snap), "--out", str(out), "--duration", "--no-flash", "--device", "cpu"])
    with pytest.raises(ValueError, match="no-flash"):
        E.export_duration(dur, padded_len=WINDOW, use_flash=False, device="cpu")

    F5TTS.init(g, cfg, device="cpu", vocab_char_map=vocab, vocoder=voc).save_pretrained(tmp_path / "snap2")
    with pytest.raises(SystemExit):
        E.main(["--model", str(tmp_path / "snap2"), "--out", str(out), "--duration", "--device", "cpu"])
