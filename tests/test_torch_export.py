"""The PyTorch port's sampler artifacts (f5_tts_tpu_torch/export.py) on the
CPU, at the tiny width of `tests/test_export.py` (dim 64, depth 2, 2 heads
x 32, text_dim 32, one ConvNeXt block, 64-frame buckets) with a tiny Vocos.

The JAX parameters come from `F5TTS.init` and reach the port through
`params_from_jax`. Tolerances: an artifact against the port's live
`F5TTS.sample` at the same seed 1e-5 (the program runs the same aten
operators on the same noise; it comes out equal); against the JAX package's
live sampler fed the port's noise as y0 1e-3 (`tests/test_torch_model.py`'s
pipeline tolerance); external weights against embedded weights exactly.
The registered operators are held to torch.library.opcheck.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu import export as JE
from f5_tts_tpu.config import CFMConfig as JaxCFMConfig
from f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from f5_tts_tpu.config import VocosConfig as JaxVocosConfig
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.vocos import Vocos as JaxVocos
from f5_tts_tpu_torch import export as E
from f5_tts_tpu_torch.config import AudioConfig, CFMConfig, DiTConfig, VocosConfig
from f5_tts_tpu_torch.models.cfm import F5TTS, cfm_sample_e2e
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.quant import quantize_module_
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.ops import flash_attention as fa
from f5_tts_tpu_torch.ops import qmatmul as qm
from f5_tts_tpu_torch.ops import w8a8 as w8
from f5_tts_tpu_torch.utils.sampling import draw_noise, sway_time_grid

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
            text_num_embeds=256, text_dim=32, conv_layers=1)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
HOP = 256
STEPS = 3  # the fixture's artifacts: two intervals of each method
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    """The same random tiny model in both packages (byte tokenizer)."""
    jax_model = JaxF5TTS.init(
        jax.random.key(0), JaxDiTConfig(**TINY, use_flash_attention=False),
        cfm_cfg=JaxCFMConfig(duration_bucket=64), vocab_char_map=None,
        vocoder=JaxVocos.init(jax.random.key(1), JaxVocosConfig(**VOCOS)).decode,
    )
    dit = DiT(DiTConfig(**TINY))
    dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_model.params), DiTConfig(**TINY)))
    vocos = Vocos(VocosConfig(**VOCOS))
    vocos.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jax_model._vocoder.__self__.params), VocosConfig(**VOCOS)))
    port = F5TTS(dit, DiTConfig(**TINY), cfm_cfg=CFMConfig(duration_bucket=64), vocoder=vocos)
    return jax_model, port


def _inputs(batch=2, frames=20, text_len=12):
    rng = np.random.RandomState(0)
    cond = (rng.randn(batch, frames, 100) * 0.1).astype(np.float32)
    text = np.full((batch, text_len), -1, np.int32)
    text[0, :5] = [5, 6, 7, 8, 9]
    if batch > 1:
        text[1, :3] = [1, 2, 3]
    return cond, text


def _save_load(model, path, *, extra_meta=None, **kw):
    exp = E.export_sampler(model, device="cpu", **kw)
    E.save_sampler(exp, path, model=model, extra_meta=extra_meta)
    return E.load_sampler(path, device="cpu")


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """batch 2, 3 steps, external weights, one per method; the RK4 one also
    with embedded weights."""
    _, port = models
    tmp = tmp_path_factory.mktemp("port_artifacts")
    out = {m: _save_load(port, tmp / f"{m}.bin", batch=2, steps=STEPS, method=m, embed_weights=False)
           + (str(tmp / f"{m}.bin"),) for m in ("euler", "midpoint", "rk4")}
    out["rk4-embedded"] = (_save_load(port, tmp / "rk4e.bin", batch=2, steps=STEPS, method="rk4")
                           + (str(tmp / "rk4e.bin"),))
    return out


def _live(model, cond, text, duration, steps, method, seed):
    return model.sample(cond, text, duration=duration, steps=steps, method=method, cfg_strength=2.0,
                        sway_sampling_coef=-1.0, seed=seed, return_trajectory=False)[0]


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_artifact_matches_live_sample(models, artifacts, method):
    """The artifact at seed 7 against `F5TTS.sample(seed=7)` (the live
    `cfm_sample_e2e`): the wave within 1e-5, the mel zeroed past max_dur."""
    _, port = models
    sampler, spec, _ = artifacts[method]
    assert isinstance(sampler, E.BoundSampler)
    assert (spec.batch, spec.padded_len, spec.steps, spec.mel_dim) == (2, 64, STEPS, 100)
    cond, text = _inputs()
    args = E.prep_inputs(spec, cond, text, 48, seed=7)
    mel, wave = sampler.call(*args)
    max_dur = int(args[3])
    live = _live(port, cond, text, 48, STEPS, method, 7)
    np.testing.assert_allclose(wave[:, :(max_dur - 1) * HOP].numpy(), live.numpy(), atol=1e-5, rtol=0)
    assert mel.shape == (2, 64, 100) and not mel[:, max_dur:].any()


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_artifact_matches_jax_live_sampler(models, artifacts, method):
    """The port's artifact against the JAX package's live sampler fed the
    artifact's noise (the seed's shared draw) as y0: mel and wave within
    1e-3."""
    jax_model, _ = models
    sampler, spec, _ = artifacts[method]
    cond, text = _inputs()
    args = E.prep_inputs(spec, cond, text, 48, seed=7)
    mel, wave = sampler.call(*args)
    y0 = draw_noise(7, True, 2, 64, 100, "cpu").numpy()
    ref_wave, ref_traj = jax_model.sample(jnp.asarray(cond), jnp.asarray(text), duration=48, steps=STEPS,
                                          method=method, cfg_strength=2.0, sway_sampling_coef=-1.0,
                                          y0=jnp.asarray(y0), return_trajectory=False)
    max_dur = int(args[3])
    np.testing.assert_allclose(wave[:, :(max_dur - 1) * HOP].numpy(), np.asarray(ref_wave), atol=1e-3, rtol=0)
    ref_mel = np.where(np.arange(max_dur)[None, :, None] < args[1][:, None, None], args[0][:, :max_dur],
                       np.asarray(ref_traj)[-1])
    np.testing.assert_allclose(mel[:, :max_dur].numpy(), ref_mel, atol=1e-3, rtol=0)


def test_prep_inputs_equal_the_jax_package(artifacts):
    """`prep_inputs` gives the JAX package's arrays for the same spec and
    request: the padded cond and text, the clamped lens and durations,
    max_dur, the sway grid and the seed."""
    _, spec, _ = artifacts["euler"]
    jspec = JE.SamplerSpec(batch=2, padded_len=64, steps=STEPS, mel_dim=100, text_num_embeds=256)
    cond, text = _inputs()
    for duration, kw in ((48, {}), (np.array([30, 50]), {"lens": np.array([10, 25])}),
                         (40, {"sway_sampling_coef": None, "seed": 3})):
        got = E.prep_inputs(spec, cond, text, duration, **kw)
        ref = JE.prep_inputs(jspec, cond, text, duration, **kw)
        assert len(got) == len(ref) == 7
        for g, r in zip(got, ref):
            g = np.asarray(g)
            assert g.dtype == np.asarray(r).dtype
            np.testing.assert_array_equal(g, np.asarray(r))


def test_dynamic_max_dur_one_artifact_many_durations(models, artifacts):
    """One artifact (one bucket) serves every duration that fits it."""
    _, port = models
    sampler, spec, _ = artifacts["euler"]
    cond, text = _inputs()
    for dur in (30, 56, 64):
        args = E.prep_inputs(spec, cond, text, dur, seed=3)
        _, wave = sampler.call(*args)
        live = _live(port, cond, text, dur, STEPS, "euler", 3)
        np.testing.assert_allclose(wave[:, :(dur - 1) * HOP].numpy(), live.numpy(), atol=1e-5, rtol=0)


def test_external_weights_equal_embedded(artifacts):
    """The RK4 artifact with its weights as an input equals the one with
    them in the program, bit for bit; the device tensor a prep gives (the
    artifact server's mel) equals the numpy one."""
    ext, spec, _ = artifacts["rk4"]
    emb, espec, _ = artifacts["rk4-embedded"]
    assert spec == espec and isinstance(emb, E.LoadedProgram) and not isinstance(emb, E.BoundSampler)
    cond, text = _inputs()
    args = E.prep_inputs(spec, cond, text, 48, seed=11)
    targs = E.prep_inputs(spec, torch.tensor(cond), text, 48, seed=11)
    assert isinstance(targs[0], torch.Tensor) and np.array_equal(targs[0].numpy(), args[0])
    for a, b in zip(ext.call(*args), emb.call(*targs)):
        assert torch.equal(a, b)


def test_w8a8_artifact_equals_live_w8a8_and_external_equals_embedded(models, tmp_path):
    """int8_compute bakes the W8A8 linears into the program, which then
    calls the registered quantize_rows and rescale_bias operators and
    torch._int_mm; it equals the live W8A8 sampler, and its external
    weights equal its embedded ones bit for bit."""
    _, port = models
    m8 = F5TTS(port.dit, port.dit_cfg.replace(int8_compute=True), cfm_cfg=port.cfm_cfg, vocoder=port.vocoder)
    ext, spec = _save_load(m8, tmp_path / "w8e.bin", batch=2, steps=2, method="euler", embed_weights=False)
    emb, _ = _save_load(m8, tmp_path / "w8.bin", batch=2, steps=2, method="euler")
    targets = {str(n.target) for n in emb.program.graph.nodes}
    assert {"f5_tts_tpu_torch.quantize_rows.default", "f5_tts_tpu_torch.rescale_bias.default",
            "aten._int_mm.default"} <= targets
    cond, text = _inputs()
    args = E.prep_inputs(spec, cond, text, 48, seed=11)
    mel_e, wave_e = ext.call(*args)
    mel_b, wave_b = emb.call(*args)
    assert torch.equal(mel_e, mel_b) and torch.equal(wave_e, wave_b)
    live = _live(m8, cond, text, 48, 2, "euler", 11)
    np.testing.assert_allclose(wave_e[:, :47 * HOP].numpy(), live.numpy(), atol=1e-5, rtol=0)
    assert not torch.equal(live, _live(port, cond, text, 48, 2, "euler", 11))


def test_int4_model_exports_through_the_k3_operator(tmp_path):
    """A weight-only int4 DiT (dim 64, so its linears are quantizable)
    exports its quantized linears as the registered qmatmul operator and
    equals its live sampler."""
    g = torch.Generator().manual_seed(0)
    cfg = DiTConfig(**{**TINY, "text_dim": 64})
    model = F5TTS.init(g, cfg, device="cpu", cfm_cfg=CFMConfig(duration_bucket=64),
                       vocoder=Vocos.init(g, VocosConfig(**VOCOS), device="cpu"))
    quantize_module_(model.dit, 4)
    sampler, spec = _save_load(model, tmp_path / "q4.bin", batch=1, steps=2, method="midpoint",
                               embed_weights=False)
    n_k3 = sum(str(n.target) == "f5_tts_tpu_torch.qmatmul.default" for n in sampler.program.graph.nodes)
    assert n_k3 > 0
    cond, text = _inputs(batch=1)
    args = E.prep_inputs(spec, cond, text, 40, seed=2)
    _, wave = sampler.call(*args)
    live = _live(model, cond, text, 40, 2, "midpoint", 2)
    np.testing.assert_allclose(wave[0, :39 * HOP].numpy(), live.numpy(), atol=1e-5, rtol=0)


def test_mel_only_artifact(models, tmp_path):
    """with_vocoder=False: the program returns the mel alone, and its
    external weights leave the vocoder's out."""
    _, port = models
    sampler, spec = _save_load(port, tmp_path / "mel.bin", batch=1, steps=2, method="midpoint",
                               with_vocoder=False, embed_weights=False)
    assert len(sampler.program.graph_signature.user_outputs) == 1
    assert not any(k.startswith("vocoder.") for k in sampler._weights()[0])
    cond, text = _inputs(batch=1)
    args = E.prep_inputs(spec, cond, text, 32, seed=0)
    mel = sampler.call(*args)
    novoc = F5TTS(port.dit, port.dit_cfg, cfm_cfg=port.cfm_cfg)
    live = novoc.sample(cond, text, duration=32, steps=2, method="midpoint", seed=0, return_trajectory=False)[0]
    np.testing.assert_allclose(mel[:, :32].numpy(), live.numpy(), atol=1e-5, rtol=0)


def test_tensor_grid_integrates_to_the_numpy_grids_bits(models):
    """The live sampler keeps its numpy time grid and int max_dur; the
    traced program's tensor grid and 0-d max_dur give the same bits on the
    CPU (each step's dt, dt/2, dt/6 and stage times round alike)."""
    _, port = models
    cond = torch.tensor(np.pad(_inputs()[0], ((0, 0), (0, 44), (0, 0))))
    text = torch.tensor(np.pad(_inputs()[1], ((0, 0), (0, 52)), constant_values=-1))
    lens, dur = torch.tensor([20, 20], dtype=torch.int32), torch.tensor([48, 40], dtype=torch.int32)
    ts = sway_time_grid(5, -1.0)
    y0 = draw_noise(1, True, 2, 64, 100, "cpu")
    for method in ("euler", "midpoint", "rk4"):
        kw = dict(method=method, cfg_strength=2.0, return_trajectory=True, shared_noise=True)
        with torch.no_grad():
            a = cfm_sample_e2e(port.dit, cond, lens, dur, 48, text, ts, y0, 0, port.vocoder, **kw)
            b = cfm_sample_e2e(port.dit, cond, lens, dur, torch.tensor(48, dtype=torch.int32), text,
                               torch.tensor(ts), y0, 0, port.vocoder, **kw)
        for x, y in zip(a, b):
            assert torch.equal(x, y), method


def test_use_flash_false_is_refused(models, tmp_path):
    """The JAX package's use_flash=False / --no-flash has no use in the
    port (its operators dispatch on the inputs' device) and must not be
    ignored silently: it raises."""
    _, port = models
    with pytest.raises(ValueError, match="no-flash"):
        E.export_sampler(port, batch=1, steps=2, use_flash=False, device="cpu")
    with pytest.raises(ValueError, match="no-flash"):
        E.main(["--model", str(tmp_path), "--out", str(tmp_path / "x.bin"), "--no-flash", "--device", "cpu"])


def test_export_cli_from_snapshot(models, tmp_path):
    """f5-tts-tpu-torch-export --model SNAPSHOT builds a loadable artifact
    from a save_pretrained directory, with the method and CFG strength in
    its header."""
    _, port = models
    snap = tmp_path / "snap"
    port.save_pretrained(snap)
    out = tmp_path / "sampler.bin"
    E.main(["--model", str(snap), "--out", str(out), "--batch", "1", "--steps", "2", "--method", "euler",
            "--external-weights", "--device", "cpu"])
    sampler, spec = E.load_sampler(out, device="cpu")
    assert (spec.batch, spec.padded_len, spec.steps, spec.method, spec.cfg_strength) == (1, 64, 2, "euler", 2.0)
    cond, text = _inputs(batch=1)
    _, wave = sampler.call(*E.prep_inputs(spec, cond, text, 48, seed=5))
    assert torch.isfinite(wave).all()


def test_header_carries_audio_constants(tmp_path):
    """A non-default AudioConfig's constants reach the spec, and the
    bucket and mel width come from the program's input shapes."""
    g = torch.Generator().manual_seed(0)
    cfg = DiTConfig(dim=32, depth=1, heads=2, dim_head=16, ff_mult=2, mel_dim=80, text_num_embeds=64,
                    text_dim=16, conv_layers=1)
    model = F5TTS.init(g, cfg, device="cpu", cfm_cfg=CFMConfig(duration_bucket=32, max_duration=2048),
                       audio_cfg=AudioConfig(sample_rate=22_050, hop_length=240, n_mels=80))
    _, spec = _save_load(model, tmp_path / "s.bin", batch=1, steps=2, method="euler", with_vocoder=False)
    assert (spec.hop_length, spec.sample_rate, spec.max_duration, spec.text_num_embeds) == (240, 22_050, 2048, 64)
    assert (spec.padded_len, spec.mel_dim) == (32, 80)


def _rewrite_header(src, dst, edit):
    blob = open(src, "rb").read()
    n = int.from_bytes(blob[4:8], "little")
    header = edit(json.loads(blob[8:8 + n]))
    enc = json.dumps(header).encode()
    with open(dst, "wb") as f:
        f.write(blob[:4] + len(enc).to_bytes(4, "little") + enc + blob[8 + n:])


def test_header_versioning_extra_meta_and_reserved_keys(models, artifacts, tmp_path):
    """A future header format raises; unknown header keys are ignored;
    extra_meta's SamplerSpec fields surface on load; keys the loader
    derives or the exporter writes are refused at save time; without
    model= the save warns and the spec skips the vocabulary check."""
    _, port = models
    _, _, path = artifacts["rk4-embedded"]
    _rewrite_header(path, tmp_path / "v2.bin", lambda h: {**h, "format": 2})
    with pytest.raises(ValueError, match="format 2"):
        E.load_sampler(tmp_path / "v2.bin", device="cpu")
    _rewrite_header(path, tmp_path / "extra.bin", lambda h: {**h, "hop_length": 128, "some_future_key": [1]})
    _, spec = E.load_sampler(tmp_path / "extra.bin", device="cpu")
    assert spec.hop_length == 128

    exp = E.export_sampler(port, batch=1, steps=2, method="euler", with_vocoder=False, device="cpu")
    E.save_sampler(exp, tmp_path / "m.bin", model=port,
                   extra_meta={"method": "euler", "cfg_strength": 1.5, "some_future_field": [1]})
    _, spec = E.load_sampler(tmp_path / "m.bin", device="cpu")
    assert (spec.method, spec.cfg_strength) == ("euler", 1.5)
    for key in ("steps", "weights", "kind", "device", "shared_noise"):
        with pytest.raises(ValueError, match="reserved"):
            E.save_sampler(exp, tmp_path / "x.bin", model=port, extra_meta={key: 1})
    with pytest.warns(UserWarning, match="without model="):
        E.save_sampler(exp, tmp_path / "nomodel.bin")
    _, spec = E.load_sampler(tmp_path / "nomodel.bin", device="cpu")
    assert spec.text_num_embeds is None and spec.hop_length == 256


def test_prep_inputs_validation_and_vocab_range(artifacts):
    _, spec, _ = artifacts["euler"]
    assert spec.text_num_embeds == 256
    cond, text = _inputs()
    with pytest.raises(ValueError, match="does not fit"):
        E.prep_inputs(spec, cond[:1], text, 48)
    with pytest.raises(ValueError, match="exceeds artifact bucket"):
        E.prep_inputs(spec, cond, text, 200)
    with pytest.raises(ValueError, match="does not fit"):
        E.prep_inputs(spec, np.zeros((2, 100, 100), np.float32), text, 48)
    bad = text.copy()
    bad[0, 0] = 999
    with pytest.raises(ValueError, match="out of range"):
        E.prep_inputs(spec, cond, bad, 48)


def test_device_is_recorded_and_a_move_must_be_named(artifacts, tmp_path):
    """An artifact exported on the CPU does not load onto the card by
    default (the refusal comes before any device is touched), loads where it
    was exported with device="cpu", and `embed_weights=False` needs the
    model at save time."""
    _, _, path = artifacts["euler"]
    seen = {}
    _rewrite_header(path, os.devnull, lambda h: seen.update(h) or h)
    assert seen["device"] == "cpu" and seen["shared_noise"] is True
    with pytest.raises(ValueError, match="exported for cpu"):
        E.load_sampler(path)
    ext = E.export_sampler(_tiny_port(), batch=1, steps=2, method="euler", embed_weights=False, device="cpu")
    with pytest.raises(ValueError, match="needs model="):
        E.save_sampler(ext, tmp_path / "x.bin")


def _tiny_port():
    g = torch.Generator().manual_seed(3)
    return F5TTS.init(g, DiTConfig(**TINY), device="cpu", cfm_cfg=CFMConfig(duration_bucket=64),
                      vocoder=Vocos.init(g, VocosConfig(**VOCOS), device="cpu"))


def test_artifact_formats_refuse_each_other(models, artifacts, tmp_path):
    """The JAX package's F5X1 artifact is a StableHLO program, the port's
    F5T1 one a torch.export program: each loader refuses the other's file
    with an error, and the port's says which package wrote it."""
    jax_model, _ = models
    jexp = JE.export_sampler(jax_model, batch=1, steps=2, method="euler", with_vocoder=False)
    JE.save_sampler(jexp, tmp_path / "jax.bin", model=jax_model)
    with pytest.raises(ValueError, match="JAX package artifact"):
        E.load_sampler(tmp_path / "jax.bin", device="cpu")
    with pytest.raises(Exception):
        JE.load_sampler(artifacts["euler"][2])
    (tmp_path / "junk.bin").write_bytes(b"PK\x03\x04 not an artifact")
    with pytest.raises(ValueError, match="F5T1"):
        E.load_sampler(tmp_path / "junk.bin", device="cpu")


def test_kind_is_checked_both_ways(artifacts):
    _, _, path = artifacts["euler"]
    with pytest.raises(ValueError, match="not a duration artifact"):
        E.load_duration(path, device="cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("case", ["plain", "mask-rope", "lse", "bf16-mask-rope-lse"])
def test_flash_attention_operator_passes_opcheck(case):
    """K1's operator: schema, fake version (shape, dtype and q's strides of
    a strided q; the lse [b, h, n] or an empty [0]) and the CPU body."""
    g = _gen()
    dtype = torch.bfloat16 if case.startswith("bf16") else torch.float32
    b, h, n, d = 2, 2, 37, 32
    q = torch.randn(b, n, h * d, generator=g).to(dtype).view(b, n, h, d).transpose(1, 2)
    k, v = (torch.randn(b, h, n, d, generator=g).to(dtype) for _ in range(2))
    mask = cos = sin = None
    if "mask" in case:
        mask = torch.arange(n)[None] < torch.tensor([n, 20])[:, None]
        ang = torch.rand(n, d, generator=g)
        cos, sin = torch.cos(ang), torch.sin(ang)
    lse = "lse" in case
    args = (q, k, v, 0.2, mask, cos, sin, lse)
    torch.library.opcheck(fa.flash_attention_fwd, args)
    out, got_lse = torch.ops.f5_tts_tpu_torch.flash_attention_fwd(*args)
    assert out.stride() == q.stride()
    assert torch.equal(out, fa.flash_attention_plain(q, k, v, 0.2, mask, None if cos is None else (cos, sin)))
    assert got_lse.shape == ((b, h, n) if lse else (0,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_qmatmul_operator_passes_opcheck(dtype, with_bias):
    g = _gen(1)
    n, k = 48, 128
    q = torch.randint(-8, 8, (n, k), generator=g, dtype=torch.int8)
    scales, biases = (torch.rand(n, k // 64, generator=g).to(dtype) for _ in range(2))
    bias = torch.randn(n, generator=g).to(dtype) if with_bias else None
    for x in (torch.randn(5, k, generator=g).to(dtype), torch.randn(2, 3, k, generator=g).to(dtype)):
        torch.library.opcheck(qm.qmatmul_op, (x, q, scales, biases, bias))
        assert torch.equal(qm.qmatmul(x, q, scales, biases, bias), qm.qmatmul_plain(x, q, scales, biases, bias))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_w8a8_operators_pass_opcheck(dtype):
    """quantize_rows with m <= 16 padded to 32 rows (zero codes) and
    unpadded; rescale_bias with and without a bias."""
    g = _gen(2)
    for m, rows in ((5, 32), (20, 20)):
        x = torch.randn(m, 64, generator=g).to(dtype)
        torch.library.opcheck(w8.quantize_rows_op, (x, rows))
        codes, sx = w8.quantize_rows(x, rows)
        ref_codes, ref_sx = w8.quantize_rows_plain(x)
        assert codes.shape == (rows, 64) and torch.equal(codes[:m], ref_codes) and torch.equal(sx[:m], ref_sx)
        assert not codes[m:].any()
    acc = torch.randint(-5000, 5000, (7, 24), generator=g, dtype=torch.int32)
    sx, scale = torch.rand(7, generator=g), torch.rand(24, generator=g)
    for bias in (None, torch.randn(24, generator=g).to(dtype)):
        torch.library.opcheck(w8.rescale_bias_op, (acc, sx, scale, bias, dtype))
        assert torch.equal(w8.rescale_bias(acc, sx, scale, bias, dtype),
                           w8.rescale_bias_plain(acc, sx, scale, bias, dtype))


def test_loading_and_calling_needs_no_model_code(artifacts):
    """A fresh process loads the artifact and calls it with export.py
    alone: models/cfm.py, dit.py and duration.py stay unimported, no
    snapshot file is opened, and the wave equals this process's to the
    bit."""
    sampler, spec, path = artifacts["rk4"]
    cond, text = _inputs()
    args = E.prep_inputs(spec, cond, text, 48, seed=7)
    want = sampler.call(*args)[1].numpy()
    script = f"""
import sys, numpy as np
opened = []
sys.addaudithook(lambda ev, a: opened.append(str(a[0])) if ev == "open" else None)
from f5_tts_tpu_torch import export as E
s, spec = E.load_sampler({path!r}, device="cpu")
args = E.prep_inputs(spec, np.load(sys.argv[1]), np.load(sys.argv[2]), 48, seed=7)
np.save(sys.argv[3], s.call(*args)[1].numpy())
loaded = [m for m in ("f5_tts_tpu_torch.models.cfm", "f5_tts_tpu_torch.models.dit",
                      "f5_tts_tpu_torch.models.duration") if m in sys.modules]
snap = [p for p in opened if p.endswith((".safetensors", "config.json", "vocab.txt"))]
print("MODULES", loaded, "SNAPSHOT", snap)
"""
    d = os.path.dirname(path)
    np.save(f"{d}/cond.npy", cond)
    np.save(f"{d}/text.npy", text)
    env = {**os.environ, "PYTHONPATH": ROOT}
    run = subprocess.run([sys.executable, "-c", script, f"{d}/cond.npy", f"{d}/text.npy", f"{d}/wave.npy"],
                         capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "MODULES [] SNAPSHOT []" in run.stdout, run.stdout
    np.testing.assert_array_equal(np.load(f"{d}/wave.npy"), want)
