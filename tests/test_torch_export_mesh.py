"""A loaded sampler artifact over the data rows of a mesh
(`LoadedProgram.place_weights`), on the CPU, at the tiny width of
`tests/test_torch_export.py` (dim 64, depth 2, 2 heads x 32, text_dim 32,
one ConvNeXt block, 64-frame buckets) with a tiny Vocos.

A grid repeats the one CPU device, as the JAX suite meshes 8 virtual
devices. Tolerances: the batch over a grid against the one-device call
2e-4 (the JAX package's `test_artifact_composes_with_mesh_dp`); each data
row's rows against the one-device call on that row's share exactly (the
same program at the same batch size); against the JAX package's live
sampler fed the same noise 1e-3 (`test_artifact_matches_jax_live_sampler`);
against the port's live sampler 1e-5, as in `tests/test_torch_export.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.config import CFMConfig as JaxCFMConfig
from f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from f5_tts_tpu.config import VocosConfig as JaxVocosConfig
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.vocos import Vocos as JaxVocos
from f5_tts_tpu_torch import export as E
from f5_tts_tpu_torch.config import CFMConfig, DiTConfig, DurationConfig, VocosConfig
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.vocos import Vocos
from f5_tts_tpu_torch.parallel.mesh import create_mesh, pad_batch
from f5_tts_tpu_torch.utils.sampling import draw_noise

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
            text_num_embeds=256, text_dim=32, conv_layers=1)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
HOP = 256
BATCH, SEED, DURATION = 8, 9, 48
STEPS = 2  # the JAX test's: one Euler interval


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


@pytest.fixture(scope="module")
def paths(models, tmp_path_factory):
    """Batch-8 Euler samplers over a 2-point grid: external weights (shared
    noise, and one noise draw a row) and embedded weights."""
    _, port = models
    tmp = tmp_path_factory.mktemp("mesh_artifacts")
    out = {}
    for name, kw in (("external", dict(embed_weights=False)), ("embedded", {}),
                     ("unshared", dict(embed_weights=False, shared_noise=False))):
        exp = E.export_sampler(port, batch=BATCH, steps=STEPS, method="euler", device="cpu", **kw)
        E.save_sampler(exp, tmp / f"{name}.bin", model=port)
        out[name] = tmp / f"{name}.bin"
    return out


def _inputs():
    """The JAX test's request: rows of text length 2 + i % 4."""
    rng = np.random.RandomState(3)
    cond = (rng.randn(BATCH, 20, 100) * 0.1).astype(np.float32)
    text = np.full((BATCH, 12), -1, np.int32)
    for i in range(BATCH):
        text[i, :2 + i % 4] = np.arange(2 + i % 4) + 1
    return cond, text


def _live(port, cond, text):
    return port.sample(cond, text, duration=DURATION, steps=STEPS, method="euler", cfg_strength=2.0,
                       sway_sampling_coef=-1.0, seed=SEED, return_trajectory=False)[0]


def _grid(data: int, model: int = 1):
    return create_mesh(data=data, model=model, devices=["cpu"] * (data * model))


def _share_calls(one, args, data: int) -> list:
    """The one-device sampler called on each data row's share of the padded
    batch (the rows a data row of the grid runs)."""
    padded = [pad_batch(torch.as_tensor(a), data) if i in E._BATCHED else a for i, a in enumerate(args[:6])]
    share = padded[0].shape[0] // data
    return [one.call(*(a[r * share:(r + 1) * share] if i in E._BATCHED else a for i, a in enumerate(padded)),
                     args[6]) for r in range(data)]


@pytest.mark.parametrize("flavor, data", [("external", 8), ("external", 3), ("embedded", 3)])
def test_loaded_sampler_over_data_rows_equals_one_device(paths, flavor, data):
    """The counterpart of the JAX package's `test_artifact_composes_with_mesh_dp`:
    the batch over a data-8 and a data-3 grid (8 rows padded to 9) within
    2e-4 of the one-device call; each data row's rows equal to the bit to
    the one-device call on its share; one program and one weight copy for
    the grid's one distinct device."""
    grid, spec = E.load_sampler(paths[flavor], device="cpu")
    args = E.prep_inputs(spec, *_inputs(), DURATION, seed=SEED)
    mel1, wave1 = grid.call(*args)
    shares = _share_calls(grid, args, data)
    assert grid.place_weights(_grid(data)) is grid
    mel, wave = grid.call(*args)
    assert mel.shape == mel1.shape == (BATCH, 64, 100) and wave.shape == wave1.shape
    np.testing.assert_allclose(wave.numpy(), wave1.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(mel.numpy(), mel1.numpy(), atol=2e-4, rtol=2e-4)
    share = -(-BATCH // data)
    for r, (mel_r, wave_r) in enumerate(shares):
        rows = slice(r * share, min((r + 1) * share, BATCH))
        n = rows.stop - rows.start
        assert torch.equal(mel[rows], mel_r[:n]) and torch.equal(wave[rows], wave_r[:n]), r
    assert list(grid._modules) == [torch.device("cpu")]
    if flavor == "external":
        assert list(grid._weights_dev) == [torch.device("cpu")]


def test_noise_is_drawn_for_the_batch_before_padding(paths):
    """One noise draw a row (shared_noise=False): the grid draws the B rows
    as the one-device call does, then pads, so the batch over data 3 stays
    within 2e-4 of the one-device call."""
    sampler, spec = E.load_sampler(paths["unshared"], device="cpu")
    args = E.prep_inputs(spec, *_inputs(), DURATION, seed=SEED)
    _, wave1 = sampler.call(*args)
    _, wave = sampler.place_weights(_grid(3)).call(*args)
    np.testing.assert_allclose(wave.numpy(), wave1.numpy(), atol=2e-4, rtol=2e-4)
    assert not torch.equal(wave1[0], wave1[1])


def test_grid_matches_the_jax_live_sampler(models, paths):
    """The batch over data 8 against the JAX package's live sampler fed the
    seed's shared draw as y0: mel and wave within 1e-3."""
    jax_model, _ = models
    sampler, spec = E.load_sampler(paths["external"], device="cpu")
    cond, text = _inputs()
    args = E.prep_inputs(spec, cond, text, DURATION, seed=SEED)
    mel, wave = sampler.place_weights(_grid(8)).call(*args)
    y0 = draw_noise(SEED, True, BATCH, 64, 100, "cpu").numpy()
    ref_wave, ref_traj = jax_model.sample(jnp.asarray(cond), jnp.asarray(text), duration=DURATION, steps=STEPS,
                                          method="euler", cfg_strength=2.0, sway_sampling_coef=-1.0,
                                          y0=jnp.asarray(y0), return_trajectory=False)
    max_dur = int(args[3])
    np.testing.assert_allclose(wave[:, :(max_dur - 1) * HOP].numpy(), np.asarray(ref_wave), atol=1e-3, rtol=0)
    ref_mel = np.where(np.arange(max_dur)[None, :, None] < args[1][:, None, None], args[0][:, :max_dur],
                       np.asarray(ref_traj)[-1])
    np.testing.assert_allclose(mel[:, :max_dur].numpy(), ref_mel, atol=1e-3, rtol=0)


def test_place_weights_on_a_device_changes_no_bit(paths):
    """The counterpart of the JAX package's explicit placement check: a
    device placement, and a grid placement followed by one back onto the
    device, leave the output unchanged to the bit."""
    sampler, spec = E.load_sampler(paths["external"], device="cpu")
    args = E.prep_inputs(spec, *_inputs(), DURATION, seed=SEED)
    want = sampler.call(*args)
    got = sampler.place_weights("cpu").call(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    sampler.place_weights(_grid(4)).call(*args)
    got = sampler.place_weights(torch.device("cpu")).call(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert sampler._rows is None and sampler.device == torch.device("cpu")


def test_a_model_axis_and_a_duration_artifact_are_refused(models, paths, tmp_path):
    """A grid with a model axis above 1 raises ValueError (the program is
    not tensor-partitioned; the live use_mesh serves tensor parallelism),
    and so does a duration artifact placed on a grid."""
    _, port = models
    sampler, _ = E.load_sampler(paths["external"], device="cpu")
    with pytest.raises(ValueError, match="not tensor-partitioned.*use_mesh"):
        sampler.place_weights(_grid(2, model=2))
    with pytest.raises(ValueError, match="not tensor-partitioned"):
        sampler.place_weights(_grid(1, model=2))
    g = torch.Generator().manual_seed(0)
    predictor = DurationPredictor.init(g, DurationConfig(dim=64, depth=1, heads=2, dim_head=32, text_dim=32,
                                                         conv_layers=1), device="cpu")
    E.save_duration(E.export_duration(predictor, padded_len=64, device="cpu"), tmp_path / "d.bin",
                    predictor=predictor)
    duration, _ = E.load_duration(tmp_path / "d.bin", device="cpu")
    with pytest.raises(ValueError, match="duration artifact"):
        duration.place_weights(_grid(2))


def test_a_static_batch_artifact_is_refused_on_data_rows_and_runs_on_one_device(models, tmp_path):
    """A file written as before the symbolic batch (the program exported at
    a static batch of 2, with no batch in its header) loads with its batch
    from the program's shapes, raises ValueError on a data-2 grid, and
    still equals the live sampler on one device."""
    _, port = models
    program = E._sampler_program(port, True, "euler", 2.0)
    z = dict(dtype=torch.int32)
    args = (torch.zeros(2, 64, 100), torch.zeros(2, **z), torch.zeros(2, **z), torch.zeros((), **z),
            torch.zeros(2, 64, **z), torch.zeros(STEPS), torch.zeros(2, 64, 100))
    exported = E.Exported(E._export(program, args, False), {"kind": "sampler", "device": "cpu",
                                                            "shared_noise": True})
    E.save_sampler(exported, tmp_path / "static.bin", model=port)
    sampler, spec = E.load_sampler(tmp_path / "static.bin", device="cpu")
    assert spec.batch == 2 and _user_batch(sampler) == 2
    with pytest.raises(ValueError, match="static batch of 2.*export it again"):
        sampler.place_weights(_grid(2))
    cond, text = (x[:2] for x in _inputs())
    _, wave = sampler.call(*E.prep_inputs(spec, cond, text, DURATION, seed=SEED))
    live = _live(port, cond, text)
    np.testing.assert_allclose(wave[:, :(DURATION - 1) * HOP].numpy(), live.numpy(), atol=1e-5, rtol=0)


def _user_batch(sampler):
    return E._user_inputs(sampler.program)[-E._N_CALL_ARGS].shape[0]


def test_symbolic_batch_artifact_equals_the_live_sampler(models, paths):
    """The batch-8 program's batch is symbolic, the header records 8, and
    the artifact still equals `F5TTS.sample` at the same seed within 1e-5
    (the port's artifact tolerance)."""
    _, port = models
    sampler, spec = E.load_sampler(paths["external"], device="cpu")
    assert spec.batch == BATCH and isinstance(_user_batch(sampler), torch.SymInt)
    cond, text = _inputs()
    args = E.prep_inputs(spec, cond, text, DURATION, seed=SEED)
    mel, wave = sampler.call(*args)
    live = _live(port, cond, text)
    max_dur = int(args[3])
    np.testing.assert_allclose(wave[:, :(max_dur - 1) * HOP].numpy(), live.numpy(), atol=1e-5, rtol=0)
    assert not mel[:, max_dur:].any()

