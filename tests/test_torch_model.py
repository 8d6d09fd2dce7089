"""The PyTorch port's DiT, ODE, snapshot loader and whole sampling slice
against the JAX package, on the CPU in float32 at a tiny width (dim 64,
depth 2, 2 heads x 32, text_dim 32, 1 conv layer, 64-frame buckets).

JAX parameters come from `F5TTS.init` and reach the port through
`params_from_jax`; inputs and the initial noise are made with numpy from a
seed. Tolerances: 1e-5 for the text branch, 1e-4 for the DiT forward (two
blocks of float32 matmuls, convs and softmax summed in another order), 1e-3
for the pipeline mel and wave.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu.config import CFMConfig as JaxCFMConfig
from f5_tts_tpu.config import DiTConfig as JaxDiTConfig
from f5_tts_tpu.config import VocosConfig as JaxVocosConfig
from f5_tts_tpu.models import blocks as JB
from f5_tts_tpu.models import ode as jode
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.dit import dit_forward_precomputed, dit_text_embed, dit_time_mods
from f5_tts_tpu.models.vocos import Vocos as JaxVocos
from f5_tts_tpu_torch.config import CFMConfig, DiTConfig, VocosConfig
from f5_tts_tpu_torch.models import ode as tode
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.vocos import Vocos

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
            text_num_embeds=256, text_dim=32, conv_layers=1)
VOCOS = dict(dim=32, intermediate_dim=64, num_layers=2)
VOCAB = {c: i for i, c in enumerate([""] + [chr(c) for c in range(ord(" "), ord(" ") + 95)])}


def _close(t: torch.Tensor, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def models():
    """The same random tiny model in both packages."""
    jax_model = JaxF5TTS.init(
        jax.random.key(0), JaxDiTConfig(**TINY), cfm_cfg=JaxCFMConfig(duration_bucket=64),
        vocab_char_map=VOCAB, vocoder=JaxVocos.init(jax.random.key(1), JaxVocosConfig(**VOCOS)).decode,
    )
    # the JAX init leaves GRN gamma/beta at zero; randomize them so the GRN
    # term is exercised
    rng = np.random.default_rng(0)
    for blk in jax_model.params["text_embed"]["blocks"]:
        blk["grn"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
                      for k, v in blk["grn"].items()}
    np_tree = jax.tree.map(np.asarray, jax_model.params)
    dit = DiT(DiTConfig(**TINY))
    dit.load_state_dict(params_from_jax(np_tree, DiTConfig(**TINY)))
    vocos = Vocos(VocosConfig(**VOCOS))
    vocos.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, jax_model._vocoder.__self__.params), VocosConfig(**VOCOS)))
    port = F5TTS(dit, DiTConfig(**TINY), cfm_cfg=CFMConfig(duration_bucket=64),
                 vocab_char_map=VOCAB, vocoder=vocos)
    return jax_model, port


def _text(n, seed):
    rng = np.random.default_rng(seed)
    text = rng.integers(0, 256, (2, 30)).astype(np.int32)
    text[0, 20:] = -1  # padding
    return text


@pytest.mark.parametrize("drop", [False, True, (False, True)])
def test_text_embedding(models, drop):
    jax_model, port = models
    text = _text(40, seed=1)
    ref = dit_text_embed(jax_model.params, jax_model.dit_cfg, jnp.asarray(text), 40,
                         drop_text=jnp.asarray(drop))
    got = port.dit.embed_text(torch.tensor(text), 40, drop_text=torch.tensor(drop))
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("with_mask", [False, True])
def test_dit_forward(models, with_mask):
    jax_model, port = models
    rng = np.random.default_rng(2)
    b, n = 2, 40
    x, cond = (rng.standard_normal((b, n, 100)).astype(np.float32) for _ in range(2))
    text = _text(n, seed=3)
    mask = np.arange(n)[None, :] < np.array([n, 31])[:, None] if with_mask else None
    drop = np.array([False, True])
    p, cfg = jax_model.params, jax_model.dit_cfg
    te = dit_text_embed(p, cfg, jnp.asarray(text), n)
    mods = jax.tree.map(lambda a: a[0], dit_time_mods(p, cfg, jnp.asarray([0.3], jnp.float32)))
    ref = dit_forward_precomputed(p, cfg, jnp.asarray(x), jnp.asarray(cond), te, None,
                                  drop_audio_cond=jnp.asarray(drop),
                                  mask=None if mask is None else jnp.asarray(mask), time_mods=mods)
    tte = port.dit.embed_text(torch.tensor(text), n)
    tmods = {k: v[0] for k, v in port.dit.time_mods(torch.tensor([0.3])).items()}
    got = port.dit(torch.tensor(x), torch.tensor(cond), tte, tmods, drop_audio_cond=torch.tensor(drop),
                   mask=None if mask is None else torch.tensor(mask))
    assert got.dtype == torch.float32
    _close(got, ref, 1e-4)
    # the time embedding and modulations on their own
    t_ref = JB.timestep_embedding(p["time_embed"], jnp.asarray([0.3, 0.9], jnp.float32))
    _close(port.dit.time_embed(torch.tensor([0.3, 0.9]), torch.float32), t_ref, 1e-5)


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_odeint(method):
    """The three steppers with and without a schedule, including RK4's shared
    half-step slot. Tolerance 1e-5."""
    rng = np.random.default_rng(4)
    y0 = rng.standard_normal((2, 3)).astype(np.float32)
    t = np.asarray(np.linspace(0, 1, 6) ** 1.5, np.float32)

    def jf(tt, y, s=0.0):
        return jnp.sin(y) * (1 - tt) + s

    def tf(tt, y, s=0.0):
        return torch.sin(y) * (1 - tt) + s

    sched = lambda times: times * 3  # noqa: E731
    for schedule in (None, sched):
        ref = jode.odeint(jf, jnp.asarray(y0), jnp.asarray(t), method, schedule_fn=schedule)
        got = tode.odeint(tf, torch.tensor(y0), t, method,
                          schedule_fn=None if schedule is None else (lambda tm: torch.tensor(tm * 3)))
        assert got.shape == (len(t), 2, 3)
        _close(got, ref, 1e-5)
        last = tode.odeint(tf, torch.tensor(y0), t, method, return_trajectory=False,
                           schedule_fn=None if schedule is None else (lambda tm: torch.tensor(tm * 3)))
        _close(last[0], ref[-1], 1e-5)


def test_snapshot_loader(models, tmp_path):
    """JAX save_pretrained -> the port's from_pretrained gives the tensors of
    params_from_jax; the port's save_pretrained writes the same files back
    (tensor for tensor) and JAX's from_pretrained reads them."""
    from safetensors.numpy import load_file as ref_load

    from f5_tts_tpu_torch.utils.safetensors import load_file

    jax_model, port = models
    jax_model.save_pretrained(tmp_path / "jax")
    loaded = F5TTS.from_pretrained(tmp_path / "jax", device="cpu")
    assert loaded.dit_cfg == port.dit_cfg and loaded.cfm_cfg == port.cfm_cfg
    assert loaded.vocab_char_map == VOCAB
    for a, b in ((loaded.dit, port.dit), (loaded.vocoder, port.vocoder)):
        sa, sb = a.state_dict(), b.state_dict()
        assert sorted(sa) == sorted(sb)
        for k in sa:
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0)

    loaded.save_pretrained(tmp_path / "port")
    for rel in ("model_v1.safetensors", "vocos/model.safetensors"):
        ours, theirs = load_file(tmp_path / "port" / rel), ref_load(str(tmp_path / "jax" / rel))
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k])
    back = JaxF5TTS.from_pretrained(str(tmp_path / "port"))
    for a, b in zip(jax.tree.leaves(back.params), jax.tree.leaves(jax_model.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_loader_rejects_unconsumed_and_missing_keys(models):
    from f5_tts_tpu_torch.models.convert import convert_dit_state, export_dit_state

    _, port = models
    flat = export_dit_state(port.dit)
    with pytest.raises(ValueError, match="unconsumed"):
        convert_dit_state({**flat, "ema_model.transformer.extra.weight": np.zeros(1)}, port.dit_cfg)
    flat.pop("ema_model.transformer.proj_out.bias")
    with pytest.raises(KeyError, match="proj_out.bias"):
        convert_dit_state(flat, port.dit_cfg)


@pytest.mark.parametrize("method", ["euler", "midpoint", "rk4"])
def test_sample_slice(models, method):
    """The whole slice: reference wave -> mel -> text -> 4-step ODE with CFG
    -> composite -> Vocos, with the same y0 on both sides. Tolerance 1e-3 on
    the mel and the wave."""
    jax_model, port = models
    sr = 24_000
    rng = np.random.default_rng(5)
    # a little noise keeps every mel bin well above the 1e-5 log floor, where
    # the log would amplify the two FFTs' rounding differences
    wave = (0.1 * np.sin(2 * np.pi * 220 * np.arange(sr // 2) / sr)
            + 0.01 * rng.standard_normal(sr // 2)).astype(np.float32)
    y0 = rng.standard_normal((1, 100, 100)).astype(np.float32)
    kw = dict(duration=100, steps=4, method=method, cfg_strength=2.0, sway_sampling_coef=-1.0)
    ref_wave, ref_traj = jax_model.sample(jnp.asarray(wave)[None], ["hello there"], y0=jnp.asarray(y0), **kw)
    got_wave, got_traj = port.sample(wave[None], ["hello there"], y0=y0, **kw)
    assert got_wave.shape == ref_wave.shape == ((100 - 1) * 256,)
    assert got_traj.shape == ref_traj.shape == (4, 1, 100, 100)
    _close(got_traj, ref_traj, 1e-3)
    _close(got_wave, ref_wave, 1e-3)


def test_sample_errors_and_seeded_noise(models):
    _, port = models
    mel = np.zeros((1, 70, 100), np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        port.sample(mel, ["hi"], duration=200, steps=2, max_duration=64)
    # a fixed seed gives every batch row the same noise
    mel2 = np.zeros((2, 10, 100), np.float32)
    _, traj = port.sample(mel2, ["ab", "ab"], duration=40, steps=2, seed=3, cfg_strength=0.0)
    torch.testing.assert_close(traj[0, 0], traj[0, 1], rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["F5TTS.init", "F5TTS.from_pretrained", "load_f5tts_pretrained",
                                   "DurationPredictor.init", "Vocos.init", "Vocos.from_pretrained",
                                   "load_vocos_pretrained"])
def test_entry_points_default_to_the_card(entry):
    """The port's entry points run on the card unless the caller asks for the
    CPU, as these tests do."""
    import inspect

    from f5_tts_tpu_torch.models import convert
    from f5_tts_tpu_torch.models.duration import DurationPredictor

    owners = {"F5TTS": F5TTS, "DurationPredictor": DurationPredictor, "Vocos": Vocos}
    owner, _, name = entry.rpartition(".")
    fn = getattr(owners[owner], name) if owner else getattr(convert, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_init_without_device_does_not_fall_back_to_the_cpu():
    """With no card, F5TTS.init without `device` raises torch's own CUDA
    error; with one, the model lives on it."""
    cfg = DiTConfig(**TINY)
    if torch.cuda.is_available():
        model = F5TTS.init(torch.Generator(device="cuda").manual_seed(0), cfg)
        assert model.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError)):
        F5TTS.init(torch.Generator().manual_seed(0), cfg)
