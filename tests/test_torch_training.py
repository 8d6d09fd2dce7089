"""The port's training path against the JAX package, on the CPU in float32
at a tiny width (dim 64, depth 2, 2 heads x 32, text_dim 32, one ConvNeXt
block): the DiT's training forward, `cfm_loss` and every parameter's
gradient, the duration loss, the optimizer and schedule against optax, whole
train steps (with gradient accumulation, EMA and the on-device mel), and
both trainers end to end.

Both packages start from the same parameters (`params_from_jax`) and see the
same random draws: the JAX key is split exactly as the JAX loss splits it and
the draws are handed to the port. Tolerances: 1e-4 on the DiT output and on
the loss (two float32 blocks summed in another order), gradients within
1e-4 of the largest gradient of their tensor; parameters after one Adam step
at lr 1e-3 within 1e-4 = lr / 10, and 99.9% of them within 1e-6: the first
update of an element is lr * g / (|g| + eps), about lr * sign(g), so equal
gradients give equal updates except where a gradient is within a few
eps = 1e-8 of zero, where a float32 difference of ~1e-9 moves the update by
a fraction of lr.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from f5_tts_tpu import config as jcfg
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.cfm import cfm_loss as jax_cfm_loss
from f5_tts_tpu.models.dit import dit_forward
from f5_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor
from f5_tts_tpu.models.duration import duration_forward
from f5_tts_tpu.training import trainer as JT
from f5_tts_tpu_torch import config as tcfg
from f5_tts_tpu_torch.models.cfm import F5TTS, CFMDraws, cfm_loss
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.duration import DurationPredictor, duration_loss
from f5_tts_tpu_torch.training import trainer as T
from f5_tts_tpu_torch.training.duration_trainer import DurationTrainer, make_duration_train_step

TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100,
            text_num_embeds=256, text_dim=32, conv_layers=1)
DUR = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32, conv_layers=1)
FPS = 24_000 / 256
LR = 1e-3


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _jax_params(tree) -> dict[str, np.ndarray]:
    """A JAX parameter (or gradient) tree in the port's names and layouts."""
    cfg = tcfg.DiTConfig(**TINY) if "time_embed" in tree else tcfg.DurationConfig(**DUR)
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree), cfg).items()}


def _assert_grads_close(got: dict[str, torch.Tensor], ref: dict[str, np.ndarray]):
    assert sorted(got) == sorted(ref)
    for k, g in got.items():
        r = ref[k]
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * max(np.abs(r).max(), 1e-3), rtol=0, err_msg=k)


def _assert_params_close(got: dict[str, torch.Tensor], ref: dict[str, np.ndarray], atol=1e-4):
    assert sorted(got) == sorted(ref)
    diffs = []
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[k], atol=atol, rtol=0, err_msg=k)
        diffs.append(np.abs(p.detach().numpy() - ref[k]).ravel())
    assert np.mean(np.concatenate(diffs) <= min(atol, 1e-6)) >= 0.999


@pytest.fixture(scope="module")
def jax_params():
    params = JaxF5TTS.init(jax.random.key(0), jcfg.DiTConfig(**TINY)).params
    rng = np.random.default_rng(0)  # the JAX init leaves GRN gamma/beta at zero
    for blk in params["text_embed"]["blocks"]:
        blk["grn"] = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)) for k, v in blk["grn"].items()}
    return params


def _port_dit(jax_params, **cfg) -> DiT:
    dit = DiT(tcfg.DiTConfig(**{**TINY, **cfg}))
    dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_params), dit.cfg))
    return dit


def _batch(b=2, n=48, seed=1, short=True):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, n, 100)).astype(np.float32)
    text = rng.integers(0, 255, (b, 20)).astype(np.int32)
    text[0, 12:] = -1
    lens = np.full((b,), n, np.int32)
    if short:
        lens[-1] = n - 9
    return mel, text, lens


def _jax_draws(key, b, n, cfm=jcfg.CFMConfig()) -> CFMDraws:
    """The draws of JAX `cfm_loss(key)`, split exactly as it splits them."""
    k_frac, k_span, k_x0, k_time, k_adrop, k_tdrop, _ = jax.random.split(key, 7)
    lo, hi = cfm.frac_lengths_mask
    return CFMDraws(
        frac_lengths=_t(jax.random.uniform(k_frac, (b,), minval=lo, maxval=hi)),
        span_start=_t(jax.random.uniform(k_span, (b,))),
        x0=_t(jax.random.normal(k_x0, (b, n, 100), dtype=jnp.float32)),
        time=_t(jax.random.uniform(k_time, (b,), dtype=jnp.float32)),
        audio_drop=_t(jax.random.uniform(k_adrop, (1,))),
        text_drop=_t(jax.random.uniform(k_tdrop, (1,))),
    )


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("drops", [(False, False), ([True, False], [False, True])])
def test_training_forward_matches_jax_dit_forward(jax_params, drops):
    """Per-sample times and drop flags, text ids in, float32 out."""
    dit = _port_dit(jax_params)
    mel, text, _ = _batch()
    rng = np.random.default_rng(2)
    cond = rng.standard_normal(mel.shape).astype(np.float32)
    time = np.array([0.2, 0.9], np.float32)
    mask = np.arange(48)[None, :] < np.array([48, 40])[:, None]
    da, dt = (np.asarray(d) for d in drops)
    ref = dit_forward(jax_params, jcfg.DiTConfig(**TINY), jnp.asarray(mel), jnp.asarray(cond), jnp.asarray(text),
                      jnp.asarray(time), drop_audio_cond=jnp.asarray(da), drop_text=jnp.asarray(dt),
                      mask=jnp.asarray(mask))
    got = dit.forward_train(_t(mel), _t(cond), _t(text), _t(time), drop_audio_cond=_t(da), drop_text=_t(dt),
                            mask=_t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_remat_gives_identical_loss_and_gradients(jax_params):
    mel, text, lens = _batch()
    draws = _jax_draws(jax.random.key(3), 2, 48)
    out = []
    for remat in (False, True):
        dit = _port_dit(jax_params, remat=remat)
        loss = cfm_loss(dit, tcfg.CFMConfig(), _t(mel), _t(text), _t(lens), draws=draws)
        out.append((loss.item(), torch.autograd.grad(loss, list(dit.parameters()))))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("seed", [0, 1, 4, 6])
def test_cfm_loss_and_every_gradient_match_jax(jax_params, seed):
    """Across keys whose CFG drops differ (none, audio, text and audio)."""
    mel, text, lens = _batch(seed=seed)
    key = jax.random.key(seed)
    jcfm, jdit = jcfg.CFMConfig(), jcfg.DiTConfig(**TINY)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jax_cfm_loss(p, jdit, jcfm, key, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens))
    )(jax_params)
    dit = _port_dit(jax_params)
    loss = cfm_loss(dit, tcfg.CFMConfig(), _t(mel), _t(text), _t(lens), draws=_jax_draws(key, 2, 48))
    assert loss.dtype == torch.float32 and loss.ndim == 0
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-4)
    names = [k for k, _ in dit.named_parameters()]
    grads = torch.autograd.grad(loss, list(dit.parameters()))
    _assert_grads_close(dict(zip(names, grads)), _jax_params(ref_grads))


def test_cfm_drop_flags_cover_every_case():
    """The keys above draw no drop, an audio drop, and a text drop (which
    drops the audio too) under the default probabilities."""
    cases = set()
    for seed in (0, 1, 4, 6):
        d = _jax_draws(jax.random.key(seed), 2, 48)
        text = bool(d.text_drop[0] < 0.2)
        cases.add((bool(d.audio_drop[0] < 0.3) or text, text))
    assert cases == {(False, False), (True, False), (True, True)}


def test_f5tts_call_from_raw_wave_matches_jax(jax_params):
    """F5TTS(...)(wave, texts): the mel front-end, tokenizer and loss."""
    vocab = {c: i for i, c in enumerate([""] + [chr(c) for c in range(ord(" "), ord(" ") + 95)])}
    jmodel = JaxF5TTS(jax_params, jcfg.DiTConfig(**TINY), vocab_char_map=vocab)
    port = F5TTS(_port_dit(jax_params), tcfg.DiTConfig(**TINY), vocab_char_map=vocab)
    rng = np.random.default_rng(5)
    wave = (0.1 * rng.standard_normal((2, 40 * 256))).astype(np.float32)
    texts = ["hello there", "a test"]
    key = jax.random.key(2)
    ref = jmodel(jnp.asarray(wave), texts, key=key)
    got = port(wave, texts, draws=_jax_draws(key, 2, 40))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-4)
    got.backward()
    assert all(p.grad is not None for p in port.dit.parameters())


def test_dropout_changes_the_loss_only_when_enabled(jax_params):
    mel, text, lens = _batch()
    draws = _jax_draws(jax.random.key(3), 2, 48)

    def loss(rate, seed):
        dit = _port_dit(jax_params, dropout=rate)
        return cfm_loss(dit, tcfg.CFMConfig(), _t(mel), _t(text), _t(lens),
                        generator=torch.Generator().manual_seed(seed), draws=draws).item()

    assert loss(0.0, 1) == loss(0.0, 2)
    assert loss(0.3, 1) == loss(0.3, 1)
    assert loss(0.3, 1) != loss(0.0, 1)
    assert loss(0.3, 1) != loss(0.3, 2)


@pytest.fixture(scope="module")
def duration_models():
    jp = JaxDurationPredictor.init(jax.random.key(3), jcfg.DurationConfig(**DUR)).params
    port = DurationPredictor(tcfg.DurationConfig(**DUR))
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), port.cfg))
    return jp, port


def _jax_rand_frac(key, b):
    return _t(jax.random.uniform(jax.random.split(key)[0], (b,)))


@pytest.mark.parametrize("seed", [0, 1])
def test_duration_loss_and_gradients_match_jax(duration_models, seed):
    jp, port = duration_models
    mel, text, lens = _batch(n=40, seed=seed)
    key = jax.random.key(seed)
    ref_loss, ref_grads = jax.value_and_grad(lambda p: duration_forward(
        p, jcfg.DurationConfig(**DUR), jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens), key=key,
        return_loss=True, frames_per_second=FPS))(jp)
    loss = duration_loss(port, _t(mel), _t(text), _t(lens), rand_frac=_jax_rand_frac(key, 2), frames_per_second=FPS)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    names = [k for k, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    _assert_grads_close(dict(zip(names, grads)), _jax_params(ref_grads))


# ------------------------------------------------------------------ optimizer


def test_schedule_matches_optax():
    for warmup, total in ((10, 100), (0, 50), (3, 3)):
        ref = JT.make_lr_schedule(1e-3, warmup, total)
        got = T.make_lr_schedule(1e-3, warmup, total)
        for step in list(range(0, 15)) + [49, 50, 51, 99, 100, 150]:
            np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-12, err_msg=str(step))


def test_optimizer_matches_optax_across_clip_and_warmup_boundary():
    """Eight updates of two tensors: the warm-up (3 steps) into the cosine
    decay, and gradients scaled so that some steps clip and some do not."""
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 5)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float32)}
    jopt = JT.make_optimizer(LR, 1e-2, 3, 10, 1.0)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    opt = T.make_optimizer(LR, 1e-2, 3, 10, 1.0)
    tparams = {k: torch.tensor(v) for k, v in params.items()}
    tstate = opt.init(tparams)
    norms = []
    for step in range(8):
        scale = 5.0 if step % 2 else 0.05
        grads = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32) for k, v in params.items()}
        norms.append(np.sqrt(sum(np.square(g).sum() for g in grads.values())))
        updates, jstate = jopt.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update_(tparams, {k: torch.tensor(g) for k, g in grads.items()}, tstate)
        for k in params:
            # a few float32 ulps of O(1) parameters: sums in another order
            np.testing.assert_allclose(tparams[k].numpy(), np.asarray(jparams[k]), atol=1e-6, rtol=0,
                                       err_msg=f"{k} after update {step}")
    assert min(norms) < 1.0 < max(norms)
    assert tstate["count"] == 8


# ------------------------------------------------------------------ steps


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_matches_jax_step(jax_params, grad_accum):
    """One update from identical parameters and draws: loss, parameters
    and EMA, with and without gradient accumulation."""
    k = grad_accum
    mel, text, lens = _batch(b=2 * k, seed=7)
    key = jax.random.key(11)
    jopt = JT.make_optimizer(LR, 1e-2, 0, 100)
    jstep = jax.jit(JT.make_train_step(jcfg.DiTConfig(**TINY), jcfg.CFMConfig(), jopt, ema_decay=0.9,
                                       grad_accum=k))
    jin = JT.split_microbatches(k, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens))
    jstate, jloss = jstep(JT.init_train_state(jax_params, jopt, ema=True), *jin, key)

    dit = _port_dit(jax_params)
    opt = T.make_optimizer(LR, 1e-2, 0, 100)
    state = T.init_train_state(dit, opt, ema=True)
    step = T.make_train_step(tcfg.CFMConfig(), opt, ema_decay=0.9, grad_accum=k)
    tin = T.split_microbatches(k, _t(mel), _t(text), _t(lens))
    if k == 1:
        draws = _jax_draws(key, 2, 48)
    else:
        draws = [_jax_draws(mk, 2, 48) for mk in jax.random.split(key, k)]
    loss = step(state, *tin, draws=draws)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    assert state.step == 1 and state.opt_state["count"] == 1
    _assert_params_close(dict(dit.named_parameters()), _jax_params(jstate["params"]))
    _assert_params_close(state.ema, _jax_params(jstate["ema"]))


def test_from_audio_step_matches_mel_step_and_jax(jax_params):
    """The on-device mel step against the mel step fed the same mel (frames
    past each length re-zeroed) and against the JAX raw-audio step."""
    from f5_tts_tpu_torch.audio.mel import log_mel_spectrogram

    rng = np.random.default_rng(3)
    n = 48
    audio = (0.1 * rng.standard_normal((2, n * 256))).astype(np.float32)
    text = rng.integers(0, 255, (2, n)).astype(np.int32)
    lens = np.array([n, n - 16], np.int32)
    key = jax.random.key(5)
    draws = _jax_draws(key, 2, n)

    mel = log_mel_spectrogram(_t(audio))
    mel = torch.where((torch.arange(n)[None, :] < _t(lens)[:, None])[..., None], mel, torch.zeros_like(mel))
    results = []
    for make, inp in ((T.make_train_step, mel), (T.make_train_step_from_audio, _t(audio))):
        dit = _port_dit(jax_params)
        opt = T.make_optimizer(LR, 1e-2, 0, 100)
        state = T.init_train_state(dit, opt)
        loss = make(tcfg.CFMConfig(), opt)(state, inp, _t(text), _t(lens), draws=draws)
        results.append((loss.item(), {k: p.detach().clone() for k, p in dit.named_parameters()}))
    assert abs(results[0][0] - results[1][0]) < 1e-5
    for k, p in results[0][1].items():
        torch.testing.assert_close(results[1][1][k], p, atol=1e-5, rtol=0)

    jopt = JT.make_optimizer(LR, 1e-2, 0, 100)
    jstate, jloss = jax.jit(JT.make_train_step_from_audio(jcfg.DiTConfig(**TINY), jcfg.CFMConfig(), jopt))(
        JT.init_train_state(jax_params, jopt), jnp.asarray(audio), jnp.asarray(text), jnp.asarray(lens), key)
    np.testing.assert_allclose(results[1][0], float(jloss), rtol=1e-4)
    _assert_params_close(results[1][1], _jax_params(jstate["params"]))


def test_duration_step_matches_jax(duration_models):
    jp, port = duration_models
    mel, text, lens = _batch(b=4, n=40, seed=9)
    key = jax.random.key(4)
    jopt = JT.make_optimizer(LR, 1e-2, 0, 100)
    from f5_tts_tpu.training.duration_trainer import make_duration_train_step as jax_make

    jstep = jax.jit(jax_make(jcfg.DurationConfig(**DUR), jopt, FPS, ema_decay=0.9, grad_accum=2))
    jin = JT.split_microbatches(2, jnp.asarray(mel), jnp.asarray(text), jnp.asarray(lens))
    jstate, jloss = jstep(JT.init_train_state(jp, jopt, ema=True), *jin, key)

    model = DurationPredictor(port.cfg)
    model.load_state_dict(port.state_dict())
    opt = T.make_optimizer(LR, 1e-2, 0, 100)
    state = T.init_train_state(model, opt, ema=True)
    draws = [_jax_rand_frac(mk, 2) for mk in jax.random.split(key, 2)]
    loss = make_duration_train_step(opt, FPS, ema_decay=0.9, grad_accum=2)(
        state, *T.split_microbatches(2, _t(mel), _t(text), _t(lens)), draws=draws)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    _assert_params_close(dict(model.named_parameters()), _jax_params(jstate["params"]))
    _assert_params_close(state.ema, _jax_params(jstate["ema"]))


# ------------------------------------------------------------------ trainers


def _dataset(n_batches, b=2, frames=48, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield {"mel_spec": rng.standard_normal((b, frames, 100)).astype(np.float32),
               "mel_len": np.full((b,), frames, np.int32),
               "transcript": rng.integers(0, 255, (b, 16)).astype(np.int32)}


def _fresh_f5tts(seed):
    return F5TTS.init(torch.Generator().manual_seed(seed), tcfg.DiTConfig(**TINY), device="cpu",
                      cfm_cfg=tcfg.CFMConfig())


def test_trainer_end_to_end(tmp_path, capsys):
    """Checkpoints at steps 3 and 6 that the JAX package's convert_dit_state
    loads bit-identically; an exact resume of the optimizer state and step;
    checkpoint="latest"; a weights-only resume warns."""
    from safetensors.numpy import load_file as ref_load

    from f5_tts_tpu.models.convert import convert_dit_state as jax_convert

    trainer = T.F5TTSTrainer(_fresh_f5tts(0), num_warmup_steps=2, results_dir=tmp_path, ema_decay=0.9)
    trainer.train(_dataset(8), learning_rate=1e-4, total_steps=6, save_every=3, sample_every=10**9, log_every=2)
    files = set(os.listdir(tmp_path))
    for step in (3, 6):
        assert {f"f5tts_{step}.safetensors", f"f5tts_{step}.ema.safetensors",
                f"f5tts_{step}.trainstate.safetensors"} <= files
    assert trainer.state.step == 6

    for suffix, want in (("", dict(trainer.model.dit.named_parameters())), (".ema", trainer.state.ema)):
        back = _jax_params(jax_convert(ref_load(str(tmp_path / f"f5tts_6{suffix}.safetensors")),
                                       jcfg.DiTConfig(**TINY)))
        _assert_params_close(want, back, atol=0)

    # an exact resume: weights, EMA, optimizer moments and step
    resumed = T.F5TTSTrainer(_fresh_f5tts(1), num_warmup_steps=2, results_dir=tmp_path, ema_decay=0.9)
    opt = T.make_optimizer(1e-4, 1e-2, 2, 8)
    resumed.state = T.init_train_state(resumed.model.dit, opt, ema=True)
    resumed.load_checkpoint(6)
    assert resumed.state.step == 6 and resumed.state.opt_state["count"] == 6
    for name in ("mu", "nu"):
        for k, v in trainer.state.opt_state[name].items():
            torch.testing.assert_close(resumed.state.opt_state[name][k], v, rtol=0, atol=0)
    for k, p in trainer.model.dit.named_parameters():
        torch.testing.assert_close(dict(resumed.model.dit.named_parameters())[k], p, rtol=0, atol=0)
        torch.testing.assert_close(resumed.state.ema[k], trainer.state.ema[k], rtol=0, atol=0)

    latest = T.F5TTSTrainer(_fresh_f5tts(2), num_warmup_steps=2, results_dir=tmp_path)
    latest.train(_dataset(4), learning_rate=1e-4, total_steps=8, save_every=10**9, sample_every=10**9,
                 checkpoint="latest")
    assert latest.state.step == 8
    assert "WEIGHTS-ONLY" not in capsys.readouterr().out

    os.remove(tmp_path / "f5tts_6.trainstate.safetensors")
    weights_only = T.F5TTSTrainer(_fresh_f5tts(3), num_warmup_steps=2, results_dir=tmp_path)
    weights_only.train(_dataset(1), total_steps=7, save_every=10**9, sample_every=10**9, checkpoint="latest")
    assert "WEIGHTS-ONLY" in capsys.readouterr().out
    assert weights_only.state.step == 1


def test_trainer_on_device_mel_and_grad_accum(tmp_path):
    rng = np.random.default_rng(0)

    def audio_batches():
        for _ in range(2):
            yield {"audio": (0.1 * rng.standard_normal((4, 32 * 256))).astype(np.float32),
                   "mel_len": np.full((4,), 32, np.int32),
                   "transcript": rng.integers(0, 255, (4, 16)).astype(np.int32)}

    trainer = T.F5TTSTrainer(_fresh_f5tts(0), num_warmup_steps=1, results_dir=tmp_path)
    trainer.train(audio_batches(), total_steps=2, save_every=2, sample_every=10**9, on_device_mel=True,
                  grad_accum=2)
    assert trainer.state.step == 2 and (tmp_path / "f5tts_2.safetensors").exists()
    with pytest.raises(ValueError, match="not divisible"):
        T.F5TTSTrainer(_fresh_f5tts(0), results_dir=tmp_path).train(
            _dataset(1, b=3), total_steps=1, save_every=10**9, sample_every=10**9, grad_accum=2)


def test_trainer_generate_sample_with_ema(tmp_path):
    from f5_tts_tpu_torch import Vocos, VocosConfig
    from f5_tts_tpu_torch.audio.io import read_wav, write_wav

    g = torch.Generator().manual_seed(0)
    model = F5TTS.init(g, tcfg.DiTConfig(**TINY), device="cpu", cfm_cfg=tcfg.CFMConfig(duration_bucket=64),
                       vocoder=Vocos.init(g, VocosConfig(dim=32, intermediate_dim=64, num_layers=2), device="cpu"))
    trainer = T.F5TTSTrainer(model, num_warmup_steps=1, results_dir=tmp_path / "r", ema_decay=0.5)
    trainer.train(_dataset(1), total_steps=1, save_every=10**9, sample_every=10**9)
    ref = tmp_path / "ref.wav"
    write_wav(ref, (0.05 * np.sin(np.arange(12_000) / 10)).astype(np.float32), 24_000)
    trainer.generate_sample(str(ref), "hi", "there", 0.5, step=1, samples_dir=str(tmp_path / "s"))
    wave, sr = read_wav(tmp_path / "s" / "audio" / "step_1.wav")
    assert sr == 24_000 and wave.ndim == 1 and len(wave) > 0


def test_trainstate_file_round_trip_and_structural_mismatch(tmp_path):
    """Tensors and numbers come back with the template's types; a changed
    optimizer configuration (a leaf the file lacks) fails loudly."""
    from f5_tts_tpu_torch.training.checkpoints import load_tree_safetensors, save_tree_safetensors

    tree = {"opt_state": {"mu": {"w": torch.arange(6.0).reshape(2, 3)}, "count": 7}, "step": 7}
    save_tree_safetensors(tmp_path / "ts.safetensors", tree)
    template = {"opt_state": {"mu": {"w": torch.zeros(2, 3)}, "count": 0}, "step": 0}
    back = load_tree_safetensors(tmp_path / "ts.safetensors", template)
    assert back["step"] == 7 and isinstance(back["step"], int) and back["opt_state"]["count"] == 7
    torch.testing.assert_close(back["opt_state"]["mu"]["w"], tree["opt_state"]["mu"]["w"], rtol=0, atol=0)
    with pytest.raises(KeyError, match="optimizer configuration changed"):
        load_tree_safetensors(tmp_path / "ts.safetensors", {"opt_state": {"nu": {"w": torch.zeros(2, 3)}}})


def _duration_batches(n, b=2, frames=40, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield {"mel_spec": rng.standard_normal((b, frames, 100)).astype(np.float32),
               "mel_len": np.full((b,), frames, np.int32),
               "transcript": rng.integers(0, 200, (b, 8)).astype(np.int32)}


def test_duration_trainer_end_to_end(tmp_path, capsys):
    from safetensors.numpy import load_file as ref_load

    from f5_tts_tpu.models.convert import convert_duration_state as jax_convert

    def fresh(seed):
        return DurationPredictor.init(torch.Generator().manual_seed(seed), tcfg.DurationConfig(**DUR), device="cpu")

    trainer = DurationTrainer(fresh(0), num_warmup_steps=2, results_dir=tmp_path, ema_decay=0.9)
    trainer.train(_duration_batches(6), learning_rate=1e-4, total_steps=6, save_every=3, log_every=2)
    assert {"duration_6.safetensors", "duration_6.ema.safetensors",
            "duration_6.trainstate.safetensors"} <= set(os.listdir(tmp_path))
    for suffix, want in (("", dict(trainer.model.named_parameters())), (".ema", trainer.state.ema)):
        back = _jax_params(jax_convert(ref_load(str(tmp_path / f"duration_6{suffix}.safetensors")),
                                       jcfg.DurationConfig(**DUR)))
        _assert_params_close(want, back, atol=0)

    resumed = DurationTrainer(fresh(1), num_warmup_steps=2, results_dir=tmp_path, ema_decay=0.9)
    resumed.train(_duration_batches(2), learning_rate=1e-4, total_steps=8, save_every=10**9,
                  checkpoint="latest", grad_accum=2)
    assert resumed.state.step == 8

    os.remove(tmp_path / "duration_6.trainstate.safetensors")
    weights_only = DurationTrainer(fresh(2), num_warmup_steps=2, results_dir=tmp_path)
    weights_only.load_checkpoint(6)  # no train state yet: weights only, no warning
    weights_only.train(_duration_batches(1), total_steps=7, save_every=10**9, checkpoint="latest")
    assert "WEIGHTS-ONLY" in capsys.readouterr().out
    for k, p in trainer.model.named_parameters():
        assert p.shape == dict(weights_only.model.named_parameters())[k].shape
