"""Training over a mesh in the port (`parallel/mesh.py` `shard_state`,
`shard_train_step`; the trainers' `mesh=`, `fsdp=` and `use_orbax=`) on the
CPU, on grids whose slots repeat the one CPU device, against the JAX
package's sharded steps on its 8 virtual CPU devices (tests/conftest.py).

Both packages start from the same parameters (`params_from_jax`) and see the
same draws: the JAX key split as the JAX loss splits it, handed to the port
as `CFMDraws` or `rand_frac` for the global batch (tests/test_torch_training.py).
Counterparts of tests/test_training.py (DP x TP, the SP step, param specs),
tests/test_grad_accum.py (grad_accum under a mesh, FSDP, the FSDP specs),
tests/test_duration_trainer.py (the duration step over a mesh, the manager's
"latest" resume) and tests/test_orbax_ckpt.py (the manager's round trip,
the trainer's "latest" resume, a sharded state restored over another
layout). Tolerances: the loss within 2e-5 of the JAX sharded step and of the
port's unsharded step; every parameter after one AdamW step at lr 1e-3
within 2e-5 of the port's unsharded step (the same float32 math summed in
another order), and against JAX within tests/test_torch_training.py's rule
(1e-4 = lr / 10, 99.9% within 1e-6: Adam's first update is about lr *
sign(g), so a gradient within a few eps of zero may move by a fraction of
lr), with proj_out's within the JAX suite's own 2e-5.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from f5_tts_tpu import config as jcfg
from f5_tts_tpu.models.cfm import F5TTS as JaxF5TTS
from f5_tts_tpu.models.duration import DurationPredictor as JaxDurationPredictor
from f5_tts_tpu.parallel import mesh as jmesh
from f5_tts_tpu.training import trainer as JT
from f5_tts_tpu.training.duration_trainer import make_duration_train_step as jax_duration_step
from f5_tts_tpu_torch import config as tcfg
from f5_tts_tpu_torch.models.cfm import F5TTS, CFMDraws
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.shard import gather_shards, shard_train_state
from f5_tts_tpu_torch.parallel import mesh as tmesh
from f5_tts_tpu_torch.training import checkpoints as C
from f5_tts_tpu_torch.training import trainer as T
from f5_tts_tpu_torch.training.duration_trainer import DurationTrainer, make_duration_train_step
from f5_tts_tpu_torch.utils.modules import init_parameters_


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """This file's torch work on one thread, restored after it. The suite's
    workers share the CPU's cores, and torch's default of one thread a core
    in each makes their OpenMP pools spin against each other: on an 8-core
    CPU, six concurrent runs of the scaling tool's sampling and pipeline
    halves took 414 s each so and 4.5 s each on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=256, text_dim=32,
            conv_layers=1)
DUR = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32, conv_layers=1)
FPS = 24_000 / 256
LR = 1e-3


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def cpu(n):
    return ["cpu"] * n


def _jax_params(tree, cfg) -> dict[str, np.ndarray]:
    return {k: v.numpy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree), cfg).items()}


def _jax_draws(key, b, n, cfm=jcfg.CFMConfig()) -> CFMDraws:
    """The draws of JAX `cfm_loss(key)` for a batch of b, split as it splits them."""
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


def _batch(b=4, n=48, seed=1, k=None):
    rng = np.random.default_rng(seed)
    lead = (b,) if k is None else (k, b)
    mel = rng.standard_normal(lead + (n, 100)).astype(np.float32)
    text = rng.integers(0, 255, lead + (20,)).astype(np.int32)
    text[..., 0, 12:] = -1
    lens = np.full(lead, n, np.int32)
    lens[..., -1] = n - 9
    return mel, text, lens


def _params(module) -> dict:
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def _close_to_jax(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    diffs = []
    for k, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref[k], atol=LR / 10, rtol=0, err_msg=k)
        diffs.append(np.abs(p.numpy() - ref[k]).ravel())
    assert np.mean(np.concatenate(diffs) <= 1e-6) >= 0.999
    np.testing.assert_allclose(got["proj_out.weight"].numpy(), ref["proj_out.weight"], atol=2e-5, rtol=0)


def _close(got: dict, want: dict, atol=2e-5):
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        torch.testing.assert_close(p, want[k], atol=atol, rtol=0, msg=k)


@pytest.fixture(scope="module")
def jax_params():
    return JaxF5TTS.init(jax.random.key(0), jcfg.DiTConfig(**TINY, use_flash_attention=False)).params


def _port_dit(jax_params, **cfg) -> DiT:
    dit = DiT(tcfg.DiTConfig(**{**TINY, **cfg}))
    dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_params), dit.cfg))
    return dit


def _jax_sharded(step_fn, params, batch, key, grad_accum=1, fsdp=False):
    """The JAX package's sharded step on its 4 x 2 mesh: (loss, params in
    the port's names)."""
    opt = JT.make_optimizer(LR, 1e-2, 1, 100)
    mesh = jmesh.create_mesh(data=4, model=2)
    params = jax.tree.map(lambda x: jnp.array(x, copy=True), params)  # the sharded step donates its state
    state = jmesh.shard_state(JT.init_train_state(params, opt), mesh, fsdp=fsdp)
    sharded = jmesh.shard_train_step(step_fn(opt), mesh, state, grad_accum=grad_accum, fsdp=fsdp)
    dsh = NamedSharding(mesh, PartitionSpec(*((None,) if grad_accum > 1 else ()), "data"))
    state, loss = sharded(state, *(jax.device_put(jnp.asarray(a), dsh) for a in batch), key)
    return float(loss), state


def _port_steps(model, make, batch, draws, grad_accum=1, fsdp=False, data=4, model_ways=2):
    """The port's unsharded step and its sharded step over a data x model
    grid of CPU slots, from the same parameters and draws: (unsharded loss,
    its parameters, sharded loss, the sharded state)."""
    opt = T.make_optimizer(LR, 1e-2, 1, 100)
    ref = type(model)(model.cfg)
    ref.load_state_dict(model.state_dict())
    step = make(opt, grad_accum)
    inputs = tuple(_t(a) for a in batch)
    loss1 = step(T.init_train_state(ref, opt), *inputs, draws=draws).item()
    mesh = tmesh.create_mesh(data=data, model=model_ways, devices=cpu(data * model_ways))
    state = shard_train_state(T.init_train_state(model, opt), mesh, fsdp=fsdp)
    sharded = tmesh.shard_train_step(step, mesh, state, grad_accum=grad_accum, fsdp=fsdp)
    loss2 = sharded(state, *inputs, draws=draws).item()
    return loss1, _params(ref), loss2, state


def _cfm_step(opt, k):
    return T.make_train_step(tcfg.CFMConfig(), opt, grad_accum=k)


def _jax_cfm_step(k):
    return lambda opt: JT.make_train_step(jcfg.DiTConfig(**TINY, use_flash_attention=False), jcfg.CFMConfig(), opt,
                                          grad_accum=k)


# ------------------------------------------------------------- DP x TP, FSDP, grad_accum


@pytest.mark.parametrize("fsdp", [False, True])
def test_dp_tp_step_matches_jax_sharded_and_unsharded(jax_params, fsdp):
    """4 x 2 (test_training.py:130, and test_grad_accum.py:146 with fsdp):
    the loss, and every parameter after one step."""
    batch = _batch()
    key = jax.random.key(3)
    jloss, jstate = _jax_sharded(_jax_cfm_step(1), jax_params, batch, key, fsdp=fsdp)
    loss1, params1, loss2, state = _port_steps(_port_dit(jax_params), _cfm_step, batch, _jax_draws(key, 4, 48),
                                               fsdp=fsdp)
    assert abs(loss2 - jloss) <= 2e-5 and abs(loss2 - loss1) <= 2e-5
    got = gather_shards(state)
    _close(got, params1)
    _close_to_jax(got, _jax_params(jstate["params"], tcfg.DiTConfig(**TINY)))
    if fsdp:  # ZeRO: a data row stores 1/data of each weight matrix, of its moments and EMA
        assert "data" in jstate["params"]["proj_out"]["kernel"].sharding.spec
        assert state.specs["proj_out.weight"] == ("data", None)
        assert state.params[0]["proj_out.weight"].shape == (25, 64)
        assert state.opt_state["mu"][0]["proj_out.weight"].shape == (25, 64)
        assert state.ema is None and state.leaves()[0]["proj_out.weight"].numel() == 0  # gathered at use only


def test_grad_accum_sharded_matches_jax_and_unsharded(jax_params):
    """grad_accum=2 under 4 x 2 (test_grad_accum.py:115): each microbatch
    splits over "data" as a step of one does."""
    batch = _batch(k=2)
    key = jax.random.key(3)
    jloss, jstate = _jax_sharded(_jax_cfm_step(2), jax_params, batch, key, grad_accum=2)
    draws = [_jax_draws(mk, 4, 48) for mk in jax.random.split(key, 2)]
    loss1, params1, loss2, state = _port_steps(_port_dit(jax_params), _cfm_step, batch, draws, grad_accum=2)
    assert abs(loss2 - jloss) <= 2e-5 and abs(loss2 - loss1) <= 2e-5
    got = gather_shards(state)
    _close(got, params1)
    _close_to_jax(got, _jax_params(jstate["params"], tcfg.DiTConfig(**TINY)))


@pytest.mark.parametrize("cfg", [dict(dropout=0.2), dict(dropout=0.2, remat=True)])
def test_dropout_and_remat_under_a_mesh_match_unsharded(jax_params, cfg):
    """With dropout each slot applies its slice of the unsharded mask (the
    data row's rows; a tensor-parallel slot's hidden columns), drawn from
    the same generator; with remat each group block is one checkpointed
    function whose recompute repeats the forward's reductions."""
    batch = _batch()

    def step_loss(sharded_grid):
        model = _port_dit(jax_params, **cfg)
        opt = T.make_optimizer(LR, 1e-2, 1, 100)
        step = _cfm_step(opt, 1)
        inputs = tuple(_t(a) for a in batch)
        gen = torch.Generator().manual_seed(7)
        if sharded_grid is None:
            return step(T.init_train_state(model, opt), *inputs, gen).item(), _params(model), None
        mesh = tmesh.create_mesh(**sharded_grid, devices=cpu(sharded_grid["data"] * sharded_grid["model"]))
        state = shard_train_state(T.init_train_state(model, opt), mesh)
        tmesh.reset_collective_counts()
        loss = tmesh.shard_train_step(step, mesh, state)(state, *inputs, gen).item()
        return loss, gather_shards(state), tmesh.collective_counts()

    loss1, params1, _ = step_loss(None)
    loss2, params2, counts = step_loss(dict(data=2, model=2))
    assert abs(loss2 - loss1) <= 2e-5
    _close(params2, params1)
    # 2 data rows x 2 blocks x 2 row-parallel linears: forward, backward (and with remat the recompute)
    assert counts["all_reduce_sum"] == 2 * 2 * 2 * (3 if cfg.get("remat") else 2)


@pytest.mark.parametrize("kind", ["dit", "duration"])
def test_both_trainers_train_over_a_seq_mesh(tmp_path, kind):
    """F5TTSTrainer and DurationTrainer over 1 x 2 x 2 (data x seq x model;
    the counterpart of test_training.py:159's mesh in a trainer): two steps
    from the same batches as an unsharded trainer, to the same parameters
    (float32 sums in another order)."""
    def run(mesh):
        if kind == "dit":
            trainer = T.F5TTSTrainer(F5TTS.init(torch.Generator().manual_seed(0), tcfg.DiTConfig(**TINY),
                                                device="cpu", cfm_cfg=tcfg.CFMConfig()),
                                     num_warmup_steps=1, results_dir=tmp_path / str(mesh), mesh=mesh)
            trainer.train(_dataset(2), total_steps=2, save_every=10**9, sample_every=10**9)
            return trainer, trainer.model.dit
        trainer = DurationTrainer(DurationPredictor.init(torch.Generator().manual_seed(0), tcfg.DurationConfig(**DUR),
                                                         device="cpu"),
                                  num_warmup_steps=1, results_dir=tmp_path / str(mesh), mesh=mesh)
        trainer.train(_duration_batches(2), learning_rate=LR, total_steps=2, save_every=10**9)
        return trainer, trainer.model

    mesh = tmesh.create_mesh(data=1, seq=2, model=2, devices=cpu(4))
    trainer, model = run(mesh)
    assert trainer.state.mesh is mesh and trainer.state.step == 2 and len(trainer.state.slots) == 4
    plain, plain_model = run(None)
    assert abs(float(trainer.last_loss) - float(plain.last_loss)) <= 2e-5
    _close(_params(model), _params(plain_model))


def test_seq_mesh_checkpoint_resumes_over_2x2_and_unsharded(tmp_path):
    """A trainer over 2 x 2 x 2 saves through the checkpoint manager (its
    layout records seq; the seq slots write nothing); trainers over 2 x 2,
    unsharded and 2 x 2 x 2 resume "latest" with the whole state and agree;
    and the 2 x 2 trainer's own checkpoint restores over 2 x 2 x 2."""
    def fresh(seed):
        return F5TTS.init(torch.Generator().manual_seed(seed), tcfg.DiTConfig(**TINY), device="cpu",
                          cfm_cfg=tcfg.CFMConfig())

    sp = tmesh.create_mesh(data=2, seq=2, model=2, devices=cpu(8))
    two = tmesh.create_mesh(data=2, model=2, devices=cpu(4))
    trainer = T.F5TTSTrainer(fresh(0), num_warmup_steps=1, results_dir=tmp_path, use_orbax=True, mesh=sp,
                             ema_decay=0.9)
    trainer.train(_dataset(2), total_steps=2, save_every=2, sample_every=10**9)
    trainer.ckpt_mgr.close()
    layout = json.loads((tmp_path / "checkpoints" / "2" / C.LAYOUT).read_text())
    assert layout["shape"] == {"data": 2, "seq": 2, "model": 2}
    owned = sum(tmesh.owns(tuple(spec), r, j) for spec in layout["specs"].values() for r in range(2)
                for j in range(2))
    from torch.distributed.checkpoint import FileSystemReader

    meta = FileSystemReader(tmp_path / "checkpoints" / "2").read_metadata().state_dict_metadata
    assert sum(k.startswith("params/") for k in meta) == owned

    runs = []
    for grid in (None, two, sp):
        resumed = T.F5TTSTrainer(fresh(1), num_warmup_steps=1, results_dir=tmp_path, use_orbax=True, mesh=grid,
                                 ema_decay=0.9)
        resumed.train(_dataset(1), total_steps=3, checkpoint="latest", save_every=10**9, sample_every=10**9)
        assert resumed.state.step == 3 and resumed.state.opt_state["count"] == 3
        if grid is two:
            mgr = C.TrainCheckpointManager(tmp_path / "from_2x2", async_save=False)
            mgr.save(3, resumed.state)
            back = mgr.restore(3, shard_train_state(_state(9, ema=True), sp))
            _assert_same_state(back, resumed.state)
        runs.append(_params(resumed.model.dit))
    _close(runs[1], runs[0])
    _close(runs[2], runs[0])


def test_split_microbatches_errors_match_jax():
    x = np.zeros((6, 3))
    for args in ((4, x), (2, x)):
        kw = {"data_size": 4 if args[0] == 2 else None}
        with pytest.raises(ValueError) as jerr:
            JT.split_microbatches(*args, **kw)
        with pytest.raises(ValueError) as terr:
            T.split_microbatches(*args, **kw)
        assert str(terr.value) == str(jerr.value)
    assert T.split_microbatches(2, x, data_size=3)[0].shape == (2, 3, 3)


# ------------------------------------------------------------- specs


def _marked_specs(tree, specs, axis, cfg) -> dict:
    """The JAX tree with each leaf replaced by the index along the dim its
    spec puts on `axis` (zeros where none), in the port's names."""
    def marker(leaf, spec):
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        if axis not in entries:
            return np.zeros(leaf.shape, np.float32)
        return np.indices(leaf.shape)[entries.index(axis)].astype(np.float32)

    return params_from_jax(jax.tree.map(marker, tree, specs, is_leaf=lambda x: isinstance(x, PartitionSpec)), cfg)


@pytest.mark.parametrize("kind, data", [("dit", 2), ("dit", 4), ("duration", 2)])
def test_fsdp_specs_match_jax(kind, data):
    """`param_specs(fsdp_data_size=)` shards the same dim of every tensor
    over "data" and over "model" as JAX's `param_specs` (test_training.py:302,
    test_grad_accum.py:187): only 2-D matrices, the largest free dim that
    data divides (ties to the input dim), the text embedding exempt."""
    if kind == "dit":
        cfg = tcfg.DiTConfig(**{**TINY, "depth": 4})
        tree = JaxF5TTS.init(jax.random.key(0), jcfg.DiTConfig(**{**TINY, "depth": 4}, use_flash_attention=False)).params
    else:
        cfg = tcfg.DurationConfig(**DUR)
        tree = JaxDurationPredictor.init(jax.random.key(0), jcfg.DurationConfig(**DUR)).params
    tree = jax.tree.map(np.asarray, tree)
    specs = jmesh.param_specs(tree, fsdp_data_size=data)
    port = tmesh.param_specs(params_from_jax(tree, cfg), fsdp_data_size=data)
    for axis in ("model", "data"):
        marked = _marked_specs(tree, specs, axis, cfg)
        for name, spec in port.items():
            t = marked[name]
            want = (torch.from_numpy(np.indices(t.shape)[spec.index(axis)].astype(np.float32)) if axis in spec
                    else torch.zeros_like(t))
            assert torch.equal(t, want), (axis, name, spec)
    sharded = [n for n, s in port.items() if "data" in s]
    assert sharded and not any(n.startswith(("text_embed.", "transformer.text_embed.")) for n in sharded)
    assert all(len(s) == 2 for n, s in port.items() if "data" in s)
    if kind == "dit":
        # proj_out [mel 100, dim 64] and input_embed.proj [dim 64, 2 mel + text_dim 232]: the larger dim
        assert port["proj_out.weight"] == ("data", None) and port["input_embed.proj.weight"] == (None, "data")
        assert port["transformer_blocks.0.attn.to_q.weight"] == ("model", "data")
        assert port["transformer_blocks.0.attn.to_out.0.weight"] == ("data", "model")
        assert port["transformer_blocks.0.attn.to_out.0.bias"] == (None,)


def test_state_specs_mirror_the_params():
    dit = DiT(tcfg.DiTConfig(**TINY))
    state = T.init_train_state(dit, T.make_optimizer(), ema=True)
    specs = tmesh.state_specs(state, fsdp_data_size=2)
    assert specs["mu"] == specs["nu"] == specs["ema"] == specs["params"] == tmesh.param_specs(dit, 2)
    assert tmesh.state_specs(T.init_train_state(dit, T.make_optimizer()))["ema"] is None


# ------------------------------------------------------------- duration


@pytest.fixture(scope="module")
def duration_models():
    jp = JaxDurationPredictor.init(jax.random.key(3), jcfg.DurationConfig(**DUR, use_flash_attention=False)).params
    port = DurationPredictor(tcfg.DurationConfig(**DUR))
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp), port.cfg))
    return jp, port


def test_duration_sharded_step_matches_jax_and_unsharded(duration_models):
    """The duration step over 4 x 2 (test_duration_trainer.py:107)."""
    jp, port = duration_models
    rng = np.random.default_rng(9)
    batch = (rng.standard_normal((4, 40, 100)).astype(np.float32), rng.integers(0, 200, (4, 8)).astype(np.int32),
             np.array([40, 31, 40, 22], np.int32))
    key = jax.random.key(4)
    jloss, jstate = _jax_sharded(lambda opt: jax_duration_step(jcfg.DurationConfig(**DUR, use_flash_attention=False),
                                                               opt, FPS), jp, batch, key)
    rand_frac = _t(jax.random.uniform(jax.random.split(key)[0], (4,)))
    loss1, params1, loss2, state = _port_steps(port, lambda opt, k: make_duration_train_step(opt, FPS, grad_accum=k),
                                               batch, rand_frac)
    assert abs(loss2 - jloss) <= 2e-5 and abs(loss2 - loss1) <= 2e-5
    got = gather_shards(state)
    _close(got, params1)
    ref = _jax_params(jstate["params"], tcfg.DurationConfig(**DUR))
    for k, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref[k], atol=LR / 10, rtol=0, err_msg=k)


def _duration_batches(n, b=4, frames=40, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield {"mel_spec": rng.standard_normal((b, frames, 100)).astype(np.float32),
               "mel_len": np.full((b,), frames, np.int32),
               "transcript": rng.integers(0, 200, (b, 8)).astype(np.int32)}


def test_duration_trainer_mesh_and_manager_latest(tmp_path):
    """DurationTrainer(mesh=, fsdp=, use_orbax=True) saves through the
    manager, and a fresh unsharded trainer resumes "latest" from it
    (test_duration_trainer.py:91)."""
    def fresh(seed):
        return DurationPredictor.init(torch.Generator().manual_seed(seed), tcfg.DurationConfig(**DUR), device="cpu")

    mesh = tmesh.create_mesh(data=2, model=2, devices=cpu(4))
    trainer = DurationTrainer(fresh(0), num_warmup_steps=2, results_dir=tmp_path, use_orbax=True, mesh=mesh,
                              fsdp=True, ema_decay=0.9)
    trainer.train(_duration_batches(4), learning_rate=1e-4, total_steps=4, save_every=2)
    trainer.ckpt_mgr.close()
    assert trainer.ckpt_mgr.all_steps() == [2, 4] and trainer.state.step == 4
    assert {"duration_4.safetensors", "duration_4.ema.safetensors"} <= set(os.listdir(tmp_path))
    trained = _params(trainer.model)

    resumed = DurationTrainer(fresh(5), num_warmup_steps=2, results_dir=tmp_path, use_orbax=True, ema_decay=0.9)
    resumed.ckpt_mgr = C.TrainCheckpointManager(tmp_path / "checkpoints")
    resumed.state = T.init_train_state(resumed.model, T.make_optimizer(), ema=True)
    resumed.state = C.restore_orbax_adapting_ema(resumed.ckpt_mgr, 4, resumed.state)
    _close(_params(resumed.model), trained, atol=0)
    resumed.train(_duration_batches(2), learning_rate=1e-4, total_steps=6, save_every=10**9, checkpoint="latest")
    assert resumed.state.step == 6


# ------------------------------------------------------------- the checkpoint manager


def _state(seed, ema=False):
    dit = DiT(tcfg.DiTConfig(**TINY))
    init_parameters_(dit, torch.Generator().manual_seed(seed))
    return T.init_train_state(dit, T.make_optimizer(LR, 1e-2, 1, 10), ema=ema)


def _trained(state, steps=1):
    """`steps` updates of a state on a fixed batch, so that moments and EMA
    are not zeros."""
    step = T.make_train_step(tcfg.CFMConfig(), T.make_optimizer(LR, 1e-2, 1, 10),
                             ema_decay=None if state.ema is None else 0.9)
    for _ in range(steps):
        step(state, *(_t(a) for a in _batch()), torch.Generator().manual_seed(1))
    return state


def _flat(state) -> dict:
    if isinstance(state, tmesh.ShardedTrainState):
        return tmesh.gather_state(state)
    return {"params": _params(state.model), "mu": state.opt_state["mu"], "nu": state.opt_state["nu"],
            "ema": state.ema, "count": state.opt_state["count"], "step": state.step}


def _assert_same_state(a, b):
    fa, fb = _flat(a), _flat(b)
    for kind in ("params", "mu", "nu", "ema"):
        if fa[kind] is None:
            assert fb[kind] is None
            continue
        _close(fa[kind], fb[kind], atol=0)
    assert (fa["count"], fa["step"]) == (fb["count"], fb["step"])


def test_manager_round_trip(tmp_path):
    """The counterpart of test_orbax_ckpt.py:20: save, wait, latest_step,
    restore into a fresh state, equal to the bit; retention keeps 3."""
    state = _trained(_state(0, ema=True))
    mgr = C.TrainCheckpointManager(tmp_path / "ckpt", async_save=False)
    mgr.save(3, state)
    mgr.wait()
    assert mgr.latest_step() == 3 and mgr.all_steps() == [3]
    restored = mgr.restore(3, _state(9, ema=True))
    _assert_same_state(restored, state)
    with pytest.raises(ValueError, match="EMA"):
        mgr.restore(3, _state(9))
    for step in (4, 5, 6):
        mgr.save(step, state)
    mgr.close()
    assert mgr.all_steps() == [4, 5, 6]


def test_manager_async_sharded_state_restores_over_other_layouts(tmp_path):
    """A state sharded over 2 x 2 with FSDP is written without gathering
    (each piece once, asynchronously: the save returns before the files are
    committed and the state may move on) and restores over the same layout,
    unsharded, and over 4 x 2; an unsharded save restores sharded (the
    counterpart of test_orbax_ckpt.py's elastic resharding)."""
    reference = _trained(_state(0, ema=True))
    mesh = tmesh.create_mesh(data=2, model=2, devices=cpu(4))
    sharded = shard_train_state(_trained(_state(0, ema=True)), mesh, fsdp=True)
    mgr = C.TrainCheckpointManager(tmp_path / "ckpt")
    mgr.save(1, sharded)
    with torch.no_grad():  # the staged copy is what is written
        for t in sharded.params[0].values():
            t.add_(1.0)
    mgr.wait()
    assert mgr.latest_step() == 1
    keys = [k for k in os.listdir(tmp_path / "ckpt" / "1")]
    assert "layout.json" in keys and ".metadata" in keys

    back = mgr.restore(1, shard_train_state(_state(9, ema=True), mesh, fsdp=True))
    _assert_same_state(back, reference)
    _assert_same_state(mgr.restore(1, _state(9, ema=True)), reference)
    wide = tmesh.create_mesh(data=4, model=2, devices=cpu(8))
    _assert_same_state(mgr.restore(1, shard_train_state(_state(9, ema=True), wide)), reference)
    mgr.save(2, reference)
    _assert_same_state(mgr.restore(2, shard_train_state(_state(9, ema=True), mesh, fsdp=True)), reference)
    mgr.close()


def _dataset(n=6, b=4):
    for i in range(n):
        yield {"mel_spec": np.random.default_rng(i).standard_normal((b, 32, 100)).astype(np.float32),
               "mel_len": np.full((b,), 32, np.int32),
               "transcript": np.zeros((b, 8), np.int32)}


def test_trainer_manager_latest_resume_over_a_mesh(tmp_path):
    """The counterpart of test_orbax_ckpt.py:46: a trainer over 2 x 2 saves
    through the manager at steps 2 and 4; a fresh trainer resumes "latest"
    (the manager's step 4, not a newer weights file) with the whole state,
    and a sharded and an unsharded continuation agree."""
    def fresh(seed):
        return F5TTS.init(torch.Generator().manual_seed(seed), tcfg.DiTConfig(**TINY), device="cpu",
                          cfm_cfg=tcfg.CFMConfig())

    mesh = tmesh.create_mesh(data=2, model=2, devices=cpu(4))
    trainer = T.F5TTSTrainer(fresh(0), num_warmup_steps=1, results_dir=tmp_path, use_orbax=True, mesh=mesh,
                             ema_decay=0.9)
    trainer.train(_dataset(), total_steps=4, save_every=2, sample_every=10**9)
    assert trainer.ckpt_mgr.all_steps() == [2, 4]
    assert not list(tmp_path.glob("*.trainstate.safetensors"))
    (tmp_path / "f5tts_5.safetensors").write_bytes((tmp_path / "f5tts_4.safetensors").read_bytes())
    assert C.latest_checkpoint_step(tmp_path, "f5tts_", trainer.ckpt_mgr) == 4

    runs = []
    for grid in (None, mesh):
        resumed = T.F5TTSTrainer(fresh(1), num_warmup_steps=1, results_dir=tmp_path, use_orbax=True, mesh=grid,
                                 ema_decay=0.9)
        resumed.train(_dataset(), total_steps=6, checkpoint="latest", save_every=10**9, sample_every=10**9)
        assert resumed.state.step == 6 and resumed.state.opt_state["count"] == 6
        runs.append(_params(resumed.model.dit))
    fresh_params = _params(fresh(1).dit)
    assert not torch.allclose(runs[0]["proj_out.weight"], fresh_params["proj_out.weight"])
    _close(runs[1], runs[0])


def test_sharded_trainer_files_load_in_the_jax_package_and_resume_unsharded(tmp_path):
    """save_checkpoint gathers the shards: the MLX-named files of a 2 x 2
    FSDP trainer load in the JAX package's convert_dit_state to the bit,
    and an unsharded trainer loads them and continues."""
    from safetensors.numpy import load_file as ref_load

    from f5_tts_tpu.models.convert import convert_dit_state as jax_convert

    mesh = tmesh.create_mesh(data=2, model=2, devices=cpu(4))
    model = F5TTS.init(torch.Generator().manual_seed(0), tcfg.DiTConfig(**TINY), device="cpu",
                       cfm_cfg=tcfg.CFMConfig())
    trainer = T.F5TTSTrainer(model, num_warmup_steps=1, results_dir=tmp_path, ema_decay=0.9, mesh=mesh, fsdp=True)
    trainer.train(_dataset(2), total_steps=2, save_every=2, sample_every=10**9)
    full = tmesh.gather_state(trainer.state)
    for suffix, want in (("", full["params"]), (".ema", full["ema"])):
        back = _jax_params(jax_convert(ref_load(str(tmp_path / f"f5tts_2{suffix}.safetensors")),
                                       jcfg.DiTConfig(**TINY)), tcfg.DiTConfig(**TINY))
        for k, v in want.items():
            np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    _close(_params(model.dit), full["params"], atol=0)

    resumed = T.F5TTSTrainer(F5TTS.init(torch.Generator().manual_seed(3), tcfg.DiTConfig(**TINY), device="cpu",
                                        cfm_cfg=tcfg.CFMConfig()), num_warmup_steps=1, results_dir=tmp_path,
                             ema_decay=0.9)
    resumed.train(_dataset(1), total_steps=3, checkpoint="latest", save_every=10**9, sample_every=10**9)
    assert resumed.state.step == 3 and resumed.state.opt_state["count"] == 3


def test_scaling_tool_training_half_on_the_cpu(capsys):
    """The port's `tools/scaling.py` training half: grids of 1, 2 and 4
    slots, FSDP on 4 and sequence parallelism on 4 (1 x 2 x 2) train what 1
    slot does (float32 sums in another order), with 2 row-parallel sums a
    block a tensor-parallel group forward and as many backward, under FSDP
    one gather and one reduce-scatter a matrix a group, and under SP one
    key and value gather an attention a model column and its reduce-scatter
    in the backward."""
    from f5_tts_tpu_torch.tools import scaling

    rows = scaling.training_rows([1, 2, 4], "cpu")
    assert [r["mesh"] for r in rows] == ["1x1", "1x2", "2x2", "2x2 FSDP", "1x2x2 SP"]
    depth, steps = scaling.CFG.depth, scaling.TRAIN_STEPS
    assert [r["collectives"]["all_reduce_sum"] for r in rows] == [0, 2 * 2 * depth * steps, 2 * 2 * 2 * depth * steps,
                                                                 2 * 2 * 2 * depth * steps, 2 * 2 * 2 * depth * steps]
    assert rows[3]["collectives"]["all_gather"] == rows[3]["collectives"]["reduce_scatter"] > 0
    assert all(r["collectives"]["all_gather"] == 0 for i, r in enumerate(rows) if i != 3)
    assert rows[-1]["collectives"]["seq_all_gather"] == rows[-1]["collectives"]["seq_reduce_scatter"] == \
        2 * depth * steps
    assert all(r["collectives"]["seq_all_gather"] == 0 for r in rows[:-1])
    assert all(r["max_abs_delta_loss"] < 1e-5 for r in rows)
    assert "1x2x2 SP" in capsys.readouterr().out
