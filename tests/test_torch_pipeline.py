"""Pipeline parallelism in the port (parallel/pipeline.py): GPipe over a
"stage" axis against the JAX package's `dit_forward_pipelined` on its 8
virtual CPU devices (tests/conftest.py) and its sequential `dit_forward`,
with the port's grids repeating the one CPU device and
tests/test_pipeline.py's tiny config (dim 64, depth 4, 2 heads of 32,
float32). Both packages load that file's parameters (`params_from_jax`)
and take the same inputs, from numpy seeds.

Tolerances as the JAX suite's: the forward within atol = rtol = 1e-5 of
both JAX forwards, the gradients with respect to x and to every block's
feed-forward w1 within atol 2e-4, rtol 1e-4 of the JAX pipeline's. Dropout
has no JAX counterpart to match (JAX draws per microbatch): the pipelined
forward is held to the port's unpipelined `DiT.forward_train` under one
generator within 1e-5. The handoffs and the attention calls (K1's and K2's
plain versions on the CPU) are counted exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f5_tts_tpu import config as jcfg
from f5_tts_tpu.models.dit import dit_forward, init_dit
from f5_tts_tpu.parallel import pipeline as jpipe
from f5_tts_tpu_torch import config as tcfg
from f5_tts_tpu_torch.models.convert import params_from_jax
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.ops import flash_attention as fa
from f5_tts_tpu_torch.parallel import mesh as tmesh
from f5_tts_tpu_torch.parallel.pipeline import (
    create_pipeline_mesh,
    dit_forward_pipelined,
    pipeline_param_specs,
    shard_params_for_pipeline,
)

TINY = dict(dim=64, depth=4, heads=2, dim_head=32, ff_mult=2, mel_dim=20, text_num_embeds=40, text_dim=32,
            conv_layers=1, use_flash_attention=False, compute_dtype="float32")
JCFG = jcfg.DiTConfig(**TINY)
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=2e-4, rtol=1e-4)


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


def cpu(n):
    return ["cpu"] * n


def _inputs(batch=8, n=48, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n, TINY["mel_dim"])).astype(np.float32),
            rng.standard_normal((batch, n, TINY["mel_dim"])).astype(np.float32),
            rng.integers(-1, TINY["text_num_embeds"], (batch, n)).astype(np.int32),
            rng.uniform(size=batch).astype(np.float32))


def _torch(arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.fixture(scope="module")
def jax_params():
    """tests/test_pipeline.py's parameters (jitted: the same bits, one
    compile instead of an eager op at a time)."""
    return jax.jit(init_dit, static_argnums=1)(jax.random.key(7), JCFG)


_dit_forward = jax.jit(dit_forward, static_argnums=1)


@pytest.fixture(scope="module")
def dit(jax_params):
    model = DiT(tcfg.DiTConfig(**TINY))
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_params), model.cfg))
    return model


@pytest.fixture(scope="module")
def jax_sequential(jax_params):
    """JAX `dit_forward` of the batch-8 inputs, once for the module."""
    return np.asarray(_dit_forward(jax_params, JCFG, *map(jnp.asarray, _inputs())))


def _jax_pipelined(params, stages, data, microbatches, inputs, **kw):
    mesh = jpipe.create_pipeline_mesh(stages=stages, data=data)
    placed = jpipe.shard_params_for_pipeline(params, mesh)
    fn = jax.jit(lambda p, *a: jpipe.dit_forward_pipelined(p, JCFG, *a, mesh=mesh, num_microbatches=microbatches,
                                                           **kw))
    return np.asarray(fn(placed, *map(jnp.asarray, inputs)))


def _port(dit, stages, data, microbatches, inputs, **kw):
    pipelined = shard_params_for_pipeline(dit, create_pipeline_mesh(stages, data, cpu(stages * data)))
    with torch.no_grad():
        return dit_forward_pipelined(pipelined, *_torch(inputs), num_microbatches=microbatches, **kw).numpy()


def test_create_pipeline_mesh_and_specs(dit, jax_params):
    mesh = create_pipeline_mesh(4, data=2, devices=cpu(9))
    assert mesh.axis_names == ("data", "stage") and mesh.shape == {"data": 2, "stage": 4}
    assert mesh.axis_names == jpipe.create_pipeline_mesh(stages=4, data=2).axis_names
    with pytest.raises(ValueError, match="needs 8 devices, have 7"):
        create_pipeline_mesh(4, data=2, devices=cpu(7))
    specs = pipeline_param_specs(dit)
    assert sorted(specs) == sorted(dit.state_dict())
    for name, spec in specs.items():
        t = dit.state_dict()[name]
        if name.startswith("transformer_blocks."):
            assert spec == ("stage",) + (None,) * t.ndim, name
        else:
            assert spec == (None,) * t.ndim, name
    # the JAX rule: every stacked block leaf leads with "stage", every other leaf replicated
    jspecs = jpipe.pipeline_param_specs(jax_params)
    assert all(s[0] == "stage" for s in jax.tree.leaves(jspecs["blocks"], is_leaf=lambda x: isinstance(x, tuple)))
    assert all(tuple(s) == () for k, v in jspecs.items() if k != "blocks"
               for s in jax.tree.leaves(v, is_leaf=lambda x: isinstance(x, tuple)))
    # stage s holds blocks [s depth / S, (s + 1) depth / S) on its device, the rest on the first stage's
    pipelined = shard_params_for_pipeline(dit, create_pipeline_mesh(2, devices=cpu(2)))
    assert [len(stage) for stage in pipelined.stages[0]] == [2, 2]
    assert torch.equal(pipelined.block(3).ff.ff[0][0].weight, dit.transformer_blocks[3].ff.ff[0][0].weight)
    assert pipelined.block(3).ff.ff[0][0].weight is not dit.transformer_blocks[3].ff.ff[0][0].weight
    assert len(pipelined.trunks[0].transformer_blocks) == 0


@pytest.mark.parametrize("stages,microbatches", [(2, 1), (2, 4), (4, 2), (4, 4)])
def test_pipelined_forward_matches_jax(dit, jax_params, jax_sequential, stages, microbatches):
    inputs = _inputs()
    got = _port(dit, stages, 1, microbatches, inputs)
    np.testing.assert_allclose(got, _jax_pipelined(jax_params, stages, 1, microbatches, inputs), **TOL)
    np.testing.assert_allclose(got, jax_sequential, **TOL)


def test_pipelined_forward_with_mask_and_drops(dit, jax_params):
    inputs = _inputs(batch=4)
    mask = np.arange(48)[None, :] < np.array([48, 30, 17, 48])[:, None]
    drop_a, drop_t = np.array([True, False, True, False]), np.array([False, False, True, True])
    got = _port(dit, 4, 1, 2, inputs, mask=torch.tensor(mask), drop_audio_cond=torch.tensor(drop_a),
                drop_text=torch.tensor(drop_t))
    kw = dict(mask=jnp.asarray(mask), drop_audio_cond=jnp.asarray(drop_a), drop_text=jnp.asarray(drop_t))
    np.testing.assert_allclose(got, _jax_pipelined(jax_params, 4, 1, 2, inputs, **kw), **TOL)
    with torch.no_grad():
        unpipelined = dit.forward_train(*_torch(inputs), mask=torch.tensor(mask),
                                        drop_audio_cond=torch.tensor(drop_a), drop_text=torch.tensor(drop_t))
    np.testing.assert_allclose(got, unpipelined.numpy(), **TOL)


def test_pipeline_composes_with_data_axis(dit, jax_params, jax_sequential):
    inputs = _inputs()
    got = _port(dit, 4, 2, 2, inputs)
    np.testing.assert_allclose(got, _jax_pipelined(jax_params, 4, 2, 2, inputs), **TOL)
    np.testing.assert_allclose(got, jax_sequential, **TOL)


def test_pipelined_gradient_matches_jax(dit, jax_params):
    """The gradient of sum(out^2) with respect to x and to every block's
    feed-forward w1, stage 2 x M 2, against JAX's gradient through its
    pipeline; each block's gradient lands on its stage's copy."""
    x, cond, text, time = _inputs(batch=4)
    mesh = jpipe.create_pipeline_mesh(stages=2, data=1)
    placed = jpipe.shard_params_for_pipeline(jax_params, mesh)

    def loss(p, xx):
        return jnp.sum(jpipe.dit_forward_pipelined(p, JCFG, xx, jnp.asarray(cond), jnp.asarray(text),
                                                   jnp.asarray(time), mesh=mesh, num_microbatches=2) ** 2)

    g_params, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(placed, jnp.asarray(x))
    w1 = np.asarray(g_params["blocks"]["ff"]["w1"]["kernel"])  # [depth, in, out]

    pipelined = shard_params_for_pipeline(dit, create_pipeline_mesh(2, devices=cpu(2)))
    xt = torch.tensor(x, requires_grad=True)
    out = dit_forward_pipelined(pipelined, xt, *_torch((cond, text, time)), num_microbatches=2)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **GRAD_TOL)
    for i in range(TINY["depth"]):
        np.testing.assert_allclose(pipelined.block(i).ff.ff[0][0].weight.grad.numpy().T, w1[i], **GRAD_TOL)
    assert dit.transformer_blocks[0].ff.ff[0][0].weight.grad is None


def test_pipeline_raises_on_what_it_cannot_split(dit):
    with pytest.raises(ValueError, match="no 'stage' axis"):
        shard_params_for_pipeline(dit, tmesh.create_mesh(data=2, model=2, devices=cpu(4)))
    shallow = DiT(tcfg.DiTConfig(**{**TINY, "depth": 3}))
    with pytest.raises(ValueError, match="divisible"):
        shard_params_for_pipeline(shallow, create_pipeline_mesh(4, devices=cpu(4)))
    pipelined = shard_params_for_pipeline(dit, create_pipeline_mesh(2, data=2, devices=cpu(4)))
    with pytest.raises(ValueError, match="not divisible by num_microbatches=4"):
        dit_forward_pipelined(pipelined, *_torch(_inputs(batch=4)), num_microbatches=4)


def test_pipelined_dropout_is_the_unpipelined_forward(dit):
    """Dropout at rate 0.3 over data 2 x stage 2, M 2: equal to the port's
    unpipelined `forward_train` under the same generator (each microbatch
    keeps its rows of the global batch's mask); the same seed gives the same
    output, another seed another; rate 0 with a generator is the
    deterministic path; every gradient is finite."""
    dropped = DiT(dit.cfg.replace(dropout=0.3))
    dropped.load_state_dict(dit.state_dict())
    pipelined = shard_params_for_pipeline(dropped, create_pipeline_mesh(2, data=2, devices=cpu(4)))
    inputs = _torch(_inputs())

    def run(seed, module=pipelined):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return dit_forward_pipelined(module, *inputs, num_microbatches=2, generator=gen)

    with torch.no_grad():
        ref = dropped.forward_train(*inputs, generator=torch.Generator().manual_seed(3))
    out = run(3)
    torch.testing.assert_close(out, ref, **TOL)
    assert torch.equal(out, run(3))
    assert (out - run(4)).abs().max() > 1e-4 and (out - run(None)).abs().max() > 1e-4
    plain = shard_params_for_pipeline(dit, create_pipeline_mesh(2, data=2, devices=cpu(4)))
    assert torch.equal(run(3, plain), run(None, plain))

    out = dit_forward_pipelined(pipelined, *inputs, num_microbatches=2, generator=torch.Generator().manual_seed(5))
    (out ** 2).mean().backward()
    grads = [p.grad for p in pipelined.parameters()]
    assert len(grads) == len(list(dit.parameters())) and all(g is not None and g.isfinite().all() for g in grads)


@pytest.mark.parametrize("data,stages,microbatches", [(1, 2, 2), (2, 4, 2), (1, 4, 1)])
def test_handoffs_and_attention_calls_are_counted(dit, monkeypatch, data, stages, microbatches):
    """A forward makes (S - 1) M handoffs and one move to the head a data
    row, and calls the attention's forward depth x M times a data row on
    b / (data M) rows each (K1's plain version here); the backward calls
    K2's plain version as often; the bubble's ticks run nothing."""
    calls = {"fwd": [], "bwd": 0}
    fwd, bwd = fa.flash_attention_plain, fa.flash_attention_bwd_plain

    def counted_fwd(q, *a, **k):
        calls["fwd"].append(q.shape[0])
        return fwd(q, *a, **k)

    def counted_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_plain", counted_fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", counted_bwd)
    b, depth = 8, TINY["depth"]
    pipelined = shard_params_for_pipeline(dit, create_pipeline_mesh(stages, data, cpu(stages * data)))
    x, cond, text, time = _torch(_inputs(batch=b))
    x.requires_grad_(True)
    tmesh.reset_collective_counts()
    out = dit_forward_pipelined(pipelined, x, cond, text, time, num_microbatches=microbatches)
    counts = tmesh.collective_counts()
    assert counts["stage_send"] == data * (stages - 1) * microbatches and counts["stage_to_head"] == data
    assert calls["fwd"] == [b // (data * microbatches)] * (data * depth * microbatches)
    out.sum().backward()
    assert calls["bwd"] == data * depth * microbatches
    assert tmesh.collective_counts()["stage_send"] == counts["stage_send"]


def _refusers():
    """Each user of a mesh other than the pipeline, as a call on a mesh."""
    from f5_tts_tpu_torch.models.cfm import F5TTS
    from f5_tts_tpu_torch.models.duration import DurationPredictor
    from f5_tts_tpu_torch.models.shard import shard_model_for_inference, shard_train_state
    from f5_tts_tpu_torch.training import trainer as T
    from f5_tts_tpu_torch.training.duration_trainer import DurationTrainer

    def model():
        return F5TTS.init(torch.Generator().manual_seed(0), tcfg.DiTConfig(**TINY), device="cpu")

    def state():
        return T.init_train_state(model().dit, T.make_optimizer(1e-3, total_steps=10))

    return {
        "use_mesh": lambda mesh: model().use_mesh(mesh),
        "shard_model_for_inference": lambda mesh: shard_model_for_inference(model().dit, mesh),
        "shard_train_state": lambda mesh: shard_train_state(state(), mesh),
        "shard_state": lambda mesh: tmesh.shard_state(state(), mesh, []),
        "shard_train_step": lambda mesh: tmesh.shard_train_step(
            T.make_train_step(tcfg.CFMConfig(), T.make_optimizer(1e-3, total_steps=10)), mesh),
        "F5TTSTrainer": lambda mesh: T.F5TTSTrainer(model(), mesh=mesh),
        "DurationTrainer": lambda mesh: DurationTrainer(
            DurationPredictor.init(torch.Generator().manual_seed(0), tcfg.DurationConfig(
                dim=64, depth=2, heads=2, dim_head=32, text_dim=32, conv_layers=1), device="cpu"), mesh=mesh),
    }


@pytest.mark.parametrize("user", ["use_mesh", "shard_model_for_inference", "shard_train_state", "shard_state",
                                  "shard_train_step", "F5TTSTrainer", "DurationTrainer"])
def test_mesh_users_refuse_a_stage_axis(user):
    with pytest.raises(ValueError, match="a 'stage' axis is the pipeline's"):
        _refusers()[user](create_pipeline_mesh(2, data=2, devices=cpu(4)))


def test_scaling_tool_pipeline_half_on_the_cpu():
    """The port's `tools/scaling.py` pipeline half: data x stage 1 x 2,
    1 x 4 and 2 x 4 at depth 4 with 2 microbatches, each forward within
    5e-5 of the unpipelined one, with (S - 1) M handoffs and one move to
    the head a data row."""
    from f5_tts_tpu_torch.tools import scaling

    rows = scaling.pipeline_rows("cpu")
    assert [(r["data"], r["stages"]) for r in rows] == [(1, 2), (1, 4), (2, 4)]
    assert all(r["max_abs_delta"] < 5e-5 for r in rows)
    assert [(r["handoffs"]["stage_send"], r["handoffs"]["stage_to_head"]) for r in rows] == [(2, 1), (6, 1), (12, 2)]
