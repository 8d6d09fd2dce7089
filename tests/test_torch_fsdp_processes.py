"""FSDP across processes in the port (parallel/mesh.py, parallel/distributed.py,
training/checkpoints.py): under `fsdp=True` with W processes of `data` local
rows, each weight matrix, its AdamW moments and its EMA are sharded over the
global data axis of data x W rows, global row `rank x data + r` storing
piece `rank x data + r` (the device order of a JAX mesh over every process's
devices); the pieces are gathered and the gradients reduce-scattered across
the processes, and each process writes the checkpoint pieces of its own
global rows.

Two real gloo ranks over loopback, each over a 2 x 2 (data x model) grid of
CPU slots, take one FSDP step against the JAX package's FSDP step on its
4 x 2 mesh of 8 virtual CPU devices (tests/conftest.py), from the same
parameters (`params_from_jax`) and draws, and against the port's own
one-process 4 x 2 FSDP step; the same ranks then step over 1 x 2 x 1
(data x seq x model) against one process's 2 x 2 x 1. Both trainers train
one step from a WAV tree on two ranks with `fsdp=True` and
`use_orbax=True`, and their checkpoint restores unsharded and over a
one-process 2 x 2 grid to the bit of the ranks' gathered state. One
process with `process_count`/`process_index` monkeypatched (as
tests/test_torch_distributed.py does) checks the specs against JAX's for
the global data size, that the two ranks' checkpoint keys of a sharded
tensor are disjoint, and that the gradient's norm counts a replicated
tensor once.

Tolerances as in tests/test_torch_mesh_training.py's FSDP test: the loss
within 2e-5 of the JAX sharded step and of the port's one-process step;
every parameter within 2e-5 of the port's one-process step, and against
JAX within lr / 10 with 99.9% within 1e-6 and proj_out within 2e-5.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from f5_tts_tpu import config as jcfg
from f5_tts_tpu.models.convert import convert_dit_state as jax_convert
from f5_tts_tpu.parallel import mesh as jmesh
from f5_tts_tpu_torch import config as tcfg
from f5_tts_tpu_torch.models.cfm import F5TTS, CFMDraws
from f5_tts_tpu_torch.models.convert import export_mlx_state, params_from_jax, to_mlx_model_naming
from f5_tts_tpu_torch.models.dit import DiT
from f5_tts_tpu_torch.models.duration import DurationPredictor
from f5_tts_tpu_torch.models.shard import gather_shards, shard_train_state
from f5_tts_tpu_torch.parallel import distributed as D
from f5_tts_tpu_torch.parallel import mesh as tmesh
from f5_tts_tpu_torch.training import checkpoints as C
from f5_tts_tpu_torch.training import trainer as T
from f5_tts_tpu_torch.utils.modules import init_parameters_

REPO = Path(__file__).resolve().parent.parent
TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=256, text_dim=32,
            conv_layers=1)
DUR = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, text_dim=32, conv_layers=1)
LR = 1e-3


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def cpu(n):
    return ["cpu"] * n


def _jax_draws(key, b, n) -> dict:
    """The draws of JAX `cfm_loss(key)` for a batch of b, split as it
    splits them, as `CFMDraws` fields."""
    k_frac, k_span, k_x0, k_time, k_adrop, k_tdrop, _ = jax.random.split(key, 7)
    lo, hi = jcfg.CFMConfig().frac_lengths_mask
    return dict(frac_lengths=_t(jax.random.uniform(k_frac, (b,), minval=lo, maxval=hi)),
                span_start=_t(jax.random.uniform(k_span, (b,))),
                x0=_t(jax.random.normal(k_x0, (b, n, 100), dtype=np.float32)),
                time=_t(jax.random.uniform(k_time, (b,), dtype=np.float32)),
                audio_drop=_t(jax.random.uniform(k_adrop, (1,))),
                text_drop=_t(jax.random.uniform(k_tdrop, (1,))))


def _batch(b=4, n=48, seed=1):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((b, n, 100)).astype(np.float32)
    text = rng.integers(0, 255, (b, 20)).astype(np.int32)
    text[0, 12:] = -1
    lens = np.full((b,), n, np.int32)
    lens[-1] = n - 9
    return mel, text, lens


def _params(module) -> dict:
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def _close(got: dict, want: dict, atol=2e-5):
    assert sorted(got) == sorted(want)
    for k, p in got.items():
        torch.testing.assert_close(p, want[k], atol=atol, rtol=0, msg=k)


def _close_to_jax(got: dict, ref: dict):
    assert sorted(got) == sorted(ref)
    diffs = []
    for k, p in got.items():
        np.testing.assert_allclose(p.numpy(), ref[k], atol=LR / 10, rtol=0, err_msg=k)
        diffs.append(np.abs(p.numpy() - ref[k]).ravel())
    assert np.mean(np.concatenate(diffs) <= 1e-6) >= 0.999
    np.testing.assert_allclose(got["proj_out.weight"].numpy(), ref["proj_out.weight"], atol=2e-5, rtol=0)


def _port_dit(jax_params) -> DiT:
    dit = DiT(tcfg.DiTConfig(**TINY))
    dit.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jax_params), dit.cfg))
    return dit


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(script: str, **fmt) -> list[subprocess.Popen]:
    """Two gloo ranks starting `script` (formatted with `repo`, `port`,
    `rank` and `fmt`)."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    return [subprocess.Popen([sys.executable, "-c", script.format(repo=str(REPO), port=port, rank=rank, **fmt)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(2)]


def _finish(procs: list[subprocess.Popen]) -> list[dict]:
    """Each rank's last printed JSON line, once both have exited 0."""
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def _as_rank(monkeypatch, rank):
    monkeypatch.setattr(D, "process_count", lambda: 2)
    monkeypatch.setattr(D, "process_index", lambda: rank)


# ------------------------------------------------------------- two ranks: one FSDP step

STEPS = textwrap.dedent("""
    import json, sys, torch
    sys.path.insert(0, {repo!r})
    from f5_tts_tpu_torch.config import CFMConfig, DiTConfig
    from f5_tts_tpu_torch.models.cfm import CFMDraws
    from f5_tts_tpu_torch.models.dit import DiT
    from f5_tts_tpu_torch.models.shard import shard_train_state
    from f5_tts_tpu_torch.parallel import create_mesh, initialize
    from f5_tts_tpu_torch.parallel import mesh as M
    from f5_tts_tpu_torch.training import trainer as T

    rank = {rank}
    initialize(coordinator_address="localhost:{port}", num_processes=2, process_id=rank, backend="gloo")
    inputs = torch.load({inputs!r})
    mel, text, lens = inputs["batch"]
    draws = CFMDraws(**inputs["draws"])
    half = slice(2 * rank, 2 * rank + 2)
    result = {{}}
    for label, grid in (("dp_tp", dict(data=2, model=2)), ("seq", dict(data=1, seq=2))):
        dit = DiT(DiTConfig(**inputs["cfg"]))
        dit.load_state_dict(inputs["params"])
        opt = T.make_optimizer(inputs["lr"], 1e-2, 1, 100)
        mesh = create_mesh(**grid, devices=["cpu"] * 4)
        state = shard_train_state(T.init_train_state(dit, opt, ema=True), mesh, fsdp=True)
        step = M.shard_train_step(T.make_train_step(CFMConfig(), opt, ema_decay=0.9), mesh, state, fsdp=True)
        M.reset_collective_counts()
        loss = step(state, mel[half], text[half], lens[half], draws=draws).item()
        counts = M.collective_counts()
        full = M.gather_state(state)
        torch.save(full["params"], {out!r} + f"/{{label}}_rank{{rank}}.pt")
        stored = {{n: [state.params[0][n].numel(), state.opt_state["mu"][0][n].numel(), state.ema[0][n].numel(),
                      full["params"][n].numel()] for n in state.gathered_names()}}
        result[label] = {{"loss": loss, "counts": counts, "stored": stored, "specs": state.specs,
                          "global_shape": state.global_shape}}
    print(json.dumps(result))
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def jax_params():
    """A JAX parameter tree: a port DiT's random weights through the JAX
    package's own converter (no JAX init to compile)."""
    dit = DiT(tcfg.DiTConfig(**TINY))
    init_parameters_(dit, torch.Generator().manual_seed(0))
    return jax_convert(to_mlx_model_naming(export_mlx_state(dit), TINY["dim_head"]), jcfg.DiTConfig(**TINY))


@pytest.fixture(scope="module")
def two_ranks(jax_params, tmp_path_factory):
    """The file's two pairs of gloo ranks, run at once while this process
    takes the references: the FSDP steps over 2 x 2 and 1 x 2 x 1 from the
    JAX parameters and draws (`STEPS`), and both trainers (`TRAINERS`).
    Returns {"steps": (the inputs, each rank's result, their directory, the
    references), "trainers": (each rank's result, their directory)}."""
    from test_torch_distributed import write_tree
    from test_torch_mesh_training import _jax_cfm_step, _jax_params, _jax_sharded

    tmp = tmp_path_factory.mktemp("fsdp_processes")
    key = jax.random.key(3)
    inputs = {"cfg": TINY, "lr": LR, "params": _port_dit(jax_params).state_dict(),
              "batch": tuple(_t(a) for a in _batch()), "draws": _jax_draws(key, 4, 48)}
    torch.save(inputs, tmp / "inputs.pt")
    (tmp / "trainers").mkdir()
    steps = _start(STEPS, inputs=str(tmp / "inputs.pt"), out=str(tmp))
    trainers = _start(TRAINERS, root=str(write_tree(tmp / "wavs")), out=str(tmp / "trainers"), dur=DUR)
    jloss, jstate = _jax_sharded(_jax_cfm_step(1), jax_params, _batch(), key, fsdp=True)
    refs = {"jax": (jloss, _jax_params(jstate["params"], tcfg.DiTConfig(**TINY))),
            "dp_tp": _one_process_fsdp(inputs, data=4, model=2), "seq": _one_process_fsdp(inputs, data=2, seq=2)}
    return {"steps": (inputs, _finish(steps), tmp, refs), "trainers": (_finish(trainers), tmp / "trainers")}


def _one_process_fsdp(inputs, **grid):
    """The port's one-process FSDP step over `grid` on the global batch:
    (loss, the gathered parameters, the collectives)."""
    dit = DiT(tcfg.DiTConfig(**TINY))
    dit.load_state_dict(inputs["params"])
    opt = T.make_optimizer(LR, 1e-2, 1, 100)
    mesh = tmesh.create_mesh(**grid, devices=cpu(8))
    state = shard_train_state(T.init_train_state(dit, opt, ema=True), mesh, fsdp=True)
    step = tmesh.shard_train_step(T.make_train_step(tcfg.CFMConfig(), opt, ema_decay=0.9), mesh, state, fsdp=True)
    tmesh.reset_collective_counts()
    loss = step(state, *inputs["batch"], draws=CFMDraws(**inputs["draws"])).item()
    return loss, gather_shards(state), tmesh.collective_counts()


def _expected_gathers(specs: dict, model: int) -> int:
    """One gather (and one reduce-scatter) a data-sharded tensor a model
    column group: a model column for a model-sharded one, else the grid."""
    return sum(model if "model" in spec else 1 for spec in specs.values() if "data" in spec)


def _check_ranks(results, label, ways):
    """The two ranks' losses equal; each slot stores 1/ways of each sharded
    matrix (its moments and EMA too); one cross-process gather and
    reduce-scatter a data-sharded tensor a group."""
    r0, r1 = results[0][label], results[1][label]
    assert r0["loss"] == r1["loss"]
    specs = {n: tuple(s) for n, s in r0["specs"].items()}
    for name, (param, mu, ema, full) in r0["stored"].items():
        per_slot = full // ways // (2 if "model" in specs[name] and label == "dp_tp" else 1)
        assert param == mu == ema == per_slot, name
    want = _expected_gathers(specs, 2 if label == "dp_tp" else 1)
    assert want > 0
    for r in (r0, r1):
        c = r["counts"]
        assert c["process_all_gather"] == c["process_reduce_scatter"] == c["all_gather"] == c["reduce_scatter"] == want
    return specs


def test_two_ranks_2x2_fsdp_match_jax_4x2_and_one_process(jax_params, two_ranks):
    """(a) Two ranks over 2 x 2 each, FSDP over the global data axis of 4,
    against the JAX package's `shard_train_step(fsdp=True)` on its 4 x 2
    mesh and the port's one-process 4 x 2 FSDP step: the loss and every
    updated parameter; the specs are the one-process 4 x 2 step's, and
    each slot stores 1/4 of each sharded matrix (1/8 where "model" shards
    it too)."""
    _, results, tmp, refs = two_ranks["steps"]
    specs = _check_ranks(results, "dp_tp", 4)
    assert results[0]["dp_tp"]["global_shape"] == {"data": 4, "model": 2}
    (jloss, ref), (loss1, params1, _) = refs["jax"], refs["dp_tp"]
    assert specs == tmesh.param_specs(_port_dit(jax_params), 4)
    for rank in range(2):
        assert abs(results[rank]["dp_tp"]["loss"] - jloss) <= 2e-5
        assert abs(results[rank]["dp_tp"]["loss"] - loss1) <= 2e-5
        got = torch.load(tmp / f"dp_tp_rank{rank}.pt")
        _close(got, params1)
        _close_to_jax(got, ref)


def test_two_ranks_seq_fsdp_match_one_process_2x2x1(two_ranks):
    """(c) Two ranks over 1 x 2 x 1 (data x seq x model) each, FSDP over
    the global data axis of 2, against one process's 2 x 2 x 1 FSDP step:
    the loss and every updated parameter; each slot stores half of each
    sharded matrix."""
    _, results, tmp, refs = two_ranks["steps"]
    _check_ranks(results, "seq", 2)
    assert results[0]["seq"]["global_shape"] == {"data": 2, "seq": 2, "model": 1}
    loss1, params1, counts = refs["seq"]
    assert counts["process_all_gather"] == counts["process_reduce_scatter"] == 0
    for rank in range(2):
        assert abs(results[rank]["seq"]["loss"] - loss1) <= 2e-5
        _close(torch.load(tmp / f"seq_rank{rank}.pt"), params1)


# ------------------------------------------------------------- two ranks: both trainers, FSDP, the manager

TRAINERS = textwrap.dedent("""
    import json, sys, torch
    sys.path.insert(0, {repo!r})
    from f5_tts_tpu_torch.config import DurationConfig
    from f5_tts_tpu_torch.models.duration import DurationPredictor
    from f5_tts_tpu_torch.parallel import initialize
    from f5_tts_tpu_torch.parallel import mesh as M
    from f5_tts_tpu_torch.training import F5TTSTrainer
    from f5_tts_tpu_torch.training.duration_trainer import DurationTrainer
    import tests.test_torch_distributed as t

    rank = {rank}
    initialize(coordinator_address="localhost:{port}", num_processes=2, process_id=rank, backend="gloo")
    result = {{}}
    for kind in ("cfm", "duration"):
        out = {out!r} + "/" + kind
        common = dict(num_warmup_steps=0, results_dir=out, ema_decay=0.9, use_orbax=True, fsdp=True)
        if kind == "cfm":
            trainer = F5TTSTrainer(t._model(), **common)
            trainer.train(t._pipeline({root!r}, True), learning_rate=t.LR, total_steps=1, save_every=1,
                          sample_every=10**9)
        else:
            predictor = DurationPredictor.init(torch.Generator().manual_seed(0), DurationConfig(**{dur!r}),
                                               device="cpu")
            trainer = DurationTrainer(predictor, **common)
            trainer.train(t._pipeline({root!r}, True), learning_rate=t.LR, total_steps=1, save_every=1)
        trainer.ckpt_mgr.close()
        full = M.gather_state(trainer.state)
        torch.save({{k: full[k] for k in ("params", "mu", "nu", "ema")}}, f"{{out}}/rank{{rank}}.pt")
        result[kind] = {{"step": full["step"], "count": int(full["count"]), "world": trainer.state.world,
                         "fsdp": trainer.state.fsdp, "slots": len(trainer.state.slots),
                         "sharded": len(trainer.state.gathered_names())}}
    print(json.dumps(result))
    torch.distributed.destroy_process_group()
""")


def _fresh(kind):
    if kind == "cfm":
        return F5TTS.init(torch.Generator().manual_seed(5), tcfg.DiTConfig(**TINY), device="cpu",
                          cfm_cfg=tcfg.CFMConfig()).dit
    return DurationPredictor.init(torch.Generator().manual_seed(5), tcfg.DurationConfig(**DUR), device="cpu")


@pytest.mark.parametrize("kind", ["cfm", "duration"])
def test_two_rank_fsdp_trainer_checkpoint_restores_to_the_bit(two_ranks, kind):
    """(b) A trainer on each of two ranks, no mesh (a grid of one slot a
    process) and `fsdp=True`, saves through the checkpoint manager: each
    rank writes its own global row's pieces (keys of rows 0 and 1 for a
    sharded tensor), and the step restores unsharded and over a one-process
    2 x 2 FSDP grid equal to the bit to both ranks' gathered state."""
    from torch.distributed.checkpoint import FileSystemReader

    results, tmp = two_ranks["trainers"]
    for r in results:
        assert r[kind] == {**r[kind], "step": 1, "count": 1, "world": 2, "fsdp": True, "slots": 1}
        assert r[kind]["sharded"] > 0
    ranks = [torch.load(tmp / kind / f"rank{rank}.pt") for rank in range(2)]
    mgr = C.TrainCheckpointManager(tmp / kind / "checkpoints")
    assert mgr.all_steps() == [1]
    layout = json.loads((tmp / kind / "checkpoints" / "1" / C.LAYOUT).read_text())
    assert layout["shape"] == {"data": 2, "model": 1}
    meta = FileSystemReader(tmp / kind / "checkpoints" / "1").read_metadata().state_dict_metadata
    sharded = [n for n, spec in layout["specs"].items() if "data" in spec]
    for name in sharded:
        assert {f"params/0.0/{name}", f"params/1.0/{name}", f"mu/1.0/{name}", f"ema/1.0/{name}"} <= set(meta)
    assert not any(k.startswith("params/1.0/") and k.split("/", 2)[2] not in sharded for k in meta)

    opt = T.make_optimizer(LR, 1e-2, 0, 10)
    plain = mgr.restore(1, T.init_train_state(_fresh(kind), opt, ema=True))
    grid = tmesh.create_mesh(data=2, model=2, devices=cpu(4))
    over = tmesh.gather_state(mgr.restore(1, shard_train_state(T.init_train_state(_fresh(kind), opt, ema=True),
                                                               grid, fsdp=True)))
    restored = {"params": _params(plain.model), "mu": plain.opt_state["mu"], "nu": plain.opt_state["nu"],
                "ema": plain.ema}
    assert (plain.step, plain.opt_state["count"], over["step"], over["count"]) == (1, 1, 1, 1)
    for want in ranks:
        for part in ("params", "mu", "nu", "ema"):
            _close(restored[part], want[part], atol=0)
            _close(over[part], want[part], atol=0)


# ------------------------------------------------------------- one process, either rank's view


def _marked(tree, specs, cfg) -> dict:
    """The JAX tree with each leaf replaced by the index along the dim its
    spec puts on "data" (zeros where none), in the port's names."""
    def marker(leaf, spec):
        entries = list(spec) + [None] * (leaf.ndim - len(spec))
        if "data" not in entries:
            return np.zeros(leaf.shape, np.float32)
        return np.indices(leaf.shape)[entries.index("data")].astype(np.float32)

    return params_from_jax(jax.tree.map(marker, tree, specs, is_leaf=lambda x: isinstance(x, PartitionSpec)), cfg)


def _tiny_state(ema=False):
    dit = F5TTS.init(torch.Generator().manual_seed(0), tcfg.DiTConfig(**TINY), device="cpu",
                     cfm_cfg=tcfg.CFMConfig()).dit
    return T.init_train_state(dit, T.make_optimizer(LR, 1e-2, 0, 10), ema=ema)


def test_specs_over_two_processes_match_jax_global_data(monkeypatch, jax_params):
    """With two processes of 2 x 2 each, the FSDP dims are those of JAX
    `param_specs(fsdp_data_size=4)`: the global data axis sizes them."""
    _as_rank(monkeypatch, 1)
    tree = jax.tree.map(np.asarray, jax_params)
    cfg = tcfg.DiTConfig(**TINY)
    state = shard_train_state(T.init_train_state(_port_dit(jax_params), T.make_optimizer()),
                              tmesh.create_mesh(data=2, model=2, devices=cpu(4)), fsdp=True)
    assert (state.world, state.rank, state.global_shape) == (2, 1, {"data": 4, "model": 2})
    assert [state.global_row(r) for r in range(2)] == [2, 3]
    marked = _marked(tree, jmesh.param_specs(tree, fsdp_data_size=4), cfg)
    for name, spec in state.specs.items():
        t = marked[name]
        want = (torch.from_numpy(np.indices(t.shape)[spec.index("data")].astype(np.float32)) if "data" in spec
                else torch.zeros_like(t))
        assert torch.equal(t, want), (name, spec)


def test_checkpoint_keys_of_two_ranks_are_disjoint(monkeypatch):
    """Each rank's pieces go under its global rows' keys: for a sharded
    tensor the two ranks' keys are disjoint and together cover the four
    global rows, each holding its global row's piece; a replicated tensor
    is written by global row 0 alone."""
    full = _tiny_state(ema=True)
    full_params = _params(full.model)
    mesh = tmesh.create_mesh(data=2, devices=cpu(2))
    keys = []
    for rank in range(2):
        _as_rank(monkeypatch, rank)
        state = shard_train_state(full, mesh, fsdp=True)
        pieces = C.owned_pieces(state)
        keys.append(set(pieces))
        for name in state.gathered_names():
            dim = state.specs[name].index("data")
            for r in range(2):
                g = 2 * rank + r
                for kind in ("params", "mu", "nu", "ema"):
                    assert f"{kind}/{g}.0/{name}" in pieces
                assert torch.equal(pieces[f"params/{g}.0/{name}"], full_params[name].chunk(4, dim)[g])
    assert keys[0].isdisjoint(keys[1]) and keys[1]
    replicated = [n for n, spec in state.specs.items() if "data" not in spec]
    assert replicated and all(f"params/0.0/{n}" in keys[0] for n in replicated)
    assert not any(k.split("/", 2)[2] in replicated for k in keys[1])


def test_global_norm_counts_a_replicated_tensor_once(monkeypatch):
    """Under FSDP across two processes the sharded pieces' squares are
    summed across them and the rest counted once: with a gradient of ones
    (each rank's pieces alike, so the sum across processes is twice this
    rank's), the norm is that of the full tensors of ones."""
    _as_rank(monkeypatch, 0)
    monkeypatch.setattr(D, "sum_across_processes", lambda t: 2 * t)
    state = shard_train_state(_tiny_state(), tmesh.create_mesh(data=2, model=2, devices=cpu(4)), fsdp=True)
    step = tmesh.shard_train_step(T.make_train_step(tcfg.CFMConfig(), T.make_optimizer()), state.mesh, state,
                                  fsdp=True)
    grads = [{n: torch.ones_like(t) for n, t in stored.items()} for stored in state.params]
    total = sum(t.numel() for t in _params(_tiny_state().model).values())
    norm = step.global_norm(state, grads).item()
    assert norm == pytest.approx(total ** 0.5, rel=1e-6)
    replicated = sum(t.numel() for n, t in _params(_tiny_state().model).items() if "data" not in state.specs[n])
    assert replicated > 0 and norm != pytest.approx((total + replicated) ** 0.5, rel=1e-6)


def test_probe_sample_gathers_on_every_process_and_samples_on_process_0(monkeypatch, tmp_path):
    """A probe sample gathers the train state on every process (under FSDP
    across processes the gather is a collective: a process that skipped it
    would leave the others waiting) and samples on process 0 alone."""
    from f5_tts_tpu_torch.audio.io import write_wav

    _as_rank(monkeypatch, 1)
    trainer = T.F5TTSTrainer(F5TTS.init(torch.Generator().manual_seed(0), tcfg.DiTConfig(**TINY), device="cpu",
                                        cfm_cfg=tcfg.CFMConfig()), results_dir=tmp_path)
    trainer.state = T.init_train_state(trainer.model.dit, T.make_optimizer(), ema=True)
    gathered = []
    monkeypatch.setattr(T, "gathered_train_state", lambda state, model: gathered.append(state) or state)
    ref = tmp_path / "ref.wav"
    write_wav(ref, (0.05 * np.sin(np.arange(12_000) / 10)).astype(np.float32), 24_000)
    trainer.generate_sample(str(ref), "hi", "there", 0.5, step=1, samples_dir=str(tmp_path / "s"))
    assert gathered == [trainer.state] and not (tmp_path / "s").exists()
