"""Several processes in the port (`f5_tts_tpu_torch/parallel/distributed.py`):
`initialize()` against the JAX package's rules (a no-op for one process, an
explicit cluster passed through, the environment's process count), with
`torch.distributed.init_process_group` monkeypatched as the JAX suite
patches `jax.distributed.initialize` (tests/test_distributed.py), and a real
2-process gloo data-parallel step over loopback: each process loads its
slice of the global batch from a WAV tree this test writes
(`make_training_pipeline(shard_by_process=True)`) and trains the tiny DiT
one step, over a grid of its own (data 1 in each process; the data axis
spans the two) or with no mesh at all (the examples' default: the trainer
then takes a grid of one slot, `training_grid`). Both must report the same
loss, equal to one process's unsharded step on the global batch within
2e-5, and the same parameters (within the float32 tolerance of
tests/test_torch_training.py: Adam's first update is about lr * sign(g)).
Two processes each over a 1 x 2 x 1 grid (data x seq x model: sequence
parallelism within a process, data parallelism across them) give the loss
and parameters of one process's 2 x 2 x 1 step. With several processes,
process 0 alone writes the checkpoint files, and FSDP cuts each process's
global data rows' pieces (tests/test_torch_fsdp_processes.py steps and
checkpoints it across real ranks).
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from f5_tts_tpu_torch.audio.io import write_wav
from f5_tts_tpu_torch.config import CFMConfig, DiTConfig
from f5_tts_tpu_torch.data import load_dir, make_training_pipeline
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.shard import shard_train_state
from f5_tts_tpu_torch.parallel import create_mesh, param_specs
from f5_tts_tpu_torch.parallel import distributed as D
from f5_tts_tpu_torch.training import F5TTSTrainer
from f5_tts_tpu_torch.training import trainer as T

REPO = Path(__file__).resolve().parent.parent
TINY = dict(dim=64, depth=2, heads=2, dim_head=32, ff_mult=2, mel_dim=100, text_num_embeds=256, text_dim=32,
            conv_layers=1)
LR = 1e-3


# ------------------------------------------------------------- initialize()


def _recorded(monkeypatch):
    calls = []
    monkeypatch.setattr(D.dist, "init_process_group", lambda **kw: calls.append(kw))
    return calls


def test_initialize_single_process_is_noop(monkeypatch):
    calls = _recorded(monkeypatch)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    D.initialize()  # no address, no environment: nothing to do
    assert calls == []
    monkeypatch.setenv("WORLD_SIZE", "1")
    D.initialize()
    assert calls == []
    assert D.process_count() == 1 and D.process_index() == 0


def test_initialize_passes_explicit_cluster(monkeypatch):
    calls = _recorded(monkeypatch)
    D.initialize(coordinator_address="10.0.0.1:1234", num_processes=4, process_id=2)
    assert calls == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 2}]


def test_initialize_env_process_count(monkeypatch):
    """WORLD_SIZE above 1 starts the group without an address: torch reads
    MASTER_ADDR, MASTER_PORT and RANK (env://)."""
    calls = _recorded(monkeypatch)
    monkeypatch.setenv("WORLD_SIZE", "8")
    D.initialize(backend="nccl")
    assert calls == [{"backend": "nccl", "init_method": "env://", "world_size": 8, "rank": -1}]


# ------------------------------------------------------------- a 2-process DP step


def write_tree(root: Path, n_clips=8, seed=0) -> Path:
    """Clips of 0.4 to 2 s (37 to 187 frames: the processes' batches fall
    in different 64-frame buckets and are padded to one)."""
    rng = np.random.default_rng(seed)
    d = root / "84" / "121123"
    d.mkdir(parents=True)
    for i in range(n_clips):
        n = int(rng.uniform(0.4, 2.0) * 24_000)
        write_wav(d / f"84_{i}.wav", (0.1 * rng.standard_normal(n)).astype(np.float32), 24_000)
        (d / f"84_{i}.normalized.txt").write_text(f"Sentence number {i} of the tree.")
    return root


def _pipeline(root, shard_by_process):
    return make_training_pipeline(load_dir(root), batch_size=4, epochs=1, shuffle_buffer=8, num_threads=2,
                                  pad_frame_multiple=64, seed=0, shard_by_process=shard_by_process)


def _model():
    return F5TTS.init(torch.Generator().manual_seed(0), DiTConfig(**TINY), device="cpu", cfm_cfg=CFMConfig())


RANK = textwrap.dedent("""
    import json, sys, torch
    sys.path.insert(0, {repo!r})
    from f5_tts_tpu_torch.parallel import create_mesh, initialize
    from f5_tts_tpu_torch.parallel import distributed as D
    from f5_tts_tpu_torch.training import F5TTSTrainer
    import tests.test_torch_distributed as t

    initialize(coordinator_address="localhost:{port}", num_processes=2, process_id={rank}, backend="gloo")
    mesh = {mesh}
    trainer = F5TTSTrainer(t._model(), num_warmup_steps=0, results_dir={out!r}, mesh=mesh)
    trainer.train(t._pipeline({root!r}, True), learning_rate=t.LR, total_steps=1, save_every=10**9, sample_every=10**9)
    torch.save(dict(trainer.model.dit.named_parameters()), {out!r} + "/params_{rank}.pt")
    print(json.dumps({{"rank": D.process_index(), "world": D.process_count(), "loss": float(trainer.last_loss)}}))
    torch.distributed.destroy_process_group()
""")


def _two_ranks(tmp_path, mesh: str) -> tuple[str, list[dict]]:
    """Two gloo ranks training one step from a WAV tree, each over the grid
    that `mesh` (Python source) builds: (the tree, each rank's result)."""
    root = str(write_tree(tmp_path / "wavs"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen([sys.executable, "-c", RANK.format(repo=str(REPO), port=port, rank=rank, root=root,
                                                                 out=str(tmp_path), mesh=mesh)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    results = []
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert [(r["rank"], r["world"]) for r in results] == [(0, 2), (1, 2)]
    assert results[0]["loss"] == results[1]["loss"]
    return root, results


@pytest.mark.parametrize("grid", [True, False], ids=["grid", "no_mesh"])
def test_two_process_gloo_dp_step_matches_one_process(tmp_path, grid):
    root, results = _two_ranks(tmp_path, 'create_mesh(data=1, devices=["cpu"])' if grid else "None")
    trainer = F5TTSTrainer(_model(), num_warmup_steps=0, results_dir=tmp_path / "one")
    trainer.train(_pipeline(root, False), learning_rate=LR, total_steps=1, save_every=10**9, sample_every=10**9)
    assert abs(float(trainer.last_loss) - results[0]["loss"]) <= 2e-5
    want = dict(trainer.model.dit.named_parameters())
    for rank in range(2):
        got = torch.load(tmp_path / f"params_{rank}.pt")
        diffs = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
        assert diffs.max().item() <= LR / 10 and (diffs <= 1e-6).float().mean().item() >= 0.999


def test_two_process_gloo_seq_step_matches_one_process_grid(tmp_path):
    """Each rank over a 1 x 2 x 1 grid (its frames split over two seq
    slots) against one process's 2 x 2 x 1 step on the global batch: the
    same sums in another order of processes and slots."""
    root, results = _two_ranks(tmp_path, 'create_mesh(data=1, seq=2, devices=["cpu"] * 2)')
    trainer = F5TTSTrainer(_model(), num_warmup_steps=0, results_dir=tmp_path / "one",
                           mesh=create_mesh(data=2, seq=2, devices=["cpu"] * 4))
    trainer.train(_pipeline(root, False), learning_rate=LR, total_steps=1, save_every=10**9, sample_every=10**9)
    assert abs(float(trainer.last_loss) - results[0]["loss"]) <= 2e-5
    want = dict(trainer.model.dit.named_parameters())
    for rank in range(2):
        got = torch.load(tmp_path / f"params_{rank}.pt")
        diffs = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
        assert diffs.max().item() <= LR / 10 and (diffs <= 1e-6).float().mean().item() >= 0.999


# ------------------------------------------------------------- several processes, one process's view


def _as_rank(monkeypatch, rank):
    monkeypatch.setattr(D, "process_count", lambda: 2)
    monkeypatch.setattr(D, "process_index", lambda: rank)


def test_training_grid_without_mesh(monkeypatch):
    """Without a mesh a trainer steps unsharded in one process and over a
    grid of one slot on the model's device with several, so the sharded
    step sums its gradient across them; a mesh it was given stays."""
    assert T.training_grid(None, torch.device("cpu")) is None
    given = create_mesh(data=2, devices=["cpu"] * 2)
    _as_rank(monkeypatch, 1)
    grid = T.training_grid(None, torch.device("cpu"))
    assert grid.shape == {"data": 1, "model": 1} and list(grid.devices.flat) == [torch.device("cpu")]
    assert T.training_grid(given, torch.device("cpu")) is given


@pytest.mark.parametrize("rank", [0, 1])
def test_fsdp_across_processes_stores_the_global_rows(monkeypatch, rank):
    """With two processes of 2 data rows each, FSDP shards over the global
    data axis of 4: local row r of process `rank` stores global row
    2 rank + r's piece of each weight matrix, of its moments and of its EMA
    (a quarter), and the specs are those of one process's data 4; without
    FSDP every slot holds whole tensors."""
    _as_rank(monkeypatch, rank)
    model = _model()
    opt = T.make_optimizer(LR, 1e-2, 0, 10)
    mesh = create_mesh(data=2, devices=["cpu"] * 2)
    full = T.init_train_state(model.dit, opt, ema=True)
    with torch.no_grad():
        for t in full.ema.values():
            t.add_(torch.rand(t.shape, generator=torch.Generator().manual_seed(1)))
    params = {n: p.detach().clone() for n, p in model.dit.named_parameters()}
    ema = {n: t.clone() for n, t in full.ema.items()}
    state = shard_train_state(full, mesh, fsdp=True)
    assert state.specs == param_specs(model.dit, 4) and (state.world, state.rank) == (2, rank)
    sharded = state.gathered_names()
    assert sharded
    for r in range(2):
        for name in sharded:
            dim = state.specs[name].index("data")
            g = 2 * rank + r
            assert torch.equal(state.params[r][name], params[name].chunk(4, dim)[g])
            assert torch.equal(state.ema[r][name], ema[name].chunk(4, dim)[g])
            assert state.opt_state["mu"][r][name].numel() * 4 == params[name].numel()
    assert shard_train_state(T.init_train_state(model.dit, opt), mesh).fsdp is False


@pytest.mark.parametrize("rank", [0, 1])
def test_only_process_zero_writes_checkpoint_files(monkeypatch, tmp_path, rank):
    """Every process saves (the checkpoint manager's save spans them), and
    process 0 alone writes the weights, EMA and train-state files."""
    _as_rank(monkeypatch, rank)
    trainer = F5TTSTrainer(_model(), num_warmup_steps=0, results_dir=tmp_path, ema_decay=0.9)
    trainer.state = T.init_train_state(trainer.model.dit, T.make_optimizer(LR, 1e-2, 0, 10), ema=True)
    trainer.save_checkpoint(1)
    want = {"f5tts_1.safetensors", "f5tts_1.ema.safetensors", "f5tts_1.trainstate.safetensors"} if rank == 0 else set()
    assert {p.name for p in tmp_path.iterdir()} == want
