"""Mesh-parallel sampling and training on grids of 1, 2, 4 and 8 slots, and
pipeline parallelism: the port of the JAX package's `tools/scaling.py`.

    PYTHONPATH=. python -m f5_tts_tpu_torch.tools.scaling               # slots on the cards
    PYTHONPATH=. python -m f5_tts_tpu_torch.tools.scaling --device cpu  # slots on the CPU

For each grid of N slots (data x model: 1 x 1, then N / 2 x 2 as the JAX
tool meshes DP x TP), one batched `F5TTS.sample` of a small random DiT
(the JAX tool's, dim 128, depth 2, 4 heads, float32, with heads of 64: the
card's attention kernel takes heads of 64, 128 or 256) through
`use_mesh`, with the same noise and durations: its max |delta| against
the 1-slot run, the reductions it made (`mesh.all_reduce.counts`: the
port's counterpart of the collectives the JAX tool counts in the compiled
HLO) and its wall. The slots cycle over the devices of `--device`'s type,
so on one card or on the CPU every slot shares the one device: the walls
then measure host cost, not scaling.

The training half: for each grid (the same data x model), three sharded
CFM steps (parallel/mesh.py `shard_train_step`) of the same DiT on the same
global batch of 8 x 64 frames with the same draws: the losses, their max
|delta| against the 1-slot run, and the counted collectives (the
row-parallel sums forward and backward, the gradients' all-reduces; under
FSDP the gathers and reduce-scatters), then an FSDP row and a sequence
parallel row (data x seq 2 x model 2: each seq slot computes 32 of the 64
frames, with a key and value gather an attention and its reduce-scatter in
the backward) on the largest grid of 4 slots or more.

The pipeline half (parallel/pipeline.py), as the JAX tool's: the same DiT
at depth 4 over data x stage grids of 1 x 2, 1 x 4 and 2 x 4 with 2
microbatches, one forward of the global batch each: its max |delta|
against the unpipelined forward (`DiT.forward_train`) and the counted
handoffs (`stage_send`, `stage_to_head`).

`sampling_rows`, `training_rows` and `pipeline_rows` run the three halves
alone; the command runs all three.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from f5_tts_tpu_torch.config import CFMConfig, DiTConfig
from f5_tts_tpu_torch.models.cfm import F5TTS
from f5_tts_tpu_torch.models.shard import shard_train_state
from f5_tts_tpu_torch.parallel.pipeline import create_pipeline_mesh, dit_forward_pipelined, shard_params_for_pipeline
from f5_tts_tpu_torch.parallel.mesh import (
    all_reduce,
    collective_counts,
    create_mesh,
    device_list,
    reset_collective_counts,
    shard_train_step,
)
from f5_tts_tpu_torch.training.trainer import init_train_state, make_optimizer, make_train_step

CFG = DiTConfig(dim=128, depth=2, heads=4, dim_head=64, ff_mult=2, mel_dim=100, text_num_embeds=64, text_dim=64,
                conv_layers=1, compute_dtype="float32")
GLOBAL_BATCH = 8
SEQ = 64
STEPS = 5  # Euler: 4 flow evaluations with CFG
TRAIN_STEPS = 3
PIPELINE_DEPTH = 4  # divisible by up to 4 stages
PIPELINE_GRIDS = ((1, 2), (1, 4), (2, 4))  # (data, stages)
PIPELINE_MICROBATCHES = 2


def run_sampling(n: int, device: str) -> tuple[np.ndarray, dict, float]:
    """(the sampled mel, the reductions, the wall in s) on a grid of n slots
    over the devices of `device`'s type."""
    mesh = _grid(n, device)
    dev = mesh.devices.flat[0]
    model = F5TTS.init(torch.Generator(device=dev).manual_seed(0), CFG, device=dev,
                       cfm_cfg=CFMConfig(duration_bucket=SEQ)).use_mesh(mesh)
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((GLOBAL_BATCH, SEQ // 4, CFG.mel_dim)).astype(np.float32)
    y0 = rng.standard_normal((GLOBAL_BATCH, SEQ, CFG.mel_dim)).astype(np.float32)
    text = np.zeros((GLOBAL_BATCH, SEQ // 2), np.int32)
    durations = rng.integers(SEQ // 2, SEQ + 1, GLOBAL_BATCH).astype(np.int32)

    def sample():
        out, _ = model.sample(cond, text, duration=durations, steps=STEPS, method="euler", y0=y0,
                              return_trajectory=False)
        return out.cpu().numpy()

    sample()  # warm-up: the first call builds kernels and caches
    all_reduce.counts.update(sum=0, max=0)
    t0 = time.perf_counter()
    out = sample()
    return out, dict(all_reduce.counts), time.perf_counter() - t0


def _grid(n: int, device: str, seq: int = 1):
    model_par = 2 if n >= 2 else 1
    devices = device_list(device)
    return create_mesh(data=n // (model_par * seq), model=model_par, seq=seq,
                       devices=[devices[i % len(devices)] for i in range(n)])


def run_training(n: int, device: str, fsdp: bool = False, seq: int = 1) -> tuple[list[float], dict, float]:
    """(the losses of TRAIN_STEPS sharded steps, the collectives they made,
    the wall in s) on a grid of n slots (`seq` of them along "seq") over the
    devices of `device`'s type."""
    mesh = _grid(n, device, seq)
    dev = mesh.devices.flat[0]
    model = F5TTS.init(torch.Generator(device=dev).manual_seed(0), CFG, device=dev, cfm_cfg=CFMConfig())
    optimizer = make_optimizer(learning_rate=1e-4, total_steps=100)
    state = shard_train_state(init_train_state(model.dit, optimizer), mesh, fsdp=fsdp)
    step = shard_train_step(make_train_step(model.cfm_cfg, optimizer), mesh, state, fsdp=fsdp)
    g = torch.Generator(device=dev).manual_seed(1)
    mel = torch.randn(GLOBAL_BATCH, SEQ, CFG.mel_dim, generator=g, device=dev)
    text = torch.zeros(GLOBAL_BATCH, SEQ, dtype=torch.int32, device=dev)
    lens = torch.full((GLOBAL_BATCH,), SEQ, device=dev)
    reset_collective_counts()
    t0 = time.perf_counter()
    losses = [step(state, mel, text, lens, torch.Generator(device=dev).manual_seed(2 + i)).item()
              for i in range(TRAIN_STEPS)]
    return losses, collective_counts(), time.perf_counter() - t0


def training_rows(slots: list[int], device: str) -> list[dict]:
    """The training half's rows: each grid of `slots`, then FSDP and
    sequence parallelism (seq 2) on the largest grid of 4 slots or more."""
    rows, base = [], None
    largest = [n for n in sorted(slots)[-1:] if n >= 4]
    runs = [(n, False, 1) for n in slots] + [(n, True, 1) for n in largest] + [(n, False, 2) for n in largest]
    for n, fsdp, seq in runs:
        losses, counts, wall = run_training(n, device, fsdp, seq)
        base = losses if base is None else base
        mp = 2 if n >= 2 else 1
        label = f"{n // mp}x{mp}" if seq == 1 else f"{n // (mp * seq)}x{seq}x{mp} SP"
        row = {"part": "training", "slots": n, "mesh": label + (" FSDP" if fsdp else ""),
               "losses": losses, "max_abs_delta_loss": max(abs(a - b) for a, b in zip(losses, base)),
               "collectives": counts, "wall_s": wall}
        print(f"training {row['slots']} slots ({row['mesh']}): losses {', '.join(f'{x:.6f}' for x in losses)}; "
              f"max |delta loss| vs 1 slot {row['max_abs_delta_loss']:.3e}; collectives over {TRAIN_STEPS} "
              f"steps {counts}; wall {wall:.3f} s")
        rows.append(row)
    return rows


def sampling_rows(slots: list[int], device: str) -> list[dict]:
    """The sampling half's rows: each grid of `slots` against 1 slot."""
    rows, base = [], None
    for n in slots:
        out, reductions, wall = run_sampling(n, device)
        base = out if base is None else base
        row = {"part": "sampling", "slots": n, "mesh": f"{n // (2 if n >= 2 else 1)}x{2 if n >= 2 else 1}",
               "max_abs_delta": float(np.abs(out - base).max()), "reductions": reductions, "wall_s": wall}
        print(f"{row['slots']} slots ({row['mesh']}): max |delta| vs 1 slot {row['max_abs_delta']:.3e}; "
              f"reductions {reductions}; wall {wall:.3f} s")
        rows.append(row)
    return rows


def pipeline_rows(device: str) -> list[dict]:
    """The pipeline half's rows: one forward of the global batch over each
    data x stage grid of PIPELINE_GRIDS (the slots cycling over the devices
    of `device`'s type) against the unpipelined forward."""
    devices = device_list(device)
    dev = devices[0]
    cfg = CFG.replace(depth=PIPELINE_DEPTH)
    model = F5TTS.init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev, cfm_cfg=CFMConfig())
    g = torch.Generator(device=dev).manual_seed(3)
    x, cond = (torch.randn(GLOBAL_BATCH, SEQ, cfg.mel_dim, generator=g, device=dev) for _ in range(2))
    text = torch.randint(-1, cfg.text_num_embeds, (GLOBAL_BATCH, SEQ), generator=g, device=dev)
    time_ = torch.rand(GLOBAL_BATCH, generator=g, device=dev)
    with torch.no_grad():
        ref = model.dit.forward_train(x, cond, text, time_)
    rows = []
    for data, stages in PIPELINE_GRIDS:
        mesh = create_pipeline_mesh(stages, data, [devices[i % len(devices)] for i in range(data * stages)])
        pipelined = shard_params_for_pipeline(model.dit, mesh)
        reset_collective_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = dit_forward_pipelined(pipelined, x, cond, text, time_, num_microbatches=PIPELINE_MICROBATCHES)
            delta = (out - ref).abs().max().item()
        wall = time.perf_counter() - t0
        counts = collective_counts()
        row = {"part": "pipeline", "data": data, "stages": stages, "mesh": f"{data}x{stages}",
               "max_abs_delta": delta, "handoffs": {k: counts[k] for k in ("stage_send", "stage_to_head")},
               "wall_s": wall}
        print(f"pipeline {row['mesh']} (data x stage, {PIPELINE_MICROBATCHES} microbatches): forward max |delta| vs "
              f"unpipelined {delta:.3e}; handoffs {row['handoffs']}; wall {wall:.3f} s")
        rows.append(row)
    return rows


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="the slots' device type: the cards by default, 'cpu' on request")
    ap.add_argument("--slots", default="1,2,4,8", help="comma-separated grid sizes")
    args = ap.parse_args(argv)
    where = torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda" else "the CPU"
    print(f"mesh sampling on {where}: batch {GLOBAL_BATCH}, {SEQ} frames, {STEPS - 1} Euler evaluations with CFG, "
          f"dim {CFG.dim} x depth {CFG.depth}, float32")
    slots = [int(s) for s in args.slots.split(",")]
    rows = sampling_rows(slots, args.device)
    print(f"mesh training on {where}: global batch {GLOBAL_BATCH}, {SEQ} frames, {TRAIN_STEPS} CFM steps")
    rows += training_rows(slots, args.device)
    print(f"pipeline on {where}: global batch {GLOBAL_BATCH}, {SEQ} frames, depth {PIPELINE_DEPTH}, forward")
    return rows + pipeline_rows(args.device)


if __name__ == "__main__":
    main()
