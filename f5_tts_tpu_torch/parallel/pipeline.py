"""Pipeline parallelism over the DiT's depth: GPipe over a "stage" axis of
the port's device grid (the port of the JAX package's
`parallel/pipeline.py`).

A ("data", "stage") grid (`create_pipeline_mesh`) holds depth / S
consecutive DiT blocks on each stage's device (`pipeline_param_specs`,
`shard_params_for_pipeline`): the JAX package's leading depth axis is the
port's block index, so stage s holds blocks [s depth / S, (s + 1) depth / S).
The data rows split the batch as `mesh.split_batch` does, and each data
row's share streams through its stages in M microbatches.

Schedule: GPipe fill and drain, M + S - 1 ticks. At tick t stage s runs
microbatch t - s through its blocks and hands the output to stage s + 1, a
copy to that stage's device (`mesh.stage_send`, counted; JAX's `ppermute`).
Within a tick every stage's work, of every data row, is issued before the
next tick's, so stages on distinct cards overlap; nothing reads back to the
host. A stage runs only its M valid microbatches: JAX computes a clipped
microbatch in each fill and drain tick and discards it, the port skips
those ticks, so a forward of one data row calls each block M times (K1
depth x M times, on b / (data M) rows each) with the same outputs.

Around the blocks, as in JAX: the text, time and input embeddings run once
a data row on its first stage's device (`DiT.train_inputs`); each block's
AdaLN-Zero modulations are computed per sample on its stage's device
(`attn_norm.mods` of the time embedding); RoPE's tables are built once on
each stage device; after the last stage a data row's microbatches are
joined and moved to its first stage's device (`mesh.stage_to_head`,
counted; JAX psums them over "stage"), where norm_out and proj_out run; the
data rows' outputs are gathered onto x's device.

Dropout (a generator and cfg.dropout above 0): one seed a layer, drawn as
`DiT.forward_train` draws them, and each microbatch keeps its rows of the
mask drawn at the global batch (`mesh.Rows`, `blocks.dropout(rows=)`), so
the pipelined forward is `DiT.forward_train` under the same generator. JAX
draws per (layer, microbatch, data shard) and can only pin determinism.

There is no activation checkpointing (cfg.remat is not read), as JAX's
local scan has none. Autograd through the forward is pipeline-parallel
backprop: each handoff's copy carries its gradient back to the stage before
it, and each attention's backward runs K2 (K2-f32) on its stage's device.

Placement: the data rows of one stage column that share a device share one
copy of the stage's blocks (a virtual grid on one card or on the CPU: a
block's gradient is then the sum over the data rows, as JAX's is); on
distinct devices each data row holds a copy of its own, whose gradient is
its rows' share.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from f5_tts_tpu_torch.models import blocks as B
from f5_tts_tpu_torch.models.dit import DiT, require_dit
from f5_tts_tpu_torch.models.rope import rotary_freqs
from f5_tts_tpu_torch.parallel.mesh import Mesh, Rows, _as_device, device_list, gather_batch, stage_send, stage_to_head

BLOCKS = "transformer_blocks."


def create_pipeline_mesh(stages: int, data: int = 1, devices=None) -> Mesh:
    """A ("data", "stage") mesh over the first data * stages of `devices`
    (default: every CUDA device in this process; a list may repeat a
    device, for a virtual grid on one card or on the CPU): DP over the
    batch composes with PP over the depth. Too few devices raise
    ValueError."""
    devices = [_as_device(d) for d in (device_list("cuda") if devices is None else devices)]
    if stages < 1 or data < 1 or data * stages > len(devices):
        raise ValueError(f"pipeline mesh {data}x{stages} needs {max(1, data) * max(1, stages)} devices, "
                         f"have {len(devices)}")
    grid = np.empty(data * stages, dtype=object)
    grid[:] = devices[: data * stages]
    return Mesh(grid.reshape(data, stages), ("data", "stage"))


def pipeline_param_specs(module_or_state_dict: nn.Module | dict) -> dict[str, tuple]:
    """Tensor name -> spec, in `mesh.param_specs`'s convention (one entry a
    dim, None where it is not cut): a block's tensor (`transformer_blocks.{i}.*`)
    leads with "stage", the depth axis that JAX stacks and the port keeps in
    the name, so stage s holds blocks [s depth / S, (s + 1) depth / S); every
    other tensor (the time, text and input embeddings, norm_out, proj_out)
    is replicated."""
    state = module_or_state_dict.state_dict() if isinstance(module_or_state_dict, nn.Module) \
        else module_or_state_dict
    return {name: ("stage",) * name.startswith(BLOCKS) + (None,) * t.ndim for name, t in state.items()}


class PipelinedDiT(nn.Module):
    """A DiT placed on a ("data", "stage") grid (`shard_params_for_pipeline`):
    `trunks[r]`, data row r's copy of the layers outside the blocks (a DiT
    of depth 0: the embeddings, norm_out and proj_out) on its first stage's
    device, and `stages[r][s]`, its copy of stage s's blocks on slot
    (r, s)'s device; slots that share a device share a copy."""

    def __init__(self, dit: DiT, mesh: Mesh):
        super().__init__()
        if "stage" not in mesh.axis_names:
            raise ValueError(f"{mesh} has no 'stage' axis: a pipeline runs on create_pipeline_mesh's grid")
        depth, stages = dit.cfg.depth, mesh.shape["stage"]
        if depth % stages:
            raise ValueError(f"depth {depth} is not divisible by {stages} stages")
        self.cfg, self.mesh = dit.cfg, mesh
        self.per_stage = depth // stages
        trunk = copy.deepcopy(dit, {id(dit.transformer_blocks): nn.ModuleList()})
        trunk.cfg = dit.cfg.replace(depth=0)
        parts = [dit.transformer_blocks[s * self.per_stage:(s + 1) * self.per_stage] for s in range(stages)]
        copies = {}

        def placed(part: nn.Module, device: torch.device) -> nn.Module:
            key = (id(part), device)
            if key not in copies:
                copies[key] = copy.deepcopy(part).to(device)
            return copies[key]

        grid = mesh.devices
        self.trunks = nn.ModuleList(placed(trunk, grid[r, 0]) for r in range(grid.shape[0]))
        self.stages = nn.ModuleList(nn.ModuleList(placed(part, grid[r, s]) for s, part in enumerate(parts))
                                    for r in range(grid.shape[0]))

    def block(self, i: int, row: int = 0) -> B.DiTBlock:
        """Block i as data row `row` holds it (on its stage's device)."""
        return self.stages[row][i // self.per_stage][i % self.per_stage]


def shard_params_for_pipeline(dit: DiT, mesh: Mesh) -> PipelinedDiT:
    """Place a copy of `dit` on a pipeline mesh, as `pipeline_param_specs`
    lays it out: each (data row, stage) slot holds its stage's blocks on its
    device, and each data row the replicated layers on its first stage's
    device, where the schedule runs them (`dit` itself is left as it is). A
    mesh without a "stage" axis, or a depth that the stages do not divide,
    raises ValueError, as does a model other than a DiT."""
    require_dit(dit, "shard_params_for_pipeline")
    return PipelinedDiT(dit, mesh)


def _run_stage(blocks: nn.ModuleList, h: torch.Tensor, mods: list, mask, rope, rate: float, seeds: list,
               rows: Rows | None) -> torch.Tensor:
    """One microbatch through a stage's blocks (`mods`, `seeds`: the
    stage's)."""
    for block, mod, seed in zip(blocks, mods, seeds):
        h = B.run_local(block.steps(h, mod, mask=mask, rope=rope, dropout_rate=rate, dropout_seed=seed, rows=rows))
    return h


def dit_forward_pipelined(
    pipelined: PipelinedDiT,
    x: torch.Tensor,  # [b, n, mel] noised input audio
    cond: torch.Tensor,  # [b, n, mel] masked cond audio
    text: torch.Tensor,  # [b, nt] int ids padded with -1
    time,  # [b] or scalar flow time in [0, 1]
    *,
    num_microbatches: int | None = None,
    drop_audio_cond=False,  # bool | [b] bool
    drop_text=False,  # bool | [b] bool
    mask: torch.Tensor | None = None,  # [b, n] bool padding mask
    generator: torch.Generator | None = None,  # dropout; None = deterministic
) -> torch.Tensor:
    """`DiT.forward_train` with the blocks run as a GPipe pipeline over the
    mesh's "stage" axis (the module's docstring) -> [b, n, mel] float32 on
    x's device. `num_microbatches` (M) defaults to max(1, stages); a batch
    that the data rows do not divide, or a data row's share that M does not
    divide, raises ValueError."""
    cfg, grid = pipelined.cfg, pipelined.mesh.devices
    data, stages = grid.shape
    m_count = max(1, stages) if num_microbatches is None else num_microbatches
    b = x.shape[0]
    if b % data:
        raise ValueError(f"batch {b} is not divisible by the mesh's data-axis size {data}")
    per_row = b // data
    if m_count < 1 or per_row % m_count:
        raise ValueError(f"per-data-row batch {per_row} is not divisible by num_microbatches={m_count}")
    mb = per_row // m_count
    time = torch.as_tensor(time, dtype=torch.float32, device=x.device)
    batched = (x, cond, text, time.expand(b) if time.ndim == 0 else time,
               B.as_batch_flag(drop_audio_cond, b, x.device), B.as_batch_flag(drop_text, b, x.device))
    use_dropout = generator is not None and cfg.dropout > 0.0
    seeds = B.draw_seeds(generator, cfg.depth) if use_dropout else [None] * cfg.depth
    per = pipelined.per_stage
    n = x.shape[1]
    ropes = {}

    def rope_on(device):
        if device not in ropes:
            raw = rotary_freqs(n, cfg.dim_head, device=device)
            ropes[device] = (torch.cos(raw), torch.sin(raw))
        return ropes[device]

    # the preamble, once a data row; each stage's modulations, mask and tables on its device
    inputs, t_embs, stage_args = {}, [], []
    for r in range(data):
        rows = slice(r * per_row, (r + 1) * per_row)
        h, t_emb, _ = pipelined.trunks[r].train_inputs(*(t[rows].to(grid[r, 0], non_blocking=True) for t in batched))
        t_embs.append(t_emb)
        for m in range(m_count):
            inputs[(r, 0, m)] = h[m * mb:(m + 1) * mb]
        row_args = []
        for s in range(stages):
            dev = grid[r, s]
            t_s = t_emb.to(dev, non_blocking=True)
            mods = [block.attn_norm.mods(t_s) for block in pipelined.stages[r][s]]  # each [per_row, 6 dim]
            row_args.append((mods, None if mask is None else mask[rows].to(dev, non_blocking=True), rope_on(dev)))
        stage_args.append(row_args)

    # fill and drain: at tick t stage s runs microbatch t - s, the bubble's ticks skipped
    last = [[None] * m_count for _ in range(data)]
    for t in range(m_count + stages - 1):
        for r in range(data):
            for s in range(max(0, t - m_count + 1), min(stages, t + 1)):
                m = t - s
                mods, row_mask, rope = stage_args[r][s]
                mbs = slice(m * mb, (m + 1) * mb)
                h = _run_stage(pipelined.stages[r][s], inputs.pop((r, s, m)), [mod[mbs] for mod in mods],
                               None if row_mask is None else row_mask[mbs], rope, cfg.dropout,
                               seeds[s * per:(s + 1) * per], Rows(b, r * per_row + m * mb) if use_dropout else None)
                if s + 1 < stages:
                    inputs[(r, s + 1, m)] = stage_send(h, grid[r, s + 1])
                else:
                    last[r][m] = h

    outs = [pipelined.trunks[r].train_head(stage_to_head(torch.cat(last[r]), grid[r, 0]), t_embs[r])
            for r in range(data)]
    return gather_batch(outs, x.device, b)
