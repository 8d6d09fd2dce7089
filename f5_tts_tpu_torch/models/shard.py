"""Tensor-parallel shards of the DiT and the duration predictor: the module
half of the JAX package's `shard_params`, by the specs of parallel/mesh.py
`param_specs`.

Each slot of a data row's tensor-parallel group gets a copy of the model
whose sharded tensors are its slot's slices, with each attention's local
head count and each linear's local widths (`shard_module`). For sampling
the rows' shards are wrapped in `models/dit.py` `DiTGroup`s
(`shard_model_for_inference`); for training every slot gets a trainable
copy, its parameters leaves of their own (`shard_model_for_training`; a
seq slot of sequence parallelism gets a copy of its model column's shard),
`shard_train_state` cuts a train state over them, and `gather_shards` joins
a sharded train state's stored pieces back into the full `state_dict`.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from f5_tts_tpu_torch.models.blocks import Attention, FeedForward
from f5_tts_tpu_torch.models.dit import DiT, DiTGroup, require_dit
from f5_tts_tpu_torch.models.duration import DurationGroup, DurationPredictor
from f5_tts_tpu_torch.models.quant import QuantizedLinear
from f5_tts_tpu_torch.ops.qmatmul import GROUP_SIZE
from f5_tts_tpu_torch.parallel.mesh import (
    COL_SHARDED,
    ROW_SHARDED,
    Mesh,
    ShardedTrainState,
    gather_state,
    param_specs,
    refuse_stage,
    shard_state,
)


def _split(name: str) -> bool:
    """Whether the attention or feed-forward module at `name` is split: the
    rules name its linears "attn.to_q", "ff.ff.0.0", ..."""
    return ("." + name).endswith((".attn", ".ff"))


def _check_shardable(dit: nn.Module, model: int) -> None:
    for name, m in dit.named_modules():
        if isinstance(m, (Attention, FeedForward)) and not _split(name):
            continue
        if isinstance(m, Attention) and m.heads % model:
            raise ValueError(f"{name} has {m.heads} heads, which a model axis of {model} does not divide")
        if isinstance(m, FeedForward) and m.ff[0][0].out_features % model:
            raise ValueError(f"{name} has {m.ff[0][0].out_features} hidden units, which a model axis of {model} "
                             "does not divide")
        if isinstance(m, QuantizedLinear) and name.endswith(ROW_SHARDED) and (m.in_features // model) % GROUP_SIZE:
            raise ValueError(f"{name} is quantized in groups of {GROUP_SIZE} along its {m.in_features} inputs; "
                             f"a model axis of {model} leaves {m.in_features // model} a slot, not a multiple "
                             f"of {GROUP_SIZE}")


def _shard(dit: nn.Module, specs: dict, slot: int, ways: int) -> nn.Module:
    """Slot `slot` of `ways` of `dit`: a copy whose sharded tensors are their
    slot's slices (the full tensors are never copied), with each attention's
    local head count and each linear's local widths."""
    memo = {}
    for name, spec in specs.items():
        if "model" not in spec:
            continue
        owner, _, leaf = name.rpartition(".")
        module = dit.get_submodule(owner)
        t = getattr(module, leaf)
        piece = t.detach().chunk(ways, spec.index("model"))[slot].clone(memory_format=torch.contiguous_format)
        memo[id(t)] = nn.Parameter(piece, requires_grad=False) if isinstance(t, nn.Parameter) else piece
    shard = copy.deepcopy(dit, memo)
    for name, m in shard.named_modules():
        if isinstance(m, (Attention, FeedForward)) and _split(name):
            m.tp, m.tp_index = ways, slot
            if isinstance(m, Attention):
                m.heads //= ways
        elif hasattr(m, "in_features") and hasattr(m, "out_features"):
            if name.endswith(COL_SHARDED):
                m.out_features //= ways
            elif name.endswith(ROW_SHARDED):
                m.in_features //= ways
    return shard


def shard_module(module: nn.Module, mesh: Mesh, seq_slots: bool = False) -> list[list[nn.Module]]:
    """One shard of `module` a slot of the grid by `param_specs`, on its
    slot's device: a list a data row of its tensor-parallel group's shards,
    or with `seq_slots` of its seq x model slots' (row-major; each seq slot
    a copy of the model group). Raises ValueError where the model axis does
    not divide an attention's heads or a feed-forward's hidden width, or
    leaves a quantized row-sharded linear an input width that is not a
    multiple of 64 a slot, and for a mesh with a "stage" axis (the
    pipeline's, parallel/pipeline.py)."""
    refuse_stage(mesh, "shard_module")
    ways = mesh.shape["model"]
    _check_shardable(module, ways)
    specs = param_specs(module)
    groups = [list(row.flat) for row in mesh.devices] if seq_slots else mesh.tp_groups()
    return [[_shard(module, specs, i % ways, ways).to(device) for i, device in enumerate(group)]
            for group in groups]


def shard_model_for_inference(dit: nn.Module, mesh: Mesh) -> list[DiTGroup]:
    """One DiT shard per slot of the grid, built from `dit` (the sampler's
    inference copy: cast, and W8A8 where int8 compute is on) by
    `param_specs`: each attention keeps heads / model heads and each
    feed-forward hidden / model units; the rest is replicated. Returns one
    `DiTGroup` per data row, its shards on that row's devices. Raises
    ValueError as `shard_module` does, and for a model other than a DiT."""
    require_dit(dit, "shard_model_for_inference")
    return [DiTGroup(shards) for shards in shard_module(dit, mesh)]


def shard_model_for_training(model: nn.Module, mesh: Mesh) -> list:
    """Trainable shards of a DiT or a duration predictor, one a slot of the
    grid by `param_specs`, every parameter a leaf of its own that requires
    grad (a replicated tensor is copied into each slot: one parameter tied
    across the grid; a seq slot holds its own copy of its model column's
    shard). Returns one group a data row over its seq x model slots:
    `DiTGroup`s or `DurationGroup`s. Raises ValueError as `shard_module`
    does, and for another model."""
    group = {DiT: DiTGroup, DurationPredictor: DurationGroup}.get(type(model))
    if group is None:
        raise ValueError(f"shard_model_for_training takes a DiT or a duration predictor, not a {type(model).__name__}")
    rows = shard_module(model, mesh, seq_slots=True)
    for shards in rows:
        for shard in shards:
            shard.requires_grad_(True)
    return [group(shards, mesh.seq) for shards in rows]


def shard_train_state(state, mesh: Mesh, fsdp: bool = False) -> ShardedTrainState:
    """A train state (training/trainer.py `TrainState`) over the grid: its
    model's trainable shards (`shard_model_for_training`) and its
    parameters, moments and EMA cut by the specs (parallel/mesh.py
    `shard_state`: with several processes and `fsdp`, this process's global
    data rows' pieces only)."""
    return shard_state(state, mesh, shard_model_for_training(state.model, mesh), fsdp)


def gather_shards(state: ShardedTrainState) -> dict[str, torch.Tensor]:
    """The full `state_dict` of a sharded train state's parameters: each
    tensor joined from the slots that own its pieces, across the processes
    under FSDP (parallel/mesh.py `gather_state`: every process calls it), on
    the first slot's device."""
    return gather_state(state)["params"]
