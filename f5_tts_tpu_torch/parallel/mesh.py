"""Mesh parallelism in one process: data parallelism over a "data" axis,
Megatron-style tensor parallelism over a "model" axis, for sampling and for
training, and sequence parallelism over a "seq" axis in training (the port
of the JAX package's `parallel/mesh.py`).

The JAX package is single-controller: one process, a `Mesh` over
`jax.devices()`, and GSPMD inserting the collectives. The port keeps that
shape: one process drives a grid of devices, each slot of the grid holds
its own shard of the model, and the collectives are plain tensor work,
each one counted (`all_reduce`, `all_gather`, `reduce_scatter`). A grid may
name one device several times, as the JAX suite meshes 8 virtual CPU
devices: the slots then share that device, which shows correctness and
host cost, not scaling. Several processes (`distributed.initialize`) each
drive a grid over their own devices, and the data axis spans them: W
processes of `data` local rows make a global data axis of data x W rows,
row `rank x data + r` being process `rank`'s local row r (the device order
of a JAX mesh over every process's devices).

TP layout (the classic two-collective pattern, `param_specs`):
  - attention to_q/to_k/to_v and feed-forward w1 (`ff.ff.0.0`): output dim
    sharded, so each slot holds heads / model heads and hidden / model
    units;
  - attention to_out and feed-forward w2 (`ff.ff.2`): input dim sharded,
    so each slot's output is a partial sum, reduced once, and the bias is
    added once, after the reduction;
  - everything else (embeddings, norms, AdaLN modulation, convs, the text
    embedding, proj_out) is replicated.
FSDP (`param_specs(fsdp_data_size=)`, the JAX `_with_fsdp`) also shards
the largest free dim of each 2-D weight matrix over "data" (ZeRO), sized
by the global data axis as JAX sizes it by its mesh's: global row g stores
piece g of data x W of the matrix, its AdamW moments and its EMA, so each
process holds 1/W of them and each of its slots 1/(data x W).

Sampling (`F5TTS.use_mesh`) pads the batch to a multiple of "data" with
copies of row 0 (`pad_batch`), splits it over the data rows
(`split_batch`), runs each row's DiT group (models/shard.py
`shard_model_for_inference`, by these specs) and vocoder on that row's
devices and gathers the rows back.

Training (`shard_state`, `shard_train_step`; the trainers' `mesh=` and
`fsdp=`): every slot holds a trainable shard (models/shard.py
`shard_model_for_training` builds them, `shard_train_state` the state over
them), each data row's slice of the global batch runs
on its tensor-parallel group in step, and autograd carries the backward
across the slots (the row-parallel sum is an autograd function whose
backward sums the output gradients over the group, counted as the
forward's). The gradient reduction rule (`reduce_gradient`):
  - a replicated tensor is one parameter tied across every slot of the
    grid, each slot holding its own leaf: its gradient is the sum over all
    the slots (the tensor-parallel group times the data rows);
  - a model-sharded tensor's gradient is the sum over the data rows of its
    column;
  - with several processes the reduced gradient is then summed across
    them (`distributed.sum_across_processes`);
  - under FSDP the slots' sum is instead reduce-scattered, across the
    processes too (`reduce_scatter`): each global data row keeps its piece
    (the accumulator of `grad_accum` too, as the JAX `grad_shardings` pins
    it), and the full weight is gathered into the slots' compute leaves at
    each microbatch, from the local rows and then across the processes
    (`all_gather`);
  - the global-norm clip is taken over the reduced gradient, each logical
    tensor counted once (each piece on the slot that owns it, `owns`; the
    data-sharded pieces' squares summed across the processes, the rest the
    same in every process and counted once), and AdamW and the EMA then
    update every slot's shard in place.
The loss is each data row's numerator over the global batch's denominator
(the CFM loss's span elements, the duration loss's batch size), and the
draws and dropout seeds are drawn once for the global batch and split over
the data rows, so the sharded step is the unsharded step in another order
of sums. This module knows tensors, names and the slots' parameters, not
the model's modules: the groups of shards come from models/shard.py, the
trainer's objective runs them (`numerator`), and the trainer's
`UpdateRule` accumulates and applies the update, as in the unsharded step.

Sequence parallelism (a "seq" axis above 1, training only; JAX shards the
step's frames over it with `sequence_sharding` and GSPMD adds the
collectives). The slots are row-major over (data, seq, model); a seq slot
holds a copy of its model column's shard (the parameters are replicated
over "seq", and seq index 0 owns the piece: the gradient norm and the
checkpoints read it alone), and a data row's group runs all its seq x model
slots in step (`lockstep`). Each seq slot computes its `Frames` of the
sequence: the text embedding whole (its GRN sums over every frame), the
input embedding on a window its two convolutions reach, clipped to the
sequence, then the blocks and the head on its own frames. Its attention
takes its queries against the keys and values gathered over its seq group
(one data row, one model column: `seq_all_gather`, whose backward
reduce-scatters the keys' and values' gradient back to the slots' frames
within the group; not FSDP's `reduce_scatter`, which also sums across
processes), with RoPE at the slot's offset (ops/flash_attention.py, a query
block). The gradient rule above then sums over the seq slots too: they are
more slots of the group. A duration step's pooled sums are joined by a
counted `seq_sum`. Frames that "seq" does not divide raise ValueError, as
JAX's `device_put` refuses them.
"""

from __future__ import annotations

import dataclasses
import re
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from f5_tts_tpu_torch.parallel import distributed as D

# the JAX package's _COL_SHARDED / _ROW_SHARDED by the port's module names
COL_SHARDED = ("attn.to_q", "attn.to_k", "attn.to_v", "ff.ff.0.0")  # output dim
ROW_SHARDED = ("attn.to_out.0", "ff.ff.2")  # input dim


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of torch devices: `devices` is a numpy object array with one
    axis per name of `axis_names`: ("data", "model") or ("data", "seq",
    "model") (`create_mesh`), or ("data", "stage") for the pipeline
    (parallel/pipeline.py `create_pipeline_mesh`), which the other users of
    a mesh refuse (`refuse_stage`)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as JAX's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def seq(self) -> int:
        return self.shape.get("seq", 1)

    def tp_groups(self) -> list[list[torch.device]]:
        """Each data row's tensor-parallel group: the devices along "model"
        (at seq index 0: for inference the seq slots hold replicas and do
        no work)."""
        grid = self.devices[:, 0, :] if "seq" in self.axis_names else self.devices
        return [list(row) for row in grid]

    def __str__(self) -> str:
        distinct = len({str(d) for d in self.devices.flat})
        dims = "x".join(str(s) for s in self.devices.shape)
        return (f"{dims} mesh {self.axis_names} over {distinct} distinct device{'s' if distinct > 1 else ''} "
                f"({', '.join(str(d) for d in self.devices.flat)})")


def refuse_stage(mesh: Mesh, user: str) -> None:
    """Raise ValueError when `mesh` has a "stage" axis: `user` takes a
    ("data", "model") or ("data", "seq", "model") grid, and a pipeline's
    grid is for parallel/pipeline.py alone."""
    if "stage" in mesh.axis_names:
        raise ValueError(f"{user} takes a mesh of ('data', 'model') or ('data', 'seq', 'model'), not {mesh}: a "
                         "'stage' axis is the pipeline's (parallel/pipeline.py shard_params_for_pipeline)")


def _as_device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def device_list(kind: str | torch.device) -> list[torch.device]:
    """Every device of `kind`'s type in this process: each CUDA card, or the
    one CPU device. The CLIs build their meshes over these."""
    kind = torch.device(kind).type
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(kind)]


def create_mesh(data: int | None = None, model: int = 1, seq: int = 1, devices=None) -> Mesh:
    """Build a ("data", "model") mesh, or ("data", "seq", "model") when
    `seq` > 1, over the first data * seq * model of `devices` (default:
    every CUDA device in this process; a list may repeat a device, for a
    virtual grid on one card or on the CPU). `data` defaults to all the
    devices left over by model * seq. Too few devices raise ValueError.

    `seq` shards the training step's frames, as in the JAX package;
    sampling replicates the parameters over it and splits the batch over
    "data" only, so its slots hold replicas and do no work."""
    devices = [_as_device(d) for d in (device_list("cuda") if devices is None else devices)]
    n = len(devices)
    if data is None:
        data = n // (model * seq)
    if data < 1 or data * model * seq > n:
        raise ValueError(f"mesh {data}x{seq}x{model} needs {max(1, data) * model * seq} devices, have {n}")
    grid = np.empty(data * seq * model, dtype=object)
    grid[:] = devices[: data * seq * model]
    if seq == 1:
        return Mesh(grid.reshape(data, model), ("data", "model"))
    return Mesh(grid.reshape(data, seq, model), ("data", "seq", "model"))


# ------------------------------------------------------------- spec rules


def _spec_for(name: str, ndim: int) -> tuple:
    """The JAX package's `_spec_for` on a tensor of the port's layout
    (linear weights, codes and w8 [out, in]; group scales and biases
    [out, in / 64]): one entry a dim, "model" where it is sharded."""
    dotted = "." + name
    if any(f".{pat}." in dotted for pat in COL_SHARDED):  # every leaf along its output dim
        return ("model",) + (None,) * (ndim - 1)
    if any(f".{pat}." in dotted for pat in ROW_SHARDED):
        if name.endswith((".weight", ".q", ".w8", ".scales", ".biases")):  # the input dim, groups alongside
            return (None, "model")
        return (None,) * ndim  # the output-side bias and w8_scale: replicated
    return (None,) * ndim


# the JAX package's _FSDP_EXEMPT_RE: the whole text embedding stays off FSDP
FSDP_EXEMPT = re.compile(r"(^|\.)text_embed\.")


def _with_fsdp(spec: tuple, name: str, shape: tuple, data_size: int) -> tuple:
    """The JAX package's `_with_fsdp` on a tensor of the port's layout: a
    2-D weight matrix outside the text embedding gets "data" on its largest
    dim that is not sharded already and that `data_size` divides; 1-D
    leaves, conv kernels and GRN's [1, 1, dim] stay as they are. On a tie
    the input dim wins (the port's [out, in] is the JAX [in, out]
    transposed, and JAX's max takes the first)."""
    if data_size <= 1 or FSDP_EXEMPT.search(name) or len(shape) != 2:
        return spec
    cands = [i for i in range(2) if spec[i] is None and shape[i] % data_size == 0 and shape[i] >= data_size]
    if not cands:
        return spec
    best = max(cands, key=lambda i: (shape[i], i))
    return spec[:best] + ("data",) + spec[best + 1:]


def param_specs(module_or_state_dict: nn.Module | dict, fsdp_data_size: int | None = None) -> dict[str, tuple]:
    """Tensor name -> spec: a tuple with one entry a dim, "model" for the
    dim sharded over the model axis, "data" for the one sharded over the
    data axis (FSDP) and None elsewhere; all None for a replicated tensor.
    The JAX package's rules (`_COL_SHARDED`, `_ROW_SHARDED`, `_spec_for`)
    by the port's names, for float, weight-only quantized and W8A8 trees
    alike; with `fsdp_data_size` (the data axis's size under FSDP) weight
    matrices also shard over "data" (`_with_fsdp`)."""
    state = module_or_state_dict.state_dict() if isinstance(module_or_state_dict, nn.Module) \
        else module_or_state_dict
    specs = {name: _spec_for(name, t.ndim) for name, t in state.items()}
    if fsdp_data_size is not None:
        specs = {name: _with_fsdp(spec, name, tuple(state[name].shape), fsdp_data_size) for name, spec in specs.items()}
    return specs


def state_specs(state, fsdp_data_size: int | None = None) -> dict:
    """Specs of a whole train state (training/trainer.py `TrainState`): the
    parameters, and the AdamW moments and the EMA, which mirror their names
    and shapes and so shard as they do (under FSDP the moments are the
    ZeRO win: twice the parameters, never gathered)."""
    params = param_specs(dict(state.model.named_parameters()), fsdp_data_size)
    return {"params": params, "mu": params, "nu": params, "ema": None if state.ema is None else params}


# ------------------------------------------------------------- the collectives


def _combined(tensors: list[torch.Tensor], combine) -> list[torch.Tensor]:
    dst = tensors[0].device
    out = tensors[0]
    for t in tensors[1:]:
        out = combine(out, t.to(dst, non_blocking=True))
    return [out.to(t.device, non_blocking=True) for t in tensors]


def all_reduce(tensors: list[torch.Tensor], op: str = "sum") -> list[torch.Tensor]:
    """The collective of tensor parallelism, in one process: each slot's
    tensor is copied to the first slot's device and combined there in slot
    order (a sum, or an elementwise max), and the result is copied back to
    every slot's device (the same tensor where a device repeats). No NCCL:
    the same code serves distinct cards and a card that repeats. Counted in
    `all_reduce.counts[op]`, once a reduction of the group: "sum" for the
    row-parallel activations (in training their backward too), "max" for
    W8A8's row absmax."""
    out = _combined(tensors, {"sum": torch.add, "max": torch.maximum}[op])
    all_reduce.counts[op] += 1
    return out


all_reduce.counts = {"sum": 0, "max": 0}


def grad_all_reduce(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """A gradient's sum over the slots that hold the same piece (as
    `all_reduce`'s sum), counted apart from the activations' in
    `grad_all_reduce.count`."""
    out = _combined(tensors, torch.add)
    grad_all_reduce.count += 1
    return out


grad_all_reduce.count = 0


def _distinct(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The list with a copy wherever a tensor repeats (slots sharing a
    device get the same result tensor from `all_reduce`), so that autograd
    sees one output a slot."""
    seen, out = set(), []
    for t in tensors:
        out.append(t.clone() if id(t) in seen else t)
        seen.add(id(t))
    return out


class RowSum(torch.autograd.Function):
    """The row-parallel sum in training: the forward sums the group's
    partial outputs (`all_reduce`), the backward hands each slot the sum of
    the output gradients over the group (another counted `all_reduce`):
    every slot's output is the same sum, so each partial's gradient is the
    sum of the outputs' gradients."""

    @staticmethod
    def forward(ctx, *partials):
        return tuple(_distinct(all_reduce(list(partials), "sum")))

    @staticmethod
    def backward(ctx, *grads):
        return tuple(_distinct(all_reduce(list(grads), "sum")))


def row_sum(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The group's sum of row-parallel partials: through `RowSum` where
    autograd records it, else the plain `all_reduce`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return list(RowSum.apply(*tensors))
    return all_reduce(tensors, "sum")


def all_gather(pieces: list[torch.Tensor], dim: int, devices: list[torch.device]) -> list[torch.Tensor]:
    """FSDP's gather: the local data rows' pieces (in row order) joined
    along `dim` on the first device, then the processes' joins along `dim`
    in rank order (`distributed.all_gather_across_processes`, with several),
    then one tensor for each of `devices` (the same tensor where a device
    repeats). Counted in `all_gather.count`, once a gather."""
    full = torch.cat([p.to(devices[0], non_blocking=True) for p in pieces], dim)
    full = D.all_gather_across_processes(full, dim)
    all_gather.count += 1
    return [full.to(d, non_blocking=True) for d in devices]


all_gather.count = 0


def reduce_scatter(tensors: list[torch.Tensor], dim: int, parts: int,
                   devices: list[torch.device], index: list[int]) -> list[torch.Tensor]:
    """FSDP's gradient reduction: the slots' tensors summed in slot order on
    the first slot's device; with several processes that sum is
    reduce-scattered across them (`distributed.reduce_scatter_across_processes`:
    the processes' sum of this process's piece); the result is cut into
    `parts` (the local data rows) along `dim`, and piece `index[i]` sent to
    `devices[i]`. Counted in `reduce_scatter.count`, once a reduction."""
    dst = tensors[0].device
    total = tensors[0]
    for t in tensors[1:]:
        total = total + t.to(dst, non_blocking=True)
    total = D.reduce_scatter_across_processes(total, dim)
    pieces = total.chunk(parts, dim)
    reduce_scatter.count += 1
    return [pieces[i].to(d, non_blocking=True) for i, d in zip(index, devices)]


reduce_scatter.count = 0


class SeqGather(torch.autograd.Function):
    """The gather of sequence parallelism, in one process: the seq group's
    pieces (in seq order) joined along `dim` on the first piece's device and
    handed to every slot (counted in `gathers`, once a gather). The backward
    is the matching reduce-scatter: the slots' gradients of the whole summed
    in seq order on the first device, cut back into the pieces' frames and
    each sent to its slot (counted in `reduce_scatters`). It stays within
    the group: no sum across processes."""

    gathers = 0
    reduce_scatters = 0

    @staticmethod
    def forward(ctx, dim, *pieces):
        ctx.dim, ctx.sizes, ctx.devices = dim, [p.shape[dim] for p in pieces], [p.device for p in pieces]
        full = torch.cat([p.to(pieces[0].device, non_blocking=True) for p in pieces], dim)
        SeqGather.gathers += 1
        return tuple(_distinct([full.to(p.device, non_blocking=True) for p in pieces]))

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0].to(ctx.devices[0])
        for g in grads[1:]:
            total = total + g.to(ctx.devices[0], non_blocking=True)
        SeqGather.reduce_scatters += 1
        parts = total.split(ctx.sizes, ctx.dim)
        return (None, *(part.to(dev, non_blocking=True) for part, dev in zip(parts, ctx.devices)))


def seq_all_gather(pieces: list[torch.Tensor], dim: int = 1) -> list[torch.Tensor]:
    """Each seq slot's piece of an activation (its frames along `dim`) to
    the whole, on every slot's device, through `SeqGather`."""
    return list(SeqGather.apply(dim, *pieces))


class SeqSum(torch.autograd.Function):
    """A sum over a seq group (the duration head's pooled sums), counted in
    `count`, forward and backward, as `RowSum` counts its own: every slot's
    output is the same sum, so each part's gradient is the sum of the
    outputs' gradients."""

    count = 0

    @staticmethod
    def forward(ctx, *parts):
        SeqSum.count += 1
        return tuple(_distinct(_combined(list(parts), torch.add)))

    @staticmethod
    def backward(ctx, *grads):
        SeqSum.count += 1
        return tuple(_distinct(_combined(list(grads), torch.add)))


def seq_sum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The seq group's sum of `parts`, one a slot (its copy on each slot's
    device), through `SeqSum`."""
    return list(SeqSum.apply(*parts))


def stage_send(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The pipeline's handoff (parallel/pipeline.py): a stage's output for
    one microbatch copied to the next stage's device (the same tensor where
    the device repeats), as JAX's `ppermute` over "stage"; autograd carries
    the gradient back through the copy. Counted in `stage_send.count`, once
    a handoff of the forward."""
    stage_send.count += 1
    return t.to(device, non_blocking=True)


stage_send.count = 0


def stage_to_head(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A data row's output of the pipeline's last stage moved to the device
    where its head runs (JAX psums it over "stage"). Counted in
    `stage_to_head.count`, once a data row of the forward."""
    stage_to_head.count += 1
    return t.to(device, non_blocking=True)


stage_to_head.count = 0


def collective_counts() -> dict:
    """Every counted collective: the all-reduces by op, the gathers and the
    reduce-scatters of FSDP (and of those, the ones across processes),
    those of sequence parallelism and the pipeline's handoffs."""
    return {**{f"all_reduce_{op}": n for op, n in all_reduce.counts.items()},
            "grad_all_reduce": grad_all_reduce.count, "all_gather": all_gather.count,
            "reduce_scatter": reduce_scatter.count,
            "process_all_gather": D.all_gather_across_processes.count,
            "process_reduce_scatter": D.reduce_scatter_across_processes.count,
            "seq_all_gather": SeqGather.gathers, "seq_reduce_scatter": SeqGather.reduce_scatters,
            "seq_sum": SeqSum.count, "stage_send": stage_send.count, "stage_to_head": stage_to_head.count}


def reset_collective_counts() -> None:
    all_reduce.counts.update({op: 0 for op in all_reduce.counts})
    grad_all_reduce.count = all_gather.count = reduce_scatter.count = 0
    D.all_gather_across_processes.count = D.reduce_scatter_across_processes.count = 0
    SeqGather.gathers = SeqGather.reduce_scatters = SeqSum.count = 0
    stage_send.count = stage_to_head.count = 0


def lockstep(steps: list, seq: int = 1) -> list:
    """Run one forward a slot of a data row's group, each a generator (a
    module's `steps`), to the end in step; the steps are row-major over
    (seq, model) slots. At each point where they yield (op, tensor), the
    tensors are combined and each generator is sent its own copy of the
    result: a "sum" (through `row_sum`, so that training records it) or a
    "max" (`all_reduce`) within each seq slot's model group, a "gather"
    (`seq_all_gather`, along the frames) within each model column's seq
    group. Every slot's work up to a collective is issued before the next
    slot's; nothing reads back to the host. Returns each generator's value."""
    model = len(steps) // seq
    sent = [None] * len(steps)
    while True:
        asked, done = [], []
        for step, value in zip(steps, sent):
            try:
                asked.append(step.send(value))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if asked:
                raise RuntimeError("the slots of a tensor-parallel group stopped at different points")
            return done
        ops = {op for op, _ in asked}
        if len(ops) != 1:
            raise RuntimeError(f"the slots of a tensor-parallel group asked for different reductions: {ops}")
        op = ops.pop()
        tensors = [t for _, t in asked]
        sent = [None] * len(steps)
        if op == "gather":
            for j in range(model):
                for s, t in zip(range(j, len(steps), model), seq_all_gather(tensors[j::model])):
                    sent[s] = t
        else:
            for q in range(seq):
                group = tensors[q * model:(q + 1) * model]
                sent[q * model:(q + 1) * model] = row_sum(group) if op == "sum" else all_reduce(group, op)


# ------------------------------------------------------------- data parallel batches


def pad_batch(t: torch.Tensor, data: int) -> torch.Tensor:
    """t [b, ...] with copies of row 0 appended up to a multiple of `data`
    rows, as the JAX package pads a batch for its data axis."""
    pad = -t.shape[0] % data
    return t if not pad else torch.cat([t, t[:1].expand(pad, *t.shape[1:])])


def split_batch(t: torch.Tensor, devices: list[torch.device]) -> list[torch.Tensor]:
    """A padded batch in equal row blocks, one to each data row's device."""
    return [part.to(dev, non_blocking=True) for part, dev in zip(t.chunk(len(devices)), devices)]


def gather_batch(parts: list[torch.Tensor], device: torch.device, batch: int, dim: int = 0) -> torch.Tensor:
    """The data rows' results joined along `dim` on `device`, the padding
    rows past `batch` trimmed."""
    return torch.cat([p.to(device) for p in parts], dim=dim).narrow(dim, 0, batch)


# ------------------------------------------------------------- training over the grid


@dataclasses.dataclass(frozen=True)
class Frames:
    """A seq slot's frames in a frame-sharded training step: slot `index`
    of `ways` holds rows [start, stop) of `total` (`total` divided evenly)."""

    ways: int
    index: int
    total: int

    @property
    def length(self) -> int:
        return self.total // self.ways

    @property
    def start(self) -> int:
        return self.index * self.length

    @property
    def stop(self) -> int:
        return self.start + self.length

    def take(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This slot's frames of a whole-sequence tensor (a view)."""
        return t.narrow(dim, self.start, self.length)

    def window(self, reach: int) -> tuple[int, int]:
        """The frames that a stack of convolutions reaching `reach` frames
        each way needs for this slot's, clipped to the sequence: where the
        window stops at the sequence's end, the convolutions' zero padding
        is the sequence's own."""
        return max(0, self.start - reach), min(self.total, self.stop + reach)


def seq_frames(ways: int, total: int) -> list[Frames]:
    """Each seq slot's frames of `total`, in seq order."""
    return [Frames(ways, q, total) for q in range(ways)]


def group_frames(seq: int, slots: int, total: int) -> list[Frames | None]:
    """Each slot's frames in a data row's group of `slots` shards, row-major
    over (seq, model); None for each without sequence parallelism."""
    if seq == 1:
        return [None] * slots
    return [f for f in seq_frames(seq, total) for _ in range(slots // seq)]


class Slot(NamedTuple):
    """One slot of the grid: its data row, seq index, model column and
    device."""

    row: int
    seq: int
    col: int
    device: torch.device


def slots(mesh: Mesh) -> list[Slot]:
    """The grid's slots, row-major over (data, seq, model)."""
    grid = mesh.devices.reshape(mesh.shape["data"], mesh.seq, mesh.shape["model"])
    return [Slot(r, q, j, _as_device(grid[r, q, j])) for r in range(grid.shape[0]) for q in range(grid.shape[1])
            for j in range(grid.shape[2])]


def piece(t: torch.Tensor, spec: tuple, r: int, j: int, mesh_shape: dict) -> torch.Tensor:
    """Slot (r, j)'s piece of a full tensor by its spec (a view; every seq
    index of (r, j) holds the same piece). Across processes `r` is the
    global data row and `mesh_shape` the global grid's
    (`ShardedTrainState.global_shape`)."""
    for axis, index in (("model", j), ("data", r)):
        if axis in spec:
            t = t.chunk(mesh_shape[axis], spec.index(axis))[index]
    return t


def owns(spec: tuple, r: int, j: int, q: int = 0) -> bool:
    """Whether slot (r, q, j) holds a piece of the tensor that no other slot
    holds: along each axis the spec shards, every slot owns its piece;
    along the others (and always along "seq"), the first. With the global
    data row `r` this holds across processes; with a local row, within
    one."""
    return q == 0 and (r == 0 or "data" in spec) and (j == 0 or "model" in spec)


def assemble(pieces: dict, spec: tuple, mesh_shape: dict, device=None) -> torch.Tensor:
    """The full tensor from the owners' pieces {(r, j): tensor} (the
    inverse of `piece`), on `device` (default: the first piece's). Over
    one process's local rows a data-sharded tensor comes out as that
    process's block along its data dim."""
    data = mesh_shape["data"] if "data" in spec else 1
    model = mesh_shape["model"] if "model" in spec else 1
    device = device or pieces[(0, 0)].device
    cols = []
    for j in range(model):
        rows = [pieces[(r, j)].to(device) for r in range(data)]
        cols.append(torch.cat(rows, spec.index("data")) if data > 1 else rows[0])
    return torch.cat(cols, spec.index("model")) if model > 1 else cols[0]


@dataclasses.dataclass
class ShardedTrainState:
    """A train state over a grid: one group of trainable shards a data row
    (`groups`, whose parameters are the compute leaves), each slot's stored
    tensors by name (`params`: the compute leaf itself, or under FSDP the
    slot's 1/data piece, which is gathered into the leaf at each
    microbatch), the AdamW moments and the EMA in the stored layout, the
    update count and the step. Slots are row-major over (data, seq, model):
    a data row's group holds its seq x model shards in that order. `world`
    and `rank` are the processes' count and this one's index when the state
    was cut: the global data axis has data x world rows, and local row r is
    global row rank x data + r (`global_row`)."""

    mesh: Mesh
    fsdp: bool
    groups: list
    specs: dict
    params: list[dict]
    opt_state: dict
    step: int = 0
    ema: list[dict] | None = None
    world: int = 1
    rank: int = 0

    @property
    def slots(self) -> list[Slot]:
        return slots(self.mesh)

    def global_row(self, r: int) -> int:
        """The global data row of local row `r`."""
        return self.rank * self.mesh.shape["data"] + r

    @property
    def global_shape(self) -> dict[str, int]:
        """The grid's shape across the processes: data x world data rows."""
        return {**self.mesh.shape, "data": self.mesh.shape["data"] * self.world}

    def leaves(self) -> list[dict]:
        """Each slot's compute leaves by name."""
        return [dict(shard.named_parameters()) for group in self.groups for shard in group.shards]

    def gathered_names(self) -> list[str]:
        return [name for name, spec in self.specs.items() if "data" in spec]

    def nbytes(self) -> list[dict]:
        """Each slot's stored bytes of the master weights, the moments and
        the EMA."""
        def size(d):
            return sum(t.numel() * t.element_size() for t in d.values())

        out = []
        for s in range(len(self.params)):
            out.append({"params": size(self.params[s]),
                        "moments": size(self.opt_state["mu"][s]) + size(self.opt_state["nu"][s]),
                        "ema": 0 if self.ema is None else size(self.ema[s])})
        return out


def shard_state(state, mesh: Mesh, groups: list, fsdp: bool = False) -> ShardedTrainState:
    """A train state (training/trainer.py `TrainState`) over the grid, on
    the trainable shards of its model that `groups` hold (one group a data
    row, from models/shard.py `shard_model_for_training`; models/shard.py
    `shard_train_state` builds both): the parameters, moments and EMA cut
    by `param_specs` (with FSDP's "data" dims when `fsdp`, sized by the
    global data axis: with several processes each cuts only its own global
    rows' pieces; a seq slot stores its own copy of its (data row, model
    column)'s pieces)."""
    refuse_stage(mesh, "shard_state")
    world, rank = D.process_count(), D.process_index()
    full = dict(state.model.named_parameters())
    specs = param_specs(full, mesh.shape["data"] * world if fsdp else None)
    sharded = ShardedTrainState(mesh, fsdp, groups, specs, [], {"mu": [], "nu": [], "count": state.opt_state["count"]},
                                state.step, None if state.ema is None else [], world, rank)
    shape = sharded.global_shape
    leaves = sharded.leaves()
    with torch.no_grad():
        for s, (r, _, j, dev) in enumerate(slots(mesh)):
            def cut(t, spec):
                return piece(t.detach(), spec, sharded.global_row(r), j, shape).to(dev, copy=True)

            stored = {}
            for name, spec in specs.items():
                leaf = leaves[s][name]
                if "data" in spec:
                    stored[name] = cut(full[name], spec)
                    leaf.data = leaf.data.new_empty(0)  # gathered at each microbatch
                else:
                    stored[name] = leaf
            sharded.params.append(stored)
            for k in ("mu", "nu"):
                sharded.opt_state[k].append({n: cut(state.opt_state[k][n], spec) for n, spec in specs.items()})
            if state.ema is not None:
                sharded.ema.append({n: cut(state.ema[n], spec) for n, spec in specs.items()})
    return sharded


def _assembled(state: ShardedTrainState, per_slot: list[dict], device=None) -> dict:
    """Name -> the full tensor, from one stored-layout dict a slot: the
    process's owners' pieces joined, then a data-sharded tensor's
    processes' blocks gathered across them (a collective: with several
    processes every one must call it)."""
    grid = {(r, j): s for s, (r, q, j, _) in enumerate(state.slots) if q == 0}
    out = {}
    for name, spec in state.specs.items():
        t = assemble({rj: per_slot[s][name] for rj, s in grid.items() if owns(spec, *rj)}, spec, state.mesh.shape,
                     device)
        out[name] = D.all_gather_across_processes(t, spec.index("data")) if "data" in spec else t
    return out


def gather_state(state: ShardedTrainState, device=None) -> dict:
    """The full tensors of a sharded state: {"params", "mu", "nu", "ema"}
    (name -> tensor, on `device`, default the first slot's; "ema" None
    without one), with "count" and "step". Under FSDP across processes it
    gathers across them, so every process calls it."""
    device = device or state.slots[0].device

    def full(per_slot):
        return {name: t.detach() for name, t in _assembled(state, per_slot, device).items()}

    return {"params": full(state.params), "mu": full(state.opt_state["mu"]), "nu": full(state.opt_state["nu"]),
            "ema": None if state.ema is None else full(state.ema), "count": state.opt_state["count"],
            "step": state.step}


def _groups(spec: tuple, coords: list[Slot]) -> list[list[int]]:
    """The slots that hold the same compute piece of a tensor: one group a
    model column (its data rows and seq slots) for a model-sharded tensor,
    else the whole grid; each in slot order."""
    if "model" not in spec:
        return [list(range(len(coords)))]
    cols = sorted({c.col for c in coords})
    return [[s for s, c in enumerate(coords) if c.col == j] for j in cols]


def gather_leaves(state: ShardedTrainState) -> None:
    """Fill the FSDP compute leaves from the data rows' stored pieces: a
    counted `all_gather` a group of `_groups` (a model column, or the grid
    for a replicated matrix) of the pieces that its column's seq index 0
    stores, each slot's leaf then holding its column's whole piece (one
    tensor shared where a device repeats; the seq slots' leaves too)."""
    coords = state.slots
    leaves = state.leaves()
    for name in state.gathered_names():
        spec = state.specs[name]
        for members in _groups(spec, coords):
            column = coords[members[0]].col
            sources = [state.params[s][name] for s in members if coords[s].col == column and coords[s].seq == 0]
            for s, g in zip(members, all_gather(sources, spec.index("data"), [coords[s].device for s in members])):
                leaves[s][name].data = g


def release_leaves(state: ShardedTrainState) -> None:
    """Empty the FSDP compute leaves (between microbatches and steps only
    the stored 1/data pieces stay)."""
    leaves = state.leaves()
    for name in state.gathered_names():
        for s in range(len(leaves)):
            leaves[s][name].data = leaves[s][name].data.new_empty(0)


def reduce_gradient(grads: list[torch.Tensor], spec: tuple, state: ShardedTrainState) -> list[torch.Tensor]:
    """One tensor's gradient from every slot (its compute layout) to every
    slot's stored layout, by the rule in this module's docstring: summed
    over each group of `_groups` (the whole grid for a replicated tensor, a
    model column for a model-sharded one) and across processes, or under
    FSDP reduce-scattered over the global data rows (each seq slot gets its
    data row's piece). One counted collective a group: a `grad_all_reduce`
    or a `reduce_scatter`."""
    coords = state.slots
    out = [None] * len(coords)
    for members in _groups(spec, coords):
        devices = [coords[s].device for s in members]
        if "data" in spec:
            reduced = reduce_scatter([grads[s] for s in members], spec.index("data"), state.mesh.shape["data"],
                                     devices, [coords[s].row for s in members])
        else:
            total = D.sum_across_processes(grad_all_reduce([grads[s] for s in members])[0])
            reduced = [total.to(d, non_blocking=True) for d in devices]
        for s, g in zip(members, reduced):
            out[s] = g
    return out


@dataclasses.dataclass(frozen=True)
class Rows:
    """Where a data row's slice sits in the global batch (across
    processes): dropout draws the global batch's mask and keeps these
    rows."""

    batch: int
    start: int


class ShardedStep:
    """The sharded train step of `shard_train_step`: `(state, inp, text,
    lens, generator=None, draws=None) -> loss`, updating a
    `ShardedTrainState` in place. `inp`, `text` and `lens` are this
    process's batch (with a leading microbatch axis under `grad_accum`);
    `draws`, when given, cover the global batch (across processes; a list of
    one a microbatch under `grad_accum`). `gradients` returns the reduced
    gradient of one batch, gathered to the full tensors, without an
    update."""

    def __init__(self, step_fn, mesh: Mesh, grad_accum: int, fsdp: bool):
        self.objective, self.rule = step_fn.objective, step_fn.rule
        if grad_accum != self.rule.grad_accum:
            raise ValueError(f"shard_train_step(grad_accum={grad_accum}) for a step built with "
                             f"grad_accum={self.rule.grad_accum}")
        self.mesh = mesh
        self.fsdp = fsdp

    def _check(self, state: ShardedTrainState) -> None:
        if state.fsdp != self.fsdp or state.mesh is not self.mesh:
            raise ValueError(f"a state sharded with fsdp={state.fsdp} over {state.mesh} given to a step built with "
                             f"fsdp={self.fsdp} over {self.mesh}")

    def _micro(self, state: ShardedTrainState, inp, text, lens, generator, draws):
        """One microbatch's forward and backward over the grid: (its loss on
        the first slot's device, each slot's reduced gradient by name)."""
        obj = self.objective
        inp, text = D.pad_across_processes(obj.prepare(inp, lens), text)
        world, rank = D.process_count(), D.process_index()
        b = inp.shape[0]
        data = self.mesh.shape["data"]
        if b % data:
            raise ValueError(f"batch size {b} is not divisible by the mesh's data-axis size {data}")
        if inp.shape[1] % self.mesh.seq:
            raise ValueError(f"{inp.shape[1]} frames are not divisible by the mesh's seq-axis size {self.mesh.seq}")
        if draws is None:
            draws = obj.draw(generator, b * world, inp)
        draws = obj.take(draws, slice(rank * b, (rank + 1) * b))
        seeds = obj.seeds(state.groups[0], generator)
        denominator = D.sum_across_processes(obj.count(inp, lens, draws)).clamp(min=1e-6)
        if state.fsdp:
            gather_leaves(state)
        per = b // data
        losses = []
        for r, group in enumerate(state.groups):
            sl = slice(r * per, (r + 1) * per)
            dev = group.device
            row = [t.to(dev, non_blocking=True) for t in (inp[sl], text[sl], lens[sl])]
            numerator = obj.numerator(group, *row, obj.take(draws, sl, dev), seeds, Rows(b * world, rank * b + r * per))
            losses.append(numerator / denominator.to(dev))
        leaves = state.leaves()
        flat = [(s, name, p) for s, d in enumerate(leaves) for name, p in d.items()]
        got = torch.autograd.grad(losses, [p for _, _, p in flat], allow_unused=True)
        grads = [{} for _ in leaves]
        for (s, name, p), g in zip(flat, got):
            grads[s][name] = torch.zeros_like(p) if g is None else g
        del got
        if state.fsdp:
            release_leaves(state)
        first = state.slots[0].device
        loss = sum(l.detach().to(first) for l in losses)
        reduced = [{} for _ in leaves]
        for name, spec in state.specs.items():
            for s, g in enumerate(reduce_gradient([grads[s][name] for s in range(len(grads))], spec, state)):
                reduced[s][name] = g
        return D.sum_across_processes(loss).float(), reduced

    def _accumulate(self, state, inp, text, lens, generator, draws):
        """The step's loss and each slot's gradient in the stored layout, by
        the step's `UpdateRule.accumulate` (under `grad_accum` the
        accumulator is in the stored layout: 1/data under FSDP)."""
        def micro(i):
            if i is None:
                return self._micro(state, inp, text, lens, generator, draws)
            return self._micro(state, inp[i], text[i], lens[i], generator, None if draws is None else draws[i])

        return self.rule.accumulate(micro)

    def global_norm(self, state: ShardedTrainState, grads: list[dict]) -> torch.Tensor:
        """The norm of the whole reduced gradient, each logical tensor once:
        every slot's norms of the pieces it owns, joined on the first
        slot's device; the squares of the data-sharded pieces are summed
        across the processes (each holds its own global rows'), the rest
        are the same in every process and counted once."""
        first = state.slots[0].device
        norms = {True: [], False: []}  # by whether the tensor is data-sharded
        for s, (r, q, j, _) in enumerate(state.slots):
            owned = {True: [], False: []}
            for name, g in grads[s].items():
                spec = state.specs[name]
                if owns(spec, r, j, q):
                    owned["data" in spec].append(g)
            for sharded, gs in owned.items():
                if gs:
                    norms[sharded].extend(n.to(first) for n in torch._foreach_norm(gs))

        def square(ns):
            return torch.linalg.vector_norm(torch.stack(ns)) ** 2 if ns else torch.zeros((), device=first)

        sharded = square(norms[True])
        if norms[True]:
            sharded = D.sum_across_processes(sharded)
        return torch.sqrt(sharded + square(norms[False]))

    def __call__(self, state: ShardedTrainState, inp, text, lens, generator=None, draws=None) -> torch.Tensor:
        self._check(state)
        loss, grads = self._accumulate(state, inp, text, lens, generator, draws)
        norm = self.global_norm(state, grads) if self.rule.optimizer.max_grad_norm > 0 else None
        count = state.opt_state["count"]
        for s, slot in enumerate(state.slots):
            dev = slot.device
            sub = {"mu": state.opt_state["mu"][s], "nu": state.opt_state["nu"][s], "count": count}
            self.rule.apply_(state.params[s], grads[s], sub, None if state.ema is None else state.ema[s],
                             norm=None if norm is None else norm.to(dev))
        state.opt_state["count"] = count + 1
        state.step += 1
        return loss

    def gradients(self, state: ShardedTrainState, inp, text, lens, generator=None, draws=None) -> tuple:
        """(loss, the reduced gradient as full tensors by name) of one step's
        batch, without an update (gathered across the processes: every one
        calls it)."""
        self._check(state)
        loss, grads = self._accumulate(state, inp, text, lens, generator, draws)
        return loss, _assembled(state, grads)


def shard_train_step(step_fn, mesh: Mesh, state: ShardedTrainState | None = None, grad_accum: int = 1,
                     fsdp: bool = False) -> ShardedStep:
    """The step of `step_fn` (training/trainer.py `make_train_step`,
    `make_train_step_from_audio` or `make_duration_train_step`) over the
    grid, for a state from `shard_state(..., mesh, fsdp=fsdp)` (the same
    flag, as in the JAX package). `grad_accum` must be the step's; the
    microbatch axis then leads the inputs, and each microbatch splits over
    "data" (and its frames over "seq") as a step of one does."""
    refuse_stage(mesh, "shard_train_step")
    if state is not None and state.fsdp != fsdp:
        raise ValueError(f"a state sharded with fsdp={state.fsdp} given to shard_train_step(fsdp={fsdp})")
    return ShardedStep(step_fn, mesh, grad_accum, fsdp)
