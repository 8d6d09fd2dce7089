"""Mesh-parallel inference in one process: data parallelism over a "data"
axis and Megatron-style tensor parallelism over a "model" axis (the port of
the JAX package's `parallel/mesh.py`, inference half).

The JAX package is single-controller: one process, a `Mesh` over
`jax.devices()`, and GSPMD inserting the collectives. The port keeps that
shape: one process drives a grid of devices, each slot of the grid holds
its own DiT shard, and the one collective that sampling needs, the sum of
a row-parallel linear's partial outputs over its tensor-parallel group, is
plain tensor work (`all_reduce`). A grid may name one device several times,
as the JAX suite meshes 8 virtual CPU devices: the slots then share that
device, which shows correctness and host cost, not scaling.

TP layout (the classic two-collective pattern, `param_specs`):
  - attention to_q/to_k/to_v and feed-forward w1 (`ff.ff.0.0`): output dim
    sharded, so each slot holds heads / model heads and hidden / model
    units;
  - attention to_out and feed-forward w2 (`ff.ff.2`): input dim sharded,
    so each slot's output is a partial sum, reduced once, and the bias is
    added once, after the reduction;
  - everything else (embeddings, norms, AdaLN modulation, convs, the text
    embedding, proj_out) is replicated.
Sampling (`F5TTS.use_mesh`) pads the batch to a multiple of "data" with
copies of row 0 (`pad_batch`), splits it over the data rows
(`split_batch`), runs each row's DiT group (models/shard.py
`shard_model_for_inference`, by these specs) and vocoder on that row's
devices and gathers the rows back. This module knows tensors and names,
not the model's modules.

Not ported here: training over a mesh (DP, FSDP and SP in the trainers,
the FSDP upgrade of the specs, `grad_shardings`, `shard_train_step`), which
PyTorch runs as several processes over `torch.distributed`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

# the JAX package's _COL_SHARDED / _ROW_SHARDED by the port's module names
COL_SHARDED = ("attn.to_q", "attn.to_k", "attn.to_v", "ff.ff.0.0")  # output dim
ROW_SHARDED = ("attn.to_out.0", "ff.ff.2")  # input dim


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of torch devices: `devices` is a numpy object array with one
    axis per name of `axis_names`, ("data", "model") or ("data", "seq",
    "model")."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as JAX's `Mesh.shape`."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

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

    `seq` is accepted as in the JAX package, where it shards the training
    step's frames; sampling replicates the parameters over it and splits the
    batch over "data" only, so its slots hold replicas and do no work."""
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


def param_specs(module_or_state_dict: nn.Module | dict) -> dict[str, tuple]:
    """Tensor name -> spec: a tuple with one entry a dim, "model" for the
    dim sharded over the model axis and None elsewhere; all None for a
    replicated tensor. The JAX package's rules (`_COL_SHARDED`,
    `_ROW_SHARDED`, `_spec_for`) by the port's names, for float,
    weight-only quantized and W8A8 trees alike. The FSDP upgrade (`_with_fsdp`)
    belongs to training over a mesh and is not ported."""
    state = module_or_state_dict.state_dict() if isinstance(module_or_state_dict, nn.Module) \
        else module_or_state_dict
    return {name: _spec_for(name, t.ndim) for name, t in state.items()}


# ------------------------------------------------------------- the collective


def all_reduce(tensors: list[torch.Tensor], op: str = "sum") -> list[torch.Tensor]:
    """The one collective of mesh inference, in one process: each slot's
    tensor is copied to the first slot's device and combined there in slot
    order (a sum, or an elementwise max), and the result is copied back to
    every slot's device (the same tensor where a device repeats). No NCCL:
    the same code serves distinct cards and a card that repeats. Counted in
    `all_reduce.counts[op]`, once a reduction of the group."""
    combine = {"sum": torch.add, "max": torch.maximum}[op]
    dst = tensors[0].device
    out = tensors[0]
    for t in tensors[1:]:
        out = combine(out, t.to(dst, non_blocking=True))
    all_reduce.counts[op] += 1
    return [out.to(t.device, non_blocking=True) for t in tensors]


all_reduce.counts = {"sum": 0, "max": 0}


def lockstep(steps: list) -> list:
    """Run one forward a slot of a tensor-parallel group, each a generator
    (a module's `steps`), to the end in step: at each point where they
    yield (op, tensor), `all_reduce` combines the group's tensors and each
    generator is sent its own copy of the result. Every slot's work up to a
    reduction is issued before the next slot's; nothing reads back to the
    host. Returns each generator's value."""
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
        sent = all_reduce([t for _, t in asked], ops.pop())


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
