"""Several processes (the port of the JAX package's `parallel/distributed.py`):
`initialize()` starts the process group, and the data loader and the
sharded train step read it.

`process_count()` and `process_index()` read `torch.distributed` when a
process group is initialized, and are 1 and 0 otherwise. Each process
drives a grid over its own devices (parallel/mesh.py), loads its slice of
the global batch (`process_local_batch_slice`, `make_training_pipeline(
shard_by_process=True)`), and the data axis spans the processes: the
sharded step draws the global batch's randomness in every process, pads the
processes' batches to one shape (`pad_across_processes`), and sums the
loss's denominator, the loss and every reduced gradient across them
(`sum_across_processes`). Under FSDP a weight matrix is sharded over the
global data rows (rank x local rows): its pieces are gathered across the
processes (`all_gather_across_processes`) and its gradient is
reduce-scattered across them (`reduce_scatter_across_processes`). Both
run on the tensors' own device: gloo takes CUDA tensors for them (it
stages through the host itself), as NCCL does.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
import torch.nn.functional as F


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Start the process group. `coordinator_address` is rank 0's
    "host:port"; without it torch reads MASTER_ADDR, MASTER_PORT, RANK and
    WORLD_SIZE (`env://`). `num_processes` defaults to WORLD_SIZE. With no
    address and one process (or none named) it is a no-op. The backend
    defaults to NCCL where there is a card, else gloo."""
    env_np = os.environ.get("WORLD_SIZE")
    if num_processes is None and env_np is not None:
        num_processes = int(env_np)
    if coordinator_address is None and num_processes in (None, 1):
        return
    dist.init_process_group(
        backend=backend or ("nccl" if torch.cuda.is_available() else "gloo"),
        init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch that this process loads."""
    per = global_batch // process_count()
    start = process_index() * per
    return slice(start, start + per)


def sum_across_processes(t: torch.Tensor) -> torch.Tensor:
    """t summed over the processes (a copy; t itself with one process)."""
    if process_count() == 1:
        return t
    t = t.clone()
    dist.all_reduce(t)
    return t


def all_gather_across_processes(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every process's `t` (one shape in all) joined along `dim` in rank
    order (t itself with one process). Counted in
    `all_gather_across_processes.count`, once a cross-process gather."""
    world = process_count()
    if world == 1:
        return t
    src = t.movedim(dim, 0).contiguous()  # the collective joins along dim 0
    out = src.new_empty((world * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src)
    all_gather_across_processes.count += 1
    return out.movedim(0, dim).contiguous()


all_gather_across_processes.count = 0


def reduce_scatter_across_processes(t: torch.Tensor, dim: int) -> torch.Tensor:
    """`t` summed over the processes and cut into one piece a process along
    `dim` (process_count() divides it): this process's piece, in rank
    order (t itself with one process). Counted in
    `reduce_scatter_across_processes.count`, once a cross-process
    reduce-scatter."""
    world = process_count()
    if world == 1:
        return t
    if t.shape[dim] % world:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {world} processes")
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // world, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src)
    reduce_scatter_across_processes.count += 1
    return out.movedim(0, dim).contiguous()


reduce_scatter_across_processes.count = 0


def pad_across_processes(inp: torch.Tensor, text: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """This process's batch padded to the longest frames and text of every
    process's (mel frames with zeros, text ids with -1), as one process
    collating the global batch would pad it. Unchanged with one process."""
    if process_count() == 1:
        return inp, text
    sizes = torch.tensor([inp.shape[1], text.shape[1]], device=inp.device if dist.get_backend() == "nccl" else "cpu")
    dist.all_reduce(sizes, op=dist.ReduceOp.MAX)
    n, nt = sizes.tolist()
    if n > inp.shape[1]:
        inp = F.pad(inp, (0, 0) * (inp.ndim - 2) + (0, n - inp.shape[1]))
    if nt > text.shape[1]:
        text = F.pad(text, (0, nt - text.shape[1]), value=-1)
    return inp, text
