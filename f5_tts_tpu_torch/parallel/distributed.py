"""The process group as the data loader sees it (the port of the JAX
package's `parallel/distributed.py` `process_local_batch_slice`).

`process_count()` and `process_index()` read `torch.distributed` when a
process group is initialized, and are 1 and 0 otherwise. Initializing the
group (`torch.distributed.init_process_group`, given its address, world size
and rank) is the caller's.
"""

from __future__ import annotations


def process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_local_batch_slice(global_batch: int) -> slice:
    """The slice of a global batch that this process loads."""
    per = global_batch // process_count()
    start = process_index() * per
    return slice(start, start + per)
