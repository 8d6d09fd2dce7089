"""Parallelism in the port.

`mesh`: one process drives a grid of devices (a device may repeat: a
virtual grid on one card or on the CPU). `create_mesh`, the JAX package's
tensor-parallel and FSDP rules by the port's names (`param_specs`,
`state_specs`), and the counted collectives (`all_reduce`, `all_gather`,
`reduce_scatter`). Sampling: models/shard.py `shard_model_for_inference`,
`F5TTS.use_mesh`, `generate(mesh=...)` and `--mesh-data`/`--mesh-model`.
Training: `shard_state` (over the groups of trainable shards that
models/shard.py `shard_train_state` builds) and `shard_train_step` (DP x
TP, FSDP, gradient accumulation), behind the trainers' `mesh=` and `fsdp=`
and the examples' `--mesh-data`/`--mesh-model`/`--fsdp`.

`distributed`: several processes. `initialize()` starts the process group;
each process loads its slice of the global batch
(`process_local_batch_slice`) and the sharded step sums the gradients
across the processes (`sum_across_processes`). A trainer without a mesh
trains over a grid of one slot when several processes run.

Not ported yet: sequence parallelism in training (the "seq" axis, ROADMAP
item 4b-ii), and FSDP across processes (item 4b-iii)."""

from f5_tts_tpu_torch.parallel.distributed import initialize, sum_across_processes
from f5_tts_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    all_reduce,
    create_mesh,
    device_list,
    param_specs,
    reduce_scatter,
    shard_state,
    shard_train_step,
    state_specs,
)

__all__ = ["Mesh", "all_gather", "all_reduce", "create_mesh", "device_list", "initialize", "param_specs",
           "reduce_scatter", "shard_state", "shard_train_step", "state_specs", "sum_across_processes"]
