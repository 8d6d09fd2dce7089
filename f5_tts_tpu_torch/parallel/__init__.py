"""Parallelism in the port.

`mesh`: one process drives a grid of devices (a device may repeat: a
virtual grid on one card or on the CPU). `create_mesh`, the JAX package's
tensor-parallel and FSDP rules by the port's names (`param_specs`,
`state_specs`), and the counted collectives (`all_reduce`, `all_gather`,
`reduce_scatter`). Sampling: models/shard.py `shard_model_for_inference`,
`F5TTS.use_mesh`, `generate(mesh=...)` and `--mesh-data`/`--mesh-model`.
Training: `shard_state` (over the groups of trainable shards that
models/shard.py `shard_train_state` builds) and `shard_train_step` (DP x
TP, FSDP, sequence parallelism over "seq", gradient accumulation), behind
the trainers' `mesh=` and `fsdp=` and the examples'
`--mesh-data`/`--mesh-model`/`--fsdp`.

`distributed`: several processes. `initialize()` starts the process group;
each process loads its slice of the global batch
(`process_local_batch_slice`) and the sharded step sums the gradients
across the processes (`sum_across_processes`); under FSDP the data axis
that shards the weight matrices is the global one (rank x local rows), and
the step gathers the pieces and reduce-scatters the gradients across the
processes (`distributed.all_gather_across_processes`,
`distributed.reduce_scatter_across_processes`). A trainer without a mesh
trains over a grid of one slot when several processes run.

`pipeline`: GPipe pipeline parallelism over the DiT's depth, on a
("data", "stage") grid (`create_pipeline_mesh`; the other users of a mesh
refuse a "stage" axis): `shard_params_for_pipeline` places each stage's
blocks on its device, `dit_forward_pipelined` streams microbatches through
the stages, and autograd through it is pipeline-parallel backprop.

The one name of the JAX package's `parallel` that the port leaves out on
purpose is `shard_params`, since the port holds no parameter tree to place
(a model's shards are modules, one a slot, from `shard_model_for_inference`
and models/shard.py `shard_module`, and a training state's pieces come from
`shard_state`). `shard_model_for_inference` and the pipeline's names load
their modules on first use, so that importing this package loads no model
code."""

import importlib

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


_LAZY = {"shard_model_for_inference": "f5_tts_tpu_torch.models.shard",
         "create_pipeline_mesh": "f5_tts_tpu_torch.parallel.pipeline",
         "dit_forward_pipelined": "f5_tts_tpu_torch.parallel.pipeline",
         "shard_params_for_pipeline": "f5_tts_tpu_torch.parallel.pipeline"}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Mesh", "all_gather", "all_reduce", "create_mesh", "create_pipeline_mesh", "device_list",
           "dit_forward_pipelined", "initialize", "param_specs", "reduce_scatter", "shard_model_for_inference",
           "shard_params_for_pipeline", "shard_state", "shard_train_step", "state_specs", "sum_across_processes"]
