"""Parallelism in the port.

Ported: mesh-parallel inference in one process (`mesh`): `create_mesh` over
a grid of devices (a device may repeat: a virtual grid on one card or on the
CPU), the JAX package's tensor-parallel rules by the port's names
(`param_specs`), the reduction of row-parallel outputs (`all_reduce`,
counted) and the data axis's batch pad, split and gather. models/shard.py
`shard_model_for_inference` builds one DiT shard a slot by these specs;
`F5TTS.use_mesh`, `generate(mesh=...)` and `--mesh-data`/`--mesh-model`
drive them. And the multi-process data contract: which slice of a global
batch this process loads (`distributed.process_local_batch_slice`).

Not ported yet: training over a mesh (data- and fully-sharded training and
sequence parallelism over `torch.distributed`, `grad_shardings`,
`initialize()`)."""

from f5_tts_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce,
    create_mesh,
    device_list,
    param_specs,
)

__all__ = ["Mesh", "all_reduce", "create_mesh", "device_list", "param_specs"]
