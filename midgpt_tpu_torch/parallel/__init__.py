"""Data-parallel and FSDP training over ``torch.distributed``
(counterpart of ``midgpt_tpu.parallel``: its ``replica`` and ``fsdp``
axes)."""

from midgpt_tpu_torch.parallel.mesh import (
    AXIS_NAMES,
    Mesh,
    create_mesh,
    single_device_mesh,
)
from midgpt_tpu_torch.parallel.sharding import (
    FlatShards,
    all_gather,
    all_reduce,
    batch_rows,
    local_batch_size,
    reduce_scatter,
)

__all__ = [
    "AXIS_NAMES",
    "Mesh",
    "create_mesh",
    "single_device_mesh",
    "FlatShards",
    "all_gather",
    "all_reduce",
    "batch_rows",
    "local_batch_size",
    "reduce_scatter",
]
