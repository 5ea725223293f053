"""Data-parallel, FSDP and sequence-parallel training over
``torch.distributed`` (counterpart of ``midgpt_tpu.parallel``: its
``replica``, ``fsdp`` and ``sequence`` axes, ring attention and
Ulysses)."""

from midgpt_tpu_torch.parallel.exchange import (
    GroupExchange,
    LoopbackExchange,
    sequence_chunks,
)
from midgpt_tpu_torch.parallel.mesh import (
    AXIS_NAMES,
    Mesh,
    create_mesh,
    single_device_mesh,
)
from midgpt_tpu_torch.parallel.ring import ring_attention
from midgpt_tpu_torch.parallel.sharding import (
    FlatShards,
    all_gather,
    all_reduce,
    all_to_all,
    batch_rows,
    local_batch_size,
    reduce_scatter,
    send_recv,
    seq_cols,
)
from midgpt_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "AXIS_NAMES",
    "Mesh",
    "create_mesh",
    "single_device_mesh",
    "FlatShards",
    "GroupExchange",
    "LoopbackExchange",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "batch_rows",
    "local_batch_size",
    "reduce_scatter",
    "ring_attention",
    "send_recv",
    "seq_cols",
    "sequence_chunks",
    "ulysses_attention",
]
