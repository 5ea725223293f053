"""Data-parallel, FSDP, sequence-parallel, tensor-parallel and pipelined
training over ``torch.distributed`` (counterpart of
``midgpt_tpu.parallel``: its ``replica``, ``fsdp``, ``sequence``,
``tensor`` and ``pipeline`` axes, ring attention and Ulysses, the
Megatron operators GSPMD inserts for ``tensor`` and the GPipe
schedule), and the tensor-only serving mesh (:class:`ServingMesh`)."""

from midgpt_tpu_torch.parallel.exchange import (
    GroupExchange,
    LoopbackExchange,
    sequence_chunks,
)
from midgpt_tpu_torch.parallel.mesh import (
    AXIS_NAMES,
    Mesh,
    ServingMesh,
    create_mesh,
    group_mesh,
    loopback_mesh,
    single_device_mesh,
)
from midgpt_tpu_torch.parallel.pipeline import (
    GroupPipe,
    LoopbackPipe,
    microbatches,
    pipeline_run,
    stage_layers,
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
    tensor_shard,
    tensor_unshard,
)
from midgpt_tpu_torch.parallel.tensor import (
    GroupTensorExchange,
    LoopbackTensorExchange,
    copy_to_tensor,
    gather_vocab,
    greedy_argmax,
    reduce_from_tensor,
)
from midgpt_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "AXIS_NAMES",
    "Mesh",
    "ServingMesh",
    "create_mesh",
    "group_mesh",
    "loopback_mesh",
    "single_device_mesh",
    "FlatShards",
    "GroupExchange",
    "GroupPipe",
    "GroupTensorExchange",
    "LoopbackExchange",
    "LoopbackPipe",
    "LoopbackTensorExchange",
    "all_gather",
    "all_reduce",
    "all_to_all",
    "batch_rows",
    "copy_to_tensor",
    "gather_vocab",
    "greedy_argmax",
    "local_batch_size",
    "microbatches",
    "pipeline_run",
    "reduce_from_tensor",
    "reduce_scatter",
    "ring_attention",
    "send_recv",
    "seq_cols",
    "sequence_chunks",
    "stage_layers",
    "tensor_shard",
    "tensor_unshard",
    "ulysses_attention",
]
