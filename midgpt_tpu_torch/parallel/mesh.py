"""The device mesh over ``torch.distributed`` (counterpart of
``midgpt_tpu.parallel.mesh``).

A :class:`Mesh` is this rank's place in the ``(pipeline, replica, fsdp,
sequence, tensor)`` grid of ``MeshConfig.sizes(world)``: ranks fill the
grid in row-major order, as JAX's ``np.asarray(devices).reshape(sizes)``
does, so rank ``r`` sits at ``np.unravel_index(r, sizes)``. It holds the
process groups of its ``fsdp`` axis (the ranks that differ only in their
fsdp coordinate: they shard the masters and moments between them), of
its ``replica`` axis, of its ``sequence`` axis (the ranks that hold the
same batch rows, each a ``1 / sequence`` slice of every row's columns:
ring attention's neighbours and Ulysses' all-to-alls), of its ``tensor``
axis (the ranks that hold the same rows and columns, each a ``1 /
tensor`` shard of the heads, MLP columns, experts and vocabulary:
Megatron's all-reduces, ``parallel.tensor``), of the gradient's
all-reduce (the ranks that share this rank's fsdp and tensor
coordinates, ``replica x sequence``: they hold the same shard of reduced
gradients, each summed over other rows or other columns) and, under a
``tensor`` axis, of ``fsdp x tensor`` (the ranks that together hold one
copy of the parameters: the gradient norm's sum), and a gloo group of
the world for what the host agrees on (the stop flag, the newest
checkpoint, loader states), so a flag never waits on the card's stream.

Under a ``pipeline`` axis (outermost, as in JAX's ``AXIS_NAMES``) the
ranks that differ only in their pipeline coordinate form the pipeline
group: GPipe stages, each holding ``n_layer / pipeline`` consecutive
blocks, that hand activations forward and gradients back to their
neighbours (``parallel.pipeline``). Every other group keeps its meaning
within one stage: ``fsdp``, ``tensor`` and the gradient's ``replica x
sequence`` hold one stage's parameters, and the data shards stay
``replica x fsdp`` (every stage sees the same rows). One copy of the
parameters is then spread over ``pipeline x fsdp x tensor`` (the
gradient norm's group, ``param_group``), and under tied embeddings the
first and last stage of each pipeline group share the embedding
(``embed_group``: its gradient is summed there).

``num_slices > 1`` (a hybrid mesh, data parallel across slices) needs
``replica % num_slices == 0`` and ``pipeline == 1``, as JAX requires.
With ``pipeline`` at 1 the row-major grid already puts ``replica``
outermost, so slice ``i`` is the block of ``world / num_slices``
contiguous ranks: JAX's ``hybrid_device_layout`` for devices without a
``slice_index``. Where ``torch.distributed.run`` reports several nodes,
each slice must be one node and the nodes as many as the slices
(:func:`check_slice_nodes`, the counterpart of ``group_by_slice``'s
``slice_index`` check). Without an initialised process group
:func:`create_mesh` gives the one-rank mesh of
:func:`single_device_mesh`, whose ``distributed`` is False, whatever
sizes the config names (one rank does every rank's work: the trainer
takes its single-card path, and under ``pipeline > 1`` runs every stage
on a loopback, ``parallel.pipeline.LoopbackPipe``).
"""

from __future__ import annotations

import dataclasses
import os
import typing as tp

import numpy as np
import torch
import torch.distributed as dist

from midgpt_tpu_torch.config import MeshConfig

AXIS_NAMES = ("pipeline", "replica", "fsdp", "sequence", "tensor")


def grid_coords(rank: int, sizes: tp.Sequence[int]) -> tp.Tuple[int, ...]:
    """Rank ``rank``'s coordinates in the row-major grid of ``sizes``."""
    return tuple(int(c) for c in np.unravel_index(rank, tuple(sizes)))


def axis_ranks(rank: int, sizes: tp.Sequence[int],
               axis: tp.Union[str, tp.Sequence[str]]) -> tp.List[int]:
    """The ranks that share every coordinate of ``rank`` but ``axis``'s
    (one axis, or several), in row-major order of those coordinates."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    coords = list(grid_coords(rank, sizes))
    idx = [AXIS_NAMES.index(a) for a in axes]
    out = []
    for sub in np.ndindex(*(sizes[a] for a in idx)):
        for a, c in zip(idx, sub):
            coords[a] = c
        out.append(int(np.ravel_multi_index(tuple(coords), tuple(sizes))))
    return out


def axis_groups(sizes: tp.Sequence[int],
                axis: tp.Union[str, tp.Sequence[str]]
                ) -> tp.List[tp.List[int]]:
    """Every group of ranks along ``axis`` (one axis, or several), each
    once, in the order of their smallest rank (the order every rank must
    create them in)."""
    world = int(np.prod(sizes))
    seen, out = set(), []
    for r in range(world):
        g = axis_ranks(r, sizes, axis)
        if g[0] not in seen:
            seen.add(g[0])
            out.append(g)
    return out


@dataclasses.dataclass
class Mesh:
    """One rank's view of the mesh: its rank, the world size, the axis
    sizes and its coordinates, and the process groups of its ``replica``,
    ``fsdp``, ``sequence``, ``tensor`` and ``pipeline`` axes, of the
    gradient's all-reduce, of the ranks that hold one copy of the
    parameters (``pipeline x fsdp x tensor``) and of a tied embedding's
    two stages (None on the one-rank mesh; the gradient's and the
    parameters' group are one of the others where an axis of theirs is
    one rank; the pipeline and embedding groups only under ``pipeline >
    1``, the latter with tied embeddings)."""

    rank: int
    world: int
    sizes: tp.Tuple[int, ...]
    distributed: bool = False
    fsdp_group: tp.Any = None
    replica_group: tp.Any = None
    host_group: tp.Any = None
    sequence_group: tp.Any = None
    grad_group: tp.Any = None
    tensor_group: tp.Any = None
    param_group: tp.Any = None
    pipeline_group: tp.Any = None
    embed_group: tp.Any = None

    @property
    def coords(self) -> tp.Tuple[int, ...]:
        return grid_coords(self.rank, self.sizes)

    def size(self, axis: str) -> int:
        return self.sizes[AXIS_NAMES.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[AXIS_NAMES.index(axis)]

    @property
    def fsdp(self) -> int:
        return self.size("fsdp")

    @property
    def replica(self) -> int:
        return self.size("replica")

    @property
    def seq_size(self) -> int:
        """Ranks each row's columns are split over (``sequence``)."""
        return self.size("sequence")

    @property
    def seq_index(self) -> int:
        """This rank's slice of every row: columns ``[seq_index * T / S,
        (seq_index + 1) * T / S)``."""
        return self.index("sequence")

    @property
    def seq_ranks(self) -> tp.List[int]:
        """The ranks of this rank's sequence axis, by sequence index."""
        return axis_ranks(self.rank, self.sizes, "sequence")

    @property
    def seq_next(self) -> int:
        """The rank a ring hop sends this rank's K/V chunk to (sequence
        index + 1, wrapping)."""
        return self.seq_ranks[(self.seq_index + 1) % self.seq_size]

    @property
    def seq_prev(self) -> int:
        """The rank a ring hop receives a K/V chunk from (sequence index
        - 1, wrapping)."""
        return self.seq_ranks[(self.seq_index - 1) % self.seq_size]

    @property
    def tp_size(self) -> int:
        """Ranks each parameter's tensor shards are spread over
        (``tensor``)."""
        return self.size("tensor")

    @property
    def tp_index(self) -> int:
        """This rank's tensor shard: heads, MLP columns, experts and
        vocabulary rows ``[tp_index / tp_size, (tp_index + 1) /
        tp_size)`` of each (``parallel.sharding.tensor_shard``)."""
        return self.index("tensor")

    @property
    def pp_size(self) -> int:
        """Pipeline stages (``pipeline``)."""
        return self.size("pipeline")

    @property
    def pp_index(self) -> int:
        """This rank's stage: blocks ``[pp_index * L / pp_size,
        (pp_index + 1) * L / pp_size)``."""
        return self.index("pipeline")

    @property
    def pp_ranks(self) -> tp.List[int]:
        """The ranks of this rank's pipeline group, by stage."""
        return axis_ranks(self.rank, self.sizes, "pipeline")

    @property
    def pp_prev(self) -> tp.Optional[int]:
        """The rank of the previous stage (None on the first)."""
        i = self.pp_index
        return self.pp_ranks[i - 1] if i > 0 else None

    @property
    def pp_next(self) -> tp.Optional[int]:
        """The rank of the next stage (None on the last)."""
        i = self.pp_index
        return self.pp_ranks[i + 1] if i + 1 < self.pp_size else None

    @property
    def grad_shards(self) -> int:
        """Ranks that hold this rank's shard of reduced gradients, each
        summed over other rows or columns (``replica * sequence``)."""
        return self.replica * self.seq_size

    @property
    def data_shards(self) -> int:
        """Ranks a global batch's rows are split over (``replica *
        fsdp``); sequence, tensor and pipeline peers hold the same
        rows."""
        return self.replica * self.fsdp

    @property
    def data_index(self) -> int:
        """This rank's place among the data shards: its batch rows are
        the ``data_index``-th ``1 / data_shards`` of the global batch
        (``replica`` outer, ``fsdp`` inner, as JAX's batch spec
        ``P(("replica", "fsdp"))`` lays them)."""
        return self.index("replica") * self.fsdp + self.index("fsdp")

    # -- what the hosts agree on (the gloo group; identity on one rank) --

    def host_max(self, value: int) -> int:
        """The largest of every rank's ``value``."""
        if not self.distributed:
            return value
        x = torch.tensor([value], dtype=torch.int64)
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.host_group)
        return int(x[0])

    def host_broadcast(self, obj: tp.Any) -> tp.Any:
        """Rank 0's ``obj`` on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        return box[0]

    def host_gather(self, obj: tp.Any) -> tp.List[tp.Any]:
        """Every rank's ``obj``, in rank order, on every rank."""
        if not self.distributed:
            return [obj]
        out: tp.List[tp.Any] = [None] * self.world
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def host_barrier(self) -> None:
        if self.distributed:
            dist.barrier(group=self.host_group)

    def key(self) -> tp.Tuple:
        """What a program keyed on the mesh takes from it (JAX's
        ``_program_key``: axis names, grid shape and this rank's
        place)."""
        return (AXIS_NAMES, tuple(self.sizes), self.rank,
                self.distributed)


def check_supported(cfg: MeshConfig, sizes: tp.Sequence[int]) -> None:
    """Raise ``ValueError`` (naming the field) for a mesh JAX refuses too:
    ``num_slices`` above 1 with a ``pipeline`` axis (a stage's hops would
    cross slices), or a ``replica`` axis that does not split over the
    slices (data parallel only across slices)."""
    pp, rep = sizes[AXIS_NAMES.index("pipeline")], sizes[
        AXIS_NAMES.index("replica")]
    if cfg.num_slices < 1:
        raise ValueError(f"num_slices={cfg.num_slices} must be >= 1")
    if cfg.num_slices > 1 and pp > 1:
        raise ValueError(
            f"pipeline={pp} with num_slices={cfg.num_slices}: the pipeline "
            f"axis must stay within a slice (JAX asserts pipeline == 1)")
    if rep % cfg.num_slices:
        raise ValueError(
            f"replica={rep} is not a multiple of num_slices="
            f"{cfg.num_slices} (data parallel only across slices)")


def slice_ranks(world: int, num_slices: int) -> tp.List[tp.List[int]]:
    """The ranks of each slice: ``num_slices`` contiguous blocks (with
    ``pipeline`` at 1 the row-major grid puts ``replica`` outermost, so a
    block holds ``replica / num_slices`` whole replicas)."""
    per = world // num_slices
    return [list(range(i * per, (i + 1) * per)) for i in range(num_slices)]


def check_slice_nodes(nodes: tp.Sequence[int], num_slices: int) -> None:
    """Each rank's node (``GROUP_RANK`` of ``torch.distributed.run``), by
    rank: where they name several nodes, every slice must be one node and
    the nodes as many as the slices (``ValueError`` otherwise); on one
    node the slices are simulated, split contiguously (JAX's
    ``group_by_slice``)."""
    if len(set(nodes)) <= 1:
        return
    if len(set(nodes)) != num_slices:
        raise ValueError(
            f"ranks run on {len(set(nodes))} nodes but num_slices="
            f"{num_slices}; set MeshConfig.num_slices to the node count")
    for i, ranks in enumerate(slice_ranks(len(nodes), num_slices)):
        held = {nodes[r] for r in ranks}
        if len(held) != 1:
            raise ValueError(
                f"slice {i} (ranks {ranks[0]}..{ranks[-1]}) spans nodes "
                f"{sorted(held)}: num_slices={num_slices} needs one node a "
                f"slice")


def create_mesh(cfg: MeshConfig) -> Mesh:
    """The mesh of ``cfg`` over the initialised default process group
    (every rank must call it, in the same order: it creates the axis
    groups), or the one-rank mesh when no group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        check_supported(cfg, (max(1, cfg.pipeline), cfg.replica if
                              cfg.replica > 0 else cfg.num_slices, 1, 1, 1))
        return single_device_mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = cfg.sizes(world)
    check_supported(cfg, sizes)
    groups = {}
    axes: tp.List[tp.Any] = ["fsdp", "replica", "sequence"]
    seq = sizes[AXIS_NAMES.index("sequence")]
    rep = sizes[AXIS_NAMES.index("replica")]
    tpn = sizes[AXIS_NAMES.index("tensor")]
    pp = sizes[AXIS_NAMES.index("pipeline")]
    if seq > 1 and rep > 1:  # else the gradient's group is one of those
        axes.append(("replica", "sequence"))
    # the tensor group even at tensor=1 (a one-rank group, whose
    # collectives are copies): the model computes through it either way
    axes.append("tensor")
    # the ranks that hold one copy of the parameters (the norm's sum)
    param = (("pipeline",) if pp > 1 else ()) + ("fsdp",) + (
        ("tensor",) if tpn > 1 else ())
    if len(param) > 1:
        axes.append(param)
    if pp > 1:
        axes.append("pipeline")
    for axis in axes:
        for ranks in axis_groups(sizes, axis):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    embed = None
    if pp > 2:
        # a tied embedding's two stages: the first and last of each
        # pipeline group (at pipeline=2, the pipeline group itself)
        for ranks in axis_groups(sizes, "pipeline"):
            g = dist.new_group([ranks[0], ranks[-1]])
            if rank in (ranks[0], ranks[-1]):
                embed = g
    elif pp == 2:
        embed = groups["pipeline"]
    grad = groups[("replica", "sequence") if seq > 1 and rep > 1
                  else "sequence" if seq > 1 else "replica"]
    host = (None if dist.get_backend() == "gloo"
            else dist.new_group(backend="gloo"))
    mesh = Mesh(rank=rank, world=world, sizes=tuple(sizes), distributed=True,
                fsdp_group=groups["fsdp"], replica_group=groups["replica"],
                host_group=host, sequence_group=groups["sequence"],
                grad_group=grad, tensor_group=groups["tensor"],
                param_group=groups[param if len(param) > 1 else "fsdp"],
                pipeline_group=groups.get("pipeline"), embed_group=embed)
    if cfg.num_slices > 1:
        check_slice_nodes(mesh.host_gather(
            int(os.environ.get("GROUP_RANK", "0"))), cfg.num_slices)
    return mesh


def single_device_mesh() -> Mesh:
    """The degenerate one-rank mesh (every axis 1, no process group)."""
    return Mesh(rank=0, world=1, sizes=(1, 1, 1, 1, 1))


@dataclasses.dataclass(frozen=True, eq=False)
class ServingMesh:
    """A serving engine's mesh (JAX's tensor-only serving mesh): the
    exchange of its ``tensor`` axis, the card (or CPU) its ranks run on
    here, and the virtual device ids that fingerprint it. A serving mesh
    holds no other axis: ``sequence`` and ``pipeline`` are kept only so
    that the engine can refuse them with JAX's messages.

    - The loopback (:func:`loopback_mesh`): every rank of the axis in one
      process on one device (``parallel.tensor.LoopbackTensorExchange``),
      the one-card path.
    - A group (:func:`group_mesh`): this process's rank of a distributed
      mesh's tensor group (``GroupTensorExchange``); ``host`` is that
      mesh, whose gloo group the engine agrees on host decisions over.
    """

    tensor: tp.Any  # parallel.tensor.TensorExchange
    device: torch.device
    device_ids: tp.Tuple[int, ...]
    sequence: int = 1
    pipeline: int = 1
    host: tp.Optional[Mesh] = None

    @property
    def tp(self) -> int:
        return self.tensor.size

    @property
    def shape(self) -> tp.Dict[str, int]:
        return {"sequence": self.sequence, "pipeline": self.pipeline,
                "tensor": self.tp}

    def key(self) -> tp.Tuple:
        """The programs' fingerprint of the mesh (JAX's ``_mesh_key``):
        its axis sizes, its device ids, and whether its sums cross
        processes."""
        return (tuple(self.shape.items()), str(self.device),
                self.device_ids, self.tensor.grouped)

    def host_broadcast(self, obj: tp.Any) -> tp.Any:
        """Rank 0's ``obj`` on every rank of the host mesh (``obj`` itself
        on the loopback)."""
        return obj if self.host is None else self.host.host_broadcast(obj)


def loopback_mesh(tp_size: int, device: tp.Union[str, torch.device],
                  first_id: int = 0) -> ServingMesh:
    """A serving mesh of ``tp_size`` virtual ranks in this process on
    ``device``, virtual device ids ``first_id ..`` (replica ``i`` of a
    one-card deployment takes ``i * tp_size``)."""
    from midgpt_tpu_torch.parallel.tensor import LoopbackTensorExchange

    return ServingMesh(LoopbackTensorExchange(tp_size), torch.device(device),
                       tuple(range(first_id, first_id + tp_size)))


def group_mesh(mesh: Mesh, device: tp.Union[str, torch.device]
               ) -> ServingMesh:
    """The serving mesh of a distributed mesh's tensor axis (this rank's
    place in it), on ``device``; its sequence and pipeline sizes are
    kept for the engine's checks."""
    from midgpt_tpu_torch.parallel.tensor import GroupTensorExchange

    return ServingMesh(GroupTensorExchange.from_mesh(mesh),
                       torch.device(device),
                       tuple(axis_ranks(mesh.rank, mesh.sizes, "tensor")),
                       mesh.seq_size, mesh.pp_size, host=mesh)
