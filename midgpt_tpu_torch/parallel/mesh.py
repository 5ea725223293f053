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

The port runs the ``replica``, ``fsdp``, ``sequence`` and ``tensor``
axes. ``pipeline`` above 1 and ``num_slices > 1`` raise
``NotImplementedError`` (ROADMAP Q9). Without an initialised process
group :func:`create_mesh` gives the one-rank mesh of
:func:`single_device_mesh`, whose ``distributed`` is False, whatever
sizes the config names (one rank does every rank's work: the trainer
takes its single-card path unchanged).
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch
import torch.distributed as dist

from midgpt_tpu_torch.config import MeshConfig

AXIS_NAMES = ("pipeline", "replica", "fsdp", "sequence", "tensor")

_LATER = {
    "pipeline": "pipeline stages (ROADMAP Q9: pipeline training)",
}


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
    ``fsdp``, ``sequence`` and ``tensor`` axes, of the gradient's
    all-reduce and of ``fsdp x tensor`` (None on the one-rank mesh; the
    last two are one of the others where an axis of theirs is one rank)."""

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
    def grad_shards(self) -> int:
        """Ranks that hold this rank's shard of reduced gradients, each
        summed over other rows or columns (``replica * sequence``)."""
        return self.replica * self.seq_size

    @property
    def data_shards(self) -> int:
        """Ranks a global batch's rows are split over (``replica *
        fsdp``); sequence and tensor peers hold the same rows."""
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
    """Raise ``NotImplementedError`` for an axis the port cannot run."""
    for name in ("pipeline",):
        n = sizes[AXIS_NAMES.index(name)]
        if n > 1:
            raise NotImplementedError(
                f"mesh axis {name}={n}: {_LATER[name]} is not ported; the "
                f"port runs the replica, fsdp, sequence and tensor axes")
    if cfg.num_slices > 1:
        raise NotImplementedError(
            f"num_slices={cfg.num_slices}: hybrid multi-slice meshes are not "
            f"ported (ROADMAP Q9), for want of nodes to test them on")


def create_mesh(cfg: MeshConfig) -> Mesh:
    """The mesh of ``cfg`` over the initialised default process group
    (every rank must call it, in the same order: it creates the axis
    groups), or the one-rank mesh when no group is initialised."""
    if not (dist.is_available() and dist.is_initialized()):
        check_supported(cfg, (cfg.pipeline, 1, 1, 1, 1))
        return single_device_mesh()
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = cfg.sizes(world)
    check_supported(cfg, sizes)
    groups = {}
    axes: tp.List[tp.Any] = ["fsdp", "replica", "sequence"]
    seq = sizes[AXIS_NAMES.index("sequence")]
    rep = sizes[AXIS_NAMES.index("replica")]
    tpn = sizes[AXIS_NAMES.index("tensor")]
    if seq > 1 and rep > 1:  # else the gradient's group is one of those
        axes.append(("replica", "sequence"))
    # the tensor group even at tensor=1 (a one-rank group, whose
    # collectives are copies): the model computes through it either way
    axes.append("tensor")
    if tpn > 1:
        axes.append(("fsdp", "tensor"))
    for axis in axes:
        for ranks in axis_groups(sizes, axis):
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    grad = groups[("replica", "sequence") if seq > 1 and rep > 1
                  else "sequence" if seq > 1 else "replica"]
    host = (None if dist.get_backend() == "gloo"
            else dist.new_group(backend="gloo"))
    return Mesh(rank=rank, world=world, sizes=tuple(sizes), distributed=True,
                fsdp_group=groups["fsdp"], replica_group=groups["replica"],
                host_group=host, sequence_group=groups["sequence"],
                grad_group=grad, tensor_group=groups["tensor"],
                param_group=groups.get(("fsdp", "tensor"), groups["fsdp"]))


def single_device_mesh() -> Mesh:
    """The degenerate one-rank mesh (every axis 1, no process group)."""
    return Mesh(rank=0, world=1, sizes=(1, 1, 1, 1, 1))
