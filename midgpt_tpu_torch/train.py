"""Training on one card (counterpart of ``midgpt_tpu.train``).

The optimizer is the JAX package's optax chain written out, not
``torch.optim.AdamW``: clip by global norm -> Adam (eps 1e-8, bias
correction with count + 1) -> ``+ (wd / lr_peak) * p`` on every
parameter -> ``x schedule(step)`` -> ``x -1``. AdamW's decay is
``lr_t * wd``; this chain's is ``lr_t * wd / lr_peak``, added after the
Adam normalisation.

The step keeps the JAX step's numerics:

- the forward runs on a compute-dtype copy of the f32 master parameters
  (``shadow``, refreshed from the masters before each step and eval);
- gradients are taken with respect to that copy and accumulate in its
  dtype across microbatches (``.grad +=`` in bf16, as JAX adds bf16
  gradient trees);
- the sum is divided by the microbatch count G and only then promoted to
  f32 for the update.

Dropout (``cfg.model.dropout > 0``) draws its masks from integer keys:
step ``s`` takes ``fold_in(cfg.seed, s)``, split into one key per
microbatch, as the JAX trainer folds the step into its PRNG key and
splits it G ways, and each microbatch's key into its sites' keys
(``layers.dropout_key_table``). The masks depend on (seed, step,
microbatch, layer, site) alone, so a resumed run draws what an
uninterrupted one would. Evals are deterministic.

Every train dispatch runs a program (``train_programs``): the step's body
(:func:`step_body`, :func:`accumulate_grads` then :func:`apply_update`)
over static buffers, on the card one CUDA graph replay a step. What
changes from step to step is read from device memory: the batch, the lr,
Adam's bias corrections and the dropout keys, written for a whole window
in one host-to-device copy (:func:`step_scalars`, :func:`step_keys`).
``steps_per_dispatch = K > 1`` runs K steps a dispatch (the windows of
``config.window_plan``, K replays with no host read between them, the
loss, grad norm and lr of each step stacked for one read), as the JAX
trainer's ``make_train_window`` does; K=1 runs a program of its own.

An MoE model (``mlp="moe"``) adds ``moe_aux_weight`` times its
load-balance aux loss (summed over the layers) to the optimized loss
only; evals report pure cross-entropy. At every eval the router's
telemetry, ``moe/aux`` and ``moe/dropped_frac`` from ``GPT.moe_stats``
on one validation microbatch, is logged beside the losses, as the JAX
trainer logs it.

Beside the step, the loop carries the JAX trainer's machinery: batches
(or K-step windows of them) from a prefetch thread over the native
gather, asynchronous checkpoints, the save on SIGTERM, the out-of-memory
ladder of ``remat="auto"`` over a program's warm-up and capture
(resolved on the card from the port's own memory estimate,
:func:`card_peak_bytes`), lifecycle telemetry (``train_telemetry``), the
always-on anomaly monitors and ``debug``.

Under an initialised process group the trainer runs the ``replica``,
``fsdp``, ``sequence``, ``tensor`` and ``pipeline`` axes of ``cfg.mesh``
(``parallel``): each
data shard (``replica x fsdp``) takes its contiguous shard of the token
files and its ``batch_size // (G * data shards)`` rows a microbatch, and
each of a shard's ``sequence`` ranks, which read the same rows, its
``T / S`` columns of them (JAX's batch spec ``P(None, ("replica",
"fsdp"), "sequence")``); attention then runs ring or Ulysses over the
sequence group (``GPT.set_batch_offset``) and the loss is each rank's
mean over its own tokens. A rank holds the f32 masters and both Adam
moments as its ``1 / fsdp`` slice (:class:`ShardedState`), gathers the
compute-dtype shadow before each step, reduces the promoted gradients
once after the local accumulation (reduce-scatter over ``fsdp``, then
all-reduce over ``replica x sequence``, the ranks that share its fsdp
coordinate: parameters are replicated over ``sequence``), and runs the
update on its slice; the step's collectives are part of its captured
graph. The ring's P2P hops and Ulysses' all-to-alls are meant to be
captured the same way, but no run on two cards has tried that yet. Rank 0
alone logs and writes checkpoints; every rank stops at the same window.
Without a process group the mesh is the one-rank mesh and nothing of
this runs.

Under a ``tensor`` axis (Megatron tensor parallelism, and expert
parallelism over the same axis, as JAX runs them) each rank holds its
tensor shard of the model (``GPT.init``'s ``tensor``: column-parallel
``wqkv``, ``w_up`` and ``w_gate``, row-parallel ``wo`` and ``w_down``,
``E / tensor`` experts, a vocab-parallel embedding, head and loss; the
QK-norms and the router replicated), its tensor peers read the same rows
and columns, and the model's all-reduces over the tensor group
(``parallel.tensor``) are meant to be captured in the step's graph
like the rest. A mesh at ``tensor=1`` runs the same code through a
one-rank tensor group, whose collectives are copies: so one card
replays them captured, bit for bit with the single-card step, but no
run on two cards has tried ``tensor > 1`` yet. The masters and moments
are the ``1 / fsdp`` slice of the rank's tensor shard; checkpoints hold
full tensors in JAX's layout, gathered a parameter at a time into host
memory (:meth:`ShardedState.items`).

Under a ``pipeline`` axis (GPipe, JAX's ``gpt_pipeline_hidden``) each
rank holds its stage of the model (``GPT.init``'s ``stage``: ``L / S``
blocks under their global names, ``wte`` on the first stage, ``lm_head``
on the last, a tied embedding on both with its gradient summed over the
two) and each microbatch of its rows runs through the stages as ``M``
microbatches (``MeshConfig.pp_microbatches``, or JAX's auto rule over
the rank's rows), activations crossing in ``pp_boundary_dtype``:
``parallel.pipeline`` writes the schedule and its backward by hand over
counted P2P hand-offs, each stage recomputing its blocks in the backward
(whole-stage remat; ``model.remat`` does not apply inside a stage). The
last stage computes the loss; the gradients equal the single-card
step's at ``g_accum_iters = G M``. It composes with ``replica``,
``fsdp`` and ``tensor`` (each group within one stage); one process
without a process group runs a config's ``pipeline > 1`` on a loopback
of every stage. ``num_slices > 1`` is the hybrid mesh: data parallel
across slices of contiguous ranks (``parallel.mesh``).

Left out against the JAX trainer: an MoE model under ``sequence > 1``,
Ulysses under ``tensor > 1`` (ROADMAP Q9), Orbax restore and wandb.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import math
import os
import signal
import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.checkpoint import Checkpointer, config_fingerprint
from midgpt_tpu_torch.config import (
    ExperimentConfig,
    ModelConfig,
    resolve_dispatch_intervals,
    to_dict,
    window_plan,
)
from midgpt_tpu_torch.data import (
    Loader,
    PrefetchLoader,
    device_transform,
    load_shard,
)
from midgpt_tpu_torch.models.gpt import (
    GPT,
    check_moe_sequence,
    check_pipeline,
    check_tensor,
    count_params,
    mlp_hidden_dim,
    pipeline_loss,
    sequence_impl,
)
from midgpt_tpu_torch.models.layers import (
    dropout_key_table,
    fold_in,
    site_row,
)
from midgpt_tpu_torch.ops import launches as launch_counts
from midgpt_tpu_torch.ops.fused_attn import supported as fused_supported
from midgpt_tpu_torch.ops.loss import chunked_softmax_xent, dense_softmax_xent
from midgpt_tpu_torch.parallel import sharding
from midgpt_tpu_torch.parallel.exchange import GroupExchange
from midgpt_tpu_torch.parallel.mesh import Mesh, create_mesh
from midgpt_tpu_torch.parallel.pipeline import (
    GroupPipe,
    LoopbackPipe,
    microbatches,
)
from midgpt_tpu_torch.parallel.tensor import GroupTensorExchange
from midgpt_tpu_torch.telemetry import (
    start_profiler,
    stop_profiler,
    write_json,
)
from midgpt_tpu_torch.train_programs import StepProgram, get_train_window
from midgpt_tpu_torch.train_telemetry import (
    AnomalyMonitors,
    TrainTelemetry,
    chrome_trace_train,
)
from midgpt_tpu_torch.utils.metrics import (
    MetricLogger,
    mfu,
    moe_router_metrics,
)
from midgpt_tpu_torch.utils.platform import local_rank, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# what the JAX package assumes when a backend reports no memory size
_DEFAULT_HBM_BYTES = int(16e9)


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


def make_lr_schedule(cfg: ExperimentConfig) -> tp.Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, decay,
    min_lr)`` in f32: linear from 0 (the first lr is 0) to the peak over
    ``warmup_steps``, then cosine to ``min_lr`` over ``lr_decay_steps -
    warmup_steps`` (``decay_steps`` counts the warmup)."""
    f32 = np.float32
    peak, end = f32(cfg.learning_rate), f32(cfg.min_lr)
    warm = cfg.warmup_steps
    decay = cfg.lr_decay_steps - warm
    if decay <= 0:
        raise ValueError("lr_decay_steps must exceed warmup_steps")
    alpha = f32(0.0) if peak == 0 else f32(cfg.min_lr / cfg.learning_rate)

    def schedule(step: int) -> float:
        if step < warm:
            frac = f32(1) - f32(min(max(step, 0), warm)) / f32(warm)
            return float((f32(0) - peak) * frac + peak)
        count = f32(min(step - warm, decay))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count / f32(decay)))
        return float(peak * ((f32(1) - alpha) * cosine + alpha))

    return schedule


@dataclasses.dataclass
class TrainState:
    """f32 master parameters, Adam moments and the optimizer step (the
    Adam count and the schedule's step alike)."""

    model: GPT
    mu: tp.List[torch.Tensor]
    nu: tp.List[torch.Tensor]
    step: int = 0

    def items(self) -> tp.Dict[str, tp.Any]:
        names = [n for n, _ in self.model.named_parameters()]
        return {"params": self.model.state_dict(),
                "mu": dict(zip(names, self.mu)),
                "nu": dict(zip(names, self.nu)),
                "step": self.step}

    def load_items(self, items: tp.Mapping[str, tp.Any]) -> None:
        self.model.load_state_dict(items["params"])
        names = [n for n, _ in self.model.named_parameters()]
        with torch.no_grad():
            for dst, key in ((self.mu, "mu"), (self.nu, "nu")):
                for d, n in zip(dst, names):
                    d.copy_(items[key][n])
        self.step = int(items["step"])

    # the step's hooks (ShardedState's are the mesh's)

    def masters(self) -> tp.List[torch.Tensor]:
        return list(self.model.parameters())

    def refresh(self, shadow: GPT) -> None:
        refresh_shadow(shadow, self.model)

    def promote_grads(self, comp: tp.Sequence[torch.Tensor],
                      g: int) -> tp.List[torch.Tensor]:
        """The shadow's accumulated gradients over G, in the masters'
        dtype."""
        return [(p.grad / g).to(self.mu[0].dtype) for p in comp]

    def grad_norm(self, grads: tp.Sequence[torch.Tensor]) -> torch.Tensor:
        return global_norm(grads)

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss


class ShardedState:
    """The train state under a mesh (ZeRO-3): this rank's ``1 / fsdp``
    slice of the flat f32 masters and of both Adam moments
    (``sharding.FlatShards``), the step, and the full compute-dtype
    shadow, whose parameters are views of one flat buffer the step
    gathers into. ``model`` keeps the parameters' names and the config,
    on the meta device. The step's hooks:

    - :meth:`refresh`: the slice cast to the compute dtype, then
      all-gathered over ``fsdp`` into the shadow;
    - :meth:`promote_grads`: each accumulated gradient over G, promoted
      into its place in a flat f32 buffer (the QK-norms' partial
      gradients summed over ``tensor`` first),
      reduce-scattered over ``fsdp``, all-reduced over ``replica x
      sequence`` and divided by the data ranks ``replica x fsdp x
      sequence`` (the mean over their equal shares of the tokens): this
      rank's slice of the global batch's gradient, as pieces aligned
      with :meth:`masters`;
    - :meth:`grad_norm`: the pieces' sums of squares in parameter order,
      all-reduced over ``fsdp`` (under a tensor axis over ``fsdp x
      tensor``, the replicated parameters' pieces weighted ``1 /
      tensor`` so that each counts once);
    - :meth:`mean_loss`: the loss all-reduced over the world, over the
      world.

    ``model`` is this rank's tensor shard (``GPT.shard_tensor_``, at
    ``tensor=1`` the whole model computing through a one-rank tensor
    group) of its pipeline stage (``GPT.keep_stage_``): the flat layout
    covers its stage's tensor-local parameters, and :meth:`items` /
    :meth:`load_items` gather and cut over ``tensor`` and ``pipeline``
    too, to full tensors in JAX's layout. Under a ``pipeline`` axis the
    gradient norm sums over ``pipeline x fsdp x tensor``, a tied
    embedding (held by the first and last stage) has its gradient summed
    over the two and counts once in the norm, and the loss (the last
    stage's) is averaged over the world less the stages.

    On a one-rank mesh every piece is a whole parameter and every
    collective is a copy, so the step equals the single-card step bit
    for bit."""

    def __init__(self, model: GPT, mesh: Mesh, compute_dtype: torch.dtype):
        if not mesh.distributed:
            raise ValueError("a ShardedState needs a distributed mesh")
        self.mesh = mesh
        self.names = [n for n, _ in model.named_parameters()]
        self.cfg = model.config
        tpn, pp = mesh.tp_size, mesh.pp_size
        if model.tensor is None or model.tensor.size != tpn:
            raise ValueError(f"a tensor={tpn} mesh needs its tensor shard "
                             f"of the model (GPT.shard_tensor_)")
        if pp > 1 and model.stage != (mesh.pp_index, pp):
            raise ValueError(f"a pipeline={pp} mesh needs stage "
                             f"{mesh.pp_index}'s model (GPT.keep_stage_)")
        # a tied embedding on the first and last stage: its gradient is
        # summed over the two (the embedding group)
        self._tied = (self.names.index("wte.weight") if pp > 1
                      and self.cfg.tie_embeddings
                      and "wte.weight" in self.names else None)
        # how many ranks of one copy of the parameters hold each one (a
        # replicated parameter is on every tensor rank, a tied embedding
        # on two stages): its square sum is divided by that in the norm
        self._copies = [
            (tpn if tpn > 1 and sharding.tensor_dim(n) is None else 1)
            * (2 if i == self._tied else 1)
            for i, n in enumerate(self.names)]
        # those whose gradients are partial sums over tensor (summed at
        # tensor=1 too, a one-rank copy)
        self._partial = [i for i, n in enumerate(self.names)
                         if sharding.tensor_partial(n)]
        params = [p.detach() for p in model.parameters()]
        device = params[0].device
        self.param_dtype = params[0].dtype
        self.layout = sharding.FlatShards([p.shape for p in params],
                                          mesh.fsdp, mesh.index("fsdp"))
        lay = self.layout
        self.master_flat = lay.shard_from(params, self.param_dtype, device)
        self.mu_flat = torch.zeros_like(self.master_flat)
        self.nu_flat = torch.zeros_like(self.master_flat)
        self._masters = lay.piece_views(self.master_flat)
        self.mu = lay.piece_views(self.mu_flat)
        self.nu = lay.piece_views(self.nu_flat)
        self.step = 0
        # the shadow: a full compute-dtype copy whose parameters are views
        # of one flat buffer, and the slice each rank contributes to it
        self.shadow = make_shadow(model, compute_dtype)
        self._shadow_flat = torch.zeros(lay.padded, dtype=compute_dtype,
                                        device=device)
        with torch.no_grad():
            for p, v in zip(self.shadow.parameters(),
                            lay.full_views(self._shadow_flat)):
                v.copy_(p)
                p.data = v
        self._shadow_shard = torch.zeros(lay.shard_len, dtype=compute_dtype,
                                         device=device)
        # the full f32 model goes before the gradients' buffers come
        del params
        self.model = model.to("meta")
        # the promoted gradients (full, flat) and this rank's reduced slice
        self._grad_flat = torch.zeros(lay.padded, dtype=self.param_dtype,
                                      device=device)
        self._grad_views = lay.full_views(self._grad_flat)
        self._grad_shard = torch.zeros(lay.shard_len,
                                       dtype=self.param_dtype, device=device)
        self._grad_pieces = lay.piece_views(self._grad_shard)
        self._everyone = self._all_parameters()

    def _all_parameters(self
                        ) -> tp.List[tp.Tuple[str, int, tp.Tuple[int, ...]]]:
        """``(name, stage, full shape)`` of every parameter of the whole
        model, in a full ``GPT``'s order (the embedding, the blocks by
        index, the head), each with the first stage holding it."""
        tpn = self.mesh.tp_size
        full = []
        for n, shape in zip(self.names, self.layout.shapes):
            shape = list(shape)
            dim = sharding.tensor_dim(n)
            if dim is not None:
                shape[dim] *= tpn
            full.append((n, tuple(shape)))
        stages = (self.mesh.host_gather((self.mesh.pp_index, full))
                  if self.mesh.pp_size > 1 else [(0, full)])
        seen, out = set(), []
        for stage, held in sorted(stages, key=lambda x: x[0]):
            for n, shape in held:
                if n not in seen:
                    seen.add(n)
                    out.append((n, stage, shape))

        def order(item):
            parts = item[0].split(".")
            if parts[0] == "wte":
                return (0, 0)
            return (1, int(parts[1])) if parts[0] == "blocks" else (2, 0)

        return sorted(out, key=order)

    def masters(self) -> tp.List[torch.Tensor]:
        return self._masters

    @torch.no_grad()
    def refresh(self, shadow: GPT) -> None:
        if shadow is not self.shadow:
            raise ValueError("a ShardedState refreshes its own shadow")
        self._shadow_shard.copy_(self.master_flat)
        sharding.all_gather(self._shadow_flat, self._shadow_shard,
                            self.mesh.fsdp_group)

    @torch.no_grad()
    def promote_grads(self, comp: tp.Sequence[torch.Tensor],
                      g: int) -> tp.List[torch.Tensor]:
        for v, p in zip(self._grad_views, comp):
            v.copy_(p.grad / g)
        if self._partial:
            # the QK-norms saw this rank's heads only: one all-reduce of
            # their gradients over tensor
            views = [self._grad_views[i] for i in self._partial]
            both = torch.cat([v.reshape(-1) for v in views])
            sharding.all_reduce(both, self.mesh.tensor_group)
            for v, part in zip(views, both.split([v.numel()
                                                  for v in views])):
                v.copy_(part.view_as(v))
        if self._tied is not None:
            # the tied embedding: the first stage's lookups and the last
            # stage's head, summed
            sharding.all_reduce(self._grad_views[self._tied],
                                self.mesh.embed_group)
        sharding.reduce_scatter(self._grad_shard, self._grad_flat,
                                self.mesh.fsdp_group)
        if self.mesh.grad_shards > 1:
            sharding.all_reduce(self._grad_shard, self.mesh.grad_group)
        data_ranks = self.mesh.world // (self.mesh.tp_size
                                         * self.mesh.pp_size)
        if data_ranks > 1:
            self._grad_shard.div_(data_ranks)
        return self._grad_pieces

    def grad_norm(self, grads: tp.Sequence[torch.Tensor]) -> torch.Tensor:
        if not grads:  # a slice of padding alone
            sq = torch.zeros((), dtype=self.param_dtype,
                             device=self.master_flat.device)
        else:
            # a parameter held by several ranks of one copy counts once
            sq = torch.stack([
                torch.sum(t * t) / self._copies[i] if self._copies[i] > 1
                else torch.sum(t * t)
                for (i, _, _), t in zip(self.layout.pieces, grads)]).sum()
        sharding.all_reduce(sq, self.mesh.param_group)
        return torch.sqrt(sq)

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        # the last stage's loss, once a pipeline group
        sharding.all_reduce(loss)
        n = self.mesh.world // self.mesh.pp_size
        return loss / n if n > 1 else loss

    @torch.no_grad()
    def items(self, keep: bool = True
              ) -> tp.Optional[tp.Dict[str, tp.Any]]:
        """Full tensors by name in host memory, the single-card
        ``TrainState.items`` layout (JAX's full layout): a collective,
        which every rank calls; with ``keep`` False a rank takes part and
        returns None (under a pipeline axis only a first-stage rank can
        keep: the other stages' parameters come to it).

        One item at a time is all-gathered over ``fsdp`` into the promoted
        gradients' buffer (free between steps), then each parameter on its
        own over ``tensor``, put back together, handed from its stage to
        the first over ``pipeline`` and copied to the host (pinned memory
        from a card, the copies queued and waited for once), so the save's
        card peak is the state's plus two copies of the largest full
        parameter (``card_peak_bytes``' ``save``)."""
        if keep and self.mesh.pp_index != 0:
            raise ValueError("only a first-stage rank keeps a save")
        out = {key: self._gather(flat, keep)
               for key, flat in (("params", self.master_flat),
                                 ("mu", self.mu_flat), ("nu", self.nu_flat))}
        if not keep:
            return None
        if self.master_flat.is_cuda:
            torch.cuda.synchronize(self.master_flat.device)
        return {**out, "step": self.step}

    def _gather(self, shard: torch.Tensor,
                keep: bool) -> tp.Dict[str, torch.Tensor]:
        mesh = self.mesh
        full, tpn = self._grad_flat, mesh.tp_size
        sharding.all_gather(full, shard, mesh.fsdp_group)
        local = dict(zip(self.names, self.layout.full_views(full)))
        out = {}
        for n, stage, shape in self._everyone:
            t = None
            if mesh.pp_index == stage:
                v = local[n]
                every = torch.empty((tpn, *v.shape), dtype=v.dtype,
                                    device=v.device)
                sharding.all_gather(every.view(-1), v.reshape(-1),
                                    mesh.tensor_group)
                t = sharding.tensor_unshard(n, list(every.unbind(0)),
                                            self.cfg)
            if stage != 0:  # from its stage to the first
                if mesh.pp_index == stage:
                    sharding.send_recv(None, t.contiguous(), mesh.pp_ranks[0],
                                       None, mesh.pipeline_group)
                elif mesh.pp_index == 0:
                    t = torch.empty(shape, dtype=full.dtype,
                                    device=full.device)
                    sharding.send_recv(t, None, None, mesh.pp_ranks[stage],
                                       mesh.pipeline_group)
            if keep:
                out[n] = torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=t.is_cuda).copy_(
                                         t, non_blocking=t.is_cuda)
        return out

    def load_items(self, items: tp.Mapping[str, tp.Any]) -> None:
        """This rank's slice of full tensors by name (a checkpoint of any
        mesh, or of one card)."""
        mesh = self.mesh
        for flat, key in ((self.master_flat, "params"), (self.mu_flat, "mu"),
                          (self.nu_flat, "nu")):
            self.layout.fill(flat, [sharding.tensor_shard(
                n, items[key][n], (mesh.tp_index,), mesh.tp_size, self.cfg)
                for n in self.names])
        self.step = int(items["step"])


def init_state(cfg: ExperimentConfig,
               device: tp.Union[None, str, torch.device] = None) -> TrainState:
    """Random init from ``cfg.seed`` in ``param_dtype``, zero moments."""
    model = GPT.init(cfg.model, torch.Generator().manual_seed(cfg.seed),
                     device=device, dtype=_dtype(cfg.param_dtype))
    return state_from_model(model)


def init_sharded_state(cfg: ExperimentConfig, mesh: Mesh,
                       device: tp.Union[None, str, torch.device] = None,
                       model: tp.Optional[GPT] = None) -> ShardedState:
    """Every rank's init from ``cfg.seed`` (or from ``model``, the full
    model, which the state takes over), sharded over ``mesh``: each rank
    keeps its tensor shard's (``GPT.init``'s ``tensor``) slice. The
    shadow is ``state.shadow``."""
    check_tensor_axis(cfg, mesh)
    check_pipeline_axis(cfg, mesh)
    # the tensor axis's exchange at tensor=1 too: the model's tensor
    # collectives then run as one-rank copies, bit for bit with one card
    tensor = GroupTensorExchange.from_mesh(mesh)
    stage = (mesh.pp_index, mesh.pp_size) if mesh.pp_size > 1 else None
    if model is None:
        model = GPT.init(cfg.model, torch.Generator().manual_seed(cfg.seed),
                         device=device, dtype=_dtype(cfg.param_dtype),
                         tensor=tensor, stage=stage)
    else:
        if stage is not None:
            model.keep_stage_(*stage)
        model.shard_tensor_(tensor)
    return ShardedState(model, mesh, _dtype(cfg.compute_dtype))


def check_tensor_axis(cfg: ExperimentConfig, mesh: Mesh) -> None:
    """What a ``tensor`` axis above 1 needs of the config (raises before
    any heavy work): V, H, Hkv and F (an MoE's E) divisible by it
    (``models.gpt.check_tensor``: ValueError naming the field), and an
    attention other than Ulysses (JAX asserts ``tensor == 1`` there)."""
    tpn = mesh.tp_size
    check_tensor(cfg.model, tpn)
    if tpn > 1 and cfg.model.attn_impl == "ulysses":
        raise ValueError(f"attn_impl='ulysses' cannot run under tensor={tpn}"
                         f" (JAX asserts tensor == 1): use 'ring'")


def check_pipeline_axis(cfg: ExperimentConfig, mesh: Mesh) -> None:
    """What a ``pipeline`` axis above 1 (the mesh's, or on the one-rank
    mesh the config's, run on a loopback) needs of the config: ValueError
    naming the field before any heavy work (``models.gpt.check_pipeline``:
    ``n_layer`` divisible by it, a dense MLP, no ring or Ulysses), and a
    boundary dtype the port knows."""
    _dtype(cfg.mesh.pp_boundary_dtype)
    check_pipeline(cfg.model, pipeline_size(cfg, mesh), mesh.seq_size)


def pipeline_size(cfg: ExperimentConfig, mesh: tp.Optional[Mesh]) -> int:
    """The stages a step runs: the mesh's pipeline axis, or without a
    distributed mesh (one process doing every rank's work, on a loopback)
    the config's."""
    if mesh is not None and mesh.distributed:
        return mesh.pp_size
    return max(1, cfg.mesh.pipeline)


def bind_mesh(shadow: GPT, mesh: Mesh, rows: int, pipeline: int = 1) -> None:
    """The forward's place in the mesh: its first global batch row
    (dropout), the sequence axis's exchange where there is one (the
    tensor axis's came with the shard) and the pipeline's: the mesh's
    pipeline group, or on the one-rank mesh a loopback of ``pipeline``
    stages (the whole model, every stage in this process)."""
    shadow.set_batch_offset(
        rows, GroupExchange.from_mesh(mesh) if mesh.seq_size > 1 else None)
    if mesh.distributed and mesh.pp_size > 1:
        shadow.pipeline = GroupPipe.from_mesh(mesh)
    elif not mesh.distributed and pipeline > 1:
        shadow.pipeline = LoopbackPipe(pipeline)
    else:
        shadow.pipeline = None


def state_from_model(model: GPT) -> TrainState:
    params = list(model.parameters())
    return TrainState(model=model,
                      mu=[torch.zeros_like(p) for p in params],
                      nu=[torch.zeros_like(p) for p in params])


def make_shadow(model: GPT, dtype: torch.dtype) -> GPT:
    """A copy of ``model`` in the compute dtype, whose parameters take the
    gradients (refresh it with :func:`refresh_shadow`)."""
    return copy.deepcopy(model).to(dtype)


@torch.no_grad()
def refresh_shadow(shadow: GPT, model: GPT) -> None:
    for pc, pm in zip(shadow.parameters(), model.parameters()):
        pc.copy_(pm)  # casts to the compute dtype


def effective_loss_chunk(cfg: ExperimentConfig,
                         mesh: tp.Optional[Mesh] = None) -> tp.Optional[int]:
    """``cfg.loss_chunk``, disabled when a rank's T (the block size over
    ``mesh``'s sequence axis) doesn't divide by it."""
    chunk = cfg.loss_chunk
    t = cfg.model.block_size // (1 if mesh is None else mesh.seq_size)
    if chunk is None or t % chunk:
        return None
    return chunk


def check_sequence(cfg: ExperimentConfig, mesh: Mesh) -> None:
    """What a ``sequence`` axis above 1 needs of the config (raises before
    any heavy work): T divisible by it, and a dense MLP (a Switch MoE's
    capacity is per global row: NotImplementedError), and an attention
    that runs on a T slice (``models.gpt.sequence_impl``: flash, naive and
    fused raise ValueError)."""
    s = mesh.seq_size
    check_moe_sequence(cfg.model, s)
    if cfg.model.block_size % s:
        raise ValueError(f"T={cfg.model.block_size} not divisible by "
                         f"sequence axis {s}")
    sequence_impl(cfg.model.attn_impl, s)


def loss_fn(model: GPT, x: torch.Tensor, y: torch.Tensor,
            loss_chunk: tp.Optional[int] = None,
            attn_impl: tp.Optional[str] = None,
            key: tp.Optional[int] = None,
            include_moe_aux: bool = True) -> torch.Tensor:
    """Mean cross-entropy of ``model`` on ``x -> y`` (``[B, T]``), logits
    in f32; T-chunked with ``loss_chunk``; dropout drawn from ``key``,
    deterministic without one. For an MoE model, plus ``moe_aux_weight``
    times the aux loss summed over the layers: the optimized loss (evals
    pass ``include_moe_aux=False``)."""
    cfg = model.config
    aux = None
    if cfg.mlp == "moe" and include_moe_aux:
        h, aux = model.hidden(x, attn_impl, key, deterministic=key is None,
                              return_aux=True)
    else:
        h = model.hidden(x, attn_impl, key, deterministic=key is None)
    xent = head_loss(model, loss_chunk)(h, y)
    return xent if aux is None else xent + cfg.moe_aux_weight * aux


def global_norm(tensors: tp.Sequence[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every element of every tensor."""
    return torch.sqrt(torch.stack([torch.sum(t * t) for t in tensors]).sum())


def bias_corrections(cfg: ExperimentConfig,
                     count: int) -> tp.Tuple[float, float]:
    """Adam's ``1 - b1^n`` and ``1 - b2^n`` at count ``n`` in f32."""
    n = np.float32(count)
    return (float(np.float32(1) - np.float32(cfg.beta1) ** n),
            float(np.float32(1) - np.float32(cfg.beta2) ** n))


@torch.no_grad()
def apply_update(state: TrainState, grads: tp.List[torch.Tensor],
                 cfg: ExperimentConfig, lr, bc1, bc2) -> torch.Tensor:
    """One update of the optax chain, in place on the f32 masters and
    moments, at ``lr`` with bias corrections ``bc1``/``bc2`` (floats, or
    f32 scalars on the device that a captured step reads). ``grads`` are
    f32, aligned with ``state.model.parameters()``. Returns the gradient's
    global norm (before clipping). No host sync; ``state.step`` is the
    caller's."""
    params = state.masters()
    norm = state.grad_norm(grads)
    keep = norm < cfg.grad_clip
    grads = [torch.where(keep, g, (g / norm) * cfg.grad_clip) for g in grads]
    b1, b2 = cfg.beta1, cfg.beta2
    torch._foreach_mul_(state.mu, b1)
    torch._foreach_add_(state.mu, torch._foreach_mul(grads, 1 - b1))
    torch._foreach_mul_(state.nu, b2)
    torch._foreach_add_(state.nu, torch._foreach_mul(
        torch._foreach_mul(grads, grads), 1 - b2))
    denom = torch._foreach_sqrt(torch._foreach_div(state.nu, bc2))
    torch._foreach_add_(denom, 1e-8)
    upd = torch._foreach_div(torch._foreach_div(state.mu, bc1), denom)
    # the JAX package's decay: independent of the lr (wd / lr_peak), or wd
    wd = (cfg.weight_decay / cfg.learning_rate if cfg.independent_wd
          else cfg.weight_decay)
    torch._foreach_add_(upd, torch._foreach_mul(params, wd))
    torch._foreach_mul_(upd, lr)
    torch._foreach_sub_(params, upd)
    return norm


def optimizer_update(state: TrainState, grads: tp.List[torch.Tensor],
                     cfg: ExperimentConfig, lr: float) -> torch.Tensor:
    """:func:`apply_update` at ``lr`` with the bias corrections of
    ``state.step + 1``, then one step on ``state.step``."""
    norm = apply_update(state, grads, cfg, lr,
                        *bias_corrections(cfg, state.step + 1))
    state.step += 1
    return norm


def head_loss(model: GPT, loss_chunk: tp.Optional[int] = None
              ) -> tp.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``(h, y) ->`` the mean cross-entropy of final hidden states ``h``
    against ``y`` through ``model``'s head (:func:`loss_fn`'s tail:
    logits in f32, T-chunked with ``loss_chunk``, vocab-parallel under a
    tensor axis): a pipeline's last stage's loss."""

    def fn(h: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        head_w = model.head_weight(h.dtype)
        if loss_chunk is not None:
            return chunked_softmax_xent(h, head_w, y, chunk_t=loss_chunk,
                                        tensor=model.tensor)
        return dense_softmax_xent(h, head_w, y, model.tensor)

    return fn


def pipeline_micro(cfg: ExperimentConfig, rows: int, size: int) -> int:
    """The microbatches ``M`` of a pipelined microstep of ``rows`` rows (a
    data rank's): ``MeshConfig.pp_microbatches``, or JAX's auto rule
    (``parallel.pipeline.microbatches``)."""
    return microbatches(rows, size, cfg.mesh.pp_microbatches)


def accumulate_grads(state: TrainState, shadow: GPT, x: torch.Tensor,
                     y: torch.Tensor, cfg: ExperimentConfig,
                     loss_chunk: tp.Optional[int] = None,
                     step_key: tp.Union[None, int, torch.Tensor] = None,
                     ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
    """The gradient half of a step on ``x, y [G, B, T]``: the G
    microbatches' gradients accumulate in the shadow's dtype, are divided
    by G and promoted to the masters' dtype. With dropout, ``step_key``
    (an int, split into one key per microbatch, or that step's key table
    ``[G, sites]`` on the device, :func:`step_keys`) keys the masks.
    Returns ``(loss, grads)``; the masters and moments are not touched.
    Under a mesh (a :class:`ShardedState`) the loss is the global batch's
    and the gradients this rank's reduced slice.

    Under a pipeline (``shadow.pipeline``) each microbatch runs the GPipe
    schedule over ``M`` microbatches of its rows
    (``models.gpt.pipeline_loss``), each seeding its own backward: the
    gradients and losses of ``G M`` microbatches add up in order and are
    divided by ``G M``, the single-card step at ``g_accum_iters = G M``
    on the same rows."""
    state.refresh(shadow)
    comp = list(shadow.parameters())
    for p in comp:
        p.grad = None
    g = x.shape[0]
    has_dropout = cfg.model.dropout > 0.0
    if has_dropout and step_key is None:
        raise ValueError("a config with dropout > 0 needs a step key")
    if not has_dropout:
        keys = [None] * g
    elif isinstance(step_key, torch.Tensor):
        keys = step_key.unbind(0)
    else:
        keys = torch.from_numpy(dropout_key_table(
            step_key, g, cfg.model.n_layer)).to(x.device).unbind(0)
    loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    if shadow.pipeline is not None:
        n_micro = pipeline_micro(cfg, x.shape[1], shadow.pipeline.size)
        tail = head_loss(shadow, loss_chunk)
        for i in range(g):
            loss_sum = pipeline_loss(
                shadow, x[i], y[i], tail, n_micro, keys[i],
                _dtype(cfg.mesh.pp_boundary_dtype), acc=loss_sum)
        g *= n_micro
    else:
        for i in range(g):
            loss = loss_fn(shadow, x[i], y[i], loss_chunk, key=keys[i])
            loss.backward()
            loss_sum = loss_sum + loss.detach()
    return state.mean_loss(loss_sum / g), state.promote_grads(comp, g)


def train_step(state: TrainState, shadow: GPT, x: torch.Tensor,
               y: torch.Tensor, cfg: ExperimentConfig, lr: float,
               loss_chunk: tp.Optional[int] = None,
               step_key: tp.Optional[int] = None,
               ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step on ``x, y [G, B, T]`` (:func:`accumulate_grads`,
    then :func:`optimizer_update`). Returns ``(loss, grad_norm)`` as
    device scalars."""
    loss, grads = accumulate_grads(state, shadow, x, y, cfg, loss_chunk,
                                   step_key)
    return loss, optimizer_update(state, grads, cfg, lr)


def step_scalars(cfg: ExperimentConfig, schedule: tp.Callable[[int], float],
                 first_step: int, adam_step: int, k: int) -> np.ndarray:
    """f32 ``[k, 3]``: steps ``first_step + i``'s lr and the bias
    corrections of Adam count ``adam_step + i + 1``."""
    return np.array([(schedule(first_step + i),
                      *bias_corrections(cfg, adam_step + i + 1))
                     for i in range(k)], dtype=np.float32)


def step_keys(cfg: ExperimentConfig, first_step: int,
              k: int) -> tp.Optional[np.ndarray]:
    """int64 ``[k, G, sites]``: steps ``first_step + i``'s dropout site
    keys (step key ``fold_in(cfg.seed, s)``); None without dropout."""
    if cfg.model.dropout <= 0.0:
        return None
    return np.stack([dropout_key_table(fold_in(cfg.seed, first_step + i),
                                       cfg.g_accum_iters, cfg.model.n_layer)
                     for i in range(k)])


def step_body(prog: StepProgram, state: TrainState, shadow: GPT,
              cfg: ExperimentConfig,
              loss_chunk: tp.Optional[int] = None) -> None:
    """One step of ``prog``'s window, all on the device: the batch, keys
    and scalars of row ``prog.idx``, :func:`accumulate_grads`, then
    :func:`apply_update` in place; the loss, grad norm and lr into row
    ``prog.idx`` of ``prog.out``, then ``prog.idx + 1``. The counterpart of
    the JAX trainer's ``_make_step_core``."""
    idx = prog.idx
    x = prog.xs.index_select(0, idx)[0]
    y = prog.ys.index_select(0, idx)[0]
    sc = prog.scalars.index_select(0, idx)[0]
    keys = prog.keys.index_select(0, idx)[0] if prog.sites else None
    loss, grads = accumulate_grads(state, shadow, x, y, cfg, loss_chunk, keys)
    prog.updating = True
    gnorm = apply_update(state, grads, cfg, sc[0], sc[1], sc[2])
    del grads
    prog.out.index_copy_(0, idx,
                        torch.stack((loss, gnorm.float(), sc[0]))[None])
    idx.add_(1)


def _world_mean(x: torch.Tensor, mesh: tp.Optional[Mesh],
                pipelined: bool = False) -> torch.Tensor:
    """``x`` averaged over the ranks of a distributed mesh (else ``x``);
    ``pipelined``: the last stages' ``x`` alone (zero elsewhere)."""
    if mesh is None or not mesh.distributed:
        return x
    sharding.all_reduce(x)
    return x / (mesh.world // (mesh.pp_size if pipelined else 1))


@torch.no_grad()
def evaluate(shadow: GPT, loader: Loader, n_batches: int, device,
             loss_chunk: tp.Optional[int] = None,
             seed_offset: int = 0,
             mesh: tp.Optional[Mesh] = None,
             cfg: tp.Optional[ExperimentConfig] = None) -> float:
    """Mean cross-entropy (no MoE aux) over every microbatch of
    ``n_batches`` peeked batches (steps disjoint from the training
    steps); under a distributed ``mesh`` the mean over the ranks' tokens
    (every rank holds as many: its rows, and under a sequence axis its
    columns of them). Under a pipeline (``shadow.pipeline``; ``cfg``
    gives its microbatches and boundary dtype) each microbatch runs the
    training step's ``M`` microbatches through the stages without
    gradients and counts their mean (the last stage's)."""
    total = torch.zeros((), dtype=torch.float32, device=device)
    n = 0
    pipe = shadow.pipeline
    for i in range(n_batches):
        xs, ys = loader.peek(10_000_000 + seed_offset + i)
        if mesh is not None:  # a sequence rank's columns
            cols = sharding.seq_cols(xs.shape[-1], mesh)
            xs, ys = xs[..., cols], ys[..., cols]
        for x, y in zip(_to_device(xs, device), _to_device(ys, device)):
            if pipe is None:
                total += loss_fn(shadow, x, y, loss_chunk,
                                 include_moe_aux=False)
            else:
                n_micro = pipeline_micro(cfg, x.shape[0], pipe.size)
                total += pipeline_loss(
                    shadow, x, y, head_loss(shadow, loss_chunk), n_micro,
                    boundary_dtype=_dtype(cfg.mesh.pp_boundary_dtype),
                    train=False) / n_micro
            n += 1
    return float(_world_mean(total / n, mesh, pipe is not None))


def moe_telemetry(shadow: GPT, loader: Loader, device,
                  seed_offset: int = 0,
                  mesh: tp.Optional[Mesh] = None) -> tp.Dict[str, float]:
    """``{"moe/aux", "moe/dropped_frac"}`` from ``moe_stats`` on the first
    microbatch of the eval's first peeked batch, as the JAX trainer reads
    them (under a distributed ``mesh``, each rank's on its rows, averaged
    over the ranks); ``{}`` for a dense model."""
    if shadow.config.mlp != "moe":
        return {}
    xs, _ = loader.peek(10_000_000 + seed_offset)
    stats = shadow.moe_stats(_to_device(xs[0], device))
    if mesh is not None and mesh.distributed:
        both = _world_mean(torch.stack([stats["aux"].float(),
                                        stats["dropped_frac"].float()]), mesh)
        stats = {"aux": both[0], "dropped_frac": both[1]}
    return moe_router_metrics(stats)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=torch.long)


def estimate_hbm_fill(cfg: ExperimentConfig, hbm_bytes: int,
                      n_devices: int = 1) -> float:
    """Estimated fraction of a device's memory filled by f32 params + Adam
    state + remat='none' activations (the JAX package's fit model over
    ``n_devices`` under ``cfg.mesh``: tokens split over the data axes,
    state over ``fsdp`` and ``tensor``; an MoE model's parameters count
    every expert, its activations keep the dense term)."""
    m = cfg.model
    c, hkv = m.head_dim, m.kv_heads
    f = (m.n_head + 2 * hkv) * c
    mh = mlp_hidden_dim(m)
    hidden = 2 * mh if m.mlp == "swiglu" else mh
    mlp_mult = m.moe_experts if m.mlp == "moe" else 1
    per_layer_params = (m.n_embd * f + m.n_head * c * m.n_embd
                        + mlp_mult * (3 if m.mlp == "swiglu" else 2)
                        * m.n_embd * mh)
    n_params = m.n_layer * per_layer_params + 2 * m.vocab_size * m.n_embd
    state_bytes = n_params * 12  # f32 params + Adam m, v
    try:
        pp_sz, rep_sz, fsdp_sz, seq_sz, tensor_sz = cfg.mesh.sizes(n_devices)
    except AssertionError:
        pp_sz, rep_sz, fsdp_sz, seq_sz, tensor_sz = 1, 1, max(1, n_devices), 1, 1
    tokens = (cfg.microbatch_size * m.block_size
              / max(1, rep_sz * fsdp_sz * seq_sz))
    per_token_act = (m.n_layer / max(1, pp_sz)
                     * (4 * m.n_embd + (f + m.n_head * c + hidden)
                        / max(1, tensor_sz)) * 2)
    return (state_bytes / max(1, fsdp_sz * tensor_sz)
            + tokens * per_token_act) / hbm_bytes


# the card's fit: "auto" takes the first remat whose estimate
# (card_peak_bytes) stays under this share of the card's memory; the rest
# is the allocator's slack between reserved and allocated bytes
CARD_FIT_FRACTION = 0.9
# beside the counted tensors: cuBLAS's workspaces (a fixed amount), and
# a share of the larger moment for what grows with the run (the
# allocator's rounding, temporaries the terms leave out); a fixed 256 MiB
# read 1.30-1.37x a 0.69 GB char run's peak and 1.01-1.03x the 6-54 GB
# runs', whose peaks lie 0.5-2.6% above their terms
CARD_HEADROOM_BYTES = 32 << 20
CARD_HEADROOM_SHARE = 0.02
REMAT_LADDER = ("none", "dots", "full")


def parameter_count(m: ModelConfig, tp: int = 1,
                    stages: tp.Optional[tp.Tuple[int, tp.Sequence[int]]]
                    = None) -> int:
    """Elements of every parameter ``GPT.init`` makes for ``m`` (``tp``:
    those of one tensor shard, ``GPT.init``'s ``tensor``; ``stages``:
    ``(S, held)``, those of the pipeline stages ``held`` of ``S``: their
    blocks, ``wte`` where the first stage (or, tied, the last) is held,
    ``lm_head`` where the last is)."""
    c, hkv, d = m.head_dim, m.kv_heads, m.n_embd
    f = mlp_hidden_dim(m)
    size, held = (1, (0,)) if stages is None else stages
    attn = (d * (m.n_head + 2 * hkv) * c + m.n_head * c * d) // tp
    attn += 2 * c if m.qk_norm else 0
    if m.mlp == "moe":
        mlp = d * m.moe_experts + 2 * m.moe_experts * d * f // tp
    else:
        mlp = (3 if m.mlp == "swiglu" else 2) * d * f // tp
    last = size - 1 in held
    ends = int(0 in held or (last and m.tie_embeddings)) + int(
        last and not m.tie_embeddings)
    return (m.n_layer // size * len(held) * (attn + mlp)
            + m.vocab_size * d * ends // tp)


def held_stages(cfg: ExperimentConfig, mesh: tp.Optional[Mesh] = None
                ) -> tp.Tuple[int, tp.Tuple[int, ...]]:
    """``(S, held)``: the pipeline's stages and those one process holds
    (a distributed mesh's rank its own; otherwise every stage of the
    config's ``pipeline``, the loopback's)."""
    size = pipeline_size(cfg, mesh)
    if mesh is not None and mesh.distributed:
        return size, (mesh.pp_index,)
    return size, tuple(range(size))


def largest_parameter(m: ModelConfig) -> int:
    """Elements of the largest full parameter ``GPT.init`` makes for
    ``m``: the embedding or head ``[V, D]``, a layer's ``wqkv``, or its
    MLP's largest weight (an MoE's ``[E, D, F]`` experts)."""
    d, f = m.n_embd, mlp_hidden_dim(m)
    experts = m.moe_experts if m.mlp == "moe" else 1
    return max(m.vocab_size * d, d * (m.n_head + 2 * m.kv_heads) * m.head_dim,
               experts * d * f)


def card_route(m: ModelConfig, seq: int = 1, tp: int = 1) -> str:
    """The attention a training step takes on the card: ``"fused"``,
    ``"flash"``, ``"naive"``, ``"ring"`` or ``"ulysses"``
    (``Attention._use_fused``, ``models.gpt.sequence_impl`` under ``seq``
    sequence ranks and ``ops.attention.resolve_impl`` for CUDA tensors,
    dropout drawn; a tensor shard's ``H / tp`` heads under ``tp``)."""
    impl = sequence_impl(m.attn_impl, seq)
    if impl in ("ring", "ulysses"):
        return impl
    if impl in ("fused", "auto") and (
            m.qk_norm and fused_supported(m.n_head // tp, m.kv_heads // tp,
                                          m.head_dim)
            and m.block_size >= 128 and m.block_size % 128 == 0
            and m.dropout == 0.0):
        return "fused"
    return "naive" if impl == "naive" else "flash"


def activation_bytes(cfg: ExperimentConfig, remat: str,
                     route: tp.Optional[str] = None,
                     mesh: tp.Optional[Mesh] = None) -> tp.Dict[str, int]:
    """Bytes autograd keeps for one training microbatch's backward, counted
    from the model's code: ``saved``, what the forward leaves (every
    layer's saved tensors under ``"none"``; the block inputs, and under
    ``"dots"`` the block's kept products, under the two checkpoints; the
    embedding's indices, ``ln_f`` and the loss's inputs), and
    ``recompute``, what a checkpointed block adds while its backward
    runs (its own ``"none"`` tensors less those kept). ``route`` is the
    attention's (default: the card's, :func:`card_route`). Under a
    ``mesh`` the microbatch is a rank's rows, and under its sequence axis
    their ``T / S`` columns; ring attention then keeps its packed K/V
    chunk and every one it received (the two chunk buffers in flight a
    hop, kept for the backward), Ulysses the head-sharded v its
    all-to-all makes beside q and k. Under its tensor axis a rank's
    heads, MLP columns and experts are a ``1 / tensor`` shard (the
    residual stream, the norms and the router's planes stay whole).

    Under a pipeline (:func:`held_stages`) ``saved`` is the stage
    inputs a held stage after the first keeps for its backward (``M``
    microbatches' ``[b / M, T, D]`` in the boundary dtype) and
    ``recompute`` one microbatch's activations of one stage's ``L / S``
    blocks while its backward runs (with the embedding's indices, and on
    the last stage ``ln_f``'s and the loss's inputs): the blocks run as
    ``remat="none"`` inside the recomputed stage."""
    m = cfg.model
    seq = 1 if mesh is None else mesh.seq_size
    tpn = 1 if mesh is None else mesh.tp_size
    route = card_route(m, seq, tpn) if route is None else route
    s = _dtype(cfg.compute_dtype).itemsize
    b, t = cfg.microbatch_size, m.block_size // seq
    if mesh is not None:
        b //= mesh.data_shards
    size, held = held_stages(cfg, mesh)
    n_micro = 1
    if size > 1:
        n_micro = pipeline_micro(cfg, b, size)
        b //= n_micro
    n = b * t
    d, h, hkv, c = m.n_embd, m.n_head // tpn, m.kv_heads // tpn, m.head_dim
    f = mlp_hidden_dim(m)
    qkv = s * (h + 2 * hkv) * c
    # a block norm: the fused one keeps its bf16 input, the plain chain
    # its f32 upcast, both the f32 rstd
    fused_norm = m.norm_impl == "fused" and d % 128 == 0
    norm = (s * d if fused_norm else 4 * d) + 4
    # per token and layer; per layer (not per token) in `layer_fixed`
    tok = 2 * norm + s * d  # the norms; ln1's output (wqkv's input)
    layer_fixed = 0
    if route == "fused":
        tok += qkv + s * h * c + 4 * h  # qkv, out (wo's input), lse
    else:
        if m.qk_norm:  # LayerNorm of q and k: centred f32, rstd, f32 out
            tok += 8 * (h + hkv) * c + 4 * (h + hkv)
            layer_fixed += 8 * c
        layer_fixed += 4 * t * c * s  # RoPE's sin/cos for q and for k
        tok += s * h * c  # wo's input
        if route in ("flash", "ring", "ulysses"):
            # q, k after RoPE, qkv (v), out, lse
            tok += s * (h + hkv) * c + qkv + s * h * c + 4 * h
            if route == "ulysses" and seq > 1:  # the all-to-alls' v copy
                tok += s * hkv * c
            if route == "ring" and seq > 1:
                # the packed local K/V chunk and the S - 1 received ones
                tok += seq * 2 * s * hkv * c
        else:  # f32 q, k, v, softmax out and its f32 probabilities
            # (as for MHA: GQA's broadcast copies are not counted; the
            # card takes this route only when asked)
            tok += 4 * (h + 2 * hkv) * c + 8 * h * t
    kept = qkv + s * d  # wqkv's and wo's products
    if m.mlp == "moe":
        e, k = m.moe_experts, m.moe_top_k
        cap = max(1, min(int(-(-m.moe_capacity * k * t // e)), t))
        rows = e // tpn * b * cap  # a shard's experts' buffer
        # x.float() (the router's input), probs, three int64 index planes,
        # keep, the claims' source rows (ln2's output itself at K = 1)
        tok += 4 * d + 4 * e + 24 * k + k + s * d * k
        if k == 1:  # the gate and the gathered row, in the compute dtype
            tok += s + s * d
        else:  # the stacked gates and their sum; f32 gates and rows
            tok += 8 * k + 4 + 4 * d * k
        # the expert buffer (with its spare row), up and GELU in [E, B C]
        layer_fixed += s * d * (rows + 1) + 2 * s * f * rows
        layer_fixed += 4 * d * e + 4 * b * e  # f32 router weight, aux means
        kept += 4 * e  # the router's f32 logits
    else:
        n_hidden = 4 if m.mlp == "swiglu" else 2
        f //= tpn
        tok += s * d + n_hidden * s * f  # ln2's output, the hidden planes
        kept += (n_hidden // 2) * s * f + s * d
    # (residual and embedding dropout keep nothing: the backward redraws
    # the mask from its key, ops.dropout)
    layer = n * tok + layer_fixed
    # the embedding's indices, ln_f, the loss's inputs (h, targets), and
    # the fused route's f32 RoPE tables
    fixed = n * (8 + norm + s * d + 8)
    fixed += 8 * t * c if route == "fused" else 0
    if m.dropout > 0.0 and remat != "none":
        # the row of int64 site keys, whose slices are the checkpointed
        # blocks' arguments
        fixed += 8 * site_row(m.n_layer)["size"]
    if size > 1:
        inputs = sum(1 for st in held if st > 0)
        saved = inputs * n_micro * n * d * _dtype(
            cfg.mesh.pp_boundary_dtype).itemsize
        return {"saved": saved,
                "recompute": m.n_layer // size * layer + fixed}
    if remat == "none":
        saved, recompute = m.n_layer * layer, 0
    elif remat == "full":
        saved, recompute = m.n_layer * n * s * d, layer
    elif remat == "dots":
        saved = m.n_layer * n * (s * d + kept)
        recompute = layer - n * kept
    else:
        raise ValueError(f"remat {remat!r} is not none | dots | full")
    return {"saved": saved + fixed, "recompute": recompute}


def card_peak_bytes(cfg: ExperimentConfig,
                    remat: tp.Optional[str] = None,
                    mesh: tp.Optional[Mesh] = None) -> tp.Dict[str, int]:
    """The port's estimate of ``torch.cuda.max_memory_allocated`` for a
    training run of ``cfg`` at ``remat`` (default ``cfg.model.remat``),
    and its terms. Two moments compete for the peak:

    - ``backward``: the f32 masters and Adam moments, the compute-dtype
      shadow and its gradients, one microbatch's saved activations
      (:func:`activation_bytes`), and the larger of the loss's backward
      (a chunk's logits recomputed: about five f32 ``[B, chunk, V]``
      planes; without ``loss_chunk``, the whole ``[B, T, V]`` logits and
      four such planes) and a checkpointed block's recompute;
    - ``optimizer``: the same state and shadow, the f32 promoted
      gradients (``train_step``) and the largest set of ``foreach``
      temporaries ``optimizer_update`` holds at once (the clipped
      gradients, ``denom``, ``upd`` and one product: four f32 lists);
    - ``save`` (under a distributed mesh; a single-card save copies
      straight to host buffers): the state and shadow, and the largest
      full parameter twice in f32 (its tensor shards all-gathered, and
      put back together: ``ShardedState.items``, which gathers over
      ``fsdp`` into the promoted gradients' buffer).

    Under a distributed ``mesh`` (:class:`ShardedState`) the masters and
    moments are a ``1 / fsdp`` slice, the shadow and its gradients stay
    whole (beside the compute-dtype slice the shadow is gathered from),
    the promoted gradients are one persistent full f32 buffer beside
    their reduced slice, the optimizer's four temporaries are slices, and
    the activations a rank's rows'; under its tensor axis every term
    counts the rank's tensor shard (``parameter_count``'s ``tp``: the
    heads, MLP columns, experts and vocabulary over ``tensor``) and the
    loss's logits its ``V / tensor`` columns. Under a pipeline every term
    counts the stages a process holds (:func:`held_stages`: one on a
    rank, all on the one-card loopback; JAX's fit estimate divides by
    ``pipeline``): their parameters, the stored stage inputs, one
    stage's recompute, and beside it, where the last stage is held, one
    microbatch's loss (``b / M`` rows).

    ``peak`` is the larger plus ``headroom``: ``CARD_HEADROOM_BYTES`` and
    ``CARD_HEADROOM_SHARE`` of the larger."""
    m = cfg.model
    remat = m.remat if remat is None else remat
    tpn = 1 if mesh is None else mesh.tp_size
    size, held = held_stages(cfg, mesh)
    p = parameter_count(m, tpn, (size, held))
    master = _dtype(cfg.param_dtype).itemsize * p
    comp = _dtype(cfg.compute_dtype).itemsize * p
    sharded = mesh is not None and mesh.distributed
    if sharded:
        shard = master // mesh.fsdp
        # slices of masters, mu, nu and the reduced grads; the promoted
        # grads' full buffer; the shadow, its grads and the slice it is
        # gathered from
        state = 4 * shard + master + 2 * comp + comp // mesh.fsdp
        temps = 4 * shard
    else:
        state = 3 * master + 2 * comp  # masters, mu, nu; shadow and grads
        temps = 5 * master  # the promoted grads and four temporaries
    act = activation_bytes(cfg, remat, mesh=mesh)
    b, v = cfg.microbatch_size, m.vocab_size // tpn
    t = m.block_size
    if mesh is not None:
        b //= mesh.data_shards
        t //= mesh.seq_size
    if size > 1:
        b //= pipeline_micro(cfg, b, size)
    chunk = effective_loss_chunk(cfg, mesh)
    if chunk is not None:
        loss = 5 * 4 * b * chunk * v
    else:
        loss = 5 * 4 * b * t * v
    if size > 1:  # the last stage's loss beside its recomputed blocks
        backward = state + act["saved"] + act["recompute"] + (
            loss if size - 1 in held else 0)
    else:
        backward = state + act["saved"] + max(loss, act["recompute"])
    optimizer = state + temps
    save = (state + 2 * _dtype(cfg.param_dtype).itemsize
            * largest_parameter(m) if sharded else 0)
    larger = max(backward, optimizer, save)
    headroom = CARD_HEADROOM_BYTES + int(CARD_HEADROOM_SHARE * larger)
    return {"peak": larger + headroom, "headroom": headroom,
            "backward": backward, "optimizer": optimizer, "save": save,
            "state": state, "saved": act["saved"],
            "recompute": act["recompute"], "loss": loss,
            "params": p}


def resolve_auto_knobs(cfg: ExperimentConfig, hbm_bytes: int,
                       card: bool = False,
                       mesh: tp.Optional[Mesh] = None) -> ExperimentConfig:
    """Resolve ``remat="auto"``, per rank of ``mesh`` (default: one card).

    On the card (``card``): the first of none, dots and full whose
    :func:`card_peak_bytes` stays under ``CARD_FIT_FRACTION`` of
    ``hbm_bytes`` (the card's ``total_memory``), else full.

    Elsewhere, the JAX package's rule on its fit estimate
    (:func:`estimate_hbm_fill` over the mesh's devices): none below 0.78
    of the memory (0.84 away from 16 GB), full above 0.92 (0.98), dots
    between."""
    m = cfg.model
    if m.remat != "auto":
        return cfg
    if card:
        fits = [r for r in REMAT_LADDER
                if card_peak_bytes(cfg, r, mesh)["peak"]
                <= CARD_FIT_FRACTION * hbm_bytes]
        remat = fits[0] if fits else "full"
        if mesh is None or mesh.rank == 0:
            print(f"auto knobs: remat={remat} (estimated peak "
                  f"{card_peak_bytes(cfg, remat, mesh)['peak'] / 1e9:.2f} "
                  f"GB of {hbm_bytes / 1e9:.1f} GB)")
    else:
        fill = estimate_hbm_fill(cfg, hbm_bytes,
                                 1 if mesh is None else mesh.world)
        margin = 0.0 if abs(hbm_bytes - 16e9) / 16e9 < 0.25 else 0.06
        if fill <= 0.78 + margin:
            remat = "none"
        elif fill <= 0.92 + margin:
            remat = "dots"
        else:
            remat = "full"
    return dataclasses.replace(cfg, model=dataclasses.replace(m, remat=remat))


def model_fingerprint(cfg: ExperimentConfig) -> str:
    """Hash of the fields that change the parameters or the math; the
    implementation knobs and ``moe_aux_weight`` (a training knob: no
    effect on the parameters) may differ between save and resume. A dense
    model's hash leaves the ``moe_*`` fields out, as it did before the
    port had them."""
    skip = {"attn_impl", "ring_schedule", "norm_impl", "remat",
            "moe_aux_weight"}
    if cfg.model.mlp != "moe":
        skip |= {"moe_experts", "moe_top_k", "moe_capacity"}
    fp = {k: v for k, v in to_dict(cfg.model).items() if k not in skip}
    fp["mlp_hidden"] = mlp_hidden_dim(cfg.model)
    return config_fingerprint(fp)


def train(cfg: ExperimentConfig) -> tp.Dict[str, tp.Any]:
    """The training loop: eval at every ``eval_interval`` (and at the
    first step), one train dispatch per window of ``steps_per_dispatch``
    steps (one step at K=1) on batches from the prefetch thread, metrics
    every ``log_interval`` steps, asynchronous checkpoints every
    ``ckpt_interval`` steps (at K > 1: after the first window of a fresh
    run and at window ends on the interval, the JAX trainer's window rule)
    and at the end; resumes from the newest checkpoint in ``cfg.rundir``.
    Misaligned intervals raise before any heavy work
    (``config.resolve_dispatch_intervals``).

    Preemption: on SIGTERM the loop finishes the window in flight, saves
    it, flushes the save and returns with ``interrupted_at`` set; the
    previous handler comes back only after the flush.

    With ``remat="auto"``, an out-of-memory error in a program's warm-up
    step (before the masters are touched) or its capture steps the remat
    one rung down (none, dots, full), drops the program and retries on
    the same batch.

    Returns the final metrics: every step's loss under ``losses``;
    ``train_dispatches``; ``launches``, every counted kernel and
    collective launch of the loop by wrapper (``ops.launches.name``), and
    ``replay_launches``, those of one replay of the step's graph (empty
    off the card); on the card ``max_memory_allocated``; the loop's host seconds (``loop_s``), and the
    evals', the save enqueues' and the waits for writes' shares of them
    (``eval_s``, ``ckpt_s``, ``ckpt_wait_s``); ``tokens_per_sec`` (and
    ``mfu`` on the card), every trained token over ``loop_s``;
    ``anomalies``, the monitors' trips."""
    if not cfg.rundir:
        raise ValueError("rundir required")
    cfg = resolve_dispatch_intervals(cfg)
    stop_requested = {"flag": False}

    def on_sigterm(signum, frame):
        stop_requested["flag"] = True

    try:
        prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
    except ValueError:  # not the main thread: no handler, no preemption
        prev_handler = None
    try:
        return _train(cfg, stop_requested)
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)


def _train(cfg: ExperimentConfig,
           stop_requested: tp.Dict[str, bool]) -> tp.Dict[str, tp.Any]:
    mesh = create_mesh(cfg.mesh)
    rank0 = mesh.rank == 0
    device = resolve_device(cfg.device,
                            local_rank() if mesh.distributed else None)
    on_card = device.type == "cuda"
    hbm = (torch.cuda.get_device_properties(device).total_memory
           if on_card else _DEFAULT_HBM_BYTES)
    remat_was_auto = cfg.model.remat == "auto"
    check_sequence(cfg, mesh)
    check_tensor_axis(cfg, mesh)
    check_pipeline_axis(cfg, mesh)
    cfg = resolve_auto_knobs(cfg, hbm, card=on_card, mesh=mesh)
    t = cfg.model.block_size
    # each data shard its contiguous shard of the token files and its rows
    # of the global batch (its sequence ranks read the same rows, then
    # take their columns of them)
    local_b = sharding.local_batch_size(cfg.batch_size, cfg.g_accum_iters,
                                        mesh)
    cols = sharding.seq_cols(t, mesh)
    shape = (cfg.g_accum_iters, local_b)
    proc, n_proc = mesh.data_index, mesh.data_shards
    train_loader = Loader(load_shard(os.path.join(cfg.data_dir, "train.bin"),
                                     proc, n_proc),
                          t, shape, cfg.data_seed, process_index=proc)
    val_loader = Loader(load_shard(os.path.join(cfg.data_dir, "val.bin"),
                                   proc, n_proc),
                        t, shape, cfg.data_seed, stream=1, process_index=proc)
    train_eval_loader = Loader(train_loader.tokens, t, shape, cfg.data_seed,
                               stream=2, process_index=proc)
    schedule = make_lr_schedule(cfg)
    loss_chunk = effective_loss_chunk(cfg, mesh)
    ckpt_every = (cfg.ckpt_interval if cfg.ckpt_interval is not None
                  else cfg.eval_interval)
    ckpt = Checkpointer(cfg.rundir, keep=cfg.ckpt_keep,
                        save_interval_steps=ckpt_every,
                        async_save=not cfg.debug)
    # rank 0 alone logs, traces and writes checkpoints
    logger = MetricLogger(cfg.rundir, cfg, enabled=rank0)
    fingerprint = model_fingerprint(cfg)
    device_name = torch.cuda.get_device_name(device) if on_card else None
    n_eval = 1 if cfg.debug else cfg.eval_batches
    tele = TrainTelemetry() if cfg.train_telemetry and rank0 else None
    monitors = AnomalyMonitors(
        telemetry=tele, flight_dir=cfg.rundir,
        rank=mesh.rank if mesh.distributed else None)
    if tele is not None:
        tele.emit("run_start", step=0, t=time.perf_counter())

    def say(msg: str) -> None:
        if rank0:
            print(msg)

    if mesh.distributed:
        state = init_sharded_state(cfg, mesh, device)
        shadow = state.shadow
    else:
        state = init_state(cfg, device)
    say(f"parameters (non-embedding): {count_params(state.model) / 1e6:.2f}M")
    first_step = 0
    # every rank takes rank 0's newest step, and reads only after all
    # ranks got here
    latest = mesh.host_broadcast(ckpt.latest_step())
    mesh.host_barrier()
    if latest is not None:
        # under a mesh the full tensors stay memory-mapped on the host,
        # and each rank copies only its pieces to the card
        items, meta = ckpt.restore(
            step=latest,
            map_location="cpu" if mesh.distributed else device)
        if meta.get("model_fingerprint") != fingerprint:
            raise ValueError("checkpoint was trained with a different model "
                             "config")
        state.load_items(items)
        del items
        loaders = meta.get("loaders")
        train_loader.load_state_dict(
            loaders[mesh.rank] if loaders is not None
            and len(loaders) == mesh.world else meta["loader"])
        first_step = int(meta["step"]) + 1
        if tele is not None:
            tele.emit("resume", step=first_step, t=time.perf_counter())
        say(f"resumed from step {meta['step']}")
    if not mesh.distributed:
        shadow = make_shadow(state.model, _dtype(cfg.compute_dtype))
    # dropout: this rank's rows (and columns) draw the global batch's
    # masks there; attention runs over the sequence group, the blocks
    # over the pipeline's stages
    bind_mesh(shadow, mesh, mesh.data_index * local_b, cfg.mesh.pipeline)
    k_disp = cfg.steps_per_dispatch
    plan = window_plan(first_step, cfg.max_steps, k_disp)
    # K > 1: each item a [k, G, B, T] window of the plan
    prefetch = PrefetchLoader(
        train_loader, *device_transform(device),
        **({"window": k_disp, "window_plan": plan} if k_disp > 1 else {}))

    def save(step: int, force: bool) -> None:
        # full tensors by name (gathered by every rank under a mesh, into
        # host tensors rank 0 hands over) and every rank's loader state;
        # rank 0 writes them
        items = (state.items(keep=rank0) if mesh.distributed
                 else state.items())
        loaders = mesh.host_gather(prefetch.state_dict())
        if not rank0:
            return
        meta = {"step": step, "loader": loaders[0],
                "model_fingerprint": fingerprint, "config": to_dict(cfg)}
        if mesh.distributed:
            meta["loaders"] = loaders
        ckpt.save(step, items, meta=meta, force=force,
                  owned=mesh.distributed)

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(device)

    def eval_loss(loader: Loader, itr: int) -> float:
        return evaluate(shadow, loader, n_eval, device, loss_chunk,
                        0 if cfg.eval_fixed else itr, mesh, cfg)

    tokens_per_step = cfg.batch_size * t
    # eval_s / ckpt_s / ckpt_wait_s: host seconds of the evals, the save
    # enqueues (the snapshot) and the waits for a write (the previous one,
    # or the flush at the end), each timed from a synced card to a synced
    # card; loop_s holds them and the steps
    final: tp.Dict[str, tp.Any] = {"remat": cfg.model.remat, "eval_s": 0.0,
                                   "ckpt_s": 0.0, "ckpt_wait_s": 0.0}

    def timed(key: str, fn: tp.Callable[[], tp.Any],
              span: tp.Optional[str] = None, step: int = 0) -> tp.Any:
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        dur = time.perf_counter() - t0
        final[key] += dur
        if tele is not None and span is not None:
            tele.span(span, step=step, t=t0, dur=dur)
        return out

    def checkpoint(step: int, force: bool) -> None:
        timed("ckpt_wait_s", ckpt.wait, "ckpt_wait", step)
        timed("ckpt_s", lambda: save(step, force), "ckpt_save", step)
        if tele is not None:
            tele.metrics.counter("ckpt_saves").inc()

    # the drive's program: K=1 a step program of its own, K > 1 the cached
    # window of cfg (a remat step-down lands on another cache key)
    programs: tp.Dict[str, StepProgram] = {}

    def program() -> StepProgram:
        if k_disp == 1:
            if "step" not in programs:
                programs["step"] = StepProgram(cfg, device, 1, mesh)
            prog = programs["step"]
        else:
            prog = programs["window"] = get_train_window(cfg, device, k_disp,
                                                         mesh)
        prog.bind(state)
        return prog

    def free_grads() -> None:
        """The eager step's gradients and cached blocks, before a capture
        (or a retry) takes its own memory."""
        for p in shadow.parameters():
            p.grad = None
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def dispatch(xs: torch.Tensor, ys: torch.Tensor, w_start: int,
                 k_eff: int) -> StepProgram:
        """Steps ``[w_start, w_start + k_eff)`` on the window's batches
        ``[k_eff, G, B, T]``: one copy of the inputs, then one run of the
        program a step. While the program is not settled (its warm-up
        step, and on the card its capture) an "auto" run's out-of-memory
        error that left the masters untouched steps the remat down a rung
        and retries the step on a new program (one card only: under a
        distributed mesh an out-of-memory error raises, since the ranks
        could not agree to retry without a collective the failing rank
        never reaches)."""
        nonlocal cfg
        scalars = step_scalars(cfg, schedule, w_start, state.step, k_eff)
        keys = step_keys(cfg, w_start, k_eff)
        prog = program()
        prog.load(scalars, keys, xs, ys)
        done = 0
        while done < k_eff:
            guarded = (remat_was_auto and not prog.settled
                       and not mesh.distributed)
            try:
                prog.run(lambda: step_body(prog, state, shadow, cfg,
                                           loss_chunk), free_grads)
            except torch.OutOfMemoryError:
                nxt = {"none": "dots", "dots": "full"}.get(cfg.model.remat)
                if not guarded or nxt is None or prog.updating:
                    raise
                say(f"first-step OOM at remat={cfg.model.remat}; retrying "
                    f"with remat={nxt}")
                cfg = dataclasses.replace(
                    cfg, model=dataclasses.replace(cfg.model, remat=nxt))
                state.model.config = shadow.config = cfg.model
                final["remat"] = nxt
                prog.release()
                programs.clear()
                free_grads()
                prog = program()
                prog.load(scalars, keys, xs, ys, start=done)
                continue
            done += 1
        state.step += k_eff
        return prog

    losses: tp.List[torch.Tensor] = []
    counts0 = launch_counts.snapshot()
    sync()
    loop_t0 = time.perf_counter()
    # the first log's interval holds every step from the first one on
    last_log_time, last_log_step = loop_t0, first_step - 1
    last_step = first_step - 1
    dispatches = 0
    w_start = first_step
    prefetch.start()
    try:
        for wi, k_eff in enumerate(plan):
            if w_start % cfg.eval_interval == 0 or w_start == first_step:
                state.refresh(shadow)
                train_loss, val_loss, router = timed("eval_s", lambda: (
                    eval_loss(train_eval_loader, w_start),
                    eval_loss(val_loader, w_start),
                    moe_telemetry(shadow, val_loader, device,
                                  0 if cfg.eval_fixed else w_start, mesh)),
                    "eval_pause", w_start)
                if tele is not None:
                    tele.metrics.counter("evals").inc()
                logger.log(w_start, {"loss/train": train_loss,
                                     "loss/val": val_loss, **router})
                final.update({"train_loss": train_loss, "val_loss": val_loss})
            t_pf = time.perf_counter()
            xs, ys = prefetch.next()
            if k_disp == 1:
                xs, ys = xs[None], ys[None]
            xs, ys = xs[..., cols], ys[..., cols]
            t_launch = time.perf_counter()
            if tele is not None:
                tele.prefetch_wait(step=w_start, t=t_pf, dur=t_launch - t_pf)
                tele.emit("window_launch", step=w_start, t=t_launch, k=k_eff)
                tele.metrics.counter("windows_dispatched").inc()
                tele.metrics.counter("steps_completed").inc(k_eff)
            # debug: the second window (the first after the warm-up) under
            # the profiler
            profiler = (start_profiler() if cfg.debug and wi == 1 and rank0
                        else None)
            prog = dispatch(xs, ys, w_start, k_eff)
            del xs, ys
            if profiler is not None:
                stop_profiler(profiler, os.path.join(cfg.rundir, "profile"))
            dispatches += 1
            w_end = w_start + k_eff - 1
            last_step = w_end
            log_steps = [s for s in range(w_start, w_end + 1)
                         if s % cfg.log_interval == 0 and s > 0]
            if log_steps:
                # the window's one host read: every step's loss, grad norm
                # and lr, stacked
                rows = prog.read(k_eff)
                t_harvest = time.perf_counter()
                if tele is not None:
                    tele.emit("window_harvest", step=w_end, t=t_harvest,
                              k=k_eff)
                    tele.span("train_window", step=w_start, t=t_launch,
                              dur=t_harvest - t_launch, k=k_eff)
                for s_ in log_steps:
                    loss_v, gnorm_v, lr_v = (float(v)
                                             for v in rows[s_ - w_start])
                    metrics = {"loss/optimized": loss_v, "lr": lr_v,
                               "grad_norm": gnorm_v}
                    trips = monitors.observe_step(s_, loss_v, gnorm_v,
                                                  t=t_harvest)
                    if s_ == log_steps[-1]:
                        # host-clocked: one rate a window
                        tps = (tokens_per_step * (s_ - last_log_step)
                               / max(t_harvest - last_log_time, 1e-9))
                        last_log_time, last_log_step = t_harvest, s_
                        metrics["tokens_per_sec"] = tps
                        if device_name is not None:
                            metrics["mfu"] = mfu(tps, cfg.model, device_name,
                                                 mesh.world)
                        trips += monitors.observe_throughput(s_, tps,
                                                             t=t_harvest)
                    for trip in trips:
                        metrics[f"anomaly/{trip['kind']}"] = 1.0
                        say(f"ANOMALY {trip['kind']} at step {s_}: "
                            f"{trip['detail']}")
                    logger.log(s_, metrics)
                    final["loss"] = loss_v
            losses.append(prog.out[:k_eff, 0].clone())
            # under a mesh every rank stops at the window any rank was
            # signalled in: one host all-reduce a window, so no rank waits
            # in a collective the others left
            stop = bool(mesh.host_max(int(stop_requested["flag"])))
            # K=1 saves at interval steps, K > 1 at the JAX trainer's window
            # ends (forced: they are off the interval grid); debug saves
            # only at the end (or on SIGTERM, synchronously)
            if k_disp == 1:
                due = w_end % ckpt_every == 0
            else:
                due = ((wi == 0 and first_step == 0)
                       or (w_end + 1) % ckpt_every == 0)
            if stop or (not cfg.debug and due):
                checkpoint(w_end, force=stop or k_disp > 1)
            if stop:
                if tele is not None:
                    tele.emit("interrupt", step=w_end, t=time.perf_counter())
                say(f"SIGTERM: checkpointed step {w_end}, exiting")
                final["interrupted_at"] = w_end
                break
            w_start += k_eff
    finally:
        prefetch.stop()
        for prog in programs.values():
            # what one replay of the step's graph launched (kernels and,
            # under a mesh, collectives); {} where nothing was captured
            final["replay_launches"] = launch_counts.names(
                prog.replay_launches)
            prog.release()
    final["train_dispatches"] = dispatches

    if "interrupted_at" not in final:
        state.refresh(shadow)
        final["val_loss"] = timed(
            "eval_s", lambda: eval_loss(val_loader, cfg.max_steps),
            "eval_pause", cfg.max_steps)
        logger.log(cfg.max_steps, {"loss/val": final["val_loss"]})
        if (cfg.max_steps > first_step
                and mesh.host_broadcast(ckpt.latest_step())
                != cfg.max_steps - 1):
            checkpoint(cfg.max_steps - 1, force=True)
    timed("ckpt_wait_s", ckpt.close, "ckpt_wait", last_step + 1)
    sync()
    final["loop_s"] = time.perf_counter() - loop_t0
    # end to end: every trained token over the whole loop, evals and saves
    # included
    final["tokens_per_sec"] = (tokens_per_step * (last_step + 1 - first_step)
                               / final["loop_s"])
    if device_name is not None:
        final["mfu"] = mfu(final["tokens_per_sec"], cfg.model, device_name,
                           mesh.world)
    final["anomalies"] = len(monitors.trips)
    # every counted launch of the loop (steps, evals, saves), by wrapper
    final["launches"] = {k: v - counts0.get(k, 0)
                         for k, v in launch_counts.snapshot().items()
                         if v != counts0.get(k, 0)}
    if on_card:
        final["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    if tele is not None:
        tele.emit("run_end", step=last_step + 1, t=time.perf_counter())
        write_json(os.path.join(cfg.rundir, "train_timeline.json"),
                   chrome_trace_train(tele))
        tele.flight_dump("run_end", path=os.path.join(
            cfg.rundir, "train_telemetry.json"))
    logger.close()
    final["losses"] = torch.cat(losses).tolist() if losses else []
    final["first_step"] = first_step
    return final
