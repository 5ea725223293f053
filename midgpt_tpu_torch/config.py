"""Model and experiment configuration, and the named registries.

A copy of ``midgpt_tpu.config``'s ``ModelConfig`` (architecture fields
plus the knobs the port reads, ``attn_impl`` with ``"ring"`` and
``"ulysses"``, ``ring_schedule``, ``norm_impl`` and ``remat``), of its
``MeshConfig`` (all five axes, ``sizes`` with the ``-1`` rule,
``num_slices`` and the ``pp_*`` fields) and of the training fields of
its ``ExperimentConfig``, ``mesh``, ``debug``, ``train_telemetry`` and
``steps_per_dispatch`` included (with
:func:`resolve_dispatch_intervals`). The trainer runs every axis over
``torch.distributed`` (``parallel.mesh``): ``replica``, ``fsdp``,
``sequence``, ``tensor`` and ``pipeline`` (GPipe stages, with
``pp_microbatches`` and ``pp_boundary_dtype``), and ``num_slices > 1``
(data parallel across slices of contiguous ranks). ``MODEL_CONFIGS``
holds the model halves of the JAX package's named configs,
``get_config`` the experiments the port can train, each with JAX's mesh:
``openwebtext_xl``, ``llama_7b`` and ``openwebtext_moe`` (its experts
sharded over ``tensor``) run on ``fsdp=-1, tensor=4``, so they need a
world of four or more ranks, ``openwebtext_xl_multislice`` on
``replica=2, tensor=4`` over two slices (eight or more ranks), and
``openwebtext_mh`` is ``openwebtext`` at one microbatch of 2048 rows for
many hosts; without a process group the trainer runs any of them on one
card as the one-rank mesh.
"""

from __future__ import annotations

import dataclasses
import typing as tp


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Decoder-only transformer architecture (GPT / Llama family)."""

    block_size: int  # max sequence length
    vocab_size: int
    n_layer: int
    n_head: int
    n_embd: int
    dropout: float = 0.0
    n_kv_head: tp.Optional[int] = None  # None => MHA (= n_head); < n_head => GQA
    mlp: str = "gelu"  # "gelu" (GPT-2, 4x) | "swiglu" (Llama) | "moe"
    # (Switch-style top-1 mixture of GELU experts, models.gpt.MoEMLP)
    moe_experts: int = 8  # experts per MoE layer (mlp="moe")
    moe_top_k: int = 1  # experts per token: 1 = Switch, 2 = GShard-style
    # (renormalized top-2 gates; aux loss tracks first choices)
    # per-row capacity factor: C = ceil(cf * top_k * T / E) — K claims per
    # token share the expert buffers, so capacity scales with top_k
    # (models.gpt.MoEMLP.forward)
    moe_capacity: float = 1.25
    moe_aux_weight: float = 0.01  # load-balance aux loss weight (train)
    mlp_ratio: float = 4.0  # hidden = ratio * n_embd (swiglu: per-branch width)
    # exact hidden width; None = ratio * n_embd, with fractional products
    # rounded up to a multiple of 256 (models.gpt.mlp_hidden_dim)
    mlp_hidden: tp.Optional[int] = None
    rope_base: float = 10000.0
    qk_norm: bool = True  # per-head QK-LayerNorm
    tie_embeddings: bool = False  # True = one shared param; False = shared
    # init, independent params
    # "fused" = QK-LN + RoPE + attention from packed qkv (ops/fused_attn,
    # the CUDA kernels on the card); "naive" = the oracle; "auto" takes
    # fused for CUDA tensors and naive on the CPU, and ring under a mesh
    # whose sequence axis is above 1
    # ring = streaming K/V ring over 'sequence'; ulysses = all-to-all
    # head<->sequence trade (parallel/ulysses.py — exact attention +
    # exact dropout, needs H % S == 0 and tensor == 1)
    attn_impl: str = "auto"  # auto | naive | flash | ring | ulysses | fused
    ring_schedule: str = "zigzag"  # zigzag (balanced) | standard; zigzag
    # auto-falls back to standard when T doesn't divide 2*sequence
    # "fused" = the one-pass RMSNorm of ops/fused_norm (the CUDA kernels on
    # the card) where D % 128 == 0; "auto" and "jnp" = the plain chain (the
    # JAX package's names and meaning: its "auto" is the plain chain too)
    norm_impl: str = "auto"
    # "none" | "dots" (one selective checkpoint per block: the products
    # with no batch dimension are kept, the rest recomputed) | "full" (one
    # checkpoint per block) | "auto" (resolved by train.resolve_auto_knobs
    # from the card's memory)
    remat: str = "full"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head if self.n_kv_head is not None else self.n_head

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh axis sizes (the JAX package's). -1 on at most one axis
    means "all remaining devices". Axis roles:
      replica  - pure DP, gradients all-reduced
      fsdp     - DP + parameter/optimizer sharding (ZeRO-3)
      sequence - context parallelism (ring attention)
      tensor   - Megatron-style tensor parallelism (and the MoE
                 experts: expert parallelism)
      pipeline - GPipe stages; outermost axis
    The port runs all five (``parallel.mesh.create_mesh``). Under
    ``pipeline`` each data rank's microstep rows stream through the
    stages as ``pp_microbatches`` microbatches (0: JAX's auto rule over
    the rank's rows, ``parallel.pipeline.microbatches``), activations
    crossing stages in ``pp_boundary_dtype``. ``num_slices > 1`` needs
    ``replica % num_slices == 0`` and ``pipeline == 1``, as in JAX.
    """

    replica: int = 1
    fsdp: int = -1
    sequence: int = 1
    tensor: int = 1
    pipeline: int = 1
    # number of slices for hybrid meshes; 1 = single slice
    num_slices: int = 1
    # microbatches streamed through the pipeline per step; 0 = auto
    pp_microbatches: int = 0
    # dtype of activations crossing stage boundaries
    pp_boundary_dtype: str = "float32"

    @property
    def axis_names(self) -> tp.Tuple[str, ...]:
        return ("pipeline", "replica", "fsdp", "sequence", "tensor")

    def sizes(self, n_devices: int) -> tp.Tuple[int, ...]:
        sizes = [self.pipeline, self.replica, self.fsdp, self.sequence,
                 self.tensor]
        if -1 in sizes:
            known = 1
            for s in sizes:
                if s != -1:
                    known *= s
            assert n_devices % known == 0, (
                f"cannot infer -1 axis: {n_devices} devices, fixed product "
                f"{known}"
            )
            sizes[sizes.index(-1)] = n_devices // known
        total = 1
        for s in sizes:
            total *= s
        assert total == n_devices, (
            f"mesh {sizes} does not cover {n_devices} devices"
        )
        return tuple(sizes)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """A training run (the JAX package's fields and defaults, less
    ``loss_chunk_unroll`` and ``use_wandb``). ``batch_size`` is the
    global batch: each rank of a mesh takes ``batch_size // (G *
    world)`` rows a microbatch."""

    model: ModelConfig
    rundir: str = ""
    data_dir: str = ""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    min_lr: float = 3e-5
    lr_decay_steps: int = 5000
    max_steps: int = 5000
    batch_size: int = 32  # sequences per optimizer step, incl. accumulation
    g_accum_iters: int = 1
    # optimizer steps a train dispatch runs (train.get_train_window: K
    # replays of the step's CUDA graph with no host read between them).
    # 1 = one dispatch a step. K > 1 needs eval and ckpt intervals that
    # are multiples of K (resolve_dispatch_intervals) and holds a K-deep
    # batch window on the card.
    steps_per_dispatch: int = 1
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    independent_wd: bool = True  # decay by wd / lr (False: by wd)
    eval_interval: int = 1000
    eval_batches: int = 200
    eval_fixed: bool = False  # the same eval batches every interval
    log_interval: int = 20
    ckpt_interval: tp.Optional[int] = None  # None => eval_interval
    ckpt_keep: int = 1
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    seed: int = 0
    data_seed: int = 1234
    loss_chunk: tp.Optional[int] = None  # T-chunked cross-entropy
    device: str = "cuda"  # "cpu" runs the plain versions of the kernels
    # one eval batch, no saves in the loop, a synchronous save at the end,
    # and the first step after the warm-up one under torch.profiler
    debug: bool = False
    # the loop's lifecycle tracing (midgpt_tpu_torch.train_telemetry):
    # prefetch waits, steps, evals and saves as events and spans, written
    # to train_timeline.json and train_telemetry.json in the rundir. The
    # anomaly monitors run either way.
    train_telemetry: bool = False
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)

    @property
    def microbatch_size(self) -> int:
        assert self.batch_size % self.g_accum_iters == 0
        return self.batch_size // self.g_accum_iters


def resolve_dispatch_intervals(cfg: ExperimentConfig) -> ExperimentConfig:
    """Check the interval knobs against ``steps_per_dispatch`` (the JAX
    package's rule and messages).

    With K steps a dispatch the host sees the train state only at window
    boundaries (multiples of K), so eval sweeps and checkpoint saves must
    land on the K grid; a misaligned explicit interval raises here.
    ``log_interval`` needs no alignment (per-step loss, grad norm and lr
    come back stacked), ``ckpt_interval=None`` resolves to
    ``eval_interval``, and ``max_steps`` need not divide by K (the last
    window is shorter). K=1 returns ``cfg`` itself."""
    k = cfg.steps_per_dispatch
    if k == 1:
        return cfg
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")

    def _aligned(name: str, value: int) -> None:
        if value % k != 0:
            lo, hi = (value // k) * k, -(-value // k) * k
            suggestion = f"{hi}" if lo == 0 else f"{lo} or {hi}"
            raise ValueError(
                f"{name}={value} is not divisible by steps_per_dispatch={k}: "
                f"the fused window only exposes the train state every {k} "
                f"steps, so the {name.split('_')[0]} cadence would silently "
                f"skew to window boundaries. Set {name} to a multiple of {k} "
                f"(e.g. {suggestion}) or change steps_per_dispatch."
            )

    _aligned("eval_interval", cfg.eval_interval)
    if cfg.ckpt_interval is not None:
        _aligned("ckpt_interval", cfg.ckpt_interval)
    return cfg


def window_plan(first_step: int, max_steps: int, k: int) -> tp.List[int]:
    """The window sizes of the dispatches covering steps ``[first_step,
    max_steps)``, aligned to the absolute K grid: a resume off the grid
    takes a shorter first window, an off-grid ``max_steps`` a shorter last
    one; ``ceil(steps / K)`` dispatches in the steady state."""
    if k < 1:
        raise ValueError(f"window length must be >= 1, got {k}")
    plan = []
    s = first_step
    while s < max_steps:
        w = min(k - (s % k), max_steps - s)
        plan.append(w)
        s += w
    return plan


def to_dict(cfg: tp.Any) -> tp.Any:
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def _from_dict(cls: type, data: tp.Mapping[str, tp.Any]) -> tp.Any:
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - names)
    if unknown:
        raise ValueError(f"{cls.__name__} has no field {unknown[0]!r} "
                         f"(unknown keys: {unknown})")
    hints = tp.get_type_hints(cls)
    return cls(**{
        k: _from_dict(hints[k], v) if dataclasses.is_dataclass(hints[k])
        else v for k, v in data.items()})


def from_dict(data: tp.Mapping[str, tp.Any]) -> ExperimentConfig:
    """The ``ExperimentConfig`` of a :func:`to_dict` dict, such as the
    ``config.json`` that ``launch`` writes into a run directory. A key the
    port's config lacks raises ``ValueError`` naming it."""
    return _from_dict(ExperimentConfig, data)


# The model halves of the JAX package's named experiment configs.
MODEL_CONFIGS: tp.Dict[str, ModelConfig] = {
    # GPT-2-small 124M
    "openwebtext": ModelConfig(
        block_size=1024, vocab_size=50304, n_layer=12, n_head=12, n_embd=768,
        remat="auto",
    ),
    # GPT-2-XL 1.5B
    "openwebtext_xl": ModelConfig(
        block_size=1024, vocab_size=50304, n_layer=24, n_head=16, n_embd=2048,
        attn_impl="auto", remat="auto",
    ),
    # openwebtext with a Switch MoE MLP: 8 experts per layer, ~558M
    # parameters, ~124M active per token
    "openwebtext_moe": ModelConfig(
        block_size=1024, vocab_size=50304, n_layer=12, n_head=12, n_embd=768,
        remat="auto", mlp="moe", moe_experts=8, moe_capacity=1.25,
    ),
    # char-level tiny GPT
    "shakespeare_char": ModelConfig(
        block_size=256, vocab_size=65, n_layer=6, n_head=6, n_embd=384,
        dropout=0.2,
    ),
    # Llama-style 7B: SwiGLU + GQA
    "llama_7b": ModelConfig(
        block_size=2048, vocab_size=50304, n_layer=32, n_head=32,
        n_kv_head=8, n_embd=4096, mlp="swiglu", mlp_ratio=8 / 3,
        remat="auto",
    ),
    # minutes-scale config for tests and smoke runs
    "tiny": ModelConfig(
        block_size=64, vocab_size=256, n_layer=2, n_head=2, n_embd=64,
        attn_impl="naive",
    ),
}


def get_model_config(name: str) -> ModelConfig:
    if name not in MODEL_CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; known: {sorted(MODEL_CONFIGS)}"
        )
    return MODEL_CONFIGS[name]


# The training halves of the JAX package's named experiment configs (the
# JAX package's ``midgpt_tpu/configs``), with their meshes.
_OPENWEBTEXT = dict(
    data_dir="data/openwebtext",
    learning_rate=1e-3, min_lr=1e-5, warmup_steps=5000,
    lr_decay_steps=60000, max_steps=60000,
    batch_size=2048, g_accum_iters=16,
    beta2=0.95, weight_decay=1e-4,
    eval_interval=1000, eval_fixed=True, loss_chunk=256,
)
# FSDP x TP: the JAX configs' tensor=4 mesh
_TENSOR4 = MeshConfig(replica=1, fsdp=-1, sequence=1, tensor=4)
_OPENWEBTEXT_XL = dict(
    data_dir="/mnt/disks/persist/openwebtext",
    learning_rate=1e-3, min_lr=1e-5, warmup_steps=2500,
    lr_decay_steps=25000, max_steps=25000,
    batch_size=1024, g_accum_iters=1,
    beta2=0.95, weight_decay=1e-4,
    eval_interval=1000, eval_fixed=True, loss_chunk=512,
    mesh=_TENSOR4,
)
# experiments that train another experiment's model
_MODEL_OF = {"openwebtext_mh": "openwebtext",
             "openwebtext_xl_multislice": "openwebtext_xl"}
_EXPERIMENTS: tp.Dict[str, tp.Dict[str, tp.Any]] = {
    "openwebtext": _OPENWEBTEXT,
    # JAX's multihost 124M: one microbatch of the same 2048 rows
    "openwebtext_mh": dict(_OPENWEBTEXT, batch_size=2048, g_accum_iters=1,
                           data_dir="/mnt/disks/persist/openwebtext"),
    # the JAX config replaces the model and the mesh: the experts shard
    # over tensor=4 (expert parallelism)
    "openwebtext_moe": dict(_OPENWEBTEXT, mesh=_TENSOR4),
    "openwebtext_xl": _OPENWEBTEXT_XL,
    # data parallel across two slices (replica=2 over them), FSDP x TP
    # inside each
    "openwebtext_xl_multislice": dict(
        _OPENWEBTEXT_XL, mesh=MeshConfig(replica=2, fsdp=-1, sequence=1,
                                         tensor=4, num_slices=2)),
    "llama_7b": dict(
        data_dir="/mnt/disks/persist/openwebtext",
        learning_rate=3e-4, min_lr=3e-5, warmup_steps=2000,
        lr_decay_steps=50000, max_steps=50000,
        batch_size=512, g_accum_iters=1,
        beta2=0.95, weight_decay=1e-4,
        eval_interval=1000, eval_fixed=True, loss_chunk=512,
        mesh=_TENSOR4,
    ),
    "shakespeare_char": dict(
        data_dir="data/shakespeare_char",
        learning_rate=1e-3, min_lr=1e-4, warmup_steps=100,
        lr_decay_steps=5000, max_steps=5000,
        batch_size=64, g_accum_iters=1,
        beta2=0.99, weight_decay=1e-4,
        eval_interval=2000,
    ),
    "tiny": dict(
        data_dir="",
        learning_rate=1e-3, min_lr=1e-4, warmup_steps=10,
        lr_decay_steps=100, max_steps=100,
        batch_size=8, g_accum_iters=2,
        beta2=0.99, weight_decay=1e-4,
        eval_interval=50, eval_batches=4, log_interval=10,
    ),
}


def get_config(name: str, **overrides) -> ExperimentConfig:
    """A fresh ``ExperimentConfig`` for a named experiment."""
    if name not in _EXPERIMENTS:
        raise KeyError(
            f"unknown experiment {name!r}; known: {sorted(_EXPERIMENTS)}"
        )
    cfg = ExperimentConfig(model=MODEL_CONFIGS[_MODEL_OF.get(name, name)],
                           **_EXPERIMENTS[name])
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
