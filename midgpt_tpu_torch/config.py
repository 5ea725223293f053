"""Model and experiment configuration, and the named registries.

A copy of ``midgpt_tpu.config``'s ``ModelConfig`` (architecture fields
plus the knobs the port reads, ``attn_impl``, ``norm_impl`` and
``remat``) and of the training fields of its ``ExperimentConfig``; the
mesh, multi-host, dispatch-window and telemetry knobs have no meaning on
one card and are left out. ``MODEL_CONFIGS`` holds the model halves of
the JAX package's named configs, ``get_config`` the experiments the port
can train.
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
    mlp: str = "gelu"  # "gelu" (GPT-2, 4x) | "swiglu" (Llama)
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
    # fused for CUDA tensors and naive on the CPU
    attn_impl: str = "auto"
    # "fused" = the one-pass RMSNorm of ops/fused_norm (the CUDA kernels on
    # the card) where D % 128 == 0; "auto" and "jnp" = the plain chain (the
    # JAX package's names and meaning: its "auto" is the plain chain too)
    norm_impl: str = "auto"
    # "none" | "full" (one checkpoint per block) | "auto" (resolved by
    # train.resolve_auto_knobs from the card's memory)
    remat: str = "full"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head if self.n_kv_head is not None else self.n_head

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """A training run on one card (the JAX package's fields, same
    defaults, where they apply to one card)."""

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
    beta1: float = 0.9
    beta2: float = 0.95
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
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

    @property
    def microbatch_size(self) -> int:
        assert self.batch_size % self.g_accum_iters == 0
        return self.batch_size // self.g_accum_iters


def to_dict(cfg: tp.Any) -> tp.Any:
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


# The model halves of the JAX package's named experiment configs.
MODEL_CONFIGS: tp.Dict[str, ModelConfig] = {
    # GPT-2-small 124M
    "openwebtext": ModelConfig(
        block_size=1024, vocab_size=50304, n_layer=12, n_head=12, n_embd=768,
        remat="auto",
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


# The training halves of the JAX package's named experiment configs that
# run on one card (the JAX package's ``midgpt_tpu/configs``).
_EXPERIMENTS: tp.Dict[str, tp.Dict[str, tp.Any]] = {
    "openwebtext": dict(
        data_dir="data/openwebtext",
        learning_rate=1e-3, min_lr=1e-5, warmup_steps=5000,
        lr_decay_steps=60000, max_steps=60000,
        batch_size=2048, g_accum_iters=16,
        beta2=0.95, weight_decay=1e-4,
        eval_interval=1000, eval_fixed=True, loss_chunk=256,
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
    cfg = ExperimentConfig(model=MODEL_CONFIGS[name], **_EXPERIMENTS[name])
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
