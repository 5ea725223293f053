"""Model configuration and the named model registry.

A copy of ``midgpt_tpu.config.ModelConfig`` (architecture fields only;
the training, mesh and kernel knobs of the JAX package's experiment
config have no meaning in the serving slice) and of the model half of
``midgpt_tpu.configs``: the named configurations the port can build.
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

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head if self.n_kv_head is not None else self.n_head

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head


# The model halves of the JAX package's named experiment configs.
MODEL_CONFIGS: tp.Dict[str, ModelConfig] = {
    # GPT-2-small 124M
    "openwebtext": ModelConfig(
        block_size=1024, vocab_size=50304, n_layer=12, n_head=12, n_embd=768,
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
    ),
    # minutes-scale config for tests and smoke runs
    "tiny": ModelConfig(
        block_size=64, vocab_size=256, n_layer=2, n_head=2, n_embd=64,
    ),
}


def get_model_config(name: str) -> ModelConfig:
    if name not in MODEL_CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; known: {sorted(MODEL_CONFIGS)}"
        )
    return MODEL_CONFIGS[name]
