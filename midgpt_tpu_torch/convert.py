"""Weights bridge: the JAX package's ``GPT`` parameters -> the port's ``GPT``.

The input is a flat ``{path: np.ndarray}`` dict with the JAX pytree's
field paths as keys (``midgpt_tpu.pytree.tree_paths``), for example
``"wte/weight"``, ``"blocks/attn/wqkv/weight"`` (stacked ``[L, D, ...]``)
or ``"lm_head/weight"``. The port never touches a JAX object: the caller
builds the dict. Block leaves are unstacked per layer; ``Linear`` weights
keep their ``[in, out]`` layout; weightless norms (``ln1``, ``ln2``,
``ln_f``) have no entry; ``lm_head`` is absent for a tied model and
``w_gate`` for a GELU MLP.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.models.gpt import (
    GPT,
    MLP,
    Attention,
    Block,
    mlp_hidden_dim,
)
from midgpt_tpu_torch.models.layers import Embedding, LayerNorm, Linear
from midgpt_tpu_torch.utils.platform import resolve_device


def gpt_from_jax_params(
    params: tp.Mapping[str, np.ndarray],
    cfg: ModelConfig,
    device: tp.Union[None, str, torch.device] = None,
    dtype: torch.dtype = torch.float32,
) -> GPT:
    """Build the port's ``GPT`` from a JAX parameter dict. Raises on a
    missing, misshapen or unknown entry."""
    device = resolve_device(device)
    left = dict(params)

    def take(path: str, shape: tp.Tuple[int, ...]) -> torch.Tensor:
        if path not in left:
            raise KeyError(f"missing parameter {path!r}")
        a = np.asarray(left.pop(path), dtype=np.float32)
        if a.shape != shape:
            raise ValueError(f"{path}: shape {a.shape}, expected {shape}")
        return torch.from_numpy(a.copy())

    nl, d, h = cfg.n_layer, cfg.n_embd, cfg.n_head
    c, hkv = cfg.head_dim, cfg.kv_heads
    f = mlp_hidden_dim(cfg)
    wqkv = take("blocks/attn/wqkv/weight", (nl, d, (h + 2 * hkv) * c))
    wo = take("blocks/attn/wo/weight", (nl, h * c, d))
    qn = take("blocks/attn/q_norm/weight", (nl, c)) if cfg.qk_norm else None
    kn = take("blocks/attn/k_norm/weight", (nl, c)) if cfg.qk_norm else None
    w_up = take("blocks/mlp/w_up/weight", (nl, d, f))
    w_down = take("blocks/mlp/w_down/weight", (nl, f, d))
    w_gate = (
        take("blocks/mlp/w_gate/weight", (nl, d, f))
        if cfg.mlp == "swiglu" else None
    )

    def norm(w: tp.Optional[torch.Tensor], i: int) -> tp.Optional[LayerNorm]:
        if w is None:
            return None
        ln = LayerNorm(c, eps=1e-6)
        ln.weight.data.copy_(w[i])
        return ln

    blocks = []
    for i in range(nl):
        attn = Attention(
            Linear(wqkv[i]), Linear(wo[i]), norm(qn, i), norm(kn, i), h, hkv
        )
        mlp = MLP(Linear(w_up[i]), Linear(w_down[i]),
                  Linear(w_gate[i]) if w_gate is not None else None)
        blocks.append(Block(attn, mlp, d))
    wte = Embedding(take("wte/weight", (cfg.vocab_size, d)))
    lm_head = (
        None if cfg.tie_embeddings
        else Linear(take("lm_head/weight", (d, cfg.vocab_size)))
    )
    if left:
        raise ValueError(f"unconverted parameters: {sorted(left)}")
    return GPT(cfg, wte, blocks, lm_head).to(device=device, dtype=dtype)
