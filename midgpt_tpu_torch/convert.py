"""Weights bridge between the JAX package's ``GPT`` parameters and the
port's ``GPT``, both ways.

The JAX side is a flat ``{path: np.ndarray}`` dict with the JAX pytree's
field paths as keys (``midgpt_tpu.pytree.tree_paths``), for example
``"wte/weight"``, ``"blocks/attn/wqkv/weight"`` (stacked ``[L, D, ...]``)
or ``"lm_head/weight"``. The port never touches a JAX object: the caller
builds the dict. Block leaves are unstacked per layer; ``Linear`` weights
keep their ``[in, out]`` layout; weightless norms (``ln1``, ``ln2``,
``ln_f``) have no entry; ``lm_head`` is absent for a tied model and
``w_gate`` for a GELU MLP.

A quantized JAX model (``midgpt_tpu.quant.quantize_model``) has, for every
projection, ``.../weight`` int8 and ``.../scale`` f32 (per output channel,
stacked ``[L, out]`` for block leaves), and always a quantized
``lm_head``; it converts to ``QuantLinear`` s holding the same codes and
scales.
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
from midgpt_tpu_torch.quant import QuantLinear
from midgpt_tpu_torch.utils.platform import resolve_device


def gpt_from_jax_params(
    params: tp.Mapping[str, np.ndarray],
    cfg: ModelConfig,
    device: tp.Union[None, str, torch.device] = None,
    dtype: torch.dtype = torch.float32,
) -> GPT:
    """Build the port's ``GPT`` from a JAX parameter dict, full precision
    or quantized (``.../scale`` entries beside int8 weights). Raises on a
    missing, misshapen or unknown entry. ``dtype`` applies to the float
    parameters; int8 codes and their f32 scales stay as they are."""
    device = resolve_device(device)
    left = dict(params)
    quant = "lm_head/scale" in left

    def take(path: str, shape: tp.Tuple[int, ...],
             dtype=np.float32) -> torch.Tensor:
        if path not in left:
            raise KeyError(f"missing parameter {path!r}")
        a = np.asarray(left.pop(path))
        if dtype == np.int8 and a.dtype != np.int8:
            raise ValueError(f"{path}: {a.dtype}, expected int8")
        a = a.astype(dtype)
        if a.shape != shape:
            raise ValueError(f"{path}: shape {a.shape}, expected {shape}")
        return torch.from_numpy(a.copy())

    def proj(path: str, shape: tp.Tuple[int, ...]):
        """A projection's weight ``[L, in, out]`` or ``[in, out]``, with
        its scales ``[L, out]`` / ``[out]`` when quantized."""
        if not quant:
            return take(f"{path}/weight", shape)
        return (take(f"{path}/weight", shape, np.int8),
                take(f"{path}/scale", shape[:-2] + shape[-1:]))

    def linear(w, i=None):  # layer i of a stacked projection, or all of it
        if w is None:
            return None
        if quant:
            q, sc = w if i is None else (w[0][i], w[1][i])
            return QuantLinear(q, sc)
        return Linear(w if i is None else w[i])

    nl, d, h = cfg.n_layer, cfg.n_embd, cfg.n_head
    c, hkv = cfg.head_dim, cfg.kv_heads
    f = mlp_hidden_dim(cfg)
    wqkv = proj("blocks/attn/wqkv", (nl, d, (h + 2 * hkv) * c))
    wo = proj("blocks/attn/wo", (nl, h * c, d))
    qn = take("blocks/attn/q_norm/weight", (nl, c)) if cfg.qk_norm else None
    kn = take("blocks/attn/k_norm/weight", (nl, c)) if cfg.qk_norm else None
    w_up = proj("blocks/mlp/w_up", (nl, d, f))
    w_down = proj("blocks/mlp/w_down", (nl, f, d))
    w_gate = (
        proj("blocks/mlp/w_gate", (nl, d, f))
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
            linear(wqkv, i), linear(wo, i), norm(qn, i), norm(kn, i), h, hkv,
            cfg.dropout,
        )
        mlp = MLP(linear(w_up, i), linear(w_down, i), linear(w_gate, i),
                  cfg.dropout)
        blocks.append(Block(attn, mlp, d, cfg.norm_impl))
    wte = Embedding(take("wte/weight", (cfg.vocab_size, d)))
    # a quantized model always carries its head, tied or not
    lm_head = (
        None if cfg.tie_embeddings and not quant
        else linear(proj("lm_head", (d, cfg.vocab_size)))
    )
    if left:
        raise ValueError(f"unconverted parameters: {sorted(left)}")
    return GPT(cfg, wte, blocks, lm_head).to(device=device, dtype=dtype)


def jax_params_from_gpt(model: GPT) -> tp.Dict[str, np.ndarray]:
    """The inverse of :func:`gpt_from_jax_params`: the port's parameters
    as a flat ``{path: np.ndarray}`` dict in the JAX pytree's paths and
    layouts (block leaves stacked ``[L, ...]``), as f32."""

    def arr(p: torch.Tensor) -> np.ndarray:  # a copy, never a view
        return np.array(p.detach().to(device="cpu", dtype=torch.float32))

    def stacked(get) -> np.ndarray:
        return np.stack([arr(get(blk)) for blk in model.blocks])

    cfg = model.config
    out = {
        "wte/weight": arr(model.wte.weight),
        "blocks/attn/wqkv/weight": stacked(lambda b: b.attn.wqkv.weight),
        "blocks/attn/wo/weight": stacked(lambda b: b.attn.wo.weight),
        "blocks/mlp/w_up/weight": stacked(lambda b: b.mlp.w_up.weight),
        "blocks/mlp/w_down/weight": stacked(lambda b: b.mlp.w_down.weight),
    }
    if cfg.qk_norm:
        out["blocks/attn/q_norm/weight"] = stacked(
            lambda b: b.attn.q_norm.weight)
        out["blocks/attn/k_norm/weight"] = stacked(
            lambda b: b.attn.k_norm.weight)
    if cfg.mlp == "swiglu":
        out["blocks/mlp/w_gate/weight"] = stacked(lambda b: b.mlp.w_gate.weight)
    if model.lm_head is not None:
        out["lm_head/weight"] = arr(model.lm_head.weight)
    return out
