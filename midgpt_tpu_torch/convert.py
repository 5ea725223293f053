"""Weights bridge between the JAX package's ``GPT`` parameters and the
port's ``GPT``, both ways.

The JAX side is a flat ``{path: np.ndarray}`` dict with the JAX pytree's
field paths as keys (``midgpt_tpu.pytree.tree_paths``), for example
``"wte/weight"``, ``"blocks/attn/wqkv/weight"`` (stacked ``[L, D, ...]``)
or ``"lm_head/weight"``. The port never touches a JAX object: the caller
builds the dict. Block leaves are unstacked per layer; ``Linear`` weights
keep their ``[in, out]`` layout; weightless norms (``ln1``, ``ln2``,
``ln_f``) have no entry; ``lm_head`` is absent for a tied model and
``w_gate`` for a GELU MLP. An MoE MLP (``mlp="moe"``) has
``blocks/mlp/router/weight [L, D, E]``, ``blocks/mlp/expert_up
[L, E, D, F]`` and ``blocks/mlp/expert_down [L, E, F, D]`` in place of
the dense MLP's weights.

Under a tensor axis :func:`gpt_from_jax_params` gives a tensor rank's
model (``tensor``: its held shards, ``GPT.shard_tensor_``), and
:func:`jax_params_from_gpt` puts full tensors back together from every
tensor index's shards (one model holding them all, or one model an
index), so the dict is always JAX's full layout.

A quantized JAX model (``midgpt_tpu.quant.quantize_model``) has, for every
projection, ``.../weight`` int8 and ``.../scale`` f32 (per output channel,
stacked ``[L, out]`` for block leaves), and always a quantized
``lm_head``; it converts to ``QuantLinear`` s holding the same codes and
scales. The JAX package does not quantize an MoE model, and a quantized
MoE dict is refused here too.
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
    MoEMLP,
    mlp_hidden_dim,
)
from midgpt_tpu_torch.models.layers import Embedding, LayerNorm, Linear
from midgpt_tpu_torch.parallel.sharding import tensor_dim, tensor_unshard
from midgpt_tpu_torch.parallel.tensor import TensorExchange, held_shard
from midgpt_tpu_torch.quant import QuantLinear
from midgpt_tpu_torch.utils.platform import resolve_device


def gpt_from_jax_params(
    params: tp.Mapping[str, np.ndarray],
    cfg: ModelConfig,
    device: tp.Union[None, str, torch.device] = None,
    dtype: torch.dtype = torch.float32,
    tensor: tp.Optional[TensorExchange] = None,
) -> GPT:
    """Build the port's ``GPT`` from a JAX parameter dict, full precision
    or quantized (``.../scale`` entries beside int8 weights). Raises on a
    missing, misshapen or unknown entry. ``dtype`` applies to the float
    parameters; int8 codes and their f32 scales stay as they are.
    ``tensor``: the model of a tensor rank, holding ``tensor.held``'s
    shards (an int8 model's per rank codes and scales as
    ``quant.shard_quant_linear`` cuts them)."""
    device = resolve_device(device)
    left = dict(params)
    quant = "lm_head/scale" in left
    moe = cfg.mlp == "moe"
    if moe and quant:
        raise ValueError("a quantized MoE model: the JAX package's "
                         "quantize_model refuses MoE models")

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
    if moe:
        e = cfg.moe_experts
        router = take("blocks/mlp/router/weight", (nl, d, e))
        up = take("blocks/mlp/expert_up", (nl, e, d, f))
        down = take("blocks/mlp/expert_down", (nl, e, f, d))
    else:
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
        if moe:
            mlp = MoEMLP(Linear(router[i]), up[i], down[i], cfg.moe_capacity,
                         cfg.moe_top_k, cfg.dropout)
        else:
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
    model = GPT(cfg, wte, blocks, lm_head)
    if tensor is not None:
        # a quantized model's codes are cut from the whole ones, so each
        # rank's are a slice of the unsharded model's, bit for bit
        model.shard_tensor_(tensor)
    return model.to(device=device, dtype=dtype)


def full_state_dict(models: tp.Union[GPT, tp.Sequence[GPT]]
                    ) -> tp.Dict[str, torch.Tensor]:
    """Full tensors by name from a model, or from tensor shards: one model
    holding every tensor index's shards, or one model an index (together
    covering each once)."""
    if isinstance(models, GPT):
        models = [models]
    ex = models[0].tensor
    if ex is None:
        return dict(models[0].state_dict())
    cfg = models[0].config
    out = {}
    for name in models[0].state_dict():
        dim = tensor_dim(name)
        if dim is None:
            out[name] = models[0].state_dict()[name]
            continue
        by_index = {}
        for m in models:
            w = m.state_dict()[name]
            # int8 codes hold their shards stacked along rows
            # (quant.shard_quant_linear)
            cut = -2 if w.dtype == torch.int8 else dim
            for j, r in enumerate(m.tensor.held):
                by_index[r] = held_shard(w, j, m.tensor, cut)
        if sorted(by_index) != list(range(ex.size)):
            raise ValueError(f"{name}: shards {sorted(by_index)} of "
                             f"{ex.size}")
        out[name] = tensor_unshard(name, [by_index[r]
                                          for r in range(ex.size)], cfg)
    return out


def jax_params_from_gpt(models: tp.Union[GPT, tp.Sequence[GPT]]
                        ) -> tp.Dict[str, np.ndarray]:
    """The inverse of :func:`gpt_from_jax_params`: the port's parameters
    (of one model, or put back together from tensor shards,
    :func:`full_state_dict`) as a flat ``{path: np.ndarray}`` dict in the
    JAX pytree's paths and layouts (block leaves stacked ``[L, ...]``),
    as f32."""
    sd = full_state_dict(models)
    cfg = (models if isinstance(models, GPT) else models[0]).config

    def arr(p: torch.Tensor) -> np.ndarray:  # a copy, never a view
        return np.array(p.detach().to(device="cpu", dtype=torch.float32))

    def stacked(leaf: str) -> np.ndarray:
        return np.stack([arr(sd[f"blocks.{i}.{leaf}"])
                         for i in range(cfg.n_layer)])

    out = {
        "wte/weight": arr(sd["wte.weight"]),
        "blocks/attn/wqkv/weight": stacked("attn.wqkv.weight"),
        "blocks/attn/wo/weight": stacked("attn.wo.weight"),
    }
    if cfg.mlp == "moe":
        out["blocks/mlp/router/weight"] = stacked("mlp.router.weight")
        out["blocks/mlp/expert_up"] = stacked("mlp.expert_up")
        out["blocks/mlp/expert_down"] = stacked("mlp.expert_down")
    else:
        out["blocks/mlp/w_up/weight"] = stacked("mlp.w_up.weight")
        out["blocks/mlp/w_down/weight"] = stacked("mlp.w_down.weight")
    if cfg.qk_norm:
        out["blocks/attn/q_norm/weight"] = stacked("attn.q_norm.weight")
        out["blocks/attn/k_norm/weight"] = stacked("attn.k_norm.weight")
    if cfg.mlp == "swiglu":
        out["blocks/mlp/w_gate/weight"] = stacked("mlp.w_gate.weight")
    if "lm_head.weight" in sd:
        out["lm_head/weight"] = arr(sd["lm_head.weight"])
    return out
