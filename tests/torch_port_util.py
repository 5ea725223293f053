"""Shared setup for the ``test_torch_*`` files: one model, two packages.

``model_pair`` builds a JAX ``GPT`` and the port's ``GPT`` holding the
same weights, drawn with NumPy from a seed: the JAX model's leaves are
replaced by the NumPy draws, and the port's model is built from the same
arrays through ``midgpt_tpu_torch.convert``. ``gain`` widens the weights
beyond the init scale so a random model's greedy streams are not one
repeated token.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from midgpt_tpu.config import ModelConfig as JaxModelConfig
from midgpt_tpu.models.gpt import GPT as JaxGPT
from midgpt_tpu.pytree import tree_paths
from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.convert import gpt_from_jax_params

# 2 layers, narrow; MHA with GELU, and GQA with SwiGLU
MHA = dict(block_size=64, vocab_size=96, n_layer=2, n_head=4, n_embd=64)
GQA = dict(MHA, n_kv_head=2, mlp="swiglu")


def numpy_params(jax_model, seed: int, gain: float):
    """``{path: array}`` drawn from ``seed`` in the model's shapes."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in tree_paths(jax_model):
        shape = leaf.shape
        if path.endswith("norm/weight"):
            a = 1.0 + 0.2 * rng.standard_normal(shape)
        elif path == "wte/weight":
            a = gain * rng.standard_normal(shape) / math.sqrt(shape[-1])
        else:  # Linear weights [.., in, out]
            a = gain * rng.standard_normal(shape) / math.sqrt(shape[-2])
        out[path] = a.astype(np.float32)
    return out


def model_pair(cfg_kw=MHA, seed: int = 0, gain: float = 2.0):
    """(jax_model, torch_model, params) with identical weights, f32, CPU."""
    jcfg = JaxModelConfig(**cfg_kw, attn_impl="naive", remat="none")
    jm = JaxGPT.init(jax.random.PRNGKey(seed), jcfg)
    params = numpy_params(jm, seed, gain)
    leaves = [jnp.asarray(params[p]) for p, _ in tree_paths(jm)]
    jm = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jm), leaves)
    tm = gpt_from_jax_params(params, ModelConfig(**cfg_kw), device="cpu")
    return jm, tm, params


def t(a, dtype=None) -> torch.Tensor:
    """A NumPy/JAX array as a CPU tensor (copied)."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The bf16 spacing at each element's magnitude."""
    mag = np.maximum(np.abs(x.astype(np.float32)), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)
