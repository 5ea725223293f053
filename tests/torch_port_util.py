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
    jcfg = JaxModelConfig(**{"attn_impl": "naive", "remat": "none",
                             **cfg_kw})
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


def assert_pages_home(eng) -> None:
    """After an engine drains: no page held, the allocator and the prefix
    index consistent, and every cold cached page reclaimable, so clearing
    the cache returns the whole pool to the free list."""
    assert eng.alloc.held_pages == 0
    eng.alloc.check()
    if eng.index is not None:
        eng.index.check(eng.alloc)
    cached = eng.alloc.cached_pages
    assert eng.clear_prefix_cache() == cached
    assert eng.alloc.free_pages == eng.alloc.num_pages


def check_engines(cl) -> None:
    """The allocator and prefix-index invariants (with the spill store) on
    every live engine of a cluster."""
    for i in cl._alive():
        e = cl.engines[i]
        e.alloc.check()
        if e.index is not None:
            e.index.check(e.alloc, e._spill_store)


def assert_clusters_agree(cl, jc) -> None:
    """The port's cluster and JAX's in the same state: every request's
    replica and engine id, the records between pools, health and its
    reasons, and every ``stats()`` key (per replica included)."""
    assert cl._route == jc._route
    assert sorted(cl._handoff) == sorted(jc._handoff)
    assert cl.health == jc.health
    assert cl.health_reason == jc.health_reason
    a, b = cl.stats(), jc.stats()
    assert tuple(a) == tuple(b)
    assert a == b, {k: (a[k], b[k]) for k in a if a[k] != b[k]}


def cluster_lockstep(cl, jc, max_steps: int = 400) -> int:
    """Step both clusters until both drain, checking every live engine's
    invariants on both sides and the two clusters' agreement after every
    step; returns the steps taken."""
    for n in range(max_steps):
        if not (cl.has_work or jc.has_work):
            return n
        cl.step()
        jc.step()
        check_engines(cl)
        for i in jc._alive():
            e = jc.engines[i]
            e.alloc.check()
            if e.index is not None:
                e.index.check(e.alloc, e._spill_store)
        assert_clusters_agree(cl, jc)
    raise AssertionError(f"the clusters did not drain in {max_steps} steps")


def cluster_streams(cl, rids):
    """Each finished request's tokens, in ``rids``' order."""
    cl._harvest()
    return [[int(x) for x in cl.finished[r].tokens] for r in rids]
