"""The port's model paths against the JAX package's, with converted weights.

A 2-layer model (MHA + GELU, and GQA + SwiGLU) gets the same weights in
both packages (``torch_port_util.model_pair``) and the same paged state,
drawn with NumPy from a seed. Checked in f32:

- ``decode_step_paged``: logits and the recent rows it writes;
- ``prefill_chunk_paged``: hidden states and per-layer K/V of a fresh
  prompt (the JAX function at start 0), one page long and longer;
- ``flush_recent`` and ``write_token_rows``: pool contents bit for bit
  (they only move bytes; the port filters invalid rows where JAX drops
  them at the sentinel page);
- ``convert``: refuses a missing or unknown parameter.

Tolerance 1e-5 (absolute plus relative) on the f32 activations and
logits: the two frameworks sum the matrix products in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.gpt import decode_step_paged as jax_decode_step_paged
from midgpt_tpu.models.gpt import prefill_chunk_paged as jax_prefill_chunk_paged
from midgpt_tpu.serving.paged import PagedKVPool as JaxPagedKVPool
from midgpt_tpu.serving.paged import flush_recent as jax_flush_recent
from midgpt_tpu.serving.paged import write_token_rows as jax_write_token_rows
from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.convert import gpt_from_jax_params
from midgpt_tpu_torch.models.gpt import decode_step_paged, prefill_chunk_paged
from midgpt_tpu_torch.serving.paged import (
    PagedKVPool,
    flush_recent,
    write_token_rows,
)

from torch_port_util import GQA, MHA, model_pair, t

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_grad():
    """These paths serve: no gradients (the parameters are trainable)."""
    with torch.no_grad():
        yield

PS, NPOOL, R = 8, 24, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _pool_state(cfg, seed, lens):
    """A random f32 pool, block tables with distinct live pages per slot
    (pads hold the sentinel), and the window's recent rows."""
    rng = np.random.default_rng(seed)
    nl, hkv = cfg["n_layer"], cfg.get("n_kv_head") or cfg["n_head"]
    c = cfg["n_embd"] // cfg["n_head"]
    pmax = cfg["block_size"] // PS
    shape = (nl, NPOOL, hkv, c, PS)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    bt = np.full((len(lens), pmax), NPOOL, np.int32)
    perm = rng.permutation(NPOOL)
    for i, n in enumerate(lens):
        live = -(-(n + R) // PS)
        bt[i, :live] = perm[i * pmax // 2 : i * pmax // 2 + live]
    rshape = (nl, len(lens), hkv, R, c)
    rk = rng.standard_normal(rshape).astype(np.float32)
    rv = rng.standard_normal(rshape).astype(np.float32)
    return pk, pv, bt, np.asarray(lens, np.int32), rk, rv


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha_gelu", "gqa_swiglu"])
@pytest.mark.parametrize("r", [0, R - 1])
def test_decode_step_paged_matches_jax(cfg, r):
    jm, tm, _ = model_pair(cfg)
    lens = [0, 5, 16, 27]
    pk, pv, bt, pl, rk, rv = _pool_state(cfg, 1, lens)
    toks = np.random.default_rng(2).integers(0, cfg["vocab_size"], len(lens))
    toks = toks.astype(np.int32)
    pos = pl + r
    block = cfg["block_size"]
    ref, jrk, jrv = jax_decode_step_paged(
        jm, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(bt), jnp.asarray(rk), jnp.asarray(rv),
        jnp.asarray(r, jnp.int32), jnp.asarray(pl), block,
        paged_kernel="pallas",
    )
    trk, trv = t(rk), t(rv)
    got, trk, trv = decode_step_paged(
        tm, t(toks), t(pos), t(pk), t(pv), t(bt), trk, trv, r, t(pl), block,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(trk.numpy(), np.asarray(jrk), **TOL)
    np.testing.assert_allclose(trv.numpy(), np.asarray(jrv), **TOL)


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha_gelu", "gqa_swiglu"])
@pytest.mark.parametrize("tlen", [PS, 3 * PS])
def test_prefill_chunk_paged_matches_jax(cfg, tlen):
    """The engine's monolithic prefill: JAX's chunk prefill at start 0
    over a pool of random pages (all masked there)."""
    jm, tm, _ = model_pair(cfg)
    pk, pv, bt, _, _, _ = _pool_state(cfg, 3, [tlen])
    toks = np.random.default_rng(4).integers(0, cfg["vocab_size"], (1, tlen))
    toks = toks.astype(np.int32)
    block = cfg["block_size"]
    jh, jks, jvs = jax_prefill_chunk_paged(
        jm, jnp.asarray(toks), jnp.asarray(0, jnp.int32), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(bt[:1]), block,
    )
    h, ks, vs = prefill_chunk_paged(tm, t(toks), block)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(ks.numpy(), np.asarray(jks), **TOL)
    np.testing.assert_allclose(vs.numpy(), np.asarray(jvs), **TOL)
    np.testing.assert_allclose(tm.project(h).numpy(),
                               np.asarray(jm.project(jh)), **TOL)


def _pools(cfg, seed):
    pk, pv, bt, pl, rk, rv = _pool_state(cfg, seed, [0, 6, 15, 24])
    jpool = JaxPagedKVPool(k=jnp.asarray(pk), v=jnp.asarray(pv), page_size=PS)
    tpool = PagedKVPool(t(pk), t(pv), PS)
    return jpool, tpool, bt, pl, rk, rv


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha", "gqa"])
def test_flush_recent_is_bitwise_jax(cfg):
    jpool, tpool, bt, pl, rk, rv = _pools(cfg, 5)
    # valid rows form a prefix per slot: all, none, some, one
    valid = np.arange(R)[None, :] < np.asarray([R, 0, 2, 1])[:, None]
    jpool = jax_flush_recent(jpool, jnp.asarray(rk), jnp.asarray(rv),
                             jnp.asarray(bt), jnp.asarray(pl),
                             jnp.asarray(valid))
    flush_recent(tpool, t(rk), t(rv), t(bt), t(pl), t(valid))
    np.testing.assert_array_equal(tpool.k.numpy(), np.asarray(jpool.k))
    np.testing.assert_array_equal(tpool.v.numpy(), np.asarray(jpool.v))


@pytest.mark.parametrize("start,n_valid", [(0, 11), (6, 16), (13, 1)])
def test_write_token_rows_is_bitwise_jax(start, n_valid):
    cfg = GQA
    jpool, tpool, bt, _, _, _ = _pools(cfg, 6)
    rng = np.random.default_rng(7)
    nl, hkv = cfg["n_layer"], cfg["n_kv_head"]
    c = cfg["n_embd"] // cfg["n_head"]
    ks = rng.standard_normal((nl, hkv, 16, c)).astype(np.float32)
    vs = rng.standard_normal((nl, hkv, 16, c)).astype(np.float32)
    row = bt[3]
    jpool = jax_write_token_rows(jpool, jnp.asarray(ks), jnp.asarray(vs),
                                 jnp.asarray(row), jnp.asarray(start),
                                 jnp.asarray(n_valid))
    write_token_rows(tpool, t(ks), t(vs), t(row), start, n_valid)
    np.testing.assert_array_equal(tpool.k.numpy(), np.asarray(jpool.k))
    np.testing.assert_array_equal(tpool.v.numpy(), np.asarray(jpool.v))


def test_convert_refuses_missing_and_unknown_params():
    _, _, params = model_pair(MHA)
    cfg = ModelConfig(**MHA)
    missing = {k: v for k, v in params.items() if k != "lm_head/weight"}
    with pytest.raises(KeyError, match="lm_head"):
        gpt_from_jax_params(missing, cfg, device="cpu")
    extra = dict(params, **{"blocks/extra/weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="unconverted"):
        gpt_from_jax_params(extra, cfg, device="cpu")


def test_convert_keeps_linear_layout_and_unstacks_layers():
    _, tm, params = model_pair(GQA)
    w = params["blocks/mlp/w_gate/weight"]
    for i, blk in enumerate(tm.blocks):
        np.testing.assert_array_equal(blk.mlp.w_gate.weight.detach().numpy(),
                                      w[i])
        np.testing.assert_array_equal(
            blk.attn.q_norm.weight.detach().numpy(),
            params["blocks/attn/q_norm/weight"][i],
        )
    assert tm.lm_head.weight.shape == (GQA["n_embd"], GQA["vocab_size"])


def test_init_draws_the_reference_distributions():
    """GPT.init: untied head starts as the embedding's transpose,
    embedding std 1/sqrt(D), linears truncated at 2/sqrt(fan_in)."""
    from midgpt_tpu_torch.models.gpt import GPT

    cfg = ModelConfig(**GQA)
    m = GPT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    d = cfg.n_embd
    assert torch.equal(m.lm_head.weight, m.wte.weight.t())
    assert abs(m.wte.weight.std().item() * d**0.5 - 1.0) < 0.05
    wqkv = m.blocks[0].attn.wqkv.weight
    assert wqkv.abs().max().item() <= 2.0 / d**0.5 + 1e-7
    assert m.blocks[0].attn.q_norm.weight.eq(1.0).all()
    again = GPT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(m.state_dict().values(), again.state_dict().values()))
