"""The port's paged decode attention against the JAX package's.

The plain PyTorch version (which the wrapper runs for CPU tensors) is
held to the JAX Pallas kernel, run through the Pallas interpreter as the
JAX package's own tests run it, and to the JAX XLA gather path of
``Attention.decode_paged_at`` with converted weights. Cases: MHA and GQA;
ragged resident lengths (empty, mid-page, page-aligned, full table);
the first and the last recent row. Tolerance 1e-5 in f32: the frameworks
sum in different orders. The CUDA kernel itself is held to the plain
version on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.layers import rope_tables as jax_rope_tables
from midgpt_tpu.ops.paged_attn import (
    paged_decode_attention as jax_paged_decode_attention,
)
from midgpt_tpu_torch.ops import paged_attn as pa

from torch_port_util import GQA, MHA, model_pair, t

torch.set_num_threads(2)

PS, PMAX, NPOOL, R = 8, 8, 40, 4
LENS = [0, 13, 32, PMAX * PS]  # empty, mid-page, page-aligned, full table


def _inputs(hkv, g, c, seed=0, layers=2, lens=LENS, npool=NPOOL):
    """Random pool, queries and recent rows; each slot owns distinct live
    pages and its table pads hold the sentinel ``npool``."""
    rng = np.random.default_rng(seed)
    s = len(lens)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    q = f(s, hkv, g, c)
    pool_k, pool_v = f(layers, npool, hkv, c, PS), f(layers, npool, hkv, c, PS)
    rk, rv = f(s, hkv, R, c), f(s, hkv, R, c)
    bt = np.full((s, PMAX), npool, np.int32)
    perm = rng.permutation(npool)
    for i, n in enumerate(lens):
        live = -(-n // PS)
        bt[i, :live] = perm[i * PMAX : i * PMAX + live]
    return q, pool_k, pool_v, bt, np.asarray(lens, np.int32), rk, rv


@pytest.mark.parametrize("hkv,g", [(4, 1), (2, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("r", [0, R - 1])
def test_reference_matches_jax_pallas_kernel(hkv, g, r):
    q, pk, pv, bt, lens, rk, rv = _inputs(hkv, g, 16)
    layer = 1
    ref = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(lens), jnp.asarray(rk), jnp.asarray(rv),
        jnp.asarray(r, jnp.int32), layer,
    )
    got = pa.paged_decode_attention(
        t(q), t(pk), t(pv), t(bt), t(lens), t(rk), t(rv), r, layer
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha", "gqa"])
@pytest.mark.parametrize("r", [0, R - 1])
def test_attention_decode_matches_jax_xla(cfg, r):
    """Attention.decode_paged_at (projection, QK-norm, RoPE, paged
    attention through the wrapper, output projection) against the JAX
    XLA gather path; the recent-row write is compared too."""
    jm, tm, _ = model_pair(cfg)
    c = cfg["n_embd"] // cfg["n_head"]
    hkv = cfg.get("n_kv_head") or cfg["n_head"]
    _, pk, pv, bt, lens, rk1, rv1 = _inputs(hkv, 1, c, seed=3)
    s, layer = len(LENS), 1
    rng = np.random.default_rng(4)
    x = rng.standard_normal((s, 1, cfg["n_embd"])).astype(np.float32)
    rk = np.broadcast_to(rk1, (2,) + rk1.shape).copy()
    rv = np.broadcast_to(rv1, (2,) + rv1.shape).copy()
    pos = lens + r
    sin, cos = (a.astype(np.float32)[pos][:, None, None, :]
                for a in jax_rope_tables(c, 2 * cfg["block_size"]))
    w = PMAX * PS
    mask_pool = np.where(np.arange(w)[None] < lens[:, None], 0.0, -np.inf)
    mask_rec = np.where(np.arange(R) <= r, 0.0, -np.inf)
    blk = jax.tree.map(lambda a: a[layer], jm.blocks)
    ref, jrk, _ = blk.attn.decode_paged_at(
        jnp.asarray(x), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(rk), jnp.asarray(rv), layer, jnp.asarray(r, jnp.int32),
        jnp.asarray(mask_pool, jnp.float32), jnp.asarray(mask_rec, jnp.float32),
        jnp.asarray(sin), jnp.asarray(cos), pooled_len=jnp.asarray(lens),
        paged_kernel="xla",
    )
    trk, trv = t(rk), t(rv)
    got = tm.blocks[layer].attn.decode_paged_at(
        t(x), t(pk), t(pv), t(bt), trk, trv, layer, r, t(sin), t(cos),
        t(lens),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(trk.numpy(), np.asarray(jrk), rtol=1e-6,
                               atol=1e-6)


def test_cpu_path_launches_no_kernel():
    q, pk, pv, bt, lens, rk, rv = _inputs(2, 2, 16)
    before = pa.paged_decode_attention.launches
    pa.paged_decode_attention(t(q), t(pk), t(pv), t(bt), t(lens), t(rk),
                              t(rv), 1, 0)
    assert pa.paged_decode_attention.launches == before


@pytest.mark.parametrize("bad", ["q_shape", "r", "layer", "bt_dtype",
                                 "rows_dtype", "rows_shape"])
def test_wrapper_rejects_bad_inputs(bad):
    q, pk, pv, bt, lens, rk, rv = (t(a) for a in _inputs(2, 2, 16))
    r, layer = 1, 0
    if bad == "q_shape":
        q = q[:, :1]
    elif bad == "r":
        r = R
    elif bad == "layer":
        layer = 2
    elif bad == "bt_dtype":
        bt = bt.long()
    elif bad == "rows_dtype":
        rk = rk.double()
    else:
        rk = rk[:, :, :, :8]
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q, pk, pv, bt, lens, rk, rv, r, layer)


def test_shared_memory_budget():
    """openwebtext (G=1, C=64, W=1024, R=4) and llama_7b (G=4, C=128,
    W=2048) fit one block's shared memory; a 100k-token table does not,
    and the wrapper's ValueError names the limit for such geometries."""
    assert pa.smem_bytes(1, 64, 64, 16, 4) == 4 * (64 + 1028) + 4 * 64
    assert pa.smem_bytes(1, 64, 64, 16, 4) <= pa.SMEM_LIMIT
    assert pa.smem_bytes(4, 128, 128, 16, 4) <= pa.SMEM_LIMIT
    assert pa.smem_bytes(1, 64, 6250, 16, 4) > pa.SMEM_LIMIT
