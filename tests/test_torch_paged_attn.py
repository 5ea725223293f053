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
from hypothesis import given, settings
from hypothesis import strategies as st

from midgpt_tpu.ops.paged_attn import (
    paged_decode_attention as jax_paged_decode_attention,
)
from midgpt_tpu.ops.paged_attn import (
    paged_verify_attention as jax_paged_verify_attention,
)
from midgpt_tpu_torch.ops import paged_attn as pa

from torch_port_util import GQA, MHA, model_pair, t

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_grad():
    """These paths serve: no gradients (the parameters are trainable)."""
    with torch.no_grad():
        yield

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
    """The split block's shared memory holds one split's K and V pages,
    queries and scores: the same at any table length. openwebtext (G=1,
    C=64, PS=16, bf16) and llama_7b-like GQA (G=4, C=128) fit; a
    100k-token table (6250 pages of 16) is accepted by the check with the
    shared memory of a 1k-token one, only its scratch growing."""
    sp = pa.split_pages(16)
    assert sp == 4
    # K and V slabs of 4 pages, 4 recent K and V rows, then per query row
    # its q row, score row, self scores and maximum; page scales and ids
    assert pa.smem_bytes(1, 64, 16, 2, R, 2) == (
        2 * sp * 64 * 16 * 2 + 2 * R * 64 * 2
        + 4 * (64 + sp * 16 + R + 1) + 12 * sp + 4)
    assert pa.smem_bytes(4, 128, 16, 4, R, 4) <= pa.SMEM_LIMIT
    short = pa.kernel_plan(1, 64, 16, 64, torch.bfloat16, R)
    long = pa.kernel_plan(1, 64, 16, 6250, torch.bfloat16, R)
    assert long["smem"] == short["smem"] <= pa.SMEM_LIMIT
    assert (short["splits"], long["splits"]) == (16, 1563)
    assert long["part_o"] == 1563 * 64
    # int8 pages stage one byte an element, with bf16 self rows
    assert pa.kernel_plan(1, 64, 16, 64, torch.int8, R)["smem"] == (
        pa.smem_bytes(1, 64, 16, 1, R, 2))
    # only the rows and the page size set the block; a split too large to
    # stage is refused whatever the table
    with pytest.raises(ValueError, match="shared memory"):
        pa.kernel_plan(4096, 128, 16, 8, torch.float32, R)


# -- the kernels' plan: splits of pages and a merged softmax ---------------

SPS, SPMAX = 8, 24  # a split is 8 pages of 8: three splits a table
# empty, one token, mid-page, a split boundary -1 / at / +1, the table
SLENS = [0, 1, 13, 63, 64, 65, SPMAX * SPS]


def _split_inputs(hkv, g, c, tt=None, seed=0, lens=SLENS):
    """A pool of distinct live pages per slot (room for ``tt`` more rows),
    queries ``[S, Hkv, G, C]`` (or ``[S, Hkv, G, T, C]``), self rows and
    block tables padded with the sentinel page."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    extra = tt or 0
    live = [-(-(n + extra) // SPS) for n in lens]
    npool = sum(live) + 1
    s, rr = len(lens), (tt or R)
    q = f(s, hkv, g, c) if tt is None else f(s, hkv, g, tt, c)
    pk, pv = f(2, npool, hkv, c, SPS), f(2, npool, hkv, c, SPS)
    rk, rv = f(s, hkv, rr, c), f(s, hkv, rr, c)
    bt = np.full((s, SPMAX), npool, np.int32)
    perm, at = rng.permutation(npool), 0
    for i, n in enumerate(live):
        bt[i, :n] = perm[at : at + n]
        at += n
    return q, pk, pv, bt, np.asarray(lens, np.int32), rk, rv


def _int8(pk, pv, bt, layer, seed=1):
    """The pools' codes on po2 scales, each slot's gathered scales, and the
    f32 pools of the dequantized values."""
    rng = np.random.default_rng(seed)
    codes, gathered, dense = [], [], []
    for p in (pk, pv):
        sc = np.ldexp(np.float32(1.0), rng.integers(-9, -3, p.shape[:3]))
        cd = rng.integers(-127, 128, p.shape).astype(np.int8)
        codes.append(cd)
        gathered.append(sc.astype(np.float32)[layer][
            np.clip(bt, 0, p.shape[1] - 1)])
        dense.append(cd.astype(np.float32) * sc[..., None, None])
    return codes, gathered, dense


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("hkv,g", [(4, 1), (2, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("r", [0, R - 1])
def test_split_reference_matches_jax_decode_and_flat(hkv, g, r, pool):
    """The staged split route against JAX's Pallas decode kernel (the
    interpreter) and the flat plain version, within 1e-5 at f32."""
    q, pk, pv, bt, lens, rk, rv = _split_inputs(hkv, g, 16)
    layer, scales = 1, []
    if pool == "int8":
        (pk, pv), scales, _ = _int8(pk, pv, bt, layer)
        rk, rv = (t(a).to(torch.bfloat16).float().numpy() for a in (rk, rv))
    ref = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(lens),
        *(jnp.asarray(a, jnp.bfloat16 if scales else jnp.float32)
          for a in (rk, rv)),
        jnp.asarray(r, jnp.int32), layer, *(jnp.asarray(a) for a in scales))
    rows = [t(a, torch.bfloat16 if scales else None) for a in (rk, rv)]
    tsc = [t(a) for a in scales]
    got = pa.paged_attention_split_reference(
        t(q), *rows, t(pk), t(pv), t(bt), t(lens), layer, r, *tsc)
    flat = pa.paged_decode_attention_reference(
        t(q), t(pk), t(pv), t(bt), t(lens), *rows, r, layer, *tsc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("pool", ["f32", "int8"])
@pytest.mark.parametrize("hkv,g", [(4, 1), (2, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("tt", [1, 5])
def test_split_reference_matches_jax_verify_and_flat(hkv, g, tt, pool):
    """The staged split route's verify against JAX's Pallas verify kernel
    and the flat plain version (1e-5, f32); its row t equals its decode
    step t (the candidate rows as recent rows) bit for bit; the int8 pool
    reads as the f32 pool of its dequantized values, bit for bit."""
    starts = [min(n, SPMAX * SPS - tt) for n in SLENS]
    q, pk, pv, bt, st, kc, vc = _split_inputs(hkv, g, 16, tt=tt,
                                              lens=starts, seed=2)
    layer, scales, dense = 1, [], None
    if pool == "int8":
        (pk, pv), scales, dense = _int8(pk, pv, bt, layer, seed=3)
        kc, vc = (t(a).to(torch.bfloat16).float().numpy() for a in (kc, vc))
    rdt = jnp.bfloat16 if scales else jnp.float32
    ref = jax_paged_verify_attention(
        jnp.asarray(q), jnp.asarray(kc, rdt), jnp.asarray(vc, rdt),
        jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt), jnp.asarray(st),
        layer, *(jnp.asarray(a) for a in scales))
    rows = [t(a, torch.bfloat16 if scales else None) for a in (kc, vc)]
    tsc = [t(a) for a in scales]
    got = pa.paged_attention_split_reference(
        t(q), *rows, t(pk), t(pv), t(bt), t(st), layer, None, *tsc)
    flat = pa.paged_verify_attention_reference(
        t(q), *rows, t(pk), t(pv), t(bt), t(st), layer, *tsc)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=1e-5,
                               atol=1e-5)
    for r in range(tt):
        step = pa.paged_attention_split_reference(
            t(q)[:, :, :, r].contiguous(), *rows, t(pk), t(pv), t(bt), t(st),
            layer, r, *tsc)
        assert torch.equal(got[:, :, :, r], step)
    if dense is not None:
        assert torch.equal(got, pa.paged_attention_split_reference(
            t(q), *(x.float() for x in rows), *(t(a) for a in dense), t(bt),
            t(st), layer))


def test_split_plan_depends_on_the_page_size_alone():
    """The plan is a function of PS: neither the query rows (G, or G T)
    nor the table's length, slots or heads enter it."""
    import inspect

    assert list(inspect.signature(pa.split_pages).parameters) == ["ps"]
    for ps in (1, 8, 16, 24, 64, 256):
        plans = {(p["split_pages"], p["splits"] * p["split_pages"] >= 100)
                 for rows in (1, 4, 5, 20, 40)
                 for p in [pa.kernel_plan(rows, 64, ps, 100,
                                          torch.bfloat16, 4)]}
        assert plans == {(max(1, 64 // ps), True)}


@settings(max_examples=12, deadline=None)
@given(g=st.integers(1, 3), tt=st.integers(1, 4), seed=st.integers(0, 99))
def test_split_rows_do_not_depend_on_the_other_rows(g, tt, seed):
    """A query row's result through the staged route is the same bits
    whatever rows stand beside it: decode at G heads equals each head
    alone, and verify at T rows equals T = 1 on its first row."""
    q, pk, pv, bt, lens, rk, rv = (t(a) for a in _split_inputs(
        2, g, 16, seed=seed))
    full = pa.paged_attention_split_reference(q, rk, rv, pk, pv, bt, lens, 1,
                                              R - 1)
    for h in range(g):
        one = pa.paged_attention_split_reference(
            q[:, :, h:h + 1].contiguous(), rk, rv, pk, pv, bt, lens, 1, R - 1)
        assert torch.equal(full[:, :, h:h + 1], one)
    starts = [min(n, SPMAX * SPS - tt) for n in SLENS]
    q, pk, pv, bt, st_, kc, vc = (t(a) for a in _split_inputs(
        2, g, 16, tt=tt, lens=starts, seed=seed))
    full = pa.paged_attention_split_reference(q, kc, vc, pk, pv, bt, st_, 1)
    first = pa.paged_attention_split_reference(
        q[:, :, :, :1].contiguous(), kc[:, :, :1].contiguous(),
        vc[:, :, :1].contiguous(), pk, pv, bt, st_, 1)
    assert torch.equal(full[:, :, :, :1], first)
