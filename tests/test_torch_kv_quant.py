"""The port's int8 serving path (int8 weights, int8 KV pool) against the
JAX package's.

- ``kv_row_scales`` (the page-birth lookup rule) bit for bit;
- the int8 plain ``paged_decode_attention`` / ``paged_verify_attention``
  (what the wrappers run for CPU tensors) against the JAX Pallas kernels'
  int8 branch in interpret mode, f32: within 1e-6 of the largest output
  (the frameworks sum in different orders);
- the scale planes and codes after a prefill write (``write_token_rows``)
  and after ``flush_recent`` (with a rejected draft at a page's birth
  position) bit for bit;
- ``Attention.decode_paged_at`` and ``verify_tokens_paged`` over an int8
  pool against JAX's (rows rounded to their pages' grids);
- greedy streams of ``generate_served(quant="int8", kv_quant="int8")``
  equal the JAX engine's token for token (f32 model, prefix cache off,
  the Pallas kernels in interpret mode): MHA window 4, GQA window 3, and
  ``speculate=3``;
- the port's int8 engine is token-identical to itself across window
  sizes and spec-on vs spec-off, and to the engine serving
  ``dequantize_model`` of the same weights (int8 pool and float pool);
- unknown ``quant`` / ``kv_quant`` values and mismatched wrapper inputs
  raise; the CPU path launches no kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.layers import rope_tables as jax_rope_tables
from midgpt_tpu.models.gpt import verify_tokens_paged as jax_verify_tokens
from midgpt_tpu.ops.paged_attn import (
    paged_decode_attention as jax_paged_decode,
    paged_verify_attention as jax_paged_verify,
)
from midgpt_tpu.serving import generate_served as jax_generate_served
from midgpt_tpu.serving import paged as jpaged
from midgpt_tpu_torch.models.gpt import verify_tokens_paged
from midgpt_tpu_torch.ops import paged_attn as pa
from midgpt_tpu_torch.quant import dequantize_model, quantize_model
from midgpt_tpu_torch.serving import (
    PagedKVPool,
    ServingEngine,
    flush_recent,
    generate_served,
    kv_row_scales,
    write_token_rows,
)

from torch_port_util import GQA, MHA, model_pair, t

torch.set_num_threads(2)

PS, PMAX, NPOOL, R = 8, 8, 40, 4
W = PS * PMAX
LENS = (5, 9, 17, 3, 30)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _tables(rng, lens, extra=0):
    """Block tables with distinct live pages per slot (room for ``extra``
    more rows), pads holding the sentinel ``NPOOL``."""
    bt = np.full((len(lens), PMAX), NPOOL, np.int32)
    perm = rng.permutation(NPOOL)
    for i, n in enumerate(lens):
        live = -(-(n + extra) // PS)
        bt[i, :live] = perm[i * PMAX : i * PMAX + live]
    return bt


def _int8_pool(rng, hkv, c, layers=2):
    """Random codes and po2 scales, as an int8 pool holds them."""
    shape = (layers, NPOOL, hkv, c, PS)
    pk, pv = (rng.integers(-127, 128, shape).astype(np.int8)
              for _ in range(2))
    sk, sv = (np.ldexp(np.float32(1.0), rng.integers(-9, -3, shape[:3]))
              .astype(np.float32) for _ in range(2))
    return pk, pv, sk, sv


def _gather(planes, bt, layer):
    """JAX's ``_gathered_pool_scales``: ``[S, Pmax, Hkv]``, clip mode."""
    return planes[layer][np.clip(bt, 0, planes.shape[1] - 1)]


def _bf16(a):
    """A NumPy f32 array rounded to bf16 (both packages read the same
    values)."""
    return t(a).to(torch.bfloat16).float().numpy()


def test_kv_row_scales_match_jax_bitwise():
    rng = np.random.default_rng(0)
    s, hkv, tt, c = 5, 2, 7, 16
    base = np.asarray([0, 3, 8, 13, 30], np.int32)  # aligned and mid-page
    bt = _tables(rng, base, extra=tt)
    rows_k, rows_v = ((rng.standard_normal((s, hkv, tt, c))
                       * np.exp(rng.uniform(-5, 5, (s, hkv, tt, 1))))
                      .astype(np.float32) for _ in range(2))
    rows_k[1, 0, 5] = 0.0  # a birth row of zeros
    _, _, sk, sv = _int8_pool(rng, hkv, c, layers=1)
    got = kv_row_scales(t(rows_k), t(rows_v), t(base), t(bt), t(sk[0]),
                        t(sv[0]), PS)
    ref = jpaged.kv_row_scales(
        *(jnp.asarray(a) for a in (rows_k, rows_v, base, bt, sk[0], sv[0])),
        PS)
    for a, b in zip(got, ref):
        assert a.shape == (s, hkv, tt)
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))
    # a leading layer dim goes along
    lk = kv_row_scales(t(rows_k)[None].expand(3, -1, -1, -1, -1),
                       t(rows_v)[None].expand(3, -1, -1, -1, -1), t(base),
                       t(bt), t(sk[0])[None].expand(3, -1, -1),
                       t(sv[0])[None].expand(3, -1, -1), PS)[0]
    assert all(torch.equal(lk[i], got[0]) for i in range(3))


def _close(got, ref, rel=1e-6):
    """Within ``rel`` of the largest reference output, elementwise."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("hkv,g", [(4, 1), (2, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("r", [0, R - 1])
def test_int8_decode_reference_matches_jax_pallas_kernel(hkv, g, r):
    rng = np.random.default_rng(1)
    c, layer = 16, 1
    lens = np.asarray([0, 13, 32, W], np.int32)
    q = rng.standard_normal((len(lens), hkv, g, c)).astype(np.float32)
    pk, pv, sk, sv = _int8_pool(rng, hkv, c)
    rk, rv = (_bf16(rng.standard_normal((len(lens), hkv, R, c)))
              for _ in range(2))
    bt = _tables(rng, lens)
    gk, gv = _gather(sk, bt, layer), _gather(sv, bt, layer)
    ref = jax_paged_decode(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(bt),
        jnp.asarray(lens), jnp.asarray(rk, jnp.bfloat16),
        jnp.asarray(rv, jnp.bfloat16), jnp.asarray(r, jnp.int32), layer,
        jnp.asarray(gk), jnp.asarray(gv))
    before = pa.paged_decode_attention.launches
    got = pa.paged_decode_attention(
        t(q), t(pk), t(pv), t(bt), t(lens), t(rk, torch.bfloat16),
        t(rv, torch.bfloat16), r, layer, t(gk), t(gv))
    assert pa.paged_decode_attention.launches == before  # CPU: no kernel
    _close(got.numpy(), ref)


@pytest.mark.parametrize("tt", [1, 3, 5])
@pytest.mark.parametrize("hkv,g", [(4, 1), (2, 2)], ids=["mha", "gqa"])
def test_int8_verify_reference_matches_jax_pallas_kernel(hkv, g, tt):
    rng = np.random.default_rng(2)
    c, layer = 16, 1
    starts = np.asarray([0, 13, 32, W - tt], np.int32)
    q = rng.standard_normal((len(starts), hkv, g, tt, c)).astype(np.float32)
    kc, vc = (_bf16(rng.standard_normal((len(starts), hkv, tt, c)))
              for _ in range(2))
    pk, pv, sk, sv = _int8_pool(rng, hkv, c)
    bt = _tables(rng, starts, extra=tt)
    gk, gv = _gather(sk, bt, layer), _gather(sv, bt, layer)
    ref = jax_paged_verify(
        jnp.asarray(q), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(bt), jnp.asarray(starts), layer, jnp.asarray(gk),
        jnp.asarray(gv))
    got = pa.paged_verify_attention(
        t(q), t(kc, torch.bfloat16), t(vc, torch.bfloat16), t(pk), t(pv),
        t(bt), t(starts), layer, t(gk), t(gv))
    _close(got.numpy(), ref)
    # the int8 pool reads as the f32 pool of its dequantized values
    deq = [t(p).float() * t(s)[..., None, None] for p, s in ((pk, sk),
                                                             (pv, sv))]
    dense = pa.paged_verify_attention(
        t(q), t(kc), t(vc), *deq, t(bt), t(starts), layer)
    assert torch.equal(got, dense)


@pytest.mark.parametrize("bad", ["no_scales", "float_pool_scales",
                                 "f32_rows", "scale_shape", "one_scale"])
def test_int8_wrappers_reject_mismatched_inputs(bad):
    rng = np.random.default_rng(3)
    lens = np.asarray([0, 13, 32, W], np.int32)
    q = t(rng.standard_normal((4, 2, 2, 16)).astype(np.float32))
    pk, pv, sk, sv = _int8_pool(rng, 2, 16)
    bt = _tables(rng, lens)
    rk = t(rng.standard_normal((4, 2, R, 16)), torch.bfloat16)
    args = [q, t(pk), t(pv), t(bt), t(lens), rk, rk.clone(), 1, 0]
    scales = [t(_gather(sk, bt, 0)), t(_gather(sv, bt, 0))]
    if bad == "no_scales":
        scales = []
    elif bad == "float_pool_scales":
        args[1], args[2] = args[1].float(), args[2].float()
        args[5], args[6] = args[5].float(), args[6].float()
    elif bad == "f32_rows":
        args[5], args[6] = args[5].float(), args[6].float()
    elif bad == "scale_shape":
        scales = [sc[:, :4] for sc in scales]
    else:
        scales = [scales[0], None]
    with pytest.raises(ValueError):
        pa.paged_decode_attention(*args, *scales)


def _pool_pair(rng, hkv, c, quantized_pages):
    """A JAX int8 pool and the port's, holding the same codes, with the
    pages in ``quantized_pages`` born earlier (their scales set) and the
    rest at the init scale of one."""
    pk, pv, sk, sv = _int8_pool(rng, hkv, c)
    born = np.zeros(NPOOL, bool)
    born[quantized_pages] = True
    sk[:, ~born] = 1.0
    sv[:, ~born] = 1.0
    jpool = jpaged.PagedKVPool(k=jnp.asarray(pk), v=jnp.asarray(pv),
                               page_size=PS, scale_k=jnp.asarray(sk),
                               scale_v=jnp.asarray(sv))
    tpool = PagedKVPool(t(pk), t(pv), PS, t(sk), t(sv))
    return jpool, tpool


def _same_pool(tpool, jpool):
    for a, b in ((tpool.k, jpool.k), (tpool.v, jpool.v)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in ((tpool.scale_k, jpool.scale_k),
                 (tpool.scale_v, jpool.scale_v)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(b))


@pytest.mark.parametrize("start,n_valid,tt", [(0, 21, 32), (5, 13, 16)],
                         ids=["prefill", "mid_page"])
def test_prefill_write_matches_jax_bitwise(start, n_valid, tt):
    rng = np.random.default_rng(4)
    hkv, c = 2, 16
    bt = _tables(rng, [start + n_valid])[0]
    # a mid-page start continues a page born earlier: its scale is set
    jpool, tpool = _pool_pair(rng, hkv, c, bt[: start // PS + 1] if start
                              else [])
    ks, vs = (rng.standard_normal((2, hkv, tt, c)).astype(np.float32)
              for _ in range(2))
    jnew = jpaged.write_token_rows(
        jpool, jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(bt),
        jnp.asarray(start, jnp.int32), jnp.asarray(n_valid, jnp.int32))
    write_token_rows(tpool, t(ks), t(vs), t(bt), start, n_valid)
    _same_pool(tpool, jnew)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flush_recent_matches_jax_bitwise(dtype):
    """A window's (or a verify dispatch's) rows land with the same codes
    and the same birth scales. Slot 1's first rejected row sits at a
    page's birth position: it is not written and sets no scale."""
    rng = np.random.default_rng(5)
    hkv, c, k = 2, 16, 6
    start = np.asarray([3, 6, 16, 9], np.int32)
    bt = _tables(rng, start, extra=k)
    resident = [p for i, n in enumerate(start) for p in bt[i, : -(-n // PS)]]
    jpool, tpool = _pool_pair(rng, hkv, c, resident)
    rk, rv = (rng.standard_normal((2, len(start), hkv, k, c))
              .astype(np.float32) for _ in range(2))
    valid = np.zeros((len(start), k), bool)
    for i, n in enumerate([6, 2, 4, 0]):
        valid[i, :n] = True
    assert (start[1] + 2) % PS == 0  # slot 1's first dropped row: a birth
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jnew = jpaged.flush_recent(
        jpool, jnp.asarray(rk, jdt), jnp.asarray(rv, jdt), jnp.asarray(bt),
        jnp.asarray(start), jnp.asarray(valid))
    flush_recent(tpool, t(rk, tdt), t(rv, tdt), t(bt), t(start), t(valid))
    _same_pool(tpool, jnew)
    born = bt[1, (start[1] + 2) // PS]
    assert (tpool.scale_k[:, born] == 1.0).all()


def _int8_pool_state(cfg, seed):
    """An int8 pool of the model's geometry whose resident pages were
    written by the port's own write path (page-birth scales), for the
    model-level comparisons; returns it with its block tables and
    lengths."""
    rng = np.random.default_rng(seed)
    hkv = cfg.get("n_kv_head") or cfg["n_head"]
    c = cfg["n_embd"] // cfg["n_head"]
    lens = np.asarray([0, 13, 32, 50], np.int32)
    bt = _tables(rng, lens, extra=8)
    pool = PagedKVPool.init(_port_cfg(cfg), NPOOL, PS, torch.float32,
                            torch.device("cpu"), kv_quant="int8")
    for i, n in enumerate(lens):
        if n:
            ks, vs = (t(rng.standard_normal((cfg["n_layer"], hkv, n, c))
                        .astype(np.float32)) for _ in range(2))
            write_token_rows(pool, ks, vs, t(bt[i]), 0, int(n))
    return pool, bt, lens


def _port_cfg(cfg):
    from midgpt_tpu_torch.config import ModelConfig

    return ModelConfig(**cfg)


def _jax_arrays(pool):
    return [jnp.asarray(a.numpy()) for a in (pool.k, pool.v, pool.scale_k,
                                              pool.scale_v)]


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha", "gqa"])
@pytest.mark.parametrize("r", [0, R - 1])
def test_attention_decode_over_int8_pool_matches_jax(cfg, r):
    """Attention.decode_paged_at over an int8 pool (this step's row
    rounded through its page's grid, the plain int8 attention) against
    the JAX XLA path; the rounded recent row is compared too."""
    jm, tm, _ = model_pair(cfg)
    pool, bt, lens = _int8_pool_state(cfg, 6)
    hkv = cfg.get("n_kv_head") or cfg["n_head"]
    c = cfg["n_embd"] // cfg["n_head"]
    s, layer = len(lens), 1
    rng = np.random.default_rng(7)
    x = rng.standard_normal((s, 1, cfg["n_embd"])).astype(np.float32)
    # earlier rows of the window, already on their grids, as bf16
    rk = np.zeros((2, s, hkv, R, c), np.float32)
    rv = np.zeros_like(rk)
    pos = lens + r
    sin, cos = (a.astype(np.float32)[pos][:, None, None, :]
                for a in jax_rope_tables(c, 2 * cfg["block_size"]))
    mask_pool = np.where(np.arange(W)[None] < lens[:, None], 0.0, -np.inf)
    mask_rec = np.where(np.arange(R) <= r, 0.0, -np.inf)
    blk = jax.tree.map(lambda a: a[layer], jm.blocks)
    jk, jv, jsk, jsv = _jax_arrays(pool)
    ref, jrk, jrv = blk.attn.decode_paged_at(
        jnp.asarray(x), jk, jv, jnp.asarray(bt),
        jnp.asarray(rk, jnp.bfloat16), jnp.asarray(rv, jnp.bfloat16), layer,
        jnp.asarray(r, jnp.int32), jnp.asarray(mask_pool, jnp.float32),
        jnp.asarray(mask_rec, jnp.float32), jnp.asarray(sin),
        jnp.asarray(cos), pooled_len=jnp.asarray(lens), pool_sk=jsk,
        pool_sv=jsv, paged_kernel="xla")
    trk, trv = t(rk, torch.bfloat16), t(rv, torch.bfloat16)
    got = tm.blocks[layer].attn.decode_paged_at(
        t(x), pool.k, pool.v, t(bt), trk, trv, layer, r, t(sin), t(cos),
        t(lens), pool_sk=pool.scale_k, pool_sv=pool.scale_v)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    for a, b in ((trk, jrk), (trv, jrv)):
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(b.astype(jnp.float32)))


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha", "gqa"])
def test_verify_tokens_over_int8_pool_matches_jax(cfg):
    jm, tm, _ = model_pair(cfg)
    pool, bt, lens = _int8_pool_state(cfg, 8)
    tt = 5
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg["vocab_size"], size=(len(lens), tt)).astype(
        np.int32)
    jk, jv, jsk, jsv = _jax_arrays(pool)
    ref, rks, rvs = jax_verify_tokens(
        jm, jnp.asarray(toks), jnp.asarray(lens), jk, jv, jnp.asarray(bt),
        cfg["block_size"], pool_sk=jsk, pool_sv=jsv, paged_kernel="pallas")
    got, ks, vs = verify_tokens_paged(
        tm, t(toks), t(lens), pool.k, pool.v, t(bt), cfg["block_size"],
        pool_sk=pool.scale_k, pool_sv=pool.scale_v)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # the rows come back rounded to their pages' grids: layer 0's exactly
    for a, b in ((ks, rks), (vs, rvs)):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b[0]))


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


INT8 = dict(quant="int8", kv_quant="int8")


@pytest.mark.parametrize("cfg,window,spec", [
    (MHA, 4, 0), (GQA, 3, 0), (MHA, 4, 3), (GQA, 4, 3)],
    ids=["mha_w4", "gqa_w3", "mha_spec3", "gqa_spec3"])
def test_int8_greedy_streams_match_jax_engine(cfg, window, spec):
    jm, tm, _ = model_pair(cfg)
    prompts = _prompts(cfg["vocab_size"])
    kw = dict(slots=2, window=window, page_size=8, speculate=spec, **INT8)
    ref = jax_generate_served(
        jm, prompts, 12, prefix_cache=False, paged_kernel="pallas",
        cache_dtype=jnp.float32, **kw)
    got = generate_served(tm, prompts, 12, device="cpu", **kw)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    assert len({tuple(x) for x in got}) > 1


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha", "gqa"])
def test_int8_engine_is_invariant_and_equals_dequantized_weights(cfg):
    """Int8 streams do not depend on the window or on speculation, and
    po2 weight scales make them those of the dequantized model's engine
    over the same int8 pool; over a float pool, quant equals the
    dequantized weights too."""
    _, tm, _ = model_pair(cfg)
    prompts = _prompts(cfg["vocab_size"], lens=(5, 9, 17, 3, 30, 12))
    kw = dict(slots=3, page_size=8, device="cpu")
    qm = quantize_model(tm)
    base = generate_served(tm, prompts, 14, window=4, **INT8, **kw)
    variants = [
        generate_served(tm, prompts, 14, window=1, **INT8, **kw),
        generate_served(tm, prompts, 14, window=5, **INT8, **kw),
        generate_served(tm, prompts, 14, speculate=3, **INT8, **kw),
        generate_served(qm, prompts, 14, kv_quant="int8", **kw),
        generate_served(dequantize_model(qm), prompts, 14, kv_quant="int8",
                        **kw),
    ]
    for got in variants:
        for a, b in zip(base, got):
            np.testing.assert_array_equal(b, a)
    floats = generate_served(qm, prompts, 14, **kw)
    deq = generate_served(dequantize_model(qm), prompts, 14, **kw)
    for a, b in zip(floats, deq):
        np.testing.assert_array_equal(b, a)


def test_int8_engine_state_and_errors():
    _, tm, _ = model_pair(MHA)
    eng = ServingEngine(tm, slots=2, page_size=8, device="cpu", **INT8)
    assert eng.pool.k.dtype == torch.int8 and eng.pool.quantized
    assert eng.pool.row_dtype == torch.bfloat16
    assert eng.pool.scale_k.shape == eng.pool.k.shape[:3]
    assert (eng.pool.scale_k == 1.0).all()
    rids = [eng.submit(p, 6) for p in _prompts(MHA["vocab_size"])[:3]]
    eng.run()
    assert all(len(eng.finished[r].tokens) == 6 for r in rids)
    assert (eng.pool.scale_k != 1.0).any()  # pages were born
    assert eng.alloc.free_pages == eng.alloc.num_pages
    assert not hasattr(tm.lm_head, "scale")  # the caller's model untouched
    for bad in (dict(quant="int4"), dict(kv_quant="fp8"),
                dict(quant="int8", kv_quant="int4")):
        with pytest.raises(ValueError, match="quant"):
            ServingEngine(tm, slots=2, page_size=8, device="cpu", **bad)
    with pytest.raises(ValueError, match="kv_quant"):
        generate_served(tm, [np.arange(3)], 2, device="cpu", kv_quant="q")
