"""The serving engine's prefill chunk programs on the CPU.

A 2-layer model gets the same weights in both packages
(``torch_port_util.model_pair``), f32 unless named. Checked:

- one chunk through the engine's prefill program (``slot``, ``start``,
  ``real_n``, the tokens and the slot's table row as static int32
  inputs, run under ``test_torch_dispatch._Refuse``: no host read, no
  host tensor, no copy to another device) against JAX's
  ``make_prefill_chunk_program`` on the same NumPy pool, table and
  tokens: buckets 8, 16 and 32 at page size 8, ``start`` 0, mid-page and
  page-aligned, ``real_n`` below the bucket; f32, bf16 and int8 pools,
  dense and MoE. The logits (the slot's row and the others untouched)
  and every page: 1e-5 at f32; a bf16 pool's pages are JAX's rounding of
  rows that agree to 1e-5, so each is equal or one bf16 step away;
  int8 codes and scales exact;
- the same bucket dispatched twice in a row for two slots (the pinned
  mirror hazard on the card) writes both slots' pages: equal to each
  chunk run alone;
- ``warm_prefill``: JAX's bucket list, both classes of every bucket made
  (at most ``2 (log2(pmax) + 1)`` programs), and the pool and the logits
  bit for bit as it found them;
- greedy streams through the programs (one-pass prefill and chunks of 8
  and 5, the prefix cache on, ``speculate=3``, int8 weights and pool)
  equal the JAX engine's request by request, and the program twin
  (``Program.run_eager``) streams alike.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.serving import ServingEngine as JaxServingEngine
from midgpt_tpu.serving import paged as jpaged
from midgpt_tpu.serving.engine import make_prefill_chunk_program
from midgpt_tpu_torch.serving import ServingEngine
from midgpt_tpu_torch.serving.programs import Program

from test_torch_dispatch import MOE, _Refuse
from torch_port_util import MHA, assert_pages_home, model_pair, t

torch.set_num_threads(2)

PS, NPOOL, SLOTS = 8, 24, 2
PMAX = MHA["block_size"] // PS


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _pool_arrays(cfg, pool: str, rng):
    """Random pool planes ``[L, NP, Hkv, C, PS]`` (and int8 scales)."""
    hkv = cfg.get("n_kv_head") or cfg["n_head"]
    c = cfg["n_embd"] // cfg["n_head"]
    shape = (cfg["n_layer"], NPOOL, hkv, c, PS)
    if pool == "int8":
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        sk, sv = (np.exp2(rng.integers(-7, -4, shape[:3])).astype(np.float32)
                  for _ in range(2))
        return k, v, sk, sv
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return k, v, None, None


def _chunk_case(cfg, pool: str, bucket: int, start: int, real_n: int,
                seed: int = 0):
    """The port's engine and JAX's pool holding the same pages, a block
    table for slot 1 covering ``start + real_n`` positions, and the
    chunk's right-padded tokens."""
    rng = np.random.default_rng(seed)
    jm, tm, _ = model_pair(cfg, gain=1.0)
    kw = dict(slots=SLOTS, page_size=PS, num_pages=NPOOL, device="cpu")
    if pool == "int8":
        kw["kv_quant"] = "int8"
    elif pool == "bf16":
        kw["cache_dtype"] = torch.bfloat16
    eng = ServingEngine(tm, **kw)
    k, v, sk, sv = _pool_arrays(cfg, pool, rng)
    if pool == "bf16":
        jk = jnp.asarray(k).astype(jnp.bfloat16)
        jv = jnp.asarray(v).astype(jnp.bfloat16)
        eng.pool.k.copy_(t(k).to(torch.bfloat16))
        eng.pool.v.copy_(t(v).to(torch.bfloat16))
    else:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        eng.pool.k.copy_(t(k))
        eng.pool.v.copy_(t(v))
    if sk is not None:
        eng.pool.scale_k.copy_(t(sk))
        eng.pool.scale_v.copy_(t(sv))
    jpool = jpaged.PagedKVPool(
        k=jk, v=jv, page_size=PS,
        scale_k=None if sk is None else jnp.asarray(sk),
        scale_v=None if sv is None else jnp.asarray(sv))
    logits = rng.standard_normal((SLOTS, cfg["vocab_size"])).astype(
        np.float32)
    eng.logits.copy_(t(logits))
    bt = np.full((PMAX,), NPOOL, np.int32)
    n_pages = -(-(start + real_n) // PS)
    bt[:n_pages] = rng.permutation(NPOOL)[:n_pages]
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :real_n] = rng.integers(0, cfg["vocab_size"], real_n)
    return jm, eng, jpool, jnp.asarray(logits), bt, toks


def _run_program(eng, bucket, slot, start, real_n, toks, bt):
    prog = eng._prefill_program(bucket, start > 0)
    prog.load(slot=slot, start=start, real_n=real_n, tokens=toks, bt=bt)
    with _Refuse() as mode:
        prog.run(eng._prefill_body(start > 0))
    assert mode.ops > 0
    return prog


def _same_pages(eng, jpool, pool: str):
    if pool == "f32":
        for a, b in ((eng.pool.k, jpool.k), (eng.pool.v, jpool.v)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)
    elif pool == "bf16":
        for a, b in ((eng.pool.k, jpool.k), (eng.pool.v, jpool.v)):
            got = a.float().numpy()
            want = np.asarray(b.astype(jnp.float32))
            # a bf16 step at each element's magnitude
            step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want),
                                                       2.0**-126))) - 7)
            assert np.all(np.abs(got - want) <= step)
    else:
        for a, b in ((eng.pool.k, jpool.k), (eng.pool.v, jpool.v)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in ((eng.pool.scale_k, jpool.scale_k),
                     (eng.pool.scale_v, jpool.scale_v)):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))


def _chunk_vs_jax(cfg, pool, bucket, start):
    real_n = bucket - 3
    jm, eng, jpool, jlogits, bt, toks = _chunk_case(cfg, pool, bucket, start,
                                                    real_n)
    before = eng.logits.clone()
    fn = make_prefill_chunk_program(jm, chunk_len=bucket, pmax=PMAX,
                                    rope_len=MHA["block_size"])
    jpool, jlogits = fn(jm, jpool, jlogits, jnp.asarray(1, jnp.int32),
                        jnp.asarray(toks), jnp.asarray(start, jnp.int32),
                        jnp.asarray(real_n, jnp.int32), jnp.asarray(bt))
    _run_program(eng, bucket, 1, start, real_n, toks, bt)
    np.testing.assert_allclose(eng.logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-5)
    assert torch.equal(eng.logits[0], before[0])  # the other slot's row
    assert not torch.equal(eng.logits[1], before[1])
    _same_pages(eng, jpool, pool)


STARTS = {"start0": 0, "mid_page": 13, "page_aligned": 16}


@pytest.mark.parametrize("start", list(STARTS))
@pytest.mark.parametrize("bucket", [8, 16, 32])
def test_chunk_program_matches_jax(bucket, start):
    _chunk_vs_jax(MHA, "f32", bucket, STARTS[start])


@pytest.mark.parametrize("start", list(STARTS))
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_chunk_program_pool_dtypes_match_jax(pool, start):
    _chunk_vs_jax(MHA, pool, 16, STARTS[start])


@pytest.mark.parametrize("start", list(STARTS))
@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_moe_chunk_program_matches_jax(pool, start):
    _chunk_vs_jax(MOE, pool, 16, STARTS[start])


def test_same_bucket_twice_in_a_row_writes_both_slots():
    """Two chunks of one program (bucket 16 at start 0), for slots 0 and
    1 on disjoint pages, loaded and run back to back with nothing read
    between: each slot's pages and logits row equal its chunk run alone
    from the same state."""
    _, eng, _, _, _, _ = _chunk_case(MHA, "f32", 16, 0, 11)
    rng = np.random.default_rng(5)
    cases = []
    for slot in range(SLOTS):
        bt = np.full((PMAX,), NPOOL, np.int32)
        bt[:2] = [2 * slot + 3, 2 * slot + 4]
        toks = np.zeros((1, 16), np.int32)
        toks[0, :11] = rng.integers(0, MHA["vocab_size"], 11)
        cases.append((slot, toks, bt))
    planes = (eng.pool.k, eng.pool.v, eng.logits)
    state = [x.clone() for x in planes]
    alone = []
    for slot, toks, bt in cases:
        for x, s in zip(planes, state):
            x.copy_(s)
        _run_program(eng, 16, slot, 0, 11, toks, bt)
        alone.append([x.clone() for x in planes])
    for x, s in zip(planes, state):
        x.copy_(s)
    prog = eng._prefill_program(16, False)
    for slot, toks, bt in cases:
        prog.load(slot=slot, start=0, real_n=11, tokens=toks, bt=bt)
        prog.run(eng._prefill_body(False))
    for slot, _, bt in cases:
        pages = torch.from_numpy(bt[:2]).long()
        for a, b in zip(planes[:2], alone[slot][:2]):
            assert torch.equal(a[:, pages], b[:, pages]), slot
            assert not torch.equal(a[:, pages], state[0][:, pages])
        assert torch.equal(eng.logits[slot], alone[slot][2][slot])


def test_warm_prefill_writes_nothing_and_makes_every_program():
    jm, tm, _ = model_pair(MHA, gain=1.0)
    for chunk in (None, 8):
        eng = ServingEngine(tm, slots=SLOTS, page_size=PS, device="cpu",
                            prefill_chunk=chunk)
        rng = np.random.default_rng(1)
        eng.pool.k.copy_(torch.from_numpy(rng.standard_normal(
            tuple(eng.pool.k.shape)).astype(np.float32)))
        eng.logits.copy_(torch.from_numpy(rng.standard_normal(
            tuple(eng.logits.shape)).astype(np.float32)))
        before = [x.clone() for x in (eng.pool.k, eng.pool.v, eng.logits)]
        jeng = JaxServingEngine(jm, slots=SLOTS, page_size=PS,
                                cache_dtype=jnp.float32, prefill_chunk=chunk)
        got = eng.warm_prefill(40)
        assert got == jeng.warm_prefill(40)
        for a, b in zip((eng.pool.k, eng.pool.v, eng.logits), before):
            assert torch.equal(a, b)
        keys = [k for k in eng._programs if k[0] == "prefill_chunk"]
        assert sorted((k[1], k[2]) for k in keys) == sorted(
            (b, r) for b in got for r in (False, True))
        assert len(keys) <= 2 * (int(math.log2(eng.pmax)) + 1)
        # a served trace after the warm-up makes no program
        made = set(eng._programs)
        eng.submit(rng.integers(0, MHA["vocab_size"], 30).astype(np.int32), 4)
        eng.run()
        assert {k for k in eng._programs if k[0] == "prefill_chunk"} <= made


def _streams_case(vocab):
    rng = np.random.default_rng(4)
    sys_prompt = rng.integers(0, vocab, size=18)
    prompts = [np.concatenate([sys_prompt, rng.integers(0, vocab, size=n)])
               .astype(np.int32) for n in (3, 5, 7, 9)]
    return prompts, [9, 12, 7, 10]


STREAMS = {
    "one_pass": dict(),
    "chunk8": dict(prefill_chunk=8),
    "chunk5": dict(prefill_chunk=5),
    "cache_off": dict(prefix_cache=False, prefill_chunk=5),
    "spec3": dict(speculate=3, prefill_chunk=8),
    "int8": dict(quant="int8", kv_quant="int8", prefill_chunk=5),
}


@pytest.mark.parametrize("case", list(STREAMS))
def test_greedy_streams_through_programs_match_jax(monkeypatch, case):
    kw = STREAMS[case]
    jm, tm, _ = model_pair(MHA)
    prompts, lens = _streams_case(MHA["vocab_size"])
    geo = dict(slots=SLOTS, page_size=PS, window=4)
    jeng = JaxServingEngine(jm, cache_dtype=jnp.float32,
                            paged_kernel="pallas", **geo, **kw)
    jr = [jeng.submit(p, n) for p, n in zip(prompts, lens)]
    jfin = jeng.run()
    ref = [list(map(int, jfin[r].tokens)) for r in jr]
    kinds = []
    run = Program.run

    def counted(self, body):
        kinds.append(self.key[0])
        run(self, body)

    monkeypatch.setattr(Program, "run", counted)
    eng = ServingEngine(tm, device="cpu", **geo, **kw)
    rids = [eng.submit(p, n) for p, n in zip(prompts, lens)]
    fin = eng.run()
    assert [list(map(int, fin[r].tokens)) for r in rids] == ref
    assert kinds.count("prefill_chunk") == eng.prefill_dispatches > 0
    assert_pages_home(eng)
    # the eager twin of every program streams alike
    monkeypatch.setattr(Program, "run", Program.run_eager)
    eng = ServingEngine(tm, device="cpu", **geo, **kw)
    rids = [eng.submit(p, n) for p, n in zip(prompts, lens)]
    fin = eng.run()
    assert [list(map(int, fin[r].tokens)) for r in rids] == ref
