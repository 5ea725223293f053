"""The serving engine's one-dispatch programs on the CPU.

- the device keys (``request_keys``, ``acceptance_keys``) equal the host
  functions ``request_key`` / ``acceptance_key`` bit for bit, for seeds
  across the int64 range (negative ones included) and token indices up
  to 2^31, per slot and per (step, slot);
- ``flush_recent`` (every row scattered, the rows that are not valid
  dropped, no host read) equals the JAX package's at f32: float and int8
  pools, rows that are not valid, a rejected row at a page's birth, a
  slot whose rows run onto sentinel table entries, an empty slot, and a
  flush with no valid row at all (the pool unchanged);
- every decode window and verify dispatch of a served run (greedy and
  sampled, float and int8, dense and MoE, one-hot and soft drafts) runs
  its program under a dispatch mode that refuses what a CUDA graph
  cannot hold: ``aten.nonzero``, ``aten._local_scalar_dense``,
  ``aten.is_nonzero``, ``aten.masked_select``, the ``unique`` ops,
  ``aten.lift_fresh`` (host data made a tensor) and any copy to another
  device. Its streams equal the same engine's with the programs' eager
  twin (``Program.run_eager``);
- the program keys: two engines of one geometry keep separate programs
  and static tensors under equal keys, and a change of ``pmax``, the
  temperature, the pool dtype, the quantization or soft drafts makes
  another key;
- the launch recording: launches inside ``ops.launches.recording`` go to
  the record, not to the wrappers' counts, and ``add`` counts a record
  again;
- ``serving.programs.capturing``: the capture lock held and the cyclic
  garbage collector paused inside, restored after (left off where it
  was off), also when the capture raises.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

from midgpt_tpu.serving import paged as jpaged
from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.ops import launches
from midgpt_tpu_torch.ops import paged_attn as pa
from midgpt_tpu_torch.sampling import (
    acceptance_key,
    acceptance_keys,
    request_key,
    request_keys,
)
from midgpt_tpu_torch.serving import (
    PagedKVPool,
    ServingEngine,
    flush_recent,
    generate_served,
    write_token_rows,
)
from midgpt_tpu_torch.serving.programs import Program, capturing

from torch_port_util import MHA, model_pair, t

torch.set_num_threads(2)

I64 = st.integers(-(2**63), 2**63 - 1)
INDEX = st.integers(0, 2**31)


@settings(max_examples=60, deadline=None)
@given(base=I64, seeds=st.lists(I64, min_size=1, max_size=6),
       index=st.lists(INDEX, min_size=1, max_size=6))
def test_device_keys_equal_host_keys(base, seeds, index):
    n = min(len(seeds), len(index))
    seeds, index = seeds[:n], index[:n]
    s, i = torch.tensor(seeds, dtype=torch.int64), torch.tensor(index)
    assert request_keys(base, s, i).tolist() == [
        request_key(base, a, b) for a, b in zip(seeds, index)]
    assert acceptance_keys(base, s, i).tolist() == [
        acceptance_key(base, a, b) for a, b in zip(seeds, index)]
    # [K, S] steps against [S] seeds, as a decode window and a verify
    # dispatch broadcast them (int32 indices, as the engine keeps them)
    steps = torch.arange(3, dtype=torch.int32)[:, None] + torch.tensor(
        [min(x, 2**31 - 4) for x in index], dtype=torch.int32)
    got = request_keys(base, s, steps)
    assert got.shape == (3, n)
    assert got.tolist() == [[request_key(base, a, int(b)) for a, b in
                             zip(seeds, row)] for row in steps.tolist()]


PS, PMAX, NPOOL, K = 8, 6, 30, 5


def _flush_case(quant: bool):
    """Pools of both packages with the same pages, and a flush of five
    slots: all rows valid, none (a resident slot), a prefix whose first
    dropped row is a page's birth, a slot whose rows run past its live
    pages onto sentinel entries (those rows not valid), an empty slot
    (a table of sentinels)."""
    rng = np.random.default_rng(7)
    hkv, c, layers = 2, 16, 2
    start = np.asarray([4, 9, 6, 14, 0], np.int32)
    n_valid = [5, 0, 2, 2, 0]
    live = [2, 3, 2, 2, 0]  # slot 3: pages for positions < 16 only
    bt = np.full((5, PMAX), NPOOL, np.int32)
    perm = rng.permutation(NPOOL)
    at = 0
    for i, n in enumerate(live):
        bt[i, :n] = perm[at : at + n]
        at += n
    valid = np.zeros((5, K), bool)
    for i, n in enumerate(n_valid):
        valid[i, :n] = True
    assert (start[0] + 4) % PS == 0  # slot 0's last row: a birth
    assert (start[2] + 2) % PS == 0  # slot 2's first dropped row: a birth
    shape = (layers, NPOOL, hkv, c, PS)
    if quant:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        sk, sv = (np.exp2(rng.integers(-9, -3, shape[:3])).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        sk = sv = None
    jpool = jpaged.PagedKVPool(
        k=jnp.asarray(k), v=jnp.asarray(v), page_size=PS,
        scale_k=None if sk is None else jnp.asarray(sk),
        scale_v=None if sv is None else jnp.asarray(sv))
    pool = PagedKVPool(t(k), t(v), PS, *((None, None) if sk is None
                                         else (t(sk), t(sv))))
    rk, rv = (rng.standard_normal((layers, 5, hkv, K, c)).astype(np.float32)
              for _ in range(2))
    return jpool, pool, (rk, rv, bt, start, valid)


def _same_pool(pool, jpool):
    for a, b in ((pool.k, jpool.k), (pool.v, jpool.v)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if jpool.scale_k is not None:
        for a, b in ((pool.scale_k, jpool.scale_k),
                     (pool.scale_v, jpool.scale_v)):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          np.asarray(b).view(np.int32))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_flush_recent_matches_jax_with_dropped_rows(quant):
    jpool, pool, (rk, rv, bt, start, valid) = _flush_case(quant)
    before = [a.clone() for a in (pool.k, pool.v)]
    planes = None if not quant else pool.scale_k.clone()
    jnew = jpaged.flush_recent(jpool, jnp.asarray(rk), jnp.asarray(rv),
                               jnp.asarray(bt), jnp.asarray(start),
                               jnp.asarray(valid))
    flush_recent(pool, t(rk), t(rv), t(bt), t(start), t(valid))
    _same_pool(pool, jnew)
    assert not torch.equal(pool.k, before[0])  # the valid rows landed
    if quant:
        # slot 2's dropped birth row set no scale; slot 0's kept one did
        dropped, kept = bt[2, (start[2] + 2) // PS], bt[0, 1]
        assert torch.equal(pool.scale_k[:, dropped], planes[:, dropped])
        assert not torch.equal(pool.scale_k[:, kept], planes[:, kept])
    # the slots' resident lengths after the flush, as a window's harvest
    # computes them
    np.testing.assert_array_equal(start + valid.sum(1), [9, 9, 8, 16, 0])


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_flush_with_no_valid_row_leaves_the_pool(quant):
    _, pool, (rk, rv, bt, start, valid) = _flush_case(quant)
    before = [a.clone() for a in (pool.k, pool.v, pool.scale_k,
                                  pool.scale_v) if a is not None]
    flush_recent(pool, t(rk), t(rv), t(bt), t(start),
                 t(np.zeros_like(valid)))
    after = [a for a in (pool.k, pool.v, pool.scale_k, pool.scale_v)
             if a is not None]
    for a, b in zip(after, before):
        assert torch.equal(a, b)


def test_prefill_write_then_flush_at_a_page_birth_matches_jax():
    """An int8 pool written by a prefill chunk (its page births) and then
    a flush that starts a new page: JAX's planes and codes."""
    rng = np.random.default_rng(3)
    cfg = ModelConfig(block_size=64, vocab_size=32, n_layer=2, n_head=2,
                      n_embd=32)
    pool = PagedKVPool.init(cfg, NPOOL, PS, torch.float32,
                            torch.device("cpu"), kv_quant="int8")
    jpool = jpaged.PagedKVPool(
        k=jnp.asarray(pool.k.numpy()), v=jnp.asarray(pool.v.numpy()),
        page_size=PS, scale_k=jnp.asarray(pool.scale_k.numpy()),
        scale_v=jnp.asarray(pool.scale_v.numpy()))
    bt = np.full((1, PMAX), NPOOL, np.int32)
    bt[0, :3] = [4, 11, 2]
    ks, vs = (rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
              for _ in range(2))
    write_token_rows(pool, t(ks), t(vs), t(bt[0]), 0, 13)
    jpool = jpaged.write_token_rows(
        jpool, jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(bt[0]),
        jnp.asarray(0, jnp.int32), jnp.asarray(13, jnp.int32))
    rk, rv = (rng.standard_normal((2, 1, 2, K, 16)).astype(np.float32)
              for _ in range(2))
    start = np.asarray([13], np.int32)
    valid = np.asarray([[True, True, True, True, False]])  # 13..16: a birth
    flush_recent(pool, t(rk), t(rv), t(bt), t(start), t(valid))
    jpool = jpaged.flush_recent(jpool, jnp.asarray(rk), jnp.asarray(rv),
                                jnp.asarray(bt), jnp.asarray(start),
                                jnp.asarray(valid))
    _same_pool(pool, jpool)


class _Refuse(TorchDispatchMode):
    """Refuses the operations a CUDA graph cannot hold (a host read of a
    device value, a shape made from one, host data, a copy to another
    device), counting the rest."""

    REFUSED = {"aten::nonzero", "aten::_local_scalar_dense",
               "aten::is_nonzero", "aten::masked_select", "aten::_unique",
               "aten::_unique2", "aten::unique_dim",
               "aten::unique_consecutive", "aten::unique_dim_consecutive",
               "aten::lift_fresh", "aten::lift_fresh_copy"}

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in self.REFUSED:
            raise AssertionError(f"{name} inside a program")
        if name in ("aten::_to_copy", "aten::copy_"):
            src = args[1] if name == "aten::copy_" else args[0]
            dst = (args[0].device if name == "aten::copy_"
                   else kwargs.get("device") or src.device)
            if torch.device(dst) != src.device:
                raise AssertionError(f"{name} from {src.device} to {dst}")
        self.ops += 1
        return func(*args, **kwargs)


def _guarded(monkeypatch):
    """Every Program.run of the test under :class:`_Refuse`; returns the
    list of per-run op counts."""
    runs = []
    run = Program.run

    def guarded(self, body):
        with _Refuse() as mode:
            run(self, body)
        runs.append((self.key[0], mode.ops))

    monkeypatch.setattr(Program, "run", guarded)
    return runs


MOE = dict(MHA, mlp="moe", moe_experts=4, moe_capacity=1.0)
SAMPLED = dict(temperature=0.8, top_k=12, seed=3)


class _SoftDrafts:
    """Soft drafts from a fixed distribution (seeded per request and
    context length)."""

    soft = True

    def __init__(self, vocab):
        w = np.exp(-0.3 * np.arange(vocab))
        self.q = w / w.sum()

    def propose_soft(self, ctx, n, seed):
        rng = np.random.default_rng([seed, len(ctx)])
        toks = [int(x) for x in rng.choice(self.q.size, size=n, p=self.q)]
        return toks, np.tile(self.q.astype(np.float32), (n, 1))


CASES = {
    "greedy": dict(cfg=MHA),
    "sampled": dict(cfg=MHA, **SAMPLED),
    "greedy_int8": dict(cfg=MHA, quant="int8", kv_quant="int8"),
    "sampled_int8": dict(cfg=MHA, quant="int8", kv_quant="int8", **SAMPLED),
    "greedy_moe": dict(cfg=MOE),
    "sampled_moe": dict(cfg=MOE, **SAMPLED),
}


def _prompts(vocab):
    rng = np.random.default_rng(0)
    motif = rng.integers(0, vocab, size=4)
    # repetitive prompts, so the n-gram proposer drafts and some accept
    reps = [np.tile(motif, 5)[: n].astype(np.int32) for n in (14, 19)]
    return reps + [rng.integers(0, vocab, size=n).astype(np.int32)
                   for n in (5, 23, 9)]


@pytest.mark.parametrize("spec", [0, 3], ids=["window", "verify"])
@pytest.mark.parametrize("case", list(CASES))
def test_programs_run_with_no_host_read(monkeypatch, case, spec):
    kw = dict(CASES[case])
    _, tm, _ = model_pair(kw.pop("cfg"), gain=1.0)
    prompts = _prompts(tm.config.vocab_size)
    serve = dict(slots=2, window=3, page_size=8, speculate=spec,
                 device="cpu", **kw)
    runs = _guarded(monkeypatch)
    got = [list(x) for x in generate_served(tm, prompts, 10, **serve)]
    kinds = {k for k, _ in runs}
    # every prefill chunk is a program too
    assert kinds == {"prefill_chunk", "verify" if spec else "decode_window"}
    assert all(n > 0 for _, n in runs)  # the mode saw the body's ops
    # the eager twin (the body without the program's run) streams alike
    monkeypatch.setattr(Program, "run", Program.run_eager)
    assert [list(x) for x in generate_served(tm, prompts, 10,
                                             **serve)] == got


def test_soft_draft_programs_run_with_no_host_read(monkeypatch):
    _, tm, _ = model_pair(MHA, gain=1.0)
    runs = _guarded(monkeypatch)
    eng = ServingEngine(tm, slots=2, window=3, page_size=8, speculate=3,
                        proposer=_SoftDrafts(MHA["vocab_size"]),
                        device="cpu", **SAMPLED)
    for i, p in enumerate(_prompts(MHA["vocab_size"])):
        eng.submit(p, 10, seed=i)
    eng.run()
    assert eng.spec_drafted > 0 and runs
    (key,) = [k for k in eng._programs if k[0] == "verify"]
    assert key[-1] is True  # soft drafts: the probs input
    prog = eng._programs[key]
    assert prog.probs.shape == (2, 3, MHA["vocab_size"])


def _engine(tm, **kw):
    return ServingEngine(tm, **{"slots": 2, "window": 3, "page_size": 8,
                                "device": "cpu", **kw})


def test_program_keys_and_static_tensors():
    _, tm, _ = model_pair(MHA, gain=1.0)
    prompt = _prompts(MHA["vocab_size"])[2]
    a, b = _engine(tm), _engine(tm)
    for e in (a, b):
        e.submit(prompt, 4)
        e.run()
    (ka,), (kb,) = ([k for k in e._programs if k[0] == "decode_window"]
                    for e in (a, b))
    assert ka == kb == a.program_key("decode_window")
    pa_, pb_ = a._programs[ka], b._programs[kb]
    assert pa_ is not pb_
    for name, x in pa_.inputs.items():
        assert x.data_ptr() != pb_.inputs[name].data_ptr(), name
    base = a.program_key("decode_window")
    others = [
        _engine(tm, page_size=16),  # pmax 4, not 8
        _engine(tm, temperature=0.8),
        _engine(tm, temperature=0.9),
        _engine(tm, cache_dtype=torch.bfloat16),
        _engine(tm, kv_quant="int8"),
    ]
    keys = [e.program_key("decode_window") for e in others]
    assert base not in keys and len(set(keys)) == len(keys)
    spec = _engine(tm, speculate=3, **SAMPLED)
    soft = _engine(tm, speculate=3, proposer=_SoftDrafts(MHA["vocab_size"]),
                   **SAMPLED)
    assert spec.program_key("verify") != soft.program_key("verify")
    assert spec.program_key("verify")[0] == "verify"


def test_launch_recording():
    fn = pa.paged_decode_attention
    before = fn.launches
    with launches.recording() as rec:
        launches.count(fn)
        launches.count(fn)
        with launches.recording() as inner:
            launches.count(fn)
        assert inner == {fn: 1}
    assert rec == {fn: 2} and fn.launches == before
    launches.add(rec)
    launches.count(fn)
    assert fn.launches == before + 3
    fn.launches = before


def test_capturing_pauses_the_garbage_collector():
    from midgpt_tpu_torch.serving import programs

    assert gc.isenabled()
    with capturing():
        assert not gc.isenabled() and programs._CAPTURE_LOCK.locked()
    assert gc.isenabled() and not programs._CAPTURE_LOCK.locked()
    with pytest.raises(RuntimeError):
        with capturing():
            raise RuntimeError("a capture that fails")
    assert gc.isenabled() and not programs._CAPTURE_LOCK.locked()
    gc.disable()
    try:
        with capturing():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
