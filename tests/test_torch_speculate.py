"""The port's self-speculative decoding against the JAX package's.

- the n-gram proposer drafts what the JAX proposer drafts, on its cases
  and on seeded random and periodic contexts;
- the verify attention's plain version (which the wrapper runs for CPU
  tensors) against the JAX Pallas verify kernel in interpret mode, and
  ``verify_tokens_paged`` against the JAX one through that kernel, f32:
  1e-5 (the frameworks sum in different orders), layer 0's K/V rows
  1e-6;
- the acceptance arithmetic (``target_probs``, ``acceptance_mask``,
  ``residual_logits``) against JAX's at 1e-6, and the identity that makes
  rejection sampling exact: accept-or-resample draws the target;
- greedy spec-on streams equal the JAX engine's spec-on streams and the
  port's spec-off streams token for token: MHA and GQA, repetitive and
  random prompts, oracle and anti-oracle proposers, EOS inside a verify
  dispatch, the budget clamp, an f32 model over a bf16 pool;
- sampled spec-on streams keep the scheduling contract (invariant to the
  slot count and, with the same drafts, to ``speculate``), equal spec-off
  when nothing is drafted, and draw the spec-off distribution (a Monte
  Carlo check at a tiny vocabulary). JAX's random bits are not matched.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu import sampling as jax_sampling
from midgpt_tpu.models.gpt import verify_tokens_paged as jax_verify_tokens
from midgpt_tpu.ops.paged_attn import (
    paged_verify_attention as jax_paged_verify_attention,
)
from midgpt_tpu.serving import generate_served as jax_generate_served
from midgpt_tpu.serving.speculate import NgramProposer as JaxNgramProposer
from midgpt_tpu_torch import sampling
from midgpt_tpu_torch.models.gpt import verify_tokens_paged
from midgpt_tpu_torch.ops import paged_attn as pa
from midgpt_tpu_torch.serving import (
    NgramProposer,
    ServingEngine,
    generate_served,
)

from torch_port_util import GQA, MHA, assert_pages_home, model_pair, t

torch.set_num_threads(2)

LENS = (5, 9, 17, 3, 30)
PS, PMAX, NPOOL = 8, 8, 40
W = PS * PMAX


@pytest.fixture(autouse=True)
def _no_grad():
    """These paths serve: no gradients (the parameters are trainable)."""
    with torch.no_grad():
        yield


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _rep_prompts(vocab, n, period=4, reps=6, seed=500):
    """A seeded motif tiled: text the n-gram proposer can draft against."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(0, vocab, size=period), reps).astype(np.int32)
            for _ in range(n)]


def _engine(tm, **kw):
    kw = {"slots": 2, "page_size": 8, "window": 4, "device": "cpu", **kw}
    return ServingEngine(tm, **kw)


def _drain(eng, prompts, n_new, check=None, **submit):
    rids = [eng.submit(p, n_new, seed=i, **submit)
            for i, p in enumerate(prompts)]
    steps = 0
    while eng.has_work:
        eng.step()
        eng.alloc.check()
        if check is not None:
            check(eng)
        steps += 1
    assert_pages_home(eng)  # every page home
    return [list(map(int, eng.finished[r].tokens)) for r in rids]


# -- the proposer ----------------------------------------------------------


def test_ngram_proposer_cases():
    """The JAX package's cases (tests/test_serving.py)."""
    p = NgramProposer(max_ngram=3, min_ngram=1)
    assert p.propose([1, 2, 3, 1, 2, 3, 1, 2, 3], 4) == [2, 3, 1, 2]
    assert p.propose(list(range(10, 30)), 4) == []
    assert p.propose([5], 4) == []
    assert p.propose([7, 7, 7, 7], 3) == [7]
    assert p.propose([7] * 8, 3) == [7, 7, 7]
    with pytest.raises(ValueError):
        NgramProposer(max_ngram=1, min_ngram=2)


@pytest.mark.parametrize("max_ngram,min_ngram,n",
                         [(4, 1, 4), (3, 2, 2), (2, 1, 6), (5, 3, 3)])
def test_ngram_proposer_matches_jax(max_ngram, min_ngram, n):
    ours = NgramProposer(max_ngram, min_ngram)
    ref = JaxNgramProposer(max_ngram, min_ngram)
    rng = np.random.default_rng(max_ngram * 10 + min_ngram)
    drafted = 0
    for i in range(200):
        length = int(rng.integers(1, 40))
        if i % 2:  # periodic, with a few substitutions
            motif = rng.integers(0, 6, size=int(rng.integers(1, 6)))
            ctx = np.resize(motif, length)
            flips = rng.integers(0, length, size=int(rng.integers(0, 3)))
            ctx[flips] = rng.integers(0, 6, size=flips.size)
        else:
            ctx = rng.integers(0, 5, size=length)
        ctx = [int(x) for x in ctx]
        got = ours.propose(ctx, n)
        assert got == ref.propose(ctx, n), ctx
        drafted += bool(got)
    assert drafted > 50  # the contexts do exercise the matcher


# -- the verify attention --------------------------------------------------


def _verify_inputs(hkv, g, c, tt, starts, seed=0, layers=2):
    rng = np.random.default_rng(seed)
    s = len(starts)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    q = f(s, hkv, g, tt, c)
    kc, vc = f(s, hkv, tt, c), f(s, hkv, tt, c)
    pk, pv = f(layers, NPOOL, hkv, c, PS), f(layers, NPOOL, hkv, c, PS)
    bt = np.full((s, PMAX), NPOOL, np.int32)
    perm = rng.permutation(NPOOL)
    for i, n in enumerate(starts):
        # the pages the dispatch's rows will land in are allocated too
        live = -(-(n + tt) // PS)
        bt[i, :live] = perm[i * PMAX : i * PMAX + live]
    return q, kc, vc, pk, pv, bt, np.asarray(starts, np.int32)


@pytest.mark.parametrize("tt", [1, 3, 5])
@pytest.mark.parametrize("hkv,g", [(4, 1), (2, 2)], ids=["mha", "gqa"])
def test_verify_reference_matches_jax_pallas_kernel(hkv, g, tt):
    starts = [0, 13, 32, W - tt]  # empty, partial page, aligned, near full
    q, kc, vc, pk, pv, bt, st = _verify_inputs(hkv, g, 16, tt, starts)
    layer = 1
    ref = jax_paged_verify_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, pk, pv, bt, st)), layer)
    before = pa.paged_verify_attention.launches
    got = pa.paged_verify_attention(
        *(t(a) for a in (q, kc, vc, pk, pv, bt, st)), layer)
    assert pa.paged_verify_attention.launches == before  # CPU: no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_verify_row_equals_decode_step():
    """Row t of a verify dispatch is decode step t over the same pages
    with the rows as the window's recent rows (the plain versions)."""
    tt = 4
    q, kc, vc, pk, pv, bt, st = (t(a) for a in _verify_inputs(
        2, 2, 16, tt, [0, 13, 32, 40]))
    got = pa.paged_verify_attention(q, kc, vc, pk, pv, bt, st, 0)
    for r in range(tt):
        step = pa.paged_decode_attention(q[:, :, :, r].contiguous(), pk, pv,
                                         bt, st, kc, vc, r, 0)
        torch.testing.assert_close(got[:, :, :, r], step, rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("bad", ["q_rank", "self_shape", "start_dtype",
                                 "self_dtype", "layer"])
def test_verify_wrapper_rejects_bad_inputs(bad):
    args = [t(a) for a in _verify_inputs(2, 2, 16, 3, [0, 13, 32, 40])]
    layer = 0
    if bad == "q_rank":
        args[0] = args[0][:, :, 0]
    elif bad == "self_shape":
        args[1] = args[1][:, :, :2]
    elif bad == "start_dtype":
        args[6] = args[6].long()
    elif bad == "self_dtype":
        args[2] = args[2].double()
    else:
        layer = 2
    with pytest.raises(ValueError):
        pa.paged_verify_attention(*args, layer)


def test_verify_shared_memory_budget():
    """A verify split block holds the G T query rows and the T candidate
    rows over one split's pages: openwebtext (G=1, T=5, C=64, bf16 pool)
    ~20 KB, the GQA check geometry (G=4, T=8, C=128, f32 pool) ~100 KB,
    whatever the table; a 100k-token table at the GQA geometry is
    accepted by the check with the shared memory of a 1k-token one."""
    owt = pa.verify_smem_bytes(1, 5, 64, 16, 2, 2)
    assert owt == pa.smem_bytes(5, 64, 16, 2, 5, 2) == (
        2 * 4 * 64 * 16 * 2 + 2 * 5 * 64 * 2
        + 4 * 5 * (64 + 64 + 5 + 1) + 12 * 4 + 4)
    gqa = pa.verify_smem_bytes(4, 8, 128, 16, 4, 4)
    assert 95_000 < gqa <= pa.SMEM_LIMIT
    for pmax in (64, 1024, 6250):
        assert pa.kernel_plan(4 * 8, 128, 16, pmax, torch.float32,
                              8)["smem"] == gqa


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha", "gqa"])
def test_verify_tokens_paged_matches_jax(cfg):
    jm, tm, _ = model_pair(cfg)
    c = cfg["n_embd"] // cfg["n_head"]
    hkv = cfg.get("n_kv_head") or cfg["n_head"]
    tt = 5
    _, _, _, pk, pv, bt, st = _verify_inputs(hkv, 1, c, tt,
                                             [0, 13, 32, W - tt], seed=2)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg["vocab_size"], size=(len(st), tt)).astype(
        np.int32)
    rope_len = cfg["block_size"]
    ref, rks, rvs = jax_verify_tokens(
        jm, *(jnp.asarray(a) for a in (toks, st, pk, pv, bt)), rope_len,
        paged_kernel="pallas")
    got, ks, vs = verify_tokens_paged(
        tm, *(t(a) for a in (toks, st, pk, pv, bt)), rope_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # layer 0's rows come from the embeddings through one projection,
    # QK-norm and RoPE: 1e-6; deeper layers' rows carry the attention
    # above them, summed in another order: 1e-5, as the logits
    for a, b in ((ks, rks), (vs, rvs)):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_allclose(a[0], b[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(a[1:], b[1:], rtol=1e-5, atol=1e-5)


# -- the acceptance arithmetic ---------------------------------------------


@pytest.mark.parametrize("top_k", [None, 5])
@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_acceptance_arithmetic_matches_jax(temperature, top_k):
    rng = np.random.default_rng(11)
    s, n, v = 4, 3, 24
    logits = (3.0 * rng.standard_normal((s, n, v))).astype(np.float32)
    q = rng.dirichlet(np.ones(v), size=(s, n)).astype(np.float32)
    u = rng.uniform(size=(s, n)).astype(np.float32)
    p = sampling.target_probs(t(logits), temperature, top_k)
    p_ref = jax_sampling.target_probs(jnp.asarray(logits), temperature, top_k)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=1e-6,
                               atol=1e-6)
    d = rng.integers(0, v, size=(s, n))
    p_sel = np.take_along_axis(p.numpy(), d[..., None], -1)[..., 0]
    q_sel = np.take_along_axis(q, d[..., None], -1)[..., 0]
    acc = sampling.acceptance_mask(t(u), t(q_sel), t(p_sel))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(
        jax_sampling.acceptance_mask(jnp.asarray(u), jnp.asarray(q_sel),
                                     jnp.asarray(p_sel))))
    for qq in (q, np.eye(v, dtype=np.float32)[d]):  # dense and one-hot q
        out, mass = sampling.residual_logits(p, t(qq), temperature)
        out_ref, mass_ref = jax_sampling.residual_logits(
            jnp.asarray(p.numpy()), jnp.asarray(qq), temperature)
        np.testing.assert_allclose(out.numpy(), np.asarray(out_ref),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(mass.numpy(), np.asarray(mass_ref),
                                   rtol=1e-6, atol=1e-6)
    # exactness with a one-hot draft d: accept with p(d), else resample
    # from the residual, draws the target p
    out, mass = sampling.residual_logits(p, t(np.eye(v, dtype=np.float32)[d]),
                                         temperature)
    resid = torch.exp(out / temperature)
    pd = torch.from_numpy(p_sel)[..., None]
    onehot = torch.from_numpy(np.eye(v, dtype=np.float32)[d])
    mixed = pd * onehot + (1 - pd) * resid
    torch.testing.assert_close(mixed, p, rtol=1e-6, atol=1e-6)


def test_acceptance_uniforms_are_a_substream():
    """One uniform in (0, 1) per key, a function of its key alone, and not
    the categorical stream's first uniform at the same position."""
    keys = [sampling.acceptance_key(3, seed, i) for seed in (0, 1)
            for i in range(50)]
    u = sampling.acceptance_uniforms(torch.tensor(keys))
    assert u.shape == (100,) and u.dtype == torch.float32
    assert (u > 0).all() and (u < 1).all()
    assert u.unique().numel() == 100
    assert torch.equal(sampling.acceptance_uniforms(torch.tensor(keys[7])),
                       u[7])
    plain = sampling._uniforms(torch.tensor(
        [sampling.request_key(3, 0, i) for i in range(50)]), 1)[:, 0]
    assert not torch.equal(plain, u[:50])
    assert abs(u.mean().item() - 0.5) < 0.1


# -- greedy streams --------------------------------------------------------


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha", "gqa"])
def test_greedy_spec_streams_match_jax_engine_and_spec_off(cfg):
    jm, tm, _ = model_pair(cfg)
    vocab = cfg["vocab_size"]
    prompts = _prompts(vocab) + _rep_prompts(vocab, 2)
    kw = dict(slots=2, window=4, page_size=8)
    ref = jax_generate_served(
        jm, prompts, 12, prefix_cache=False, paged_kernel="pallas",
        cache_dtype=jnp.float32, speculate=4, **kw)
    on = generate_served(tm, prompts, 12, speculate=4, device="cpu", **kw)
    off = generate_served(tm, prompts, 12, device="cpu", **kw)
    for a, b, c in zip(ref, on, off):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, c)
    assert len({tuple(x) for x in on}) > 1


def test_repetitive_prompt_emits_more_than_one_token_per_dispatch():
    _, tm, _ = model_pair(MHA, gain=1.0)
    prompt = _rep_prompts(MHA["vocab_size"], 1)[0]
    n_new = 20
    off = _drain(_engine(tm, slots=1), [prompt], n_new)
    eng = _engine(tm, slots=1, speculate=4)
    on = _drain(eng, [prompt], n_new)
    assert on == off
    st = eng.stats()
    assert st["tokens_generated"] == n_new
    assert st["tokens_per_dispatch"] > 1.0, st
    assert st["spec_accepted_tokens"] > 0
    assert st["verify_dispatches"] == st["decode_dispatches"] < n_new


class _OracleProposer:
    """Drafts the true continuation (from the spec-off streams)."""

    def __init__(self, seqs):
        self.seqs = [list(map(int, x)) for x in seqs]

    def propose(self, ctx, n):
        ctx = list(map(int, ctx))
        for full in self.seqs:
            if full[: len(ctx)] == ctx and len(full) > len(ctx) + 1:
                return full[len(ctx) + 1 : len(ctx) + 1 + n]
        return []


class _AntiOracleProposer(_OracleProposer):
    """Every draft wrong: each verify dispatch rejects them all."""

    def __init__(self, seqs, vocab):
        super().__init__(seqs)
        self.vocab = vocab

    def propose(self, ctx, n):
        return [(x + 1) % self.vocab for x in super().propose(ctx, n)]


def test_oracle_proposer_hits_the_dispatch_floor():
    _, tm, _ = model_pair(GQA)
    prompts = _prompts(GQA["vocab_size"], lens=(7, 7))
    n_new, spec = 12, 4
    off = _drain(_engine(tm), prompts, n_new)
    seqs = [list(p) + o for p, o in zip(prompts, off)]
    eng = _engine(tm, speculate=spec, proposer=_OracleProposer(seqs))
    on = _drain(eng, prompts, n_new)
    assert on == off
    st = eng.stats()
    assert st["decode_dispatches"] == -(-n_new // (spec + 1))
    assert st["spec_acceptance_rate"] == 1.0
    assert all(r.spec_k == spec for r in eng.finished.values())


def test_anti_oracle_proposer_rolls_back_every_draft():
    _, tm, _ = model_pair(MHA)
    vocab = MHA["vocab_size"]
    prompts = _prompts(vocab, lens=(6, 7, 8, 9))
    n_new = 12
    off = _drain(_engine(tm), prompts, n_new)
    seqs = [list(p) + o for p, o in zip(prompts, off)]

    def check(eng):
        for s in range(eng.slots):
            if eng.slot_req[s] is not None:
                # the pool never runs ahead of the verified context
                assert int(eng.pooled_len[s]) <= len(eng.slot_ctx[s])

    eng = _engine(tm, speculate=4, proposer=_AntiOracleProposer(seqs, vocab))
    on = _drain(eng, prompts, n_new, check=check)
    assert on == off
    assert eng.spec_drafted > 0 and eng.spec_accepted == 0
    assert all(r.spec_k == 1 for r in eng.finished.values())


def test_eos_inside_a_verify_dispatch_stops_where_spec_off_does():
    """The EOS is a token first emitted at a row other than 0 of a verify
    dispatch: with the oracle proposer each dispatch emits 5 rows, so
    the stop lands inside one; the n-gram proposer must stop there too."""
    _, tm, _ = model_pair(MHA)
    prompt = _prompts(MHA["vocab_size"])[2]
    full = generate_served(tm, [prompt], 16, page_size=8, device="cpu")[0]
    first = {}
    for i, x in enumerate(full.tolist()):
        first.setdefault(x, i)
    at = min(i for i in first.values() if i > 5 and i % 5)
    eos = int(full[at])
    off = generate_served(tm, [prompt], 16, eos_id=eos, page_size=8,
                          device="cpu")[0]
    np.testing.assert_array_equal(off, full[: at + 1])
    oracle = _OracleProposer([list(prompt) + full.tolist()])
    for proposer in (oracle, None):
        eng = _engine(tm, slots=1, speculate=4, proposer=proposer)
        on = _drain(eng, [prompt], 16, eos_id=eos)[0]
        np.testing.assert_array_equal(on, off)
    eng = _engine(tm, slots=1, speculate=4, proposer=oracle)
    _drain(eng, [prompt], 16, eos_id=eos)
    assert eng.decode_dispatches == at // 5 + 1


@pytest.mark.parametrize("n_new", [1, 2])
def test_budget_clamps_the_draft(n_new):
    _, tm, _ = model_pair(MHA, gain=1.0)
    prompts = _rep_prompts(MHA["vocab_size"], 3)
    off = _drain(_engine(tm), prompts, n_new)
    eng = _engine(tm, speculate=4)
    on = _drain(eng, prompts, n_new)
    assert on == off and all(len(x) == n_new for x in on)
    # one token left: no draft can be emitted, none is drafted
    assert eng.spec_drafted <= (n_new - 1) * len(prompts)


def test_f32_model_over_bf16_pool_spec_equals_spec_off():
    """The verify rows are rounded to the pool dtype before scoring, as
    the decode window's recent rows are."""
    _, tm, _ = model_pair(GQA)
    prompts = _prompts(GQA["vocab_size"]) + _rep_prompts(GQA["vocab_size"], 1)
    kw = dict(slots=2, page_size=8, cache_dtype=torch.bfloat16, device="cpu")
    off = generate_served(tm, prompts, 12, **kw)
    on = generate_served(tm, prompts, 12, speculate=4, **kw)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(b, a)


def test_constructor_errors():
    _, tm, _ = model_pair(MHA)
    eng = _engine(tm, temperature=0.8, speculate=4)
    assert eng.speculate == 4 and isinstance(eng.proposer, NgramProposer)
    assert _engine(tm).proposer is None
    for bad in (-1, MHA["block_size"]):
        with pytest.raises(ValueError, match="speculate"):
            _engine(tm, speculate=bad)
    with pytest.raises(ValueError, match="soft"):
        _engine(tm, speculate=4, proposer=_SoftProposer(MHA["vocab_size"]))
    with pytest.raises(ValueError, match="temperature"):
        _engine(tm, temperature=-0.5)
    with pytest.raises(ValueError, match="top_k"):
        _engine(tm, temperature=0.8, top_k=0)


# -- sampled streams -------------------------------------------------------


class _EmptyProposer:
    def propose(self, ctx, n):
        return []


class _SelfDraft:
    """Drafts the model's own greedy continuation of the context (its
    first token guesses the skipped position ``len(ctx)``): deterministic
    in the context, and often accepted. ``limit`` caps the draft, so
    engines with different ``speculate`` get the same drafts."""

    def __init__(self, model, limit=None):
        self.model, self.limit = model, limit

    def propose(self, ctx, n):
        n = n if self.limit is None else min(n, self.limit)
        ids = [int(x) for x in ctx]
        for _ in range(n + 1):
            logits = self.model(torch.tensor([ids]))[0, -1]
            ids.append(int(torch.argmax(logits)))
        return ids[len(ctx) + 1 :]


class _SoftProposer:
    """Samples each draft from a fixed distribution ``q`` with a generator
    seeded by (request seed, context length): honest soft drafts."""

    soft = True

    def __init__(self, vocab, tilt=0.3):
        w = np.exp(-tilt * np.arange(vocab))
        self.q = (w / w.sum()).astype(np.float64)

    def propose_soft(self, ctx, n, seed):
        rng = np.random.default_rng([seed, len(ctx)])
        toks = [int(x) for x in rng.choice(self.q.size, size=n, p=self.q)]
        return toks, np.tile(self.q.astype(np.float32), (n, 1))


SAMPLED = dict(temperature=0.8, top_k=12, seed=3)


def _sampled(tm, prompts, lens, **kw):
    eng = _engine(tm, **{**SAMPLED, **kw})
    rids = [eng.submit(p, n, seed=i) for i, (p, n) in
            enumerate(zip(prompts, lens))]
    fin = eng.run()
    assert_pages_home(eng)
    return [list(map(int, fin[r].tokens)) for r in rids], eng


def test_sampled_spec_streams_keep_the_scheduling_contract():
    _, tm, _ = model_pair(GQA, gain=1.0)
    vocab = GQA["vocab_size"]
    prompts = _rep_prompts(vocab, 2) + _prompts(vocab, lens=(9, 14))
    lens = [10, 12, 8, 9]
    prop = _SelfDraft(tm)
    base, eng = _sampled(tm, prompts, lens, slots=2, speculate=4,
                         proposer=prop)
    # both the accept and the reject-and-resample paths ran
    assert 0 < eng.spec_accepted < eng.spec_drafted
    assert all(len(x) == n for x, n in zip(base, lens))
    for slots in (1, 3):
        assert _sampled(tm, prompts, lens, slots=slots, speculate=4,
                        proposer=prop)[0] == base
    one = [_sampled(tm, prompts, lens, slots=slots, speculate=spec,
                    proposer=_SelfDraft(tm, limit=1))
           for slots, spec in ((2, 2), (3, 4))]
    assert one[0][0] == one[1][0] and one[0][1].spec_accepted > 0
    ngram = _sampled(tm, prompts, lens, slots=2, speculate=4)[0]
    off, _ = _sampled(tm, prompts, lens, slots=2)
    # row 0 of the first dispatch is spec-off's first token
    assert [x[0] for x in base] == [x[0] for x in ngram] == [x[0] for x in off]
    other, _ = _sampled(tm, prompts, lens, slots=2, speculate=4,
                        proposer=prop, seed=SAMPLED["seed"] + 1)
    assert other != base


def test_sampled_spec_without_drafts_is_spec_off():
    _, tm, _ = model_pair(MHA)
    prompts = _prompts(MHA["vocab_size"])
    lens = [8, 10, 6, 7, 9]
    off, _ = _sampled(tm, prompts, lens)
    on, eng = _sampled(tm, prompts, lens, speculate=4,
                       proposer=_EmptyProposer())
    assert on == off and eng.spec_drafted == 0


def test_soft_proposer_runs_the_dense_path():
    _, tm, _ = model_pair(MHA, gain=1.0)
    prompts = _rep_prompts(MHA["vocab_size"], 2)
    prop = _SoftProposer(MHA["vocab_size"])
    a, eng = _sampled(tm, prompts, [10, 12], speculate=3, proposer=prop)
    assert eng._soft_drafts and eng.spec_drafted > 0
    assert _sampled(tm, prompts, [10, 12], slots=1, speculate=3,
                    proposer=prop)[0] == a


TINY = dict(block_size=32, vocab_size=6, n_layer=1, n_head=2, n_embd=32)


@pytest.mark.parametrize("proposer", ["one_hot", "soft"])
def test_sampled_spec_draws_the_spec_off_distribution(proposer):
    """Monte Carlo at vocabulary 6: over 600 request seeds, the first
    drafted position's marginal matches spec-off's. Two samples of 600
    from one distribution over 6 outcomes differ in total variation by
    about 0.05; the bound is 0.12. Position 0 is spec-off's bit for bit.
    The one-hot proposer always drafts the last token id, the soft one
    samples a skewed q: both reject often, so the residual carries real
    mass."""
    _, tm, _ = model_pair(TINY, gain=0.8)
    prompt = np.asarray([1, 4, 2, 0, 3], np.int32)
    n, vocab = 600, TINY["vocab_size"]

    class OneHot:
        def propose(self, ctx, k):
            return [vocab - 1]

    prop = OneHot() if proposer == "one_hot" else _SoftProposer(vocab, 0.8)
    kw = dict(slots=64, page_size=8, temperature=1.0, top_k=None, seed=5)
    off, _ = _sampled(tm, [prompt] * n, [2] * n, **kw)
    on, eng = _sampled(tm, [prompt] * n, [2] * n, speculate=2, proposer=prop,
                       **kw)
    assert eng.spec_drafted >= n and 0.1 < eng.spec_accepted / n < 0.9
    off, on = np.asarray(off), np.asarray(on)
    np.testing.assert_array_equal(on[:, 0], off[:, 0])
    ca = np.bincount(off[:, 1], minlength=vocab) / n
    cb = np.bincount(on[:, 1], minlength=vocab) / n
    assert 0.5 * np.abs(ca - cb).sum() < 0.12
    # not a degenerate marginal
    assert (ca > 0.02).sum() >= 3 and math.isclose(cb.sum(), 1.0)
