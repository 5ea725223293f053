"""The fixed-batch sampler's programs on the CPU (``sampling.SamplerPrograms``:
the prefill, the decode step with its base and row on the device, the
merge that ends a chunk of each length, the exact re-forward step).

A 2-layer model gets the same weights in both packages
(``torch_port_util.model_pair``), f32. Checked:

- greedy streams through the programs equal JAX's ``generate`` token for
  token: both slidings, a ``chunk_len`` that leaves a partial first and
  a partial last chunk, totals below and past ``block_size`` (the plan
  of chunk lengths and the re-forward count are JAX's ``run_chunked``);
- sampled streams equal the eager sampler as it was before the programs
  (host keys per row and token, positions as ints, ``_eager_generate``
  below) bit for bit, and two seeds run through one set of programs: the
  seed is a device input, not part of the key;
- every body runs under ``test_torch_dispatch._Refuse``: no host read,
  no host tensor, no copy to another device, inside the prefill, a step,
  a merge or a re-forward, in the plan's order (each chunk's steps, then
  its merge);
- ``make_sampler`` reuses its programs across calls and keys a new
  prompt shape; the cache drops a model's programs when the model goes,
  and makes new ones when its tensors are replaced (a graph reads them
  where they were at its capture).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.sampling import generate as jax_generate
from midgpt_tpu_torch import sampling
from midgpt_tpu_torch.models import gpt as tg
from midgpt_tpu_torch.sampling import generate, make_sampler, request_key
from midgpt_tpu_torch.serving.programs import Program

from test_torch_dispatch import _Refuse
from torch_port_util import MHA, model_pair

torch.set_num_threads(2)

F32 = torch.float32
BLOCK = MHA["block_size"]


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def pair():
    return model_pair(MHA)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, MHA["vocab_size"], shape).astype(np.int32)


def _eager_generate(model, prompt, n, *, seed, temperature, top_k, sliding,
                    chunk_len):
    """The sampler before its programs: every step launched eagerly with
    host positions and host keys (``request_key(seed, row, token)``)."""
    cfg = model.config
    prompt = torch.from_numpy(prompt)
    b, p = prompt.shape
    total = p + n
    w = min(total, cfg.block_size)
    r_len = min(chunk_len, w)
    wp = -(-w // r_len) * r_len
    cache = tg.KVCache.init(cfg, b, wp, dtype=F32, device="cpu")
    logits, cache = tg.prefill(model, prompt, cache)
    rshape = (cfg.n_layer, b, cfg.kv_heads, r_len, cfg.head_dim)

    def keys(t):
        if temperature == 0.0:
            return None
        return torch.tensor([request_key(seed, i, t) for i in range(b)],
                            dtype=torch.int64)

    toks, base = [], p
    end = p + (n if sliding == "kv" else w - p)
    while base < end:
        clen = min(r_len - base % r_len, end - base)
        rk = torch.zeros(rshape, dtype=F32)
        rv = torch.zeros_like(rk)
        for r in range(clen):
            tok = sampling._draw(logits, keys(base - p + r), temperature,
                                 top_k)
            logits, rk, rv = tg.decode_step_recent(
                model, tok, base + r, cache, rk, rv, r, base, w, total)
            toks.append(tok)
        tg.merge_recent(cache, rk, rv, base % wp, clen)
        base += clen
    window = torch.cat([prompt, torch.stack(toks, 1)], 1) if toks else prompt
    for t in range(len(toks), n):
        tok = sampling._draw(logits, keys(t), temperature, top_k)
        toks.append(tok)
        window = torch.cat([window[:, 1:], tok[:, None]], dim=1)
        logits = model.project(model.hidden(
            window, attn_impl=tg.full_forward_impl(cfg))[:, -1])
    return torch.stack(toks, 1).numpy()


# (prompt, new tokens, sliding, chunk_len): 13 % 5 leaves a partial first
# chunk (2) and 13 + 2 + 5k a partial last one
CASES = {
    "below_partial_first_last": (13, 24, "exact", 5),
    "exact_past_block": (30, 50, "exact", 8),
    "kv_past_block": (30, 50, "kv", 8),
    "kv_past_block_partial": (13, 60, "kv", 5),
    "prompt_at_block": (BLOCK, 6, "exact", 4),
}


def _plan(case):
    p, n, sliding, chunk = CASES[case]
    total = p + n
    w = min(total, BLOCK)
    decodable = w - p if sliding == "exact" else n
    return sampling._chunk_plan(p, decodable, min(chunk, w)), n - decodable


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_program_streams_match_jax(pair, monkeypatch, case):
    jm, tm, _ = pair
    p, n, sliding, chunk = CASES[case]
    prompt = _tokens((3, p), 2)
    ref = np.asarray(jax_generate(
        jm, jnp.asarray(prompt), n, key=jax.random.PRNGKey(0),
        temperature=0.0, cache_dtype=jnp.float32, sliding=sliding,
        chunk_len=chunk))
    kinds = []
    run = Program.run

    def guarded(self, body):
        with _Refuse() as mode:
            run(self, body)
        assert mode.ops > 0
        kinds.append(self.key[-1])  # "prefill", "step", a merge's length

    monkeypatch.setattr(Program, "run", guarded)
    got = generate(tm, prompt, n, temperature=0.0, cache_dtype=F32,
                   sliding=sliding, chunk_len=chunk, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    plan, n_re = _plan(case)
    chunks = [k for n in plan for k in ["step"] * n + [n]]
    assert kinds == ["prefill"] + chunks + ["reforward"] * n_re
    if case == "below_partial_first_last":
        assert plan[0] < chunk and plan[-1] < chunk and chunk in plan
    if sliding == "exact" and p + n > BLOCK:
        assert n_re > 0


@pytest.mark.parametrize("case", ["below_partial_first_last",
                                  "exact_past_block", "kv_past_block"])
def test_sampled_program_streams_equal_the_eager_sampler(pair, case):
    _, tm, _ = pair
    p, n, sliding, chunk = CASES[case]
    prompt = _tokens((4, p), 3)
    kw = dict(temperature=0.8, top_k=7, sliding=sliding, chunk_len=chunk)
    got = [generate(tm, prompt, n, seed=s, cache_dtype=F32, device="cpu",
                    **kw).numpy() for s in (3, 11)]
    progs = list(sampling._SAMPLERS.values())[-1]
    for s, g in zip((3, 11), got):
        np.testing.assert_array_equal(
            g, _eager_generate(tm, prompt, n, seed=s, **kw))
    assert (got[0] != got[1]).any()
    # both seeds through one set of programs
    assert list(sampling._SAMPLERS.values())[-1] is progs
    generate(tm, prompt, n, seed=99, cache_dtype=F32, device="cpu", **kw)
    assert list(sampling._SAMPLERS.values())[-1] is progs


def test_make_sampler_reuses_its_programs(pair):
    _, tm, _ = pair
    sampler = make_sampler(12, temperature=0.0, cache_dtype=F32,
                           chunk_len=4, device="cpu")
    a = sampler(tm, _tokens((2, 10), 4))
    progs = list(sampling._SAMPLERS.values())[-1]
    b = sampler(tm, _tokens((2, 10), 4))
    assert list(sampling._SAMPLERS.values())[-1] is progs
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    # the output is the caller's: a later call does not overwrite it
    sampler(tm, _tokens((2, 10), 5))
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    sampler(tm, _tokens((2, 11), 4))  # a new prompt shape: a new key
    other = list(sampling._SAMPLERS.values())[-1]
    assert other is not progs and other.p == 11
    assert other.key[:-1] != progs.key[:-1]


def test_programs_go_with_their_model():
    _, tm, _ = model_pair(MHA, seed=3)
    generate(tm, _tokens((2, 9), 6), 5, temperature=0.0, cache_dtype=F32,
             device="cpu")
    ident = id(tm)
    assert any(k[-1] == ident for k in sampling._SAMPLERS)
    del tm
    gc.collect()
    assert not any(k[-1] == ident for k in sampling._SAMPLERS)


def test_programs_follow_the_models_tensors():
    """``load_state_dict(..., assign=True)`` replaces the model's tensors
    under the same model: the next call keys new programs, drops the
    ones of the old tensors, and samples with the new weights."""
    _, tm, _ = model_pair(MHA, seed=4)
    _, other, _ = model_pair(MHA, seed=5)
    prompt = _tokens((2, 9), 7)
    kw = dict(temperature=0.0, cache_dtype=F32, chunk_len=4, device="cpu")
    generate(tm, prompt, 6, **kw)
    old = list(sampling._SAMPLERS.values())[-1]
    tm.load_state_dict({k: v.clone() for k, v in other.state_dict().items()},
                       assign=True)
    got = generate(tm, prompt, 6, **kw)
    new = list(sampling._SAMPLERS.values())[-1]
    assert new is not old and new.key[:-2] == old.key[:-2]
    assert old.key not in sampling._SAMPLERS
    np.testing.assert_array_equal(got.numpy(),
                                  generate(other, prompt, 6, **kw).numpy())
