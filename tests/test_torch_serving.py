"""The port's serving engine against the JAX package's, end to end.

- greedy streams from ``generate_served`` equal the JAX engine's token for
  token (prefix cache off, the Pallas decode kernel in interpret mode, an
  f32 pool), on prompts of mixed lengths with more prompts than slots so
  requests are admitted mid-run;
- the page allocator's invariants hold after every step and every page is
  free once the engine drains;
- sampled streams (T=0.8, top-k) do not depend on the slot count or the
  window: each position's noise is keyed by (request seed, token index).
  They are not compared with JAX, whose random bits cannot be matched;
- the allocator's three page states (free, held, cached) follow the JAX
  allocator's op for op;
- the sampling noise: each row a function of its key alone, uniform
  and Gumbel-distributed, with no int64 overflow at the largest key;
- EOS, budget, prompt cropping and the page-exhaustion error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.serving import generate_served as jax_generate_served
from midgpt_tpu.serving.paged import PageAllocator as JaxPageAllocator
from midgpt_tpu_torch.sampling import _mix32, gumbel_noise, request_key
from midgpt_tpu_torch.serving import PageAllocator, ServingEngine, generate_served

from torch_port_util import GQA, MHA, model_pair

torch.set_num_threads(2)

LENS = (5, 9, 17, 3, 30)


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


@pytest.mark.parametrize("cfg,window", [(MHA, 4), (GQA, 3)],
                         ids=["mha_w4", "gqa_w3"])
def test_greedy_streams_match_jax_engine(cfg, window):
    jm, tm, _ = model_pair(cfg)
    prompts = _prompts(cfg["vocab_size"])
    kw = dict(slots=2, window=window, page_size=8)
    ref = jax_generate_served(
        jm, prompts, 12, prefix_cache=False, paged_kernel="pallas",
        cache_dtype=jnp.float32, **kw,
    )
    got = generate_served(tm, prompts, 12, device="cpu", **kw)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    # a random model that emits one repeated token would prove little
    assert len({tuple(x) for x in got}) > 1


def _drain_checked(eng):
    steps = 0
    while eng.has_work:
        eng.step()
        eng.alloc.check()
        steps += 1
    return steps


def test_allocator_invariants_hold_every_step():
    _, tm, _ = model_pair(MHA)
    eng = ServingEngine(tm, slots=2, window=4, page_size=8, device="cpu")
    rids = [eng.submit(p, 10) for p in _prompts(MHA["vocab_size"])]
    assert _drain_checked(eng) > len(rids) // 2
    assert eng.alloc.free_pages == eng.alloc.num_pages
    assert eng.alloc.held_pages == 0
    assert all(len(eng.finished[r].tokens) == 10 for r in rids)
    st = eng.stats()
    assert st["tokens_generated"] == 10 * len(rids)
    assert st["free_pages"] == eng.alloc.num_pages


def test_sampled_streams_invariant_to_slots_and_window():
    _, tm, _ = model_pair(GQA)
    prompts = _prompts(GQA["vocab_size"])
    kw = dict(temperature=0.8, top_k=12, seed=7, page_size=8, device="cpu")
    base = generate_served(tm, prompts, 10, slots=2, window=4, **kw)
    for slots, window in [(1, 1), (3, 2), (5, 5)]:
        got = generate_served(tm, prompts, 10, slots=slots, window=window,
                              **kw)
        for a, b in zip(base, got):
            np.testing.assert_array_equal(b, a)
    greedy = generate_served(tm, prompts, 10, slots=2, page_size=8,
                             device="cpu")
    assert any(not np.array_equal(a, b) for a, b in zip(base, greedy))
    other_seed = generate_served(tm, prompts, 10, slots=2, window=4,
                                 **dict(kw, seed=8))
    assert any(not np.array_equal(a, b) for a, b in zip(base, other_seed))


@pytest.mark.parametrize("vocab", [96, 50304])
def test_gumbel_noise_rows_depend_on_their_key_alone(vocab):
    keys = [request_key(0, seed, i) for seed in (0, 7) for i in (0, 1, 9)]
    keys.append((1 << 63) - 1)  # the largest key: no product overflows
    batch = gumbel_noise(torch.tensor(keys), vocab)
    assert batch.shape == (len(keys), vocab) and batch.dtype == torch.float32
    assert torch.isfinite(batch).all()
    for i, k in enumerate(keys):
        assert torch.equal(gumbel_noise(torch.tensor(k), vocab), batch[i])
    # distinct keys draw distinct rows
    assert len({tuple(row.tolist()) for row in batch}) == len(keys)
    # Gumbel(0, 1): mean = Euler's constant, variance pi^2 / 6
    if vocab > 1000:
        assert abs(batch.mean().item() - 0.5772) < 0.01
        assert abs(batch.var().item() - 1.6449) < 0.03


def test_noise_hash_is_a_bijection_and_uniform():
    x = torch.arange(1 << 16, dtype=torch.int64) * 65537  # spread inputs
    h = _mix32(x & ((1 << 32) - 1))
    assert h.min().item() >= 0 and h.max().item() < (1 << 32)
    assert h.unique().numel() == x.numel()
    # the 24 bits the uniform uses fill 16 equal bins evenly
    bins = torch.bincount((h >> 28), minlength=16).float()
    expected = x.numel() / 16
    assert ((bins - expected) ** 2 / expected).sum().item() < 40.0


def test_eos_ends_a_request_after_emitting_it():
    _, tm, _ = model_pair(MHA)
    prompts = _prompts(MHA["vocab_size"])[:2]
    full = generate_served(tm, prompts, 12, slots=2, page_size=8,
                           device="cpu")
    eos = int(full[0][2])
    cut = generate_served(tm, prompts, 12, slots=2, page_size=8,
                          eos_id=eos, device="cpu")
    for f, c in zip(full, cut):
        hits = np.flatnonzero(f == eos)
        end = hits[0] + 1 if hits.size else f.size
        np.testing.assert_array_equal(c, f[:end])


def test_prompts_are_cropped_to_leave_room_for_the_budget():
    _, tm, _ = model_pair(MHA)
    long = _prompts(MHA["vocab_size"], lens=(80,))[0]
    block, new = MHA["block_size"], 20
    eng = ServingEngine(tm, slots=1, page_size=8, device="cpu")
    rid = eng.submit(long, new)
    assert eng.queue[0].prompt.size == block - new
    np.testing.assert_array_equal(eng.queue[0].prompt, long[-(block - new):])
    assert len(eng.run()[rid].tokens) == new
    cropped = generate_served(tm, [long[-(block - new):]], new, page_size=8,
                              device="cpu")
    np.testing.assert_array_equal(eng.finished[rid].tokens, cropped[0])


def test_undersized_pool_raises_instead_of_evicting():
    _, tm, _ = model_pair(MHA)
    eng = ServingEngine(tm, slots=2, page_size=8, num_pages=3, device="cpu")
    with pytest.raises(ValueError, match="pages"):
        eng.submit(_prompts(MHA["vocab_size"], lens=(30,))[0], 10)
    eng.submit(_prompts(MHA["vocab_size"], lens=(14,))[0], 8)
    eng.submit(_prompts(MHA["vocab_size"], lens=(14,), seed=1)[0], 8)
    with pytest.raises(RuntimeError, match="exhausted"):
        eng.run()


@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_follows_jax_allocator(seed):
    """One random sequence of alloc / incref / decref (to free or to the
    cache) / reclaim through both allocators: same pages handed out, same
    state counts, invariants after every op."""
    rng = np.random.default_rng(seed)
    ours, ref = PageAllocator(12), JaxPageAllocator(12)
    held, cached = [], []
    for _ in range(200):
        op = rng.integers(0, 4)
        if op == 0 and ours.can_alloc(2):
            got = ours.alloc(2)
            assert got == ref.alloc(2)
            held += got
        elif op == 1 and held:
            p = held[rng.integers(len(held))]
            ours.incref(p)
            ref.incref(p)
            held.append(p)
        elif op == 2 and held:
            p = held.pop(rng.integers(len(held)))
            to_cache = bool(rng.integers(2))
            assert ours.decref(p, cache=to_cache) == ref.decref(p, cache=to_cache)
            if to_cache and ours.refcount(p) == 0:
                cached.append(p)
        elif op == 3 and cached:
            p = cached.pop(rng.integers(len(cached)))
            if ours.refcount(p) == 0 and p not in held:
                ours.reclaim(p)
                ref.reclaim(p)
        ours.check()
        ref.check()
        assert (ours.free_pages, ours.held_pages, ours.cached_pages) == (
            ref.free_pages, ref.held_pages, ref.cached_pages)
    for bad in (ours.decref, ours.reclaim, ours.incref):
        with pytest.raises(ValueError):
            bad(99)  # a page id that is neither held nor cached
