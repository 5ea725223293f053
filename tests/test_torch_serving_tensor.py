"""The port's tensor-parallel serving engine against the JAX package's
(``ServingEngine(mesh=...)`` on a tensor-only mesh).

JAX's small sharded-serving model (``tests/test_serving_sharded.py``'s
CFG: 2 layers, 4 heads, vocabulary 96) gets the same weights in both
packages (``torch_port_util.model_pair``). The JAX engine runs on the
8-device CPU mesh ``tests/conftest.py`` sets, the port's on a loopback
mesh (``parallel.mesh.loopback_mesh``: every tensor rank a shard of this
process), f32 pools. Checked, each against one JAX reference run a case:

- greedy streams token for token at tp 2 and tp 4 over JAX's matrix
  (prefix cache on and off, ``speculate=3`` with float and int8 weights,
  chunked prefill) and with an int8 KV pool; eviction and re-admission
  at tp 2 (the same evictions);
- ``prefill_sp`` "on" equal to "off" and to JAX, greedy and sampled, and
  composed with host spill (JAX ``tests/test_serving_longctx.py``);
  "auto" resolves to "on" exactly when tp > 1;
- sampled speculation at tp 2 equal to the port's tp 1 (the two
  packages' random streams differ by construction);
- the refusals of unservable meshes with JAX's messages, and program
  keys that differ per mesh (a tp 2 engine never replays a tp 1 graph).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.config import MeshConfig
from midgpt_tpu.parallel.mesh import create_mesh
from midgpt_tpu.serving import ServingEngine as JaxServingEngine
from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.models.gpt import GPT
from midgpt_tpu_torch.parallel.mesh import loopback_mesh
from midgpt_tpu_torch.serving import ServingEngine

from torch_port_util import assert_pages_home, model_pair

torch.set_num_threads(2)

CFG_KW = dict(block_size=64, vocab_size=96, n_layer=2, n_head=4, n_embd=32)


@pytest.fixture(scope="module")
def pair():
    jm, tm, _ = model_pair(CFG_KW)
    return jm, tm


def _jax_mesh(tp):
    return create_mesh(MeshConfig(replica=1, fsdp=1, sequence=1, tensor=tp),
                       devices=jax.devices()[:tp])


def _prompts(n, base_len=5, stride=3, seed0=100):
    rng = np.random.default_rng(seed0)
    return [rng.integers(0, CFG_KW["vocab_size"],
                         size=base_len + stride * i).astype(np.int32)
            for i in range(n)]


def _jax_run(jm, tp, prompts, n_new, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("window", 4)
    eng = JaxServingEngine(jm, mesh=_jax_mesh(tp) if tp > 1 else None,
                           cache_dtype=jnp.float32, **kw)
    rids = [eng.submit(p, n_new, seed=i) for i, p in enumerate(prompts)]
    fin = eng.run()
    return [list(map(int, fin[r].tokens)) for r in rids], eng


def _run(tm, tp, prompts, n_new, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("window", 4)
    eng = ServingEngine(tm, mesh=loopback_mesh(tp, "cpu") if tp > 1 else None,
                        device="cpu", cache_dtype=torch.float32, **kw)
    rids = [eng.submit(p, n_new, seed=i) for i, p in enumerate(prompts)]
    fin = eng.run()
    return [list(map(int, fin[r].tokens)) for r in rids], eng


# JAX's fast matrix (cache, nocache, spec, spec with int8 weights) and its
# chunked case, and an int8 KV pool
MATRIX = {
    "cache": dict(prefix_cache=True),
    "nocache": dict(prefix_cache=False),
    "spec": dict(speculate=3),
    "spec-int8": dict(speculate=3, quant="int8"),
    "chunked": dict(prefill_chunk=3),
    "kv-int8": dict(kv_quant="int8"),
}


@pytest.fixture(scope="module")
def jax_refs(pair):
    """The JAX engine's streams per (tp, case), made at first use."""
    jm, _ = pair
    prompts = _prompts(3)
    refs = {}

    def get(tp, case):
        if (tp, case) not in refs:
            refs[tp, case], _ = _jax_run(jm, tp, prompts, 10, **MATRIX[case])
        return refs[tp, case]

    return prompts, get


@pytest.mark.parametrize("case", list(MATRIX))
@pytest.mark.parametrize("tp", [2, 4])
def test_greedy_streams_equal_jax_sharded_engine(pair, jax_refs, tp, case):
    _, tm = pair
    prompts, ref = jax_refs
    got, eng = _run(tm, tp, prompts, 10, **MATRIX[case])
    assert got == ref(tp, case)
    assert eng.tp == tp and eng.stats()["tp"] == tp
    assert eng.prefill_sp == "on"
    if MATRIX[case].get("speculate"):
        assert eng.verify_dispatches > 0
    assert_pages_home(eng)


def test_eviction_and_readmission_equal_jax_at_tp2(pair):
    jm, tm = pair
    prompts = _prompts(4, base_len=6, stride=0)
    kw = dict(num_pages=5, page_size=8)
    ref, je = _jax_run(jm, 2, prompts, 16, **kw)
    got, eng = _run(tm, 2, prompts, 16, **kw)
    assert je.evictions > 0, "the trace must evict"
    assert eng.evictions == je.evictions
    assert got == ref
    assert_pages_home(eng)


def test_prefill_sp_on_equals_off_and_jax(pair):
    jm, tm = pair
    prompts = _prompts(3, base_len=20, stride=6)
    kw = dict(page_size=8, prefill_chunk=8, prefix_cache=True)
    ref, _ = _jax_run(jm, 2, prompts, 10, prefill_sp="on", **kw)
    off, e_off = _run(tm, 2, prompts, 10, prefill_sp="off", **kw)
    on, e_on = _run(tm, 2, prompts, 10, prefill_sp="on", **kw)
    assert on == off == ref
    assert (e_on.prefill_sp, e_off.prefill_sp) == ("on", "off")
    # sampled: sp must not move a bit of the logits
    skw = dict(page_size=8, prefill_chunk=8, temperature=0.8, top_k=16)
    s_off, _ = _run(tm, 2, prompts, 12, prefill_sp="off", **skw)
    s_on, _ = _run(tm, 2, prompts, 12, prefill_sp="on", **skw)
    assert s_on == s_off


def test_prefill_sp_rows_equal_unsplit_bit_for_bit(pair):
    """One prefill chunk at tp 4: the hidden states and every rank's K/V
    with the rows split over the ranks equal the replicated run's."""
    from midgpt_tpu_torch.models.gpt import prefill_chunk_paged, tensor_copy
    from midgpt_tpu_torch.serving.paged import ShardedKVPool

    _, tm = pair
    sharded = tensor_copy(tm, loopback_mesh(4, "cpu").tensor)
    cfg = tm.config
    pool = ShardedKVPool.init(cfg, 8, 8, torch.float32, torch.device("cpu"),
                              sharded.tensor)
    tokens = torch.from_numpy(_prompts(1, base_len=16)[0][None]).long()
    bt = torch.arange(8, dtype=torch.int32)[None]
    start = torch.zeros(1, dtype=torch.int32)
    outs = [prefill_chunk_paged(sharded, tokens, start, pool.k, pool.v, bt,
                                cfg.block_size, resumed=False, sp=sp)
            for sp in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1] + outs[0][2], outs[1][1] + outs[1][2]):
        assert a.shape[2] == 1 and torch.equal(a, b)


def test_prefill_sp_with_spill_equals_one_card(pair):
    _, tm = pair
    prompts = _prompts(3, base_len=22, stride=0, seed0=900)
    kw = dict(page_size=8, prefill_chunk=8, prefix_cache=True)
    ref, _ = _run(tm, 1, prompts, 10, **kw)
    got, eng = _run(tm, 2, prompts, 10, prefill_sp="on", spill="on",
                    num_pages=7, **kw)
    assert got == ref
    assert eng.prefill_sp == "on"
    assert eng.stats()["spilled_pages"] > 0
    eng.alloc.check()
    eng.index.check(eng.alloc, eng._spill_store)


def test_sampled_speculation_at_tp2_equals_tp1(pair):
    _, tm = pair
    rng = np.random.default_rng(700)
    prompts = [np.tile(rng.integers(0, 96, size=4), 6).astype(np.int32)
               for _ in range(3)]
    kw = dict(temperature=0.8, top_k=20, speculate=3, seed=3)
    ref, e1 = _run(tm, 1, prompts, 10, **kw)
    got, e2 = _run(tm, 2, prompts, 10, **kw)
    assert got == ref
    assert e2.spec_drafted > 0 and e2.spec_drafted == e1.spec_drafted


def test_prefill_sp_resolution_and_program_keys(pair):
    """"auto" is "on" exactly at tp > 1; every program key carries the
    mesh's fingerprint (and a prefill chunk's the resolved sp), so two
    meshes never share a key (JAX
    ``test_program_cache_distinct_entries_per_mesh``)."""
    _, tm = pair
    prompt = _prompts(1)[0]
    keys = {}
    for name, mesh, sp in (("none", None, "auto"),
                           ("tp2", loopback_mesh(2, "cpu"), "auto"),
                           ("tp2_off", loopback_mesh(2, "cpu"), "off"),
                           ("tp4", loopback_mesh(4, "cpu"), "auto"),
                           ("tp2_b", loopback_mesh(2, "cpu", first_id=2),
                            "auto")):
        eng = ServingEngine(tm, mesh=mesh, device="cpu", slots=2, window=4,
                            cache_dtype=torch.float32, prefill_sp=sp)
        eng.submit(prompt, 3)
        eng.run()
        keys[name] = set(eng._programs)
        assert eng.prefill_sp == ("on" if mesh is not None and sp == "auto"
                                  else "off")
    meshes = ("none", "tp2", "tp4", "tp2_b")
    assert all(not keys[a] & keys[b] for a in meshes for b in meshes
               if a < b)
    assert loopback_mesh(2, "cpu").key() == loopback_mesh(2, "cpu").key()
    # one mesh, sp on and off: the decode program is shared (its key has
    # no sp, as JAX's), the prefill chunks are not
    prefill = {n: {k for k in keys[n] if k[0] == "prefill_chunk"}
               for n in ("tp2", "tp2_off")}
    assert {k[-1] for k in prefill["tp2"]} == {"on"}
    assert {k[-1] for k in prefill["tp2_off"]} == {"off"}
    assert keys["tp2"] - prefill["tp2"] == keys["tp2_off"] - prefill[
        "tp2_off"]


def test_unservable_meshes_are_refused_at_construction(pair):
    _, tm = pair
    with pytest.raises(ValueError, match="cannot shard 'sequence'"):
        ServingEngine(tm, device="cpu",
                      mesh=dataclasses.replace(loopback_mesh(1, "cpu"),
                                               sequence=2))
    with pytest.raises(ValueError, match="cannot shard 'pipeline'"):
        ServingEngine(tm, device="cpu",
                      mesh=dataclasses.replace(loopback_mesh(2, "cpu"),
                                               pipeline=2))
    with pytest.raises(ValueError, match="divide heads"):
        ServingEngine(tm, device="cpu", mesh=loopback_mesh(8, "cpu"))
    odd_v = GPT.init(ModelConfig(**{**CFG_KW, "vocab_size": 97}),
                     device="cpu")
    with pytest.raises(ValueError, match="divide vocab_size 97"):
        ServingEngine(odd_v, device="cpu", mesh=loopback_mesh(2, "cpu"))
    odd_f = GPT.init(ModelConfig(**{**CFG_KW, "mlp_hidden": 130}),
                     device="cpu")
    with pytest.raises(ValueError, match="divide the MLP hidden width 130"):
        ServingEngine(odd_f, device="cpu", mesh=loopback_mesh(4, "cpu"))
    moe = GPT.init(ModelConfig(**{**CFG_KW, "mlp": "moe", "moe_experts": 4}),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="MoE"):
        ServingEngine(moe, device="cpu", mesh=loopback_mesh(2, "cpu"))
    with pytest.raises(ValueError, match="page_size 2 divisible"):
        ServingEngine(tm, device="cpu", mesh=loopback_mesh(4, "cpu"),
                      page_size=2, prefill_sp="on")
    # JAX refuses the same meshes (its messages, asserted)
    jm, _ = pair
    seq = create_mesh(MeshConfig(replica=1, fsdp=1, sequence=2, tensor=1),
                      devices=jax.devices()[:2])
    with pytest.raises(AssertionError, match="sequence"):
        JaxServingEngine(jm, mesh=seq)
    with pytest.raises(AssertionError, match="divide heads"):
        JaxServingEngine(jm, mesh=_jax_mesh(8))
