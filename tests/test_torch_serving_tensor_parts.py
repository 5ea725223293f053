"""The parts of the port's tensor-parallel serving beside the engine: the
greedy combiner, a gloo world of two ``GroupTensorExchange`` ranks, the
TP x DP cluster, the fixed-batch sampler under a mesh, the int8 model's
per-rank codes and the CLI's ``--serve_tp``.

JAX's small sharded-serving model (``tests/test_serving_sharded.py``'s
CFG) gets the same weights in both packages; the JAX package runs on the
8-device CPU mesh of ``tests/conftest.py``. Checked:

- the combiner (``parallel.tensor.greedy_argmax``) equals
  ``torch.argmax`` of the whole row on planted ties across shard
  boundaries, and within a shard, at 2, 4 and 8 shards;
- two processes over gloo, each rank one shard of a
  ``parallel.mesh.group_mesh``: both ranks serve the same greedy streams,
  equal to JAX's tp 2 engine (cache on, ``speculate=3``, int8 weights);
  their combiner agrees with the whole row's argmax; a deadline trace
  whose clocks read differently on the two ranks sheds the same requests
  on both (rank 0's reading counts);
- a world of one (``GroupTensorExchange`` at tensor 1) serves exactly
  the plain engine's streams;
- ``ServingCluster(meshes=serving_meshes(2, 2, loopback=True))`` equals
  one engine; ``serving_meshes`` refuses tensor ranks over several cards
  without ``loopback``; ``serving_devices`` takes ``tp_size > 1``;
- ``make_sampler(mesh=...)`` equals JAX's ``make_sampler(mesh=...)``
  greedy (exact and kv sliding past ``block_size``), and its sampled
  streams equal the port's tp 1;
- an int8 JAX model converted under ``tensor=`` holds, per rank, a slice
  of the unsharded codes bit for bit, and puts them back whole;
- ``python -m midgpt_tpu_torch.sample --serve --serve_tp 2`` prints what
  ``generate_served(mesh=...)`` gives.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import midgpt_tpu.quant as jq
from midgpt_tpu.config import MeshConfig
from midgpt_tpu.parallel.mesh import create_mesh
from midgpt_tpu.pytree import tree_paths
from midgpt_tpu.sampling import make_sampler as jax_make_sampler
from midgpt_tpu.serving import ServingEngine as JaxServingEngine
from midgpt_tpu_torch import sample
from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.convert import full_state_dict, gpt_from_jax_params
from midgpt_tpu_torch.data import write_tokens
from midgpt_tpu_torch.parallel.mesh import loopback_mesh
from midgpt_tpu_torch.parallel.tensor import (
    GroupTensorExchange,
    LoopbackTensorExchange,
    greedy_argmax,
)
from midgpt_tpu_torch.sampling import make_sampler
from midgpt_tpu_torch.serving import (
    ServingCluster,
    ServingEngine,
    generate_served,
    serving_devices,
    serving_meshes,
)

from torch_dist_util import run_world
from torch_port_util import model_pair

torch.set_num_threads(2)

CFG_KW = dict(block_size=64, vocab_size=96, n_layer=2, n_head=4, n_embd=32)


@pytest.fixture(scope="module")
def pair():
    return model_pair(CFG_KW)


def _jax_mesh(tp):
    return create_mesh(MeshConfig(replica=1, fsdp=1, sequence=1, tensor=tp),
                       devices=jax.devices()[:tp])


def _prompts(n, base_len=5, stride=3, seed0=100):
    rng = np.random.default_rng(seed0)
    return [rng.integers(0, CFG_KW["vocab_size"],
                         size=base_len + stride * i).astype(np.int32)
            for i in range(n)]


def _jax_streams(jm, tp, prompts, n_new, **kw):
    eng = JaxServingEngine(jm, mesh=_jax_mesh(tp), slots=2, window=4,
                           cache_dtype=jnp.float32, **kw)
    rids = [eng.submit(p, n_new, seed=i) for i, p in enumerate(prompts)]
    fin = eng.run()
    return [list(map(int, fin[r].tokens)) for r in rids]


def _tied_logits(rows, vocab, seed=0):
    """Random logits with planted ties: each row's maximum at two or more
    indices, across a shard boundary of every split or within a shard."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, vocab)).astype(np.float32)
    for i in range(rows):
        k = rng.integers(2, 4)
        at = rng.choice(vocab, size=k, replace=False)
        x[i, at] = x[i].max() + 1.0
    x[0, [vocab // 2 - 1, vocab // 2]] = 9.0  # across the middle boundary
    x[1, [vocab // 8 - 1, vocab // 8]] = 9.0  # across the eighth's
    x[2, [3, 5]] = 9.0  # within the first shard
    x[3, [vocab - 1, 0]] = 9.0  # the last index and the first
    return x


@pytest.mark.parametrize("size", [2, 4, 8])
def test_combiner_takes_the_lowest_index_on_ties(size):
    x = torch.from_numpy(_tied_logits(64, 96))
    got = greedy_argmax(x, LoopbackTensorExchange(size))
    assert torch.equal(got, torch.argmax(x, -1))
    # bf16 rows, three dims
    xb = x.to(torch.bfloat16).reshape(4, 16, 96)
    assert torch.equal(greedy_argmax(xb, LoopbackTensorExchange(size)),
                       torch.argmax(xb, -1))


def test_gloo_world_of_two_serves_jax_streams(pair, tmp_path):
    jm, _, params = pair
    prompts = _prompts(3)
    cases = {"cache": dict(slots=2, window=4),
             "spec": dict(slots=2, window=4, speculate=3),
             "int8": dict(slots=2, window=4, quant="int8")}
    logits = _tied_logits(16, 96, seed=4)
    args = {"params": params, "model": CFG_KW, "prompts": prompts,
            "n_new": 10, "cases": cases, "logits": logits,
            "deadlines": [None, 2.5, 100.0, 3.5]}
    ranks = run_world(str(tmp_path), 2, "serve_group", args)
    assert ranks[0]["streams"] == ranks[1]["streams"]
    for case, kw in cases.items():
        kw = {k: v for k, v in kw.items() if k not in ("slots", "window")}
        assert ranks[0]["streams"][case] == _jax_streams(jm, 2, prompts, 10,
                                                         **kw), case
    assert ranks[0]["tp"] == 2
    # the combiner: one all-gather of the pairs a token, the sampled
    # draws none here (greedy); the rows' all-reduces are the operators'
    assert ranks[0]["collectives"]["all_gather"] > 0
    assert ranks[0]["collectives"]["all_reduce"] > 0
    for r in ranks:
        np.testing.assert_array_equal(r["argmax"],
                                      np.argmax(logits, axis=-1))
    assert ranks[0]["shed"] == ranks[1]["shed"] and ranks[0]["shed"]
    assert ranks[0]["kept"] == ranks[1]["kept"] and ranks[0]["kept"]
    # only deadline decisions take rank 0's agreed reading: the spans are
    # timed on each rank's own clock
    assert all(r["shortest_span"] > 0 for r in ranks)


def test_world_of_one_equals_the_plain_engine(pair, tmp_path):
    """A ``GroupTensorExchange`` at tensor 1 runs the tensor path (one
    shard, one-rank collectives): the plain engine's streams exactly."""
    import torch.distributed as dist

    from midgpt_tpu_torch.config import MeshConfig as PortMesh
    from midgpt_tpu_torch.parallel.mesh import create_mesh as port_mesh
    from midgpt_tpu_torch.parallel.mesh import group_mesh

    _, tm, _ = pair
    prompts = _prompts(3)
    dist.init_process_group("gloo", init_method="file://" + str(
        tmp_path / "store"), rank=0, world_size=1)
    try:
        sm = group_mesh(port_mesh(PortMesh(fsdp=1, tensor=-1)), "cpu")
        assert isinstance(sm.tensor, GroupTensorExchange) and sm.tp == 1
        for kw in ({}, dict(speculate=3), dict(temperature=0.8, seed=2)):
            streams = []
            for mesh in (None, sm):
                eng = ServingEngine(tm, mesh=mesh, device="cpu", slots=2,
                                    window=4, cache_dtype=torch.float32,
                                    **kw)
                rids = [eng.submit(p, 10, seed=i)
                        for i, p in enumerate(prompts)]
                fin = eng.run()
                streams.append([fin[r].tokens for r in rids])
            assert streams[0] == streams[1], kw
            assert eng.tensor is sm.tensor and eng.prefill_sp == "off"
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["least_loaded", "disagg", "crash"])
def test_tp2_by_two_replica_cluster_equals_one_engine(pair, mode):
    """Two tp 2 replicas on one device: least-loaded admission, the
    disaggregated 1 + 1 pools (every handoff record carrying both ranks'
    heads) and a crash of replica 0 with its requests failed over, each
    with one engine's streams."""
    from midgpt_tpu_torch.serving import FaultPlan

    _, tm, _ = pair
    prompts = _prompts(6, base_len=5, stride=2)
    kw = dict(slots=2, window=4, cache_dtype=torch.float32)
    eng = ServingEngine(tm, device="cpu", **kw)
    rids = [eng.submit(p, 8, seed=i) for i, p in enumerate(prompts)]
    fin = eng.run()
    ref = [fin[r].tokens for r in rids]
    meshes = serving_meshes(2, 2, devices=["cpu", "cpu"], loopback=True)
    assert meshes[0].key() != meshes[1].key()
    extra = {"least_loaded": {},
             "disagg": dict(prefill_replicas=1, decode_replicas=1),
             "crash": dict(fault_plan=FaultPlan.parse("2:crash@0"))}[mode]
    cl = ServingCluster(tm, meshes=meshes, **kw, **extra)
    crids = [cl.submit(p, 8, seed=i) for i, p in enumerate(prompts)]
    got = cl.run()
    assert [got[r].tokens for r in crids] == ref
    assert all(e.tp == 2 for e in cl.engines)
    # one cut of the model serves both replicas
    assert cl.engines[0].model is cl.engines[1].model
    st = cl.stats()
    assert [s["tp"] for s in st["per_replica"]] == [2, 2]
    if mode == "disagg":
        assert st["handoffs"] == len(prompts)
    if mode == "crash":
        assert cl.health[0] == "dead" and st["failovers"] == 1
    assert serving_meshes(1, 1) == [None]
    with pytest.raises(NotImplementedError, match="loopback=True"):
        serving_meshes(2, 1, devices=["cpu", "cpu"])
    assert serving_devices(4, 1, devices=["cpu"]) == [torch.device("cpu")]


@pytest.mark.parametrize("sliding", ["exact", "kv"])
def test_make_sampler_under_a_mesh_equals_jax(pair, sliding):
    jm, tm, _ = pair
    prompt = np.stack(_prompts(3, base_len=7, stride=0, seed0=5))
    ref = jax_make_sampler(70, mesh=_jax_mesh(2), temperature=0.0,
                           cache_dtype=jnp.float32, sliding=sliding,
                           chunk_len=5)(jm, jnp.asarray(prompt),
                                        jax.random.PRNGKey(0))
    for tp in (2, 4):
        got = make_sampler(70, mesh=loopback_mesh(tp, "cpu"),
                           temperature=0.0, cache_dtype=torch.float32,
                           sliding=sliding, chunk_len=5)(tm, prompt, 0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    sampled = [make_sampler(70, mesh=mesh, temperature=0.8, top_k=20,
                            cache_dtype=torch.float32, sliding=sliding,
                            chunk_len=5, device="cpu")(tm, prompt, 3)
               for mesh in (None, loopback_mesh(2, "cpu"))]
    assert torch.equal(sampled[0], sampled[1])


def test_int8_model_under_tensor_holds_slices_of_the_codes(pair):
    jm, _, _ = pair
    qparams = {p: np.asarray(a)
               for p, a in tree_paths(jq.quantize_model(jm))}
    cfg = ModelConfig(**CFG_KW)
    whole = gpt_from_jax_params(qparams, cfg, device="cpu")
    ex = LoopbackTensorExchange(2)
    cut = gpt_from_jax_params(qparams, cfg, device="cpu", tensor=ex)
    for blk, wblk in zip(cut.blocks, whole.blocks):
        n = wblk.mlp.w_up.weight.shape[1] // 2
        for j in range(2):
            col = blk.mlp.w_up.weight.chunk(2, 0)[j]
            assert torch.equal(col, wblk.mlp.w_up.weight[:, j * n:(j + 1) * n])
            assert torch.equal(blk.mlp.w_up.scale.chunk(2)[j],
                               wblk.mlp.w_up.scale[j * n:(j + 1) * n])
            k = wblk.attn.wo.weight.shape[0] // 2
            assert torch.equal(blk.attn.wo.weight.chunk(2, 0)[j],
                               wblk.attn.wo.weight[j * k:(j + 1) * k])
        assert torch.equal(blk.attn.wo.scale, wblk.attn.wo.scale)
        assert blk.mlp.w_up.weight.is_contiguous()
    full = full_state_dict(cut)
    for name, w in whole.state_dict().items():
        assert torch.equal(full[name], w), name


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    from midgpt_tpu_torch.launch import main

    root = tmp_path_factory.mktemp("serve_tp_cli")
    data = root / "data"
    rng = np.random.default_rng(0)
    write_tokens(str(data / "train.bin"), np.tile(np.arange(64), 200))
    write_tokens(str(data / "val.bin"), rng.integers(0, 64, 3000))
    run = str(root / "run")
    main(["--config", "tiny", "--rundir", run, "--set", f"data_dir={data}",
          "device=cpu", "max_steps=2", "eval_batches=1"])
    return run


def test_serve_tp_cli_prints_the_meshs_streams(run_dir, capsys,
                                               monkeypatch, tmp_path):
    monkeypatch.setenv("TIKTOKEN_CACHE_DIR", str(tmp_path / "no_cache"))
    start = "1 2 3 4 5 "
    outs = sample.main(["--ckpt_dir", run_dir, "--device", "cpu", "--start",
                        start, "--num_samples", "2", "--serve",
                        "--serve_tp", "2", "--max_new_tokens", "24",
                        "--temperature", "0"])
    lines = capsys.readouterr().out.splitlines()
    cfg = sample.load_run_config(run_dir)
    model, _ = sample.restore_model(run_dir, cfg, torch.device("cpu"))
    prompt = np.tile(np.arange(1, 6, dtype=np.int32)[None], (2, 1))
    ref = generate_served(model, list(prompt), 24, window=8, page_size=16,
                          device="cpu", mesh=loopback_mesh(2, "cpu"))
    np.testing.assert_array_equal(np.stack(outs), np.stack(ref))
    _, decode = sample.get_tokenizer("")
    assert lines[1:] == [x for toks in ref
                         for x in ("-" * 40, start + decode(toks))]
    assert os.path.isdir(run_dir)
