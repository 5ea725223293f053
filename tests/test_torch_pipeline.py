"""The pipeline axis's schedule, mesh and model against JAX's, on the CPU
(f32; the loopback in this process, and gloo worlds of spawned ranks,
``torch_dist_util``).

- The GPipe schedule (``parallel.pipeline.pipeline_run``) on JAX's tanh
  toy (``tests/test_pipeline.py``: 8 layers, S = 4, M = 6): forward
  outputs and the gradients of ``sum(sin(out))`` with respect to the
  layers and the input against JAX's ``pipeline_forward`` on a 4-device
  host mesh (atol 1e-5), on the loopback and over a gloo world of four
  (each rank one stage, its P2P hand-offs counted);
- the layer split and JAX's auto microbatch rule; a split that does not
  divide, and each refusal of a pipelined config (an MoE model, ring
  attention, ``num_slices`` with a pipeline, ``replica % num_slices``)
  raise ``ValueError`` naming the field;
- a spawned ``pipeline=2 x fsdp=2`` world's groups: the pipeline group
  and neighbours along JAX's grid, fsdp within a stage, the parameters'
  group over ``pipeline x fsdp``, a tied embedding's pair;
- one card's loopback trainer at ``pipeline=4`` (8 microbatches of one
  row) equals the unpipelined trainer at ``g_accum_iters=8`` bit for bit
  (f32 and bf16, dense and chunked loss);
- ``pp_boundary_dtype="bfloat16"`` under f32 compute (JAX's CPU cannot
  run it) equals a run that rounds each stage's input, and its
  gradient, to bf16 by hand;
- multi-slice: the rank grid at ``num_slices=2`` against JAX's
  ``hybrid_device_layout`` at worlds 4 and 8, and the node check; the
  named configs ``openwebtext_mh`` and ``openwebtext_xl_multislice``
  against JAX's ``get_config``;
- the stage's share of ``card_peak_bytes``.
"""

import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from midgpt_tpu_torch.config import (
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    get_config,
)
from midgpt_tpu_torch.models.gpt import GPT, check_pipeline, pipeline_loss
from midgpt_tpu_torch.parallel.mesh import (
    Mesh,
    axis_ranks,
    check_slice_nodes,
    check_supported,
    grid_coords,
    single_device_mesh,
    slice_ranks,
)
from midgpt_tpu_torch.parallel.pipeline import (
    LoopbackPipe,
    bubble,
    microbatches,
    pipeline_run,
    stage_layers,
)
from midgpt_tpu_torch.train import (
    bind_mesh,
    card_peak_bytes,
    check_pipeline_axis,
    effective_loss_chunk,
    head_loss,
    make_lr_schedule,
    make_shadow,
    parameter_count,
    state_from_model,
    train_step,
)

from torch_dist_util import run_world

torch.set_num_threads(2)

D, L, M, BM, S = 16, 8, 6, 4, 4  # JAX's toy
SMALL = dict(block_size=32, vocab_size=96, n_layer=4, n_head=4, n_embd=64,
             attn_impl="naive", remat="none")


# -- the schedule against JAX's pipeline_forward ------------------------------


def _toy(seed: int = 0):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.standard_normal((L, D, D))).astype(np.float32)
    b = (0.1 * rng.standard_normal((L, D))).astype(np.float32)
    x = rng.standard_normal((M, BM, D)).astype(np.float32)
    return w, b, x


def _jax_toy(w, b, x):
    """JAX's pipelined outputs and the gradients of ``sum(sin(out))``."""
    from midgpt_tpu.parallel.pipeline import pipeline_forward, stage_scan_fn

    mesh = JaxMesh(np.asarray(jax.devices()[:S]).reshape(S), ("pipeline",))

    def block(p, h):
        return jnp.tanh(h @ p[0] + p[1])

    def fwd(params, xx):
        return pipeline_forward(params, xx, stage_scan_fn(block), mesh)

    params = (jnp.asarray(w), jnp.asarray(b))
    out = jax.jit(fwd)(params, jnp.asarray(x))
    (gw, gb), gx = jax.jit(jax.grad(
        lambda p, xx: jnp.sum(jnp.sin(fwd(p, xx))), argnums=(0, 1)))(
            params, jnp.asarray(x))
    return {k: np.asarray(v) for k, v in
            dict(out=out, gw=gw, gb=gb, gx=gx).items()}


def _loopback_toy(w, b, x):
    w, b = torch.from_numpy(w).requires_grad_(), torch.from_numpy(
        b).requires_grad_()
    x = torch.from_numpy(x).requires_grad_()

    def stage_fn(head):
        def fn(s, h, m):
            for i in stage_layers(L, S, s):
                h = torch.tanh(h @ w[i] + b[i])
            return torch.sin(h).sum() if head and s == S - 1 else h
        return fn

    out = pipeline_run(LoopbackPipe(S), M, stage_fn(False), lambda m: x[m],
                       (BM, D), torch.float32, "cpu", train=False)
    losses = pipeline_run(LoopbackPipe(S), M, stage_fn(True),
                          lambda m: x[m], (BM, D), torch.float32, "cpu")
    assert len(losses) == M
    return dict(out=torch.stack(out).numpy(), gw=w.grad.numpy(),
                gb=b.grad.numpy(), gx=x.grad.numpy())


def test_loopback_schedule_matches_jax_pipeline_forward():
    w, b, x = _toy()
    ref, got = _jax_toy(w, b, x), _loopback_toy(w, b, x)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)


def test_gloo_schedule_matches_jax_pipeline_forward(tmp_path):
    w, b, x = _toy(1)
    ref = _jax_toy(w, b, x)
    out = run_world(str(tmp_path), S, "pipe_toy", dict(w=w, b=b, x=x),
                    timeout=120)
    for r, got in enumerate(out):
        lo, hi = got["layers"]
        assert got["stage"] == r and (lo, hi) == (r * L // S,
                                                  (r + 1) * L // S)
        np.testing.assert_allclose(got["gw"], ref["gw"][lo:hi], atol=1e-5)
        np.testing.assert_allclose(got["gb"], ref["gb"][lo:hi], atol=1e-5)
        # each stage's hand-offs: M activations and M gradients a
        # neighbour, in the forward-only run and in the training run
        assert got["send_recv"] == 3 * M * ((r > 0) + (r < S - 1))
    np.testing.assert_allclose(out[-1]["out"], ref["out"], atol=1e-5)
    np.testing.assert_allclose(out[0]["gx"], ref["gx"], atol=1e-5)
    assert all(o["out"] is None for o in out[:-1])


# -- the split, the microbatches, the refusals --------------------------------


def test_indivisible_layers_raise_naming_both():
    assert list(stage_layers(8, 4, 2)) == [4, 5]
    with pytest.raises(ValueError, match="n_layer=6.*pipeline=4"):
        stage_layers(6, 4, 0)
    with pytest.raises(ValueError, match="n_layer=6"):
        GPT.init(ModelConfig(**dict(SMALL, n_layer=6)), device="cpu",
                 stage=(0, 4))


@pytest.mark.parametrize("rows,size,want,warns", [
    (8, 4, 8, False), (16, 4, 8, False), (4, 4, 4, False), (6, 4, 6, False),
    (8, 2, 4, False), (3, 4, 3, True), (5, 2, 1, True), (1, 2, 1, True),
])
def test_auto_microbatches_follow_jax(rows, size, want, warns):
    """JAX's rule (``gpt_pipeline_hidden``): ``min(2 S, b)``, lowered until
    it divides ``b``, a warning below ``S``; the port's ``b`` is a data
    rank's rows."""
    with pytest.warns(UserWarning, match="degraded") if warns else \
            _no_warning():
        assert microbatches(rows, size) == want
    assert microbatches(rows, size, want) == want
    assert bubble(size, want) == (size - 1) / (want + size - 1)
    with pytest.raises(ValueError, match="pp_microbatches"):
        microbatches(rows, size, rows + 1)


@contextlib.contextmanager
def _no_warning():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yield


def _refusal(field):
    """The config (or mesh) of each refusal, and how it is reached."""
    base = ExperimentConfig(model=ModelConfig(**SMALL),
                            mesh=MeshConfig(pipeline=2))
    four = Mesh(rank=0, world=4, sizes=(2, 1, 2, 1, 1), distributed=True)
    if field == "mlp":
        cfg = dataclasses.replace(base, model=ModelConfig(
            **dict(SMALL, mlp="moe", moe_experts=4)))
        return lambda: check_pipeline_axis(cfg, four)
    if field == "attn_impl":
        cfg = dataclasses.replace(base, model=ModelConfig(
            **dict(SMALL, attn_impl="ring")))
        return lambda: check_pipeline_axis(cfg, four)
    if field == "n_layer":
        cfg = dataclasses.replace(base, model=ModelConfig(
            **dict(SMALL, n_layer=3)))
        return lambda: check_pipeline_axis(cfg, single_device_mesh())
    if field == "num_slices":
        m = MeshConfig(replica=2, fsdp=1, pipeline=2, num_slices=2)
        return lambda: check_supported(m, m.sizes(4))
    m = MeshConfig(replica=3, fsdp=1, num_slices=2)
    return lambda: check_supported(m, m.sizes(3))


@pytest.mark.parametrize("field", ["mlp", "attn_impl", "n_layer",
                                   "num_slices", "replica"])
def test_pipeline_refusals_name_the_field(field):
    with pytest.raises(ValueError, match=field):
        _refusal(field)()


def test_sequence_under_pipeline_raises():
    cfg = ExperimentConfig(model=ModelConfig(**SMALL),
                           mesh=MeshConfig(pipeline=2, sequence=2))
    with pytest.raises(ValueError, match="sequence=2"):
        check_pipeline(cfg.model, 2, 2)


def test_pipeline_axis_builds_its_groups(tmp_path):
    """``pipeline=2 x fsdp=2``: the pipeline group and neighbours along
    JAX's grid (``pipeline`` outermost), fsdp and the gradient's group
    within a stage, the parameters' group over ``pipeline x fsdp``, the
    embedding pair, and the data shards of ``replica x fsdp`` (stages
    see the same rows)."""
    kw = dict(fsdp=2, pipeline=2)
    cfg = MeshConfig(**kw)
    sizes = cfg.sizes(4)
    assert sizes == (2, 1, 2, 1, 1)
    out = run_world(str(tmp_path), 4, "mesh_layout", {"mesh": kw},
                    timeout=120)
    for r, got in enumerate(out):
        pipe = axis_ranks(r, sizes, "pipeline")
        i = pipe.index(r)
        assert got["pipeline"] == got["embed"] == pipe
        assert got["pp_index"] == grid_coords(r, sizes)[0] == i == r // 2
        assert (got["pp_prev"], got["pp_next"]) == (
            pipe[i - 1] if i else None, pipe[i + 1] if i < 1 else None)
        assert got["fsdp"] == axis_ranks(r, sizes, "fsdp")
        assert got["param"] == axis_ranks(r, sizes, ("pipeline", "fsdp"))
        assert got["data_index"] == out[pipe[1 - i]]["data_index"] == r % 2


# -- the trainer on one card's loopback ---------------------------------------


def _run(pp: int, g: int, dtype: str, chunk, steps: int = 3, **model_kw):
    cfg = ExperimentConfig(model=ModelConfig(**dict(SMALL, **model_kw)),
                           mesh=MeshConfig(pipeline=pp), batch_size=8,
                           g_accum_iters=g, learning_rate=1e-3, min_lr=1e-4,
                           warmup_steps=2, lr_decay_steps=10,
                           compute_dtype=dtype, device="cpu",
                           loss_chunk=chunk)
    model = GPT.init(cfg.model, torch.Generator().manual_seed(0),
                     device="cpu")
    state = state_from_model(model)
    shadow = make_shadow(model, getattr(torch, dtype))
    bind_mesh(shadow, single_device_mesh(), 0, pp)
    sched = make_lr_schedule(cfg)
    toks = np.random.default_rng(3).integers(0, SMALL["vocab_size"],
                                             (steps, 8, 33))
    out = []
    for s in range(steps):
        x = torch.from_numpy(toks[s, :, :-1]).reshape(g, 8 // g, 32)
        y = torch.from_numpy(toks[s, :, 1:]).reshape(g, 8 // g, 32)
        loss, norm = train_step(state, shadow, x, y, cfg, sched(s),
                                effective_loss_chunk(cfg))
        out.append((float(loss), float(norm)))
    return out, state


@pytest.mark.parametrize("dtype,chunk", [("float32", None),
                                         ("bfloat16", None),
                                         ("bfloat16", 16)])
def test_loopback_trainer_equals_one_card_at_g_accum_m(dtype, chunk):
    """One process at ``pipeline=4`` runs every stage on a loopback with
    JAX's auto M = 8 (one row each): the losses, grad norms and params
    equal the unpipelined trainer at ``g_accum_iters=8`` bit for bit."""
    got, s_pp = _run(4, 1, dtype, chunk)
    ref, s_one = _run(1, 8, dtype, chunk)
    assert got == ref
    for a, b in zip(s_pp.model.parameters(), s_one.model.parameters()):
        assert torch.equal(a, b)


def test_bf16_boundary_equals_rounding_by_hand():
    """``pp_boundary_dtype="bfloat16"`` under f32 compute: each stage's
    input (and the gradient sent back for it) is rounded to bf16; a run
    of the unpipelined blocks that rounds there by hand gives the same
    losses and gradients, and they differ from the f32 boundary's."""
    cfg = ModelConfig(**SMALL)
    g = torch.Generator().manual_seed(1)
    model = GPT.init(cfg, g, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=g)
    x, y = toks[:, :-1], toks[:, 1:]
    tail = head_loss(model)

    def pipelined(bdtype):
        model.zero_grad()
        model.pipeline = LoopbackPipe(2)
        loss = pipeline_loss(model, x, y, tail, 2, boundary_dtype=bdtype)
        model.pipeline = None
        return loss, [p.grad.clone() for p in model.parameters()]

    def by_hand():
        model.zero_grad()
        from midgpt_tpu_torch.models.gpt import _rope_tables_full

        rope = _rope_tables_full(cfg.head_dim, 32, cfg.rope_base,
                                 torch.device("cpu"))
        total = torch.zeros(())
        for m in range(2):
            h = model.wte(x[2 * m:2 * m + 2])
            for i, blk in enumerate(model.blocks):
                if i == 2:
                    h = h.to(torch.bfloat16).to(torch.float32)
                h = blk(h, rope, "naive")
            loss = tail(model.ln_f(h), y[2 * m:2 * m + 2])
            loss.backward()
            total = total + loss.detach()
        return total, [p.grad.clone() for p in model.parameters()]

    loss16, grads16 = pipelined(torch.bfloat16)
    ref, ref_grads = by_hand()
    assert torch.equal(loss16, ref)
    for a, b in zip(grads16, ref_grads):
        assert torch.equal(a, b)
    loss32, grads32 = pipelined(torch.float32)
    assert not torch.equal(loss32, loss16)
    assert any(not torch.equal(a, b) for a, b in zip(grads32, grads16))


# -- multi-slice meshes and the named configs ---------------------------------


@pytest.mark.parametrize("world,kw", [
    (4, dict(replica=2, fsdp=-1, num_slices=2)),
    (8, dict(replica=2, fsdp=-1, tensor=2, num_slices=2)),
    (8, dict(replica=4, fsdp=2, num_slices=2)),
    (8, dict(replica=2, fsdp=1, sequence=2, tensor=2, num_slices=2)),
])
def test_slice_layout_matches_jax_hybrid_layout(world, kw):
    from midgpt_tpu.parallel.mesh import hybrid_device_layout

    from midgpt_tpu.config import MeshConfig as JaxMeshConfig

    cfg = MeshConfig(**kw)
    sizes = cfg.sizes(world)
    assert sizes == JaxMeshConfig(**kw).sizes(world)
    check_supported(cfg, sizes)
    devices = jax.devices()[:world]
    arr = hybrid_device_layout(devices, sizes, cfg.num_slices)
    order = [d.id for d in devices]
    for rank in range(world):
        assert order.index(arr[grid_coords(rank, sizes)].id) == rank
    # a slice: world / num_slices contiguous ranks, replica / num_slices
    # whole replicas
    per = sizes[1] // cfg.num_slices
    for i, ranks in enumerate(slice_ranks(world, cfg.num_slices)):
        assert {grid_coords(r, sizes)[1] // per for r in ranks} == {i}


def test_slice_nodes_check():
    check_slice_nodes([0, 0, 0, 0], 2)  # one node: simulated slices
    check_slice_nodes([0, 0, 1, 1], 2)
    with pytest.raises(ValueError, match="num_slices=2"):
        check_slice_nodes([0, 1, 0, 1], 2)  # a slice across two nodes
    with pytest.raises(ValueError, match="3 nodes"):
        check_slice_nodes([0, 0, 1, 2], 2)


@pytest.mark.parametrize("name", ["openwebtext_mh",
                                  "openwebtext_xl_multislice"])
def test_multihost_configs_equal_jax(name):
    from midgpt_tpu.config import get_config as jax_get_config

    ours, ref = get_config(name), jax_get_config(name)
    for f in dataclasses.fields(ours.model):
        assert getattr(ours.model, f.name) == getattr(ref.model, f.name), f
    for f in dataclasses.fields(ours):
        if f.name not in ("model", "device", "mesh"):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert dataclasses.asdict(ours.mesh) == dataclasses.asdict(ref.mesh)
    check_supported(ours.mesh, ours.mesh.sizes(8))


# -- memory -------------------------------------------------------------------


def test_stage_share_of_card_peak_bytes():
    """A stage's parameters are its blocks and the ends it holds; the
    stages' counts add up to the whole model's, and a pipeline rank's
    estimate lies below one card's, while the loopback holds every
    stage."""
    m = ModelConfig(**SMALL)
    full = parameter_count(m)
    parts = [parameter_count(m, 1, (2, (s,))) for s in range(2)]
    assert sum(parts) == full
    tied = ModelConfig(**dict(SMALL, tie_embeddings=True))
    assert sum(parameter_count(tied, 1, (2, (s,))) for s in range(2)) == (
        parameter_count(tied) + m.vocab_size * m.n_embd)
    cfg = ExperimentConfig(model=m, mesh=MeshConfig(fsdp=1, pipeline=2),
                           batch_size=8, g_accum_iters=1)
    for s in range(2):
        rank = Mesh(rank=s, world=2, sizes=(2, 1, 1, 1, 1),
                    distributed=True)
        est = card_peak_bytes(cfg, "none", rank)
        assert est["params"] == parts[s]
        # the last stage stores M = 4 microbatches' inputs, f32
        assert est["saved"] == s * 4 * 2 * 32 * m.n_embd * 4
    one = card_peak_bytes(dataclasses.replace(cfg, mesh=MeshConfig()))
    loop = card_peak_bytes(cfg)
    assert loop["params"] == one["params"] == full
    assert loop["saved"] == 4 * 2 * 32 * m.n_embd * 4
