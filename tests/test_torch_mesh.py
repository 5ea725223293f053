"""The port's data-parallel and FSDP mesh against the JAX package's, on the
CPU (f32 compute; worlds of 1, 2 and 4 spawned ranks over gloo,
``torch_dist_util``).

- ``MeshConfig.sizes`` and its errors against JAX's over a table of
  configs and device counts; what JAX refuses of the pipeline and
  multi-slice axes raises ``ValueError``, ``sequence=2`` builds its
  groups and ring neighbours, ``tensor=2`` its tensor and ``fsdp x
  tensor`` groups; no process group gives the one-rank mesh;
- each rank's grid coordinates against ``create_mesh``'s device grid on
  the 8-device CPU mesh, and a spawned world's axis groups;
- ``FlatShards``: the slices cover every element once, each tensor
  starts aligned;
- ``load_shard`` and ``Loader(process_index=p)`` batches bit for bit
  against JAX's for every ``p`` of ``n`` = 2 and 4;
- one step and five steps at ``fsdp=2`` (world 2) and at ``replica=2,
  fsdp=2`` (world 4): losses, grad norms and the gathered f32 params
  against JAX's train window on a mesh of the same sizes, fed the same
  global batch (rtol 1e-5 on losses and norms; params rtol 1e-5, atol
  2e-6), each rank holding ``1 / fsdp`` of the masters and moments;
- a one-rank mesh step equals the single-card step bit for bit (f32 and
  bf16 compute);
- dropout 0.1 (naive and flash attention): world 2 against world 1 on
  the same global batch (rtol 1e-5; the masks are keyed by global row,
  so only the reduction order differs), and the row offsets of the
  residual mask and the attention mask against slices of the whole
  batch's, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.config import ExperimentConfig as JaxExperimentConfig
from midgpt_tpu.config import MeshConfig as JaxMeshConfig
from midgpt_tpu.config import ModelConfig as JaxModelConfig
from midgpt_tpu.data import Loader as JaxLoader
from midgpt_tpu.data import load_shard as jax_load_shard
from midgpt_tpu.pytree import tree_paths
from midgpt_tpu_torch.config import ExperimentConfig, MeshConfig, ModelConfig
from midgpt_tpu_torch.convert import jax_params_from_gpt
from midgpt_tpu_torch.data import Loader, load_shard, write_tokens
from midgpt_tpu_torch.models.gpt import GPT
from midgpt_tpu_torch.models.layers import dropout, fold_in
from midgpt_tpu_torch.ops.attention import naive_attention
from midgpt_tpu_torch.ops.dropout import keep_mask_reference
from midgpt_tpu_torch.ops.flash import flash_attention_dropout
from midgpt_tpu_torch.parallel import (
    FlatShards,
    batch_rows,
    create_mesh,
    local_batch_size,
)
from midgpt_tpu_torch.parallel.mesh import (
    AXIS_NAMES,
    Mesh,
    axis_ranks,
    check_supported,
    grid_coords,
)
from midgpt_tpu_torch.parallel.sharding import ALIGN
from midgpt_tpu_torch.train import (
    effective_loss_chunk,
    make_lr_schedule,
    make_shadow,
    state_from_model,
    train_step,
)

from torch_dist_util import chip_smoke, run_world
from torch_port_util import model_pair

torch.set_num_threads(2)

MODEL = dict(block_size=32, vocab_size=96, n_layer=2, n_head=4, n_embd=64,
             attn_impl="naive", remat="none")
TRAIN = dict(learning_rate=1e-3, min_lr=1e-4, warmup_steps=2,
             lr_decay_steps=10, beta2=0.99, weight_decay=1e-4,
             grad_clip=1.0, batch_size=8, g_accum_iters=2)
STEPS = 5


# -- the mesh -----------------------------------------------------------------

SIZES_TABLE = [
    (dict(), 1), (dict(), 8), (dict(replica=2), 8), (dict(replica=-1, fsdp=2), 8),
    (dict(fsdp=2, tensor=2, sequence=2), 8), (dict(pipeline=2), 4),
    (dict(replica=4, fsdp=1), 4), (dict(fsdp=3), 8), (dict(fsdp=2), 3),
    (dict(replica=2, fsdp=2), 8), (dict(replica=-1, fsdp=-1), 4),
    (dict(sequence=2), 4), (dict(fsdp=1, sequence=-1), 4),
]


@pytest.mark.parametrize("kw,n", SIZES_TABLE)
def test_mesh_sizes_match_jax(kw, n):
    def sizes(cfg):
        try:
            return cfg.sizes(n)
        except AssertionError as e:
            return ("AssertionError", type(e).__name__)
        except ValueError as e:  # list.index on two -1s
            return ("ValueError", type(e).__name__)

    ours, ref = MeshConfig(**kw), JaxMeshConfig(**kw)
    assert sizes(ours) == sizes(ref)
    assert ours.axis_names == ref.axis_names == AXIS_NAMES
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("kw", [dict(fsdp=8), dict(replica=2, fsdp=4),
                                dict(replica=4, fsdp=2), dict(replica=8, fsdp=1)])
def test_grid_coords_match_create_mesh(kw):
    from midgpt_tpu.parallel.mesh import create_mesh as jax_create_mesh

    devices = jax.devices()[:8]
    jmesh = jax_create_mesh(JaxMeshConfig(**kw), devices=devices)
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    sizes = MeshConfig(**kw).sizes(8)
    assert ids.shape == sizes
    for rank in range(8):
        assert tuple(np.argwhere(ids == devices[rank].id)[0]) == grid_coords(
            rank, sizes)
        for axis in ("replica", "fsdp"):
            a = AXIS_NAMES.index(axis)
            idx = list(grid_coords(rank, sizes))
            idx[a] = slice(None)
            order = [d.id for d in devices]
            along = [order.index(i) for i in ids[tuple(idx)]]
            assert axis_ranks(rank, sizes, axis) == along
        mesh = Mesh(rank=rank, world=8, sizes=sizes)
        # the batch spec P(("replica", "fsdp")): replica outer, fsdp inner
        assert mesh.data_index == (mesh.index("replica") * mesh.fsdp
                                   + mesh.index("fsdp"))


def test_spawned_world_axis_groups(tmp_path):
    out = run_world(str(tmp_path), 4, "mesh_layout",
                    {"mesh": dict(replica=2, fsdp=2)}, timeout=120)
    sizes = (1, 2, 2, 1, 1)
    for r, got in enumerate(out):
        assert got["rank"] == r and tuple(got["sizes"]) == sizes
        assert tuple(got["coords"]) == grid_coords(r, sizes)
        assert got["fsdp"] == axis_ranks(r, sizes, "fsdp")
        assert got["replica"] == axis_ranks(r, sizes, "replica")
        assert got["data_index"] == r


@pytest.mark.parametrize("kw,axis", [
    pytest.param(dict(pipeline=2, num_slices=2), "pipeline",
                 id="kw1-pipeline"),
    pytest.param(dict(num_slices=2), "num_slices", id="kw2-num_slices"),
])
def test_unported_axes_raise(kw, axis):
    """Both axes are ported; what JAX refuses of them raises ValueError
    naming the field: a pipeline across slices, and a replica axis (1
    here) that does not split over the slices."""
    cfg = MeshConfig(**kw)
    with pytest.raises(ValueError, match=axis):
        check_supported(cfg, cfg.sizes(4))
    assert check_supported(MeshConfig(pipeline=2), (2, 1, 2, 1, 1)) is None


@pytest.mark.parametrize("world,kw", [
    (2, dict(fsdp=1, tensor=2)), (4, dict(fsdp=2, tensor=2)),
    (4, dict(fsdp=1, sequence=2, tensor=2)),
], ids=["tensor2", "fsdp2_tensor2", "sequence2_tensor2"])
def test_tensor_axis_builds_its_groups(tmp_path, world, kw):
    """``tensor=2`` builds a mesh: the tensor group along JAX's grid (the
    innermost axis), ``fsdp x tensor`` (the gradient norm's), the fsdp
    and gradient groups at a fixed tensor coordinate, and the data
    shards of ``replica x fsdp`` (tensor peers hold the same rows)."""
    cfg = MeshConfig(**kw)
    check_supported(cfg, cfg.sizes(world))
    out = run_world(str(tmp_path), world, "mesh_layout", {"mesh": kw},
                    timeout=120)
    sizes = cfg.sizes(world)
    for r, got in enumerate(out):
        ten = axis_ranks(r, sizes, "tensor")
        assert got["tensor"] == ten and got["tp_size"] == 2
        assert got["tp_index"] == grid_coords(r, sizes)[4] == ten.index(r)
        assert got["param"] == axis_ranks(r, sizes, ("fsdp", "tensor"))
        assert got["fsdp"] == axis_ranks(r, sizes, "fsdp")
        assert got["grad"] == axis_ranks(r, sizes, ("replica", "sequence"))
        peer = out[ten[1 - ten.index(r)]]
        assert got["data_index"] == peer["data_index"]


@pytest.mark.parametrize("world,kw", [
    (2, dict(fsdp=1, sequence=2)), (4, dict(fsdp=2, sequence=2)),
    (4, dict(replica=2, fsdp=1, sequence=2)),
], ids=["sequence2", "fsdp2_sequence2", "replica2_sequence2"])
def test_sequence_axis_builds_its_groups(tmp_path, world, kw):
    """``sequence=2`` builds a mesh: the sequence group and ring
    neighbours along JAX's grid, the gradient's group over ``replica x
    sequence`` (the ranks that share the fsdp coordinate), and the data
    shards of ``replica x fsdp`` (sequence peers hold the same rows)."""
    cfg = MeshConfig(**kw)
    check_supported(cfg, cfg.sizes(world))
    out = run_world(str(tmp_path), world, "mesh_layout", {"mesh": kw},
                    timeout=120)
    sizes = cfg.sizes(world)
    for r, got in enumerate(out):
        seq = axis_ranks(r, sizes, "sequence")
        i = seq.index(r)
        assert got["sequence"] == seq and got["seq_size"] == 2
        assert got["seq_index"] == grid_coords(r, sizes)[3] == i
        assert (got["seq_next"], got["seq_prev"]) == (seq[(i + 1) % 2],
                                                       seq[(i - 1) % 2])
        assert got["grad"] == axis_ranks(r, sizes, ("replica", "sequence"))
        assert got["fsdp"] == axis_ranks(r, sizes, "fsdp")
        peer = out[seq[1 - i]]
        assert got["data_index"] == peer["data_index"]


def test_no_process_group_gives_the_one_rank_mesh():
    mesh = create_mesh(MeshConfig())
    assert not mesh.distributed and mesh.world == 1
    assert mesh.sizes == (1,) * 5 and mesh.data_index == 0
    assert local_batch_size(8, 2, mesh) == 4
    assert batch_rows(4, mesh) == slice(0, 4)
    four = Mesh(rank=3, world=4, sizes=(1, 2, 2, 1, 1))
    assert local_batch_size(8, 2, four) == 1
    assert batch_rows(8, four) == slice(6, 8)
    with pytest.raises(AssertionError):
        local_batch_size(6, 2, four)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_flat_shards_cover_every_element_once(n):
    shapes = [(5, 7), (64,), (3, 130), (1,), (200, 3)]
    seen = np.zeros(sum(int(np.prod(s)) for s in shapes), dtype=int)
    tensors = [torch.arange(int(np.prod(s)), dtype=torch.float32).reshape(s)
               + 1000 * i for i, s in enumerate(shapes)]
    starts = np.cumsum([0] + [int(np.prod(s)) for s in shapes])
    for i in range(n):
        lay = FlatShards(shapes, n, i)
        assert lay.padded % (ALIGN * n) == 0 and lay.shard_len * n == lay.padded
        assert all(o % ALIGN == 0 for o in lay.offsets)
        shard = lay.shard_from(tensors, torch.float32, "cpu")
        for (t_i, a, b), v in zip(lay.pieces, lay.piece_views(shard)):
            seen[starts[t_i] + a:starts[t_i] + b] += 1
            np.testing.assert_array_equal(
                v.reshape(-1).numpy(), tensors[t_i].reshape(-1)[a:b].numpy())
    assert (seen == 1).all()


# -- per-process data ---------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_process_shards_and_loaders_match_jax(tmp_path, n):
    path = str(tmp_path / "train.bin")
    write_tokens(path, np.random.default_rng(3).integers(0, 50304, 100_003))
    for p in range(n):
        ours = load_shard(path, p, n)
        ref = jax_load_shard(path, p, n)
        np.testing.assert_array_equal(ours, ref.tokens)
        for stream in (0, 1, 2):
            a = Loader(ours, 64, (2, 3), seed=1234, stream=stream,
                       process_index=p)
            b = JaxLoader(ref, 64, (2, 3), seed=1234, process_index=p,
                          stream=stream)
            for _ in range(3):
                for u, v in zip(a.next(), b.next()):
                    np.testing.assert_array_equal(u, v)
    with pytest.raises(ValueError):
        load_shard(path, n, n)


# -- the step against JAX -----------------------------------------------------


def _batches(vocab=MODEL["vocab_size"], seed=7):
    rng = np.random.default_rng(seed)
    g, b = TRAIN["g_accum_iters"], TRAIN["batch_size"] // TRAIN["g_accum_iters"]
    toks = rng.integers(0, vocab, (STEPS, g, b, MODEL["block_size"] + 1))
    return toks[..., :-1].astype(np.int32), toks[..., 1:].astype(np.int32)


def _port_args(tm, mesh, **model_kw):
    xs, ys = _batches()
    return dict(model=dict(MODEL, **model_kw),
                train=dict(TRAIN, compute_dtype="float32", device="cpu"),
                mesh=mesh, init={k: v.clone() for k, v in
                                 tm.state_dict().items()},
                xs=xs, ys=ys, gather_after=(1, STEPS))


def _as_jax_paths(named, model_kw=MODEL):
    model = GPT.init(ModelConfig(**model_kw), device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in named.items()})
    return jax_params_from_gpt(model)


@pytest.mark.parametrize("world,mesh", [(2, dict(fsdp=2)),
                                        (4, dict(replica=2, fsdp=2))],
                         ids=["fsdp2", "replica2_fsdp2"])
def test_mesh_steps_match_jax_mesh_step(tmp_path, world, mesh):
    from midgpt_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from midgpt_tpu.train import TrainState, make_optimizer, make_train_window

    jm, tm, _ = model_pair(MODEL, gain=1.0)
    out = run_world(str(tmp_path), world, "mesh_steps",
                    _port_args(tm, mesh), timeout=180)

    jcfg = JaxExperimentConfig(model=JaxModelConfig(**MODEL),
                               compute_dtype="float32",
                               mesh=JaxMeshConfig(**mesh), **TRAIN)
    jmesh = jax_create_mesh(jcfg.mesh, devices=jax.devices()[:world])
    tx, _ = make_optimizer(jcfg)
    window = make_train_window(jcfg, tx, jmesh, 1)
    jstate = TrainState(params=jm, opt_state=tx.init(jm),
                        step=jnp.zeros((), jnp.int32))
    xs, ys = _batches()
    losses, norms, params = [], [], {}
    for s in range(STEPS):
        jstate, aux = window(jstate, jnp.asarray(xs[s:s + 1]),
                             jnp.asarray(ys[s:s + 1]), jax.random.PRNGKey(0))
        losses.append(float(aux["loss"][0]))
        norms.append(float(aux["grad_norm"][0]))
        if s + 1 in (1, STEPS):
            params[s + 1] = {k: np.asarray(v)
                             for k, v in tree_paths(jstate.params)}

    fsdp = MeshConfig(**mesh).sizes(world)[2]
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["loss"], losses, rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-5)
        lo, hi, n_master, n_mu, n_nu, padded = got["shard"]
        # this rank's 1 / fsdp of the masters and both moments
        assert n_master == n_mu == n_nu == padded // fsdp == hi - lo
        assert lo == (r % fsdp) * (padded // fsdp)
        for step in (1, STEPS):
            ours = _as_jax_paths(got["params"][step])
            assert set(ours) == set(params[step])
            for k in ours:
                np.testing.assert_allclose(ours[k], params[step][k],
                                           rtol=1e-5, atol=2e-6,
                                           err_msg=f"rank {r} step {step} {k}")


@pytest.mark.parametrize("dtype,model_kw,loss_chunk,rows", [
    pytest.param("float32", {}, None, 4, id="float32"),
    pytest.param("bfloat16", {}, None, 4, id="bfloat16"),
    pytest.param("bfloat16", dict(remat="dots"), 8, 3, id="chunked_dots"),
    pytest.param("float32", dict(remat="full", mlp="moe", moe_experts=4),
                 8, 3, id="chunked_moe_full"),
    pytest.param("bfloat16", dict(block_size=24), None, 3, id="bfloat16_t24"),
    pytest.param("float32", dict(block_size=24), 8, 3, id="chunked_t24"),
])
def test_one_rank_mesh_step_equals_single_card_step(tmp_path, dtype,
                                                    model_kw, loss_chunk,
                                                    rows):
    """A world of one (``tensor=1``: the model computes through a one-rank
    tensor group, Megatron's operators, the vocab-parallel embedding and
    loss and the QK-norms' gradient sum each a copy) steps to the
    single-card trainer's numbers bit for bit, and counts the tensor
    all-reduces. Microbatches of 3 rows make 96 tokens (72 at T = 24),
    so the loss's gradient scale is no power of two. The single-card
    steps run on one CPU thread, as the spawned rank does: the CPU's
    matmuls and reductions split their sums by the thread count, so two
    threads against one differ in the last bits (at T = 24 in ``wqkv``
    and, with the chunked loss, ``wte``), whatever the mesh does."""
    kw = dict(MODEL, **model_kw)
    _, tm, _ = model_pair(kw, gain=1.0)
    args = _port_args(tm, dict(fsdp=1), **model_kw)
    args["train"].update(compute_dtype=dtype, loss_chunk=loss_chunk,
                         batch_size=rows * TRAIN["g_accum_iters"])
    t = kw["block_size"]
    args["xs"] = args["xs"][:, :, :rows, :t]
    args["ys"] = args["ys"][:, :, :rows, :t]
    got = run_world(str(tmp_path), 1, "mesh_steps", args, timeout=120)[0]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _single_card_steps(args, got, dtype)
    finally:
        torch.set_num_threads(threads)


def _single_card_steps(args, got, dtype):
    """The single-card trainer on the rank's model and batches: each step's
    loss and grad norm, and the params after the last, equal the rank's
    bit for bit."""
    cfg = ExperimentConfig(model=ModelConfig(**args["model"]),
                           **args["train"])
    assert got["collectives"]["all_reduce"] == (
        chip_smoke().tensor_all_reduces(cfg))
    model = GPT.init(cfg.model, device="cpu")
    model.load_state_dict(args["init"])
    state = state_from_model(model)
    shadow = make_shadow(model, getattr(torch, dtype))
    sched = make_lr_schedule(cfg)
    for s in range(STEPS):
        loss, norm = train_step(state, shadow,
                                torch.from_numpy(args["xs"][s]).long(),
                                torch.from_numpy(args["ys"][s]).long(),
                                cfg, sched(s), effective_loss_chunk(cfg))
        assert float(loss) == got["loss"][s], s
        assert float(norm) == got["grad_norm"][s], s
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got["params"][STEPS][k],
                                      err_msg=k)


# -- dropout under the mesh ---------------------------------------------------


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_dropout_world2_equals_world1(tmp_path, impl):
    _, tm, _ = model_pair(MODEL, gain=1.0)
    kw = dict(dropout=0.1, attn_impl=impl)
    keys = [fold_in(5, s) for s in range(STEPS)]
    runs = {}
    for world in (1, 2):
        args = dict(_port_args(tm, dict(fsdp=world), **kw), step_keys=keys)
        runs[world] = run_world(str(tmp_path / f"w{world}"), world,
                                "mesh_steps", args, timeout=180)[0]
    np.testing.assert_allclose(runs[2]["loss"], runs[1]["loss"], rtol=1e-5)
    np.testing.assert_allclose(runs[2]["grad_norm"], runs[1]["grad_norm"],
                               rtol=1e-5)
    for k, v in runs[1]["params"][STEPS].items():
        np.testing.assert_allclose(runs[2]["params"][STEPS][k], v, rtol=1e-5,
                                   atol=2e-6, err_msg=k)
    # and dropout draws: another key moves the loss
    assert runs[1]["loss"][0] != pytest.approx(
        run_world(str(tmp_path / "other"), 1, "mesh_steps",
                  dict(_port_args(tm, dict(fsdp=1), **kw),
                       step_keys=[k + 1 for k in keys]),
                  timeout=120)[0]["loss"][0], rel=1e-6)


def test_row_offsets_draw_the_whole_batch_masks():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, 8, generator=g)
    key = torch.tensor(fold_in(3, 1), dtype=torch.int64)
    whole = dropout(x, 0.3, key)
    for lo in range(6):
        np.testing.assert_array_equal(
            dropout(x[lo:lo + 2], 0.3, key, row_offset=lo).numpy(),
            whole[lo:lo + 2].numpy())
    # the index wraps at 2^32, as the kernel's uint32 does
    wrap = keep_mask_reference(key, 4, 0.5, offset=(1 << 32) - 2)
    np.testing.assert_array_equal(
        wrap.numpy(),
        torch.cat([keep_mask_reference(key, 2, 0.5, offset=(1 << 32) - 2),
                   keep_mask_reference(key, 2, 0.5)]).numpy())
    b, h, t, c = 4, 2, 16, 8
    q, k, v = (torch.randn(b, h, t, c, generator=g) for _ in range(3))
    full_naive = naive_attention(q, k, v, dropout_rate=0.2, seed=11)
    full_flash = flash_attention_dropout(q, k, v, 11, 0.2)
    for lo in (1, 2):
        sl = slice(lo, lo + 2)
        np.testing.assert_array_equal(
            naive_attention(q[sl], k[sl], v[sl], dropout_rate=0.2, seed=11,
                            batch_offset=lo).numpy(), full_naive[sl].numpy())
        np.testing.assert_array_equal(
            flash_attention_dropout(q[sl], k[sl], v[sl], 11, 0.2,
                                    bh_off=lo * h).numpy(),
            full_flash[sl].numpy())
