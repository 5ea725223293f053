"""The tensor axis's pieces, on the CPU (f32; no process group unless a
test spawns a gloo world, ``torch_dist_util``).

- every parameter's shard / unshard round trip, bit for bit, at tensor
  2 and 4 (MHA GELU, GQA SwiGLU, MoE, tied embeddings), through the JAX
  bridge too (``convert``: a rank's model from JAX's dict, and JAX's
  dict back from every rank's model);
- the packed ``wqkv`` shard against JAX's full ``wqkv``: index ``r``
  holds ``[q heads of r | k heads of r | v heads of r]``;
- Megatron's two operators over a gloo world of two (the group
  exchange) and over the loopback: forward and backward;
- the vocab-parallel embedding and loss (dense and chunked) against the
  whole ones, and a whole model held as tensor shards on a loopback
  (logits-free loss, MoE aux included, every gradient) against the
  whole model;
- ``GPT.init``'s ``tensor``: a rank's init equals the slice of the full
  init of the same seed;
- the configs: ``openwebtext_xl``, ``llama_7b`` and ``openwebtext_moe``
  equal JAX's on every shared field, the mesh included (``tensor=4``);
  V, H, Hkv, F or E not divisible by the tensor axis raise ValueError
  naming the field; Ulysses under a tensor axis raises; pipeline still
  raises NotImplementedError; the memory estimate counts a rank's
  shard.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from midgpt_tpu_torch.config import (
    ExperimentConfig,
    MeshConfig,
    ModelConfig,
    get_config,
)
from midgpt_tpu_torch.convert import (
    full_state_dict,
    gpt_from_jax_params,
    jax_params_from_gpt,
)
from midgpt_tpu_torch.models.gpt import GPT, check_tensor
from midgpt_tpu_torch.models.layers import Embedding
from midgpt_tpu_torch.ops.loss import chunked_softmax_xent, dense_softmax_xent
from midgpt_tpu_torch.parallel.mesh import Mesh, check_supported
from midgpt_tpu_torch.parallel.sharding import (
    tensor_dim,
    tensor_shard,
    tensor_unshard,
)
from midgpt_tpu_torch.parallel.tensor import (
    LoopbackTensorExchange,
    copy_to_tensor,
    reduce_from_tensor,
)
from midgpt_tpu_torch.train import (
    card_peak_bytes,
    check_pipeline_axis,
    check_tensor_axis,
    loss_fn,
    parameter_count,
)

from torch_dist_util import run_world
from torch_port_util import GQA, MHA, model_pair

torch.set_num_threads(2)

MODELS = {
    "mha": MHA,
    "gqa": GQA,
    "moe": dict(MHA, mlp="moe", moe_experts=4),
    "moe_top2": dict(MHA, mlp="moe", moe_experts=4, moe_top_k=2),
    "tied": dict(MHA, tie_embeddings=True),
}
TPS = [("mha", 2), ("mha", 4), ("gqa", 2), ("moe", 2), ("moe", 4),
       ("moe_top2", 2), ("tied", 4)]


def _cfg(name, **kw):
    return ModelConfig(**dict(MODELS[name], attn_impl="naive",
                              remat="none", **kw))


@pytest.mark.parametrize("name,tp", TPS)
def test_shard_unshard_round_trip_bit_for_bit(name, tp):
    cfg = _cfg(name)
    full = GPT.init(cfg, device="cpu").state_dict()
    for n, w in full.items():
        shards = [tensor_shard(n, w, (r,), tp, cfg) for r in range(tp)]
        dim = tensor_dim(n)
        if dim is None:
            assert all(s is w for s in shards)
        else:
            assert all(s.shape[dim] * tp == w.shape[dim] for s in shards)
        assert torch.equal(tensor_unshard(n, shards, cfg), w), n
        # every index's shards held end to end: the loopback's layout
        held = tensor_shard(n, w, tuple(range(tp)), tp, cfg)
        assert held.shape == w.shape
    # through the JAX bridge: a rank's model from JAX's dict, and back
    _, tm, params = model_pair(MODELS[name])
    ranks = [gpt_from_jax_params(params, ModelConfig(**MODELS[name]),
                                 device="cpu",
                                 tensor=_Index(r, tp)) for r in range(tp)]
    for r, m in enumerate(ranks):
        for n, w in m.state_dict().items():
            assert torch.equal(w, tensor_shard(n, tm.state_dict()[n], (r,),
                                               tp, m.config)), n
    back = jax_params_from_gpt(ranks)
    assert set(back) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


class _Index(LoopbackTensorExchange):
    """One tensor index's shard held alone (a rank's model, no group)."""

    def __init__(self, r, size):
        super().__init__(size)
        self.held = self.active = (r,)


@pytest.mark.parametrize("tp", [2, 4])
def test_packed_qkv_shard_against_jax_full_wqkv(tp):
    jm, _, params = model_pair(GQA if tp == 2 else MHA)
    cfg = ModelConfig(**(GQA if tp == 2 else MHA))
    h, hkv, c = cfg.n_head, cfg.kv_heads, cfg.head_dim
    full = params["blocks/attn/wqkv/weight"]  # JAX's [L, D, (H+2Hkv)C]
    heads = full.reshape(full.shape[0], full.shape[1], h + 2 * hkv, c)
    hl, kl = h // tp, hkv // tp
    for r in range(tp):
        got = tensor_shard("blocks/attn/wqkv/weight", torch.from_numpy(full),
                           (r,), tp, cfg).numpy()
        want = np.concatenate([
            heads[:, :, r * hl:(r + 1) * hl],
            heads[:, :, h + r * kl:h + (r + 1) * kl],
            heads[:, :, h + hkv + r * kl:h + hkv + (r + 1) * kl]], axis=2)
        np.testing.assert_array_equal(got, want.reshape(got.shape))


def test_megatron_operators_over_a_group(tmp_path):
    rng = np.random.default_rng(0)
    x, w, dout = (rng.standard_normal(s).astype(np.float32)
                  for s in ((3, 4), (2, 4, 5), (3, 5)))
    out = run_world(str(tmp_path), 2, "tensor_ops",
                    {"x": x, "w": w, "dout": dout}, timeout=120)
    # whole: y = x @ (w0 + w1) summed; the loopback holds both shards
    ex = LoopbackTensorExchange(2)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    xc = copy_to_tensor(xt, ex)
    y = reduce_from_tensor([xc @ wt[0], xc @ wt[1]], ex)
    (y * torch.from_numpy(dout)).sum().backward()
    for r, got in enumerate(out):
        np.testing.assert_allclose(got["y"], y.detach().numpy(), rtol=1e-6)
        # f's backward: the whole input gradient on every rank
        np.testing.assert_allclose(got["dx"], xt.grad.numpy(), rtol=1e-6)
        # g's backward: the output gradient passed on as it is
        np.testing.assert_allclose(got["dw"], wt.grad[r].numpy(), rtol=1e-6)
        assert got["collectives"] == {"all_reduce": 2}


@pytest.mark.parametrize("tp", [2, 4])
def test_vocab_parallel_embedding_and_loss_equal_the_whole(tp):
    g = torch.Generator().manual_seed(0)
    v, d = 96, 16
    emb = Embedding(torch.randn(v, d, generator=g)).requires_grad_(False)
    tokens = torch.randint(0, v, (3, 32), generator=g)
    whole = emb(tokens)
    sharded = copy.deepcopy(emb)
    sharded.tensor = LoopbackTensorExchange(tp)
    # the loopback holds every shard: the embedding's rows as they are
    np.testing.assert_array_equal(sharded(tokens).numpy(), whole.numpy())
    for r in range(tp):  # one virtual rank alone: its ids, zeros elsewhere
        sharded.tensor = LoopbackTensorExchange(tp, active=(r,))
        mine = (tokens // (v // tp) == r)[..., None]
        np.testing.assert_array_equal(sharded(tokens).numpy(),
                                      torch.where(mine, whole, 0).numpy())
    h = torch.randn(3, 32, d, generator=g, requires_grad=True)
    w = torch.randn(d, v, generator=g, requires_grad=True)
    y = torch.randint(0, v, (3, 32), generator=g)
    ex = LoopbackTensorExchange(tp)
    for loss in (lambda t: dense_softmax_xent(h, w, y, t),
                 lambda t: chunked_softmax_xent(h, w, y, chunk_t=8,
                                                tensor=t)):
        ref = loss(None)
        dh, dw = torch.autograd.grad(ref, (h, w))
        got = loss(ex)
        gh, gw = torch.autograd.grad(got, (h, w))
        np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)
        np.testing.assert_allclose(gh.numpy(), dh.numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(gw.numpy(), dw.numpy(), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("name,tp", TPS)
@pytest.mark.parametrize("chunk", [None, 16])
def test_loopback_model_equals_the_whole(name, tp, chunk):
    cfg = _cfg(name, block_size=32)
    whole = GPT.init(cfg, device="cpu")
    held = copy.deepcopy(whole).shard_tensor_(LoopbackTensorExchange(tp))
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, cfg.vocab_size, (3, 32), generator=g)
    y = torch.randint(0, cfg.vocab_size, (3, 32), generator=g)
    ref, got = loss_fn(whole, x, y, chunk), loss_fn(held, x, y, chunk)
    ref.backward()
    got.backward()
    np.testing.assert_allclose(got.item(), ref.item(), rtol=1e-6)
    grads = copy.deepcopy(held)
    for p, q in zip(grads.parameters(), held.parameters()):
        p.data = q.grad
    grads = full_state_dict(grads)
    for n, p in whole.named_parameters():
        np.testing.assert_allclose(grads[n].numpy(), p.grad.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("name,tp", [("gqa", 2), ("moe", 4), ("tied", 2)])
def test_rank_init_equals_the_slice_of_the_full_init(name, tp):
    cfg = _cfg(name)
    full = GPT.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    for r in range(tp):
        rank = GPT.init(cfg, torch.Generator().manual_seed(3), device="cpu",
                        tensor=_Index(r, tp))
        for n, w in rank.state_dict().items():
            assert torch.equal(w, tensor_shard(n, full.state_dict()[n], (r,),
                                               tp, cfg)), n


# -- the configs --------------------------------------------------------------


@pytest.mark.parametrize("name", ["openwebtext_xl", "llama_7b",
                                  "openwebtext_moe"])
def test_tensor4_configs_equal_jax(name):
    from midgpt_tpu.config import get_config as jax_get_config

    ours, ref = get_config(name), jax_get_config(name)
    for f in dataclasses.fields(ours.model):
        assert getattr(ours.model, f.name) == getattr(ref.model, f.name), f
    for f in dataclasses.fields(ours):
        if f.name not in ("model", "device", "mesh"):
            assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert dataclasses.asdict(ours.mesh) == dataclasses.asdict(ref.mesh)
    assert ours.mesh.tensor == 4
    check_tensor(ours.model, 4)
    # the shard's parameters and the memory estimate count 1 / tensor
    mesh4 = Mesh(rank=0, world=4, sizes=ours.mesh.sizes(4), distributed=True)
    assert parameter_count(ours.model, 4) < parameter_count(ours.model) / 3.5
    est = card_peak_bytes(ours, "full", mesh4)
    assert est["params"] == parameter_count(ours.model, 4)
    assert est["peak"] < card_peak_bytes(ours, "full")["peak"]


@pytest.mark.parametrize("field,kw", [
    ("vocab_size", dict(vocab_size=97)), ("n_head", dict(n_head=2)),
    ("n_kv_head", dict(n_kv_head=1)), ("mlp_hidden", dict(mlp_hidden=70)),
    ("moe_experts", dict(mlp="moe", moe_experts=6)),
])
def test_a_field_that_does_not_split_raises(field, kw):
    cfg = ModelConfig(**dict(MHA, **kw))
    with pytest.raises(ValueError, match=field):
        check_tensor(cfg, 4)
    with pytest.raises(ValueError, match=field):
        GPT.init(cfg, device="cpu", tensor=LoopbackTensorExchange(4))


def test_ulysses_under_tensor_raises_and_pipeline_is_not_ported():
    """Ulysses under tensor raises; the pipeline axis is ported now, and
    what it still refuses under tensor raises ValueError naming the
    field: an MoE model, ring attention, a pipeline across slices, and a
    replica axis that does not split over the slices."""
    cfg = ExperimentConfig(model=ModelConfig(**dict(MHA,
                                                    attn_impl="ulysses")))
    mesh = Mesh(rank=0, world=4, sizes=(1, 1, 1, 2, 2), distributed=True)
    with pytest.raises(ValueError, match="ulysses"):
        check_tensor_axis(cfg, mesh)
    pp_tp = Mesh(rank=0, world=4, sizes=(2, 1, 1, 1, 2), distributed=True)
    for field, kw in (("mlp", dict(mlp="moe", moe_experts=4)),
                      ("attn_impl", dict(attn_impl="ring"))):
        bad = ExperimentConfig(model=ModelConfig(**dict(MHA, **kw)),
                               mesh=MeshConfig(pipeline=2, tensor=2))
        with pytest.raises(ValueError, match=field):
            check_pipeline_axis(bad, pp_tp)
    for field, kw in (("pipeline", dict(pipeline=2, tensor=2, replica=2,
                                        num_slices=2)),
                      ("num_slices", dict(num_slices=2, tensor=2))):
        m = MeshConfig(**kw)
        with pytest.raises(ValueError, match=field):
            check_supported(m, m.sizes(8 if "pipeline" in kw else 2))
