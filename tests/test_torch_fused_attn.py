"""The port's fused QK-LayerNorm + RoPE + attention against the JAX
package's, on the same NumPy inputs.

JAX runs its Pallas kernels through the CPU interpreter (the
``pallas_interpret`` fixture); the port runs the kernels' plain versions
(its wrapper's CPU path). Checked in f32:

- ``fused_attention_qkv`` forward within 2e-5 and the gradients of
  ``qkv``, ``wq`` and ``wk`` within 5e-4 (absolute plus relative: the JAX
  package's own tolerances for its kernels against its oracle), through
  the combined backward (T below the block cap);
- the plain backward against ``torch.autograd`` through the unfused
  oracle ``fused_attention_reference``, within 1e-5: the same f32 math in
  another order;
- the split backward (T above the combined kernel's cap; the test lowers
  the port's cap so that T=256 takes it): the port's plain pre-pass, dq
  and dk/dv with the GQA group sum, through ``fused_attention_qkv``,
  against JAX's split path (``fused_attention`` with
  ``block_q=block_k=128``, its ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``
  in interpret mode) within 5e-4, and against the port's combined plain
  backward within 1e-5; the routing rule (``takes_split``) against JAX's
  (``_fused_backward``, ``t <= _BWD_DQ_CAP[hpb]``) over a grid of (T, C);
- the bf16 split route's stages (``split_schedule``: dq blocks of one q
  tile, dk/dv blocks of one k tile pair), written out tile by tile
  in plain PyTorch: against JAX's split kernels within 5e-4 and against
  the plain split backward within 1e-5 (f32), over MHA, GQA and MQA
  geometries and T % 128 == 64; the schedule covers every tile once, the
  dk/dv blocks with equal causal work; the split wrappers give the same
  bits with and without the pre-pass's q^ and k^ given;
- ``supported`` against the JAX package's matrix, and the dispatch:
  ``auto`` takes the naive path on the CPU and the fused kernels for CUDA
  tensors, ``fused`` refuses a shape the kernels do not take, and on the
  card ``auto`` routes such a shape, or a step that draws attention
  dropout, to the flash kernels (which raise for a shape they do not
  take), never to the naive path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.models.layers import rope_tables
from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.models.gpt import GPT, Attention
from midgpt_tpu_torch.ops import fused_attn as fa

from torch_port_util import t

torch.set_num_threads(2)

GEOMS = [(2, 256, 4, 4, 64), (2, 256, 4, 2, 128)]


def _inputs(b, tt, h, hkv, c, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, tt, (h + 2 * hkv) * c)).astype(np.float32)
    wq = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    wk = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    w_out = rng.standard_normal((b, tt, h * c)).astype(np.float32)
    sin_h, cos_h = rope_tables(c, tt)
    sin = np.repeat(sin_h, 2, axis=-1).astype(np.float32)
    cos = np.repeat(cos_h, 2, axis=-1).astype(np.float32)
    return qkv, wq, wk, sin, cos, w_out


@pytest.mark.parametrize("geom", GEOMS, ids=["mha_c64", "gqa_c128"])
def test_fused_attention_matches_jax_kernels(pallas_interpret, geom):
    from midgpt_tpu.ops.fused_attn import fused_attention_qkv as jax_fused

    b, tt, h, hkv, c = geom
    qkv, wq, wk, sin, cos, w_out = _inputs(b, tt, h, hkv, c)

    def jax_loss(q_, wq_, wk_):
        out = jax_fused(q_, wq_, wk_, jnp.asarray(sin), jnp.asarray(cos), h,
                        hkv, True, 1e-6)
        return jnp.sum(out * w_out), out

    (_, ref), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(wq), jnp.asarray(wk))
    args = [t(a).requires_grad_() for a in (qkv, wq, wk)]
    before = (fa.fused_attention_fwd.launches, fa.fused_attention_bwd.launches)
    out = fa.fused_attention_qkv(*args, t(sin), t(cos), h, hkv)
    (out * t(w_out)).sum().backward()
    assert (fa.fused_attention_fwd.launches,
            fa.fused_attention_bwd.launches) == before  # plain versions
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    for name, a, g in zip(["dqkv", "dwq", "dwk"], args, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("geom", GEOMS + [(1, 128, 2, 1, 128)],
                         ids=["mha_c64", "gqa_c128", "mqa_c128"])
def test_plain_backward_equals_autograd_of_the_oracle(geom):
    b, tt, h, hkv, c = geom
    qkv, wq, wk, sin, cos, w_out = _inputs(b, tt, h, hkv, c, seed=1)
    args = [t(a).requires_grad_() for a in (qkv, wq, wk)]
    ref = fa.fused_attention_reference(*args, t(sin), t(cos), h, hkv)
    (ref * t(w_out)).sum().backward()
    out, lse = fa.fused_attention_forward_reference(
        t(qkv), t(wq), t(wk), t(sin), t(cos), h, hkv)
    grads = fa.fused_attention_backward_reference(
        t(qkv), t(wq), t(wk), t(sin), t(cos), out, lse, t(w_out), h, hkv)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    for name, a, g in zip(["dqkv", "dwq", "dwk"], args, grads):
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("geom", GEOMS + [(1, 128, 2, 1, 128),
                                  (1, 512, 2, 2, 64)],
                         ids=["mha_c64", "gqa_c128", "mqa_c128", "mha_t512"])
def test_staged_backward_matches_jax_combined_kernel(pallas_interpret, geom):
    """The bf16 kernel route's decomposition, in f32 on the CPU: plain
    pre-pass, the per-k-tile walk with one dq partial per group
    (``dq_groups``: 2 at T=256, 1 at T=128, 4 at T=512), partials summed in
    group order in the post-pass. Held against JAX's single-pass combined
    kernel (``_fused_backward``, T under the cap, in interpret mode) within
    5e-4, the JAX package's tolerance for its kernels, and against the
    port's unstaged plain backward within 1e-5 (the same f32 sums, split
    at tile boundaries)."""
    from midgpt_tpu.ops.fused_attn import (_fused_backward, _fused_forward,
                                           _packed_geometry)

    b, tt, h, hkv, c = geom
    qkv, wq, wk, sin, cos, dout = _inputs(b, tt, h, hkv, c, seed=2)
    jq = jnp.asarray(qkv)
    c_, koff, voff = _packed_geometry(jq, h, hkv)
    kw = dict(n_head=h, n_kv_head=hkv, causal=True, bq=None, bk=None,
              head_dim=c_, koff=koff, voff=voff, eps=1e-6)
    jout, jlse = _fused_forward(jq, jq, jq, jnp.asarray(wq), jnp.asarray(wk),
                                jnp.asarray(sin), jnp.asarray(cos), **kw)
    jgrads = _fused_backward(jq, jq, jq, jnp.asarray(wq), jnp.asarray(wk),
                             jnp.asarray(sin), jnp.asarray(cos), jout, jlse,
                             jnp.asarray(dout), **kw)
    jdqkv = np.concatenate([np.asarray(g) for g in jgrads[:3]], axis=-1)
    out = t(np.asarray(jout))
    lse = t(np.asarray(jlse)).reshape(b, h, tt)
    args = [t(a) for a in (qkv, wq, wk, sin, cos)]
    staged = fa.fused_attention_backward_staged_reference(
        *args, out, lse, t(dout), h, hkv)
    plain = fa.fused_attention_backward_reference(*args, out, lse, t(dout),
                                                  h, hkv)
    for name, s, j, p in zip(["dqkv", "dwq", "dwk"], staged,
                             [jdqkv, *jgrads[3:]], plain):
        np.testing.assert_allclose(s.numpy(), np.asarray(j), rtol=5e-4,
                                   atol=5e-4, err_msg=name)
        np.testing.assert_allclose(s.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_supported_matches_jax_matrix():
    from midgpt_tpu.ops.fused_attn import supported as jax_supported

    for h in (1, 2, 3, 4, 6, 11, 12, 32):
        for hkv in (1, 2, 3, 4, 6, 8, 12):
            for c in (32, 64, 96, 128, 256):
                assert fa.supported(h, hkv, c) == jax_supported(h, hkv, c), (
                    h, hkv, c)


def _attention(n_head=4, n_kv_head=4, n_embd=256, qk_norm=True):
    cfg = ModelConfig(block_size=256, vocab_size=32, n_layer=1,
                      n_head=n_head, n_kv_head=n_kv_head, n_embd=n_embd,
                      qk_norm=qk_norm)
    return Attention.init(cfg, torch.Generator().manual_seed(0))


def test_dispatch_auto_and_fused():
    """``auto`` on the card takes the fused kernels where they take the
    shape and no attention dropout is drawn, else the flash kernels."""
    from midgpt_tpu_torch.ops.attention import resolve_impl

    attn = _attention()
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not attn._use_fused("auto", 128, cpu)  # naive on the CPU
    assert attn._use_fused("auto", 128, cuda)
    assert attn._use_fused("fused", 128, cpu)
    assert not attn._use_fused("naive", 128, cuda)
    for bad in (_attention(n_kv_head=2), _attention(n_embd=192)):
        with pytest.raises(ValueError, match="attn_impl='fused'"):
            bad._use_fused("fused", 128, cpu)
        assert not bad._use_fused("auto", 128, cuda)
    assert not attn._use_fused("auto", 192, cuda)  # T not a multiple of 128
    assert not _attention(qk_norm=False)._use_fused("auto", 128, cuda)
    assert resolve_impl("auto", cuda) == "flash"  # for each shape above
    # attention dropout drawn: flash; none drawn (evals): fused
    attn.dropout_rate = 0.2
    assert not attn._use_fused("auto", 128, cuda, drops=True)
    assert attn._use_fused("auto", 128, cuda, drops=False)
    with pytest.raises(ValueError, match="no attention dropout"):
        attn._use_fused("fused", 128, cpu, drops=True)


def test_model_auto_on_cpu_is_the_naive_path():
    cfg = ModelConfig(block_size=128, vocab_size=64, n_layer=2, n_head=2,
                      n_embd=128, remat="none")
    model = GPT.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tok = torch.from_numpy(
        np.random.default_rng(0).integers(0, 64, (2, 128))).long()
    with torch.no_grad():
        auto = model(tok, attn_impl="auto")
        naive = model(tok, attn_impl="naive")
        fused = model(tok, attn_impl="fused")
    assert torch.equal(auto, naive)
    np.testing.assert_allclose(fused.numpy(), naive.numpy(), rtol=1e-4,
                               atol=1e-4)


def _spy_split(monkeypatch):
    """Count the split wrappers' calls (CPU: their plain versions)."""
    calls = {"prep": 0, "dq": 0, "dkv": 0}
    for name in calls:
        real = getattr(fa, f"fused_attention_bwd_{name}")

        def counting(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(fa, f"fused_attention_bwd_{name}", counting)
    return calls


@pytest.mark.parametrize("geom", GEOMS, ids=["mha_c64", "gqa_c128"])
def test_split_backward_matches_jax_split_kernels(pallas_interpret,
                                                  monkeypatch, geom):
    from midgpt_tpu.ops.fused_attn import fused_attention as jax_fused

    b, tt, h, hkv, c = geom
    qkv, wq, wk, sin, cos, w_out = _inputs(b, tt, h, hkv, c, seed=2)
    hc, kc = h * c, hkv * c

    def jax_loss(q_, k_, v_, wq_, wk_):
        # block_q / block_k given: JAX takes its split kernels at any T
        out = jax_fused(q_, k_, v_, wq_, wk_, jnp.asarray(sin),
                        jnp.asarray(cos), h, hkv, True, 128, 128, 1e-6)
        return jnp.sum(out * w_out), out

    parts = (qkv[..., :hc], qkv[..., hc : hc + kc], qkv[..., hc + kc :])
    (_, ref), jgrads = jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in (*parts, wq, wk)))
    monkeypatch.setattr(fa, "BWD_CAP", {2: 128, 1: 128})
    assert fa.takes_split(tt, c)
    calls = _spy_split(monkeypatch)
    args = [t(a).requires_grad_() for a in (qkv, wq, wk)]
    out = fa.fused_attention_qkv(*args, t(sin), t(cos), h, hkv)
    (out * t(w_out)).sum().backward()
    assert calls == {"prep": 1, "dq": 1, "dkv": 1}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    dqkv = np.concatenate([np.asarray(g) for g in jgrads[:3]], axis=-1)
    for name, a, g in zip(["dqkv", "dwq", "dwk"], args,
                          [dqkv, *jgrads[3:]]):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("geom", GEOMS + [(1, 128, 2, 1, 128)],
                         ids=["mha_c64", "gqa_c128", "mqa_c128"])
def test_split_plain_equals_combined_plain(geom):
    """The split pair (delta, dq, dk/dv per q head, the group sum) and the
    combined plain backward: the same f32 math, within 1e-5."""
    b, tt, h, hkv, c = geom
    qkv, wq, wk, sin, cos, w_out = (t(a) for a in _inputs(b, tt, h, hkv, c,
                                                          seed=3))
    out, lse = fa.fused_attention_forward_reference(qkv, wq, wk, sin, cos,
                                                    h, hkv)
    ref = fa.fused_attention_backward_reference(qkv, wq, wk, sin, cos, out,
                                                lse, w_out, h, hkv)
    got = fa.fused_attention_bwd_split(qkv, wq, wk, sin, cos, out, lse,
                                      w_out, h, hkv)
    for name, a, r in zip(["dqkv", "dwq", "dwk"], got, ref):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # the wrappers' CPU paths write into given rows (dqkv's slots)
    delta = fa.attention_delta(out, w_out, h)
    dqkv = torch.zeros_like(qkv)
    dq, _ = fa.fused_attention_bwd_dq(qkv, wq, wk, sin, cos, lse, delta,
                                      w_out, h, hkv, out=dqkv[..., : h * c])
    assert dq.data_ptr() == dqkv.data_ptr()
    np.testing.assert_allclose(dqkv[..., : h * c].numpy(),
                               ref[0][..., : h * c].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_split_routing_matches_jax():
    import midgpt_tpu.ops.fused_attn as jax_fa

    for c in (64, 128, 256):
        for tt in (64, 128, 512, 960, 1024, 1088, 2048, 2112, 4096):
            jax_split = not tt <= jax_fa._BWD_DQ_CAP[2 if c == 64 else 1]
            assert fa.takes_split(tt, c) == jax_split, (tt, c)


def _jax_split_grads(geom, seed):
    """JAX's split path (block_q = block_k = 128, its split kernels in
    interpret mode) on ``_inputs(geom, seed)``: (inputs, dqkv, dwq, dwk)
    of ``sum(out * w_out)``."""
    from midgpt_tpu.ops.fused_attn import fused_attention as jax_fused

    b, tt, h, hkv, c = geom
    qkv, wq, wk, sin, cos, w_out = _inputs(b, tt, h, hkv, c, seed=seed)
    hc, kc = h * c, hkv * c

    def jax_loss(q_, k_, v_, wq_, wk_):
        out = jax_fused(q_, k_, v_, wq_, wk_, jnp.asarray(sin),
                        jnp.asarray(cos), h, hkv, True, 128, 128, 1e-6)
        return jnp.sum(out * w_out)

    parts = (qkv[..., :hc], qkv[..., hc : hc + kc], qkv[..., hc + kc :])
    grads = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in (*parts, wq, wk)))
    dqkv = np.concatenate([np.asarray(g) for g in grads[:3]], axis=-1)
    return ((qkv, wq, wk, sin, cos, w_out), dqkv, np.asarray(grads[3]),
            np.asarray(grads[4]))


def _staged(inputs, h, hkv):
    qkv, wq, wk, sin, cos, dout = (t(a) for a in inputs)
    out, lse = fa.fused_attention_forward_reference(qkv, wq, wk, sin, cos,
                                                    h, hkv)
    args = (qkv, wq, wk, sin, cos, out, lse, dout, h, hkv)
    return (fa.fused_attention_backward_split_staged_reference(*args),
            fa.fused_attention_bwd_split(*args))


@pytest.mark.parametrize("geom", GEOMS, ids=["mha_c64", "gqa_c128"])
def test_split_staged_route_matches_jax_split_kernels(pallas_interpret, geom):
    """The bf16 split route's stages (pre-pass once, the dq walk per q tile,
    dK^ / dV per k tile pair), in f32 on the CPU, against JAX's split
    kernels in interpret mode within 5e-4 (the JAX package's tolerance)."""
    b, tt, h, hkv, c = geom
    inputs, dqkv, dwq, dwk = _jax_split_grads(geom, seed=4)
    staged, _ = _staged(inputs, h, hkv)
    for name, s_, j in zip(["dqkv", "dwq", "dwk"], staged, [dqkv, dwq, dwk]):
        np.testing.assert_allclose(s_.numpy(), j, rtol=5e-4, atol=5e-4,
                                   err_msg=name)


@pytest.mark.parametrize("geom", GEOMS + [(1, 128, 2, 1, 128),
                                  (1, 192, 2, 2, 64), (1, 320, 4, 2, 128),
                                  (2, 256, 2, 2, 64), (1, 448, 4, 1, 128),
                                  (2, 320, 2, 2, 64)],
                         ids=["mha_c64", "gqa_c128", "mqa_c128", "mha_t192",
                              "gqa_t320", "mha_b2", "mqa_t448",
                              "mha_b2_t320"])
def test_split_staged_route_equals_split_plain(geom):
    """The staged split route and the plain split backward: the same f32
    math, summed tile by tile, within 1e-5; T % 128 == 64 leaves a dq
    block of one q tile and a dk/dv block of the middle k tile alone."""
    b, tt, h, hkv, c = geom
    staged, plain = _staged(_inputs(b, tt, h, hkv, c, seed=5), h, hkv)
    for name, s_, p in zip(["dqkv", "dwq", "dwk"], staged, plain):
        np.testing.assert_allclose(s_.numpy(), p.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_split_schedule_covers_every_tile_once():
    """dq blocks: every q tile once, one a block, heavy (late) ones first;
    dk/dv blocks: every k tile once, each pair (j, nk - 1 - j) the same
    causal work (nk + 1 q tiles), the middle tile alone where nk is odd."""
    for nk in range(1, 41):
        dq, dkv = fa.split_schedule(nk * fa.TILE)
        assert dq == [[i] for i in reversed(range(nk))]
        assert sorted(j for blk in dkv for j in blk) == list(range(nk))
        assert len(dkv) == (nk + 1) // 2
        work = [sum(nk - j for j in blk) for blk in dkv]
        full = [w for blk, w in zip(dkv, work) if len(blk) == 2]
        assert full == [nk + 1] * len(full)
        assert len(full) == nk // 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_wrappers_same_with_and_without_hats(dtype):
    """The dq and dk/dv wrappers give the same bits whether the pre-pass's
    q^ and k^ are given or recomputed (CPU: their plain versions)."""
    b, tt, h, hkv, c = 1, 192, 4, 2, 64
    qkv, wq, wk, sin, cos, dout = (t(a) for a in _inputs(b, tt, h, hkv, c,
                                                         seed=6))
    qkv, dout = qkv.to(dtype), dout.to(dtype)
    out, lse = fa.fused_attention_forward_reference(qkv, wq, wk, sin, cos,
                                                    h, hkv)
    qhat, khat, delta = fa.fused_attention_bwd_prep(
        qkv, wq, wk, sin, cos, h, hkv, out=out, dout=dout)
    assert qhat.dtype == dtype and qhat.shape == (b, h, tt, c)
    assert khat.shape == (b, hkv, tt, c)
    assert torch.equal(delta, fa.attention_delta(out, dout, h))
    args = (qkv, wq, wk, sin, cos, lse, delta, dout, h, hkv)
    for fn in (fa.fused_attention_bwd_dq, fa.fused_attention_bwd_dkv):
        bare, given = fn(*args), fn(*args, qhat=qhat, khat=khat)
        for x, y in zip(bare, given):
            assert torch.equal(x, y), fn.__name__


@pytest.mark.parametrize("geom", GEOMS, ids=["mha_c64", "gqa_c128"])
def test_forward_staged_route_matches_jax_forward_kernel(pallas_interpret,
                                                         geom):
    """The bf16 forward route's stages (the pre-pass's q^ and k^, then the
    forward core's 128-row blocks walking k tiles in base 2), in f32 on the
    CPU: out and lse against JAX's ``_fused_forward`` (its ``_fwd_kernel``
    in interpret mode) within 5e-4, the JAX package's tolerance for its
    kernels, and against the plain forward within the same 5e-4 (the same
    f32 math, exponent in base 2 and sums split at tile boundaries; torch's
    f32 ``exp`` on the CPU is not correctly rounded and has been seen to
    return values 5e-5 apart, relative, for the same input on two calls)."""
    from midgpt_tpu.ops.fused_attn import _fused_forward, _packed_geometry

    b, tt, h, hkv, c = geom
    qkv, wq, wk, sin, cos, _ = _inputs(b, tt, h, hkv, c, seed=8)
    jq = jnp.asarray(qkv)
    c_, koff, voff = _packed_geometry(jq, h, hkv)
    jout, jlse = _fused_forward(
        jq, jq, jq, jnp.asarray(wq), jnp.asarray(wk), jnp.asarray(sin),
        jnp.asarray(cos), n_head=h, n_kv_head=hkv, causal=True, bq=None,
        bk=None, head_dim=c_, koff=koff, voff=voff, eps=1e-6)
    args = [t(a) for a in (qkv, wq, wk, sin, cos)]
    staged = fa.fused_attention_forward_staged_reference(*args, h, hkv)
    plain = fa.fused_attention_forward_reference(*args, h, hkv)
    for name, s_, j, p in zip(("out", "lse"), staged,
                              (jout, np.asarray(jlse).reshape(b, h, tt)),
                              plain):
        np.testing.assert_allclose(s_.numpy(), np.asarray(j), rtol=5e-4,
                                   atol=5e-4, err_msg=name)
        np.testing.assert_allclose(s_.numpy(), p.numpy(), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("geom", [(1, 192, 2, 2, 64), (1, 320, 4, 2, 128),
                                  (1, 128, 2, 1, 128), (2, 64, 2, 2, 64)],
                         ids=["mha_t192", "gqa_t320", "mqa_c128", "mha_t64"])
def test_forward_staged_route_equals_plain(geom):
    """The staged forward route and the plain forward within 5e-4 (as
    above) where a 128-row block's second q tile lies past T (T % 128 ==
    64) and at one k tile."""
    b, tt, h, hkv, c = geom
    args = [t(a) for a in _inputs(b, tt, h, hkv, c, seed=9)[:5]]
    staged = fa.fused_attention_forward_staged_reference(*args, h, hkv)
    plain = fa.fused_attention_forward_reference(*args, h, hkv)
    for name, s_, p in zip(("out", "lse"), staged, plain):
        np.testing.assert_allclose(s_.numpy(), p.numpy(), rtol=5e-4,
                                   atol=5e-4, err_msg=name)
