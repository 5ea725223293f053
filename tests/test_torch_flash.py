"""The port's flash attention and its counter-hash dropout against the JAX
package's, on the same NumPy inputs.

JAX runs its Pallas kernels through the CPU interpreter (the
``pallas_interpret`` fixture); the port runs the kernels' plain versions
(the wrappers' CPU path). Checked:

- the keep-mask equals ``dropout_mask_reference`` bit for bit, for seeds
  of both signs and the int32 edges, at rates 0.1 and 0.2; the blockwise
  form with row, column and flat-head offsets equals JAX's
  ``_dropout_keep_block`` and the matching slices of the dense mask;
- ``flash_attention``, ``flash_attention_lse`` (nonzero lse cotangent),
  ``flash_attention_dropout`` and ``flash_attention_dropout_lse`` (same
  int32 seed, with offsets) in f32: outputs within 2e-5, gradients of q,
  k and v within 5e-4 (absolute plus relative: the JAX package's own
  tolerances for its kernels), for MHA C=64, GQA H=4/Hkv=2 C=64 and
  C=128, at T=128 and 256;
- the plain backward against ``torch.autograd`` through a dense oracle
  built from the same mask, within 1e-5 (the same f32 math in another
  order), and the naive path's dropout equal to the flash path's;
- the dispatch: ``auto`` is flash for every CUDA tensor and naive for
  CPU ones; the CUDA kernels' shape check refuses what they do not take.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu_torch.ops import attention as att
from midgpt_tpu_torch.ops import flash as tf

from torch_port_util import t

torch.set_num_threads(2)

SEEDS = [0, 12345, -777, 2**31 - 1, -(2**31)]


@pytest.mark.parametrize("rate", [0.1, 0.2])
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_mask_matches_jax_bit_for_bit(seed, rate):
    from midgpt_tpu.ops.flash import dropout_mask_reference

    want = np.asarray(dropout_mask_reference(jnp.int32(seed), 2, 3, 96, rate))
    got = tf.dropout_mask_reference(seed, 2, 3, 96, rate).numpy()
    assert got.shape == want.shape == (2, 3, 96, 96)
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1.0 - rate)) < 0.01


def test_keep_threshold_is_jax_arithmetic():
    assert tf.keep_threshold(0.8) == 13421772 == int(0.8 * (1 << 24))
    assert tf.keep_threshold(0.9) == int((1.0 - 0.1) * (1 << 24))


@pytest.mark.parametrize("seed", [-777, 2**31 - 1])
def test_keep_block_with_offsets_matches_jax_and_dense_slices(seed):
    from midgpt_tpu.ops.flash import _dropout_keep_block, dropout_mask_reference

    b, h, big_t, rate = 2, 4, 256, 0.2
    dense = np.asarray(dropout_mask_reference(jnp.int32(seed), b, h, big_t,
                                              rate))
    for head, r0, c0 in ((5, 64, 128), (0, 192, 0), (7, 128, 192)):
        want = np.asarray(_dropout_keep_block(
            jnp.int32(seed), jnp.int32(head), jnp.int32(r0), jnp.int32(c0),
            64, 64, 1.0 - rate))
        got = tf.dropout_keep_block(seed, head, r0, c0, 64, 64,
                                    1.0 - rate).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, dense[head // h, head % h, r0 : r0 + 64, c0 : c0 + 64])
    # a call's payload: batch row 1, heads [2, 4) of the dense call, at
    # rows [128, 256) and columns [64, 192)
    drop = tf.Dropout(rate, seed, row_off=128, col_off=64, bh_off=h + 2,
                      n_head_total=h)
    sub = tf._mask(drop, 1, 2, 128, None).numpy()
    np.testing.assert_array_equal(sub, dense[1:2, 2:4, 128:256, 64:192])


def _qkv(b, h, hkv, tt, c, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tt, c)).astype(np.float32)
    k = rng.standard_normal((b, hkv, tt, c)).astype(np.float32)
    v = rng.standard_normal((b, hkv, tt, c)).astype(np.float32)
    w = rng.standard_normal((b, h, tt, c)).astype(np.float32)
    wl = rng.standard_normal((b, h, tt)).astype(np.float32)
    return q, k, v, w, wl


GEOMS = [(2, 4, 4, 64), (2, 4, 2, 64), (1, 2, 2, 128)]
SEED, RATE = -12345, 0.2
# flat-head anchor and stride, row and column anchors of the offset call
OFFS = dict(row_off=128, col_off=64, bh_off=3)


def _jax_call(mode, q, k, v, h):
    from midgpt_tpu.ops import flash as jf

    s = jnp.int32(SEED)
    if mode == "plain":
        return jf.flash_attention(q, k, v, True), None
    if mode == "lse":
        return jf.flash_attention_lse(q, k, v, True)
    if mode == "dropout":
        return jf.flash_attention_dropout(q, k, v, s, RATE, True), None
    return jf.flash_attention_dropout_lse(
        q, k, v, s, RATE, True, **{n: jnp.int32(x) for n, x in OFFS.items()},
        n_head_total=h + 2)


def _port_call(mode, q, k, v, h):
    if mode == "plain":
        return tf.flash_attention(q, k, v, True), None
    if mode == "lse":
        return tf.flash_attention_lse(q, k, v, True)
    if mode == "dropout":
        return tf.flash_attention_dropout(q, k, v, SEED, RATE, True), None
    return tf.flash_attention_dropout_lse(q, k, v, SEED, RATE, True, **OFFS,
                                          n_head_total=h + 2)


@pytest.mark.parametrize("tt", [128, 256])
@pytest.mark.parametrize("geom", GEOMS, ids=["mha_c64", "gqa_c64", "c128"])
def test_flash_entry_points_match_jax(pallas_interpret, geom, tt):
    """All four entry points at one geometry: out (and lse) within 2e-5,
    dq, dk, dv within 5e-4; lse carries a nonzero cotangent."""
    b, h, hkv, c = geom
    q, k, v, w, wl = _qkv(b, h, hkv, tt, c)
    for mode in ("plain", "lse", "dropout", "dropout_lse"):
        def jax_loss(q_, k_, v_):
            out, lse = _jax_call(mode, q_, k_, v_, h)
            loss = jnp.sum(out * w)
            if lse is not None:
                loss = loss + jnp.sum(lse * wl)
            return loss, (out, lse)

        (_, (ref, ref_lse)), jgrads = jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
        args = [t(a).requires_grad_() for a in (q, k, v)]
        before = (tf.flash_fwd.launches, tf.flash_bwd_dq.launches,
                  tf.flash_bwd_dkv.launches)
        out, lse = _port_call(mode, *args, h)
        loss = (out * t(w)).sum()
        if lse is not None:
            loss = loss + (lse * t(wl)).sum()
        loss.backward()
        assert (tf.flash_fwd.launches, tf.flash_bwd_dq.launches,
                tf.flash_bwd_dkv.launches) == before  # plain versions
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=2e-5, atol=2e-5, err_msg=mode)
        if lse is not None:
            np.testing.assert_allclose(lse.detach().numpy(),
                                       np.asarray(ref_lse), rtol=2e-5,
                                       atol=2e-5, err_msg=mode)
        for name, a, g in zip("qkv", args, jgrads):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(g),
                                       rtol=5e-4, atol=5e-4,
                                       err_msg=f"{mode} d{name}")


def test_non_causal_dropout_matches_jax(pallas_interpret):
    """A ring-hop-shaped call: an off-diagonal tile, fully visible, with
    the global row/column anchors of its place."""
    from midgpt_tpu.ops import flash as jf

    b, h, tt, c = 1, 2, 128, 64
    q, k, v, w, _ = _qkv(b, h, h, tt, c, seed=3)

    def jax_loss(q_, k_, v_):
        out, _ = jf.flash_attention_dropout_lse(
            q_, k_, v_, jnp.int32(SEED), RATE, causal=False,
            row_off=jnp.int32(tt), col_off=jnp.int32(0))
        return jnp.sum(out * w), out

    (_, ref), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                          has_aux=True)(q, k, v)
    args = [t(a).requires_grad_() for a in (q, k, v)]
    out, _ = tf.flash_attention_dropout_lse(*args, SEED, RATE, causal=False,
                                            row_off=tt, col_off=0)
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    for a, g in zip(args, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=5e-4,
                                   atol=5e-4)


def _dense_oracle(q, k, v, mask, rate):
    """Autograd-differentiable dense attention: -1e30 after the scale,
    undropped softmax, dropped probabilities through PV."""
    b, h, tt, c = q.shape
    hkv = k.shape[1]
    g = h // hkv
    z = (q.reshape(b, hkv, g, tt, c) @ k[:, :, None].transpose(-1, -2)) / (
        c ** 0.5)
    ii = torch.arange(tt)
    z = z.masked_fill(ii[None, :] > ii[:, None], -1e30)
    p = torch.softmax(z, -1)
    if mask is not None:
        p = torch.where(mask.reshape(p.shape), p / (1.0 - rate), 0.0)
    return (p @ v[:, :, None]).reshape(b, h, tt, c)


@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("geom", GEOMS, ids=["mha_c64", "gqa_c64", "c128"])
def test_plain_backward_equals_autograd_of_dense_oracle(geom, rate):
    b, h, hkv, c = geom
    q, k, v, w, wl = _qkv(b, h, hkv, 128, c, seed=1)
    drop = tf.Dropout(rate, SEED) if rate else None
    mask = tf._mask(drop, b, h, 128, None)
    args = [t(a).requires_grad_() for a in (q, k, v)]
    ref = _dense_oracle(*args, mask, rate)
    (ref * t(w)).sum().backward()
    out, lse = tf.flash_forward_reference(t(q), t(k), t(v), True, drop)
    np.testing.assert_allclose(out.numpy(), ref.detach().numpy(), rtol=1e-5,
                               atol=1e-5)
    dq, dk, dv = tf.flash_bwd(t(q), t(k), t(v), out, lse, t(w), None, True,
                              drop)
    for name, a, g in zip("qkv", args, (dq, dk, dv)):
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{name}")


def test_naive_dropout_drops_what_flash_drops():
    q, k, v, w, _ = _qkv(2, 4, 2, 128, 64, seed=2)
    kw = dict(dropout_rate=RATE, seed=SEED)
    naive = att.attention(t(q), t(k), t(v), impl="naive", **kw)
    flash = att.attention(t(q), t(k), t(v), impl="flash", **kw)
    np.testing.assert_allclose(naive.numpy(), flash.numpy(), rtol=1e-5,
                               atol=1e-5)
    other = att.attention(t(q), t(k), t(v), impl="flash",
                          **dict(kw, seed=SEED + 1))
    assert (other - flash).abs().max() > 0.1
    # no seed: no dropout whatever the rate, on either path
    plain = att.attention(t(q), t(k), t(v), impl="flash")
    for impl in ("flash", "naive"):
        det = att.attention(t(q), t(k), t(v), impl=impl,
                            **dict(kw, seed=None))
        np.testing.assert_allclose(det.numpy(), plain.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert torch.equal(plain, att.attention(t(q), t(k), t(v), impl="flash",
                                            **dict(kw, seed=None)))


def test_resolve_impl_is_the_jax_rule():
    """The JAX package's rule with the card for the TPU, except that a
    CUDA tensor never goes to the naive path: shapes the kernels do not
    take raise in their shape check instead."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert att.resolve_impl("auto", cuda) == "flash"
    assert att.resolve_impl("auto", cpu) == "naive"
    assert att.resolve_impl("flash", cpu) == "flash"
    assert att.resolve_impl("naive", cuda) == "naive"

    def shape(tt, c=64, h=2, hkv=1):
        q = torch.zeros(1, h, tt, c)
        kv = torch.zeros(1, hkv, tt, c)
        return tf._check_cuda(q, kv, kv)

    for tt in (64, 128, 192, 320):  # the kernels' 64-row tile
        assert shape(tt) == (1, 2, 1, tt, 64)
    assert shape(256, c=128)[4] == 128
    with pytest.raises(ValueError, match="64-row tile"):
        shape(96)
    with pytest.raises(ValueError, match="C in"):
        shape(128, c=32)
    with pytest.raises(ValueError, match="unknown"):
        att.attention(*(torch.zeros(1, 1, 8, 8) for _ in range(3)),
                      impl="ring")


@pytest.mark.parametrize("tt", [64, 128, 192, 256, 320, 1024, 2048])
def test_dkv_schedule_covers_every_tile_pair_once(tt):
    """The bf16 dk/dv kernel's blocks: causal, every (k tile, q tile >= k
    tile) pair once, one k tile pair (g, nk - 1 - g) a block with nk + 1
    tile pairs each (the middle tile alone where nk is odd); non-causal,
    every (k tile, q tile) pair once, one k tile a block."""
    nk = tt // tf.TILE
    causal = tf.dkv_schedule(tt, causal=True)
    pairs = [(j, i) for blk in causal for j, qs in blk for i in qs]
    assert sorted(pairs) == [(j, i) for j in range(nk) for i in range(j, nk)]
    assert len(causal) == (nk + 1) // 2
    assert [j for blk in causal for j, _ in blk] == [
        j for g in range((nk + 1) // 2) for j in sorted({g, nk - 1 - g})]
    work = [sum(len(qs) for _, qs in blk) for blk in causal]
    full = [w for blk, w in zip(causal, work) if len(blk) == 2]
    assert full == [nk + 1] * (nk // 2)
    dense = tf.dkv_schedule(tt, causal=False)
    assert [[j for j, _ in blk] for blk in dense] == [[j] for j in range(nk)]
    pairs = [(j, i) for blk in dense for j, qs in blk for i in qs]
    assert sorted(pairs) == [(j, i) for j in range(nk) for i in range(nk)]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("geom", GEOMS, ids=["mha_c64", "gqa_c64", "c128"])
def test_dkv_staged_route_matches_jax_flash_backward(pallas_interpret, geom,
                                                     causal):
    """The bf16 dk/dv kernel's stages (:func:`dkv_schedule`, S^T and dP^T
    per tile pair, the dropout mask on P^T and dP^T), in f32 on the CPU,
    with dropout at global offsets: against JAX's ``_flash_backward``
    (its ``_bwd_dkv_kernel`` in interpret mode, then the GQA sum) within
    5e-4, the JAX package's tolerance for its kernels, and against the
    plain dk/dv within the same 5e-4: the same f32 sums split at tile
    boundaries, but torch's f32 ``exp`` on the CPU is not correctly
    rounded and has been seen to return values 5e-5 apart (relative) for
    the same input on two calls, which ds and dk magnify."""
    from midgpt_tpu.ops import flash as jf

    b, h, hkv, c = geom
    tt = 192 if causal else 128  # a causal T % 128 == 64: a lone tile
    q, k, v, w, _ = _qkv(b, h, hkv, tt, c, seed=7)
    offs = dict(row_off=128, col_off=64, bh_off=3)
    kw = dict(causal=causal, bq=None, bk=None, keep=1.0 - RATE,
              seed=jnp.int32(SEED), n_head_total=h + 2,
              **{n: jnp.int32(x) for n, x in offs.items()})
    jout, jlse = jf._flash_forward(q, k, v, **kw)
    _, jdk, jdv = jf._flash_backward(q, k, v, jout, jlse, jnp.asarray(w),
                                     **kw)
    out, lse = t(np.asarray(jout)), t(np.asarray(jlse)).reshape(b, h, tt)
    delta = (t(w) * out).sum(-1)
    drop = tf.Dropout(RATE, SEED, n_head_total=h + 2, **offs)
    args = (t(q), t(k), t(v), t(w), lse, delta, causal, drop)
    staged = tf.flash_backward_dkv_staged_reference(*args)
    plain = tf.flash_backward_dkv_reference(*args)
    for name, s_, j, p in zip(("dk", "dv"), staged, (jdk, jdv), plain):
        summed = tf._grouped(s_, hkv).sum(2)
        np.testing.assert_allclose(summed.numpy(), np.asarray(j), rtol=5e-4,
                                   atol=5e-4, err_msg=name)
        np.testing.assert_allclose(s_.numpy(), p.numpy(), rtol=5e-4,
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("rate", [0.0, 0.2], ids=["no_dropout", "dropout"])
def test_dq_delta_route_matches_jax_flash_backward(pallas_interpret, rate,
                                                   causal):
    """The CPU path of the dq kernel's delta-forming entry
    (``flash_bwd_dq_delta``: delta = rowsum(dO * O) - dlse, then the plain
    dq) with a nonzero lse cotangent, against JAX's ``_flash_backward``
    (its ``_bwd_dq_kernel`` in interpret mode, delta folded in by XLA)
    within 5e-4, the JAX package's tolerance for its kernels; delta
    itself against a float64 NumPy sum within 1e-5. Nothing launches."""
    from midgpt_tpu.ops import flash as jf

    b, h, hkv, c = 2, 4, 2, 64
    tt = 192 if causal else 128
    q, k, v, w, wl = _qkv(b, h, hkv, tt, c, seed=9)
    offs = dict(row_off=64, col_off=0, bh_off=1)
    kw = dict(causal=causal, bq=None, bk=None)
    drop = None
    if rate:
        kw.update(keep=1.0 - rate, seed=jnp.int32(SEED), n_head_total=h + 1,
                  **{n: jnp.int32(x) for n, x in offs.items()})
        drop = tf.Dropout(rate, SEED, n_head_total=h + 1, **offs)
    jout, jlse = jf._flash_forward(q, k, v, **kw)
    jdq, _, _ = jf._flash_backward(q, k, v, jout, jlse, jnp.asarray(w),
                                   dlse=jnp.asarray(wl)[..., None], **kw)
    out, lse = t(np.asarray(jout)), t(np.asarray(jlse)).reshape(b, h, tt)
    before = tf.flash_bwd_dq.launches
    dq, delta = tf.flash_bwd_dq_delta(t(q), t(k), t(v), t(w), lse, out,
                                      t(wl), causal, drop)
    assert tf.flash_bwd_dq.launches == before
    want = (w.astype(np.float64) * np.asarray(jout, np.float64)).sum(-1) - wl
    np.testing.assert_allclose(delta.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dq.numpy(), np.asarray(jdq), rtol=5e-4,
                               atol=5e-4)
    # the whole backward takes the same route
    dq2, _, _ = tf.flash_bwd(t(q), t(k), t(v), out, lse, t(w), t(wl),
                             causal, drop)
    assert torch.equal(dq, dq2)
