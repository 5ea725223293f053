"""The port's fused RMSNorm against the JAX package's, on the same NumPy
inputs.

JAX runs its Pallas kernels (``midgpt_tpu.ops.fused_norm``) through the
CPU interpreter (the ``pallas_interpret`` fixture); the port runs the
kernels' plain versions (its wrappers' CPU path). Checked:

- the forward at ``[4, 96, 256]`` with and without a weight, and at
  ``[3, 37, 128]`` (JAX with ``block_rows=16``, its row-padding path),
  eps 1e-6 and 1e-5, within 1e-5 in f32 (the JAX package's own
  tolerance for its kernel against its oracle); in bf16 within one bf16
  ulp (both compute in f32 and round once, the sums in another order);
- ``dx`` and ``dw`` through ``torch.autograd`` against ``jax.grad`` on a
  random cotangent, within 1e-5 in f32 and one bf16 ulp of ``dx`` in
  bf16;
- ``RMSNorm``'s dispatch: ``impl="fused"`` takes ``ops.fused_norm`` only
  where ``D % 128 == 0``; ``"auto"`` and ``"jnp"`` never do; the fused
  plain version equals the plain chain bit for bit in f32; a ``GPT``
  with ``norm_impl="fused"`` calls it ``2 n_layer + 1`` times a forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.models.gpt import GPT
from midgpt_tpu_torch.models.layers import RMSNorm
from midgpt_tpu_torch.ops import fused_norm as fn

from torch_port_util import bf16_ulp, t

torch.set_num_threads(2)

# (shape, JAX block_rows)
SHAPES = [((4, 96, 256), 256), ((3, 37, 128), 16)]


def _inputs(shape, use_weight, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, (w if use_weight else None), dy


def _jax_run(x, w, dy, eps, block_rows, dtype):
    from midgpt_tpu.ops.fused_norm import fused_rms_norm as jax_norm

    xj = jnp.asarray(x, dtype)
    wj = None if w is None else jnp.asarray(w, dtype)

    def loss(x_, w_):
        y = jax_norm(x_, w_, eps, block_rows)
        return jnp.sum(y.astype(jnp.float32) * dy), y

    argnums = (0,) if w is None else (0, 1)
    (_, y), grads = jax.value_and_grad(loss, argnums=argnums, has_aux=True)(
        xj, wj)
    return [np.asarray(a, np.float32) for a in (y, *grads)]


def _port_run(x, w, dy, eps, dtype):
    xt = t(x, dtype).requires_grad_()
    wt = None if w is None else t(w, dtype).requires_grad_()
    y = fn.fused_rms_norm(xt, wt, eps)
    (y.float() * t(dy)).sum().backward()
    grads = [xt.grad] + ([] if wt is None else [wt.grad])
    return [a.detach().float().numpy() for a in (y, *grads)]


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("use_weight", [False, True], ids=["no_w", "w"])
@pytest.mark.parametrize("shape,block_rows", SHAPES, ids=["4x96x256",
                                                          "3x37x128"])
def test_fused_norm_matches_jax_kernels_f32(pallas_interpret, shape,
                                            block_rows, use_weight, eps):
    x, w, dy = _inputs(shape, use_weight)
    ref = _jax_run(x, w, dy, eps, block_rows, jnp.float32)
    got = _port_run(x, w, dy, eps, torch.float32)
    for name, a, b in zip(["y", "dx", "dw"], got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("shape,block_rows", SHAPES, ids=["4x96x256",
                                                          "3x37x128"])
def test_fused_norm_matches_jax_kernels_bf16(pallas_interpret, shape,
                                             block_rows):
    """bf16 x and weight: y and dx within one bf16 ulp (both packages sum
    in f32 and round once); dw, JAX's one plain reduction in f32 rounded
    to bf16, within one ulp too."""
    x, w, dy = _inputs(shape, True, seed=1)
    ref = _jax_run(x, w, dy, 1e-6, block_rows, jnp.bfloat16)
    got = _port_run(x, w, dy, 1e-6, torch.bfloat16)
    for name, a, b in zip(["y", "dx", "dw"], got, ref):
        assert (np.abs(a - b) <= bf16_ulp(b)).all(), name


def test_plain_versions_match_their_formulas():
    """rstd is saved per row in f32, and the plain backward is the
    autograd of the plain forward (within 1e-5 in f32)."""
    x, w, dy = _inputs((5, 37, 128), True, seed=2)
    x2, w2, dy2 = t(x).reshape(-1, 128), t(w), t(dy).reshape(-1, 128)
    y, rstd = fn.fused_rms_norm_forward_reference(x2, w2, 1e-5)
    assert rstd.shape == (5 * 37,) and rstd.dtype == torch.float32
    np.testing.assert_allclose(
        rstd.numpy(), 1 / np.sqrt((x.reshape(-1, 128) ** 2).mean(-1) + 1e-5),
        rtol=1e-6)
    xa = x2.clone().requires_grad_()
    yy = xa * torch.rsqrt(xa.square().mean(-1, keepdim=True) + 1e-5) * w2
    (yy * dy2).sum().backward()
    dx = fn.fused_rms_norm_backward_reference(x2, w2, rstd, dy2)
    np.testing.assert_allclose(y.numpy(), yy.detach().numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(dx.numpy(), xa.grad.numpy(), rtol=1e-5,
                               atol=1e-5)


def _spy(monkeypatch):
    calls = []
    real = fn.fused_rms_norm

    def counting(x, weight, eps=1e-6):
        calls.append(x.shape)
        return real(x, weight, eps)

    monkeypatch.setattr(fn, "fused_rms_norm", counting)
    return calls


def test_rmsnorm_dispatch(monkeypatch):
    calls = _spy(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 5, 256)).astype(np.float32))
    plain = RMSNorm(256)(x)
    assert torch.equal(RMSNorm(256, impl="fused")(x), plain)
    assert len(calls) == 1
    for impl in ("auto", "jnp"):
        assert torch.equal(RMSNorm(256, impl=impl)(x), plain)
    RMSNorm(96, impl="fused")(x[..., :96])  # D % 128 != 0: the plain chain
    assert len(calls) == 1
    with pytest.raises(ValueError, match="norm impl"):
        RMSNorm(256, impl="pallas")
    before = (fn.fused_rms_norm_fwd.launches, fn.fused_rms_norm_bwd.launches)
    xg = x.clone().requires_grad_()
    RMSNorm(256, impl="fused")(xg).sum().backward()
    # CPU tensors run the plain versions: no kernel launch is counted
    assert (fn.fused_rms_norm_fwd.launches,
            fn.fused_rms_norm_bwd.launches) == before


@pytest.mark.parametrize("norm_impl,n_calls", [("fused", 5), ("auto", 0),
                                               ("jnp", 0)])
def test_model_norm_impl(monkeypatch, norm_impl, n_calls):
    """2 layers: ln1, ln2 per block and ln_f; the same logits either way."""
    calls = _spy(monkeypatch)
    kw = dict(block_size=32, vocab_size=64, n_layer=2, n_head=2, n_embd=128,
              remat="none", attn_impl="naive")
    model = GPT.init(ModelConfig(**kw, norm_impl=norm_impl),
                     torch.Generator().manual_seed(0), device="cpu")
    ref = GPT.init(ModelConfig(**kw), torch.Generator().manual_seed(0),
                   device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 32)))
    with torch.no_grad():
        out = model(tok.long())
        assert torch.equal(out, ref(tok.long()))
    assert len(calls) == n_calls
