"""The port's Ulysses attention (``midgpt_tpu_torch.parallel.ulysses``)
against the JAX package's, on the CPU (f32).

- ``ulysses_attention`` over the loopback exchange at S = 2 and 4, MHA
  and GQA: outputs and (dq, dk, dv) of ``sum(out * dO)`` against JAX's
  ``ulysses_attention`` on a host mesh of S devices (``sequence=S``) and
  JAX's naive full attention (atol 2e-5 on outputs, 1e-4 on gradients);
- dropout against JAX's Ulysses dropout and the port's single-call flash
  dropout at the same seed, with a batch offset (a data shard's rows);
- H or Hkv not divisible by S rejected (ValueError naming ring);
- the loopback exchange equals the process-group one (gloo worlds): one
  all-to-all of q, k and v and one of the output, forward and back;
- configs trained with ``attn_impl="ring"`` and ``"ulysses"`` sample
  (``sampling.generate`` takes them as ``"auto"``, as JAX's prefill
  does) and stream JAX's greedy tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.config import MeshConfig as JaxMeshConfig
from midgpt_tpu.ops.attention import naive_attention as jax_naive
from midgpt_tpu.parallel.mesh import create_mesh as jax_create_mesh
from midgpt_tpu_torch.models.gpt import full_forward_impl
from midgpt_tpu_torch.ops.flash import flash_attention_dropout
from midgpt_tpu_torch.parallel import (
    LoopbackExchange,
    sequence_chunks,
    ulysses_attention,
)

from torch_dist_util import run_world
from torch_port_util import model_pair

torch.set_num_threads(2)

GEOMS = {"mha": (2, 4, 4, 64, 16), "gqa": (1, 8, 4, 64, 16)}


def _inputs(geom, seed=0):
    b, h, hkv, t, c = GEOMS[geom]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, t, c), (b, hkv, t, c), (b, hkv, t, c),
                      (b, h, t, c))]


def _jax_grads(fn, arrs):
    q, k, v, do = (jnp.asarray(a) for a in arrs)
    out = fn(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * do),
                     argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


def _port(arrs, s, **kw):
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    chunks = [sequence_chunks(x, s) for x in (q, k, v)]
    out = torch.cat(ulysses_attention(*chunks, LoopbackExchange(s), **kw), 2)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrs[3]))
    return [x.detach().numpy() for x in (out, *grads)]


def _close(got, want, what):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-5 if name == "out" else 1e-4,
                                   err_msg=f"{what} {name}")


def _jax_mesh(s):
    return jax_create_mesh(JaxMeshConfig(fsdp=1, sequence=s),
                           devices=jax.devices()[:s])


@pytest.mark.parametrize("geom", ["mha", "gqa"])
@pytest.mark.parametrize("s", [2, 4])
def test_ulysses_matches_jax_ulysses_and_full_attention(s, geom):
    from midgpt_tpu.parallel.ulysses import ulysses_attention as jax_uly

    arrs = _inputs(geom, seed=s)
    mesh = _jax_mesh(s)
    ref = _jax_grads(jax.jit(lambda q, k, v: jax_uly(q, k, v, mesh)), arrs)
    full = _jax_grads(lambda q, k, v: jax_naive(q, k, v, causal=True), arrs)
    got = _port(arrs, s)
    _close(got, ref, f"vs JAX ulysses S={s} {geom}")
    _close(got, full, f"vs JAX full S={s} {geom}")


@pytest.mark.parametrize("geom", ["mha", "gqa"])
def test_ulysses_dropout_matches_jax_and_one_flash_call(geom):
    from midgpt_tpu.parallel.ulysses import ulysses_attention as jax_uly

    arrs = _inputs(geom, seed=7)
    rate, seed, s = 0.3, 4242, 2
    mesh = _jax_mesh(s)
    ref = _jax_grads(jax.jit(lambda q, k, v: jax_uly(
        q, k, v, mesh, use_flash=False, dropout_rate=rate,
        dropout_seed=jnp.int32(seed))), arrs)
    got = _port(arrs, s, dropout_rate=rate, dropout_seed=seed)
    _close(got, ref, f"vs JAX ulysses dropout {geom}")
    q, k, v, do = (torch.from_numpy(a).requires_grad_() for a in arrs)
    one = flash_attention_dropout(q, k, v, seed, rate)
    _close(got, [x.detach().numpy() for x in
                 (one, *torch.autograd.grad(one, (q, k, v), do))],
           f"vs one flash call {geom}")
    # rows of a larger batch: batch row b draws global row 3 + b's masks
    b, h = arrs[0].shape[:2]
    off = _port(arrs, s, dropout_rate=rate, dropout_seed=seed, b_off=3)
    one = flash_attention_dropout(q, k, v, seed, rate, bh_off=3 * h)
    np.testing.assert_allclose(off[0], one.detach().numpy(), atol=2e-5)
    assert np.abs(off[0] - got[0]).max() > 1e-2


def test_ulysses_rejects_bad_shapes():
    ex = LoopbackExchange(2)
    q = sequence_chunks(torch.randn(1, 3, 32, 16), 2)
    kv = sequence_chunks(torch.randn(1, 3, 32, 16), 2)
    with pytest.raises(ValueError, match="attn_impl='ring'"):
        ulysses_attention(q, kv, kv, ex)  # H = 3
    q = sequence_chunks(torch.randn(1, 4, 32, 16), 2)
    kv = sequence_chunks(torch.randn(1, 1, 32, 16), 2)
    with pytest.raises(ValueError, match="Hkv=1"):
        ulysses_attention(q, kv, kv, ex)  # Hkv = 1
    with pytest.raises(ValueError, match="not divisible by sequence"):
        sequence_chunks(torch.randn(1, 4, 31, 16), 2)
    with pytest.raises(ValueError, match="dropout_seed"):
        q = sequence_chunks(torch.randn(1, 4, 32, 16), 2)
        ulysses_attention(q, q, q, ex, dropout_rate=0.1)


@pytest.mark.parametrize("s,kw", [(2, {}), (4, {}),
                                  (2, dict(dropout_rate=0.2,
                                           dropout_seed=9))],
                         ids=["s2", "s4", "s2_dropout"])
def test_loopback_equals_process_group_exchange(tmp_path, s, kw):
    arrs = _inputs("gqa", seed=30 + s)
    want = _port(arrs, s, **kw)
    out = run_world(str(tmp_path), s, "seq_attention",
                    dict(q=arrs[0], k=arrs[1], v=arrs[2], dout=arrs[3],
                         mesh=dict(fsdp=1, sequence=s), impl="ulysses",
                         kw=kw), timeout=120)
    got = [np.concatenate([r[n] for r in out], 2)
           for n in ("out", "dq", "dk", "dv")]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=name)
    for r in out:  # q, k, v in one, the output in another; each back
        assert r["collectives"]["all_to_all"] == 4
        assert r["collectives"]["send_recv"] == 0


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_trained_sequence_config_samples(impl):
    """A config trained with ring or Ulysses samples on one card as
    ``"auto"``: greedy streams equal JAX's ``generate`` on the same
    weights."""
    from midgpt_tpu.sampling import generate as jax_generate
    from midgpt_tpu_torch.sampling import generate

    cfg = dict(block_size=32, vocab_size=64, n_layer=2, n_head=4, n_embd=32,
               dropout=0.0, remat="none")
    jm, tm, _ = model_pair(cfg, gain=2.0)
    tm.config = dataclasses.replace(tm.config, attn_impl=impl)
    jm = dataclasses.replace(jm, config=dataclasses.replace(
        jm.config, attn_impl=impl))
    assert full_forward_impl(tm.config) == "auto"
    prompt = np.random.default_rng(1).integers(0, 64, (2, 7))
    ref = jax_generate(jm, jnp.asarray(prompt), 9, key=jax.random.PRNGKey(2),
                       temperature=0.0, cache_dtype=jnp.float32)
    got = generate(tm, torch.from_numpy(prompt), 9, temperature=0.0,
                   cache_dtype=torch.float32, device="cpu")
    assert got.shape == (2, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
