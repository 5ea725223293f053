"""The port's ring attention (``midgpt_tpu_torch.parallel.ring``) against
the JAX package's, on the CPU (f32).

- ``ring_attention`` over the loopback exchange at S = 2 and 4, standard
  and zigzag, MHA and GQA: outputs and (dq, dk, dv) of ``sum(out * dO)``
  against JAX's ``ring_attention`` on a host mesh of S devices
  (``sequence=S``) and against JAX's naive full attention (atol 2e-5 on
  outputs, 1e-4 on gradients: JAX's own tolerances in
  ``tests/test_ring.py``); the ring's own plain version (``plain=True``)
  the same; the plain chunk-pair oracle ``_chunk_attention`` against
  JAX's in every mode, with dropout at global anchors;
- ring dropout (the standard schedule) against JAX's ring dropout and
  against the port's single-call flash dropout at the same seed;
- the zigzag relayout against ``_zigzag_order`` (the port's equals
  JAX's), and its inverse;
- ragged T, odd zigzag chunking and dropout under zigzag rejected;
- the loopback exchange equals the process-group one (gloo worlds of S
  ranks, ``torch_dist_util``): outputs bit for bit, gradients within
  1e-6 (a chunk's dK/dV accumulator sums its pairs in another order on
  the loopback), and each rank counts its P2P transfers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.config import MeshConfig as JaxMeshConfig
from midgpt_tpu.ops.attention import naive_attention as jax_naive
from midgpt_tpu.parallel.mesh import create_mesh as jax_create_mesh
from midgpt_tpu_torch.ops.flash import flash_attention_dropout
from midgpt_tpu_torch.parallel import (
    LoopbackExchange,
    ring_attention,
    sequence_chunks,
)
from midgpt_tpu_torch.parallel.ring import (
    _zigzag_order,
    _zigzag_relayout_in,
    _zigzag_relayout_out,
)

from torch_dist_util import run_world

torch.set_num_threads(2)

GEOMS = {"mha": (2, 4, 4, 64, 16), "gqa": (1, 4, 2, 64, 16)}


def _inputs(geom, seed=0):
    """q, k, v, dO ``[B, H|Hkv, T, C]`` f32 NumPy arrays."""
    b, h, hkv, t, c = GEOMS[geom] if isinstance(geom, str) else geom
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, t, c), (b, hkv, t, c), (b, hkv, t, c),
                      (b, h, t, c))]


def _jax_mesh(s):
    return jax_create_mesh(JaxMeshConfig(fsdp=1, sequence=s),
                           devices=jax.devices()[:s])


def _jax_grads(fn, arrs):
    """``(out, dq, dk, dv)`` of ``sum(fn(q, k, v) * dO)`` in JAX."""
    q, k, v, do = (jnp.asarray(a) for a in arrs)
    out = fn(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * do),
                     argnums=(0, 1, 2))(q, k, v)
    return [np.asarray(x) for x in (out, *grads)]


def _port_loopback(arrs, s, **kw):
    """``(out, dq, dk, dv)`` of the port's ring over a loopback exchange."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrs[:3])
    chunks = [sequence_chunks(x, s) for x in (q, k, v)]
    out = torch.cat(ring_attention(*chunks, LoopbackExchange(s), **kw), 2)
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrs[3]))
    return [x.detach().numpy() for x in (out, *grads)]


def _close(got, want, what):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-5 if name == "out" else 1e-4,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("geom", ["mha", "gqa"])
@pytest.mark.parametrize("schedule", ["standard", "zigzag"])
@pytest.mark.parametrize("s", [2, 4])
def test_ring_matches_jax_ring_and_full_attention(s, schedule, geom):
    from midgpt_tpu.parallel.ring import ring_attention as jax_ring

    arrs = _inputs(geom, seed=s)
    mesh = _jax_mesh(s)
    ref_ring = _jax_grads(jax.jit(
        lambda q, k, v: jax_ring(q, k, v, mesh, schedule=schedule)), arrs)
    ref_full = _jax_grads(lambda q, k, v: jax_naive(q, k, v, causal=True),
                          arrs)
    got = _port_loopback(arrs, s, schedule=schedule)
    _close(got, ref_ring, f"vs JAX ring S={s} {schedule} {geom}")
    _close(got, ref_full, f"vs JAX full S={s} {schedule} {geom}")
    plain = _port_loopback(arrs, s, schedule=schedule, plain=True)
    _close(plain, ref_ring, f"plain ring vs JAX ring S={s} {schedule}")


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_chunk_oracle_matches_jax(mode, rate):
    from midgpt_tpu.parallel.ring import _chunk_attention as jax_chunk
    from midgpt_tpu_torch.ops.flash import Dropout
    from midgpt_tpu_torch.parallel.ring import _chunk_attention

    q, k, v, _ = _inputs("gqa", seed=mode)
    anchors = dict(row_off=32, col_off=0, bh_off=12, n_head_total=8)
    jkw = {} if not rate else dict(keep=1.0 - rate, seed=jnp.int32(-5),
                                   **anchors)
    ref = jax_chunk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(mode, jnp.int32), **jkw)
    drop = Dropout(rate, -5, **anchors) if rate else None
    got = _chunk_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), mode, drop)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("geom", ["mha", "gqa"])
@pytest.mark.parametrize("s", [2, 4])
def test_ring_dropout_matches_jax_and_one_flash_call(s, geom):
    from midgpt_tpu.parallel.ring import ring_attention as jax_ring

    arrs = _inputs(geom, seed=10 + s)
    rate, seed = 0.25, -987
    mesh = _jax_mesh(s)
    ref = _jax_grads(jax.jit(lambda q, k, v: jax_ring(
        q, k, v, mesh, use_flash=False, dropout_rate=rate,
        dropout_seed=jnp.int32(seed))), arrs)
    got = _port_loopback(arrs, s, dropout_rate=rate, dropout_seed=seed)
    _close(got, ref, f"vs JAX ring dropout S={s} {geom}")
    # the single-call mask: one flash dropout call over the whole T
    q, k, v, do = (torch.from_numpy(a).requires_grad_() for a in arrs)
    one = flash_attention_dropout(q, k, v, seed, rate)
    grads = torch.autograd.grad(one, (q, k, v), do)
    _close(got, [x.detach().numpy() for x in (one, *grads)],
           f"vs one flash call S={s} {geom}")
    # and the mask is seed's: another seed moves the output
    other = _port_loopback(arrs, s, dropout_rate=rate, dropout_seed=seed + 1)
    assert np.abs(other[0] - got[0]).max() > 1e-2


@pytest.mark.parametrize("s", [2, 3, 4])
def test_zigzag_relayout_matches_the_index_oracle(s):
    from midgpt_tpu.parallel.ring import _zigzag_order as jax_order

    t = 8 * s
    x = torch.randn(2, 2, t, 4, generator=torch.Generator().manual_seed(s))
    idx, inv = _zigzag_order(t, s)
    ref_idx, ref_inv = jax_order(t, s)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(inv, ref_inv)
    ex = LoopbackExchange(s)
    relaid = _zigzag_relayout_in(sequence_chunks(x, s), ex)
    np.testing.assert_array_equal(torch.cat(relaid, 2).numpy(),
                                  x[:, :, idx].numpy())
    back = _zigzag_relayout_out(relaid, ex)
    np.testing.assert_array_equal(torch.cat(back, 2).numpy(), x.numpy())


def test_ring_rejects_bad_shapes():
    x = torch.randn(1, 2, 31, 16)
    with pytest.raises(ValueError, match="not divisible by sequence"):
        sequence_chunks(x, 2)  # ragged T
    q = torch.randn(1, 2, 34, 16)
    chunks = sequence_chunks(q, 2)  # 17 rows a chunk: odd
    ex = LoopbackExchange(2)
    with pytest.raises(ValueError, match="zigzag needs T=34"):
        ring_attention(chunks, chunks, chunks, ex, schedule="zigzag")
    q = torch.randn(1, 2, 32, 16)
    chunks = sequence_chunks(q, 2)
    with pytest.raises(ValueError, match="schedule='standard'"):
        ring_attention(chunks, chunks, chunks, ex, schedule="zigzag",
                       dropout_rate=0.1, dropout_seed=1)
    with pytest.raises(ValueError, match="dropout_seed"):
        ring_attention(chunks, chunks, chunks, ex, dropout_rate=0.1)
    with pytest.raises(ValueError, match="unknown ring schedule"):
        ring_attention(chunks, chunks, chunks, ex, schedule="spiral")
    with pytest.raises(ValueError, match="held sequence indices"):
        ring_attention(chunks[:1], chunks[:1], chunks[:1], ex)


@pytest.mark.parametrize("s,kw", [
    (2, dict(schedule="standard")), (2, dict(schedule="zigzag")),
    (4, dict(schedule="standard")), (4, dict(schedule="zigzag")),
    (2, dict(schedule="standard", dropout_rate=0.2, dropout_seed=31)),
], ids=["s2_standard", "s2_zigzag", "s4_standard", "s4_zigzag",
        "s2_dropout"])
def test_loopback_equals_process_group_exchange(tmp_path, s, kw):
    arrs = _inputs((2, 4, 2, 64, 16), seed=20 + s)
    want = _port_loopback(arrs, s, **kw)
    out = run_world(str(tmp_path), s, "seq_attention",
                    dict(q=arrs[0], k=arrs[1], v=arrs[2], dout=arrs[3],
                         mesh=dict(fsdp=1, sequence=s), impl="ring", kw=kw),
                    timeout=120)
    got = [np.concatenate([r[n] for r in out], 2)
           for n in ("out", "dq", "dk", "dv")]
    np.testing.assert_array_equal(got[0], want[0])
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
    for i, r in enumerate(out):  # P2P only
        assert r["collectives"]["send_recv"] == _hops(s, kw["schedule"], i)
        assert r["collectives"]["all_to_all"] == 0


def _hops(s: int, schedule: str, i: int) -> int:
    """Rank ``i``'s transfers: the ring's S - 1 K/V hops forward and S
    moves of its dK/dV accumulator back, and under zigzag, forward and
    back, each relayout permutation (two in, two out) that does not map
    ``i`` to itself."""
    n = 0
    if schedule == "zigzag":
        def owner(g):
            return g if g < s else 2 * s - 1 - g

        g_even = i if i % 2 == 0 else 2 * s - 1 - i
        g_odd = i if i % 2 == 1 else 2 * s - 1 - i
        dests = (owner(2 * i), owner(2 * i + 1), g_even // 2,
                 (g_odd - 1) // 2)
        n += sum(d != i for d in dests)
    return 2 * s - 1 + 2 * n
