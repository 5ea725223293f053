"""The port's primitive layers against the JAX package's, on one input.

Tolerances: float32 within 1e-6, absolute plus relative (the two
frameworks reduce in different orders). bfloat16 within one bf16 ulp.
Where JAX's bf16 graph rounds after each op (the QK LayerNorm's mean
subtraction; ``jax.nn.gelu``, whose constants it also rounds to bf16)
the port computes in f32 and rounds once, so those two are held to the
JAX function evaluated in f32 and rounded once to bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu.config import ModelConfig as JaxModelConfig
from midgpt_tpu.models import layers as jl
from midgpt_tpu.models.gpt import MLP as JaxMLP
from midgpt_tpu.models.gpt import mlp_hidden_dim as jax_mlp_hidden_dim
from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.models import layers as tl
from midgpt_tpu_torch.models.gpt import MLP, mlp_hidden_dim

from torch_port_util import bf16_ulp, t

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _close(ref, got, kind):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.to(torch.float32).numpy()
    assert ref.shape == got.shape
    if kind == "f32":
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    else:
        assert np.all(np.abs(got - ref) <= bf16_ulp(ref)), np.max(
            np.abs(got - ref) / bf16_ulp(ref)
        )


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rmsnorm_matches_jax(kind, eps):
    jd, td = DTYPES[kind]
    x = _x((3, 5, 64))
    ref = jl.RMSNorm.init(64, eps=eps)(jnp.asarray(x, jd))
    got = tl.RMSNorm(64, eps=eps)(t(x, td))
    _close(ref, got, kind)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_layernorm_matches_jax(kind):
    jd, td = DTYPES[kind]
    x = 3.0 + _x((4, 6, 16))
    w = 1.0 + 0.3 * _x((16,), seed=1)
    ref = jl.LayerNorm(weight=jnp.asarray(w), eps=1e-6)(
        jnp.asarray(jnp.asarray(x, jd), jnp.float32)
    ).astype(jd)
    ln = tl.LayerNorm(16, eps=1e-6)
    ln.weight.data.copy_(t(w))
    _close(ref, ln(t(x, td)), kind)


def test_rope_tables_identical():
    js, jc = jl.rope_tables(32, 50, 10000.0)
    ts, tc = tl.rope_tables(32, 50, 10000.0)
    np.testing.assert_array_equal(js, ts)
    np.testing.assert_array_equal(jc, tc)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_apply_rotary_matches_jax(kind):
    jd, td = DTYPES[kind]
    x = _x((2, 3, 7, 16))
    sin, cos = jl.rope_tables(16, 7)
    ref = jl.apply_rotary(jnp.asarray(x, jd), sin, cos)
    got = tl.apply_rotary(
        t(x, td), torch.from_numpy(sin).float(), torch.from_numpy(cos).float()
    )
    _close(ref, got, kind)


def test_rotate_every_two():
    x = torch.arange(6.0)
    assert tl.rotate_every_two(x).tolist() == [-1.0, 0.0, -3.0, 2.0, -5.0, 4.0]


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_gelu_is_the_tanh_approximation(kind):
    """jax.nn.gelu defaults to the tanh approximation; the erf form
    differs by up to ~1e-3 and would fail this. Inputs stay in [-3, 3]:
    below that, ``1 + tanh`` cancels in f32 itself."""
    import jax

    jd, td = DTYPES[kind]
    x = np.clip(1.5 * _x((4, 256)), -3.0, 3.0)
    ref = jax.nn.gelu(jnp.asarray(jnp.asarray(x, jd), jnp.float32)).astype(jd)
    _close(ref, torch.nn.functional.gelu(t(x, td), approximate="tanh"), kind)


@pytest.mark.parametrize("mlp", ["gelu", "swiglu"])
def test_mlp_matches_jax(mlp):
    kw = dict(block_size=8, vocab_size=8, n_layer=1, n_head=2, n_embd=32,
              mlp=mlp)
    f = mlp_hidden_dim(ModelConfig(**kw))
    assert f == jax_mlp_hidden_dim(JaxModelConfig(**kw))
    w_up, w_down = 0.2 * _x((32, f), 1), 0.1 * _x((f, 32), 2)
    w_gate = 0.2 * _x((32, f), 3) if mlp == "swiglu" else None
    x = _x((2, 3, 32))

    def jlin(w):
        return None if w is None else jl.Linear(weight=jnp.asarray(w))

    def tlin(w):
        return None if w is None else tl.Linear(t(w))

    ref = JaxMLP(w_up=jlin(w_up), w_down=jlin(w_down), w_gate=jlin(w_gate))(
        jnp.asarray(x)
    )
    got = MLP(tlin(w_up), tlin(w_down), tlin(w_gate))(t(x))
    _close(ref, got, "f32")


def test_mlp_hidden_rounds_fractional_widths():
    cfg = ModelConfig(block_size=8, vocab_size=8, n_layer=1, n_head=32,
                      n_embd=4096, mlp="swiglu", mlp_ratio=8 / 3)
    assert mlp_hidden_dim(cfg) == 11008
