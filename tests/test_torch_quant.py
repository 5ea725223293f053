"""The port's int8 quantization helpers against the JAX package's, bit for
bit (``midgpt_tpu_torch.quant`` vs ``midgpt_tpu.quant``).

- the po2 machinery (``_pow2_f32``, ``po2_ceil_exact``) on every exponent,
  exact powers of two, the ``2**-126`` boundary and subnormals;
- ``quantize_per_channel`` in all three modes, on random data and on
  zero, constant, power-of-two and subnormal channels;
- the KV grid (``kv_scale_from_absmax``, ``quantize_kv_rows``,
  ``round_kv_rows_to_grid``) on random rows and edge cases;
- ``quantize_model``'s codes and scales, a quantized JAX params dict
  converted by ``convert.gpt_from_jax_params``, ``dequantize_model``, and
  the quantized model's logits (MHA and GQA at the shared small sizes);
- ``QuantLinear`` is bitwise ``x @ dequantize(w)`` in f32.

Inputs are NumPy arrays from a seed, handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from midgpt_tpu import quant as jq
from midgpt_tpu.pytree import tree_paths
from midgpt_tpu_torch import quant as tq
from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.convert import gpt_from_jax_params
from midgpt_tpu_torch.models.layers import Linear

from torch_port_util import GQA, MHA, model_pair, t

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _same_bits(got: torch.Tensor, ref) -> None:
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref))


def _positive_edge_values() -> np.ndarray:
    """Exact powers of two over the whole f32 range (subnormals too), one
    ulp either side of each, the ``2**-126`` boundary, the smallest
    subnormals, and log-uniform randoms."""
    e = np.arange(-149, 128)
    po2 = np.ldexp(np.float32(1.0), e).astype(np.float32)
    up = np.nextafter(po2, np.float32(np.inf))
    down = np.nextafter(po2, np.float32(0.0))
    sub = np.array([1, 2, 3, 5, 0x7FFFFF, 0x400001], np.int32).view(np.float32)
    rng = np.random.default_rng(0)
    rand = np.exp(rng.uniform(-100.0, 85.0, 4000)).astype(np.float32)
    vals = np.concatenate([po2, up, down, sub, rand,
                           np.float32([2.0**-126, 2.0**-127, 1.0 / 63.0])])
    vals = vals[(vals > 0) & np.isfinite(vals)]
    return vals.astype(np.float32)


def test_pow2_matches_jax_on_every_exponent():
    e = np.arange(-170, 140, dtype=np.int32)
    _same_bits(tq._pow2_f32(t(e)), jq._pow2_f32(jnp.asarray(e)))


def test_po2_ceil_exact_matches_jax_bitwise():
    y = _positive_edge_values()
    got = tq.po2_ceil_exact(t(y))
    _same_bits(got, jq.po2_ceil_exact(jnp.asarray(y)))
    # and is what it says: a power of two, >= y, < 2y (above 2^127 the
    # answer, 2^128, is f32 inf)
    g = got.numpy().astype(np.float64)
    fin = y <= 2.0**127
    assert np.isinf(g[~fin]).all()
    g, y = g[fin], y[fin].astype(np.float64)
    mant, _ = np.frexp(g)
    assert (mant == 0.5).all()
    assert (g >= y).all() and (g < 2.0 * y).all()


def _weights(seed: int) -> np.ndarray:
    """``[2, 16, 12]`` stacked weights: random channels, then an all-zero
    channel, a constant one, powers of two, subnormals and a channel whose
    absmax/127 is a power of two."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((2, 16, 12)).astype(np.float32)
    w[:, :, 0] = 0.0
    w[:, :, 1] = 0.3
    w[:, :, 2] = np.ldexp(1.0, rng.integers(-20, 5, (2, 16)))
    w[:, :, 3] = np.array([1, 7, 0x7FFFFF], np.int32).view(np.float32)[
        rng.integers(0, 3, (2, 16))]
    w[:, :, 4] = 127.0 * 2.0**-10 * rng.choice([-1.0, 1.0, 0.5], (2, 16))
    w[:, :, 5] *= 1e-30
    return w


@pytest.mark.parametrize("mode", tq.QUANT_MODES)
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_per_channel_matches_jax_bitwise(mode, seed):
    w = _weights(seed)
    if mode == "identity":  # integer-valued weights round-trip exactly
        w = np.round(np.clip(w * 40.0, -127, 127)).astype(np.float32)
    q, sc = tq.quantize_per_channel(t(w), mode=mode)
    rq, rsc = jq.quantize_per_channel(jnp.asarray(w), mode=mode)
    assert q.dtype == torch.int8 and sc.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    _same_bits(sc, rsc)
    _same_bits(tq.dequantize(q, sc), jq.dequantize(rq, rsc))
    if mode == "po2":
        # the zero and the subnormal channels take scale 1 and codes 0
        for ch in (0, 3):
            assert (sc[:, ch] == 1.0).all() and (q[:, :, ch] == 0).all()
    with pytest.raises(ValueError):
        tq.quantize_per_channel(t(w), mode="fp8")


def test_kv_scale_from_absmax_matches_jax_bitwise():
    vals = np.concatenate([
        np.float32([0.0, tq.KV_SCALE_MIN / 2, tq.KV_SCALE_MIN,
                    63.0 * 2.0**-126, 63.0, 64.0, 126.0, 127.0]),
        _positive_edge_values(),
        63.0 * np.ldexp(np.float32(1.0), np.arange(-130, 60)),
    ]).astype(np.float32)
    vals = vals[np.isfinite(vals)]
    _same_bits(tq.kv_scale_from_absmax(t(vals)),
               jq.kv_scale_from_absmax(jnp.asarray(vals)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_row_quantization_matches_jax_bitwise(dtype):
    rng = np.random.default_rng(3)
    rows = (rng.standard_normal((3, 2, 5, 16))
            * np.exp(rng.uniform(-8, 8, (3, 2, 5, 1)))).astype(np.float32)
    rows[0, 0, 0] = 0.0
    rows[0, 1, 1] = 1e-41  # subnormal row
    absmax = np.abs(rows).max(-1)
    scales = np.array(jq.kv_scale_from_absmax(jnp.asarray(absmax)))
    scales[1, 0, 2] *= 0.25  # a later row larger than its birth row: clips
    jrows = jnp.asarray(rows).astype(getattr(jnp, dtype))
    trows = t(rows).to(getattr(torch, dtype))
    codes = tq.quantize_kv_rows(trows, t(scales))
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(jq.quantize_kv_rows(jrows,
                                                       jnp.asarray(scales))))
    rounded = tq.round_kv_rows_to_grid(trows, t(scales))
    ref = jq.round_kv_rows_to_grid(jrows, jnp.asarray(scales))
    assert rounded.dtype == trows.dtype
    _same_bits(rounded.float(), np.asarray(ref.astype(jnp.float32)))
    # a rounded row is on its grid: quantizing it again is exact, and
    # the scale derived from it is the one it was rounded with
    again = tq.round_kv_rows_to_grid(rounded, t(scales))
    assert torch.equal(again, rounded)
    rederived = tq.kv_scale_from_absmax(
        tq.round_kv_rows_to_grid(trows, tq.kv_scale_from_absmax(
            trows.float().abs().amax(-1))).float().abs().amax(-1))
    assert torch.equal(rederived, tq.kv_scale_from_absmax(
        trows.float().abs().amax(-1)))


def _jax_quantized_params(jm):
    return {p: np.asarray(a) for p, a in tree_paths(jq.quantize_model(jm))}


@pytest.mark.parametrize("cfg", [MHA, GQA, dict(MHA, tie_embeddings=True)],
                         ids=["mha", "gqa", "tied"])
def test_quantize_model_matches_jax_and_converts(cfg):
    """The port's quantize_model gives JAX's codes and scales bit for bit,
    and JAX's quantized params dict converts to the same QuantLinears."""
    jm, tm, _ = model_pair(cfg)
    qref = _jax_quantized_params(jm)
    qm = tq.quantize_model(tm)
    assert tq.is_quantized(qm) and not tq.is_quantized(tm)
    conv = gpt_from_jax_params(qref, ModelConfig(**cfg), device="cpu")
    assert tq.is_quantized(conv)
    names = ["attn.wqkv", "attn.wo", "mlp.w_up", "mlp.w_down"]
    if cfg.get("mlp") == "swiglu":
        names.append("mlp.w_gate")
    for name in names:
        path = "blocks/" + name.replace(".", "/")
        for i in range(cfg["n_layer"]):
            for m in (qm, conv):
                lin = m.blocks[i].get_submodule(name)
                assert isinstance(lin, tq.QuantLinear)
                np.testing.assert_array_equal(lin.weight.numpy(),
                                              qref[f"{path}/weight"][i])
                _same_bits(lin.scale, qref[f"{path}/scale"][i])
    for m in (qm, conv):
        np.testing.assert_array_equal(m.lm_head.weight.numpy(),
                                      qref["lm_head/weight"])
        _same_bits(m.lm_head.scale, qref["lm_head/scale"])
    with pytest.raises(ValueError):
        tq.quantize_model(qm)
    with pytest.raises(ValueError, match="GPT.project"):
        qm.head_weight(torch.float32)


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha", "gqa"])
def test_quantized_logits_match_jax(cfg):
    """The quantized model's logits against JAX's quantized model (f32,
    1e-5: the frameworks sum in other orders), and dequantize_model's
    weights against JAX's bit for bit."""
    jm, tm, _ = model_pair(cfg)
    qj = jq.quantize_model(jm)
    qm = tq.quantize_model(tm)
    tokens = np.random.default_rng(5).integers(0, cfg["vocab_size"], (2, 24))
    ref = np.asarray(qj(jnp.asarray(tokens, jnp.int32)))
    got = qm(t(tokens).long())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    dref = {p: np.asarray(a) for p, a in tree_paths(jq.dequantize_model(qj))}
    dm = tq.dequantize_model(qm)
    _same_bits(dm.blocks[1].attn.wqkv.weight,
               dref["blocks/attn/wqkv/weight"][1])
    _same_bits(dm.lm_head.weight, dref["lm_head/weight"])
    assert isinstance(dm.lm_head, Linear) and not tq.is_quantized(dm)


@pytest.mark.parametrize("mode", tq.QUANT_MODES)
def test_quant_linear_is_bitwise_the_dequantized_product(mode):
    rng = np.random.default_rng(7)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    if mode == "identity":
        w = np.round(w * 30.0).astype(np.float32)
    x = t(rng.standard_normal((3, 5, 48)).astype(np.float32))
    ql = tq.quantize_linear(Linear(t(w)), mode=mode)
    dense = tq.dequantize_linear(ql)
    if mode == "absmax":  # fractional scales: one rounding per product
        np.testing.assert_allclose(ql(x).numpy(), dense(x).numpy(),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(ql(x), dense(x))
    # a dtype cast of the module moves the codes and keeps the scale f32
    half = tq.quantize_linear(Linear(t(w))).to(torch.bfloat16)
    assert half.weight.dtype == torch.int8
    assert half.scale.dtype == torch.float32
