"""All-to-all sequence parallelism, DeepSpeed-Ulysses style (counterpart of
``midgpt_tpu.parallel.ulysses``), beside ring attention
(``parallel.ring``).

Where the ring streams K/V chunks around the ``sequence`` axis, Ulysses
trades the sharded axis: one all-to-all re-shards ``[B, H, T/S, C]`` to
``[B, H/S, T, C]`` (heads scatter, sequence gathers), each index runs
ordinary whole-sequence causal flash attention on its head group, and
the inverse all-to-all restores the sequence-sharded layout. Index ``d``
takes q heads ``[d H/S, (d+1) H/S)`` and kv heads ``[d Hkv/S, (d+1)
Hkv/S)`` (JAX's tiled ``lax.all_to_all`` order), so GQA's grouping is
kept. The flash kernels' dropout applies unchanged, anchored at the
index's first global flat head ``b_off H + d H/S`` with stride ``H``, so
dropout is exact with no schedule restriction. Needs H and Hkv divisible
by S.

The all-to-alls come from the caller's exchange (``parallel.exchange``):
q, k and v travel in one (so the backward's transfers happen in one
order on every rank), the output in another. Their backward is the
inverse all-to-all, so autograd derives the backward schedule.
"""

from __future__ import annotations

import typing as tp

import torch

from midgpt_tpu_torch.ops.flash import Dropout
from midgpt_tpu_torch.parallel.exchange import Exchange
from midgpt_tpu_torch.parallel.ring import Chunks, _one_call


def ulysses_attention(
    q: Chunks,  # [B, H, T/S, C] per held index
    k: Chunks,  # [B, Hkv, T/S, C]
    v: Chunks,
    exchange: Exchange,
    *,
    dropout_rate: float = 0.0,
    dropout_seed: tp.Union[None, int, torch.Tensor] = None,
    b_off: int = 0,
) -> Chunks:
    """Causal attention with T sharded over ``exchange``'s indices through
    head / sequence all-to-alls; chunks as in ``ring.ring_attention``.
    ``b_off``: the global batch row of the chunks' row 0 (dropout's
    anchor). Requires T, H and Hkv divisible by S (ValueError)."""
    single = isinstance(q, torch.Tensor)
    qs, ks, vs = ([q], [k], [v]) if single else (list(q), list(k), list(v))
    s = exchange.size
    if not len(qs) == len(ks) == len(vs) == len(exchange.held):
        raise ValueError(f"{len(qs)} q, {len(ks)} k, {len(vs)} v chunks for "
                         f"{len(exchange.held)} held sequence indices")
    b, h, tc, _ = qs[0].shape
    hkv = ks[0].shape[1]
    if h % s or hkv % s:
        raise ValueError(
            f"ulysses needs head counts divisible by the sequence axis "
            f"(H={h}, Hkv={hkv}, S={s}); use attn_impl='ring' otherwise")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("ulysses dropout needs dropout_seed")
    seed = (dropout_seed if isinstance(dropout_seed, torch.Tensor)
            or dropout_seed is None else int(dropout_seed))
    if s == 1:  # one index: one causal call, nothing traded
        drop = (None if dropout_rate == 0.0 else
                Dropout(dropout_rate, seed, 0, 0, b_off * h, h))
        out = [_one_call(*qkv, drop)
               if d in exchange.active else torch.zeros_like(qkv[0])
               for qkv, d in zip(zip(qs, ks, vs), exchange.held)]
        return out[0] if single else out
    # q, k and v in one all-to-all: [B, S, (H + 2 Hkv) / S, T/S, C], head
    # group d of each at [:, d], each index's groups gathered along T
    packed = [torch.cat([x.unflatten(1, (s, x.shape[1] // s))
                         for x in qkv], 2) for qkv in zip(qs, ks, vs)]
    gathered = exchange.all_to_all(packed, 1, 3)  # [B, 1, (H+2Hkv)/S, T, C]
    outs = []
    for j, d in enumerate(exchange.held):
        qh, kh, vh = gathered[j][:, 0].split(
            [h // s, hkv // s, hkv // s], 1)
        if d not in exchange.active:
            outs.append(torch.zeros_like(qh))
            continue
        drop = (None if dropout_rate == 0.0 else
                Dropout(dropout_rate, seed, 0, 0, b_off * h + d * (h // s), h))
        outs.append(_one_call(qh, kh, vh, drop))
    out = exchange.all_to_all(outs, 2, 1)  # [B, H, T/S, C]
    return out[0] if single else out
