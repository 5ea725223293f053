"""Ring attention: causal self-attention with T sharded over the mesh's
``sequence`` axis (counterpart of ``midgpt_tpu.parallel.ring``).

Each sequence index ``i`` holds one chunk of ``T / S`` rows of q, k and v
(RoPE already applied at global positions). K/V chunks travel around the
ring, one hop to the next index at a time, through the caller's exchange
(``parallel.exchange``: P2P over the process group in training, an
in-process loopback on one card and in the tests). Each hop computes
chunk pairs through the flash forward kernel (``ops.flash.flash_fwd``,
its dropout anchored at the pair's global row, column and head), and the
partials merge by their log-sum-exps in f32, which equals one softmax
over the whole row.

Causality by chunk index, the JAX package's schedules:

- ``"standard"``: index ``i`` holds chunk ``i``; at hop ``r`` it holds
  chunk ``src = (i - r) mod S``, fully visible when ``src < i``,
  invisible when ``src > i``, causal on the diagonal (hop 0). Index
  ``S - 1`` computes ``S`` pairs, index 0 one.
- ``"zigzag"``: index ``i`` holds half-chunks ``i`` and ``2S - 1 - i``
  (relaid out from the natural order by two half-chunk permutations each
  way, and back; q, k and v relaid out in one tensor); every hop then
  costs two half-chunk pairs on every index (three on the diagonal), so
  the work is balanced.

The backward is the reverse ring, written out (:class:`_Ring`), where
JAX lets autodiff transpose its ``ppermute``s and fold each hop's lse
cotangent into its kernel: here every pair's backward reads the call's
merged output, lse and output gradient (``flash_bwd_dq_delta`` forming
delta once a q chunk, ``flash_bwd_dq`` / ``flash_bwd_dkv`` given it),
which is the single call's math restricted to the pair's columns, with
no per-hop output, lse or merge kept; dq sums in f32 on its rank, and
each K/V chunk's dK/dV sum in an f32 accumulator that travels with the
chunk and goes home after the last hop. Each pair's kernels still round
their partial dq, dk and dv to the compute dtype, so a chunk's gradient
carries one rounding per pair that reads it (on an H100, bf16 [8, 12,
1024, 64], a standard S = 2 ring's dK lies 2.08x as far from one f32
call as one plain bf16 call does, and exactly as far as the ring's own
plain version). The K/V
chunks a rank received in the forward are kept for the backward, as
autodiff would keep them, and every rank runs the same transfers in one
order.

Index ``i`` is a Python int here, not a traced axis index: a pair that
sees nothing launches nothing (JAX computes it and gates it out of the
merge with ``lse = -inf``), and zigzag's operand select is a Python
branch; the K/V chunks still travel every hop, K and V packed in one
tensor (one permutation a hop), and every rank runs every transfer, so
the sends and receives pair up. With one sequence index both schedules
are one causal flash call (its autograd entry).

On the card a chunk (or zigzag half-chunk) that is not a multiple of the
flash kernels' 64-row tile raises (JAX falls back to its naive chunk
math there; the port runs no plain attention on the card).
:func:`_chunk_attention` is JAX's plain chunk-pair oracle, kept for the
tests.
"""

from __future__ import annotations

import math
import typing as tp

import torch

from midgpt_tpu_torch.ops import flash as fl
from midgpt_tpu_torch.ops.flash import (
    NEG_INF,
    TILE,
    Dropout,
    _keep_mask,
    exp_f32,
    log_f32,
)
from midgpt_tpu_torch.parallel.exchange import Exchange

Chunks = tp.Union[torch.Tensor, tp.Sequence[torch.Tensor]]
SCHEDULES = ("standard", "zigzag")


def _chunk_attention(q, k, v, mode: int,
                     drop: tp.Optional[Dropout] = None):
    """One (q chunk, kv chunk) pair in plain math: ``(normalized out f32
    [B, H, Tq, C], lse f32 [B, H, Tq])``, the contract :func:`_merge`
    takes. ``mode`` 0 sees nothing, 1 is causal (the diagonal), 2 sees
    everything. Scores in f32 from the compute-dtype inputs with
    ``1 / sqrt(C)`` applied before the mask; dropout (``drop``, at its
    global anchors) touches the value sums only, so l and lse stay
    undropped and the merge weights exact. A row that sees nothing has
    lse -inf."""
    b, h, tq, c = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    f32 = torch.float32
    qg = q.to(f32).reshape(b, hkv, h // hkv, tq, c)
    z = (qg @ k.to(f32)[:, :, None].transpose(-1, -2)) * (1.0 / math.sqrt(c))
    ii = torch.arange(tq, device=q.device)[:, None]
    jj = torch.arange(tk, device=q.device)[None, :]
    visible = (jj <= ii) if mode == 1 else torch.full(
        (tq, tk), mode == 2, device=q.device)
    z = torch.where(visible, z, NEG_INF)
    m = z.amax(-1)
    p = exp_f32(z - m[..., None])
    l = p.sum(-1)
    if drop is not None:
        ar = lambda n: torch.arange(n, dtype=torch.int64,  # noqa: E731
                                    device=q.device)
        heads = (drop.bh_off + ar(b)[:, None] * (drop.n_head_total or h)
                 + ar(h)[None, :])
        mask = _keep_mask(drop.seed, heads, drop.row_off + ar(tq),
                          drop.col_off + ar(tk), 1.0 - drop.rate)
        p = torch.where(mask.reshape(p.shape), p * (1.0 / (1.0 - drop.rate)),
                        0.0)
    out = p.to(v.dtype).to(f32) @ v.to(f32)[:, :, None]
    out = out / l.clamp_min(1e-30)[..., None]
    lse = m + log_f32(l.clamp_min(1e-30))
    lse = torch.where(m <= NEG_INF / 2, -math.inf, lse)
    return out.reshape(b, h, tq, c), lse.reshape(b, h, tq)


def _merge(o1, lse1, o2, lse2):
    """Merge two normalized chunk-softmax partials: the average weighted
    by their log-sum-exps (both finite: a pair that sees nothing is never
    computed)."""
    m = torch.maximum(lse1, lse2)
    w1, w2 = exp_f32(lse1 - m), exp_f32(lse2 - m)
    denom = w1 + w2
    out = (o1 * w1[..., None] + o2 * w2[..., None]) / denom[..., None]
    return out, m + log_f32(denom)


def _anchored(drop: tp.Optional[Dropout], row_off: int,
              col_off: int) -> tp.Optional[Dropout]:
    return None if drop is None else drop._replace(row_off=row_off,
                                                   col_off=col_off)


def _next(s: int) -> tp.Callable[[int], int]:
    return lambda i: (i + 1) % s


def _kv(kv):
    """A packed ``[B, 2 Hkv, T, C]`` chunk's k and v (views)."""
    hkv = kv.shape[1] // 2
    return kv[:, :hkv], kv[:, hkv:]


def _parts(schedule: str, tc: int) -> tp.List[slice]:
    """The row ranges of a chunk the schedule pairs: the whole chunk, or
    zigzag's two halves."""
    if schedule == "standard":
        return [slice(0, tc)]
    return [slice(0, tc // 2), slice(tc // 2, tc)]


def _pairs(schedule: str, s: int, i: int,
           r: int) -> tp.List[tp.Tuple[int, int, bool]]:
    """Index ``i``'s chunk pairs at hop ``r``, in merge order: ``(q part,
    kv part, causal)``."""
    src = (i - r) % s
    if schedule == "standard":
        if r == 0:
            return [(0, 0, True)]
        return [(0, 0, False)] if src < i else []
    if r == 0:
        return [(0, 0, True), (1, 0, False), (1, 1, True)]
    return [(1, 0, False), (0, 0, False) if src < i else (1, 1, False)]


def _rows(schedule: str, s: int, i: int, tc: int, part: slice) -> int:
    """The global row of a held part's first row (standard: chunk ``i``
    is rows ``i tc ..``; zigzag holds half-chunks ``i`` and ``2S-1-i``)."""
    if schedule == "standard":
        return i * tc + part.start
    return (i if part.start == 0 else 2 * s - 1 - i) * (tc // 2)


class HopOps(tp.NamedTuple):
    """The four calls a chunk pair makes: the forward ``(out, lse)``, dq
    forming delta ``(dq, delta)``, dq given delta, and per-q-head
    ``(dk, dv)`` (``ops.flash``'s signatures)."""

    fwd: tp.Callable
    dq_delta: tp.Callable
    dq: tp.Callable
    dkv: tp.Callable


def _plain_dq_delta(q, k, v, dout, lse, out, dlse=None, causal=True,
                    drop=None):
    delta = fl.delta_reference(dout, out, dlse)
    return fl.flash_backward_dq_reference(q, k, v, dout, lse, delta, causal,
                                          drop), delta


# the kernels' wrappers (their plain versions for CPU tensors), and the
# plain versions on any device, for comparisons
FLASH_OPS = HopOps(fl.flash_fwd, fl.flash_bwd_dq_delta, fl.flash_bwd_dq,
                   fl.flash_bwd_dkv)
PLAIN_OPS = HopOps(fl.flash_forward_reference, _plain_dq_delta,
                   fl.flash_backward_dq_reference,
                   fl.flash_backward_dkv_reference)


def _gqa_sum(x: torch.Tensor, hkv: int) -> torch.Tensor:
    """Per-q-head ``[B, H, T, C]`` summed over each kv group, in f32."""
    b, h, t, c = x.shape
    return x.float().reshape(b, hkv, h // hkv, t, c).sum(2)


class _Ring(torch.autograd.Function):
    """The ring over the held chunks (q ``[B, H, T/S, C]``, kv packed
    ``[B, 2 Hkv, T/S, C]``): forward hops and merges, backward the
    reverse ring (see the module docstring)."""

    @staticmethod
    def forward(ctx, ex, schedule, drop, ops, n, *chunks):
        qs, kvs = chunks[:n], chunks[n:]
        s, tc, dt = ex.size, qs[0].shape[2], qs[0].dtype
        parts = _parts(schedule, tc)
        # per held index: each part's (out f32, lse), and the chunk held
        # at each hop (kept for the backward)
        acc = [[None] * len(parts) for _ in range(n)]
        held: tp.List[tp.List[torch.Tensor]] = [[] for _ in range(n)]
        cur = list(kvs)
        for r in range(s):
            if r:
                cur = ex.permute(cur, _next(s))
            for j, i in enumerate(ex.held):
                held[j].append(cur[j])
                if i not in ex.active:
                    continue
                for qp, kp, causal in _pairs(schedule, s, i, r):
                    k, v = _kv(cur[j][:, :, parts[kp]])
                    d = _anchored(drop, _rows(schedule, s, i, tc, parts[qp]),
                                  _rows(schedule, s, (i - r) % s, tc,
                                        parts[kp]))
                    o, lse = ops.fwd(qs[j][:, :, parts[qp]], k, v, causal,
                                     d)
                    part = (o.float(), lse)
                    acc[j][qp] = (part if acc[j][qp] is None
                                  else _merge(*acc[j][qp], *part))
        outs, lses = [], []
        for j, q in enumerate(qs):
            if ex.held[j] in ex.active:
                outs.append(torch.cat([a[0] for a in acc[j]], 2).to(dt))
                lses.append(torch.cat([a[1] for a in acc[j]], 2))
            else:
                outs.append(torch.zeros_like(q))
                lses.append(torch.zeros(q.shape[:3], device=q.device))
        ctx.ex, ctx.schedule, ctx.drop, ctx.ops, ctx.n = (ex, schedule, drop,
                                                          ops, n)
        ctx.save_for_backward(*qs, *outs, *lses,
                              *[x for hops in held for x in hops])
        return tuple(outs)

    @staticmethod
    def backward(ctx, *douts):
        ex, schedule, drop, ops, n = (ctx.ex, ctx.schedule, ctx.drop,
                                      ctx.ops, ctx.n)
        saved = ctx.saved_tensors
        qs, outs, lses = saved[:n], saved[n:2 * n], saved[2 * n:3 * n]
        s, tc, dt = ex.size, qs[0].shape[2], qs[0].dtype
        held = [saved[3 * n + j * s:3 * n + (j + 1) * s] for j in range(n)]
        parts = _parts(schedule, tc)
        hkv = held[0][0].shape[1] // 2
        dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
               for q in qs]
        # the dK/dV of the chunk each index holds, travelling with it
        dkvs = [torch.zeros(kv.shape, dtype=torch.float32, device=kv.device)
                for kv in (h[0] for h in held)]
        deltas = [[None] * len(parts) for _ in range(n)]
        for r in range(s):
            if r:
                dkvs = ex.permute(dkvs, _next(s))
            for j, i in enumerate(ex.held):
                if i not in ex.active:
                    continue
                for qp, kp, causal in _pairs(schedule, s, i, r):
                    rows, cols = parts[qp], parts[kp]
                    q = qs[j][:, :, rows]
                    k, v = _kv(held[j][r][:, :, cols])
                    do = douts[j][:, :, rows]
                    lse = lses[j][:, :, rows]
                    d = _anchored(drop, _rows(schedule, s, i, tc, rows),
                                  _rows(schedule, s, (i - r) % s, tc, cols))
                    if deltas[j][qp] is None:  # delta = rowsum(dO * O)
                        dq, deltas[j][qp] = ops.dq_delta(
                            q, k, v, do, lse, outs[j][:, :, rows], None,
                            causal, d)
                    else:
                        dq = ops.dq(q, k, v, do, lse, deltas[j][qp], causal,
                                    d)
                    dk, dv = ops.dkv(q, k, v, do, lse, deltas[j][qp], causal,
                                     d)
                    dqs[j][:, :, rows] += dq.float()
                    dkvs[j][:, :hkv, cols] += _gqa_sum(dk, hkv)
                    dkvs[j][:, hkv:, cols] += _gqa_sum(dv, hkv)
        dkvs = ex.permute(dkvs, _next(s))  # each accumulator home
        return (None, None, None, None, None, *[x.to(dt) for x in dqs],
                *[x.to(dt) for x in dkvs])


def _halves(x):
    tc = x.shape[2] // 2
    return x[:, :, :tc], x[:, :, tc:]


def _zigzag_order(t: int, s: int):
    """Gather indices that re-lay a contiguous T axis into zigzag chunk
    order ``[0, 2S-1, 1, 2S-2, ...]`` (index ``i`` holds pair ``(i, 2S-1-i)``),
    and the inverse permutation. The oracle of the relayouts below."""
    import numpy as np

    tc = t // (2 * s)
    order = []
    for i in range(s):
        order += [i, 2 * s - 1 - i]
    idx = np.concatenate([np.arange(c * tc, (c + 1) * tc) for c in order])
    return idx, np.argsort(idx)


def _zigzag_relayout_in(xs, ex: Exchange):
    """Natural-order chunks (half-chunks ``2d, 2d + 1`` at index ``d``)
    -> zigzag pairs ``(d, 2S - 1 - d)``: two half-chunk permutations and
    a parity slot select. Half-chunk ``g``'s owner is ``g`` for ``g < S``,
    else ``2S - 1 - g``; the even halves form one bijection, the odd ones
    another, and the even arrival goes first exactly at an even index."""
    s = ex.size

    def owner(g: int) -> int:
        return g if g < s else 2 * s - 1 - g

    lo, hi = zip(*map(_halves, xs))
    a = ex.permute(lo, lambda i: owner(2 * i))
    b = ex.permute(hi, lambda i: owner(2 * i + 1))
    return [torch.cat([a[j], b[j]] if d % 2 == 0 else [b[j], a[j]], 2)
            for j, d in enumerate(ex.held)]


def _zigzag_relayout_out(ys, ex: Exchange):
    """The inverse of :func:`_zigzag_relayout_in`: index ``d`` holds
    half-chunks ``(d, 2S - 1 - d)``; the even one goes home to the low
    slot of index ``g / 2``, the odd one to the high slot of ``(g - 1) /
    2``."""
    s = ex.size
    slots = [_halves(y) for y in ys]
    even = [sl[0] if d % 2 == 0 else sl[1] for sl, d in zip(slots, ex.held)]
    odd = [sl[1] if d % 2 == 0 else sl[0] for sl, d in zip(slots, ex.held)]

    def g_even(d: int) -> int:
        return d if d % 2 == 0 else 2 * s - 1 - d

    def g_odd(d: int) -> int:
        return d if d % 2 == 1 else 2 * s - 1 - d

    c = ex.permute(even, lambda i: g_even(i) // 2)
    e = ex.permute(odd, lambda i: (g_odd(i) - 1) // 2)
    return [torch.cat([c[j], e[j]], 2) for j in range(len(ys))]


def _one_call(q, k, v, drop: tp.Optional[Dropout]) -> torch.Tensor:
    """Causal attention in one flash call (its autograd entry)."""
    if drop is None:
        return fl.flash_attention(q, k, v)
    return fl.flash_attention_dropout_lse(
        q, k, v, drop.seed, drop.rate, True, row_off=drop.row_off,
        col_off=drop.col_off, bh_off=drop.bh_off,
        n_head_total=drop.n_head_total)[0]


def check_chunks(qs, ks, vs, ex: Exchange, schedule: str) -> None:
    """The shape rules of a ring call (ValueError): one chunk a held index,
    all of one shape; zigzag needs an even chunk; on the card each
    chunk (zigzag: half-chunk) a multiple of the flash kernels' tile."""
    if not len(qs) == len(ks) == len(vs) == len(ex.held):
        raise ValueError(f"{len(qs)} q, {len(ks)} k, {len(vs)} v chunks for "
                         f"{len(ex.held)} held sequence indices")
    tc = qs[0].shape[2]
    if any(x.shape[2] != tc for x in (*qs, *ks, *vs)):
        raise ValueError("every chunk must hold the same T / S rows")
    s = ex.size
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown ring schedule {schedule!r}")
    if schedule == "zigzag" and tc % 2:
        raise ValueError(f"zigzag needs T={tc * s} divisible by 2*sequence "
                         f"({2 * s})")
    rows = tc // 2 if schedule == "zigzag" and s > 1 else tc
    if qs[0].device.type == "cuda" and rows % TILE:
        what = "half-chunk" if rows != tc else "chunk"
        raise ValueError(
            f"a ring {what} of {rows} rows is not a multiple of the flash "
            f"kernels' {TILE}-row tile (T={tc * s}, S={s}, schedule "
            f"{schedule!r})")


def ring_attention(
    q: Chunks,  # [B, H, T/S, C] per held index
    k: Chunks,  # [B, Hkv, T/S, C]
    v: Chunks,
    exchange: Exchange,
    *,
    schedule: str = "standard",
    dropout_rate: float = 0.0,
    dropout_seed: tp.Union[None, int, torch.Tensor] = None,
    bh_off: int = 0,
    n_head_total: tp.Optional[int] = None,
    plain: bool = False,
) -> Chunks:
    """Causal ring attention over ``exchange``'s sequence indices: q, k, v
    the held chunks (a tensor for a process that holds one index, else a
    list in ``exchange.held`` order), the output alike, each chunk in q's
    dtype. Differentiable (:class:`_Ring` runs the ring in reverse).

    ``schedule``: ``"standard"`` or ``"zigzag"`` (balanced; T divisible
    by 2S). Attention dropout at ``dropout_rate`` needs ``dropout_seed``
    and the standard schedule (a zigzag chunk interleaves two
    non-contiguous half-chunks, which one scalar row/column anchor cannot
    express); every pair anchors the flash kernels' mask at its global
    coordinates, the flat q head at ``bh_off + b * n_head_total + h``
    (``n_head_total`` default H), so the ring drops exactly what one call
    over the whole T drops. A virtual rank outside a loopback's
    ``active`` launches nothing and gives zeros. ``plain`` runs every
    pair through the flash kernels' plain versions, on any device (the
    ring's own plain version, for comparisons)."""
    single = isinstance(q, torch.Tensor)
    qs, ks, vs = ([q], [k], [v]) if single else (list(q), list(k), list(v))
    drop = None
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("ring dropout needs dropout_seed")
        if schedule != "standard":
            raise ValueError("attention dropout under ring requires "
                             "schedule='standard'")
        seed = (dropout_seed if isinstance(dropout_seed, torch.Tensor)
                else int(dropout_seed))
        drop = Dropout(dropout_rate, seed, 0, 0, bh_off,
                       n_head_total or qs[0].shape[1])
    check_chunks(qs, ks, vs, exchange, schedule)
    ex, n, h = exchange, len(qs), qs[0].shape[1]
    ops = PLAIN_OPS if plain else FLASH_OPS
    if ex.size == 1:  # both schedules: one causal call
        schedule = "standard"
    if ex.size == 1 and not plain:
        out = [_one_call(*qkv, drop) if i in ex.active
               else torch.zeros_like(qkv[0])
               for qkv, i in zip(zip(qs, ks, vs), ex.held)]
    elif schedule == "zigzag":
        qkv = _zigzag_relayout_in([torch.cat(x, 1) for x in zip(qs, ks, vs)],
                                  ex)
        out = _zigzag_relayout_out(list(_Ring.apply(
            ex, schedule, None, ops, n, *[x[:, :h] for x in qkv],
            *[x[:, h:] for x in qkv])), ex)
    else:
        out = list(_Ring.apply(ex, schedule, drop, ops, n, *qs,
                               *[torch.cat(x, 1) for x in zip(ks, vs)]))
    return out[0] if single else out
