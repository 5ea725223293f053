"""Continuous-batching serving engine over a paged KV pool
(counterpart of ``midgpt_tpu.serving.engine``: the prefix cache with
copy-on-write, chunked prefill and self-speculative decoding).

Every :meth:`ServingEngine.step` is one scheduler window: admit queued
requests into free slots (a prefix-cache match, then page allocation for
the rest of the prompt), run prefill chunks round-robin over the
prefilling slots until the window's token budget is spent, top up every
decoding slot's pages for the coming ``window`` tokens, run the K-step
decode window for all slots, then harvest the emitted tokens and
finished requests with one device-to-host read.

Prefix cache (``prefix_cache=True``, the default, as in the JAX
engine): every full page of a slot's context (prompt and generated
tokens) is indexed by its content chain (``serving.paged.PrefixIndex``).
An admission matches its prompt less the last token against the index,
shares the matched pages, and prefills only the suffix
(``prefill_chunk`` at ``start > 0``). A partial match of a cached page
copies that page into a private one first (copy-on-write,
``serving.paged.copy_page``). A finished request's indexed pages retire
to a cold cache, still matchable, until admission needs their pages.

Chunked prefill: ``prefill_chunk=N`` prefills at most N tokens a chunk,
``prefill_budget`` (default: ``prefill_chunk``) caps the prefill tokens
a window runs (the first chunk always runs), and a cursor kept across
windows takes the prefilling slots in turn. ``max_prefills_per_window``
(default: ``slots``) caps admissions a window.

The decode window (:func:`decode_window`) carries the same per-slot state
as the JAX program: each step samples a token per slot from the carried
f32 logits, marks slots that hit EOS or their budget done (the token that
reaches the budget is emitted, ``done`` is set after it), runs one decode
step for every slot with finished and empty slots riding along masked,
and at window end flushes the valid prefix of the recent rows into the
pages. The pool is read-only inside the window.

On the card the decode window and the verify dispatch each run as one
CUDA graph replay, as JAX runs each as one jitted program
(``make_decode_window``, ``make_verify_program``): the engine keeps one
:class:`~midgpt_tpu_torch.serving.programs.Program` per key (JAX's
``_cached_program`` key: kind, slots, window or speculation length,
pages a table, rope length, the sampling constants, the pool's dtype and
quantization, soft drafts), captures its graph at its first dispatch and
replays it after. The slots' host state is copied into the program's
static tensors from a pinned mirror before the replay, the carried
logits and the pool are updated in place, and the harvest reads the
packed results in one copy. Neither body reads a device value on the
host or makes a shape from one (:func:`decode_window`,
:func:`verify_dispatch`, ``serving.paged.flush_recent``); on the CPU the
same bodies run eagerly. There is no eager mode on the card: a capture
that fails raises.

Every prefill chunk is one replay too, as JAX compiles one program per
padded chunk length (``make_prefill_chunk_program``): one program per
bucket and shape class (a chunk at 0 reads no page; a chunk that
resumes, ``start > 0``, reads the whole table masked at ``start``), at
most ``2 (log2(pmax) + 1)`` an engine. The slot, ``start``, the real
length, the tokens and the slot's table row are its static inputs
(:func:`prefill_chunk`); the pool's pages and the slot's logits row are
written in place. :meth:`ServingEngine.warm_prefill` captures every
bucket and class ahead of a measured trace, writing nothing.

With ``speculate=N`` every decode window becomes one verify dispatch
(:func:`verify_dispatch`): a host-side proposer (``serving.speculate``)
drafts up to N tokens per slot from the request's own history, the model
scores row 0 (the true next token, drawn from the carried logits as the
window's step 0 would) and the drafts in one pass, and each slot emits
``1 + accepted`` tokens. Greedy acceptance is the longest prefix of
drafts equal to the model's argmax; sampled acceptance is rejection
sampling, with the residual ``max(p - q, 0)`` carried as the next
dispatch's logits. Only the emitted prefix's K/V reaches the pool.

Int8 serving: ``quant="int8"`` serves the model with per-output-channel
po2 int8 weights (``midgpt_tpu_torch.quant``), and ``kv_quant="int8"``
stores the pool's pages int8 with one po2 scale per (page, KV head); the
paged kernels then take their int8 branch. Each is a different function
from the float engine's, but streams do not depend on the window or on
speculation, and po2 weight scales make the quantized engine
token-identical to the engine serving the dequantized weights.

Capacity and overload (JAX's admission accounting): the pool defaults
to the worst case (every slot at ``block_size``); a deployment sizes it
to the card's memory. Admission reserves only the prompt's pages less
its matched full pages, reclaiming cold cached pages least recently used
leaf first; a blocked head of the queue waits, with no skip-ahead. Pages
then grow on demand before each dispatch. When the pool runs short the
slot with the least progress is evicted: its pages retire (indexed ones
to the cold cache), and it re-queues with ``prompt0 + tokens`` as its
prompt, so its re-admission re-prefills mostly from the cache and its
stream goes on unchanged. A request evicted ``park_threshold`` times
without emitting a token in between parks (the livelock guard), and so
does a lone slot that cannot grow; parked requests return to the queue
when a request finishes or is cancelled, when a quarantine lifts, or
when nothing else runs.

The request lifecycle (JAX's): ``submit`` raises the typed
:class:`~midgpt_tpu_torch.serving.faults.AdmissionRejected` (counted by
reason) or, with a full bounded queue (``max_queue``) under
``overload_policy="defer"``,
:class:`~midgpt_tpu_torch.serving.faults.PoolOverloaded`. Fresh requests
are admitted by priority, aged by ``priority_aging`` per scheduler step
queued, first in first out within a priority; resumed (evicted or
parked) work goes first. A request whose deadline (on ``clock``) passes
while it is queued or parked is shed. ``cancel`` tears down a queued,
parked or running request; ``lookup`` finds one by id;
``drain_requests`` and ``resubmit`` move requests to another engine,
where their streams go on. ``fault_hook`` (``FaultPlan.hook``) runs at
the top of every step.

Cold-page host spill (``spill="on"``, JAX's knob; needs the prefix
cache): under pool pressure a cold cached page, the least recently used
one with no resident child, moves to host RAM instead of being dropped:
its payload and int8 scale planes go to a
:class:`~midgpt_tpu_torch.serving.paged.HostSpillStore` (pinned memory on
the card, copied on the engine's stream), the prefix index re-keys the
node to a virtual id, still matchable, and only then does the page id
return to the free list. An admission whose match walks onto spilled
nodes faults them back byte for byte (``import_pages``) into fresh
pages; with ``spill_prefetch="on"`` each step first fetches the queue
head's spilled chain in one batched import. ``spill_budget_pages``
caps the pages held on the host: past it the oldest spilled prefixes
are forgotten. Streams do not change: a page comes back with the bytes
it left with, or its tokens are recomputed.

Metrics and tracing (JAX's): the counters are properties over the
engine's :class:`~midgpt_tpu_torch.telemetry.MetricsRegistry`, beside
live gauges and latency histograms; :meth:`ServingEngine.stats` is a
view of it with exactly the keys of
:data:`~midgpt_tpu_torch.serving.telemetry.ENGINE_STATS_KEYS`, and
:meth:`ServingEngine.metrics_snapshot` the whole registry.
``telemetry=True`` (or an
:class:`~midgpt_tpu_torch.serving.telemetry.EngineTelemetry`) records
each request's lifecycle events and each dispatch's span, keyed to the
scheduler step, with times from ``clock``; every emission reads host
state only, and a dispatch's span ends at the harvest's existing read,
so tracing changes no stream and adds no synchronization.
:meth:`ServingEngine.flight_dump` writes the rings, the registry and the
stats as one JSON record.

Page handoff (JAX's ``role``, the disaggregated cluster's seam,
``serving.cluster``): a ``role="prefill"`` engine runs a prompt's prefill
to its end and then parks the slot handoff-ready instead of decoding it;
:meth:`ServingEngine.export_request` packages the slot as a
:class:`HandoffRecord` (its pages and scale planes copied to pinned host
memory on the engine's stream, and the carried f32 logits row) and
releases it, and :meth:`ServingEngine.import_request` lands the record in
another engine's free slot, aliasing the prefix that engine's index
already holds, so its stream goes on as the monolithic engine's would.
``role="decode"`` is a routing label only: such an engine is a full
engine.

Tensor parallelism (``mesh=``, JAX's tensor-only serving mesh): the
model's column- and row-parallel shards, the pool split by whole KV
heads (``serving.paged.ShardedKVPool``), vocabulary-sharded logits with
each token through the greedy combiner or the gathered row, and
``prefill_sp``; every program key carries the mesh's fingerprint
(:class:`ServingEngine`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.models.gpt import (
    GPT,
    _rope_table,
    check_serving_tensor,
    decode_step_paged,
    prefill_chunk_paged,
    tensor_copy,
    verify_tokens_paged,
)
from midgpt_tpu_torch.ops import launches
from midgpt_tpu_torch.parallel.tensor import shardwise
from midgpt_tpu_torch.quant import is_quantized, quantize_model
from midgpt_tpu_torch.sampling import (
    acceptance_keys,
    acceptance_mask,
    acceptance_uniforms,
    gumbel_noise,
    request_keys,
    residual_logits,
    sample_token,
    target_probs,
)
from midgpt_tpu_torch.serving.faults import (
    AdmissionRejected,
    HandoffFailed,
    PoolOverloaded,
)
from midgpt_tpu_torch.serving.paged import (
    HostSpillStore,
    PageAllocator,
    PagedKVPool,
    PrefixIndex,
    ShardedKVPool,
    copy_page,
    export_pages,
    flush_recent,
    import_pages,
    pages_needed,
    recent_rows,
    write_token_rows,
)
from midgpt_tpu_torch.serving.programs import Program, pool_bytes
from midgpt_tpu_torch.serving.speculate import NgramProposer, Proposer
from midgpt_tpu_torch.serving.telemetry import (
    EngineTelemetry,
    MetricsRegistry,
    write_json,
)
from midgpt_tpu_torch.utils.platform import resolve_device

PAD_ID = 0  # the token finished and empty slots sample, and prefill pads


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record."""

    rid: int
    # [p] int32 admission context: the cropped prompt, or prompt0 + the
    # tokens emitted so far after an eviction
    prompt: np.ndarray
    max_new_tokens: int
    # the cropped original prompt, from which an eviction rebuilds
    # ``prompt`` (never from an already grown one)
    prompt0: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int32))
    eos_id: int = -1  # -1 = no EOS (run to max_new_tokens)
    seed: int = 0
    submit_time: float = 0.0
    first_token_time: tp.Optional[float] = None
    finish_time: tp.Optional[float] = None
    tokens: tp.List[int] = dataclasses.field(default_factory=list)
    evictions: int = 0
    cached_tokens: int = 0  # prompt tokens served from the prefix cache
    # speculation: the adaptive draft length (starts at the engine's
    # ``speculate``), its acceptance-rate EWMA, and the request's totals;
    # an eviction keeps them
    spec_k: int = 0
    spec_rate: float = 1.0
    spec_drafted: int = 0
    spec_accepted: int = 0
    # the livelock guard: tokens held at the last admission, and the
    # evictions in a row without a token emitted since
    admit_tokens: int = 0
    thrash: int = 0
    # admission order: higher priority first; ``deadline`` an absolute
    # instant on the engine's clock past which a request still waiting is
    # shed (None: none); ``queue_seq`` the submission order, ``queue_step``
    # the scheduler step of the last enqueue (aging counts from it)
    priority: int = 0
    deadline: tp.Optional[float] = None
    queue_seq: int = 0
    queue_step: int = 0
    # "pending" while live, then "finished", "cancelled" or "expired"
    outcome: str = "pending"

    @property
    def done(self) -> bool:
        return self.finish_time is not None


@dataclasses.dataclass
class HandoffRecord:
    """A prefilled request packaged for the page handoff between engines
    (``ServingCluster``'s disaggregated pools): the live :class:`Request`,
    its context tokens, its pages' payloads with an int8 pool's scale
    planes in block-table order, and the carried logits row, the one the
    last prefill chunk wrote, from which a monolithic engine would draw
    the first token. Built by :meth:`ServingEngine.export_request`, taken
    by :meth:`ServingEngine.import_request`.

    The tensors are host tensors (pinned on the card) whose copies were
    queued on the source engine's stream and may still be running;
    ``ready`` is an event recorded on that stream after them (None off
    the card), which the importing engine's stream waits on before it
    reads them."""

    req: Request
    ctx: tp.List[int]  # the slot's context tokens (the prompt)
    resident: int  # tokens in the pages (len(ctx))
    logits_row: torch.Tensor  # [V] f32
    n_pages: int
    # [L, n_pages, Hkv, C, PS] pool dtype; under a tensor axis every held
    # rank's heads end to end
    k: torch.Tensor
    v: torch.Tensor
    sk: tp.Optional[torch.Tensor]  # [L, n_pages, Hkv] f32 (int8 pools)
    sv: tp.Optional[torch.Tensor]
    ready: tp.Optional[torch.cuda.Event] = None

    @property
    def nbytes(self) -> int:
        """The handoff's bytes: payload, scale planes and logits row."""
        n = self.k.nbytes + self.v.nbytes + self.logits_row.nbytes
        if self.sk is not None:
            n += self.sk.nbytes + self.sv.nbytes
        return int(n)


@torch.no_grad()
def decode_window(
    model: GPT,
    pool: PagedKVPool,
    logits: torch.Tensor,  # [S, V] f32 per-slot next-token logits
    bt: torch.Tensor,  # [S, Pmax] int32 block tables
    pooled_len: torch.Tensor,  # [S] int32 tokens resident in the pool
    done: torch.Tensor,  # [S] bool finished or empty slot
    emitted: torch.Tensor,  # [S] int32 tokens emitted so far per request
    budget: torch.Tensor,  # [S] int32 max_new_tokens per request
    eos: torch.Tensor,  # [S] int32 per-request EOS id (-1 = none)
    seeds: torch.Tensor,  # [S] int64 per-slot request seeds
    *,
    window: int,
    rope_len: int,
    temperature: float = 0.0,
    top_k: tp.Optional[int] = None,
    base_seed: int = 0,
    paged_kernel: str = "kernel",
):
    """``window`` decode steps for every slot, then the bulk flush (JAX's
    ``make_decode_window``). Returns ``(logits, toks [K, S], emit [K, S],
    done, new_len, emitted)``; the pool's pages are updated in place. It
    reads no device value on the host and makes no shape from one, so the
    engine runs it as one CUDA graph on the card. The noise keys come
    from ``seeds`` and ``emitted`` on the device. ``paged_kernel=
    "reference"`` runs the plain attention on any device, to compare
    with the kernel."""
    cfg = model.config
    s = logits.shape[0]
    rk = recent_rows(pool, cfg.n_layer, s, window, cfg.head_dim,
                     logits.device)
    rv = recent_rows(pool, cfg.n_layer, s, window, cfg.head_dim,
                     logits.device)
    pad = torch.full((s,), PAD_ID, dtype=torch.int32, device=logits.device)
    start = emitted
    toks, emits, wvalid = [], [], []
    for r in range(window):
        pre_done = done
        gumbel = None
        if temperature > 0.0:
            # a live slot at step r has emitted start + r tokens (done is
            # monotone within the window)
            gumbel = gumbel_noise(request_keys(base_seed, seeds, start + r),
                                  cfg.vocab_size)
        tok = sample_token(logits, temperature, top_k, gumbel, model.tensor)
        tok = torch.where(pre_done, pad, tok)
        emitted = emitted + (~pre_done).to(torch.int32)
        hit_eos = ~pre_done & (tok == eos)
        hit_len = ~pre_done & (emitted >= budget)
        done = pre_done | hit_eos | hit_len
        # the sampled token is this step's input; its K/V row is only
        # needed if a real token can follow it
        write_valid = ~done
        new_logits, rk, rv = decode_step_paged(
            model, tok, pooled_len + r, pool.k, pool.v, bt, rk, rv, r,
            pooled_len, rope_len, paged_kernel=paged_kernel,
            pool_sk=pool.scale_k, pool_sv=pool.scale_v,
        )
        logits = new_logits.to(torch.float32)
        toks.append(tok)
        emits.append(~pre_done)
        wvalid.append(write_valid)
    valid = torch.stack(wvalid, dim=1)  # [S, K]
    flush_recent(pool, rk, rv, bt, pooled_len, valid)
    new_len = pooled_len + valid.sum(dim=1, dtype=torch.int32)
    return (logits, torch.stack(toks), torch.stack(emits), done, new_len,
            emitted)


@torch.no_grad()
def verify_dispatch(
    model: GPT,
    pool: PagedKVPool,
    logits: torch.Tensor,  # [S, V] f32 per-slot next-token logits
    bt: torch.Tensor,  # [S, Pmax] int32 block tables
    pooled_len: torch.Tensor,  # [S] int32 tokens resident in the pool
    done: torch.Tensor,  # [S] bool finished or empty slot
    emitted: torch.Tensor,  # [S] int32 tokens emitted so far per request
    budget: torch.Tensor,  # [S] int32 max_new_tokens per request
    eos: torch.Tensor,  # [S] int32 per-request EOS id (-1 = none)
    drafts: torch.Tensor,  # [S, N] int32 drafted tokens
    n_draft: torch.Tensor,  # [S] int32 in [0, N] drafts per slot
    seeds: torch.Tensor,  # [S] int64 per-slot request seeds
    *,
    rope_len: int,
    temperature: float = 0.0,
    top_k: tp.Optional[int] = None,
    base_seed: int = 0,
    draft_probs: tp.Optional[torch.Tensor] = None,  # [S, N, V] soft drafts
    paged_kernel: str = "kernel",
):
    """One speculative verify dispatch for every slot (JAX's
    ``make_verify_program``). Candidate row 0 is the true next token,
    drawn from the carried logits with the decode window's key for that
    position; rows ``1..N`` are the drafts. Returns ``(logits, cand
    [S, T], emit [S, T], done, new_len, emitted, n_acc)``; the pool's
    pages get the emitted rows' K/V in place, except a terminal row (EOS
    or budget), which no token follows. As :func:`decode_window`, it
    reads no device value on the host (keys from ``seeds`` and
    ``emitted`` on the device).

    Under a tensor axis the logits are vocabulary-sharded (``model.
    tensor``'s held shards): greedy acceptance takes the combiner's
    argmax of each row, sampled acceptance and the residual the whole
    rows gathered, the carried row its held columns again."""
    from midgpt_tpu_torch.parallel.tensor import (
        gather_vocab,
        greedy_argmax,
        held_columns,
    )

    cfg = model.config
    ex = model.tensor
    s, spec_len = drafts.shape
    t = spec_len + 1
    dev = logits.device
    i32 = torch.int32
    pad = torch.full((s,), PAD_ID, dtype=i32, device=dev)
    gumbel = None
    if temperature > 0.0:
        gumbel = gumbel_noise(request_keys(base_seed, seeds, emitted),
                              cfg.vocab_size)
    t0 = torch.where(done, pad, sample_token(logits, temperature, top_k,
                                             gumbel, ex))
    cand = torch.cat([t0[:, None], drafts.to(i32)], dim=1)  # [S, T]
    all_logits, ks, vs = verify_tokens_paged(
        model, cand, pooled_len, pool.k, pool.v, bt, rope_len,
        paged_kernel=paged_kernel, pool_sk=pool.scale_k, pool_sv=pool.scale_v,
    )  # all_logits [S, T, V]; ks/vs [L, S, Hkv, T, C]
    rows = torch.arange(spec_len, device=dev)
    in_draft = rows[None, :] < n_draft[:, None]
    if temperature == 0.0:
        preds = greedy_argmax(all_logits, ex).to(i32)
        match = (cand[:, 1:] == preds[:, :-1]) & in_draft
    else:
        # the distribution sample_token draws from after each prefix row
        p = target_probs(gather_vocab(all_logits[:, :-1], ex), temperature,
                         top_k)
        p_sel = torch.gather(p, 2, cand[:, 1:, None].long())[..., 0]
        if draft_probs is not None:
            qf = draft_probs.to(torch.float32)
            q_sel = torch.gather(qf, 2, cand[:, 1:, None].long())[..., 0]
        else:  # one-hot n-gram drafts: q(draft) = 1
            q_sel = torch.ones_like(p_sel)
        # one uniform per (request, stream position) from the position's
        # salted key: independent of the categorical draw a rejection
        # then makes at that position
        akeys = acceptance_keys(base_seed, seeds[:, None],
                                emitted[:, None] + rows[None, :] + 1)
        match = acceptance_mask(acceptance_uniforms(akeys), q_sel,
                                p_sel) & in_draft
    acc = torch.cumprod(match.to(i32), dim=1) > 0  # accepted prefix
    ok = torch.cat([torch.ones((s, 1), dtype=torch.bool, device=dev), acc],
                   dim=1)  # [S, T]: row 0 is always emitted by a live slot
    cols = torch.arange(t, device=dev)
    ok = ok & (cols[None, :] < (budget - emitted)[:, None]) & ~done[:, None]
    # an emitted EOS is kept; every row after it is dropped
    is_eos = (ok & (cand == eos[:, None])).to(i32)
    emit = ok & ~((torch.cumsum(is_eos, dim=1) - is_eos) > 0)
    n_emit = emit.sum(dim=1, dtype=i32)
    new_emitted = emitted + n_emit
    hit_eos = (emit & (cand == eos[:, None])).any(dim=1)
    new_done = done | hit_eos | (new_emitted >= budget)
    n_write = torch.clamp(n_emit - (new_done & ~done).to(i32), min=0)
    flush_recent(pool, ks, vs, bt, pooled_len, cols[None, :] < n_write[:, None])
    new_len = pooled_len + n_write
    # the carried logits: after the last emitted row (done slots take row
    # 0, scratch until an admission overwrites it)
    last = torch.clamp(n_emit - 1, 0, t - 1).long()
    ar = torch.arange(s, device=dev)
    new_logits = all_logits[ar, last].to(torch.float32)
    n_acc = acc.sum(dim=1, dtype=i32)
    if temperature > 0.0:
        # the prefix ended at a rejected draft (not cut by EOS or budget):
        # the next row-0 draw is the residual max(p - q, 0) there
        rej = torch.clamp(n_acc, 0, spec_len - 1).long()
        p_carry = p[ar, rej]
        if draft_probs is not None:
            q_carry = qf[ar, rej]
        else:
            # one-hot by comparison: F.one_hot reads the ids' range on
            # the host off the card
            vocab = torch.arange(cfg.vocab_size, device=dev)
            q_carry = (vocab[None, :] == drafts[ar, rej][:, None]).to(
                torch.float32)
        resid, mass = residual_logits(p_carry, q_carry, temperature)
        use = (n_acc < n_draft) & (n_emit == n_acc + 1) & (mass > 0.0)
        new_logits = torch.where(use[:, None], held_columns(resid, ex),
                                 new_logits)
    return (new_logits, cand, emit, new_done, new_len, new_emitted, n_acc)


@torch.no_grad()
def prefill_chunk(
    model: GPT,
    pool: PagedKVPool,
    logits: torch.Tensor,  # [S, V] f32
    slot: torch.Tensor,  # [1] int32
    tokens: torch.Tensor,  # [1, T] int32 (right-padded)
    start: torch.Tensor,  # [1] int32 position of chunk token 0
    real_n: torch.Tensor,  # [1] int32 real tokens in the chunk
    bt_row: torch.Tensor,  # [Pmax] int32
    rope_len: int,
    *,
    resumed: bool,  # the shape class: start > 0
    sp: bool = False,  # prefill_sp: the chunk's rows over the tensor axis
) -> None:
    """One prefill chunk (JAX ``_build_prefill_chunk_program``): the
    chunk's forward over the slot's resident pages, the slot's logits row
    from its last real token (after a prompt's last chunk, the logits a
    one-pass prefill leaves), and the page write of its real rows at
    positions ``start .. start+real_n-1`` (in place). ``slot``, ``start``
    and ``real_n`` are the prefill program's device inputs: nothing is
    read back, no shape depends on them. The logits row's index is
    clamped, so ``real_n = 0`` (a program's quiet state) writes no page
    and only that row."""
    h, ks, vs = prefill_chunk_paged(
        model, tokens, start, pool.k, pool.v, bt_row[None], rope_len,
        pool.scale_k, pool.scale_v, resumed=resumed, sp=sp)
    last = (real_n.long() - 1).clamp(0, tokens.shape[1] - 1)
    row = model.project(h.index_select(1, last)[:, 0])
    logits.index_copy_(0, slot.long(), row.to(torch.float32))
    write_token_rows(pool, shardwise(lambda a: a[:, 0], ks),
                     shardwise(lambda a: a[:, 0], vs), bt_row, start, real_n)


# The counters of ServingEngine: each name becomes a property over the
# engine's MetricsRegistry counter of that name (attached after the class
# body), so ``+= 1``, a reset by assignment, stats() and the snapshot all
# reach the same Counter.
_ENGINE_COUNTERS = (
    "decode_dispatches",
    "prefill_dispatches",
    "copy_dispatches",
    "tokens_generated",
    "windows",
    "occupancy_sum",
    "evictions",
    "prompt_tokens_total",
    "prompt_tokens_cached",
    "prefill_tokens_computed",
    "cold_reclaims",
    "spilled_pages",
    "spill_faultback_pages",
    "spill_prefetch_pages",
    "spill_readmissions",
    "spill_discards",
    "verify_dispatches",
    "spec_drafted",
    "spec_accepted",
    "admission_rejected",
    "shed_requests",
    "deferred_submits",
    "livelock_parks",
    "overload_parks",
    "cancelled_requests",
    "deadline_shed_requests",
    "faults_injected",
)


def _counter_property(name: str) -> property:
    def _get(self):
        return self.metrics.counter(name).value

    def _set(self, v):
        self.metrics.counter(name).value = v

    return property(_get, _set,
                    doc=f"the registry's counter {name!r} (MetricsRegistry)")


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (
        a.index is None or b.index is None or a.index == b.index
    )


class ServingEngine:
    """Continuous-batching scheduler over ``slots`` decode lanes.

    ``device`` defaults to the card and raises when there is none; tests
    pass ``device="cpu"``. The model must already live on that device.
    ``cache_dtype`` defaults to the model's dtype. Decode attention goes
    through ``ops.paged_attn.paged_decode_attention``: the CUDA kernel on
    the card, its plain version for CPU tensors.

    ``speculate=N`` (N >= 1) replaces each decode window with one verify
    dispatch of ``N + 1`` candidate rows per slot, through
    ``paged_verify_attention``; ``proposer`` drafts them (an
    :class:`~midgpt_tpu_torch.serving.speculate.NgramProposer` by
    default; a soft proposer, which samples its drafts, only at
    ``temperature > 0``). Each request's draft length adapts to its
    acceptance rate (:meth:`_adapt_spec`).

    ``quant="int8"`` serves the int8 form of ``model``
    (``quant.quantize_model``, made here unless ``model`` is already
    quantized, which serves as it is with ``quant=None`` too);
    ``kv_quant="int8"`` makes the pool int8 with per-(page, KV head)
    scales, whatever ``cache_dtype`` says.

    ``prefix_cache``, ``prefill_chunk``, ``prefill_budget`` and
    ``max_prefills_per_window`` are the JAX engine's knobs with its
    defaults (module docstring), as are the lifecycle's: ``clock`` (the
    time source of submit, first-token and finish times and deadlines),
    ``max_queue`` (None: unbounded) with ``overload_policy`` (``"defer"``
    raises ``PoolOverloaded``, ``"shed"`` ``AdmissionRejected``),
    ``park_threshold`` (the livelock guard), ``priority_aging`` and
    ``fault_hook``.

    ``spill="on"`` (with the prefix cache) keeps cold prefix pages in
    host RAM under pressure instead of dropping them,
    ``spill_budget_pages`` (None: no cap) bounds the pages held there, and
    ``spill_prefetch="on"`` fetches the queue head's spilled chain a step
    ahead of its admission in one batched import. ``telemetry`` (None,
    False, True or an :class:`EngineTelemetry`) turns lifecycle tracing
    on; the metrics registry (``metrics``) is always on.

    ``role`` is ``"both"`` (the monolithic engine), ``"prefill"`` (a
    completed prefill parks its slot handoff-ready for
    :meth:`export_request`; an imported slot decodes as usual) or
    ``"decode"`` (a routing label: the engine is a full one, so an
    eviction re-prefills locally).

    ``mesh`` (a tensor-only ``parallel.mesh.ServingMesh``; JAX's
    ``mesh``) serves under its tensor axis, ``self.tp`` ranks: the
    model's column- and row-parallel shards (``models.gpt.tensor_copy``
    of the full model, after ``quant``; a model already sharded on an
    exchange of the same size and held ranks serves as it is), the pool
    split by whole KV heads (``serving.paged.ShardedKVPool``) and the
    logits vocabulary-sharded, each token through the greedy combiner or
    the gathered row. On a loopback mesh every rank is a shard of this
    process and each dispatch's one program launches every rank's
    kernels; under a group mesh every rank runs this scheduler, and its
    deadline decisions read rank 0's clock, agreed once at the top of
    each step and of each submit (FaultPlan hooks are functions of the
    step alone); telemetry's spans and histograms read this rank's own.
    Checked at construction with JAX's messages
    (``models.gpt.check_serving_tensor``). ``prefill_sp`` ("auto", "on",
    "off"): a prefill chunk's replicated segments on its rows split over
    the ranks (``prefill_chunk_paged(sp=True)``); "auto" is "on" exactly
    when ``tp > 1``, and the resolved value is in every program key, as
    is the mesh's fingerprint. ``tp > 1`` with prefill_sp "on" needs
    ``page_size % tp == 0`` (every chunk's rows split evenly)."""

    def __init__(
        self,
        model: GPT,
        *,
        slots: int = 4,
        page_size: int = 16,
        num_pages: tp.Optional[int] = None,
        window: int = 4,
        temperature: float = 0.0,
        top_k: tp.Optional[int] = None,
        cache_dtype: tp.Optional[torch.dtype] = None,
        seed: int = 0,
        device: tp.Union[None, str, torch.device] = None,
        speculate: int = 0,
        proposer: tp.Optional[Proposer] = None,
        quant: tp.Optional[str] = None,
        kv_quant: tp.Optional[str] = None,
        prefix_cache: bool = True,
        prefill_chunk: tp.Optional[int] = None,
        prefill_budget: tp.Optional[int] = None,
        max_prefills_per_window: tp.Optional[int] = None,
        clock: tp.Callable[[], float] = time.monotonic,
        max_queue: tp.Optional[int] = None,
        overload_policy: str = "defer",
        park_threshold: int = 2,
        priority_aging: float = 0.125,
        fault_hook: tp.Optional[tp.Callable[["ServingEngine"], None]] = None,
        spill: str = "off",
        spill_budget_pages: tp.Optional[int] = None,
        spill_prefetch: str = "on",
        telemetry: tp.Union[None, bool, EngineTelemetry] = None,
        role: str = "both",
        mesh=None,
        prefill_sp: str = "auto",
    ):
        if role not in ("both", "prefill", "decode"):
            raise ValueError(f"unknown role {role!r}")
        if prefill_sp not in ("auto", "on", "off"):
            raise ValueError(f"unknown prefill_sp {prefill_sp!r}")
        self.role = role
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        if mesh is not None and not _same_device(mesh.device, self.device):
            raise ValueError(f"the mesh runs on {mesh.device}, engine device "
                             f"is {self.device}")
        if spill not in ("on", "off"):
            raise ValueError(f"unknown spill mode {spill!r}")
        if spill == "on" and not prefix_cache:
            raise ValueError("spill='on' needs prefix_cache=True: only "
                             "indexed cold pages spill")
        if spill_budget_pages is not None and spill_budget_pages < 0:
            raise ValueError(f"spill_budget_pages must be None or >= 0, "
                             f"got {spill_budget_pages}")
        if spill_prefetch not in ("on", "off"):
            raise ValueError(f"unknown spill_prefetch {spill_prefetch!r}")
        if telemetry is True:
            telemetry = EngineTelemetry()
        elif not telemetry:
            telemetry = None  # False and None both mean tracing off
        if telemetry is not None and not isinstance(telemetry,
                                                     EngineTelemetry):
            raise ValueError(f"telemetry must be None, a bool or an "
                             f"EngineTelemetry, got {telemetry!r}")
        self.telemetry = telemetry
        # the counter attributes are properties over this registry
        self.metrics = MetricsRegistry()
        for name in _ENGINE_COUNTERS:
            self.metrics.counter(name)
        if overload_policy not in ("defer", "shed"):
            raise ValueError(f"unknown overload_policy {overload_policy!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be None or >= 1, got "
                             f"{max_queue}")
        if park_threshold < 1:
            raise ValueError(f"park_threshold must be >= 1, got "
                             f"{park_threshold}")
        if priority_aging < 0.0:
            raise ValueError(f"priority_aging must be >= 0, got "
                             f"{priority_aging}")
        if quant not in (None, "int8"):
            raise ValueError(f"unknown quant mode {quant!r}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}")
        if not _same_device(model.device, self.device):
            raise ValueError(
                f"model lives on {model.device}, engine device is "
                f"{self.device}"
            )
        if slots < 1 or window < 1 or page_size < 1:
            raise ValueError(f"bad geometry {slots=} {window=} {page_size=}")
        for name, knob in (("prefill_chunk", prefill_chunk),
                           ("prefill_budget", prefill_budget),
                           ("max_prefills_per_window",
                            max_prefills_per_window)):
            if knob is not None and knob < 1:
                raise ValueError(f"{name} must be None or >= 1, got {knob}")
        cfg = model.config
        if cfg.block_size % page_size:
            raise ValueError(
                f"page_size {page_size} must divide block_size "
                f"{cfg.block_size}"
            )
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k is not None and top_k < 1:
            raise ValueError(f"top_k must be None or >= 1, got {top_k}")
        if not 0 <= speculate < cfg.block_size:
            raise ValueError(
                f"speculate must be in [0, block_size {cfg.block_size}), "
                f"got {speculate}")
        soft = getattr(proposer, "soft", False)
        if soft and temperature == 0.0:
            raise ValueError(
                "a soft proposer's draft probabilities are read only by "
                "sampled acceptance; greedy speculation takes a plain "
                "proposer")
        self.mesh = mesh
        self.tp = 1
        if mesh is not None:
            check_serving_tensor(cfg, mesh)
            self.tp = mesh.tp
        # the tensor path: a loopback above one rank, or any group (a
        # world of one runs the group's collectives as copies)
        tensor = (mesh.tensor if mesh is not None and (
            mesh.tp > 1 or mesh.tensor.grouped) else None)
        self.prefill_sp = ("on" if prefill_sp in ("on", "auto")
                           and self.tp > 1 else "off")
        if self.prefill_sp == "on" and page_size % self.tp:
            raise ValueError(f"prefill_sp='on' needs page_size {page_size} "
                             f"divisible by tensor={self.tp}: a chunk's "
                             f"rows split over the ranks")
        if tensor is None and model.tensor is not None:
            raise ValueError("a tensor-sharded model needs its mesh=")
        if quant is not None and not is_quantized(model):
            if model.tensor is not None:
                raise ValueError("quant='int8' quantizes a full model: pass "
                                 "the unsharded model (quantize, then cut)")
            model = quantize_model(model)
        if tensor is not None:
            model = tensor_copy(model, tensor)
            if tensor.active != tensor.held:
                raise ValueError("a serving mesh computes every held rank "
                                 "(active == held)")
        self.tensor = tensor
        self.model = model
        self.kv_quant = kv_quant
        self.slots, self.window, self.page_size = slots, window, page_size
        self.temperature, self.top_k = float(temperature), top_k
        self.seed = seed
        self.clock = clock
        # under a group mesh, rank 0's clock reading (:meth:`_agree_clock`)
        self._agreed_now: tp.Optional[float] = None
        self.max_queue = max_queue
        self.overload_policy = overload_policy
        self.park_threshold = park_threshold
        self.priority_aging = priority_aging
        # called at the top of every step(), after fault_step is counted
        self._fault_hook = fault_hook
        self.fault_step = 0
        # the ``handoff`` fault's flag: the next export_request raises
        # HandoffFailed before any state leaves its slot
        self._handoff_poison = False
        self.speculate = int(speculate)
        self.proposer = proposer if proposer is not None or not speculate \
            else NgramProposer()
        self._soft_drafts = bool(self.speculate and soft)
        # tokens a dispatch may write per slot, which page growth provides
        self._grow = self.speculate + 1 if self.speculate else window
        self.block = cfg.block_size
        self.pmax = pages_needed(self.block, page_size)
        if num_pages is None:
            num_pages = slots * self.pmax  # every slot at block_size
        self.alloc = PageAllocator(num_pages)
        self.index = PrefixIndex(page_size) if prefix_cache else None
        self.spill = spill
        self.spill_prefetch = spill_prefetch
        self._spill_store = (HostSpillStore(budget_pages=spill_budget_pages)
                             if spill == "on" else None)
        self.prefill_chunk = prefill_chunk
        # prefill tokens a window may run (the first chunk always runs);
        # None (one-pass prefill) is unlimited
        self.prefill_budget = (prefill_budget if prefill_budget is not None
                               else prefill_chunk)
        self._max_prefills = (max_prefills_per_window
                              if max_prefills_per_window is not None
                              else slots)
        pool_dtype = cache_dtype if cache_dtype is not None else model.dtype
        if tensor is None:
            self.pool = PagedKVPool.init(cfg, num_pages, page_size,
                                         pool_dtype, self.device,
                                         kv_quant=kv_quant)
        else:
            self.pool = ShardedKVPool.init(cfg, num_pages, page_size,
                                           pool_dtype, self.device, tensor,
                                           kv_quant=kv_quant)
        # the held vocabulary shards' columns (the whole row without a
        # tensor axis, and on a loopback holding every rank)
        held_v = (cfg.vocab_size if tensor is None
                  else cfg.vocab_size // tensor.size * len(tensor.held))
        self.logits = torch.zeros(
            (slots, held_v), dtype=torch.float32, device=self.device
        )
        # the stream every dispatch and page copy is queued on; whoever
        # steps the engine from another thread makes it current there
        self.stream = (torch.cuda.current_stream(self.device)
                       if self.device.type == "cuda" else None)
        # the decode window and the verify dispatch by program key (JAX's
        # _cached_program, kept per engine: a program's static tensors
        # name this engine's logits and pool), and on the card the memory
        # pool their CUDA graphs share
        self._programs: tp.Dict[tp.Tuple, Program] = {}
        self._graph_pool = (torch.cuda.graph_pool_handle()
                            if self.device.type == "cuda" else None)
        # the rope tables every body reads (keyed by a tensor's device, as
        # the bodies key them), held for the graphs' lifetime: the table
        # cache may drop them
        self._rope = _rope_table(cfg.head_dim, self.block, cfg.rope_base,
                                 self.logits.device)
        self._sentinel = num_pages
        # host-side slot state
        self.bt = np.full((slots, self.pmax), self._sentinel, np.int32)
        self.pooled_len = np.zeros((slots,), np.int32)
        self.done = np.ones((slots,), bool)  # empty slots ride as done
        self.prefilling = np.zeros((slots,), bool)
        # a prefill-role engine's slot whose prompt is resident, parked
        # for export_request (done stays True: no window carries it)
        self.handoff_ready = np.zeros((slots,), bool)
        self.emitted = np.zeros((slots,), np.int32)
        self.budget = np.zeros((slots,), np.int32)
        self.eos = np.full((slots,), -1, np.int32)
        self.seeds = np.zeros((slots,), np.int64)
        self.slot_pages: tp.List[tp.List[int]] = [[] for _ in range(slots)]
        self.slot_req: tp.List[tp.Optional[Request]] = [None] * slots
        # prompt + emitted tokens per slot: what its pages hold, the
        # proposer's context and the prefix index's keys
        self.slot_ctx: tp.List[tp.List[int]] = [[] for _ in range(slots)]
        # pages of the slot walked for registration (matched pages count),
        # the index node its chain has reached, and the extra references
        # it holds on canonical pages it chains through without owning
        # (register() returned another request's page of equal content)
        self.slot_registered: tp.List[int] = [0] * slots
        self.slot_node: tp.List[int] = [PrefixIndex._ROOT] * slots
        self.slot_pins: tp.List[tp.List[int]] = [[] for _ in range(slots)]
        # round-robin cursor over prefilling slots, kept across windows
        self._prefill_rr = 0
        self.queue: tp.Deque[Request] = collections.deque()
        # evicted by the livelock guard or a lone slot's exhaustion,
        # progress kept, until _unpark
        self.parked: tp.List[Request] = []
        self.finished: tp.Dict[int, Request] = {}
        self.cancelled: tp.Dict[int, Request] = {}
        self.expired: tp.Dict[int, Request] = {}  # shed at their deadline
        # queued, parked or in a slot, by id
        self._live: tp.Dict[int, Request] = {}
        self._next_rid = 0
        self._queue_seq = 0  # fresh submissions' order
        self.reject_reasons: tp.Dict[str, int] = {}
        self.metrics.attach_labels("reject_reasons", self.reject_reasons)
        # live gauges, read when a snapshot is taken
        g = self.metrics.gauge
        g("free_pages", lambda: self.alloc.free_pages)
        g("cached_pages", lambda: self.alloc.cached_pages)
        g("spill_resident_pages",
          lambda: len(self._spill_store)
          if self._spill_store is not None else 0)
        g("spill_resident_bytes",
          lambda: self._spill_store.nbytes
          if self._spill_store is not None else 0)
        g("pool_utilization",
          lambda: 1.0 - self.alloc.free_pages / max(1, self.alloc.num_pages))
        g("queue_depth", lambda: len(self.queue))
        g("parked_requests", lambda: len(self.parked))
        g("active_slots", lambda: len(self._active_slots()))
        g("slot_occupancy",
          lambda: self.occupancy_sum / max(1, self.windows * self.slots))
        g("prefix_hit_rate",
          lambda: self.prompt_tokens_cached
          / max(1, self.prompt_tokens_total))
        g("spec_acceptance_rate",
          lambda: self.spec_accepted / max(1, self.spec_drafted))
        g("tokens_per_dispatch",
          lambda: self.tokens_generated / max(1, self.decode_dispatches))
        # latency histograms: queue delay, TTFT and e2e from the
        # scheduler's own clock reads, always; TBT and dispatch spans need
        # the token timeline, so only under tracing
        for name in ("queue_delay_s", "ttft_s", "e2e_s", "tbt_s",
                     "dispatch_s"):
            self.metrics.histogram(name)

    # -- submission ---------------------------------------------------------

    def _reject(self, reason: str, message: str) -> tp.NoReturn:
        """A typed, counted admission rejection."""
        self.admission_rejected += 1
        self.reject_reasons[reason] = self.reject_reasons.get(reason, 0) + 1
        raise AdmissionRejected(reason, message)

    def submit(self, prompt: np.ndarray, max_new_tokens: int, *,
               eos_id: tp.Optional[int] = None, seed: int = 0,
               priority: int = 0, deadline_s: tp.Optional[float] = None,
               deadline: tp.Optional[float] = None) -> int:
        """Queue a request; returns its id. Prompts are cropped to their
        last ``block_size - max_new_tokens`` tokens so the context fits.

        ``priority``: higher is admitted first. The deadline is
        ``deadline_s`` from now on the engine's clock, or ``deadline`` as
        an absolute instant; a request still queued or parked past it is
        shed. Raises :class:`AdmissionRejected` for a request this engine
        can never serve, and with a full queue (``max_queue``)
        ``AdmissionRejected`` (``overload_policy="shed"``) or
        :class:`PoolOverloaded` (``"defer"``); all are counted."""
        self._agree_clock()
        if max_new_tokens < 1:
            self._reject("bad_budget", f"max_new_tokens {max_new_tokens} < 1")
        if max_new_tokens >= self.block:
            self._reject(
                "budget_exceeds_block",
                f"max_new_tokens {max_new_tokens} must leave room for a "
                f"prompt token in block_size {self.block}")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            self._reject("empty_prompt", "prompt has no tokens")
        keep = self.block - max_new_tokens
        if prompt.size > keep:
            prompt = prompt[-keep:]
        lifetime = pages_needed(prompt.size + max_new_tokens, self.page_size)
        if lifetime > self.alloc.num_pages:
            self._reject(
                "lifetime_exceeds_pool",
                f"request needs {lifetime} pages over its lifetime, the "
                f"pool holds {self.alloc.num_pages}")
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            if self.overload_policy == "shed":
                self.shed_requests += 1
                self._emit("shed", reason="queue_full")
                self._reject("queue_full",
                             f"queue at max_queue={self.max_queue}; shed")
            self.deferred_submits += 1
            self._emit("deferred", reason="queue_full")
            raise PoolOverloaded(
                "queue_full",
                f"queue at max_queue={self.max_queue}; retry later")
        if deadline is None and deadline_s is not None:
            deadline = self._decision_now() + deadline_s
        req = self.make_request(prompt, max_new_tokens, eos_id=eos_id,
                                seed=seed, priority=priority,
                                deadline=deadline)
        # emitted under the id resubmit assigns, so the log reads submit,
        # queued; scheduling fields only when set, and the deadline as a
        # flag (its instant is a clock value)
        extra: tp.Dict[str, tp.Any] = {}
        if priority:
            extra["priority"] = int(priority)
        if deadline is not None:
            extra["has_deadline"] = True
        self._emit("submit", rid=self._next_rid, t=req.submit_time,
                   prompt_tokens=int(req.prompt.size),
                   budget=int(max_new_tokens), **extra)
        return self.resubmit(req)

    def make_request(self, prompt: np.ndarray, max_new_tokens: int, *,
                     eos_id: tp.Optional[int] = None, seed: int = 0,
                     priority: int = 0,
                     deadline: tp.Optional[float] = None) -> Request:
        """A :class:`Request` as :meth:`submit` builds it, crop included,
        without admission control or queueing (``deadline`` absolute)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        keep = self.block - max_new_tokens
        if prompt.size > keep:
            prompt = prompt[-keep:]
        return Request(
            rid=-1, prompt=prompt, prompt0=prompt,
            max_new_tokens=max_new_tokens,
            eos_id=-1 if eos_id is None else int(eos_id), seed=seed,
            submit_time=self.clock(), spec_k=self.speculate,
            priority=int(priority), deadline=deadline)

    def resubmit(self, req: Request) -> int:
        """Queue an already accepted request (one drained off another
        engine, progress kept) under a new id of this engine; returns the
        id. Bypasses the queue bound: this is accepted work, not new
        load."""
        rid = self._next_rid
        self._next_rid += 1
        req.rid = rid
        req.queue_seq = self._queue_seq
        self._queue_seq += 1
        req.queue_step = self.fault_step
        self._live[rid] = req
        self.queue.append(req)
        self._emit("queued", rid=rid, prompt_tokens=int(req.prompt.size),
                   tokens_emitted=len(req.tokens))
        return rid

    def drain_requests(self) -> tp.List[Request]:
        """Hand every live request off this engine: running ones as an
        eviction converts them (``prompt0 + tokens``, budget intact), then
        the queue, then the parked. The engine is left empty; a request
        passed to another engine's :meth:`resubmit` goes on with its
        stream."""
        out: tp.List[Request] = []
        for s in self._active_slots():
            req = self.slot_req[s]
            req.prompt = np.concatenate(
                [req.prompt0, np.asarray(req.tokens, np.int32)])
            self._emit("evicted", rid=req.rid, slot=s, drained=True)
            self._release_slot(s)
            out.append(req)
        out.extend(self.queue)
        self.queue.clear()
        out.extend(self.parked)
        self.parked.clear()
        self._live.clear()
        return out

    @contextlib.contextmanager
    def on_stream(self):
        """Make the engine's device and stream current (both are per
        thread): whoever drives the engine from another thread enters
        this first. A no-op off the card."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.stream.device), \
                torch.cuda.stream(self.stream):
            yield

    # -- page handoff (the disaggregated cluster's seam) ----------------------

    def handoff_ready_slots(self) -> tp.List[int]:
        """Slots whose prompt is resident and parked for export (a
        prefill-role engine's; always empty elsewhere)."""
        return [s for s in range(self.slots) if self.handoff_ready[s]]

    @torch.no_grad()
    def export_request(self, s: int) -> HandoffRecord:
        """Package handoff-ready slot ``s`` for another engine: its pages'
        payloads (and scale planes) and the carried logits row are copied
        to host memory (pinned, queued on the engine's stream, an event
        recorded after them), then the slot releases as at a finish, so
        its indexed pages retire cold and this engine's prefix cache
        keeps serving hits on the chain.

        Raises :class:`HandoffFailed` when a scripted ``handoff`` fault
        is armed, before any state leaves the slot: the request is intact
        and the caller may abandon this copy and serve it again."""
        req = self.slot_req[s]
        if req is None or not self.handoff_ready[s]:
            raise ValueError(f"slot {s} is not handoff-ready")
        if self._handoff_poison:
            self._handoff_poison = False
            raise HandoffFailed(
                f"scripted handoff fault exporting rid {req.rid} "
                f"(slot {s})")
        p = int(self.pooled_len[s])
        n_pages = pages_needed(p, self.page_size)
        k, v, sk, sv = export_pages(self.pool, [int(x) for x in
                                                self.bt[s, :n_pages]])
        row = self.logits[s]
        ready = None
        if row.is_cuda:
            host = torch.empty(row.shape, dtype=row.dtype, pin_memory=True)
            host.copy_(row, non_blocking=True)
            row = host
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        else:
            row = row.clone()
        rec = HandoffRecord(req=req, ctx=list(self.slot_ctx[s]), resident=p,
                            logits_row=row, n_pages=n_pages, k=k, v=v,
                            sk=sk, sv=sv, ready=ready)
        self._emit("handoff", rid=req.rid, slot=s, direction="export",
                   pages=n_pages)
        self._live.pop(req.rid, None)
        self._release_slot(s)
        return rec

    @torch.no_grad()
    def import_request(self, rec: HandoffRecord) -> tp.Optional[int]:
        """Land a :class:`HandoffRecord` in a free slot of this engine and
        return the request's new id here, or None when no slot or no
        pages can be had now (the caller keeps the record and tries
        again). The full-page prefix this engine's index holds is aliased
        (matched as at admission, capped before the last prompt token so
        the append page stays private, and cut at the first host-spilled
        node: the record carries those bytes), only the other pages are
        allocated and written from the payload, the carried logits row is
        set, and the chain is registered in this index. The slot decodes
        from where the source's prefill left it: the same resident
        tokens, logits row and request seed, so the stream is the
        monolithic engine's."""
        free = [s for s in range(self.slots) if self.slot_req[s] is None]
        if not free:
            return None
        s = free[0]
        ctx, p = rec.ctx, rec.resident
        if p != len(ctx) or rec.n_pages != pages_needed(p, self.page_size):
            raise ValueError(f"inconsistent record: {p} resident tokens, "
                             f"{len(ctx)} context, {rec.n_pages} pages")
        req = rec.req
        full: tp.List[int] = []
        if self.index is not None:
            full, _, _ = self.index.match(ctx[: p - 1])
            # spilled nodes (a suffix of the chain) are not faulted back:
            # the record holds their bytes, and _register_pages re-adopts
            # them as at a recomputed admission
            for i, pg in enumerate(full):
                if self.index.is_spilled(pg):
                    full = full[:i]
                    break
        for pg in full:
            self.alloc.incref(pg)
            self.index.revive(pg)
        need = rec.n_pages - len(full)
        if not self._try_reserve(need):
            self._release_pages(full)
            return None
        fresh = self.alloc.alloc(need)
        pages = full + fresh
        if rec.ready is not None:
            # the payload's copies off the source stream end first
            torch.cuda.current_stream(self.device).wait_event(rec.ready)
        # the aliased prefix holds the same bytes already (the content
        # chain's contract): the payload lands on the fresh pages only.
        # The whole (contiguous) payload is queued to the device before it
        # is cut: a pinned view that is not contiguous would be packed by
        # a host memcpy at once, ahead of the export's copies
        n = len(full)
        k, v, sk, sv = (None if a is None else
                        a.to(self.device, non_blocking=True)[:, n:]
                        for a in (rec.k, rec.v, rec.sk, rec.sv))
        import_pages(self.pool, fresh, k, v, sk, sv)
        self.logits[s].copy_(rec.logits_row.to(self.device,
                                                non_blocking=True))
        rid = self._next_rid
        self._next_rid += 1
        req.rid = rid
        self._live[rid] = req
        self.slot_req[s] = req
        self.slot_pages[s] = list(pages)
        self.slot_pins[s] = []
        self.bt[s, :] = self._sentinel
        self.bt[s, : rec.n_pages] = pages
        self.pooled_len[s] = p
        self.done[s] = False
        self.prefilling[s] = False
        self.handoff_ready[s] = False
        self.emitted[s] = len(req.tokens)
        self.budget[s] = req.max_new_tokens
        self.eos[s] = req.eos_id
        self.seeds[s] = req.seed
        self.slot_ctx[s] = [int(x) for x in ctx]
        self.slot_registered[s] = len(full)
        self.slot_node[s] = full[-1] if full else PrefixIndex._ROOT
        self._register_pages(s)
        self._emit("handoff", rid=rid, slot=s, direction="import",
                   pages=rec.n_pages, aliased=len(full), imported=need)
        return rid

    # -- cancel, lookup -------------------------------------------------------

    def cancel(self, rid: int) -> bool:
        """Tear down a live request: a queued or parked one leaves its
        list; a running one (decoding, or between prefill chunks) loses
        its slot now, and its pages release as at a finish (indexed ones
        cold). Returns False for an unknown or already ended id."""
        for i, req in enumerate(self.queue):
            if req.rid == rid:
                del self.queue[i]
                self._cancelled(req, where="queued")
                return True
        for i, req in enumerate(self.parked):
            if req.rid == rid:
                self.parked.pop(i)
                self._cancelled(req, where="parked")
                return True
        for s in self._active_slots():
            req = self.slot_req[s]
            if req.rid == rid:
                self._cancelled(req, where="slot", slot=s)
                self._release_slot(s)
                if self.parked:
                    self._unpark()  # freed pages: parked work retries
                return True
        return False

    def _cancelled(self, req: Request, **data) -> None:
        req.outcome = "cancelled"
        self.cancelled_requests += 1
        self._live.pop(req.rid, None)
        self.cancelled[req.rid] = req
        self._emit("cancelled", rid=req.rid, tokens_emitted=len(req.tokens),
                   **data)

    def _expire(self, req: Request, **data) -> None:
        """Deadline shed: the deadline passed while the request waited."""
        req.outcome = "expired"
        self.deadline_shed_requests += 1
        self._live.pop(req.rid, None)
        self.expired[req.rid] = req
        self._emit("deadline_shed", rid=req.rid,
                   tokens_emitted=len(req.tokens), **data)

    def lookup(self, rid: int) -> tp.Optional[Request]:
        """The request of an id wherever it is (queued, parked, in a slot
        or ended); None for an unknown id."""
        return (self._live.get(rid) or self.finished.get(rid)
                or self.cancelled.get(rid) or self.expired.get(rid))

    # -- scheduling ---------------------------------------------------------

    def _emit(self, kind: str, rid=None, t=None, **data) -> None:
        """One lifecycle event into the telemetry; with tracing off, one
        ``is None`` check (the clock is not read). ``data`` must be
        deterministic under replay: clock readings go only in ``t``."""
        tele = self.telemetry
        if tele is None:
            return
        tele.emit(kind, step=self.fault_step,
                  t=self.clock() if t is None else t, rid=rid, **data)

    def _active_slots(self) -> tp.List[int]:
        return [s for s in range(self.slots) if self.slot_req[s] is not None]

    def _decoding_slots(self) -> tp.List[int]:
        return [s for s in range(self.slots)
                if self.slot_req[s] is not None and not self.prefilling[s]
                and not self.handoff_ready[s]]

    def _prefill_bucket(self, p: int) -> int:
        """Padded chunk length: pages rounded up to a power of two."""
        n = pages_needed(p, self.page_size)
        n = 1 << (n - 1).bit_length()
        return min(n * self.page_size, self.pmax * self.page_size)

    def _try_reserve(self, n: int,
                     protect: tp.Optional[tp.AbstractSet[int]] = None
                     ) -> bool:
        """Make ``n`` pages allocatable, reclaiming cold cached pages, the
        least recently used leaf first; False when even that cannot
        produce them. Held pages are never touched, which is why an
        admission pins its matched chain first.

        With spill on, the same order spills instead: the victim's
        payload goes to the host store, the index re-keys it virtual, and
        then its page id is freed. Past ``spill_budget_pages`` the oldest
        spilled prefixes are forgotten, except the vids in ``protect``,
        which an in-flight fault-back still needs (the store may then
        overshoot until that fault-back pops them)."""
        while not self.alloc.can_alloc(n):
            if self.index is None:
                return False
            if self._spill_store is not None:
                victim = self.index.coldest_leaf()
                if victim is None:
                    return False
                payload = export_pages(self.pool, [victim])
                vid = self.index.spill(victim)
                self._spill_store.put(vid, payload)
                self.alloc.reclaim(victim)
                self.spilled_pages += 1
                while self._spill_store.over_budget:
                    dropped = self.index.discard_spilled_oldest(protect)
                    if dropped is None:
                        # every discardable node is protected: carry the
                        # overshoot, the fault-back pops them shortly
                        if not protect:
                            raise AssertionError(
                                "over budget with nothing discardable")
                        break
                    self._spill_store.pop(dropped)
                    self.spill_discards += 1
            else:
                victim = self.index.evict_cold_leaf()
                if victim is None:
                    return False
                self.alloc.reclaim(victim)
                self.cold_reclaims += 1
        return True

    def _fault_back(self, vid: int,
                    protect: tp.Optional[tp.AbstractSet[int]] = None
                    ) -> tp.Optional[int]:
        """Restore spilled node ``vid`` into a fresh page (``import_pages``,
        byte for byte). Returns the page at refcount 1 (the caller's pin),
        or None when no page can be had even by spilling others, and the
        caller then matches a shorter prefix. ``protect`` must hold ``vid``
        and the chain's other spilled nodes, so this reservation's budget
        pass cannot drop them."""
        if not self._try_reserve(1, protect=protect):
            return None
        [page] = self.alloc.alloc(1)
        k, v, sk, sv = self._spill_store.pop(vid)
        import_pages(self.pool, [page], k, v, sk, sv)
        self.index.unspill(vid, page)
        self.spill_faultback_pages += 1
        return page

    def _fault_back_matched(
            self, full: tp.List[int], cow_src: tp.Optional[int],
            matched: int,
            protect: tp.Optional[tp.AbstractSet[int]] = None,
    ) -> tp.Tuple[tp.List[int], tp.Optional[int], int, tp.Set[int]]:
        """Fault back the spilled nodes a match walked onto: a suffix of
        ``full`` (spilled subtrees are closed downward) and perhaps the COW
        source, a child of its tail, in chain order, each parent resident
        before its child re-keys under it. Returns the match with resident
        page ids, and the pages that already hold their pin (allocated at
        refcount 1). A failed fault-back cuts the match at that node: its
        tokens are recomputed and the stream does not change."""
        prepinned: tp.Set[int] = set()
        if self._spill_store is None:
            return full, cow_src, matched, prepinned
        for i, node in enumerate(full):
            if not self.index.is_spilled(node):
                continue
            page = self._fault_back(node, protect=protect)
            if page is None:
                full = full[:i]
                return full, None, len(full) * self.page_size, prepinned
            full[i] = page
            prepinned.add(page)
        if cow_src is not None and self.index.is_spilled(cow_src):
            page = self._fault_back(cow_src, protect=protect)
            if page is None:
                return full, None, len(full) * self.page_size, prepinned
            cow_src = page
            prepinned.add(page)
        return full, cow_src, matched, prepinned

    # pages a step's prefetch faults back, in one batched import_pages
    _SPILL_PREFETCH_BOUND = 8

    def _spill_prefetch(self) -> None:
        """Prefetch on queue: match the next admission's prompt against the
        index and fault back the spilled nodes of its chain before
        admission, up to ``_SPILL_PREFETCH_BOUND`` in one
        :func:`import_pages` call. They park cold at refcount 0, and the
        admission pins them as resident pages. As in :meth:`_admit`, the
        chain's resident nodes are pinned first (the reservation cannot
        spill a parent from under a child coming back) and its spilled
        vids are protected. A failed reservation leaves it to the
        admission's fault-back."""
        if (self._spill_store is None or self.spill_prefetch != "on"
                or not self.queue or not len(self._spill_store)):
            return
        req = self.queue[self._select_queued()]
        p = int(req.prompt.size)
        full, cow_src, _ = self.index.match(req.prompt[: p - 1])
        cand = list(full) + ([cow_src] if cow_src is not None else [])
        spilled = [pg for pg in cand if self.index.is_spilled(pg)]
        if not spilled:
            return
        # a prefix of the chain-ordered list: parents ahead of children
        vids = spilled[: self._SPILL_PREFETCH_BOUND]
        pinned = [pg for pg in cand if pg not in set(spilled)]
        for pg in pinned:
            self.alloc.incref(pg)
            self.index.revive(pg)
        if not self._try_reserve(len(vids), protect=set(vids)):
            self._release_pages(pinned)
            return
        pages = self.alloc.alloc(len(vids))
        payloads = [self._spill_store.pop(v) for v in vids]
        # stacked on the pool's device, queued behind their spills: the
        # host never reads a payload whose copy may still be running
        dev = self.device
        parts = [torch.cat([pl[j].to(dev, non_blocking=True)
                            for pl in payloads], dim=1)
                 if payloads[0][j] is not None else None for j in range(4)]
        import_pages(self.pool, pages, *parts)
        for vid, page in zip(vids, pages):
            self.index.unspill(vid, page)
        self.spill_faultback_pages += len(pages)
        self.spill_prefetch_pages += len(pages)
        # refcount 0: cold, resident and matchable; the admission pins them
        self._release_pages(pinned + list(pages))

    def _release_pages(self, pages: tp.Iterable[int]) -> None:
        """Drop a request's references: indexed pages retire to the cold
        cache (still matchable), private ones to the free list."""
        for p in pages:
            cached = self.index is not None and p in self.index
            if self.alloc.decref(p, cache=cached) == 0 and cached:
                self.index.touch_cold(p)

    def _shed_expired_queued(self) -> None:
        """Drop every queued request whose deadline has passed, before any
        dispatch; the clock is read only if one carries a deadline."""
        now: tp.Optional[float] = None
        for req in [r for r in self.queue if r.deadline is not None]:
            if now is None:
                now = self._decision_now()
            if now > req.deadline:
                self.queue.remove(req)
                self._expire(req, where="queued")

    def _select_queued(self) -> int:
        """Index of the next request to admit: resumed work (``evictions >
        0``) first, in queue order; then fresh requests by aged priority
        ``priority + priority_aging * steps queued``, first in first out
        within one. Every key is a step or submission count, never the
        clock."""
        best, best_key = 0, None
        for i, req in enumerate(self.queue):
            if req.evictions > 0:
                key: tp.Tuple = (0, i)
            else:
                eff = req.priority + self.priority_aging * (
                    self.fault_step - req.queue_step)
                key = (1, -eff, req.queue_seq)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _admit(self) -> None:
        """Fill free slots, at most ``max_prefills_per_window`` a window,
        with the requests :meth:`_select_queued` picks. The prompt less
        its last token (always recomputed: its forward gives the first
        logits) is matched against the prefix index; the matched chain and
        the copy-on-write source are pinned, then the prompt's pages less
        the matched full ones are reserved. A request that does not fit
        unpins and waits, and so does everything behind it."""
        self._shed_expired_queued()
        admitted = 0
        ps = self.page_size
        for s in range(self.slots):
            if not self.queue or admitted >= self._max_prefills:
                break
            if self.slot_req[s] is not None:
                continue
            qi = self._select_queued()
            req = self.queue[qi]
            p = int(req.prompt.size)
            full: tp.List[int] = []
            cow_src: tp.Optional[int] = None
            matched = 0
            if self.index is not None:
                full, cow_src, matched = self.index.match(req.prompt[: p - 1])
            # spilled nodes (a suffix of the chain, perhaps the COW source)
            # cannot be pinned: they fault back after the resident pins,
            # each into a fresh page that carries its pin
            cand = full + ([cow_src] if cow_src is not None else [])
            spilled_vids = ({pg for pg in cand if self.index.is_spilled(pg)}
                            if self.index is not None else set())
            pinned = [pg for pg in cand if pg not in spilled_vids]
            for pg in pinned:
                self.alloc.incref(pg)
                self.index.revive(pg)
            # the whole demand, a page per spilled node included, before
            # any import: a blocked head of the queue costs no import
            need = pages_needed(p, ps) - len(full)
            if not self._try_reserve(need + len(spilled_vids),
                                     protect=spilled_vids):
                self._release_pages(pinned)
                break  # it waits for pages; no skip-ahead
            if self._spill_store is not None:
                full, cow_src, matched, prepinned = self._fault_back_matched(
                    full, cow_src, matched, protect=spilled_vids)
                pinned.extend(sorted(prepinned))
                # a no-op unless a fault-back cut the match
                need = pages_needed(p, ps) - len(full)
                if not self._try_reserve(need):
                    self._release_pages(pinned)
                    break
            del self.queue[qi]
            fresh = self.alloc.alloc(need)
            pages = full + fresh
            if cow_src is not None:
                # fresh[0] becomes the private copy holding the partial
                # tail of the match
                copy_page(self.pool, cow_src, fresh[0])
                self.copy_dispatches += 1
                self._release_pages([cow_src])
            self.slot_req[s] = req
            self.slot_pages[s] = pages
            self.bt[s, :] = self._sentinel
            self.bt[s, : len(pages)] = pages
            self.pooled_len[s] = matched
            self.done[s] = True  # not decodable until its prefill completes
            self.prefilling[s] = True
            self.emitted[s] = len(req.tokens)
            self.budget[s] = req.max_new_tokens
            self.eos[s] = req.eos_id
            self.seeds[s] = req.seed
            self.slot_ctx[s] = [int(x) for x in req.prompt]
            self.slot_registered[s] = len(full)
            self.slot_node[s] = full[-1] if full else PrefixIndex._ROOT
            self.prompt_tokens_total += p
            self.prompt_tokens_cached += matched
            req.cached_tokens += matched
            req.admit_tokens = len(req.tokens)  # the livelock guard's base
            now = self.clock()
            if not req.tokens and req.evictions == 0:
                # a fresh request's first admission: its wait is the queue
                # delay (a re-admission's is eviction stall)
                self.metrics.histogram("queue_delay_s").observe(
                    now - req.submit_time)
            self._emit("admitted", rid=req.rid, t=now, slot=s,
                       prompt_tokens=p, cached_tokens=matched,
                       pages=len(pages))
            admitted += 1

    def _prefill_one_chunk(self, s: int) -> bool:
        """Run one prefill chunk of slot ``s`` (padded to a power-of-two
        page bucket); True when its prompt is resident and the slot
        decodes from the next window on."""
        req = self.slot_req[s]
        p = int(req.prompt.size)
        start = int(self.pooled_len[s])
        remaining = p - start
        clen = (remaining if self.prefill_chunk is None
                else min(self.prefill_chunk, remaining))
        bucket = self._prefill_bucket(clen)
        toks = np.full((1, bucket), PAD_ID, np.int32)
        toks[0, :clen] = req.prompt[start : start + clen]
        tele = self.telemetry
        t0 = self.clock() if tele is not None else 0.0
        prog = self._prefill_program(bucket, start > 0)
        prog.load(slot=s, start=start, real_n=clen, tokens=toks,
                  bt=self.bt[s])
        prog.run(self._prefill_body(start > 0))
        self.prefill_dispatches += 1
        self.prefill_tokens_computed += clen
        if tele is not None:
            # the span is the host's: the chunk is queued, not waited for
            t1 = self.clock()
            tele.record_dispatch(
                "prefill_chunk", step=self.fault_step, t=t0, dur=t1 - t0,
                rids=(req.rid,), tokens=0, slot=s, start=start, chunk=clen,
                bucket=bucket)
            tele.emit("prefill_chunk", step=self.fault_step, t=t1,
                      rid=req.rid, slot=s, start=start, chunk=clen,
                      bucket=bucket)
        self.pooled_len[s] = start + clen
        self._register_pages(s)
        if start + clen < p:
            return False
        self.prefilling[s] = False
        if self.role == "prefill":
            # parked for the cluster's export (done stays True)
            self.handoff_ready[s] = True
        else:
            self.done[s] = False  # decodable from the next window on
        return True

    def _run_prefills(self) -> None:
        """Sarathi-style chunk scheduling: one chunk per prefilling slot in
        turn until the window's token budget is spent (the first chunk
        always runs). The cursor persists across windows, so a one-chunk
        budget still alternates between prefilling slots."""
        spent = 0
        while True:
            pending = [s for s in range(self.slots) if self.prefilling[s]]
            if not pending:
                return
            pending.sort(key=lambda s: (s - self._prefill_rr) % self.slots)
            for s in pending:
                before = self.prefill_tokens_computed
                self._prefill_one_chunk(s)
                self._prefill_rr = (s + 1) % self.slots
                spent += self.prefill_tokens_computed - before
                if self.prefill_budget is not None and (
                        spent >= self.prefill_budget):
                    return

    def _register_pages(self, s: int) -> None:
        """Index every newly full page of slot ``s`` by its content chain.
        Where another request indexed the same content first, the slot's
        own page stays private (freed at release) and its chain continues
        through the canonical page, which it pins: without that pin a
        cold reclaim could free a page the slot's chain still names."""
        if self.index is None:
            return
        ps = self.page_size
        ctx = self.slot_ctx[s]
        resident = int(self.pooled_len[s])
        while (self.slot_registered[s] + 1) * ps <= resident:
            i = self.slot_registered[s]
            page = int(self.bt[s, i])
            canonical = self.index.register(self.slot_node[s],
                                            ctx[i * ps : (i + 1) * ps], page)
            if canonical != page and self.index.is_spilled(canonical):
                # a spilled prefix recomputed into this page: the page
                # takes the node (same content by its key) and the host
                # payload is dropped, no import needed
                self._spill_store.pop(canonical)
                self.index.unspill(canonical, page)
                self.spill_readmissions += 1
                canonical = page
            if canonical != page:
                self.alloc.incref(canonical)
                self.index.revive(canonical)
                self.slot_pins[s].append(canonical)
            self.slot_node[s] = canonical
            self.slot_registered[s] += 1

    def _ensure_growth(self) -> None:
        """Give every decoding slot pages for the rows its next dispatch
        may write (``window``, or ``speculate + 1`` candidate rows),
        capped at its remaining budget. When the pool cannot, the other
        slot with the fewest tokens is evicted (the cheapest re-prefill),
        until it can; a lone slot that cannot grow parks."""
        for s in self._decoding_slots():
            if self.slot_req[s] is None:
                continue  # evicted for an earlier slot's growth
            remaining = int(self.budget[s]) - int(self.emitted[s])
            tokens = int(self.pooled_len[s]) + min(self._grow, remaining)
            need = min(pages_needed(tokens, self.page_size), self.pmax) - len(
                self.slot_pages[s])
            parked_self = False
            while need > 0 and not self._try_reserve(need):
                others = [v for v in self._active_slots() if v != s]
                if not others:
                    self._evict(s, park=True)
                    parked_self = True
                    break
                self._evict(min(others,
                                key=lambda v: len(self.slot_req[v].tokens)))
            if parked_self or need <= 0:
                continue
            pages = self.alloc.alloc(need)
            start = len(self.slot_pages[s])
            self.slot_pages[s].extend(pages)
            self.bt[s, start : start + need] = pages

    def _release_slot(self, s: int) -> None:
        self._release_pages(self.slot_pages[s])
        self._release_pages(self.slot_pins[s])
        self.slot_pages[s] = []
        self.slot_pins[s] = []
        self.slot_req[s] = None
        self.slot_ctx[s] = []
        self.bt[s, :] = self._sentinel
        self.pooled_len[s] = 0
        self.done[s] = True
        self.prefilling[s] = False
        self.handoff_ready[s] = False
        self.slot_registered[s] = 0
        self.slot_node[s] = PrefixIndex._ROOT

    def _evict(self, s: int, park: bool = False) -> None:
        """Preempt slot ``s`` with its progress kept: its prompt becomes
        ``prompt0 + tokens`` (rebuilt from the original prompt, so a
        second eviction appends nothing twice), its pages retire (indexed
        ones cold, where its re-admission finds them), and it re-queues at
        the front. It parks instead with ``park=True`` (a lone slot that
        cannot grow) or at ``park_threshold`` evictions in a row without a
        token emitted since its admission (the livelock guard)."""
        req = self.slot_req[s]
        progressed = len(req.tokens) > req.admit_tokens
        req.thrash = 0 if progressed else req.thrash + 1
        req.prompt = np.concatenate(
            [req.prompt0, np.asarray(req.tokens, np.int32)])
        # prompt0 holds at most block - max_new_tokens tokens, so the
        # rebuilt prompt fits beside the remaining budget: no crop
        assert req.prompt.size <= self.block - (
            req.max_new_tokens - len(req.tokens))
        req.evictions += 1
        self._emit("evicted", rid=req.rid, slot=s, progressed=bool(progressed),
                   evictions=req.evictions)
        self._release_slot(s)
        self.evictions += 1
        if park:
            self.overload_parks += 1
            self.parked.append(req)
            self._emit("parked", rid=req.rid, reason="overload")
        elif req.thrash >= self.park_threshold:
            self.livelock_parks += 1
            self.parked.append(req)
            self._emit("parked", rid=req.rid, reason="livelock")
        else:
            self.queue.appendleft(req)

    def _unpark(self) -> None:
        """Return every parked request to the queue, where resumed work
        goes first, in park order; one whose deadline has passed is shed
        instead. Aging restarts at the release."""
        now: tp.Optional[float] = None
        while self.parked:
            req = self.parked.pop(0)
            if req.deadline is not None:
                if now is None:
                    now = self._decision_now()
                if now > req.deadline:
                    self._expire(req, where="parked")
                    continue
            self._emit("resumed", rid=req.rid)
            req.queue_step = self.fault_step
            self.queue.append(req)

    def _finish_request(self, req: Request, now: float, s: int) -> None:
        """Retire a finished request: TTFT and e2e go to their histograms
        always (the scheduler holds both times), the TBT gaps only under
        tracing (they need the token timeline)."""
        req.finish_time = now
        req.outcome = "finished"
        self._live.pop(req.rid, None)
        self.finished[req.rid] = req
        if req.first_token_time is not None:
            self.metrics.histogram("ttft_s").observe(
                req.first_token_time - req.submit_time)
        self.metrics.histogram("e2e_s").observe(now - req.submit_time)
        tele = self.telemetry
        if tele is not None:
            ts = tele.token_times(req.rid)
            h = self.metrics.histogram("tbt_s")
            for a, b in zip(ts, ts[1:]):
                h.observe(b - a)
            tele.emit("finished", step=self.fault_step, t=now, rid=req.rid,
                      tokens=len(req.tokens), evictions=req.evictions)
        self._release_slot(s)

    @property
    def has_work(self) -> bool:
        """Queued, parked or running requests remain."""
        return bool(self.queue or self.parked or self._active_slots())

    # -- speculation ----------------------------------------------------------

    def _draft(self, decoding: tp.List[int]):
        """The proposer's drafts for this dispatch: up to ``req.spec_k``
        tokens per slot, and never more than ``remaining - 1`` (row 0
        takes one of the request's remaining tokens). Returns ``(drafts
        [S, N], n_draft [S], probs [S, N, V] or None)``; slots without a
        draft ride with ``n_draft = 0``."""
        drafts = np.zeros((self.slots, self.speculate), np.int32)
        n_draft = np.zeros((self.slots,), np.int32)
        probs = (np.zeros((self.slots, self.speculate,
                           self.model.config.vocab_size), np.float32)
                 if self._soft_drafts else None)
        for s in decoding:
            req = self.slot_req[s]
            remaining = int(self.budget[s]) - int(self.emitted[s])
            k = min(req.spec_k, self.speculate, remaining - 1)
            if k < 1:
                continue
            if probs is not None:
                got, q = self.proposer.propose_soft(self.slot_ctx[s], k,
                                                    req.seed)
                got = list(got)[: self.speculate]
                if got:
                    probs[s, : len(got)] = np.asarray(q, np.float32)[
                        : len(got)]
            else:
                got = list(self.proposer.propose(self.slot_ctx[s], k))[
                    : self.speculate]
            drafts[s, : len(got)] = got
            n_draft[s] = len(got)
        return drafts, n_draft, probs

    def _adapt_spec(self, req: Request, drafted: int, accepted: int) -> None:
        """Per-request draft length: an EWMA of the acceptance rate sizes
        the next draft between 1 and ``speculate``, so a request in
        repetitive text climbs back to the full draft and one in novel
        text decays to a one-token probe."""
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        req.spec_drafted += drafted
        req.spec_accepted += accepted
        if drafted < 1:
            return
        req.spec_rate = 0.5 * req.spec_rate + 0.5 * (accepted / drafted)
        req.spec_k = max(1, min(
            self.speculate,
            int(round(1 + req.spec_rate * (self.speculate - 1)))))

    # -- the one-dispatch programs -------------------------------------------

    def program_key(self, kind: str, bucket: int = 0,
                    resumed: bool = False) -> tp.Tuple:
        """The key of this engine's ``kind`` program ("decode_window",
        "verify" or "prefill_chunk"), modelled on JAX's
        ``_cached_program`` keys: the geometry, the sampling constants the
        body bakes in, the pool's dtype and quantization, whether soft
        drafts come in, and the mesh's fingerprint (``ServingMesh.key``:
        a tp = 2 engine never replays a tp = 1 graph). A prefill chunk's
        is its padded length ``bucket``, its shape class (``resumed``:
        ``start > 0``) and the resolved ``prefill_sp``."""
        mesh = None if self.mesh is None else self.mesh.key()
        if kind == "prefill_chunk":
            return (kind, bucket, resumed, self.pmax, self.block,
                    self.pool.dtype, self.pool.quantized, mesh,
                    self.prefill_sp)
        rows = self.window if kind == "decode_window" else self.speculate
        return (kind, self.slots, rows, self.pmax, self.block, PAD_ID,
                self.temperature, self.top_k, self.seed, self.pool.dtype,
                self.pool.quantized, mesh,
                kind == "verify" and self._soft_drafts)

    def _program(self, kind: str) -> Program:
        """This engine's ``kind`` program, made at its first dispatch: its
        static inputs (the slots' state; a verify dispatch's drafts and
        soft-draft probabilities) and its body over them. Its first
        :meth:`Program.run` on the card captures the CUDA graph."""
        key = self.program_key(kind)
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        s, i32 = self.slots, torch.int32
        fields = [("seeds", (s,), torch.int64), ("bt", (s, self.pmax), i32),
                  ("pooled_len", (s,), i32), ("done", (s,), i32),
                  ("emitted", (s,), i32), ("budget", (s,), i32),
                  ("eos", (s,), i32)]
        probs_shape = None
        if kind == "verify":
            fields += [("drafts", (s, self.speculate), i32),
                       ("n_draft", (s,), i32)]
            if self._soft_drafts:
                probs_shape = (s, self.speculate,
                               self.model.config.vocab_size)
        prog = Program(key, self.device, fields,
                       quiet=lambda x: x["done"].fill_(1),
                       carry=(self.logits,), probs_shape=probs_shape,
                       pool=self._graph_pool)
        self._programs[key] = prog
        return prog

    def _prefill_program(self, bucket: int, resumed: bool) -> Program:
        """The prefill chunk program of ``bucket`` tokens and class
        ``resumed``, made at its first dispatch. Its quiet state is a
        chunk of no real token (no page written), the logits carried."""
        key = self.program_key("prefill_chunk", bucket, resumed)
        prog = self._programs.get(key)
        if prog is None:
            i32 = torch.int32
            prog = Program(
                key, self.device,
                [("slot", (1,), i32), ("start", (1,), i32),
                 ("real_n", (1,), i32), ("tokens", (1, bucket), i32),
                 ("bt", (self.pmax,), i32)],
                quiet=lambda x: x["real_n"].fill_(0),
                carry=(self.logits,), pool=self._graph_pool)
            self._programs[key] = prog
        return prog

    def _prefill_body(self, resumed: bool):
        """The prefill program's body of class ``resumed``:
        :func:`prefill_chunk` on the static inputs."""

        def body(x: tp.Dict[str, torch.Tensor],
                 probs: tp.Optional[torch.Tensor]) -> torch.Tensor:
            prefill_chunk(self.model, self.pool, self.logits, x["slot"],
                          x["tokens"], x["start"], x["real_n"], x["bt"],
                          self.block, resumed=resumed,
                          sp=self.prefill_sp == "on")
            return x["real_n"]

        return body

    def _load(self, prog: Program, **extra) -> None:
        """The slots' host state into ``prog``'s static inputs."""
        prog.load(seeds=self.seeds, bt=self.bt, pooled_len=self.pooled_len,
                  done=self.done, emitted=self.emitted, budget=self.budget,
                  eos=self.eos, **extra)

    def _decode_body(self, x: tp.Dict[str, torch.Tensor],
                     probs: tp.Optional[torch.Tensor]) -> torch.Tensor:
        """The decode window program's body: :func:`decode_window` on the
        static inputs, the carried logits updated in place (JAX donates
        them), the results packed ``[toks, emit, done, new_len,
        emitted]``."""
        logits, toks, emit, done, new_len, emitted = decode_window(
            self.model, self.pool, self.logits, x["bt"], x["pooled_len"],
            x["done"] != 0, x["emitted"], x["budget"], x["eos"], x["seeds"],
            window=self.window, rope_len=self.block,
            temperature=self.temperature, top_k=self.top_k,
            base_seed=self.seed)
        self.logits.copy_(logits)
        i32 = torch.int32
        return torch.cat([toks.reshape(-1), emit.reshape(-1).to(i32),
                          done.to(i32), new_len, emitted])

    def _verify_body(self, x: tp.Dict[str, torch.Tensor],
                     probs: tp.Optional[torch.Tensor]) -> torch.Tensor:
        """The verify program's body, as :meth:`_decode_body`: packed
        ``[cand, emit, done, new_len, emitted, n_acc]``."""
        (logits, cand, emit, done, new_len, emitted,
         n_acc) = verify_dispatch(
            self.model, self.pool, self.logits, x["bt"], x["pooled_len"],
            x["done"] != 0, x["emitted"], x["budget"], x["eos"],
            x["drafts"], x["n_draft"], x["seeds"], rope_len=self.block,
            temperature=self.temperature, top_k=self.top_k,
            base_seed=self.seed, draft_probs=probs)
        self.logits.copy_(logits)
        i32 = torch.int32
        return torch.cat([cand.reshape(-1), emit.reshape(-1).to(i32),
                          done.to(i32), new_len, emitted, n_acc])

    @property
    def graph_captures(self) -> int:
        """Programs whose CUDA graph this engine has captured."""
        return sum(p.graph is not None for p in self._programs.values())

    @property
    def graph_pool_bytes(self) -> int:
        """Bytes held in the memory pool this engine's graphs share (0 off
        the card or before a capture)."""
        if self._graph_pool is None or not self.graph_captures:
            return 0
        return pool_bytes(self._graph_pool)

    def _run_verify(self, decoding: tp.List[int]) -> None:
        """One verify dispatch and its harvest (speculation's stand-in for
        the decode window)."""
        drafts, n_draft, probs = self._draft(decoding)
        t0 = self.clock() if self.telemetry is not None else 0.0
        prog = self._program("verify")
        self._load(prog, drafts=drafts, n_draft=n_draft, probs=probs)
        prog.run(self._verify_body)
        out = prog.read()
        self.verify_dispatches += 1
        s, n = self.slots, self.slots * (self.speculate + 1)
        cand, emit = out[:n].reshape(s, -1), out[n : 2 * n].reshape(s, -1)
        n_acc_h = out[-s:]
        for i in decoding:
            self._adapt_spec(self.slot_req[i], int(n_draft[i]),
                             int(n_acc_h[i]))
        self._harvest(decoding, cand.T, emit.T.astype(bool),
                      out[2 * n : -s], "verify_dispatch", t0,
                      drafted=int(n_draft[decoding].sum()),
                      accepted=int(n_acc_h[decoding].sum()))

    def _harvest(self, decoding, toks_h, emit_h, state_h, kind: str,
                 t0: float, **span) -> None:
        """A dispatch's results, read to the host in one copy: the emitted
        tokens ``toks_h[r, s]`` where ``emit_h[r, s]``, the slot state
        ``state_h`` (done, pooled_len, emitted, ``[3 S]``), and the
        finished requests' release. Under tracing the dispatch's span
        (``kind``, from ``t0`` to this read, with ``span``'s fields) and
        each slot's tokens are recorded."""
        self.decode_dispatches += 1
        self.windows += 1
        self.occupancy_sum += len(decoding)
        # slots outside ``decoding`` (empty, prefilling, or evicted before
        # the dispatch) ride as done and come back as they went
        s = self.slots
        self.done = state_h[:s].astype(bool)
        self.pooled_len = state_h[s : 2 * s].astype(np.int32)
        self.emitted = state_h[2 * s : 3 * s].astype(np.int32)
        now = self.clock()
        tele = self.telemetry
        if tele is not None:
            # stamped at the harvest's read: tracing adds none of its own
            n_window = int(emit_h[:, decoding].sum())
            tele.record_dispatch(
                kind, step=self.fault_step, t=t0, dur=now - t0,
                rids=tuple(self.slot_req[s].rid for s in decoding),
                tokens=n_window, **span)
            self.metrics.histogram("dispatch_s").observe(now - t0)
            tele.emit(kind, step=self.fault_step, t=now,
                      slots=len(decoding), tokens=n_window)
        finished_any = False
        for s in decoding:
            req = self.slot_req[s]
            new = [int(toks_h[r, s]) for r in range(toks_h.shape[0])
                   if emit_h[r, s]]
            if new and req.first_token_time is None:
                req.first_token_time = now
            req.tokens.extend(new)
            self.slot_ctx[s].extend(new)
            self.tokens_generated += len(new)
            # generated tokens fill pages too: indexed, later turns of a
            # conversation hit them
            self._register_pages(s)
            if tele is not None:
                tele.emit("tokens", step=self.fault_step, t=now, rid=req.rid,
                          n=len(new), total=len(req.tokens), slot=s)
            if self.done[s]:
                self._finish_request(req, now, s)
                finished_any = True
        if finished_any and self.parked:
            self._unpark()  # freed pages: parked requests try again

    def step(self) -> bool:
        """One scheduler window; returns True while there is work. A
        ``fault_hook`` may raise its scripted fault, always before any
        dispatch, so the engine stays consistent and drainable."""
        self._agree_clock()
        self.fault_step += 1
        if self.telemetry is not None:
            # the profiler window (profile_steps), at step boundaries
            self.telemetry.maybe_profile(self.fault_step)
        if self._fault_hook is not None:
            self._fault_hook(self)
        if self.parked and not self.queue and not self._active_slots():
            self._unpark()  # nothing else can free pages
        self._spill_prefetch()
        self._admit()
        self._run_prefills()
        decoding = self._decoding_slots()
        if not decoding:
            return self.has_work
        self._ensure_growth()
        decoding = self._decoding_slots()  # growth may have evicted
        if not decoding:
            return True
        if self.speculate:
            self._run_verify(decoding)
            return True
        t0 = self.clock() if self.telemetry is not None else 0.0
        prog = self._program("decode_window")
        self._load(prog)
        prog.run(self._decode_body)
        out = prog.read()
        n = self.window * self.slots
        toks, emit = out[:n].reshape(self.window, -1), out[n : 2 * n]
        self._harvest(decoding, toks, emit.reshape(self.window, -1)
                      .astype(bool), out[2 * n :], "decode_window", t0,
                      window=self.window)
        return True

    def _agree_clock(self) -> None:
        """Under a group mesh: rank 0's clock reading on every rank (one
        broadcast over the host group), for the deadline decisions up to
        the next agreement, so that every rank sheds the same requests."""
        if self.tensor is not None and self.tensor.grouped:
            self._agreed_now = self.mesh.host_broadcast(self.clock())

    def _decision_now(self) -> float:
        """The instant a deadline is set or checked against: the agreed
        reading under a group mesh, else the clock's."""
        return self.clock() if self._agreed_now is None else self._agreed_now

    def warm_prefill(self, max_tokens: int) -> tp.List[int]:
        """Make (on the card: capture) the prefill program of every bucket
        a trace of prompts of up to ``max_tokens`` (suffix) tokens can
        dispatch, in both shape classes (at 0 and resumed), and run each
        once on pad tokens of no real length against an all-sentinel
        block table: no page is written, and the logits are restored, so
        a measured trace holds no capture. Its launches are recorded
        apart, not counted (``ops.launches``). With the cache on,
        admissions prefill suffixes of any length, and chunking caps them
        at ``prefill_chunk``. The engine must be idle. Returns the bucket
        lengths."""
        if self._active_slots():
            raise RuntimeError("warm_prefill needs an idle engine")
        cap = min(max_tokens if self.prefill_chunk is None
                  else min(self.prefill_chunk, max_tokens),
                  self.pmax * self.page_size)
        buckets = sorted({self._prefill_bucket(n) for n in range(1, cap + 1)})
        saved = self.logits.clone()
        row = np.full((self.pmax,), self._sentinel, np.int32)
        with launches.recording():
            for b in buckets:
                for resumed in (False, True):
                    prog = self._prefill_program(b, resumed)
                    prog.load(slot=0, start=int(resumed), real_n=0,
                              tokens=np.full((1, b), PAD_ID, np.int32),
                              bt=row)
                    prog.run(self._prefill_body(resumed))
        self.logits.copy_(saved)
        return buckets

    def clear_prefix_cache(self) -> int:
        """Reclaim every cold cached page and forget every spilled prefix;
        returns how many. Live slots' pages are untouched. A measurement
        calls this after its warm-up, so its hit rate and spill counts
        come from the measured trace alone."""
        n = 0
        if self.index is None:
            return n
        # spilled nodes first: they hang below cold pages, and
        # evict_cold_leaf skips a page with any child
        if self._spill_store is not None:
            while True:
                vid = self.index.discard_spilled_oldest()
                if vid is None:
                    break
                self._spill_store.pop(vid)
                n += 1
        while True:
            victim = self.index.evict_cold_leaf()
            if victim is None:
                break
            self.alloc.reclaim(victim)
            n += 1
        return n

    def run(self, max_windows: int = 100_000) -> tp.Dict[int, Request]:
        """Drive :meth:`step` until queue and slots drain; returns the
        finished requests by id. A profiler window still open when the
        engine drains is closed and written."""
        try:
            for _ in range(max_windows):
                if not self.has_work:
                    return self.finished
                self.step()
            if self.has_work:
                raise RuntimeError(
                    f"engine did not drain in {max_windows} windows")
            return self.finished
        finally:
            if self.telemetry is not None:
                self.telemetry.stop_profiling()

    # -- reporting ----------------------------------------------------------

    def metrics_snapshot(self) -> tp.Dict[str, tp.Any]:
        """The whole registry as JSON-able data: counters, labeled
        families, gauges read now, histograms (:meth:`stats` is a view of
        it)."""
        return self.metrics.snapshot()

    def flight_dump(self, reason: str, path: tp.Optional[str] = None,
                    extra: tp.Optional[tp.Dict[str, tp.Any]] = None
                    ) -> tp.Dict[str, tp.Any]:
        """The flight recorder's record: the event and dispatch rings (with
        tracing on), the registry and the stats, plus ``extra``; written
        as JSON to ``path`` when given (its absolute path goes in the
        record). Reads host state only."""
        rec: tp.Dict[str, tp.Any] = {
            "reason": reason,
            "fault_step": self.fault_step,
            "stats": self.stats(),
            "metrics": self.metrics_snapshot(),
            "telemetry": (self.telemetry.flight_payload()
                          if self.telemetry is not None else None),
        }
        if extra:
            rec.update(extra)
        if path is not None:
            rec["path"] = os.path.abspath(path)
            write_json(path, rec)
        return rec

    def stats(self) -> tp.Dict[str, tp.Any]:
        """A view of the registry with exactly the keys of
        ``ENGINE_STATS_KEYS``, in its order; ``tp`` is the mesh's tensor
        ranks (1 without one) and the spill keys read 0 with spill
        off."""
        store = self._spill_store
        return {
            "tp": self.tp,
            "decode_dispatches": self.decode_dispatches,
            "prefill_dispatches": self.prefill_dispatches,
            "copy_dispatches": self.copy_dispatches,
            "tokens_generated": self.tokens_generated,
            "windows": self.windows,
            "slot_occupancy": round(
                self.occupancy_sum / max(1, self.windows * self.slots), 4),
            "evictions": self.evictions,
            "free_pages": self.alloc.free_pages,
            "cached_pages": self.alloc.cached_pages,
            "cold_reclaims": self.cold_reclaims,
            "spilled_pages": self.spilled_pages,
            "spill_faultback_pages": self.spill_faultback_pages,
            "spill_prefetch_pages": self.spill_prefetch_pages,
            "spill_readmissions": self.spill_readmissions,
            "spill_discards": self.spill_discards,
            "spill_resident_pages": len(store) if store is not None else 0,
            "prompt_tokens_total": self.prompt_tokens_total,
            "prefill_tokens_saved": self.prompt_tokens_cached,
            "prefill_tokens_computed": self.prefill_tokens_computed,
            "prefix_hit_rate": round(
                self.prompt_tokens_cached / max(1, self.prompt_tokens_total),
                4),
            "tokens_per_dispatch": round(
                self.tokens_generated / max(1, self.decode_dispatches), 2),
            "verify_dispatches": self.verify_dispatches,
            "spec_drafted_tokens": self.spec_drafted,
            "spec_accepted_tokens": self.spec_accepted,
            "spec_acceptance_rate": round(
                self.spec_accepted / max(1, self.spec_drafted), 4),
            "admission_rejected": self.admission_rejected,
            "reject_reasons": dict(self.reject_reasons),
            "shed_requests": self.shed_requests,
            "deferred_submits": self.deferred_submits,
            "livelock_parks": self.livelock_parks,
            "overload_parks": self.overload_parks,
            "parked_requests": len(self.parked),
            "cancelled_requests": self.cancelled_requests,
            "deadline_shed_requests": self.deadline_shed_requests,
            "faults_injected": self.faults_injected,
        }


# the counter attributes: data descriptors over the registry's counters
for _name in _ENGINE_COUNTERS:
    setattr(ServingEngine, _name, _counter_property(_name))
del _name
