"""Continuous-batching serving engine over a paged KV pool
(counterpart of ``midgpt_tpu.serving.engine``: the monolithic-prefill,
no-prefix-cache slice, with self-speculative decoding).

Every :meth:`ServingEngine.step` is one scheduler window: admit queued
requests into free slots (page allocation for the prompt), prefill each
admitted prompt in one pass (padded to a power-of-two page bucket), top
up every decoding slot's pages for the coming ``window`` tokens, run the
K-step decode window for all slots, then harvest the emitted tokens and
finished requests with one device-to-host read.

The decode window (:func:`decode_window`) carries the same per-slot state
as the JAX program: each step samples a token per slot from the carried
f32 logits, marks slots that hit EOS or their budget done (the token that
reaches the budget is emitted, ``done`` is set after it), runs one decode
step for every slot with finished and empty slots riding along masked,
and at window end flushes the valid prefix of the recent rows into the
pages. The pool is read-only inside the window.

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

Capacity: the pool defaults to the worst case (every slot at
``block_size``). A smaller pool serves every request all the same: a
request is admitted only when the free pages, less those promised to
the running requests, hold its whole reservation (its prompt plus its
budget, capped at ``block_size``); until then it waits at the head of
the queue. So page growth never runs short in the middle of a run.
Eviction, the prefix cache and chunked prefill are not in this slice.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import typing as tp

import numpy as np
import torch

from midgpt_tpu_torch.models.gpt import (
    GPT,
    KVGrid,
    decode_step_paged,
    prefill_chunk_paged,
    verify_tokens_paged,
)
from midgpt_tpu_torch.quant import is_quantized, quantize_model
from midgpt_tpu_torch.sampling import (
    acceptance_key,
    acceptance_mask,
    acceptance_uniforms,
    gumbel_noise,
    request_key,
    residual_logits,
    sample_token,
    target_probs,
)
from midgpt_tpu_torch.serving.paged import (
    PageAllocator,
    PagedKVPool,
    flush_recent,
    pages_needed,
    write_token_rows,
)
from midgpt_tpu_torch.serving.speculate import NgramProposer, Proposer
from midgpt_tpu_torch.utils.platform import resolve_device

PAD_ID = 0  # the token finished and empty slots sample, and prefill pads


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle record."""

    rid: int
    prompt: np.ndarray  # [p] int32, cropped to block_size - max_new_tokens
    max_new_tokens: int
    eos_id: int = -1  # -1 = no EOS (run to max_new_tokens)
    seed: int = 0
    submit_time: float = 0.0
    first_token_time: tp.Optional[float] = None
    finish_time: tp.Optional[float] = None
    tokens: tp.List[int] = dataclasses.field(default_factory=list)
    # speculation: the adaptive draft length (starts at the engine's
    # ``speculate``), its acceptance-rate EWMA, and the request's totals
    spec_k: int = 0
    spec_rate: float = 1.0
    spec_drafted: int = 0
    spec_accepted: int = 0


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
    seeds: tp.Sequence[int],  # per-slot request seeds (host)
    emitted_host: tp.Sequence[int],  # ``emitted`` at window start (host)
    *,
    window: int,
    rope_len: int,
    temperature: float = 0.0,
    top_k: tp.Optional[int] = None,
    base_seed: int = 0,
    paged_kernel: str = "kernel",
):
    """``window`` decode steps for every slot, then the bulk flush.
    Returns ``(logits, toks [K, S], emit [K, S], done, new_len, emitted)``;
    the pool's pages are updated in place. ``paged_kernel="reference"``
    runs the plain attention on any device, to compare with the kernel."""
    cfg = model.config
    s = logits.shape[0]
    rshape = (cfg.n_layer, s, cfg.kv_heads, window, cfg.head_dim)
    rk = torch.zeros(rshape, dtype=pool.row_dtype, device=logits.device)
    rv = torch.zeros_like(rk)
    pad = torch.full((s,), PAD_ID, dtype=torch.int32, device=logits.device)
    if temperature > 0.0:
        # the noise keys of the whole window, one host-to-device copy: a
        # live slot at step r has emitted emitted_host + r tokens (done is
        # monotone within the window)
        keys = torch.tensor(
            [[request_key(base_seed, int(seeds[i]), int(emitted_host[i]) + r)
              for i in range(s)] for r in range(window)],
            dtype=torch.int64,
        ).to(logits.device)
    toks, emits, wvalid = [], [], []
    for r in range(window):
        pre_done = done
        gumbel = None
        if temperature > 0.0:
            gumbel = gumbel_noise(keys[r], cfg.vocab_size)
        tok = sample_token(logits, temperature, top_k, gumbel)
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
    seeds: tp.Sequence[int],  # per-slot request seeds (host)
    emitted_host: tp.Sequence[int],  # ``emitted`` (host)
    *,
    rope_len: int,
    temperature: float = 0.0,
    top_k: tp.Optional[int] = None,
    base_seed: int = 0,
    draft_probs: tp.Optional[torch.Tensor] = None,  # [S, N, V] soft drafts
    paged_kernel: str = "kernel",
):
    """One speculative verify dispatch for every slot. Candidate row 0 is
    the true next token, drawn from the carried logits with the decode
    window's key for that position; rows ``1..N`` are the drafts. Returns
    ``(logits, cand [S, T], emit [S, T], done, new_len, emitted, n_acc)``;
    the pool's pages get the emitted rows' K/V in place, except a
    terminal row (EOS or budget), which no token follows."""
    cfg = model.config
    s, spec_len = drafts.shape
    t = spec_len + 1
    dev = logits.device
    i32 = torch.int32
    pad = torch.full((s,), PAD_ID, dtype=i32, device=dev)
    gumbel = None
    if temperature > 0.0:
        keys = torch.tensor(
            [request_key(base_seed, int(seeds[i]), int(emitted_host[i]))
             for i in range(s)], dtype=torch.int64).to(dev)
        gumbel = gumbel_noise(keys, cfg.vocab_size)
    t0 = torch.where(done, pad, sample_token(logits, temperature, top_k,
                                             gumbel))
    cand = torch.cat([t0[:, None], drafts.to(i32)], dim=1)  # [S, T]
    all_logits, ks, vs = verify_tokens_paged(
        model, cand, pooled_len, pool.k, pool.v, bt, rope_len,
        paged_kernel=paged_kernel, pool_sk=pool.scale_k, pool_sv=pool.scale_v,
    )  # all_logits [S, T, V]; ks/vs [L, S, Hkv, T, C]
    rows = torch.arange(spec_len, device=dev)
    in_draft = rows[None, :] < n_draft[:, None]
    if temperature == 0.0:
        preds = torch.argmax(all_logits, dim=-1).to(i32)
        match = (cand[:, 1:] == preds[:, :-1]) & in_draft
    else:
        # the distribution sample_token draws from after each prefix row
        p = target_probs(all_logits[:, :-1], temperature, top_k)
        p_sel = torch.gather(p, 2, cand[:, 1:, None].long())[..., 0]
        if draft_probs is not None:
            qf = draft_probs.to(torch.float32)
            q_sel = torch.gather(qf, 2, cand[:, 1:, None].long())[..., 0]
        else:  # one-hot n-gram drafts: q(draft) = 1
            q_sel = torch.ones_like(p_sel)
        # one uniform per (request, stream position) from the position's
        # salted key: independent of the categorical draw a rejection
        # then makes at that position
        akeys = torch.tensor(
            [[acceptance_key(base_seed, int(seeds[i]),
                             int(emitted_host[i]) + j + 1)
              for j in range(spec_len)] for i in range(s)],
            dtype=torch.int64).to(dev)
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
            q_carry = torch.nn.functional.one_hot(
                drafts[ar, rej].long(), cfg.vocab_size).to(torch.float32)
        resid, mass = residual_logits(p_carry, q_carry, temperature)
        use = (n_acc < n_draft) & (n_emit == n_acc + 1) & (mass > 0.0)
        new_logits = torch.where(use[:, None], resid, new_logits)
    return (new_logits, cand, emit, new_done, new_len, new_emitted, n_acc)


@torch.no_grad()
def prefill_chunk(
    model: GPT,
    pool: PagedKVPool,
    logits: torch.Tensor,  # [S, V] f32
    slot: int,
    tokens: torch.Tensor,  # [1, T] int32 (right-padded)
    real_n: int,  # real tokens in the prompt
    bt_row: torch.Tensor,  # [Pmax] int32
    rope_len: int,
) -> None:
    """One monolithic prefill pass: the prompt's forward, the slot's
    logits row from its last real token, and the page write of its real
    rows (in place)."""
    grid = None
    if pool.quantized:
        grid = KVGrid(bt_row, pool.scale_k, pool.scale_v, pool.page_size)
    h, ks, vs = prefill_chunk_paged(model, tokens, rope_len, grid)
    logits[slot] = model.project(h[:, real_n - 1])[0].to(torch.float32)
    write_token_rows(pool, ks[:, 0], vs[:, 0], bt_row, 0, real_n)


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
    scales, whatever ``cache_dtype`` says."""

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
    ):
        self.device = resolve_device(device)
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
        if quant is not None and not is_quantized(model):
            model = quantize_model(model)
        self.model = model
        self.kv_quant = kv_quant
        self.slots, self.window, self.page_size = slots, window, page_size
        self.temperature, self.top_k = float(temperature), top_k
        self.seed = seed
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
        self.pool = PagedKVPool.init(
            cfg, num_pages, page_size,
            cache_dtype if cache_dtype is not None else model.dtype,
            self.device, kv_quant=kv_quant,
        )
        self.logits = torch.zeros(
            (slots, cfg.vocab_size), dtype=torch.float32, device=self.device
        )
        self._sentinel = num_pages
        # host-side slot state
        self.bt = np.full((slots, self.pmax), self._sentinel, np.int32)
        self.pooled_len = np.zeros((slots,), np.int32)
        self.done = np.ones((slots,), bool)  # empty slots ride as done
        self.emitted = np.zeros((slots,), np.int32)
        self.budget = np.zeros((slots,), np.int32)
        self.eos = np.full((slots,), -1, np.int32)
        self.seeds = np.zeros((slots,), np.int64)
        self.slot_pages: tp.List[tp.List[int]] = [[] for _ in range(slots)]
        self.slot_req: tp.List[tp.Optional[Request]] = [None] * slots
        # prompt + emitted tokens per slot, the proposer's context
        self.slot_ctx: tp.List[tp.List[int]] = [[] for _ in range(slots)]
        self.queue: tp.Deque[Request] = collections.deque()
        self.finished: tp.Dict[int, Request] = {}
        self._next_rid = 0
        # counters
        self.prefill_dispatches = 0
        self.tokens_generated = 0
        self.decode_dispatches = 0  # windows, or verify dispatches
        self.verify_dispatches = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.occupancy_sum = 0

    # -- submission ---------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int, *,
               eos_id: tp.Optional[int] = None, seed: int = 0) -> int:
        """Queue a request; returns its id. Prompts are cropped to their
        last ``block_size - max_new_tokens`` tokens so the context fits."""
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens {max_new_tokens} < 1")
        if max_new_tokens >= self.block:
            raise ValueError(
                f"max_new_tokens {max_new_tokens} must leave room for a "
                f"prompt token in block_size {self.block}"
            )
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt has no tokens")
        keep = self.block - max_new_tokens
        if prompt.size > keep:
            prompt = prompt[-keep:]
        lifetime = pages_needed(prompt.size + max_new_tokens, self.page_size)
        if lifetime > self.alloc.num_pages:
            raise ValueError(
                f"request needs {lifetime} pages, the pool holds "
                f"{self.alloc.num_pages}"
            )
        req = Request(
            rid=self._next_rid, prompt=prompt, max_new_tokens=max_new_tokens,
            eos_id=-1 if eos_id is None else int(eos_id), seed=seed,
            submit_time=time.monotonic(), spec_k=self.speculate,
        )
        self._next_rid += 1
        self.queue.append(req)
        return req.rid

    # -- scheduling ---------------------------------------------------------

    def _active_slots(self) -> tp.List[int]:
        return [s for s in range(self.slots) if self.slot_req[s] is not None]

    def _prefill_bucket(self, p: int) -> int:
        """Padded prefill length: pages rounded up to a power of two."""
        n = pages_needed(p, self.page_size)
        n = 1 << (n - 1).bit_length()
        return min(n * self.page_size, self.pmax * self.page_size)

    def _reservation(self, req: Request) -> int:
        """Pages a request holds by its end: its prompt and its whole
        budget (at most ``block_size`` tokens)."""
        return min(pages_needed(req.prompt.size + req.max_new_tokens,
                                self.page_size), self.pmax)

    def _promised(self) -> int:
        """Pages the running requests are yet to take of their
        reservations."""
        return sum(self._reservation(self.slot_req[s]) - len(self.slot_pages[s])
                   for s in self._active_slots())

    def _admit(self) -> None:
        """Fill free slots from the head of the queue, in order, while the
        free pages less those promised hold the head's reservation: pages
        for the prompt, then its prefill."""
        for s in range(self.slots):
            if not self.queue:
                break
            if self.slot_req[s] is not None:
                continue
            req = self.queue[0]
            if self.alloc.free_pages - self._promised() < self._reservation(
                    req):
                break  # it waits for a running request's pages
            self.queue.popleft()
            pages = self.alloc.alloc(
                pages_needed(req.prompt.size, self.page_size))
            self.slot_req[s] = req
            self.slot_pages[s] = pages
            self.bt[s, :] = self._sentinel
            self.bt[s, : len(pages)] = pages
            self.emitted[s] = 0
            self.budget[s] = req.max_new_tokens
            self.eos[s] = req.eos_id
            self.seeds[s] = req.seed
            self.slot_ctx[s] = [int(x) for x in req.prompt]
            self._prefill(s, req)

    def _prefill(self, s: int, req: Request) -> None:
        """Prefill slot ``s``'s whole prompt in one padded pass."""
        p = int(req.prompt.size)
        bucket = self._prefill_bucket(p)
        toks = np.full((1, bucket), PAD_ID, np.int32)
        toks[0, :p] = req.prompt
        prefill_chunk(
            self.model, self.pool, self.logits, s,
            torch.from_numpy(toks).to(self.device), p,
            torch.from_numpy(self.bt[s]).to(self.device), self.block,
        )
        self.prefill_dispatches += 1
        self.pooled_len[s] = p
        self.done[s] = False

    def _ensure_growth(self) -> None:
        """Give every decoding slot pages for the rows its next dispatch
        may write (``window``, or ``speculate + 1`` candidate rows),
        capped at its remaining budget."""
        for s in self._active_slots():
            remaining = int(self.budget[s]) - int(self.emitted[s])
            tokens = int(self.pooled_len[s]) + min(self._grow, remaining)
            need = min(pages_needed(tokens, self.page_size), self.pmax) - len(
                self.slot_pages[s]
            )
            if need > 0:  # within the reservation _admit set aside
                pages = self.alloc.alloc(need)
                start = len(self.slot_pages[s])
                self.slot_pages[s].extend(pages)
                self.bt[s, start : start + need] = pages

    def _release_slot(self, s: int) -> None:
        self.alloc.free(self.slot_pages[s])
        self.slot_pages[s] = []
        self.slot_req[s] = None
        self.slot_ctx[s] = []
        self.bt[s, :] = self._sentinel
        self.pooled_len[s] = 0
        self.done[s] = True

    @property
    def windows(self) -> int:
        """Decode windows run: each verify dispatch stands for one."""
        return self.decode_dispatches

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self._active_slots())

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

    def _state(self) -> tp.List[torch.Tensor]:
        """The slots' state on the device: bt, pooled_len, done, emitted,
        budget, eos."""
        return [torch.from_numpy(a).to(self.device) for a in (
            self.bt, self.pooled_len, self.done, self.emitted, self.budget,
            self.eos)]

    def _run_verify(self, decoding: tp.List[int]) -> None:
        """One verify dispatch and its harvest (speculation's stand-in for
        the decode window)."""
        drafts, n_draft, probs = self._draft(decoding)
        dev = self.device
        (self.logits, cand, emit, done_d, new_len, emitted_d,
         n_acc) = verify_dispatch(
            self.model, self.pool, self.logits, *self._state(),
            torch.from_numpy(drafts).to(dev),
            torch.from_numpy(n_draft).to(dev),
            self.seeds.tolist(), self.emitted.tolist(),
            rope_len=self.block, temperature=self.temperature,
            top_k=self.top_k, base_seed=self.seed,
            draft_probs=None if probs is None else
            torch.from_numpy(probs).to(dev),
        )
        self.verify_dispatches += 1
        n_acc_h = n_acc.cpu().numpy()
        for s in decoding:
            self._adapt_spec(self.slot_req[s], int(n_draft[s]),
                             int(n_acc_h[s]))
        self._harvest(decoding, cand.cpu().numpy().T, emit.cpu().numpy().T,
                      done_d, new_len, emitted_d)

    def _harvest(self, decoding, toks_h, emit_h, done_d, new_len,
                 emitted_d) -> None:
        """One device -> host read of a dispatch's results: the emitted
        tokens ``toks_h[r, s]`` where ``emit_h[r, s]``, the slot state,
        and the finished requests' release."""
        self.decode_dispatches += 1
        self.occupancy_sum += len(decoding)
        self.done = done_d.cpu().numpy().copy()
        self.pooled_len = new_len.cpu().numpy().astype(np.int32)
        self.emitted = emitted_d.cpu().numpy().astype(np.int32)
        now = time.monotonic()
        for s in decoding:
            req = self.slot_req[s]
            new = [int(toks_h[r, s]) for r in range(toks_h.shape[0])
                   if emit_h[r, s]]
            if new and req.first_token_time is None:
                req.first_token_time = now
            req.tokens.extend(new)
            self.slot_ctx[s].extend(new)
            self.tokens_generated += len(new)
            if self.done[s]:
                req.finish_time = now
                self.finished[req.rid] = req
                self._release_slot(s)

    def step(self) -> bool:
        """One scheduler window; returns True while there is work."""
        self._admit()
        decoding = self._active_slots()
        if not decoding:
            return self.has_work
        self._ensure_growth()
        if self.speculate:
            self._run_verify(decoding)
            return True
        (self.logits, toks, emit, done_d, new_len, emitted_d) = decode_window(
            self.model, self.pool, self.logits, *self._state(),
            self.seeds.tolist(), self.emitted.tolist(),
            window=self.window, rope_len=self.block,
            temperature=self.temperature, top_k=self.top_k,
            base_seed=self.seed,
        )
        self._harvest(decoding, toks.cpu().numpy(), emit.cpu().numpy(),
                      done_d, new_len, emitted_d)
        return True

    def run(self, max_windows: int = 100_000) -> tp.Dict[int, Request]:
        """Drive :meth:`step` until queue and slots drain; returns the
        finished requests by id."""
        for _ in range(max_windows):
            if not self.has_work:
                return self.finished
            self.step()
        if self.has_work:
            raise RuntimeError(f"engine did not drain in {max_windows} windows")
        return self.finished

    def stats(self) -> tp.Dict[str, float]:
        return {
            "prefill_dispatches": self.prefill_dispatches,
            "tokens_generated": self.tokens_generated,
            "windows": self.windows,
            "slot_occupancy": round(
                self.occupancy_sum / max(1, self.windows * self.slots), 4
            ),
            "free_pages": self.alloc.free_pages,
            "decode_dispatches": self.decode_dispatches,
            "verify_dispatches": self.verify_dispatches,
            "tokens_per_dispatch": round(
                self.tokens_generated / max(1, self.decode_dispatches), 2
            ),
            "spec_drafted_tokens": self.spec_drafted,
            "spec_accepted_tokens": self.spec_accepted,
            "spec_acceptance_rate": round(
                self.spec_accepted / max(1, self.spec_drafted), 4
            ),
        }
