"""Continuous-batching serving engine over a paged KV pool
(counterpart of ``midgpt_tpu.serving.engine``: the monolithic-prefill,
no-prefix-cache, no-speculation slice).

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

Capacity: the pool defaults to the worst case (every slot at
``block_size``), and running out of pages raises; eviction, the prefix
cache, chunked prefill and speculation are not in this slice.
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
    decode_step_paged,
    prefill_chunk_paged,
)
from midgpt_tpu_torch.sampling import gumbel_noise, request_key, sample_token
from midgpt_tpu_torch.serving.paged import (
    PageAllocator,
    PagedKVPool,
    flush_recent,
    pages_needed,
    write_token_rows,
)
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
    rk = torch.zeros(rshape, dtype=pool.dtype, device=logits.device)
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
    h, ks, vs = prefill_chunk_paged(model, tokens, rope_len)
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
    the card, its plain version for CPU tensors."""

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
    ):
        self.device = resolve_device(device)
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
        self.model = model
        self.slots, self.window, self.page_size = slots, window, page_size
        self.temperature, self.top_k = float(temperature), top_k
        self.seed = seed
        self.block = cfg.block_size
        self.pmax = pages_needed(self.block, page_size)
        if num_pages is None:
            num_pages = slots * self.pmax  # every slot at block_size
        self.alloc = PageAllocator(num_pages)
        self.pool = PagedKVPool.init(
            cfg, num_pages, page_size,
            cache_dtype if cache_dtype is not None else model.dtype,
            self.device,
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
        self.queue: tp.Deque[Request] = collections.deque()
        self.finished: tp.Dict[int, Request] = {}
        self._next_rid = 0
        # counters
        self.prefill_dispatches = 0
        self.tokens_generated = 0
        self.windows = 0
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
            submit_time=time.monotonic(),
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

    def _alloc(self, n: int) -> tp.List[int]:
        if not self.alloc.can_alloc(n):
            raise RuntimeError(
                f"page pool exhausted ({n} wanted, {self.alloc.free_pages} "
                f"free): this engine does not evict; raise num_pages"
            )
        return self.alloc.alloc(n)

    def _admit(self) -> None:
        """Fill every free slot from the queue: pages for the prompt, then
        its prefill."""
        for s in range(self.slots):
            if not self.queue:
                break
            if self.slot_req[s] is not None:
                continue
            req = self.queue.popleft()
            pages = self._alloc(pages_needed(req.prompt.size, self.page_size))
            self.slot_req[s] = req
            self.slot_pages[s] = pages
            self.bt[s, :] = self._sentinel
            self.bt[s, : len(pages)] = pages
            self.emitted[s] = 0
            self.budget[s] = req.max_new_tokens
            self.eos[s] = req.eos_id
            self.seeds[s] = req.seed
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
        """Give every decoding slot pages for its next ``window`` tokens,
        capped at its remaining budget."""
        for s in self._active_slots():
            remaining = int(self.budget[s]) - int(self.emitted[s])
            tokens = int(self.pooled_len[s]) + min(self.window, remaining)
            need = min(pages_needed(tokens, self.page_size), self.pmax) - len(
                self.slot_pages[s]
            )
            if need > 0:
                pages = self._alloc(need)
                start = len(self.slot_pages[s])
                self.slot_pages[s].extend(pages)
                self.bt[s, start : start + need] = pages

    def _release_slot(self, s: int) -> None:
        self.alloc.free(self.slot_pages[s])
        self.slot_pages[s] = []
        self.slot_req[s] = None
        self.bt[s, :] = self._sentinel
        self.pooled_len[s] = 0
        self.done[s] = True

    @property
    def has_work(self) -> bool:
        return bool(self.queue or self._active_slots())

    def step(self) -> bool:
        """One scheduler window; returns True while there is work."""
        self._admit()
        decoding = self._active_slots()
        if not decoding:
            return self.has_work
        self._ensure_growth()
        dev = self.device
        (self.logits, toks, emit, done_d, new_len, emitted_d) = decode_window(
            self.model, self.pool, self.logits,
            torch.from_numpy(self.bt).to(dev),
            torch.from_numpy(self.pooled_len).to(dev),
            torch.from_numpy(self.done).to(dev),
            torch.from_numpy(self.emitted).to(dev),
            torch.from_numpy(self.budget).to(dev),
            torch.from_numpy(self.eos).to(dev),
            self.seeds.tolist(), self.emitted.tolist(),
            window=self.window, rope_len=self.block,
            temperature=self.temperature, top_k=self.top_k,
            base_seed=self.seed,
        )
        self.windows += 1
        self.occupancy_sum += len(decoding)
        # one device -> host read per window
        toks_h = toks.cpu().numpy()
        emit_h = emit.cpu().numpy()
        self.done = done_d.cpu().numpy().copy()
        self.pooled_len = new_len.cpu().numpy().astype(np.int32)
        self.emitted = emitted_d.cpu().numpy().astype(np.int32)
        now = time.monotonic()
        for s in decoding:
            req = self.slot_req[s]
            new = [int(toks_h[r, s]) for r in range(self.window)
                   if emit_h[r, s]]
            if new and req.first_token_time is None:
                req.first_token_time = now
            req.tokens.extend(new)
            self.tokens_generated += len(new)
            if self.done[s]:
                req.finish_time = now
                self.finished[req.rid] = req
                self._release_slot(s)
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
            "tokens_per_window": round(
                self.tokens_generated / max(1, self.windows), 2
            ),
        }
