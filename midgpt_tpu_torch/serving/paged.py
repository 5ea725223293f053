"""Paged KV pool, its host-side allocator, and the bulk page writes
(counterpart of ``midgpt_tpu.serving.paged``).

Layout ``[L, num_pages, Hkv, C, page_size]``: time is the minor dim
inside a page, as in the JAX package. Writes happen only at window and
prefill boundaries (:func:`flush_recent`, :func:`write_token_rows`), in
place. JAX scatters every row and lets the out-of-range sentinel page
drop the invalid ones (``mode="drop"``); PyTorch has no such mode, so
here the rows are filtered by their valid mask first and only real rows
are written. No clipped index is ever written to.

``kv_quant="int8"`` stores the payload int8 with one f32 power-of-two
scale per (page, KV head) (``scale_k`` / ``scale_v``), fixed at page
birth from the page's first row (``midgpt_tpu_torch.quant``'s KV grid).
:func:`kv_row_scales` is the one lookup rule every reader and writer
uses, and :func:`_quantize_rows_at_pages` the one place page-birth scales
are written.
"""

from __future__ import annotations

import typing as tp

import torch

from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.quant import (
    kv_scale_from_absmax,
    quantize_kv_rows,
)


class PagedKVPool:
    """The shared page pool; ``k``/``v`` carry a leading layer axis, and
    an int8 pool its scale planes ``scale_k``/``scale_v`` ``[L, NP, Hkv]``
    f32."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, page_size: int,
                 scale_k: tp.Optional[torch.Tensor] = None,
                 scale_v: tp.Optional[torch.Tensor] = None):
        self.k, self.v, self.page_size = k, v, page_size
        self.scale_k, self.scale_v = scale_k, scale_v

    @staticmethod
    def init(cfg: ModelConfig, num_pages: int, page_size: int,
             dtype: torch.dtype, device: torch.device,
             kv_quant: tp.Optional[str] = None) -> "PagedKVPool":
        """``kv_quant="int8"`` stores int8 pages (``dtype`` is then
        ignored) with scale planes of ones: a page's scale is written by
        its birth row before ``pooled_len`` exposes the page to a read."""
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"bad pool geometry {num_pages=} {page_size=}")
        if kv_quant not in (None, "int8"):
            raise ValueError(f"unknown kv_quant {kv_quant!r}")
        shape = (cfg.n_layer, num_pages, cfg.kv_heads, cfg.head_dim,
                 page_size)
        if kv_quant == "int8":
            dtype = torch.int8
        scales = [None, None]
        if kv_quant == "int8":
            scales = [torch.ones(shape[:3], dtype=torch.float32,
                                 device=device) for _ in range(2)]
        return PagedKVPool(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            page_size, *scales,
        )

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.k.dtype

    @property
    def quantized(self) -> bool:
        return self.scale_k is not None

    @property
    def row_dtype(self) -> torch.dtype:
        """The dtype K/V rows travel in before they land in pages (the
        decode window's recent rows, the verify rows): the pool dtype, or
        bf16 for an int8 pool, whose grid values are exact in bf16."""
        return torch.bfloat16 if self.quantized else self.k.dtype


class PageAllocator:
    """Host-side refcounting allocator over pool page ids.

    A page is in exactly one of three states: **free** (on the free
    list), **held** (refcount >= 1, referenced by live requests) or
    **cached** (refcount 0 but resident, kept for prefix-cache hits until
    reclaimed). Invariants (:meth:`check`): ``free + held + cached ==
    num_pages``, the sets are disjoint, no refcount below one.
    Allocation is LIFO, so freed pages are reused first."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        self._free: tp.List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: tp.Dict[int, int] = {}
        self._cached: tp.Set[int] = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def held_pages(self) -> int:
        return len(self._ref)

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    def refcount(self, p: int) -> int:
        return self._ref.get(p, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> tp.List[int]:
        """Pop ``n`` pages at refcount 1; MemoryError when short."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise MemoryError(
                f"page pool exhausted: want {n}, free {len(self._free)} "
                f"of {self.num_pages}"
            )
        pages = [self._free.pop() for _ in range(n)]
        self._ref.update((p, 1) for p in pages)
        return pages

    def incref(self, p: int) -> None:
        """Share a held page, or revive a cached one to refcount 1."""
        if p in self._cached:
            self._cached.remove(p)
            self._ref[p] = 1
        elif p in self._ref:
            self._ref[p] += 1
        else:
            raise ValueError(f"incref of free page {p}")

    def decref(self, p: int, cache: bool = False) -> int:
        """Drop one reference; at zero the page goes to the cache when
        ``cache`` else to the free list. Returns the new refcount."""
        if p not in self._ref:
            raise ValueError(f"freeing page {p} that is not held")
        self._ref[p] -= 1
        n = self._ref[p]
        if n == 0:
            del self._ref[p]
            if cache:
                self._cached.add(p)
            else:
                self._free.append(p)
        return n

    def free(self, pages: tp.Iterable[int]) -> None:
        for p in pages:
            self.decref(p, cache=False)

    def reclaim(self, p: int) -> None:
        """Cached -> free."""
        if p not in self._cached:
            raise ValueError(f"reclaiming page {p} that is not cached")
        self._cached.remove(p)
        self._free.append(p)

    def check(self) -> None:
        """Raise AssertionError when a structural invariant is broken."""
        free, held = set(self._free), set(self._ref)
        if len(self._free) + len(self._ref) + len(self._cached) != (
            self.num_pages
        ):
            raise AssertionError("free + held + cached != num_pages")
        if len(free) != len(self._free):
            raise AssertionError("free-list duplicate")
        if free & held or free & self._cached or held & self._cached:
            raise AssertionError("a page is in two states")
        if any(n < 1 for n in self._ref.values()):
            raise AssertionError("refcount < 1")


def pages_needed(tokens: int, page_size: int) -> int:
    """ceil(tokens / page_size)."""
    return -(-tokens // page_size)


def kv_row_scales(
    rows_k: torch.Tensor,  # [..., S, Hkv, T, C] contiguous rows
    rows_v: torch.Tensor,
    base: torch.Tensor,  # [S] int32 absolute position of row 0 per slot
    bt: torch.Tensor,  # [S, Pmax] int32 block tables
    scale_k: torch.Tensor,  # [..., NP, Hkv] f32 pool scale planes
    scale_v: torch.Tensor,
    page_size: int,
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The page-grid scale of each row of a contiguous run of K/V rows:
    row ``j`` (position ``base + j``) takes its page's scale, which is (a)
    derived from the page's BIRTH row when that row is in this batch
    (positions fill contiguously, so a page entered at ``pos % PS == 0``
    was entered by a batch row), else (b) the pool's recorded scale.
    Leading dims (layers) of the rows and the planes go along. Returns
    ``(sk, sv)`` ``[..., S, Hkv, T]`` f32.

    A page's scale is thus a pure function of its birth row, and
    derivation is rounding-stable, so rows already rounded through their
    own grid (what every write path sees) re-derive the same scale: int8
    streams do not depend on the window, the verify length or
    speculation."""
    *lead, s, hkv, t, _ = rows_k.shape
    ps = page_size
    pmax = bt.shape[1]
    npool = scale_k.shape[-2]
    pos = base.long()[:, None] + torch.arange(t, device=bt.device)  # [S, T]
    page_idx = pos // ps
    # in-batch birth row of row j's page (negative: born before the batch)
    jb = page_idx * ps - base.long()[:, None]
    in_batch = (jb >= 0)[:, None, :]  # [S, 1, T]
    jb_idx = jb.clamp(0, t - 1)[:, None, :].expand(2, *lead, s, hkv, t)
    pg = torch.gather(bt.long(), 1, page_idx.clamp(0, pmax - 1))
    pg = pg.clamp(0, npool - 1)  # sentinel pads clip like the gather
    # K and V in one pass (the decode step's host path pays per op)
    rows = torch.stack([rows_k, rows_v]).to(torch.float32)
    derived = kv_scale_from_absmax(rows.abs().amax(-1))  # [2, ..., S, Hkv, T]
    from_batch = torch.gather(derived, -1, jb_idx)
    planes = torch.stack([scale_k, scale_v])
    from_pool = planes[..., pg, :].transpose(-1, -2)
    return tuple(torch.where(in_batch, from_batch, from_pool).unbind(0))


def _quantize_rows_at_pages(
    pool: PagedKVPool,
    rk: torch.Tensor,  # [L, S, Hkv, T, C] contiguous rows, slot-batched
    rv: torch.Tensor,
    base: torch.Tensor,  # [S] int32 absolute position of row 0 per slot
    bt: torch.Tensor,  # [S, Pmax] int32 block tables
    valid: torch.Tensor,  # [S, T] bool: row j is a real token of slot s
) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The quantized write shared by :func:`flush_recent` and
    :func:`write_token_rows`: each row's scale from :func:`kv_row_scales`,
    the rows' int8 codes (exact for rows rounded in-dispatch), and, in
    place, the scales of the pages this write gives birth to: valid rows
    at ``pos % PS == 0``, under the same filter as the payload. A
    rejected draft is not valid, so it never sets a scale; the next
    dispatch derives the page's scale from the accepted row. This is THE
    page-birth rule. Returns the codes ``(qk, qv)``."""
    ps = pool.page_size
    sk, sv = kv_row_scales(rk, rv, base, bt, pool.scale_k, pool.scale_v, ps)
    qk, qv = quantize_kv_rows(rk, sk), quantize_kv_rows(rv, sv)
    t = rk.shape[3]
    pos = base.long()[:, None] + torch.arange(t, device=bt.device)  # [S, T]
    s_idx, j_idx = torch.nonzero(valid & (pos % ps == 0), as_tuple=True)
    if s_idx.numel():
        born = bt[s_idx, pos[s_idx, j_idx] // ps].long()
        # [L, S, T, Hkv] indexed at adjacent dims -> [L, N, Hkv]
        pool.scale_k[:, born] = sk.transpose(-1, -2)[:, s_idx, j_idx]
        pool.scale_v[:, born] = sv.transpose(-1, -2)[:, s_idx, j_idx]
    return qk, qv


def flush_recent(
    pool: PagedKVPool,
    rk: torch.Tensor,  # [L, S, Hkv, K, C] the window's recent rows
    rv: torch.Tensor,
    bt: torch.Tensor,  # [S, Pmax] int32 block tables
    start_len: torch.Tensor,  # [S] int32 pool-resident tokens at window start
    valid: torch.Tensor,  # [S, K] bool: row j is a real token of slot s
) -> PagedKVPool:
    """Fold a decode window's valid recent rows into their slots' pages,
    in place: row ``j`` of slot ``s`` is position ``start_len[s] + j``.
    The valid mask is also speculation's write watermark: a rejected
    draft's row never reaches a page."""
    ps = pool.page_size
    if pool.quantized:
        rk, rv = _quantize_rows_at_pages(pool, rk, rv, start_len, bt, valid)
    s_idx, j_idx = torch.nonzero(valid, as_tuple=True)
    pos = start_len[s_idx].long() + j_idx
    page = bt[s_idx, pos // ps].long()
    off = pos % ps
    if s_idx.numel():
        # non-adjacent advanced indices: the [N] row dim leads, so the
        # values arrive [N, L, Hkv, C]
        pool.k[:, page, :, :, off] = rk[:, s_idx, :, j_idx, :].to(pool.dtype)
        pool.v[:, page, :, :, off] = rv[:, s_idx, :, j_idx, :].to(pool.dtype)
    return pool


def write_token_rows(
    pool: PagedKVPool,
    ks: torch.Tensor,  # [L, Hkv, T, C] chunk K from a prefill (post-rope)
    vs: torch.Tensor,  # [L, Hkv, T, C]
    bt_row: torch.Tensor,  # [Pmax] int32 the slot's block table
    start: int,  # absolute position of chunk token 0
    n_valid: int,  # real tokens in the chunk (the rest is pad)
) -> PagedKVPool:
    """Scatter a prefill chunk's first ``n_valid`` K/V rows into the
    slot's pages at positions ``start + j``, in place."""
    ps = pool.page_size
    if pool.quantized:
        t = ks.shape[2]
        dev = bt_row.device
        valid = (torch.arange(t, device=dev) < n_valid)[None]  # [1, T]
        base = torch.full((1,), start, dtype=torch.int32, device=dev)
        qk, qv = _quantize_rows_at_pages(pool, ks[:, None], vs[:, None],
                                         base, bt_row[None], valid)
        ks, vs = qk[:, 0], qv[:, 0]
    pos = start + torch.arange(n_valid, device=ks.device)
    page = bt_row[pos // ps].long()
    off = pos % ps
    pool.k[:, page, :, :, off] = ks[:, :, :n_valid].permute(2, 0, 1, 3).to(
        pool.dtype
    )
    pool.v[:, page, :, :, off] = vs[:, :, :n_valid].permute(2, 0, 1, 3).to(
        pool.dtype
    )
    return pool
