"""Paged KV pool, its host-side allocator, and the bulk page writes
(counterpart of ``midgpt_tpu.serving.paged``, float pools).

Layout ``[L, num_pages, Hkv, C, page_size]``: time is the minor dim
inside a page, as in the JAX package. Writes happen only at window and
prefill boundaries (:func:`flush_recent`, :func:`write_token_rows`), in
place. JAX scatters every row and lets the out-of-range sentinel page
drop the invalid ones (``mode="drop"``); PyTorch has no such mode, so
here the rows are filtered by their valid mask first and only real rows
are written. No clipped index is ever written to.
"""

from __future__ import annotations

import typing as tp

import torch

from midgpt_tpu_torch.config import ModelConfig


class PagedKVPool:
    """The shared page pool; ``k``/``v`` carry a leading layer axis."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, page_size: int):
        self.k, self.v, self.page_size = k, v, page_size

    @staticmethod
    def init(cfg: ModelConfig, num_pages: int, page_size: int,
             dtype: torch.dtype, device: torch.device) -> "PagedKVPool":
        if num_pages < 1 or page_size < 1:
            raise ValueError(f"bad pool geometry {num_pages=} {page_size=}")
        shape = (cfg.n_layer, num_pages, cfg.kv_heads, cfg.head_dim,
                 page_size)
        return PagedKVPool(
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
            page_size,
        )

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.k.dtype


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


def flush_recent(
    pool: PagedKVPool,
    rk: torch.Tensor,  # [L, S, Hkv, K, C] the window's recent rows
    rv: torch.Tensor,
    bt: torch.Tensor,  # [S, Pmax] int32 block tables
    start_len: torch.Tensor,  # [S] int32 pool-resident tokens at window start
    valid: torch.Tensor,  # [S, K] bool: row j is a real token of slot s
) -> PagedKVPool:
    """Fold a decode window's valid recent rows into their slots' pages,
    in place: row ``j`` of slot ``s`` is position ``start_len[s] + j``."""
    ps = pool.page_size
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
