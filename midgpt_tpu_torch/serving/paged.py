"""Paged KV pool, its host-side allocator, the prefix index, and the bulk
page writes (counterpart of ``midgpt_tpu.serving.paged``).

Layout ``[L, num_pages, Hkv, C, page_size]``: time is the minor dim
inside a page, as in the JAX package. Writes happen only at window and
prefill boundaries (:func:`flush_recent`, :func:`write_token_rows`), in
place. JAX scatters every row and lets the out-of-range sentinel page
drop the invalid ones (``mode="drop"``). PyTorch has no such mode, and
the pool keeps no sentinel page, so a write scatters every row too, at a
fixed shape and with no host read (:func:`_scatter_valid`): a row that is
not valid takes the target and the value of the first valid row, so its
write repeats that row's, and with no valid row at all each row rewrites
the value it finds. The serving engine's one-dispatch programs (CUDA
graphs on the card) run these writes.

``kv_quant="int8"`` stores the payload int8 with one f32 power-of-two
scale per (page, KV head) (``scale_k`` / ``scale_v``), fixed at page
birth from the page's first row (``midgpt_tpu_torch.quant``'s KV grid).
:func:`kv_row_scales` is the one lookup rule every reader and writer
uses, and :func:`_quantize_rows_at_pages` the one place page-birth scales
are written.

Under a tensor-only serving mesh the pool splits by whole KV heads (JAX's
``POOL_SPEC_AXES``): a :class:`ShardedKVPool` is one
:class:`PagedKVPool` a held tensor rank, ``[L, NP, Hkv / tp, C, PS]``
each with its scale planes ``[L, NP, Hkv / tp]``. Pages, block tables
and the allocator are shared; every write and copy runs shard by shard
(the rows a write takes are then tuples over the shards), and an export
carries every held rank's heads end to end, ``[L, n, Hkv', C, PS]``. A
shard is a tensor of its own, not a view of a whole pool's heads, which
the paged kernels' addressing would not take.
"""

from __future__ import annotations

import collections
import typing as tp

import torch

from midgpt_tpu_torch.config import ModelConfig
from midgpt_tpu_torch.parallel.tensor import as_shards, shardwise
from midgpt_tpu_torch.quant import (
    kv_scale_from_absmax,
    quantize_kv_rows,
)
from midgpt_tpu_torch.utils.platform import device_scalar


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

    @property
    def shards(self) -> tp.List["PagedKVPool"]:
        """The pools a write runs over: this one."""
        return [self]

    @property
    def kv_heads(self) -> int:
        """KV heads held (over every shard)."""
        return self.k.shape[2]


class ShardedKVPool:
    """A tensor-parallel engine's pool: one :class:`PagedKVPool` a held
    tensor rank (``shards``), split by whole KV heads. ``k``, ``v``,
    ``scale_k`` and ``scale_v`` are tuples over the shards, as the
    model's serving paths take them under a tensor axis; the geometry is
    the shards' (shared)."""

    def __init__(self, shards: tp.Sequence[PagedKVPool]):
        self.shards = list(shards)
        self.page_size = self.shards[0].page_size

    @staticmethod
    def init(cfg: ModelConfig, num_pages: int, page_size: int,
             dtype: torch.dtype, device: torch.device, tensor,
             kv_quant: tp.Optional[str] = None) -> "ShardedKVPool":
        """One pool of ``cfg.kv_heads / tensor.size`` heads for each of
        ``tensor``'s held ranks (``PagedKVPool.init``'s arguments)."""
        import dataclasses

        if cfg.kv_heads % tensor.size:
            raise ValueError(f"tensor={tensor.size} must divide the KV heads "
                             f"{cfg.kv_heads}")
        # a rank's heads, at the model's head dim
        part = dataclasses.replace(
            cfg, n_kv_head=cfg.kv_heads // tensor.size,
            n_head=cfg.n_head // tensor.size,
            n_embd=cfg.n_embd // tensor.size)
        return ShardedKVPool([
            PagedKVPool.init(part, num_pages, page_size, dtype, device,
                             kv_quant) for _ in tensor.held])

    def _each(self, name: str):
        return tuple(getattr(p, name) for p in self.shards)

    k = property(lambda self: self._each("k"))
    v = property(lambda self: self._each("v"))
    scale_k = property(lambda self: self._each("scale_k")
                       if self.quantized else None)
    scale_v = property(lambda self: self._each("scale_v")
                       if self.quantized else None)
    num_pages = property(lambda self: self.shards[0].num_pages)
    dtype = property(lambda self: self.shards[0].dtype)
    quantized = property(lambda self: self.shards[0].quantized)
    row_dtype = property(lambda self: self.shards[0].row_dtype)
    kv_heads = property(lambda self: sum(p.kv_heads for p in self.shards))


def recent_rows(pool, layers: int, slots: int, rows: int,
                head_dim: int, device: torch.device):
    """Zeros for a window's recent rows ``[L, S, Hkv, R, C]`` in the
    pool's row dtype, in ``pool.k``'s form: a tuple over a sharded pool's
    shards, each at its heads."""
    return shardwise(lambda k: torch.zeros(
        (layers, slots, k.shape[2], rows, head_dim), dtype=pool.row_dtype,
        device=device), pool.k)


class PageAllocator:
    """Host-side refcounting allocator over pool page ids.

    A page is in exactly one of three states: **free** (on the free
    list), **held** (refcount >= 1, referenced by live requests) or
    **cached** (refcount 0 but resident, kept for prefix-cache hits until
    reclaimed). A fourth exists only under fault injection (the
    ``exhaust`` event of ``serving.faults``): **quarantined**, taken off
    the free list by :meth:`quarantine` and returned by
    :meth:`release_quarantined`. Invariants (:meth:`check`): ``free +
    held + cached + quarantined == num_pages``, the sets are disjoint, no
    refcount below one. Allocation is LIFO, so freed pages are reused
    first."""

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.num_pages = num_pages
        self._free: tp.List[int] = list(range(num_pages - 1, -1, -1))
        self._ref: tp.Dict[int, int] = {}
        self._cached: tp.Set[int] = set()
        self._quarantined: tp.List[int] = []

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def held_pages(self) -> int:
        return len(self._ref)

    @property
    def cached_pages(self) -> int:
        return len(self._cached)

    @property
    def quarantined_pages(self) -> int:
        return len(self._quarantined)

    def quarantine(self, n: int = -1) -> int:
        """Take up to ``n`` free pages (-1 = all) out of circulation; held
        and cached pages are untouched, so only new allocation feels it.
        Returns the count quarantined."""
        if n < 0:
            n = len(self._free)
        n = min(n, len(self._free))
        for _ in range(n):
            self._quarantined.append(self._free.pop())
        return n

    def release_quarantined(self) -> int:
        """Return every quarantined page to the free list; returns how
        many."""
        n = len(self._quarantined)
        self._free.extend(self._quarantined)
        self._quarantined.clear()
        return n

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
        quarantined = set(self._quarantined)
        if len(self._free) + len(self._ref) + len(self._cached) + len(
                self._quarantined) != self.num_pages:
            raise AssertionError(
                "free + held + cached + quarantined != num_pages")
        if len(free) != len(self._free):
            raise AssertionError("free-list duplicate")
        if len(quarantined) != len(self._quarantined):
            raise AssertionError("quarantine duplicate")
        if free & held or free & self._cached or held & self._cached or (
                quarantined & (free | held | self._cached)):
            raise AssertionError("a page is in two states")
        if any(n < 1 for n in self._ref.values()):
            raise AssertionError("refcount < 1")


class PrefixIndex:
    """Host-side page-granular prefix index: resident KV pages looked up
    by the token prefix they hold (counterpart of JAX
    ``serving/paged.py`` ``PrefixIndex``).

    The page holding positions ``[i PS, (i + 1) PS)`` is keyed by
    ``(parent_page, chunk)``: its PS tokens and the indexed page of the
    chunk before it (-1 at the root). KV at a position depends on the
    whole prefix before it, which the parent link encodes, so two pages
    with one key are interchangeable. Only full pages are indexed; pages
    are append-only, so an indexed page never changes and may be aliased
    into any block table.

    Refcounts live in :class:`PageAllocator`; the index keeps the
    content -> page map, the parent/children tree and an LRU order over
    COLD pages (refcount 0, kept resident until pages run short).
    Eviction is leaf-first: a page is reclaimable only when no indexed
    child chains through it. A held page's ancestors are held (a match
    shares whole chains from the root), so cold subtrees are closed
    downward and a reclaimable leaf exists while any cold page does.

    Host spill (``ServingEngine(spill="on")``): a cold page may move to
    host RAM under a VIRTUAL id (-2, -3, ... in spill order; the root is
    -1, pages are >= 0). The node keeps its ``(parent, chunk)`` identity,
    so :meth:`match` walks onto and through it, and the engine faults it
    back into a fresh page before use. Spill goes deepest first (a page
    is eligible once every child is spilled), so spilled subtrees are
    closed downward: a resident page never chains under a virtual id."""

    _ROOT = -1

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self._by_key: tp.Dict[tp.Tuple[int, tp.Tuple[int, ...]], int] = {}
        self._meta: tp.Dict[int, tp.Tuple[int, tp.Tuple[int, ...]]] = {}
        self._children: tp.Dict[int, tp.Set[int]] = {}
        # cold pages, least recently used first; values unused
        self._lru: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict())
        # spilled nodes by virtual id, oldest first (the discard order
        # under a host budget); values unused
        self._spilled: "collections.OrderedDict[int, None]" = (
            collections.OrderedDict())
        self._next_spill = -2

    def __len__(self) -> int:
        return len(self._meta)

    def __contains__(self, page: int) -> bool:
        return page in self._meta

    @property
    def cold_pages(self) -> int:
        return len(self._lru)

    def lookup(self, parent: int,
               chunk: tp.Sequence[int]) -> tp.Optional[int]:
        """The indexed page for ``chunk`` under ``parent`` (-1 = root), or
        None."""
        return self._by_key.get((parent, tuple(int(t) for t in chunk)))

    def match(self, tokens: tp.Sequence[int]
              ) -> tp.Tuple[tp.List[int], tp.Optional[int], int]:
        """The longest cached prefix of ``tokens``: ``(full_pages, cow_src,
        matched)``, the chain of wholly matched pages, a page whose chunk
        extends the partial tail left over (the copy-on-write source),
        and the tokens matched. The engine passes the prompt less its
        last token, which it always recomputes."""
        ps = self.page_size
        toks = [int(t) for t in tokens]
        full: tp.List[int] = []
        parent = self._ROOT
        i = 0
        while i + ps <= len(toks):
            page = self._by_key.get((parent, tuple(toks[i : i + ps])))
            if page is None:
                break
            full.append(page)
            parent = page
            i += ps
        rem = tuple(toks[i:])  # shorter than a page after the walk stops
        cow = None
        if rem:
            for child in self._children.get(parent, ()):
                if self._meta[child][1][: len(rem)] == rem:
                    cow = child
                    break
        return full, cow, i + (len(rem) if cow is not None else 0)

    def register(self, parent: int, chunk: tp.Sequence[int],
                 page: int) -> int:
        """Index ``page`` as holding ``chunk`` under ``parent``. Returns
        the CANONICAL page of that content: ``page``, or the page indexed
        first when another request registered the same content (the
        duplicate stays private; the caller chains through the canonical
        one)."""
        key = (parent, tuple(int(t) for t in chunk))
        existing = self._by_key.get(key)
        if existing is not None:
            return existing
        if page in self._meta:
            raise ValueError(f"page {page} indexed twice")
        self._by_key[key] = page
        self._meta[page] = key
        self._children.setdefault(parent, set()).add(page)
        return page

    def touch_cold(self, page: int) -> None:
        """Mark an indexed page cold (its refcount reached 0), the most
        recently used."""
        if page not in self._meta:
            raise ValueError(f"page {page} is not indexed")
        self._lru[page] = None
        self._lru.move_to_end(page)

    def revive(self, page: int) -> None:
        """A cold page was hit (refcount 0 -> 1): it leaves the LRU."""
        self._lru.pop(page, None)

    def evict_cold_leaf(self) -> tp.Optional[int]:
        """Drop the least recently used cold page that no indexed child
        chains through; returns it (the caller reclaims it in the
        allocator), or None when no cold page is reclaimable."""
        for page in self._lru:
            if not self._children.get(page):
                self._drop(page)
                return page
        return None

    # -- host spill ---------------------------------------------------------

    @property
    def spilled_count(self) -> int:
        return len(self._spilled)

    def is_spilled(self, node: int) -> bool:
        """True for a spilled node's virtual id (:meth:`match` can return
        them as a suffix of its chain, or as the COW source)."""
        return node in self._spilled

    def coldest_leaf(self) -> tp.Optional[int]:
        """The least recently used cold page with no resident child: the
        next spill victim, returned without dropping it (its payload is
        exported while the index still maps it). Spilled children do not
        block it, so a victim exists while any cold page does."""
        for page in self._lru:
            kids = self._children.get(page)
            if not kids or all(k in self._spilled for k in kids):
                return page
        return None

    def _rekey(self, old: int, new: int) -> None:
        """Move a node from id ``old`` to ``new`` with its ``(parent,
        chunk)`` identity, its place under its parent and its children,
        whose keys name the parent id and move with it."""
        parent, chunk = self._meta.pop(old)
        self._by_key[(parent, chunk)] = new
        self._meta[new] = (parent, chunk)
        siblings = self._children.get(parent)
        if siblings is not None:
            siblings.discard(old)
            siblings.add(new)
        kids = self._children.pop(old, None)
        if kids:
            self._children[new] = kids
            for c in kids:
                _, cchunk = self._meta[c]
                del self._by_key[(old, cchunk)]
                self._by_key[(new, cchunk)] = c
                self._meta[c] = (new, cchunk)

    def spill(self, page: int) -> int:
        """Re-key cold ``page`` to a fresh virtual id and return it: the
        node stays matchable, the page id detaches (the caller reclaims
        it and stores the exported payload under the returned id). Only
        a page whose children are all spilled may spill
        (:meth:`coldest_leaf`)."""
        if page not in self._meta or page not in self._lru:
            raise ValueError(f"page {page} is not a cold indexed page")
        kids = self._children.get(page)
        if kids and not all(k in self._spilled for k in kids):
            raise ValueError(f"spilling page {page} with resident children")
        vid = self._next_spill
        self._next_spill -= 1
        self._rekey(page, vid)
        self._lru.pop(page)
        self._spilled[vid] = None
        return vid

    def unspill(self, vid: int, page: int) -> None:
        """Fault-back: spilled node ``vid`` becomes resident ``page``
        (freshly allocated, its payload imported). Spilled children
        re-key under ``page`` with it."""
        if vid not in self._spilled:
            raise ValueError(f"node {vid} is not spilled")
        if page < 0 or page in self._meta:
            raise ValueError(f"page {page} cannot take a spilled node")
        self._rekey(vid, page)
        del self._spilled[vid]

    def discard_spilled_oldest(
            self, protect: tp.Optional[tp.AbstractSet[int]] = None
    ) -> tp.Optional[int]:
        """Forget the oldest spilled node without spilled children (host
        budget overflow, or a cache clear); returns its virtual id, whose
        payload the caller drops, or None when none is discardable.
        ``protect`` exempts the vids an in-flight fault-back still needs."""
        for vid in self._spilled:
            if self._children.get(vid):
                continue
            if protect is not None and vid in protect:
                continue
            parent, chunk = self._meta.pop(vid)
            del self._by_key[(parent, chunk)]
            self._children.get(parent, set()).discard(vid)
            self._children.pop(vid, None)
            del self._spilled[vid]
            return vid
        return None

    def _drop(self, page: int) -> None:
        parent, chunk = self._meta.pop(page)
        del self._by_key[(parent, chunk)]
        self._children.get(parent, set()).discard(page)
        self._children.pop(page, None)
        self._lru.pop(page, None)

    def check(self, alloc: tp.Optional["PageAllocator"] = None,
              spill_store: tp.Optional["HostSpillStore"] = None) -> None:
        """Raise AssertionError when a structural invariant is broken;
        with ``alloc``, also when an indexed resident page is free or a
        cold page is referenced. Spilled nodes have virtual ids, are never
        in the cold LRU, and their subtrees are closed downward; with
        ``spill_store`` the store holds exactly the spilled nodes, so
        resident indexed nodes plus spilled ones are all indexed nodes,
        and the two sets are disjoint."""
        if len(self._by_key) != len(self._meta):
            raise AssertionError("key map and page map differ in size")
        for page, (parent, chunk) in self._meta.items():
            if self._by_key.get((parent, chunk)) != page:
                raise AssertionError(f"page {page} is not under its key")
            if parent != self._ROOT and (
                    parent not in self._meta
                    or page not in self._children.get(parent, ())):
                raise AssertionError(
                    f"page {page} chains through unindexed parent {parent}")
        if any(page not in self._meta for page in self._lru):
            raise AssertionError("an unindexed page is in the cold LRU")
        if any(page < 0 for page in self._lru):
            raise AssertionError("a virtual node is in the cold LRU")
        for vid in self._spilled:
            if vid > -2 or vid not in self._meta:
                raise AssertionError(f"bad spilled node {vid}")
            if not all(c in self._spilled
                       for c in self._children.get(vid, ())):
                raise AssertionError(
                    f"spilled node {vid} has resident children")
        if alloc is not None:
            for page in self._meta:
                if page in self._spilled:
                    continue
                if page < 0:
                    raise AssertionError(
                        f"node {page} is neither a page nor spilled")
                if alloc.refcount(page) == 0 and page not in alloc._cached:
                    raise AssertionError(f"indexed page {page} is free")
            for page in self._lru:
                if alloc.refcount(page) != 0:
                    raise AssertionError(
                        f"cold page {page} is still referenced")
        if spill_store is not None and (
                set(self._spilled) != set(spill_store.nodes())):
            raise AssertionError(
                "the spill store and the index disagree on spilled nodes")


def copy_page(pool: PagedKVPool, src: int, dst: int) -> PagedKVPool:
    """Copy page ``src``'s K/V, every layer, into page ``dst``, in place:
    the copy-on-write step that gives an admission a private page to
    append into after a partial match of a cached page. An int8 pool's
    scale rows go with the codes: a page and its scales are one unit, and
    codes under a stale scale would decode to other values, silently.
    The copy also inherits the source's scale for the rows appended to
    it, as the page-birth rule wants (it shares the source's birth row).
    Every shard's heads."""
    for p in pool.shards:
        p.k[:, dst] = p.k[:, src]
        p.v[:, dst] = p.v[:, src]
        if p.quantized:
            p.scale_k[:, dst] = p.scale_k[:, src]
            p.scale_v[:, dst] = p.scale_v[:, src]
    return pool


class HostSpillStore:
    """Host-RAM payloads of spilled cold pages (``ServingEngine(
    spill="on")``): one :func:`export_pages` single-page payload ``(k, v,
    sk, sv)`` per spilled prefix-index node, keyed by its virtual id
    (:meth:`PrefixIndex.spill`). :func:`import_pages` puts a payload back
    byte for byte.

    ``budget_pages`` caps the pages held; past it the engine discards the
    oldest spilled prefixes (None: no cap). ``nbytes`` is a running count
    kept by :meth:`put` and :meth:`pop`."""

    def __init__(self, budget_pages: tp.Optional[int] = None):
        if budget_pages is not None and budget_pages < 0:
            raise ValueError(f"budget_pages must be None or >= 0, got "
                             f"{budget_pages}")
        self.budget_pages = budget_pages
        self._store: tp.Dict[int, tp.Tuple] = {}
        self._nbytes = 0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, node: int) -> bool:
        return node in self._store

    def nodes(self) -> tp.Iterable[int]:
        return self._store.keys()

    @staticmethod
    def _payload_nbytes(payload: tp.Tuple) -> int:
        return sum(a.nbytes for a in payload if a is not None)

    def put(self, node: int, payload: tp.Tuple) -> None:
        if node in self._store:
            raise ValueError(f"node {node} spilled twice")
        self._store[node] = payload
        self._nbytes += self._payload_nbytes(payload)

    def pop(self, node: int) -> tp.Tuple:
        payload = self._store.pop(node)
        self._nbytes -= self._payload_nbytes(payload)
        return payload

    @property
    def over_budget(self) -> bool:
        return (self.budget_pages is not None
                and len(self._store) > self.budget_pages)

    @property
    def nbytes(self) -> int:
        """Host bytes held: payloads and scale planes."""
        return int(self._nbytes)


def _page_index(page_ids: tp.Sequence[int], device) -> torch.Tensor:
    """Page ids as a long tensor on ``device``, copied without waiting for
    the stream."""
    return torch.tensor(list(page_ids), dtype=torch.long).to(
        device, non_blocking=True)


def export_pages(pool: PagedKVPool, page_ids: tp.Sequence[int]
                 ) -> tp.Tuple[torch.Tensor, torch.Tensor,
                               tp.Optional[torch.Tensor],
                               tp.Optional[torch.Tensor]]:
    """Copy ``n`` pages out of the pool to host memory: ``(k, v, sk, sv)``
    with ``k``/``v`` ``[L, n, Hkv, C, PS]`` in the pool dtype and, for an
    int8 pool, ``sk``/``sv`` its ``[L, n, Hkv]`` f32 scale planes (None
    for a float pool). A page and its scales travel together: codes under
    another page's scale would decode to other values, silently. The pages
    are copied, not moved.

    On the card the payload lands in pinned host memory through copies
    queued on the current stream (the engine's), which return before the
    copy ends: a later write to a recycled page id is queued behind it,
    and :func:`import_pages` of the payload on the same stream reads it
    after it. Reading the payload on the host needs the stream
    synchronized first. PyTorch's pinned allocator keeps a payload's
    memory from reuse until its copy is done.

    A :class:`ShardedKVPool`'s payload carries every shard's heads end to
    end along the heads (dim 2), gathered on the device before the one
    copy out."""
    shards = pool.shards
    ids = _page_index(page_ids, shards[0].k.device)
    names = ["k", "v"] + (["scale_k", "scale_v"] if pool.quantized else [])
    out: tp.List[tp.Optional[torch.Tensor]] = []
    for name in names:
        parts = [getattr(p, name).index_select(1, ids) for p in shards]
        rows = parts[0] if len(parts) == 1 else torch.cat(parts, 2)
        if rows.is_cuda:
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            host.copy_(rows, non_blocking=True)
            rows = host
        out.append(rows)
    if not pool.quantized:
        out += [None, None]
    return tuple(out)


def import_pages(pool: PagedKVPool, page_ids: tp.Sequence[int],
                 k: torch.Tensor, v: torch.Tensor,
                 sk: tp.Optional[torch.Tensor] = None,
                 sv: tp.Optional[torch.Tensor] = None) -> PagedKVPool:
    """Write :func:`export_pages` payloads into ``pool`` at ``page_ids``,
    in place: its exact inverse, with no arithmetic on the values, so
    the pages read back bit for bit. An int8 pool takes the scale planes
    with the payload, both or neither. The payload may be on the host
    (pinned and contiguous: the copy to the card is queued on the current
    stream) or already on the pool's device. Raises on a shape, dtype or
    missing scale plane, and on a host payload for the card that is not
    contiguous. A :class:`ShardedKVPool` takes every shard's heads end to
    end (its export's layout), split on the device."""
    n = len(page_ids)
    shards = pool.shards
    first = shards[0]
    want = (first.k.shape[0], n, pool.kv_heads) + tuple(first.k.shape[3:])
    for name, a in (("k", k), ("v", v)):
        if tuple(a.shape) != want or a.dtype != pool.dtype:
            raise ValueError(f"{name} payload {tuple(a.shape)} {a.dtype} "
                             f"does not fit {want} {pool.dtype}")
    planes = [("k", k), ("v", v)]
    if pool.quantized:
        if sk is None or sv is None:
            raise ValueError("an int8 pool's import needs its scale planes: "
                             "a page and its scales are one unit")
        for name, a in (("sk", sk), ("sv", sv)):
            if tuple(a.shape) != want[:3] or a.dtype != torch.float32:
                raise ValueError(f"{name} plane {tuple(a.shape)} {a.dtype} "
                                 f"does not fit {want[:3]} f32")
        planes += [("scale_k", sk), ("scale_v", sv)]
    elif sk is not None or sv is not None:
        raise ValueError("scale planes given for a float pool")
    dev = first.k.device
    for _, a in planes:
        # a host view that is not contiguous is packed by a host memcpy
        # when it is copied over, not queued: it would read pinned memory
        # ahead of the copies that fill it
        if dev.type == "cuda" and not a.is_cuda and not a.is_contiguous():
            raise ValueError("a host payload must be contiguous: cut it on "
                             "the device")
    ids = _page_index(page_ids, dev)
    heads = [p.kv_heads for p in shards]
    for name, a in planes:
        parts = a.to(dev, non_blocking=True).split(heads, 2)
        for p, part in zip(shards, parts):
            getattr(p, name).index_copy_(1, ids, part)
    return pool


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


def _scatter_valid(dst: torch.Tensor, index, rows: torch.Tensor,
                   valid: torch.Tensor, row_dim: int) -> None:
    """``dst[index(n)] = rows[n]`` for the rows ``n`` where ``valid``, in
    place, as one scatter of every row: no host read and no shape that
    depends on the data. ``index(pick)`` gives the advanced index of the
    rows ``pick`` (``[N]`` long), and the selection ``dst[index(pick)]``
    holds them along ``row_dim``, as ``rows`` does. A row that is not
    valid takes the target and the value of the first valid row (a
    repeated write of equal values, so no order among duplicates
    matters); with no valid row every row takes row 0's target (clipped
    into the pool) and writes back the value it reads there."""
    n = valid.shape[0]
    first = torch.argmax(valid.to(torch.int32))  # the first valid row, or 0
    pick = torch.where(valid, torch.arange(n, device=valid.device), first)
    keep = valid[pick]
    at = index(pick)
    shape = [1] * rows.dim()
    shape[row_dim] = n
    dst[at] = torch.where(keep.view(shape), rows.index_select(row_dim, pick),
                          dst[at])


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
    at ``pos % PS == 0``, under the same rule as the payload (every row
    scattered, a row that is not born dropped, :func:`_scatter_valid`). A
    rejected draft is not valid, so it never sets a scale; the next
    dispatch derives the page's scale from the accepted row. This is THE
    page-birth rule. Returns the codes ``(qk, qv)``."""
    ps = pool.page_size
    sk, sv = kv_row_scales(rk, rv, base, bt, pool.scale_k, pool.scale_v, ps)
    qk, qv = quantize_kv_rows(rk, sk), quantize_kv_rows(rv, sv)
    page, _ = _row_pages(pool, bt, base, rk.shape[3])
    born = (valid & (_row_positions(base, rk.shape[3]) % ps == 0)).reshape(-1)
    for plane, scale in ((pool.scale_k, sk), (pool.scale_v, sv)):
        # [L, S, Hkv, T] -> [L, S T, Hkv]: row n = s T + j along dim 1
        rows = scale.transpose(-1, -2).flatten(1, 2)
        _scatter_valid(plane, lambda pick: (slice(None), page[pick]), rows,
                       born, 1)
    return qk, qv


def _row_positions(base: torch.Tensor, t: int) -> torch.Tensor:
    """``[S, T]`` absolute positions ``base + j`` (long)."""
    return base.long()[:, None] + torch.arange(t, device=base.device)


def _row_pages(pool: PagedKVPool, bt: torch.Tensor, base: torch.Tensor,
               t: int) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """Rows ``n = s T + j`` at positions ``base[s] + j``: their pages and
    in-page offsets, ``[S T]`` long each. Table entries past ``Pmax`` and
    sentinel pads are clipped into the pool: only a valid row's page is
    ever written with a new value."""
    ps = pool.page_size
    pos = _row_positions(base, t)
    idx = (pos // ps).clamp(0, bt.shape[1] - 1)
    page = torch.gather(bt.long(), 1, idx).clamp(0, pool.num_pages - 1)
    return page.reshape(-1), (pos % ps).reshape(-1)


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
    draft's row never reaches a page. Every row is scattered, the ones
    that are not valid dropped (:func:`_scatter_valid`): no host read. A
    :class:`ShardedKVPool` takes tuples of rows, one a shard."""
    for shard, rk_s, rv_s in zip(pool.shards, as_shards(rk),
                                 as_shards(rv)):
        if shard.quantized:
            rk_s, rv_s = _quantize_rows_at_pages(shard, rk_s, rv_s,
                                                 start_len, bt, valid)
        page, off = _row_pages(shard, bt, start_len, rk_s.shape[3])
        flat = valid.reshape(-1)
        for dst, src in ((shard.k, rk_s), (shard.v, rv_s)):
            # [L, S, Hkv, K, C] -> [S K, L, Hkv, C]: non-adjacent advanced
            # indices put the row dim first
            rows = src.permute(1, 3, 0, 2, 4).flatten(0, 1).to(shard.dtype)
            _scatter_valid(
                dst, lambda pick: (slice(None), page[pick], slice(None),
                                   slice(None), off[pick]), rows, flat, 0)
    return pool


def write_token_rows(
    pool: PagedKVPool,
    ks: torch.Tensor,  # [L, Hkv, T, C] chunk K from a prefill (post-rope)
    vs: torch.Tensor,  # [L, Hkv, T, C]
    bt_row: torch.Tensor,  # [Pmax] int32 the slot's block table
    start: tp.Union[int, torch.Tensor],  # position of chunk token 0
    n_valid: tp.Union[int, torch.Tensor],  # real tokens in the chunk
) -> PagedKVPool:
    """Scatter a prefill chunk's first ``n_valid`` K/V rows into the
    slot's pages at positions ``start + j``, in place. ``start`` and
    ``n_valid`` may be ints or int32 ``[1]`` tensors on the pool's device
    (a prefill program's inputs): every row is scattered, the pad rows
    dropped, as :func:`flush_recent` does for one slot, so no shape
    depends on them and nothing is read back to the host."""
    dev = bt_row.device
    start, n_valid = device_scalar(start, dev), device_scalar(n_valid, dev)
    t = as_shards(ks)[0].shape[2]
    valid = torch.arange(t, device=dev)[None] < n_valid[:, None]
    return flush_recent(pool, shardwise(lambda a: a[:, None], ks),
                        shardwise(lambda a: a[:, None], vs), bt_row[None],
                        start, valid)

