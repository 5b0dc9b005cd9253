"""Block/paged KV cache for the continuous-batching runtime.

Each attention layer owns ``k``/``v`` pools ``[n_pages, page_size, n_kv,
hd]``; a request's KV lives on the physical pages the host-side allocator
handed it, and the device sees an int32 ``[B, table_width]`` page table each
step.  Physical page 0 is the garbage page: pad tokens and unallocated table
entries point at it, and the per-row position mask keeps it out of every
real row's softmax.

Pages are refcounted: a shared-prefix hit (:class:`PrefixCache`) hands the
same physical pages to several requests, and a lane about to write into a
shared page copies it first (:func:`copy_page`).  Speculative page growth is
undone by :func:`checkpoint` / :func:`rollback`, and :func:`defrag` compacts
live pages to the front of the pool.  Device pools are updated in place.
"""
from __future__ import annotations

import dataclasses
from collections import Counter, deque
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import PagedKVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_quant import KV_DTYPES, KV_SCALE_DTYPE
from repro_torch.tree import leaves as tree_leaves

#: Physical page reserved for pad-token writes and unallocated table slots.
GARBAGE_PAGE = 0


def resolve_kv_dtypes(cfg: ModelConfig, kv_dtypes=None) -> Dict[str, str]:
    """Per-layer-position KV page dtypes (``None``: all ``cfg.kv_dtype``; a
    string: all that; a ``{"pos_i": dtype}`` dict: missing positions follow
    ``cfg.kv_dtype``), validated once, loudly."""
    base = cfg.kv_dtype
    if isinstance(kv_dtypes, str):
        out = {f"pos_{p}": kv_dtypes for p in range(cfg.period)}
    else:
        kv_dtypes = kv_dtypes or {}
        unknown = set(kv_dtypes) - {f"pos_{p}" for p in range(cfg.period)}
        if unknown:
            raise ValueError(f"kv_dtypes names positions {sorted(unknown)} "
                             f"outside this model's period ({cfg.period})")
        out = {f"pos_{p}": kv_dtypes.get(f"pos_{p}", base)
               for p in range(cfg.period)}
    for key, dt in out.items():
        if dt not in KV_DTYPES:
            raise ValueError(f"{key}: unknown kv_dtype {dt!r}; expected one of "
                             f"{KV_DTYPES}")
        if dt == "int4" and cfg.head_dim_ % 2:
            raise ValueError(f"{key}: kv_dtype='int4' requires an even head_dim "
                             f"(got {cfg.head_dim_})")
    return out


def init_paged_caches(cfg: ModelConfig, n_pages: int, page_size: int, dtype,
                      kv_dtypes=None, device="cuda") -> Dict[str, PagedKVCache]:
    """Paged caches stacked over periods: ``{pos_i: [n_periods, n_pages,
    ...]}``, on the card unless ``device`` says otherwise.  Only attention
    mixers page (their KV grows with the sequence); a stack with a Mamba
    position serves through the slot runtime instead."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    for pos in range(cfg.period):
        if cfg.mixer_kind(pos) != "attn":
            raise ValueError(
                f"paged KV caches cover attention mixers only; layer position "
                f"{pos} is {cfg.mixer_kind(pos)!r} (serve this arch with the "
                f"slot runtime)")
    device = resolve_device(device)
    resolved = resolve_kv_dtypes(cfg, kv_dtypes)
    return {key: PagedKVCache.zeros(cfg, n_pages, page_size, dtype, kv_dtype=dt,
                                    device=device, stack=(cfg.n_periods,))
            for key, dt in resolved.items()}


def kv_token_bytes(cfg: ModelConfig, kv_dtype: str, dtype=None) -> int:
    """KV pool bytes ONE token costs at ONE layer under ``kv_dtype``."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim_
    if kv_dtype == "fp16":
        dt = dtype if dtype is not None else cfg.dtype()
        return 2 * kv * hd * torch.empty((), dtype=dt).element_size()
    codes = hd // 2 if kv_dtype == "int4" else hd
    scale = torch.empty((), dtype=KV_SCALE_DTYPE).element_size()
    return 2 * kv * (codes + scale)


def kv_page_bytes(cfg: ModelConfig, page_size: int, kv_dtypes=None,
                  dtype=None) -> int:
    """Bytes ONE physical page costs across ALL layers (k + v + scales)."""
    resolved = resolve_kv_dtypes(cfg, kv_dtypes)
    per_layer = sum(kv_token_bytes(cfg, dt, dtype=dtype)
                    for dt in resolved.values())
    return page_size * cfg.n_periods * per_layer


def _leaves(tree) -> Iterator[torch.Tensor]:
    """Every pool tensor of a cache tree (dicts of :class:`PagedKVCache`,
    scales included)."""
    for node in tree_leaves(tree):
        if isinstance(node, PagedKVCache):
            yield from (x for x in (node.k, node.v, node.k_scale, node.v_scale)
                        if x is not None)
        elif isinstance(node, torch.Tensor):
            yield node


def kv_cache_nbytes(caches) -> int:
    """Actual device bytes of a paged-cache tree (every leaf, scales in)."""
    return sum(x.numel() * x.element_size() for x in _leaves(caches))


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` tokens."""
    return -(-n_tokens // page_size)


def table_width(max_len: int, page_size: int) -> int:
    """Page-table width: pages covering ``max_len`` + the garbage column."""
    return pages_for(max_len, page_size) + 1


def pad_position(max_len: int, page_size: int) -> int:
    """The logical position pad tokens write to — start of the garbage
    column, beyond every real position, so ``kpos <= tpos`` masks it."""
    return (table_width(max_len, page_size) - 1) * page_size


def table_array(tables: Sequence[Sequence[int]], width: int) -> np.ndarray:
    """Host page-table lists → dense int32 [B, width]; unallocated entries
    and the garbage column point at GARBAGE_PAGE."""
    out = np.full((len(tables), width), GARBAGE_PAGE, dtype=np.int32)
    for i, t in enumerate(tables):
        if len(t) > width - 1:
            raise ValueError(f"row {i} holds {len(t)} pages > table width "
                             f"{width} (garbage column excluded)")
        out[i, : len(t)] = t
    return out


class PagePool:
    """Host-side physical-page allocator: free list, refcounts, stats.

    ``alloc`` returns ``None`` on exhaustion (backpressure, never a crash).
    ``free`` releases one reference per page; releasing a reference that was
    never taken raises before any state moves.
    """

    def __init__(self, n_pages: int, page_bytes: int = 0):
        if n_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is the garbage page)")
        self.n_pages = n_pages
        self.page_bytes = page_bytes
        self._free: deque = deque(range(1, n_pages))
        self._ref: List[int] = [0] * n_pages
        self._allocs = 0
        self._frees = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - 1 - len(self._free)

    @property
    def shared_pages(self) -> int:
        return sum(1 for r in self._ref if r > 1)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def free_page_ids(self) -> FrozenSet[int]:
        """Snapshot of the free list as a set."""
        return frozenset(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages with one reference each, or None; never partial."""
        if n > len(self._free):
            return None
        self._allocs += n
        out = []
        for _ in range(n):
            p = self._free.popleft()
            self._ref[p] = 1
            out.append(p)
        return out

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            if not 1 <= p < self.n_pages or self._ref[p] < 1:
                raise ValueError(f"incref on non-live page {p}")
        for p in pages:
            self._ref[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        need = Counter(pages)
        for p, c in need.items():
            if not 1 <= p < self.n_pages:
                raise ValueError(f"freeing invalid page {p}")
            if self._ref[p] < c:
                raise ValueError(f"double-free of page {p}: {c} release(s) "
                                 f"requested but only {self._ref[p]} held")
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
        self._frees += len(pages)

    def stats(self) -> Dict[str, int]:
        return {
            "n_pages": self.n_pages,
            "free_pages": self.free_pages,
            "used_pages": self.used_pages,
            "shared_pages": self.shared_pages,
            "alloc_count": self._allocs,
            "free_count": self._frees,
            "page_bytes": self.page_bytes,
            "pool_bytes": self.page_bytes * self.n_pages,
            "used_bytes": self.page_bytes * self.used_pages,
            "free_bytes": self.page_bytes * self.free_pages,
        }


# ---------------------------------------------------------------------------
# checkpoint / rollback: undo speculative page growth without leaks
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PageCheckpoint:
    """One request's page-table length, taken before a speculative (draft)
    allocation burst.  Rolling back frees exactly the pages allocated since,
    head-first onto the free list in reverse allocation order, so with no
    interleaved activity the pool ends as if nothing had been drafted.
    Stale KV in released pages needs no scrubbing: the ``kpos <= tpos`` mask
    keeps unaccepted positions out of every read, and a later owner writes a
    page's rows before their positions become readable."""

    n_pages: int


def checkpoint(pool: PagePool, table: Sequence[int]) -> PageCheckpoint:
    """Snapshot ``table`` (one request's physical-page list) against ``pool``."""
    del pool  # kept in the signature so the snapshot point is explicit
    return PageCheckpoint(n_pages=len(table))


def rollback(pool: PagePool, table: List[int], ckpt: PageCheckpoint,
             keep: Optional[int] = None) -> List[int]:
    """Release the pages allocated after ``ckpt``, keeping the first
    ``keep`` (default: the checkpointed length; never fewer).  Returns the
    freed pages.  The allocation counter is un-counted.  Raises, before any
    state moves, on a ``keep`` past the table, an invalid page, or a page
    another owner shares."""
    keep = ckpt.n_pages if keep is None else max(keep, ckpt.n_pages)
    if keep > len(table):
        raise ValueError(
            f"rollback keep={keep} exceeds the table's {len(table)} pages: "
            "accepted context covers pages that were never allocated")
    dropped = table[keep:]
    for p in dropped:
        if not 1 <= p < pool.n_pages:
            raise ValueError(f"rolling back invalid page {p}")
        if pool._ref[p] != 1:
            raise ValueError(
                f"rolling back shared page {p} (refcount {pool._ref[p]}): "
                "draft growth must own its pages exclusively")
    del table[keep:]
    for p in reversed(dropped):
        pool._ref[p] = 0
        pool._free.appendleft(p)
    pool._allocs -= len(dropped)
    return dropped


# ---------------------------------------------------------------------------
# page copies and defrag (in place, on the pools' device)
# ---------------------------------------------------------------------------


def _remap_pages(leaf: torch.Tensor, src: Sequence[int],
                 dst: Sequence[int]) -> None:
    """Move pool pages ``src[i] -> dst[i]`` on the pages axis (axis 0 for a
    per-layer pool, 1 under the period stack), in place.  The source rows
    are gathered before any is written, so overlapping moves are safe."""
    axis = leaf.ndim - 4  # [..., n_pages, page_size, kv, hd]
    if axis not in (0, 1):
        raise ValueError(f"unexpected pool rank {leaf.ndim}")
    s = torch.as_tensor(list(src), dtype=torch.long, device=leaf.device)
    d = torch.as_tensor(list(dst), dtype=torch.long, device=leaf.device)
    leaf.index_copy_(axis, d, leaf.index_select(axis, s))


def copy_page(caches, src: int, dst: int):
    """Copy physical page ``src``'s rows (codes and in-page scales) into page
    ``dst`` in every pool of ``caches``: the device half of copy-on-write
    (the caller rewrites the table and moves the refcounts).  Returns
    ``caches``."""
    for leaf in _leaves(caches):
        _remap_pages(leaf, [src], [dst])
    return caches


def defrag(caches, pool: PagePool, tables: List[List[int]], trie=None):
    """Compact live pages to the front of the pool: pages move on the device,
    ``tables`` and ``pool`` are rewritten in place, and ``trie`` (a
    :class:`PrefixCache`) is remapped alongside, its pages being live too.
    A page with references that no table and no trie node accounts for is a
    leak, and raises.  Returns ``caches``."""
    held = [] if trie is None else trie.pages()
    live_set = {p for t in tables for p in t} | set(held)
    live = sorted(live_set)
    orphans = [p for p in range(1, pool.n_pages)
               if pool._ref[p] > 0 and p not in live_set]
    if orphans:
        raise ValueError(
            f"defrag found leaked pages {orphans}: live refcounts with no "
            "owning page table or prefix-cache node")
    mapping = {src: dst for dst, src in enumerate(live, start=1)}
    moves = [(s, d) for s, d in mapping.items() if s != d]
    if moves:
        for leaf in _leaves(caches):
            _remap_pages(leaf, [s for s, _ in moves], [d for _, d in moves])
    for t in tables:
        t[:] = [mapping[p] for p in t]
    if trie is not None:
        trie.remap(mapping)
    ref = [0] * pool.n_pages
    for s, d in mapping.items():
        ref[d] = pool._ref[s]
    pool._ref = ref
    pool._free = deque(range(len(live) + 1, pool.n_pages))
    return caches


# ---------------------------------------------------------------------------
# shared-prefix cache: a radix/trie index over page-granular token prefixes
# ---------------------------------------------------------------------------


class _TrieNode:
    """One cached physical page: ``key`` is the page's full token tuple,
    ``page`` the physical page whose KV holds exactly those tokens (given
    the ancestor chain as context)."""

    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key: Tuple[int, ...], page: int,
                 parent: Optional["_TrieNode"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.last_used = 0


class PrefixCache:
    """Host-side radix index over token prefixes, one full page per node.

    A prefix's KV depends only on its tokens, so requests sharing a prompt
    prefix share the physical pages that hold it.  The trie owns one
    reference per cached page; each admitted lane that reuses a node adds
    its own (:meth:`claim`).  A hit is capped at ``len(prompt) - 1`` tokens
    (the last token always prefills), so only the last, partly used page of
    a hit can be written, and the scheduler copies it first.  Eviction is
    LRU over leaves whose page only the trie references.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root = _TrieNode((), GARBAGE_PAGE, None)
        self._tick = 0
        self.evictions = 0
        self.cached_tokens = 0   # cumulative tokens served from the cache
        self.lookup_tokens = 0   # cumulative prompt tokens looked up

    # -- traversal -----------------------------------------------------------
    def nodes(self) -> Iterator[_TrieNode]:
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            yield nd
            stack.extend(nd.children.values())

    def pages(self) -> List[int]:
        return [nd.page for nd in self.nodes()]

    @property
    def n_pages(self) -> int:
        return sum(1 for _ in self.nodes())

    def _touch(self, node: _TrieNode) -> None:
        self._tick += 1
        node.last_used = self._tick

    # -- lookup / claim ------------------------------------------------------
    def match(self, tokens: Sequence[int]) -> Tuple[List[_TrieNode], int]:
        """Longest cached page chain that prefixes ``tokens``: ``(nodes,
        hit_tokens)``, the hit capped at ``len(tokens) - 1``.  Read-only."""
        ps = self.page_size
        limit = len(tokens) - 1
        nodes: List[_TrieNode] = []
        node, i = self.root, 0
        while i + ps <= len(tokens) and i < limit:
            child = node.children.get(tuple(int(t) for t in tokens[i:i + ps]))
            if child is None:
                break
            nodes.append(child)
            node, i = child, i + ps
        return nodes, min(i, limit)

    def claim(self, nodes: Sequence[_TrieNode], pool: PagePool) -> List[int]:
        """Pin a matched chain for an admitted lane (one reference per page,
        an LRU touch); returns its pages in prefix order."""
        pages = [nd.page for nd in nodes]
        pool.incref(pages)
        for nd in nodes:
            self._touch(nd)
        return pages

    # -- insert --------------------------------------------------------------
    def insert(self, tokens: Sequence[int], pages: Sequence[int],
               pool: PagePool) -> int:
        """Index every full page of ``tokens`` (a fully ingested prompt).
        Prefixes already cached keep the trie's page; new nodes take one
        trie-owned reference on the lane's page.  Returns the nodes made."""
        ps = self.page_size
        node, new = self.root, 0
        for j in range(len(tokens) // ps):
            key = tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
            child = node.children.get(key)
            if child is None:
                pool.incref([pages[j]])
                child = _TrieNode(key, pages[j], node)
                node.children[key] = child
                new += 1
            self._touch(child)
            node = child
        return new

    # -- eviction ------------------------------------------------------------
    def reclaimable(self, pool: PagePool) -> int:
        """Pages eviction could free now (cached pages no lane shares)."""
        return sum(1 for nd in self.nodes() if pool.refcount(nd.page) == 1)

    def evict_one(self, pool: PagePool) -> bool:
        """Drop the least recently used leaf whose page only the trie holds.
        When every such page sits on an interior node, unindex the LRU leaf
        that shields one; with nothing reclaimable, return False."""
        if not any(pool.refcount(nd.page) == 1 for nd in self.nodes()):
            return False
        leaves = [nd for nd in self.nodes() if not nd.children]
        free = [nd for nd in leaves if pool.refcount(nd.page) == 1]
        if not free:
            def shields(nd):
                a = nd.parent
                while a is not None and a.parent is not None:
                    if pool.refcount(a.page) == 1:
                        return True
                    a = a.parent
                return False

            free = [nd for nd in leaves if shields(nd)]
        victim = min(free, key=lambda nd: nd.last_used)
        del victim.parent.children[victim.key]
        pool.free([victim.page])
        self.evictions += 1
        return True

    def evict_until(self, pool: PagePool, n_free: int) -> bool:
        """Evict LRU leaves until ``n_free`` pages are free; True on success."""
        while pool.free_pages < n_free:
            if not self.evict_one(pool):
                return False
        return True

    def clear(self, pool: PagePool) -> None:
        """Unindex everything and release the trie's references."""
        for nd in list(self.nodes()):
            pool.free([nd.page])
        self.root.children = {}

    # -- defrag hook ---------------------------------------------------------
    def remap(self, mapping: Dict[int, int]) -> None:
        for nd in self.nodes():
            nd.page = mapping[nd.page]
