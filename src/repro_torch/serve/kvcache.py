"""Block/paged KV cache for the continuous-batching runtime.

Each attention layer owns ``k``/``v`` pools ``[n_pages, page_size, n_kv,
hd]``; a request's KV lives on the physical pages the host-side allocator
handed it, and the device sees an int32 ``[B, table_width]`` page table each
step.  Physical page 0 is the garbage page: pad tokens and unallocated table
entries point at it, and the per-row position mask keeps it out of every
real row's softmax.
"""
from __future__ import annotations

from collections import Counter, deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.attention import PagedKVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_quant import KV_DTYPES, KV_SCALE_DTYPE

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
                      kv_dtypes=None, device="cpu") -> Dict[str, PagedKVCache]:
    """Paged caches stacked over periods: ``{pos_i: [n_periods, n_pages,
    ...]}`` (every layer position of the dense family is attention)."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
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
