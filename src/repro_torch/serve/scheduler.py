"""Continuous-batching scheduler over the paged KV cache.

One fixed decode batch of ``batch_size`` lanes runs every tick.  Because the
page pool is batch-free, a tick issues up to two calls of the same step: a
compact chunked-prefill sub-batch (``[prefill_lanes, chunk]``, lanes still
ingesting their prompt) and a pure decode batch (``[width, 1]``, compacted to
the width ladder).  ``"reserve"`` admission only admits a request when its
worst-case page demand fits beside the reservations of every running lane,
so a running lane can always get its next page (the queue waits instead).
Finished lanes free their pages at once; sampling is greedy.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward
from repro_torch.serve.kvcache import (
    GARBAGE_PAGE,
    PagePool,
    init_paged_caches,
    kv_page_bytes,
    pad_position,
    pages_for,
    resolve_kv_dtypes,
    table_width,
)


@dataclasses.dataclass
class Request:
    """One generation request."""

    uid: int
    prompt: np.ndarray            # [T0] int32
    max_new_tokens: int = 32
    eos_id: int = -1              # -1 → never stops early
    on_token: Optional[Callable[[int, int], None]] = None  # stream (uid, tok)
    generated: Optional[List[int]] = None
    submit_t: float = 0.0
    first_token_t: Optional[float] = None
    finish_t: float = 0.0
    token_times: Optional[List[float]] = None

    def __post_init__(self):
        if self.generated is None:
            self.generated = []
        if self.token_times is None:
            self.token_times = []


def latency_metrics(reqs) -> Dict[str, float]:
    """TTFT and inter-token latency percentiles (ms) over finished requests
    (zeros when nothing has finished)."""
    itl: List[float] = []
    for r in reqs:
        itl.extend(b - a for a, b in zip(r.token_times, r.token_times[1:]))
    ttft = [r.first_token_t - r.submit_t for r in reqs
            if r.first_token_t is not None]

    def pct(xs, q):
        return float(np.percentile(xs, q)) * 1e3 if xs else 0.0

    return {"ttft_p50_ms": pct(ttft, 50), "itl_p50_ms": pct(itl, 50),
            "itl_p99_ms": pct(itl, 99)}


def pow2_bucket(n: int, lo: int = 1) -> int:
    """Smallest power of two ≥ n (and ≥ lo) — the step-length buckets."""
    b = lo
    while b < n:
        b *= 2
    return b


def width_buckets(b: int) -> List[int]:
    """Batch-width ladder {1, 2, 3, 4, 6, 8, 12, …, b}: pow2 plus the 1.5×
    midpoints."""
    out, w = [], 1
    while w < b:
        out.append(w)
        mid = w + w // 2
        if w > 1 and mid < b:
            out.append(mid)
        w *= 2
    out.append(b)
    return out


def width_bucket(n: int, b: int) -> int:
    """Smallest ladder width ≥ n (capped at b)."""
    for w in width_buckets(b):
        if w >= n:
            return w
    return b


@dataclasses.dataclass
class _Lane:
    """Host state of one occupied batch row."""

    req: Request
    pages: List[int]              # physical pages, in logical order
    ctx: List[int]                # prompt + generated-so-far token ids
    pos: int = 0                  # ctx tokens already written to the pool
    admitted_t: float = 0.0

    @property
    def remaining(self) -> int:   # 1 → decoding; >1 → still prefilling
        return len(self.ctx) - self.pos


class PagedScheduler:
    """Continuous batching + paged KV with reserve admission."""

    def __init__(self, cfg: ModelConfig, params: Any, batch_size: int,
                 max_len: int, page_size: int = 16,
                 n_pages: Optional[int] = None,
                 device: torch.device = torch.device("cpu")):
        self.kv_dtypes = resolve_kv_dtypes(cfg)
        if n_pages is None:
            # dense-slot-equivalent footprint: every lane can hold max_len
            n_pages = batch_size * pages_for(max_len, page_size) + 1
        self.cfg = cfg
        self.params = params
        self.device = device
        self.b = batch_size
        self.max_len = max_len
        self.page_size = page_size
        # the reference's defaults: 16-token prompt chunks on up to 4 lanes
        self.prefill_chunk = 16
        self.prefill_lanes = min(4, batch_size)
        # decode lanes take one token each; prefill chunks fill the rest
        self.token_budget = batch_size + 2 * self.prefill_chunk
        self.W = table_width(max_len, page_size)
        self.pad_pos = pad_position(max_len, page_size)
        self.pool = PagePool(n_pages, page_bytes=kv_page_bytes(
            cfg, page_size, self.kv_dtypes))
        self.caches = init_paged_caches(cfg, n_pages, page_size, cfg.dtype(),
                                        kv_dtypes=self.kv_dtypes, device=device)
        self.lanes: List[Optional[_Lane]] = [None] * batch_size
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self.steps = 0
        self.out_tokens = 0
        self.ctx_tokens = 0
        self._start_t: Optional[float] = None

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        t0 = len(req.prompt)
        if t0 >= self.max_len:
            raise ValueError(f"request {req.uid}: prompt of {t0} tokens does "
                             f"not fit max_len={self.max_len}")
        worst = self._worst_pages(t0 + len(req.generated),
                                  req.max_new_tokens - len(req.generated))
        if worst > self.pool.n_pages - 1:
            raise ValueError(f"request {req.uid} can never be served: needs "
                             f"{worst} pages but the pool holds "
                             f"{self.pool.n_pages - 1}")
        req.submit_t = time.perf_counter()
        self.queue.append(req)

    def _worst_pages(self, ctx_len: int, rem_new: int) -> int:
        return pages_for(min(ctx_len + max(rem_new, 0), self.max_len),
                         self.page_size)

    def _lane_reservation(self, lane: _Lane) -> int:
        return self._worst_pages(
            len(lane.ctx), lane.req.max_new_tokens - len(lane.req.generated))

    def _admit(self) -> None:
        for i in range(self.b):
            if not self.queue:
                return
            if self.lanes[i] is not None:
                continue
            req = self.queue[0]
            ctx = [int(t) for t in req.prompt] + list(req.generated)
            held = sum(self._lane_reservation(l)
                       for l in self.lanes if l is not None)
            worst = self._worst_pages(len(ctx), req.max_new_tokens
                                      - len(req.generated))
            if held + worst > self.pool.n_pages - 1:
                return  # backpressure: head-of-line waits for pages
            self.queue.pop(0)
            self.lanes[i] = _Lane(req=req, pages=[], ctx=ctx,
                                  admitted_t=time.perf_counter())

    def _ensure_pages(self, lane: _Lane, n: int) -> int:
        """Grow lane.pages to cover pos+n tokens; returns the n covered (a
        prefill chunk shrinks to what free pages allow; 0 = deferred)."""
        while n > 0:
            need = pages_for(lane.pos + n, self.page_size) - len(lane.pages)
            if need <= 0:
                return n
            got = self.pool.alloc(need)
            if got is not None:
                lane.pages.extend(got)
                return n
            fit = ((len(lane.pages) + self.pool.free_pages) * self.page_size
                   - lane.pos)
            n = min(n - 1, max(fit, 0))
        return 0

    # -- the tick ------------------------------------------------------------
    def step(self) -> int:
        """One tick: admit, one chunked-prefill sub-batch (if any lane is
        still ingesting), then one decode step over the decoding lanes.
        Returns the number of active lanes."""
        self._admit()
        active = [(i, l) for i, l in enumerate(self.lanes) if l is not None]
        if not active:
            return 0
        if self._start_t is None:
            self._start_t = time.perf_counter()
        self.steps += 1
        decode_count = sum(1 for _, l in active if l.remaining == 1)
        prefill = [(i, l) for i, l in active if l.remaining > 1]
        if prefill:
            self._prefill_phase(prefill, decode_count)
        decode = [(i, l) for i, l in enumerate(self.lanes)
                  if l is not None and l.remaining == 1]
        if decode:
            self._decode_phase(decode)
        return sum(l is not None for l in self.lanes)

    def _run_batch(self, rows, plan, n_rows: int, t_step: int) -> np.ndarray:
        """One call of the step for ``rows`` = [(batch_row, lane_idx, lane)].
        Pad rows/columns carry the garbage position, so their writes land in
        the garbage page and every real row's mask excludes them."""
        tokens = np.zeros((n_rows, t_step), np.int32)
        positions = np.full((n_rows, t_step), self.pad_pos, np.int32)
        last_idx = np.zeros((n_rows,), np.int32)
        table = np.full((n_rows, self.W), GARBAGE_PAGE, np.int32)
        for r, i, l in rows:
            n = plan[i]
            tokens[r, :n] = l.ctx[l.pos: l.pos + n]
            positions[r, :n] = np.arange(l.pos, l.pos + n)
            last_idx[r] = n - 1
            table[r, : len(l.pages)] = l.pages
        dev = self.device
        with torch.inference_mode():
            logits, self.caches = forward(
                self.params, torch.from_numpy(tokens).to(dev), self.cfg,
                torch.from_numpy(positions).to(dev), self.caches,
                torch.from_numpy(table).to(dev),
                last_idx=torch.from_numpy(last_idx).to(dev))
        return logits[:, 0].float().cpu().numpy()

    def _prefill_phase(self, prefill, decode_count: int) -> None:
        """Up to ``prefill_lanes`` ingesting lanes advance one chunk each in
        a compact sub-batch; the token budget is what the decode lanes
        leave."""
        budget = self.token_budget - decode_count
        if budget <= 0 and decode_count > 0:
            return  # decode saturates the budget this tick
        sel = sorted(prefill, key=lambda t: t[1].admitted_t)[: self.prefill_lanes]
        plan: Dict[int, int] = {}
        for i, l in sel:
            n = min(l.remaining, self.prefill_chunk, budget)
            plan[i] = self._ensure_pages(l, n)
            budget -= plan[i]
        rows = [(r, i, l) for r, (i, l) in enumerate(
            (i, l) for i, l in sel if plan[i] > 0)]
        if not rows:
            return
        t_step = min(pow2_bucket(max(plan[i] for _, i, _ in rows)),
                     self.prefill_chunk)
        logits = self._run_batch(rows, plan, self.prefill_lanes, t_step)
        now = time.perf_counter()
        for r, i, l in rows:
            l.pos += plan[i]
            self.ctx_tokens += plan[i]
            if l.remaining == 0:  # chunk covered the last unseen token
                self._sample(i, l, logits[r], now)

    def _decode_phase(self, decode) -> None:
        """All decoding lanes advance one token in a [width, 1] step."""
        for i, l in decode:
            if self._ensure_pages(l, 1) != 1:
                raise RuntimeError(
                    f"lane {i} found no page for its next token although "
                    "reserve admission guarantees one: page ledger corrupted")
        width = width_bucket(len(decode), self.b)
        rows = [(r, i, l) for r, (i, l) in enumerate(decode)]
        logits = self._run_batch(rows, {i: 1 for i, _ in decode}, width, 1)
        now = time.perf_counter()
        for r, i, l in rows:
            l.pos += 1
            self.ctx_tokens += 1
            self._sample(i, l, logits[r], now)

    def _sample(self, i: int, lane: _Lane, row: np.ndarray, now: float) -> None:
        req = lane.req
        tok = int(np.argmax(row))
        if not req.generated:
            req.first_token_t = now
        req.token_times.append(now)
        req.generated.append(tok)
        lane.ctx.append(tok)
        self.out_tokens += 1
        if req.on_token is not None:
            req.on_token(req.uid, tok)
        if (tok == req.eos_id or len(req.generated) >= req.max_new_tokens
                or len(lane.ctx) >= self.max_len):
            req.finish_t = now
            self.pool.free(lane.pages)
            self.done[req.uid] = req
            self.lanes[i] = None

    def run(self, max_steps: int = 100_000) -> Dict[int, Request]:
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return self.done

    def metrics(self) -> Dict[str, Any]:
        wall = (time.perf_counter() - self._start_t) if self._start_t else 0.0
        return {
            "runtime": "paged",
            "requests_done": len(self.done),
            "out_tokens": self.out_tokens,
            **latency_metrics(self.done.values()),
            "ctx_tokens": self.ctx_tokens,
            "steps": self.steps,
            "wall_s": wall,
            "tokens_per_s": self.out_tokens / wall if wall > 0 else 0.0,
            "pool": self.pool.stats(),
        }
