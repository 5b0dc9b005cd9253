"""Continuous-batching scheduler over the paged KV cache.

One fixed decode batch of ``batch_size`` lanes runs every tick.  Because the
page pool is batch-free, a tick issues up to two calls of the same step: a
compact chunked-prefill sub-batch (``[prefill_lanes, chunk]``, lanes still
ingesting their prompt) and a pure decode batch (``[width, 1]``, compacted to
the width ladder).  Host-side state:

* admission with a token budget: ``token_budget`` caps the tokens of a tick
  (decode lanes first, prefill chunks fill the rest).  ``"reserve"`` admits
  a request only when its worst-case page demand fits beside every running
  lane's reservation (the queue waits); ``"optimistic"`` admits on
  first-chunk fit and preempts the youngest lane when a decoding lane finds
  no page (its KV is recomputed on re-admission, token-exact under greedy
  decoding), and lanes stalled for ``stall_patience`` ticks are preempted
  too;
* ``prefix_cache=True``: fully ingested prompt pages go into a trie
  (:class:`repro_torch.serve.kvcache.PrefixCache`); admission skips prefill
  for every cached page of a new prompt (shared by refcount), a write into a
  still-shared page copies it first, and pool pressure evicts LRU cached
  prefixes before backpressure.  Tokens are identical with the cache on or
  off;
* ``spec=SpecConfig(...)``: speculative decoding — decode lanes draft
  ``gamma`` tokens with a cheap pass and verify them in one full-precision
  step over ``gamma + 1`` positions; greedy acceptance keeps the output
  token-identical, and page checkpoints roll rejected growth back.

Counters, gauges and histograms live in a metrics registry under the
reference's series names (``obs=`` hands in an
:class:`~repro_torch.obs.Observability` bundle; each scheduler otherwise
makes its own), read through the reference's property and ``metrics()``
names.  An enabled trace recorder gets the reference's events (submit,
running spans, tokens, preemptions, per-tick phases), stamped on the same
``perf_counter`` clock as ``Request.token_times``, and every device call
runs inside a ``torch.profiler`` annotation named for its shape
(``paged_step[rows x T]``).  ``hw=`` (a
:class:`~repro_torch.obs.hwcost.HardwareCostModel`) prices the executed
token-passes on the paper's DA circuits: ``metrics()["hw"]``, reckoned from
the circuit model, never measured on the device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.races import PageWrite, TickPlan, assert_plan_ok
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Observability
from repro_torch.obs.hwcost import HardwareCostModel, draft_price
from repro_torch.obs.metrics import ENERGY_BUCKETS
from repro_torch.obs.trace import SCHED_TRACK, device_span, request_track
from repro_torch.serve.kvcache import (
    GARBAGE_PAGE,
    PagePool,
    PrefixCache,
    checkpoint as kv_checkpoint,
    copy_page,
    defrag,
    init_paged_caches,
    kv_cache_nbytes,
    kv_page_bytes,
    kv_token_bytes,
    pad_position,
    pages_for,
    resolve_kv_dtypes,
    rollback as kv_rollback,
    table_width,
)
from repro_torch.spec import (
    SpecConfig,
    breakeven_acceptance,
    greedy_accept,
    make_provider,
    make_verify_step,
)
from repro_torch.spec.decode import (  # noqa: F401  (mk_positions re-exported)
    make_fused_draft,
    make_paged_step,
    mk_positions,
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
    # estimated DA-hardware cost of this request's executed work (pJ /
    # model-ns), accumulated when a HardwareCostModel is attached
    hw_pj: float = 0.0
    hw_ns: float = 0.0

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


def base_metrics(runtime: str, done: Dict[int, Request],
                 out_tokens: int) -> Dict[str, Any]:
    """The ``metrics()`` core: runtime tag, completion and token totals, and
    the latency percentiles."""
    return {"runtime": runtime, "requests_done": len(done),
            "out_tokens": out_tokens, **latency_metrics(done.values())}


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
    stalled_steps: int = 0
    cached: bool = False          # prompt pages already offered to the trie
    draft_pos: int = 0            # ctx tokens an own-cache draft has ingested

    @property
    def remaining(self) -> int:   # 1 → decoding; >1 → still prefilling
        return len(self.ctx) - self.pos


#: the registry's counters: attribute, series name and help text (the
#: reference's); each is read through a property named for its attribute
_COUNTERS = (
    ("steps", "sched_ticks", "scheduler ticks run"),
    ("out_tokens", "sched_out_tokens", "tokens emitted"),
    ("ctx_tokens", "sched_ctx_tokens", "context tokens written to the KV pool"),
    ("preemptions", "sched_preemptions", "lanes evicted back to the queue"),
    ("step_compiles", "sched_step_compiles", "unified-step shape compiles"),
    ("prefix_lookups", "prefix_lookups",
     "admissions that consulted the prefix trie"),
    ("prefix_hits", "prefix_hits", "admissions that reused cached prefix pages"),
    ("cow_copies", "kv_cow_copies", "copy-on-write page copies"),
    ("draft_steps", "spec_draft_steps", "draft-model steps issued"),
    ("verify_steps", "spec_verify_steps", "batched verify calls issued"),
    ("spec_rounds", "spec_rounds", "speculative rounds completed"),
    ("drafted_tokens", "spec_drafted_tokens",
     "tokens proposed by the draft model"),
    ("accepted_drafts", "spec_accepted_drafts",
     "draft tokens accepted by verify"),
    ("bonus_tokens", "spec_bonus_tokens",
     "bonus tokens from fully-accepted windows"),
    ("spec_disabled", "spec_disabled_requests",
     "requests whose speculation auto-off'd"),
    ("draft_compiles", "spec_draft_compiles", "draft-step shape compiles"),
    ("verify_compiles", "spec_verify_compiles", "verify-step shape compiles"),
)

#: the compile counter each kind of device call counts its new shapes in
#: (the reference jit-compiles one step function per kind, once per shape;
#: the draft step and the own-cache draft ingest count in one counter)
_COMPILES = {"step": "step_compiles", "draft": "draft_compiles",
             "ingest": "draft_compiles", "verify": "verify_compiles"}


_NO_SPAN = contextlib.nullcontext()


def _counter_view(attr: str):
    return property(lambda self: int(self._c[attr].total))


class PagedScheduler:
    """Continuous batching + paged KV: the serving runtime behind
    ``ServeEngine``.  Runs on the card unless ``device`` says otherwise."""

    def __init__(self, cfg: ModelConfig, params: Any, batch_size: int,
                 max_len: int, greedy: bool = True, page_size: int = 16,
                 n_pages: Optional[int] = None, prefill_chunk: int = 16,
                 prefill_lanes: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 admission: str = "reserve", stall_patience: int = 64,
                 spec: Optional[SpecConfig] = None, prefix_cache: bool = False,
                 paged_attn: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 kv_dtypes: Optional[Dict[str, str]] = None,
                 obs: Optional[Observability] = None,
                 hw: Optional[HardwareCostModel] = None,
                 analysis_debug: bool = False, device="cuda"):
        if admission not in ("reserve", "optimistic"):
            raise ValueError(f"unknown admission policy {admission!r}")
        # the runtime knobs override the model config; baked into cfg before
        # any step or draft provider reads it
        if paged_attn is not None and paged_attn != cfg.paged_attn:
            cfg = dataclasses.replace(cfg, paged_attn=paged_attn)
        if kv_dtype is not None and kv_dtype != cfg.kv_dtype:
            cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        self.kv_dtypes = resolve_kv_dtypes(cfg, kv_dtypes)
        if spec is not None and not greedy:
            raise ValueError(
                "speculative decoding verifies drafts by greedy acceptance; "
                "it requires greedy=True")
        self.device = resolve_device(device)
        if n_pages is None:
            # dense-slot-equivalent footprint: every lane can hold max_len
            n_pages = batch_size * pages_for(max_len, page_size) + 1
        self.cfg = cfg
        self.params = params
        self.b = batch_size
        self.max_len = max_len
        self.greedy = greedy
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.prefill_lanes = prefill_lanes or min(4, batch_size)
        self.token_budget = token_budget or (batch_size + 2 * prefill_chunk)
        self.admission = admission
        self.stall_patience = stall_patience
        self.W = table_width(max_len, page_size)
        self.pad_pos = pad_position(max_len, page_size)
        self.pool = PagePool(n_pages, page_bytes=kv_page_bytes(
            cfg, page_size, self.kv_dtypes))
        self.caches = init_paged_caches(cfg, n_pages, page_size, cfg.dtype(),
                                        kv_dtypes=self.kv_dtypes,
                                        device=self.device)
        self.lanes: List[Optional[_Lane]] = [None] * batch_size
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}
        self._preempted: set = set()  # uids waiting on a full-ctx re-admit
        self.prefix = PrefixCache(page_size) if prefix_cache else None
        # analysis_debug: every launch's (page, offset) write plan goes
        # through repro_torch.analysis.races before the device call; a
        # violated aliasing invariant raises PageRaceError instead of
        # corrupting KV.  plans_checked is a plain attribute, not a registry
        # counter: a debug-only metric would change the exported schema.
        self.analysis_debug = bool(analysis_debug)
        self.plans_checked = 0
        # counters, gauges and histograms live in the registry, so metrics(),
        # the Prometheus export and snapshots read one source
        self.obs = obs if obs is not None else Observability.make()
        reg = self.obs.registry
        self._tr = self.obs.tracer
        self._c = {attr: reg.counter(name, doc) for attr, name, doc in _COUNTERS}
        self._g_lanes = reg.gauge("sched_live_lanes", "occupied batch rows")
        self._g_queue = reg.gauge(
            "sched_queue_depth", "requests waiting for admission")
        self._g_used_pages = reg.gauge("kv_used_pages", "pool pages in use")
        self._h_ttft = reg.histogram(
            "req_ttft_seconds", "submit to first token")
        self._h_itl = reg.histogram("req_itl_seconds", "inter-token latency")
        self._h_tick = reg.histogram(
            "sched_tick_seconds", "wall time of one scheduler tick")
        # distinct shapes issued, by kind of device call: the first call of
        # a shape counts as its compile (the reference's jit compiles once
        # per shape bucket)
        self._shapes: Dict[str, set] = {k: set() for k in _COMPILES}
        self._start_t: Optional[float] = None
        self._step = make_paged_step(cfg)

        self.spec = spec
        self._provider = None
        self.draft_caches = None
        self._spec_state: Dict[int, Dict[str, Any]] = {}  # uid → EMA state
        if spec is not None:
            self._provider = make_provider(spec, cfg, params, device=self.device)
            self.draft_caches = self._provider.init_caches(
                self.pool.n_pages, page_size, self.device)
            self._spec_floor = (
                spec.disable_below if spec.disable_below is not None
                else min(1.0, breakeven_acceptance(
                    spec.gamma, self._provider.cost_ratio) + 0.05))
            self._draft_step = make_fused_draft(self._provider.make_step(),
                                                spec.gamma)
            self._draft_ingest = self._provider.make_step()
            self._verify_step = make_verify_step(cfg)

        # -- hardware cost attribution (repro_torch.obs.hwcost) ---------------
        # per-token-pass prices by phase, fixed here: prefill, decode and
        # verify run the full-precision model; draft and draft-side ingest
        # run at the provider's price (truncated bit-planes: proportionally
        # fewer read cycles; an own-artifact draft: its own table; layer
        # skip: scaled by cost_ratio)
        self.hw = hw if hw else None  # an empty cost table: no attribution
        self._hw_prices: Dict[str, Tuple[float, float]] = {}
        self._hw_bs: Dict[str, Tuple[float, float]] = {}
        self._hw_draft: Optional[Dict[str, Any]] = None
        if self.hw is not None:
            full = (self.hw.pj_per_token(), self.hw.ns_per_token())
            bs_full = (self.hw.bitslice_pj_per_token(),
                       self.hw.bitslice_ns_per_token())
            for ph in ("prefill", "decode", "verify"):
                self._hw_prices[ph] = full
                self._hw_bs[ph] = bs_full
            if self._provider is not None:
                dp = draft_price(self.hw, self._provider, self.params)
                self._hw_draft = dp
                for ph in ("draft", "draft_ingest"):
                    self._hw_prices[ph] = (dp["pj"], dp["ns"])
                    self._hw_bs[ph] = (dp["bs_pj"], dp["bs_ns"])
            self._c_hw_tokens = reg.counter(
                "hw_tokens", "token-passes priced by the DA hardware model")
            self._c_hw_pj = reg.counter(
                "hw_est_pj", "estimated DA energy of executed work (pJ)")
            self._c_hw_ns = reg.counter(
                "hw_est_ns",
                "estimated serialized DA latency of executed work (ns)")
            self._h_req_pj = reg.histogram(
                "req_hw_pj", "per-request estimated DA energy (pJ)",
                buckets=ENERGY_BUCKETS)

    # -- registry-backed counter views ---------------------------------------
    steps = _counter_view("steps")
    out_tokens = _counter_view("out_tokens")
    ctx_tokens = _counter_view("ctx_tokens")
    preemptions = _counter_view("preemptions")
    prefix_lookups = _counter_view("prefix_lookups")
    prefix_hits = _counter_view("prefix_hits")
    cow_copies = _counter_view("cow_copies")
    draft_steps = _counter_view("draft_steps")
    verify_steps = _counter_view("verify_steps")
    spec_rounds = _counter_view("spec_rounds")
    drafted_tokens = _counter_view("drafted_tokens")
    accepted_drafts = _counter_view("accepted_drafts")
    bonus_tokens = _counter_view("bonus_tokens")
    spec_disabled = _counter_view("spec_disabled")
    step_compiles = _counter_view("step_compiles")
    draft_compiles = _counter_view("draft_compiles")
    verify_compiles = _counter_view("verify_compiles")

    def _issue(self, kind: str, width: int, t_step: int):
        """Note a device call of ``kind`` at ``[width, t_step]`` (its first
        call counts as a compile) and return the context it runs in: a
        ``torch.profiler`` annotation named for it while the recorder is on,
        else a shared no-op."""
        shapes = self._shapes[kind]
        if (width, t_step) not in shapes:
            shapes.add((width, t_step))
            self._c[_COMPILES[kind]].inc()
        if not self._tr.enabled:
            return _NO_SPAN
        name = "paged_step" if kind == "step" else f"spec_{kind}"
        return device_span(f"{name}[{width}x{t_step}]",
                           cuda=self.device.type == "cuda")

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
        if self._tr.enabled:
            self._tr.instant("submit", request_track(req.uid),
                             ts=req.submit_t, prompt_tokens=t0,
                             max_new_tokens=req.max_new_tokens)

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
            hit_nodes, hit = ([], 0)
            if self.prefix is not None:
                hit_nodes, hit = self.prefix.match(ctx)
            # a hit mid-page means the lane's first write copies the last
            # shared page: one more page the reservation must carry
            cow_extra = 1 if hit % self.page_size else 0
            if self.admission == "reserve":
                held = sum(self._lane_reservation(l)
                           for l in self.lanes if l is not None)
                # hit pages a running lane also holds are inside `held`
                # already; trie-only hit pages stay in this lane's worst case
                live = {p for l in self.lanes if l is not None
                        for p in l.pages}
                discount = sum(1 for nd in hit_nodes if nd.page in live)
                worst = (self._worst_pages(
                    len(ctx), req.max_new_tokens - len(req.generated))
                    - discount + cow_extra)
                if held + worst > self.pool.n_pages - 1:
                    return  # backpressure: head-of-line waits for pages
            else:
                # optimistic: the first chunk must fit now, plus headroom for
                # decode growth; a preempted request re-admits only when its
                # whole context fits (a sliver would replay and be evicted
                # again); cached prefix pages are already resident
                need = (len(ctx) - hit if req.uid in self._preempted
                        else min(len(ctx) - hit, self.prefill_chunk))
                headroom = max(2, self.pool.n_pages // 16)
                want = min(pages_for(hit + need, self.page_size)
                           - len(hit_nodes) + cow_extra + headroom,
                           self.pool.n_pages - 1 - len(hit_nodes))
                if not self._can_cover(want):
                    return
                self._preempted.discard(req.uid)
            self.queue.pop(0)
            pages: List[int] = []
            if self.prefix is not None:
                self._c["prefix_lookups"].inc()
                # the hit rate's denominator: prompt tokens only
                self.prefix.lookup_tokens += len(req.prompt)
                if hit_nodes:
                    pages = self.prefix.claim(hit_nodes, self.pool)
                    self._c["prefix_hits"].inc()
                    self.prefix.cached_tokens += hit
            lane = _Lane(req=req, pages=pages, ctx=ctx, pos=hit,
                         admitted_t=time.perf_counter())
            self.lanes[i] = lane
            if self._tr.enabled:
                # one "running" span per residency: begun here, ended by
                # _preempt or at the finish
                self._tr.begin("running", request_track(req.uid),
                               ts=lane.admitted_t, lane=i, ctx_tokens=len(ctx),
                               prefix_hit_tokens=hit)

    # -- preemption / eviction -----------------------------------------------
    def _preempt(self, i: int) -> None:
        """Evict lane i to the queue head: its pages are freed now and its KV
        is rebuilt by chunked prefill on re-admission."""
        lane = self.lanes[i]
        self.pool.free(lane.pages)
        self.queue.insert(0, lane.req)
        self._preempted.add(lane.req.uid)
        self.lanes[i] = None
        self._c["preemptions"].inc()
        if self._tr.enabled:
            track = request_track(lane.req.uid)
            self._tr.instant("preempt", track,
                             generated=len(lane.req.generated))
            self._tr.end("running", track)

    def _youngest_other(self, i: int) -> Optional[int]:
        cands = [(j, l) for j, l in enumerate(self.lanes)
                 if l is not None and j != i]
        if not cands:
            return None
        return max(cands, key=lambda t: t[1].admitted_t)[0]

    def _alloc(self, n: int) -> Optional[List[int]]:
        """Pool allocation that evicts LRU cached prefixes on exhaustion."""
        got = self.pool.alloc(n)
        if (got is None and self.prefix is not None
                and self.prefix.evict_until(self.pool, n)):
            got = self.pool.alloc(n)
        return got

    def _can_cover(self, n: int) -> bool:
        """Could ``n`` pages be produced right now (free + evictable)?"""
        free = self.pool.free_pages
        if self.prefix is not None:
            free += self.prefix.reclaimable(self.pool)
        return n <= free

    def _cow_shared_page(self, lane: _Lane) -> bool:
        """Copy-on-write before KV rows are written at ``lane.pos``: a page
        other owners still reference is copied to a private page first.
        Only the last, partly used page of a prefix hit can be shared.
        False when no page is free for the copy (backpressure)."""
        if self.prefix is None:
            return True
        idx = lane.pos // self.page_size
        if idx >= len(lane.pages):
            return True
        src = lane.pages[idx]
        if self.pool.refcount(src) <= 1:
            return True
        got = self._alloc(1)
        if got is None:
            return False
        dst = got[0]
        # an own-cache draft indexes its pools with the same page tables
        copy_page({"t": self.caches, "d": self.draft_caches}
                  if self.draft_caches is not None else self.caches, src, dst)
        lane.pages[idx] = dst
        self.pool.free([src])  # drop the lane's reference on the shared page
        self._c["cow_copies"].inc()
        return True

    def _maybe_cache_prefix(self, lane: _Lane) -> None:
        """Offer a lane's prompt pages to the trie once the prompt is fully
        ingested."""
        if (self.prefix is None or lane.cached
                or lane.pos < len(lane.req.prompt)):
            return
        lane.cached = True
        self.prefix.insert(lane.ctx[: len(lane.req.prompt)], lane.pages,
                           self.pool)

    def _ensure_pages(self, lane: _Lane, n: int) -> int:
        """Grow lane.pages to cover pos+n tokens; returns the n covered (a
        prefill chunk shrinks to what free pages allow; 0 = deferred)."""
        if n > 0 and not self._cow_shared_page(lane):
            return 0
        while n > 0:
            need = pages_for(lane.pos + n, self.page_size) - len(lane.pages)
            if need <= 0:
                return n
            got = self._alloc(need)
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
        still ingesting), then the decode lanes (speculative rounds for the
        staged ones, one decode step for the rest).  Returns the number of
        active lanes."""
        self._admit()
        active = [(i, l) for i, l in enumerate(self.lanes) if l is not None]
        if not active:
            return 0
        if self._start_t is None:
            self._start_t = time.perf_counter()
        self._c["steps"].inc()
        t_tick = time.perf_counter()
        allocs0, cow0 = self.pool._allocs, self._c["cow_copies"].total
        evict0 = self.prefix.evictions if self.prefix is not None else 0
        progressed: set = set()
        decode_count = sum(1 for _, l in active if l.remaining == 1)
        prefill = [(i, l) for i, l in active if l.remaining > 1]
        if prefill:
            progressed |= self._prefill_phase(prefill, decode_count)
        decode = [(i, l) for i, l in enumerate(self.lanes)
                  if l is not None and l.remaining == 1]
        if decode:
            staged, plain = self._partition_spec(decode)
            if staged:
                progressed |= self._spec_phase(staged)
            if plain:
                progressed |= self._decode_phase(plain)
        active = [(i, l) for i, l in enumerate(self.lanes) if l is not None]
        if active and not progressed:
            # pool jammed: keep only the oldest lane (servable by the
            # submit-time capacity check), requeue the rest
            oldest = min(active, key=lambda t: t[1].admitted_t)[0]
            for i, _ in active:
                if i != oldest:
                    self._preempt(i)
        for i, l in ((i, l) for i, l in enumerate(self.lanes)
                     if l is not None):
            if i in progressed:
                l.stalled_steps = 0
            else:
                l.stalled_steps += 1
                if l.stalled_steps > self.stall_patience:
                    self._preempt(i)  # stalled: hand its pages to the rest
        live = sum(l is not None for l in self.lanes)
        now = time.perf_counter()
        self._h_tick.observe(now - t_tick)
        self._g_lanes.set(live)
        self._g_queue.set(len(self.queue))
        self._g_used_pages.set(self.pool.used_pages)
        if self._tr.enabled:
            evict1 = self.prefix.evictions if self.prefix is not None else 0
            self._tr.complete(
                "tick", SCHED_TRACK, t_tick, now - t_tick,
                lanes=live, decode_lanes=decode_count,
                prefill_lanes=len(prefill), queue=len(self.queue),
                pages_allocated=self.pool._allocs - allocs0,
                cow_copies=int(self._c["cow_copies"].total - cow0),
                prefix_evictions=evict1 - evict0,
                used_pages=self.pool.used_pages)
        return live

    def _pack_rows(self, rows, toks, poss, n_rows: int, t_step: int,
                   cfg: Optional[ModelConfig] = None):
        """One fixed-shape batch from per-lane token and position lists, as
        device tensors, the positions shaped for ``cfg`` (default the
        target's; ``[B, T, 3]`` under M-RoPE).  Pad rows and columns carry
        the garbage position (never a negative one), so their writes land
        in the garbage page and every real row's ``kpos <= tpos`` mask
        excludes them."""
        tokens = np.zeros((n_rows, t_step), np.int32)
        positions = np.full((n_rows, t_step), self.pad_pos, np.int32)
        last_idx = np.zeros((n_rows,), np.int32)
        table = np.full((n_rows, self.W), GARBAGE_PAGE, np.int32)
        for r, i, l in rows:
            n = len(toks[i])
            tokens[r, :n] = toks[i]
            positions[r, :n] = poss[i]
            last_idx[r] = n - 1
            table[r, : len(l.pages)] = l.pages
        dev = self.device
        tokens, positions, table, last_idx = (
            torch.from_numpy(a).to(dev)
            for a in (tokens, positions, table, last_idx))
        return (tokens, mk_positions(cfg or self.cfg, positions), table,
                last_idx)

    def _submit_plan(self, phase: str, rows, poss) -> None:
        """analysis_debug gate: prove the page-aliasing invariants of one
        launch before it reaches the device.  ``rows`` = [(batch_row,
        lane_idx, lane)]; ``poss`` maps a lane index to the positions this
        launch writes for it.  A position past the lane's page table (the
        pad position) lands in the garbage page, whose aliasing the checker
        exempts.  Warmup's pad-only batches (no rows) write only there and
        are not submitted."""
        if not rows:
            return
        ps = self.page_size
        writes = []
        for _, i, l in rows:
            for pos in poss[i]:
                pi = pos // ps
                page = l.pages[pi] if 0 <= pi < len(l.pages) else GARBAGE_PAGE
                writes.append(PageWrite(lane=i, uid=l.req.uid, page=page,
                                        offset=pos % ps))
        touched = {w.page for w in writes}
        assert_plan_ok(TickPlan.build(
            phase=phase, page_size=ps, writes=writes,
            refcounts={p: self.pool.refcount(p) for p in touched
                       if 0 <= p < self.pool.n_pages},
            trie_pages=self.prefix.pages() if self.prefix is not None else (),
            free_pages=self.pool.free_page_ids(), garbage_page=GARBAGE_PAGE))
        self.plans_checked += 1

    def _run_batch(self, rows, plan, n_rows: int, t_step: int,
                   phase: str = "step") -> np.ndarray:
        """One call of the step for ``rows`` = [(batch_row, lane_idx, lane)],
        lane i feeding its next ``plan[i]`` context tokens; returns the last
        real token's logits [n_rows, V] on the host."""
        toks = {i: l.ctx[l.pos: l.pos + plan[i]] for _, i, l in rows}
        poss = {i: range(l.pos, l.pos + plan[i]) for _, i, l in rows}
        if self.analysis_debug:
            self._submit_plan(phase, rows, poss)
        tokens, positions, table, last_idx = self._pack_rows(
            rows, toks, poss, n_rows, t_step)
        with self._issue("step", n_rows, t_step), torch.inference_mode():
            logits, self.caches = self._step(self.params, self.caches, tokens,
                                             positions, table, last_idx)
            logits = logits.float()
        return logits.cpu().numpy()  # the host waits here, outside the span

    def _hw_charge(self, req: Request, phase: str, n: int) -> float:
        """Price ``n`` executed token-passes of ``phase`` work on the DA
        hardware model: registry counters (labeled by phase) plus the
        request's own running total.  Returns the pJ charged (0.0 with no
        cost model).  Host-side float math only, so the accounting is the
        same with tracing on or off."""
        if self.hw is None or n <= 0:
            return 0.0
        pj_tok, ns_tok = self._hw_prices[phase]
        pj, ns = pj_tok * n, ns_tok * n
        self._c_hw_tokens.inc(n, phase=phase)
        self._c_hw_pj.inc(pj, phase=phase)
        self._c_hw_ns.inc(ns, phase=phase)
        req.hw_pj += pj
        req.hw_ns += ns
        return pj

    def _prefill_phase(self, prefill, decode_count: int) -> set:
        """Up to ``prefill_lanes`` ingesting lanes advance one chunk each in
        a compact sub-batch; the token budget is what the decode lanes
        leave."""
        budget = self.token_budget - decode_count
        if budget <= 0 and decode_count > 0:
            return set()  # decode saturates the budget this tick
        sel = sorted(prefill, key=lambda t: t[1].admitted_t)[: self.prefill_lanes]
        plan: Dict[int, int] = {}
        for i, l in sel:
            n = min(l.remaining, self.prefill_chunk, budget)
            plan[i] = self._ensure_pages(l, n)  # may shrink or defer
            budget -= plan[i]
        rows = [(r, i, l) for r, (i, l) in enumerate(
            (i, l) for i, l in sel if plan[i] > 0)]
        if not rows:
            return set()
        # capped at prefill_chunk, so a non-pow2 chunk keeps warmup's shape
        t_step = min(pow2_bucket(max(plan[i] for _, i, _ in rows)),
                     self.prefill_chunk)
        t0 = time.perf_counter()
        logits = self._run_batch(rows, plan, self.prefill_lanes, t_step,
                                 phase="prefill")
        now = time.perf_counter()
        if self._tr.enabled:
            for r, i, l in rows:
                extra = ({"est_pj": self._hw_prices["prefill"][0] * plan[i]}
                         if self.hw is not None else {})
                self._tr.complete("prefill_chunk", request_track(l.req.uid),
                                  t0, now - t0, tokens=plan[i], pos=l.pos,
                                  **extra)
            self._tr.complete("prefill", SCHED_TRACK, t0, now - t0,
                              lanes=len(rows), t_step=t_step)
        for r, i, l in rows:
            l.pos += plan[i]
            self._hw_charge(l.req, "prefill", plan[i])
            self._c["ctx_tokens"].inc(plan[i])
            self._maybe_cache_prefix(l)  # before _sample can free the pages
            if l.remaining == 0:  # chunk covered the last unseen token
                self._sample(i, l, logits[r], now)
        return {i for _, i, _ in rows}

    def _decode_phase(self, decode) -> set:
        """Decoding lanes advance one token in a [width, 1] step; a lane that
        finds no page for its next token preempts the youngest other lane."""
        ready = set()
        for i, l in sorted(decode, key=lambda t: t[1].admitted_t):
            if self.lanes[i] is not l:
                continue  # preempted as a victim earlier in this loop
            got = self._ensure_pages(l, 1)
            while got == 0:
                victim = self._youngest_other(i)
                if victim is None:
                    break
                self._preempt(victim)
                got = self._ensure_pages(l, 1)
            if got:
                ready.add(i)
        live = [(i, l) for i, l in decode if i in ready and self.lanes[i] is l]
        if not live:
            return set()
        width = width_bucket(len(live), self.b)
        rows = [(r, i, l) for r, (i, l) in enumerate(live)]
        t0 = time.perf_counter()
        logits = self._run_batch(rows, {i: 1 for i, _ in live}, width, 1,
                                 phase="decode")
        now = time.perf_counter()
        if self._tr.enabled:
            extra = ({"est_pj": self._hw_prices["decode"][0] * len(live)}
                     if self.hw is not None else {})
            self._tr.complete("decode", SCHED_TRACK, t0, now - t0,
                              lanes=len(live), width=width, **extra)
        for r, i, l in rows:
            l.pos += 1
            self._hw_charge(l.req, "decode", 1)
            self._c["ctx_tokens"].inc()
            self._maybe_cache_prefix(l)  # before _sample can free the pages
            self._sample(i, l, logits[r], now)
        return {i for i, _ in live}

    # -- speculative decoding ------------------------------------------------
    def _fresh_spec_state(self) -> Dict[str, Any]:
        return {"on": True, "ema": None, "rounds": 0}

    def _partition_spec(self, decode):
        """Split decode lanes into spec-staged and plain.  A lane speculates
        while its request's speculation is on, it can still emit ≥ 2 tokens,
        the gamma+1 window stays inside the page table, and the extra pages
        stage in one go (else it decodes plainly this tick, where
        preemption lives).  Staging takes a page checkpoint first, so the
        round's growth rolls back exactly."""
        if self.spec is None:
            return [], decode
        g = self.spec.gamma
        addressable = (self.W - 1) * self.page_size
        staged, plain = [], []
        for i, l in sorted(decode, key=lambda t: t[1].admitted_t):
            st = self._spec_state.setdefault(l.req.uid,
                                             self._fresh_spec_state())
            allowance = min(l.req.max_new_tokens - len(l.req.generated),
                            self.max_len - len(l.ctx))
            ok = st["on"] and allowance >= 2 and l.pos + g + 1 <= addressable
            if ok:
                ck = kv_checkpoint(self.pool, l.pages)
                # drafts never write into (or roll back) a shared page
                if not self._cow_shared_page(l):
                    ok = False
                need = pages_for(l.pos + g + 1, self.page_size) - len(l.pages)
                if ok and need > 0:
                    got = self._alloc(need)
                    if got is None:
                        ok = False
                    else:
                        l.pages.extend(got)
                if ok:
                    staged.append((i, l, ck))
            if not ok:
                plain.append((i, l))
        return staged, plain

    def _run_draft(self, rows, toks, poss, width: int,
                   t_step: int) -> np.ndarray:
        """One fused draft call → all gamma proposals [width, gamma]."""
        if self.analysis_debug and self._provider.shared_cache:
            # the fused call feeds poss[i], then gamma - 1 single-token steps
            # each write the next position.  An own-cache provider writes
            # its own pool, which the target pool's ledger does not govern.
            g = self.spec.gamma
            self._submit_plan("spec_draft", rows, {
                i: list(poss[i]) + [poss[i][-1] + 1 + k for k in range(g - 1)]
                for _, i, _ in rows})
        batch = self._pack_rows(rows, toks, poss, width, t_step,
                                self._provider.cfg)
        shared = self._provider.shared_cache
        with self._issue("draft", width, t_step), torch.inference_mode():
            drafts, new = self._draft_step(
                self._provider.params,
                self.caches if shared else self.draft_caches, *batch)
        if shared:
            self.caches = new
        else:
            self.draft_caches = new
        return drafts.cpu().numpy()

    def _run_ingest(self, rows, toks, poss, width: int, t_step: int) -> None:
        batch = self._pack_rows(rows, toks, poss, width, t_step,
                                self._provider.cfg)
        with self._issue("ingest", width, t_step), torch.inference_mode():
            _, self.draft_caches = self._draft_ingest(
                self._provider.params, self.draft_caches, *batch)

    def _draft_catch_up(self, rows) -> None:
        """Own-cache providers: ingest, in prefill-chunk slices, the context
        the draft model has not seen (first round after admission or
        preemption), so the fused draft call keeps its small shapes."""
        chunk = self.prefill_chunk
        while True:
            pend = [(i, l) for _, i, l in rows if l.pos - l.draft_pos >= chunk]
            if not pend:
                return
            toks: Dict[int, List[int]] = {}
            poss: Dict[int, List[int]] = {}
            for i, l in pend:
                n = min(chunk, l.pos - l.draft_pos)
                toks[i] = list(l.ctx[l.draft_pos: l.draft_pos + n])
                poss[i] = list(range(l.draft_pos, l.draft_pos + n))
            t = min(pow2_bucket(max(len(x) for x in toks.values())), chunk)
            sub = [(r, i, l) for r, (i, l) in enumerate(pend)]
            self._run_ingest(sub, toks, poss, width_bucket(len(pend), self.b), t)
            for i, l in pend:
                l.draft_pos += len(toks[i])
                self._hw_charge(l.req, "draft_ingest", len(toks[i]))

    def _run_verify(self, rows, toks, poss, width: int,
                    t_step: int) -> np.ndarray:
        """One full-precision verify call over the windows; returns the
        greedy token at every position, [width, t_step], on the host."""
        if self.analysis_debug:
            self._submit_plan("spec_verify", rows, poss)
        tokens, positions, table, _ = self._pack_rows(rows, toks, poss, width,
                                                      t_step)
        with self._issue("verify", width, t_step), torch.inference_mode():
            logits, self.caches = self._verify_step(
                self.params, self.caches, tokens, positions, table)
            best = torch.argmax(logits, dim=-1)
        return best.cpu().numpy()

    def _spec_phase(self, staged) -> set:
        """One speculative round for the staged lanes: one fused draft call
        (gamma proposals), one batched full-precision verify over the gamma+1
        window, greedy acceptance, then page rollback of the rejected
        growth."""
        g = self.spec.gamma
        rows = [(r, i, l) for r, (i, l, _) in enumerate(staged)]
        ckpts = {i: ck for i, _, ck in staged}
        width = width_bucket(len(rows), self.b)
        shared = self._provider.shared_cache
        toks: Dict[int, List[int]] = {}
        poss: Dict[int, List[int]] = {}
        start_pos: Dict[int, int] = {}
        t0 = time.perf_counter()
        if not shared:
            self._draft_catch_up(rows)
        for _, i, l in rows:
            start_pos[i] = l.pos
            s = l.pos if shared else min(l.draft_pos, l.pos)
            toks[i] = list(l.ctx[s: l.pos + 1])
            poss[i] = list(range(s, l.pos + 1))
        t1 = min(pow2_bucket(max(len(t) for t in toks.values())),
                 max(self.prefill_chunk, 1))
        # the fused call feeds len(toks[i]) tokens (catch-up and x_t, giving
        # the first proposal), then gamma - 1 single-token steps
        feed = {i: len(toks[i]) for _, i, _ in rows}
        dmat = self._run_draft(rows, toks, poss, width, t1)
        self._c["draft_steps"].inc(g)
        drafts = {i: [int(t) for t in dmat[r]] for r, i, _ in rows}
        # verify [x_t, d_1..d_g] at full precision: logits at every position,
        # and exact KV over the draft's rows
        for _, i, l in rows:
            toks[i] = [l.ctx[start_pos[i]]] + drafts[i]
            poss[i] = list(range(start_pos[i], start_pos[i] + g + 1))
        vtok = self._run_verify(rows, toks, poss, width, pow2_bucket(g + 1))
        self._c["verify_steps"].inc()
        now = time.perf_counter()
        out = set()
        for r, i, l in rows:
            verify = [int(t) for t in vtok[r, : g + 1]]
            m = greedy_accept(drafts[i], verify)
            # the round's work is charged before its tokens: a request that
            # finishes in this round observes req_hw_pj with the round in it
            round_pj = (self._hw_charge(l.req, "draft", feed[i] + g - 1)
                        + self._hw_charge(l.req, "verify", g + 1))
            emitted = self._accept_tokens(i, l, verify[:m], now)
            l.pos = start_pos[i] + emitted
            # own-cache draft KV is valid for the matched prefix only
            l.draft_pos = min(start_pos[i] + g, l.pos)
            self._c["ctx_tokens"].inc(emitted)
            self._c["spec_rounds"].inc()
            self._c["drafted_tokens"].inc(g)
            self._c["accepted_drafts"].inc(m - 1)
            if m == g + 1:
                self._c["bonus_tokens"].inc()
            if self._tr.enabled:
                extra = {"est_pj": round_pj} if self.hw is not None else {}
                self._tr.complete("spec_round", request_track(l.req.uid),
                                  t0, now - t0, drafted=g, accepted=m - 1,
                                  emitted=emitted, **extra)
            self._update_spec_state(l.req.uid, (m - 1) / g)
            if self.lanes[i] is l:  # still running: release rejected pages
                kv_rollback(self.pool, l.pages, ckpts[i],
                            keep=pages_for(l.pos, self.page_size))
                self._maybe_cache_prefix(l)
            out.add(i)
        return out

    def _accept_tokens(self, i: int, lane: _Lane, tokens, now: float) -> int:
        """Emit verified tokens in order; returns how many were emitted
        before a finish condition."""
        emitted = 0
        for tok in tokens:
            emitted += 1
            if self._emit(i, lane, tok, now):
                break
        return emitted

    def _update_spec_state(self, uid: int, rate: float) -> None:
        """Per-request acceptance EMA; a request below the floor after
        ``warmup_rounds`` stops speculating."""
        st = self._spec_state[uid]
        a = self.spec.ema_alpha
        st["ema"] = rate if st["ema"] is None else a * rate + (1 - a) * st["ema"]
        st["rounds"] += 1
        if (st["on"] and st["rounds"] >= self.spec.warmup_rounds
                and st["ema"] < self._spec_floor):
            st["on"] = False
            self._c["spec_disabled"].inc()

    def _sample(self, i: int, lane: _Lane, row: np.ndarray, now: float) -> None:
        req = lane.req
        if self.greedy:
            tok = int(np.argmax(row))
        else:
            gen = torch.Generator().manual_seed((req.uid << 20)
                                                + len(req.generated))
            probs = torch.softmax(torch.from_numpy(row).double(), dim=-1)
            tok = int(torch.multinomial(probs, 1, generator=gen))
        self._emit(i, lane, tok, now)

    def _emit(self, i: int, lane: _Lane, tok: int, now: float) -> bool:
        """Append one token to the lane's request (stream callback, timing);
        finish the request and free its pages when it is done.  Returns
        whether it finished.  ``now`` is read after the logits reached the
        host, so on the card it follows the device's work."""
        req = lane.req
        if not req.generated:
            req.first_token_t = now
            self._h_ttft.observe(now - req.submit_t)
        elif req.token_times:
            self._h_itl.observe(now - req.token_times[-1])
        req.token_times.append(now)
        req.generated.append(tok)
        lane.ctx.append(tok)
        self._c["out_tokens"].inc()
        if self._tr.enabled:
            # the value token_times holds: the trace rebuilds TTFT and ITL
            # exactly
            self._tr.instant("token", request_track(req.uid), ts=now,
                             n=len(req.generated))
        if req.on_token is not None:
            req.on_token(req.uid, tok)
        if (tok == req.eos_id or len(req.generated) >= req.max_new_tokens
                or len(lane.ctx) >= self.max_len):
            req.finish_t = now
            self.pool.free(lane.pages)
            self.done[req.uid] = req
            self.lanes[i] = None
            if self.hw is not None:
                self._h_req_pj.observe(req.hw_pj)
            if self._tr.enabled:
                track = request_track(req.uid)
                self._tr.instant("finish", track, ts=now,
                                 tokens=len(req.generated))
                self._tr.end("running", track, ts=now)
            return True
        return False

    def run(self, max_steps: int = 100_000) -> Dict[int, Request]:
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return self.done

    def warmup(self) -> int:
        """Run every step shape once (decode widths × prefill chunk buckets,
        and with spec the draft and verify shapes of each width) on pad-only
        batches, whose writes land in the garbage page.  Returns the number
        of shapes run."""
        shapes = [(w, 1) for w in width_buckets(self.b)]
        t = 1
        while t < self.prefill_chunk:
            shapes.append((self.prefill_lanes, t))
            t *= 2
        shapes.append((self.prefill_lanes, self.prefill_chunk))
        shapes = list(dict.fromkeys(shapes))
        for bw, ts in shapes:
            self._run_batch([], {}, bw, ts)
        n_spec = 0
        if self.spec is not None:
            tv = pow2_bucket(self.spec.gamma + 1)
            for bw in width_buckets(self.b):
                self._run_draft([], {}, {}, bw, 1)
                self._run_verify([], {}, {}, bw, tv)
                n_spec += 2
        return len(shapes) + n_spec

    # -- maintenance / metrics -----------------------------------------------
    def defrag(self) -> None:
        """Compact live pages to the pool's low-index prefix (the page tables
        move with them).  An own-cache draft's pools and the prefix trie's
        pages move under the same remap."""
        tables = [l.pages for l in self.lanes if l is not None]
        defrag({"target": self.caches, "draft": self.draft_caches}
               if self.draft_caches is not None else self.caches,
               self.pool, tables, trie=self.prefix)

    def metrics(self) -> Dict[str, Any]:
        wall = (time.perf_counter() - self._start_t) if self._start_t else 0.0
        spec = None
        if self.spec is not None:
            drafted = self.drafted_tokens
            spec = {
                "provider": self._provider.name,
                "gamma": self.spec.gamma,
                "cost_ratio": round(self._provider.cost_ratio, 4),
                "rounds": self.spec_rounds,
                "draft_steps": self.draft_steps,
                "verify_steps": self.verify_steps,
                "drafted_tokens": drafted,
                "accepted_drafts": self.accepted_drafts,
                "acceptance_rate": (self.accepted_drafts / drafted
                                    if drafted else 0.0),
                "bonus_tokens": self.bonus_tokens,
                "draft_compiles": self.draft_compiles,
                "verify_compiles": self.verify_compiles,
                "disable_floor": round(self._spec_floor, 4),
                "disabled_requests": self.spec_disabled,
                "enabled_requests": sum(
                    1 for s in self._spec_state.values() if s["on"]),
            }
        prefix = None
        if self.prefix is not None:
            pc = self.prefix
            prefix = {
                "lookups": self.prefix_lookups,
                "hits": self.prefix_hits,
                # token-weighted: the share of admitted prompt tokens whose
                # KV came off cached pages
                "hit_rate": (pc.cached_tokens / pc.lookup_tokens
                             if pc.lookup_tokens else 0.0),
                "cached_tokens": pc.cached_tokens,
                "evictions": pc.evictions,
                "trie_pages": pc.n_pages,
                "cow_copies": self.cow_copies,
            }
        # the run's estimated cost on the paper's DA hardware: the static
        # per-token table plus live totals (executed token-passes per phase ×
        # the phase's price), the bit-slicing counterfactual priced over the
        # same work
        hw = None
        if self.hw is not None:
            hw = self.hw.summary()
            phases = sorted(self._hw_prices)
            tokens = {p: self._c_hw_tokens.value(phase=p) for p in phases}
            est_pj = {p: self._c_hw_pj.value(phase=p) for p in phases}
            est_ns = {p: self._c_hw_ns.value(phase=p) for p in phases}
            total_pj = sum(est_pj.values())
            total_ns = sum(est_ns.values())
            bs_pj = sum(self._hw_bs[p][0] * tokens[p] for p in phases)
            bs_ns = sum(self._hw_bs[p][1] * tokens[p] for p in phases)
            out_toks = self.out_tokens
            hw.update({
                "tokens": tokens,
                "est_pj": {**est_pj, "total": total_pj},
                "est_ns": {**est_ns, "total": total_ns},
                "pj_per_out_token": (total_pj / out_toks
                                     if out_toks else 0.0),
                "live": {
                    "da_pj": total_pj,
                    "bitslice_pj": bs_pj,
                    "energy_ratio": bs_pj / total_pj if total_pj else 0.0,
                    "da_ns": total_ns,
                    "bitslice_ns": bs_ns,
                    "latency_ratio": bs_ns / total_ns if total_ns else 0.0,
                },
            })
            if self._hw_draft is not None:
                hw["draft"] = dict(self._hw_draft)
        bpt = sum(kv_token_bytes(self.cfg, dt)
                  for dt in self.kv_dtypes.values()) * self.cfg.n_periods
        fp_bpt = (kv_token_bytes(self.cfg, "fp16") * len(self.kv_dtypes)
                  * self.cfg.n_periods)
        pool_stats = self.pool.stats()
        kv = {
            "kv_dtypes": dict(self.kv_dtypes),
            "bytes_per_token": bpt,
            "fp_bytes_per_token": fp_bpt,
            "capacity_multiplier": fp_bpt / bpt if bpt else 0.0,
            "page_bytes": pool_stats["page_bytes"],
            "used_bytes": pool_stats["used_bytes"],
            "free_bytes": pool_stats["free_bytes"],
            "pool_bytes": kv_cache_nbytes(self.caches),
        }
        return {
            **base_metrics("paged", self.done, self.out_tokens),
            "ctx_tokens": self.ctx_tokens,
            "steps": self.steps,
            "preemptions": self.preemptions,
            "step_compiles": self.step_compiles,
            "wall_s": wall,
            "tokens_per_s": self.out_tokens / wall if wall > 0 else 0.0,
            "pool": pool_stats,
            "kv": kv,
            "hw": hw,
            "spec": spec,
            "prefix_cache": prefix,
        }
