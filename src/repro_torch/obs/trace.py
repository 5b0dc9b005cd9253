"""Structured request/scheduler tracing for the paged serving runtime.

A :class:`TraceRecorder` is a bounded ring buffer of host-side events — the
per-request lifecycle (submit → admit → prefill-chunk × N → decode-tick × M
→ preempt/re-admit → spec rounds → finish) and the per-tick scheduler story
(batch shape bucket, lanes, pages allocated/COW'd/evicted).  Events carry
``perf_counter`` timestamps, the SAME clock the latency metrics use, so a
trace reconstructs TTFT/ITL exactly (the token events are stamped with the
very ``now`` the scheduler put into ``Request.token_times``).

Events export to Chrome ``trace_event`` JSON (``repro_torch.obs.export``) and load
in Perfetto / ``chrome://tracing``: each request is a named track, spans
nest by B/E pairing, scheduler ticks are complete ("X") events with the
shape/page args attached.

Tracing is OFF by default (``TraceRecorder(enabled=False)`` is a no-op whose
every method is one attribute test) and must never perturb decode — token
bit-identity with tracing on/off is test-asserted.  The ring buffer bounds
memory on long serves: the newest ``capacity`` events win, and
:meth:`span_balance` is computed from lifetime depth counters, not the
buffer, so balance checks survive wraparound.

``device_span`` bridges host spans to device profiles: inside it, a
``torch.profiler.record_function`` range (a user annotation that
``torch.profiler`` puts on its timeline, around the kernels launched inside
it) plus, on a CUDA machine, an NVTX range make the device timeline line up
with the host-side request spans when both are captured.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import torch

#: Track name for scheduler-level (per-tick) events.
SCHED_TRACK = "scheduler"


def request_track(uid: int) -> str:
    return f"req:{uid}"


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One structured event.

    ``ph`` follows the Chrome trace_event phases this recorder emits:
    ``"B"``/``"E"`` span begin/end, ``"X"`` complete (carries ``dur``),
    ``"i"`` instant.  ``ts``/``dur`` are seconds on the perf_counter clock
    (export converts to microseconds).
    """

    name: str
    ph: str
    ts: float
    track: str
    dur: float = 0.0
    args: Optional[Dict[str, Any]] = None


class TraceRecorder:
    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self.events: deque = deque(maxlen=capacity)
        # lifetime span-depth ledger per track: +1 on begin, -1 on end.
        # Balance is judged on these, not the ring buffer, so an evicted
        # "B" event cannot fake an unbalanced trace.
        self._depth: Dict[str, int] = {}
        self.dropped = 0
        self._t0 = time.perf_counter()

    # -- emission ------------------------------------------------------------
    def _push(self, ev: TraceEvent) -> None:
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        self.events.append(ev)

    def begin(self, name: str, track: str, ts: Optional[float] = None,
              **args) -> None:
        if not self.enabled:
            return
        self._depth[track] = self._depth.get(track, 0) + 1
        self._push(TraceEvent(name, "B", self._now(ts), track,
                              args=args or None))

    def end(self, name: str, track: str, ts: Optional[float] = None,
            **args) -> None:
        if not self.enabled:
            return
        self._depth[track] = self._depth.get(track, 0) - 1
        self._push(TraceEvent(name, "E", self._now(ts), track,
                              args=args or None))

    def complete(self, name: str, track: str, t_start: float,
                 dur: float, **args) -> None:
        """One already-finished span (per-tick phases: start time + duration
        measured by the caller)."""
        if not self.enabled:
            return
        self._push(TraceEvent(name, "X", t_start, track, dur=dur,
                              args=args or None))

    def instant(self, name: str, track: str, ts: Optional[float] = None,
                **args) -> None:
        if not self.enabled:
            return
        self._push(TraceEvent(name, "i", self._now(ts), track,
                              args=args or None))

    @contextlib.contextmanager
    def span(self, name: str, track: str, **args) -> Iterator[None]:
        """B/E pair guarded by try/finally — a span opened is a span closed
        even when the body raises (the balance invariant the tests assert)."""
        self.begin(name, track, **args)
        try:
            yield
        finally:
            self.end(name, track)

    def _now(self, ts: Optional[float]) -> float:
        return time.perf_counter() if ts is None else ts

    # -- inspection ----------------------------------------------------------
    def span_balance(self) -> Dict[str, int]:
        """Track → currently-open span depth (every value should be 0 once
        serving drains; nonzero means a begin without its end)."""
        return {t: d for t, d in self._depth.items() if d != 0}

    def drain(self) -> List[TraceEvent]:
        out = list(self.events)
        self.events.clear()
        return out

    def __len__(self) -> int:
        return len(self.events)


@contextlib.contextmanager
def device_span(name: str, enabled: bool = True,
                cuda: bool = False) -> Iterator[None]:
    """Host→device profiling bridge around a device dispatch.

    Wraps the body in ``torch.profiler.record_function(name)`` so a
    ``torch.profiler`` capture shows this host span on its timeline, with
    the kernels it launched inside it; with ``cuda`` (the dispatch's tensors
    live on the card) an NVTX range of the same name marks it for CUDA-side
    tools too.  Neither synchronises: the span times the host's dispatch,
    never the device.  No-op (one branch) when disabled.
    """
    if not enabled:
        yield
        return
    with torch.profiler.record_function(name):
        if not cuda:
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def kernels_in_spans(trace: Any,
                     prefix: str = "paged_step[") -> Dict[str, List[int]]:
    """Device work of a ``torch.profiler`` capture, by name, split by whether
    the host launched it inside a ``device_span`` whose name starts with
    ``prefix``: ``{name: [inside, outside]}``.

    ``trace`` is the finished profiler, or its Chrome trace as a dict.  Each
    kernel, memcpy and memset there carries the CUPTI correlation id of the
    runtime call that launched it; that call's host timestamp falls inside a
    span's annotation or not."""
    if hasattr(trace, "export_chrome_trace"):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            trace.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
    spans, launched = [], {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation" and ev["name"].startswith(prefix):
            spans.append((ev["ts"], ev["ts"] + ev.get("dur", 0)))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = ev["ts"]
    out: Dict[str, List[int]] = {}
    for ev in trace.get("traceEvents", ()):
        if ev.get("ph") != "X" or ev.get("cat") not in (
                "kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts = launched.get((ev.get("args") or {}).get("correlation"))
        inside = ts is not None and any(a <= ts <= b for a, b in spans)
        out.setdefault(ev["name"], [0, 0])[0 if inside else 1] += 1
    return out


# -- module default ----------------------------------------------------------
# Disabled by default: tracing is opt-in per engine (ServeEngine(trace=True)
# or --trace-out) and costs one attribute test per call site when off.
_default = TraceRecorder(enabled=False)


def default_tracer() -> TraceRecorder:
    return _default
