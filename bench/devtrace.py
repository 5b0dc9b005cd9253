"""The traced slice's device timeline, from ``torch.profiler``'s Chrome
trace: every kernel, memset and memcpy, the host op that launched it (by
the CUPTI correlation id of its launch) and the host annotation that
launch fell in; the union of device activity and its idle gaps.

The slice is the span of the harness's ``bench.tick`` annotations (one
per scheduler tick it drives while the profiler runs).  The port's kernel
entries are custom ops (``repro_torch::<name>``), recorded with their
input shapes.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Dict, List, Optional, Tuple

TICK = "bench.tick"
#: host label of device idle time outside any annotation
OUTSIDE = "harness (outside ticks)"
OP_PREFIX = "repro_torch::"
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


@dataclasses.dataclass
class Activity:
    name: str
    start: float          # us, the trace's clock
    dur: float            # us
    op: Optional[str]     # repro_torch::<entry> that launched it, else None


@dataclasses.dataclass
class Slice:
    start: float
    end: float
    activities: List[Activity]
    ops: List[Tuple[str, list]]          # every repro_torch op call: (name, dims)
    gaps: List[Tuple[str, float]]        # (host label, us) of each idle gap
    ticks: int

    @property
    def wall_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds in which some device activity ran (their union)."""
        total, cur_s, cur_e = 0.0, None, None
        for a in sorted(self.activities, key=lambda a: a.start):
            s, e = max(a.start, self.start), min(a.start + a.dur, self.end)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e6

    def time_s(self, op: Optional[str] = None) -> float:
        """Device seconds of the activities launched by ``op`` (``""``: by no
        port op; None: all)."""
        return sum(a.dur for a in self.activities
                   if op is None or (a.op or "") == op) / 1e6


class _Intervals:
    """Host intervals of one thread, innermost lookup by time."""

    def __init__(self):
        self.items: List[Tuple[float, float, dict]] = []

    def add(self, s: float, e: float, ev: dict) -> None:
        self.items.append((s, e, ev))

    def done(self) -> None:
        self.items.sort(key=lambda t: t[0])
        self.starts = [t[0] for t in self.items]

    def innermost(self, ts: float) -> Optional[dict]:
        i = bisect.bisect_right(self.starts, ts)
        best = None
        # intervals of one thread nest: walk back while they may cover ts
        for s, e, ev in reversed(self.items[max(0, i - 64):i]):
            if s <= ts <= e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, ev)
        return best[2] if best else None


def load_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reduce_trace(trace: dict) -> Slice:
    """The :class:`Slice` of a Chrome trace holding ``bench.tick`` spans."""
    evs = [e for e in trace.get("traceEvents", ()) if e.get("ph") == "X"]
    ops: Dict[object, _Intervals] = {}
    notes: Dict[object, _Intervals] = {}
    launches: Dict[object, Tuple[float, object]] = {}
    ticks: List[Tuple[float, float]] = []
    op_calls: List[Tuple[str, list]] = []
    for e in evs:
        cat, ts, dur = e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0))
        if cat == "user_annotation":
            notes.setdefault(e.get("tid"), _Intervals()).add(ts, ts + dur, e)
            if e["name"] == TICK:
                ticks.append((ts, ts + dur))
        elif cat == "cpu_op" and e["name"].startswith(OP_PREFIX):
            ops.setdefault(e.get("tid"), _Intervals()).add(ts, ts + dur, e)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (ts, e.get("tid"))
    for group in (ops, notes):
        for iv in group.values():
            iv.done()
    if not ticks:
        raise ValueError(f"the trace holds no {TICK} annotation")
    start, end = min(s for s, _ in ticks), max(e for _, e in ticks)
    for iv in ops.values():
        for s, _, ev in iv.items:
            if start <= s <= end:
                op_calls.append((ev["name"], (ev.get("args") or {}).get("Input Dims")))
    acts: List[Activity] = []
    for e in evs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if ts + dur < start or ts > end:
            continue
        op = None
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None and launch[1] in ops:
            hit = ops[launch[1]].innermost(launch[0])
            if hit is not None:
                op = hit["name"]
        acts.append(Activity(e["name"], ts, dur, op))
    return Slice(start, end, acts, op_calls, _gaps(acts, notes, start, end), len(ticks))


def _gaps(acts: List[Activity], notes: Dict[object, _Intervals],
          start: float, end: float) -> List[Tuple[str, float]]:
    """Each idle stretch of the device between ``start`` and ``end``,
    labelled by the innermost host annotation around its midpoint."""
    out: List[Tuple[str, float]] = []
    cur = start
    for a in sorted(acts, key=lambda a: a.start):
        if a.start > cur:
            out.append((_label(notes, (cur + a.start) / 2), a.start - cur))
        cur = max(cur, a.start + a.dur)
    if end > cur:
        out.append((_label(notes, (cur + end) / 2), end - cur))
    return out


def _label(notes: Dict[object, _Intervals], ts: float) -> str:
    best = None
    for iv in notes.values():
        hit = iv.innermost(ts)
        if hit is not None and (best is None or hit["dur"] < best["dur"]):
            best = hit
    return best["name"] if best is not None else OUTSIDE


def breakdown(sl: Slice, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time by the
    host label it fell under, each ``[[name, seconds], ...]``."""
    by_name: Dict[str, float] = {}
    for a in sl.activities:
        by_name[a.name] = by_name.get(a.name, 0.0) + a.dur / 1e6
    idle: Dict[str, float] = {}
    for label, us in sl.gaps:
        idle[label] = idle.get(label, 0.0) + us / 1e6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_name), "idle_gaps": rank(idle)}
