"""Process-wide metrics registry for the serving runtime.

The Lynchpin-style premise: in-memory-compute performance claims are only
credible under systematic, reproducible measurement — so the runtime carries
its own telemetry substrate instead of every subsystem hand-rolling an
end-of-run snapshot dict.  Three instrument kinds, one registry:

* :class:`Counter` — monotonically increasing totals (tokens emitted,
  preemptions, COW copies), optionally labeled (``inc(1, backend="fused")``
  keeps one series per label set).
* :class:`Gauge` — last-write-wins levels (pages in use, live lanes).
* :class:`Histogram` — streaming fixed-bucket distributions.  Buckets are
  geometric, chosen at construction; p50/p99 are answerable *live* (bucket
  interpolation), not only after the run ends, and the cumulative-bucket
  layout exports directly as a Prometheus histogram.

Cost model: every instrument is a dict lookup + a float add on the hot path,
and a disabled registry (``MetricsRegistry(enabled=False)``) short-circuits
each operation to one attribute test — observability must never perturb the
decode loop it measures (token identity with metrics on/off is
test-asserted).  Instruments are created once (``registry.counter(...)`` is
get-or-create) and written many times.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

#: Version stamp for every exported snapshot / BENCH_*.json so downstream
#: consumers (dashboards, trend scripts) can detect schema drift.
#: v2: hardware-cost block (``metrics()["hw"]``, ``hw_*`` series,
#: ``req_hw_pj`` histogram, ``est_pj``/``est_ns`` trace-span args).
METRICS_SCHEMA_VERSION = 2

#: Geometric latency buckets: 10 us .. ~100 s, factor ~2.15 (21 buckets).
#: Wide enough for TTFT on a cold compile and tight enough that decode-loop
#: percentiles resolve to ~2x.
TIME_BUCKETS: Tuple[float, ...] = tuple(
    1e-5 * (2.15 ** i) for i in range(21)
)

#: Generic magnitude buckets (token counts, page counts): 1 .. ~1e6, pow2.
COUNT_BUCKETS: Tuple[float, ...] = tuple(float(2 ** i) for i in range(21))

#: Per-request estimated energy (pJ): decades from 100 pJ to ~10 mJ — a
#: single CONV1 VMM is ~1e2 pJ, a long LM request runs to ~1e10+ pJ.
ENERGY_BUCKETS: Tuple[float, ...] = tuple(
    10.0 ** (2 + 0.5 * i) for i in range(17)
)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Instrument:
    """Shared shell: name, help text, per-label-set series storage."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", enabled: bool = True):
        self.name = name
        self.help = help
        self.enabled = enabled

    def series(self):  # pragma: no cover - overridden
        raise NotImplementedError


class Counter(_Instrument):
    kind = "counter"

    def __init__(self, name: str, help: str = "", enabled: bool = True):
        super().__init__(name, help, enabled)
        self._v: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        if not self.enabled:
            return
        key = _label_key(labels)
        self._v[key] = self._v.get(key, 0.0) + n

    def value(self, **labels) -> float:
        return self._v.get(_label_key(labels), 0.0)

    @property
    def total(self) -> float:
        """Sum across every label set (the unlabeled common case reads the
        single () series)."""
        return sum(self._v.values())

    def series(self) -> Iterable[Tuple[LabelKey, float]]:
        return self._v.items()


class Gauge(_Instrument):
    kind = "gauge"

    def __init__(self, name: str, help: str = "", enabled: bool = True):
        super().__init__(name, help, enabled)
        self._v: Dict[LabelKey, float] = {}

    def set(self, v: float, **labels) -> None:
        if not self.enabled:
            return
        self._v[_label_key(labels)] = float(v)

    def value(self, **labels) -> float:
        return self._v.get(_label_key(labels), 0.0)

    def series(self) -> Iterable[Tuple[LabelKey, float]]:
        return self._v.items()


class Histogram(_Instrument):
    """Fixed-bucket streaming histogram with live percentile estimates.

    ``buckets`` are upper bounds (le) of each bin; observations beyond the
    last bound land in the implicit +Inf bin.  ``percentile`` finds the bin
    where the cumulative count crosses the quantile and interpolates
    linearly inside it — a t-digest-free estimate whose error is bounded by
    the bucket ratio (~2x here), available at any instant of the run.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = TIME_BUCKETS,
                 enabled: bool = True):
        super().__init__(name, help, enabled)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[LabelKey, List[int]] = {}
        self._sum: Dict[LabelKey, float] = {}
        self._n: Dict[LabelKey, int] = {}

    def observe(self, v: float, **labels) -> None:
        if not self.enabled:
            return
        key = _label_key(labels)
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts[key] = [0] * (len(self.buckets) + 1)
            self._sum[key] = 0.0
            self._n[key] = 0
        # linear scan is fine: ~21 bins, and the common observations (ITL)
        # land in the first few
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        self._sum[key] += v
        self._n[key] += 1

    def count(self, **labels) -> int:
        return self._n.get(_label_key(labels), 0)

    def sum(self, **labels) -> float:
        return self._sum.get(_label_key(labels), 0.0)

    def percentile(self, q: float, **labels) -> float:
        """Live quantile estimate (q in [0, 100])."""
        key = _label_key(labels)
        counts = self._counts.get(key)
        n = self._n.get(key, 0)
        if not counts or n == 0:
            return 0.0
        target = q / 100.0 * n
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            lo = self.buckets[i - 1] if 0 < i <= len(self.buckets) else 0.0
            hi = (self.buckets[i] if i < len(self.buckets)
                  else self.buckets[-1] * 2)
            if cum + c >= target:
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.buckets[-1] * 2

    def series(self) -> Iterable[Tuple[LabelKey, List[int]]]:
        return self._counts.items()


class MetricsRegistry:
    """Named instruments, one namespace, snapshot/export-ready.

    ``enabled=False`` builds a registry whose instruments all short-circuit:
    the serving runtime can keep its instrumentation calls unconditionally
    inline while a benchmark measures the un-instrumented hot loop.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._instruments: Dict[str, _Instrument] = {}
        self._lock = threading.Lock()

    # -- get-or-create -------------------------------------------------------
    def _get(self, cls, name: str, help: str, **kw) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help=help, enabled=self.enabled, **kw)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {inst.kind}, "
                    f"requested {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = TIME_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        return self._instruments.get(name)

    def instruments(self) -> Dict[str, _Instrument]:
        return dict(self._instruments)

    # -- views ---------------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """One machine-readable dict of every series: counters/gauges map
        ``name`` (or ``name{k=v,...}``) to value; histograms to
        ``{count, sum, p50, p99}``.  Deterministic key order."""
        out: Dict[str, object] = {
            "metrics_schema_version": METRICS_SCHEMA_VERSION}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if isinstance(inst, Histogram):
                for key, _ in sorted(inst.series()):
                    lbl = _fmt_labels(key)
                    out[f"{name}{lbl}"] = {
                        "count": inst.count(**dict(key)),
                        "sum": inst.sum(**dict(key)),
                        "p50": inst.percentile(50, **dict(key)),
                        "p99": inst.percentile(99, **dict(key)),
                    }
            else:
                for key, v in sorted(inst.series()):
                    out[f"{name}{_fmt_labels(key)}"] = v
        return out

    def reset(self) -> None:
        """Drop every instrument (tests; a fresh engine makes a fresh
        registry instead)."""
        with self._lock:
            self._instruments.clear()


def _fmt_labels(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in key) + "}"


# -- module default ----------------------------------------------------------
# One process-wide registry for code without an engine in hand (kernel-level
# counters, ad-hoc scripts).  Engines build their OWN registry so parallel
# engines in one process (e.g. the spec-decode benchmark's paired runs) never
# share series.
_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default
