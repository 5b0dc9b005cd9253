"""Observability layer for the serving runtime.

``Observability`` bundles the two halves every instrumented component
takes: a :class:`MetricsRegistry` (always-on counters/gauges/histograms;
cheap enough to leave enabled) and a :class:`TraceRecorder` (structured
event ring buffer; opt-in, off by default).  Engines build their own
bundle so parallel engines in one process never share series.

The port's copy of the reference's ``repro.obs``: the registry, exporters,
validators and the regression gate are the reference's framework-free code;
``device_span`` annotates ``torch.profiler`` (and NVTX on the card), and
``hwcost.from_frozen`` walks the port's per-layer params.
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.metrics import (
    COUNT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    METRICS_SCHEMA_VERSION,
    MetricsRegistry,
    TIME_BUCKETS,
    default_registry,
)
from repro_torch.obs.trace import (
    SCHED_TRACK,
    TraceEvent,
    TraceRecorder,
    default_tracer,
    device_span,
    kernels_in_spans,
    request_track,
)
from repro_torch.obs.export import (
    chrome_trace,
    prometheus_text,
    validate_chrome_trace,
    validate_hw_block,
    validate_metrics_json,
    validate_prometheus_text,
    write_chrome_trace,
    write_prometheus,
)

#: hwcost names resolve lazily (PEP 562): the CLI tools (check / regress)
#: import this package and must stay importable without the core stack.
_HWCOST_NAMES = {"HardwareCostModel", "LayerGeom", "bitslice_design",
                 "da_design", "draft_price"}


def __getattr__(name):
    if name in _HWCOST_NAMES:
        from repro_torch.obs import hwcost

        return getattr(hwcost, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass
class Observability:
    """Registry + tracer pair threaded through a serving stack."""

    registry: MetricsRegistry
    tracer: TraceRecorder

    @classmethod
    def make(cls, metrics: bool = True, trace: bool = False,
             trace_capacity: int = 65536) -> "Observability":
        return cls(registry=MetricsRegistry(enabled=metrics),
                   tracer=TraceRecorder(capacity=trace_capacity,
                                        enabled=trace))


__all__ = [
    "COUNT_BUCKETS",
    "Counter",
    "Gauge",
    "HardwareCostModel",
    "Histogram",
    "LayerGeom",
    "METRICS_SCHEMA_VERSION",
    "MetricsRegistry",
    "Observability",
    "SCHED_TRACK",
    "TIME_BUCKETS",
    "TraceEvent",
    "TraceRecorder",
    "bitslice_design",
    "chrome_trace",
    "da_design",
    "default_registry",
    "default_tracer",
    "device_span",
    "draft_price",
    "kernels_in_spans",
    "prometheus_text",
    "request_track",
    "validate_chrome_trace",
    "validate_hw_block",
    "validate_metrics_json",
    "validate_prometheus_text",
    "write_chrome_trace",
    "write_prometheus",
]
