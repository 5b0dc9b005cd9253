"""Exporters for the observability layer: Chrome trace_event JSON and
Prometheus text exposition, plus the tiny schema checkers CI runs against
the emitted artifacts.

Chrome trace — ``chrome_trace(recorder)`` maps every :class:`TraceEvent`
onto the Trace Event Format (the JSON Perfetto and ``chrome://tracing``
load): one process (pid 0, named after the run), one *thread per track*
(``scheduler``, ``req:<uid>``, …) so request lifecycles render as parallel
swimlanes with spans nested by B/E pairing.  Timestamps convert from
perf_counter seconds to integer-precision microseconds; the recorder's
clock anchor (``otherData.clock_anchor``) maps them onto a
``torch.profiler`` trace's Unix clock (``repro_torch.obs.trace.unix_us``).

Prometheus — ``prometheus_text(registry)`` renders the registry in the text
exposition format (``# HELP`` / ``# TYPE`` + samples; histograms as
cumulative ``_bucket{le=...}`` series with ``_sum``/``_count``), so a
scrape-style pipeline or ``promtool`` ingests serving metrics without a
custom parser.

The validators are deliberately small — structural schema checks (required
fields, known phases, balanced spans, parseable samples), not a Perfetto
re-implementation — and they are what the CI smoke runs over the artifacts
a traced serve emits.
"""
from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    METRICS_SCHEMA_VERSION,
    MetricsRegistry,
)
from repro_torch.obs.trace import TraceRecorder

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


# ---------------------------------------------------------------------------
# Chrome trace_event JSON
# ---------------------------------------------------------------------------


def chrome_trace(recorder: TraceRecorder,
                 process_name: str = "repro-serve") -> Dict[str, Any]:
    """Recorder → Trace Event Format dict (``json.dump`` it and load in
    Perfetto).  Tracks map to tids; metadata events name them."""
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = [{
        "ph": "M", "pid": 0, "tid": 0, "name": "process_name",
        "args": {"name": process_name},
    }]

    def tid(track: str) -> int:
        t = tids.get(track)
        if t is None:
            t = tids[track] = len(tids)
            events.append({
                "ph": "M", "pid": 0, "tid": t, "name": "thread_name",
                "args": {"name": track},
            })
            # sort_index keeps the scheduler lane on top, requests below in
            # uid order (tracks are created in first-use order)
            events.append({
                "ph": "M", "pid": 0, "tid": t, "name": "thread_sort_index",
                "args": {"sort_index": t},
            })
        return t

    for ev in recorder.events:
        rec: Dict[str, Any] = {
            "name": ev.name,
            "ph": ev.ph,
            "pid": 0,
            "tid": tid(ev.track),
            "ts": round(ev.ts * 1e6, 3),  # seconds → microseconds
        }
        if ev.ph == "X":
            rec["dur"] = round(ev.dur * 1e6, 3)
        if ev.ph == "i":
            rec["s"] = "t"  # thread-scoped instant
        if ev.args:
            rec["args"] = ev.args
        events.append(rec)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "metrics_schema_version": METRICS_SCHEMA_VERSION,
            "dropped_events": recorder.dropped,
            "clock_anchor": dict(recorder.anchor),
        },
    }


def write_chrome_trace(path: str, recorder: TraceRecorder,
                       process_name: str = "repro-serve") -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace(recorder, process_name), f)
    return path


def validate_chrome_trace(obj: Any) -> List[str]:
    """Structural checks on a Chrome trace dict; returns a list of problems
    (empty = valid).  Checks: the traceEvents container, per-event required
    fields, known phases, B/E balance per (pid, tid), and that at least one
    nested (request-track) span exists when any request events are present.
    """
    errs: List[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be a dict with a 'traceEvents' list"]
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["'traceEvents' must be a non-empty list"]
    known_ph = {"B", "E", "X", "i", "I", "M"}
    depth: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        for field in ("ph", "pid", "tid", "name"):
            if field not in ev:
                errs.append(f"event {i}: missing required field {field!r}")
        ph = ev.get("ph")
        if ph not in known_ph:
            errs.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph != "M" and "ts" not in ev:
            errs.append(f"event {i}: missing 'ts'")
        if ph == "X" and "dur" not in ev:
            errs.append(f"event {i}: complete event missing 'dur'")
        args = ev.get("args")
        if isinstance(args, dict):
            # energy-annotated spans (schema v2): when present, the hardware
            # estimates must be finite non-negative numbers.  Absent is fine
            # (older traces, spans outside the priced phases) — back-compat.
            for key in ("est_pj", "est_ns"):
                v = args.get(key)
                if v is not None and not _is_cost(v):
                    errs.append(f"event {i}: args[{key!r}]={v!r} is not a "
                                "finite non-negative number")
        key = (ev.get("pid"), ev.get("tid"))
        if ph == "B":
            depth[key] = depth.get(key, 0) + 1
        elif ph == "E":
            depth[key] = depth.get(key, 0) - 1
            if depth[key] < 0:
                errs.append(f"event {i}: 'E' without matching 'B' on {key}")
                depth[key] = 0
    for key, d in depth.items():
        if d != 0:
            errs.append(f"track {key}: {d} unclosed span(s)")
    return errs


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _prom_labels(key) -> str:
    if not key:
        return ""
    body = ",".join(f'{_prom_name(k)}="{v}"' for k, v in key)
    return "{" + body + "}"


def _merge_labels(key, extra: Dict[str, str]) -> str:
    merged = dict(key)
    merged.update(extra)
    return _prom_labels(tuple(sorted(merged.items())))


def prometheus_text(registry: MetricsRegistry) -> str:
    """Registry → Prometheus text exposition format (version 0.0.4)."""
    lines: List[str] = []
    for name in sorted(registry.instruments()):
        inst = registry.instruments()[name]
        pname = _prom_name(name)
        if inst.help:
            lines.append(f"# HELP {pname} {inst.help}")
        lines.append(f"# TYPE {pname} {inst.kind}")
        if isinstance(inst, (Counter, Gauge)):
            series = sorted(inst.series()) or [((), 0.0)]
            for key, v in series:
                lines.append(f"{pname}{_prom_labels(key)} {_fmt(v)}")
        elif isinstance(inst, Histogram):
            series = sorted(inst.series()) or [((), None)]
            for key, _ in series:
                labels = dict(key)
                cum = 0
                counts = inst._counts.get(key, [0] * (len(inst.buckets) + 1))
                for ub, c in zip(inst.buckets, counts):
                    cum += c
                    lines.append(
                        f"{pname}_bucket"
                        f"{_merge_labels(key, {'le': _fmt(ub)})} {cum}")
                cum += counts[-1]
                lines.append(
                    f"{pname}_bucket{_merge_labels(key, {'le': '+Inf'})} "
                    f"{cum}")
                lines.append(f"{pname}_sum{_prom_labels(key)} "
                             f"{_fmt(inst.sum(**labels))}")
                lines.append(f"{pname}_count{_prom_labels(key)} "
                             f"{inst.count(**labels)}")
    lines.append("")
    return "\n".join(lines)


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def write_prometheus(path: str, registry: MetricsRegistry) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(prometheus_text(registry))
    return path


_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})?\s+[^\s]+$")


def validate_prometheus_text(text: str) -> List[str]:
    """Structural checks on a Prometheus exposition body (empty = valid):
    every non-comment line parses as ``name{labels} value``, every sample's
    base name was TYPE-declared, histograms carry _sum/_count, and values
    are finite numbers."""
    errs: List[str] = []
    typed: Dict[str, str] = {}
    samples: List[str] = []
    for ln, line in enumerate(text.splitlines(), start=1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary", "untyped"):
                errs.append(f"line {ln}: malformed TYPE declaration")
            else:
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        if not _SAMPLE_RE.match(line):
            errs.append(f"line {ln}: unparseable sample {line!r}")
            continue
        name = re.split(r"[{\s]", line, maxsplit=1)[0]
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if name not in typed and base not in typed:
            errs.append(f"line {ln}: sample {name!r} has no TYPE declaration")
        val = line.rsplit(None, 1)[-1]
        if val not in ("+Inf", "-Inf", "NaN"):
            try:
                float(val)
            except ValueError:
                errs.append(f"line {ln}: non-numeric value {val!r}")
        samples.append(name)
    for name, kind in typed.items():
        if kind == "histogram":
            for suffix in ("_bucket", "_sum", "_count"):
                if not any(s.startswith(name + suffix) for s in samples):
                    errs.append(f"histogram {name!r} missing {suffix} series")
    if not samples:
        errs.append("no samples found")
    return errs


# ---------------------------------------------------------------------------
# registry-schema helpers shared with benchmarks/stamp.py
# ---------------------------------------------------------------------------


def snapshot_with_schema(registry: Optional[MetricsRegistry]) -> Dict[str, Any]:
    """Registry snapshot in the BENCH_*.json schema (version-stamped)."""
    if registry is None:
        return {"metrics_schema_version": METRICS_SCHEMA_VERSION}
    return registry.snapshot()


# ---------------------------------------------------------------------------
# hardware-cost metrics validation (schema v2)
# ---------------------------------------------------------------------------


def _is_cost(v: Any) -> bool:
    """A finite, non-negative number (bool excluded — JSON true is not 1)."""
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and math.isfinite(v) and v >= 0)


def validate_hw_block(hw: Any, where: str = "hw") -> List[str]:
    """Structural checks on a ``metrics()["hw"]`` block (empty = valid).

    Required: the static per-token prices (``pj_per_token``/``ns_per_token``),
    the component breakdown, the bit-slicing counterfactual, and the
    design-point ratios.  Workload keys (``tokens``/``est_pj``/``est_ns``/
    ``live``) are optional — a freshly-built engine has not served yet — but
    must be well-formed when present.  Pure dict checks: no hwcost import,
    so the CLI stays dependency-light."""
    errs: List[str] = []
    if not isinstance(hw, dict):
        return [f"{where}: must be an object, got {type(hw).__name__}"]
    for key in ("pj_per_token", "ns_per_token"):
        if not _is_cost(hw.get(key)):
            errs.append(f"{where}.{key}: missing or not a finite "
                        "non-negative number")
    comp = hw.get("components")
    if not isinstance(comp, dict):
        errs.append(f"{where}.components: missing or not an object")
    else:
        for key in ("sense_pj", "array_overhead_pj", "adder_pj"):
            if not _is_cost(comp.get(key)):
                errs.append(f"{where}.components.{key}: missing or invalid")
    bs = hw.get("bitslice")
    if not isinstance(bs, dict):
        errs.append(f"{where}.bitslice: missing or not an object")
    else:
        for key in ("pj_per_token", "ns_per_token"):
            if not _is_cost(bs.get(key)):
                errs.append(f"{where}.bitslice.{key}: missing or invalid")
    ratios = hw.get("ratios")
    if not isinstance(ratios, dict):
        errs.append(f"{where}.ratios: missing or not an object")
    else:
        for key in ("energy", "latency"):
            if not _is_cost(ratios.get(key)):
                errs.append(f"{where}.ratios.{key}: missing or invalid")
    for key in ("tokens", "est_pj", "est_ns", "live"):
        sub = hw.get(key)
        if sub is None:
            continue
        if not isinstance(sub, dict):
            errs.append(f"{where}.{key}: not an object")
            continue
        for k, v in sub.items():
            if not _is_cost(v):
                errs.append(f"{where}.{key}.{k}: invalid value {v!r}")
    if isinstance(hw.get("est_pj"), dict) and "total" not in hw["est_pj"]:
        errs.append(f"{where}.est_pj: missing 'total'")
    return errs


def _walk_hw(obj: Any, path: str, errs: List[str]) -> None:
    if isinstance(obj, dict):
        for k, v in obj.items():
            p = f"{path}.{k}" if path else k
            if k == "hw":
                if v is None:
                    errs.append(f"{p}: null (no DA cost model — served "
                                "float weights?)")
                else:
                    errs.extend(validate_hw_block(v, where=p))
            else:
                _walk_hw(v, p, errs)
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            _walk_hw(v, f"{path}[{i}]", errs)


def validate_metrics_json(obj: Any) -> List[str]:
    """Checks on a schema-stamped metrics JSON (``write_hw_metrics`` output,
    BENCH_*.json payloads).  Version 1 files predate the hardware block and
    validate with no ``hw`` requirements (back-compat); version ≥ 2 files
    must carry well-formed ``hw`` blocks wherever the key appears."""
    if not isinstance(obj, dict):
        return ["top level must be an object"]
    version = obj.get("metrics_schema_version")
    if not isinstance(version, int):
        return ["missing integer 'metrics_schema_version'"]
    if version > METRICS_SCHEMA_VERSION:
        return [f"schema version {version} is newer than this build "
                f"understands ({METRICS_SCHEMA_VERSION})"]
    errs: List[str] = []
    if version >= 2:
        _walk_hw(obj, "", errs)
    return errs
