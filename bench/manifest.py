"""``BENCHMARK.json``: loading, the files each cell names, and the checks
its contract makes of names, units and the metrics of each cell."""
from __future__ import annotations

import json
import pathlib
import re
from typing import Dict, List

from bench.model import BENCH, load_json, model_problems

ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("device_trace", "host_clock")


def load(path: pathlib.Path = MANIFEST) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: Dict, name: str) -> Dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(manifest: Dict, cell_: Dict) -> Dict:
    for c in manifest["configs"]:
        if c["name"] == cell_["config"]:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no config {cell_['config']!r} in BENCHMARK.json")


def mix_of(cell_: Dict) -> Dict:
    return load_json(BENCH / "traffic" / f"{cell_['traffic']}.json")


def limit_of(cell_: Dict):
    """The cell's limit on the widest served-token logit gap, or None."""
    path = BENCH / "limits" / f"{cell_['name']}.json"
    return load_json(path)["logit_gap_max"]["limit"] if path.exists() else None


def metrics_of(manifest: Dict, cell_name: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell_name in m["workloads"]]


def problems(manifest: Dict) -> List[str]:
    """What in ``manifest`` breaks the contract's rules on names, units,
    sources and the metrics each cell reports, or names a configuration
    file or model module that is missing or incomplete (empty when none)."""
    out: List[str] = []
    names = {k: [x["name"] for x in manifest[k]]
             for k in ("configs", "workloads", "end_to_end", "per_layer")}
    for kind, ns in names.items():
        out += [f"{kind}: bad name {n!r}" for n in ns if not NAME.match(n)]
        out += [f"{kind}: {n!r} twice" for n in set(ns) if ns.count(n) > 1]
    metric_names = names["end_to_end"] + names["per_layer"]
    out += [f"metric {n!r} twice" for n in set(metric_names) if metric_names.count(n) > 1]
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better {m['better']!r}")
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']!r}")
    for m in manifest["end_to_end"]:
        if m["source"] not in E2E_SOURCES:
            out.append(f"{m['name']}: an end-to-end source must be one of {E2E_SOURCES}")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']} outside [0.01, 0.25]")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    if len(e2e) - ("setup_s" in e2e) > 4:
        out.append("more than four end-to-end metrics besides setup_s")
    for w in manifest["workloads"]:
        got = {m["name"] for m in metrics_of(manifest, w["name"], "end_to_end")}
        if "setup_s" not in got or len(got) < 2:
            out.append(f"{w['name']}: needs setup_s and another end-to-end metric")
        layer = metrics_of(manifest, w["name"], "per_layer")
        if not layer:
            out.append(f"{w['name']}: reports no per-layer metric")
        for m in layer:
            if m["moves"] not in got:
                out.append(f"{w['name']}: {m['name']} moves {m['moves']}, which it does not report")
        if w["config"] not in names["configs"]:
            out.append(f"{w['name']}: unknown config {w['config']!r}")
    for c in manifest["configs"]:
        path = ROOT / c["file"]
        if not path.is_file():
            out.append(f"{c['name']}: no file {c['file']}")
        elif "model" in (raw := load_json(path)):
            out += [f"{c['name']}: {p}" for p in model_problems(raw["model"])]
    return out
