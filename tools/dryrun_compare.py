"""Hold the port's dry-run against the reference's, cell by cell.

Reads two directories of dry-run records (one JSON per cell, as
``python -m repro.launch.dryrun --out DIR`` and ``python -m
repro_torch.launch.dryrun --out DIR`` write them) and prints one line per
cell: per-chip FLOPs, argument + temp bytes and collective bytes (in all
and by kind), each as port ÷ reference beside both figures.  A cell that
either side recorded as failed is listed with its error; a cell only one
side has is listed as missing.

The reference's per-chip FLOPs and collective bytes are its roofline's
(two unrolled probes extrapolated to the full depth, as ``probe_costs``
does); its collectives by kind are extrapolated from the probes alike.
The port's are its full-depth trace's.  Memory is each side's full-depth
record.  This script reads JSON only.

  python tools/dryrun_compare.py REF_DIR PORT_DIR [--markdown] [--cells a,b]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _load(d: str) -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        out[rec.get("cell", os.path.basename(path)[:-5])] = rec
    return out


def _ref_kinds(rec: dict) -> dict:
    """The reference's collective bytes by kind at full depth: the probes'
    kinds extrapolated by the factor that takes the probes' totals to the
    roofline's."""
    probes = rec.get("probes") or {}
    p1, p2 = probes.get("probe_1"), probes.get("probe_2")
    if not p1 or not p2:
        return dict(rec.get("raw_full_cost", {}).get("coll_by_kind", {}))
    total = rec["roofline"]["coll_bytes_per_chip"]
    step = p2["coll"] - p1["coll"]
    k = (total - p1["coll"]) / step if step else 0.0
    kinds = set(p1["coll_by_kind"]) | set(p2["coll_by_kind"])
    return {kind: p1["coll_by_kind"].get(kind, 0)
            + k * (p2["coll_by_kind"].get(kind, 0) - p1["coll_by_kind"].get(kind, 0))
            for kind in sorted(kinds)}


def figures(rec: dict, reference: bool) -> dict:
    """A record's per-chip FLOPs, argument + temp bytes, collective bytes
    and collectives by kind."""
    roof, mem = rec.get("roofline", {}), rec.get("memory", {})
    kinds = (_ref_kinds(rec) if reference
             else dict(rec.get("raw_full_cost", {}).get("coll_by_kind", {})))
    peak = None
    if mem.get("argument_bytes") is not None and mem.get("temp_bytes") is not None:
        peak = mem["argument_bytes"] + mem["temp_bytes"]
    return {"flops": roof.get("flops_per_chip"), "peak": peak,
            "coll": roof.get("coll_bytes_per_chip"), "kinds": kinds}


def _ratio(a, b):
    if a is None or b is None:
        return None
    if not b:
        return None if a else 1.0
    return a / b


def compare(ref_dir: str, port_dir: str, cells=None) -> list:
    """One row per cell: ``{cell, status, ref, port, flops, peak, coll,
    kinds}`` (ratios port ÷ reference; ``status`` ``ok``, ``reference
    failed``, ``port failed`` or ``missing``)."""
    ref, port = _load(ref_dir), _load(port_dir)
    rows = []
    for cell in sorted(set(ref) | set(port)):
        if cells and not any(c in cell for c in cells):
            continue
        r, p = ref.get(cell), port.get(cell)
        row = {"cell": cell}
        if r is None or p is None:
            row["status"] = "missing in " + ("reference" if r is None else "port")
        elif not r.get("ok"):
            row.update(status="reference failed", error=r.get("error"))
        elif not p.get("ok"):
            row.update(status="port failed", error=p.get("error"))
        else:
            fr, fp = figures(r, True), figures(p, False)
            row.update(status="ok", ref=fr, port=fp,
                       flops=_ratio(fp["flops"], fr["flops"]),
                       peak=_ratio(fp["peak"], fr["peak"]),
                       coll=_ratio(fp["coll"], fr["coll"]),
                       kinds={k: (fp["kinds"].get(k, 0), fr["kinds"].get(k, 0))
                              for k in sorted(set(fr["kinds"]) | set(fp["kinds"]))})
        rows.append(row)
    return rows


def _g(v) -> str:
    return "-" if v is None else f"{v:.3g}"


def _kinds(kinds: dict) -> str:
    return ", ".join(f"{k} {_g(p)}/{_g(r)}" for k, (p, r) in kinds.items()
                     if p or r)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("ref_dir")
    ap.add_argument("port_dir")
    ap.add_argument("--markdown", action="store_true",
                    help="print a markdown table (PERF.md's form)")
    ap.add_argument("--cells", default=None,
                    help="comma-separated substrings of the cells to list")
    args = ap.parse_args(argv)
    rows = compare(args.ref_dir, args.port_dir,
                   args.cells.split(",") if args.cells else None)
    if args.markdown:
        print("| cell | FLOPs port/ref | args+temp port/ref | collectives "
              "port/ref | collectives by kind (port/ref B) |")
        print("|---|---|---|---|---|")
    for row in rows:
        if row["status"] != "ok":
            text = row["status"] + (f": {row['error']}" if row.get("error") else "")
            print(f"| {row['cell']} | {text} | | | |" if args.markdown
                  else f"{row['cell']:52s} {text}")
            continue
        r, p = row["ref"], row["port"]
        cols = [f"{_g(p['flops'])}/{_g(r['flops'])} = {_g(row['flops'])}",
                f"{_g(p['peak'])}/{_g(r['peak'])} = {_g(row['peak'])}",
                f"{_g(p['coll'])}/{_g(r['coll'])} = {_g(row['coll'])}",
                _kinds(row["kinds"])]
        print(f"| {row['cell']} | " + " | ".join(cols) + " |" if args.markdown
              else f"{row['cell']:52s} flops {cols[0]:28s} args+temp "
                   f"{cols[1]:28s} coll {cols[2]:28s} [{cols[3]}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
