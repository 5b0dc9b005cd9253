"""Benchmark regression gate: a fresh BENCH_*.json vs the committed copy.

Usage (what nightly CI runs after re-generating a benchmark)::

    python -m repro_torch.obs.regress fresh.json artifacts/BENCH_energy.json \
        [--tolerance 0.25] [--key workloads.greedy.hw.ratios.energy ...]

Both files must be stamped metrics payloads (``metrics_schema_version``)
of the SAME schema version — a version drift is a schema change, not a
noise band, and fails loudly.  The keys compared are the payload's own
``regress_keys`` list (dotted paths into the nested JSON; every stamped
benchmark that wants guarding declares which of its numbers are
load-bearing), extendable/overridable with ``--key``.  A key missing from
either file, or whose values differ by more than ``--tolerance`` relative
(absolute, when the committed value is 0), is a regression: exit 1.

The check is symmetric — an "improvement" outside the band also fails,
because an unexplained jump in a calibrated analytic model is a bug in the
model, not a win.  Exit codes: 0 ok, 1 regression, 2 usage/parse error.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, List, Optional, Tuple


def _resolve(obj: Any, dotted: str) -> Tuple[bool, Any]:
    """Follow a dotted path through dicts (and list indices); returns
    (found, value)."""
    cur = obj
    for part in dotted.split("."):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        elif isinstance(cur, list) and part.lstrip("-").isdigit():
            idx = int(part)
            if -len(cur) <= idx < len(cur):
                cur = cur[idx]
            else:
                return False, None
        else:
            return False, None
    return True, cur


def _is_num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def compare(fresh: dict, committed: dict, keys: List[str],
            tolerance: float) -> List[str]:
    """Returns a list of regression messages (empty = accepted)."""
    errs: List[str] = []
    fv = fresh.get("metrics_schema_version")
    cv = committed.get("metrics_schema_version")
    if fv != cv:
        errs.append(f"schema version mismatch: fresh={fv} committed={cv}")
        return errs
    for key in keys:
        f_ok, f = _resolve(fresh, key)
        c_ok, c = _resolve(committed, key)
        if not f_ok or not c_ok:
            errs.append(f"{key}: missing from "
                        f"{'fresh' if not f_ok else 'committed'} file")
            continue
        if not _is_num(f) or not _is_num(c):
            if f != c:
                errs.append(f"{key}: non-numeric mismatch {f!r} != {c!r}")
            continue
        if not (math.isfinite(f) and math.isfinite(c)):
            # NaN compares False against any band — without this, a NaN
            # metric would sail through the gate
            errs.append(f"{key}: non-finite value fresh={f} committed={c}")
            continue
        if c == 0:
            delta, band = abs(f), f"abs {tolerance}"
        else:
            delta, band = abs(f - c) / abs(c), f"rel {tolerance}"
        if delta > tolerance:
            errs.append(f"{key}: fresh={f} committed={c} "
                        f"delta={delta:.4g} > {band}")
    return errs


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.regress",
        description="compare a fresh stamped BENCH_*.json against the "
                    "committed copy; exit nonzero on regression")
    ap.add_argument("fresh", help="freshly generated benchmark JSON")
    ap.add_argument("committed", help="committed reference JSON")
    ap.add_argument("--tolerance", type=float, default=0.25,
                    help="relative tolerance per key (default 0.25)")
    ap.add_argument("--key", action="append", default=[],
                    help="dotted path to compare (repeatable); adds to the "
                         "payload's own regress_keys")
    args = ap.parse_args(argv)
    payloads = []
    for path in (args.fresh, args.committed):
        try:
            with open(path) as f:
                obj = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"ERROR {path}: {e}")
            return 2
        if not isinstance(obj, dict) or "metrics_schema_version" not in obj:
            print(f"ERROR {path}: not a stamped metrics payload")
            return 2
        payloads.append(obj)
    fresh, committed = payloads
    declared = committed.get("regress_keys", [])
    if not isinstance(declared, list):
        print(f"ERROR {args.committed}: regress_keys must be a list")
        return 2
    keys = list(dict.fromkeys([*declared, *args.key]))
    if not keys:
        print(f"ERROR {args.committed}: no keys to compare — the payload "
              "declares no regress_keys and no --key was given")
        return 2
    errs = compare(fresh, committed, keys, args.tolerance)
    if errs:
        print(f"REGRESSION {args.fresh} vs {args.committed}")
        for e in errs:
            print(f"  - {e}")
        return 1
    print(f"OK {args.fresh} vs {args.committed} "
          f"({len(keys)} keys within {args.tolerance})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
