"""CLI schema checker for exported observability artifacts.

Usage (what CI runs after the traced serve smoke)::

    python -m repro_torch.obs.check trace.json metrics.prom

``*.json`` files route by content: a ``traceEvents`` container validates as
a Chrome trace_event file (including the schema-v2 ``est_pj``/``est_ns``
energy annotations on spans), a ``metrics_schema_version``-stamped object
as a metrics/BENCH payload (hardware-cost ``hw`` blocks checked wherever
they appear; version-1 files predate them and still validate).  Anything
else validates as Prometheus text exposition.  Prints one line per
artifact; exits nonzero on the first invalid one.
"""
from __future__ import annotations

import json
import sys

from repro_torch.obs.export import (
    validate_chrome_trace,
    validate_metrics_json,
    validate_prometheus_text,
)


def check_file(path: str) -> list:
    if path.endswith(".json"):
        with open(path) as f:
            try:
                obj = json.load(f)
            except json.JSONDecodeError as e:
                return [f"invalid JSON: {e}"]
        if isinstance(obj, dict) and "traceEvents" in obj:
            return validate_chrome_trace(obj)
        if isinstance(obj, dict) and "metrics_schema_version" in obj:
            return validate_metrics_json(obj)
        return ["unrecognized JSON artifact: neither a Chrome trace "
                "('traceEvents') nor a stamped metrics payload "
                "('metrics_schema_version')"]
    with open(path) as f:
        return validate_prometheus_text(f.read())


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.obs.check <trace.json|metrics.prom>...")
        return 2
    rc = 0
    for path in argv:
        errs = check_file(path)
        if errs:
            rc = 1
            print(f"FAIL {path}")
            for e in errs[:20]:
                print(f"  - {e}")
        else:
            print(f"OK   {path}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
