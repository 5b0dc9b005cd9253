"""Per-layer metric readers: ``bench/metrics/<metric>.py``, each with
``read(data) -> float | None`` (``data`` a :class:`bench.serve.RunData`),
found by the metric's name.  A reader that finds nothing to read returns
None and the metric is left out of the result line."""
from __future__ import annotations

import importlib.util
import pathlib
from typing import Callable, Optional

from bench import yardstick

METRICS = pathlib.Path(__file__).resolve().parent / "metrics"


def load_reader(name: str) -> Callable:
    path = METRICS / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for per-layer metric {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def vmm_roofline(data, op: str) -> Optional[float]:
    """Σ over the slice's calls of ``op`` of each call's least time, over
    the device time of everything those calls launched, in %."""
    sl = data.slice
    if sl is None:
        return None
    calls = [dims for name, dims in sl.ops if name == op and dims]
    spent = sl.time_s(op=op)
    if not calls or spent <= 0:
        return None
    bound = sum(yardstick.vmm_bound_s(dims[0], dims[1]) for dims in calls)
    return 100.0 * bound / spent
