"""Run one cell of ``BENCHMARK.json`` once on the card and print its
result as the last line of standard output:

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones from a traced run.  The program measured is ``repro_torch``
(under ``src/``); a run that finds no card, fewer cards than the cell
asks for, or no ``repro_torch`` beside it exits non-zero and prints no
result, as does one whose process has loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: top-level module names a run may not hold (the JAX stack and the JAX
#: package the port was made from); compared whole, so ``repro_torch``
#: is not ``repro``
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default
    ``sys.modules``)."""
    tops = {name.split(".", 1)[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def _fail(code: int, why: str) -> None:
    print(f"bench: {why}", file=sys.stderr)
    sys.exit(code)


def _line(res, cell, manifest, trace: bool, device_info: dict) -> dict:
    from bench import devtrace
    from bench.manifest import metrics_of
    from bench.readers import load_reader

    data = res["data"]
    metrics = {}
    if trace:
        for m in metrics_of(manifest, cell["name"], "per_layer"):
            v = load_reader(m["name"])(data)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(data.window)
        values["setup_s"] = res["setup_s"]
        values["peak_mem_gb"] = res["window_peak_bytes"] / 1e9
        for m in metrics_of(manifest, cell["name"], "end_to_end"):
            v = values.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"], "failed": 0,
            "metrics": metrics, "device": device_info}
    if trace and data.slice is not None:
        line["device"]["busy_s"] = data.slice.busy_s
        line["device"]["window_s"] = data.slice.wall_s
        line["breakdown"] = devtrace.breakdown(data.slice)
    line["window"] = {k: data.window[k] for k in
                      ("window_s", "out_tokens", "prompt_tokens", "gaps", "first_tokens", "requests")}
    line["pool"] = data.pool
    line["setup_phases"] = res["setup_phases"]
    line["check_s"] = res["check_s"]
    gap = res["gap"] if math.isfinite(res["gap"]) else None
    line["compared"] = {"logit_gap_max": {"value": gap, "limit": res["limit"],
                                          "requests": len(res["sample"])}}
    return line


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        _fail(3, f"no repro_torch under {ROOT / 'src'}: nothing to measure")
    from bench import manifest as mf

    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    import torch

    if not torch.cuda.is_available():
        _fail(2, "no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < cell["chips"]:
        _fail(2, f"{args.workload} needs {cell['chips']} cards, "
                 f"{torch.cuda.device_count()} found")
    import repro_torch  # noqa: F401  (fails here without the port)
    from bench.serve import run_cell

    res = run_cell(cell, mf.config_of(manifest, cell), mf.mix_of(cell), args.seed,
                   args.seconds, bool(args.trace), "cuda", T_START, mf.limit_of(cell))
    bad = forbidden_modules()
    if bad:
        _fail(4, f"the run loaded {bad}: the benchmark measures repro_torch alone")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"], "memory_peak_bytes": res["memory_peak_bytes"]}
    line = _line(res, cell, manifest, bool(args.trace), device)
    gap, lim = res["gap"], res["limit"]
    print(json.dumps(line))
    sys.stdout.flush()
    print(f"logit_gap_max {gap!r} limit {lim!r} over {len(res['sample'])} requests",
          file=sys.stderr)
    if not math.isfinite(gap):
        print("bench: no served request to compare", file=sys.stderr)


if __name__ == "__main__":
    main()
