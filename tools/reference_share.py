"""The JAX reference's one-device work of a dry-run cell, ÷ the production
mesh's chips: what a chip would do if the reference split the cell evenly.

``python -m repro.launch.dryrun`` records what a reference chip does on
the 16 × 16 mesh; where GSPMD runs part of a cell replicated, that is more
than this share.  ``tools/dryrun_compare.py`` holds the port against the
chip's figures; this script gives the share beside them.  It compiles the
cell on one CPU device at full width with 2 and 3 periods of layers,
unrolled, and extrapolates XLA's cost to the full depth as the reference's
``probe_costs`` does (cost(P) = c2 + (P − 2)·(c3 − c2)).  It runs the JAX
package on the CPU only, and prints one JSON line.

  PYTHONPATH=src JAX_PLATFORMS=cpu python tools/reference_share.py \\
      --arch phi3-medium-14b --shape prefill_32k
"""
import os

os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=1 "
                           + os.environ.get("XLA_FLAGS", ""))

import argparse  # noqa: E402
import json  # noqa: E402

#: the production mesh's chips (``make_production_mesh``, single pod)
CHIPS = 256


def main(argv=None) -> dict:
    from repro.configs.registry import LM_SHAPES, get
    from repro.launch.dryrun import _cost_of, lower_cell
    from repro.launch.mesh import make_test_mesh

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    args = ap.parse_args(argv)
    cfg = get(args.arch)
    shape = next(s for s in LM_SHAPES if s.name == args.shape)
    mesh = make_test_mesh((1, 1), ("data", "model"))
    probes = []
    for k in (2, 3):
        lowered, _ = lower_cell(cfg, shape, mesh, extra_cfg={
            "n_layers": k * cfg.period, "scan_unroll": True})
        probes.append(_cost_of(lowered.compile())["flops"])
    periods = cfg.n_layers // cfg.period
    flops = probes[0] + (periods - 2) * (probes[1] - probes[0])
    out = {"cell": f"{args.arch}__{args.shape}", "one_device_flops": flops,
           "probe_flops": probes, "chips": CHIPS, "share_flops": flops / CHIPS}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
