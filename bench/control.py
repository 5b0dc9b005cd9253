"""The correctness check's two readings, for setting its limit: the
program's widest served-token logit gap and the control's, at a cell's
own size and load, over several seeds in one process.

The control is the reference put in the program's place at the precision
below the configuration's: activations truncated to their top 4
bit-planes (the program's own ``x_bits_override(4)`` path).  At each
served position of the sampled requests it reads the gap, under the
full-precision reference, of the token the control puts first.

    python bench/control.py --workload <cell> --seeds 11,12,13 --seconds 20

prints one JSON line per seed.  The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import List

ROOT = pathlib.Path(__file__).resolve().parents[1]


def control_gap(model, seed: int, sample, device, x_bits: int = 4) -> float:
    """Widest gap, under ``model``'s reference (a ``bench.model.Model``),
    of the token that the reference at ``x_bits`` puts first at each served
    position of ``sample``."""
    import torch

    if not sample:
        return float("inf")
    seqs = [list(s.prompt) + s.tokens[:-1] for s in sample]
    starts = [len(s.prompt) - 1 for s in sample]
    worst = 0.0
    full = model.logits_at(model.desc, seed, seqs, starts, device)
    low = model.logits_at(model.desc, seed, seqs, starts, device, x_bits=x_bits)
    for (_, ref), (_, ctl) in zip(full, low):
        first = torch.argmax(ctl, dim=-1)
        gaps = ref.max(-1).values - ref.gather(1, first[:, None])[:, 0]
        worst = max(worst, float(gaps.max()))
    return worst


def main(argv: List[str] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import manifest as mf
    from bench import serve
    from bench.model import model_of

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        sys.exit(2)
    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    config, mix = mf.config_of(manifest, cell), mf.mix_of(cell)
    model = model_of(config)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = serve.run_cell(cell, config, mix, seed, args.seconds, False, "cuda", t,
                             mf.limit_of(cell))
        sample = res["sample"]
        ctl = control_gap(model, seed, sample, torch.device("cuda"))
        print(json.dumps({"workload": cell["name"], "seed": seed, "program_gap": res["gap"],
                          "control_gap": ctl, "requests": len(sample),
                          "served_tokens": sum(len(s.tokens) for s in sample),
                          "tokens_per_s": res["data"].window["tokens_per_s"],
                          "setup_s": res["setup_s"], "seconds": time.perf_counter() - t}),
              flush=True)


if __name__ == "__main__":
    main()
