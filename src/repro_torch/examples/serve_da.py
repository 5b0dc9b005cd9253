"""Serve a small LM with batched requests through the DA-quantized engine —
the paper's setting end-to-end: weights are frozen after training, the
pre-VMM step builds the integer DA artifacts, and every linear layer of the
serving graph runs the multiplier-free datapath.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_da [--requests 8]
[--mode auto] [--device cpu]

The reference's ``examples/serve_da.py`` on the port: the same model, flags
and printed lines, plus ``--device`` (default ``cuda``: the hand-written
kernels serve; ``cpu``: their plain versions).  ``main(argv)`` runs in
process.

``--mode auto`` runs the per-layer planner: each weight matrix gets its own
(backend, group size, lut-or-not) decision from measured autotune timings
with the analytic hardware model as fallback.

Freeze-once, serve-many::

    # freeze, persist the artifact, then serve from it
    python -m repro_torch.examples.serve_da --save-artifact DIR
    # later / elsewhere: cold boot straight off disk — no float weights,
    # no re-packing, the pre-VMM step never runs again
    python -m repro_torch.examples.serve_da --artifact DIR

An artifact frozen by either package boots in the other.
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs.registry import ARCHS
from repro_torch.core.freeze import da_memory_report
from repro_torch.device import resolve_device
from repro_torch.models.model import count_params, init_model
from repro_torch.serve.engine import Request, ServeEngine


def build_cfg():
    return dataclasses.replace(
        ARCHS["qwen3-8b"],
        name="qwen3-20m",
        n_layers=4,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        head_dim=64,
        d_ff=768,
        vocab=8000,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
        moe_dropless=True,
    )


def print_plan(eng):
    rep = da_memory_report(eng.params, model_cfg=eng.cfg)
    print(f"{rep['da_matrices']} weight matrices in DA form, "
          f"LUT blow-up {rep['cell_blowup']:.1f}x aggregate")
    for row in rep["layers"][:8]:
        print(f"  {row['layer']:34s} {row['k']}x{row['n']:<6d} "
              f"mode={row['mode']:<17s} codes={row['code_bytes']/1e3:.0f}kB "
              f"luts={row['lut_bytes']/1e3:.0f}kB")
    if len(rep["layers"]) > 8:
        print(f"  ... {len(rep['layers']) - 8} more layers")
    kv = rep.get("kv")
    if kv:
        dts = ",".join(sorted(set(kv["kv_dtypes"].values())))
        print(f"  kv cache [{dts}]: {kv['bytes_per_token']} B/token "
              f"({kv['capacity_multiplier']:.1f}x capacity vs compute-dtype "
              f"pages)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--mode", default="auto",
                    choices=["auto", "lut", "onehot", "bitplane",
                             "bitplane_stacked", "int8", "float",
                             "da_lut", "da_bitplane"])  # legacy aliases
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="boot from a persisted DA artifact (no float "
                         "weights, no re-packing)")
    ap.add_argument("--save-artifact", default=None, metavar="DIR",
                    help="after freezing, persist the artifact to DIR")
    ap.add_argument("--runtime", default="auto",
                    choices=["auto", "paged", "slots"],
                    help="serving runtime (auto: paged KV + continuous "
                         "batching for attention stacks)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size (tokens) for the paged runtime")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix caching: requests sharing a prompt "
                         "prefix (the demo gives every request one) reuse "
                         "its KV pages instead of re-prefilling them")
    ap.add_argument("--paged-attn", default="auto",
                    choices=["auto", "gather", "fused"],
                    help="paged-attention read: plain gather or the fused "
                         "CUDA page-walk kernel (auto: fused on the card, "
                         "gather on the CPU; tokens identical either way)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=["fp16", "int8", "int4"],
                    help="KV page precision: int8/int4 store quantized codes "
                         "with in-page dequant scales; fp16 keeps compute-"
                         "dtype pages (default: model config / artifact)")
    ap.add_argument("--spec", default=None,
                    choices=["bitplane", "layerskip"],
                    help="self-speculative decoding: draft with a truncated-"
                         "bitplane or early-exit pass over the SAME weights, "
                         "verify in one batched full-precision step (greedy "
                         "output is token-identical)")
    ap.add_argument("--spec-gamma", type=int, default=4,
                    help="draft tokens per speculative round")
    ap.add_argument("--spec-draft-bits", type=int, default=4,
                    help="bit-planes the truncated-bitplane draft evaluates")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="record lifecycle spans and write a Chrome "
                         "trace_event JSON (loadable in Perfetto)")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the metrics registry in Prometheus text "
                         "exposition format after the run")
    ap.add_argument("--hw-metrics", nargs="?", const="-", default=None,
                    metavar="FILE",
                    help="print what the run would have cost on the paper's "
                         "DA hardware (metrics()['hw']); with FILE, also "
                         "write the block as schema-stamped JSON")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu: the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.save_artifact and args.mode == "float":
        raise SystemExit("--save-artifact requires a DA --mode (not float)")
    if args.artifact and args.save_artifact:
        raise SystemExit("--artifact and --save-artifact are mutually "
                         "exclusive (the artifact already exists on disk)")

    spec = None
    if args.spec:
        from repro_torch.spec import SpecConfig

        if args.spec == "bitplane" and args.mode == "float":
            raise SystemExit("--spec bitplane truncates DA bit-planes; it "
                             "needs a DA --mode (not float)")
        spec = SpecConfig(provider=args.spec, gamma=args.spec_gamma,
                          draft_x_bits=args.spec_draft_bits)

    device = resolve_device(args.device)
    trace = args.trace_out is not None
    t0 = time.perf_counter()
    if args.artifact:
        eng = ServeEngine.from_artifact(args.artifact, batch_size=args.batch,
                                        max_len=96, runtime=args.runtime,
                                        page_size=args.page_size, spec=spec,
                                        prefix_cache=args.prefix_cache,
                                        paged_attn=args.paged_attn,
                                        kv_dtype=args.kv_dtype, trace=trace,
                                        device=device)
        cfg = eng.cfg
        print(f"cold boot from {args.artifact} in "
              f"{time.perf_counter()-t0:.1f}s (zero float weights, "
              f"runtime={eng.runtime}, kv_dtype={cfg.kv_dtype})")
        print_plan(eng)
    else:
        cfg = build_cfg()
        params = init_model(cfg, seed=0, device=device)
        print(f"model: {count_params(cfg)/1e6:.1f}M params")
        t0 = time.perf_counter()
        eng = ServeEngine(cfg, params, batch_size=args.batch, max_len=96,
                          da_mode=args.mode,  # per-layer planned freeze
                          runtime=args.runtime, page_size=args.page_size,
                          spec=spec, prefix_cache=args.prefix_cache,
                          paged_attn=args.paged_attn,
                          kv_dtype=args.kv_dtype, trace=trace, device=device)
        if args.mode != "float":
            print(f"pre-VMM freeze ({args.mode}) in "
                  f"{time.perf_counter()-t0:.1f}s:")
            print_plan(eng)
        if args.save_artifact:
            path = eng.save_artifact(args.save_artifact)
            print(f"artifact persisted to {path} — re-serve with "
                  f"--artifact {path}")
    rng = np.random.default_rng(0)
    # a shared "system prompt" prefix gives --prefix-cache its workload; off
    # the flag, requests stay fully independent (the PR-3/4 demo shape)
    shared = rng.integers(0, cfg.vocab, 32 if args.prefix_cache else 0)
    t0 = time.perf_counter()
    for uid in range(args.requests):
        eng.submit(Request(
            uid=uid,
            prompt=np.concatenate(
                [shared, rng.integers(0, cfg.vocab, rng.integers(4, 24))]),
            max_new_tokens=int(rng.integers(8, 24)),
        ))
    done = eng.run()
    dt = time.perf_counter() - t0
    total_toks = sum(len(r.generated) for r in done.values())
    print(f"\nserved {len(done)} requests / {total_toks} tokens in {dt:.1f}s "
          f"({total_toks/dt:.1f} tok/s on {device.type.upper()}, "
          f"continuous batching, "
          f"runtime={eng.runtime}, batch={args.batch})")
    sm = eng.metrics().get("spec")
    if sm:
        print(f"spec[{sm['provider']}]: gamma={sm['gamma']} "
              f"acceptance={sm['acceptance_rate']:.2f} "
              f"rounds={sm['rounds']} bonus={sm['bonus_tokens']} "
              f"disabled={sm['disabled_requests']}")
    pm = eng.metrics().get("prefix_cache")
    if pm:
        print(f"prefix-cache: hit_rate={pm['hit_rate']:.2f} "
              f"cached_tokens={pm['cached_tokens']} hits={pm['hits']}/"
              f"{pm['lookups']} cow={pm['cow_copies']} "
              f"evictions={pm['evictions']}")
    for uid in sorted(done)[:4]:
        print(f"  req {uid}: {len(done[uid].generated)} tokens -> "
              f"{done[uid].generated[:8]}...")
    if args.hw_metrics:
        hm = eng.metrics().get("hw")
        if hm is None:
            print("hw: no DA cost model (--mode float has no DA geometry)")
        else:
            live = hm["live"]
            print(f"hw: {hm['pj_per_token']:.3e} pJ/token over "
                  f"{hm['layers']} DA layers; this run "
                  f"{live['da_pj']:.3e} pJ vs bit-sliced "
                  f"{live['bitslice_pj']:.3e} pJ "
                  f"(x{live['energy_ratio']:.1f} energy, "
                  f"x{live['latency_ratio']:.2f} latency)")
        if args.hw_metrics != "-":
            print(f"hw metrics -> {eng.write_hw_metrics(args.hw_metrics)}")
    if args.trace_out:
        print(f"trace -> {eng.write_trace(args.trace_out)} "
              f"({len(eng.obs.tracer)} events; open in Perfetto)")
    if args.metrics_out:
        print(f"metrics -> {eng.write_metrics(args.metrics_out)}")


if __name__ == "__main__":
    main()
