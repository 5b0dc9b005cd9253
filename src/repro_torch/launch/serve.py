"""Serving launcher: batched continuous-batching engine, optional DA mode.

  python -m repro_torch.launch.serve --arch qwen3-8b --smoke --quant da8 \
      --requests 16 --batch 4

The reference's flags, argument conflicts and printed lines, plus
``--device`` (default ``cuda``: the hand-written kernels serve; ``--device
cpu`` runs their plain versions on the host).  ``main(argv)`` runs in
process.

Freeze-once, serve-many: ``--quant da8-plan --save-artifact DIR`` persists
the planned DA artifact; a later ``--artifact DIR`` boots straight from disk
(no --arch, no float init, no re-packing).

Shared-prefix caching (paged runtime): ``--prefix-cache`` reuses the KV
pages of shared prompt prefixes across requests (refcounted pages,
copy-on-write on the last partial page; tokens identical to caching off).

Speculative decoding (paged runtime): ``--spec bitplane`` drafts with a
truncated-bitplane pass over the same artifact (``--spec-gamma``,
``--spec-draft-bits``); ``--spec layerskip`` early-exits after
``--spec-draft-periods`` period groups; ``--spec artifact`` drafts with a
second frozen artifact (``--spec-draft-artifact DIR``).  Greedy output is
token-identical to non-speculative serving.
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "da8", "da8-lut", "da8-plan"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="boot from a persisted DA artifact (cold serve path)")
    ap.add_argument("--save-artifact", default=None, metavar="DIR",
                    help="persist the frozen artifact after the pre-VMM step")
    ap.add_argument("--runtime", default="auto",
                    choices=["auto", "paged", "slots"],
                    help="serving runtime (auto: paged KV + continuous "
                         "batching for attention stacks)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size (tokens) for the paged runtime")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="shared-prefix caching: requests sharing a prompt "
                         "prefix reuse its KV pages (refcounted, COW; "
                         "tokens identical to caching off)")
    ap.add_argument("--paged-attn", default="auto",
                    choices=["auto", "gather", "fused"],
                    help="paged-attention read: plain gather or the fused "
                         "CUDA page-walk kernel (auto: fused on the card, "
                         "gather on the CPU; tokens identical either way)")
    ap.add_argument("--kv-dtype", default=None,
                    choices=["fp16", "int8", "int4"],
                    help="KV page precision (paged runtime): int8/int4 pages "
                         "store quantized codes with in-page dequant scales "
                         "(~2x/~3.6x more resident tokens per pool byte); "
                         "fp16 keeps compute-dtype pages. Default: the model "
                         "config / artifact plan")
    ap.add_argument("--spec", default=None,
                    choices=["bitplane", "layerskip", "artifact"],
                    help="speculative decoding draft provider (paged runtime; "
                         "greedy output stays token-identical)")
    ap.add_argument("--spec-gamma", type=int, default=4,
                    help="draft tokens per speculative round")
    ap.add_argument("--spec-draft-bits", type=int, default=4,
                    help="bit-planes the truncated-bitplane self-draft "
                         "evaluates (of the artifact's x_bits)")
    ap.add_argument("--spec-draft-periods", type=int, default=None,
                    help="period groups the layer-skip draft runs "
                         "(default: half the stack)")
    ap.add_argument("--spec-draft-artifact", default=None, metavar="DIR",
                    help="frozen draft DAArtifact for --spec artifact")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="record request/scheduler lifecycle spans and write "
                         "a Chrome trace_event JSON here (load the file in "
                         "Perfetto / chrome://tracing)")
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write the metrics registry here in Prometheus "
                         "text exposition format after the run")
    ap.add_argument("--hw-metrics", nargs="?", const="-", default=None,
                    metavar="FILE",
                    help="print the DA hardware-cost estimate "
                         "(metrics()['hw']: pJ/token, component breakdown, "
                         "live DA-vs-bitslice ratios) after the run; with "
                         "FILE, also write it as schema-stamped JSON "
                         "(validated by python -m repro_torch.obs.check)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu: the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    if args.artifact and (args.save_artifact or args.quant != "none"
                          or args.smoke or args.arch):
        raise SystemExit("--artifact boots a finished artifact; it conflicts "
                         "with --arch/--smoke/--quant/--save-artifact")
    if args.save_artifact and args.quant == "none":
        raise SystemExit("--save-artifact requires a DA --quant mode")

    import dataclasses

    import numpy as np

    from repro_torch.configs.registry import ARCHS, reduce_for_smoke
    from repro_torch.core.freeze import da_memory_report
    from repro_torch.device import resolve_device
    from repro_torch.models.model import count_params, init_model
    from repro_torch.serve.engine import Request, ServeEngine

    device = resolve_device(args.device)

    spec = None
    if args.spec:
        from repro_torch.spec import SpecConfig

        if args.spec == "artifact" and not args.spec_draft_artifact:
            raise SystemExit("--spec artifact requires --spec-draft-artifact")
        spec = SpecConfig(provider=args.spec, gamma=args.spec_gamma,
                          draft_x_bits=args.spec_draft_bits,
                          draft_periods=args.spec_draft_periods,
                          draft_artifact=args.spec_draft_artifact)

    trace = args.trace_out is not None
    if args.artifact:
        eng = ServeEngine.from_artifact(args.artifact, batch_size=args.batch,
                                        max_len=args.max_len,
                                        runtime=args.runtime,
                                        page_size=args.page_size, spec=spec,
                                        prefix_cache=args.prefix_cache,
                                        paged_attn=args.paged_attn,
                                        kv_dtype=args.kv_dtype, trace=trace,
                                        device=device)
        cfg = eng.cfg
        print(f"arch={cfg.name} cold boot from {args.artifact} "
              f"(zero float weights, runtime={eng.runtime}, "
              f"kv_dtype={cfg.kv_dtype})")
    else:
        if args.arch is None:
            raise SystemExit("--arch is required unless booting --artifact")
        cfg = ARCHS[args.arch]
        if args.smoke:
            cfg = reduce_for_smoke(cfg)
        cfg = dataclasses.replace(cfg, moe_dropless=True)
        if cfg.modality != "text":
            raise SystemExit(
                f"{cfg.name} has a stub frontend; serve text archs")

        params = init_model(cfg, seed=0, device=device)
        print(f"arch={cfg.name} params={count_params(cfg)/1e6:.1f}M "
              f"quant={args.quant}")
        mode = {"none": None, "int8": "int8", "da8": "da_bitplane",
                "da8-lut": "da_lut", "da8-plan": "auto"}[args.quant]
        eng = ServeEngine(cfg, params, batch_size=args.batch,
                          max_len=args.max_len, da_mode=mode,
                          runtime=args.runtime, page_size=args.page_size,
                          spec=spec, prefix_cache=args.prefix_cache,
                          paged_attn=args.paged_attn, kv_dtype=args.kv_dtype,
                          trace=trace, device=device)
        del params
        if mode is not None:
            rep = da_memory_report(eng.params, model_cfg=eng.cfg)
            print(f"pre-VMM freeze: {rep['da_matrices']} matrices"
                  + (f", LUT blow-up {rep['cell_blowup']:.0f}x"
                     if rep["lut_cells"] else ""))
            kv = rep.get("kv")
            if kv:
                print(f"kv cache: {kv['bytes_per_token']} B/token "
                      f"({kv['capacity_multiplier']:.1f}x capacity vs "
                      f"compute-dtype pages)")
        if args.save_artifact:
            print(f"artifact -> {eng.save_artifact(args.save_artifact)}")

    rng = np.random.default_rng(0)
    # with prefix caching on, give the workload the shape the cache is for:
    # every request opens with the same "system prompt" prefix; the unique
    # tail is capped so shared + tail always fits --max-len
    shared = (rng.integers(0, cfg.vocab, min(48, args.max_len // 2))
              if args.prefix_cache else rng.integers(0, cfg.vocab, 0))
    tail_hi = max(5, min(32, args.max_len - len(shared) - 4))
    t0 = time.perf_counter()
    for uid in range(args.requests):
        tail = rng.integers(0, cfg.vocab, rng.integers(4, tail_hi))
        eng.submit(Request(uid=uid,
                           prompt=np.concatenate([shared, tail]),
                           max_new_tokens=args.max_new))
    done = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.generated) for r in done.values())
    print(f"served {len(done)} requests / {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s)")
    sm = eng.metrics().get("spec")
    if sm:
        print(f"spec[{sm['provider']}] gamma={sm['gamma']} "
              f"acceptance={sm['acceptance_rate']:.2f} "
              f"draft_steps={sm['draft_steps']} "
              f"verify_steps={sm['verify_steps']} "
              f"disabled={sm['disabled_requests']}")
    km = eng.metrics().get("kv")
    if km and km["capacity_multiplier"] != 1.0:
        print(f"kv[{','.join(sorted(set(km['kv_dtypes'].values())))}] "
              f"{km['bytes_per_token']} B/token "
              f"capacity={km['capacity_multiplier']:.1f}x "
              f"pool={km['pool_bytes']/1e6:.1f}MB")
    pm = eng.metrics().get("prefix_cache")
    if pm:
        print(f"prefix-cache hit_rate={pm['hit_rate']:.2f} "
              f"cached_tokens={pm['cached_tokens']} "
              f"evictions={pm['evictions']} cow={pm['cow_copies']}")
    if args.hw_metrics:
        hm = eng.metrics().get("hw")
        if hm is None:
            print("hw: no DA cost model (float weights) — freeze with a DA "
                  "--quant mode or boot an --artifact")
        else:
            live = hm["live"]
            print(f"hw: {hm['pj_per_token']:.3e} pJ/token "
                  f"{hm['ns_per_token']:.3e} ns/token over "
                  f"{hm['layers']} DA layers; executed "
                  f"{live['da_pj']:.3e} pJ "
                  f"(bit-sliced would be {live['bitslice_pj']:.3e} pJ — "
                  f"x{live['energy_ratio']:.1f} energy, "
                  f"x{live['latency_ratio']:.2f} latency)")
            comp = hm["components"]
            print("hw components/token: "
                  + " ".join(f"{k}={v:.3e}" for k, v in comp.items()))
        if args.hw_metrics != "-":
            print(f"hw metrics -> {eng.write_hw_metrics(args.hw_metrics)}")
    if args.trace_out:
        print(f"trace -> {eng.write_trace(args.trace_out)} "
              f"({len(eng.obs.tracer)} events)")
    if args.metrics_out:
        print(f"metrics -> {eng.write_metrics(args.metrics_out)}")


if __name__ == "__main__":
    main()
