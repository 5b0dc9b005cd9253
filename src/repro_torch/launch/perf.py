"""§Perf hillclimbing driver.

Traces a (arch × shape) cell with a named variant (a set of config levers /
DA quant mode) on the production mesh (:mod:`repro_torch.launch.dryrun`),
computes its roofline, and writes the record under ``artifacts/torch/perf/``.
Also offers a diagnosis mode that prints the top collectives and the bytes
by op kind of the traced step, and a split (``--split``) of the rank's
FLOPs and collective bytes by the port function that issued them, beside
one device's FLOPs ÷ chips: where a rank does more than its share.

  python -m repro_torch.launch.perf --arch mistral-nemo-12b --shape prefill_32k \\
      --variant L3_additive_bf16
  python -m repro_torch.launch.perf --arch mistral-nemo-12b --shape prefill_32k \\
      --diagnose
  python -m repro_torch.launch.perf --arch qwen3-8b --shape train_4k --split
(``--device cpu`` without a card.)
"""
import argparse
import json

# Named §Perf variants: config levers (+ optional quant) per experiment.
VARIANTS = {
    "baseline": dict(extra={}, quant=None),
    # L2: slice hidden state before the LM head in prefill
    "L2_last_only": dict(extra={"prefill_last_only": True}, quant=None),
    # L3: additive mask (one fused pass) + bf16 score pipeline
    "L3_additive": dict(extra={"attn_mask_mode": "additive"}, quant=None),
    "L3_additive_bf16": dict(
        extra={"attn_mask_mode": "additive", "softmax_dtype": "bfloat16"},
        quant=None,
    ),
    # L4: sort-based MoE dispatch
    "L4_sorted_moe": dict(extra={"moe_impl": "sorted"}, quant=None),
    "L4_sorted_small_groups": dict(
        extra={"moe_impl": "sorted", "moe_group_size": 256}, quant=None
    ),
    # L5: remat policy saving matmul outputs (train)
    "L5_remat_dots": dict(extra={"remat_policy": "dots"}, quant=None),
    # L8: structurally-lean attention (minimal score-tensor passes)
    "L8_lean_attn": dict(extra={"attn_impl": "lean"}, quant=None),
    # L9: uniform-position KV-cache write as one slice
    "L9_cache_slice": dict(extra={"cache_mode": "slice"}, quant=None),
    "L89_lean_slice": dict(
        extra={"attn_impl": "lean", "cache_mode": "slice"}, quant=None),
    "DA_stacked_slice": dict(
        extra={"cache_mode": "slice"}, quant="da_bitplane_stacked"),
    # L6: flash-style chunked attention for long prefill
    "L6_chunked_attn": dict(extra={"attn_chunk_q": 2048}, quant=None),
    # DA-quantized serving (the paper's technique in the serving graph).
    # quant names are engine backends (repro_torch.core.engine registry;
    # legacy da_* spellings are canonicalized there).
    "DA_bitplane": dict(extra={}, quant="da_bitplane"),       # faithful serial
    "DA_stacked": dict(extra={}, quant="da_bitplane_stacked"),  # L7: one dot
    "DA_int8": dict(extra={}, quant="int8"),
    # shape-aware engine dispatch: each layer picks its backend per (M,K,N)
    "DA_auto": dict(extra={}, quant="auto"),
    "DA_stacked_combo": dict(
        extra={"attn_mask_mode": "additive", "softmax_dtype": "bfloat16"},
        quant="da_bitplane_stacked",
    ),
    # combos
    "combo_serve": dict(
        extra={"attn_mask_mode": "additive", "softmax_dtype": "bfloat16",
               "prefill_last_only": True},
        quant=None,
    ),
    "combo_moe_serve": dict(
        extra={"attn_mask_mode": "additive", "softmax_dtype": "bfloat16",
               "moe_impl": "sorted"},
        quant=None,
    ),
}


def diagnose(arch: str, shape_name: str, extra=None, quant=None, rules=None,
             device="cuda", top: int = 20):
    """Trace the cell on the single-pod mesh and print its top collectives
    (per-chip result bytes) and its bytes by op kind; returns the trace."""
    from repro_torch.configs.registry import LM_SHAPES, get
    from repro_torch.launch.dryrun import lower_cell, start_fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.sharding import LM_RULES

    import torch

    start_fake_world()
    cfg = get(arch)
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    mesh = make_production_mesh(device_type=torch.device(device).type)
    trace, _ = lower_cell(cfg, shape, mesh, rules=rules or LM_RULES,
                          extra_cfg=extra, quant=quant, device=device,
                          memory=False)
    c = trace.counter
    print("== top collectives (per-chip result bytes) ==")
    for name, kind, b, n in c.top_collectives(top):
        print(f"  {b/1e9:9.3f} GB  n={n:5d}  {kind:20s} {name}")
    print("== bytes by op kind ==")
    for kind, b, n in c.bytes_by_op_kind()[:top]:
        print(f"  {b/1e9:9.3f} GB  n={n:5d}  {kind}")
    return trace


def split_sites(cfg, shape, mesh, *, extra=None, quant=None, rules=None,
                device="cuda") -> dict:
    """Where a rank's FLOPs and collectives come from: the cell traced on
    ``mesh`` and on one device, both split by site (the port function that
    issued each op, ``bwd:`` its backward; :class:`OpCounter`).  Returns
    ``{"chips", "sites": [{site, rank_flops, one_flops_per_chip, excess,
    coll_bytes, ops}]}``, largest excess (rank FLOPs less one device's ÷
    chips) first; ``ops`` the site's rank FLOPs by op."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.sharding import LM_RULES

    rank, aux = lower_cell(cfg, shape, mesh, rules=rules or LM_RULES,
                           extra_cfg=extra, quant=quant, device=device,
                           memory=False, sites=True)
    one, _ = lower_cell(cfg, shape, None, extra_cfg=extra, quant=quant,
                        device=device, memory=False, sites=True)
    chips = aux["chips"]
    rows: dict = {}

    def row(site):
        return rows.setdefault(site, {"site": site, "rank_flops": 0,
                                      "one_flops_per_chip": 0.0,
                                      "coll_bytes": 0, "ops": {}})

    for (site, op), n in rank.counter.flops_by_site.items():
        r = row(site)
        r["rank_flops"] += n
        r["ops"][op] = r["ops"].get(op, 0) + n
    for (site, _), n in one.counter.flops_by_site.items():
        row(site)["one_flops_per_chip"] += n / chips
    for (site, op), b in rank.counter.coll_by_site.items():
        row(site)["coll_bytes"] += b
    for r in rows.values():
        r["excess"] = r["rank_flops"] - r["one_flops_per_chip"]
    return {"chips": chips, "rank_flops": rank.counter.flops,
            "one_flops": one.counter.flops,
            "coll_bytes": sum(b for _, b in rank.counter.collectives),
            "sites": sorted(rows.values(),
                            key=lambda r: (-r["excess"], -r["coll_bytes"]))}


def print_split(split: dict, top: int = 20) -> None:
    """The table of :func:`split_sites`: the sites with the largest FLOP
    excess, then those with the most collective bytes."""
    print(f"== rank FLOPs {split['rank_flops']:.4g} vs one device ÷ "
          f"{split['chips']} {split['one_flops'] / split['chips']:.4g} "
          f"(×{split['rank_flops'] * split['chips'] / max(split['one_flops'], 1):.3f}); "
          f"collectives {split['coll_bytes']:.4g} B ==")
    print(f"  {'rank FLOPs':>11s} {'one ÷ chips':>11s} {'excess':>11s} "
          f"{'coll B':>11s}  site")
    for r in split["sites"][:top]:
        print(f"  {r['rank_flops']:11.4g} {r['one_flops_per_chip']:11.4g} "
              f"{r['excess']:11.4g} {r['coll_bytes']:11.4g}  {r['site']}")
    print("== most collective bytes ==")
    for r in sorted(split["sites"], key=lambda r: -r["coll_bytes"])[:top]:
        if r["coll_bytes"]:
            print(f"  {r['coll_bytes']:11.4g} B  {r['site']}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default=None, choices=sorted(VARIANTS))
    ap.add_argument("--extra", default=None,
                    help="JSON dict of raw config overrides")
    ap.add_argument("--quant", default=None)
    ap.add_argument("--diagnose", action="store_true")
    ap.add_argument("--split", action="store_true",
                    help="split the rank's FLOPs and collective bytes by "
                         "site, beside one device's FLOPs ÷ chips")
    ap.add_argument("--fsdp", action="store_true",
                    help="use FSDP_RULES (2-D weight sharding over data+model)")
    ap.add_argument("--full", action="store_true",
                    help="also track memory (MemTracker) in the trace")
    ap.add_argument("--out", default="artifacts/torch/perf")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors and the mesh (cpu "
                         "without a card)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.sharding import FSDP_RULES, LM_RULES

    resolve_device(args.device)
    rules = FSDP_RULES if args.fsdp else LM_RULES
    if args.split:
        import torch

        from repro_torch.configs.registry import LM_SHAPES, get
        from repro_torch.launch.dryrun import start_fake_world
        from repro_torch.launch.mesh import make_production_mesh

        v = VARIANTS.get(args.variant, {}) if args.variant else {}
        extra = dict(v.get("extra", {}))
        extra.update(json.loads(args.extra) if args.extra else {})
        start_fake_world()
        mesh = make_production_mesh(device_type=torch.device(args.device).type)
        shape = next(s for s in LM_SHAPES if s.name == args.shape)
        split = split_sites(get(args.arch), shape, mesh, extra=extra,
                            quant=args.quant or v.get("quant"), rules=rules,
                            device=args.device)
        print_split(split)
        return split
    if args.diagnose:
        v = VARIANTS.get(args.variant, {}) if args.variant else {}
        extra = dict(v.get("extra", {}))
        extra.update(json.loads(args.extra) if args.extra else {})
        diagnose(args.arch, args.shape, extra=extra,
                 quant=args.quant or v.get("quant"), rules=rules,
                 device=args.device)
        return None

    if not (args.variant or args.extra):
        ap.error("--variant or --extra")
    if args.variant:
        v = VARIANTS[args.variant]
        extra, quant = dict(v["extra"]), v["quant"]
        tag = args.variant
    else:
        extra, quant = json.loads(args.extra), args.quant
        tag = "custom"
    if args.fsdp:
        tag = tag + "_fsdp"
    rec = run_cell(args.arch, args.shape, multi_pod=False, out_dir=args.out,
                   extra_cfg=extra, tag=tag, skip_full=not args.full,
                   quant=quant, rules=rules, device=args.device)
    r = rec.get("roofline", {})
    print(json.dumps({k: r.get(k) for k in (
        "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
        "useful_flops_fraction", "roofline_fraction")}, indent=1))
    if rec.get("memory"):
        print("memory:", json.dumps(rec["memory"]))
    if not rec.get("ok"):
        print("ERROR:", rec.get("error"))
    return rec


if __name__ == "__main__":
    main()
