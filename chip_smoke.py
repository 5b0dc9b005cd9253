#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device: card name and power limit, build of every CUDA kernel from the
   sources in the checkout (one ``nvcc`` per source, started together) with
   its ``-Xptxas -v`` summary;
2. the bit-plane DA VMM kernel against its plain version at every qwen3-8b
   weight shape, M in {4, 64}: int32 results must be EQUAL (the plain version
   forms each plane product in float64, exact since every partial is an
   integer far below 2^53);
3. the paged-attention kernel against the plain gather read at qwen3-8b head
   shapes in bfloat16 (T = 1 and 16, ragged tpos, permuted pages, pad lanes
   on the garbage page, a long table whose scores spill to scratch);
4. one prefill step of qwen3-8b at full width and 2 layers, through the
   kernels and through the plain versions: logits within a stated tolerance;
5. ServeEngine on qwen3-8b at full width and all 36 layers, random weights
   from seed 0 frozen to DA form, 8 requests: every request finishes and both
   kernels were launched on that run; then a window of batch-4 decode steps,
   timed on the host and traced with ``torch.profiler`` for the device time
   by kernel.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and
last the ``{"ok": true, "device": ...}`` line.  Any failed check raises and
the script exits non-zero; with no card it exits non-zero before printing a
result.
"""
from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
L2_FLUSH_BYTES = 256 << 20     # > the 50 MB L2: each timed launch starts cold

#: qwen3-8b weight shapes the serving path hands the bit-plane kernel
#: (fused q|k|v, wo, up/gate, down, LM head)
VMM_SHAPES = ((4096, 6144), (4096, 4096), (4096, 12288), (12288, 4096),
              (4096, 151936))
#: bfloat16 tolerance of the paged-attention kernel against the plain read:
#: both round at the same points, so they differ by float32 summation order
#: only; one bf16 ulp at magnitude 1 bounds that
ATTN_ATOL = 2.0 ** -7
#: logits tolerance of the 2-layer full-width step, kernels vs plain: the DA
#: layers are exact, so the gap is attention rounding carried through
#: activation quantization and two layers; see PERF.md
LOGITS_ATOL = 0.25


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_cuda(fn, iters: int, flush=None, warmup: int = 2) -> float:
    """Mean ms of ``fn`` from CUDA events, each launch after an L2 flush."""
    import torch

    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


def phase_device():
    from repro_torch.kernels import build

    secs = build.build_all()
    emit({"phase": "device", "smi": smi_line(), "build_s": secs,
          "ptxas": build.ptxas_summary()})


def phase_bitplane(flush):
    import torch

    from repro_torch.core.da import DAConfig
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.kernels.ref import bitplane_vmm_ref

    cfg = DAConfig(x_bits=8, x_signed=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for k, n in VMM_SHAPES:
        wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                           dtype=torch.int8)
        for m in (4, 64):
            xq = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                               dtype=torch.int32)
            y = bitplane_vmm_cuda(xq, wq, cfg)
            ref = bitplane_vmm_ref(xq, wq, cfg)
            torch.cuda.synchronize()
            if not torch.equal(y, ref):
                raise AssertionError(f"bitplane kernel != plain at M={m} K={k} N={n}")
            ms = time_cuda(lambda: bitplane_vmm_cuda(xq, wq, cfg), 20, flush)
            plain_ms = time_cuda(lambda: bitplane_vmm_ref(xq, wq, cfg), 3, flush, 1)
            lib_ms = None
            if m > 16 and k % 8 == 0 and n % 8 == 0:  # torch._int_mm's shape rule
                x8 = xq.to(torch.int8)
                lib_ms = time_cuda(lambda: torch._int_mm(x8, wq), 20, flush)
            nbytes = k * n + 4 * m * k + 4 * m * n
            ops = 2 * m * k * n * cfg.x_bits
            bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "operations": ops / INT8_OPS_PER_S * 1e3}
            by = max(bound, key=bound.get)
            rows.append({"m": m, "k": k, "n": n, "equal": True, "max_abs_err": 0,
                         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[by],
                         "bound_by": by, "library_ms": lib_ms})
            del xq, y, ref
        del wq
        torch.cuda.empty_cache()
    emit({"phase": "bitplane_vmm", "plain": "float64 plane products (exact)",
          "shapes": rows})
    return rows


def _paged_case(gen, b, t, w, p, dtype, ps=16, kv=8, h=32, hd=128):
    """Pool with permuted physical pages, a garbage column, ragged tpos and a
    pad lane at the garbage position."""
    import torch

    q = torch.randn(b, t, h, hd, generator=gen, device="cuda").to(dtype)
    kp = torch.randn(p, ps, kv, hd, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(p, ps, kv, hd, generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(p - 1, generator=gen, device="cuda")[: b * (w - 1)]
    table = torch.cat([perm.reshape(b, w - 1).to(torch.int32) + 1,
                       torch.zeros(b, 1, dtype=torch.int32, device="cuda")], 1)
    lens = torch.randint(t, (w - 1) * ps, (b,), generator=gen, device="cuda")
    tpos = (lens[:, None] - t + torch.arange(t, device="cuda")[None]).to(torch.int32)
    tpos[0, 0] = (w - 1) * ps  # pad lane: garbage position
    return q, kp, vp, table.contiguous(), tpos.contiguous()


def phase_attention(flush):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.attention import paged_gather_read

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    # (B, T, W): decode and prefill at max_len 256 / page 16 (W = 17), and a
    # long table (W = 300) whose scores do not fit in shared memory
    for b, t, w in ((4, 1, 17), (4, 16, 17), (2, 16, 300)):
        for mode in ("where", "additive"):
            q, kp, vp, table, tpos = _paged_case(gen, b, t, w, b * w + 8,
                                                 torch.bfloat16)
            out = paged_attention_cuda(q, kp, vp, table, tpos, mask_mode=mode)
            ref = paged_gather_read(q, kp, vp, table, tpos, mask_mode=mode)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= ATTN_ATOL:
                raise AssertionError(f"paged attention kernel vs plain: {err} > "
                                     f"{ATTN_ATOL} at B={b} T={t} W={w} {mode}")
            row = {"b": b, "t": t, "w": w, "mask_mode": mode, "max_abs_err": err}
            if mode == "where":
                row["ms"] = time_cuda(lambda: paged_attention_cuda(
                    q, kp, vp, table, tpos), 20, flush)
                row["plain_ms"] = time_cuda(lambda: paged_gather_read(
                    q, kp, vp, table, tpos), 10, flush)
                tl = table.long()
                kg = kp[tl].reshape(b, -1, 8, 128).transpose(1, 2)
                vg = vp[tl].reshape(b, -1, 8, 128).transpose(1, 2)
                mask = (torch.arange(w * 16, device="cuda")[None, None]
                        <= tpos[:, :, None])[:, None]
                qh = q.transpose(1, 2)
                row["library_ms"] = time_cuda(lambda: F.scaled_dot_product_attention(
                    qh, kg, vg, attn_mask=mask, enable_gqa=True), 20, flush)
                # the work this data needs: a row reads K and V up to its
                # largest tpos, a query scores and sums up to its own
                live = (tpos.long() + 1).clamp(max=w * 16)
                nbytes = (2 * q.numel() * 2
                          + 2 * int(live.amax(1).sum()) * 8 * 128 * 2
                          + 4 * b * w + 4 * b * t)
                flops = 4 * int(live.sum()) * 32 * 128
                bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                         "operations": flops / BF16_FLOPS_PER_S * 1e3}
                row["bound_by"] = max(bound, key=bound.get)
                row["bound_ms"] = bound[row["bound_by"]]
            rows.append(row)
    emit({"phase": "paged_attention", "dtype": "bfloat16", "atol": ATTN_ATOL,
          "cases": rows})
    return rows


def _with_mode(tree, mode):
    import dataclasses

    from repro_torch.core.engine import PackedWeights

    if isinstance(tree, PackedWeights):
        return dataclasses.replace(tree, mode=mode)
    if isinstance(tree, dict):
        return {k: _with_mode(v, mode) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_mode(v, mode) for v in tree]
    return tree


def phase_logits():
    import dataclasses

    import torch

    from repro_torch.configs.registry import get
    from repro_torch.core.freeze import freeze_model
    from repro_torch.models.model import forward, init_model
    from repro_torch.serve.kvcache import init_paged_caches, pad_position, table_width

    cfg = dataclasses.replace(get("qwen3-8b"), n_layers=2)
    frozen = freeze_model(init_model(cfg, seed=0, device="cuda"),
                          mode="pallas_bitplane", device="cuda")
    b, t, ps, max_len = 4, 16, 16, 256
    w = table_width(max_len, ps)
    lens = [16, 9, 13, 4]  # ragged chunk: short rows pad to the garbage page
    tokens = torch.randint(0, cfg.vocab, (b, t), device="cuda", dtype=torch.int32,
                           generator=torch.Generator(device="cuda").manual_seed(3))
    pos = torch.full((b, t), pad_position(max_len, ps), dtype=torch.int32,
                     device="cuda")
    table = torch.zeros((b, w), dtype=torch.int32, device="cuda")
    for i, n in enumerate(lens):
        pos[i, :n] = torch.arange(n, device="cuda")
        table[i, 0] = i + 1
    last = torch.tensor([n - 1 for n in lens], device="cuda")
    out = {}
    for name, params, attn in (("kernels", frozen, "fused"),
                               ("plain", _with_mode(frozen, "bitplane_stacked"),
                                "gather")):
        caches = init_paged_caches(cfg, b + 1, ps, cfg.dtype(), device="cuda")
        with torch.inference_mode():
            logits, _ = forward(params, tokens, dataclasses.replace(
                cfg, paged_attn=attn), pos, caches, table, last_idx=last)
        out[name] = logits.float()
    if not torch.isfinite(out["kernels"]).all():
        raise AssertionError("non-finite logits through the kernels")
    diff = (out["kernels"] - out["plain"]).abs()
    argmax_eq = (out["kernels"].argmax(-1) == out["plain"].argmax(-1)).all().item()
    emit({"phase": "logits", "layers": 2, "d_model": cfg.d_model,
          "shape": list(out["kernels"].shape), "max_abs_err": diff.max().item(),
          "mean_abs_err": diff.mean().item(), "atol": LOGITS_ATOL,
          "logit_absmax": out["plain"].abs().max().item(),
          "argmax_equal": argmax_eq})
    if not diff.max().item() <= LOGITS_ATOL:
        raise AssertionError(f"logits kernels vs plain {diff.max().item()} > "
                             f"{LOGITS_ATOL}")
    del frozen, out
    gc.collect()
    torch.cuda.empty_cache()


def phase_serve():
    import numpy as np
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get("qwen3-8b")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = ServeEngine(cfg, params, batch_size=4, max_len=256, page_size=16,
                      da_mode="pallas_bitplane", paged_attn="fused", device="cuda")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    rng = np.random.default_rng(0)
    reqs = [Request(uid=u, prompt=rng.integers(0, cfg.vocab, int(rng.integers(16, 65))
                                               ).astype(np.int32), max_new_tokens=16)
            for u in range(8)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats()
    bitplane_vmm_cuda.launches = 0
    paged_attention_cuda.launches = 0
    done = eng.run()
    torch.cuda.synchronize()
    launches = {"bitplane_vmm": bitplane_vmm_cuda.launches,
                "paged_attention": paged_attention_cuda.launches}
    if len(done) != len(reqs) or any(
            len(done[r.uid].generated) != 16
            or not all(0 <= tok < cfg.vocab for tok in done[r.uid].generated)
            for r in reqs):
        raise AssertionError("not every request finished with 16 in-vocab tokens")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was never launched on the main path: {launches}")
    m = eng.metrics()
    emit({"phase": "serve", "model": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "requests": len(done),
          "prompt_tokens": [len(r.prompt) for r in reqs],
          "out_tokens": m["out_tokens"], "steps": m["steps"],
          "tokens_per_s": m["tokens_per_s"], "ttft_p50_ms": m["ttft_p50_ms"],
          "itl_p50_ms": m["itl_p50_ms"], "itl_p99_ms": m["itl_p99_ms"],
          "wall_s": m["wall_s"], "init_s": t1 - t0, "freeze_s": t2 - t1,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": launches,
          "first_tokens": done[0].generated[:8]})
    emit(decode_window(eng, cfg.vocab))
    return launches


def decode_window(eng, vocab: int, steps: int = 4):
    """Where a full-width decode step spends its time: host wall of
    ``steps`` batch-4 decode ticks, then the same number of ticks under
    ``torch.profiler`` for the device time by kernel.  The busy share is
    device time over the untraced wall."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(1)
    for u in range(4):
        eng.submit(Request(uid=100 + u, prompt=rng.integers(0, vocab, 16).astype(
            np.int32), max_new_tokens=4 * steps))
    for _ in range(64):  # admit and prefill until all four lanes decode
        if all(l is not None and l.remaining == 1 for l in eng._rt.lanes):
            break
        eng.step()
    else:
        raise AssertionError("the decode window's lanes never all reached decode")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    dev = {"bitplane_vmm": 0.0, "paged_attention": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = ("bitplane_vmm" if "bitplane_vmm_kernel" in e.name else
               "paged_attention" if "paged_attn_kernel" in e.name else "other")
        dev[key] += e.time_range.elapsed_us() / 1e3 / steps
    eng.run()
    busy = sum(dev.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"phase": "decode_step", "width": 4, "steps": steps,
            "wall_ms": wall_ms, "device_ms": dev, "device_busy_ms": busy,
            "busy_share": busy / wall_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    # the plain versions are references: full float32 and bf16 reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()
    phase_device()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    vmm = phase_bitplane(flush)
    attn = phase_attention(flush)
    del flush
    torch.cuda.empty_cache()
    phase_logits()
    launches = phase_serve()
    dec_vmm = next(r for r in vmm if (r["m"], r["k"], r["n"]) == (4, 4096, 12288))
    dec_attn = next(r for r in attn if (r["t"], r["w"]) == (1, 17) and "ms" in r)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [
        {"name": "bitplane_vmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitplane_vmm.cu",
         "replaces": "src/repro/kernels/bitplane_vmm.py:33",
         "launches": launches["bitplane_vmm"],
         "max_abs_err": max(r["max_abs_err"] for r in vmm),
         "ms": dec_vmm["ms"], "plain_ms": dec_vmm["plain_ms"],
         "bound_ms": dec_vmm["bound_ms"], "bound_by": dec_vmm["bound_by"],
         "library_ms": dec_vmm["library_ms"], "shape": "M=4 K=4096 N=12288 int8"},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:66",
         "launches": launches["paged_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in attn),
         "ms": dec_attn["ms"], "plain_ms": dec_attn["plain_ms"],
         "bound_ms": dec_attn["bound_ms"], "bound_by": dec_attn["bound_by"],
         "library_ms": dec_attn["library_ms"],
         "shape": "B=4 T=1 W=17 ps=16 H=32 kv=8 hd=128 bf16"},
    ]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
