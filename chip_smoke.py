#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phase attention  # build, then the attention phase
    python3 chip_smoke.py --phase vmm        # build, then the VMM phases
    python3 chip_smoke.py --phase plans      # build, then the VMM plans' sweep
    python3 chip_smoke.py --phase ci_boot    # build, then one boot and serve
                                             # of the CI smoke's artifact
    python3 chip_smoke.py --phase serve      # build, then phase 6 alone
    python3 chip_smoke.py --phase obs        # build, then phase 12 alone
    python3 chip_smoke.py --phase auto       # build, then phase 13 alone
    python3 chip_smoke.py --phase dense      # build, then phases 14-15 alone
    python3 chip_smoke.py --phase families   # build, then phases 16-19 alone
    python3 chip_smoke.py --out FILE         # every JSON line also to FILE
    python3 chip_smoke.py --phase attention --src OTHER/src
    python3 chip_smoke.py --phase vmm --src OTHER/src
    python3 chip_smoke.py --phase ci_boot --src OTHER/src
    python3 chip_smoke.py --phase serve --src OTHER/src
                         # the same, on another checkout's port: compares two
                         # commits with one set of timers

Phases, one JSON line each:

1. device: card name and power limit, build of every CUDA kernel from the
   sources in the checkout (one ``nvcc`` per source, all started together)
   with its ``-Xptxas -v`` summary;
2. the bit-plane DA VMM kernel against its plain version at every qwen3-8b
   weight shape, M in {4, 16, 64} (decode, verify at batch 4, prefill), and
   at M = 4 with 4-bit codes (the truncated draft's): int32 results must be
   EQUAL (the plain version
   forms each plane product in float64, exact since every partial is an
   integer far below 2^53); and the engine's ``int8`` baseline (not a DA
   kernel: ``torch._int_mm`` on operands zero-padded to its shape rule, the
   weights laid out column-major once per pack) at the same shapes, EQUAL to
   the exact product;
3. the LUT-readout DA VMM kernel against its plain version (the LUT gather)
   at every LUT shape of the LUT-serving model, M in {4, 16, 64} and M = 4
   at x_bits 4, and at the
   reference's kernel-test shapes (CONV1's 4x25x6 among them), signed and
   unsigned, x_bits 2/4/8, group size 4/8/16, ragged K: int32 EQUAL.  Each
   timed shape of phases 2-3 gives its time on two event timers (device
   spin before the start event or not), device ms per kernel from
   ``torch.profiler``, host µs to enqueue, and the plan's tile, split and
   blocks per launch;
4. the paged-attention kernel against the plain gather read over fp, int8
   and int4 pages at the head shapes of both paths: qwen3-8b's in bfloat16
   (T = 1 at batch 4, 2 and 1, T = 4 (verify, its last column a pad query at
   the garbage position) and 16 at max_len 256, and a long table, W = 300,
   at T = 1 and 16), the LUT-serving model's in float32 (the same at
   max_len 128, no long table) and qwen2-moe's in bfloat16 (T = 1 and 16
   at W = 17), and at every head shape the bfloat16 score
   pipeline (``softmax_dtype="bfloat16"``) at decode and verify over fp,
   int8 and int4 pages, its decode timed; every case EQUAL to the plain
   read (both sum in float64; the reference holds its bfloat16 pipeline to
   2e-2), or within ATTN_ATOL for an older checkout's float32 read (--src);
   ragged tpos, permuted pages, pad lanes on the garbage page, and at every
   head shape a row whose every query is masked; each case with its
   cluster plan (chunks = the cluster's blocks, pages per chunk, blocks per
   launch, shared bytes per block, where the scores live, clusters the card
   holds at once) and its CUDA launches per read (one, checked), the read's time on
   two event timers (device spin before the start event or not), its device
   time per kernel from ``torch.profiler`` and its host time to enqueue;
   then each query of a verify-shaped read (T = 3, and T = 4 with a pad
   column at the garbage position) must EQUAL the T = 1 read of its row at
   its position, at batch 4 and batch 1, a decode row at batch 2-4 must
   EQUAL the row read alone, and the RMS norm's sum of squares of a row
   must not depend on the row count (the spec and prefix paths' tokens rest
   on it);
5. one prefill step of qwen3-8b at full width and 2 layers, through the
   kernels and through the plain versions, with fp and with int8 KV pages:
   logits EQUAL;
6. ServeEngine on qwen3-8b at full width and all 36 layers, random weights
   from seed 0 frozen to DA form, 8 requests: every request finishes and both
   kernels were launched on that run; then a window of batch-4 decode steps,
   timed on the host and traced with ``torch.profiler`` for the device time
   by kernel;
7. the same frozen weights served again with int8 KV pages: every request
   finishes through the attention kernel's quantized branch;
8. shared-prefix serving (``serve_prefix``): the same frozen weights, 8
   requests sharing a 48-token prefix, once with ``prefix_cache=True`` and
   once without: tokens EQUAL, with prefix hits, COW copies and pages saved;
9. speculative decoding (``serve_spec``): the same weights and requests as
   phase 6 with ``SpecConfig("bitplane", gamma=2, draft_x_bits=4)``: tokens
   EQUAL to phase 6's, then one draft round and one verify step traced with
   ``torch.profiler`` for the device time by kernel;
10. the LUT path: the LUT-serving model (qwen3 family, 4 layers, d 256) frozen
   on the card with ``pallas_lut``, saved as a DA artifact, booted with
   ``ServeEngine.from_artifact`` and served through the LUT kernel; the same
   artifact booted with the plain ``lut`` gather must give identical tokens,
   and a spec run (gamma 2, draft x_bits 4, the LUT kernel at 4 bits) too;
11. the CI serve smoke's legs (``artifact_ci``, ``.github/workflows/ci.yml``):
   the LUT-serving model frozen with ``bitplane_stacked`` (the bit-plane
   kernel on the card), saved, booted with ``from_artifact`` and served: 2
   requests; 2 with ``--spec bitplane --spec-gamma 2``; 4 at batch 2 with
   ``--prefix-cache``; 2 at batch 2 with ``--paged-attn fused``; 2 at batch
   2 with ``--kv-dtype int8``; spec and prefix tokens EQUAL to their plain
   runs'; then CI's "Observability smoke" (4 requests at batch 2, traced:
   the Chrome trace, Prometheus text and hw block written under $TMPDIR and
   each accepted by ``repro_torch.obs.check``) and the nightly "Traced
   serve" (8 requests at batch 4, spec bitplane gamma 2, trace and metrics
   checked the same way).  The artifact's manifest carries its hardware-cost
   table.  ``--phase ci_boot`` runs only its boot and first leg;
12. observability (``serve_obs``, run after phase 9 while phase 6's weights
   are on the card): phase 6's weights and requests served four times in
   turns with the trace recorder off, on, on, off: tokens EQUAL across the
   four and to phase 6's, registry series and the hw block equal across the
   four; per run ITL / TTFT p50 and the host ms per width-4
   decode step (the trace's host cost); with the trace on, spans balanced,
   TTFT / ITL rebuilt from the trace equal to metrics()'s, the exports
   accepted by ``repro_torch.obs.check``, and one ``torch.profiler`` window
   over 4 traced decode steps in which every bit-plane and attention kernel
   runs inside a ``paged_step[...]`` annotation.  The hw block's numbers
   (pJ and model-ns per token, DA against bit slicing) are the paper's
   circuits as ``core/hwmodel.py`` reckons them, never a measurement of the
   card;
13. the repo's default freeze (``artifact_auto``): the LUT-serving model
   frozen on the card by ``ServeEngine(da_mode="auto")`` with no cost table:
   the analytic plan must be the reference's (the LUT readout for the 7
   matrices of every block, stacked bit-planes for the LM head, whose LUTs
   would exceed the budget), saved, booted with ``from_artifact`` and
   served: both VMM kernels launch.  The same artifact served again with
   both VMM kernels swapped for their plain versions (inside this script
   only) launches none and gives EQUAL tokens.  Then every eligible backend,
   ``int8`` too, is timed at the engine's 9 bucket shapes, one name per
   kernel (``engine.timeable_backends``: ``lut`` for the LUT-readout
   kernel, ``bitplane_stacked`` for the bit-plane kernel); the table is
   written under the git-ignored ``build/`` stamped for this card, installed, and the
   LUT-serving model and qwen3-8b (from phase 6's float params' shapes) are
   planned on it (plans only, no serve);
14. the dense family's serve (``serve_dense``): minitron-8b (32 layers, d
   4096, squared-ReLU MLP, LayerNorm, vocab 256000) at full width and depth,
   seed-0 weights frozen by ``da_mode="auto"`` with no cost table (every
   matrix must plan ``bitplane_stacked``), 8 requests at batch 4 through
   the paged runtime (bit-plane and attention kernels) and the slot runtime
   (bit-plane kernel, plain dense-cache attention); each runtime's tokens
   EQUAL to the same runtime's serve with both VMM kernels and the
   attention kernel swapped for their plain versions, which launches none;
   per runtime ITL, TTFT, tokens/s, peak memory, launches, and 4 width-4
   decode steps' host ms and device busy share; then the paged runtime
   again with the bfloat16 score pipeline (``softmax_dtype="bfloat16"``),
   its tokens EQUAL to its plain-swapped serve's;
15. the other dense variants (``dense_variants``): musicgen-large (48
   layers, d 2048, GELU, LayerNorm, MHA, embedding inputs) at full size and
   qwen2-vl-72b (q/k/v biases, M-RoPE (16, 24, 24), [B, T, 3] positions)
   at full width and 2 of its 80 layers (reduced: 70 B int8 codes and its
   own float freeze do not fit one card), biases non-zero, frozen with
   ``pallas_bitplane``: a 16-row embedding prefill into ``init_caches`` and
   4 decode steps against the plain-swapped forward, logits EQUAL.

16. the families' shapes (``family_shapes``, run after phase 3): the
   bit-plane kernel at every matrix shape of mamba2-780m and qwen2-moe-a2.7b
   (FAMILY_VMM_SHAPES) at M = 4 and 64, and the attention kernel at
   qwen2-moe's heads (MHA, 16 KV heads of 128, bf16) at decode and a
   prefill chunk over fp, int8 and int4 pages: EQUAL; then the
   stacked-expert VMMs (``stacked_vmm``): qwen2-moe's expert stack
   [64, 2048, 1408] at C = 4 and 16 rows per expert through the bit-plane
   kernel and a LUT-carrying [6, 256, 512] stack through the LUT-readout
   kernel, each as one call of the kernel's experts' entry (the expert on
   its grid; a zeroing memset only where the plan splits) and as E calls
   of its 2-D entry, both EQUAL to the plain versions' loop and, through
   the engine's ``dense`` (one call per stack), to the same call under the
   plain versions; both forms timed in the same call, with the bound and
   ``torch._int_mm`` over the experts (not under ``--src``);
17. ``serve_ssm``: mamba2-780m (48 layers, d 1536, 48 SSD heads, state 128,
   vocab 50280) at full size, seed-0 weights frozen by ``da_mode="auto"``
   (``bitplane_stacked`` throughout, 97 bit-plane calls per forward), the
   phase-6 requests on ``runtime="auto"`` (the slot runtime: exact-length
   prefills into a MambaCache), tokens EQUAL to the plain-swapped serve's,
   and a width-4 decode window;
18. ``serve_moe``: qwen2-moe-a2.7b (24 layers, d 2048, MHA 16 heads, q/k/v
   biases, 60 experts padded to 64, top-4, 4 shared, vocab 151936) at full
   size, dropless, the same freeze (193 bit-plane calls per forward, one
   per stacked expert pack), the phase-6 requests on the paged
   runtime with the attention kernel, tokens EQUAL to the plain-swapped
   serve's, and a width-4 decode window;
19. ``family_variants``: jamba-1.5-large-398b at one period (8 of its 72
   layers, full width: attention at position 4, Mamba elsewhere, MoE at 1,
   3, 5 and 7; initialised and frozen block by block, since its bf16
   weights do not fit the card beside its codes) and moonshot-v1-16b-a3b at
   4 of 48 layers: a 16-row prefill into ``init_caches`` (KVCache and
   MambaCache) and 4 decode steps, kernels against plain logits EQUAL.

``--phase plans`` runs none of these after the build: it times each
constant of the two VMM plans (kernels/bitplane_vmm.py, kernels/da_vmm.py)
against its alternatives at the shapes of phases 2-3, each EQUAL to the
plain version, and the attention plan's cluster-size cap ``_NS_MAX``
(kernels/paged_attention.py) at decode and verify reads of batch 1-4, each
EQUAL to the plain read, in two passes of opposite order.

Each path (6-15 and 17-19, each leg of 10 and 11, each run of 12 and 14,
each model of 15 and 19) sets the kernels' launch counts
to 0 just before it runs and reads them just after, and fails if an
attention read of this port queued other than one CUDA launch.  Then the
``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power line, and last
the ``{"ok": true, "device": ...}`` line.  Any failed check raises and the
script exits non-zero; with no card it exits 2, and without the port beside
it (``src/repro_torch``) it exits 3, before printing a result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
INT8_OPS_PER_S = 1979e12       # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
#: int32 adds on the CUDA cores: the data sheet's 67 TFLOP/s float32 counts
#: an FMA as 2 flops on 128 lanes per SM; Hopper has 64 INT32 lanes per SM,
#: and one IADD3 (or a shift-and-add LEA) retires up to two adds per lane per
#: clock, so the operations bound counts two adds per INT32 lane per clock
INT32_OPS_PER_S = 67e12 / 2
L2_FLUSH_BYTES = 256 << 20     # > the 50 MB L2: each timed launch starts cold
#: device clock cycles spun before each timed call (about 0.1 ms at 1.98 GHz):
#: the host enqueues the call meanwhile, so the events time the device alone
HOST_COVER_CYCLES = 200_000

#: qwen3-8b weight shapes the serving path hands the bit-plane kernel
#: (fused q|k|v, wo, up/gate, down, LM head)
VMM_SHAPES = ((4096, 6144), (4096, 4096), (4096, 12288), (12288, 4096),
              (4096, 151936))
#: LUT-serving model shapes the LUT kernel reads (q and wo, k and v, up and
#: gate, down, LM head), each with its own tables
LUT_SHAPES = ((256, 256), (256, 128), (256, 768), (768, 256), (256, 8000))
#: the speculative paths' draft: gamma tokens on the top DRAFT_X_BITS planes;
#: verify reads pow2(gamma + 1) query rows, the last a pad column
GAMMA, DRAFT_X_BITS, VERIFY_T = 2, 4, 4
#: (M, x_bits) of each VMM shape the two VMM phases check and time: decode
#: and verify (4 lanes x VERIFY_T rows) and prefill at 8 bits, and the
#: truncated draft's decode at DRAFT_X_BITS
VMM_ROWS = ((4, 8), (4 * VERIFY_T, 8), (64, 8), (4, DRAFT_X_BITS))
#: this port's paged-attention kernel and plain read sum in float64 and
#: round at the same points, so they must be EQUAL.  An older checkout's
#: (``--src``) summed in float32, in another order than its plain read: one
#: bf16 ulp at magnitude 1 bounds that in bfloat16, 1e-5 in float32
ATTN_ATOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
#: the reference's tolerance for its bfloat16 score pipeline
#: (``softmax_dtype="bfloat16"``) against the gather read (one bf16 ulp per
#: reduction, tests/test_paged_attention.py); printed beside this port's
#: bf16 cases, which are held EQUAL
ATTN_BF16_SOFTMAX_ATOL = 2e-2
#: head shapes and (B, T, W) cases of the attention phase.  qwen3-8b, bf16:
#: decode at batch 4, 2 and 1, verify (T = VERIFY_T, batch 4) and prefill at
#: max_len 256 / page 16 (W = 17), and a long table (W = 300) at decode and
#: prefill.  The LUT-serving model, f32: the same at max_len 128 / page 16
#: (W = 9), without the long table.  qwen2-moe-a2.7b, bf16 (one query head
#: per KV head, 16 of them): decode and prefill at W = 17.  The first case
#: of each is its decode.
ATTN_HEADS = (("bfloat16", dict(h=32, kv=8, hd=128),
               ((4, 1, 17), (2, 1, 17), (1, 1, 17), (4, VERIFY_T, 17),
                (4, 16, 17), (4, 1, 300), (2, 16, 300))),
              ("float32", dict(h=4, kv=2, hd=64),
               ((4, 1, 9), (2, 1, 9), (1, 1, 9), (4, VERIFY_T, 9), (4, 16, 9))),
              ("bfloat16", dict(h=16, kv=16, hd=128), ((4, 1, 17), (4, 16, 17))))
#: the case of each head shape run again with one row's queries all masked
ATTN_MASKED = {"bfloat16": (4, 16, 17), "float32": (4, 1, 9)}
#: the activation dtype each path hands the attention kernel
PATH_DTYPE = {"serve": "bfloat16", "serve_int8kv": "bfloat16",
              "serve_prefix": "bfloat16", "serve_spec": "bfloat16",
              "serve_obs": "bfloat16",
              "artifact_lut": "float32", "artifact_lut_spec": "float32",
              "artifact_ci": "float32", "artifact_auto": "float32",
              "serve_dense": "bfloat16", "dense_variants": "bfloat16",
              "serve_ssm": "bfloat16", "serve_moe": "bfloat16",
              "family_variants": "bfloat16"}


#: a file that receives every emitted line too (``--out``), for lines the
#: tail of the standard output would cut
_OUT = []


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    for path in _OUT:
        with open(path, "a") as f:
            f.write(line + "\n")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_cuda(fn, iters: int, flush=None, warmup: int = 2, spin: bool = True) -> float:
    """Mean ms of ``fn`` from CUDA events, each call after an L2 flush.  With
    ``spin`` a device spin before the start event covers the host's enqueue
    of ``fn`` (a wrapper that makes several launches would otherwise leave
    its host time between them on the clock); without it the events also
    time whatever of the enqueue the L2 flush does not cover."""
    import torch

    total = 0.0
    for i in range(warmup + iters):
        if flush is not None:
            flush.zero_()
        if spin:
            torch.cuda._sleep(HOST_COVER_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if i >= warmup:
            total += a.elapsed_time(b)
    return total / iters


def host_us(fn, iters: int) -> dict:
    """Mean host µs to enqueue one call of ``fn``: ``idle`` with the device
    idle before each call; ``busy`` behind a device spin, where a call that
    waits for the device shows the wait."""
    import torch

    fn()
    torch.cuda.synchronize()
    idle = 0.0
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        idle += time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda._sleep(10 * HOST_COVER_CYCLES * iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    busy = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"idle": idle / iters * 1e6, "busy": busy / iters * 1e6}


def device_ms_by_kernel(fn, iters: int, flush, pattern: str) -> dict:
    """Device ms per call of ``fn`` from ``torch.profiler`` for each device
    event whose name matches the regex ``pattern`` (keyed by the word that
    starts there; a memset shows as ``Memset``), L2 flushed before each call
    by an elementwise kernel (not a memset).  A trace that holds none is
    taken again (the profiler has once returned an empty one), three times
    at most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.add_(1)
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            m = re.search(r"(?:" + pattern + r")\w*", e.name)
            if e.device_type == DeviceType.CUDA and m:
                out[m[0]] = out.get(m[0], 0.0) + e.time_range.elapsed_us() / 1e3 / iters
        if out:
            return out
    raise AssertionError(f"the profiler traced no {pattern} kernel")


def call_times(fn, flush, pattern: str) -> dict:
    """One call of ``fn`` on both event timers (``ms`` with the device spin
    before the start event, ``ms_no_spin`` without), by kernel on the
    device (``torch.profiler``) and on the host (µs to enqueue)."""
    by_kernel = device_ms_by_kernel(fn, 5, flush, pattern)
    return {"ms": time_cuda(fn, 20, flush),
            "ms_no_spin": time_cuda(fn, 20, flush, spin=False),
            "device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel,
            "host_us": host_us(fn, 20)}


def phase_device():
    from repro_torch.kernels import build

    secs = build.build_all()
    emit({"phase": "device", "smi": smi_line(), "build_s": secs,
          "ptxas": build.ptxas_summary(),
          "attention_ptxas": _kernel_resources(build.ptxas_summary(), "paged_attn_")})


def _kernel_resources(lines, prefix) -> list:
    """Registers and spill bytes of each instance of the kernels whose
    mangled name holds ``prefix``, from the ptxas summary lines."""
    out, cur = [], None
    for line in lines:
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            cur = {"entry": m.group(1)} if prefix in m.group(1) else None
            if cur:
                out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def lut_model_cfg():
    """The repo's LUT-serving model (``examples/serve_da.py::build_cfg``):
    qwen3 family, 4 layers, d 256, 4 heads over 2 KV heads of 64, d_ff 768,
    vocab 8000, float32.  Every block matrix fits the default LUT budget;
    the LM head's tables (65.5M cells) do not."""
    from repro_torch.configs.registry import get

    return dataclasses.replace(
        get("qwen3-8b"), name="qwen3-20m", n_layers=4, d_model=256, n_heads=4,
        n_kv_heads=2, head_dim=64, d_ff=768, vocab=8000,
        param_dtype="float32", compute_dtype="float32")


def _vmm_module(name):
    """The port's kernel module (this checkout's, or ``--src``'s)."""
    return importlib.import_module(f"repro_torch.kernels.{name}")


def _bitplane_fields(mod, m, k, n) -> dict:
    """The tile and split a call of this shape runs with."""
    plan = mod.bitplane_plan(m, k, n, _vmm_module("build").sms(0))
    return {"tokens_per_block": plan.tokens, "k_splits": plan.splits,
            "blocks_per_launch": plan.blocks}


#: what the VMM rows' library_ms times
LIBRARY = ("torch._int_mm on the int8 codes, zero-padded to its shape rule "
           "(M > 16, K and N multiples of 8) and the weights column-major, "
           "laid out outside the timing")


def _library_ms(xq, wq, flush) -> float:
    """ms of one ``torch._int_mm`` computing ``xq @ wq`` (signed int8 codes)
    on operands laid out once (``engine.int_mm_weights`` / ``int_mm_acts``)."""
    import torch

    from repro_torch.core.engine import int_mm_acts, int_mm_weights

    w8 = int_mm_weights(wq)
    x8 = int_mm_acts(xq, w8.shape[0])
    return time_cuda(lambda: torch._int_mm(x8, w8), 20, flush)


def phase_bitplane(flush):
    import torch

    from repro_torch.core.da import DAConfig
    from repro_torch.kernels.ref import bitplane_vmm_ref

    mod = _vmm_module("bitplane_vmm")
    kernel = mod.bitplane_vmm_cuda
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    for k, n in VMM_SHAPES:
        wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                           dtype=torch.int8)
        # decode, verify (batch 4 x pow2(gamma + 1) rows) and prefill at 8
        # bits, and the truncated draft's decode: the top 4 planes of the
        # codes, shifted down (core.da.truncate_codes)
        for m, x_bits in VMM_ROWS:
            cfg = DAConfig(x_bits=x_bits, x_signed=True)
            half = 1 << (x_bits - 1)
            xq = torch.randint(-half, half, (m, k), generator=gen, device="cuda",
                               dtype=torch.int32)
            y = kernel(xq, wq, cfg)
            ref = bitplane_vmm_ref(xq, wq, cfg)
            torch.cuda.synchronize()
            if not torch.equal(y, ref):
                raise AssertionError(f"bitplane kernel != plain at M={m} K={k} "
                                     f"N={n} x_bits={x_bits}")
            row = {"m": m, "k": k, "n": n, "x_bits": x_bits, "equal": True,
                   "max_abs_err": 0,
                   **_bitplane_fields(mod, m, k, n),
                   **call_times(lambda: kernel(xq, wq, cfg), flush, BITPLANE_KERNELS)}
            row["plain_ms"] = time_cuda(lambda: bitplane_vmm_ref(xq, wq, cfg), 3, flush, 1)
            lib_ms = _library_ms(xq, wq, flush)
            nbytes = k * n + 4 * m * k + 4 * m * n
            ops = 2 * m * k * n * cfg.x_bits
            bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "operations": ops / INT8_OPS_PER_S * 1e3}
            by = max(bound, key=bound.get)
            row.update(bound_ms=bound[by], bound_by=by, library_ms=lib_ms)
            rows.append(row)
            del xq, y, ref
        del wq
        torch.cuda.empty_cache()
    emit({"phase": "bitplane_vmm", "plain": "float64 plane products (exact)",
          "library": LIBRARY, "shapes": rows})
    return rows


def phase_int8(flush):
    """The engine's int8 baseline (``xq.int8 @ wq.int8 → int32``, not a DA
    kernel: ``torch._int_mm`` on operands zero-padded to M > 16 and K, N
    multiples of 8, the weights laid out column-major by the pack's first
    call and kept, the result sliced back) at every VMM_SHAPES x VMM_ROWS
    shape, EQUAL to the exact product (float64 on the card: every partial is
    an integer far below 2^53)."""
    import torch

    from repro_torch.core.da import DAConfig
    from repro_torch.core.engine import PackedWeights, get_backend

    fn = get_backend("int8").fn
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for k, n in VMM_SHAPES:
        wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                           dtype=torch.int8)
        packed = PackedWeights(wq=wq, w_scale=torch.ones(1, n, device="cuda"),
                               luts=None, cfg=DAConfig(x_signed=True), mode="int8")
        for m, x_bits in VMM_ROWS:
            cfg = DAConfig(x_bits=x_bits, x_signed=True)
            half = 1 << (x_bits - 1)
            xq = torch.randint(-half, half, (m, k), generator=gen, device="cuda",
                               dtype=torch.int32)
            y = fn(xq, packed, cfg)
            ref = (xq.double() @ wq.double()).long()
            torch.cuda.synchronize()
            if not (y.dtype == torch.int32 and torch.equal(y.long(), ref)):
                raise AssertionError(f"int8 baseline != exact product at M={m} "
                                     f"K={k} N={n}")
            nbytes = k * n + m * k + 4 * m * n
            bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                     "operations": 2 * m * k * n / INT8_OPS_PER_S * 1e3}
            by = max(bound, key=bound.get)
            rows.append({"m": m, "k": k, "n": n, "x_bits": x_bits, "equal": True,
                         "padded_m": max(m, 17),
                         "ms": time_cuda(lambda: fn(xq, packed, cfg), 20, flush),
                         "ms_no_spin": time_cuda(lambda: fn(xq, packed, cfg), 20,
                                                 flush, spin=False),
                         "library_ms": _library_ms(xq, wq, flush),
                         "bound_ms": bound[by], "bound_by": by})
            del xq, y, ref
        del wq, packed
        torch.cuda.empty_cache()
    emit({"phase": "int8_vmm", "backend": "int8: the codes' padding, "
          "torch._int_mm on the pack's kept weight operand and the slice per "
          "call (ms); torch._int_mm alone (library_ms)", "plain": "exact product (float64)", "shapes": rows})
    return rows


def _lut_terms(xq, luts, cfg):
    """The two least times for this data: the distinct LUT rows its
    addresses read, plus the codes and the output, at the HBM rate; and the
    int32 adds at the CUDA cores' rate.  Returns ({bytes, operations} ms,
    rows read)."""
    from repro_torch.core.da import group_addresses

    m, k = xq.shape
    g, _, n = luts.shape
    addr = group_addresses(xq, cfg).permute(2, 0, 1).reshape(g, -1)
    srt = addr.sort(dim=1).values
    rows = int(g + (srt[:, 1:] != srt[:, :-1]).sum())
    return ({"bytes": (4 * rows * n + 4 * m * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3,
             "operations": m * cfg.x_bits * g * n / INT32_OPS_PER_S * 1e3}, rows)


def _lut_bound(xq, luts, cfg):
    """Least time for this data: the larger of :func:`_lut_terms`' two."""
    bound, rows = _lut_terms(xq, luts, cfg)
    by = max(bound, key=bound.get)
    return bound[by], by, rows


#: the kernels' names in the profiler's trace, and the output zeroing of a
#: split call
BITPLANE_KERNELS = "bitplane_vmm_kernel|Memset"
LUT_KERNELS = "lut_gather_kernel|Memset"


def _lut_fields(mod, m, n, luts) -> dict:
    """The split a call of this shape runs with."""
    plan = mod.lut_plan(m, n, luts.shape[0], _vmm_module("build").sms(0))
    return {"tokens_per_block": plan.bm, "groups_per_block": plan.gpb,
            "blocks_per_launch": plan.blocks}


def phase_lut_vmm(flush):
    import torch

    from repro_torch.core.da import DAConfig, build_luts
    from repro_torch.kernels.ref import da_vmm_ref

    mod = _vmm_module("da_vmm")
    kernel = mod.da_vmm_cuda
    gen = torch.Generator(device="cuda").manual_seed(4)

    def case(m, k, n, x_bits, signed, group):
        lo, hi = ((-(1 << (x_bits - 1)), 1 << (x_bits - 1)) if signed
                  else (0, 1 << x_bits))
        xq = torch.randint(lo, hi, (m, k), generator=gen, device="cuda",
                           dtype=torch.int32)
        wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                           dtype=torch.int8)
        cfg = DAConfig(group_size=group, x_bits=x_bits, x_signed=signed)
        luts = build_luts(wq, group)
        ref = da_vmm_ref(xq, luts, cfg)
        y = kernel(xq, luts, cfg)
        torch.cuda.synchronize()
        if not torch.equal(y, ref):
            raise AssertionError(f"LUT kernel != plain at M={m} K={k} N={n} "
                                 f"x_bits={x_bits} signed={signed} L={group}")
        return xq, wq, luts, cfg

    timed = []
    for k, n in LUT_SHAPES:
        for m, x_bits in VMM_ROWS:
            xq, wq, luts, cfg = case(m, k, n, x_bits, True, 8)
            row = {"m": m, "k": k, "n": n, "x_bits": x_bits, "equal": True,
                   "max_abs_err": 0,
                   **_lut_fields(mod, m, n, luts),
                   **call_times(lambda: kernel(xq, luts, cfg), flush, LUT_KERNELS)}
            row["plain_ms"] = time_cuda(lambda: da_vmm_ref(xq, luts, cfg), 5, flush, 1)
            lib_ms = _library_ms(xq, wq, flush)
            bound, by, rows = _lut_bound(xq, luts, cfg)
            row.update(bound_ms=bound, bound_by=by, rows_read=rows,
                       table_mb=luts.numel() * 4 / 1e6, library_ms=lib_ms)
            timed.append(row)
            del xq, wq, luts
    checked = 0
    # the reference's kernel-test shapes (tests/test_kernels.py), both
    # signednesses; code widths and group sizes; ragged K
    for m, k, n in ((1, 8, 1), (4, 25, 6), (16, 64, 32), (33, 100, 17),
                    (300, 130, 70), (64, 256, 128)):
        for signed in (False, True):
            case(m, k, n, 8, signed, 8)
            checked += 1
    for x_bits in (2, 4, 8):
        for group in (4, 8):
            for signed in (False, True):
                case(8, 37, 24, x_bits, signed, group)  # K = 37: ragged
                checked += 1
    case(5, 40, 12, 8, True, 16)
    case(4, 4096, 300, 8, True, 8)
    case(300, 100, 17, 8, True, 16)
    checked += 3
    emit({"phase": "lut_vmm", "plain": "LUT gather (int32)",
          "library": LIBRARY,
          "shapes": timed, "cases_checked": checked + len(timed)})
    return timed


#: the VMM plans' constants the plans phase times, each with the values it
#: tries (the shipped one among them) and the M it tries them at, over
#: VMM_SHAPES (bit-plane) or LUT_SHAPES (LUT readout)
PLAN_SWEEP = (("bitplane_vmm", "_WAVES", (1, 2, 4), (4, 64)),
              ("bitplane_vmm", "_MIN_STEPS", (2, 4, 8), (4, 64)),
              ("bitplane_vmm", "_WM", (2, 4), (64,)),
              ("da_vmm", "_GPB", (4, 8, 16), (4, 64)),
              ("da_vmm", "_DECODE_BM", (1, 2), (4,)),
              ("da_vmm", "_PREFILL_BM", (1, 2), (64,)))


def phase_plans(flush):
    """Each constant of PLAN_SWEEP at each of its values, at every shape:
    the call EQUAL to the plain version, its device ms (``torch.profiler``)
    and its ms on the spin timer, in two passes, the second in the
    opposite order of values."""
    import torch

    from repro_torch.core.da import DAConfig, build_luts
    from repro_torch.kernels.ref import bitplane_vmm_ref, da_vmm_ref

    gen = torch.Generator(device="cuda").manual_seed(5)
    cfg = DAConfig(group_size=8, x_bits=8, x_signed=True)
    sms = _vmm_module("build").sms(0)
    for name, const, values, ms in PLAN_SWEEP:
        mod = _vmm_module(name)
        plan_fn = mod.bitplane_plan if name == "bitplane_vmm" else mod.lut_plan
        shipped = getattr(mod, const)
        rows = []
        for k, n in VMM_SHAPES if name == "bitplane_vmm" else LUT_SHAPES:
            wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                               dtype=torch.int8)
            luts = build_luts(wq, 8) if name == "da_vmm" else None
            for m in ms:
                xq = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                                   dtype=torch.int32)
                if luts is None:
                    ref, pattern = bitplane_vmm_ref(xq, wq, cfg), BITPLANE_KERNELS
                    call = functools.partial(mod.bitplane_vmm_cuda, xq, wq, cfg)
                    plan_args = (m, k, n, sms)
                else:
                    ref, pattern = da_vmm_ref(xq, luts, cfg), LUT_KERNELS
                    call = functools.partial(mod.da_vmm_cuda, xq, luts, cfg)
                    plan_args = (m, n, luts.shape[0], sms)
                row = {"m": m, "k": k, "n": n}
                try:
                    for order in (values, values[::-1]):
                        for v in order:
                            setattr(mod, const, v)
                            plan_fn.cache_clear()
                            if not torch.equal(call(), ref):
                                raise AssertionError(f"{name} with {const}={v} != plain "
                                                     f"at M={m} K={k} N={n}")
                            r = row.setdefault(str(v), {"blocks": plan_fn(*plan_args).blocks,
                                                        "device_ms": [], "ms": []})
                            r["device_ms"].append(sum(
                                device_ms_by_kernel(call, 5, flush, pattern).values()))
                            r["ms"].append(time_cuda(call, 10, flush))
                finally:
                    setattr(mod, const, shipped)
                    plan_fn.cache_clear()
                rows.append(row)
                del xq, ref
            del wq, luts
            torch.cuda.empty_cache()
        emit({"phase": "plans", "kernel": name, "constant": const,
              "shipped": shipped, "shapes": rows})
    _attention_plan_sweep(flush)


#: the attention plan's constant the plans phase times (the most chunks a
#: row takes: the cluster's size), its values, and the (B, T) reads it
#: times them at, at each head shape's decode width
ATTN_PLAN_SWEEP = ("_NS_MAX", (2, 4, 8), ((1, 1), (2, 1), (4, 1), (4, VERIFY_T)))


def _attention_plan_sweep(flush):
    """ATTN_PLAN_SWEEP's constant at each of its values, at both head shapes
    over fp pages: the read EQUAL to the plain read, its plan,
    its device ms (``torch.profiler``) and its ms on the spin timer, in two
    passes of opposite order."""
    import torch

    from repro_torch.models.attention import paged_gather_read

    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    const, values, cases = ATTN_PLAN_SWEEP
    shipped = getattr(pa, const)
    exact = _exact_read(pa)
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = []
    for dname, heads, shapes in ATTN_HEADS:
        w = shapes[0][2]
        for b, t in cases:
            q, kp, vp, table, tpos = _paged_case(gen, b, t, w, b * w + 8,
                                                 getattr(torch, dname), **heads)
            ref = paged_gather_read(q, kp, vp, table, tpos).float()
            call = functools.partial(pa.paged_attention_cuda, q, kp, vp, table, tpos)
            row = {"dtype": dname, "b": b, "t": t, "w": w}
            try:
                for order in (values, values[::-1]):
                    for v in order:
                        setattr(pa, const, v)
                        pa.split_plan.cache_clear()
                        out = call()
                        err = (out.float() - ref).abs().max().item()
                        if not (torch.equal(out.float(), ref) if exact
                                else err <= ATTN_ATOL[dname]):
                            raise AssertionError(f"attention with {const}={v}: {err} "
                                                 f"off the plain read at {row}")
                        r = row.setdefault(str(v), {
                            **_split_fields(pa, b, t, w, kp.shape[1], heads, q.dtype),
                            "device_ms": [], "ms": []})
                        r["device_ms"].append(sum(
                            device_ms_by_kernel(call, 5, flush, "paged_attn_").values()))
                        r["ms"].append(time_cuda(call, 10, flush))
            finally:
                setattr(pa, const, shipped)
                pa.split_plan.cache_clear()
            rows.append(row)
    emit({"phase": "plans", "kernel": "paged_attention", "constant": const,
          "shipped": shipped, "shapes": rows})


def _exact_read(pa) -> bool:
    """Whether the port's attention kernel and plain read sum in float64 and
    so must be EQUAL: a port with the bfloat16 score pipeline does; an older
    checkout's (``--src``) summed in float32."""
    return hasattr(pa.paged_attention_cuda, "launches_by_softmax")


def _paged_case(gen, b, t, w, p, dtype, ps=16, kv=8, h=32, hd=128):
    """Pool with permuted physical pages, a garbage column, ragged tpos and a
    pad lane at the garbage position; a read of VERIFY_T rows is verify's,
    its last column the pad query at the garbage position."""
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
    if t == VERIFY_T:
        tpos[:, -1] = (w - 1) * ps
    return q, kp, vp, table.contiguous(), tpos.contiguous()


def phase_attention(flush):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(2)
    rows = []
    # each case over fp pages and over int8 / int4 codes of the same K and V
    for dname, heads, shapes in ATTN_HEADS:
        for b, t, w in shapes:
            for mode in ("where", "additive"):
                rows += _attention_case(gen, b, t, w, mode, dname, heads, flush)
        for mode in ("where", "additive"):  # checked, not timed
            rows += _attention_case(gen, *ATTN_MASKED[dname], mode, dname, heads,
                                    None, masked_row=1)
        # the bfloat16 score pipeline at decode and at verify (its last
        # column the pad query), the decode case timed; an older checkout's
        # port (--src) may have no such pipeline
        if not hasattr(importlib.import_module(
                "repro_torch.kernels.paged_attention").paged_attention_cuda,
                "launches_by_softmax"):
            continue
        for b, t, w in shapes[:1] + tuple(s for s in shapes if s[1] == VERIFY_T):
            for mode in ("where", "additive"):
                rows += _attention_case(gen, b, t, w, mode, dname, heads,
                                        flush if t == 1 else None,
                                        softmax="bfloat16")
        rows += _attention_case(gen, *ATTN_MASKED[dname], "additive", dname,
                                heads, None, masked_row=1, softmax="bfloat16")
    exact = _exact_read(importlib.import_module("repro_torch.kernels.paged_attention"))
    emit({"phase": "paged_attention", "atol": 0.0 if exact else ATTN_ATOL,
          "bf16_softmax_reference_atol": ATTN_BF16_SOFTMAX_ATOL, "cases": rows})
    _row_invariance(gen)
    return rows


def _row_invariance(gen):
    """Spec and prefix serving keep the plain serve's tokens only if a row's
    result does not depend on the call it rides in.  At both head shapes and
    over fp and int8 pages: a read of VERIFY_T rows (windows at ragged
    starts, the last column at the garbage position as the verify step's
    pad) and one of its first 3 rows, against T = 1 reads of each query at
    batch 4 and of row 0 alone: EQUAL.  Decode reads of a row at batch 2-4
    against the row alone, 50 random position sets: EQUAL.  The norm's sum
    of squares of a row at 1-64 rows: EQUAL (the float32 sum's count of
    differing rows is printed beside it)."""
    import torch

    from repro_torch.models import kv_quant

    kernel = importlib.import_module(
        "repro_torch.kernels.paged_attention").paged_attention_cuda
    rows = []
    for dname, heads, shapes in ATTN_HEADS:
        w = shapes[0][2]
        q, kp, vp, table, _ = _paged_case(gen, 4, VERIFY_T, w, 4 * w + 8,
                                          getattr(torch, dname), **heads)
        ps = kp.shape[1]
        start = torch.randint(0, (w - 1) * ps - VERIFY_T, (4,), generator=gen,
                              device="cuda")
        tpos = (start[:, None] + torch.arange(VERIFY_T, device="cuda")[None]
                ).to(torch.int32)
        tpos[:, -1] = (w - 1) * ps
        for fmt in ("fp", "int8"):
            if fmt == "fp":
                kc, vc, scales = kp, vp, {}
            else:
                (kc, ks), (vc, vs) = (kv_quant.quantize_kv(x, fmt) for x in (kp, vp))
                scales = {"k_scale": ks, "v_scale": vs}

            def read(qq, tp, tb=table):
                return kernel(qq.contiguous(), kc, vc, tb.contiguous(),
                              tp.contiguous(), **scales)

            full, three = read(q, tpos), read(q[:, :3], tpos[:, :3])
            equal = True
            for j in range(VERIFY_T - 1):
                one = read(q[:, j:j + 1], tpos[:, j:j + 1])
                solo = read(q[:1, j:j + 1], tpos[:1, j:j + 1], table[:1])
                equal &= (torch.equal(full[:, j], one[:, 0])
                          and torch.equal(three[:, j], one[:, 0])
                          and torch.equal(solo[0, 0], one[0, 0]))
            rows.append({"dtype": dname, "kv": fmt, "w": w, "t": VERIFY_T,
                         "starts": start.tolist(), "equal": bool(equal)})
    # decode reads: a row at batch 2-4 against the same row read alone, at
    # random positions (the split's chunk must not follow the batch)
    decode = []
    for dname, heads, shapes in ATTN_HEADS:
        w = shapes[0][2]
        q, kp, vp, table, _ = _paged_case(gen, 4, 1, w, 4 * w + 8,
                                          getattr(torch, dname), **heads)
        differ = total = 0
        for _ in range(50):
            q.normal_(generator=gen)
            tpos = torch.randint(0, (w - 1) * kp.shape[1], (4, 1), generator=gen,
                                 device="cuda").to(torch.int32)
            alone = [kernel(q[r:r + 1], kp, vp, table[r:r + 1].contiguous(),
                            tpos[r:r + 1]) for r in range(4)]
            for b in (2, 3, 4):
                out = kernel(q[:b], kp, vp, table[:b].contiguous(),
                             tpos[:b].contiguous())
                total += b
                differ += sum(not torch.equal(out[r], alone[r][0]) for r in range(b))
        decode.append({"dtype": dname, "w": w, "rows": total, "differing": differ})
    # the RMS norm's sum of squares: in float32 CUDA's reduction splits a row
    # by the row count; summed in float64 (models/layers.py) it does not
    from repro_torch.models.layers import _mean_square

    # activations as the model holds them: bfloat16 values, widened
    x = (3 * torch.randn(64, 4096, generator=gen, device="cuda")).to(
        torch.bfloat16).float()
    f32 = torch.mean(torch.square(x), dim=-1, keepdim=True)
    norms = {"rows": 64, "f32_differing": {}, "f64_differing": {}}
    for r in (1, 2, 4, 16, 64):
        norms["f32_differing"][r] = int((torch.mean(torch.square(x[:r]), dim=-1,
                                                     keepdim=True) != f32[:r]).sum())
        norms["f64_differing"][r] = int((_mean_square(x[:r]) != _mean_square(x)[:r]).sum())
    emit({"phase": "row_invariance", "verify": rows, "decode": decode,
          "norm_sum_of_squares": norms})
    if not all(r["equal"] for r in rows):
        raise AssertionError(f"a verify read's rows differ from decode reads: {rows}")
    if any(d["differing"] for d in decode) or any(norms["f64_differing"].values()):
        raise AssertionError(f"a row's read or norm depends on its batch: {decode} {norms}")


def _one_launch_read(pa) -> bool:
    """Whether the port's attention read is one cluster launch (this
    checkout's); an older checkout's (``--src``) launched twice a read."""
    return hasattr(pa, "block_shape")


def _split_fields(pa, b, t, w, ps, heads, dtype, fmt="fp") -> dict:
    """The split a read of this case runs with: chunks (the cluster's
    blocks), pages per chunk, blocks per launch, and for a cluster read
    its shared bytes per block and where the chunk's scores live."""
    h, kv, hd = heads["h"], heads["kv"], heads["hd"]
    if not _one_launch_read(pa):
        plan = pa.split_plan(t, h, kv, hd, ps, w, _vmm_module("build").sms(0))
        return {"chunks": plan.ns, "chunk_pages": plan.chunk,
                "blocks_per_launch": kv * b * plan.ns}
    plan = pa.split_plan(kv, ps, w, _vmm_module("build").sms(0))
    shape = pa.block_shape(t, h, kv, hd, ps, plan.chunk, dtype.itemsize, fmt)
    return {"chunks": plan.ns, "chunk_pages": plan.chunk, "cluster_size": plan.ns,
            "blocks_per_launch": kv * b * plan.ns, "smem_bytes": shape.smem,
            "scores_in": "scratch" if shape.scratch else "shared",
            "max_active_clusters": pa.max_clusters(dtype, fmt, hd, plan.ns,
                                                   shape.smem, 0)}


def _attention_case(gen, b, t, w, mode, dname, heads, flush, masked_row=None,
                    softmax="float32"):
    import torch

    from repro_torch.models import kv_quant
    from repro_torch.models.attention import paged_gather_read

    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    kernel = pa.paged_attention_cuda
    exact = _exact_read(pa)
    rows = []
    q, kp, vp, table, tpos = _paged_case(gen, b, t, w, b * w + 8,
                                         getattr(torch, dname), **heads)
    if masked_row is not None:
        tpos[masked_row] = -1
    for fmt in ("fp", "int8", "int4"):
        split = _split_fields(pa, b, t, w, kp.shape[1], heads, q.dtype, fmt)
        if fmt == "fp":
            kc, vc, scales = kp, vp, {}
        else:
            (kc, ks), (vc, vs) = (kv_quant.quantize_kv(x, fmt) for x in (kp, vp))
            scales = {"k_scale": ks, "v_scale": vs}
        before = kernel.launches, getattr(kernel, "cuda_launches", None)
        out = kernel(q, kc, vc, table, tpos, mask_mode=mode,
                     softmax_dtype=softmax, **scales)
        if kernel.launches != before[0] + 1:
            raise AssertionError("an attention read did not count one read")
        if before[1] is not None:
            split["cuda_launches_per_read"] = kernel.cuda_launches - before[1]
        if _one_launch_read(pa) and split["cuda_launches_per_read"] != 1:
            raise AssertionError(f"an attention read queued "
                                 f"{split['cuda_launches_per_read']} CUDA launches")
        ref = paged_gather_read(q, kc, vc, table, tpos, mask_mode=mode,
                                softmax_dtype=softmax, **scales)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        if not (torch.equal(out, ref) if exact else err <= ATTN_ATOL[dname]):
            raise AssertionError(
                f"paged attention kernel vs plain: {err} off at B={b} "
                f"T={t} W={w} {heads} {dname} {mode} {fmt} pages, "
                f"{softmax} softmax")
        row = {"dtype": dname, "softmax": softmax, "h": heads["h"],
               "kv_heads": heads["kv"],
               "hd": heads["hd"], "b": b, "t": t, "w": w, "kv": fmt,
               "mask_mode": mode, "all_masked_row": masked_row, **split,
               "max_abs_err": err, "equal": bool(torch.equal(out, ref))}
        if mode == "where" and flush is not None:
            row.update(_attention_times(kernel, q, kc, vc, table, tpos, scales,
                                        fmt, flush, softmax))
        rows.append(row)
    return rows


def _attention_times(kernel, q, kc, vc, table, tpos, scales, fmt, flush,
                     softmax="float32"):
    """Kernel, plain and SDPA times and the bound for one case.  The read is
    timed on both event timers (``ms`` with the device spin before the start
    event, ``ms_no_spin`` without), by kernel on the device, and on the
    host.  SDPA runs on the gathered (and dequantized) view, made outside
    the timing."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models import kv_quant
    from repro_torch.models.attention import paged_gather_read

    b, t, h, hd = q.shape
    ps, kv = kc.shape[1], kc.shape[2]
    w = table.shape[1]

    def read():
        return kernel(q, kc, vc, table, tpos, softmax_dtype=softmax, **scales)

    row = {**call_times(read, flush, "paged_attn_"),
           "plain_ms": time_cuda(lambda: paged_gather_read(
               q, kc, vc, table, tpos, softmax_dtype=softmax, **scales), 10, flush)}
    tl = table.long()
    kg, vg = kc[tl], vc[tl]
    if fmt != "fp":
        kg = kv_quant.dequantize_kv(kg, scales["k_scale"][tl], fmt, q.dtype)
        vg = kv_quant.dequantize_kv(vg, scales["v_scale"][tl], fmt, q.dtype)
    kg = kg.reshape(b, -1, kv, hd).transpose(1, 2)
    vg = vg.reshape(b, -1, kv, hd).transpose(1, 2)
    mask = (torch.arange(w * ps, device="cuda")[None, None]
            <= tpos[:, :, None])[:, None]
    qh = q.transpose(1, 2)
    row["library_ms"] = time_cuda(lambda: F.scaled_dot_product_attention(
        qh, kg, vg, attn_mask=mask, enable_gqa=True), 20, flush)
    # the work this data needs: a row reads K and V up to its largest tpos
    # (codes and a 2-byte scale per row when quantized), a query scores and
    # sums up to its own
    live = (tpos.long() + 1).clamp(max=w * ps)
    row_bytes = {"fp": hd * q.element_size(), "int8": hd + 2,
                 "int4": hd // 2 + 2}[fmt]
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * int(live.amax(1).sum()) * kv * row_bytes
              + 4 * b * w + 4 * b * t)
    flops = 4 * int(live.sum()) * h * hd
    bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": flops / BF16_FLOPS_PER_S * 1e3}
    row["bound_by"] = max(bound, key=bound.get)
    row["bound_ms"] = bound[row["bound_by"]]
    return row


#: the VMM entries of ``kernels/ops.py``: each matrix's, and each stack of
#: experts' (one kernel call per pack)
VMM_ENTRIES = ("da_vmm", "bitplane_vmm", "da_vmm_experts", "bitplane_vmm_experts")
#: the launch counts a plain-swapped run must leave at 0
KERNEL_COUNTS = ("bitplane_vmm", "bitplane_vmm_experts", "da_vmm", "da_vmm_experts",
                 "paged_attention")


@contextlib.contextmanager
def plain_vmm():
    """Both VMM kernels swapped for their plain versions (``kernels/ref.py``)
    inside this script only: every DA backend that would launch the
    bit-plane or the LUT-readout kernel on the card runs the plain version
    there instead, so a serve under it is the kernels' plain side."""
    from repro_torch.kernels import ops, ref

    names = [n for n in VMM_ENTRIES if hasattr(ops, n)]
    saved = {n: getattr(ops, n) for n in names}
    for n in names:
        setattr(ops, n, getattr(ref, f"{n}_ref"))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


def phase_logits():
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.core.freeze import freeze_model_da
    from repro_torch.models.model import forward, init_model
    from repro_torch.serve.kvcache import init_paged_caches, pad_position, table_width

    cfg = dataclasses.replace(get("qwen3-8b"), n_layers=2)
    frozen = freeze_model_da(init_model(cfg, seed=0, device="cuda"),
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
    for kv_dtype in ("fp16", "int8"):
        kcfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        out = {}
        for name, attn, vmm in (("kernels", "fused", contextlib.nullcontext),
                                ("plain", "gather", plain_vmm)):
            caches = init_paged_caches(kcfg, b + 1, ps, cfg.dtype(), device="cuda")
            with torch.inference_mode(), vmm():
                logits, _ = forward(frozen, tokens, dataclasses.replace(
                    kcfg, paged_attn=attn), pos, caches, table, last_idx=last)
            out[name] = logits.float()
        if not torch.isfinite(out["kernels"]).all():
            raise AssertionError("non-finite logits through the kernels")
        diff = (out["kernels"] - out["plain"]).abs()
        argmax_eq = (out["kernels"].argmax(-1) == out["plain"].argmax(-1)).all().item()
        equal = torch.equal(out["kernels"], out["plain"])
        emit({"phase": "logits", "layers": 2, "d_model": cfg.d_model,
              "kv_dtype": kv_dtype, "shape": list(out["kernels"].shape),
              "max_abs_err": diff.max().item(), "mean_abs_err": diff.mean().item(),
              "atol": 0.0, "equal": equal,
              "logit_absmax": out["plain"].abs().max().item(),
              "argmax_equal": argmax_eq})
        if not equal:
            raise AssertionError(f"logits kernels vs plain ({kv_dtype} pages) "
                                 f"differ by {diff.max().item()}")
    del frozen, out
    gc.collect()
    torch.cuda.empty_cache()


def _vmm_wrappers() -> dict:
    """The VMM kernels' wrappers by count name; an older checkout's port
    (``--src``) has no experts' entries."""
    out = {}
    for name in ("bitplane_vmm", "da_vmm"):
        mod = _vmm_module(name)
        for key in (name, f"{name}_experts"):
            fn = getattr(mod, f"{key}_cuda", None)
            if fn is not None:
                out[key] = fn
    return out


def _reset_counts():
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    for fn in _vmm_wrappers().values():
        fn.launches = fn.cuda_launches = 0
        fn.launches_by_bits = {}
    paged_attention_cuda.launches = 0
    paged_attention_cuda.cuda_launches = 0
    for fmt in paged_attention_cuda.launches_by_format:
        paged_attention_cuda.launches_by_format[fmt] = 0
    # an older checkout's port (--src) has no bfloat16 score pipeline
    by_softmax = getattr(paged_attention_cuda, "launches_by_softmax", {})
    for sm in by_softmax:
        by_softmax[sm] = 0
    paged_attention_cuda.launches_by_t = {}


def _read_counts():
    """Every kernel's calls since :func:`_reset_counts`: each VMM entry's
    (the experts' entries one per stack; 0 for an older checkout's port
    without them), with the CUDA launches it queued and its calls by
    x_bits, and the attention kernel's reads by format, T and softmax.
    Raises if this port's attention reads queued other than one CUDA
    launch each."""
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    pa = importlib.import_module("repro_torch.kernels.paged_attention")
    if (_one_launch_read(pa) and paged_attention_cuda.cuda_launches
            != paged_attention_cuda.launches):
        raise AssertionError(f"{paged_attention_cuda.launches} attention reads "
                             f"queued {paged_attention_cuda.cuda_launches} CUDA "
                             f"launches, not one each")
    wrappers = _vmm_wrappers()
    out = {}
    for key in ("bitplane_vmm", "bitplane_vmm_experts", "da_vmm", "da_vmm_experts"):
        fn = wrappers.get(key)
        out[key] = fn.launches if fn else 0
        out[f"{key}_cuda_launches"] = fn.cuda_launches if fn else 0
        out[f"{key}_by_bits"] = dict(fn.launches_by_bits) if fn else {}
    return {**out,
            "paged_attention": paged_attention_cuda.launches,
            "paged_attention_cuda_launches": paged_attention_cuda.cuda_launches,
            "paged_attention_by_format": dict(paged_attention_cuda.launches_by_format),
            "paged_attention_by_t": dict(paged_attention_cuda.launches_by_t),
            "paged_attention_by_softmax": dict(getattr(
                paged_attention_cuda, "launches_by_softmax", {}))}


def _serve_requests(eng, vocab, n, seed=0, new=16):
    """Submit ``n`` requests with prompts of 16–64 tokens, run them with the
    launch counts set to 0 just before, and return (reqs, done, counts)."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    reqs = [Request(uid=u, prompt=rng.integers(0, vocab, int(rng.integers(16, 65))
                                               ).astype(np.int32), max_new_tokens=new)
            for u in range(n)]
    return _run_requests(eng, reqs, vocab)


def _run_requests(eng, reqs, vocab):
    """Submit ``reqs``, run them with the launch counts set to 0 just before,
    check every one finished with its ``max_new_tokens`` in-vocab tokens (a
    stop at max_len aside) and return (reqs, done, counts)."""
    import torch

    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    _reset_counts()
    done = eng.run()
    torch.cuda.synchronize()
    counts = _read_counts()
    if len(done) != len(reqs) or any(
            len(done[r.uid].generated) != min(r.max_new_tokens,
                                              eng.max_len - len(r.prompt))
            or not all(0 <= tok < vocab for tok in done[r.uid].generated)
            for r in reqs):
        raise AssertionError("not every request finished with its in-vocab tokens")
    return reqs, done, counts


def _tokens(done, reqs):
    return {r.uid: list(done[r.uid].generated) for r in reqs}


def phase_serve():
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ServeEngine

    cfg = get("qwen3-8b")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    shapes = _shapes_of(params)
    eng = ServeEngine(cfg, params, batch_size=4, max_len=256, page_size=16,
                      da_mode="pallas_bitplane", paged_attn="fused", device="cuda")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    reqs, done, counts = _serve_requests(eng, cfg.vocab, 8)
    if min(counts["bitplane_vmm"], counts["paged_attention"]) <= 0:
        raise AssertionError(f"a kernel was never launched on the main path: {counts}")
    emit(_serve_line("serve", eng, reqs, done, counts,
                     init_s=t1 - t0, freeze_s=t2 - t1))
    emit(decode_window(eng, cfg.vocab))
    return eng.params, counts, _tokens(done, reqs), shapes


def _shapes_of(tree):
    """``tree`` with every tensor replaced by an empty one of its shape and
    dtype on the meta device: what the planner reads, none of the bytes."""
    import torch

    if isinstance(tree, dict):
        return {k: _shapes_of(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes_of(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def _serve_line(phase, eng, reqs, done, counts, **extra):
    import torch

    m = eng.metrics()
    cfg = eng.cfg
    return {"phase": phase, "model": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "kv_dtype": cfg.kv_dtype,
            "requests": len(done), "prompt_tokens": [len(r.prompt) for r in reqs],
            "out_tokens": m["out_tokens"], "steps": m["steps"],
            "tokens_per_s": m["tokens_per_s"], "ttft_p50_ms": m["ttft_p50_ms"],
            "itl_p50_ms": m["itl_p50_ms"], "itl_p99_ms": m["itl_p99_ms"],
            "wall_s": m["wall_s"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts, "first_tokens": done[0].generated[:8], **extra}


def phase_serve_int8kv(params):
    """qwen3-8b at full width and depth again, int8 KV pages, on the weights
    the fp serve froze (never re-packed)."""
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.serve.engine import ServeEngine

    cfg = get("qwen3-8b")
    eng = ServeEngine(cfg, params, batch_size=4, max_len=256, page_size=16,
                      paged_attn="fused", kv_dtype="int8", device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reqs, done, counts = _serve_requests(eng, cfg.vocab, 8)
    if (min(counts["bitplane_vmm"], counts["paged_attention"]) <= 0
            or counts["paged_attention_by_format"]["int8"] <= 0):
        raise AssertionError(f"the int8-page serve missed a kernel: {counts}")
    emit(_serve_line("serve_int8kv", eng, reqs, done, counts))
    return counts


def phase_serve_prefix(params):
    """Shared-prefix serving at full width and depth on the fp serve's frozen
    weights: 8 requests share a 48-token prefix (3 pages) with 16–32 tokens
    of their own, served with the prefix cache and without; tokens EQUAL."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get("qwen3-8b")
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab, 48)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, int(rng.integers(
        16, 33)))]).astype(np.int32) for _ in range(8)]
    runs, line = {}, {}
    for cached in (True, False):
        eng = ServeEngine(cfg, params, batch_size=4, max_len=256, page_size=16,
                          paged_attn="fused", prefix_cache=cached, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reqs, done, counts = _run_requests(
            eng, [Request(uid=u, prompt=p, max_new_tokens=16)
                  for u, p in enumerate(prompts)], cfg.vocab)
        runs[cached] = _tokens(done, reqs)
        m = eng.metrics()
        if cached:
            pc = m["prefix_cache"]
            if min(counts["bitplane_vmm"], counts["paged_attention"]) <= 0:
                raise AssertionError(f"the prefix serve missed a kernel: {counts}")
            if pc["hits"] <= 0:
                raise AssertionError(f"the prefix cache never hit: {pc}")
            line = _serve_line("serve_prefix", eng, reqs, done, counts,
                               prefix_hits=pc["hits"], cow_copies=pc["cow_copies"],
                               cached_tokens=pc["cached_tokens"],
                               pages_saved=pc["cached_tokens"] // 16,
                               hit_rate=pc["hit_rate"], ctx_tokens=m["ctx_tokens"])
            path_counts = counts
        else:
            line.update(uncached={k: m[k] for k in (
                "ttft_p50_ms", "itl_p50_ms", "itl_p99_ms", "tokens_per_s",
                "ctx_tokens", "steps", "wall_s")})
        del eng
        gc.collect()
    line["tokens_equal"] = runs[True] == runs[False]
    emit(line)
    if not line["tokens_equal"]:
        raise AssertionError("prefix-cached serve and plain serve disagree on tokens")
    return path_counts


def phase_serve_spec(params, plain_tokens):
    """Speculative decoding at full width and depth: the fp serve's weights
    and requests with a truncated-bitplane self-draft (gamma 2, the top 4
    planes); tokens EQUAL to the plain serve's for every request; then one
    draft round and one verify step traced by kernel."""
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.spec import SpecConfig

    cfg = get("qwen3-8b")
    eng = ServeEngine(cfg, params, batch_size=4, max_len=256, page_size=16,
                      paged_attn="fused", device="cuda",
                      spec=SpecConfig(provider="bitplane", gamma=GAMMA,
                                      draft_x_bits=DRAFT_X_BITS))
    torch.cuda.reset_peak_memory_stats()
    reqs, done, counts = _serve_requests(eng, cfg.vocab, 8)
    sm = eng.metrics()["spec"]
    same = _tokens(done, reqs) == plain_tokens
    line = _serve_line("serve_spec", eng, reqs, done, counts,
                       tokens_equal_plain=same,
                       differing=[u for u, t in _tokens(done, reqs).items()
                                  if t != plain_tokens[u]],
                       spec={k: sm[k] for k in (
                           "acceptance_rate", "rounds", "draft_steps",
                           "verify_steps", "drafted_tokens", "accepted_drafts",
                           "bonus_tokens", "disabled_requests", "disable_floor")})
    line["round"] = spec_window(eng, cfg.vocab)
    emit(line)
    if not same:
        raise AssertionError("spec serve and plain serve disagree on tokens")
    if (counts["bitplane_vmm_by_bits"].get(DRAFT_X_BITS, 0) <= 0
            or counts["paged_attention_by_t"].get(VERIFY_T, 0) <= 0):
        raise AssertionError(f"the spec serve missed the draft or verify kernels: {counts}")
    del eng
    gc.collect()
    return counts


def _series(snapshot) -> dict:
    """A registry snapshot's counter and gauge series, and each histogram's
    observation count (its sum and buckets are wall-clock)."""
    return {k: (v["count"] if isinstance(v, dict) else v)
            for k, v in snapshot.items()}


def _trace_latency(tracer, uids) -> dict:
    """TTFT and ITL p50 (ms) rebuilt from the trace's submit and token
    instants of requests ``uids``."""
    import numpy as np

    submit, toks = {}, {}
    for ev in tracer.events:
        if ev.ph != "i" or not ev.track.startswith("req:"):
            continue
        uid = int(ev.track.split(":")[1])
        if uid not in uids:
            continue
        if ev.name == "submit":
            submit[uid] = ev.ts
        elif ev.name == "token":
            toks.setdefault(uid, []).append(ev.ts)
    ttft = [toks[u][0] - submit[u] for u in sorted(toks)]
    itl = [b - a for u in toks for a, b in zip(toks[u], toks[u][1:])]
    return {"ttft_p50_ms": float(np.percentile(ttft, 50)) * 1e3,
            "itl_p50_ms": float(np.percentile(itl, 50)) * 1e3}


def _merge_counts(runs) -> dict:
    """Launch counts of several runs added up, the by-format / by-bits / by-T
    tables entry by entry."""
    total: dict = {}
    for counts in runs:
        for k, v in counts.items():
            if isinstance(v, dict):
                into = total.setdefault(k, {})
                for kk, vv in v.items():
                    into[kk] = into.get(kk, 0) + vv
            else:
                total[k] = total.get(k, 0) + v
    return total


def _check_exports(eng, directory, hw=True) -> dict:
    """Write the engine's Chrome trace, Prometheus text (and hw block) under
    ``directory`` and run ``repro_torch.obs.check`` over them; an invalid
    file or an unbalanced span raises."""
    from repro_torch.obs import check

    if eng.obs.tracer.span_balance():
        raise AssertionError(f"unbalanced spans: {eng.obs.tracer.span_balance()}")
    files = [eng.write_trace(os.path.join(directory, "trace.json")),
             eng.write_metrics(os.path.join(directory, "metrics.prom"))]
    if hw:
        files.append(eng.write_hw_metrics(os.path.join(directory, "hw.json")))
    rc = check.main(files)
    if rc != 0:
        raise AssertionError(f"repro_torch.obs.check rejected {files}: rc {rc}")
    return {os.path.basename(f): os.path.getsize(f) for f in files}


def _hw_reckoned(hw) -> dict:
    """The ``hw`` block's headline numbers, labeled as what they are."""
    return {"source": "the paper's ReRAM circuits as core/hwmodel.py reckons "
                      "them; not measured on any device",
            "pj_per_token": hw["pj_per_token"],
            "model_ns_per_token": hw["ns_per_token"],
            "bitslice_pj_per_token": hw["bitslice"]["pj_per_token"],
            "bitslice_model_ns_per_token": hw["bitslice"]["ns_per_token"],
            "ratios": hw["ratios"], "pj_per_out_token": hw["pj_per_out_token"],
            "tokens": hw["tokens"], "live": hw["live"]}


def _all_decoding(eng, vocab: int, uid0: int, new: int, seed: int) -> None:
    """Submit four 16-token requests and step until all four lanes (or, on
    the slot runtime, all four slots) decode."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(seed)
    for u in range(4):
        eng.submit(Request(uid=uid0 + u, prompt=rng.integers(0, vocab, 16).astype(
            np.int32), max_new_tokens=new))
    rt = eng._rt
    for _ in range(64):
        if (all(s is not None for s in rt.slots[:4]) if hasattr(rt, "slots")
                else all(l is not None and l.remaining == 1
                         for l in rt.lanes[:4])):
            return
        eng.step()
    raise AssertionError("the window's lanes never all reached decode")


def _host_step_ms(eng, vocab: int, steps: int = 8) -> float:
    """Host wall per width-4 decode step (synchronised at both ends)."""
    import torch

    _all_decoding(eng, vocab, 100, 2 * steps, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    eng.run()
    return ms


#: the serve's kernels, by a substring of their device names
SPAN_KERNELS = {"bitplane_vmm": "bitplane_vmm_kernel",
                "paged_attention": "paged_attn_"}


def _span_window(eng, vocab: int, steps: int = 4) -> dict:
    """One ``torch.profiler`` window over ``steps`` traced width-4 decode
    steps: each kernel launched, by whether it ran inside a
    ``paged_step[...]`` annotation.  A bit-plane or attention kernel outside
    one raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import kernels_in_spans

    _all_decoding(eng, vocab, 300, 2 * steps, seed=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    eng.run()
    annotations = sorted({e.name for e in prof.events()
                          if e.name.startswith("paged_step[")})
    by_name = kernels_in_spans(prof)
    ours = {key: [sum(v[i] for k, v in by_name.items() if pat in k)
                  for i in (0, 1)] for key, pat in SPAN_KERNELS.items()}
    other = [sum(v[i] for k, v in by_name.items()
                 if not any(p in k for p in SPAN_KERNELS.values()))
             for i in (0, 1)]
    line = {"steps": steps, "annotations": annotations,
            "inside_outside": ours, "other_kernels_inside_outside": other,
            "names": len(by_name)}
    if any(out for _, out in ours.values()) or min(
            inside for inside, _ in ours.values()) <= 0:
        raise AssertionError(f"a serve kernel ran outside its paged_step "
                             f"annotation (or none ran): {line}; names "
                             f"{sorted(by_name)[:40]}")
    return line


def phase_serve_obs(params=None, plain_tokens=None):
    """Observability on the qwen3-8b serve: ``serve``'s frozen weights (frozen
    here when run alone) and requests, four serves in turns with the trace
    off, on, on, off.  Tokens EQUAL across the four (and to ``serve``'s),
    registry series equal across the four; per run ITL / TTFT p50 and the
    host ms per width-4 decode step (the trace's host cost); with the trace
    on: spans balanced, TTFT / ITL rebuilt from the trace equal metrics()'s,
    the exported trace, Prometheus text and hw block pass
    ``repro_torch.obs.check``, and (first traced run) one profiler window in
    which every bit-plane and attention kernel runs inside a
    ``paged_step[...]`` annotation."""
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ServeEngine

    cfg = get("qwen3-8b")
    if params is None:
        params = ServeEngine(cfg, init_model(cfg, seed=0, device="cuda"),
                             batch_size=4, max_len=256, da_mode="pallas_bitplane",
                             device="cuda").params
        gc.collect()
        torch.cuda.empty_cache()
    runs, counts, window = [], [], None
    for trace in (False, True, True, False):
        eng = ServeEngine(cfg, params, batch_size=4, max_len=256, page_size=16,
                          paged_attn="fused", trace=trace, device="cuda")
        reqs, done, c = _serve_requests(eng, cfg.vocab, 8)
        counts.append(c)
        m = eng.metrics()
        run = {"trace": trace, "ttft_p50_ms": m["ttft_p50_ms"],
               "itl_p50_ms": m["itl_p50_ms"], "tokens_per_s": m["tokens_per_s"],
               "trace_events": len(eng.obs.tracer)}
        seen = {"tokens": _tokens(done, reqs), "hw": m["hw"],
                "series": _series(eng.metrics_snapshot())}
        if trace:
            rebuilt = _trace_latency(eng.obs.tracer, {r.uid for r in reqs})
            if not all(math.isclose(rebuilt[k], m[k], rel_tol=0.0, abs_tol=1e-9)
                       for k in rebuilt):
                raise AssertionError(f"the trace's TTFT/ITL {rebuilt} differ "
                                     f"from metrics()'s {m}")
            run["trace_latency_ms"] = rebuilt
        run["host_step_ms"] = _host_step_ms(eng, cfg.vocab)
        if trace and window is None:
            window = _span_window(eng, cfg.vocab)
        if trace:
            with tempfile.TemporaryDirectory() as tmp:
                run["exports"] = _check_exports(eng, tmp)
        runs.append((run, seen))
        del eng
        gc.collect()
    first = runs[0][1]
    equal = {k: all(seen[k] == first[k] for _, seen in runs)
             for k in ("tokens", "series", "hw")}
    if plain_tokens is not None:
        equal["tokens_serve"] = first["tokens"] == plain_tokens
    total = _merge_counts(counts)
    emit({"phase": "serve_obs", "model": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "runs": [run for run, _ in runs],
          "equal": equal, "span_window": window,
          "hw_reckoned": _hw_reckoned(first["hw"]), "launches": total})
    if not all(equal.values()):
        raise AssertionError(f"tracing changed the serve: {equal}")
    if min(total["bitplane_vmm"], total["paged_attention"]) <= 0:
        raise AssertionError(f"the traced serve missed a kernel: {total}")
    return total


def _device_ms(fn, calls: int = 1):
    """Device ms per call of ``fn`` by kernel (``torch.profiler`` over
    ``calls`` calls), the memsets per call among them, and the host wall of
    the traced calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = {"bitplane_vmm": 0.0, "da_vmm": 0.0, "paged_attention": 0.0,
           "memset": 0.0, "other": 0.0}
    memsets = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        key = ("bitplane_vmm" if "bitplane_vmm_kernel" in e.name else
               "da_vmm" if "lut_gather_kernel" in e.name else
               "paged_attention" if "paged_attn_" in e.name else
               "memset" if "Memset" in e.name else "other")
        dev[key] += e.time_range.elapsed_us() / 1e3 / calls
        memsets += key == "memset"
    busy = sum(dev.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    return {"wall_ms": wall * 1e3 / calls, "device_ms": dev,
            "device_busy_ms": busy, "memsets": memsets / calls}


def spec_window(eng, vocab: int):
    """One speculative round of four decoding lanes, by kernel: the fused
    draft call (gamma steps at the draft's planes) and the verify step
    (pow2(gamma + 1) rows at full precision), each traced once after one
    untraced call.  The draft rewrites x_t's KV row and verify rewrites it at
    full precision, as a round does, so the lanes then finish as usual."""
    from repro_torch.serve.scheduler import pow2_bucket

    rt = eng._rt
    _all_decoding(eng, vocab, 200, 48, seed=2)
    g = rt.spec.gamma
    rows = [(r, i, l) for r, (i, l) in enumerate(
        (i, l) for i, l in enumerate(rt.lanes) if l is not None)]
    toks = {i: [l.ctx[l.pos]] for _, i, l in rows}
    poss = {i: [l.pos] for _, i, l in rows}
    width, tv = len(rows), pow2_bucket(g + 1)

    def draft():
        return rt._run_draft(rows, toks, poss, width, 1)

    drafts = draft()
    vt = {i: [l.ctx[l.pos]] + [int(t) for t in drafts[r]] for r, i, l in rows}
    vp = {i: list(range(l.pos, l.pos + g + 1)) for _, i, l in rows}

    def verify():
        return rt._run_verify(rows, vt, vp, width, tv)

    verify()
    out = {"width": width, "gamma": g, "draft_x_bits": rt.spec.draft_x_bits,
           "verify_t": tv, "draft": _device_ms(draft), "verify": _device_ms(verify)}
    eng.run()
    return out


def phase_artifact_lut():
    """The LUT path: freeze the LUT-serving model with pallas_lut on the card,
    save the artifact, boot it with from_artifact and serve; the same
    artifact served with both VMM kernels swapped for their plain versions
    (the LUT gather) must give the same tokens."""
    import torch

    from repro_torch.core.freeze import load_artifact
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.spec import SpecConfig

    cfg = lut_model_cfg()
    kw = dict(batch_size=4, max_len=128, page_size=16, paged_attn="fused",
              device="cuda")
    t0 = time.perf_counter()
    frozen = ServeEngine(cfg, init_model(cfg, seed=0, device="cuda"),
                         da_mode="pallas_lut", **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lut_mb = sum(p.luts.numel() * 4 for blk in frozen.params["blocks"]
                 for sub in blk.values() for p in sub.values()
                 if getattr(p, "luts", None) is not None) / 1e6
    lut_mb += frozen.params["lm_head"]["w"].luts.numel() * 4 / 1e6
    with tempfile.TemporaryDirectory() as tmp:
        directory = frozen.save_artifact(os.path.join(tmp, "qwen3_20m_lut"))
        art_mb = sum(os.path.getsize(os.path.join(directory, f))
                     for f in os.listdir(directory)) / 1e6
        del frozen
        gc.collect()
        t2 = time.perf_counter()
        eng = ServeEngine.from_artifact(directory, **kw)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        art = load_artifact(directory, device="cuda")
    reqs, done, counts = _serve_requests(eng, cfg.vocab, 4, seed=5)
    forwards = counts["paged_attention"] // cfg.n_layers
    if counts["da_vmm"] <= 0 or counts["bitplane_vmm"] != 0:
        raise AssertionError(f"the LUT path did not run the LUT kernel alone: {counts}")
    line = _serve_line("artifact_lut", eng, reqs, done, counts,
                       boot_s=t3 - t2, freeze_s=t1 - t0, save_s=t2 - t1,
                       lut_mb=lut_mb, artifact_mb=art_mb, forward_calls=forwards,
                       da_vmm_per_forward=counts["da_vmm"] / max(forwards, 1),
                       hw_reckoned=_hw_reckoned(eng.metrics()["hw"]))
    # the plain side shares the fused attention so that its tokens can be
    # held EQUAL to the kernel boot's; the attention phase holds that f32,
    # head-dim-64 instance against the plain read at this path's shapes
    plain = ServeEngine(art.model_cfg, art.params, **kw)
    with plain_vmm():
        _, plain_done, plain_counts = _serve_requests(plain, cfg.vocab, 4, seed=5)
    same = all(plain_done[r.uid].generated == done[r.uid].generated for r in reqs)
    line.update(plain_tokens_identical=same, plain_launches=plain_counts,
                plain_tokens_per_s=plain.metrics()["tokens_per_s"])
    # the truncated-bitplane self-draft on the LUT artifact: the LUT kernel
    # at 4 bits; its tokens are the kernel boot's
    spec = ServeEngine(art.model_cfg, art.params, spec=SpecConfig(
        provider="bitplane", gamma=GAMMA, draft_x_bits=DRAFT_X_BITS), **kw)
    _, spec_done, spec_counts = _serve_requests(spec, cfg.vocab, 4, seed=5)
    spec_same = all(spec_done[r.uid].generated == done[r.uid].generated
                    for r in reqs)
    sm = spec.metrics()
    line["spec"] = {"tokens_identical": spec_same, "launches": spec_counts,
                    "tokens_per_s": sm["tokens_per_s"],
                    "itl_p50_ms": sm["itl_p50_ms"],
                    **{k: sm["spec"][k] for k in ("acceptance_rate", "rounds",
                                                  "draft_steps", "verify_steps")}}
    emit(line)
    if not same:
        raise AssertionError("LUT kernel boot and its plain side disagree on tokens")
    if plain_counts["da_vmm"] or plain_counts["bitplane_vmm"]:
        raise AssertionError(f"the plain side launched a VMM kernel: {plain_counts}")
    if not spec_same:
        raise AssertionError("the LUT spec serve and the LUT serve disagree on tokens")
    if spec_counts["da_vmm_by_bits"].get(DRAFT_X_BITS, 0) <= 0:
        raise AssertionError(f"the LUT spec serve never ran the 4-bit draft: {spec_counts}")
    return counts, spec_counts


def _ci_requests(n, shared_len, vocab):
    """The CI smoke's requests (``examples/serve_da.py``, seed 0): a shared
    prefix of ``shared_len`` tokens, 4–23 own tokens, 8–23 new tokens."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, shared_len)
    return [Request(uid=u, prompt=np.concatenate(
        [shared, rng.integers(0, vocab, rng.integers(4, 24))]).astype(np.int32),
        max_new_tokens=int(rng.integers(8, 24))) for u in range(n)]


def _ci_artifact(directory):
    """Freeze the CI smoke's model (``lut_model_cfg``) with
    ``bitplane_stacked`` on the card and save it; returns its path."""
    import torch

    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ServeEngine

    cfg = lut_model_cfg()
    eng = ServeEngine(cfg, init_model(cfg, seed=0, device="cuda"), batch_size=4,
                      max_len=96, da_mode="bitplane_stacked", device="cuda")
    path = eng.save_artifact(os.path.join(directory, "smoke_da"))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return path


def _ci_leg(directory, n, batch, shared_len=0, **kw):
    """Boot the artifact with ``from_artifact`` (timed) and serve one leg of
    the smoke (timed, launch counts from just before to just after)."""
    import torch

    from repro_torch.serve.engine import ServeEngine

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServeEngine.from_artifact(directory, batch_size=batch, max_len=96,
                                    device="cuda", **kw)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    reqs, done, counts = _run_requests(eng, _ci_requests(n, shared_len,
                                                         eng.cfg.vocab),
                                       eng.cfg.vocab)
    leg = {"requests": n, "batch": batch, "boot_s": boot_s,
           "serve_s": time.perf_counter() - t1,
           "out_tokens": eng.metrics()["out_tokens"], "launches": counts,
           "first_tokens": done[0].generated[:8]}
    return eng, _tokens(done, reqs), leg


def phase_ci_boot():
    """The CI smoke's first leg alone: freeze and save its artifact, boot it
    with ``from_artifact`` and serve 2 requests at batch 4, timed (with
    ``--src``, on another checkout's port)."""
    with tempfile.TemporaryDirectory() as tmp:
        _, _, leg = _ci_leg(_ci_artifact(tmp), 2, 4)
    emit({"phase": "ci_boot", **leg})


def phase_artifact_ci():
    """The CI serve smoke's five legs on the card (``.github/workflows/ci.yml``
    "Serve smoke"), from a ``bitplane_stacked`` artifact of its model: plain;
    spec (``--spec bitplane --spec-gamma 2``, draft bits 4); prefix cache (4
    requests at batch 2, a 32-token shared prefix) against the same requests
    served plainly; ``--paged-attn fused``; ``--kv-dtype int8``."""
    import torch

    from repro_torch.spec import SpecConfig

    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        directory = _ci_artifact(tmp)
        with open(os.path.join(directory, "manifest.json")) as f:
            hw_layers = len(json.load(f)["hwcost"]["layers"])
        _, plain2, legs["plain"] = _ci_leg(directory, 2, 4)
        _, spec2, legs["spec"] = _ci_leg(directory, 2, 4, spec=SpecConfig(
            provider="bitplane", gamma=GAMMA, draft_x_bits=DRAFT_X_BITS))
        _, plain4, legs["plain_b2"] = _ci_leg(directory, 4, 2, shared_len=32)
        eng, prefix4, legs["prefix_cache"] = _ci_leg(directory, 4, 2,
                                                     shared_len=32,
                                                     prefix_cache=True)
        legs["prefix_cache"]["prefix"] = eng.metrics()["prefix_cache"]
        _, _, legs["paged_attn_fused"] = _ci_leg(directory, 2, 2,
                                                 paged_attn="fused")
        eng, _, legs["kv_int8"] = _ci_leg(directory, 2, 2, kv_dtype="int8")
        if eng.cfg.kv_dtype != "int8":
            raise AssertionError("the int8 leg did not serve int8 pages")
        # "Observability smoke": 4 requests at batch 2, traced; the trace,
        # Prometheus text and hw block pass repro_torch.obs.check
        eng, _, legs["obs_smoke"] = _ci_leg(directory, 4, 2, trace=True)
        legs["obs_smoke"]["exports"] = _check_exports(eng, os.path.join(tmp, "obs"))
        legs["obs_smoke"]["hw_reckoned"] = _hw_reckoned(eng.metrics()["hw"])
        # the nightly "Traced serve": 8 requests at batch 4, spec bitplane
        # gamma 2, trace and Prometheus text
        eng, _, legs["traced_serve"] = _ci_leg(
            directory, 8, 4, trace=True, spec=SpecConfig(
                provider="bitplane", gamma=GAMMA, draft_x_bits=DRAFT_X_BITS))
        legs["traced_serve"]["exports"] = _check_exports(
            eng, os.path.join(tmp, "traced_serve"), hw=False)
    legs["spec"]["tokens_equal_plain"] = spec2 == plain2
    legs["prefix_cache"]["tokens_equal_plain"] = prefix4 == plain4
    total = _merge_counts(leg["launches"] for leg in legs.values())
    emit({"phase": "artifact_ci", "model": lut_model_cfg().name,
          "mode": "bitplane_stacked", "manifest_hwcost_layers": hw_layers,
          "legs": legs, "launches": total})
    if not (legs["spec"]["tokens_equal_plain"]
            and legs["prefix_cache"]["tokens_equal_plain"]):
        raise AssertionError("a spec or prefix leg of the CI smoke disagrees "
                             "with its plain leg")
    if (total["bitplane_vmm"] <= 0 or total["paged_attention"] <= 0
            or total["bitplane_vmm_by_bits"].get(DRAFT_X_BITS, 0) <= 0
            or total["paged_attention_by_format"]["int8"] <= 0
            or legs["prefix_cache"]["prefix"]["hits"] <= 0):
        raise AssertionError(f"the CI smoke's legs missed a kernel path: {total}")
    torch.cuda.empty_cache()
    return total


#: the reference planner's plan of the LUT-serving model at m_hint 4 with no
#: cost table: the PMAs for the 7 matrices of every block, stacked
#: bit-planes for the LM head, whose LUTs (65.5M cells) exceed the budget
AUTO_PLAN = {**{f"periods/pos_0/{m}": "lut" for m in (
    "mixer/wq", "mixer/wk", "mixer/wv", "mixer/wo", "ffn/w_up", "ffn/w_gate",
    "ffn/w_down")}, "lm_head/w": "bitplane_stacked"}
#: where the measured cost table is written: git-ignored, never artifacts/
AUTOTUNE_OUT = os.path.join(ROOT, "build", "repro_torch", "engine_autotune.json")


def _plan_rows(plan) -> dict:
    return {k: {"mode": p.mode, "group_size": p.group_size, "luts": p.with_luts,
                "source": p.source, "est_cost": p.est_cost}
            for k, p in sorted(plan.items())}


def _autotune_table(flush) -> dict:
    """Device µs of every eligible backend (the int8 baseline too; one name
    per kernel, as ``timeable_backends`` yields them on CUDA) at the
    engine's 9 bucket shapes, x_bits 8, group size 8, LUTs where they fit
    the freeze's budget: what ``benchmarks/engine_autotune.py`` times for
    the reference, each call EQUAL to the exact product."""
    import torch

    from repro_torch.core.da import DAConfig
    from repro_torch.core.engine import (BUCKET_SHAPES, DEFAULT_LUT_LIMIT,
                                         lut_cells, pack_quantized, shape_bucket,
                                         timeable_backends)

    gen = torch.Generator(device="cuda").manual_seed(9)
    cfg = DAConfig(group_size=8, x_bits=8, x_signed=True)
    table = {}
    for m, k, n in BUCKET_SHAPES.values():
        wq = torch.randint(-128, 128, (k, n), generator=gen, device="cuda",
                           dtype=torch.int8)
        xq = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                           dtype=torch.int32)
        packed = pack_quantized(wq, cfg=cfg, with_luts=lut_cells(
            k, n, cfg.group_size) <= DEFAULT_LUT_LIMIT)
        ref = (xq.double() @ wq.double()).long()
        costs = {}
        for spec in timeable_backends(cfg, packed.has_luts, include_baselines=True):
            if not torch.equal(spec.fn(xq, packed, cfg).long(), ref):
                raise AssertionError(f"backend {spec.name} != exact product at "
                                     f"M={m} K={k} N={n}")
            costs[spec.name] = time_cuda(lambda: spec.fn(xq, packed, cfg), 10,
                                         flush) * 1e3
        table[shape_bucket(m, k, n, cfg.x_bits)] = costs
        del wq, xq, packed, ref
    torch.cuda.empty_cache()
    return table


def phase_artifact_auto(serve_shapes=None):
    """The repo's default freeze on the card: ``ServeEngine(da_mode="auto")``
    on the LUT-serving model with no cost table (the analytic plan, held
    to AUTO_PLAN), saved, booted with ``from_artifact`` and served (4
    requests at batch 4): the LUT and bit-plane kernels both launch.  The
    same artifact served again with both VMM kernels swapped for their
    plain versions launches none and gives EQUAL tokens.  Then a measured
    table, stamped for this card, is written under build/, installed,
    and the LUT-serving model and qwen3-8b (``serve_shapes``: phase 6's float
    params as shapes) are planned on it."""
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.core import engine
    from repro_torch.core.freeze import packed_leaves, plan_model
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ServeEngine

    cfg = lut_model_cfg()
    kw = dict(batch_size=4, max_len=128, page_size=16, paged_attn="fused",
              device="cuda")
    engine.set_cost_table({})  # no port cost table: the analytic plan
    try:
        t0 = time.perf_counter()
        frozen = ServeEngine(cfg, init_model(cfg, seed=0, device="cuda"),
                             da_mode="auto", **kw)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        engine.set_cost_table(None)
    plan = frozen.artifact.plan
    got = {k: p.mode for k, p in plan.items()}
    lut_mb = sum(p.luts.numel() * p.luts.element_size()
                 for _, p in packed_leaves(frozen.params) if p.has_luts) / 1e6
    with tempfile.TemporaryDirectory() as tmp:
        directory = frozen.save_artifact(os.path.join(tmp, "qwen3_20m_auto"))
        art_mb = sum(os.path.getsize(os.path.join(directory, f))
                     for f in os.listdir(directory)) / 1e6
        del frozen
        gc.collect()
        t2 = time.perf_counter()
        eng = ServeEngine.from_artifact(directory, **kw)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        plain = ServeEngine.from_artifact(directory, **kw)
    reqs, done, counts = _serve_requests(eng, cfg.vocab, 4, seed=5)
    forwards = counts["paged_attention"] // cfg.n_layers
    # metrics() closes the serve's wall clock: read it before the plain side
    line = _serve_line("artifact_auto", eng, reqs, done, counts,
                       boot_s=t3 - t2, freeze_s=t1 - t0, save_s=t2 - t1,
                       plan=_plan_rows(plan), lut_mb=lut_mb, artifact_mb=art_mb,
                       forward_calls=forwards,
                       da_vmm_per_forward=counts["da_vmm"] / max(forwards, 1),
                       bitplane_vmm_per_forward=counts["bitplane_vmm"] / max(forwards, 1))
    with plain_vmm():
        _, plain_done, plain_counts = _serve_requests(plain, cfg.vocab, 4, seed=5)
    same = _tokens(plain_done, reqs) == _tokens(done, reqs)
    line.update(plain_tokens_identical=same, plain_launches=plain_counts,
                plain_tokens_per_s=plain.metrics()["tokens_per_s"])
    del eng, plain
    gc.collect()
    # a measured plan: every eligible backend timed on this card
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    table = _autotune_table(flush)
    del flush
    os.makedirs(os.path.dirname(AUTOTUNE_OUT), exist_ok=True)
    with open(AUTOTUNE_OUT, "w") as f:
        json.dump({"version": 1, "device": engine.device_stamp(),
                   "registry": engine.registry_fingerprint(), "group_size": 8,
                   "unit": "us (CUDA events, L2 flushed)", "table": table},
                  f, indent=1, sort_keys=True)
    loaded = engine.load_cost_table(AUTOTUNE_OUT)  # the stamp is checked
    if loaded != table:
        raise AssertionError("the measured table did not load back under its stamp")
    if serve_shapes is None:
        serve_shapes = _shapes_of(init_model(get("qwen3-8b"), seed=0, device="cuda"))
        gc.collect()
        torch.cuda.empty_cache()
    engine.set_cost_table(loaded)
    try:
        measured = {"lut_model": plan_model(_shapes_of(init_model(
                        cfg, seed=0, device="cuda")), m_hint=4),
                    "qwen3-8b": plan_model(serve_shapes, m_hint=4)}
    finally:
        engine.set_cost_table(None)
    line["measured"] = {"table": os.path.relpath(AUTOTUNE_OUT, ROOT),
                        "device": engine.device_stamp(), "buckets_us": table,
                        **{name: _plan_rows(p) for name, p in measured.items()}}
    emit(line)
    if got != AUTO_PLAN or {p.source for p in plan.values()} != {"analytic"}:
        raise AssertionError(f"the analytic plan is not the reference's: {got}")
    if min(counts["da_vmm"], counts["bitplane_vmm"], counts["paged_attention"]) <= 0:
        raise AssertionError(f"the planned serve missed a kernel: {counts}")
    if plain_counts["da_vmm"] or plain_counts["bitplane_vmm"]:
        raise AssertionError(f"the plain side launched a VMM kernel: {plain_counts}")
    if not same:
        raise AssertionError("the planned serve and its plain side disagree on tokens")
    for name, p in measured.items():
        if {q.source for q in p.values()} != {"measured"}:
            raise AssertionError(f"the {name} plan is not measured: {_plan_rows(p)}")
        if not all(engine.get_backend(q.mode).is_da for q in p.values()):
            raise AssertionError(f"the {name} plan picked a baseline: {_plan_rows(p)}")
    torch.cuda.empty_cache()
    return counts


#: minitron-8b served on both runtimes (phase ``serve_dense``): batch, max_len,
#: page size, requests and new tokens of phase 6's serve
DENSE_SERVE = dict(batch_size=4, max_len=256, page_size=16)


def _slot_line(phase, eng, reqs, done, counts, **extra):
    """The slot runtime's serve line: its metrics() has the reference's keys
    (no wall clock), so tokens/s is the emitted tokens over first submit to
    last finish."""
    import torch

    m = eng.metrics()
    wall = (max(r.finish_t for r in done.values())
            - min(r.submit_t for r in done.values()))
    cfg = eng.cfg
    return {"phase": phase, "model": cfg.name, "layers": cfg.n_layers,
            "d_model": cfg.d_model, "runtime": m["runtime"],
            "requests": len(done), "prompt_tokens": [len(r.prompt) for r in reqs],
            "out_tokens": m["out_tokens"], "tokens_per_s": m["out_tokens"] / wall,
            "ttft_p50_ms": m["ttft_p50_ms"], "itl_p50_ms": m["itl_p50_ms"],
            "itl_p99_ms": m["itl_p99_ms"], "wall_s": wall,
            "prefill_compiles": m["prefill_compiles"],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts, "first_tokens": done[0].generated[:8], **extra}


def phase_serve_dense():
    """minitron-8b (squared-ReLU MLP, LayerNorm, vocab 256000) at full width
    and depth, seed-0 weights frozen by the repo's default ``da_mode="auto"``
    (every matrix planned ``bitplane_stacked``: no LUTs fit), served through
    the paged runtime (bit-plane and attention kernels) and the slot runtime
    (bit-plane kernel, plain dense-cache attention), each against the same
    runtime with both VMM kernels and the attention kernel swapped for their
    plain versions: tokens EQUAL, 0 kernel launches on the plain side.  Each
    runtime's serve and a window of 4 width-4 decode steps are printed.
    Then the paged runtime again with the bfloat16 score pipeline
    (``softmax_dtype="bfloat16"``), which only the attention kernel's
    bfloat16 branch runs: tokens EQUAL to its plain side's, no window."""
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.core.freeze import packed_leaves
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ServeEngine

    cfg = get("minitron-8b")
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = ServeEngine(cfg, params, runtime="paged", da_mode="auto",
                      device="cuda", **DENSE_SERVE)
    frozen, plan = eng.params, eng.artifact.plan
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    modes = sorted({p.mode for p in plan.values()})
    if modes != ["bitplane_stacked"] or any(p.with_luts for p in plan.values()):
        raise AssertionError(f"minitron-8b's auto plan is not bitplane_stacked "
                             f"throughout: {modes}")
    code_bytes = sum(w.wq.numel() for _, w in packed_leaves(frozen))
    emit({"phase": "serve_dense_freeze", "model": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
          "mlp_act": cfg.mlp_act, "norm_type": cfg.norm_type,
          "plan_modes": modes, "plan_sources": sorted({p.source for p in plan.values()}),
          "matrices": len(plan), "code_gb": code_bytes / 1e9,
          "embed_gb": frozen["embed"]["table"].numel() * 2 / 1e9,
          "init_s": t1 - t0, "freeze_s": t2 - t1})
    runs, out = {}, {}
    legs = (("paged", "paged", cfg), ("slots", "slots", cfg),
            ("paged_bf16_softmax", "paged",
             dataclasses.replace(cfg, softmax_dtype="bfloat16")))
    for leg, runtime, leg_cfg in legs:
        tokens = {}
        for side in ("kernels", "plain"):
            kw = dict(DENSE_SERVE)
            if runtime == "paged":
                kw["paged_attn"] = "fused" if side == "kernels" else "gather"
            else:
                kw.pop("page_size")
            eng = ServeEngine(leg_cfg, frozen, runtime=runtime, device="cuda", **kw)
            torch.cuda.reset_peak_memory_stats()
            with (plain_vmm() if side == "plain" else contextlib.nullcontext()):
                reqs, done, counts = _serve_requests(eng, cfg.vocab, 8)
            tokens[side] = _tokens(done, reqs)
            line = (_serve_line if runtime == "paged" else _slot_line)(
                f"serve_dense_{leg}", eng, reqs, done, counts, side=side)
            line["runtime"] = runtime
            line["softmax_dtype"] = leg_cfg.softmax_dtype
            if side == "kernels":
                want = ("bitplane_vmm", "paged_attention") if runtime == "paged" \
                    else ("bitplane_vmm",)
                # every read of the leg runs its own softmax pipeline
                by_softmax = counts["paged_attention_by_softmax"]
                if min(counts[k] for k in want) <= 0 or (
                        runtime == "slots" and counts["paged_attention"]) or (
                        by_softmax.get(leg_cfg.softmax_dtype, 0)
                        != counts["paged_attention"]):
                    raise AssertionError(f"{leg}: kernels of the path not "
                                         f"launched as expected: {counts}")
                runs[leg] = counts
                line["forwards"] = counts["paged_attention"] / cfg.n_layers \
                    if runtime == "paged" else None
                emit(line)
                if leg in ("paged", "slots"):
                    window = decode_window(eng, cfg.vocab)
                    window["phase"] = f"decode_step_dense_{runtime}"
                    emit(window)
            else:
                if any(counts[k] for k in KERNEL_COUNTS):
                    raise AssertionError(f"{leg}: the plain side launched "
                                         f"a kernel: {counts}")
                emit(line)
            del eng
            gc.collect()
        equal = tokens["kernels"] == tokens["plain"]
        out[leg] = {"tokens_equal": equal}
        if not equal:
            raise AssertionError(f"minitron-8b {leg}: tokens through the "
                                 "kernels differ from the plain serve's")
    emit({"phase": "serve_dense", "model": cfg.name, **out})
    del frozen
    gc.collect()
    torch.cuda.empty_cache()
    return _merge_counts(list(runs.values()))


def _nonzero_biases(params, gen) -> None:
    """Fill every norm bias and q/k/v bias of ``params`` (in place) from
    ``gen``, so a dropped bias changes the logits."""
    for bp in params["blocks"]:
        for node in (bp["norm_mixer"], bp["norm_ffn"], bp["mixer"]):
            for key in ("bias", "bq", "bk", "bv"):
                if key in node:
                    node[key].copy_(0.1 * _randn_like(node[key], gen))
    if "bias" in params["final_norm"]:
        params["final_norm"]["bias"].copy_(
            0.1 * _randn_like(params["final_norm"]["bias"], gen))


def _randn_like(x, gen):
    import torch

    return torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype)


def phase_dense_variants():
    """musicgen-large (GELU, LayerNorm, MHA, embedding inputs) at full width
    and depth, and qwen2-vl-72b (q/k/v biases, M-RoPE (16, 24, 24)) at full
    width and 2 of its 80 layers, seed-0 weights with non-zero biases,
    frozen with ``pallas_bitplane``: a prefill of 16 embedding rows into
    ``init_caches`` and 4 decode steps through the bit-plane kernel, against
    the same forward with both VMM kernels swapped for their plain versions
    (0 launches there): logits EQUAL (exact VMMs, the same torch ops)."""
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.core.freeze import freeze_model_da
    from repro_torch.models.model import forward, init_caches, init_model
    from repro_torch.spec.decode import mk_positions

    b, t0, steps = 2, 16, 4
    counts_all = []
    for name, layers in (("musicgen-large", None), ("qwen2-vl-72b", 2)):
        cfg = get(name)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        t_init = time.perf_counter()
        params = init_model(cfg, seed=0, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        _nonzero_biases(params, gen)
        frozen = freeze_model_da(params, mode="pallas_bitplane", device="cuda")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t_frozen = time.perf_counter()
        emb = torch.randn(b, t0 + steps, cfg.d_model, generator=gen,
                          device="cuda").to(cfg.dtype())
        # under M-RoPE the h and w coordinates of the prefill rows differ
        # from t (a 4-wide patch grid); t is the cache row
        pos = torch.arange(t0, dtype=torch.int32, device="cuda")[None].expand(b, t0)
        pos = mk_positions(cfg, pos)
        if cfg.mrope_sections:
            pos = torch.stack([pos[..., 0], pos[..., 1] // 4, pos[..., 2] % 4],
                              dim=-1).contiguous()
        out = {}
        for side in ("kernels", "plain"):
            caches = init_caches(cfg, b, 64, device="cuda")
            torch.cuda.synchronize()
            _reset_counts()
            logits = []
            with torch.inference_mode(), (plain_vmm() if side == "plain"
                                          else contextlib.nullcontext()):
                lg, _ = forward(frozen, emb[:, :t0], cfg, pos, caches,
                                update_cache=True, last_logit_only=True)
                logits.append(lg[:, 0].float())
                for s in range(t0, t0 + steps):
                    p1 = mk_positions(cfg, torch.full(
                        (b, 1), s, dtype=torch.int32, device="cuda"))
                    lg, _ = forward(frozen, emb[:, s:s + 1], cfg, p1, caches)
                    logits.append(lg[:, 0].float())
            torch.cuda.synchronize()
            counts = _read_counts()
            if side == "kernels":
                if counts["bitplane_vmm"] <= 0:
                    raise AssertionError(f"{name}: the bit-plane kernel never ran")
                counts_all.append(counts)
            elif any(counts[k] for k in KERNEL_COUNTS):
                raise AssertionError(f"{name}: the plain side launched a kernel")
            out[side] = torch.stack(logits)
        if not torch.isfinite(out["kernels"]).all():
            raise AssertionError(f"{name}: non-finite logits through the kernels")
        diff = (out["kernels"] - out["plain"]).abs()
        equal = torch.equal(out["kernels"], out["plain"])
        argmax_eq = bool((out["kernels"].argmax(-1) == out["plain"].argmax(-1)).all())
        emit({"phase": "dense_variants", "model": name, "layers": cfg.n_layers,
              "d_model": cfg.d_model, "mlp_act": cfg.mlp_act,
              "norm_type": cfg.norm_type, "modality": cfg.modality,
              "attn_bias": cfg.attn_bias, "mrope_sections": cfg.mrope_sections,
              "batch": b, "prefill_rows": t0, "decode_steps": steps,
              "shape": list(out["kernels"].shape),
              "max_abs_err": diff.max().item(), "atol": 0.0, "equal": equal,
              "logit_absmax": out["plain"].abs().max().item(),
              "argmax_equal": argmax_eq, "launches": counts_all[-1],
              "reduced": None if layers is None else
              f"{layers} of {get(name).n_layers} layers",
              "freeze_s": t_frozen - t_init})
        if not equal:
            raise AssertionError(f"{name}: kernels vs plain logits differ by "
                                 f"{diff.max().item()}")
        del frozen, out
        gc.collect()
        torch.cuda.empty_cache()
    return _merge_counts(counts_all)


#: the families' VMM shapes the vmm check holds the bit-plane kernel to, at
#: M = 4 and 64: mamba2-780m's in_proj, out_proj and LM head, qwen2-moe's
#: fused q|k|v, wo, expert up / gate and down, shared-expert up / gate and
#: down and LM head (an expert's matrix alone; the stacks in ``stacked_vmm``)
FAMILY_VMM_SHAPES = ((1536, 6448), (3072, 1536), (1536, 50280), (2048, 6144),
                     (2048, 2048), (2048, 1408), (1408, 2048), (2048, 5632),
                     (5632, 2048), (2048, 151936))
#: qwen2-moe's attention heads (MHA: 16 query heads over 16 KV heads of 128)
MOE_HEADS = dict(h=16, kv=16, hd=128)
#: the stacked-expert checks: qwen2-moe's [64, 2048, 1408] expert stack at
#: C = 4 and 16 rows per expert through the bit-plane kernel, and a
#: LUT-carrying [6, 256, 512] stack through the LUT-readout kernel
STACKED_BITPLANE = (64, 2048, 1408, (4, 16))
STACKED_LUT = (6, 256, 512, (4, 16))


def phase_family_shapes():
    """The two kernels the families' paths run, held EQUAL to their plain
    versions at those paths' shapes before any serve: the bit-plane kernel
    at every FAMILY_VMM_SHAPES shape at M = 4 and 64 (8-bit codes), and the
    attention kernel at qwen2-moe's head shape (bf16, hd 128, 16 KV heads:
    one query head per KV head) at decode (B=4, T=1, W=17) and a prefill
    chunk (T=16), over fp, int8 and int4 pages, both mask modes."""
    import torch

    from repro_torch.core.da import DAConfig
    from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
    from repro_torch.kernels.ref import bitplane_vmm_ref

    gen = torch.Generator(device="cuda").manual_seed(6)
    cfg = DAConfig(x_bits=8, x_signed=True)
    checked = []
    for k, n in FAMILY_VMM_SHAPES:
        wq = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                           dtype=torch.int8)
        for m in (4, 64):
            xq = torch.randint(-128, 128, (m, k), generator=gen, device="cuda",
                               dtype=torch.int32)
            if not torch.equal(bitplane_vmm_cuda(xq, wq, cfg),
                               bitplane_vmm_ref(xq, wq, cfg)):
                raise AssertionError(f"bitplane kernel != plain at M={m} K={k} N={n}")
            checked.append(f"M={m} K={k} N={n}")
        del wq
    rows = []
    for b, t, w in ((4, 1, 17), (4, 16, 17)):
        for mode in ("where", "additive"):
            rows += _attention_case(gen, b, t, w, mode, "bfloat16", MOE_HEADS, None)
    torch.cuda.empty_cache()
    emit({"phase": "family_shapes", "bitplane_equal": checked,
          "attention_heads": MOE_HEADS,
          "attention_cases": [{k: r[k] for k in ("b", "t", "w", "kv", "mask_mode",
                                                 "equal", "max_abs_err")}
                              for r in rows]})


def phase_stacked_vmm(flush):
    """Stacked-expert packs through both VMM kernels: qwen2-moe's expert
    stack [64, 2048, 1408] (int8 codes) at C = 4 and 16 rows per expert
    through the bit-plane kernel, and a LUT-carrying [6, 256, 512] stack
    through the LUT-readout kernel.  Each kernel in two forms: one call of
    its experts' entry per stack (the expert on the kernel's grid, as the
    reference's vmapped ``pallas_call``; what the engine runs) and E calls
    of its 2-D entry (the per-expert form).  Both EQUAL to the plain
    versions' loop over the experts; the experts' entry is one call per
    stack and queues the CUDA launches its plan says (a zeroing memset only
    where it splits K or the groups); through the engine (``dense`` on a
    bf16 [E, C, K] input) one call of the experts' entry and none of the
    2-D entry, EQUAL to the same call under ``plain_vmm()``, which launches
    none.  Both forms timed in this call on the same timers, with the plain
    loop, the bound, and ``torch._int_mm`` over the E experts."""
    import torch

    from repro_torch.core.da import DAConfig, build_luts
    from repro_torch.core.engine import (
        PackedWeights,
        dense,
        int_mm_acts,
        int_mm_weights,
    )
    from repro_torch.kernels.ref import bitplane_vmm_experts_ref, da_vmm_experts_ref

    gen = torch.Generator(device="cuda").manual_seed(7)
    cfg = DAConfig(x_bits=8, x_signed=True)
    sms = _vmm_module("build").sms(0)
    rows = []
    for name, (e, k, n, cs) in (("bitplane_vmm", STACKED_BITPLANE),
                                ("da_vmm", STACKED_LUT)):
        lut = name == "da_vmm"
        mod = _vmm_module(name)
        kernel, batched = getattr(mod, f"{name}_cuda"), getattr(mod, f"{name}_experts_cuda")
        plain = da_vmm_experts_ref if lut else bitplane_vmm_experts_ref
        wq = torch.randint(-127, 128, (e, k, n), generator=gen, device="cuda",
                           dtype=torch.int8)
        luts = (torch.stack([build_luts(wq[i], cfg.group_size) for i in range(e)])
                if lut else None)
        table = luts if lut else wq
        pack = PackedWeights(wq=wq, w_scale=torch.rand(
            (e, 1, n), generator=gen, device="cuda") / 100, luts=luts, cfg=cfg,
            mode="pallas_lut" if lut else "pallas_bitplane")
        for c in cs:
            xq = torch.randint(-128, 128, (e, c, k), generator=gen, device="cuda",
                               dtype=torch.int32)

            def one_call():
                return batched(xq, table, cfg)

            def e_launch():
                return [kernel(xq[i], table[i], cfg) for i in range(e)]

            if lut:
                plan = mod.lut_plan(c, n, luts.shape[1], sms, e)
                splits = -(-luts.shape[1] // plan.gpb)
                fields = {"tokens_per_block": plan.bm, "groups_per_block": plan.gpb,
                          "group_ranges": splits}
            else:
                plan = mod.bitplane_plan(c, k, n, sms, e)
                splits = plan.splits
                fields = {"tokens_per_block": plan.tokens, "k_splits": splits}
            before = batched.launches, batched.cuda_launches, kernel.launches
            got = one_call()
            calls = (batched.launches - before[0], batched.cuda_launches - before[1])
            per = torch.stack(e_launch())
            e_calls = kernel.launches - before[2]
            want = plain(xq, table, cfg)
            x = torch.randn((e, c, k), generator=gen, device="cuda").to(torch.bfloat16)
            before = batched.launches, kernel.launches
            y = dense(x, pack)
            dense_calls = (batched.launches - before[0], kernel.launches - before[1])
            before = batched.launches, kernel.launches
            with plain_vmm():
                y_plain = dense(x, pack)
            torch.cuda.synchronize()
            planned = 1 + (splits > 1)
            if not (torch.equal(got, want) and torch.equal(per, want)
                    and torch.equal(y, y_plain) and calls == (1, planned)
                    and e_calls == e and dense_calls == (1, 0)
                    and (batched.launches, kernel.launches) == before):
                raise AssertionError(
                    f"stacked {name} [{e}, {k}, {n}] at C={c}: one call "
                    f"{calls} (planned 1, {planned}), E calls {e_calls}, dense "
                    f"{dense_calls}, or a result != the plain loop")
            row = {"kernel": name, "experts": e, "k": k, "n": n, "c": c,
                   "x_bits": 8, "launches_per_stacked_vmm": 1,
                   "cuda_launches_per_stacked_vmm": planned,
                   "zeroing_memsets": planned - 1, "blocks_per_launch": plan.blocks,
                   **fields, "equal": True, "max_abs_err": 0,
                   **call_times(one_call, flush, LUT_KERNELS if lut else BITPLANE_KERNELS)}
            row["e_launch"] = {"launches_per_stacked_vmm": e_calls,
                               **call_times(e_launch, flush,
                                            LUT_KERNELS if lut else BITPLANE_KERNELS)}
            row["plain_ms"] = time_cuda(lambda: plain(xq, table, cfg), 3, flush, 1)
            w8 = [int_mm_weights(wq[i]) for i in range(e)]
            x8 = [int_mm_acts(xq[i], w8[i].shape[0]) for i in range(e)]
            row["library_ms"] = time_cuda(
                lambda: [torch._int_mm(a, b) for a, b in zip(x8, w8)], 20, flush)
            if lut:  # the rows each expert's addresses read of its own tables
                both = {"bytes": 0.0, "operations": 0.0}
                for i in range(e):
                    for key, v in _lut_terms(xq[i], luts[i], cfg)[0].items():
                        both[key] += v
            else:
                nbytes = e * (k * n + 4 * c * k + 4 * c * n)
                ops = 2 * e * c * k * n * cfg.x_bits
                both = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                        "operations": ops / INT8_OPS_PER_S * 1e3}
            by = max(both, key=both.get)
            row.update(bound_ms=both[by], bound_by=by)
            rows.append(row)
            del xq, got, per, want, w8, x8
        del wq, luts, table, pack
        torch.cuda.empty_cache()
    emit({"phase": "stacked_vmm", "plain": "the plain versions, expert by expert",
          "forms": "ms etc.: one call of the experts' entry per stack; "
                   "e_launch: E calls of the 2-D entry",
          "library": "torch._int_mm per expert (" + LIBRARY + "), E calls",
          "shapes": rows})
    return rows


def _auto_plan_check(name, plan):
    """The analytic plan at these widths: ``bitplane_stacked`` throughout,
    no LUTs (no matrix's tables fit the cell budget)."""
    modes = sorted({p.mode for p in plan.values()})
    if modes != ["bitplane_stacked"] or any(p.with_luts for p in plan.values()):
        raise AssertionError(f"{name}'s auto plan is not bitplane_stacked "
                             f"throughout: {modes}")
    return modes


def _calls_per_forward(params, cfg) -> dict:
    """Bit-plane kernel calls of one forward (a 4-token prompt, no cache):
    in all, and those of the experts' entry (one per stacked pack)."""
    import torch

    from repro_torch.models.model import forward

    tokens = torch.zeros((1, 4), dtype=torch.int32, device="cuda")
    _reset_counts()
    with torch.inference_mode():
        forward(params, tokens, cfg, last_logit_only=True)
    torch.cuda.synchronize()
    counts = _read_counts()
    return {"calls_per_forward": counts["bitplane_vmm"] + counts["bitplane_vmm_experts"],
            "expert_calls_per_forward": counts["bitplane_vmm_experts"]}


def _family_serve(phase, cfg, runtime, reckoned):
    """Seed-0 weights of ``cfg`` made on the card, frozen by
    ``da_mode="auto"`` (analytic plan: ``bitplane_stacked`` throughout), the
    phase-6 requests served on ``runtime`` through the kernels and again
    with every kernel swapped for its plain version: tokens EQUAL, 0
    launches on the plain side; then a window of 4 width-4 decode steps."""
    import torch

    from repro_torch.core.freeze import packed_leaves
    from repro_torch.models.model import init_model
    from repro_torch.serve.engine import ServeEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_model(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    float_gb = sum(x.numel() * x.element_size() for x in _tensors(params)) / 1e9
    kw = dict(DENSE_SERVE)
    if runtime == "slots":
        kw.pop("page_size")
    eng = ServeEngine(cfg, params, runtime="auto", da_mode="auto", device="cuda", **kw)
    if eng.runtime != runtime:
        raise AssertionError(f"{cfg.name}: runtime='auto' picked {eng.runtime}")
    frozen, plan = eng.params, eng.artifact.plan
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    modes = _auto_plan_check(cfg.name, plan)
    code_bytes = sum(w.wq.numel() for _, w in packed_leaves(frozen))
    calls = _calls_per_forward(frozen, cfg)
    if calls != reckoned:
        raise AssertionError(f"{cfg.name}: bit-plane calls per forward {calls}, "
                             f"reckoned {reckoned}")
    emit({"phase": f"{phase}_freeze", "model": cfg.name, "family": cfg.family,
          "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
          "plan_modes": modes, "matrices": len(plan),
          "float_gb": float_gb, "code_gb": code_bytes / 1e9,
          "peak_mem_gb_freeze": torch.cuda.max_memory_allocated() / 1e9,
          **calls, "reckoned": reckoned,
          "init_s": t1 - t0, "freeze_s": t2 - t1})
    tokens, runs = {}, {}
    for side in ("kernels", "plain"):
        kw = dict(DENSE_SERVE)
        if runtime == "paged":
            kw["paged_attn"] = "fused" if side == "kernels" else "gather"
        else:
            kw.pop("page_size")
        eng = ServeEngine(cfg, frozen, runtime=runtime, device="cuda", **kw)
        torch.cuda.reset_peak_memory_stats()
        with (plain_vmm() if side == "plain" else contextlib.nullcontext()):
            reqs, done, counts = _serve_requests(eng, cfg.vocab, 8)
        tokens[side] = _tokens(done, reqs)
        line = (_serve_line if runtime == "paged" else _slot_line)(
            phase, eng, reqs, done, counts, side=side)
        line.update(runtime=runtime, **calls)
        if side == "kernels":
            want = ("bitplane_vmm", "paged_attention") if runtime == "paged" \
                else ("bitplane_vmm",)
            if reckoned["expert_calls_per_forward"]:
                want += ("bitplane_vmm_experts",)
            if min(counts[k] for k in want) <= 0 or (
                    runtime == "slots" and counts["paged_attention"]):
                raise AssertionError(f"{phase}: kernels of the path not "
                                     f"launched as expected: {counts}")
            runs[side] = counts
            emit(line)
            window = decode_window(eng, cfg.vocab)
            window["phase"] = f"decode_step_{phase}"
            emit(window)
        else:
            if any(counts[k] for k in KERNEL_COUNTS):
                raise AssertionError(f"{phase}: the plain side launched a kernel: "
                                     f"{counts}")
            emit(line)
        del eng
        gc.collect()
    equal = tokens["kernels"] == tokens["plain"]
    emit({"phase": phase, "model": cfg.name, "tokens_equal": equal})
    if not equal:
        raise AssertionError(f"{cfg.name}: tokens through the kernels differ "
                             "from the plain serve's")
    del frozen
    gc.collect()
    torch.cuda.empty_cache()
    return runs["kernels"]


def _tensors(tree):
    import torch

    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def phase_serve_ssm():
    """mamba2-780m (48 layers, d 1536, 48 SSD heads, state 128, vocab
    50280) at full size on the slot runtime (``runtime="auto"`` picks it for
    an ssm stack); reckoned 97 bit-plane calls per forward (in_proj and
    out_proj of 48 layers, the LM head), no stacked pack."""
    from repro_torch.configs.registry import get

    cfg = get("mamba2-780m")
    return _family_serve("serve_ssm", cfg, "slots",
                         {"calls_per_forward": 2 * cfg.n_layers + 1,
                          "expert_calls_per_forward": 0})


def phase_serve_moe():
    """qwen2-moe-a2.7b (24 layers, d 2048, MHA 16 heads, q/k/v biases, 60
    experts padded to 64, top-4, 4 shared, vocab 151936) at full size,
    dropless as the reference's server runs it, on the paged runtime
    (page 16, the attention kernel); reckoned 193 bit-plane calls per
    forward: 24 x (q|k|v, wo, 3 stacked expert packs of 64 experts, one
    call each, 3 shared) and the LM head."""
    from repro_torch.configs.registry import get

    cfg = dataclasses.replace(get("qwen2-moe-a2.7b"), moe_dropless=True)
    return _family_serve("serve_moe", cfg, "paged", {
        "calls_per_forward": cfg.n_layers * (2 + 3 + 3) + 1,
        "expert_calls_per_forward": cfg.n_layers * 3})


def _frozen_by_block(cfg, seed: int = 0):
    """``init_model(cfg, seed)``'s weights drawn in its order on the card,
    each block frozen by ``da_mode="auto"`` as soon as it is drawn (a
    stacked-expert leaf quantized expert by expert), so the float weights of
    one block at a time are on the card.  Returns (frozen params, plans)."""
    import torch

    from repro_torch.core.freeze import freeze_model
    from repro_torch.models.layers import init_embed, init_lm_head, init_norm
    from repro_torch.models.model import init_block

    gen = torch.Generator(device="cuda").manual_seed(seed)
    blocks, plans = [], {}
    for i in range(cfg.n_layers):
        art = freeze_model(init_block(gen, cfg, i % cfg.period), mode="auto",
                           device="cuda")
        blocks.append(art.params)
        plans.update({f"{i}/{k}": p for k, p in art.plan.items()})
        del art
        gc.collect()
        torch.cuda.empty_cache()
    params = {"blocks": blocks, "final_norm": init_norm(cfg, cfg.d_model, gen.device)}
    head = freeze_model({"lm_head": init_lm_head(gen, cfg)}, mode="auto",
                        device="cuda")
    params["lm_head"] = head.params["lm_head"]
    plans.update(head.plan)
    if cfg.modality == "text":
        params["embed"] = init_embed(gen, cfg)
    return params, plans


def phase_family_variants():
    """jamba-1.5-large-398b at one period (8 of 72 layers: attention at
    position 4, Mamba elsewhere, MoE at 1, 3, 5, 7, 16 experts top-2, the
    MLP at 0, 2, 4, 6) at full width, initialised and frozen block by block
    (its codes take 44.6 GB, its bf16 weights 89 GB), and
    moonshot-v1-16b-a3b (64 experts top-6) at 4 of 48 layers, frozen by
    ``da_mode="auto"``: a 16-row prefill into ``init_caches`` (KVCache and
    MambaCache) and 4 decode steps, against the same forward with the
    kernels swapped for their plain versions (0 launches there): logits
    EQUAL."""
    import torch

    from repro_torch.configs.registry import get
    from repro_torch.core.freeze import packed_leaves
    from repro_torch.models.model import forward, init_caches

    b, t0, steps = 2, 16, 4
    counts_all = []
    for name, layers in (("jamba-1.5-large-398b", 8), ("moonshot-v1-16b-a3b", 4)):
        cfg = dataclasses.replace(get(name), n_layers=layers, moe_dropless=True)
        torch.cuda.reset_peak_memory_stats()
        t_init = time.perf_counter()
        frozen, plans = _frozen_by_block(cfg)
        torch.cuda.synchronize()
        t_frozen = time.perf_counter()
        peak_freeze = torch.cuda.max_memory_allocated() / 1e9
        modes = _auto_plan_check(name, plans)
        code_gb = sum(w.wq.numel() for _, w in packed_leaves(frozen)) / 1e9
        largest = max((w for _, w in packed_leaves(frozen)), key=lambda w: w.wq.numel())
        gen = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab, (b, t0 + steps), generator=gen,
                               device="cuda", dtype=torch.int32)
        pos = torch.arange(t0, dtype=torch.int32, device="cuda")[None].expand(b, t0)
        out = {}
        torch.cuda.reset_peak_memory_stats()
        for side in ("kernels", "plain"):
            caches = init_caches(cfg, b, 64, device="cuda")
            torch.cuda.synchronize()
            _reset_counts()
            logits = []
            with torch.inference_mode(), (plain_vmm() if side == "plain"
                                          else contextlib.nullcontext()):
                lg, _ = forward(frozen, tokens[:, :t0], cfg, pos, caches,
                                update_cache=True, last_logit_only=True)
                logits.append(lg[:, 0].float())
                for s in range(t0, t0 + steps):
                    p1 = torch.full((b, 1), s, dtype=torch.int32, device="cuda")
                    lg, _ = forward(frozen, tokens[:, s:s + 1], cfg, p1, caches)
                    logits.append(lg[:, 0].float())
            torch.cuda.synchronize()
            counts = _read_counts()
            if side == "kernels":
                # the dense matrices through the 2-D entry, every stacked
                # expert pack through the experts' entry (one call each)
                if min(counts["bitplane_vmm"], counts["bitplane_vmm_experts"]) <= 0:
                    raise AssertionError(f"{name}: a bit-plane entry never ran: "
                                         f"{counts}")
                counts_all.append(counts)
            elif any(counts[k] for k in KERNEL_COUNTS):
                raise AssertionError(f"{name}: the plain side launched a kernel")
            out[side] = torch.stack(logits)
        if not torch.isfinite(out["kernels"]).all():
            raise AssertionError(f"{name}: non-finite logits through the kernels")
        diff = (out["kernels"] - out["plain"]).abs()
        equal = torch.equal(out["kernels"], out["plain"])
        emit({"phase": "family_variants", "model": name, "family": cfg.family,
              "layers": cfg.n_layers, "d_model": cfg.d_model,
              "layer_pattern": [f"{cfg.mixer_kind(p)}+{cfg.ffn_kind(p)}"
                                for p in range(cfg.period)],
              "caches": sorted({type(c).__name__ for c in caches.values()}),
              "batch": b, "prefill_rows": t0, "decode_steps": steps,
              "shape": list(out["kernels"].shape), "plan_modes": modes,
              "code_gb": code_gb,
              "largest_leaf": {"shape": list(largest.wq.shape),
                               "bf16_gb": largest.wq.numel() * 2 / 1e9,
                               "f32_gb": largest.wq.numel() * 4 / 1e9},
              "peak_mem_gb_freeze": peak_freeze,
              "peak_mem_gb_forward": torch.cuda.max_memory_allocated() / 1e9,
              "max_abs_err": diff.max().item(), "atol": 0.0, "equal": equal,
              "logit_absmax": out["plain"].abs().max().item(),
              "argmax_equal": bool((out["kernels"].argmax(-1)
                                    == out["plain"].argmax(-1)).all()),
              "launches": counts_all[-1],
              "reduced": f"{layers} of {get(name).n_layers} layers",
              "freeze_s": t_frozen - t_init})
        if not equal:
            raise AssertionError(f"{name}: kernels vs plain logits differ by "
                                 f"{diff.max().item()}")
        del frozen, out, caches
        gc.collect()
        torch.cuda.empty_cache()
    return _merge_counts(counts_all)


def phase_families(flush):
    """This slice's phases: the kernels at the families' shapes, the
    stacked-expert VMMs, mamba2-780m and qwen2-moe-a2.7b served at full
    size, jamba and moonshot against their plain sides.  Returns the
    stacked rows and each path's launch counts."""
    timings = {}
    t0 = time.perf_counter()
    phase_family_shapes()
    stacked = phase_stacked_vmm(flush)
    timings["checks_s"] = time.perf_counter() - t0
    paths = {}
    for path, fn in (("serve_ssm", phase_serve_ssm), ("serve_moe", phase_serve_moe),
                     ("family_variants", phase_family_variants)):
        t0 = time.perf_counter()
        paths[path] = fn()
        timings[f"{path}_s"] = time.perf_counter() - t0
    emit({"phase": "families_seconds", **timings})
    return stacked, paths


def decode_window(eng, vocab: int, steps: int = 4):
    """Where a full-width decode step spends its time: host wall of
    ``steps`` batch-4 decode ticks, then the same number of ticks under
    ``torch.profiler`` for the device time by kernel.  The busy share is
    device time over the untraced wall."""
    import torch

    _all_decoding(eng, vocab, 100, 4 * steps, seed=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    _reset_counts()
    traced = _device_ms(eng.step, steps)
    counts = _read_counts()
    eng.run()
    busy = traced["device_busy_ms"]
    # the memsets the VMM entry points queued (one per split call), against
    # every memset the trace holds
    zeroings = sum(counts[f"{k}_cuda_launches"] - counts[k] for k in
                   ("bitplane_vmm", "bitplane_vmm_experts", "da_vmm", "da_vmm_experts"))
    return {"phase": "decode_step", "width": 4, "steps": steps,
            "wall_ms": wall_ms, "device_ms": traced["device_ms"],
            "device_busy_ms": busy, "busy_share": busy / wall_ms,
            "memsets_per_step": traced["memsets"],
            "vmm_zeroings_per_step": zeroings / steps}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phase", choices=("all", "attention", "vmm", "plans",
                                            "ci_boot", "serve", "obs", "auto",
                                            "dense", "families"),
                        default="all",
                        help="'attention', 'vmm', 'plans', 'ci_boot', 'serve', "
                             "'obs', 'auto', 'dense' or 'families': build the "
                             "kernels and run only "
                             "the attention phase, only the bit-plane, int8, "
                             "LUT and stacked-expert phases, only the plans' "
                             "sweep, only the "
                             "CI smoke artifact's boot and first leg, only "
                             "the qwen3-8b serve and its decode window, only "
                             "the traced qwen3-8b serves, only the planned "
                             "freeze and serve, only the dense variants "
                             "(minitron-8b on both runtimes, musicgen-large, "
                             "qwen2-vl-72b), or only the MoE / Mamba / hybrid "
                             "phases (no result line)")
    parser.add_argument("--src", help="import the port from this directory "
                        "(another checkout's src/) instead of this one's; "
                        "only with --phase attention, vmm, ci_boot or serve")
    parser.add_argument("--out", help="append every JSON line to this file "
                        "too (the standard output's tail may cut long lines)")
    args = parser.parse_args()
    if args.out:
        _OUT.append(args.out)
    if args.src:
        if args.phase in ("all", "plans", "obs", "auto"):
            parser.error("--src needs --phase attention, vmm, ci_boot or serve")
        sys.path.insert(0, os.path.abspath(args.src))
    elif not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: the port (src/repro_torch) is not beside {__file__}",
              file=sys.stderr)
        return 3
    # the plain versions are references: full float32 and bf16 reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()
    phase_device()
    if args.phase in ("ci_boot", "serve", "obs", "auto"):
        {"ci_boot": phase_ci_boot, "serve": phase_serve,
         "obs": phase_serve_obs, "auto": phase_artifact_auto}[args.phase]()
        print(smi_line(), flush=True)
        return 0
    if args.phase == "dense":
        phase_serve_dense()
        phase_dense_variants()
        print(smi_line(), flush=True)
        return 0
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    if args.phase == "families":
        phase_families(flush)
        print(smi_line(), flush=True)
        return 0
    if args.phase == "attention":
        phase_attention(flush)
    if args.phase == "vmm":
        phase_bitplane(flush)
        phase_int8(flush)
        phase_lut_vmm(flush)
        if not args.src:  # an older checkout's port has no experts' entries
            phase_stacked_vmm(flush)
    if args.phase == "plans":
        phase_plans(flush)
    if args.phase != "all":
        print(smi_line(), flush=True)
        return 0
    secs = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        secs[name] = time.perf_counter() - t0
        return out

    vmm = timed("bitplane_vmm", phase_bitplane, flush)
    timed("int8_vmm", phase_int8, flush)
    lut = timed("lut_vmm", phase_lut_vmm, flush)
    timed("family_shapes", phase_family_shapes)
    stacked = timed("stacked_vmm", phase_stacked_vmm, flush)
    attn = timed("paged_attention", phase_attention, flush)
    del flush
    torch.cuda.empty_cache()
    timed("logits", phase_logits)
    params, fp_counts, plain_tokens, serve_shapes = timed("serve", phase_serve)
    int8_counts = timed("serve_int8kv", phase_serve_int8kv, params)
    prefix_counts = timed("serve_prefix", phase_serve_prefix, params)
    spec_counts = timed("serve_spec", phase_serve_spec, params, plain_tokens)
    obs_counts = timed("serve_obs", phase_serve_obs, params, plain_tokens)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    lut_counts, lut_spec_counts = timed("artifact_lut", phase_artifact_lut)
    ci_counts = timed("artifact_ci", phase_artifact_ci)
    auto_counts = timed("artifact_auto", phase_artifact_auto, serve_shapes)
    dense_counts = timed("serve_dense", phase_serve_dense)
    variant_counts = timed("dense_variants", phase_dense_variants)
    ssm_counts = timed("serve_ssm", phase_serve_ssm)
    moe_counts = timed("serve_moe", phase_serve_moe)
    family_counts = timed("family_variants", phase_family_variants)
    emit({"phase": "phase_seconds", **secs})
    paths = {"serve": fp_counts, "serve_int8kv": int8_counts,
             "serve_prefix": prefix_counts, "serve_spec": spec_counts,
             "serve_obs": obs_counts, "artifact_lut": lut_counts, "artifact_lut_spec": lut_spec_counts,
             "artifact_ci": ci_counts, "artifact_auto": auto_counts,
             "serve_dense": dense_counts, "dense_variants": variant_counts,
             "serve_ssm": ssm_counts, "serve_moe": moe_counts,
             "family_variants": family_counts}

    def launches(name, fmt=None, dtype=None, key=None):
        """Launches over the paths (that run ``dtype``): of ``name``, of its
        page format ``fmt``, or of entry ``key`` of the by-x_bits / by-T
        count ``name``."""
        by = {p: (c["paged_attention_by_format"][fmt] if fmt else
                  c[name].get(key, 0) if key is not None else c[name])
              for p, c in paths.items() if dtype in (None, PATH_DTYPE[p])}
        return sum(by.values()), {p: n for p, n in by.items() if n}

    def attn_row(fmt, dtype, w, t=1):
        # the batch-4 decode (or verify) case of the paths that run this dtype
        r = next(r for r in attn if (r["dtype"], r["b"], r["t"], r["w"], r["kv"])
                 == (dtype, 4, t, w, fmt) and "ms" in r
                 and r["softmax"] == "float32")
        total, by_path = (launches("paged_attention", fmt, dtype) if t == 1 else
                          launches("paged_attention_by_t", dtype=dtype,
                                   key=VERIFY_T))
        return {"kv": fmt, "dtype": dtype, "head_dim": r["hd"], "t": t,
                "shape": f"B={r['b']} T={t} W={w} ps=16 H={r['h']} "
                         f"kv={r['kv_heads']} hd={r['hd']} {dtype}, {fmt} pages",
                "launches": total, "launches_by_path": by_path,
                "max_abs_err": max(x["max_abs_err"] for x in attn
                                   if (x["kv"], x["dtype"], x["softmax"])
                                   == (fmt, dtype, "float32")),
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}

    def vmm_row(rows, m, k, n, x_bits, name):
        r = next(r for r in rows if (r["m"], r["k"], r["n"], r["x_bits"])
                 == (m, k, n, x_bits))
        total, by_path = launches(f"{name}_by_bits", key=x_bits)
        return {"x_bits": x_bits, "launches": total, "launches_by_path": by_path,
                "shape": f"M={m} K={k} N={n} x_bits={x_bits}",
                **{key: r[key] for key in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by", "library_ms")}}

    def stacked_row(kernel, c, one_call):
        """A stacked-expert row of ``stacked_vmm``: one call of the experts'
        entry per stack (launches: that entry's calls on every path, at
        every C), or the E calls of the 2-D entry (launches 0: no path runs
        a stack that way)."""
        r = next(r for r in stacked if (r["kernel"], r["c"]) == (kernel, c))
        t = r if one_call else r["e_launch"]
        total, by_path = launches(f"{kernel}_experts") if one_call else (0, {})
        return {"form": ("one call of the experts' entry per stack" if one_call
                         else "E calls of the 2-D entry"),
                **({"batches": "jax.vmap of the kernel in src/repro/core/engine.py:"
                               "782,784 (one pallas_call, grid (E, ..))"}
                   if one_call else {}),
                "shape": f"E={r['experts']} x (M={c} K={r['k']} N={r['n']}) x_bits=8",
                "launches": total, "launches_by_path": by_path,
                "launches_per_stacked_vmm": t["launches_per_stacked_vmm"],
                "device_ms": t["device_ms"], "ms": t["ms"],
                **{k: r[k] for k in ("max_abs_err", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")}}

    dec_vmm = vmm_row(vmm, 4, 4096, 12288, 8, "bitplane_vmm")
    dec_lut = vmm_row(lut, 4, 256, 8000, 8, "da_vmm")
    formats = ([attn_row(fmt, "bfloat16", 17) for fmt in ("fp", "int8", "int4")]
               + [attn_row(fmt, "float32", 9) for fmt in ("fp", "int8", "int4")])
    # verify's read: pow2(gamma + 1) rows, the last a pad column
    verify = [attn_row("fp", "bfloat16", 17, t=VERIFY_T),
              attn_row("fp", "float32", 9, t=VERIFY_T)]
    # the bfloat16 score pipeline: served by serve_dense's bf16-softmax leg;
    # checked and timed in the attention phase
    sm = next(r for r in attn if (r["dtype"], r["b"], r["t"], r["w"], r["kv"],
                                  r["softmax"]) == ("bfloat16", 4, 1, 17, "fp",
                                                    "bfloat16") and "ms" in r)
    sm_total, sm_paths = launches("paged_attention_by_softmax", key="bfloat16")
    bf16_softmax = {
        "softmax_dtype": "bfloat16", "launches": sm_total,
        "launches_by_path": sm_paths,
        "shape": "B=4 T=1 W=17 ps=16 H=32 kv=8 hd=128 bfloat16, fp pages",
        "atol": 0.0, "reference_atol": ATTN_BF16_SOFTMAX_ATOL,
        "max_abs_err": max(r["max_abs_err"] for r in attn
                           if r["softmax"] == "bfloat16"),
        **{k: sm[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}}
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})

    def entries(name):
        """Calls of a kernel through both entries (each stack one call of
        the experts' entry), by path and by entry."""
        one, one_paths = launches(name)
        stacks, stack_paths = launches(f"{name}_experts")
        by_path = {p: one_paths.get(p, 0) + stack_paths.get(p, 0)
                   for p in {**one_paths, **stack_paths}}
        return one + stacks, by_path, {"2d": one, "experts": stacks}

    bp_total, bp_paths, bp_entries = entries("bitplane_vmm")
    lut_total, lut_paths, lut_entries = entries("da_vmm")
    emit({"kernels": [
        {"name": "bitplane_vmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/bitplane_vmm.cu",
         "replaces": "src/repro/kernels/bitplane_vmm.py:33",
         "launches": bp_total, "launches_by_path": bp_paths,
         "launches_by_entry": bp_entries,
         "cuda_launches": (launches("bitplane_vmm_cuda_launches")[0]
                           + launches("bitplane_vmm_experts_cuda_launches")[0]),
         "max_abs_err": max(r["max_abs_err"] for r in vmm),
         **{k: dec_vmm[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "shape")},
         "variants": [vmm_row(vmm, 4, 4096, 12288, DRAFT_X_BITS, "bitplane_vmm")]
         + [stacked_row("bitplane_vmm", c, one) for one in (True, False)
            for c in STACKED_BITPLANE[3]]},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:66",
         "launches": sum(f["launches"] for f in formats),
         "cuda_launches": launches("paged_attention_cuda_launches")[0],
         "max_abs_err": max(r["max_abs_err"] for r in attn
                            if r["softmax"] == "float32"),
         **{k: formats[0][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "shape")},
         "formats": formats, "variants": verify + [bf16_softmax]},
        {"name": "da_vmm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/da_vmm.cu",
         "replaces": "src/repro/kernels/da_vmm.py:33",
         "launches": lut_total, "launches_by_path": lut_paths,
         "launches_by_entry": lut_entries,
         "cuda_launches": (launches("da_vmm_cuda_launches")[0]
                           + launches("da_vmm_experts_cuda_launches")[0]),
         "max_abs_err": max(r["max_abs_err"] for r in lut),
         **{k: dec_lut[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
         "library_note": LIBRARY,
         "shape": "M=4 K=256 N=8000 x_bits=8 L=8 (LM head of the LUT path)",
         "variants": [vmm_row(lut, 4, 256, 8000, DRAFT_X_BITS, "da_vmm")]
         + [stacked_row("da_vmm", c, one) for one in (True, False)
            for c in STACKED_LUT[3]]},
    ]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
