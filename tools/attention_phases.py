"""Phase timeline of the paged-attention kernel on the card.

Copies this checkout's port into ``build/attention_phases/<variant>/src``,
adds ``%globaltimer`` stamps to ``csrc/paged_attention.cu`` at the kernel's
phase boundaries (thread 0 of block (0, 0, 0), the first chunk of KV head 0
of row 0) and the earliest and latest block start and end over the grid,
builds that copy and reads qwen3-8b's bfloat16 shapes through it.  With
``--scalar`` each float64 MMA is replaced by the same products as scalar
float64 FMAs over the fragments, moved between lanes by shuffles: the
kernel as it would be with scalar arithmetic over the staged tiles.  With
``--twice`` each stamped read runs right behind an identical one (its code
and data warm); otherwise the L2 cache is flushed first.

Prints one JSON line per case: the read EQUAL to the plain read, its mean ms
over 10 reads on CUDA events (each after an L2 flush and a device spin, as
``chip_smoke.py`` times), the cluster plan, the span from the first block's
start to the last block's end and the spread of block starts (a second wave
shows there), and block (0, 0, 0)'s stamps in us from its start: the query
rows loaded, the first tiles issued, each K tile's start and end, the chunk
maxima pushed, the exp-sums pushed, the probabilities formed, each V tile's
start and end, the partials ready, the outputs written and the end.

    python3 tools/attention_phases.py [--scalar] [--twice]

The instrumentation finds its places by the source's text and raises if one
is gone: a kernel edit that moves them needs this script edited with it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: (B, T, W) of qwen3-8b reads: decode, verify and a prefill chunk at
#: max_len 256 / page 16, and a long table at decode and prefill
CASES = ((4, 1, 17), (4, 4, 17), (4, 16, 17), (4, 1, 300), (2, 16, 300))

_STAMPS = r'''
__device__ unsigned long long pa_stamp[256];
__device__ __forceinline__ unsigned long long pa_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(k) do { if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && \
  blockIdx.z == 0) pa_stamp[k] = pa_now(); } while (0)
#define STAMP_START() do { if (threadIdx.x == 0) { const unsigned long long t = pa_now(); \
  atomicMin(&pa_stamp[250], t); atomicMax(&pa_stamp[252], t); } STAMP(0); } while (0)
#define STAMP_END() do { if (threadIdx.x == 0) atomicMax(&pa_stamp[251], pa_now()); } while (0)
'''

_READERS = '''extern "C" {
int pa_stamp_reset() {
  unsigned long long h[256] = {};
  h[250] = ~0ull;
  return (int)cudaMemcpyToSymbol(pa_stamp, h, sizeof(h));
}
int pa_stamp_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, pa_stamp, 256 * 8);
}
'''

_SCALAR_MMA = '''__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, c = (lane & 3) * 2;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double x0 = __shfl_sync(FULL, a0, g * 4 + k), x1 = __shfl_sync(FULL, a1, g * 4 + k);
    const double y0 = __shfl_sync(FULL, b, c * 4 + k), y1 = __shfl_sync(FULL, b, (c + 1) * 4 + k);
    d[0] = fma(x0, y0, d[0]);
    d[1] = fma(x0, y1, d[1]);
    d[2] = fma(x1, y0, d[2]);
    d[3] = fma(x1, y1, d[3]);
  }
}

'''


def instrument(source: str, scalar: bool) -> str:
    """The kernel source with phase stamps (and scalar products)."""
    lines = source.split("\n")

    def find(text, start=0):
        for i in range(start, len(lines)):
            if text in lines[i]:
                return i
        raise KeyError(f"attention_phases: {text!r} is no longer in the kernel")

    after = {}
    after[find("  extern __shared__ __align__(16) unsigned char smem[];")] = "  STAMP_START();"
    after[find("  __syncthreads();", find("dst[j] = 0.f;"))] = "  STAMP(1);"
    a0 = find("  for (int i = 0; i < nt; ++i) {")
    after[a0 - 1] = "  STAMP(2);"
    w1 = find("    __syncthreads();", a0)
    after[w1] = "    STAMP(10 + 2 * min(i, 39));"
    after[find("    __syncthreads();", w1 + 1)] = "    STAMP(11 + 2 * min(i, 39));"
    c1 = find("  cluster.sync();", w1)
    after[c1 - 1] = "  STAMP(90);"
    c2 = find("  cluster.sync();", c1 + 1)
    after[c2 - 1] = "  STAMP(92);"
    d0 = find("  for (int i = 0; i < nt; ++i) {", c2)
    after[d0 - 1] = "  STAMP(94);"
    x1 = find("    __syncthreads();", d0)
    after[x1] = "    STAMP(100 + 2 * min(i, 69));"
    after[find("    __syncthreads();", x1 + 1)] = "    STAMP(101 + 2 * min(i, 69));"
    c3 = find("  cluster.sync();", x1)
    after[c3] = "  STAMP(242);"
    c4 = find("  cluster.sync();  // no block leaves", c3 + 1)
    after[c4 - 1] = "  STAMP(243);"
    after[c4] = "  STAMP(244); STAMP_END();"
    out = []
    for i, line in enumerate(lines):
        out.append(line)
        if i in after:
            out.append(after[i])
    s = "\n".join(out)
    s = s.replace("namespace cg = cooperative_groups;\n",
                  "namespace cg = cooperative_groups;\n" + _STAMPS, 1)
    s = s.replace('extern "C" {\n', _READERS, 1)
    if scalar:
        start = s.index("__device__ __forceinline__ void dmma(")
        s = s[:start] + _SCALAR_MMA + s[s.index("// Scores of R ", start):]
    return s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scalar", action="store_true", help="scalar float64 FMAs "
                    "in place of the float64 MMA")
    ap.add_argument("--twice", action="store_true", help="stamp a read made "
                    "right behind an identical one")
    args = ap.parse_args()
    variant = "scalar" if args.scalar else "dmma"
    dst = ROOT / "build" / "attention_phases" / variant
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / "src" / "repro_torch" / "kernels" / "csrc" / "paged_attention.cu"
    cu.write_text(instrument(cu.read_text(), args.scalar))
    sys.path.insert(0, str(dst / "src"))

    import torch

    if not torch.cuda.is_available():
        print("attention_phases: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.attention import paged_gather_read

    build.build_all()
    lib = build.load("paged_attention")
    stamps = (ctypes.c_ulonglong * 256)()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for b, t, w in CASES:
        g = torch.Generator(device="cuda").manual_seed(0)
        h, kv, hd, ps, p = 32, 8, 128, 16, b * w + 8
        q = torch.randn(b, t, h, hd, generator=g, device="cuda").to(torch.bfloat16)
        kp = torch.randn(p, ps, kv, hd, generator=g, device="cuda").to(torch.bfloat16)
        vp = torch.randn(p, ps, kv, hd, generator=g, device="cuda").to(torch.bfloat16)
        perm = torch.randperm(p - 1, generator=g, device="cuda")[: b * (w - 1)]
        table = torch.cat([perm.reshape(b, w - 1).to(torch.int32) + 1,
                           torch.zeros(b, 1, dtype=torch.int32, device="cuda")], 1)
        end = (w - 1) * ps - 3
        tpos = (end - t + torch.arange(t, device="cuda")).expand(b, t).to(torch.int32)
        read = (q, kp, vp, table.contiguous(), tpos.contiguous())
        equal = torch.equal(pa.paged_attention_cuda(*read), paged_gather_read(*read))
        flush.zero_()
        torch.cuda.synchronize()
        if args.twice:
            pa.paged_attention_cuda(*read)
        lib.pa_stamp_reset()
        pa.paged_attention_cuda(*read)
        torch.cuda.synchronize()
        lib.pa_stamp_read(stamps)
        d = list(stamps)

        def us(k):
            return round((d[k] - d[0]) / 1e3, 3) if d[k] else None

        total = 0.0
        for i in range(12):
            flush.zero_()
            torch.cuda._sleep(200_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            pa.paged_attention_cuda(*read)
            e1.record()
            e1.synchronize()
            if i >= 2:
                total += e0.elapsed_time(e1)
        plan = pa.split_plan(kv, ps, w, build.sms(0))
        print(json.dumps({
            "variant": variant, "twice": args.twice, "b": b, "t": t, "w": w,
            "equal": equal, "ms": total / 10, "ns": plan.ns, "chunk": plan.chunk,
            "span_us": (d[251] - d[250]) / 1e3, "start_spread_us": (d[252] - d[250]) / 1e3,
            "block0_us": {
                "q_loaded": us(1), "issued": us(2),
                "k_tiles": [(us(10 + 2 * i), us(11 + 2 * i)) for i in range(40) if d[10 + 2 * i]],
                "maxima_pushed": us(90), "sums_pushed": us(92), "probabilities": us(94),
                "v_tiles": [(us(100 + 2 * i), us(101 + 2 * i)) for i in range(70)
                            if d[100 + 2 * i]],
                "partials_ready": us(242), "outputs_written": us(243), "end": us(244)}}),
            flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
