"""Quickstart: the paper's technique in five minutes.

1. Build a weight matrix, quantize it (post-training symmetric INT8, §II-C).
2. Pre-VMM: compute all 2^8 weight sums per 8-row group and 'write the PMAs'
   (pack_quantized / pack_weights — the once-in-a-lifetime step, §III-A).
3. Run a bit-serial, multiplier-free, ADC-free VMM through the unified engine
   (§II) — every registered backend is bit-exact against the integer matmul,
   and mode="auto" picks the backend from the activation/layer shape.
4. Ask the calibrated hardware model what this costs on a ReRAM engine vs the
   bit-slicing baseline (Table I).

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The reference's ``examples/quickstart.py`` on the port, with the same prints
and self-checks.  On the card (the default device) the backend loop runs the
hand-written kernels: ``pallas_bitplane`` and the storage-free modes the
bit-plane kernel, ``pallas_lut`` and the LUT modes the LUT-readout kernel,
here on unsigned codes with a partial last group (K = 25 = 3·8 + 1).
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (
    DAConfig,
    da_matmul,
    da_vmm,
    pack_quantized,
    pack_weights,
    registered_backends,
    select_backend,
)
from repro_torch.core.hwmodel import table1
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu: the kernels' plain versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)

    # --- the paper's CONV1 workload: 1×25 vector · 25×6 matrix -------------
    x = rng.integers(0, 256, (1, 25)).astype(np.int32)      # 8-bit image patch
    w = rng.integers(-128, 128, (25, 6)).astype(np.int32)   # INT8 weights

    cfg = DAConfig(group_size=8, x_bits=8, x_signed=False)
    packed = pack_quantized(torch.as_tensor(w, device=dev), cfg=cfg)  # pre-VMM
    print(f"PMAs: {packed.luts.shape[0]} arrays of 2^8={packed.luts.shape[1]} "
          f"weight-sums x {packed.luts.shape[2]} columns")

    xt = torch.as_tensor(x, device=dev)
    y = da_vmm(xt, packed, mode="lut").cpu().numpy()         # 8 bit-serial cycles
    print("DA result:      ", y[0])
    print("integer matmul: ", (x @ w)[0])
    assert (y == x @ w).all(), "DA must be bit-exact"
    print("bit-exact ✓ — no multiplier, no DAC, no ADC")

    # every eligible engine backend computes the same integers (int8 is
    # signed-only, so it sits this unsigned-activation demo out)
    verified = []
    for name, spec in sorted(registered_backends().items()):
        if spec.supports(cfg, packed.has_luts):
            assert (da_vmm(xt, packed, mode=name).cpu().numpy()
                    == x @ w).all(), name
            verified.append(name)
    print(f"…and so does every eligible engine backend: "
          f"{', '.join(verified)}\n")

    # --- float end-to-end (LM-style linear layer) ---------------------------
    xf = rng.normal(size=(4, 64)).astype(np.float32)
    wf = rng.normal(size=(64, 32)).astype(np.float32)
    pw = pack_weights(torch.as_tensor(wf, device=dev))       # codes + scale + LUTs
    y_da = da_matmul(torch.as_tensor(xf, device=dev), pw,
                     mode="auto").cpu().numpy()              # shape-aware dispatch
    chosen = select_backend(4, 64, 32, DAConfig(x_signed=True), pw.has_luts)
    rel = np.abs(y_da - xf @ wf).max() / np.abs(xf @ wf).max()
    print(f"float linear via DA engine (auto -> {chosen}): "
          f"rel err {rel:.4f} (int8 quantization only)\n")

    # --- what does it cost in silicon? (paper Table I) ----------------------
    t = table1(k=25, n=6)
    print("Table I (model ↔ paper):")
    print(f"  DA        : {t['da']['latency_ns']:.0f} ns, "
          f"{t['da']['energy_vmm_pj']:.1f} pJ   (paper: 88 ns, 110.2 pJ)")
    print(f"  bit-slice : {t['bitslice']['latency_ns']:.0f} ns, "
          f"{t['bitslice']['energy_vmm_pj']:.1f} pJ  (paper: 400 ns, 1421.5 pJ)")
    print(f"  DA is {t['latency_ratio']:.1f}x faster, "
          f"{t['energy_ratio']:.1f}x more energy-efficient, "
          f"uses {t['cell_ratio']:.0f}x more memory cells and "
          f"{t['transistor_ratio']:.1f}x fewer transistors.")


if __name__ == "__main__":
    main()
