"""Full LeNet-5 inference, every layer through the DA in-memory engine.

The paper evaluates CONV1 and notes that "the inference of any Neural
Network can be executed efficiently as a series of VMM operations" (§II-B).
This example completes that claim: all five weight layers of LeNet-5
(conv1 → pool → conv2 → pool → fc1 → fc2 → fc3) run as DA VMMs
(im2col for convs), bit-exact against the integer reference at every layer,
with per-layer hardware-model cost and the whole-network totals.

Run: PYTHONPATH=src python -m repro_torch.examples.lenet_full_da
[--device cpu]

The reference's ``examples/lenet_full_da.py`` on the port, with the same
prints and self-checks; ``mode="lut"`` is the LUT readout, the LUT-readout
kernel on the card (the default device).
"""
import argparse

import numpy as np
import torch

from repro_torch.core.da import DAConfig
from repro_torch.core.engine import da_vmm, pack_quantized
from repro_torch.core.hwmodel import BitSliceDesign, DADesign
from repro_torch.core.quant import quantize_weights
from repro_torch.device import resolve_device


def im2col(x: np.ndarray, kh: int, kw: int) -> np.ndarray:
    """x: [C, H, W] → patches [OH·OW, C·kh·kw]."""
    c, h, w = x.shape
    oh, ow = h - kh + 1, w - kw + 1
    cols = np.empty((oh * ow, c * kh * kw), dtype=x.dtype)
    idx = 0
    for i in range(oh):
        for j in range(ow):
            cols[idx] = x[:, i : i + kh, j : j + kw].reshape(-1)
            idx += 1
    return cols


def avg_pool2(x: np.ndarray) -> np.ndarray:
    """x: [C, H, W] → 2×2 average pool (LeNet subsampling), integer-floored."""
    c, h, w = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return (
        x.reshape(c, h // 2, 2, w // 2, 2).sum(axis=(2, 4)) // 4
    )


def da_layer(x_int: np.ndarray, w_float: np.ndarray, name: str,
             unsigned: bool, stats: list, dev: torch.device) -> np.ndarray:
    """One VMM layer through the faithful LUT datapath; returns int32 acc.

    x_int: [M, K] integer activations; w_float: [K, N] trained weights.
    """
    wq = quantize_weights(torch.as_tensor(w_float, device=dev))
    bits_in = 8
    cfg = DAConfig(group_size=8, x_bits=bits_in, x_signed=not unsigned)
    packed = pack_quantized(wq.q, wq.scale, cfg=cfg)  # pre-VMM, LUTs once
    # re-quantize activations to 8 bits (the inter-layer requantization any
    # integer pipeline performs; inputs are unsigned after ReLU / images)
    amax = max(1, int(np.abs(x_int).max()))
    qmax = (1 << bits_in) - 1 if unsigned else (1 << (bits_in - 1)) - 1
    xq = np.clip((x_int.astype(np.float64) * qmax / amax).round(),
                 0 if unsigned else -qmax - 1, qmax).astype(np.int32)
    acc = da_vmm(torch.as_tensor(xq, device=dev), packed,
                 mode="lut").cpu().numpy()
    # exactness vs direct integer matmul
    assert (acc == xq @ wq.q.cpu().numpy()).all(), name

    k, n = w_float.shape
    d = DADesign(k=k, n=n, adder_topology="tree" if k > 32 else "chain")
    b = BitSliceDesign(k=k, n=n)
    n_vmm = x_int.shape[0]
    stats.append((name, f"{k}x{n}", n_vmm,
                  n_vmm * d.latency_ns() * 1e-3,
                  n_vmm * d.energy_vmm_j() * 1e9,
                  n_vmm * b.latency_ns() * 1e-3,
                  n_vmm * b.energy_vmm_j() * 1e9))
    return acc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu: the kernel's plain version)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (1, 32, 32)).astype(np.int32)

    # LeNet-5 weights (random stand-ins with the published shapes; the
    # datapath exactness does not depend on the values)
    w_conv1 = rng.normal(size=(6, 1 * 5 * 5)).astype(np.float32).T      # 25×6
    w_conv2 = rng.normal(size=(16, 6 * 5 * 5)).astype(np.float32).T     # 150×16
    w_fc1 = rng.normal(size=(16 * 5 * 5, 120)).astype(np.float32)       # 400×120
    w_fc2 = rng.normal(size=(120, 84)).astype(np.float32)
    w_fc3 = rng.normal(size=(84, 10)).astype(np.float32)

    stats: list = []
    relu = lambda a: np.maximum(a, 0)

    # conv1: 784 VMMs of 1×25 · 25×6 (the paper's workload)
    y = da_layer(im2col(img, 5, 5), w_conv1, "conv1", True, stats, dev)
    y = relu(y).T.reshape(6, 28, 28)
    y = avg_pool2(y)                                  # 6×14×14
    # conv2: 100 VMMs of 1×150 · 150×16
    y = da_layer(im2col(y, 5, 5), w_conv2, "conv2", True, stats, dev)
    y = relu(y).T.reshape(16, 10, 10)
    y = avg_pool2(y)                                  # 16×5×5
    # fc layers: single VMMs
    y = da_layer(y.reshape(1, -1), w_fc1, "fc1", True, stats, dev)
    y = da_layer(relu(y), w_fc2, "fc2", True, stats, dev)
    logits = da_layer(relu(y), w_fc3, "fc3", True, stats, dev)

    print("full LeNet-5 through DA: every layer bit-exact ✓")
    print(f"prediction: class {int(np.argmax(logits))}\n")
    print(f"{'layer':6s} {'KxN':9s} {'VMMs':>5s} "
          f"{'DA us':>9s} {'DA nJ':>10s} {'BS us':>9s} {'BS nJ':>10s}")
    tot = np.zeros(4)
    for name, kn, n, da_us, da_nj, bs_us, bs_nj in stats:
        print(f"{name:6s} {kn:9s} {n:5d} {da_us:9.1f} {da_nj:10.1f} "
              f"{bs_us:9.1f} {bs_nj:10.1f}")
        tot += (da_us, da_nj, bs_us, bs_nj)
    print(f"{'TOTAL':6s} {'':9s} {'':5s} {tot[0]:9.1f} {tot[1]:10.1f} "
          f"{tot[2]:9.1f} {tot[3]:10.1f}")
    print(f"\nwhole-network: DA is {tot[2]/tot[0]:.1f}x faster, "
          f"{tot[3]/tot[1]:.1f}x more energy-efficient than bit-slicing "
          f"(tree-adder PMAs for K>32, ADC-resolution-scaled baseline)")


if __name__ == "__main__":
    main()
