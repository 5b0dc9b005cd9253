"""LeNet-5 CONV1 inference through the DA in-memory engine (paper §II-B, §III).

Maps each 5×5 convolution stride to a 1×25 · 25×6 VMM (Fig. 3 im2col), runs
all 784 strides through the faithful LUT datapath, verifies exactness against
the direct convolution, and prints the hardware-model cost of the full layer.

Run: PYTHONPATH=src python -m repro_torch.examples.lenet_da_inference
[--device cpu]

The reference's ``examples/lenet_da_inference.py`` on the port, with the same
prints and self-check; ``mode="lut"`` is the LUT readout, the LUT-readout
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


def im2col(img: np.ndarray, kh: int = 5, kw: int = 5) -> np.ndarray:
    """32×32 image → [784, 25] stride patches (paper Fig. 3 unrolling)."""
    h, w = img.shape
    oh, ow = h - kh + 1, w - kw + 1
    cols = np.empty((oh * ow, kh * kw), dtype=img.dtype)
    idx = 0
    for i in range(oh):
        for j in range(ow):
            cols[idx] = img[i : i + kh, j : j + kw].reshape(-1)
            idx += 1
    return cols


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (cpu: the kernel's plain version)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(42)
    # A synthetic 'digit': bright strokes on dark background, 8-bit grayscale.
    img = np.zeros((32, 32), dtype=np.int32)
    img[8:24, 14:18] = 220
    img[8:12, 10:18] = 200
    img += rng.integers(0, 30, (32, 32))

    filters = rng.normal(size=(6, 5, 5)).astype(np.float32)
    wq = quantize_weights(torch.as_tensor(filters.reshape(6, 25).T, device=dev))

    print("pre-VMM: summing weights and writing three PMAs "
          "(two 256x66, one 512x66) ...")
    cfg = DAConfig(x_signed=False)
    packed = pack_quantized(wq.q, wq.scale, cfg=cfg)     # LUTs built once

    cols = im2col(img)                                   # 784 strides
    acc = da_vmm(torch.as_tensor(cols, device=dev), packed,
                 mode="lut")                            # faithful PMA readout
    feature_maps = acc.cpu().numpy().reshape(28, 28, 6).transpose(2, 0, 1)

    ref = (cols @ wq.q.cpu().numpy()).reshape(28, 28, 6).transpose(2, 0, 1)
    assert (feature_maps == ref).all()
    print(f"CONV1 done: 784 VMMs -> 6 feature maps 28x28, "
          f"bit-exact vs direct convolution ✓")

    da, bs = DADesign(k=25, n=6), BitSliceDesign(k=25, n=6)
    print(f"\nprojected on ReRAM engine (hardware model, Table I constants):")
    print(f"  DA        : {784*da.latency_ns()/1e3:8.1f} us, "
          f"{784*da.energy_vmm_j()*1e9:8.2f} nJ per image")
    print(f"  bit-slice : {784*bs.latency_ns()/1e3:8.1f} us, "
          f"{784*bs.energy_vmm_j()*1e9:8.2f} nJ per image")
    print(f"  one-time pre-VMM cost: {da.pre_vmm_energy_j()*1e9:.1f} nJ "
          f"(amortized {da.pre_vmm_energy_j()*1e12/10000:.2f} pJ over 10k inferences)")
    act = feature_maps[0]
    print(f"\nfeature map 0 stats: min={act.min()} max={act.max()} "
          f"mean={act.mean():.1f}")


if __name__ == "__main__":
    main()
