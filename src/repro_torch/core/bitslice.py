"""Bit-slicing in-memory VMM — the paper's comparison baseline (§IV, Fig. 10).

ISAAC-style [Shafiee et al., ISCA'16]: the 8-bit weights are stored in binary
form across 8 columns (one bit per column); inputs are fed bit-serially over 8
cycles through 1-bit DACs. Each cycle, every column's bit-line current is the
*count* of rows where (input bit == 1 AND stored weight bit == 1); an
``adc_bits``-bit ADC digitizes that count. Two shift-and-add stages then undo the
weight slicing (×2^bw, with the weight's sign column carrying −2^7 for two's
complement) and the input slicing (×2^bx).

This module is the exact digital emulation of that datapath (the reference's
``repro.core.bitslice``), used as a functional baseline: it equals X @ W
exactly when the ADC has enough resolution.  It runs in plain int32 torch ops
on the CPU and on the card alike (CUDA has no integer matmul, so each
cycle's column counts are an elementwise product summed over the rows, an
``[M, K, N * w_bits]`` intermediate: a baseline for small design points, not
a serving path).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.da import bit_coefs


@dataclasses.dataclass(frozen=True)
class BitSliceConfig:
    w_bits: int = 8
    x_bits: int = 8
    w_signed: bool = True
    x_signed: bool = False
    adc_bits: int | None = None  # None → exact (enough resolution for #rows)


def weight_bit_columns(wq: torch.Tensor, cfg: BitSliceConfig) -> torch.Tensor:
    """Binary storage of W: [K, N, w_bits] of {0,1} (two's-complement bits)."""
    wu = torch.bitwise_and(wq.to(torch.int32), (1 << cfg.w_bits) - 1)
    return torch.stack([torch.bitwise_and(torch.bitwise_right_shift(wu, b), 1)
                        for b in range(cfg.w_bits)], dim=-1)


def bitslice_vmm(xq: torch.Tensor, wq: torch.Tensor,
                 cfg: BitSliceConfig) -> torch.Tensor:
    """Exact emulation of the bit-sliced analog VMM datapath.

    xq: [M, K] integer codes; wq: [K, N] integer codes.
    Returns int32 [M, N] == xq @ wq when the ADC resolution suffices.
    """
    wcols = weight_bit_columns(wq, cfg)  # [K, N, w_bits]
    k, n, wb = wcols.shape
    wflat = wcols.reshape(k, n * wb)
    xu = torch.bitwise_and(xq.to(torch.int32), (1 << cfg.x_bits) - 1)
    dev = xq.device
    w_coef = torch.as_tensor(bit_coefs(cfg.w_bits, cfg.w_signed),
                             dtype=torch.int32, device=dev)
    x_coef = bit_coefs(cfg.x_bits, cfg.x_signed)

    acc = torch.zeros(xq.shape[:-1] + (n,), dtype=torch.int32, device=dev)
    for bx in range(cfg.x_bits):
        xplane = torch.bitwise_and(torch.bitwise_right_shift(xu, bx), 1)
        # column currents: counts[m, n, bw] = Σ_k xbit·wbit (the ADC reading)
        counts = (xplane.unsqueeze(-1) * wflat).sum(
            -2, dtype=torch.int32).reshape(xq.shape[:-1] + (n, wb))
        if cfg.adc_bits is not None:
            counts = torch.clamp(counts, 0, (1 << cfg.adc_bits) - 1)
        # first shift-and-add: undo weight slicing
        col = (counts * w_coef).sum(-1, dtype=torch.int32)
        # second shift-and-add: undo input slicing
        acc = acc + int(x_coef[bx]) * col
    return acc


def adc_bits_required(rows: int) -> int:
    """Minimum ADC resolution to digitize a column of ``rows`` 1-bit products
    without clipping (paper: 5-bit for 25 rows)."""
    return max(1, math.ceil(math.log2(rows + 1)))
