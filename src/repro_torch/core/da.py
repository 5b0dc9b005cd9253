"""Distributed-Arithmetic VMM, bit-plane forms (the paper's identity, §II).

For integer X [M, K] and constant integer W [K, N]::

    Y = Σ_b coef(b) · (xbit_b @ W),   xbit_b ∈ {0, 1}

with ``coef(b) = 2^b`` except the sign bit of two's-complement inputs, which
carries ``-2^(B-1)``.  Both forms return the exact int32 accumulator
(== X @ W).  The LUT-readout forms arrive with the LUT slice.

The plane products run as float64 matmuls: every partial is an integer far
below 2^53, so the product is exact on any device (CUDA has no int32
``matmul``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DAConfig:
    """Configuration of the DA engine.

    group_size: rows per processing-memory array (paper: 8 → 256-row PMA).
    x_bits:     bit-serial cycles (input bit width; paper: 8).
    x_signed:   two's-complement inputs (LM activations) vs unsigned (images).
    """

    group_size: int = 8
    x_bits: int = 8
    x_signed: bool = False


def num_groups(k: int, group_size: int) -> int:
    return -(-k // group_size)


def bit_coefs(x_bits: int, x_signed: bool) -> np.ndarray:
    """Per-bit weights; two's complement puts −2^(B−1) on the sign bit."""
    coefs = np.array([1 << b for b in range(x_bits)], dtype=np.int64)
    if x_signed:
        coefs[-1] = -coefs[-1]
    return coefs


def truncate_codes(xq: torch.Tensor, cfg: DAConfig, x_bits_eff: int):
    """Drop the ``cfg.x_bits - x_bits_eff`` low-order bit-planes of ``xq``.

    An arithmetic right shift of the (sign-extended) two's-complement codes:
    running a backend on ``xq >> d`` under ``x_bits = x_bits_eff`` and
    scaling the accumulator by ``2^d`` computes exactly the top-plane
    partial sum.  Returns ``(shifted codes, cfg with x_bits=x_bits_eff, d)``.
    """
    if not 1 <= x_bits_eff <= cfg.x_bits:
        raise ValueError(
            f"x_bits_eff={x_bits_eff} outside [1, cfg.x_bits={cfg.x_bits}]")
    drop = cfg.x_bits - x_bits_eff
    if drop == 0:
        return xq, cfg, 0
    if cfg.x_signed:
        sign = 1 << (cfg.x_bits - 1)
        xq = (torch.bitwise_and(xq, (1 << cfg.x_bits) - 1) ^ sign) - sign
    shifted = torch.bitwise_right_shift(xq, drop)
    return shifted, dataclasses.replace(cfg, x_bits=x_bits_eff), drop


def bit_planes(xq: torch.Tensor, cfg: DAConfig) -> torch.Tensor:
    """``[x_bits, .., K]`` {0,1} planes of the two's-complement bit pattern
    of the low ``x_bits`` bits (LSB first)."""
    xm = torch.bitwise_and(xq.to(torch.int32), (1 << cfg.x_bits) - 1)
    return torch.stack([torch.bitwise_and(torch.bitwise_right_shift(xm, b), 1)
                        for b in range(cfg.x_bits)])


def plane_products(planes: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact ``planes [B, M, K] @ wq [K, N]`` → int32 ``[B, M, N]``."""
    mr = torch.matmul(planes.to(torch.float64), wq.to(torch.float64))
    return mr.to(torch.int32)


def da_vmm_bitplane(xq: torch.Tensor, wq: torch.Tensor,
                    cfg: DAConfig) -> torch.Tensor:
    """Storage-free DA: Σ_b coef(b) · (xbit_b @ W), one plane at a time,
    MSB first (the paper's LSIS accumulator: acc ← 2·acc ± MR_b)."""
    planes = bit_planes(xq, cfg)
    acc = torch.zeros(xq.shape[:-1] + (wq.shape[-1],), dtype=torch.int32,
                      device=xq.device)
    for b in range(cfg.x_bits - 1, -1, -1):
        mr = plane_products(planes[b], wq)
        sign = -1 if (cfg.x_signed and b == cfg.x_bits - 1) else 1
        acc = acc + sign * (1 << b) * mr
    return acc


def da_vmm_bitplane_stacked(xq: torch.Tensor, wq: torch.Tensor,
                            cfg: DAConfig) -> torch.Tensor:
    """All bit-planes stacked on a leading axis: ONE batched product against
    W, then the coefficient contraction.  Bit-exact == da_vmm_bitplane."""
    mr = plane_products(bit_planes(xq, cfg), wq)  # [B_bits, .., N]
    coefs = torch.as_tensor(bit_coefs(cfg.x_bits, cfg.x_signed),
                            dtype=torch.int32, device=xq.device)
    # elementwise contraction: CUDA has no integer einsum / bmm
    return (mr * coefs.reshape((-1,) + (1,) * (mr.ndim - 1))).sum(0,
                                                              dtype=torch.int32)
