"""Distributed-Arithmetic VMM (the paper's identity, §II).

For integer X [M, K] and constant integer W [K, N]::

    Y = Σ_b coef(b) · Σ_g LUT_g[addr_g(m, b), n]   (LUT readout)
      = Σ_b coef(b) · (xbit_b @ W),   xbit_b ∈ {0, 1}   (bit-plane)

where rows of W are split into groups of ``group_size`` L (one PMA each),
``LUT_g[a, n] = Σ_{i: bit i of a set} W[g·L+i, n]`` holds all 2^L weight
sums of group g, and ``addr_g(m, b)`` packs bit-plane b of the group's
inputs into the PMA address.  ``coef(b) = 2^b`` except the sign bit of
two's-complement inputs, which carries ``-2^(B-1)``.  Every form returns the
exact int32 accumulator (== X @ W).

Matrix products run as float64 matmuls: every partial is an integer far
below 2^53, so the product is exact on any device (CUDA has no int32
``matmul``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: the largest group size any backend addresses (16-bit PMA addresses)
MAX_GROUP_SIZE = 16


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

    @property
    def lut_rows(self) -> int:
        return 1 << self.group_size


def num_groups(k: int, group_size: int) -> int:
    return -(-k // group_size)


def pad_to_groups(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """Zero-pad the contraction dim of W [K, N] to a multiple of group_size."""
    pad = (-w.shape[0]) % group_size
    if pad:
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    return w


def build_luts(w: torch.Tensor, group_size: int = 8) -> torch.Tensor:
    """Pre-VMM weight summation (§III-A): int32 LUTs [G, 2^L, N] with
    ``LUT[g, a, n] = Σ_{i<L, a_i=1} W[g·L+i, n]``, by iterative doubling
    (address bit r ↔ group row r, LSB first)."""
    w = pad_to_groups(w.to(torch.int32), group_size)
    k, n = w.shape
    wg = w.reshape(k // group_size, group_size, n)
    luts = torch.zeros((wg.shape[0], 1, n), dtype=torch.int32, device=w.device)
    for r in range(group_size):
        luts = torch.cat([luts, luts + wg[:, r:r + 1, :]], dim=1)
    return luts


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


def bit_plane(xq: torch.Tensor, b: int) -> torch.Tensor:
    """Bit b of the (two's-complement or unsigned) integer codes, in {0, 1}."""
    return torch.bitwise_and(torch.bitwise_right_shift(xq, b), 1)


def group_addresses(xq: torch.Tensor, cfg: DAConfig) -> torch.Tensor:
    """Pack the bit-planes of X [.., K] into PMA addresses [.., B, G]:
    ``addr[.., b, g] = Σ_i bit_b(X[.., g·L+i]) << i`` (K zero-padded to whole
    groups; signed codes contribute their low ``x_bits`` two's-complement
    pattern)."""
    l = cfg.group_size
    pad = (-xq.shape[-1]) % l
    if pad:
        xq = torch.nn.functional.pad(xq, (0, pad))
    xg = xq.reshape(xq.shape[:-1] + (xq.shape[-1] // l, l))
    xg = torch.bitwise_and(xg.to(torch.int32), (1 << cfg.x_bits) - 1)
    shifts = torch.arange(l, dtype=torch.int32, device=xq.device)
    return torch.stack([
        torch.sum(torch.bitwise_left_shift(bit_plane(xg, b), shifts), dim=-1,
                  dtype=torch.int32)
        for b in range(cfg.x_bits)], dim=-2)


def _coefs(cfg: DAConfig, device) -> torch.Tensor:
    return torch.as_tensor(bit_coefs(cfg.x_bits, cfg.x_signed),
                           dtype=torch.int32, device=device)


def da_vmm_lut(xq: torch.Tensor, luts: torch.Tensor,
               cfg: DAConfig) -> torch.Tensor:
    """Faithful DA VMM: LUT gather (the memory readout) + shift-and-add.
    xq [M, K] codes, luts [G, 2^L, N] → int32 [M, N] == xq @ W exactly."""
    addr = group_addresses(xq, cfg).long()                 # [M, B, G]
    groups = torch.arange(luts.shape[0], device=luts.device)
    mr = luts[groups, addr]                                # [M, B, G, N]
    per_cycle = mr.sum(dim=2, dtype=torch.int32)           # adder tree over PMAs
    return (per_cycle * _coefs(cfg, xq.device)[:, None]).sum(1, dtype=torch.int32)


def da_vmm_onehot(xq: torch.Tensor, luts: torch.Tensor,
                  cfg: DAConfig) -> torch.Tensor:
    """The address decoder as a one-hot [M·B, G·2^L] contracted against the
    tables in one product (exact in float64: entries stay far below 2^53)."""
    g, r, n = luts.shape
    addr = group_addresses(xq, cfg).long()                 # [M, B, G]
    onehot = torch.nn.functional.one_hot(addr, r).to(torch.int32)
    m = xq.shape[0]
    flat = onehot.reshape(m * cfg.x_bits, g * r)
    per_cycle = torch.matmul(flat.to(torch.float64),
                             luts.reshape(g * r, n).to(torch.float64))
    per_cycle = per_cycle.to(torch.int32).reshape(m, cfg.x_bits, n)
    return (per_cycle * _coefs(cfg, xq.device)[:, None]).sum(1, dtype=torch.int32)


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
    coefs = _coefs(cfg, xq.device)
    # elementwise contraction: CUDA has no integer einsum / bmm
    return (mr * coefs.reshape((-1,) + (1,) * (mr.ndim - 1))).sum(0,
                                                              dtype=torch.int32)
