"""Plain PyTorch versions of the kernels (bit-exact integer references)."""
from __future__ import annotations

import torch

from repro_torch.core.da import (
    DAConfig,
    bit_coefs,
    bit_planes,
    da_vmm_lut,
    plane_products,
)


def da_vmm_ref(xq: torch.Tensor, luts: torch.Tensor,
               cfg: DAConfig) -> torch.Tensor:
    """Plain version of kernels/da_vmm.py: the faithful LUT-gather DA VMM →
    int32."""
    return da_vmm_lut(xq, luts, cfg)


def bitplane_vmm_ref(xq: torch.Tensor, wq: torch.Tensor,
                     cfg: DAConfig) -> torch.Tensor:
    """Plain version of kernels/bitplane_vmm.py: Σ_b coef(b)·(xbit_b @ W) →
    int32, plane products exact in float64 on any device (int8 or int32
    codes)."""
    mr = plane_products(bit_planes(xq, cfg), wq)   # [x_bits, .., N]
    coefs = bit_coefs(cfg.x_bits, cfg.x_signed)
    acc = torch.zeros(xq.shape[:-1] + (wq.shape[-1],), dtype=torch.int32,
                      device=xq.device)
    for b in range(cfg.x_bits):
        acc = acc + int(coefs[b]) * mr[b]
    return acc


def da_vmm_experts_ref(xq: torch.Tensor, luts: torch.Tensor,
                       cfg: DAConfig) -> torch.Tensor:
    """Plain version of the LUT readout over stacked experts: xq [E, M, K]
    against luts [E, G, 2^L, N], expert by expert → int32 [E, M, N]."""
    return torch.stack([da_vmm_ref(xq[e], luts[e], cfg) for e in range(xq.shape[0])])


def bitplane_vmm_experts_ref(xq: torch.Tensor, wq: torch.Tensor,
                             cfg: DAConfig) -> torch.Tensor:
    """Plain version of the bit-plane VMM over stacked experts: xq [E, M, K]
    against wq [E, K, N], expert by expert → int32 [E, M, N]."""
    return torch.stack([bitplane_vmm_ref(xq[e], wq[e], cfg)
                        for e in range(xq.shape[0])])
