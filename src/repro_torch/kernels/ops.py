"""Public kernel dispatch: a CPU tensor goes to the plain version, a CUDA
tensor to the hand-written kernel.  There is no other path."""
from __future__ import annotations

import torch

from repro_torch.core.da import DAConfig
from repro_torch.kernels import ref
from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda, bitplane_vmm_experts_cuda
from repro_torch.kernels.da_vmm import da_vmm_cuda, da_vmm_experts_cuda


def da_vmm(xq: torch.Tensor, luts: torch.Tensor, cfg: DAConfig) -> torch.Tensor:
    """Faithful LUT-readout DA VMM (int32-exact). xq [M,K], luts [G,2^L,N]."""
    if xq.device.type == "cuda":
        return da_vmm_cuda(xq.contiguous(), luts, cfg)
    return ref.da_vmm_ref(xq, luts, cfg)


def bitplane_vmm(xq: torch.Tensor, wq: torch.Tensor,
                 cfg: DAConfig) -> torch.Tensor:
    """Storage-free bit-plane DA VMM (int32-exact). xq [M,K], wq [K,N]."""
    if xq.device.type == "cuda":
        return bitplane_vmm_cuda(xq.contiguous(), wq, cfg)
    return ref.bitplane_vmm_ref(xq, wq, cfg)


def da_vmm_experts(xq: torch.Tensor, luts: torch.Tensor,
                   cfg: DAConfig) -> torch.Tensor:
    """The LUT readout over stacked experts, one kernel call on CUDA.
    xq [E,M,K], luts [E,G,2^L,N] → int32 [E,M,N]."""
    if xq.device.type == "cuda":
        return da_vmm_experts_cuda(xq.contiguous(), luts, cfg)
    return ref.da_vmm_experts_ref(xq, luts, cfg)


def bitplane_vmm_experts(xq: torch.Tensor, wq: torch.Tensor,
                         cfg: DAConfig) -> torch.Tensor:
    """The bit-plane VMM over stacked experts, one kernel call on CUDA.
    xq [E,M,K], wq [E,K,N] → int32 [E,M,N]."""
    if xq.device.type == "cuda":
        return bitplane_vmm_experts_cuda(xq.contiguous(), wq, cfg)
    return ref.bitplane_vmm_experts_ref(xq, wq, cfg)
