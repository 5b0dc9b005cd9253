"""LUT-readout DA VMM: wrapper of the CUDA kernel ``csrc/da_vmm.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/da_vmm.py``.  The kernel
takes int32 activation codes and the int32 weight-sum tables ``[G, 2^L, N]``
and returns the exact int32 ``Σ_b coef(b)·Σ_g LUT[g, addr_g(m, b), n]``; see
the source for its design and what bounds it.  The plain version is
:func:`repro_torch.kernels.ref.da_vmm_ref`; :func:`repro_torch.kernels.ops.
da_vmm` picks between the two by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.da import DAConfig
from repro_torch.kernels import build

#: the kernel's largest group size (16-bit PMA addresses) and code width
MAX_GROUP_SIZE, MAX_X_BITS = 16, 8


def _lib():
    fn = build.load("da_vmm").da_vmm_lut_s32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def da_vmm_cuda(xq: torch.Tensor, luts: torch.Tensor,
                cfg: DAConfig) -> torch.Tensor:
    """Launch the kernel: ``xq`` int32 [M, K] and ``luts`` int32 [G, 2^L, N],
    both contiguous on one CUDA device, ``G·L ≥ K``.  Returns int32 [M, N]."""
    if xq.device.type != "cuda" or luts.device != xq.device:
        raise ValueError("da_vmm_cuda: xq and luts must be on one CUDA device")
    if xq.dtype != torch.int32 or luts.dtype != torch.int32:
        raise TypeError(f"da_vmm_cuda takes int32 codes and int32 LUTs, got "
                        f"{xq.dtype} and {luts.dtype}")
    if not 1 <= cfg.group_size <= MAX_GROUP_SIZE:
        raise ValueError(f"da_vmm_cuda: group_size {cfg.group_size} outside "
                         f"[1, {MAX_GROUP_SIZE}]")
    if not 1 <= cfg.x_bits <= MAX_X_BITS:
        raise ValueError(f"da_vmm_cuda: x_bits={cfg.x_bits} outside "
                         f"[1, {MAX_X_BITS}]")
    if xq.ndim != 2 or luts.ndim != 3 or luts.shape[-2] != 1 << cfg.group_size:
        raise ValueError(f"da_vmm_cuda: codes {tuple(xq.shape)} and LUTs "
                         f"{tuple(luts.shape)} do not match group_size "
                         f"{cfg.group_size} (2^L rows per table)")
    m, k = xq.shape
    g, _, n = luts.shape
    if g * cfg.group_size < k:
        raise ValueError(f"da_vmm_cuda: {g} groups of {cfg.group_size} cover "
                         f"fewer than K={k} codes")
    if not xq.is_contiguous() or not luts.is_contiguous():
        raise ValueError("da_vmm_cuda: xq and luts must be contiguous")
    y = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    err = _lib()(xq.data_ptr(), luts.data_ptr(), y.data_ptr(), m, k, n, g,
                 cfg.group_size, cfg.x_bits, int(cfg.x_signed),
                 torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, "da_vmm_lut_s32")
    da_vmm_cuda.launches += 1
    return y


#: kernel launches in this process (reset by callers that count a run)
da_vmm_cuda.launches = 0
