"""Bit-plane DA VMM: wrapper of the CUDA kernel ``csrc/bitplane_vmm.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/bitplane_vmm.py``.  The
kernel takes int32 activation codes and int8 weight codes and returns the
exact int32 ``Σ_b coef(b)·(xbit_b @ W)``; see the source for its design and
what bounds it.  The plain version is
:func:`repro_torch.kernels.ref.bitplane_vmm_ref`; :func:`repro_torch.kernels.
ops.bitplane_vmm` picks between the two by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.da import DAConfig
from repro_torch.kernels import build

_SMS = 132          # H100 SXM streaming multiprocessors
_BM, _BN, _BK = 8, 64, 128   # block tile of the kernel


def _lib():
    lib = build.load("bitplane_vmm")
    fn = lib.bitplane_vmm_s8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def split_k(m: int, k: int, n: int) -> int:
    """K splits so about four blocks per SM keep weight loads in flight
    (decode grids of N/64 blocks alone leave most SMs idle)."""
    blocks = -(-m // _BM) * -(-n // _BN)
    return max(1, min(-(-k // _BK), -(-4 * _SMS // blocks)))


def bitplane_vmm_cuda(xq: torch.Tensor, wq: torch.Tensor,
                      cfg: DAConfig) -> torch.Tensor:
    """Launch the kernel: ``xq`` int32 [M, K] contiguous, ``wq`` int8 [K, N]
    with unit column stride (rows may be strided, e.g. a column slice of a
    merged q|k|v matrix).  Returns int32 [M, N]."""
    if xq.device.type != "cuda" or wq.device != xq.device:
        raise ValueError("bitplane_vmm_cuda: xq and wq must be on one CUDA device")
    if xq.dtype != torch.int32 or wq.dtype != torch.int8:
        raise TypeError(f"bitplane_vmm_cuda takes int32 activation codes and "
                        f"int8 weight codes, got {xq.dtype} and {wq.dtype}")
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"bitplane_vmm_cuda: shapes {tuple(xq.shape)} @ "
                         f"{tuple(wq.shape)} do not contract")
    if not 1 <= cfg.x_bits <= 8:
        raise ValueError(f"x_bits={cfg.x_bits} outside [1, 8]")
    if not xq.is_contiguous() or wq.stride(1) != 1 or wq.stride(0) < wq.shape[1]:
        raise ValueError("bitplane_vmm_cuda: xq must be contiguous and wq "
                         "row-major with unit column stride")
    m, k = xq.shape
    n = wq.shape[1]
    splits = split_k(m, k, n)
    y = (torch.zeros if splits > 1 else torch.empty)(
        (m, n), dtype=torch.int32, device=xq.device)
    err = _lib()(xq.data_ptr(), wq.data_ptr(), y.data_ptr(), m, k, n,
                 wq.stride(0), cfg.x_bits, int(cfg.x_signed), splits,
                 torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, "bitplane_vmm_s8")
    bitplane_vmm_cuda.launches += 1
    return y


#: kernel launches in this process (reset by callers that count a run)
bitplane_vmm_cuda.launches = 0

