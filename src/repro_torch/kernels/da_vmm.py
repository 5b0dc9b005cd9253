"""LUT-readout DA VMM: wrapper of the CUDA kernel ``csrc/da_vmm.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/da_vmm.py``.  The kernel
takes int32 activation codes and the int32 weight-sum tables ``[G, 2^L, N]``
and returns the exact int32 ``Σ_b coef(b)·Σ_g LUT[g, addr_g(m, b), n]``; see
the source for its design and what bounds it.  :func:`lut_plan` splits the
work over (column tiles, token tiles, group ranges) from the shapes and the
SM count.  The plain version is
:func:`repro_torch.kernels.ref.da_vmm_ref`; :func:`repro_torch.kernels.ops.
da_vmm` picks between the two by device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.da import MAX_GROUP_SIZE, DAConfig
from repro_torch.kernels import build

#: the kernel's widest code
MAX_X_BITS = 8
#: most warps a block, most groups a block, and tokens a block at decode
#: (M <= 8) and above (the kernel takes 1 or 2)
_WARPS, _GPB, _DECODE_BM, _PREFILL_BM = 4, 8, 1, 2


class LutPlan(NamedTuple):
    """One call's split: columns per lane (``vec``), tokens and groups per
    block, warps per block and the grid's block count."""
    vec: int
    bm: int
    gpb: int
    warps: int
    blocks: int


@functools.lru_cache(maxsize=None)
def lut_plan(m: int, n: int, g: int, sms: int) -> LutPlan:
    """The split of an ``[m, K] x [g, 2^L, n]`` call on a card of ``sms``
    SMs: ``_DECODE_BM`` tokens per block at decode (``m <= 8``),
    ``_PREFILL_BM`` above; 16-byte rows per lane unless even one group per
    block leaves SMs idle; groups cut into balanced ranges of at most
    ``_GPB`` so the grid holds about four blocks per SM.  ``chip_smoke.py
    --phase plans`` times the constants' alternatives."""
    vec = 4 if n % 4 == 0 and -(-n // 128) * m * g >= sms else 1
    bm = _DECODE_BM if m <= 8 else _PREFILL_BM
    base = -(-n // (32 * vec)) * -(-m // bm)
    gpb = min(_GPB, max(1, g * base // (4 * sms)))
    splits = -(-g // gpb)
    gpb = -(-g // splits)  # balanced ranges, same count
    return LutPlan(vec, bm, gpb, min(_WARPS, gpb), base * splits)


def _lib():
    fn = build.load("da_vmm").da_vmm_lut_s32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
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
    if luts.data_ptr() % 16:
        raise ValueError("da_vmm_cuda: luts must be 16-byte aligned (rows are "
                         "read as vectors)")
    plan = lut_plan(m, n, g, build.sms(xq.device.index))
    y = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    queued = ctypes.c_int(0)
    err = _lib()(xq.data_ptr(), luts.data_ptr(), y.data_ptr(), m, k, n, g,
                 cfg.group_size, cfg.x_bits, int(cfg.x_signed), plan.vec, plan.bm,
                 plan.gpb, plan.warps,
                 torch.cuda.current_stream(xq.device).cuda_stream,
                 ctypes.byref(queued))
    da_vmm_cuda.cuda_launches += queued.value
    build.check(err, "da_vmm_lut_s32")
    da_vmm_cuda.launches += 1
    da_vmm_cuda.launches_by_bits[cfg.x_bits] = (
        da_vmm_cuda.launches_by_bits.get(cfg.x_bits, 0) + 1)
    return y


#: calls in this process (in all and by x_bits), and the CUDA launches (the
#: kernel, and the zeroing of the output when groups are split) the entry point
#: queued for them (reset by callers that count a run)
da_vmm_cuda.launches = 0
da_vmm_cuda.launches_by_bits = {}
da_vmm_cuda.cuda_launches = 0
