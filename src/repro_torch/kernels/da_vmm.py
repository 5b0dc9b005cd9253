"""LUT-readout DA VMM: wrapper of the CUDA kernel ``csrc/da_vmm.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/da_vmm.py``.  The kernel
takes int32 activation codes and the int32 weight-sum tables ``[G, 2^L, N]``
and returns the exact int32 ``Σ_b coef(b)·Σ_g LUT[g, addr_g(m, b), n]``; see
the source for its design and what bounds it.  :func:`lut_plan` splits the
work over (column tiles, token tiles, group ranges) from the shapes and the
SM count.  :func:`da_vmm_cuda` launches it on one matrix's tables,
:func:`da_vmm_experts_cuda` on a stack of experts' tables in one launch (the
reference's ``jax.vmap`` of the Pallas kernel, one ``pallas_call`` with the
expert on its grid).  The plain versions are
:func:`repro_torch.kernels.ref.da_vmm_ref` and ``da_vmm_experts_ref``;
:mod:`repro_torch.kernels.ops` picks between kernel and plain version by
device.
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
def lut_plan(m: int, n: int, g: int, sms: int, experts: int = 1) -> LutPlan:
    """The split of an ``[m, K] x [g, 2^L, n]`` call, or of ``experts``
    such calls in one launch, on a card of ``sms`` SMs: ``_DECODE_BM``
    tokens per block at decode (``m <= 8``), ``_PREFILL_BM`` above; 16-byte
    rows per lane unless even one group per block leaves SMs idle; groups
    cut into balanced ranges of at most ``_GPB`` so the grid holds about
    four blocks per SM, the experts' blocks counted together.
    ``chip_smoke.py --phase plans`` times the constants' alternatives."""
    vec = 4 if n % 4 == 0 and experts * -(-n // 128) * m * g >= sms else 1
    bm = _DECODE_BM if m <= 8 else _PREFILL_BM
    base = experts * -(-n // (32 * vec)) * -(-m // bm)
    gpb = min(_GPB, max(1, g * base // (4 * sms)))
    splits = -(-g // gpb)
    gpb = -(-g // splits)  # balanced ranges, same count
    return LutPlan(vec, bm, gpb, min(_WARPS, gpb), base * splits)


#: the C entry's arguments: xq, luts, out; E, M, K, N, G, L; the experts'
#: element strides of xq, luts and out (64-bit); x_bits, x_signed, vec, bm,
#: gpb, warps; the stream and the launch count
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def _lib():
    fn = build.load("da_vmm").da_vmm_lut_s32
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, xq: torch.Tensor, luts: torch.Tensor, cfg: DAConfig,
           ndim: int) -> None:
    if xq.device.type != "cuda" or luts.device != xq.device:
        raise ValueError(f"{name}: xq and luts must be on one CUDA device")
    if xq.dtype != torch.int32 or luts.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 codes and int32 LUTs, got "
                        f"{xq.dtype} and {luts.dtype}")
    if not 1 <= cfg.group_size <= MAX_GROUP_SIZE:
        raise ValueError(f"{name}: group_size {cfg.group_size} outside "
                         f"[1, {MAX_GROUP_SIZE}]")
    if not 1 <= cfg.x_bits <= MAX_X_BITS:
        raise ValueError(f"{name}: x_bits={cfg.x_bits} outside [1, {MAX_X_BITS}]")
    if (xq.ndim != ndim or luts.ndim != ndim + 1
            or luts.shape[-2] != 1 << cfg.group_size
            or xq.shape[:-2] != luts.shape[:-3]):
        raise ValueError(f"{name}: codes {tuple(xq.shape)} and LUTs "
                         f"{tuple(luts.shape)} do not match group_size "
                         f"{cfg.group_size} (2^L rows per table)")
    g, k = luts.shape[-3], xq.shape[-1]
    if g * cfg.group_size < k:
        raise ValueError(f"{name}: {g} groups of {cfg.group_size} cover "
                         f"fewer than K={k} codes")
    if not xq.is_contiguous() or not luts.is_contiguous():
        raise ValueError(f"{name}: xq and luts must be contiguous")
    if luts.data_ptr() % 16:
        raise ValueError(f"{name}: luts must be 16-byte aligned (rows are "
                         "read as vectors)")


def _launch(xq: torch.Tensor, luts: torch.Tensor, cfg: DAConfig, e: int,
            m: int, k: int) -> tuple:
    """One launch over ``e`` experts (contiguous stacks); returns
    (out [e, m, n], CUDA launches)."""
    g, rows, n = luts.shape[-3:]
    plan = lut_plan(m, n, g, build.sms(xq.device.index), e)
    y = torch.empty((e, m, n), dtype=torch.int32, device=xq.device)
    queued = ctypes.c_int(0)
    err = _lib()(xq.data_ptr(), luts.data_ptr(), y.data_ptr(), e, m, k, n, g,
                 cfg.group_size, m * k, g * rows * n, m * n,
                 cfg.x_bits, int(cfg.x_signed), plan.vec, plan.bm, plan.gpb,
                 plan.warps, torch.cuda.current_stream(xq.device).cuda_stream,
                 ctypes.byref(queued))
    build.check(err, "da_vmm_lut_s32")
    return y, queued.value


def _count(fn, cfg: DAConfig, queued: int) -> None:
    fn.launches += 1
    fn.launches_by_bits[cfg.x_bits] = fn.launches_by_bits.get(cfg.x_bits, 0) + 1
    fn.cuda_launches += queued


def da_vmm_cuda(xq: torch.Tensor, luts: torch.Tensor,
                cfg: DAConfig) -> torch.Tensor:
    """Launch the kernel: ``xq`` int32 [M, K] and ``luts`` int32 [G, 2^L, N],
    both contiguous on one CUDA device, ``G·L ≥ K``.  Returns int32 [M, N]."""
    _check("da_vmm_cuda", xq, luts, cfg, 2)
    y, queued = _launch(xq, luts, cfg, 1, *xq.shape)
    _count(da_vmm_cuda, cfg, queued)
    return y[0]


def da_vmm_experts_cuda(xq: torch.Tensor, luts: torch.Tensor,
                        cfg: DAConfig) -> torch.Tensor:
    """Launch the kernel once over a stack of experts: ``xq`` int32
    [E, M, K] and ``luts`` int32 [E, G, 2^L, N], both contiguous (a strided
    stack is refused, never copied).  Returns int32 [E, M, N], each
    expert's the same bits as :func:`da_vmm_cuda` on its own tables."""
    _check("da_vmm_experts_cuda", xq, luts, cfg, 3)
    y, queued = _launch(xq, luts, cfg, *xq.shape)
    _count(da_vmm_experts_cuda, cfg, queued)
    return y


#: calls in this process (in all and by x_bits), and the CUDA launches (the
#: kernel, and the zeroing of the output when groups are split) the entry
#: point queued for them (reset by callers that count a run); each entry
#: counts its own calls, one per stack for the experts' entry
for _fn in (da_vmm_cuda, da_vmm_experts_cuda):
    _fn.launches = 0
    _fn.launches_by_bits = {}
    _fn.cuda_launches = 0
del _fn
