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
import functools
from typing import NamedTuple

import torch

from repro_torch.core.da import DAConfig
from repro_torch.kernels import build

#: the kernel's column and K tile, and its ring of weight tiles
_BN, _BK, _STAGES = 128, 128, 4
#: blocks per SM the K split aims at, and the fewest K steps a split keeps
#: (a shorter range would not fill the ring)
_WAVES, _MIN_STEPS = 2, 4
#: warps along M of the tile above 16 tokens, 8 tokens (64 plane rows) each
_WM = 4


class BitplanePlan(NamedTuple):
    """One call's tile and K split: ``mt`` m16 tiles (2 tokens each) per
    warp, ``wm`` warps along M, ``tokens`` per block, K in ``splits`` ranges
    of ``k_per_split``, the grid's block count and its dynamic shared
    bytes."""
    mt: int
    wm: int
    tokens: int
    splits: int
    k_per_split: int
    blocks: int
    smem: int


@functools.lru_cache(maxsize=None)
def bitplane_plan(m: int, k: int, n: int, sms: int) -> BitplanePlan:
    """Tile and K split of an ``[m, k] x [k, n]`` call on ``sms`` SMs: a
    decode tile of 2, 4 or 8 tokens for ``m <= 8``, else 16 (``m <= 16``)
    or ``8·_WM`` tokens in token slices of 8 (one warp of 64 plane rows per
    slice and column quarter); K split so about ``_WAVES`` blocks per SM
    keep weight loads in flight, each range at least ``_MIN_STEPS`` steps
    of ``_BK``.  ``chip_smoke.py --phase plans`` times the constants'
    alternatives."""
    if m <= 8:
        mt, wm = (1 if m <= 2 else 2 if m <= 4 else 4), 1
    else:
        mt, wm = 4, 2 if m <= 16 else _WM
    tokens = 2 * mt * wm
    tiles = -(-m // tokens) * -(-n // _BN)
    steps = -(-k // _BK)
    splits = max(1, min(-(-steps // _MIN_STEPS), -(-_WAVES * sms // tiles)))
    per = -(-steps // splits)
    splits = -(-steps // per)
    return BitplanePlan(mt, wm, tokens, splits, per * _BK, tiles * splits,
                        _STAGES * _BK * _BN + 2 * tokens * _BK)


def _lib():
    fn = build.load("bitplane_vmm").bitplane_vmm_s8
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    return fn


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
    plan = bitplane_plan(m, k, n, build.sms(xq.device.index))
    y = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    queued = ctypes.c_int(0)
    err = _lib()(xq.data_ptr(), wq.data_ptr(), y.data_ptr(), m, k, n,
                 wq.stride(0), cfg.x_bits, int(cfg.x_signed), plan.mt, plan.wm,
                 plan.k_per_split, torch.cuda.current_stream(xq.device).cuda_stream,
                 ctypes.byref(queued))
    bitplane_vmm_cuda.cuda_launches += queued.value
    build.check(err, "bitplane_vmm_s8")
    bitplane_vmm_cuda.launches += 1
    bitplane_vmm_cuda.launches_by_bits[cfg.x_bits] = (
        bitplane_vmm_cuda.launches_by_bits.get(cfg.x_bits, 0) + 1)
    return y


#: calls in this process (in all and by x_bits), and the CUDA launches (the
#: kernel, and the zeroing of the output when K is split) the entry point
#: queued for them (reset by callers that count a run)
bitplane_vmm_cuda.launches = 0
bitplane_vmm_cuda.launches_by_bits = {}
bitplane_vmm_cuda.cuda_launches = 0
