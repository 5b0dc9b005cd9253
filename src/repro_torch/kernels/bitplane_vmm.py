"""Bit-plane DA VMM: wrapper of the CUDA kernel ``csrc/bitplane_vmm.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/bitplane_vmm.py``.  The
kernel takes int32 activation codes and int8 weight codes and returns the
exact int32 ``Σ_b coef(b)·(xbit_b @ W)``; see the source for its design and
what bounds it.  :func:`bitplane_vmm_cuda` launches it on one matrix,
:func:`bitplane_vmm_experts_cuda` on a stack of experts in one launch (the
reference's ``jax.vmap`` of the Pallas kernel, one ``pallas_call`` with the
expert on its grid).  The plain versions are
:func:`repro_torch.kernels.ref.bitplane_vmm_ref` and ``bitplane_vmm_experts_ref``;
:mod:`repro_torch.kernels.ops` picks between kernel and plain version by
device.
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
def bitplane_plan(m: int, k: int, n: int, sms: int, experts: int = 1) -> BitplanePlan:
    """Tile and K split of an ``[m, k] x [k, n]`` call, or of ``experts``
    such calls in one launch, on ``sms`` SMs: a decode tile of 2, 4 or 8
    tokens for ``m <= 8``, else 16 (``m <= 16``) or ``8·_WM`` tokens in
    token slices of 8 (one warp of 64 plane rows per slice and column
    quarter); K split so about ``_WAVES`` blocks per SM keep weight loads in
    flight, each range at least ``_MIN_STEPS`` steps of ``_BK``.  The
    experts' tiles count together, so a stack fills the card with fewer
    splits than one of its matrices.  ``chip_smoke.py --phase plans`` times
    the constants' alternatives."""
    if m <= 8:
        mt, wm = (1 if m <= 2 else 2 if m <= 4 else 4), 1
    else:
        mt, wm = 4, 2 if m <= 16 else _WM
    tokens = 2 * mt * wm
    tiles = experts * -(-m // tokens) * -(-n // _BN)
    steps = -(-k // _BK)
    splits = max(1, min(-(-steps // _MIN_STEPS), -(-_WAVES * sms // tiles)))
    per = -(-steps // splits)
    splits = -(-steps // per)
    return BitplanePlan(mt, wm, tokens, splits, per * _BK, tiles * splits,
                        _STAGES * _BK * _BN + 2 * tokens * _BK)


#: the C entry's arguments: xq, w, y; E, M, K, N, ldw; the experts' element
#: strides of xq, w and y (64-bit: see :func:`expert_strides`); x_bits,
#: x_signed, mt, wm, k_per_split; the stream and the launch count
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])


def _lib():
    fn = build.load("bitplane_vmm").bitplane_vmm_s8
    if fn.argtypes is None:
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def expert_strides(m: int, k: int, n: int, w_strides) -> tuple:
    """The element strides between experts that the C entry takes, for codes
    ``[E, m, k]`` and an output ``[E, m, n]``, both contiguous, and weights
    of strides ``w_strides`` (expert, row, column).  Raises on weights the
    kernel cannot read: a column stride other than 1, rows shorter than
    ``n``, or experts that overlap (the stack is read where it lies, never
    copied).  A stack past 2^31 elements needs the 64-bit strides."""
    se, sk, sn = (int(v) for v in w_strides)
    if sn != 1 or sk < n or se < k * sk:
        raise ValueError(f"bitplane_vmm_experts_cuda: weight strides {tuple(w_strides)} "
                         f"of a [E, {k}, {n}] stack: the kernel reads row-major "
                         "experts with unit column stride that do not overlap")
    return m * k, se, m * n


def _launch(xq: torch.Tensor, wq: torch.Tensor, cfg: DAConfig, e: int, m: int,
            k: int, n: int, ldw: int, strides: tuple) -> tuple:
    """One launch over ``e`` experts; returns (y [e, m, n], CUDA launches)."""
    plan = bitplane_plan(m, k, n, build.sms(xq.device.index), e)
    y = torch.empty((e, m, n), dtype=torch.int32, device=xq.device)
    queued = ctypes.c_int(0)
    err = _lib()(xq.data_ptr(), wq.data_ptr(), y.data_ptr(), e, m, k, n, ldw,
                 *strides, cfg.x_bits, int(cfg.x_signed), plan.mt, plan.wm,
                 plan.k_per_split, torch.cuda.current_stream(xq.device).cuda_stream,
                 ctypes.byref(queued))
    build.check(err, "bitplane_vmm_s8")
    return y, queued.value


def _check(name: str, xq: torch.Tensor, wq: torch.Tensor, cfg: DAConfig,
           ndim: int) -> None:
    if xq.device.type != "cuda" or wq.device != xq.device:
        raise ValueError(f"{name}: xq and wq must be on one CUDA device")
    if xq.dtype != torch.int32 or wq.dtype != torch.int8:
        raise TypeError(f"{name} takes int32 activation codes and int8 weight "
                        f"codes, got {xq.dtype} and {wq.dtype}")
    if (xq.ndim != ndim or wq.ndim != ndim or xq.shape[-1] != wq.shape[-2]
            or xq.shape[:-2] != wq.shape[:-2]):
        raise ValueError(f"{name}: shapes {tuple(xq.shape)} @ {tuple(wq.shape)} "
                         "do not contract")
    if not 1 <= cfg.x_bits <= 8:
        raise ValueError(f"x_bits={cfg.x_bits} outside [1, 8]")
    if not xq.is_contiguous():
        raise ValueError(f"{name}: xq must be contiguous")


def _count(fn, cfg: DAConfig, queued: int) -> None:
    fn.launches += 1
    fn.launches_by_bits[cfg.x_bits] = fn.launches_by_bits.get(cfg.x_bits, 0) + 1
    fn.cuda_launches += queued


def bitplane_vmm_cuda(xq: torch.Tensor, wq: torch.Tensor,
                      cfg: DAConfig) -> torch.Tensor:
    """Launch the kernel: ``xq`` int32 [M, K] contiguous, ``wq`` int8 [K, N]
    with unit column stride (rows may be strided, e.g. a column slice of a
    merged q|k|v matrix).  Returns int32 [M, N]."""
    _check("bitplane_vmm_cuda", xq, wq, cfg, 2)
    if wq.stride(1) != 1 or wq.stride(0) < wq.shape[1]:
        raise ValueError("bitplane_vmm_cuda: wq must be row-major with unit "
                         "column stride")
    (m, k), n = xq.shape, wq.shape[1]
    y, queued = _launch(xq, wq, cfg, 1, m, k, n, wq.stride(0), (0, 0, 0))
    _count(bitplane_vmm_cuda, cfg, queued)
    return y[0]


def bitplane_vmm_experts_cuda(xq: torch.Tensor, wq: torch.Tensor,
                              cfg: DAConfig) -> torch.Tensor:
    """Launch the kernel once over a stack of experts: ``xq`` int32
    [E, M, K] contiguous, ``wq`` int8 [E, K, N] (:func:`expert_strides`
    says which layouts it reads).  Returns int32 [E, M, N], each expert's
    the same bits as :func:`bitplane_vmm_cuda` on its own matrix."""
    _check("bitplane_vmm_experts_cuda", xq, wq, cfg, 3)
    e, m, k = xq.shape
    n = wq.shape[2]
    strides = expert_strides(m, k, n, wq.stride())
    y, queued = _launch(xq, wq, cfg, e, m, k, n, wq.stride(1), strides)
    _count(bitplane_vmm_experts_cuda, cfg, queued)
    return y


#: calls in this process (in all and by x_bits), and the CUDA launches (the
#: kernel, and the zeroing of the output when K is split) the entry point
#: queued for them (reset by callers that count a run); each entry counts
#: its own calls, one per stack for the experts' entry
for _fn in (bitplane_vmm_cuda, bitplane_vmm_experts_cuda):
    _fn.launches = 0
    _fn.launches_by_bits = {}
    _fn.cuda_launches = 0
del _fn
