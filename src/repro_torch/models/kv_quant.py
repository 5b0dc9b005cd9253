"""KV-page quantization numerics shared by every paged-attention reader.

Pages hold int8 codes (or two int4 nibbles packed per byte along head_dim)
and one float16 dequantization scale per (page slot, kv head), riding inside
the page allocation (``[n_pages, ps, kv, 1]`` beside ``[n_pages, ps, kv,
hd]``).  Scales are write-once: a row is quantized exactly once with its own
absmax.  Dequantization is the one elementwise formula
``codes.to(compute) * scale.to(compute)``.
"""
from __future__ import annotations

import torch

#: Recognized KV page dtypes; "fp16" keeps pages at the compute dtype.
KV_DTYPES = ("fp16", "int8", "int4")

#: Symmetric ranges; int4 uses [-7, 7] so the packed nibble sign-extends.
KV_QMAX = {"int8": 127.0, "int4": 7.0}

#: Dtype of the in-page scales (2 bytes per (slot, head)).
KV_SCALE_DTYPE = torch.float16


def kv_format(k_pool: torch.Tensor, k_scale, head_dim: int) -> str:
    """A pool's KV dtype from its arrays alone: ``"fp"``, ``"int8"`` (codes
    at full head_dim) or ``"int4"`` (two nibbles per byte)."""
    if k_scale is None:
        return "fp"
    hd_p = k_pool.shape[-1]
    if hd_p == head_dim:
        return "int8"
    if 2 * hd_p == head_dim:
        return "int4"
    raise ValueError(
        f"quantized KV pool with head axis {hd_p} matches neither int8 "
        f"(head_dim={head_dim}) nor packed int4 (head_dim//2={head_dim // 2})")


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """Pack int8-held nibbles [-7, 7] pairwise along the last axis: element
    ``2i`` in the low nibble, ``2i+1`` in the high nibble of one byte."""
    lo = torch.bitwise_and(codes[..., 0::2].to(torch.int32), 0xF)
    hi = torch.bitwise_left_shift(
        torch.bitwise_and(codes[..., 1::2].to(torch.int32), 0xF), 4)
    return torch.bitwise_or(lo, hi).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` with sign-extending shifts."""
    x = packed.to(torch.int32)
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(x, 28), 28)
    hi = torch.bitwise_right_shift(torch.bitwise_left_shift(x, 24), 28)
    both = torch.stack([lo, hi], dim=-1)
    return both.reshape(*packed.shape[:-1], 2 * packed.shape[-1]).to(torch.int8)


def quantize_kv(x: torch.Tensor, kv_dtype: str):
    """Quantize fresh KV rows ``[..., kv, hd]`` → ``(codes, scale)``.

    The absmax scale is rounded to the storage dtype first and the codes are
    quantized against the rounded value; all-zero rows get scale 0, codes 0.
    """
    qmax = KV_QMAX[kv_dtype]
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = (amax / qmax).to(KV_SCALE_DTYPE)
    s32 = scale.to(torch.float32)
    pos = s32 > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, s32, torch.ones_like(s32)),
                      torch.zeros_like(s32))
    codes = torch.clamp(torch.round(xf * inv), -qmax, qmax).to(torch.int8)
    if kv_dtype == "int4":
        codes = pack_int4(codes)
    return codes, scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, kv_dtype: str,
                  out_dtype) -> torch.Tensor:
    """``codes [..., kv, hd(/2)]`` + ``scale [..., kv, 1]`` → fp rows."""
    if kv_dtype == "int4":
        codes = unpack_int4(codes)
    return codes.to(out_dtype) * scale.to(out_dtype)
