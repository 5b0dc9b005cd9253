"""Symmetric uniform quantization (paper §II-C: post-training symmetric INT8).

Weights: per-output-channel symmetric int8.  Activations: signed codes with a
dynamic per-token scale (the LM serving path), or unsigned codes (the image
path).  Codes are int32 plus a float32 scale.  The arithmetic mirrors the
reference op for op: ``scale = max(amax, eps) / qmax`` in the input dtype,
then ``round(x / scale)`` (a division, not a reciprocal multiply;
``torch.round`` rounds half to even).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class QTensor:
    """An integer-quantized tensor: values ≈ q * scale."""

    q: torch.Tensor       # integer codes, int32
    scale: torch.Tensor   # broadcastable float32 scale
    bits: int
    signed: bool


def _symmetric(x: torch.Tensor, amax: torch.Tensor, bits: int,
               eps: float) -> QTensor:
    qmax = (1 << (bits - 1)) - 1
    # eps and qmax act in x's dtype (a bf16 weight gets a bf16 scale, cast
    # to f32 only after the codes are formed)
    scale = torch.clamp(amax, min=eps) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax).to(torch.int32)
    return QTensor(q=q, scale=scale.to(torch.float32), bits=bits, signed=True)


def quantize_weights(w: torch.Tensor, bits: int = 8, axis: Optional[int] = 0,
                     eps: float = 1e-8) -> QTensor:
    """Symmetric per-channel weight quantization; ``axis`` is the contraction
    axis reduced for the per-channel max (``None`` → per-tensor)."""
    if axis is None:
        amax = torch.amax(torch.abs(w))
    else:
        amax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    return _symmetric(w, amax, bits, eps)


def quantize_acts_signed(x: torch.Tensor, bits: int = 8,
                         eps: float = 1e-8) -> QTensor:
    """Dynamic per-row (per-token) symmetric activation quantization."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    return _symmetric(x, amax, bits, eps)


def quantize_acts_unsigned(x: torch.Tensor, bits: int = 8,
                           eps: float = 1e-8) -> QTensor:
    """Unsigned per-row activation quantization (e.g. [0, 255] grayscale
    inputs, the paper's CONV1 image path)."""
    qmax = (1 << bits) - 1
    amax = torch.amax(x, dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=eps) / qmax
    q = torch.clamp(torch.round(x / scale), 0, qmax).to(torch.int32)
    return QTensor(q=q, scale=scale.to(torch.float32), bits=bits, signed=False)


def int_matmul(xq: QTensor, wq: QTensor) -> torch.Tensor:
    """Exact integer reference matmul; dequantized float32 output.  The
    int32 accumulation is formed in int64 on the CPU and in float64 on CUDA
    (which has no integer matmul; exact below 2^53)."""
    dt = torch.float64 if xq.q.device.type == "cuda" else torch.int64
    acc = (xq.q.to(dt) @ wq.q.to(dt)).to(torch.int32)
    return acc.to(torch.float32) * xq.scale * wq.scale
