"""Device resolution for the port's entry points.

``init_model``, ``freeze_model`` and ``ServeEngine`` run on the card by
default; a caller that wants the CPU (the parity tests) says so.  There is
no silent fallback: asking for CUDA on a machine without a card raises.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
