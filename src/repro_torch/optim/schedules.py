"""LR schedules (pure functions of the step, elastic-restart friendly)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, warmup: int, total: int, floor: float = 0.1) -> torch.Tensor:
    """Returns a float32 multiplier in [floor, 1].  ``step`` may be an int or
    a tensor; a tensor's multiplier is formed on its device, with no host
    sync."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(1, warmup), max=1.0)
    prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return warm * (floor + (1.0 - floor) * cos)


def constant(step, value: float = 1.0):
    del step
    return value
