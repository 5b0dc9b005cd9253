"""AdamW with fp32 master weights, global-norm clipping, and a NaN guard.

Params may live in bf16 (the model's param_dtype); the optimizer keeps fp32
master copies and moments, computes the update in fp32, and casts back — the
standard mixed-precision training recipe. ``update`` returns a ``skipped``
flag instead of raising when gradients are non-finite (fault tolerance: a bad
batch must not kill a long run).

The arithmetic is the reference's (``repro/optim/adamw.py``) op for op.  The
state's tensors are updated in place (the reference donates its buffers to
the jitted step; here the master weights, moments and params are written
where they lie), and the NaN guard is a ``torch.where`` on the device: on a
skipped step every entry keeps its value and ``step`` does not advance.
Nothing in :func:`update` waits for the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 scalar: updates applied (skipped ones not)
    master: Any          # fp32 master params
    mu: Any
    nu: Any


def init(params) -> AdamWState:
    """Fresh state on the params' device: float32 copies of the params and
    zero moments (placed as the params are, on a mesh)."""
    first = leaves(params)[0]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        master=tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
        mu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
        nu=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params),
    )


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig,
           lr_scale) -> Tuple[Any, AdamWState, dict]:
    """One clipped AdamW step from ``grads`` (a tree like ``params``, any
    float dtype).  Writes the new master weights, moments and params into
    their tensors and returns ``(params, state, metrics)``: ``grad_norm``,
    ``skipped`` (1.0 when the gradients were not finite) and ``lr``, each a
    float32 scalar on the device."""
    gnorm = global_norm(grads)
    finite = torch.isfinite(gnorm)
    scale = torch.where(finite, torch.clamp(cfg.clip_norm / (gnorm + 1e-9),
                                            max=1.0), 0.0)
    step = state.step + finite.to(torch.int32)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)
    for g, m, v, w, p in zip(leaves(grads), leaves(state.mu), leaves(state.nu),
                             leaves(state.master), leaves(params)):
        g = g.to(torch.float32) * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        del g
        delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
        w_new = w - lr * (delta + cfg.weight_decay * w)
        del delta
        # NaN guard: on a skipped step every state entry is unchanged
        m.copy_(torch.where(finite, m_new, m))
        v.copy_(torch.where(finite, v_new, v))
        w.copy_(torch.where(finite, w_new, w))
        p.copy_(w)
    metrics = {"grad_norm": gnorm, "skipped": (~finite).to(torch.float32),
               "lr": lr}
    return params, state._replace(step=step), metrics
