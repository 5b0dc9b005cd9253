"""Int8 gradient compression with error feedback (distributed-optimization
trick for bandwidth-bound data-parallel all-reduce).

The DP all-reduce moves ``4·N`` bytes per step in fp32; int8 compression cuts
the payload 4× at the cost of quantization noise, which error feedback (EF)
re-injects next step so the *accumulated* update is unbiased in practice
[Seide et al. 2014; Karimireddy et al. 2019].  Thematically this mirrors the
paper: both replace exact wide arithmetic with narrow integer codes plus a
correction structure.

The arithmetic is the reference's (``repro/optim/compress.py``) op for op,
so the int8 codes equal its codes.  Every divide divides by a 0-dim tensor
on the operand's device: PyTorch's CUDA divide by a Python scalar
multiplies by the scalar's rounded reciprocal, which is not the quotient,
and would move codes at rounding edges.

:func:`allreduce_compressed` runs inside :func:`repro_torch.launch.mesh.shard_map_compat`
(or any code holding a mesh): ``pmax`` / ``psum`` over the axis's process
group.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.launch.mesh import pmax, psum
from repro_torch.tree import tree_map


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / v``, the quotient on every device."""
    return x / torch.full((), v, dtype=x.dtype, device=x.device)


def _codes(target: torch.Tensor, amax: torch.Tensor):
    scale = _div(torch.clamp(amax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(target / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_leaf(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (codes int8, scale f32)."""
    return _codes(g, torch.max(torch.abs(g)))


def decompress_leaf(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


class _Pair:
    """One leaf's two results, kept apart from the tree's own tuples."""

    def __init__(self, first, second):
        self.items = (first, second)


def _split(pairs):
    """A tree of :class:`_Pair` → the tree of firsts and of seconds."""
    def pick(node, i):
        if isinstance(node, _Pair):
            return node.items[i]
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(pick(v, i) for v in node))
        return type(node)(pick(v, i) for v in node)

    return pick(pairs, 0), pick(pairs, 1)


def compress_with_ef(grads, error):
    """(grads + error) → int8 codes + new error residual.  Returns
    ``(codes, new_error)``: ``codes`` a tree of ``(q, scale)`` pairs."""
    def one(g, e):
        target = g.to(torch.float32) + e
        q, s = compress_leaf(target)
        return _Pair((q, s), target - decompress_leaf(q, s))

    return _split(tree_map(one, grads, error))


def allreduce_compressed(grads, error, axis_name: str):
    """Compress+EF with a *shared* scale (``pmax`` of the local amax),
    ``psum`` of the int8 codes (as int32) — the wire payload is the codes
    plus one scalar per tensor.  The shared scale keeps the psum of codes
    exact w.r.t. the quantized values, so error feedback sees the true
    residual.  Returns ``(mean, new_error)``."""

    def one(g, e):
        target = g.to(torch.float32) + e
        q, scale = _codes(target, pmax(torch.max(torch.abs(target)), axis_name))
        new_e = target - q.to(torch.float32) * scale
        total = psum(q.to(torch.int32), axis_name)
        n = psum(torch.ones((), device=g.device), axis_name)
        return _Pair(total.to(torch.float32) * scale / n, new_e)

    return _split(tree_map(one, grads, error))
