"""GPipe-style pipeline parallelism over a mesh axis (local code over the
axis's process group, point-to-point hops).

Each stage holds ``n_layers / n_stages`` layers and microbatches stream
through with one hop per tick.  The schedule is the reference's
(``repro/train/pipeline.py``): at tick t, stage s runs microbatch t − s (if
in range), then the activations hop one stage to the right; the last stage
records its outputs and a psum replicates them.  Bubble = (S−1)/(M+S−1).

The reference gets its backward from JAX (``lax.scan`` + ``ppermute``
transpose).  Here :class:`_GPipe` is one autograd function whose backward
runs the same schedule in reverse: at tick t (last to first) every stage
receives the gradient of its tick-t output from the stage to its right,
applies its stage's vector-Jacobian product if it was active (saved from
the forward), and sends the gradient of its input left.  Every stage takes
part in every hop, forward and backward, so the exchanges never wait on a
stage that has nothing to send: it sends zeros.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.launch import mesh as M
from repro_torch.launch.sharding import P
from repro_torch.tree import leaves, tree_map


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, treedef_params, group, n_stages, s_idx,
                x_micro, *flat):
        m = x_micro.shape[0]
        ticks = m + n_stages - 1
        right = tuple((i, (i + 1) % n_stages) for i in range(n_stages))
        buf = torch.zeros_like(x_micro[0])
        outs = [torch.zeros_like(x_micro[0]) for _ in range(m)]
        saved = {}     # tick → (stage input, param aliases, stage output)
        for t in range(ticks):
            mb = t - s_idx
            active = 0 <= mb < m
            if active:
                h = x_micro[mb] if s_idx == 0 else buf
                with torch.enable_grad():
                    hx = h.detach().requires_grad_(x_micro.requires_grad
                                                   or s_idx > 0)
                    ps = [p.detach().requires_grad_(p.requires_grad)
                          for p in flat]
                    it = iter(ps)
                    y = stage_fn(tree_map(lambda _: next(it), treedef_params), hx)
                saved[t] = (hx, ps, y)
                y = y.detach()
                if s_idx == n_stages - 1:
                    outs[mb] = y
            else:
                y = buf
            buf = M._permute(y, group, right)
        ctx.stage_fn, ctx.group = stage_fn, group
        ctx.n_stages, ctx.s_idx, ctx.m = n_stages, s_idx, m
        ctx.saved_ticks = saved
        ctx.x_shape = x_micro.shape
        ctx.x_needs = x_micro.requires_grad
        ctx.n_flat = len(flat)
        out = torch.stack(outs)
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g_out):
        n_stages, s_idx, m = ctx.n_stages, ctx.s_idx, ctx.m
        ticks = m + n_stages - 1
        left = tuple(((i + 1) % n_stages, i) for i in range(n_stages))
        g_x = torch.zeros(ctx.x_shape, dtype=g_out.dtype, device=g_out.device)
        g_params = [None] * ctx.n_flat
        g_next = torch.zeros_like(g_out[0])   # d loss / d (buffer after tick)
        for t in reversed(range(ticks)):
            g_y = M._permute(g_next, ctx.group, left)
            mb = t - s_idx
            if t in ctx.saved_ticks:
                if s_idx == n_stages - 1:
                    g_y = g_y + g_out[mb]
                hx, ps, y = ctx.saved_ticks.pop(t)
                req = [w for w in [hx] + ps if w.requires_grad]
                grads = (torch.autograd.grad(y, req, g_y, allow_unused=True)
                         if req else ())
                got = {id(w): g for w, g in zip(req, grads)}
                g_h = got.get(id(hx))
                for i, p in enumerate(ps):
                    g = got.get(id(p))
                    if g is not None:
                        g_params[i] = g if g_params[i] is None else g_params[i] + g
                g_h = torch.zeros_like(g_y) if g_h is None else g_h
                if s_idx == 0:
                    g_x[mb] += g_h
                    g_next = torch.zeros_like(g_y)
                else:
                    g_next = g_h
            else:
                g_next = g_y      # an idle stage passes its buffer on
        return ((None, None, None, None, None, g_x if ctx.x_needs else None)
                + tuple(g_params))


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x_micro: torch.Tensor, axis: str,
                     n_stages: int = None, mesh=None) -> torch.Tensor:
    """Run on each rank of ``axis`` (inside :func:`repro_torch.launch.mesh.shard_map_compat`
    or with ``mesh``).  stage_params: this stage's layer stack; x_micro:
    [M, mb, ...] microbatches (the same on every stage; only stage 0's
    input matters).  Returns the last stage's outputs [M, mb, ...] on
    every stage; differentiable in ``x_micro`` and the stage's params."""
    s_idx = M.axis_index(axis, mesh)
    if n_stages is None:
        n_stages = M.axis_size(axis, mesh)
    group = M.current_mesh(mesh).get_group(axis)
    flat = leaves(stage_params)
    return _GPipe.apply(stage_fn, stage_params, group, n_stages, s_idx,
                        x_micro, *flat)


def make_pipelined_apply(mesh, axis: str, stage_fn: Callable,
                         n_microbatches: int) -> Callable:
    """Wrap a per-stage apply into a pipelined whole-model apply.

    stage_params must be sharded stage-major on ``axis`` (leading dim =
    n_stages: a DTensor ``Shard(0)`` there, or the full stack, the same on
    every rank).  Inputs [B, ...] are split into microbatches; the result
    is a replicated DTensor [B, ...]."""

    def apply(stage_params, x):
        b = x.shape[0]
        mb = b // n_microbatches
        x_micro = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))

        def inner(sp, xm):
            sp = tree_map(lambda a: a[0], sp)  # this stage's slice
            return pipeline_forward(stage_fn, sp, xm, axis,
                                    n_stages=M.axis_size(axis, mesh))

        shard = M.shard_map_compat(inner, mesh=mesh, in_specs=(P(axis), P()),
                                   out_specs=P(), check=False)
        y_micro = shard(stage_params, x_micro)
        return y_micro.reshape((b,) + tuple(y_micro.shape[2:]))

    return apply
