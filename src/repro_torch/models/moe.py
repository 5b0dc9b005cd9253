"""Mixture-of-Experts layer: top-k routing, capacity-based dispatch.

Expert counts that do not divide the reference's 16-way expert axis
(qwen2-moe's 60) are zero-padded to the next multiple with −inf router
logits: padded experts are never selected and their zero weights add
nothing, so the numerics are exact.

Dispatch is GShard/Switch-style with a static per-group capacity
``C = ceil(S·k/E · capacity_factor)`` (``moe_dropless``: C = S): one-hot
dispatch and combine tensors and per-expert products (``moe_impl="dense"``),
or a sort by expert id with one gather and one scatter-add
(``moe_impl="sorted"``).  The expert weights are stacked ``[E, K, N]``; a
frozen stack is a stacked-expert ``PackedWeights`` whose experts run the DA
datapath one by one (:func:`repro_torch.core.engine.dense`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.engine import dense
from repro_torch.launch.sharding import (
    block_of,
    constrain,
    on_rows,
    placements,
    pspec,
    rule_dims,
    shard_block,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, init_mlp, normal_init


def padded_experts(cfg: ModelConfig, model_axis: int = 16) -> int:
    """Experts padded up to a multiple of the reference's expert axis."""
    e = cfg.n_experts
    return -(-e // model_axis) * model_axis if e % model_axis else e


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """``router`` [d, E_pad] (float32, never frozen), the stacked experts
    ``w_gate`` / ``w_up`` [E_pad, d, f] and ``w_down`` [E_pad, f, d] with
    the padded experts zeroed, and a ``shared`` SwiGLU MLP of
    ``n_shared_experts · f`` when the config has shared experts."""
    dt = cfg.pdtype()
    d, f = cfg.d_model, cfg.moe_d_ff
    e_pad = padded_experts(cfg)
    s_in, s_out = 1.0 / (d ** 0.5), 1.0 / (f ** 0.5)

    def ew(shape, scale):
        """Drawn expert by expert (a float32 draw of the whole stack would
        take 4x its bf16 bytes); the padded experts are zero: exact no-ops."""
        if gen.device.type == "meta":
            return normal_init(gen, shape, scale, dt)
        w = torch.zeros(shape, dtype=dt, device=gen.device)
        for i in range(cfg.n_experts):
            w[i] = normal_init(gen, shape[1:], scale, dt)
        return w

    p = {"router": normal_init(gen, (d, e_pad), s_in, torch.float32),
         "w_gate": ew((e_pad, d, f), s_in),
         "w_up": ew((e_pad, d, f), s_in),
         "w_down": ew((e_pad, f, d), s_out)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d, cfg.n_shared_experts * f)
    return p


def capacity(cfg: ModelConfig, group: int) -> int:
    """Static per-group expert capacity: the group size under
    ``moe_dropless`` (exact), else GShard's capacity factor, which drops
    the overflow."""
    if cfg.moe_dropless:
        return group
    c = math.ceil(group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(1, min(c, group))


def _top_k(gates: torch.Tensor, k: int):
    """The ``k`` largest gates and their experts, ties to the lower index as
    ``jax.lax.top_k`` breaks them (a stable descending sort keeps equal
    values in index order; ``torch.topk`` promises no order on ties), with
    the weights renormalised to sum to 1."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = vals[..., :k], idx[..., :k]
    return topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9), topi


def _topk_dispatch(gates: torch.Tensor, k: int, cap: int, experts=None,
                   slots=None):
    """gates [G, S, E] → dispatch [G, S, E, C] (0/1) and combine [G, S, E, C]
    (weighted), slot-major priority within each group (every slot-0 choice
    first, in token order); capacity per (group, expert).  ``experts``
    ``(start, n)``: those experts' columns only (an expert's slots depend
    on its own choices alone); ``slots`` ``(start, n)``: those slots only,
    a slot at or past ``cap`` empty."""
    g, s, e = gates.shape
    topw, topi = _top_k(gates, k)                          # [G, S, k]
    onehot = F.one_hot(topi, e).to(torch.float32)          # [G, S, k, E]
    if experts is not None:
        onehot = onehot[..., experts[0]:experts[0] + experts[1]]
        e = experts[1]
    flat = onehot.permute(0, 2, 1, 3).reshape(g, k * s, e)
    pos = torch.cumsum(flat, dim=1) - flat                 # 0-based slot
    keep = (pos < cap) * flat
    first, n = slots if slots is not None else (0, cap)
    slot_ids = torch.arange(first, first + n, device=gates.device, dtype=pos.dtype)
    posc = (pos[..., None] == slot_ids).to(torch.float32) * keep[..., None]
    posc = posc.reshape(g, k, s, e, n)
    dispatch = posc.sum(dim=1)                             # [G, S, E, C]
    combine = torch.einsum("gksec,gsk->gsec", posc, topw)
    return dispatch, combine


def _sorted_dispatch(gates: torch.Tensor, k: int, cap: int):
    """Sort-based dispatch (per group): the S·k (token, expert) choices
    sorted by expert id, each choice's slot in its expert's buffer derived
    from the sort.  Returns (token_for_slot [G, E·C], indices into the
    group's tokens with S = none; weight_for_slot [G, E·C])."""
    g, s, e = gates.shape
    dev = gates.device
    topw, topi = _top_k(gates, k)
    flat_e, flat_w = topi.reshape(g, s * k), topw.reshape(g, s * k)
    flat_t = torch.arange(s, device=dev)[:, None].expand(s, k).reshape(s * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(flat_w, 1, order)
    st = flat_t[order]                                     # [G, S·k]
    counts = F.one_hot(flat_e, e).sum(dim=1)               # [G, E]
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(s * k, device=dev)[None] - torch.gather(starts, 1, se)
    slot = torch.where(pos < cap, se * cap + pos,
                       torch.full_like(se, e * cap))       # overflow → garbage
    token_for_slot = torch.full((g, e * cap + 1), s, dtype=torch.int64,
                                device=dev).scatter_(1, slot, st)
    weight_for_slot = torch.zeros((g, e * cap + 1), dtype=topw.dtype,
                                  device=dev).scatter_(1, slot, sw)
    return token_for_slot[:, :e * cap], weight_for_slot[:, :e * cap]


def _moe_experts(p, xe: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its capacity buffer, xe [.., E, C, D]."""
    gate = dense(xe, p["w_gate"])
    up = dense(xe, p["w_up"])
    return dense(F.silu(gate) * up, p["w_down"])


def moe_forward_sorted(p, xg: torch.Tensor, gates: torch.Tensor,
                       cfg: ModelConfig, cap: int) -> torch.Tensor:
    """Sorted-dispatch expert layer on grouped tokens xg [G, S, D]."""
    g, s, d = xg.shape
    e = gates.shape[-1]
    token_for_slot, weight_for_slot = on_rows(_sorted_dispatch, gates,
                                              cfg.top_k, cap)
    xg_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    rows = torch.arange(g, device=xg.device)[:, None]
    xe = xg_pad[rows, token_for_slot].reshape(g, e, cap, d)
    xe = constrain(xe, ("batch", "expert", None, "embed"))
    ye = constrain(_moe_experts(p, xe), ("batch", "expert", None, "embed"))
    yflat = ye.reshape(g, e * cap, d) * weight_for_slot[..., None].to(ye.dtype)
    y = ye.new_zeros((g, s + 1, d))
    y.index_put_((rows.expand_as(token_for_slot), token_for_slot), yflat,
                 accumulate=True)
    return y[:, :s]


def _dense_experts(p, xg, gates, k: int, cap: int, batch_rows: int = 1
                   ) -> torch.Tensor:
    """The one-hot dispatch (:func:`_topk_dispatch`), the experts and the
    combine: xg [G, S, D], gates [G, S, E] → [G, S, D].  On a mesh that
    shards the experts (``expert``), each rank routes its groups' tokens
    to its own experts only (its block of the dispatch's and combine's E,
    from the gates read whole), runs them (:func:`_moe_experts`) and
    combines their outputs into a Partial sum over the experts' mesh dims,
    reduced there, as the reference's expert-parallel layout places these
    einsums; the tokens and the gates are read whole there, so their
    gradients are Partial sums too (the gates' [G, S, E], not the
    combine's [G, S, E, C]).  Where there is one group (a decode step's
    ``batch_rows`` rows' tokens, row-major), which cannot shard on
    ``batch``, the batch axes take the capacity slots instead: each rank fills its
    block of its experts' slots (the capacity padded to a multiple of
    those axes; a slot past it stays empty), the output's Partial sum is
    reduce-scattered over them to the batch rows' blocks of tokens, and
    the output leaves with the tokens so split (``batch_rows`` must divide
    by those axes, else the slots stay whole).  Elsewhere, each rank's
    rows (:func:`on_rows`)."""
    g, e, dt = xg.shape[0], gates.shape[-1], xg.dtype
    mesh = xg.device_mesh if isinstance(xg, DTensor) else None
    rows = (None if mesh is None
            else placements(pspec(("batch",), (g,)), mesh))
    edims = ([] if rows is None else
             [i for i in rule_dims("expert") if rows[i] == Replicate()])
    if not edims or e % math.prod(mesh.size(i) for i in edims):
        dispatch, combine = on_rows(_topk_dispatch, gates, k, cap)
        xe = on_rows(torch.einsum, "gsec,gsd->gecd", dispatch.to(dt), xg)
        xe = constrain(xe, ("batch", "expert", None, "embed"))
        ye = constrain(_moe_experts(p, xe), ("batch", "expert", None, "embed"))
        return on_rows(torch.einsum, "gsec,gecd->gsd", combine.to(dt), ye)
    sdims = ([i for i in rule_dims("batch") if i not in edims and mesh.size(i) > 1]
             if g == 1 else [])
    ns = math.prod(mesh.size(i) for i in sdims)
    if batch_rows % ns:
        sdims, ns = [], 1
    slot_axis = "batch" if sdims else None
    on_e = lambda dim: [Shard(dim) if i in edims  # noqa: E731
                        else Shard(dim + 1) if i in sdims else pl
                        for i, pl in enumerate(rows)]
    block = shard_block(mesh, on_e(2), 2, e)[::-1]          # (start, n)
    slots = shard_block(mesh, [Shard(0) if i in sdims else Replicate()
                               for i in range(mesh.ndim)], 0,
                        -(-cap // ns) * ns)[::-1]
    partial_on = edims + sdims
    dl, cl = _topk_dispatch(block_of(gates, mesh, rows, partial_on=partial_on),
                            k, cap, experts=block, slots=slots)
    xe = torch.einsum("gsec,gsd->gecd", dl.to(dt),
                      block_of(xg, mesh, rows, partial_on=partial_on))
    axes = ("batch", "expert", slot_axis, "embed")
    xe = constrain(DTensor.from_local(xe, mesh, on_e(1), run_check=False), axes)
    ye = constrain(_moe_experts(p, xe), axes)
    y = torch.einsum("gsec,gecd->gsd", cl.to(dt), block_of(ye, mesh, on_e(1)))
    y = DTensor.from_local(y, mesh, [Partial() if i in partial_on else pl
                                     for i, pl in enumerate(rows)],
                           run_check=False)
    return constrain(y, ("batch", slot_axis, "embed"))


def _probs(logits: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Routing probabilities in float32 over the padded experts (a padded
    expert's logit is -inf: never chosen)."""
    pad_mask = torch.where(torch.arange(logits.shape[-1], device=logits.device)
                           < n_experts, 0.0, float("-inf"))
    return torch.softmax(logits + pad_mask, dim=-1)


def _gates(xg: torch.Tensor, router: torch.Tensor, n_experts: int) -> torch.Tensor:
    return _probs(xg.to(torch.float32) @ router, n_experts)


def _route(xg: torch.Tensor, router, n_experts: int) -> torch.Tensor:
    """gates [G, S, E] of the grouped tokens.  Where the groups do not
    shard on ``batch`` (a decode step's one group) but the experts do,
    each rank takes its experts' logits from its own block of the router's
    columns and the [G, S, E] logits are gathered, not the [D, E] router
    (the reference's placement of the router product); the tokens are read
    whole, so their gradient is a Partial sum there.  Elsewhere each
    rank's rows, the router whole (:func:`on_rows`)."""
    mesh = xg.device_mesh if isinstance(xg, DTensor) else None
    rows = (None if mesh is None
            else placements(pspec(("batch",), (xg.shape[0],)), mesh))
    edims = ([] if rows is None or any(pl != Replicate() for pl in rows)
             else rule_dims("expert"))
    if not edims or router.shape[1] % math.prod(mesh.size(i) for i in edims):
        return on_rows(_gates, xg, router, n_experts, whole=(1,))
    rep = [Replicate()] * mesh.ndim
    cols = [Shard(1) if i in edims else Replicate() for i in range(mesh.ndim)]
    logits = (block_of(xg, mesh, rep, partial_on=edims).to(torch.float32)
              @ block_of(router, mesh, cols))
    logits = DTensor.from_local(logits, mesh, [Shard(2) if i in edims else pl
                                               for i, pl in enumerate(rep)],
                                run_check=False).full_tensor()
    return DTensor.from_local(_probs(logits, n_experts), mesh, rep,
                              run_check=False)


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Grouped dispatch: the B·T tokens split into groups of
    ``moe_group_size``; routing in float32 over the padded experts."""
    b, t, d = x.shape
    n = b * t
    s = min(cfg.moe_group_size, n)
    g = -(-n // s)
    xf = x.reshape(n, d)
    if g * s > n:
        xf = F.pad(xf, (0, 0, 0, g * s - n))
    xg = constrain(xf.reshape(g, s, d), ("batch", None, "embed"))
    cap = capacity(cfg, s)

    gates = _route(xg, p["router"], cfg.n_experts)

    if cfg.moe_impl == "sorted":
        y = moe_forward_sorted(p, xg, gates, cfg, cap)
    else:
        y = _dense_experts(p, xg, gates, cfg.top_k, cap, b)
    y = y.reshape(g * s, d)
    if g * s > n:
        y = y[:n]
    y = y.reshape(b, t, d)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)
    return constrain(y, ("batch", "seq", "embed"))
