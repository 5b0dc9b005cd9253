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


def _sorted_dispatch(gates: torch.Tensor, k: int, cap: int, experts=None,
                     slots=None):
    """Sort-based dispatch (per group): the S·k (token, expert) choices
    sorted by expert id, each choice's slot in its expert's buffer derived
    from the sort.  Returns (token_for_slot [G, E·C], indices into the
    group's tokens with S = none; weight_for_slot [G, E·C]).  ``experts``
    ``(start, n)``: those experts' slots only; ``slots`` ``(start, n)``:
    those slots of each expert only, a slot at or past ``cap`` empty
    (:func:`_topk_dispatch`'s blocks)."""
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
    token_for_slot, weight_for_slot = token_for_slot[:, :-1], weight_for_slot[:, :-1]
    if experts is None and slots is None:
        return token_for_slot, weight_for_slot
    e0, ne = experts if experts is not None else (0, e)
    c0, nc = slots if slots is not None else (0, cap)
    pad = max(c0 + nc - cap, 0)                            # slots past cap: empty
    tok = F.pad(token_for_slot.reshape(g, e, cap), (0, pad), value=s)
    wt = F.pad(weight_for_slot.reshape(g, e, cap), (0, pad))
    return (tok[:, e0:e0 + ne, c0:c0 + nc].reshape(g, ne * nc),
            wt[:, e0:e0 + ne, c0:c0 + nc].reshape(g, ne * nc))


def _moe_experts(p, xe: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its capacity buffer, xe [.., E, C, D]."""
    gate = dense(xe, p["w_gate"])
    up = dense(xe, p["w_up"])
    return dense(F.silu(gate) * up, p["w_down"])


def _combine_slots(ye: torch.Tensor, token_for_slot: torch.Tensor,
                   weight_for_slot: torch.Tensor, s: int) -> torch.Tensor:
    """The scatter-add combine: each slot's output ye [G, E, C, D], times
    its weight, added into its token's row of [G, S, D]."""
    g, d = ye.shape[0], ye.shape[-1]
    yflat = ye.reshape(g, -1, d) * weight_for_slot[..., None].to(ye.dtype)
    rows = torch.arange(g, device=ye.device)[:, None]
    y = ye.new_zeros((g, s + 1, d))
    y.index_put_((rows.expand_as(token_for_slot), token_for_slot), yflat,
                 accumulate=True)
    return y[:, :s]


def _gather_slots(xg: torch.Tensor, token_for_slot: torch.Tensor, e: int
                  ) -> torch.Tensor:
    """Each slot's token of xg [G, S, D] (a zero row for an empty slot):
    [G, e, C, D]."""
    g, _, d = xg.shape
    xg_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    rows = torch.arange(g, device=xg.device)[:, None]
    return xg_pad[rows, token_for_slot].reshape(g, e, -1, d)


class _Layout:
    """The expert-parallel layout of a dispatch on a mesh that shards the
    experts (``expert``) on dims where the groups are whole
    (:func:`_expert_layout`): ``rows`` the groups' placements, ``edims``
    the experts' mesh dims, ``sdims`` the batch dims that split one
    group's capacity slots, ``block`` and ``slots`` this rank's ``(start,
    n)`` of the experts and of each expert's slots.  ``tokens`` is this rank's block of the grouped
    tokens, read whole on ``partial_on`` (their gradient a Partial sum
    there); the router and the dispatch share it where they read the same
    block, so the two Partial sums of its gradient are reduced as one."""

    def __init__(self, xg, rows, edims, sdims, e: int, cap: int):
        self.mesh, self.rows, self.edims, self.sdims = xg.device_mesh, rows, edims, sdims
        ns = math.prod(self.mesh.size(i) for i in sdims)
        self.block = shard_block(self.mesh, self.on_e(2), 2, e)[::-1]
        self.slots = shard_block(self.mesh, [Shard(0) if i in sdims else Replicate()
                                             for i in range(self.mesh.ndim)], 0,
                                 -(-cap // ns) * ns)[::-1]
        self.partial_on = edims + sdims
        self.slot_axis = "batch" if sdims else None
        self.tokens = block_of(xg, self.mesh, rows, partial_on=self.partial_on)

    def on_e(self, dim: int) -> list:
        """The placements of a [G, E, C, ..] tensor with E at ``dim``."""
        return [Shard(dim) if i in self.edims
                else Shard(dim + 1) if i in self.sdims else pl
                for i, pl in enumerate(self.rows)]

    def combined(self, y: torch.Tensor) -> torch.Tensor:
        """A rank's [G, S, D] share of the combine as the Partial sum over
        ``partial_on``, reduced (reduce-scattered over the slots' dims) to
        the tokens' layout."""
        y = DTensor.from_local(y, self.mesh, [Partial() if i in self.partial_on
                                              else pl
                                              for i, pl in enumerate(self.rows)],
                               run_check=False)
        return constrain(y, ("batch", self.slot_axis, "embed"))


def _expert_layout(xg, e: int, cap: int, batch_rows: int):
    """The :class:`_Layout` of grouped tokens xg [G, S, D] on the active
    mesh rules for ``e`` experts of capacity ``cap``; None where there is
    none (no mesh, no expert dim free of the groups, or experts that do
    not divide it).  Where there is one group (a decode step's
    ``batch_rows`` rows' tokens, row-major), which cannot shard on
    ``batch``, the batch axes take each expert's capacity slots (padded
    to a multiple of them; a slot past it stays empty), if ``batch_rows``
    divides by them."""
    g = xg.shape[0]
    if not isinstance(xg, DTensor):
        return None
    mesh = xg.device_mesh
    rows = placements(pspec(("batch",), (g,)), mesh)
    edims = [i for i in rule_dims("expert") if rows[i] == Replicate()]
    if not edims or e % math.prod(mesh.size(i) for i in edims):
        return None
    sdims = ([i for i in rule_dims("batch") if i not in edims and mesh.size(i) > 1]
             if g == 1 else [])
    if batch_rows % math.prod(mesh.size(i) for i in sdims):
        sdims = []
    return _Layout(xg, rows, edims, sdims, e, cap)


def moe_forward_sorted(p, xg: torch.Tensor, gates: torch.Tensor,
                       cfg: ModelConfig, cap: int, lay=None) -> torch.Tensor:
    """Sorted-dispatch expert layer on grouped tokens xg [G, S, D].  With a
    :class:`_Layout`, the expert-parallel layout of :func:`_dense_experts`:
    each rank sorts its groups' choices (the gates read whole), gathers
    and runs only its own experts' slots (one group's slots split over
    the batch axes as there) and scatter-adds them into a [G, S, D]
    Partial sum over the experts' mesh dims, reduced (reduce-scattered
    where the tokens shard) to the tokens' layout; no rank gathers the
    experts' [G, E·C, D] output.  Elsewhere each rank's rows
    (:func:`on_rows`)."""
    s, e = xg.shape[1], gates.shape[-1]
    if lay is None:
        token_for_slot, weight_for_slot = on_rows(_sorted_dispatch, gates,
                                                  cfg.top_k, cap)
        xe = on_rows(_gather_slots, xg, token_for_slot, e)
        xe = constrain(xe, ("batch", "expert", None, "embed"))
        ye = constrain(_moe_experts(p, xe), ("batch", "expert", None, "embed"))
        return on_rows(_combine_slots, ye, token_for_slot, weight_for_slot, s)
    mesh = lay.mesh
    tl, wl = _sorted_dispatch(block_of(gates, mesh, lay.rows,
                                       partial_on=lay.partial_on),
                              cfg.top_k, cap, experts=lay.block, slots=lay.slots)
    xe = _gather_slots(lay.tokens, tl, lay.block[1])
    axes = ("batch", "expert", lay.slot_axis, "embed")
    xe = constrain(DTensor.from_local(xe, mesh, lay.on_e(1), run_check=False), axes)
    ye = constrain(_moe_experts(p, xe), axes)
    return lay.combined(_combine_slots(block_of(ye, mesh, lay.on_e(1)), tl, wl, s))


def _dense_experts(p, xg, gates, k: int, cap: int, lay=None) -> torch.Tensor:
    """The one-hot dispatch (:func:`_topk_dispatch`), the experts and the
    combine: xg [G, S, D], gates [G, S, E] → [G, S, D].  With a
    :class:`_Layout` (a mesh that shards the experts), each rank routes
    its groups' tokens to its own experts only (its block of the
    dispatch's and combine's E, from the gates read whole), runs them
    (:func:`_moe_experts`) and combines their outputs into a Partial sum
    over the experts' mesh dims, reduced there, as the reference's
    expert-parallel layout places these einsums; the tokens and the gates
    are read whole there, so their gradients are Partial sums too (the
    gates' [G, S, E], not the combine's [G, S, E, C]).  Where there is one
    group, each rank fills its block of its experts' slots, and the
    output's Partial sum is reduce-scattered over the slots' batch axes
    to the batch rows' blocks of tokens, leaving with the tokens so
    split.  Elsewhere, each rank's rows (:func:`on_rows`)."""
    dt = xg.dtype
    if lay is None:
        dispatch, combine = on_rows(_topk_dispatch, gates, k, cap)
        xe = on_rows(torch.einsum, "gsec,gsd->gecd", dispatch.to(dt), xg)
        xe = constrain(xe, ("batch", "expert", None, "embed"))
        ye = constrain(_moe_experts(p, xe), ("batch", "expert", None, "embed"))
        return on_rows(torch.einsum, "gsec,gecd->gsd", combine.to(dt), ye)
    mesh = lay.mesh
    dl, cl = _topk_dispatch(block_of(gates, mesh, lay.rows,
                                     partial_on=lay.partial_on),
                            k, cap, experts=lay.block, slots=lay.slots)
    xe = torch.einsum("gsec,gsd->gecd", dl.to(dt), lay.tokens)
    axes = ("batch", "expert", lay.slot_axis, "embed")
    xe = constrain(DTensor.from_local(xe, mesh, lay.on_e(1), run_check=False), axes)
    ye = constrain(_moe_experts(p, xe), axes)
    return lay.combined(torch.einsum("gsec,gecd->gsd", cl.to(dt),
                                     block_of(ye, mesh, lay.on_e(1))))


def _probs(logits: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Routing probabilities in float32 over the padded experts (a padded
    expert's logit is -inf: never chosen)."""
    pad_mask = torch.where(torch.arange(logits.shape[-1], device=logits.device)
                           < n_experts, 0.0, float("-inf"))
    return torch.softmax(logits + pad_mask, dim=-1)


def _gates(xg: torch.Tensor, router: torch.Tensor, n_experts: int) -> torch.Tensor:
    return _probs(xg.to(torch.float32) @ router, n_experts)


def _route(xg: torch.Tensor, router, n_experts: int, lay=None) -> torch.Tensor:
    """gates [G, S, E] of the grouped tokens.  With a :class:`_Layout` (the
    experts shard on mesh dims that the groups do not: a decode step's
    one group on every dim, training's groups on the batch axes and the
    experts on the model axis), each rank takes its experts' logits of its
    rows from its own block of the router's columns and the [G, S, E]
    logits are gathered over those dims, not the [D, E] router (the
    reference's placement of the router product): no rank computes
    another's logits.  The tokens are read whole there, so their gradient
    is a Partial sum over the experts' dims (the dispatch's block of them
    where it reads the same one), and the router's over the dims that
    split the rows.  Elsewhere each rank's rows, the router whole
    (:func:`on_rows`)."""
    if lay is None:
        return on_rows(_gates, xg, router, n_experts, whole=(1,))
    mesh, rows = lay.mesh, lay.rows
    tokens = (block_of(xg, mesh, rows, partial_on=lay.edims) if lay.sdims
              else lay.tokens)
    row_dims = [i for i, pl in enumerate(rows) if pl != Replicate()]
    cols = [Shard(1) if i in lay.edims else Replicate() for i in range(mesh.ndim)]
    logits = tokens.to(torch.float32) @ block_of(router, mesh, cols, partial_on=row_dims)
    logits = DTensor.from_local(logits, mesh, [Shard(2) if i in lay.edims else pl
                                               for i, pl in enumerate(rows)],
                                run_check=False).redistribute(mesh, rows)
    return DTensor.from_local(_probs(logits.to_local(), n_experts), mesh, rows,
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

    lay = _expert_layout(xg, p["router"].shape[1], cap, b)
    gates = _route(xg, p["router"], cfg.n_experts, lay)

    if cfg.moe_impl == "sorted":
        y = moe_forward_sorted(p, xg, gates, cfg, cap, lay)
    else:
        y = _dense_experts(p, xg, gates, cfg.top_k, cap, lay)
    y = y.reshape(g * s, d)
    if g * s > n:
        y = y[:n]
    y = y.reshape(b, t, d)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)
    return constrain(y, ("batch", "seq", "embed"))
