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

from repro_torch.core.engine import dense
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


def _topk_dispatch(gates: torch.Tensor, k: int, cap: int):
    """gates [G, S, E] → dispatch [G, S, E, C] (0/1) and combine [G, S, E, C]
    (weighted), slot-major priority within each group (every slot-0 choice
    first, in token order); capacity per (group, expert)."""
    g, s, e = gates.shape
    topw, topi = _top_k(gates, k)                          # [G, S, k]
    onehot = F.one_hot(topi, e).to(torch.float32)          # [G, S, k, E]
    flat = onehot.permute(0, 2, 1, 3).reshape(g, k * s, e)
    pos = torch.cumsum(flat, dim=1) - flat                 # 0-based slot
    keep = (pos < cap) * flat
    slots = torch.arange(cap, device=gates.device, dtype=pos.dtype)
    posc = (pos[..., None] == slots).to(torch.float32) * keep[..., None]
    posc = posc.reshape(g, k, s, e, cap)
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
    token_for_slot, weight_for_slot = _sorted_dispatch(gates, cfg.top_k, cap)
    xg_pad = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)
    rows = torch.arange(g, device=xg.device)[:, None]
    xe = xg_pad[rows, token_for_slot].reshape(g, e, cap, d)
    ye = _moe_experts(p, xe)
    yflat = ye.reshape(g, e * cap, d) * weight_for_slot[..., None].to(ye.dtype)
    y = ye.new_zeros((g, s + 1, d))
    y.index_put_((rows.expand_as(token_for_slot), token_for_slot), yflat,
                 accumulate=True)
    return y[:, :s]


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
    xg = xf.reshape(g, s, d)
    cap = capacity(cfg, s)

    logits = xg.to(torch.float32) @ p["router"]
    e_pad = p["router"].shape[1]
    pad_mask = torch.where(torch.arange(e_pad, device=x.device) < cfg.n_experts,
                           0.0, float("-inf"))
    gates = torch.softmax(logits + pad_mask, dim=-1)

    if cfg.moe_impl == "sorted":
        y = moe_forward_sorted(p, xg, gates, cfg, cap)
    else:
        dispatch, combine = _topk_dispatch(gates, cfg.top_k, cap)
        xe = torch.einsum("gsec,gsd->gecd", dispatch.to(x.dtype), xg)
        ye = _moe_experts(p, xe)
        y = torch.einsum("gsec,gecd->gsd", combine.to(x.dtype), ye)
    y = y.reshape(g * s, d)[:n].reshape(b, t, d)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], x, cfg)
    return y
