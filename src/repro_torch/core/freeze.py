"""Model-level DA freeze with one pinned backend mode.

Walks a params tree and packs every weight-matrix leaf (``DA_LEAF_NAMES``,
outside ``SKIP_CONTEXT``) under the pinned mode; norms, biases and the
embedding table stay float.  The per-layer planner, the hardware cost model
and artifact save/load arrive with later slices.

The q/k/v codes of each attention layer are laid out side by side in one
``[K, Nq + Nk + Nv]`` buffer (each pack's ``wq`` is a column slice of it), so
the fused projection reads the three matrices in one kernel pass without
concatenating them every step.
"""
from __future__ import annotations

import torch

from repro_torch.core.da import DAConfig
from repro_torch.core.engine import (
    PackedWeights,
    canonical_mode,
    get_backend,
    pack_weights,
)
from repro_torch.device import resolve_device

#: Param leaf names that are weight matrices ([in, out]).
DA_LEAF_NAMES = {
    "wq", "wk", "wv", "wo",          # attention projections
    "w_up", "w_gate", "w_down",      # MLP
    "in_proj", "out_proj",           # mamba projections
    "w",                             # lm head
}
SKIP_CONTEXT = {"router", "conv_w", "table"}


def _is_da_leaf(path, leaf) -> bool:
    if not path or any(n in SKIP_CONTEXT for n in path):
        return False
    return (path[-1] in DA_LEAF_NAMES and isinstance(leaf, torch.Tensor)
            and leaf.ndim >= 2)


def _colocate_qkv(node: dict) -> None:
    """Give a mixer's packed q/k/v codes one shared buffer (in place)."""
    packs = [node.get(n) for n in ("wq", "wk", "wv")]
    if not all(isinstance(p, PackedWeights) for p in packs):
        return
    merged = torch.cat([p.wq for p in packs], dim=1)
    off = 0
    for name, p in zip(("wq", "wk", "wv"), packs):
        node[name] = PackedWeights(wq=merged[:, off:off + p.n], w_scale=p.w_scale,
                                   luts=p.luts, cfg=p.cfg, mode=p.mode)
        off += p.n


def freeze_model(params, da_cfg: DAConfig = DAConfig(x_signed=True),
                 mode: str = "pallas_bitplane", device="cuda"):
    """Pack every weight-matrix leaf of ``params`` on ``device`` under the
    registered backend ``mode``; returns the packed tree (other leaves are
    moved to ``device`` unchanged)."""
    dev = resolve_device(device)
    mode = canonical_mode(mode)
    if mode == "auto":
        raise NotImplementedError(
            "freeze_model(mode='auto') needs the per-layer planner, which is "
            "not ported yet; pin a backend (e.g. 'pallas_bitplane')")
    get_backend(mode)

    def walk(path, node):
        if isinstance(node, dict):
            out = {k: walk(path + (str(k),), v) for k, v in node.items()}
            _colocate_qkv(out)
            return out
        if isinstance(node, (list, tuple)):
            return [walk(path + (str(i),), v) for i, v in enumerate(node)]
        if isinstance(node, PackedWeights):
            return node  # already frozen: never re-packed
        if _is_da_leaf(path, node):
            return pack_weights(node.to(dev), da_cfg, mode=mode)
        return node.to(dev) if isinstance(node, torch.Tensor) else node

    return walk((), params)


def is_frozen(params) -> bool:
    """Does the tree carry PackedWeights leaves?"""
    if isinstance(params, PackedWeights):
        return True
    if isinstance(params, dict):
        return any(is_frozen(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return any(is_frozen(v) for v in params)
    return False
