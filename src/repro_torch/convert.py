"""Carry parameters between the reference's layout and the port's.

:func:`params_from_jax` takes the reference's params as nested dicts of
arrays (numpy, or CPU tensors as :func:`repro_torch.checkpoint.ckpt.load_tree`
returns them) — float params or frozen ones, where a packed leaf is a dict
(or object) with ``wq`` / ``w_scale`` / ``luts`` and optionally ``mode`` and
``cfg`` — and returns the port's params, so both packages compute the same
function.  The reference stacks each layer position over periods
(``periods/pos_j`` leaves ``[n_periods, ...]``, LUTs ``[n_periods, G, 2^L,
N]``); the port keeps one dict per layer, so that axis is split here (the
port's ``dense`` would read a 3-D ``wq`` as stacked experts).
:func:`params_to_ref` stacks the layers back, so the reference can read what
the port writes.  Both walk whatever leaves the tree holds, so every dense
variant crosses as is: q/k/v biases, LayerNorm biases, MLPs without
``w_gate`` and trees without an ``embed`` table (embedding-input models).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.da import DAConfig
from repro_torch.core.engine import PackedWeights


def _field(node, name, default=None):
    if isinstance(node, dict):
        return node.get(name, default)
    return getattr(node, name, default)


def _is_packed(node) -> bool:
    return _field(node, "w_scale") is not None and _field(node, "wq") is not None


def _arr(a):
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy (incl. ml_dtypes bfloat16) or a tensor → torch tensor, copied."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True).contiguous()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16), copy=True))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _packed(node, device) -> PackedWeights:
    cfg = _field(node, "cfg")
    if cfg is None:
        cfg = DAConfig(x_signed=True)
    elif not isinstance(cfg, DAConfig):
        fields = [f.name for f in dataclasses.fields(DAConfig)]
        cfg = DAConfig(**{f: _field(cfg, f) for f in fields})
    luts = _field(node, "luts")
    return PackedWeights(
        wq=to_tensor(_field(node, "wq"), device),
        w_scale=to_tensor(_field(node, "w_scale"), device).to(torch.float32),
        luts=None if luts is None else to_tensor(luts, device),
        cfg=cfg, mode=_field(node, "mode", "auto"))


def _convert(node, device):
    if _is_packed(node):
        return _packed(node, device)
    if isinstance(node, dict):
        return {k: _convert(v, device) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_convert(v, device) for v in node]
    return to_tensor(node, device)


def _index(node, i: int):
    """Slice period ``i`` off every leaf (packed leaves field by field)."""
    if _is_packed(node):
        luts = _field(node, "luts")
        return {"wq": _arr(_field(node, "wq"))[i],
                "w_scale": _arr(_field(node, "w_scale"))[i],
                "luts": None if luts is None else _arr(luts)[i],
                "cfg": _field(node, "cfg"), "mode": _field(node, "mode", "auto")}
    if isinstance(node, dict):
        return {k: _index(v, i) for k, v in node.items()}
    return _arr(node)[i]


def _n_periods(node) -> int:
    if _is_packed(node):
        return _arr(_field(node, "wq")).shape[0]
    if isinstance(node, dict):
        return _n_periods(next(iter(node.values())))
    return _arr(node).shape[0]


def params_from_jax(tree, device="cpu"):
    """Reference params (nested dicts of arrays) → port params."""
    periods = tree["periods"]
    period = len(periods)
    n = _n_periods(periods["pos_0"])
    blocks = [None] * (n * period)
    for key, sub in periods.items():
        pos = int(key.split("_")[1])
        for p in range(n):
            blocks[p * period + pos] = _convert(_index(sub, p), device)
    out = {k: _convert(v, device) for k, v in tree.items() if k != "periods"}
    out["blocks"] = blocks
    return out


def _stack(nodes):
    """One leaf stacked over layers (packed leaves field by field; they must
    agree on DAConfig, mode and whether they carry LUTs)."""
    first = nodes[0]
    if isinstance(first, PackedWeights):
        if any((p.cfg, p.mode, p.has_luts) != (first.cfg, first.mode,
                                                first.has_luts) for p in nodes):
            raise ValueError("layers of one position disagree on DAConfig, "
                             "mode or LUTs; the reference stacks them as one "
                             "PackedWeights")
        luts = (torch.stack([p.luts for p in nodes]) if first.has_luts
                else None)
        return PackedWeights(wq=torch.stack([p.wq for p in nodes]),
                             w_scale=torch.stack([p.w_scale for p in nodes]),
                             luts=luts, cfg=first.cfg, mode=first.mode)
    if isinstance(first, dict):
        return {k: _stack([n[k] for n in nodes]) for k in first}
    return torch.stack(nodes)


def params_to_ref(params, period: int = 1):
    """Port params → the reference's layout: ``blocks[p * period + pos]``
    stacked into ``periods/pos_<pos>`` leaves ``[n_periods, ...]``."""
    blocks = params["blocks"]
    if len(blocks) % period:
        raise ValueError(f"{len(blocks)} layers are not whole periods of "
                         f"{period}")
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["periods"] = {f"pos_{pos}": _stack(blocks[pos::period])
                      for pos in range(period)}
    return out
