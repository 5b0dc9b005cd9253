"""Model-level DA freeze with one pinned backend mode, and DA artifacts on disk.

:func:`freeze_model` walks a params tree and packs every weight-matrix leaf
(``DA_LEAF_NAMES``, outside ``SKIP_CONTEXT``) under the pinned mode, building
LUTs for every leaf when that mode reads them; norms, biases and the
embedding table stay float.  The per-layer planner (``mode="auto"``) arrives
with a later slice.  :func:`da_memory_report` prices the packed layers
(storage and the :mod:`repro_torch.obs.hwcost` table), keyed by the
reference's leaf paths.

The q/k/v codes of each attention layer are laid out side by side in one
``[K, Nq + Nk + Nv]`` buffer (each pack's ``wq`` is a column slice of it), so
the fused projection reads the three matrices in one kernel pass without
concatenating them every step; each pack keeps its own LUTs.

:func:`save_artifact` / :func:`load_artifact` read and write the reference's
artifact (``arrays.npz`` + ``manifest.json``): its layout stacks each layer
position over periods (``periods/pos_j/...``), which the port splits into
``blocks`` when reading and stacks back when writing, so the two packages
boot each other's artifacts.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.convert import params_from_jax, params_to_ref
from repro_torch.core.da import DAConfig
from repro_torch.core.engine import (
    PackedWeights,
    canonical_mode,
    get_backend,
    pack_weights,
    registered_backends,
    registry_fingerprint,
)
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs.hwcost import HardwareCostModel

#: Artifact schema (the reference's): bumped on any layout/manifest change.
ARTIFACT_VERSION = 1
ARTIFACT_FORMAT = "da-artifact"

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
        node[name] = dataclasses.replace(p, wq=merged[:, off:off + p.n])
        off += p.n


def _map_dicts(tree, fn):
    """Apply ``fn`` in place to every dict of ``tree``, leaves first."""
    if isinstance(tree, dict):
        for v in tree.values():
            _map_dicts(v, fn)
        fn(tree)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _map_dicts(v, fn)
    return tree


def freeze_model(params, da_cfg: DAConfig = DAConfig(x_signed=True),
                 mode: str = "pallas_bitplane", device="cuda"):
    """Pack every weight-matrix leaf of ``params`` on ``device`` under the
    registered backend ``mode`` (with LUTs when ``mode`` reads them); returns
    the packed tree (other leaves are moved to ``device`` unchanged)."""
    dev = resolve_device(device)
    mode = canonical_mode(mode)
    if mode == "auto":
        raise NotImplementedError(
            "freeze_model(mode='auto') needs the per-layer planner, which is "
            "not ported yet; pin a backend (e.g. 'pallas_bitplane')")
    get_backend(mode)

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (str(k),), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(path + (str(i),), v) for i, v in enumerate(node)]
        if isinstance(node, PackedWeights):
            return node  # already frozen: never re-packed
        if _is_da_leaf(path, node):
            return pack_weights(node.to(dev), da_cfg, mode=mode)
        return node.to(dev) if isinstance(node, torch.Tensor) else node

    return _map_dicts(walk((), params), _colocate_qkv)


def is_frozen(params) -> bool:
    """Does the tree carry PackedWeights leaves?"""
    return next(packed_leaves(params), None) is not None


# ---------------------------------------------------------------------------
# Plan schema and the artifact
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's freeze decision (the reference's schema).

    mode:       concrete backend name this layer serves under.
    group_size: rows per PMA for this layer (LUT addressability).
    with_luts:  materialize the weight-sum LUTs (the PMA write) or not.
    k, n:       the weight matrix shape the plan was made for.
    source:     "measured", "analytic", "pinned" or "stale" (a mode this
                build does not register, demoted to "auto").
    est_cost:   the winning backend's estimated cost, NaN when pinned.
    kv_dtype:   KV-page precision of this layer's cache, on the wk/wv mixer
                entries only ("fp16" | "int8" | "int4"); None elsewhere.
    """

    mode: str
    group_size: int
    with_luts: bool
    k: int
    n: int
    source: str = "analytic"
    est_cost: float = dataclasses.field(default=float("nan"), compare=False)
    kv_dtype: Optional[str] = None

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        if not math.isfinite(d["est_cost"]):
            d["est_cost"] = None  # a bare NaN literal breaks strict JSON
        return d

    @classmethod
    def from_json(cls, d: dict) -> "LayerPlan":
        d = dict(d)
        if d.get("est_cost") is None:
            d["est_cost"] = float("nan")
        return cls(**d)


@dataclasses.dataclass
class DAArtifact:
    """The frozen, servable model: packed params + the plan that shaped them.

    params:    the port's params (``blocks`` list) with PackedWeights leaves.
    plan:      reference leaf path (``periods/pos_0/mixer/wq``) → LayerPlan.
    da_cfg:    base DAConfig the model was frozen under.
    model_cfg: the ModelConfig to rebuild the serving graph, or None.
    hwcost:    :class:`~repro_torch.obs.hwcost.HardwareCostModel` pricing
               every packed leaf on the paper's DA circuits (and the
               bit-slicing counterfactual); carried in the manifest, rebuilt
               from the packed leaves when a manifest predates it.
    analysis:  the reference's last static-analysis verdict, carried as is.
    """

    params: Any
    plan: Dict[str, LayerPlan]
    da_cfg: DAConfig
    model_cfg: Any = None
    version: int = ARTIFACT_VERSION
    hwcost: Optional[HardwareCostModel] = None
    analysis: Optional[Dict[str, Any]] = None


def _ref_key(path, period: int) -> str:
    """A port leaf path as the reference names it: block ``i`` of the layer
    list is position ``i % period`` of the stacked periods."""
    if path[:1] == ("blocks",):
        path = ("periods", f"pos_{int(path[1]) % period}") + tuple(path[2:])
    return "/".join(path)


def packed_leaves(params, period: int = 1, path=()):
    """Every PackedWeights leaf of a port params tree with its path as the
    reference names it (:func:`_ref_key`), as ``(ref_path, leaf)`` pairs in
    the tree's order; the blocks of one layer position share a path."""
    if isinstance(params, PackedWeights):
        yield _ref_key(path, period), params
    elif isinstance(params, dict):
        for k, v in params.items():
            yield from packed_leaves(v, period, path + (str(k),))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from packed_leaves(v, period, path + (str(i),))


def pinned_plan(params, model_cfg=None) -> Dict[str, LayerPlan]:
    """The plan a pinned freeze of ``params`` amounts to, read off its
    PackedWeights leaves; with ``model_cfg`` the wk/wv entries record
    ``model_cfg.kv_dtype``."""
    period = model_cfg.period if model_cfg is not None else 1
    kv = model_cfg.kv_dtype if model_cfg is not None else None
    return {key: LayerPlan(
        mode=node.mode, group_size=node.cfg.group_size,
        with_luts=node.has_luts, k=node.k, n=node.n, source="pinned",
        kv_dtype=kv if key.endswith(("/wk", "/wv")) else None)
        for key, node in packed_leaves(params, period)}


# ---------------------------------------------------------------------------
# Serialize / load
# ---------------------------------------------------------------------------


def save_artifact(directory: str, artifact: DAArtifact) -> str:
    """Persist a DAArtifact in the reference's layout: ``<dir>/arrays.npz`` +
    ``manifest.json`` (atomic, crc-checked per array), the layers stacked
    over periods, the manifest carrying the DA config, the plan, the model
    config and the backend-registry fingerprint."""
    cfg = artifact.model_cfg
    extra = {
        "format": ARTIFACT_FORMAT,
        "artifact_version": artifact.version,
        "da_cfg": dataclasses.asdict(artifact.da_cfg),
        "plan": {k: p.to_json() for k, p in artifact.plan.items()},
        "registry": registry_fingerprint(),
    }
    if artifact.hwcost:
        extra["hwcost"] = artifact.hwcost.to_json()
    if artifact.analysis is not None:
        extra["analysis"] = artifact.analysis
    if cfg is not None:
        extra["model_cfg"] = cfg.to_manifest()
    tree = params_to_ref(artifact.params, cfg.period if cfg is not None else 1)
    return ckpt.save_tree(directory, tree, extra_manifest=extra)


def _demote_stale_modes(params, stale: set):
    def demote(node):
        for k, v in node.items():
            if isinstance(v, PackedWeights) and v.mode in stale:
                node[k] = dataclasses.replace(v, mode="auto")

    return _map_dicts(params, demote)


def load_artifact(directory: str, device="cuda") -> DAArtifact:
    """Boot a DAArtifact (the reference's or the port's) from disk onto
    ``device``: no float weights, no re-packing, every array crc-verified.
    A plan naming a backend this build does not register degrades that
    layer to ``mode="auto"`` with a warning."""
    dev = resolve_device(device)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest.get("format") != ARTIFACT_FORMAT:
        raise IOError(f"{directory} is not a DA artifact (format="
                      f"{manifest.get('format')!r}); expected "
                      f"{ARTIFACT_FORMAT!r}")
    if manifest.get("artifact_version", 0) > ARTIFACT_VERSION:
        raise IOError(f"artifact version {manifest['artifact_version']} is "
                      f"newer than this build understands ({ARTIFACT_VERSION})")
    tree = ckpt.load_tree(directory)
    params = params_from_jax(tree, dev) if "periods" in tree else tree
    _map_dicts(params, _colocate_qkv)
    plan = {k: LayerPlan.from_json(p)
            for k, p in manifest.get("plan", {}).items()}
    registry = registered_backends()
    stale = sorted({p.mode for p in plan.values() if p.mode not in registry})
    if stale:
        warnings.warn(
            f"artifact {directory} was planned for backends {stale} that are "
            "not registered in this build; those layers fall back to "
            "mode='auto' dispatch", stacklevel=2)
        params = _demote_stale_modes(params, set(stale))
        plan = {k: (dataclasses.replace(p, mode="auto", source="stale")
                    if p.mode in stale else p) for k, p in plan.items()}
    model_cfg = (ModelConfig.from_manifest(manifest["model_cfg"])
                 if "model_cfg" in manifest else None)
    if "hwcost" in manifest:
        hwcost = HardwareCostModel.from_json(manifest["hwcost"])
    else:  # a manifest older than the cost table: the leaves hold the geometry
        hwcost = HardwareCostModel.from_frozen(
            params, plan, period=model_cfg.period if model_cfg else 1)
    return DAArtifact(params=params, plan=plan,
                      da_cfg=DAConfig(**manifest["da_cfg"]), model_cfg=model_cfg,
                      version=manifest.get("artifact_version", 1),
                      hwcost=hwcost, analysis=manifest.get("analysis"))


# ---------------------------------------------------------------------------
# Reporting: the Table-I trade-off, per layer
# ---------------------------------------------------------------------------


def da_memory_report(frozen_params: Any, model_cfg: Any = None,
                     kv_dtypes: Any = None) -> dict:
    """The paper's Table-I trade-off at model scale — aggregate AND per layer
    (the reference's report, key for key).

    ``"layers"`` lists every packed matrix under its reference leaf path
    (the blocks of one layer position merged, as the reference stacks
    them), with its mode, group size and storage split (int8 code bytes vs
    int32 LUT bytes) and its :mod:`repro_torch.obs.hwcost` price per
    token-pass; ``"hw"`` is the model-total
    :meth:`~repro_torch.obs.hwcost.HardwareCostModel.summary`, the table
    that ``metrics()["hw"]`` serves.  With ``model_cfg``, a ``"kv"``
    section prices the paged KV cache beside the weights: per-position page
    dtype, bytes per token per layer, model-total bytes per token and the
    capacity multiplier against compute-dtype pages.
    """
    period = model_cfg.period if model_cfg is not None else 1
    hwm = HardwareCostModel.from_frozen(frozen_params, period=period)
    hw_rows = {r["path"]: r for r in hwm.layer_table()}
    merged: Dict[tuple, dict] = {}
    for key, node in packed_leaves(frozen_params, period):
        row = merged.setdefault(tuple(key.split("/")), {
            "layer": key, "mode": node.mode,
            "group_size": node.cfg.group_size, "k": int(node.k),
            "n": int(node.n), "with_luts": node.has_luts,
            "cells": 0, "lut_cells": 0, "code_bytes": 0,
            "scale_bytes": 0, "lut_bytes": 0})
        row["cells"] += node.wq.numel()
        row["code_bytes"] += node.wq.numel() * node.wq.element_size()
        row["scale_bytes"] += node.w_scale.numel() * node.w_scale.element_size()
        if node.luts is not None:
            row["lut_cells"] += node.luts.numel()
            row["lut_bytes"] += node.luts.numel() * node.luts.element_size()
    layers = []
    weights = luts = 0
    for at in sorted(merged):  # the reference's flattening order
        row = merged[at]
        cells, lut_cells = row.pop("cells"), row.pop("lut_cells")
        weights += cells
        luts += lut_cells
        hw_row = hw_rows.get(row["layer"], {})
        layers.append({
            **row,
            "cell_blowup": (lut_cells / cells) if cells else 0.0,
            "vmms_per_token": hw_row.get("vmms_per_token", 1),
            "da_pj": hw_row.get("da_pj", 0.0),
            "da_ns": hw_row.get("da_ns", 0.0),
            "bs_pj": hw_row.get("bs_pj", 0.0),
            "bs_ns": hw_row.get("bs_ns", 0.0),
        })
    report = {
        "da_matrices": len(layers),
        "weight_cells": weights,
        "lut_cells": luts,
        "cell_blowup": (luts / weights) if weights else 0.0,
        "layers": layers,
        "hw": hwm.summary() if hwm else None,
    }
    if model_cfg is not None:  # the port's family is attention throughout
        from repro_torch.serve.kvcache import kv_token_bytes, resolve_kv_dtypes

        resolved = resolve_kv_dtypes(model_cfg, kv_dtypes)
        per_pos = {key: kv_token_bytes(model_cfg, dt)
                   for key, dt in resolved.items()}
        total = model_cfg.n_periods * sum(per_pos.values())
        fp_total = model_cfg.n_periods * sum(
            kv_token_bytes(model_cfg, "fp16") for _ in per_pos)
        report["kv"] = {
            "kv_dtypes": resolved,
            "token_bytes_per_layer": per_pos,
            "bytes_per_token": total,
            "fp_bytes_per_token": fp_total,
            "capacity_multiplier": fp_total / total if total else 0.0,
        }
    return report
