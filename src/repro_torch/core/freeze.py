"""Model-level DA freeze: plan → pack → serialize, and DA artifacts on disk.

1. **Plan** (:func:`plan_model`): for every weight-matrix leaf
   (``DA_LEAF_NAMES``, outside ``SKIP_CONTEXT``) choose a backend mode, a
   group size and lut-or-not from the layer's (K, N) shape and the expected
   decode batch ``m_hint``: measured cost-table timings
   (:func:`repro_torch.core.engine.load_cost_table`, the port's own table)
   rank the eligible backends when the bucket was timed on this device,
   else the analytic hardware model (:func:`analytic_costs`) ranks them.
   Plans are keyed by the reference's leaf paths (``periods/pos_0/mixer/wq``);
   the blocks of one layer position share one plan, as the reference's
   period-stacked leaf does.
2. **Pack** (:func:`freeze_model`): quantize every planned leaf, write its
   LUTs when the plan says so, and return a :class:`DAArtifact` (packed
   params, the plan, the DA config, the model config and the hardware-cost
   table).  A concrete ``mode`` pins every layer to it instead.  Norms,
   biases and the embedding table stay float.
3. **Serialize** (:func:`save_artifact` / :func:`load_artifact`): the
   reference's artifact (``arrays.npz`` + ``manifest.json``).  Its layout
   stacks each layer position over periods, which the port splits into
   ``blocks`` when reading and stacks back when writing, so the two
   packages boot each other's artifacts.

The q/k/v codes of each attention layer are laid out side by side in one
``[K, Nq + Nk + Nv]`` buffer (each pack's ``wq`` is a column slice of it), so
the fused projection reads the three matrices in one kernel pass without
concatenating them every step; each pack keeps its own LUTs.
:func:`da_memory_report` prices the packed layers (storage and the
:mod:`repro_torch.obs.hwcost` table), keyed by the reference's leaf paths.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.convert import params_from_jax, params_to_ref
from repro_torch.core.da import DAConfig
from repro_torch.core.engine import (
    DEFAULT_LUT_LIMIT,
    PackedWeights,
    canonical_mode,
    get_backend,
    load_cost_table,
    lut_cells,
    pack_weights,
    registered_backends,
    registry_fingerprint,
    shape_bucket,
)
from repro_torch.core.hwmodel import T_ADD_STAGE, T_READ_PIPE
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.kv_quant import KV_DTYPES
from repro_torch.obs.hwcost import HardwareCostModel, da_design

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


def is_frozen(params) -> bool:
    """Does the tree carry PackedWeights leaves?"""
    return next(packed_leaves(params), None) is not None


# ---------------------------------------------------------------------------
# The planner: measured costs with the analytic hardware model as fallback
# ---------------------------------------------------------------------------


def analytic_costs(m: int, k: int, n: int, cfg: DAConfig,
                   has_luts: bool) -> Dict[str, float]:
    """Analytic per-backend latency proxies (model-ns) from the hardware
    model, the reference's: the PMA readout streams ``x_bits`` read cycles
    per input row (``DADesign.latency_ns``), the one-hot decode touches the
    whole 2^L/L-blown-up table per readout, and the storage-free forms pay a
    K·N adder sweep per bit plane plus a weight-array read, once per plane
    for ``bitplane`` and once in all for ``bitplane_stacked``.  Only the
    ranking matters; these are the paper's circuits, not the card."""
    costs: Dict[str, float] = {}
    x_bits = cfg.x_bits
    mac_sweep = float(m) * k * n * T_ADD_STAGE
    w_read = float(k) * n * T_READ_PIPE
    if has_luts:
        d = da_design(k, n, x_bits=x_bits, group_size=cfg.group_size)
        readout = m * d.latency_ns()
        costs["lut"] = readout
        costs["pallas_lut"] = readout
        costs["onehot"] = readout * ((1 << cfg.group_size) / cfg.group_size)
    costs["bitplane"] = x_bits * (mac_sweep + w_read)
    costs["pallas_bitplane"] = costs["bitplane"]
    costs["bitplane_stacked"] = x_bits * mac_sweep + w_read
    return costs


def plan_layer(k: int, n: int, da_cfg: DAConfig, m_hint: int = 4,
               lut_cell_limit: int = DEFAULT_LUT_LIMIT,
               cost_table: Optional[Dict[str, Dict[str, float]]] = None,
               group_size_candidates: Optional[Sequence[int]] = None
               ) -> LayerPlan:
    """Choose (mode, group_size, lut-or-not) for one K×N weight matrix.

    For each candidate group size: LUTs when they fit ``lut_cell_limit``;
    the eligible DA backends ranked by the ``m_hint`` bucket's timings in
    ``cost_table`` (default: the process table), else by
    :func:`analytic_costs`.  The cheapest candidate wins, ties to the first;
    measured candidates rank before analytic ones (never compared), and
    only the base group size may claim ``measured`` (tables are timed at
    that one group size)."""
    table = cost_table if cost_table is not None else load_cost_table()
    candidates = tuple(group_size_candidates or (da_cfg.group_size,))
    best: Optional[Tuple[int, float, LayerPlan]] = None  # (rank, cost, plan)
    for gs in candidates:
        cfg = dataclasses.replace(da_cfg, group_size=gs)
        with_luts = lut_cells(k, n, gs) <= lut_cell_limit
        eligible = [s for s in registered_backends().values()
                    if s.is_da and s.supports(cfg, with_luts)]
        if not eligible:
            continue
        measured = (table.get(shape_bucket(m_hint, k, n, cfg.x_bits), {})
                    if gs == da_cfg.group_size else {})
        timed = {s.name: measured[s.name] for s in eligible
                 if s.name in measured}
        if timed:
            mode = min(timed, key=timed.get)
            rank, source, cost = 0, "measured", timed[mode]
        else:
            analytic = analytic_costs(m_hint, k, n, cfg, with_luts)
            scored = {s.name: analytic[s.name] for s in eligible
                      if s.name in analytic}
            if not scored:  # a backend the model does not price
                scored = {min(eligible, key=lambda s: s.name).name: 0.0}
            mode = min(scored, key=scored.get)
            rank, source, cost = 1, "analytic", scored[mode]
        plan = LayerPlan(mode=mode, group_size=gs, with_luts=with_luts,
                         k=k, n=n, source=source, est_cost=cost)
        if best is None or (rank, cost) < best[:2]:
            best = (rank, cost, plan)
    if best is None:  # unreachable with the built-in backends
        raise ValueError(f"no DA backend eligible for K={k} N={n} "
                         f"candidates={candidates}")
    return best[2]


def _da_leaves(tree, period: int, path=()):
    """``(reference path, leaf)`` of every weight-matrix leaf still float."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _da_leaves(v, period, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _da_leaves(v, period, path + (str(i),))
    elif _is_da_leaf(path, tree):
        yield _ref_key(path, period), tree


def plan_model(params, da_cfg: DAConfig = DAConfig(x_signed=True),
               m_hint: int = 4, lut_cell_limit: int = DEFAULT_LUT_LIMIT,
               cost_table: Optional[Dict[str, Dict[str, float]]] = None,
               group_size_candidates: Optional[Sequence[int]] = None,
               period: int = 1) -> Dict[str, LayerPlan]:
    """Per-layer plans for every weight-matrix leaf of ``params`` (no
    packing), keyed by the reference's paths: the blocks of one layer
    position (``i % period``) share a plan.  Only shapes are read."""
    plans: Dict[str, LayerPlan] = {}
    for key, leaf in _da_leaves(params, period):
        if key not in plans:
            plans[key] = plan_layer(
                int(leaf.shape[-2]), int(leaf.shape[-1]), da_cfg,
                m_hint=m_hint, lut_cell_limit=lut_cell_limit,
                cost_table=cost_table,
                group_size_candidates=group_size_candidates)
    return plans


# ---------------------------------------------------------------------------
# Freeze: pack every planned leaf
# ---------------------------------------------------------------------------


def freeze_model(params, da_cfg: DAConfig = DAConfig(x_signed=True),
                 mode: str = "auto", m_hint: int = 4,
                 lut_cell_limit: int = DEFAULT_LUT_LIMIT, model_cfg=None,
                 cost_table: Optional[Dict[str, Dict[str, float]]] = None,
                 group_size_candidates: Optional[Sequence[int]] = None,
                 pin_modes: bool = True,
                 kv_dtype_overrides: Optional[Dict[str, str]] = None,
                 device="cuda") -> DAArtifact:
    """Pack every weight-matrix leaf of ``params`` on ``device`` under its
    per-layer plan; returns the :class:`DAArtifact`.

    ``mode="auto"`` runs the planner (:func:`plan_layer`); a registered
    backend (legacy ``da_*`` spellings accepted) pins every layer to it.
    ``pin_modes=True`` bakes each planned backend into its PackedWeights
    and writes LUTs only where that backend reads them; ``pin_modes=False``
    keeps ``mode="auto"`` (runtime shape dispatch) and every feasible LUT.
    With ``model_cfg`` the plan's wk/wv entries record the KV-page
    precision their cache serves at: ``model_cfg.kv_dtype``, overridden per
    layer position by ``kv_dtype_overrides`` (``{"pos_i": dtype}``).  Leaves
    already packed are never re-packed; other leaves move to ``device``."""
    dev = resolve_device(device)
    mode = canonical_mode(mode)
    planned = mode == "auto"
    if not planned:
        get_backend(mode)
    period = model_cfg.period if model_cfg is not None else 1
    base_kv = getattr(model_cfg, "kv_dtype", None) if model_cfg else None
    for key, dt in (kv_dtype_overrides or {}).items():
        if dt not in KV_DTYPES:
            raise ValueError(f"kv_dtype_overrides[{key!r}]={dt!r}; expected "
                             f"one of {KV_DTYPES}")
    plans: Dict[str, LayerPlan] = {}

    def plan_for(key: str, k: int, n: int) -> LayerPlan:
        if planned:
            plan = plan_layer(k, n, da_cfg, m_hint=m_hint,
                              lut_cell_limit=lut_cell_limit,
                              cost_table=cost_table,
                              group_size_candidates=group_size_candidates)
            if pin_modes and not get_backend(plan.mode).needs_luts:
                # the pinned backend never reads PMAs: writing them would
                # store up to 2^L/L x dead cells
                plan = dataclasses.replace(plan, with_luts=False)
        else:
            plan = LayerPlan(mode=mode, group_size=da_cfg.group_size,
                             with_luts=get_backend(mode).needs_luts, k=k, n=n,
                             source="pinned")
        names = key.split("/")
        if base_kv is not None and names[-1] in ("wk", "wv"):
            pos = next((s for s in names if s.startswith("pos_")), None)
            plan = dataclasses.replace(
                plan, kv_dtype=(kv_dtype_overrides or {}).get(pos, base_kv))
        return plan

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (str(k),), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(path + (str(i),), v) for i, v in enumerate(node)]
        if isinstance(node, PackedWeights):
            return node  # already frozen: never re-packed
        if _is_da_leaf(path, node):
            key = _ref_key(path, period)
            if key not in plans:
                plans[key] = plan_for(key, int(node.shape[-2]),
                                      int(node.shape[-1]))
            plan = plans[key]
            return pack_weights(
                node.to(dev), dataclasses.replace(da_cfg,
                                                  group_size=plan.group_size),
                mode=plan.mode if (pin_modes or not planned) else "auto",
                with_luts=plan.with_luts)
        return node.to(dev) if isinstance(node, torch.Tensor) else node

    packed = _map_dicts(walk((), params), _colocate_qkv)
    return DAArtifact(params=packed, plan=plans, da_cfg=da_cfg,
                      model_cfg=model_cfg,
                      hwcost=HardwareCostModel.from_frozen(packed, plans,
                                                           period=period))


def freeze_model_da(params, da_cfg: DAConfig = DAConfig(x_signed=True),
                    mode: str = "auto", lut_cell_limit: int = DEFAULT_LUT_LIMIT,
                    device="cuda"):
    """Freeze and return only the packed params tree (the reference's
    legacy surface)."""
    return freeze_model(params, da_cfg, mode=mode,
                        lut_cell_limit=lut_cell_limit, device=device).params


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
    that ``metrics()["hw"]`` serves.  With the ``model_cfg`` of a stack
    whose every mixer is attention (the paged pool's), a ``"kv"`` section
    prices the paged KV cache beside the weights: per-position page
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
    if model_cfg is not None and all(model_cfg.mixer_kind(p) == "attn"
                                     for p in range(model_cfg.period)):
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
