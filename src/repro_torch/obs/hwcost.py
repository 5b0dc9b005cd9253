"""Hardware cost model of a frozen model on the paper's DA circuits.

The calibrated analytic model in :mod:`repro.core.hwmodel` prices ONE VMM on
ONE K×N design point (Table I).  This module lifts it to a *served model*:
every frozen layer's geometry (K×N, group size, x bits, backend mode, how
many VMMs one token-pass issues through that leaf) maps onto a
:class:`~repro.core.hwmodel.DADesign` and its bit-slicing counterfactual
:class:`~repro.core.hwmodel.BitSliceDesign`, giving a per-layer, per-token
cost table — ns and pJ, broken into sense / adder / array-overhead
components — that the serving stack multiplies by *actual executed work*
(prefill chunk tokens, decode steps, spec-decode draft passes).

This is the Lynchpin-style discipline for in-memory VMM claims: evaluated
per workload, component-attributed, reproducible — not a single design
point.  The model is built once at freeze / ``from_artifact``, recorded in the
artifact manifest, and is the ONE source of geometry truth shared by
``da_memory_report`` and ``metrics()["hw"]``.

Its numbers are the paper's ReRAM circuits as :mod:`repro_torch.core.hwmodel`
reckons them (pJ and model-ns per token-pass), never a measurement of the
device the port runs on.  The port keeps one params dict per layer where the
reference stacks each layer position over periods; :meth:`from_frozen` keys
every leaf by the reference's path (``periods/pos_0/mixer/wq``) and merges
the layers of one position into one row, so both packages give the same
table for the same model.

Accounting conventions (documented, test-asserted):

* A "token-pass" is one token through the full stack; it issues
  ``vmms_per_token`` VMMs per leaf (the product of the leaf's stacked
  leading dims — periods, experts).  MoE leaves count every expert (the
  dropless upper bound); attention/softmax and other non-DA compute are
  outside the model.
* ``ns_per_token`` is the fully-serialized bound: every VMM's
  ``latency_ns`` summed (layers are sequential in a forward pass; intra-
  layer parallelism would only lower it).
* ``x_bits_eff`` prices a reduced-precision pass (the truncated-bitplane
  spec draft): the DA engine simply issues fewer bit-serial read cycles,
  so energy scales *exactly* linearly in the evaluated bit-planes — the
  DA-native energy story.  The bit-slicing counterfactual also scales
  (fewer DAC/input cycles), keeping the comparison honest.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.hwmodel import PJ, BitSliceDesign, DADesign

#: Schema version of the serialized cost table (artifact manifest block).
HWCOST_VERSION = 1

#: Weight codes are int8 throughout the freeze pipeline.
DA_W_BITS = 8


def da_design(k: int, n: int, x_bits: int = 8, group_size: int = 8,
              w_bits: int = DA_W_BITS) -> DADesign:
    """THE layer-geometry → DA engine mapping (single source of truth —
    the freeze planner's analytic fallback and every report go through
    here, never through ad-hoc ``DADesign(...)`` construction)."""
    return DADesign(k=k, n=n, w_bits=w_bits, x_bits=x_bits,
                    base_group=group_size)


def bitslice_design(k: int, n: int, x_bits: int = 8,
                    w_bits: int = DA_W_BITS) -> BitSliceDesign:
    """The layer-geometry → bit-slicing counterfactual mapping."""
    return BitSliceDesign(k=k, n=n, w_bits=w_bits, x_bits=x_bits)


@dataclasses.dataclass(frozen=True)
class LayerGeom:
    """One frozen leaf's cost-relevant geometry (what the manifest stores)."""

    path: str
    k: int
    n: int
    group_size: int = 8
    x_bits: int = 8
    w_bits: int = DA_W_BITS
    mode: str = "auto"
    vmms_per_token: int = 1

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "LayerGeom":
        return cls(**d)


def _eff_bits(x_bits: int, x_bits_eff: Optional[int]) -> int:
    if x_bits_eff is None:
        return x_bits
    return max(1, min(int(x_bits_eff), x_bits))


class HardwareCostModel:
    """Per-layer, per-token DA cost table for a frozen model.

    Construct via :meth:`from_frozen` (a packed params tree),
    :meth:`from_shapes` (bare geometries — design studies, the CONV1
    check), or :meth:`from_json` (artifact manifest round-trip).
    """

    def __init__(self, layers: Iterable[LayerGeom]):
        self.layers: Tuple[LayerGeom, ...] = tuple(layers)
        # per-x_bits_eff cache of (da_pj, da_ns, bs_pj, bs_ns) totals and
        # the component breakdowns — the scheduler prices every charge from
        # these floats, so building them is O(layers) exactly once per
        # precision actually served
        self._cache: Dict[Optional[int], Dict[str, Any]] = {}

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_frozen(cls, params: Any,
                    plan: Optional[Dict[str, Any]] = None,
                    period: int = 1) -> "HardwareCostModel":
        """Walk a packed params tree; one LayerGeom per reference leaf path.

        Block ``i`` of the port's layer list is position ``i % period`` of
        the reference's stacked periods, so the blocks of one position merge
        into one row whose ``vmms_per_token`` counts them (times any
        stacked leading dims of the leaf itself).  ``k`` and ``n`` come from
        the PackedWeights fields, never the storage size: the q/k/v codes of
        a layer are views into one shared buffer."""
        from repro_torch.core.freeze import packed_leaves

        rows: Dict[Tuple[str, ...], LayerGeom] = {}
        for key, node in packed_leaves(params, period):
            k, n = int(node.k), int(node.n)
            mode = node.mode
            if plan and key in plan and mode == "auto":
                mode = plan[key].mode
            geom = LayerGeom(path=key, k=k, n=n,
                             group_size=int(node.cfg.group_size),
                             x_bits=int(node.cfg.x_bits), mode=mode,
                             vmms_per_token=max(1, node.wq.numel() // (k * n)))
            at = tuple(key.split("/"))
            prev = rows.get(at)
            if prev is None:
                rows[at] = geom
            elif dataclasses.replace(
                    prev, vmms_per_token=geom.vmms_per_token) != geom:
                raise ValueError(
                    f"layers of {key} disagree on their geometry; the "
                    "reference stacks them as one PackedWeights")
            else:
                rows[at] = dataclasses.replace(
                    prev, vmms_per_token=prev.vmms_per_token
                    + geom.vmms_per_token)
        # the reference's tree flattening visits dict keys in sorted order
        return cls(rows[at] for at in sorted(rows))

    @classmethod
    def from_shapes(cls, shapes: Iterable[Any], x_bits: int = 8,
                    group_size: int = 8) -> "HardwareCostModel":
        """Bare geometries: each item is ``(label, k, n)`` (or
        ``(label, k, n, count)``), or a dict of LayerGeom fields."""
        layers = []
        for s in shapes:
            if isinstance(s, dict):
                layers.append(LayerGeom(**{"x_bits": x_bits,
                                           "group_size": group_size, **s}))
            else:
                label, k, n = s[0], int(s[1]), int(s[2])
                count = int(s[3]) if len(s) > 3 else 1
                layers.append(LayerGeom(path=label, k=k, n=n, x_bits=x_bits,
                                        group_size=group_size,
                                        vmms_per_token=count))
        return cls(layers)

    # -- serialization -------------------------------------------------------
    def to_json(self) -> dict:
        return {"hwcost_version": HWCOST_VERSION,
                "layers": [g.to_json() for g in self.layers]}

    @classmethod
    def from_json(cls, d: dict) -> "HardwareCostModel":
        v = d.get("hwcost_version", 0)
        if v > HWCOST_VERSION:
            raise ValueError(
                f"hwcost table version {v} is newer than this build "
                f"understands ({HWCOST_VERSION})")
        return cls(LayerGeom.from_json(g) for g in d.get("layers", []))

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, HardwareCostModel)
                and self.layers == other.layers)

    def __bool__(self) -> bool:
        return bool(self.layers)

    # -- the per-layer table -------------------------------------------------
    def _totals(self, x_bits_eff: Optional[int] = None) -> Dict[str, Any]:
        got = self._cache.get(x_bits_eff)
        if got is not None:
            return got
        da_pj = da_ns = bs_pj = bs_ns = 0.0
        comp = {"sense_pj": 0.0, "array_overhead_pj": 0.0, "adder_pj": 0.0}
        bs_comp = {"read_pj": 0.0, "adc_pj": 0.0, "dac_pj": 0.0,
                   "adder_pj": 0.0}
        rows: List[dict] = []
        for g in self.layers:
            # The hardware is built at the layer's FULL x_bits; a reduced-
            # precision pass (x_bits_eff) runs the same circuits for fewer
            # bit-serial cycles.  Energy therefore scales by eff/x_bits
            # EXACTLY (every component is per-cycle); latency drops by the
            # skipped read cycles (same cycle time, same adder tail).
            eff = _eff_bits(g.x_bits, x_bits_eff)
            scale = eff / g.x_bits
            da = da_design(g.k, g.n, x_bits=g.x_bits,
                           group_size=g.group_size, w_bits=g.w_bits)
            bs = bitslice_design(g.k, g.n, x_bits=g.x_bits, w_bits=g.w_bits)
            m = g.vmms_per_token
            c = {f"{k}_pj": v * scale * m / PJ
                 for k, v in da.energy_components_j().items()}
            bc = {f"{k}_pj": v * scale * m / PJ
                  for k, v in bs.energy_components_j().items()}
            row = {
                "path": g.path, "k": g.k, "n": g.n, "mode": g.mode,
                "group_size": g.group_size, "x_bits": eff,
                "vmms_per_token": m,
                "da_ns": dataclasses.replace(da, x_bits=eff).latency_ns() * m,
                "da_pj": sum(c.values()),
                "da_components_pj": c,
                "bs_ns": bs.latency_ns() * scale * m,
                "bs_pj": sum(bc.values()),
                "bs_components_pj": bc,
                "memory_cells": da.memory_cells * m,
                "transistors": da.transistors() * m,
            }
            rows.append(row)
            da_pj += row["da_pj"]
            da_ns += row["da_ns"]
            bs_pj += row["bs_pj"]
            bs_ns += row["bs_ns"]
            for key in comp:
                comp[key] += c[key]
            for key in bs_comp:
                bs_comp[key] += bc[key]
        out = {"rows": rows, "da_pj": da_pj, "da_ns": da_ns,
               "bs_pj": bs_pj, "bs_ns": bs_ns,
               "components": comp, "bs_components": bs_comp}
        self._cache[x_bits_eff] = out
        return out

    def layer_table(self, x_bits_eff: Optional[int] = None) -> List[dict]:
        """Per-layer per-token costs (ns, pJ, components, counterfactual)."""
        return self._totals(x_bits_eff)["rows"]

    # -- per-token scalars (what the scheduler multiplies by work) -----------
    def pj_per_token(self, x_bits_eff: Optional[int] = None) -> float:
        """DA energy of one token-pass (pJ); ``x_bits_eff`` prices a
        truncated-bitplane pass — exactly linear in the evaluated planes."""
        return self._totals(x_bits_eff)["da_pj"]

    def ns_per_token(self, x_bits_eff: Optional[int] = None) -> float:
        """Fully-serialized DA latency of one token-pass (model ns)."""
        return self._totals(x_bits_eff)["da_ns"]

    def components(self, x_bits_eff: Optional[int] = None) -> Dict[str, float]:
        """pJ/token split into sense / array-overhead / adder energy."""
        return dict(self._totals(x_bits_eff)["components"])

    def bitslice_pj_per_token(self, x_bits_eff: Optional[int] = None) -> float:
        return self._totals(x_bits_eff)["bs_pj"]

    def bitslice_ns_per_token(self, x_bits_eff: Optional[int] = None) -> float:
        return self._totals(x_bits_eff)["bs_ns"]

    def bitslice_components(
            self, x_bits_eff: Optional[int] = None) -> Dict[str, float]:
        return dict(self._totals(x_bits_eff)["bs_components"])

    def ratios(self, x_bits_eff: Optional[int] = None) -> Dict[str, float]:
        """Design-point DA-vs-bit-slicing ratios for this model's layers
        (the paper's headline numbers, at LM geometry)."""
        t = self._totals(x_bits_eff)
        return {
            "energy": t["bs_pj"] / t["da_pj"] if t["da_pj"] else 0.0,
            "latency": t["bs_ns"] / t["da_ns"] if t["da_ns"] else 0.0,
        }

    def summary(self, x_bits_eff: Optional[int] = None) -> Dict[str, Any]:
        """The static half of ``metrics()["hw"]`` (per-token, no workload)."""
        t = self._totals(x_bits_eff)
        return {
            "layers": len(self.layers),
            "vmms_per_token": sum(g.vmms_per_token for g in self.layers),
            "pj_per_token": t["da_pj"],
            "ns_per_token": t["da_ns"],
            "components": dict(t["components"]),
            "bitslice": {
                "pj_per_token": t["bs_pj"],
                "ns_per_token": t["bs_ns"],
                "components": dict(t["bs_components"]),
            },
            "ratios": self.ratios(x_bits_eff),
        }


def draft_price(hw: HardwareCostModel, provider: Any,
                full_params: Any = None) -> Dict[str, Any]:
    """Per-token DA + bit-slicing prices of a spec-decode DRAFT pass.

    Truncated-bitplane drafts (``x_bits_eff``) reprice through the model
    exactly — proportionally fewer bit-serial read cycles.  A second-
    artifact draft with its own frozen weights gets its own cost table.
    Anything else (layer-skip) scales the full pass by the provider's
    ``cost_ratio``.  Returns ``{pj, ns, bs_pj, bs_ns, x_bits_eff}``.
    """
    xb = getattr(provider, "x_bits_eff", None)
    if xb is not None:
        return {"pj": hw.pj_per_token(x_bits_eff=xb),
                "ns": hw.ns_per_token(x_bits_eff=xb),
                "bs_pj": hw.bitslice_pj_per_token(x_bits_eff=xb),
                "bs_ns": hw.bitslice_ns_per_token(x_bits_eff=xb),
                "x_bits_eff": int(xb)}
    dparams = getattr(provider, "params", None)
    if dparams is not None and dparams is not full_params:
        own = HardwareCostModel.from_frozen(
            dparams, period=getattr(getattr(provider, "cfg", None),
                                    "period", 1))
        if own:
            return {"pj": own.pj_per_token(), "ns": own.ns_per_token(),
                    "bs_pj": own.bitslice_pj_per_token(),
                    "bs_ns": own.bitslice_ns_per_token(),
                    "x_bits_eff": None}
    r = float(getattr(provider, "cost_ratio", 1.0))
    return {"pj": hw.pj_per_token() * r, "ns": hw.ns_per_token() * r,
            "bs_pj": hw.bitslice_pj_per_token() * r,
            "bs_ns": hw.bitslice_ns_per_token() * r,
            "x_bits_eff": None}
