"""Serving engine: continuous batching over the paged KV cache, with every
weight matrix frozen into DA form (the paper's inference setting: weights
constant, the DA precondition).

``ServeEngine`` freezes float params through
:func:`repro_torch.core.freeze.freeze_model` when ``da_mode`` is given:
``"auto"`` (the default of the repo's serving surfaces) plans a backend,
group size and lut-or-not per layer at ``m_hint=batch_size``, a registered
backend pins every layer (params already frozen are never re-packed); it
serves them through the paged scheduler; :meth:`ServeEngine.from_artifact` boots a DA artifact
(the reference's or the port's) from disk with no float weights and no
re-packing.  It runs on the card unless the caller passes ``device="cpu"``.

Observability: every engine carries a metrics registry (always on) and a
trace recorder (``trace=True``, off by default); ``obs=`` hands in a bundle
instead.  ``write_trace`` / ``write_metrics`` / ``write_hw_metrics`` export a
Chrome trace, Prometheus text and the stamped ``hw`` block, the files
``python -m repro_torch.obs.check`` validates.  The ``hw`` block prices the
executed work on the paper's DA circuits (reckoned, not measured).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.da import DAConfig
from repro_torch.core.freeze import (
    DAArtifact,
    freeze_model,
    is_frozen,
    load_artifact,
    save_artifact,
)
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Observability, write_chrome_trace, write_prometheus
from repro_torch.obs.hwcost import HardwareCostModel
from repro_torch.obs.metrics import METRICS_SCHEMA_VERSION
from repro_torch.serve.scheduler import PagedScheduler, Request  # noqa: F401
from repro_torch.spec import SpecConfig


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


class ServeEngine:
    """Freeze-once DA weights in front, the paged scheduler behind."""

    def __init__(self, cfg: ModelConfig, params: Any, batch_size: int,
                 max_len: int, greedy: bool = True,
                 da_mode: Optional[str] = None, da_pin_modes: bool = True,
                 page_size: int = 16,
                 n_pages: Optional[int] = None, prefill_chunk: int = 16,
                 prefill_lanes: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 admission: str = "reserve", spec=None,
                 prefix_cache: bool = False, paged_attn: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 kv_dtypes: Optional[Dict[str, str]] = None,
                 trace: bool = False, obs: Optional[Observability] = None,
                 hw: Optional[HardwareCostModel] = None,
                 analysis_debug: bool = False, device="cuda"):
        # da_mode: freeze float params through the planner ("auto": a
        # backend per layer from measured + analytic costs at m_hint =
        # batch_size) or pin every layer to a registered backend; None /
        # "float" keeps float weights.  da_pin_modes=False keeps runtime
        # shape dispatch on the frozen artifact (prefill and decode may then
        # run different backends) instead of baking in the decode plan.
        # paged_attn: "gather"
        # | "fused" | "auto" (fused on CUDA, gather on the CPU); None
        # inherits cfg.paged_attn.  kv_dtype: KV page precision ("fp16" |
        # "int8" | "int4"); None inherits cfg.kv_dtype; kv_dtypes overrides
        # it per layer position.  spec: a SpecConfig, or a provider name
        # ("bitplane" | "layerskip" | "artifact") with its defaults.
        # prefix_cache: shared-prefix caching with copy-on-write pages.
        # trace: turn on the event recorder (export with write_trace()); the
        # metrics registry is always on.  obs: a prebuilt Observability
        # bundle instead (overrides trace=); each engine otherwise builds its
        # own, so two engines never share series.  hw: a HardwareCostModel
        # pricing the served work on the paper's DA circuits; None derives
        # it from the artifact or the frozen params (float weights: none).
        # The scheduler knobs (greedy, prefill_chunk, prefill_lanes,
        # token_budget, admission, analysis_debug) pass through to
        # PagedScheduler.
        self.device = resolve_device(device)
        # the KV precision is part of the frozen model (the artifact records
        # it); the attention read is a choice of this engine
        if kv_dtype is not None:
            cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        #: the DAArtifact this engine froze or booted from, else None
        self.artifact: Optional[DAArtifact] = None
        if da_mode not in (None, "float") and not is_frozen(params):
            self.artifact = freeze_model(
                params, DAConfig(x_signed=True), mode=da_mode,
                m_hint=batch_size, model_cfg=cfg, pin_modes=da_pin_modes,
                kv_dtype_overrides=kv_dtypes, device=self.device)
            params = self.artifact.params
        else:
            params = _to_device(params, self.device)
        if hw is None:
            if self.artifact is not None:
                hw = self.artifact.hwcost
            elif is_frozen(params):
                hw = HardwareCostModel.from_frozen(params, period=cfg.period)
        self.hw = hw if hw else None
        self.obs = obs if obs is not None else Observability.make(trace=trace)
        if isinstance(spec, str):
            spec = SpecConfig(provider=spec)
        self.cfg = cfg
        self.params = params
        self.b = batch_size
        self.max_len = max_len
        self._rt = PagedScheduler(
            cfg, params, batch_size=batch_size, max_len=max_len, greedy=greedy,
            page_size=page_size, n_pages=n_pages, prefill_chunk=prefill_chunk,
            prefill_lanes=prefill_lanes, token_budget=token_budget,
            admission=admission, spec=spec, prefix_cache=prefix_cache,
            paged_attn=paged_attn, kv_dtypes=kv_dtypes, obs=self.obs,
            hw=self.hw, analysis_debug=analysis_debug, device=self.device)
        self.cfg = self._rt.cfg

    # -- freeze-once, serve-many ---------------------------------------------
    @classmethod
    def from_artifact(cls, directory: str, batch_size: int, max_len: int,
                      kv_dtype: Optional[str] = None, device="cuda",
                      **kw) -> "ServeEngine":
        """Boot the serving runtime from a persisted DA artifact: the packed
        weights come straight off disk onto ``device``; ``kw`` are the
        engine's runtime knobs (``prefix_cache``, ``spec``, ...).

        KV precision follows the artifact: the plan's wk entries record the
        page dtype of each layer position.  An explicit ``kv_dtype``
        overrides a homogeneous plan and raises on a per-layer one (it would
        flatten it)."""
        art = load_artifact(directory, device=device)
        if art.model_cfg is None:
            raise ValueError(f"artifact {directory} carries no model config; "
                             "it cannot be served")
        plan_kv: Dict[str, str] = {}
        for key, p in art.plan.items():
            if p.kv_dtype is not None and key.endswith("/wk"):
                seg = next((s for s in key.split("/") if s.startswith("pos_")),
                           None)
                if seg is not None:
                    plan_kv[seg] = p.kv_dtype
        if len(set(plan_kv.values())) > 1:
            if kv_dtype is not None:
                raise ValueError(
                    f"artifact {directory} was frozen with per-layer KV dtypes "
                    f"{plan_kv}; overriding them with a global kv_dtype= would "
                    "silently flatten the plan — drop the override or re-freeze")
            raise NotImplementedError(
                f"artifact {directory}: per-position KV dtypes {plan_kv} need a "
                "layer pattern with period > 1, which the port's dense family "
                "does not have")
        if kv_dtype is None and plan_kv:
            kv_dtype = next(iter(plan_kv.values()))
        kw.setdefault("hw", art.hwcost)  # the manifest's cost table
        eng = cls(art.model_cfg, art.params, batch_size, max_len,
                  kv_dtype=kv_dtype, device=device, **kw)
        eng.artifact = art
        return eng

    def save_artifact(self, directory: str) -> str:
        """Persist this engine's frozen weights + plan for later cold boots."""
        if self.artifact is None:
            raise ValueError("engine holds no DAArtifact (constructed without "
                             "da_mode and not from_artifact) — nothing to save")
        return save_artifact(directory, self.artifact)

    # -- runtime delegation --------------------------------------------------
    @property
    def queue(self) -> List[Request]:
        return self._rt.queue

    @property
    def done(self) -> Dict[int, Request]:
        return self._rt.done

    @property
    def caches(self):
        return self._rt.caches

    def submit(self, req: Request) -> None:
        self._rt.submit(req)

    def step(self) -> int:
        return self._rt.step()

    def run(self, max_steps: int = 100_000) -> Dict[int, Request]:
        return self._rt.run(max_steps)

    def warmup(self) -> int:
        """Run every step shape of the runtime once."""
        return self._rt.warmup()

    def metrics(self) -> Dict[str, Any]:
        return self._rt.metrics()

    # -- observability export ------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, Any]:
        """Flat registry snapshot (every counter, gauge and histogram
        series), the schema the Prometheus export shares."""
        return self.obs.registry.snapshot()

    def write_trace(self, path: str) -> str:
        """Dump the recorded events as Chrome trace_event JSON (loadable in
        Perfetto); empty unless the recorder is on (``trace=True``)."""
        return write_chrome_trace(path, self.obs.tracer)

    def write_metrics(self, path: str) -> str:
        """Dump the registry in Prometheus text exposition format."""
        return write_prometheus(path, self.obs.registry)

    def write_hw_metrics(self, path: str) -> str:
        """Dump ``metrics()["hw"]`` (the DA hardware-cost block, null without
        a cost model) as schema-stamped JSON."""
        payload = {"metrics_schema_version": METRICS_SCHEMA_VERSION,
                   "hw": self.metrics().get("hw")}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        return path
