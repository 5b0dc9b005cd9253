"""Serving engine: continuous batching over the paged KV cache, with every
weight matrix frozen into DA form (the paper's inference setting: weights
constant, the DA precondition).

``ServeEngine`` freezes float params through
:func:`repro_torch.core.freeze.freeze_model` when ``da_mode`` names a
backend (params already frozen are never re-packed) and serves them through
the paged scheduler; :meth:`ServeEngine.from_artifact` boots a DA artifact
(the reference's or the port's) from disk with no float weights and no
re-packing.  It runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.da import DAConfig
from repro_torch.core.freeze import (
    DAArtifact,
    freeze_model,
    is_frozen,
    load_artifact,
    pinned_plan,
    save_artifact,
)
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.serve.scheduler import PagedScheduler, Request  # noqa: F401


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


class ServeEngine:
    """Freeze-once DA weights in front, the paged scheduler behind."""

    def __init__(self, cfg: ModelConfig, params: Any, batch_size: int,
                 max_len: int, da_mode: Optional[str] = None,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 paged_attn: Optional[str] = None,
                 kv_dtype: Optional[str] = None, device="cuda"):
        # da_mode: a registered DA backend every weight matrix is frozen
        # under (None / "float" keeps float weights).  paged_attn: "gather"
        # | "fused" | "auto" (fused on CUDA, gather on the CPU); None
        # inherits cfg.paged_attn.  kv_dtype: KV page precision ("fp16" |
        # "int8" | "int4"); None inherits cfg.kv_dtype.
        self.device = resolve_device(device)
        # the KV precision is part of the frozen model (the artifact records
        # it); the attention read is a choice of this engine
        if kv_dtype is not None:
            cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        #: the DAArtifact this engine froze or booted from, else None
        self.artifact: Optional[DAArtifact] = None
        if da_mode not in (None, "float") and not is_frozen(params):
            da_cfg = DAConfig(x_signed=True)
            params = freeze_model(params, da_cfg, mode=da_mode,
                                  device=self.device)
            self.artifact = DAArtifact(params=params,
                                       plan=pinned_plan(params, cfg),
                                       da_cfg=da_cfg, model_cfg=cfg)
        else:
            params = _to_device(params, self.device)
        if paged_attn is not None:
            cfg = dataclasses.replace(cfg, paged_attn=paged_attn)
        self.cfg = cfg
        self.params = params
        self.b = batch_size
        self.max_len = max_len
        self._rt = PagedScheduler(
            self.cfg, params, batch_size=batch_size, max_len=max_len,
            page_size=page_size, n_pages=n_pages, device=self.device)

    # -- freeze-once, serve-many ---------------------------------------------
    @classmethod
    def from_artifact(cls, directory: str, batch_size: int, max_len: int,
                      kv_dtype: Optional[str] = None, device="cuda",
                      **kw) -> "ServeEngine":
        """Boot the serving runtime from a persisted DA artifact: the packed
        weights come straight off disk onto ``device``.

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

    def submit(self, req: Request) -> None:
        self._rt.submit(req)

    def step(self) -> int:
        return self._rt.step()

    def run(self, max_steps: int = 100_000) -> Dict[int, Request]:
        return self._rt.run(max_steps)

    def metrics(self) -> Dict[str, Any]:
        return self._rt.metrics()
