"""Serving engine: continuous batching over the paged KV cache, with every
weight matrix frozen into DA form (the paper's inference setting: weights
constant, the DA precondition).

``ServeEngine`` freezes float params through
:func:`repro_torch.core.freeze.freeze_model` when ``da_mode`` names a
backend (params already frozen are never re-packed) and serves them through
the paged scheduler.  It runs on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.da import DAConfig
from repro_torch.core.freeze import freeze_model, is_frozen
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
                 paged_attn: Optional[str] = None, device="cuda"):
        # da_mode: a registered DA backend every weight matrix is frozen
        # under (None / "float" keeps float weights).  paged_attn: "gather"
        # | "fused" | "auto" (fused on CUDA, gather on the CPU); None
        # inherits cfg.paged_attn.  KV page precision is cfg.kv_dtype.
        self.device = resolve_device(device)
        if paged_attn is not None:
            cfg = dataclasses.replace(cfg, paged_attn=paged_attn)
        if da_mode not in (None, "float") and not is_frozen(params):
            params = freeze_model(params, DAConfig(x_signed=True), mode=da_mode,
                                  device=self.device)
        else:
            params = _to_device(params, self.device)
        self.cfg = cfg
        self.params = params
        self.b = batch_size
        self.max_len = max_len
        self._rt = PagedScheduler(
            self.cfg, params, batch_size=batch_size, max_len=max_len,
            page_size=page_size, n_pages=n_pages, device=self.device)

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
