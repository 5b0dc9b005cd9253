"""Draft providers: the three cheap passes behind one protocol.

A provider owns the draft side of speculative decoding: which parameters the
draft step reads, whether it writes the target's paged pools or its own,
what a draft step costs relative to a full step (the breakeven input), and
the step itself.  Step contract (all providers)::

    step(params, caches, tokens [B,T], positions [B,T], page_table [B,W],
         last_idx [B]) -> (logits [B,V], caches)

``T > 1`` is the catch-up form of a provider with its own KV, which ingests
the tokens the target accepted since its last draft.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Protocol, runtime_checkable

from repro_torch.core import engine
from repro_torch.core.engine import PackedWeights
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import count_params
from repro_torch.spec.decode import SpecConfig, make_paged_step


@runtime_checkable
class DraftProvider(Protocol):
    """What the scheduler needs from a draft pass.

    name:         provider kind (metrics).
    cost_ratio:   draft step cost / full step cost — the breakeven input.
    shared_cache: True → the draft writes the target's pools (self-draft;
                  verify overwrites its rows) and never catches up; False →
                  its own pools, indexed by the same page tables.
    cfg:          ModelConfig the draft step runs under.
    params:       the tree the step reads.
    """

    name: str
    cost_ratio: float
    shared_cache: bool
    cfg: ModelConfig
    params: Any

    def make_step(self) -> Callable:
        ...

    def init_caches(self, n_pages: int, page_size: int,
                    device) -> Optional[Any]:
        """Provider-owned paged pools (None when ``shared_cache``)."""
        ...


def _artifact_x_bits(params: Any) -> Optional[int]:
    """x_bits of the first PackedWeights leaf, or None for float trees."""
    if isinstance(params, PackedWeights):
        return params.cfg.x_bits
    children = (params.values() if isinstance(params, dict) else
                params if isinstance(params, (list, tuple)) else ())
    for child in children:
        bits = _artifact_x_bits(child)
        if bits is not None:
            return bits
    return None


class TruncatedBitplaneDraft:
    """Self-draft by bit-plane truncation: every DA linear of the same frozen
    artifact evaluates only the top ``x_bits_eff`` of its ``x_bits`` input
    bit-planes (:func:`repro_torch.core.da.truncate_codes`), against the
    same weights.  ``cost_ratio = x_bits_eff / x_bits``."""

    name = "bitplane"
    shared_cache = True

    def __init__(self, cfg: ModelConfig, params: Any, x_bits_eff: int = 4):
        full = _artifact_x_bits(params)
        if full is None:
            raise ValueError(
                "truncated-bitplane self-draft needs DA-frozen params "
                "(PackedWeights leaves) — float weights have no bit-planes "
                "to truncate; freeze the model or pick another provider")
        if not 1 <= x_bits_eff <= full:
            raise ValueError(
                f"draft_x_bits={x_bits_eff} outside [1, artifact x_bits={full}]")
        self.cfg = cfg
        self.params = params
        self.x_bits_eff = x_bits_eff
        self.cost_ratio = x_bits_eff / full

    def make_step(self):
        base, bits = make_paged_step(self.cfg), self.x_bits_eff

        def step(*args):
            with engine.x_bits_override(bits):
                return base(*args)

        return step

    def init_caches(self, n_pages: int, page_size: int, device) -> None:
        return None


class LayerSkipDraft:
    """Early-exit self-draft: the first ``draft_periods`` period groups of
    the same weights, then the final norm and LM head.  The draft writes KV
    of the layers it runs (in place, in the target's pools); verify
    overwrites every layer of the window at full precision."""

    name = "layerskip"
    shared_cache = True

    def __init__(self, cfg: ModelConfig, params: Any,
                 draft_periods: Optional[int] = None):
        n = cfg.n_periods
        dp = draft_periods if draft_periods is not None else max(1, n // 2)
        if not 1 <= dp <= n:
            raise ValueError(f"draft_periods={dp} outside [1, n_periods={n}]")
        self.cfg = cfg
        self.params = params
        self.draft_periods = dp
        self.cost_ratio = dp / n

    def make_step(self):
        n_layers = self.draft_periods * self.cfg.period
        base = make_paged_step(dataclasses.replace(self.cfg, n_layers=n_layers))

        def step(params, *args):
            # the port keeps one dict per layer; caches stay whole (layer i
            # of the cut stack is layer i of the full one)
            return base({**params, "blocks": params["blocks"][:n_layers]},
                        *args)

        return step

    def init_caches(self, n_pages: int, page_size: int, device) -> None:
        return None


class ArtifactDraft:
    """A second, smaller frozen model as the drafter.  It shares the
    vocabulary and carries its own paged pools, sized and indexed like the
    target's, so one page table drives both.  The scheduler tracks what the
    draft has ingested (``draft_pos``) and catches it up each round."""

    name = "artifact"
    shared_cache = False

    def __init__(self, target_cfg: ModelConfig, draft_cfg: ModelConfig,
                 draft_params: Any):
        if draft_cfg.vocab != target_cfg.vocab:
            raise ValueError(
                f"draft vocab {draft_cfg.vocab} != target vocab "
                f"{target_cfg.vocab} — spec decoding needs one token space")
        self.cfg = draft_cfg
        self.params = draft_params
        self.cost_ratio = min(
            1.0, count_params(draft_cfg) / max(1, count_params(target_cfg)))

    def make_step(self):
        return make_paged_step(self.cfg)

    def init_caches(self, n_pages: int, page_size: int, device):
        from repro_torch.serve.kvcache import init_paged_caches

        return init_paged_caches(self.cfg, n_pages, page_size,
                                 self.cfg.dtype(), device=device)


def make_provider(spec: SpecConfig, cfg: ModelConfig, params: Any,
                  device="cuda") -> DraftProvider:
    """Resolve a SpecConfig to a provider for ``(cfg, params)``; an
    ``artifact`` draft read from disk lands on ``device``."""
    if spec.provider == "bitplane":
        return TruncatedBitplaneDraft(cfg, params, x_bits_eff=spec.draft_x_bits)
    if spec.provider == "layerskip":
        return LayerSkipDraft(cfg, params, draft_periods=spec.draft_periods)
    if spec.provider == "artifact":
        if spec.draft_params is not None:
            if spec.draft_model_cfg is None:
                raise ValueError("draft_params without draft_model_cfg — pass both")
            return ArtifactDraft(cfg, spec.draft_model_cfg, spec.draft_params)
        if spec.draft_artifact is None:
            raise ValueError(
                "provider='artifact' needs draft_artifact=DIR (a frozen "
                "DAArtifact directory) or in-memory draft_params + "
                "draft_model_cfg")
        from repro_torch.core.freeze import load_artifact

        art = load_artifact(spec.draft_artifact, device=device)
        if art.model_cfg is None:
            raise ValueError(
                f"draft artifact {spec.draft_artifact} carries no model "
                "config; freeze it with a model config")
        return ArtifactDraft(cfg, art.model_cfg, art.params)
    raise ValueError(f"unknown draft provider {spec.provider!r} "
                     "(expected bitplane | layerskip | artifact)")
