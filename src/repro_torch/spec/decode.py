"""Speculative-decoding config, acceptance math, the fused draft loop and the
verify step.

One round spends ``gamma`` draft steps at relative cost ``c`` (the
provider's ``cost_ratio``) plus one full-precision verify step over
``gamma + 1`` positions, which costs about one decode step, and yields ``m``
tokens (``1 ≤ m ≤ gamma + 1``)::

    speedup ≈ E[m] / (gamma · c + 1)        with E[m] ≈ 1 + r · gamma

for per-draft acceptance rate ``r``, so speculation pays when ``r > c``.
The scheduler keeps a per-request EMA of ``r`` and stops speculating for
requests that fall below ``disable_below`` (default ``c`` plus a margin).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding knobs for the paged scheduler.

    provider:       ``bitplane`` | ``layerskip`` | ``artifact``.
    gamma:          draft tokens per round (the verify window is gamma+1).
    draft_x_bits:   bit-planes the bitplane self-draft evaluates.
    draft_periods:  period groups the layerskip draft runs (None → half).
    draft_artifact: directory of a frozen draft DAArtifact (``artifact``).
    draft_params / draft_model_cfg: in-memory draft model (wins over the
                    directory).
    ema_alpha:      weight of the newest round in the acceptance-rate EMA.
    disable_below:  acceptance-rate floor; None → provider breakeven + 0.05.
    warmup_rounds:  rounds before the floor can disable a request.
    """

    provider: str = "bitplane"
    gamma: int = 4
    draft_x_bits: int = 4
    draft_periods: Optional[int] = None
    draft_artifact: Optional[str] = None
    draft_params: Any = None
    draft_model_cfg: Any = None
    ema_alpha: float = 0.25
    disable_below: Optional[float] = None
    warmup_rounds: int = 3

    def __post_init__(self):
        if self.gamma < 1:
            raise ValueError(f"gamma={self.gamma} must be >= 1")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha={self.ema_alpha} outside (0, 1]")


def greedy_accept(draft: Sequence[int], verify: Sequence[int]) -> int:
    """How many verify tokens survive greedy acceptance: the matched draft
    prefix plus one full-model token (the correction, or the bonus when all
    ``gamma`` drafts match).  Returns ``m`` in ``[1, gamma + 1]``; the
    accepted tokens are ``verify[:m]``."""
    if len(verify) != len(draft) + 1:
        raise ValueError(
            f"verify window of {len(verify)} tokens does not cover "
            f"{len(draft)} drafts + 1")
    m = 1
    for d, y in zip(draft, verify):
        if int(d) != int(y):
            break
        m += 1
    return m


def breakeven_acceptance(gamma: int, cost_ratio: float) -> float:
    """Per-draft acceptance rate below which a round loses throughput
    (``r* = c`` from the linear form; ``gamma`` kept for callers using the
    geometric one)."""
    del gamma
    return min(1.0, max(0.0, cost_ratio))


def mk_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """Shape positions for the model: [B, T] → [B, T, 3] under M-RoPE (the
    temporal, height and width coordinates of a text token are one)."""
    if cfg.mrope_sections:
        return torch.stack([pos, pos, pos], dim=-1)
    return pos


def make_fused_draft(step_fn, gamma: int):
    """The whole gamma-token draft loop as one call: (params, caches, tokens
    [B,T], positions, page_table, last_idx) → (drafts [B, gamma] int32,
    caches).

    The first feed is the catch-up chunk (the last accepted token, plus for
    own-cache providers what the target accepted since the draft last ran);
    the other gamma−1 proposals are single-token steps whose token and
    position stay on the device (argmax there, first max index on ties as on
    the host), so a round makes no host copy between draft steps.  Pad rows
    write past the garbage position, inside the garbage column (``gamma``
    stays below the page size on every path) and masked from every real
    row."""

    def fused(params, caches, tokens, positions, page_table, last_idx):
        logits, caches = step_fn(params, caches, tokens, positions,
                                 page_table, last_idx)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)          # [B]
        tpos = positions[..., 0] if positions.ndim == 3 else positions
        pos = torch.gather(tpos, 1, last_idx.long()[:, None])[:, 0] + 1
        drafts = [tok]
        zero = torch.zeros_like(last_idx)
        for _ in range(gamma - 1):
            nxt = pos[:, None].to(torch.int32)
            if positions.ndim == 3:  # M-RoPE: one coordinate per section
                nxt = nxt[..., None].expand(-1, -1, positions.shape[-1])
            lg, caches = step_fn(params, caches, tok[:, None], nxt,
                                 page_table, zero)
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
            drafts.append(tok)
            pos = pos + 1
        return torch.stack(drafts, dim=1), caches

    return fused


def make_paged_step(cfg: ModelConfig):
    """The serve step: (params, caches, tokens [B,T], positions, page_table
    [B,W], last_idx [B]) → (logits [B,V] of each row's last real token,
    caches).  T=1 is decode; T>1 a prefill chunk (or a draft's catch-up),
    pad columns writing to the garbage page."""

    def step(params, caches, tokens, positions, page_table, last_idx):
        logits, caches = forward(params, tokens, cfg, positions, caches,
                                 page_table, last_idx=last_idx)
        return logits[:, 0], caches

    return step


def make_verify_step(cfg: ModelConfig):
    """The full-precision verify step: (params, caches, tokens [B,T],
    positions, page_table) → (logits [B,T,V], caches).  Keeps the logits of
    every position and writes full-precision KV for all of them, over the
    draft's rows."""

    def verify(params, caches, tokens, positions, page_table):
        return forward(params, tokens, cfg, positions, caches, page_table)

    return verify
