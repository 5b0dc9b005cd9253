"""Shared layers: RMS norm and LayerNorm, rotary embeddings (1-D RoPE and
M-RoPE), the SwiGLU, GELU and squared-ReLU MLPs, embedding and LM head.

Each ``init_*`` draws from an explicit ``torch.Generator`` on the target
device, with the reference's shapes and scales.  Norms compute in float32 and
cast back; RoPE casts cos/sin to the activation dtype before multiplying, as
the reference does.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.engine import dense
from repro_torch.models.config import ModelConfig


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype) -> torch.Tensor:
    """``scale`` × standard normal drawn from ``gen`` on its device (on the
    meta device: the shape and dtype alone)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(cfg: ModelConfig, dim: int, device) -> dict:
    p = {"scale": torch.ones((dim,), dtype=cfg.pdtype(), device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=cfg.pdtype(), device=device)
    return p


def _mean_square(xf: torch.Tensor) -> torch.Tensor:
    """Float32 mean of squares over the last dim, summed in float64.  CUDA's
    reduction splits a row among threads by how many rows the call holds,
    so a float32 sum would round a row differently in a decode step and in
    a verify or prefill step; the float64 sum rounds to the same float32 in
    all but a vanishing share of rows, whatever the batch."""
    return torch.mean(torch.square(xf.to(torch.float64)), dim=-1,
                      keepdim=True).to(torch.float32)


def _row_mean(xf: torch.Tensor) -> torch.Tensor:
    """Float32 mean over the last dim, summed in float64 as the sum of
    squares is (:func:`_mean_square`), for the same row invariance."""
    return torch.mean(xf.to(torch.float64), dim=-1, keepdim=True).to(torch.float32)


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMS norm, or LayerNorm (mean removed first, then a bias), in
    float32."""
    xf = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        xf = xf - _row_mean(xf)
    y = xf * torch.rsqrt(_mean_square(xf) + cfg.norm_eps)
    y = y * p["scale"].to(torch.float32)
    if cfg.norm_type == "layernorm":
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def rms_norm_headwise(x: torch.Tensor, scale: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """Per-head RMS norm over head_dim (qwen3 qk-norm)."""
    xf = x.to(torch.float32)
    y = xf * torch.rsqrt(_mean_square(xf) + eps) * scale.to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (1-D RoPE and qwen2-vl M-RoPE)
# ---------------------------------------------------------------------------
def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                sections: Optional[Sequence[int]] = None) -> torch.Tensor:
    """positions: [B, T] (1-D RoPE) or [B, T, 3] (M-RoPE) → angles
    [B, T, hd/2] in float32.  Under M-RoPE the frequency bands are split
    into ``sections`` (summing to hd/2), each rotated by its own position
    coordinate (t, h, w); ``[B, T]`` positions (text) feed all three."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    inv = 1.0 / (theta ** exps)
    if sections is None:
        if positions.ndim == 3:
            positions = positions[..., 0]
        return positions.to(torch.float32)[..., None] * inv
    if positions.ndim == 2:
        positions = torch.stack([positions] * len(sections), dim=-1)
    if positions.ndim != 3 or positions.shape[-1] != len(sections):
        raise ValueError(f"M-RoPE positions of shape {tuple(positions.shape)} "
                         f"for {len(sections)} sections")
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    parts, off = [], 0
    for i, sec in enumerate(sections):
        p = positions[..., i].to(torch.float32)
        parts.append(p[..., None] * inv[off:off + sec])
        off += sec
    return torch.cat(parts, dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, hd]; angles: [B, T, hd/2] (broadcast over heads)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU / squared-ReLU)
# ---------------------------------------------------------------------------
MLP_ACTS = ("swiglu", "gelu", "relu2")


def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_model: int,
             d_ff: int) -> dict:
    """``w_up`` and ``w_down``, and ``w_gate`` for the gated SwiGLU only."""
    if cfg.mlp_act not in MLP_ACTS:
        raise ValueError(f"unknown mlp_act {cfg.mlp_act!r}; expected one of "
                         f"{MLP_ACTS}")
    dt = cfg.pdtype()
    s_in, s_out = 1.0 / (d_model ** 0.5), 1.0 / (d_ff ** 0.5)
    p = {"w_up": normal_init(gen, (d_model, d_ff), s_in, dt),
         "w_down": normal_init(gen, (d_ff, d_model), s_out, dt)}
    if cfg.mlp_act == "swiglu":
        p["w_gate"] = normal_init(gen, (d_model, d_ff), s_in, dt)
    return p


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """GELU is the tanh form (``jax.nn.gelu``'s default)."""
    up = dense(x, p["w_up"])
    if cfg.mlp_act == "swiglu":
        h = F.silu(dense(x, p["w_gate"])) * up
    elif cfg.mlp_act == "gelu":
        h = F.gelu(up, approximate="tanh")
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(up))
    else:
        raise ValueError(cfg.mlp_act)
    return dense(h, p["w_down"])


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def init_embed(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"table": normal_init(gen, (cfg.vocab, cfg.d_model), 0.02, cfg.pdtype())}


def apply_embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["table"][tokens.long()]


def init_lm_head(gen: torch.Generator, cfg: ModelConfig) -> dict:
    s = 1.0 / (cfg.d_model ** 0.5)
    return {"w": normal_init(gen, (cfg.d_model, cfg.vocab), s, cfg.pdtype())}


def apply_lm_head(p, x: torch.Tensor) -> torch.Tensor:
    return dense(x, p["w"])
