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
from repro_torch.launch.sharding import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    block_of,
    constrain,
    replicated,
)
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
    all but a vanishing share of rows, whatever the batch.  Where no
    gradient is recorded the square is taken in place, one float64 copy
    of the rows alive instead of two (the same values)."""
    x64 = xf.to(torch.float64)
    sq = (torch.square(x64) if torch.is_grad_enabled() and x64.requires_grad
          else x64.square_())
    return torch.mean(sq, dim=-1, keepdim=True).to(torch.float32)


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
    """GELU is the tanh form (``jax.nn.gelu``'s default).  One name holds
    the up projection and then the activation, so neither outlives its use
    (the gate's product is a temporary)."""
    h = constrain(dense(x, p["w_up"]), ("batch", "seq", "ffn"))
    if cfg.mlp_act == "swiglu":
        h = F.silu(constrain(dense(x, p["w_gate"]), ("batch", "seq", "ffn"))) * h
    elif cfg.mlp_act == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(cfg.mlp_act)
    return constrain(dense(h, p["w_down"]), ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# Embedding / LM head
# ---------------------------------------------------------------------------
def init_embed(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"table": normal_init(gen, (cfg.vocab, cfg.d_model), 0.02, cfg.pdtype())}


def apply_embed(p, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``tokens``; a table placed on a mesh reads
    through :func:`_vocab_parallel_rows` when its vocab is sharded, else
    through ``F.embedding``."""
    table = p["table"]
    if not isinstance(table, DTensor):
        rows = table[tokens.long()]
    elif any(isinstance(pl, Shard) and pl.dim == 0 for pl in table.placements):
        rows = _vocab_parallel_rows(table, tokens)
    else:
        rows = F.embedding(tokens.long(), table)
    return constrain(rows, ("batch", "seq", "embed"))


def _vocab_parallel_rows(table, tokens: torch.Tensor):
    """The vocab-parallel lookup: each rank reads the ids that fall in its
    slice of the vocab (zeros for the others), and the ranks' rows are a
    ``Partial`` sum over the vocab's mesh dim — one non-zero term each, so
    the sum is exact.  Ids placed on a mesh keep their batch rows where
    they are sharded (each rank looks up its own rows only).  Its backward
    gives each rank the gradient of its own rows.  (DTensor's own strategy
    for an embedding on a vocab-sharded table has no backward: it cannot
    turn a ``Partial`` gradient into its masked partial.)"""
    mesh = table.device_mesh
    vocab_dims = [i for i, pl in enumerate(table.placements)
                  if isinstance(pl, Shard) and pl.dim == 0]
    if len(vocab_dims) != 1:
        return replicated(F.embedding, tokens.long(), table)
    (vd,) = vocab_dims
    rows_pl = [Shard(0) if i != vd and pl == Shard(0) else Replicate()
               for i, pl in enumerate(tokens.placements if isinstance(tokens, DTensor)
                                      else [Replicate()] * mesh.ndim)]
    ids = block_of(tokens, mesh, rows_pl).long()
    # the table's gradient from this rank's rows is a part of the whole
    rows = block_of(table, mesh, [pl if i == vd else Replicate()
                                  for i, pl in enumerate(table.placements)],
                    partial_on=[i for i, p in enumerate(rows_pl) if p == Shard(0)])
    start = mesh.get_local_rank(vd) * rows.shape[0]
    ids = ids - start
    outside = (ids < 0) | (ids >= rows.shape[0])
    out = F.embedding(torch.where(outside, 0, ids), rows)
    out = torch.where(outside[..., None], torch.zeros((), dtype=out.dtype,
                                                      device=out.device), out)
    return DTensor.from_local(out, mesh, [Partial() if i == vd else pl
                                          for i, pl in enumerate(rows_pl)],
                              run_check=False)


def init_lm_head(gen: torch.Generator, cfg: ModelConfig) -> dict:
    s = 1.0 / (cfg.d_model ** 0.5)
    return {"w": normal_init(gen, (cfg.d_model, cfg.vocab), s, cfg.pdtype())}


def apply_lm_head(p, x: torch.Tensor) -> torch.Tensor:
    return constrain(dense(x, p["w"]), ("batch", "seq", "vocab"))
