"""LM assembly: a Python loop over the layers of a dense attention stack.

Parameters are a dict ``{"embed", "blocks": [per-layer dict], "final_norm",
"lm_head"}``; the reference stacks each layer position over periods and
scans, the port keeps one dict per layer (see ``repro_torch.convert``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import PagedKVCache, attention_forward, init_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_embed,
    apply_lm_head,
    apply_mlp,
    apply_norm,
    init_embed,
    init_lm_head,
    init_mlp,
    init_norm,
)

Params = Dict[str, Any]


def init_block(gen: torch.Generator, cfg: ModelConfig) -> Params:
    dev = gen.device
    return {"norm_mixer": init_norm(cfg, cfg.d_model, dev),
            "mixer": init_attention(gen, cfg),
            "norm_ffn": init_norm(cfg, cfg.d_model, dev),
            "ffn": init_mlp(gen, cfg, cfg.d_model, cfg.d_ff)}


def block_forward(p, x: torch.Tensor, cfg: ModelConfig, positions,
                  cache: PagedKVCache, page_table) -> torch.Tensor:
    h = apply_norm(p["norm_mixer"], x, cfg)
    x = x + attention_forward(p["mixer"], h, cfg, positions, cache, page_table)
    h = apply_norm(p["norm_ffn"], x, cfg)
    return x + apply_mlp(p["ffn"], h, cfg)


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights with the reference's shapes and scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {"blocks": [init_block(gen, cfg) for _ in range(cfg.n_layers)],
            "final_norm": init_norm(cfg, cfg.d_model, dev),
            "lm_head": init_lm_head(gen, cfg),
            "embed": init_embed(gen, cfg)}


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor, caches: Dict[str, PagedKVCache],
            page_table: torch.Tensor, last_idx: Optional[torch.Tensor] = None):
    """tokens [B, T] int; positions [B, T] int32 (pad lanes carry the
    garbage position); caches ``{"pos_0": PagedKVCache[n_periods, ...]}``
    updated in place; page_table int32 [B, W].

    ``last_idx`` int [B]: per-row index of the last real token, gathered
    before the LM head (logits [B, 1, V]).  Returns (logits, caches)."""
    h = apply_embed(params["embed"], tokens)
    for layer, bp in enumerate(params["blocks"]):
        pos, pidx = layer % cfg.period, layer // cfg.period
        cache = caches[f"pos_{pos}"].layer(pidx)
        h = block_forward(bp, h, cfg, positions, cache, page_table)
    if last_idx is not None:
        rows = torch.arange(h.shape[0], device=h.device)
        h = h[rows, last_idx.long()][:, None]
    h = apply_norm(params["final_norm"], h, cfg)
    return apply_lm_head(params["lm_head"], h), caches


def count_params(cfg: ModelConfig) -> int:
    """Parameters of :func:`init_model`'s tree for ``cfg``, from the shapes."""
    d, hd = cfg.d_model, cfg.head_dim_
    attn = 2 * d * cfg.q_dim + 2 * d * cfg.kv_dim + (2 * hd if cfg.qk_norm else 0)
    block = 2 * d + attn + 3 * d * cfg.d_ff
    return cfg.n_layers * block + d + 2 * cfg.vocab * d
