"""LM assembly: a Python loop over the layers of a transformer, SSM, MoE or
hybrid stack.

Parameters are a dict ``{"embed", "blocks": [per-layer dict], "final_norm",
"lm_head"}``; the reference stacks each layer position over periods and
scans, the port keeps one dict per layer (see ``repro_torch.convert``).
Block ``i`` sits at position ``i % period`` of the layer pattern, whose
mixer (attention or Mamba-2) and FFN (MLP, MoE or none) the config names.
Configs with ``modality`` audio or vlm have no ``embed`` table: their
frontends are stubs, and the backbone takes precomputed frame or patch
embeddings ``[B, T, d_model]`` in place of token ids.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    KVCache,
    attention_forward,
    causal_bias,
    init_attention,
)
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
from repro_torch.models.mamba2 import MambaCache, init_mamba, mamba_forward
from repro_torch.models.moe import init_moe, moe_forward, padded_experts

Params = Dict[str, Any]


def init_block(gen: torch.Generator, cfg: ModelConfig, pos: int = 0) -> Params:
    """The block at layer position ``pos``: a pre-norm and the position's
    mixer, then (unless the FFN is ``none``) a pre-norm and its MLP or MoE."""
    dev = gen.device
    mixer, ffn = cfg.mixer_kind(pos), cfg.ffn_kind(pos)
    p: Params = {"norm_mixer": init_norm(cfg, cfg.d_model, dev),
                 "mixer": (init_attention(gen, cfg) if mixer == "attn"
                           else init_mamba(gen, cfg))}
    if ffn != "none":
        p["norm_ffn"] = init_norm(cfg, cfg.d_model, dev)
        p["ffn"] = (init_moe(gen, cfg) if ffn == "moe"
                    else init_mlp(gen, cfg, cfg.d_model, cfg.d_ff))
    return p


def block_forward(p, x: torch.Tensor, cfg: ModelConfig, pos: int, positions,
                  cache=None, page_table=None, *, update_cache: bool = False,
                  attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = apply_norm(p["norm_mixer"], x, cfg)
    if cfg.mixer_kind(pos) == "attn":
        y = attention_forward(p["mixer"], h, cfg, positions, cache, page_table,
                              update_cache=update_cache, attn_bias=attn_bias)
    else:
        y = mamba_forward(p["mixer"], h, cfg, cache, update_cache)
    x = x + y
    ffn = cfg.ffn_kind(pos)
    if ffn == "none":
        return x
    h = apply_norm(p["norm_ffn"], x, cfg)
    return x + (moe_forward(p["ffn"], h, cfg) if ffn == "moe"
                else apply_mlp(p["ffn"], h, cfg))


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights with the reference's shapes and scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _init_tree(gen, cfg)


def _init_tree(gen, cfg: ModelConfig) -> Params:
    params = {"blocks": [init_block(gen, cfg, i % cfg.period)
                         for i in range(cfg.n_layers)],
              "final_norm": init_norm(cfg, cfg.d_model, gen.device),
              "lm_head": init_lm_head(gen, cfg)}
    if cfg.modality == "text":
        params["embed"] = init_embed(gen, cfg)
    return params


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                device="cuda") -> Params:
    """Decode caches stacked over periods on ``device``: ``{"pos_i":
    KVCache [n_periods, batch, max_len, kv, hd]}`` at attention positions,
    ``MambaCache [n_periods, batch, ...]`` at Mamba positions."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype()
    stack = (cfg.n_periods,)
    return {f"pos_{pos}": (
        KVCache.zeros(cfg, batch, max_len, dtype, device=dev, stack=stack)
        if cfg.mixer_kind(pos) == "attn"
        else MambaCache.zeros(cfg, batch, dtype, device=dev, stack=stack))
        for pos in range(cfg.period)}


def forward(params: Params, inputs: torch.Tensor, cfg: ModelConfig,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Params] = None,
            page_table: Optional[torch.Tensor] = None,
            last_idx: Optional[torch.Tensor] = None, *,
            update_cache: bool = False, last_logit_only: bool = False):
    """inputs: tokens [B, T] int, or embeddings [B, T, D] (audio and vlm
    configs).  positions: int32 [B, T] (pad lanes carry the garbage
    position), or [B, T, 3] under M-RoPE; None counts 0..T-1.

    caches: None (causal self-attention over the segment), dense
    ``{"pos_i": KVCache | MambaCache}`` from :func:`init_caches`
    (``update_cache``: a prefill into an empty cache; else decode over the
    cache), or paged ``{"pos_i": PagedKVCache}`` with ``page_table`` int32
    [B, W] (attention stacks only).  Caches are updated in place.

    ``last_idx`` int [B]: per-row index of the last real token, gathered
    before the LM head (logits [B, 1, V]); ``last_logit_only`` keeps the
    last position.  Returns (logits, caches)."""
    if inputs.ndim == 2:
        h = apply_embed(params["embed"], inputs)
    else:
        h = inputs.to(cfg.dtype())
    b, t = h.shape[0], h.shape[1]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=h.device)[None].expand(b, t)
    attn_bias = (causal_bias(t, device=h.device)
                 if cfg.attn_impl == "lean" and t > 1 else None)
    for layer, bp in enumerate(params["blocks"]):
        pos, cache = layer % cfg.period, None
        if caches is not None:
            cache = caches[f"pos_{pos}"].layer(layer // cfg.period)
        h = block_forward(bp, h, cfg, pos, positions, cache, page_table,
                          update_cache=update_cache, attn_bias=attn_bias)
    if last_idx is not None:
        rows = torch.arange(h.shape[0], device=h.device)
        h = h[rows, last_idx.long()][:, None]
    elif last_logit_only:
        h = h[:, -1:]
    h = apply_norm(params["final_norm"], h, cfg)
    return apply_lm_head(params["lm_head"], h), caches


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


class _ShapeGen:
    """Stands in for a generator on the meta device: the init functions
    then build tensors with shapes and dtypes and no data."""

    device = torch.device("meta")


def count_params(cfg: ModelConfig) -> int:
    """Parameters of :func:`init_model`'s tree for ``cfg``, counted from the
    tree's shapes (built on the meta device, no bytes)."""
    def leaves(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                yield from leaves(v)
        elif isinstance(tree, list):
            for v in tree:
                yield from leaves(v)
        else:
            yield tree

    return sum(math.prod(x.shape) for x in leaves(_init_tree(_ShapeGen(), cfg)))


def count_active_params(cfg: ModelConfig) -> int:
    """Active parameters: the routed experts count ``top_k`` of their
    (padded) number, as the reference's roofline counts them."""
    total = count_params(cfg)
    if not cfg.n_experts:
        return total
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    n_moe = cfg.n_periods * sum(cfg.ffn_kind(pos) == "moe"
                                for pos in range(cfg.period))
    return total - n_moe * (padded_experts(cfg) - cfg.top_k) * per_expert
