"""Registry of the port's model configurations (public-literature sources
inline in each config module)."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, ModelConfig] = {}


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU tests, the reference's reduction:
    one period of layers (2 for a homogeneous stack), d_model 64, 4 heads
    over 2 KV heads of 16 (32 under M-RoPE, sections (4, 6, 6)), d_ff 128,
    6 experts, top-2, expert d_ff 32 (2 shared when the config shares),
    SSM state 16, SSM head dim 8, SSD chunk 8, vocab 97, float32."""
    changes: dict = dict(n_layers=cfg.period if cfg.period > 1 else 2,
                         d_model=64, vocab=97, param_dtype="float32",
                         compute_dtype="float32")
    if cfg.n_heads:
        changes.update(n_heads=4,
                       n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
                       head_dim=32 if cfg.mrope_sections else 16)
    if cfg.mrope_sections:
        changes["mrope_sections"] = (4, 6, 6)  # sums to head_dim/2 = 16
    if cfg.d_ff:
        changes["d_ff"] = 128
    if cfg.n_experts:
        changes.update(n_experts=6, top_k=2, moe_d_ff=32)
        if cfg.n_shared_experts:
            changes["n_shared_experts"] = 2
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=8)
    return dataclasses.replace(cfg, **changes)


def register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    return ARCHS[name]


def _load_all() -> None:
    from repro_torch.configs import (  # noqa: F401
        jamba_1_5_large_398b,
        mamba2_780m,
        minitron_8b,
        mistral_nemo_12b,
        moonshot_v1_16b_a3b,
        musicgen_large,
        phi3_medium_14b,
        qwen2_moe_a2_7b,
        qwen2_vl_72b,
        qwen3_8b,
    )


_load_all()
