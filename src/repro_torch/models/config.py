"""Model configuration of the dense attention family (qwen3-style).

Field names and defaults follow the reference ``ModelConfig``; the port
covers the dense attention family only (MoE, Mamba and M-RoPE arrive with
later slices), so every layer position is an attention mixer with an MLP.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense
    n_layers: int
    d_model: int
    vocab: int

    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0              # 0 → d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0

    # dense SwiGLU MLP, RMS norms
    d_ff: int = 0

    # numerics / execution
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_mask_mode: str = "where"     # where | additive
    softmax_dtype: str = "float32"    # float32 | bfloat16 score pipeline
    paged_attn: str = "auto"          # auto (fused on CUDA, gather on CPU)
                                      # | gather | fused
    kv_dtype: str = "fp16"            # fp16 (compute-dtype pages) | int8 |
                                      # int4, with in-page dequant scales

    def __post_init__(self):
        if self.family != "dense":
            raise NotImplementedError(
                f"{self.name}: family {self.family!r} is not ported yet (the "
                "port covers dense attention models)")

    # ---- derived ------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim_

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim_

    @property
    def period(self) -> int:
        """Layer-pattern period (1: a homogeneous dense stack)."""
        return 1

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)
