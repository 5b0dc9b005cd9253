"""Model configuration of the dense attention family.

Field names and defaults follow the reference ``ModelConfig``; the port
covers the dense family (SwiGLU, GELU and squared-ReLU MLPs, RMS norm or
LayerNorm, optional q/k/v biases, 1-D RoPE or M-RoPE, token or embedding
inputs); MoE, Mamba and the hybrid stack arrive with later slices, so every
layer position is an attention mixer with an MLP.  An artifact manifest's
``model_cfg`` (the reference's full field set) reads through
:meth:`ModelConfig.from_manifest`, which refuses any field that would change
the model and that the port does not implement.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

#: The reference's fields that the port's config does not carry, with their
#: reference defaults.  A manifest may hold them at these values.
_REFERENCE_ONLY: Dict[str, Any] = {
    "n_experts": 0, "top_k": 0, "moe_d_ff": 0, "n_shared_experts": 0,
    "moe_period": 1, "moe_offset": 0, "capacity_factor": 1.25,
    "moe_dropless": False, "moe_group_size": 1024,
    "ssm_state": 0, "ssm_head_dim": 64, "ssm_conv": 4, "ssm_expand": 2,
    "ssm_groups": 1, "ssm_chunk": 256, "attn_period": 0, "attn_offset": 0,
    "remat": True, "remat_policy": "nothing",
    "tie_embeddings": False, "scan_unroll": False, "prefill_last_only": False,
    "moe_impl": "dense",
}

#: Of those, the ones that do not change what a dense model computes, at any
#: value: training and compile knobs, the MoE knobs without experts
#: (``n_experts`` 0), the Mamba and hybrid knobs of a family without Mamba
#: layers, and the prefill head slice (serving always slices the last token).
_INERT_WHEN_DENSE = {
    "remat", "remat_policy", "scan_unroll", "prefill_last_only",
    "top_k", "moe_d_ff", "n_shared_experts", "moe_period", "moe_offset",
    "capacity_factor", "moe_dropless", "moe_group_size", "moe_impl",
    "ssm_state", "ssm_head_dim", "ssm_conv", "ssm_expand", "ssm_groups",
    "ssm_chunk", "attn_period", "attn_offset",
}

#: the ROADMAP item that ports each family the port refuses
_FAMILY_ITEM = {"moe": "ROADMAP Queue 1 item 4, MoE",
                "ssm": "ROADMAP Queue 1 item 4, Mamba2",
                "hybrid": "ROADMAP Queue 1 item 4, hybrid"}


def _refuse_family(name, family) -> None:
    if family != "dense":
        raise NotImplementedError(
            f"{name}: family {family!r} is not ported yet "
            f"({_FAMILY_ITEM.get(family, 'no ROADMAP item')}); the port "
            "covers dense attention models")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense
    n_layers: int
    d_model: int
    vocab: int
    modality: str = "text"         # text | audio | vlm (embedding inputs)

    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0              # 0 → d_model // n_heads
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # M-RoPE (qwen2-vl)

    # dense MLP
    d_ff: int = 0
    mlp_act: str = "swiglu"        # swiglu | gelu | relu2
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm

    # numerics / execution
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    attn_chunk_q: int = 0             # 0 → naive attention; else KV chunk of
                                      # the online-softmax prefill
    attn_mask_mode: str = "where"     # where | additive
    softmax_dtype: str = "float32"    # float32 | bfloat16 score pipeline
    attn_impl: str = "reference"      # reference | lean (the no-cache path)
    cache_mode: str = "scatter"       # dense-cache write: scatter (ragged
                                      # rows) | slice (uniform positions)
    paged_attn: str = "auto"          # auto (fused on CUDA, gather on CPU)
                                      # | gather | fused
    kv_dtype: str = "fp16"            # fp16 (compute-dtype pages) | int8 |
                                      # int4, with in-page dequant scales

    def __post_init__(self):
        _refuse_family(self.name, self.family)
        if self.mrope_sections is not None:  # a manifest's JSON list
            object.__setattr__(self, "mrope_sections",
                               tuple(self.mrope_sections))

    # ---- artifact manifests ---------------------------------------------------
    def to_manifest(self) -> Dict[str, Any]:
        """The manifest's ``model_cfg``: only field names the reference's
        ``ModelConfig(**raw)`` accepts."""
        return dataclasses.asdict(self)

    @classmethod
    def from_manifest(cls, raw: Dict[str, Any]) -> "ModelConfig":
        """A manifest's ``model_cfg`` (the reference's fields) as the port's
        config.  Raises on a non-dense family, an unknown field, or a
        reference field away from its default that would change the model."""
        _refuse_family(raw.get("name"), raw.get("family"))
        ours = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(raw) - ours - set(_REFERENCE_ONLY))
        if unknown:
            raise ValueError(f"model_cfg has fields {unknown} that neither "
                             "the port nor the reference defines")
        changed = sorted(
            k for k in set(raw) - ours
            if k not in _INERT_WHEN_DENSE and raw[k] != _REFERENCE_ONLY[k])
        if changed:
            raise NotImplementedError(
                f"{raw.get('name')}: model_cfg sets "
                f"{ {k: raw[k] for k in changed} }, which the port does not "
                "implement")
        return cls(**{k: v for k, v in raw.items() if k in ours})

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

    def mixer_kind(self, pos: int) -> str:
        """Mixer of layer position ``pos``: attention throughout."""
        return "attn"

    @property
    def n_periods(self) -> int:
        return self.n_layers // self.period

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)
