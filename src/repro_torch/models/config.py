"""Model configuration covering every family of the reference's zoo.

Field names and defaults follow the reference ``ModelConfig``: the dense
attention family (SwiGLU, GELU and squared-ReLU MLPs, RMS norm or
LayerNorm, optional q/k/v biases, 1-D RoPE or M-RoPE, token or embedding
inputs), Mixture-of-Experts FFNs (``moe``), Mamba-2 mixers (``ssm``) and
the attention:Mamba interleave (``hybrid``).  Layers group into periods of
the layer pattern (:attr:`ModelConfig.period`); :meth:`mixer_kind` and
:meth:`ffn_kind` say what each position of a period holds.  An artifact
manifest's ``model_cfg`` (the reference's full field set) reads through
:meth:`ModelConfig.from_manifest`, which refuses any field that would change
the model and that the port does not implement.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

#: The reference's fields that the port's config does not carry, with their
#: reference defaults.  A manifest may hold them at these values.
_REFERENCE_ONLY: Dict[str, Any] = {
    "tie_embeddings": False, "scan_unroll": False, "prefill_last_only": False,
}

#: Of those, the ones that do not change what a model computes, at any value:
#: a compile knob, and the prefill head slice (serving always slices the
#: last token).
_INERT = {"scan_unroll", "prefill_last_only"}

#: the families the reference defines
FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _refuse_family(name, family) -> None:
    if family not in FAMILIES:
        raise ValueError(f"{name}: unknown family {family!r}; expected one "
                         f"of {FAMILIES}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid
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

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    moe_period: int = 1            # MoE replaces the MLP every k-th layer
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_dropless: bool = False     # capacity = group size (exact; serving)
    moe_group_size: int = 1024     # token-group size; capacity is per group

    # Mamba2 / SSD
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256

    # hybrid interleave (jamba): 1 attention layer per attn_period layers
    attn_period: int = 0
    attn_offset: int = 0

    # numerics / execution
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True                # recompute each block in the backward
    remat_policy: str = "nothing"     # nothing | dots: what a block saves
    attn_chunk_q: int = 0             # 0 → naive attention; else KV chunk of
                                      # the online-softmax prefill
    attn_mask_mode: str = "where"     # where | additive
    softmax_dtype: str = "float32"    # float32 | bfloat16 score pipeline
    moe_impl: str = "dense"           # dense (one-hot dispatch) | sorted
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
        config.  Raises on an unknown family or field, or a reference field
        away from its default that would change the model."""
        _refuse_family(raw.get("name"), raw.get("family"))
        ours = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(raw) - ours - set(_REFERENCE_ONLY))
        if unknown:
            raise ValueError(f"model_cfg has fields {unknown} that neither "
                             "the port nor the reference defines")
        changed = sorted(
            k for k in set(raw) - ours
            if k not in _INERT and raw[k] != _REFERENCE_ONLY[k])
        if changed:
            raise NotImplementedError(
                f"{raw.get('name')}: model_cfg sets "
                f"{ {k: raw[k] for k in changed} }, which the port does not "
                "implement")
        return cls(**{k: v for k, v in raw.items() if k in ours})

    def with_levers(self, **levers) -> "ModelConfig":
        """``dataclasses.replace`` by the reference's config levers (the
        §Perf variants): a reference-only lever that changes nothing here
        (``scan_unroll``; ``prefill_last_only``, as the port's prefill
        always slices the last position) is dropped, any other unknown
        field raises."""
        return dataclasses.replace(
            self, **{k: v for k, v in levers.items() if k not in _INERT})

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
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_channels(self) -> int:
        """Mamba-2 convolves x together with the B and C streams."""
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    @property
    def period(self) -> int:
        """Layer-pattern period: 1 for homogeneous stacks; the hybrid's
        attention period and the MoE period combine by their lcm."""
        p = 1
        if self.family == "hybrid" and self.attn_period:
            p = self.attn_period
        if self.n_experts and self.moe_period > 1:
            p = math.lcm(p, self.moe_period)
        return p

    @property
    def n_periods(self) -> int:
        if self.n_layers % self.period:
            raise ValueError(f"{self.name}: {self.n_layers} layers are not "
                             f"whole periods of {self.period}")
        return self.n_layers // self.period

    def mixer_kind(self, pos: int) -> str:
        """Mixer of layer position ``pos`` within a period: attn | mamba."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            return "attn" if pos % self.attn_period == self.attn_offset else "mamba"
        return "attn"

    def ffn_kind(self, pos: int) -> str:
        """FFN of layer position ``pos``: mlp | moe | none."""
        if self.family == "ssm":
            return "none"
        if self.n_experts and pos % self.moe_period == self.moe_offset:
            return "moe"
        return "mlp"

    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)
