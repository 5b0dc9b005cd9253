"""A configuration file's model, in the benchmark's own terms.

``bench/configs/<name>.json`` holds the model as it is run under
``config`` (the published ``config.json`` keys, changed only where
``reduced`` says) and the layout facts that file does not state under
``layout``.  :class:`ModelDesc` reads both; the weight generator, the
reference and the operation counts take it, and nothing of the program.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict

BENCH = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class ModelDesc:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    vocab: int
    norm_type: str            # layernorm | rmsnorm
    norm_eps: float
    rope_theta: float
    mlp_act: str              # relu2 | swiglu
    d_ff: int = 0
    attn_bias: bool = False
    n_experts: int = 0
    n_experts_padded: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0
    norm_topk_prob: bool = True

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


def desc_from_file(cfg: Dict[str, Any]) -> ModelDesc:
    """The :class:`ModelDesc` of a loaded configuration file."""
    c, lay = cfg["config"], cfg["layout"]
    moe = "num_experts" in c
    return ModelDesc(
        n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        head_dim=c["head_dim"], vocab=c["vocab_size"],
        norm_type=lay["norm_type"],
        norm_eps=c.get("norm_eps", c.get("rms_norm_eps")),
        rope_theta=float(c["rope_theta"]), mlp_act=lay["mlp_act"],
        d_ff=0 if moe else c["intermediate_size"],
        attn_bias=lay["attn_bias"],
        n_experts=c.get("num_experts", 0),
        n_experts_padded=lay.get("n_experts_padded", 0),
        top_k=c.get("num_experts_per_tok", 0),
        moe_d_ff=c.get("moe_intermediate_size", 0),
        shared_d_ff=c.get("shared_expert_intermediate_size", 0),
        norm_topk_prob=c.get("norm_topk_prob", True))


def load_json(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
