"""A configuration file's model, in the benchmark's own terms.

``bench/configs/<name>.json`` holds the model as it is run under
``config`` (the published ``config.json`` keys, changed only where
``reduced`` says) and the layout facts that file does not state under
``layout``.  :class:`ModelDesc` reads both; the weight generator, the
reference and the operation counts take it, and nothing of the program.

A configuration whose model the built-in generator and reference do not
describe names a model module of its own under ``model`` (a path under
``bench/``); :func:`model_of` gives either as one :class:`Model`.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from typing import Any, Callable, Dict, List, NamedTuple, Optional

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
    #: a model module's own count of the parameters a token runs through
    #: (``bench.yardstick.matmul_params`` where None)
    matmul_params: Optional[Callable] = dataclasses.field(default=None, compare=False,
                                                          repr=False)

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


#: the functions a model module defines (``matmul_params`` is optional)
MODEL_FUNCTIONS = ("desc", "make_params", "logits_at")


class Model(NamedTuple):
    """A configuration's model as the harness uses it: its desc, the
    weights drawn from the seed (``bench.weights.make_params``'s contract)
    and the plain reference's logits (``bench.reference.logits_at``'s)."""

    desc: ModelDesc
    make_params: Callable
    logits_at: Callable


def load_model_module(path: str):
    """The model module ``bench/<path>``, loaded by its path."""
    file = BENCH / path
    name = "bench_model_" + "".join(c if c.isalnum() else "_" for c in path)
    spec = importlib.util.spec_from_file_location(name, file)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # a dataclass's module must be importable
    spec.loader.exec_module(mod)
    return mod


def model_of(config: Dict[str, Any]) -> Model:
    """The built-in model of a configuration file without a ``model`` key
    (:func:`desc_from_file`, ``bench.weights.make_params``,
    ``bench.reference.logits_at``), else its model module's."""
    if "model" not in config:
        from bench import reference, weights

        return Model(desc_from_file(config), weights.make_params, reference.logits_at)
    mod = load_model_module(config["model"])
    desc = mod.desc(config)
    if hasattr(mod, "matmul_params"):
        desc = dataclasses.replace(desc, matmul_params=mod.matmul_params)
    return Model(desc, mod.make_params, mod.logits_at)


def model_problems(path: str) -> List[str]:
    """What is wrong with the model module ``bench/<path>`` (empty when
    nothing is)."""
    file = (BENCH / path).resolve()
    if BENCH not in file.parents or not file.is_file():
        return [f"model module {path!r}: no such file under bench/"]
    try:
        mod = load_model_module(path)
    except Exception as e:           # reported, as every other problem is
        return [f"model module {path!r} does not load: {e!r}"]
    return [f"model module {path!r} lacks {name}()" for name in MODEL_FUNCTIONS
            if not callable(getattr(mod, name, None))]


def load_json(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
