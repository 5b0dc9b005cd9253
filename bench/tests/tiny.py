"""Tiny stand-ins for the cells' configuration and mix files, for runs on
the CPU: the same families at widths a test holds."""
from __future__ import annotations

import copy
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]


def _load(path):
    with open(BENCH / path) as f:
        return json.load(f)


def config_file(name: str) -> str:
    """A cell's configuration, or, for a family no cell serves yet (the
    port's MoE), its stand-in under ``tests/configs``."""
    own = f"configs/{name}.json"
    return own if (BENCH / own).exists() else f"tests/{own}"


def tiny_config(name: str) -> dict:
    """``bench/configs/<name>.json`` at test widths: 2 layers, d 64, heads
    of 16 in the source's ratio of query to KV heads (4 over 4 for MHA, 6
    over 1 for minitron's 48 over 8, so its queries are wider than d as
    there), vocab 97; experts 6 of width 32 (padded to 16), top-2, shared
    64."""
    cfg = copy.deepcopy(_load(config_file(name)))
    c, lay = cfg["config"], cfg["layout"]
    g = c["num_attention_heads"] // c["num_key_value_heads"]
    kv = 4 if g == 1 else 2 if g <= 4 else 1
    c.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=g * kv,
             num_key_value_heads=kv, head_dim=16, vocab_size=97)
    ov = dict(cfg.get("overrides", {}), n_layers=2, d_model=64, vocab=97,
              n_heads=g * kv, n_kv_heads=kv, head_dim=16,
              param_dtype="bfloat16", compute_dtype="bfloat16")
    if "num_experts" in c:
        c.update(num_experts=6, num_experts_per_tok=2, moe_intermediate_size=32,
                 shared_expert_intermediate_size=64)
        lay["n_experts_padded"] = 16
        ov.update(n_experts=6, top_k=2, moe_d_ff=32, n_shared_experts=2)
    else:
        c["intermediate_size"] = 128
        ov["d_ff"] = 128
    cfg["overrides"] = ov
    return cfg


def tiny_mix(name: str, clients: int = 4) -> dict:
    """``bench/traffic/<name>.json`` with ``clients`` clients and short
    lengths."""
    mix = copy.deepcopy(_load(f"traffic/{name}.json"))
    mix["clients"] = clients
    mix["prompt_tokens"].update(median=12, min=4, max=40)
    mix["output_tokens"].update(min=4, max=12)
    mix["sizes"] = 64
    mix["serve"].update(batch_size=clients, max_len=64, n_pages=None, prefill_chunk=8,
                        prefill_lanes=min(2, clients), token_budget=clients + 16)
    return mix
