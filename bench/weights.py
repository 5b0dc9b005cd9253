"""Random weights from ``--seed``, made on the device in the layout the
port's ``ServeEngine`` takes (``{"embed", "blocks", "final_norm",
"lm_head"}``, matrices ``[in, out]``, expert stacks ``[E_pad, in, out]``
with the padded experts zero).

Each layer comes from its own generator, seeded from the run's seed and
the layer's index, in one normal draw of all its matrices (bf16, the
type they are served in) and one of its small vectors; the router, served
in float32, is drawn in float32.  So the reference regenerates any layer
alone, bit for bit, on the same device.  Matrices are scaled by 1/sqrt(fan
in); norm scales are 1 + 0.1·z and biases 0.1·z, so every norm and bias
term is exercised.  Only ``torch`` is imported here.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch

from bench.model import ModelDesc

BF16 = torch.bfloat16
_MIX = 1_000_003


def _generator(seed: int, part: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * _MIX + part) % (1 << 63))
    return g


def _matrices(m: ModelDesc, moe: bool) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    """(path, shape, scale) of one layer's matrices, in draw order."""
    d, q, kv = m.d_model, m.q_dim, m.kv_dim
    out = [(("mixer", "wq"), (d, q), d ** -0.5),
           (("mixer", "wk"), (d, kv), d ** -0.5),
           (("mixer", "wv"), (d, kv), d ** -0.5),
           (("mixer", "wo"), (q, d), q ** -0.5)]
    if moe:
        e, f, fs = m.n_experts_padded, m.moe_d_ff, m.shared_d_ff
        out += [(("ffn", "w_gate"), (e, d, f), d ** -0.5),
                (("ffn", "w_up"), (e, d, f), d ** -0.5),
                (("ffn", "w_down"), (e, f, d), f ** -0.5)]
        if fs:
            out += [(("ffn", "shared", "w_up"), (d, fs), d ** -0.5),
                    (("ffn", "shared", "w_down"), (fs, d), fs ** -0.5),
                    (("ffn", "shared", "w_gate"), (d, fs), d ** -0.5)]
    else:
        out += [(("ffn", "w_up"), (d, m.d_ff), d ** -0.5),
                (("ffn", "w_down"), (m.d_ff, d), m.d_ff ** -0.5)]
        if m.mlp_act == "swiglu":
            out.append((("ffn", "w_gate"), (d, m.d_ff), d ** -0.5))
    return out


def _vectors(m: ModelDesc) -> List[Tuple[Tuple[str, ...], int, str]]:
    """(path, length, kind) of one layer's norm and bias vectors."""
    d = m.d_model
    out = [(("norm_mixer", "scale"), d, "scale"), (("norm_ffn", "scale"), d, "scale")]
    if m.norm_type == "layernorm":
        out += [(("norm_mixer", "bias"), d, "bias"), (("norm_ffn", "bias"), d, "bias")]
    if m.attn_bias:
        out += [(("mixer", "bq"), m.q_dim, "bias"), (("mixer", "bk"), m.kv_dim, "bias"),
                (("mixer", "bv"), m.kv_dim, "bias")]
    return out


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _vector_values(z: torch.Tensor, kind: str) -> torch.Tensor:
    return (1.0 + 0.1 * z.float()).to(BF16) if kind == "scale" else (0.1 * z.float()).to(BF16)


def layer_weights(m: ModelDesc, seed: int, layer: int, device) -> Dict:
    """Layer ``layer``'s parameters, as the port's block dict."""
    g = _generator(seed, layer + 1, device)
    moe = m.n_experts > 0
    mats = _matrices(m, moe)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in mats), generator=g,
                       device=device, dtype=BF16)
    block: Dict = {}
    off = 0
    for path, shape, scale in mats:
        n = math.prod(shape)
        w = flat[off:off + n].view(shape).mul_(scale)
        if moe and len(shape) == 3:
            w[m.n_experts:].zero_()      # padded experts: exact no-ops
        _put(block, path, w)
        off += n
    vecs = _vectors(m)
    small = torch.randn(sum(n for _, n, _ in vecs), generator=g, device=device,
                        dtype=BF16)
    off = 0
    for path, n, kind in vecs:
        _put(block, path, _vector_values(small[off:off + n], kind))
        off += n
    if moe:
        block["ffn"]["router"] = torch.randn(
            (m.d_model, m.n_experts_padded), generator=g, device=device,
            dtype=torch.float32).mul_(m.d_model ** -0.5)
    return block


def top_weights(m: ModelDesc, seed: int, device) -> Dict:
    """The embedding table, the final norm and the LM head."""
    g = _generator(seed, 0, device)
    d, v = m.d_model, m.vocab
    top = {"embed": {"table": torch.randn((v, d), generator=g, device=device,
                                          dtype=BF16).mul_(0.02)},
           "lm_head": {"w": torch.randn((d, v), generator=g, device=device,
                                        dtype=BF16).mul_(d ** -0.5)}}
    z = torch.randn(2 * d, generator=g, device=device, dtype=BF16)
    top["final_norm"] = {"scale": _vector_values(z[:d], "scale")}
    if m.norm_type == "layernorm":
        top["final_norm"]["bias"] = _vector_values(z[d:], "bias")
    return top


def make_params(m: ModelDesc, seed: int, device,
                freeze: Callable[[Dict], Dict] = lambda t: t,
                draw_layer: Callable = layer_weights) -> Dict:
    """The whole tree, each part passed through ``freeze`` as soon as it
    is drawn (so at most one layer's floats are alive beside the frozen
    codes).  A model module whose layers hold other weights passes its own
    ``draw_layer(m, seed, i, device)``."""
    top = freeze(top_weights(m, seed, device))
    blocks = [freeze({"blocks": [draw_layer(m, seed, i, device)]})["blocks"][0]
              for i in range(m.n_layers)]
    return {"embed": top["embed"], "blocks": blocks,
            "final_norm": top["final_norm"], "lm_head": top["lm_head"]}
