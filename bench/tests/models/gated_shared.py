"""A model module whose plain reference departs from what the port
computes: the shared experts' SwiGLU scaled by ``sigmoid(x · w_g)``, a
gate ``[d, 1]`` a layer drawn from the seed (Qwen1.5-MoE's
``shared_expert_gate``), which the port's MoE lacks.  ``w_g`` is drawn at
4/sqrt(d), so the gate nears 0 or 1 for most tokens and the departure
shows at test widths on every seed.  The port's weights are the built-in
ones."""
import torch

from bench import reference, weights, yardstick
from bench.model import desc_from_file as desc  # noqa: F401
from bench.weights import make_params  # noqa: F401


def _layer(m, seed, i, device):
    p = weights.layer_weights(m, seed, i, device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * 1009 + i)
    p["ffn"]["shared_gate"] = torch.randn((m.d_model, 1), generator=g, device=device
                                          ).mul_(4 * m.d_model ** -0.5)
    return p


def _ffn(x, p, m, xb):
    routed = {k: v for k, v in p.items() if k not in ("shared", "shared_gate")}
    shared = {n: reference.Linear(w) for n, w in p["shared"].items()}
    gate = torch.sigmoid(x @ p["shared_gate"])
    return reference.moe(x, routed, m, xb) + gate * reference.mlp(x, shared, "swiglu", xb)


def logits_at(desc, seed, seqs, starts, device, x_bits=8):
    return reference.logits_at(desc, seed, seqs, starts, device, x_bits,
                               draw_layer=_layer, ffn=_ffn)


def matmul_params(m):
    """The built-in count and each layer's gate."""
    p = yardstick.matmul_params(m)
    return dict(p, body=p["body"] + m.n_layers * m.d_model)
