"""The plain reference: the served model's full forward in float32, plain
``torch`` only, over whole sequences, layer by layer.

It regenerates the float weights from the seed (``bench.weights``) and
derives the DA int8 weight codes and per-column scales from them itself,
by the symmetric per-channel rule of the paper's §II-C in the weights'
own dtype (``scale = max|w| / 127``, ``round(w / scale)``).  Every linear
layer quantizes its input per token to ``x_bits``-bit signed codes
(``scale = max|x| / 127``, round half to even), takes the exact integer
product (float64, every partial below 2^53) and dequantizes as
``acc · x_scale · w_scale``.  ``x_bits`` below 8 keeps only the top
``x_bits`` bit-planes of the 8-bit codes (an arithmetic shift, the
accumulator scaled back): the precision below the configuration's, the
control.  Everything else (norms, RoPE, softmax attention, the experts'
routing and combine) runs in float32 with TF32 off.  Nothing of the
program is imported, and nothing it made is read.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench.model import ModelDesc
from bench.weights import layer_weights, top_weights

#: output columns of one float64 product (bounds its temporaries)
_COLS = 16384


class Linear:
    """One weight matrix as int8 codes and per-column float32 scales."""

    def __init__(self, w: torch.Tensor):
        amax = torch.amax(torch.abs(w), dim=0, keepdim=True)
        scale = torch.clamp(amax, min=1e-8) / 127
        self.codes = torch.clamp(torch.round(w / scale), -128, 127).to(torch.int8)
        self.scale = scale.to(torch.float32)

    def __call__(self, x: torch.Tensor, x_bits: int = 8) -> torch.Tensor:
        xf = x.to(torch.float32)
        amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
        xs = torch.clamp(amax, min=1e-8) / 127
        xq = torch.clamp(torch.round(xf / xs), -128, 127)
        step = float(1 << (8 - x_bits))
        if step > 1:
            xq = torch.floor(xq / step) * step
        xq = xq.to(torch.float64)
        n = self.codes.shape[1]
        out = torch.empty(xf.shape[:-1] + (n,), dtype=torch.float32, device=xf.device)
        for c in range(0, n, _COLS):
            acc = xq @ self.codes[:, c:c + _COLS].to(torch.float64)
            out[..., c:c + _COLS] = acc.to(torch.float32) * xs * self.scale[:, c:c + _COLS]
        return out


def _norm(x: torch.Tensor, p: Dict, m: ModelDesc) -> torch.Tensor:
    if m.norm_type == "layernorm":
        x = x - x.mean(-1, keepdim=True)
    y = x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + m.norm_eps)
    y = y * p["scale"].float()
    return y + p["bias"].float() if "bias" in p else y


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [L, H, hd]: the first and second halves of each head rotated
    together by pos × theta^(-i / (hd/2))."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, device=x.device, dtype=torch.float32) / half))
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(x: torch.Tensor, p: Dict, lin: Dict, m: ModelDesc, spans, xb: int):
    q, k, v = (lin[n](x, xb) for n in ("wq", "wk", "wv"))
    if "bq" in p:
        q, k, v = q + p["bq"].float(), k + p["bk"].float(), v + p["bv"].float()
    out = torch.empty((x.shape[0], m.q_dim), dtype=torch.float32, device=x.device)
    g = m.n_heads // m.n_kv_heads
    for a, b in spans:
        n = b - a
        pos = torch.arange(n, device=x.device)
        qs = _rope(q[a:b].view(n, m.n_heads, m.head_dim), pos, m.rope_theta)
        ks = _rope(k[a:b].view(n, m.n_kv_heads, m.head_dim), pos, m.rope_theta)
        vs = v[a:b].view(n, m.n_kv_heads, m.head_dim)
        ks = ks.repeat_interleave(g, dim=1)
        vs = vs.repeat_interleave(g, dim=1)
        scores = torch.einsum("qhd,khd->hqk", qs, ks) / (m.head_dim ** 0.5)
        mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        probs = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        out[a:b] = torch.einsum("hqk,khd->qhd", probs, vs).reshape(n, m.q_dim)
    return lin["wo"](out, xb)


def mlp(x: torch.Tensor, lin: Dict, act: str, xb: int) -> torch.Tensor:
    up = lin["w_up"](x, xb)
    h = F.silu(lin["w_gate"](x, xb)) * up if act == "swiglu" else torch.square(F.relu(up))
    return lin["w_down"](h, xb)


def moe(x: torch.Tensor, p: Dict, m: ModelDesc, xb: int) -> torch.Tensor:
    """Each token's top-k experts by routing probability (ties to the lower
    index), their SwiGLU outputs weighted and summed, plus the shared
    experts' SwiGLU; nothing is dropped."""
    logits = x @ p["router"].float()
    logits[:, m.n_experts:] = float("-inf")
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[:, :m.top_k], idx[:, :m.top_k]
    if m.norm_topk_prob:
        topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    y = torch.zeros_like(x)
    for e in range(m.n_experts):
        rows, slot = torch.nonzero(topi == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        lin = {n: Linear(p[n][e]) for n in ("w_gate", "w_up", "w_down")}
        y.index_add_(0, rows, mlp(x[rows], lin, "swiglu", xb) * topw[rows, slot, None])
    if "shared" in p:
        lin = {n: Linear(w) for n, w in p["shared"].items()}
        y = y + mlp(x, lin, "swiglu", xb)
    return y


def ffn(x: torch.Tensor, p: Dict, m: ModelDesc, xb: int) -> torch.Tensor:
    """The layer's FFN block ``p``: the port's MoE, or the dense MLP."""
    if m.n_experts:
        return moe(x, p, m, xb)
    return mlp(x, {n: Linear(w) for n, w in p.items()}, m.mlp_act, xb)


def logits_at(m: ModelDesc, seed: int, seqs: Sequence[Sequence[int]],
              starts: Sequence[int], device, x_bits: int = 8,
              draw_layer: Callable = layer_weights, ffn: Callable = ffn
              ) -> Iterator[Tuple[int, torch.Tensor]]:
    """Yields ``(i, logits)``: the float32 logits [len(seqs[i]) - starts[i],
    V] of sequence i at positions starts[i], starts[i] + 1, ...

    A model module whose layers differ from the built-in ones in their
    weights or their FFN block passes its own ``draw_layer(m, seed, i,
    device)`` (a layer's float weights, as ``bench.weights.layer_weights``)
    and ``ffn(x, p, m, x_bits)`` (the block on the normed input ``x``, ``p``
    the layer's ``"ffn"`` weights)."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield from _logits_at(m, seed, seqs, starts, device, x_bits, draw_layer, ffn)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def _logits_at(m, seed, seqs, starts, device, x_bits, draw_layer, ffn):
    spans: List[Tuple[int, int]] = []
    rows = 0
    for s in seqs:
        spans.append((rows, rows + len(s)))
        rows += len(s)
    tokens = torch.tensor([t for s in seqs for t in s], dtype=torch.long, device=device)
    top = top_weights(m, seed, device)
    h = top["embed"]["table"][tokens].float()
    del top
    for layer in range(m.n_layers):
        p = draw_layer(m, seed, layer, device)
        lin = {n: Linear(w) for n, w in p["mixer"].items() if n.startswith("w")}
        h = h + _attention(_norm(h, p["norm_mixer"], m), p["mixer"], lin, m, spans, x_bits)
        del lin
        x = _norm(h, p["norm_ffn"], m)
        h = h + ffn(x, p["ffn"], m, x_bits)
        del p, x
    top = top_weights(m, seed, device)
    head = Linear(top["lm_head"]["w"])
    for i, ((a, b), st) in enumerate(zip(spans, starts)):
        yield i, head(_norm(h[a + st:b], top["final_norm"], m), x_bits)
