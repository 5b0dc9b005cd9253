"""The benchmark's fixed arithmetic: the card's data-sheet peaks and the
operations and bytes of each kernel call and of a served token.

NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the full
700 W power limit: 1979 TOP/s int8, 989 TFLOP/s bf16, 3.35 TB/s HBM3.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

INT8_PEAK = 1979e12     # int8 tensor-core operations per second
BF16_PEAK = 989e12      # bf16 tensor-core FLOP per second
HBM_BW = 3.35e12        # bytes per second


def vmm_bound_s(xq: Sequence[int], wq: Sequence[int]) -> float:
    """Least seconds of one bit-plane VMM call: codes ``xq`` [.., M, K]
    (int32, as the port passes them) against weights ``wq`` [.., K, N]
    (int8), output int32 [.., M, N]; a leading dim is the experts' stack.
    The operations are the product's own, 2·M·K·N per expert, at the int8
    peak, whatever bit-planes implement it; the bytes are each operand
    read once and the output written once."""
    *lead_w, k, n = wq
    m = xq[-2]
    e = math.prod(lead_w) if lead_w else 1
    ops = 2.0 * e * m * k * n
    nbytes = e * (4.0 * m * k + 1.0 * k * n + 4.0 * m * n)
    return max(ops / INT8_PEAK, nbytes / HBM_BW)


def attention_bound_s(rows: Sequence[Sequence[int]], n_heads: int,
                      n_kv_heads: int, head_dim: int,
                      kv_bytes: int = 2, act_bytes: int = 2) -> float:
    """Least seconds of one paged-attention read over ``rows``, each
    ``(t, ctx)``: t query positions attending to ctx cached positions.
    Bytes: the K and V of the ctx positions read once, q read and the
    output written once; operations 4·t·ctx·H·hd (QK^T and PV) at the
    bf16 peak."""
    nbytes = ops = 0.0
    for t, ctx in rows:
        nbytes += 2.0 * ctx * n_kv_heads * head_dim * kv_bytes
        nbytes += 2.0 * t * n_heads * head_dim * act_bytes
        ops += 4.0 * t * ctx * n_heads * head_dim
    return max(ops / BF16_PEAK, nbytes / HBM_BW)


def matmul_params(m) -> Dict[str, float]:
    """Parameters a token runs through in matrix products (``m`` a
    :class:`bench.model.ModelDesc`): ``body``, every layer's attention
    projections and FFN, the routed experts counted ``top_k`` times and
    the router and shared experts once; ``head``, the LM head."""
    d = m.d_model
    attn = 2 * d * m.q_dim + 2 * d * m.kv_dim
    if m.n_experts:
        ffn = (m.top_k * 3 * d * m.moe_d_ff + d * m.n_experts_padded
               + 3 * d * m.shared_d_ff)
    else:
        ffn = (3 if m.mlp_act == "swiglu" else 2) * d * m.d_ff
    return {"body": float(m.n_layers * (attn + ffn)), "head": float(d * m.vocab)}


def window_ops(m, tokens: int, ctx_sum: int, sampled: int) -> float:
    """Model operations of ``tokens`` token passes whose contexts sum to
    ``ctx_sum`` positions, ``sampled`` of which went through the LM head
    (``m`` a :class:`bench.model.ModelDesc`, counted by its model module's
    own ``matmul_params`` where it brings one)."""
    p = (m.matmul_params or matmul_params)(m)
    attn = 4.0 * m.n_heads * m.head_dim * m.n_layers
    return 2.0 * p["body"] * tokens + attn * ctx_sum + 2.0 * p["head"] * sampled
