"""GQA attention with RoPE, qk-norm and a page-table-indexed KV cache.

The paged branch of the reference's attention: K/V rows scatter into a
batch-free page pool (in place — the pool is updated where it lives) and the
read runs through the engine's paged-attention registry (``gather``: the
plain read below; ``fused``: the CUDA page-walk kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.engine import (
    PackedWeights,
    da_qkv_matmul,
    dense,
    get_attn_backend,
    select_attn_backend,
)
from repro_torch.models import kv_quant as _kvq
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    normal_init,
    rms_norm_headwise,
    rope_angles,
)

NEG_INF = -1e30


@dataclasses.dataclass
class PagedKVCache:
    """Paged decode cache for one attention layer, or a stack of them.

    k/v: ``[(n_periods,) n_pages, page_size, n_kv, hd]`` — batch-free; a
    request's rows live on the physical pages its page table names.
    Quantized pools hold int8 codes (int4: two nibbles per byte along hd)
    and per-(slot, head) float16 scales ``[.., n_pages, page_size, n_kv, 1]``.
    """

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(cfg: ModelConfig, n_pages: int, page_size: int, dtype,
              kv_dtype: str = "fp16", device="cpu", stack=()) -> "PagedKVCache":
        hd = cfg.head_dim_
        if kv_dtype not in _kvq.KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}; expected one of "
                             f"{_kvq.KV_DTYPES}")
        lead = tuple(stack) + (n_pages, page_size, cfg.n_kv_heads)
        if kv_dtype == "fp16":
            return PagedKVCache(k=torch.zeros(lead + (hd,), dtype=dtype, device=device),
                                v=torch.zeros(lead + (hd,), dtype=dtype, device=device))
        if kv_dtype == "int4" and hd % 2:
            raise ValueError(f"kv_dtype='int4' packs two nibbles per byte along "
                             f"head_dim; head_dim={hd} is odd")
        hd_p = hd // 2 if kv_dtype == "int4" else hd
        z = lambda d, dt: torch.zeros(lead + (d,), dtype=dt, device=device)  # noqa: E731
        return PagedKVCache(k=z(hd_p, torch.int8), v=z(hd_p, torch.int8),
                            k_scale=z(1, _kvq.KV_SCALE_DTYPE),
                            v_scale=z(1, _kvq.KV_SCALE_DTYPE))

    def layer(self, i: int) -> "PagedKVCache":
        """Views of stacked layer ``i`` (writes land in the stack)."""
        pick = lambda a: None if a is None else a[i]  # noqa: E731
        return PagedKVCache(k=self.k[i], v=self.v[i], k_scale=pick(self.k_scale),
                            v_scale=pick(self.v_scale))

    @property
    def page_size(self) -> int:
        return self.k.shape[-3]


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> dict:
    dt = cfg.pdtype()
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    s, so = 1.0 / (d ** 0.5), 1.0 / (qd ** 0.5)
    p = {"wq": normal_init(gen, (d, qd), s, dt),
         "wk": normal_init(gen, (d, kvd), s, dt),
         "wv": normal_init(gen, (d, kvd), s, dt),
         "wo": normal_init(gen, (qd, d), so, dt)}
    dev = gen.device
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((cfg.head_dim_,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((cfg.head_dim_,), dtype=dt, device=dev)
    return p


def _fusable_qkv(*ws) -> bool:
    """The q/k/v artifacts can share one DA pass: all 2-D PackedWeights with
    one DAConfig and one contraction dim."""
    return (all(isinstance(w, PackedWeights) and w.wq.ndim == 2 for w in ws)
            and len({w.cfg for w in ws}) == 1 and len({w.k for w in ws}) == 1)


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    b, t, _ = x.shape
    hd = cfg.head_dim_
    if _fusable_qkv(p["wq"], p["wk"], p["wv"]):
        yq, yk, yv = da_qkv_matmul(x, (p["wq"], p["wk"], p["wv"]))
        q, k, v = yq.to(x.dtype), yk.to(x.dtype), yv.to(x.dtype)
    else:
        q, k, v = dense(x, p["wq"]), dense(x, p["wk"]), dense(x, p["wv"])
    q = q.reshape(b, t, cfg.n_heads, hd)
    k = k.reshape(b, t, cfg.n_kv_heads, hd)
    v = v.reshape(b, t, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm_headwise(k, p["k_norm"], cfg.norm_eps)
    ang = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, ang), apply_rope(k, ang), v


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (a scalar the reference applies in the
    array's dtype)."""
    return torch.tensor(value, dtype=dtype).item()


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [B,T,H,hd], k: [B,S,Kv,hd] → scores [B,Kv,G,T,S] (H = Kv·G), in
    q's dtype, divided by sqrt(hd) in that dtype."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, t, kv, h // kv, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k)
    return scores / _in_dtype(hd ** 0.5, scores.dtype)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: [B,Kv,G,T,S], v: [B,S,Kv,hd] → [B,T,H,hd]."""
    b, kv, g, t, s = probs.shape
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(b, t, kv * g, v.shape[-1])


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor, softmax_dtype,
                    mask_mode: str) -> torch.Tensor:
    """Mask, then softmax as ``exp(x - max) / sum`` in ``softmax_dtype``."""
    sd = getattr(torch, str(softmax_dtype).replace("torch.", ""))
    scores = scores.to(sd)
    neg = torch.tensor(NEG_INF, dtype=sd, device=scores.device)
    if mask_mode == "additive":
        scores = scores + torch.where(mask, torch.zeros((), dtype=sd,
                                                        device=scores.device), neg)
    else:
        scores = torch.where(mask, scores, neg)
    unnorm = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    return unnorm / torch.sum(unnorm, dim=-1, keepdim=True)


def paged_gather_read(q, k_pool, v_pool, page_table, tpos, *,
                      softmax_dtype="float32", mask_mode: str = "where",
                      k_scale=None, v_scale=None) -> torch.Tensor:
    """Gather-based paged-attention read (the ``"gather"`` backend, and the
    plain version of the CUDA page-walk kernel).

    Gathers each row's page table into a contiguous ``[B, S, kv, hd]`` view
    of the pool and runs masked grouped-GQA attention over it;
    ``kpos <= tpos`` masks unwritten cache, pad lanes and the garbage column.
    Quantized pools dequantize the gathered codes with their scales.
    """
    b = q.shape[0]
    fmt = _kvq.kv_format(k_pool, k_scale, q.shape[-1])
    table = page_table.long()
    kg, vg = k_pool[table], v_pool[table]      # [B, W, ps, kv, hd(/2)]
    if fmt != "fp":
        kg = _kvq.dequantize_kv(kg, k_scale[table], fmt, q.dtype)
        vg = _kvq.dequantize_kv(vg, v_scale[table], fmt, q.dtype)
    kg = kg.reshape(b, -1, kg.shape[-2], kg.shape[-1])
    vg = vg.reshape(b, -1, vg.shape[-2], vg.shape[-1])
    kpos = torch.arange(kg.shape[1], device=q.device)
    mask = kpos[None, None, :] <= tpos.long()[:, :, None]   # [B, T, S]
    scores = _gqa_scores(q, kg)
    probs = _masked_softmax(scores, mask[:, None, None], softmax_dtype,
                            mask_mode).to(q.dtype)
    return _gqa_out(probs, vg)


def _paged_attention(q, k, v, cache: PagedKVCache, page_table, tpos,
                     cfg: ModelConfig) -> torch.Tensor:
    """Write this step's K/V rows at ``(page_table[b, pos // ps], pos % ps)``
    in place, then run the read through the attention-backend registry.

    Pad lanes carry positions in the garbage column, which map to garbage
    page 0; several pad rows may write the same (page, slot) and which one
    lands is unspecified on CUDA, which is harmless because every real row's
    ``kpos <= tpos`` mask excludes the garbage column."""
    b, t = tpos.shape
    ps = cache.page_size
    fmt = _kvq.kv_format(cache.k, cache.k_scale, q.shape[-1])
    tp = tpos.long()
    page_ids = page_table.long()[torch.arange(b, device=tp.device)[:, None],
                                 tp // ps]
    off = tp % ps
    if fmt == "fp":
        cache.k[page_ids, off] = k.to(cache.k.dtype)
        cache.v[page_ids, off] = v.to(cache.v.dtype)
    else:
        qk, sk = _kvq.quantize_kv(k, fmt)
        qv, sv = _kvq.quantize_kv(v, fmt)
        cache.k[page_ids, off] = qk
        cache.v[page_ids, off] = qv
        cache.k_scale[page_ids, off] = sk
        cache.v_scale[page_ids, off] = sv
    name = select_attn_backend(cfg.paged_attn, q.device)
    return get_attn_backend(name).fn(
        q, cache.k, cache.v, page_table, tpos,
        softmax_dtype=cfg.softmax_dtype, mask_mode=cfg.attn_mask_mode,
        k_scale=cache.k_scale, v_scale=cache.v_scale)


def attention_forward(p, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, cache: PagedKVCache,
                      page_table: torch.Tensor) -> torch.Tensor:
    """Paged attention over ``cache`` (decode, chunked prefill or a mix):
    writes this step's K/V into the pool and returns the projected output."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    y = _paged_attention(q, k, v, cache, page_table, positions, cfg)
    return dense(y.reshape(b, t, cfg.q_dim), p["wo"])
