"""GQA attention with RoPE / M-RoPE, qk-norm, q/k/v biases and KV caches.

Three branches, as the reference's ``attention_forward``:

* paged (a :class:`PagedKVCache` and a page table): K/V rows scatter into a
  batch-free page pool (in place — the pool is updated where it lives) and
  the read runs through the engine's paged-attention registry (``gather``:
  the plain read below; ``fused``: the CUDA page-walk kernel);
* dense (a :class:`KVCache` ``[B, S_max, kv, hd]``, the slot runtime's):
  position-driven writes (``cache_mode`` ``scatter`` for ragged rows,
  ``slice`` for uniform positions), then decode over the whole cache with a
  per-row length mask, or a prefill over the fresh segment only;
* no cache: causal self-attention over the segment — naive full-head,
  ``attn_impl="lean"`` (pre-scaled q, one hoisted additive bias, late
  divide) or, with ``attn_chunk_q``, an online softmax over KV chunks.

The non-paged paths are plain torch, as the reference computes them outside
any kernel; every scalar applies in the array's dtype, as JAX's weak typing
does, and every sum accumulates in it.  The paged read alone rounds at the
reference's points but sums q·k, the softmax's row sum and p·v in float64,
so the rounded values do not depend on the summation order and the CUDA
kernel, which sums in float64 too, matches it bit for bit.
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
class KVCache:
    """Dense decode cache of one attention layer, or a stack of them.

    k/v: ``[(n_periods,) B, S_max, n_kv, hd]``; length: int32 tokens
    written (``[n_periods]`` when stacked), the reference's scalar that only
    the warm-cache check of a prefill reads.  Writes land in place."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor

    @staticmethod
    def zeros(cfg: ModelConfig, batch: int, max_len: int, dtype,
              device="cpu", stack=()) -> "KVCache":
        shape = tuple(stack) + (batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       length=torch.zeros(tuple(stack), dtype=torch.int32,
                                          device=device))

    def layer(self, i: int) -> "KVCache":
        """Views of stacked layer ``i`` (writes land in the stack)."""
        return KVCache(k=self.k[i], v=self.v[i], length=self.length[i])


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
    if cfg.attn_bias:
        p["bq"] = torch.zeros((qd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((kvd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((kvd,), dtype=dt, device=dev)
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
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, cfg.n_heads, hd)
    k = k.reshape(b, t, cfg.n_kv_heads, hd)
    v = v.reshape(b, t, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm_headwise(k, p["k_norm"], cfg.norm_eps)
    ang = rope_angles(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    return apply_rope(q, ang), apply_rope(k, ang), v


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (a scalar the reference applies in the
    array's dtype)."""
    return torch.tensor(value, dtype=dtype).item()


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, acc=None) -> torch.Tensor:
    """q: [B,T,H,hd], k: [B,S,Kv,hd] → scores [B,Kv,G,T,S] (H = Kv·G): the
    dot products summed in ``acc`` (q's dtype by default) and rounded to q's
    dtype, divided by sqrt(hd) in that dtype.  The divisor is a 0-dim
    tensor on the scores' device: PyTorch's CUDA divide by a CPU scalar
    multiplies by its rounded reciprocal, which is not the quotient (in
    float32, where sqrt(hd) is no power of two, it moves scores by an ulp);
    on the CPU both forms are the quotient."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    acc = acc or q.dtype
    qg = q.reshape(b, t, kv, h // kv, hd)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.to(acc), k.to(acc)).to(q.dtype)
    return scores / torch.full((), _in_dtype(hd ** 0.5, scores.dtype),
                               dtype=scores.dtype, device=scores.device)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, acc=None) -> torch.Tensor:
    """probs: [B,Kv,G,T,S], v: [B,S,Kv,hd] → [B,T,H,hd], summed in ``acc``
    (probs' dtype by default) and rounded to probs' dtype."""
    b, kv, g, t, s = probs.shape
    acc = acc or probs.dtype
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(acc), v.to(acc)).to(probs.dtype)
    return out.reshape(b, t, kv * g, v.shape[-1])


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor, softmax_dtype,
                    mask_mode: str, acc=None) -> torch.Tensor:
    """Mask, then softmax as ``exp(x - max) / sum`` in ``softmax_dtype``,
    the row sum accumulated in ``acc`` (``softmax_dtype`` by default) and
    rounded to that dtype."""
    sd = getattr(torch, str(softmax_dtype).replace("torch.", ""))
    scores = scores.to(sd)
    neg = torch.tensor(NEG_INF, dtype=sd, device=scores.device)
    if mask_mode == "additive":
        scores = scores + torch.where(mask, torch.zeros((), dtype=sd,
                                                        device=scores.device), neg)
    else:
        scores = torch.where(mask, scores, neg)
    unnorm = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    return unnorm / torch.sum(unnorm, dim=-1, keepdim=True,
                              dtype=acc or sd).to(sd)


def paged_gather_read(q, k_pool, v_pool, page_table, tpos, *,
                      softmax_dtype="float32", mask_mode: str = "where",
                      k_scale=None, v_scale=None) -> torch.Tensor:
    """Gather-based paged-attention read (the ``"gather"`` backend, and the
    plain version of the CUDA page-walk kernel).

    Gathers each row's page table into a contiguous ``[B, S, kv, hd]`` view
    of the pool and runs masked grouped-GQA attention over it;
    ``kpos <= tpos`` masks unwritten cache, pad lanes and the garbage column.
    Quantized pools dequantize the gathered codes with their scales.

    The three sums (q·k, the softmax's row sum, p·v) accumulate in float64
    and round once to their dtype, at the reference's rounding points: a
    sum of products of bfloat16 values is exact in float64, and of float32
    values off by 2^-53 at most, so its rounding does not depend on the
    summation order.  The kernel sums in float64 too, and the two reads
    then agree bit for bit.
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
    scores = _gqa_scores(q, kg, torch.float64)
    probs = _masked_softmax(scores, mask[:, None, None], softmax_dtype,
                            mask_mode, torch.float64).to(q.dtype)
    return _gqa_out(probs, vg, torch.float64)


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


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,S,Kv,hd] → [B,S,H,hd] (each KV head repeated for its group)."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kv, dim=2)


def _decode_attention(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """Grouped GQA attention over a dense cache; mask [B, T, S]."""
    scores = _gqa_scores(q, k)
    probs = _masked_softmax(scores, mask[:, None, None], cfg.softmax_dtype,
                            cfg.attn_mask_mode).to(q.dtype)
    return _gqa_out(probs, v)


def _naive_attention(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """Full-head attention. q [B,T,H,hd], k/v [B,S,Kv,hd]; mask [..,T,S]."""
    h, hd = q.shape[2], q.shape[3]
    kf, vf = _repeat_kv(k, h), _repeat_kv(v, h)
    scores = torch.einsum("bthd,bshd->bhts", q, kf)
    scores = scores / _in_dtype(hd ** 0.5, scores.dtype)
    probs = _masked_softmax(scores, mask, cfg.softmax_dtype,
                            cfg.attn_mask_mode).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, vf)


def causal_bias(t: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Additive causal bias [T, T] (0 on and below the diagonal, -1e30
    above), built once per forward and shared by every layer."""
    pos = torch.arange(t, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    neg = torch.tensor(NEG_INF, dtype=dtype, device=device)
    return torch.where(pos[None, :] <= pos[:, None], zero, neg)


def _lean_attention(q, k, v, cfg: ModelConfig, bias) -> torch.Tensor:
    """Causal attention with the fewest passes: q pre-scaled by 1/sqrt(hd),
    one additive bias, max / sub-exp / sum in float32, and the 1/l
    normalisation on the [B,T,H,hd] output."""
    h, hd = q.shape[2], q.shape[3]
    kf, vf = _repeat_kv(k, h), _repeat_kv(v, h)
    qs = (q * _in_dtype(hd ** -0.5, q.dtype)).to(q.dtype)
    scores = torch.einsum("bthd,bshd->bhts", qs, kf).to(torch.float32)
    scores = scores + bias[None, None]
    m = torch.amax(scores, dim=-1)
    p = torch.exp(scores - m[..., None])
    l = torch.sum(p, dim=-1)  # noqa: E741
    o = torch.einsum("bhts,bshd->bthd", p.to(q.dtype), vf)
    return o / l.permute(0, 2, 1)[..., None].to(o.dtype)


def _chunked_attention(q, k, v, q_offset: int, chunk: int) -> torch.Tensor:
    """Flash-style online softmax over KV chunks of ``chunk`` positions (a
    Python loop over the chunks).  Causal: the query at absolute position
    ``q_offset + i`` attends to keys at positions ≤ that."""
    b, t, h, hd = q.shape
    kf, vf = _repeat_kv(k, h), _repeat_kv(v, h)
    s = kf.shape[1]
    chunk = min(chunk, s)
    dev = q.device
    qpos = q_offset + torch.arange(t, device=dev)
    div = _in_dtype(hd ** 0.5, torch.float32)
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=dev)  # noqa: E741
    acc = torch.zeros((b, h, t, hd), dtype=q.dtype, device=dev)
    for c0 in range(0, s, chunk):
        kb, vb = kf[:, c0:c0 + chunk], vf[:, c0:c0 + chunk]
        kpos = c0 + torch.arange(kb.shape[1], device=dev)
        sc = torch.einsum("bthd,bshd->bhts", q, kb).to(torch.float32) / div
        valid = kpos[None, :] <= qpos[:, None]
        sc = torch.where(valid[None, None], sc,
                         torch.tensor(NEG_INF, dtype=torch.float32, device=dev))
        m_new = torch.maximum(m, torch.amax(sc, dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)  # noqa: E741
        pv = torch.einsum("bhts,bshd->bhtd", p.to(q.dtype), vb)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None].to(acc.dtype)
    return out.permute(0, 2, 1, 3)  # [B,T,H,hd]


def _dense_cache_write(k, v, cache: KVCache, tpos, cfg: ModelConfig) -> None:
    """Write this step's K/V rows into the dense cache in place: at each
    row's own positions (``scatter``), or as one slice at row 0's first
    position, clamped to fit as a dynamic update slice is (``slice``)."""
    t = k.shape[1]
    if cfg.cache_mode == "slice":
        start = min(max(int(tpos[0, 0]), 0), cache.k.shape[1] - t)
        cache.k[:, start:start + t] = k.to(cache.k.dtype)
        cache.v[:, start:start + t] = v.to(cache.v.dtype)
    else:
        rows = torch.arange(k.shape[0], device=k.device)[:, None]
        tp = tpos.long()
        cache.k[rows, tp] = k.to(cache.k.dtype)
        cache.v[rows, tp] = v.to(cache.v.dtype)
    cache.length.add_(t)


def attention_forward(p, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, cache=None,
                      page_table: Optional[torch.Tensor] = None, *,
                      update_cache: bool = False,
                      attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of one layer; returns the projected output.  Caches are
    written in place.

    * ``PagedKVCache`` (with ``page_table``): decode, chunked prefill or a
      mix over the page pool;
    * ``KVCache``: decode over the whole cache (``update_cache=False`` or
      T = 1), or a prefill (``update_cache`` and T > 1) over the fresh
      segment only, which is right only into an empty cache: a second
      chunk into a warm cache raises;
    * no cache: causal self-attention over the segment.

    ``positions`` is [B, T], or [B, T, 3] under M-RoPE, whose first
    coordinate is the temporal one the caches index."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    tpos = positions[..., 0] if positions.ndim == 3 else positions
    if isinstance(cache, PagedKVCache):
        if page_table is None:
            raise ValueError("a PagedKVCache requires a page_table operand")
        y = _paged_attention(q, k, v, cache, page_table, tpos, cfg)
        return dense(y.reshape(b, t, cfg.q_dim), p["wo"])
    if cache is not None:
        warm = update_cache and t > 1 and int(cache.length) > 0
        if warm:
            raise ValueError(
                "chunked prefill into a warm dense KVCache is not supported: "
                f"the cache already holds {int(cache.length)} tokens the "
                "fresh-segment attention cannot see. Prefill the whole prompt "
                "in one call, or use the paged runtime (PagedKVCache), whose "
                "attention read covers earlier chunks through the page pool.")
        _dense_cache_write(k, v, cache, tpos, cfg)
        if not (update_cache and t > 1):
            kpos = torch.arange(cache.k.shape[1], device=x.device)
            mask = kpos[None, None, :] <= tpos.long()[:, :, None]  # [B,T,S]
            y = _decode_attention(q, cache.k, cache.v, mask, cfg)
            return dense(y.reshape(b, t, cfg.q_dim), p["wo"])
    # no cache, or a prefill into an empty dense cache: the fresh segment
    if cfg.attn_impl == "lean":
        bias = attn_bias if attn_bias is not None else causal_bias(
            t, device=x.device)
        y = _lean_attention(q, k, v, cfg, bias)
    elif cfg.attn_chunk_q and t > cfg.attn_chunk_q:
        y = _chunked_attention(q, k, v, q_offset=0, chunk=cfg.attn_chunk_q)
    else:
        pos = torch.arange(t, device=x.device)
        mask = (pos[None, :] <= pos[:, None])[None, None]     # [1,1,T,S]
        y = _naive_attention(q, k, v, mask, cfg)
    return dense(y.reshape(b, t, cfg.q_dim), p["wo"])
