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
import math
from typing import Optional

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import Replicate, Shard

from repro_torch.core.engine import (
    PackedWeights,
    da_qkv_matmul,
    dense,
    get_attn_backend,
    select_attn_backend,
)
from repro_torch.launch.sharding import (
    DTensor,
    NamedSharding,
    P,
    active_mesh,
    block_of,
    constrain,
    distribute,
    full,
    local_of,
    paged_cache_axes,
    placements,
    pspec,
    replicated,
    rule_dims,
    shard_block,
    spec_of,
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
    q = _split_heads(q, cfg.n_heads, hd, "heads")
    k = _split_heads(k, cfg.n_kv_heads, hd, "kv_heads")
    v = _split_heads(v, cfg.n_kv_heads, hd, "kv_heads")
    if cfg.qk_norm:
        q = rms_norm_headwise(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm_headwise(k, p["k_norm"], cfg.norm_eps)
    ang = rope_angles(positions, hd, cfg.rope_theta, cfg.mrope_sections)
    q = constrain(apply_rope(q, ang), ("batch", "seq", "heads", "head_dim"))
    k = constrain(apply_rope(k, ang), ("batch", "seq", "kv_heads", "head_dim"))
    v = constrain(v, ("batch", "seq", "kv_heads", "head_dim"))
    return q, k, v


def _split_heads(y: torch.Tensor, n: int, hd: int, axis: str) -> torch.Tensor:
    """[B, T, n·hd] → [B, T, n, hd].  On a mesh the flat projection is
    first placed as the 4-D result resolves (``axis`` on its mesh axes, or
    replicated where ``n`` does not divide them while ``n·hd`` does: 8 KV
    heads on a 16-way model axis), GSPMD's implicit reshard, where DTensor
    refuses to unflatten an uneven split.  A plain tensor is reshaped as
    it is."""
    b, t, _ = y.shape
    mesh = active_mesh()
    if isinstance(y, DTensor) and mesh is not None:
        spec = tuple(pspec(("batch", "seq", axis, "head_dim"), (b, t, n, hd)))
        target = placements(P(*(spec + (None,) * 3)[:3]), mesh)
        if tuple(y.placements) != target:
            y = y.redistribute(mesh, target)
    return y.reshape(b, t, n, hd)


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
    rounded to that dtype.  Where no gradient is recorded, the same
    operations in the same order run in place on one copy of the scores in
    ``softmax_dtype`` (bit for bit the chain's values, one score buffer
    instead of several): scores already in that dtype are written over, so
    a caller passes scores it does not read again."""
    sd = getattr(torch, str(softmax_dtype).replace("torch.", ""))
    scores = scores.to(sd)
    # a fill on the device, not a copy from the host: a CUDA graph captures it
    neg = torch.full((), NEG_INF, dtype=sd, device=scores.device)
    if not (torch.is_grad_enabled() and scores.requires_grad):
        if mask_mode == "additive":
            scores.add_(torch.where(mask, torch.zeros((), dtype=sd,
                                                      device=scores.device), neg))
        else:
            torch.where(mask, scores, neg, out=scores)
        scores.sub_(torch.amax(scores, dim=-1, keepdim=True)).exp_()
        return scores.div_(torch.sum(scores, dim=-1, keepdim=True,
                                     dtype=acc or sd).to(sd))
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
    kg = constrain(kg, ("batch", "kv_seq", "kv_heads", "head_dim"))
    vg = constrain(vg, ("batch", "kv_seq", "kv_heads", "head_dim"))
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
        _write_rows(cache.k, page_ids, off, k.to(cache.k.dtype))
        _write_rows(cache.v, page_ids, off, v.to(cache.v.dtype))
    else:
        qk, sk = _kvq.quantize_kv(k, fmt)
        qv, sv = _kvq.quantize_kv(v, fmt)
        _write_rows(cache.k, page_ids, off, qk)
        _write_rows(cache.v, page_ids, off, qv)
        _write_rows(cache.k_scale, page_ids, off, sk)
        _write_rows(cache.v_scale, page_ids, off, sv)
    # the reference's constraints on the written pools: placed once by
    # shard_paged_caches, each returns its pool as it is
    pool_axes = paged_cache_axes(cache.k.ndim)
    if fmt != "fp":
        constrain(cache.k_scale, pool_axes)
        constrain(cache.v_scale, pool_axes)
    constrain(cache.k, pool_axes)
    constrain(cache.v, pool_axes)
    name = select_attn_backend(cfg.paged_attn, q.device, batch=b, t=t,
                               kv_len=page_table.shape[1] * ps)
    return get_attn_backend(name).fn(
        q, cache.k, cache.v, page_table, tpos,
        softmax_dtype=cfg.softmax_dtype, mask_mode=cfg.attn_mask_mode,
        k_scale=cache.k_scale, v_scale=cache.v_scale)


def _write_rows(pool, page_ids, off, rows) -> None:
    """``pool[page_ids, off] = rows`` in place.  A pool placed on a mesh
    (:func:`repro_torch.launch.sharding.shard_paged_caches`: its kv-heads
    dim sharded, the rest replicated) takes on each rank the rows' block
    under the pool's own placements, written into its local block — both
    are ``[.., kv, hd]`` in their last two dims."""
    if isinstance(pool, DTensor):
        if not isinstance(rows, DTensor):
            rows = distribute(rows, NamedSharding(pool.device_mesh, spec_of(pool)))
        rows = rows.redistribute(pool.device_mesh, pool.placements).to_local()
        pool, page_ids, off = pool.to_local(), local_of(page_ids), local_of(off)
    pool[page_ids, off] = rows


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """[B,S,Kv,hd] → [B,S,H,hd] (each KV head repeated for its group)."""
    kv = k.shape[2]
    if kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kv, dim=2)


def _head_parallel(fn, q, k, v, *args, batch_args=(), **kwargs):
    """``fn(q, k, v, *batch_args, *args, **kwargs)``, an attention core
    over [B,T,H,hd] / [B,S,Kv,hd], run on each rank's own rows and heads;
    returns its output flattened to [B,T,H·hd].

    Rows and heads are independent, so where q, k and v are placed on a
    mesh each rank keeps its block of the batch (dim 0) and of the heads
    (dim 2: a contiguous block of q heads reads the matching block of KV
    heads when both counts divide the ranks) and gathers only the rest;
    its output is flattened locally (a block of heads is a block of
    H·hd) and placed as q.  Where the KV heads do not divide the ranks but
    each rank's block of q heads lies in one KV head's group (32 heads
    over 8 KV heads on 16 ranks), the rank reads that one KV head.  Where
    the q heads do not divide the heads' mesh axes at all (phi3's 40 on
    16), the ranks of those axes split the queries instead
    (:func:`_query_parallel`).  ``batch_args`` ([B, ..]) are cut by rows
    alike, ``args`` are taken whole.  Without a DTensor operand, ``fn`` as
    it is; where the heads fit no way, the whole core runs replicated."""
    if not any(isinstance(t, DTensor) for t in (q, k, v)):
        return fn(q, k, v, *batch_args, *args, **kwargs).flatten(2)
    mesh = next(t.device_mesh for t in (q, k, v) if isinstance(t, DTensor))
    place = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
             for p in (q.placements if isinstance(q, DTensor)
                       else [Replicate()] * mesh.ndim)]
    rows = [p if p == Shard(0) else Replicate() for p in place]
    idle = [i for i in rule_dims("heads") if place[i] == Replicate()]
    if idle and Shard(2) not in place and not batch_args:
        n = math.prod(mesh.size(i) for i in idle)
        if q.shape[1] % n == 0 and q.shape[1] >= n > 1:
            return _query_parallel(fn, q, k, v, args, kwargs, mesh, rows, idle)
    split = 1
    for size, p in zip(mesh.shape, place):
        split *= size if p == Shard(2) else 1
    h, kv = q.shape[2], k.shape[2]
    if h % split or (kv % split and (h // kv) % (h // split)):
        return replicated(lambda *a, **kw: fn(*a, **kw).flatten(2), q, k, v,
                          *batch_args, *args, **kwargs)
    if kv % split:                  # the KV head of this rank's q heads
        head = shard_block(mesh, place, 2, h)[1] // (h // kv)
        heads_dims = [i for i, p in enumerate(place) if p == Shard(2)]
        ks, vs = (block_of(t, mesh, rows, partial_on=heads_dims)[:, :, head:head + 1]
                  for t in (k, v))
    else:
        ks, vs = block_of(k, mesh, place), block_of(v, mesh, place)
    y = fn(block_of(q, mesh, place), ks, vs,
           *(block_of(a, mesh, rows) for a in batch_args),
           *(a.full_tensor() if isinstance(a, DTensor) else a for a in args),
           **kwargs)
    return DTensor.from_local(y.flatten(2), mesh, place, run_check=False)


#: a core's keyword operands that run along the queries ([.., T, S]: cut
#: with them), and its offset of the first query
_QUERY_ROWS, _QUERY_OFFSET = ("mask", "bias"), "q_offset"


def _query_parallel(fn, q, k, v, args, kwargs, mesh, rows, dims):
    """The core on each rank's block of queries: along the mesh dims
    ``dims`` (those of the heads, which the q heads do not divide) each
    rank takes its contiguous block of q's positions, with the matching
    rows of the causal mask or bias (``_QUERY_ROWS``) or the offset of its
    first query (``_QUERY_OFFSET``), and every head; K and V are read whole
    by this rank's rows, so their gradient there is a Partial sum, as
    GSPMD splits a replicated-heads attention.  The output comes back with
    its H·hd columns sharded on ``dims`` (one all-to-all), as the output
    projection's rows are, or whole where they do not divide."""
    qpl = [Shard(1) if i in dims else p for i, p in enumerate(rows)]
    n, start = shard_block(mesh, qpl, 1, q.shape[1])
    kw = dict(kwargs)
    for name in _QUERY_ROWS:
        if kw.get(name) is not None:
            kw[name] = full(kw[name]).narrow(-2, start, n)
    if _QUERY_OFFSET in kw:
        kw[_QUERY_OFFSET] = kw[_QUERY_OFFSET] + start
    ks, vs = (block_of(t, mesh, rows, partial_on=dims) for t in (k, v))
    y = fn(block_of(q, mesh, qpl), ks, vs,
           *(a.full_tensor() if isinstance(a, DTensor) else a for a in args),
           **kw)
    y = DTensor.from_local(y.flatten(2), mesh, qpl, run_check=False)
    cols = Shard(2) if y.shape[2] % math.prod(mesh.size(i) for i in dims) == 0 \
        else Replicate()
    return y.redistribute(mesh, [cols if i in dims else p
                                 for i, p in enumerate(rows)])


def _decode_attention(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """Grouped GQA attention over a dense cache; mask [B, T, S]."""
    scores = _gqa_scores(q, k)
    probs = _masked_softmax(scores, mask[:, None, None], cfg.softmax_dtype,
                            cfg.attn_mask_mode).to(q.dtype)
    return _gqa_out(probs, v)


def _seq_sharded(cache_k) -> bool:
    """Whether a dense cache [B, S, kv, hd] is placed with its positions
    sharded and its heads whole (the KV heads' divisibility fallback)."""
    return (isinstance(cache_k, DTensor) and Shard(1) in cache_k.placements
            and Shard(2) not in cache_k.placements)


def _seq_parallel_decode(q, k: DTensor, v: DTensor, mask, cfg: ModelConfig):
    """Decode attention over a cache whose positions are sharded: each
    rank attends every head of its rows over its own block of positions
    (max and row sum in float32, unnormalised PV in the cache's dtype),
    and the blocks combine as an online softmax does (the max over the
    position axes, each block's sum and PV rescaled to it and summed), so
    no rank gathers the cache.  [B,T,H·hd] out, placed as the rows."""
    from repro_torch.launch.mesh import pmax, psum

    mesh, names = k.device_mesh, k.device_mesh.mesh_dim_names
    pl = k.placements
    seq_axes = [names[i] for i, p in enumerate(pl) if p == Shard(1)]
    rows = [Shard(0) if p == Shard(0) else Replicate() for p in pl]
    block = [Shard(0) if p == Shard(0) else Shard(1) if p == Shard(1)
             else Replicate() for p in pl]
    mask_block = [Shard(2) if p == Shard(1) else p for p in block]
    ql, kl, vl = (block_of(q, mesh, rows), block_of(k, mesh, block),
                  block_of(v, mesh, block))
    ml = block_of(mask, mesh, mask_block)
    sd = getattr(torch, str(cfg.softmax_dtype).replace("torch.", ""))
    scores = _gqa_scores(ql, kl).to(sd)                      # [b,kv,g,T,S/n]
    neg = torch.tensor(NEG_INF, dtype=sd, device=scores.device)
    if cfg.attn_mask_mode == "additive":
        scores = scores + torch.where(ml[:, None, None], torch.zeros(
            (), dtype=sd, device=scores.device), neg)
    else:
        scores = torch.where(ml[:, None, None], scores, neg)
    f32 = torch.float32
    m = torch.amax(scores, dim=-1).to(f32)
    top = m
    for a in seq_axes:
        top = pmax(top, a, mesh)
    p = torch.exp(scores.to(f32) - m[..., None])
    scale = torch.exp(m - top)
    l = torch.sum(p, dim=-1) * scale  # noqa: E741
    # PV in the cache's dtype, as the unsharded read's is
    o = torch.einsum("bkgts,bskd->btkgd", p.to(vl.dtype), vl).to(f32) \
        * scale.permute(0, 3, 1, 2)[..., None]
    for a in seq_axes:
        l, o = psum(l, a, mesh), psum(o, a, mesh)  # noqa: E741
    y = (o / l.permute(0, 3, 1, 2)[..., None]).to(q.dtype)
    y = y.reshape(y.shape[0], y.shape[1], -1)
    return DTensor.from_local(y, mesh, rows, run_check=False)


def _naive_attention(q, k, v, cfg: ModelConfig, *, mask) -> torch.Tensor:
    """Full-head attention. q [B,T,H,hd], k/v [B,S,Kv,hd]; mask [..,T,S]."""
    h, hd = q.shape[2], q.shape[3]
    kf, vf = _repeat_kv(k, h), _repeat_kv(v, h)
    # the scaled scores reach the softmax with no other reference, so its
    # copy in softmax_dtype frees them
    probs = _masked_softmax(_scaled_scores(q, kf, hd), mask, cfg.softmax_dtype,
                            cfg.attn_mask_mode).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, vf)


def _scaled_scores(q, kf, hd: int) -> torch.Tensor:
    """q [B,T,H,hd] · kf [B,S,H,hd] → [B,H,T,S], divided by sqrt(hd)."""
    scores = torch.einsum("bthd,bshd->bhts", q, kf)
    return scores / _in_dtype(hd ** 0.5, scores.dtype)


def causal_bias(t: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Additive causal bias [T, T] (0 on and below the diagonal, -1e30
    above), built once per forward and shared by every layer."""
    pos = torch.arange(t, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=device)
    return constrain(torch.where(pos[None, :] <= pos[:, None], zero, neg),
                     (None, None))


def _lean_attention(q, k, v, cfg: ModelConfig, *, bias) -> torch.Tensor:
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
                         torch.full((), NEG_INF, dtype=torch.float32, device=dev))
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
    position, clamped to fit as a dynamic update slice is (``slice``).  A
    cache placed on a mesh takes either as positions on each rank's block
    (:func:`_write_sharded`)."""
    t = k.shape[1]
    if isinstance(cache.k, DTensor):
        if cfg.cache_mode == "slice":   # the slice's positions, on the device
            first = full(tpos)[0, 0].long().clamp(0, cache.k.shape[1] - t)
            tpos = (first + torch.arange(t, device=first.device))[None].expand(
                k.shape[0], t)
        _write_sharded(cache.k, k, tpos)
        _write_sharded(cache.v, v, tpos)
    elif cfg.cache_mode == "slice":
        start = min(max(int(tpos[0, 0]), 0), cache.k.shape[1] - t)
        cache.k[:, start:start + t] = k.to(cache.k.dtype)
        cache.v[:, start:start + t] = v.to(cache.v.dtype)
    else:
        rows = torch.arange(k.shape[0], device=k.device)[:, None]
        tp = tpos.long()
        cache.k[rows, tp] = k.to(cache.k.dtype)
        cache.v[rows, tp] = v.to(cache.v.dtype)
    cache.length.add_(t)


def _write_sharded(cache: DTensor, rows, tpos) -> None:
    """``cache[b, tpos[b, i]] = rows[b, i]`` into a dense cache placed on a
    mesh ([B, S, kv, hd], batch, positions and heads possibly sharded), on
    each rank's local block in place: DTensor refuses an in-place
    ``index_put_`` whose operands it would have to move.  The rows come to
    the cache's placements (their T axis whole); where the positions are
    sharded, an entry outside the rank's block writes back what its
    clamped slot holds, or the entry that lands there (the last of them),
    so every write to one slot carries one value."""
    mesh, pl = cache.device_mesh, tuple(cache.placements)
    new = block_of(rows.to(cache.dtype), mesh,
                   [Replicate() if p == Shard(1) else p for p in pl])
    tp = block_of(tpos, mesh, [p if p == Shard(0) else Replicate()
                               for p in pl]).long()
    local = cache.to_local()
    b = torch.arange(local.shape[0], device=local.device)[:, None]
    if Shard(1) not in pl:
        local[b, tp] = new
        return
    s_loc, start = shard_block(mesh, pl, 1, cache.shape[1])
    lp = tp - start
    valid = (lp >= 0) & (lp < s_loc)
    lp = lp.clamp(0, s_loc - 1)
    entry = torch.arange(lp.shape[1], device=lp.device).expand_as(lp)
    lands = torch.full((lp.shape[0], s_loc), -1, dtype=torch.long, device=lp.device)
    lands.scatter_reduce_(1, lp, torch.where(valid, entry, -1), reduce="amax")
    src = lands.gather(1, lp)
    pick = new[b, src.clamp(min=0)]
    local[b, lp] = torch.where((src >= 0)[..., None, None], pick, local[b, lp])


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
        y = dense(y.reshape(b, t, cfg.q_dim), p["wo"])
        return constrain(y, ("batch", "seq", "embed"))
    if cache is not None:
        # traced on fake tensors (the dry-run), a prefill's caches are empty
        warm = (update_cache and t > 1 and not is_fake(cache.length)
                and int(cache.length) > 0)
        if warm:
            raise ValueError(
                "chunked prefill into a warm dense KVCache is not supported: "
                f"the cache already holds {int(cache.length)} tokens the "
                "fresh-segment attention cannot see. Prefill the whole prompt "
                "in one call, or use the paged runtime (PagedKVCache), whose "
                "attention read covers earlier chunks through the page pool.")
        _dense_cache_write(k, v, cache, tpos, cfg)
        constrain(cache.k, ("batch", "kv_seq", "kv_heads", "head_dim"))
        constrain(cache.v, ("batch", "kv_seq", "kv_heads", "head_dim"))
        if not (update_cache and t > 1):
            kpos = torch.arange(cache.k.shape[1], device=x.device)
            mask = kpos[None, None, :] <= tpos.long()[:, :, None]  # [B,T,S]
            if _seq_sharded(cache.k):
                y = _seq_parallel_decode(q, cache.k, cache.v, mask, cfg)
            else:
                y = _head_parallel(_decode_attention, q, cache.k, cache.v, cfg,
                                   batch_args=(mask,))
            y = dense(y, p["wo"])
            return constrain(y, ("batch", "seq", "embed"))
    # no cache, or a prefill into an empty dense cache: the fresh segment
    if cfg.attn_impl == "lean":
        bias = attn_bias if attn_bias is not None else causal_bias(
            t, device=x.device)
        y = _head_parallel(_lean_attention, q, k, v, cfg, bias=bias)
    elif cfg.attn_chunk_q and t > cfg.attn_chunk_q:
        y = _head_parallel(_chunked_attention, q, k, v, q_offset=0,
                           chunk=cfg.attn_chunk_q)
    else:
        pos = torch.arange(t, device=x.device)
        mask = (pos[None, :] <= pos[:, None])[None, None]     # [1,1,T,S]
        y = _head_parallel(_naive_attention, q, k, v, cfg, mask=mask)
    y = dense(y, p["wo"])
    return constrain(y, ("batch", "seq", "embed"))
