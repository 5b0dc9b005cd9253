"""LM assembly: a Python loop over the layers of a transformer, SSM, MoE or
hybrid stack.

Parameters are a dict ``{"embed", "blocks": [per-layer dict], "final_norm",
"lm_head"}``; the reference stacks each layer position over periods and
scans, the port keeps one dict per layer (see ``repro_torch.convert``).
Block ``i`` sits at position ``i % period`` of the layer pattern, whose
mixer (attention or Mamba-2) and FFN (MLP, MoE or none) the config names.
Configs with ``modality`` audio or vlm have no ``embed`` table: their
frontends are stubs, and the backbone takes precomputed frame or patch
embeddings ``[B, T, d_model]`` in place of token ids.

``cfg.remat`` recomputes each block in the backward pass when the forward
records a graph (training: no cache, grad enabled), as the reference's
``jax.checkpoint`` around each period does: ``torch.utils.checkpoint``
without reentrancy, saving nothing inside a block (``remat_policy=
"nothing"``) or the outputs of its matrix products (``"dots"``, the
counterpart of ``checkpoint_policies.checkpoint_dots``: every ``mm``,
``bmm``, ``addmm`` and ``baddbmm``, which is what a matmul or einsum
becomes under autograd).  Serving runs under ``inference_mode`` and never
checkpoints.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Any, Dict, Optional

import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.device import resolve_device
from repro_torch.launch.sharding import (
    DTensor,
    Replicate,
    Shard,
    block_of,
    constrain,
    rules_context,
    shard_block,
)
from repro_torch.models.attention import (
    KVCache,
    attention_forward,
    causal_bias,
    init_attention,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_embed,
    apply_lm_head,
    apply_mlp,
    apply_norm,
    init_embed,
    init_lm_head,
    init_mlp,
    init_norm,
)
from repro_torch.models.mamba2 import MambaCache, init_mamba, mamba_forward
from repro_torch.models.moe import init_moe, moe_forward, padded_experts
from repro_torch.tree import leaves

Params = Dict[str, Any]


def init_block(gen: torch.Generator, cfg: ModelConfig, pos: int = 0) -> Params:
    """The block at layer position ``pos``: a pre-norm and the position's
    mixer, then (unless the FFN is ``none``) a pre-norm and its MLP or MoE."""
    dev = gen.device
    mixer, ffn = cfg.mixer_kind(pos), cfg.ffn_kind(pos)
    p: Params = {"norm_mixer": init_norm(cfg, cfg.d_model, dev),
                 "mixer": (init_attention(gen, cfg) if mixer == "attn"
                           else init_mamba(gen, cfg))}
    if ffn != "none":
        p["norm_ffn"] = init_norm(cfg, cfg.d_model, dev)
        p["ffn"] = (init_moe(gen, cfg) if ffn == "moe"
                    else init_mlp(gen, cfg, cfg.d_model, cfg.d_ff))
    return p


def block_forward(p, x: torch.Tensor, cfg: ModelConfig, pos: int, positions,
                  cache=None, page_table=None, *, update_cache: bool = False,
                  attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = apply_norm(p["norm_mixer"], x, cfg)
    # h takes the mixer's output, so the norm's and the mixer's outputs
    # are each freed as soon as they are spent
    if cfg.mixer_kind(pos) == "attn":
        h = attention_forward(p["mixer"], h, cfg, positions, cache, page_table,
                              update_cache=update_cache, attn_bias=attn_bias)
    else:
        h = mamba_forward(p["mixer"], h, cfg, cache, update_cache)
    x = x + h
    ffn = cfg.ffn_kind(pos)
    if ffn == "none":
        return x
    h = apply_norm(p["norm_ffn"], x, cfg)
    return x + (moe_forward(p["ffn"], h, cfg) if ffn == "moe"
                else apply_mlp(p["ffn"], h, cfg))


#: what the backward of a ``remat_policy="dots"`` block finds saved
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


_REMAT_CONTEXT = {
    "nothing": _ckpt.noop_context_fn,
    "dots": functools.partial(_ckpt.create_selective_checkpoint_contexts,
                              _save_dots),
}


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


def _remat_context(policy: str):
    """The checkpoint's ``context_fn`` of ``policy``, whose recompute also
    runs under the mesh rules active at the forward (on CUDA the backward,
    and so the recompute, runs on the autograd engine's device thread)."""
    def context_fn():
        forward, recompute = _REMAT_CONTEXT[policy]()
        return forward, _both(recompute, rules_context())

    return context_fn


def init_model(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights with the reference's shapes and scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return _init_tree(gen, cfg)


def _init_tree(gen, cfg: ModelConfig) -> Params:
    params = {"blocks": [init_block(gen, cfg, i % cfg.period)
                         for i in range(cfg.n_layers)],
              "final_norm": init_norm(cfg, cfg.d_model, gen.device),
              "lm_head": init_lm_head(gen, cfg)}
    if cfg.modality == "text":
        params["embed"] = init_embed(gen, cfg)
    return params


def init_caches(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
                device="cuda") -> Params:
    """Decode caches stacked over periods on ``device``: ``{"pos_i":
    KVCache [n_periods, batch, max_len, kv, hd]}`` at attention positions,
    ``MambaCache [n_periods, batch, ...]`` at Mamba positions."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype()
    stack = (cfg.n_periods,)
    return {f"pos_{pos}": (
        KVCache.zeros(cfg, batch, max_len, dtype, device=dev, stack=stack)
        if cfg.mixer_kind(pos) == "attn"
        else MambaCache.zeros(cfg, batch, dtype, device=dev, stack=stack))
        for pos in range(cfg.period)}


def forward(params: Params, inputs: torch.Tensor, cfg: ModelConfig,
            positions: Optional[torch.Tensor] = None,
            caches: Optional[Params] = None,
            page_table: Optional[torch.Tensor] = None,
            last_idx: Optional[torch.Tensor] = None, *,
            update_cache: bool = False, last_logit_only: bool = False):
    """inputs: tokens [B, T] int, or embeddings [B, T, D] (audio and vlm
    configs).  positions: int32 [B, T] (pad lanes carry the garbage
    position), or [B, T, 3] under M-RoPE; None counts 0..T-1.

    caches: None (causal self-attention over the segment), dense
    ``{"pos_i": KVCache | MambaCache}`` from :func:`init_caches`
    (``update_cache``: a prefill into an empty cache; else decode over the
    cache), or paged ``{"pos_i": PagedKVCache}`` with ``page_table`` int32
    [B, W] (attention stacks only).  Caches are updated in place.

    ``last_idx`` int [B]: per-row index of the last real token, gathered
    before the LM head (logits [B, 1, V]); ``last_logit_only`` keeps the
    last position.  Returns (logits, caches)."""
    if inputs.ndim == 2:
        h = apply_embed(params["embed"], inputs)
    else:
        h = constrain(inputs.to(cfg.dtype()), ("batch", "seq", "embed"))
    b, t = h.shape[0], h.shape[1]
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=h.device)[None].expand(b, t)
    attn_bias = (causal_bias(t, device=h.device)
                 if cfg.attn_impl == "lean" and t > 1 else None)
    remat = cfg.remat and caches is None and torch.is_grad_enabled()
    for layer, bp in enumerate(params["blocks"]):
        pos, cache = layer % cfg.period, None
        if caches is not None:
            cache = caches[f"pos_{pos}"].layer(layer // cfg.period)
        if remat:
            h = _ckpt.checkpoint(block_forward, bp, h, cfg, pos, positions,
                                 attn_bias=attn_bias, use_reentrant=False,
                                 context_fn=_remat_context(cfg.remat_policy))
        else:
            h = block_forward(bp, h, cfg, pos, positions, cache, page_table,
                              update_cache=update_cache, attn_bias=attn_bias)
    if last_idx is not None:
        rows = torch.arange(h.shape[0], device=h.device)
        h = h[rows, last_idx.long()][:, None]
    elif last_logit_only:
        h = h[:, -1:]
    h = apply_norm(params["final_norm"], h, cfg)
    return apply_lm_head(params["lm_head"], h), caches


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy in float32 (:class:`_CrossEntropy`: the
    backward holds one float32 buffer of the logits' shape).  Logits
    placed on a mesh are reduced where they lie (:func:`_sharded_lm_loss`);
    a replicated DTensor result."""
    if isinstance(logits, DTensor):
        return _sharded_lm_loss(logits, labels)
    return _lm_loss(logits, labels)


#: float32 bytes of one block of rows that the loss's backward works on at
#: a time (at most a quarter of the rows: a 16-bit gradient and one float32
#: block then hold less than one float32 buffer of the logits' shape)
_LOSS_BLOCK_BYTES = 1 << 28


class _CrossEntropy(torch.autograd.Function):
    """Each row's ``log Σ exp(x) − x[label]`` in float32, the logits ``x``
    [.., V] read in their own dtype (one float32 temporary of their shape,
    summed as ``torch.logsumexp`` sums).  ``start`` is the first vocab
    index of ``x``'s columns and ``combine(m, op)``
    reduces a per-row ``"max"`` or ``"sum"`` over the ranks that hold the
    other columns (Megatron's vocab-parallel cross-entropy: a label outside
    this block adds no gold logit here).  Saves the logits (the graph holds
    them already), the labels and each row's log-sum-exp; the backward
    writes ``(softmax − one_hot) · g`` in float32 into the logits' own
    dtype, a block of rows at a time, into one float32 buffer when that is
    their dtype, as the autograd chain's ``exp(x − lse) · g``, less ``g``
    at the label."""

    @staticmethod
    def forward(ctx, x, labels, start, combine):
        v = x.shape[-1]
        x2, lab = x.reshape(-1, v), labels.reshape(-1).long() - start
        hit = (lab >= 0) & (lab < v)
        lab = torch.where(hit, lab, 0)
        m = torch.amax(x2, dim=-1).to(torch.float32)
        if combine is not None:
            m = combine(m, "max")
        se = torch.sum((x2 - m[:, None]).exp_(), dim=-1)
        gold = torch.gather(x2, 1, lab[:, None])[:, 0].to(torch.float32)
        gold = torch.where(hit, gold, torch.zeros((), dtype=gold.dtype,
                                                  device=gold.device))
        if combine is not None:
            se, gold = combine(se, "sum"), combine(gold, "sum")
        lse = m + torch.log(se)
        ctx.save_for_backward(x, lab, hit, lse)
        return (lse - gold).reshape(labels.shape)

    @staticmethod
    def backward(ctx, g):
        x, lab, hit, lse = ctx.saved_tensors
        v = x.shape[-1]
        x2, g = x.reshape(-1, v), g.reshape(-1).to(torch.float32)
        out = torch.empty_like(x2)
        gold_g = torch.where(hit, -g, torch.zeros((), dtype=g.dtype, device=g.device))
        for r in _row_blocks(x2):
            if out.dtype == torch.float32:
                buf = torch.sub(x2[r], lse[r, None], out=out[r])
            else:
                buf = x2[r] - lse[r, None]
            buf.exp_().mul_(g[r, None])
            rows = torch.arange(buf.shape[0], device=buf.device)
            buf.index_put_((rows, lab[r]), gold_g[r], accumulate=True)
            if out.dtype != torch.float32:
                out[r] = buf
        return out.reshape(x.shape), None, None, None


def _row_blocks(x2: torch.Tensor):
    """Slices of ``x2``'s rows, at most a quarter of them each, whose
    float32 copy fits ``_LOSS_BLOCK_BYTES``."""
    n, v = x2.shape
    step = max(1, min(_LOSS_BLOCK_BYTES // (4 * max(v, 1)), -(-n // 4)))
    return [slice(i, min(i + step, n)) for i in range(0, n, step)]


def _lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(_CrossEntropy.apply(logits, labels, 0, None))


def _sharded_lm_loss(logits: DTensor, labels) -> DTensor:
    """The loss on each rank's block of the logits: its rows where the
    batch or sequence is sharded, its slice of the vocab where that is
    (the log-sum-exp's max and sum, and the gold logit, combined over the
    vocab's mesh axes inside :class:`_CrossEntropy`), the tokens' sum over
    the rows' axes.  No rank holds the global logits.  Every rank ends
    with the same scalar; the combines (``psum``) pass each rank's
    cotangent through as it is, as that replicated scalar's gradient is:
    a rank's gradient is its own block, the gold term only where the label
    falls in it."""
    from repro_torch.launch.mesh import pmax, psum

    mesh, names = logits.device_mesh, logits.device_mesh.mesh_dim_names
    pl = [p if isinstance(p, Shard) else Replicate() for p in logits.placements]
    if pl != list(logits.placements):          # a Partial sum: reduce it
        logits = logits.redistribute(mesh, pl)
    rows_pl = [p if p.is_shard() and p.dim < 2 else Replicate() for p in pl]
    vocab_axes = [names[i] for i, p in enumerate(pl) if p == Shard(2)]
    row_axes = [names[i] for i, p in enumerate(pl) if p.is_shard() and p.dim < 2]
    lab = block_of(labels, mesh, rows_pl)
    _, start = shard_block(mesh, pl, 2, logits.shape[-1])    # the vocab block

    def combine(t, op):
        for a in vocab_axes:
            t = pmax(t, a, mesh) if op == "max" else psum(t, a, mesh)
        return t

    total = torch.sum(_CrossEntropy.apply(logits.to_local(), lab, start,
                                          combine if vocab_axes else None))
    for a in row_axes:
        total = psum(total, a, mesh)
    loss = total / (labels.shape[0] * labels.shape[1])
    return DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


class _ShapeGen:
    """Stands in for a generator on the meta device: the init functions
    then build tensors with shapes and dtypes and no data."""

    device = torch.device("meta")


def abstract_params(cfg: ModelConfig) -> Params:
    """:func:`init_model`'s tree for ``cfg`` on the meta device: shapes and
    dtypes, no bytes."""
    return _init_tree(_ShapeGen(), cfg)


def count_params(cfg: ModelConfig) -> int:
    """Parameters of :func:`init_model`'s tree for ``cfg``, counted from the
    tree's shapes (built on the meta device, no bytes)."""
    return sum(math.prod(x.shape) for x in leaves(abstract_params(cfg)))


def count_active_params(cfg: ModelConfig) -> int:
    """Active parameters: the routed experts count ``top_k`` of their
    (padded) number, as the reference's roofline counts them."""
    total = count_params(cfg)
    if not cfg.n_experts:
        return total
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    n_moe = cfg.n_periods * sum(cfg.ffn_kind(pos) == "moe"
                                for pos in range(cfg.period))
    return total - n_moe * (padded_experts(cfg) - cfg.top_k) * per_expert
