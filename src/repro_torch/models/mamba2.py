"""Mamba-2 (SSD, state-space duality) block [arXiv:2405.21060].

The chunked SSD algorithm: an intra-chunk quadratic (attention-like) term
plus an inter-chunk state recurrence, so memory stays O(T·Q) instead of
O(T·H·P·S); the reference scans over chunks with ``lax.scan``, the port
loops over them in Python.  Decode is the O(1) single-step recurrence on the
(conv window, SSM state) pair.  Every float32 cast the reference makes is
kept; the projections run through :func:`repro_torch.core.engine.dense`, so
a frozen block's ``in_proj`` and ``out_proj`` take the DA datapath.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.engine import dense
from repro_torch.launch.mesh import exchange_columns
from repro_torch.launch.sharding import (
    DTensor,
    Replicate,
    Shard,
    block_of,
    constrain,
    on_rows,
    placements,
    pspec,
    replicated,
    rule_dims,
    shard_block,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _mean_square, normal_init


@dataclasses.dataclass
class MambaCache:
    """Decode state of one Mamba layer, or a stack of them.

    conv: ``[(n_periods,) B, conv - 1, conv_channels]`` rolling window in the
    compute dtype; ssm: ``[(n_periods,) B, H, P, S]`` state in float32.
    Writes land in place."""

    conv: torch.Tensor
    ssm: torch.Tensor

    @staticmethod
    def zeros(cfg: ModelConfig, batch: int, dtype, device="cpu",
              stack=()) -> "MambaCache":
        lead = tuple(stack) + (batch,)
        return MambaCache(
            conv=torch.zeros(lead + (cfg.ssm_conv - 1, cfg.conv_channels),
                             dtype=dtype, device=device),
            ssm=torch.zeros(lead + (cfg.ssm_heads, cfg.ssm_head_dim,
                                    cfg.ssm_state),
                            dtype=torch.float32, device=device))

    def layer(self, i: int) -> "MambaCache":
        """Views of stacked layer ``i`` (writes land in the stack)."""
        return MambaCache(conv=self.conv[i], ssm=self.ssm[i])


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The reference's leaves, shapes and scales: ``in_proj`` [d, 2·d_inner
    + 2·G·S + H] (z, x, B, C, dt), the depthwise ``conv_w`` [conv, ch] and
    ``conv_b``, ``A_log`` = log(linspace(1, 16, H)), ``D`` ones, ``dt_bias``
    zeros, the gated norm's ``norm_scale`` and ``out_proj`` [d_inner, d]."""
    dt = cfg.pdtype()
    dev = gen.device
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gs = cfg.ssm_groups * cfg.ssm_state
    proj_out = 2 * di + 2 * gs + h
    f32 = torch.float32
    return {
        "in_proj": normal_init(gen, (d, proj_out), 1.0 / (d ** 0.5), dt),
        "conv_w": normal_init(gen, (cfg.ssm_conv, cfg.conv_channels), 0.2, dt),
        "conv_b": torch.zeros((cfg.conv_channels,), dtype=dt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=dev)),
        "D": torch.ones((h,), dtype=f32, device=dev),
        "dt_bias": torch.zeros((h,), dtype=f32, device=dev),
        "norm_scale": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": normal_init(gen, (di, d), 1.0 / (di ** 0.5), dt),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, gs = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * gs]
    dt = zxbcdt[..., 2 * di + 2 * gs:]
    if dt.shape[-1] != cfg.ssm_heads:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt columns for "
                         f"{cfg.ssm_heads} heads")
    return z, xbc, dt


#: the column segments of ``in_proj``'s output, in order, with the
#: logical axis each is projected on and the one it is used on, on a mesh
#: (B and C are shared by the heads of a group: projected on their
#: columns, then whole)
_SEGMENTS = (("z", "inner", "inner"), ("x", "inner", "inner"),
             ("B", "inner", None), ("C", "inner", None),
             ("dt", "ssm_heads", "ssm_heads"))


def _segment_widths(cfg: ModelConfig):
    gs = cfg.ssm_groups * cfg.ssm_state
    return (cfg.d_inner, cfg.d_inner, gs, gs, cfg.ssm_heads)


def _heads_split(x, cfg: ModelConfig) -> Optional[int]:
    """The mesh dim that splits the block's heads (the ``inner`` rules'
    one dim, holding no rows of ``x``), where the channels and heads
    divide it; None where the block runs on rows only."""
    dims = rule_dims("inner")
    if not isinstance(x, DTensor) or len(dims) != 1:
        return None
    d = dims[0]
    n = x.device_mesh.size(d)
    if x.placements[d] != Replicate() or cfg.d_inner % n or cfg.ssm_heads % n:
        return None
    hb, per_g = cfg.ssm_heads // n, cfg.ssm_heads // cfg.ssm_groups
    return d if hb % per_g == 0 or per_g % hb == 0 else None


def _segment_layout(cfg: ModelConfig, n: int, conv: bool = False):
    """Each of ``n`` ranks' column ranges of ``in_proj``'s output (of the
    conv channels with ``conv``) in Megatron's Mamba layout: its block of
    heads' columns of z, x and dt, and B and C whole."""
    di, gs, h = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    zb, hb = di // n, h // n
    if conv:
        return [[(r * zb, (r + 1) * zb), (di, di + 2 * gs)] for r in range(n)]
    return [[(r * zb, (r + 1) * zb), (di + r * zb, di + (r + 1) * zb),
             (2 * di, 2 * di + 2 * gs),
             (2 * di + 2 * gs + r * hb, 2 * di + 2 * gs + (r + 1) * hb)]
            for r in range(n)]


def _held(t, dim: int, n: int):
    """The column ranges of ``t``'s last dim that each of the ``n`` ranks
    of mesh dim ``dim`` holds: contiguous blocks where ``t`` is split
    there, else all of them."""
    width = t.shape[-1]
    if isinstance(t, DTensor) and t.placements[dim] == Shard(t.ndim - 1):
        c = width // n
        return [[(i * c, (i + 1) * c)] for i in range(n)]
    return [[(0, width)]] * n


def _mesh_mixer(p, x: DTensor, cfg: ModelConfig, cache, update_cache: bool,
                hd: int):
    """``in_proj``, the causal conv and the SSD on a mesh whose dim ``hd``
    splits the heads, in Megatron's Mamba layout (each rank its own
    heads' columns of z, x and dt, and B and C whole;
    :func:`_segment_layout`), where the contiguous split of the whole
    projection (the parameter's placement, kept as the reference's) cuts
    across the segments.  The cheaper of two exchanges gives the
    segments: the weight gathered once and projected segment by segment
    (many rows: train, prefill), or the projection's columns moved to
    their ranks (few rows: decode, and any frozen pack;
    :func:`repro_torch.launch.mesh.exchange_columns`).  The conv taps and
    the cached window move alike, the conv runs on each rank's channels,
    and the new window goes back to the cache's placement; the scan or
    step runs on each rank's heads, reading the B/C groups they span, and
    writes the rank's block of the SSM state.  B and C are read whole, so
    their gradient on a rank is its heads' part, summed where they came
    from.  Returns y (with the D skip) and z, [B, T, d_inner] DTensors
    split on ``hd``."""
    mesh, n = x.device_mesh, x.device_mesh.size(hd)
    axis = mesh.mesh_dim_names[hd]
    rows = [p_ if p_ == Shard(0) else Replicate() for p_ in x.placements]
    row_dims = [i for i, p_ in enumerate(rows) if p_ == Shard(0)]
    heads = [Shard(2) if i == hd else p_ for i, p_ in enumerate(rows)]
    widths = _segment_widths(cfg)
    gs = widths[2]
    w = p["in_proj"]
    if isinstance(w, DTensor) and math.prod(x.to_local().shape[:-1]) > w.shape[0]:
        whole = w.redistribute(mesh, [Replicate() if p_ == Shard(1) else p_
                                      for p_ in w.placements])
        starts = [sum(widths[:i]) for i in range(len(widths))]
        segs = [constrain(constrain(dense(x, constrain(
                    whole.narrow(-1, a, m), ("embed", proj))),
                    ("batch", "seq", proj)), ("batch", "seq", use))
                for (_, proj, use), a, m in zip(_SEGMENTS, starts, widths)]
        z, xs, bs, cs, dt = (
            block_of(t, mesh, tuple(t.placements),
                     partial_on=[] if use else [hd])
            for t, (_, _, use) in zip(segs, _SEGMENTS))
    else:
        y = dense(x, w)
        z, xs, bs, cs, dt = torch.split(
            exchange_columns(block_of(y, mesh, tuple(y.placements)),
                             _held(y, hd, n), _segment_layout(cfg, n), axis, mesh),
            [widths[0] // n, widths[1] // n, gs, gs, widths[4] // n], dim=-1)
    conv = _segment_layout(cfg, n, conv=True)

    def taps(t):
        """``t``'s segment channels on this rank (its gradient a Partial
        sum over the rows' mesh dims)."""
        local = (block_of(t, mesh, tuple(t.placements), partial_on=row_dims)
                 if isinstance(t, DTensor) else t)
        return exchange_columns(local, _held(t, hd, n), conv, axis, mesh)

    window = None
    if cache is not None:
        window = exchange_columns(cache.conv.to_local(), _held(cache.conv, hd, n),
                                  conv, axis, mesh)
    xbc, new = _causal_conv(torch.cat([xs, bs, cs], dim=-1), taps(p["conv_w"]),
                            taps(p["conv_b"]), window)
    if cache is not None:
        cache.conv.to_local().copy_(exchange_columns(
            new, conv, _held(cache.conv, hd, n), axis, mesh).to(cache.conv.dtype))
    xs, bs, cs = torch.split(xbc, [widths[0] // n, gs, gs], dim=-1)

    hb = cfg.ssm_heads // n
    h0 = mesh.get_local_rank(hd) * hb
    per_g = cfg.ssm_heads // cfg.ssm_groups
    g0, gn = h0 // per_g, max(1, hb // per_g)
    own = [Shard(0) if i == hd else Replicate() for i in range(mesh.ndim)]
    head_param = lambda t: block_of(t, mesh, own, partial_on=row_dims)  # noqa: E731
    b_loc, t = xs.shape[0], xs.shape[1]
    xh = xs.reshape(b_loc, t, hb, cfg.ssm_head_dim)
    groups = lambda m: m.reshape(b_loc, t, cfg.ssm_groups, -1)[:, :, g0:g0 + gn]  # noqa: E731
    bmat, cmat = groups(bs), groups(cs)
    dt = F.softplus(dt.to(torch.float32) + head_param(p["dt_bias"]))
    a = -torch.exp(head_param(p["A_log"]))
    state = cache.ssm.to_local() if cache is not None else None
    if cache is not None and t == 1 and not update_cache:
        y, new_ssm = ssd_step(state, xh[:, 0], dt[:, 0], a, bmat[:, 0], cmat[:, 0])
        y = y[:, None]
    else:
        y, new_ssm = ssd_chunked(xh, dt, a, bmat, cmat, cfg.ssm_chunk, state)
    if cache is not None:
        state.copy_(new_ssm)
    y = y + head_param(p["D"])[None, None, :, None] * xh.to(torch.float32)
    wrap = lambda v: DTensor.from_local(  # noqa: E731
        v.reshape(b_loc, t, -1), mesh, heads, run_check=False)
    return wrap(y), wrap(z)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cache_conv: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time, xbc [B, T, C], w [K, C]: the taps
    summed one by one in xbc's dtype, then SiLU.  Returns (y, the last
    K - 1 rows of the context: the next call's window)."""
    k, t = w.shape[0], xbc.shape[1]
    if cache_conv is not None:
        ctx = torch.cat([cache_conv.to(xbc.dtype), xbc], dim=1)
    else:
        ctx = F.pad(xbc, (0, 0, k - 1, 0))
    new_conv = ctx[:, -(k - 1):, :] if k > 1 else None
    y = 0
    for i in range(k):
        y = y + w[i][None, None] * ctx[:, i:i + t, :]
    return F.silu(y + b[None, None]), new_conv


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """RMS norm of ``y · silu(z)`` in float32 (the mean of squares summed in
    float64, as the port's norms do, so a row rounds alike at any batch);
    y, z [B, T, d_inner]."""
    g = y * F.silu(z.to(torch.float32))
    # on a mesh the row statistic is whole on every rank of the channels
    # (left to DTensor, it comes back split on the rows' dim 0, and every
    # product with it then moves the channels)
    ms = constrain(_mean_square(g), ("batch", "seq", None))
    return g * torch.rsqrt(ms + eps) * scale.to(torch.float32)


def _per_head(m: torch.Tensor, h: int) -> torch.Tensor:
    """[.., G, S] group streams → [.., H, S] in float32 (each group repeated
    for its H / G heads)."""
    return torch.repeat_interleave(m.to(torch.float32), h // m.shape[-2],
                                   dim=-2)


def ssd_chunked(x, dt, a, bmat, cmat, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x [B, T, H, P] (raw head inputs, not dt-scaled), dt [B, T, H] (positive
    step sizes), a [H] (negative decay rates), bmat / cmat [B, T, G, S].
    Returns (y [B, T, H, P], final state [B, H, P, S]), in float32."""
    btot, t, h, p = x.shape
    q = min(chunk, t)
    pad = (-t) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    nc = (t + pad) // q
    xf = x.to(torch.float32).reshape(btot, nc, q, h, p)
    dtf = dt.to(torch.float32).reshape(btot, nc, q, h)
    bf = _per_head(bmat, h).reshape(btot, nc, q, h, -1)
    cf = _per_head(cmat, h).reshape(btot, nc, q, h, -1)

    dta = dtf * a[None, None, None, :]              # [B,C,Q,H] (negative)
    cs = torch.cumsum(dta, dim=2)                   # inclusive cumsum
    total = cs[:, :, -1, :]                         # [B,C,H]
    dtx = xf * dtf[..., None]                       # dt-scaled inputs

    # intra-chunk: Y_ij = exp(cs_i - cs_j) · (C_i·B_j) · dtx_j   (j ≤ i)
    li = cs[:, :, :, None, :] - cs[:, :, None, :, :]      # [B,C,Q,Q,H]
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: the upper triangle of li is positive (cs decreases)
    li = torch.where(tri[None, None, :, :, None], li,
                     torch.tensor(float("-inf"), device=x.device))
    decay = torch.exp(li)
    cb = torch.einsum("bcihs,bcjhs->bcijh", cf, bf)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", cb * decay, dtx)

    # chunk summary states: S_c = Σ_j exp(total − cs_j) dtx_j ⊗ B_j
    decay_out = torch.exp(total[:, :, None, :] - cs)       # [B,C,Q,H]
    s_c = torch.einsum("bcjh,bcjhp,bcjhs->bchps", decay_out, dtx, bf)

    # inter-chunk recurrence over the (few) chunks; keep each chunk's start
    state = (init_state.to(torch.float32) if init_state is not None
             else torch.zeros((btot, h, p, bf.shape[-1]), dtype=torch.float32,
                              device=x.device))
    starts = []
    for c in range(nc):
        starts.append(state)
        state = state * torch.exp(total[:, c])[:, :, None, None] + s_c[:, c]
    h_starts = torch.stack(starts, dim=1)                  # [B,C,H,P,S]

    # inter-chunk contribution: C_i · (H_start · exp(cs_i))
    y_inter = torch.einsum("bcihs,bchps,bcih->bcihp", cf, h_starts,
                           torch.exp(cs))
    y = (y_intra + y_inter).reshape(btot, nc * q, h, p)[:, :t]
    return y, state


def ssd_step(state, x, dt, a, bmat, cmat):
    """One decode step.  state [B, H, P, S]; x [B, H, P]; dt [B, H]; bmat /
    cmat [B, G, S].  Returns (y [B, H, P], new state), in float32."""
    h = x.shape[1]
    bf, cf = _per_head(bmat, h), _per_head(cmat, h)         # [B,H,S]
    dta = torch.exp(dt.to(torch.float32) * a[None, :])      # [B,H]
    upd = torch.einsum("bhp,bhs->bhps", x.to(torch.float32) * dt[..., None], bf)
    new_state = state * dta[:, :, None, None] + upd
    y = torch.einsum("bhps,bhs->bhp", new_state, cf)
    return y, new_state


def _on_blocks(fn, x, dt, a, bmat, cmat, state=None):
    """``fn(state, x, dt, a, bmat, cmat)`` → ``(y, new state)``, the SSD
    scan or step, run on each rank's own rows and heads where its
    operands are placed on a mesh: x ``[B, (T,) H, P]``, dt ``[B, (T,)
    H]``, a ``[H]``, bmat / cmat ``[B, (T,) G, S]``, state ``[B, H, P,
    S]`` or None.  Rows and heads are independent; the rules place them
    (``batch``, ``ssm_heads``), and a rank's block of heads reads the B/C
    groups it spans.  y and the state come back placed so.  Without a
    DTensor operand, ``fn`` as it is; where a block of heads straddles
    groups unevenly, the whole scan runs replicated."""
    if not any(isinstance(t, DTensor) for t in (x, dt, bmat, cmat, state)):
        return fn(state, x, dt, a, bmat, cmat)
    mesh = next(t.device_mesh for t in (x, dt, bmat, cmat, state)
                if isinstance(t, DTensor))
    hd = x.ndim - 2                            # the heads' dim of x
    h, g = x.shape[hd], bmat.shape[-2]
    place = placements(pspec(("batch", "ssm_heads"), (x.shape[0], h)), mesh)
    split = math.prod(mesh.size(i) for i, p in enumerate(place) if p == Shard(1))
    hb, per_g = h // split, h // g
    if hb % per_g and per_g % hb:
        return replicated(lambda *a_: fn(a_[-1], *a_[:-1]), x, dt, a, bmat,
                          cmat, state)
    g0, gn = shard_block(mesh, place, 1, h)[1] // per_g, max(1, hb // per_g)

    def cut(t, rows, heads):
        """t's block: its dim ``rows`` on the batch axes, ``heads`` on the
        heads axes (None: whole, and read by this rank's part only)."""
        target = [Shard(rows) if p == Shard(0) and rows is not None else
                  Shard(heads) if p == Shard(1) and heads is not None else
                  Replicate() for p in place]
        part = [i for i, p in enumerate(place) if p != Replicate()
                and target[i] == Replicate()]
        return block_of(t, mesh, target, partial_on=part)

    y, new = fn(None if state is None else cut(state, 0, 1), cut(x, 0, hd),
                cut(dt, 0, dt.ndim - 1), cut(a, None, 0),
                cut(bmat, 0, None).narrow(-2, g0, gn),
                cut(cmat, 0, None).narrow(-2, g0, gn))
    wrap = lambda t, d: DTensor.from_local(  # noqa: E731
        t, mesh, [Shard(d) if p == Shard(1) else p for p in place],
        run_check=False)
    return wrap(y, hd), wrap(new, 1)


def _mixer(p, x: torch.Tensor, cfg: ModelConfig, cache, update_cache: bool):
    """``in_proj``, the causal conv and the SSD on one device, or on a mesh
    by rows (the conv's rows and the scan's rows and heads,
    :func:`on_rows` and :func:`_on_blocks`); the cache written in place.
    Returns y (with the D skip) and z, [B, T, d_inner]."""
    b, t, _ = x.shape
    h, pdim, s = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gs = cfg.ssm_groups * s
    di = cfg.d_inner
    zxbcdt = constrain(dense(x, p["in_proj"]), ("batch", "seq", "inner"))
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    xbc, new_conv = on_rows(_causal_conv, xbc, p["conv_w"], p["conv_b"],
                            cache.conv if cache is not None else None,
                            whole=(1, 2))
    xh = xbc[..., :di].reshape(b, t, h, pdim)
    bmat = xbc[..., di:di + gs].reshape(b, t, cfg.ssm_groups, s)
    cmat = xbc[..., di + gs:].reshape(b, t, cfg.ssm_groups, s)

    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])

    if cache is not None and t == 1 and not update_cache:
        y1, new_ssm = _on_blocks(
            lambda s_, x_, dt_, a_, b_, c_: ssd_step(s_, x_, dt_, a_, b_, c_),
            xh[:, 0], dt[:, 0], a, bmat[:, 0], cmat[:, 0], cache.ssm)
        y = y1[:, None]
    else:
        y, new_ssm = _on_blocks(
            lambda s_, x_, dt_, a_, b_, c_: ssd_chunked(
                x_, dt_, a_, b_, c_, cfg.ssm_chunk, s_),
            xh, dt, a, bmat, cmat, cache.ssm if cache is not None else None)

    y = y + p["D"][None, None, :, None] * xh.to(torch.float32)
    if cache is not None:
        cache.conv.copy_(new_conv.to(cache.conv.dtype))
        cache.ssm.copy_(new_ssm)
    return y.reshape(b, t, di), z


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig,
                  cache: Optional[MambaCache] = None,
                  update_cache: bool = False) -> torch.Tensor:
    """Mamba-2 block: train (no cache), prefill (``update_cache``, from the
    cache's state) or decode (T = 1 over the cache).  The new conv window and
    SSM state are written into ``cache`` in place; returns the output."""
    hd = _heads_split(x, cfg)
    if hd is not None:              # on a mesh: Megatron's layout
        y, z = _mesh_mixer(p, x, cfg, cache, update_cache, hd)
    else:
        y, z = _mixer(p, x, cfg, cache, update_cache)
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps).to(x.dtype)
    return constrain(dense(y, p["out_proj"]), ("batch", "seq", "embed"))
