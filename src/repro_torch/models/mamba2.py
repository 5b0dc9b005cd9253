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
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.engine import dense
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
    float64, as the port's norms do, so a row rounds alike at any batch)."""
    g = y * F.silu(z.to(torch.float32))
    return g * torch.rsqrt(_mean_square(g) + eps) * scale.to(torch.float32)


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


def mamba_forward(p, x: torch.Tensor, cfg: ModelConfig,
                  cache: Optional[MambaCache] = None,
                  update_cache: bool = False) -> torch.Tensor:
    """Mamba-2 block: train (no cache), prefill (``update_cache``, from the
    cache's state) or decode (T = 1 over the cache).  The new conv window and
    SSM state are written into ``cache`` in place; returns the output."""
    b, t, _ = x.shape
    h, pdim, s = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    z, xbc, dt_raw = _split_proj(cfg, dense(x, p["in_proj"]))

    conv_in = cache.conv if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_in)
    gs = cfg.ssm_groups * s
    di = cfg.d_inner
    xh = xbc[..., :di].reshape(b, t, h, pdim)
    bmat = xbc[..., di:di + gs].reshape(b, t, cfg.ssm_groups, s)
    cmat = xbc[..., di + gs:].reshape(b, t, cfg.ssm_groups, s)

    dt = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])

    if cache is not None and t == 1 and not update_cache:
        y1, new_ssm = ssd_step(cache.ssm, xh[:, 0], dt[:, 0], a, bmat[:, 0],
                               cmat[:, 0])
        y = y1[:, None]
    else:
        y, new_ssm = ssd_chunked(xh, dt, a, bmat, cmat, cfg.ssm_chunk,
                                 cache.ssm if cache is not None else None)

    y = y + p["D"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(b, t, di)
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps).to(x.dtype)
    out = dense(y, p["out_proj"])
    if cache is not None:
        cache.conv.copy_(new_conv.to(cache.conv.dtype))
        cache.ssm.copy_(new_ssm)
    return out
