"""PyTorch port kernels vs the JAX reference's Pallas kernels.

On the CPU each wrapper runs its plain version (only because its tensors lie
on the CPU); those are held against the Pallas kernels run in interpret mode:
the bit-plane and LUT-readout VMMs bit-exactly, the paged-attention read in
float32 to
atol 1e-5 / rtol 1e-5 (both compute the same roundings; only float32
summation order differs), over fp, int8 and int4 pools.  The attention
kernel's cluster order (per-chunk maxima to the row max, per-chunk float64
exp-sums and PV partials added in chunk order, rounded probabilities) is
emulated in plain torch, held against both at the card's tolerances (2^-7
in bfloat16, 1e-5 in float32) and EQUAL to the plain read.  The two VMM kernels' splits (group ranges of the
LUT readout, K ranges of the bit-plane kernel, each from the wrapper's plan)
are emulated the same way and held bit-exactly against both; the plans
themselves are checked for coverage, grid size and shared memory.

The kernels themselves are tested on the card by ``tests/test_torch_gpu.py``.
"""
import inspect

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core.da import DAConfig as JDA
from repro.core.da import build_luts as jbuild_luts
from repro.kernels.bitplane_vmm import bitplane_vmm_pallas
from repro.kernels.da_vmm import da_vmm_pallas
from repro.kernels.paged_attention import paged_attention as jpaged
from repro.models import kv_quant as jkvq
from repro_torch.core.da import DAConfig, bit_planes, build_luts, group_addresses
from repro_torch.kernels import build, ops
from repro_torch.kernels.bitplane_vmm import bitplane_plan
from repro_torch.kernels.da_vmm import lut_plan
from repro_torch.kernels.paged_attention import (block_shape, block_smem, paged_attention,
                                                 split_plan)
from repro_torch.models import kv_quant as tkvq


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# bit-plane DA VMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("x_bits", [4, 8])
@pytest.mark.parametrize("k", [32, 45])
def test_bitplane_plain_matches_pallas_interpret(signed, x_bits, k):
    rng = np.random.default_rng(10 * k + x_bits)
    lo, hi = (-(1 << (x_bits - 1)), 1 << (x_bits - 1)) if signed else (0, 1 << x_bits)
    xq = rng.integers(lo, hi, (3, k)).astype(np.int32)
    wq = rng.integers(-127, 128, (k, 20)).astype(np.int8)
    ref = bitplane_vmm_pallas(jnp.asarray(xq), jnp.asarray(wq),
                              JDA(x_bits=x_bits, x_signed=signed), interpret=True)
    cfg = DAConfig(x_bits=x_bits, x_signed=signed)
    got = ops.bitplane_vmm(_t(xq), _t(wq), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the plain version also takes int32 codes (the kernel takes int8 only)
    np.testing.assert_array_equal(
        ops.bitplane_vmm(_t(xq), _t(wq).to(torch.int32), cfg).numpy(),
        np.asarray(ref))


# ---------------------------------------------------------------------------
# LUT-readout DA VMM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(1, 8, 1), (4, 25, 6), (16, 64, 32),
                                   (33, 100, 17)])
@pytest.mark.parametrize("signed", [False, True])
def test_lut_plain_matches_pallas_interpret(m, k, n, signed):
    """The reference's fast kernel shapes, CONV1's 4x25x6 among them."""
    rng = np.random.default_rng(m * k + n)
    xq = (rng.integers(-128, 128, (m, k)) if signed
          else rng.integers(0, 256, (m, k))).astype(np.int32)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int32)
    ref = da_vmm_pallas(jnp.asarray(xq), jbuild_luts(jnp.asarray(wq)),
                        JDA(group_size=8, x_bits=8, x_signed=signed),
                        bm=64, bn=32, bg=4, interpret=True)
    cfg = DAConfig(group_size=8, x_bits=8, x_signed=signed)
    got = ops.da_vmm(_t(xq), build_luts(_t(wq), 8), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), xq.astype(np.int64) @ wq)


# ---------------------------------------------------------------------------
# the VMM kernels' plans and split arithmetic
# ---------------------------------------------------------------------------

#: an H100: 132 SMs, 227 KB of shared memory a block may take
SMS, SMEM_LIMIT = 132, 232448
#: the (K, N) shapes chip_smoke.py times: the LUT-serving model's, qwen3-8b's
LUT_SHAPES = ((256, 256), (256, 128), (256, 768), (768, 256), (256, 8000))
VMM_SHAPES = ((4096, 6144), (4096, 4096), (4096, 12288), (12288, 4096),
              (4096, 151936))


def _ranges(total: int, per: int):
    return [(s, min(total, s + per)) for s in range(0, total, per)]


@pytest.mark.parametrize("m", [4, 8, 16, 64, 128, 300])
@pytest.mark.parametrize("k,n", LUT_SHAPES)
def test_lut_plan_covers_groups_fills_the_card_and_fits(m, k, n):
    """The decode (M = 4) and prefill (M = 64) shapes chip_smoke.py runs,
    and the widths between and past them."""
    g = -(-k // 8)
    plan = lut_plan(m, n, g, SMS)
    covered = [gi for a, b in _ranges(g, plan.gpb) for gi in range(a, b)]
    assert covered == list(range(g))  # every group in exactly one range
    cols = 32 * plan.vec
    assert plan.blocks == -(-n // cols) * -(-m // plan.bm) * -(-g // plan.gpb)
    assert plan.blocks >= SMS
    assert plan.bm == (1 if m <= 8 else 2) and plan.gpb <= 8
    assert plan.warps == min(4, plan.gpb)
    # the warps' partials meet in static shared memory, below 48 KB
    assert plan.warps * plan.bm * cols * 4 <= 48 << 10


@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("k,n", VMM_SHAPES)
def test_bitplane_plan_covers_k_fills_the_card_and_fits(m, k, n):
    plan = bitplane_plan(m, k, n, SMS)
    assert plan.k_per_split % 128 == 0
    steps = [s for a, b in _ranges(k, plan.k_per_split)
             for s in range(a, b, 128)]
    assert steps == list(range(0, k, 128))  # every K step in exactly one range
    assert len(_ranges(k, plan.k_per_split)) == plan.splits
    assert plan.tokens == 2 * plan.mt * plan.wm and plan.tokens >= min(m, 32)
    assert plan.blocks == -(-m // plan.tokens) * -(-n // 128) * plan.splits
    assert plan.blocks >= SMS and plan.smem <= SMEM_LIMIT


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wrap (the kernels' int32 adds)."""
    return (((x + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


def _coefs(cfg) -> list:
    return [-(1 << b) if cfg.x_signed and b == cfg.x_bits - 1 else 1 << b
            for b in range(cfg.x_bits)]


def _lut_split(xq, luts, cfg, plan) -> torch.Tensor:
    """The LUT kernel's arithmetic under ``plan``: each group range's
    readout Σ_b coef(b)·Σ_{g in range} LUT[g, addr, n], shift-added in int32,
    and the ranges' partials wrap-added (atomicAdd into a zeroed output)."""
    addr = group_addresses(xq, cfg).long()                  # [M, B, G]
    out = torch.zeros(xq.shape[0], luts.shape[-1], dtype=torch.int64)
    for a, b in _ranges(luts.shape[0], plan.gpb):
        part = torch.zeros_like(out)
        for bit, c in enumerate(_coefs(cfg)):
            rows = luts[torch.arange(a, b), addr[:, bit, a:b]]  # [M, g, N]
            part = part + c * rows.sum(1, dtype=torch.int64)
        out = out + _wrap32(part)
    return _wrap32(out)


def _bitplane_split(xq, wq, cfg, plan) -> torch.Tensor:
    """The bit-plane kernel's arithmetic under ``plan``: each K range's
    plane sums MR_b, shift-added (Σ_b coef(b)·MR_b) in int32, and the
    ranges' partials wrap-added."""
    planes = bit_planes(xq, cfg).long()                     # [B, M, K]
    out = torch.zeros(xq.shape[0], wq.shape[1], dtype=torch.int64)
    for a, b in _ranges(xq.shape[1], plan.k_per_split):
        mr = planes[:, :, a:b] @ wq[a:b].long()              # [B, M, N]
        out = out + _wrap32(sum(c * mr[i] for i, c in enumerate(_coefs(cfg))))
    return _wrap32(out)


def _codes(rng, shape, x_bits, signed):
    lo, hi = (-(1 << (x_bits - 1)), 1 << (x_bits - 1)) if signed else (0, 1 << x_bits)
    return rng.integers(lo, hi, shape).astype(np.int32)


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("x_bits", [4, 8])
@pytest.mark.parametrize("group,k", [
    (4, 37), (4, 64), (8, 100), (8, 256), (16, 40), (16, 45)])
def test_lut_split_arithmetic_matches_plain_and_pallas_interpret(signed, x_bits,
                                                                 group, k):
    """Ragged K (37, 100, 40, 45 are not whole groups) and whole groups; the
    plan of a 132-SM card cuts these small shapes into many group ranges."""
    rng = np.random.default_rng(k + group + x_bits + 2 * signed)
    m, n = 5, 19
    xq = _codes(rng, (m, k), x_bits, signed)
    wq = rng.integers(-128, 128, (k, n)).astype(np.int32)
    cfg = DAConfig(group_size=group, x_bits=x_bits, x_signed=signed)
    luts = build_luts(_t(wq), group)
    plan = lut_plan(m, n, luts.shape[0], SMS)
    assert -(-luts.shape[0] // plan.gpb) > 1  # the sum really is split
    got = _lut_split(_t(xq), luts, cfg, plan)
    np.testing.assert_array_equal(got.numpy(), ops.da_vmm(_t(xq), luts, cfg).numpy())
    ref = da_vmm_pallas(jnp.asarray(xq), jnp.asarray(luts.numpy()),
                        JDA(group_size=group, x_bits=x_bits, x_signed=signed),
                        bm=8, bn=32, bg=4, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("x_bits", [4, 8])
@pytest.mark.parametrize("m,k", [(4, 1100), (40, 700)])
def test_bitplane_split_arithmetic_matches_plain_and_pallas_interpret(signed, x_bits,
                                                                      m, k):
    """K split into ranges of whole 128-steps, a ragged last one; M = 4 takes
    a decode tile, M = 40 the prefill tile."""
    rng = np.random.default_rng(m + k + x_bits + 2 * signed)
    n = 24
    xq = _codes(rng, (m, k), x_bits, signed)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    cfg = DAConfig(x_bits=x_bits, x_signed=signed)
    plan = bitplane_plan(m, k, n, SMS)
    assert plan.splits > 1 and k % plan.k_per_split  # split, ragged last range
    got = _bitplane_split(_t(xq), _t(wq), cfg, plan)
    np.testing.assert_array_equal(got.numpy(),
                                  ops.bitplane_vmm(_t(xq), _t(wq), cfg).numpy())
    ref = bitplane_vmm_pallas(jnp.asarray(xq), jnp.asarray(wq),
                              JDA(x_bits=x_bits, x_signed=signed), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# paged-attention read
# ---------------------------------------------------------------------------


def _paged_case(rng, t, lens, kv_dtype, hd=16, ps=4, n_pages=12, h=4, kv=2):
    """Pool with permuted physical pages, ragged tpos, a pad lane at the
    garbage position, and junk on the garbage page."""
    b = len(lens)
    w = max(-(-n // ps) for n in lens) + 1
    q = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    k = rng.normal(size=(n_pages, ps, kv, hd)).astype(np.float32)
    v = rng.normal(size=(n_pages, ps, kv, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((b, w), np.int32)
    nxt = 0
    for i, n in enumerate(lens):
        need = -(-n // ps)
        table[i, :need] = perm[nxt:nxt + need]
        nxt += need
    tpos = np.stack([np.clip(np.arange(n - t, n), 0, None) for n in lens]
                    ).astype(np.int32)
    tpos[0, 0] = (w - 1) * ps
    scales = [None, None]
    if kv_dtype != "fp":
        k, ks = jkvq.quantize_kv(jnp.asarray(k), kv_dtype)
        v, vs = jkvq.quantize_kv(jnp.asarray(v), kv_dtype)
        k, v, scales = np.asarray(k), np.asarray(v), [np.asarray(ks), np.asarray(vs)]
    return q, k, v, table, tpos, scales


@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("mask_mode", ["where", "additive"])
def test_paged_plain_matches_pallas_interpret(kv_dtype, t, mask_mode):
    rng = np.random.default_rng({"fp": 0, "int8": 1, "int4": 2}[kv_dtype] + 7 * t)
    q, k, v, table, tpos, (ks, vs) = _paged_case(rng, t, [5, 11, 8], kv_dtype)
    jkw = {} if ks is None else {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
    ref = jpaged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
                 jnp.asarray(tpos), mask_mode=mask_mode, interpret=True, **jkw)
    tkw = {} if ks is None else {"k_scale": _t(ks), "v_scale": _t(vs)}
    got = paged_attention(_t(q), _t(k), _t(v), _t(table), _t(tpos),
                          mask_mode=mask_mode, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_kv_quant_codes_bit_exact(kv_dtype):
    x = np.random.default_rng(3).normal(size=(5, 2, 16)).astype(np.float32)
    x[0, 0] = 0.0
    rc, rs = jkvq.quantize_kv(jnp.asarray(x), kv_dtype)
    gc, gs = tkvq.quantize_kv(_t(x), kv_dtype)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        tkvq.dequantize_kv(gc, gs, kv_dtype, torch.float32).numpy(),
        np.asarray(jkvq.dequantize_kv(rc, rs, kv_dtype, jnp.float32)))
    assert tkvq.kv_format(gc, gs, 16) == kv_dtype


def _split_read(q, k, v, table, tpos, chunk, mask_mode, k_scale=None,
                v_scale=None, softmax_dtype="float32"):
    """Plain-torch emulation of the CUDA kernel's cluster order, with the
    positions of each row split into chunks of ``chunk`` pages, one block of
    the row's cluster each: (a) rounded, masked scores (the float64 dot
    rounded through float32 to q's dtype, divided by sqrt(hd) in that
    dtype) and each chunk's max; the row max over the chunk maxima; (b)
    each chunk's float64 sum of exp(x - max); (c) L = the chunk sums added
    in chunk order, rounded to the softmax dtype, probabilities exp(x -
    max) / L rounded to q's dtype, a float64 PV partial per chunk; (d) the
    partials added in chunk order and rounded.  A chunk wholly past the
    row's live end (its largest tpos + 1, or all S if every query is
    masked) contributes max -1e30, sum 0 and a zero partial.  The bfloat16
    score pipeline rounds the scores before the mask, and x - max, exp,
    L and the divide, to bfloat16."""
    dt = q.dtype
    sd = getattr(torch, softmax_dtype)
    b, t, h, hd = q.shape
    _, ps, kv, _ = k.shape
    g, w = h // kv, table.shape[1]
    s_len, cp = w * ps, chunk * ps
    fmt = tkvq.kv_format(k, k_scale, hd)
    kg, vg = k[table.long()], v[table.long()]
    if fmt != "fp":
        kg = tkvq.dequantize_kv(kg, k_scale[table.long()], fmt, dt)
        vg = tkvq.dequantize_kv(vg, v_scale[table.long()], fmt, dt)
    kg = kg.reshape(b, s_len, kv, hd).double()
    vg = vg.reshape(b, s_len, kv, hd).double()
    div = torch.tensor(hd ** 0.5, dtype=dt).item()
    dot = torch.einsum("btkgd,bskd->bkgts", q.double().reshape(b, t, kv, g, hd), kg)
    x = (dot.float().to(dt) / div).to(sd)
    valid = (torch.arange(s_len)[None, None] <= tpos.long()[:, :, None])[:, None, None]
    neg = torch.tensor(-1e30, dtype=sd)
    x = (x + torch.where(valid, torch.zeros((), dtype=sd), neg) if mask_mode == "additive"
         else torch.where(valid, x, neg))
    out = torch.empty(b, kv, g, t, hd, dtype=torch.float64)
    for i in range(b):
        tmax = int(tpos[i].max())
        s_end = min(s_len, tmax + 1) if tmax >= 0 else s_len
        chunks = [(c, max(c, min(c + cp, s_end))) for c in range(0, s_len, cp)]
        m = torch.full(x.shape[1:4], -1e30, dtype=sd)                # (a)
        for c0, c1 in chunks:
            m = torch.maximum(m, x[i, ..., c0:c1].amax(-1) if c1 > c0 else neg)
        e = [torch.exp(x[i, ..., c0:c1] - m[..., None]) for c0, c1 in chunks]   # (b)
        big_l = torch.zeros(m.shape, dtype=torch.float64)            # (c)
        for e_j in e:
            big_l = big_l + e_j.sum(-1, dtype=torch.float64)
        big_l = big_l.to(sd)
        acc = torch.zeros(kv, g, t, hd, dtype=torch.float64)         # (d)
        for (c0, c1), e_j in zip(chunks, e):
            p = (e_j / big_l[..., None]).to(dt)
            acc = acc + torch.einsum("kgts,skd->kgtd", p.double(), vg[i, c0:c1])
        out[i] = acc
    return out.to(dt).permute(0, 3, 1, 2, 4).reshape(b, t, h, hd)


@pytest.mark.parametrize("ns", [1, 3, 7])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mask_mode", ["where", "additive"])
def test_split_arithmetic_matches_plain_and_pallas_interpret(ns, kv_dtype, dtype,
                                                             mask_mode):
    """W = 7 pages split into 1, 3 or 7 chunks.  Row 0 has a pad lane at the
    garbage position (every chunk live), row 2's live end leaves later
    chunks wholly past it, and every query of row 3 is masked (uniform over
    all positions)."""
    rng = np.random.default_rng(ns + {"fp": 0, "int8": 10, "int4": 20}[kv_dtype])
    q, k, v, table, tpos, (ks, vs) = _paged_case(rng, 3, [5, 22, 8, 6], kv_dtype,
                                                 n_pages=16)
    tpos[3] = -1
    w = table.shape[1]
    chunk = -(-w // ns)
    assert w == 7 and -(-w // chunk) == ns
    jkw = {} if ks is None else {"k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
    ref = jpaged(jnp.asarray(q).astype(dtype), jnp.asarray(k).astype(
                     dtype if kv_dtype == "fp" else k.dtype),
                 jnp.asarray(v).astype(dtype if kv_dtype == "fp" else v.dtype),
                 jnp.asarray(table), jnp.asarray(tpos), mask_mode=mask_mode,
                 interpret=True, **jkw)
    tdt = getattr(torch, dtype)
    pools = [_t(x) if kv_dtype != "fp" else _t(x).to(tdt) for x in (k, v)]
    tkw = {} if ks is None else {"k_scale": _t(ks), "v_scale": _t(vs)}
    args = (_t(q).to(tdt), *pools, _t(table), _t(tpos))
    got = _split_read(*args, chunk, mask_mode, **tkw)
    plain = paged_attention(*args, mask_mode=mask_mode, **tkw)
    atol = {"bfloat16": 2.0 ** -7, "float32": 1e-5}[dtype]
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), rtol=0, atol=atol)


@pytest.mark.parametrize("softmax", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1, 3, 7])
@pytest.mark.parametrize("kv_dtype", ["fp", "int8", "int4"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cluster_order_equals_plain_read(chunk, kv_dtype, dtype, softmax):
    """The kernel's cluster order in float64 (per-chunk max to the row max,
    per-chunk exp-sums added in chunk order, per-chunk PV partials added in
    chunk order), emulated in torch, is EQUAL to the plain read: W = 7
    pages in 7, 3 or 1 chunks, both mask forms, a pad lane at the garbage
    position, a row whose live end leaves chunks empty, and a row whose
    every query is masked (uniform over all S)."""
    rng = np.random.default_rng(chunk + {"fp": 0, "int8": 10, "int4": 20}[kv_dtype]
                                + (dtype == "float32") * 40)
    q, k, v, table, tpos, (ks, vs) = _paged_case(rng, 3, [5, 22, 8, 6], kv_dtype,
                                                 n_pages=16)
    tpos[3] = -1
    tdt = getattr(torch, dtype)
    pools = [_t(x) if kv_dtype != "fp" else _t(x).to(tdt) for x in (k, v)]
    tkw = {} if ks is None else {"k_scale": _t(ks), "v_scale": _t(vs)}
    args = (_t(q).to(tdt), *pools, _t(table), _t(tpos))
    for mode in ("where", "additive"):
        got = _split_read(*args, chunk, mode, softmax_dtype=softmax, **tkw)
        plain = paged_attention(*args, mask_mode=mode, softmax_dtype=softmax, **tkw)
        assert torch.equal(got, plain), (mode, (got.float() - plain.float()).abs().max())


@pytest.mark.parametrize("w", [1, 9, 17, 300, 2560])
def test_split_plan_fills_the_card_and_fits_shared_memory(w):
    """qwen3-8b heads (32 over 8 KV heads of 128), page 16, an H100's 132
    SMs: every page in one chunk of whole pages, one cluster of at most 8
    blocks (the portable size) per (KV head, row), more than one chunk once
    the row holds two chunks' worth of positions, and the clusters of 4
    rows within one wave of 1.75 blocks an SM (qwen2-moe's 16 KV heads get
    fewer chunks).  The plan takes the KV heads, the page size, the table
    width and the SM count only: the chunk cannot follow T, B or tpos, so
    a row's sums round the same in a decode, a verify and a prefill call of
    any batch.  At T = 1, 4 and 16, bfloat16 and float32, over fp, int8 and
    int4 pages, a block's shared memory fits the card's 227 KB, the scores
    moving to a scratch slice only where they cannot sit beside the staged
    tiles; W = 2560 (40960 positions) at T = 16 reads in one launch."""
    assert set(inspect.signature(split_plan).parameters) == {"kv", "ps", "w", "sms"}
    for kv in (8, 16):
        plan = split_plan(kv, 16, w, 132)
        assert 1 <= plan.ns <= 8 and plan.ns == -(-w // plan.chunk)
        assert (plan.ns - 1) * plan.chunk < w <= plan.ns * plan.chunk
        assert plan.ns == 1 if w * 16 < 64 else plan.ns >= 2
        assert kv * 4 * plan.ns <= 1.75 * 132
    plan = split_plan(8, 16, w, 132)
    for t in (1, 4, 16):
        for elem, fmt in ((2, "fp"), (4, "fp"), (2, "int8"), (2, "int4")):
            shape = block_shape(t, 32, 8, 128, 16, plan.chunk, elem, fmt)
            assert shape.smem <= 227 * 1024
            here = block_smem(t, 32, 8, 128, 16, plan.chunk, elem, fmt, True)
            assert (shape.scratch == 0) == (here <= 227 * 1024)
            if shape.scratch:  # G*T rows padded to 16, each a chunk's scores
                assert shape.scratch >= 32 // 8 * t * plan.chunk * 16
    if w == 2560:
        assert block_shape(16, 32, 8, 128, 16, plan.chunk, 2, "fp").scratch > 0


def test_build_key_tracks_sources():
    """Libraries are keyed by a hash of source + flags under build/."""
    for name in build.SOURCES:
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").exists()
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
