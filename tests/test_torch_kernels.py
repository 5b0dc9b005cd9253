"""PyTorch port kernels vs the JAX reference's Pallas kernels.

On the CPU each wrapper runs its plain version (only because its tensors lie
on the CPU); those are held against the Pallas kernels run in interpret mode:
the bit-plane and LUT-readout VMMs bit-exactly, the paged-attention read in
float32 to
atol 1e-5 / rtol 1e-5 (both compute the same roundings; only float32
summation order differs), over fp, int8 and int4 pools.

The kernels themselves are tested on the card by ``tests/test_torch_gpu.py``.
"""
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
from repro_torch.core.da import DAConfig, build_luts
from repro_torch.kernels import build, ops
from repro_torch.kernels.paged_attention import paged_attention, smem_plan
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


def test_smem_plan_spills_long_tables_to_scratch():
    nbytes, in_smem = smem_plan(t=16, h=32, kv=8, hd=128, ps=16, w=17)
    assert in_smem and nbytes <= 227 * 1024
    nbytes, in_smem = smem_plan(t=16, h=32, kv=8, hd=128, ps=16, w=300)
    assert not in_smem and nbytes == 4 * (64 * 128 + 8 * 8 * 128 + 16 + 300)


def test_build_key_tracks_sources():
    """Libraries are keyed by a hash of source + flags under build/."""
    for name in build.SOURCES:
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert (build.CSRC / f"{name}.cu").exists()
    assert build.BUILD_DIR.parts[-2:] == ("build", "repro_torch")
