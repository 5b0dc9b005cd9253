"""PyTorch port vs the JAX reference: DA core, quantization and the engine.

Inputs come from a seeded numpy generator and go to both packages.  Integer
codes and int32 accumulators must be bit-exact.  Float outputs of the DA
linear agree to 1e-6 relative: the codes are identical and dequantization
multiplies in the same order, so only float32 op scheduling can differ."""
import ast
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import da as jda
from repro.core import engine as jeng
from repro.core import quant as jquant
from repro_torch.core import da as tda
from repro_torch.core import engine as teng
from repro_torch.core import quant as tquant

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, None])
def test_quantize_weights_bit_exact(dtype, axis):
    w = np.random.default_rng(0).normal(size=(37, 11)).astype(np.float32) * 0.3
    ref = jquant.quantize_weights(jnp.asarray(w, dtype=dtype), axis=axis)
    got = tquant.quantize_weights(_t(w).to(getattr(torch, dtype)), axis=axis)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.q.dtype == torch.int32 and got.scale.dtype == torch.float32


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_acts_signed_bit_exact(bits):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 29)).astype(np.float32)
    x[0] = 0.0                       # an all-zero row hits the eps floor
    x[1, :4] = [0.5, -0.5, 1.5, 2.5]  # round-half-even lanes
    ref = jquant.quantize_acts_signed(jnp.asarray(x), bits=bits)
    got = tquant.quantize_acts_signed(_t(x), bits=bits)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))


def test_quantize_acts_unsigned_bit_exact():
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 255, size=(4, 25)).astype(np.float32)
    x[0] = 0.0                        # an all-zero row hits the eps floor
    x[1, :3] = [127.5, 0.5, 254.5]    # round-half-even lanes
    ref = jquant.quantize_acts_unsigned(jnp.asarray(x))
    got = tquant.quantize_acts_unsigned(_t(x))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert not got.signed and got.q.dtype == torch.int32


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("x_bits", [2, 4, 8])
@pytest.mark.parametrize("group", [4, 8])
@pytest.mark.parametrize("k", [16, 37])
def test_lut_forms_bit_exact(signed, x_bits, group, k):
    """build_luts, group_addresses, da_vmm_lut and da_vmm_onehot against the
    reference, K ragged against the group size."""
    rng = np.random.default_rng(100 * k + 10 * x_bits + group)
    lo, hi = (-(1 << (x_bits - 1)), 1 << (x_bits - 1)) if signed else (0, 1 << x_bits)
    xq = rng.integers(lo, hi, (5, k)).astype(np.int32)
    wq = rng.integers(-128, 128, (k, 11)).astype(np.int32)
    jcfg = jda.DAConfig(group_size=group, x_bits=x_bits, x_signed=signed)
    tcfg = tda.DAConfig(group_size=group, x_bits=x_bits, x_signed=signed)
    jl = jda.build_luts(jnp.asarray(wq), group)
    tl = tda.build_luts(_t(wq), group)
    assert tl.dtype == torch.int32 and tuple(tl.shape) == (
        tda.num_groups(k, group), tcfg.lut_rows, 11)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(
        tda.group_addresses(_t(xq), tcfg).numpy(),
        np.asarray(jda.group_addresses(jnp.asarray(xq), jcfg)))
    for fn in ("da_vmm_lut", "da_vmm_onehot"):
        got = getattr(tda, fn)(_t(xq), tl, tcfg)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(getattr(jda, fn)(jnp.asarray(xq), jl, jcfg)))
        np.testing.assert_array_equal(got.numpy(), xq.astype(np.int64) @ wq)


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("eff", [1, 3, 8])
def test_truncate_codes_bit_exact(signed, eff):
    cfg_j = jda.DAConfig(x_bits=8, x_signed=signed)
    cfg_t = tda.DAConfig(x_bits=8, x_signed=signed)
    lo, hi = (-128, 128) if signed else (0, 256)
    xq = np.random.default_rng(2).integers(lo, hi, (4, 33)).astype(np.int32)
    rq, rcfg, rd = jda.truncate_codes(jnp.asarray(xq), cfg_j, eff)
    gq, gcfg, gd = tda.truncate_codes(_t(xq), cfg_t, eff)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(rq))
    assert (gd, gcfg.x_bits) == (rd, rcfg.x_bits)


def test_bit_coefs_and_groups_match():
    for k in (1, 8, 37):
        assert tda.num_groups(k, 8) == jda.num_groups(k, 8)
    for bits in (4, 8):
        for signed in (True, False):
            np.testing.assert_array_equal(tda.bit_coefs(bits, signed),
                                          jda.bit_coefs(bits, signed))


@pytest.mark.parametrize("fn", ["da_vmm_bitplane", "da_vmm_bitplane_stacked"])
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("x_bits", [4, 8])
@pytest.mark.parametrize("k", [16, 37])
def test_bitplane_forms_bit_exact(fn, signed, x_bits, k):
    rng = np.random.default_rng(k + x_bits)
    lo, hi = (-(1 << (x_bits - 1)), 1 << (x_bits - 1)) if signed else (0, 1 << x_bits)
    xq = rng.integers(lo, hi, (3, k)).astype(np.int32)
    wq = rng.integers(-128, 128, (k, 9)).astype(np.int8)
    ref = getattr(jda, fn)(jnp.asarray(xq), jnp.asarray(wq),
                           jda.DAConfig(x_bits=x_bits, x_signed=signed))
    got = getattr(tda, fn)(_t(xq), _t(wq), tda.DAConfig(x_bits=x_bits,
                                                         x_signed=signed))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), xq.astype(np.int64) @ wq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_weights_codes_bit_exact(dtype):
    w = np.random.default_rng(3).normal(size=(40, 24)).astype(np.float32) / 6
    ref = jeng.pack_weights(jnp.asarray(w, dtype=dtype), mode="bitplane")
    got = teng.pack_weights(_t(w).to(getattr(torch, dtype)), mode="bitplane")
    np.testing.assert_array_equal(got.wq.numpy(), np.asarray(ref.wq))
    np.testing.assert_array_equal(got.w_scale.numpy(), np.asarray(ref.w_scale))
    assert got.wq.dtype == torch.int8 and got.luts is None
    # a LUT mode builds the tables once, at pack time, as the reference does
    for mode in ("lut", "auto"):
        ref = jeng.pack_weights(jnp.asarray(w, dtype=dtype), mode=mode)
        got = teng.pack_weights(_t(w).to(getattr(torch, dtype)), mode=mode)
        assert got.has_luts and ref.luts is not None
        np.testing.assert_array_equal(got.luts.numpy(), np.asarray(ref.luts))
    assert teng.lut_cells(40, 24, 8) == jeng.lut_cells(40, 24, 8)
    assert teng.DEFAULT_LUT_LIMIT == jeng.DEFAULT_LUT_LIMIT
    # "auto" skips the tables past the budget, as the reference does
    big = np.ones((2056, 256), dtype=np.float32)
    assert teng.lut_cells(2056, 256, 8) > teng.DEFAULT_LUT_LIMIT
    assert not teng.pack_weights(_t(big), mode="auto").has_luts
    assert jeng.pack_weights(jnp.asarray(big), mode="auto").luts is None


@pytest.mark.parametrize("mode", ["bitplane", "bitplane_stacked",
                                  "pallas_bitplane", "auto", "lut", "onehot",
                                  "pallas_lut"])
def test_da_matmul_matches_reference(mode):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(37, 20)).astype(np.float32) / 6
    x = rng.normal(size=(2, 3, 37)).astype(np.float32)
    jp = jeng.pack_weights(jnp.asarray(w), mode="lut")
    tp = teng.pack_weights(_t(w), mode="lut")
    ref = jeng.da_matmul(jnp.asarray(x), jp, mode="bitplane")
    got = teng.da_matmul(_t(x), tp, mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    # integer level: the accumulator is exactly xq @ wq
    xq = rng.integers(-128, 128, (4, 37)).astype(np.int32)
    np.testing.assert_array_equal(
        teng.da_vmm(_t(xq), tp, mode=mode).numpy(),
        np.asarray(jeng.da_vmm(jnp.asarray(xq), jp, mode="bitplane")))


def test_da_qkv_matmul_matches_reference_and_separate_calls():
    """The fused pass equals JAX's fused pass and three separate calls, for
    separate code buffers and for freeze's shared q|k|v buffer."""
    from repro_torch.core.freeze import freeze_model_da

    rng = np.random.default_rng(5)
    ws = [rng.normal(size=(32, n)).astype(np.float32) / 6 for n in (16, 8, 8)]
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    jps = [jeng.pack_weights(jnp.asarray(w), mode="pallas_bitplane") for w in ws]
    ref = jeng.da_qkv_matmul(jnp.asarray(x), jps)
    separate = [teng.pack_weights(_t(w), mode="pallas_bitplane") for w in ws]
    shared = freeze_model_da({"wq": _t(ws[0]), "wk": _t(ws[1]), "wv": _t(ws[2])},
                             mode="pallas_bitplane", device="cpu")
    lut = freeze_model_da({"wq": _t(ws[0]), "wk": _t(ws[1]), "wv": _t(ws[2])},
                          mode="pallas_lut", device="cpu")
    lut = [lut[n] for n in ("wq", "wk", "wv")]
    # the LUT freeze co-locates the codes and gives each pack its own tables
    assert lut[1].wq.untyped_storage().data_ptr() == \
        lut[0].wq.untyped_storage().data_ptr()
    assert [tuple(p.luts.shape) for p in lut] == [(4, 256, n) for n in (16, 8, 8)]
    shared = [shared[n] for n in ("wq", "wk", "wv")]
    assert shared[1].wq.untyped_storage().data_ptr() == \
        shared[0].wq.untyped_storage().data_ptr()
    merged = teng._merged_codes(shared)
    assert merged.untyped_storage().data_ptr() == \
        shared[0].wq.untyped_storage().data_ptr()  # a view, not a copy
    for packs in (separate, shared, lut):
        got = teng.da_qkv_matmul(_t(x), packs)
        for g, r, p in zip(got, ref, packs):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_array_equal(g.numpy(),
                                          teng.da_matmul(_t(x), p).numpy())


def test_registry_names_resolve_and_auto_by_device():
    assert {"bitplane", "bitplane_stacked", "pallas_bitplane"} <= set(
        teng.registered_backends())
    cpu = torch.device("cpu")
    # "auto" is the reference's shape policy, on any device: without timings
    # the PMAs at decode-like M <= 8 when LUTs exist, else stacked planes
    cfg = tda.DAConfig(x_signed=True)
    teng.set_cost_table({})
    jeng.set_cost_table({})
    try:
        for m, luts, want in ((4, True, "lut"), (16, True, "bitplane_stacked"),
                              (4, False, "bitplane_stacked")):
            assert teng.select_backend(m, 64, 128, cfg, luts) == want
            assert jeng.select_backend(m, 64, 128, jda.DAConfig(x_signed=True),
                                       luts) == want
    finally:
        teng.set_cost_table(None)
        jeng.set_cost_table(None)
    assert teng.get_backend("stacked").name == "bitplane_stacked"
    assert teng.select_attn_backend("auto", cpu) == "gather"
    assert teng.select_attn_backend(None, torch.device("cuda")) == "fused"
    for name in ("lut", "onehot", "pallas_lut"):
        spec = teng.get_backend(name)
        ref = jeng.get_backend(name)
        assert spec.needs_luts and ref.needs_luts
    assert teng.get_backend("pallas").name == "pallas_lut"
    # a LUT mode on a pack without LUTs is a capability error, not garbage
    bare = teng.pack_weights(torch.ones(16, 4), mode="bitplane")
    with pytest.raises(ValueError, match="LUTs"):
        teng.da_matmul(torch.ones(2, 16), bare, mode="pallas_lut")
    packed = teng.pack_weights(torch.ones(16, 4), mode="lut")
    with pytest.raises(ValueError, match="rows per PMA"):
        teng.da_vmm(torch.ones(2, 16, dtype=torch.int32), packed,
                    cfg=tda.DAConfig(group_size=4))
    # the int8 baseline is registered with the reference's capabilities
    int8, ref8 = teng.get_backend("int8"), jeng.get_backend("int8")
    assert (int8.is_da, int8.signed_only) == (ref8.is_da, ref8.signed_only) \
        == (False, True)
    with pytest.raises(ValueError, match="unknown DA mode"):
        teng.get_backend("nope")


def test_dense_casts_back_and_float_path():
    rng = np.random.default_rng(6)
    w = _t(rng.normal(size=(16, 8)).astype(np.float32))
    x = _t(rng.normal(size=(2, 16)).astype(np.float32)).to(torch.bfloat16)
    p = teng.pack_weights(w, mode="pallas_bitplane")
    assert teng.dense(x, p).dtype == torch.bfloat16
    xf = x.float()
    np.testing.assert_allclose(teng.dense(xf, w).numpy(), (xf @ w).numpy())


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {mod}"
        text = f.read_text()
        assert "import jax" not in text and "from repro." not in text, f


def test_da_config_fields_match():
    assert [f.name for f in dataclasses.fields(tda.DAConfig)] == \
        [f.name for f in dataclasses.fields(jda.DAConfig)]
