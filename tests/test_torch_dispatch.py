"""PyTorch port vs the JAX reference: the engine's shape-aware ``"auto"``
dispatch, its cost table and the ``int8`` baseline.

Mirrors ``tests/test_engine_dispatch.py`` test for test, each case run
through both packages on the same numpy-seeded inputs and the same cost
table (installed in both with ``set_cost_table``): bucket keys, picks,
warnings and capability errors must agree.  The port's table files carry
its own stamp (``device_stamp()``, ``"torch:cpu"`` here), so a table the
reference wrote (stamped ``"cpu"``) is rejected by the port.  Integer
results are compared exactly.
"""
import dataclasses
import json
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.da import DAConfig as JDA
from repro_torch.core import engine as teng
from repro_torch.core.da import DAConfig

BUCKET_SHAPES = teng.BUCKET_SHAPES


@pytest.fixture(autouse=True)
def _isolate_cost_tables():
    """Each test installs its own tables; restore lazy state in both."""
    yield
    teng.set_cost_table(None)
    jeng.set_cost_table(None)


def _install(table):
    teng.set_cost_table(table)
    jeng.set_cost_table(table)


def _select(m, k, n, has_luts, x_bits=8):
    """(port pick, reference pick) for one shape."""
    return (teng.select_backend(m, k, n, DAConfig(x_bits=x_bits, x_signed=True),
                                has_luts),
            jeng.select_backend(m, k, n, JDA(x_bits=x_bits, x_signed=True),
                                has_luts))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_bucketing_is_total_and_stable():
    """shape_bucket equals the reference's over (M, K, N) space, and its 9
    cells are the representative shapes'."""
    assert BUCKET_SHAPES == jeng.BUCKET_SHAPES
    seen = set()
    for m in (1, 8, 9, 256, 257, 4096):
        for k, n in ((8, 8), (128, 128), (512, 512), (4096, 4096)):
            for bits in (8, 4):
                b = teng.shape_bucket(m, k, n, bits)
                assert b == jeng.shape_bucket(m, k, n, bits)
                seen.add(b)
    assert len(seen) == 18
    assert {teng.shape_bucket(m, k, n, 8) for m, k, n in BUCKET_SHAPES.values()} \
        == {b for b in seen if b.endswith(":b8")}


@pytest.mark.parametrize("has_luts", [True, False])
@pytest.mark.parametrize("cell", sorted(BUCKET_SHAPES))
def test_auto_returns_registered_backend_for_every_bucket(cell, has_luts):
    """No table: the heuristic picks the reference's backend for every
    bucket, a registered, eligible DA one."""
    _install({})
    m, k, n = BUCKET_SHAPES[cell]
    ours, ref = _select(m, k, n, has_luts)
    assert ours == ref
    spec = teng.registered_backends()[ours]
    assert spec.is_da and spec.supports(DAConfig(x_signed=True), has_luts)


@pytest.mark.parametrize("table", ["measured", "partial"])
@pytest.mark.parametrize("has_luts", [True, False])
def test_auto_follows_measured_costs(table, has_luts):
    """A measured table (every bucket, ranks rotated through the backends)
    or a partial one (every other bucket): both packages pick the same
    backend at every representative shape, never the int8 baseline."""
    names = sorted(teng.registered_backends())
    costs = {}
    for i, cell in enumerate(sorted(BUCKET_SHAPES)):
        if table == "partial" and i % 2:
            continue
        costs[teng.shape_bucket(*BUCKET_SHAPES[cell], 8)] = {
            b: float((j + i) % len(names)) + (0.5 if b == "int8" else 1.0)
            for j, b in enumerate(names)}
    _install(costs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the partial table's bucket misses
        for m, k, n in BUCKET_SHAPES.values():
            ours, ref = _select(m, k, n, has_luts)
            assert ours == ref and ours != "int8"
    cfg = DAConfig(x_signed=True)
    bucket = teng.shape_bucket(4, 64, 128, 8)
    _install({bucket: {"onehot": 1.0, "bitplane": 5.0, "int8": 0.1}})
    assert teng.select_backend(4, 64, 128, cfg, has_luts=True) == "onehot"
    assert teng.select_backend(4, 64, 128, cfg, has_luts=False) == "bitplane"


def test_auto_fallback_when_bucket_unmeasured():
    """A table that lacks the bucket behaves exactly like no table."""
    other = teng.shape_bucket(512, 2048, 2048, 8)
    _install({other: {"bitplane": 1.0}})
    with pytest.warns(UserWarning, match="no timings"):
        with_table = teng.select_backend(4, 64, 128, DAConfig(x_signed=True), True)
    _install({})
    assert with_table == _select(4, 64, 128, True)[0] == _select(4, 64, 128, True)[1]


def test_bucket_miss_warns_once_per_bucket_and_backend():
    """A table that misses the dispatched bucket warns once per (bucket,
    fallback backend); a new table resets that; no table stays silent."""
    cfg = DAConfig(x_signed=True)
    other = teng.shape_bucket(512, 2048, 2048, cfg.x_bits)
    teng.set_cost_table({other: {"bitplane": 1.0}})
    with pytest.warns(UserWarning, match="no timings"):
        first = teng.select_backend(4, 64, 128, cfg, has_luts=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert teng.select_backend(4, 64, 128, cfg, has_luts=True) == first
        with pytest.warns(UserWarning, match="no timings"):
            teng.select_backend(300, 64, 128, cfg, has_luts=True)
    assert len(teng._BUCKET_MISS_WARNED) == 2
    teng.set_cost_table({other: {"bitplane": 1.0}})
    assert not teng._BUCKET_MISS_WARNED
    with pytest.warns(UserWarning, match="no timings"):
        teng.select_backend(4, 64, 128, cfg, has_luts=True)
    teng.set_cost_table({})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        teng.select_backend(4, 64, 128, cfg, has_luts=True)
    jeng.set_cost_table({other: {"bitplane": 1.0}})
    with pytest.warns(UserWarning, match="no timings"):
        assert jeng.select_backend(4, 64, 128, JDA(x_signed=True), True) == first


def test_cost_table_loads_from_json(tmp_path):
    """A port-stamped table round-trips through the loader; junk entries
    are dropped, not fatal, exactly as the reference drops them."""
    bucket = teng.shape_bucket(4, 64, 128, 8)
    entries = {bucket: {"lut": 2.0, "bitplane_stacked": 9.0,
                        "not_a_backend": 1e-9, "bitplane": "junk"}}
    ours, ref = tmp_path / "torch.json", tmp_path / "jax.json"
    ours.write_text(json.dumps({"version": 1, "device": teng.device_stamp(),
                                "table": entries}))
    ref.write_text(json.dumps({"version": 1, "device": "cpu", "table": entries}))
    with pytest.warns(UserWarning, match="unregistered"):
        table = teng.load_cost_table(ours)
    with pytest.warns(UserWarning, match="unregistered"):
        assert table == jeng.load_cost_table(ref) == {
            bucket: {"lut": 2.0, "bitplane_stacked": 9.0}}
    teng.set_cost_table(table)
    assert teng.select_backend(4, 64, 128, DAConfig(x_signed=True), True) == "lut"


def test_cost_table_absent_or_corrupt_is_safe(tmp_path):
    """Missing and corrupt tables degrade to {}; dispatch still works."""
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for load in (teng.load_cost_table, jeng.load_cost_table):
        assert load(tmp_path / "nope.json") == {}
        assert load(bad) == {}
    _install({})
    assert _select(1, 16, 16, True)[0] == _select(1, 16, 16, True)[1] == "lut"


def test_unknown_mode_rejected_with_clear_error():
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, (16, 8)).astype(np.int32)
    packed = teng.pack_quantized(w, cfg=DAConfig(x_signed=True))
    x = _t(rng.normal(size=(2, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="unknown DA mode 'warp'"):
        teng.da_matmul(x, packed, mode="warp")
    with pytest.raises(ValueError, match="registered backends"):
        teng.get_backend("warp9")


def test_legacy_mode_aliases_canonicalize():
    assert teng.MODE_ALIASES == jeng.MODE_ALIASES
    for alias in jeng.MODE_ALIASES:
        assert teng.get_backend(alias).name == jeng.get_backend(alias).name


def test_auto_dispatch_end_to_end_matches_explicit():
    """mode='auto' gives the reference's floats and every explicit
    backend's integers, whatever it picks."""
    _install({})
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 32)).astype(np.float32)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    packed = teng.pack_weights(_t(w))  # mode defaults to "auto"
    y_auto = packed(_t(x)).numpy()
    np.testing.assert_array_equal(
        y_auto, teng.da_matmul(_t(x), packed, mode="bitplane").numpy())
    ref = jeng.pack_weights(jnp.asarray(w))
    np.testing.assert_allclose(y_auto, np.asarray(ref(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_packed_auto_respects_lut_cell_limit():
    """pack_weights(mode='auto') builds LUTs only within the budget, and
    dispatch adapts, as in the reference."""
    rng = np.random.default_rng(9)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    small, tight = teng.pack_weights(_t(w)), teng.pack_weights(_t(w), lut_cell_limit=100)
    assert small.has_luts and not tight.has_luts
    assert jeng.pack_weights(jnp.asarray(w), lut_cell_limit=100).luts is None
    torch.testing.assert_close(
        small.luts, _t(np.asarray(jeng.pack_weights(jnp.asarray(w)).luts)),
        rtol=0, atol=0)
    _install({})
    assert _select(4, 64, 32, small.has_luts) == ("lut", "lut")
    chosen = _select(4, 64, 32, tight.has_luts)
    assert chosen[0] == chosen[1]
    assert not teng.registered_backends()[chosen[0]].needs_luts


def test_engine_default_cache_path_env(monkeypatch, tmp_path):
    """The port's table lives under artifacts/torch/, never at the
    reference's path, and has its own environment variable."""
    monkeypatch.delenv(teng.AUTOTUNE_ENV, raising=False)
    monkeypatch.delenv("REPRO_ENGINE_AUTOTUNE", raising=False)
    default = teng.default_cache_path()
    assert default.parts[-3:] == ("artifacts", "torch", "engine_autotune.json")
    assert default != jeng.default_cache_path()
    p = tmp_path / "alt.json"
    monkeypatch.setenv(teng.AUTOTUNE_ENV, str(p))
    assert teng.default_cache_path() == p
    monkeypatch.setenv("REPRO_ENGINE_AUTOTUNE", str(tmp_path / "jax.json"))
    assert teng.default_cache_path() == p


def test_explicit_path_load_is_read_only(tmp_path):
    """load_cost_table(path) inspects without redirecting auto dispatch."""
    installed = {"some:bucket:b8": {"bitplane": 1.0}}
    teng.set_cost_table(installed)
    p = tmp_path / "other.json"
    p.write_text(json.dumps({"device": teng.device_stamp(), "table": {}}))
    assert teng.load_cost_table(p) == {}
    assert teng.load_cost_table() == installed


def test_cost_table_registry_fingerprint_mismatch_warns(tmp_path):
    """The registry stamp equals the reference's; a table stamped against
    another registry is ignored with a warning, a matching one loads."""
    assert teng.registry_fingerprint() == jeng.registry_fingerprint()
    assert sorted(teng.registered_backends()) == sorted(jeng.registered_backends())
    bucket = teng.shape_bucket(4, 64, 128, 8)
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"version": 1, "device": teng.device_stamp(),
                                 "registry": "00000000",
                                 "table": {bucket: {"lut": 1.0}}}))
    with pytest.warns(UserWarning, match="different backend registry"):
        assert teng.load_cost_table(stale) == {}
    fresh = tmp_path / "fresh.json"
    fresh.write_text(json.dumps({"version": 1, "device": teng.device_stamp(),
                                 "registry": teng.registry_fingerprint(),
                                 "table": {bucket: {"lut": 1.0}}}))
    assert teng.load_cost_table(fresh) == {bucket: {"lut": 1.0}}


def test_cost_table_unknown_backend_names_warn(tmp_path):
    bucket = teng.shape_bucket(4, 64, 128, 8)
    p = tmp_path / "renamed.json"
    p.write_text(json.dumps({"version": 1, "device": teng.device_stamp(),
                             "table": {bucket: {"warp_drive": 0.1, "lut": 2.0}}}))
    with pytest.warns(UserWarning, match="unregistered backends"):
        table = teng.load_cost_table(p)
    assert table[bucket] == {"lut": 2.0}
    teng.set_cost_table(table)
    assert teng.select_backend(4, 64, 128, DAConfig(x_signed=True), True) == "lut"


def test_cost_table_rejects_other_device(tmp_path):
    """A table timed elsewhere must not steer dispatch: the reference's
    stamp ("cpu"), a card's stamp on a host without it, and the committed
    reference table itself all load as {} in the port."""
    assert teng.device_stamp("cpu") == "torch:cpu"
    bucket = teng.shape_bucket(4, 64, 128, 8)
    for stamp in ("cpu", "tpu", "torch:cuda:Some Other Card"):
        if stamp == teng.device_stamp():
            continue
        p = tmp_path / "elsewhere.json"
        p.write_text(json.dumps({"version": 1, "device": stamp,
                                 "table": {bucket: {"pallas_lut": 0.1}}}))
        assert teng.load_cost_table(p) == {}
    committed = pathlib.Path(jeng.__file__).resolve().parents[3] / "artifacts" / \
        "engine_autotune.json"
    assert json.loads(committed.read_text())["device"] == "cpu"
    assert teng.load_cost_table(committed) == {}


def test_explicit_mode_enforces_capabilities():
    """int8 on unsigned codes, a LUT mode without LUTs: capability errors,
    as in the reference (int8 would wrap unsigned codes >= 128)."""
    rng = np.random.default_rng(2)
    w = rng.integers(-128, 128, (16, 8)).astype(np.int32)
    ucfg = DAConfig(x_signed=False)
    packed = teng.pack_quantized(w, cfg=ucfg)
    x = rng.integers(0, 256, (2, 16)).astype(np.int32)
    with pytest.raises(ValueError, match="signed"):
        teng.da_vmm(_t(x), packed, mode="int8", cfg=ucfg)
    with pytest.raises(ValueError, match="signed"):
        jeng.da_vmm(jnp.asarray(x), jeng.pack_quantized(w, cfg=JDA()),
                    mode="int8", cfg=JDA())
    bare = teng.pack_quantized(w, cfg=DAConfig(x_signed=True), with_luts=False)
    with pytest.raises(ValueError, match="LUTs"):
        teng.da_vmm(_t(x), bare, mode="onehot")


def test_group_size_cap_matches_reference():
    """One cap, 16 rows per group, for every backend: above it no backend
    is eligible in either package, an explicit mode names the cap and
    ``auto`` finds no DA backend."""
    from repro_torch.core.da import MAX_GROUP_SIZE

    for gs, ok in ((MAX_GROUP_SIZE, True), (MAX_GROUP_SIZE + 1, False)):
        ours = {n: s.supports(DAConfig(group_size=gs, x_signed=True), True)
                for n, s in teng.registered_backends().items()}
        ref = {n: s.supports(JDA(group_size=gs, x_signed=True), True)
               for n, s in jeng.registered_backends().items()}
        assert ours == ref == dict.fromkeys(ref, ok)
    big = DAConfig(group_size=MAX_GROUP_SIZE + 1, x_signed=True)
    with pytest.raises(ValueError, match="group_size ≤ 16, got 17"):
        teng._resolve_spec("bitplane", 4, 64, 8, big, False, "auto")
    with pytest.raises(ValueError, match="group_size ≤ 16, got 17"):
        jeng._resolve_spec("bitplane", 4, 64, 8, JDA(group_size=17, x_signed=True),
                           False, "auto")
    with pytest.raises(ValueError, match="no DA backend"):
        teng.select_backend(4, 64, 8, big, False)


def test_explicit_auto_overrides_packed_mode():
    """mode='auto' runs shape dispatch even on an artifact packed with a
    concrete mode; mode=None defers to the artifact."""
    cfg = DAConfig(x_signed=True)
    _install({teng.shape_bucket(3, 32, 16, 8): {"bitplane_stacked": 1.0,
                                                "lut": 50.0}})
    auto = teng._resolve_spec("auto", 3, 32, 16, cfg, True, default_mode="lut")
    assert auto.name == "bitplane_stacked"
    assert teng._resolve_spec(None, 3, 32, 16, cfg, True,
                              default_mode="lut").name == "lut"
    rng = np.random.default_rng(6)
    w = _t(rng.normal(size=(32, 16)).astype(np.float32))
    packed = teng.pack_weights(w, mode="lut")
    x = _t(rng.normal(size=(3, 32)).astype(np.float32))
    np.testing.assert_array_equal(teng.da_matmul(x, packed, mode="auto").numpy(),
                                  teng.da_matmul(x, packed).numpy())


def test_dispatch_sees_the_draft_bits():
    """Under x_bits_eff the bucket is the draft's (``b4``), in da_vmm,
    da_matmul and da_qkv_matmul alike, as the reference's rcfg."""
    rng = np.random.default_rng(8)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    packed = teng.pack_weights(_t(w))
    _install({teng.shape_bucket(3, 32, 16, 4): {"onehot": 1.0, "lut": 9.0},
              teng.shape_bucket(3, 32, 16, 8): {"bitplane": 1.0}})
    seen = []
    real = {n: s for n, s in teng._REGISTRY.items()}
    try:
        for name in ("onehot", "bitplane"):
            spec = real[name]
            teng._REGISTRY[name] = dataclasses.replace(
                spec, fn=lambda xq, p, c, _f=spec.fn, _n=name: (
                    seen.append((_n, c.x_bits)) or _f(xq, p, c)))
        x = _t(rng.normal(size=(3, 32)).astype(np.float32))
        xq = _t(rng.integers(-128, 128, (3, 32)).astype(np.int32))
        teng.da_matmul(x, packed, x_bits_eff=4)
        teng.da_vmm(xq, packed, x_bits_eff=4)
        teng.da_qkv_matmul(x, [packed, packed], x_bits_eff=4)
        with teng.x_bits_override(4):
            teng.da_matmul(x, packed)
        teng.da_matmul(x, packed)
    finally:
        teng._REGISTRY.update(real)
    assert seen == [("onehot", 4)] * 5 + [("bitplane", 8)]
    assert jeng.select_backend(3, 32, 16, JDA(x_bits=4, x_signed=True), True) \
        == "onehot"


def test_timeable_backends_match_reference_off_the_accelerator():
    """Off CUDA the port skips its pallas_* names (their plain versions),
    as the reference skips its interpret-mode kernels off the TPU; on CUDA
    it times one name per kernel: ``lut`` (the LUT-readout kernel) when
    LUTs exist and ``bitplane_stacked`` (the bit-plane kernel), plus the
    baseline when asked."""
    for has_luts in (True, False):
        for base in (False, True):
            cfg = DAConfig(x_signed=True)
            ours = [s.name for s in teng.timeable_backends(cfg, has_luts, base,
                                                           device="cpu")]
            ref = [s.name for s in jeng.timeable_backends(JDA(x_signed=True),
                                                          has_luts, base)]
            assert ours == ref
            cuda = [s.name for s in teng.timeable_backends(cfg, has_luts, base,
                                                           device="cuda")]
            assert cuda == sorted(["bitplane_stacked"] + ["lut"] * has_luts
                                  + ["int8"] * base)


@pytest.mark.parametrize("m,k,n", [(1, 16, 8), (4, 37, 20), (16, 64, 24),
                                   (17, 40, 9), (64, 300, 70), (3, 8, 5)])
def test_int8_backend_is_bit_exact_to_reference(m, k, n):
    """xq.int8 @ wq.int8 → int32, exact, through da_vmm and da_matmul at
    M <= 16 and K, N not multiples of 8; the backend's capabilities are the
    reference's."""
    rng = np.random.default_rng(m * 1000 + k)
    w = rng.normal(size=(k, n)).astype(np.float32)
    xq = rng.integers(-128, 128, (m, k)).astype(np.int32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    tp = teng.pack_weights(_t(w), mode="int8")
    jp = jeng.pack_weights(jnp.asarray(w), mode="int8")
    assert not tp.has_luts and jp.luts is None
    np.testing.assert_array_equal(teng.da_vmm(_t(xq), tp).numpy(),
                                  np.asarray(jeng.da_vmm(jnp.asarray(xq), jp)))
    np.testing.assert_array_equal(
        teng.da_vmm(_t(xq), tp).numpy(),
        xq.astype(np.int64) @ tp.wq.numpy().astype(np.int64))
    np.testing.assert_allclose(teng.da_matmul(_t(x), tp).numpy(),
                               np.asarray(jeng.da_matmul(jnp.asarray(x), jp)),
                               rtol=1e-6, atol=1e-7)
    spec, ref = teng.get_backend("int8"), jeng.get_backend("int8")
    for f in ("needs_luts", "is_da", "signed_only"):
        assert getattr(spec, f) == getattr(ref, f), f
