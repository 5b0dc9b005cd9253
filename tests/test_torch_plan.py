"""PyTorch port vs the JAX reference: the per-layer planner and the planned
freeze.

Mirrors the planner and freeze tests of ``tests/test_freeze_artifact.py``
and holds the port's plans to the reference's field for field
(``est_cost`` exactly) on the CI smoke's model (``examples/serve_da.py::
build_cfg``, qwen3-20m) and ``reduce_for_smoke(qwen3-8b)``, under an empty
cost table (analytic), the reference's committed table installed in both
packages, and two group-size candidates.  Planned freezes give bit-exact
codes, scales and LUTs; planned artifacts boot across packages with the
same plan; ``ServeEngine(da_mode="auto")`` decodes the reference's greedy
tokens.  Weights come from the reference's ``init_model`` (seeded) and are
carried over by ``params_from_jax``.
"""
import dataclasses
import importlib
import json
import pathlib
import sys
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core import engine as jeng
from repro.core import freeze as jfreeze
from repro.core.da import DAConfig as JDA
from repro.models.model import init_model as jinit
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import engine as teng
from repro_torch.core import freeze as tfreeze
from repro_torch.core.da import DAConfig
from repro_torch.core.engine import PackedWeights
from repro_torch.serve.engine import Request, ServeEngine

COMMITTED = pathlib.Path(jeng.__file__).resolve().parents[3] / "artifacts" / \
    "engine_autotune.json"


@pytest.fixture(autouse=True)
def _isolate_cost_tables():
    yield
    teng.set_cost_table(None)
    jeng.set_cost_table(None)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Six xdist workers would otherwise oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _install(table):
    teng.set_cost_table(table)
    jeng.set_cost_table(table)


def _json(plans):
    return {k: p.to_json() for k, p in plans.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _smoke_cfgs():
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]),
                               moe_dropless=True)
    return jcfg, treg.reduce_for_smoke(treg.get("qwen3-8b"))


def _ci_cfgs():
    """examples/serve_da.py::build_cfg in both packages."""
    kw = dict(name="qwen3-20m", n_layers=4, d_model=256, n_heads=4,
              n_kv_heads=2, head_dim=64, d_ff=768, vocab=8000,
              param_dtype="float32", compute_dtype="float32")
    return (dataclasses.replace(ARCHS["qwen3-8b"], remat=False,
                                moe_dropless=True, **kw),
            dataclasses.replace(treg.get("qwen3-8b"), **kw))


def _tiny_cfgs():
    """The reference's ``_serve_cfg``: vocab 503 puts the LM head in another
    bucket than the blocks' matrices."""
    kw = dict(name="qwen3-tiny", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, head_dim=16, d_ff=128, vocab=503,
              param_dtype="float32", compute_dtype="float32")
    return (dataclasses.replace(ARCHS["qwen3-8b"], remat=False,
                                moe_dropless=True, **kw),
            dataclasses.replace(treg.get("qwen3-8b"), **kw))


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, (jcfg, tcfg) in (("smoke", _smoke_cfgs()), ("tiny", _tiny_cfgs()),
                               ("ci", _ci_cfgs())):
        params = jinit(jax.random.key(0), jcfg)
        out[name] = (jcfg, tcfg, params, params_from_jax(_np(params)))
    return out


def _two_bucket_table(m_hint, d_model, vocab):
    """Stacked bit-planes win the blocks' bucket, the LUT readout the LM
    head's: a per-layer planner must differ by shape."""
    small = teng.shape_bucket(m_hint, d_model, d_model, 8)
    head = teng.shape_bucket(m_hint, d_model, vocab, 8)
    assert small != head
    return {small: {"bitplane_stacked": 1.0, "lut": 50.0, "bitplane": 40.0},
            head: {"lut": 1.0, "bitplane_stacked": 50.0, "bitplane": 60.0}}


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [1, 4, 64, 512])
@pytest.mark.parametrize("k,n", [(64, 64), (256, 8000), (4096, 12288), (37, 20)])
@pytest.mark.parametrize("group,x_bits", [(8, 8), (4, 8), (8, 4)])
def test_analytic_costs_equal_reference(m, k, n, group, x_bits):
    for has_luts in (True, False):
        ours = tfreeze.analytic_costs(m, k, n, DAConfig(group_size=group,
                                                        x_bits=x_bits,
                                                        x_signed=True), has_luts)
        ref = jfreeze.analytic_costs(m, k, n, JDA(group_size=group,
                                                  x_bits=x_bits, x_signed=True),
                                     has_luts)
        assert ours == ref


def test_plan_layer_measured_beats_analytic():
    cfg = DAConfig(x_signed=True)
    table = {teng.shape_bucket(4, 64, 64, 8): {"bitplane": 1.0, "lut": 9.0}}
    p = tfreeze.plan_layer(64, 64, cfg, m_hint=4, cost_table=table)
    assert p.mode == "bitplane" and p.source == "measured"
    assert p.est_cost == 1.0 and p.with_luts
    assert p.to_json() == jfreeze.plan_layer(64, 64, JDA(x_signed=True), m_hint=4,
                                             cost_table=table).to_json()


def test_plan_layer_analytic_fallback_uses_hwmodel():
    cfg = DAConfig(x_signed=True)
    with_luts = tfreeze.plan_layer(64, 64, cfg, m_hint=4, cost_table={})
    assert with_luts.source == "analytic" and with_luts.mode == "lut"
    no_luts = tfreeze.plan_layer(64, 64, cfg, m_hint=4, cost_table={},
                                 lut_cell_limit=100)
    assert not no_luts.with_luts and no_luts.mode == "bitplane_stacked"
    for ours, kw in ((with_luts, {}), (no_luts, {"lut_cell_limit": 100})):
        assert ours.to_json() == jfreeze.plan_layer(
            64, 64, JDA(x_signed=True), m_hint=4, cost_table={}, **kw).to_json()


def test_group_size_candidates_recover_luts():
    """A layer whose LUTs bust the budget at L=8 keeps the readout at L=4;
    only the base group size may claim a measurement."""
    cfg = DAConfig(x_signed=True)
    k = n = 64
    limit = 8 * k * n
    p8 = tfreeze.plan_layer(k, n, cfg, cost_table={}, lut_cell_limit=limit)
    assert not p8.with_luts
    p48 = tfreeze.plan_layer(k, n, cfg, cost_table={}, lut_cell_limit=limit,
                             group_size_candidates=(8, 4))
    assert p48.with_luts and p48.group_size == 4 and p48.mode == "lut"
    table = {teng.shape_bucket(4, k, n, 8): {"bitplane": 5.0}}
    p84 = tfreeze.plan_layer(k, n, cfg, cost_table=table, lut_cell_limit=limit,
                             group_size_candidates=(4, 8))
    assert (p84.source, p84.group_size) == ("measured", 8)
    for ours, kw in ((p8, {}), (p48, {"group_size_candidates": (8, 4)}),
                     (p84, {"group_size_candidates": (4, 8), "cost_table": table})):
        kw = {"cost_table": {}, **kw}
        assert ours.to_json() == jfreeze.plan_layer(
            k, n, JDA(x_signed=True), lut_cell_limit=limit, **kw).to_json()


def test_plan_model_is_per_layer_not_constant(models):
    jcfg, tcfg, jparams, tparams = models["tiny"]
    table = _two_bucket_table(2, tcfg.d_model, tcfg.vocab)
    plans = tfreeze.plan_model(tparams, DAConfig(x_signed=True), m_hint=2,
                               cost_table=table)
    assert plans["periods/pos_0/mixer/wq"].mode == "bitplane_stacked"
    assert plans["lm_head/w"].mode == "lut"
    assert _json(plans) == _json(jfreeze.plan_model(
        jparams, JDA(x_signed=True), m_hint=2, cost_table=table))


@pytest.mark.parametrize("table", ["empty", "committed"])
@pytest.mark.parametrize("groups", [None, (4, 8)])
@pytest.mark.parametrize("model", ["smoke", "ci"])
@pytest.mark.parametrize("m_hint", [4, 64])
def test_plan_model_equals_reference(models, model, table, groups, m_hint):
    """Every field of every plan equal (est_cost exactly), the table
    installed in both packages with set_cost_table."""
    jcfg, tcfg, jparams, tparams = models[model]
    if table == "committed":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _install(jeng.load_cost_table(COMMITTED))
        assert teng.load_cost_table()
    else:
        _install({})
    ours = tfreeze.plan_model(tparams, DAConfig(x_signed=True), m_hint=m_hint,
                              group_size_candidates=groups, period=tcfg.period)
    ref = jfreeze.plan_model(jparams, JDA(x_signed=True), m_hint=m_hint,
                             group_size_candidates=groups)
    assert _json(ours) == _json(ref)
    assert len(ours) == 8  # 7 matrices of a block and the LM head
    if model == "ci" and m_hint == 4 and groups is None:
        # the repo's default freeze of its LUT-serving model: the PMAs for
        # every block matrix, stacked bit-planes for the 65.5M-cell head
        assert {k: p.mode for k, p in ours.items()} == {
            k: ("bitplane_stacked" if k == "lm_head/w" else "lut") for k in ours}
        assert {p.source for p in ours.values()} == (
            {"analytic"} if table == "empty" else {"measured"})


# ---------------------------------------------------------------------------
# the planned freeze
# ---------------------------------------------------------------------------

def _assert_packed_equal(ours, theirs):
    """Every block's PackedWeights equal: codes, scales, LUTs, cfg, mode."""
    a_leaves, b_leaves = list(tfreeze.packed_leaves(ours)), list(
        tfreeze.packed_leaves(theirs))
    assert [k for k, _ in a_leaves] == [k for k, _ in b_leaves]
    for (_, a), (_, b) in zip(a_leaves, b_leaves):
        assert torch.equal(a.wq, b.wq) and torch.equal(a.w_scale, b.w_scale)
        assert (a.luts is None) == (b.luts is None)
        assert a.luts is None or torch.equal(a.luts, b.luts)
        assert (a.cfg, a.mode) == (b.cfg, b.mode)


@pytest.mark.parametrize("pin_modes", [True, False])
@pytest.mark.parametrize("model", ["tiny", "ci"])
def test_planned_freeze_is_bit_exact(models, model, pin_modes):
    """A planned freeze (blocks on stacked planes, the head on the PMAs)
    packs the reference's codes, scales and LUTs: pinned artifacts drop the
    LUTs their backend never reads, unpinned ones keep every feasible LUT
    and mode 'auto'."""
    jcfg, tcfg, jparams, tparams = models[model]
    table = _two_bucket_table(4, tcfg.d_model, tcfg.vocab)
    _install(table)
    ours = tfreeze.freeze_model(tparams, DAConfig(x_signed=True), mode="auto",
                                model_cfg=tcfg, pin_modes=pin_modes, device="cpu")
    ref = jfreeze.freeze_model(jparams, JDA(x_signed=True), mode="auto",
                               model_cfg=jcfg, pin_modes=pin_modes)
    assert _json(ours.plan) == _json(ref.plan)
    assert ours.hwcost.to_json() == ref.hwcost.to_json()
    _assert_packed_equal(ours.params, params_from_jax(_np(ref.params)))
    wq = ours.params["blocks"][0]["mixer"]["wq"]
    head = ours.params["lm_head"]["w"]
    if model == "tiny":  # the head's LUTs fit the budget
        assert head.has_luts
    if pin_modes:
        assert (wq.mode, wq.has_luts) == ("bitplane_stacked", False)
        assert not ours.plan["periods/pos_0/mixer/wq"].with_luts
    else:
        assert wq.mode == "auto" and wq.has_luts
    # the q/k/v codes share one buffer, as the pinned freeze lays them out
    mixer = ours.params["blocks"][1]["mixer"]
    assert mixer["wk"].wq.untyped_storage().data_ptr() == \
        mixer["wq"].wq.untyped_storage().data_ptr()


def test_pinned_freeze_drops_dead_luts():
    cfg = DAConfig(x_signed=True)
    table = {teng.shape_bucket(4, 64, 64, 8): {"bitplane_stacked": 1.0,
                                                "lut": 9.0}}
    w = {"wq": torch.from_numpy(np.random.default_rng(7).normal(
        size=(64, 64)).astype(np.float32))}
    pinned = tfreeze.freeze_model(w, cfg, m_hint=4, cost_table=table, device="cpu")
    assert pinned.params["wq"].mode == "bitplane_stacked"
    assert not pinned.params["wq"].has_luts and not pinned.plan["wq"].with_luts
    loose = tfreeze.freeze_model(w, cfg, m_hint=4, cost_table=table,
                                 pin_modes=False, device="cpu")
    assert loose.params["wq"].mode == "auto" and loose.params["wq"].has_luts


def test_freeze_model_pinned_mode_matches_legacy():
    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(32, 16)).astype(np.float32))
    art = tfreeze.freeze_model({"w": w}, DAConfig(x_signed=True), mode="da_lut",
                               device="cpu")
    leaf = art.params["w"]
    assert isinstance(leaf, PackedWeights) and leaf.mode == "lut" and leaf.has_luts
    assert art.plan["w"].source == "pinned"
    legacy = tfreeze.freeze_model_da({"w": w}, mode="da_lut", device="cpu")
    assert torch.equal(legacy["w"].luts, leaf.luts)


def test_skip_context_subtrees_stay_float():
    w = torch.ones(8, 4)
    art = tfreeze.freeze_model({"router": {"w": w}, "head": {"w": w}},
                               DAConfig(x_signed=True), mode="lut", device="cpu")
    assert not isinstance(art.params["router"]["w"], PackedWeights)
    assert isinstance(art.params["head"]["w"], PackedWeights)
    assert set(art.plan) == {"head/w"}


def test_kv_dtype_overrides_are_recorded(models):
    """model_cfg's KV dtype on the wk/wv plans, overridden per position;
    an unknown dtype raises in both packages."""
    jcfg, tcfg, jparams, tparams = models["smoke"]
    _install({})
    ours = tfreeze.freeze_model(tparams, mode="auto", device="cpu",
                                model_cfg=dataclasses.replace(tcfg, kv_dtype="int8"),
                                kv_dtype_overrides={"pos_0": "int4"})
    ref = jfreeze.freeze_model(jparams, mode="auto",
                               model_cfg=dataclasses.replace(jcfg, kv_dtype="int8"),
                               kv_dtype_overrides={"pos_0": "int4"})
    assert _json(ours.plan) == _json(ref.plan)
    assert {k: p.kv_dtype for k, p in ours.plan.items() if p.kv_dtype} == {
        "periods/pos_0/mixer/wk": "int4", "periods/pos_0/mixer/wv": "int4"}
    with pytest.raises(ValueError, match="kv_dtype_overrides"):
        tfreeze.freeze_model(tparams, mode="auto", model_cfg=tcfg, device="cpu",
                             kv_dtype_overrides={"pos_0": "fp8"})


def test_linear_facade_and_quantize_shim():
    from repro_torch.core import linear

    w = torch.from_numpy(np.random.default_rng(3).normal(
        size=(64, 32)).astype(np.float32))
    p = linear.freeze_da(w)
    assert isinstance(p, linear.DAFrozenLinear) and p.has_luts and p.mode == "auto"
    assert not linear.freeze_da(w, lut_cell_limit=100).has_luts
    sys.modules.pop("repro_torch.serve.quantize", None)
    with pytest.warns(DeprecationWarning, match="repro_torch.core.freeze"):
        shim = importlib.import_module("repro_torch.serve.quantize")
    for name in ("freeze_model", "freeze_model_da", "plan_model", "DAArtifact",
                 "LayerPlan", "save_artifact", "load_artifact"):
        assert getattr(shim, name) is getattr(tfreeze, name), name


# ---------------------------------------------------------------------------
# planned artifacts across packages, and the planned serve
# ---------------------------------------------------------------------------

KW = dict(batch_size=2, max_len=32, page_size=8)


def _tokens(eng, prompts, request_cls, new=4):
    for uid, pr in prompts.items():
        eng.submit(request_cls(uid=uid, prompt=pr, max_new_tokens=new))
    done = eng.run()
    return {u: [int(t) for t in done[u].generated] for u in prompts}


def test_planned_artifacts_boot_across_packages(models, tmp_path):
    """A port-planned artifact boots in JAX with the same plan and tokens;
    a JAX-planned one (pin_modes=False: mode 'auto' kept) boots in the port
    the same way."""
    jcfg, tcfg, jparams, tparams = models["tiny"]
    _install(_two_bucket_table(2, tcfg.d_model, tcfg.vocab))
    rng = np.random.default_rng(11)
    prompts = {u: rng.integers(0, tcfg.vocab, 3 + 5 * u).astype(np.int32)
               for u in range(3)}
    ours = ServeEngine(tcfg, tparams, da_mode="auto", device="cpu", **KW)
    assert {p.mode for p in ours.artifact.plan.values()} == {"lut", "bitplane_stacked"}
    d = ours.save_artifact(str(tmp_path / "torch_art"))
    theirs = JServeEngine.from_artifact(d, **KW)
    assert _json(theirs.artifact.plan) == _json(ours.artifact.plan)
    assert _tokens(theirs, prompts, JRequest) == _tokens(ours, prompts, Request)
    jart = jfreeze.freeze_model(jparams, JDA(x_signed=True), mode="auto",
                                m_hint=2, model_cfg=jcfg, pin_modes=False)
    d2 = jfreeze.save_artifact(str(tmp_path / "jax_art"), jart)
    back = ServeEngine.from_artifact(d2, device="cpu", **KW)
    assert _json(back.artifact.plan) == _json(jart.plan)
    assert back.params["blocks"][0]["mixer"]["wq"].mode == "auto"
    assert _tokens(back, prompts, Request) == _tokens(
        JServeEngine.from_artifact(d2, **KW), prompts, JRequest)


def test_serve_from_artifact_matches_in_memory(models, tmp_path):
    """Freeze with da_mode='auto', save, cold-boot from disk: the same plan,
    the same greedy tokens, and a per-layer plan."""
    jcfg, tcfg, _, tparams = models["tiny"]
    teng.set_cost_table(_two_bucket_table(2, tcfg.d_model, tcfg.vocab))
    mem = ServeEngine(tcfg, tparams, da_mode="auto", device="cpu", **KW)
    plans = mem.artifact.plan
    assert {"lut", "bitplane_stacked"} <= {p.mode for p in plans.values()}
    assert plans["periods/pos_0/mixer/wk"].kv_dtype == tcfg.kv_dtype
    d = mem.save_artifact(str(tmp_path / "artifact"))
    with open(f"{d}/manifest.json") as f:
        assert json.load(f)["registry"] == jeng.registry_fingerprint()
    disk = ServeEngine.from_artifact(d, device="cpu", **KW)
    assert disk.artifact.plan == plans
    rng = np.random.default_rng(10)
    prompts = {u: rng.integers(0, tcfg.vocab, 5 + u) for u in range(3)}
    assert _tokens(mem, prompts, Request, 6) == _tokens(disk, prompts, Request, 6)


@pytest.mark.parametrize("pin", [True, False])
def test_auto_serve_equals_reference_on_ci_smoke(models, pin):
    """ServeEngine(da_mode="auto") on the CI smoke's model, the smoke's
    plain-leg requests (2 at batch 4, seed 0): the reference's plan and
    greedy tokens, with modes pinned and with runtime dispatch."""
    jcfg, tcfg, jparams, tparams = models["ci"]
    _install({})

    def serve(eng, request_cls):
        rng = np.random.default_rng(0)
        for u in range(2):
            eng.submit(request_cls(uid=u, prompt=rng.integers(
                0, tcfg.vocab, rng.integers(4, 24)).astype(np.int32),
                max_new_tokens=int(rng.integers(8, 24))))
        done = eng.run()
        return {u: [int(t) for t in r.generated] for u, r in done.items()}

    ours = ServeEngine(tcfg, tparams, batch_size=4, max_len=96, da_mode="auto",
                       da_pin_modes=pin, device="cpu")
    ref = JServeEngine(jcfg, jparams, batch_size=4, max_len=96, da_mode="auto",
                       da_pin_modes=pin)
    assert _json(ours.artifact.plan) == _json(ref.artifact.plan)
    assert ours.artifact.hwcost.to_json() == ref.artifact.hwcost.to_json()
    got, want = serve(ours, Request), serve(ref, JRequest)
    assert len(want) == 2 and got == want
