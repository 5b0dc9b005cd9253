"""PyTorch port vs the JAX reference: the DA hardware-cost model.

``repro_torch.obs.hwcost`` prices every packed layer of a served model on
the paper's DA circuits and on bit slicing (pJ and model-ns per token-pass,
reckoned from ``core/hwmodel.py``; nothing here is measured on a device).
Held against the reference:

* the per-token table: CONV1 is Table I exactly, components sum to the
  total, stacked VMMs and truncated bit-planes scale linearly, the JSON
  form round-trips behind a version gate;
* qwen3-8b at full width through ``from_shapes``: equal ``summary()``;
* ``from_frozen`` on ``reduce_for_smoke(qwen3-8b)`` frozen in both packages:
  the port keeps one params dict per layer, the reference stacks layers
  over periods, and the tables (``layer_table()``, ``summary()``,
  ``draft_price`` of every provider) are equal;
* artifacts: the table survives a save and a load between the packages in
  both directions, a manifest without it is rebuilt from the leaves, and
  ``da_memory_report`` is the reference's;
* serving: the attributed pJ equals the per-token price times the executed
  token-passes, greedy and with a spec draft, and float weights carry no
  ``hw`` block.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core import freeze as jfreeze
from repro.core.da import DAConfig as JDA
from repro.models.model import init_model as jinit
from repro.obs import hwcost as jhwcost
from repro.spec import SpecConfig as JSpec
from repro.spec import make_provider as jmake_provider
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import freeze as tfreeze
from repro_torch.core.hwmodel import PJ, BitSliceDesign, DADesign
from repro_torch.obs import check as tcheck
from repro_torch.obs.export import validate_metrics_json
from repro_torch.obs.hwcost import (
    HWCOST_VERSION,
    HardwareCostModel,
    draft_price,
)
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.spec import SpecConfig
from repro_torch.spec import make_provider

CONV1 = [("conv1", 25, 6)]
MAX_NEW = 4
KW = dict(batch_size=2, max_len=32, page_size=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's CPU ops
    in each take one thread (restored after the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _same_table(ours: HardwareCostModel, ref) -> None:
    assert [dataclasses.asdict(g) for g in ours.layers] == \
        [dataclasses.asdict(g) for g in ref.layers]
    for eff in (None, 4, 1):
        assert ours.layer_table(eff) == ref.layer_table(eff)
        assert ours.summary(eff) == ref.summary(eff)


# ---------------------------------------------------------------------------
# the per-token table (pure)
# ---------------------------------------------------------------------------
def test_conv1_matches_table1_exactly():
    hw = HardwareCostModel.from_shapes(CONV1)
    assert hw.pj_per_token() == pytest.approx(110.2, rel=1e-6)
    assert hw.ns_per_token() == pytest.approx(88.0)
    assert hw.bitslice_pj_per_token() == pytest.approx(1421.5, rel=1e-6)
    assert hw.bitslice_ns_per_token() == pytest.approx(400.0)
    r = hw.ratios()
    assert r["energy"] == pytest.approx(1421.5 / 110.2, rel=1e-6)
    assert r["energy"] > 10.0
    assert r["latency"] == pytest.approx(400.0 / 88.0, rel=1e-6)
    _same_table(hw, jhwcost.HardwareCostModel.from_shapes(CONV1))


def test_components_sum_to_total_exactly():
    hw = HardwareCostModel.from_shapes(CONV1)
    assert sum(hw.components().values()) == hw.pj_per_token()
    assert sum(hw.bitslice_components().values()) == hw.bitslice_pj_per_token()
    for design, comps in ((DADesign(k=25, n=6), hw.components()),
                          (BitSliceDesign(k=25, n=6), hw.bitslice_components())):
        for key, joules in design.energy_components_j().items():
            assert comps[f"{key}_pj"] == pytest.approx(joules / PJ)


def test_vmms_per_token_and_x_bits_eff_scale_linearly():
    """Stacked VMMs add up; a truncated-bitplane pass runs the same circuits
    for fewer cycles: energy × eff/x_bits exactly on every component,
    latency less the skipped read cycles (CONV1 at 4 bits: 15 + 3·10 + 3)."""
    one = HardwareCostModel.from_shapes(CONV1)
    three = HardwareCostModel.from_shapes([("conv1", 25, 6, 3)])
    assert three.pj_per_token() == pytest.approx(3 * one.pj_per_token())
    assert three.ns_per_token() == pytest.approx(3 * one.ns_per_token())
    row = three.layer_table()[0]
    assert row["vmms_per_token"] == 3
    assert row["memory_cells"] == 3 * one.layer_table()[0]["memory_cells"]
    assert one.pj_per_token(x_bits_eff=4) == 0.5 * one.pj_per_token()
    for key, full in one.components().items():
        assert one.components(x_bits_eff=4)[key] == 0.5 * full
    assert one.ns_per_token(x_bits_eff=4) == pytest.approx(48.0)
    assert one.bitslice_pj_per_token(x_bits_eff=4) == \
        0.5 * one.bitslice_pj_per_token()
    assert one.ratios(x_bits_eff=4)["energy"] == \
        pytest.approx(one.ratios()["energy"])
    assert one.pj_per_token(x_bits_eff=99) == one.pj_per_token()
    assert one.pj_per_token(x_bits_eff=0) == one.pj_per_token(x_bits_eff=1)


def test_json_roundtrip_and_version_gate():
    shapes = [("a", 25, 6), {"path": "b", "k": 64, "n": 32, "vmms_per_token": 2}]
    hw = HardwareCostModel.from_shapes(shapes)
    again = HardwareCostModel.from_json(hw.to_json())
    assert again == hw and again.summary() == hw.summary()
    assert hw.to_json() == jhwcost.HardwareCostModel.from_shapes(shapes).to_json()
    with pytest.raises(ValueError):
        HardwareCostModel.from_json({"hwcost_version": HWCOST_VERSION + 1,
                                     "layers": []})
    assert not HardwareCostModel([])  # empty is falsy: no cost model


def _full_width_shapes(cfg):
    """Every DA matrix of a dense qwen3 layer stack, (label, K, N, count)."""
    d, qd, kvd, n = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                     cfg.n_kv_heads * cfg.head_dim, cfg.n_layers)
    return [("wq", d, qd, n), ("wk", d, kvd, n), ("wv", d, kvd, n),
            ("wo", qd, d, n), ("w_gate", d, cfg.d_ff, n),
            ("w_up", d, cfg.d_ff, n), ("w_down", cfg.d_ff, d, n),
            ("lm_head", d, cfg.vocab, 1)]


def test_qwen3_8b_full_width_summary_equals_the_reference():
    shapes = _full_width_shapes(treg.get("qwen3-8b"))
    assert shapes == _full_width_shapes(ARCHS["qwen3-8b"])
    ours = HardwareCostModel.from_shapes(shapes)
    _same_table(ours, jhwcost.HardwareCostModel.from_shapes(shapes))
    s = ours.summary()
    assert s["vmms_per_token"] == 7 * 36 + 1
    # the serialized DA bound stretches with K's adder chain: at these
    # widths the model has DA ahead on energy, not on latency
    assert s["ratios"]["energy"] > 1.0 > s["ratios"]["latency"]


# ---------------------------------------------------------------------------
# from_frozen: the port's per-layer tree, the reference's stacked one
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def frozen():
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]),
                               moe_dropless=True)
    tcfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    jparams = jinit(jax.random.key(0), jcfg)
    tfloat = params_from_jax(jax.tree.map(np.asarray, jparams))
    arts = {}
    for mode in ("bitplane", "bitplane_stacked", "pallas_lut"):
        jart = jfreeze.freeze_model(jparams, JDA(x_signed=True), mode=mode,
                                    model_cfg=jcfg)
        tart = ServeEngine(tcfg, tfloat, da_mode=mode, device="cpu",
                           **KW).artifact
        arts[mode] = (jart, tart)
    rng = np.random.default_rng(7)
    prompts = {u: rng.integers(0, jcfg.vocab, 3 + u).astype(np.int32)
               for u in range(4)}
    return jcfg, tcfg, tfloat, arts, prompts


@pytest.mark.parametrize("mode", ["bitplane", "bitplane_stacked", "pallas_lut"])
def test_from_frozen_equals_the_reference(frozen, mode):
    """Both packages freeze the same float weights: the port's table (its
    blocks merged under the reference's paths, vmms_per_token = layers)
    equals the reference's row for row."""
    jcfg, tcfg, _, arts, _ = frozen
    jart, tart = arts[mode]
    _same_table(tart.hwcost, jart.hwcost)
    assert tart.hwcost == HardwareCostModel.from_frozen(
        tart.params, tart.plan, period=tcfg.period)
    assert {g.vmms_per_token for g in tart.hwcost.layers} == {1, tcfg.n_layers}
    assert all(g.mode == mode for g in tart.hwcost.layers)


def test_from_frozen_refuses_layers_that_disagree(frozen):
    _, tcfg, _, arts, _ = frozen
    params = arts["bitplane"][1].params
    blocks = list(params["blocks"])
    mixer = dict(blocks[1]["mixer"])
    mixer["wq"] = dataclasses.replace(mixer["wq"], mode="lut")
    blocks[1] = {**blocks[1], "mixer": mixer}
    with pytest.raises(ValueError, match="disagree"):
        HardwareCostModel.from_frozen({**params, "blocks": blocks})


@pytest.mark.parametrize("provider", ["bitplane", "layerskip", "artifact"])
def test_draft_price_equals_the_reference(frozen, provider):
    """Truncated bit-planes reprice through the model, layer skip scales by
    cost_ratio, an own-weights draft gets its own table."""
    jcfg, tcfg, _, arts, _ = frozen
    jart, tart = arts["bitplane"]
    other_j, other_t = arts["bitplane_stacked"]
    kw = dict(provider=provider, draft_x_bits=4, draft_periods=1)
    if provider == "artifact":
        jspec = JSpec(**kw, draft_params=other_j.params, draft_model_cfg=jcfg)
        tspec = SpecConfig(**kw, draft_params=other_t.params,
                           draft_model_cfg=tcfg)
    else:
        jspec, tspec = JSpec(**kw), SpecConfig(**kw)
    ours = draft_price(tart.hwcost, make_provider(tspec, tcfg, tart.params,
                                                  device="cpu"), tart.params)
    ref = jhwcost.draft_price(jart.hwcost, jmake_provider(jspec, jcfg,
                                                          jart.params),
                              jart.params)
    assert ours == ref
    if provider == "bitplane":
        assert ours["pj"] == 0.5 * tart.hwcost.pj_per_token()
    if provider == "artifact":
        assert ours["pj"] == other_t.hwcost.pj_per_token()


# ---------------------------------------------------------------------------
# artifacts both ways
# ---------------------------------------------------------------------------
def test_port_artifact_carries_hwcost_to_the_reference(frozen, tmp_path):
    jcfg, tcfg, _, arts, _ = frozen
    jart, tart = arts["bitplane_stacked"]
    d = tfreeze.save_artifact(str(tmp_path / "port"), tart)
    manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert manifest["hwcost"] == jart.hwcost.to_json()
    assert jfreeze.load_artifact(d).hwcost == jart.hwcost
    assert tfreeze.load_artifact(d, device="cpu").hwcost == tart.hwcost


def test_reference_artifact_carries_hwcost_to_the_port(frozen, tmp_path):
    jcfg, tcfg, _, arts, _ = frozen
    jart, tart = arts["bitplane"]
    d = str(tmp_path / "ref")
    jfreeze.save_artifact(d, jart)
    loaded = tfreeze.load_artifact(d, device="cpu")
    assert isinstance(loaded.hwcost, HardwareCostModel)
    _same_table(loaded.hwcost, jart.hwcost)
    eng = ServeEngine.from_artifact(d, device="cpu", **KW)
    assert eng.hw == loaded.hwcost  # from_artifact passes the manifest's


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_manifest_without_hwcost_is_rebuilt(frozen, tmp_path, writer):
    """An artifact written before the cost table: the port's loader rebuilds
    it from the packed leaves (the plan's modes where a leaf says auto)."""
    jcfg, tcfg, _, arts, _ = frozen
    jart, tart = arts["bitplane"]
    d = str(tmp_path / writer)
    if writer == "port":
        tfreeze.save_artifact(d, tart)
    else:
        jfreeze.save_artifact(d, jart)
    mpath = tmp_path / writer / "manifest.json"
    manifest = json.loads(mpath.read_text())
    del manifest["hwcost"]
    mpath.write_text(json.dumps(manifest))
    _same_table(tfreeze.load_artifact(d, device="cpu").hwcost, jart.hwcost)
    assert jfreeze.load_artifact(d).hwcost == jart.hwcost


@pytest.mark.parametrize("mode", ["bitplane", "pallas_lut"])
def test_da_memory_report_equals_the_reference(frozen, tmp_path, mode):
    """The reference's report, key for key, on the same artifact (a LUT
    freeze adds the LUT cells and their blow-up)."""
    jcfg, tcfg, _, arts, _ = frozen
    jart = arts[mode][0]
    d = str(tmp_path / "art")
    jfreeze.save_artifact(d, jart)
    art = tfreeze.load_artifact(d, device="cpu")
    for kv in (None, "int8"):
        ours = tfreeze.da_memory_report(art.params, art.model_cfg, kv)
        ref = jfreeze.da_memory_report(jart.params, jcfg, kv)
        assert ours == ref
    bare = tfreeze.da_memory_report(art.params)
    assert "kv" not in bare and bare["layers"] == ref["layers"]
    assert (ours["lut_cells"] > 0) == (mode == "pallas_lut")


# ---------------------------------------------------------------------------
# serving attribution
# ---------------------------------------------------------------------------
def _serve(eng, prompts):
    for uid, pr in prompts.items():
        eng.submit(Request(uid=uid, prompt=pr, max_new_tokens=MAX_NEW))
    eng.run()
    return eng.metrics()


def test_greedy_attribution_sums_exactly(frozen):
    """Attributed pJ and ns equal the per-token price × executed
    token-passes; the live counterfactual prices the same work."""
    _, tcfg, _, arts, prompts = frozen
    art = arts["bitplane_stacked"][1]
    eng = ServeEngine(tcfg, art.params, device="cpu", **KW)
    assert eng.hw == art.hwcost  # derived from the frozen params
    m = _serve(eng, prompts)
    hw = m["hw"]
    toks = hw["tokens"]
    assert toks["prefill"] + toks["decode"] == m["ctx_tokens"]
    assert hw["est_pj"]["total"] == pytest.approx(
        m["ctx_tokens"] * art.hwcost.pj_per_token(), rel=1e-9)
    assert hw["est_ns"]["total"] == pytest.approx(
        m["ctx_tokens"] * art.hwcost.ns_per_token(), rel=1e-9)
    assert hw["pj_per_out_token"] == pytest.approx(
        hw["est_pj"]["total"] / m["out_tokens"], rel=1e-9)
    assert hw["live"]["bitslice_pj"] == pytest.approx(
        m["ctx_tokens"] * art.hwcost.bitslice_pj_per_token(), rel=1e-9)
    assert hw["live"]["energy_ratio"] == pytest.approx(
        art.hwcost.ratios()["energy"], rel=1e-9)
    per_req = sum(r.hw_pj for r in eng.done.values())
    assert per_req == pytest.approx(hw["est_pj"]["total"], rel=1e-9)
    snap = eng.metrics_snapshot()
    assert snap["req_hw_pj"]["count"] == len(prompts)


def test_spec_draft_attribution(frozen):
    """Draft passes are priced at x_bits_eff; the total decomposes exactly
    into full-price and draft-price phases."""
    _, tcfg, _, arts, prompts = frozen
    art = arts["bitplane_stacked"][1]
    eng = ServeEngine(tcfg, art.params, device="cpu",
                      spec=SpecConfig(provider="bitplane", gamma=2,
                                      draft_x_bits=4, disable_below=0.0), **KW)
    hw = _serve(eng, prompts)["hw"]
    full, draft = art.hwcost.pj_per_token(), art.hwcost.pj_per_token(x_bits_eff=4)
    assert hw["draft"]["x_bits_eff"] == 4 and hw["draft"]["pj"] == draft
    assert draft == 0.5 * full
    t = hw["tokens"]
    assert t["draft"] > 0 and t["verify"] > 0
    expect = (full * (t["prefill"] + t["decode"] + t["verify"])
              + draft * (t["draft"] + t["draft_ingest"]))
    assert hw["est_pj"]["total"] == pytest.approx(expect, rel=1e-9)


def test_explicit_and_absent_cost_models(frozen, tmp_path):
    """``hw=`` overrides the derived table; float weights (and an empty
    table) attribute nothing; the hw payload validates either way."""
    _, tcfg, tfloat, arts, prompts = frozen
    art = arts["bitplane"][1]
    conv = HardwareCostModel.from_shapes(CONV1)
    eng = ServeEngine(tcfg, art.params, hw=conv, device="cpu", **KW)
    m = _serve(eng, prompts)
    assert m["hw"]["est_pj"]["total"] == pytest.approx(
        m["ctx_tokens"] * conv.pj_per_token(), rel=1e-9)
    for kw in (dict(params=tfloat), dict(params=art.params,
                                         hw=HardwareCostModel([]))):
        eng = ServeEngine(tcfg, device="cpu", **kw, **KW)
        assert eng.hw is None and _serve(eng, prompts)["hw"] is None
    path = eng.write_hw_metrics(str(tmp_path / "hw.json"))
    obj = json.loads(open(path).read())
    assert obj["hw"] is None
    # a null hw block under schema v2 is a violation, as in the reference
    assert validate_metrics_json(obj) and tcheck.main([path]) == 1
