"""BENCHMARK.json against the contract's rules, and every file a cell,
a configuration or a metric names."""
from __future__ import annotations

import copy
import dataclasses

import pytest

from bench import manifest as mf
from bench.model import BENCH, load_json, model_of
from bench.readers import load_reader


@pytest.fixture(scope="module")
def man():
    return mf.load()


def test_manifest_has_no_problems(man):
    assert mf.problems(man) == []


def test_top_level_keys_and_command(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "bench/run.py"]
    assert man["paths"] == ["bench"]
    assert 1 <= man["run_seconds"] <= 51


@pytest.mark.parametrize("name,ok", [
    ("tokens_per_s", True), ("minitron-8b.chat-b128", True), ("_x.y-z", True),
    ("a" * 64, True), ("a" * 65, False), ("has space", False), ("a,b", False),
    ("a/b", False), ("-lead", False), ("µs", False), ("", False)])
def test_name_characters(name, ok):
    assert bool(mf.NAME.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("tokens/s", True), ("%", True), ("ms", True), ("GB", True),
    ("tokens per second", False), ("µs", False), ("x" * 17, False), ("", False)])
def test_unit_characters(unit, ok):
    assert bool(mf.UNIT.match(unit)) is ok


def test_a_bad_unit_and_a_fifth_metric_are_caught(man):
    bad = copy.deepcopy(man)
    bad["end_to_end"][0]["unit"] = "tokens per second"
    bad["end_to_end"].append(dict(bad["end_to_end"][1], name="extra_ms"))
    found = mf.problems(bad)
    assert any("bad unit" in p for p in found)
    assert any("more than four" in p for p in found)


def test_a_layer_metric_must_move_a_metric_its_cells_report(man):
    bad = copy.deepcopy(man)
    bad["per_layer"][0]["moves"] = "ttft_p90_ms"      # reported by one cell only
    assert any("moves ttft_p90_ms" in p for p in mf.problems(bad))


def test_every_cell_reports_setup_and_a_layer_metric(man):
    for w in man["workloads"]:
        e2e = {m["name"] for m in mf.metrics_of(man, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert mf.metrics_of(man, w["name"], "per_layer")


def test_every_named_file_exists(man):
    for c in man["configs"]:
        assert (BENCH.parent / c["file"]).exists()
    for w in man["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").exists()
        assert mf.limit_of(w) is not None
    for m in man["per_layer"]:
        assert callable(load_reader(m["name"]))


def test_roofline_metrics_are_named_for_their_kernel(man):
    for m in man["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_config_files_match_the_program(man):
    """The sizes a configuration file states are the ones the port runs."""
    from bench.serve import program_config

    for c in man["configs"]:
        raw = load_json(BENCH.parent / c["file"])
        assert raw["source"] == c["source"] and raw["reduced"] == c["reduced"]
        d, cfg = model_of(raw).desc, program_config(raw)
        assert (d.n_layers, d.d_model, d.n_heads, d.n_kv_heads, d.head_dim, d.vocab) == (
            cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.vocab)
        assert (d.norm_type, d.mlp_act, d.attn_bias) == (cfg.norm_type, cfg.mlp_act, cfg.attn_bias)
        assert (d.norm_eps, d.rope_theta) == (cfg.norm_eps, cfg.rope_theta)
        if d.n_experts:
            from repro_torch.models.moe import padded_experts

            assert (d.n_experts, d.top_k, d.moe_d_ff, d.n_experts_padded) == (
                cfg.n_experts, cfg.top_k, cfg.moe_d_ff, padded_experts(cfg))
            assert d.shared_d_ff == cfg.n_shared_experts * cfg.moe_d_ff
            assert cfg.moe_dropless
        else:
            assert d.d_ff == cfg.d_ff
        assert dataclasses.replace(cfg) == cfg
