"""A configuration's own model module (``"model"`` in its file): without
the key the harness runs the built-in weights, reference and count
themselves; with it, the module's reference decides ``correct``."""
from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from bench import manifest as mf
from bench import reference, serve, weights, yardstick
from bench.model import desc_from_file, model_of
from test_bench_imports import forbidden_imports
from tiny import tiny_config, tiny_mix

SEED = 2**31 + 33
MOE = "qwen2-moe-a2.7b"       # the port's MoE stand-in, bench/tests/configs


def _with_module(name: str, module: str) -> dict:
    cfg = copy.deepcopy(tiny_config(name))
    cfg["model"] = module
    return cfg


def _run(config: dict) -> dict:
    w = mf.cell(mf.load(), "minitron-8b.chat-b128")
    return serve.run_cell(w, config, tiny_mix("chat-b128"), SEED, 1.5, False, "cpu",
                          time.perf_counter(), mf.limit_of(w))


@pytest.mark.parametrize("name", ["minitron-8b", MOE])
def test_without_a_model_key_the_builtins_run(name):
    cfg = tiny_config(name)
    model = model_of(cfg)
    assert model.make_params is weights.make_params
    assert model.logits_at is reference.logits_at
    assert model.desc == desc_from_file(cfg) and model.desc.matmul_params is None
    d = model.desc
    ours, theirs = model.make_params(d, SEED, "cpu"), weights.make_params(d, SEED, "cpu")
    assert torch.equal(ours["blocks"][1]["mixer"]["wq"], theirs["blocks"][1]["mixer"]["wq"])
    seqs = [list(range(5, 30)), list(range(40, 52))]
    got = dict(model.logits_at(d, SEED, seqs, [3, 0], "cpu"))
    want = dict(reference.logits_at(d, SEED, seqs, [3, 0], "cpu"))
    assert all(torch.equal(got[i], want[i]) for i in want)
    p = yardstick.matmul_params(d)
    assert yardstick.window_ops(d, 10, 0, 3) == 2.0 * p["body"] * 10 + 2.0 * p["head"] * 3


def test_a_module_of_the_builtins_checks_as_the_builtins():
    """Served through the port with a module that re-exports the built-ins:
    ``correct``, with the built-in reference's gap on the same sample."""
    res = _run(_with_module(MOE, "tests/models/builtin.py"))
    assert res["correct"], res["gap"]
    assert res["gap"] == serve.served_gap(model_of(tiny_config(MOE)), SEED, res["sample"], "cpu")


def test_the_modules_reference_decides():
    """A module whose reference gates the shared experts, as the port does
    not: the same sound program reads ``correct: false``."""
    res = _run(_with_module(MOE, "tests/models/gated_shared.py"))
    assert not res["correct"], res["gap"]
    builtin = serve.served_gap(model_of(tiny_config(MOE)), SEED, res["sample"], "cpu")
    assert builtin <= res["limit"] < res["gap"]


def test_a_modules_count_reaches_the_yardstick():
    d = model_of(_with_module(MOE, "tests/models/gated_shared.py")).desc
    p = yardstick.matmul_params(d)
    gate = d.n_layers * d.d_model
    assert yardstick.window_ops(d, 10, 0, 3) == 2.0 * (p["body"] + gate) * 10 + 2.0 * p["head"] * 3


@pytest.mark.parametrize("module,want", [
    ("tests/models/absent.py", "no such file"),
    ("../BENCHMARK.json", "no such file"),
    ("yardstick.py", "lacks desc()"),
    ("yardstick.py", "lacks logits_at()"),
    ("tests/models/builtin.py", None)])
def test_manifest_names_a_missing_or_incomplete_module(tmp_path, module, want):
    path = tmp_path / "config.json"
    path.write_text(json.dumps(_with_module(MOE, module)))
    man = mf.load()
    man["configs"].append(dict(man["configs"][0], name="with-module", file=str(path)))
    found = [p for p in mf.problems(man) if p.startswith("with-module")]
    assert (found == []) if want is None else any(want in p for p in found), found


@pytest.mark.parametrize("where", ["models", "tests/models"])
def test_the_import_scan_reaches_model_modules(tmp_path, where):
    (tmp_path / where).mkdir(parents=True)
    (tmp_path / where / "m.py").write_text("import torch\nimport jax.numpy as jnp\n")
    assert [(p.name, line) for p, line in forbidden_imports(tmp_path)] == [
        ("m.py", "import jax.numpy as jnp")]
