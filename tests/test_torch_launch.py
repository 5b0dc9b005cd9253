"""PyTorch port vs the JAX reference: the entry points.

Both serving launchers (``repro.launch.serve`` through a patched
``sys.argv``, ``repro_torch.launch.serve.main(argv)`` with ``--device
cpu``) boot the same artifact, the CI smoke's model (``examples/
serve_da.py::build_cfg``) frozen by the reference with
``bitplane_stacked``, and must print the same lines, their seconds and tok/s
masked, with fp and int8 KV pages; both ``serve_da`` examples print the same
lines on it, the ``req`` lines (each request's tokens) among them, plain and
with a truncated-bitplane spec draft.  The argument conflicts raise
``SystemExit`` in both.  The quickstart and both LeNet examples print the
reference's lines; the quickstart's float line is formatted to 4 decimals
and equal (its ``auto`` pick equal with no cost table in either package).
``repro_torch.core`` re-exports the reference's ``repro.core`` surface.
Every entry point runs with ``--device cpu`` and raises without a card when
left at its default.
"""
import dataclasses
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.core.da import DAConfig as JDA
from repro.core.freeze import freeze_model as jfreeze
from repro.core.freeze import save_artifact as jsave
from repro.models.model import init_model as jinit

ENTRY_POINTS = ("repro_torch.launch.serve", "repro_torch.launch.train",
                "repro_torch.examples.serve_da", "repro_torch.examples.quickstart",
                "repro_torch.examples.lenet_da_inference",
                "repro_torch.examples.lenet_full_da", "repro_torch.examples.train_lm")
#: what varies between two runs of one command: wall seconds and rates
TIMES = [(re.compile(r"\d+\.\d+s\b"), "<s>"),
         (re.compile(r"\d+\.\d+ tok/s"), "<tok/s>")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's CPU ops
    in each take one thread (restored after the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def smoke_artifact(tmp_path_factory):
    cfg = dataclasses.replace(  # examples/serve_da.py::build_cfg
        ARCHS["qwen3-8b"], name="qwen3-20m", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=768, vocab=8000,
        param_dtype="float32", compute_dtype="float32", remat=False,
        moe_dropless=True)
    d = str(tmp_path_factory.mktemp("art") / "smoke_da")
    jsave(d, jfreeze(jinit(jax.random.key(0), cfg), JDA(x_signed=True),
                     mode="bitplane_stacked", model_cfg=cfg))
    return d


def _masked(text: str):
    for pat, sub in TIMES:
        text = pat.sub(sub, text)
    return text.splitlines()


def _reference(monkeypatch, capsys, fn, argv):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    capsys.readouterr()
    fn()
    return capsys.readouterr().out


def _port(capsys, fn, argv):
    capsys.readouterr()
    fn(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def _ref_example(name):
    return lambda: runpy.run_path(f"examples/{name}.py", run_name="__main__")


# ---------------------------------------------------------------------------
# the serving launcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [[], ["--kv-dtype", "int8", "--hw-metrics"],
                                   ["--hw-metrics"]])
def test_serve_launcher_prints_the_reference_lines(smoke_artifact, monkeypatch,
                                                   capsys, extra):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    argv = ["--artifact", smoke_artifact, "--requests", "2", "--batch", "2",
            "--max-new", "8"] + extra
    theirs = _reference(monkeypatch, capsys, jserve.main, argv)
    ours = _port(capsys, tserve.main, argv)
    assert _masked(ours) == _masked(theirs)
    assert "served 2 requests / 16 tokens" in ours
    assert ("hw:" in ours) == ("--hw-metrics" in extra)
    assert ("kv[int8]" in ours) == ("int8" in extra)


SERVE_CONFLICTS = [
    ["--artifact", "A", "--quant", "da8"],
    ["--artifact", "A", "--arch", "qwen3-8b"],
    ["--artifact", "A", "--smoke"],
    ["--artifact", "A", "--save-artifact", "B"],
    ["--save-artifact", "B", "--arch", "qwen3-8b"],
    ["--arch", "qwen3-8b", "--spec", "artifact"],
    ["--quant", "da8"],
    ["--arch", "musicgen-large", "--smoke"],
]


@pytest.mark.parametrize("argv", SERVE_CONFLICTS)
def test_serve_launcher_conflicts_raise_in_both(monkeypatch, argv):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    with pytest.raises(SystemExit) as theirs:
        jserve.main()
    with pytest.raises(SystemExit) as ours:
        tserve.main(argv + ["--device", "cpu"])
    assert str(ours.value) == str(theirs.value) and str(ours.value)


def test_serve_launcher_freezes_and_saves(tmp_path, capsys):
    from repro_torch.core.freeze import load_artifact
    from repro_torch.launch import serve as tserve

    d = str(tmp_path / "art")
    out = _port(capsys, tserve.main, [
        "--arch", "qwen3-8b", "--smoke", "--quant", "da8-plan", "--requests", "2",
        "--batch", "2", "--max-new", "4", "--save-artifact", d])
    lines = out.splitlines()
    assert lines[0] == "arch=qwen3-8b params=0.1M quant=da8-plan"
    assert lines[1].startswith("pre-VMM freeze: ") and f"artifact -> {d}" in out
    assert load_artifact(d, device="cpu").model_cfg.name == "qwen3-8b"
    out = _port(capsys, tserve.main, ["--artifact", d, "--requests", "1",
                                      "--max-new", "4", "--prefix-cache"])
    assert "served 1 requests / 4 tokens" in out and "prefix-cache" in out


def test_legacy_quant_names_freeze_as_in_the_reference():
    """``--quant da8`` / ``da8-lut`` hand the engine ``da_bitplane`` /
    ``da_lut``; both packages resolve them to the same backend."""
    from repro.core.engine import canonical_mode as jcanon
    from repro_torch.core.engine import canonical_mode, get_backend

    for legacy in ("da_bitplane", "da_lut"):
        assert canonical_mode(legacy) == jcanon(legacy)
        get_backend(canonical_mode(legacy))


# ---------------------------------------------------------------------------
# serve_da
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [[], ["--spec", "bitplane", "--spec-gamma", "2"]])
def test_serve_da_prints_the_reference_lines(smoke_artifact, monkeypatch, capsys,
                                             extra):
    """The CI smoke's plain and spec legs.  (Its int8-page leg is held by the
    launcher's line test, which prints no tokens: on int8 pages a float32
    ulp between the packages can move one KV code across a rounding edge,
    and request 0 then leaves the reference's tokens at its token 7, a
    near-tie, ROADMAP Queue 3.)"""
    from repro_torch.examples import serve_da

    argv = ["--artifact", smoke_artifact, "--requests", "2", "--batch", "2"] + extra
    theirs = _reference(monkeypatch, capsys, _ref_example("serve_da"), argv)
    ours = _port(capsys, serve_da.main, argv)
    reqs = [line for line in _masked(ours) if line.startswith("  req ")]
    assert len(reqs) == 2
    assert reqs == [line for line in _masked(theirs) if line.startswith("  req ")]
    assert _masked(ours) == _masked(theirs)


@pytest.mark.parametrize("argv", [
    ["--save-artifact", "B", "--mode", "float"],
    ["--artifact", "A", "--save-artifact", "B"],
    ["--spec", "bitplane", "--mode", "float"],
])
def test_serve_da_conflicts_raise_in_both(monkeypatch, argv):
    from repro_torch.examples import serve_da

    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    with pytest.raises(SystemExit) as theirs:
        _ref_example("serve_da")()
    with pytest.raises(SystemExit) as ours:
        serve_da.main(argv + ["--device", "cpu"])
    assert str(ours.value) == str(theirs.value) and str(ours.value)


def test_serve_da_build_cfg_is_the_reference_model():
    from repro_torch.examples import serve_da

    ns = runpy.run_path("examples/serve_da.py")
    ref, ours = ns["build_cfg"](), serve_da.build_cfg()
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


# ---------------------------------------------------------------------------
# the DA examples
# ---------------------------------------------------------------------------
@pytest.fixture
def no_cost_tables():
    """Neither package reads a cost table: ``auto`` takes the heuristic in
    both (each package's own committed table would decide otherwise)."""
    from repro.core import engine as jengine
    from repro_torch.core import engine as tengine

    jengine.set_cost_table({})
    tengine.set_cost_table({})
    yield
    jengine.set_cost_table(None)
    tengine.set_cost_table(None)


@pytest.mark.parametrize("name", ["quickstart", "lenet_da_inference",
                                  "lenet_full_da"])
def test_da_examples_print_the_reference_lines(name, monkeypatch, capsys,
                                               no_cost_tables):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    theirs = _reference(monkeypatch, capsys, _ref_example(name), [])
    ours = _port(capsys, mod.main, [])
    assert ours.splitlines() == theirs.splitlines()
    assert "✓" in ours
    if name == "quickstart":
        verified = next(line for line in ours.splitlines() if "verified" in line
                        or "every eligible" in line)
        assert "pallas_bitplane" in verified and "pallas_lut" in verified


def test_core_reexports_the_reference_surface():
    import repro.core as jcore
    import repro_torch.core as tcore

    names = {n for n in dir(jcore) if not n.startswith("_")
             and not isinstance(getattr(jcore, n), type(jcore))}
    assert names == set(tcore.__all__)
    for n in names:
        assert getattr(tcore, n).__name__ == getattr(jcore, n).__name__, n
    with pytest.raises(AttributeError):
        tcore.no_such_name  # noqa: B018


# ---------------------------------------------------------------------------
# every entry point: a module with a main, the card by default
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_point_runs_as_a_module(module, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [module, "--help"])
    with pytest.raises(SystemExit) as ei:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    assert ei.value.code == 0 and "--device" in capsys.readouterr().out


@pytest.mark.parametrize("module,argv", [
    ("repro_torch.launch.serve", ["--arch", "qwen3-8b", "--smoke"]),
    ("repro_torch.launch.train", ["--arch", "qwen3-8b", "--smoke"]),
    ("repro_torch.examples.serve_da", []),
    ("repro_torch.examples.quickstart", []),
    ("repro_torch.examples.lenet_da_inference", []),
    ("repro_torch.examples.lenet_full_da", []),
    ("repro_torch.examples.train_lm", []),
])
def test_entry_point_defaults_to_the_card(module, argv):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="is_available"):
        importlib.import_module(module).main(argv)


def test_train_lm_example_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import train_lm

    d = str(tmp_path / "ck")
    out = _port(capsys, train_lm.main, ["--steps", "1", "--batch", "2",
                                        "--seq", "16", "--ckpt-dir", d])
    lines = out.splitlines()
    assert lines[0].startswith("model: qwen3-100m  params=")
    assert lines[1].startswith("step    0  loss ") and f"checkpoints in {d}" in out
    assert np.isfinite(float(lines[1].split()[3]))


def test_new_modules_lint_clean():
    import glob
    import os

    from repro_torch.analysis import lint

    root = lint.repo_root()
    paths = [p for d in ("launch", "examples", "train", "optim", "data")
             for p in glob.glob(os.path.join(root, "src", "repro_torch", d, "*.py"))]
    assert len(paths) >= 12
    assert lint.lint_paths(paths) == []


def test_auto_attention_read_by_shape():
    """``paged_attn="auto"`` is the kernel on CUDA, whatever the read's
    shape, and the gather read on the CPU: so the kernel is built for the
    head width of every attention config of the zoo and of its reduced form
    (the launcher's ``--smoke``), int4 pages from head width 32 on."""
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke
    from repro_torch.core.engine import select_attn_backend
    from repro_torch.kernels import paged_attention as pa

    assert select_attn_backend("auto", torch.device("cuda")) == "fused"
    assert select_attn_backend(None, torch.device("cuda")) == "fused"
    assert select_attn_backend("auto", torch.device("cpu")) == "gather"
    assert select_attn_backend("gather", torch.device("cuda")) == "gather"
    widths = {c.head_dim_ for cfg in ARCHS.values() if cfg.n_heads
              for c in (cfg, reduce_for_smoke(cfg))}
    assert widths == {16, 32, 64, 128}
    assert widths <= set(pa.HEAD_DIMS)
    assert pa._INT4_MIN_HD == 32
