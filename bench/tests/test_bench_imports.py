"""Nothing the benchmark loads is JAX or the JAX package: the check
compares top-level module names whole (``repro_torch`` is not
``repro``)."""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

from bench.run import FORBIDDEN, forbidden_modules

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("modules,found", [
    (["repro_torch", "repro_torch.serve.engine", "torch"], []),
    (["reproducible", "jaxtyping", "flaxen", "bench.reference"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.engine"], ["repro"]),
    (["jax._src.core", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
])
def test_top_level_names_compare_whole(modules, found):
    assert forbidden_modules(modules) == found


def test_forbidden_names():
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}


def test_a_run_loads_no_jax():
    """A fresh interpreter that imports everything a run imports (the
    harness, its readers and the port's serving path) holds none of the
    forbidden names."""
    code = f"""
import json, sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import bench.run as run
from bench import control, devtrace, manifest, reference, serve, traffic, weights, window
from bench.readers import load_reader
for m in manifest.load()["per_layer"]:
    load_reader(m["name"])
import repro_torch.serve.engine, repro_torch.core.freeze, repro_torch.kernels.build
print(json.dumps(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def forbidden_imports(bench: pathlib.Path):
    """``(path, line)`` of each import of a forbidden package in the
    sources under ``bench``, the test files themselves aside."""
    found = []
    for path in bench.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                if words[1].split(".")[0] in FORBIDDEN:
                    found.append((path, line))
    return found


def test_sources_import_nothing_forbidden():
    """No file of the benchmark names a forbidden package in an import."""
    assert forbidden_imports(ROOT / "bench") == []


def test_run_refuses_without_the_port(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a run
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "minitron-8b.chat-b128",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
