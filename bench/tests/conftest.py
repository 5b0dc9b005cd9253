"""The benchmark's CPU tests: ``python -m pytest -q bench/tests`` from the
repository root.  Tests marked ``gpu`` need the card and skip without it
(decided inside the ``cuda`` fixture, never at import)."""
from __future__ import annotations

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "bench" / "tests"), str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark's card path")
    return torch.device("cuda")
