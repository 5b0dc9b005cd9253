"""The closed-loop generator: the same seed gives the same inputs, every
seed the same sizes in the same order."""
from __future__ import annotations

import numpy as np
import pytest

from bench.manifest import BENCH
from bench.model import load_json
from bench.traffic import ClosedLoop, _quantiles

MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))


def _requests(loop, n=3):
    return [loop.request(c, k) for c in range(loop.clients) for k in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_same_seed_same_inputs(mix):
    m = load_json(BENCH / "traffic" / f"{mix}.json")
    a, b = ClosedLoop(m, 2**31 + 11, 1000), ClosedLoop(m, 2**31 + 11, 1000)
    for (pa, oa), (pb, ob) in zip(_requests(a), _requests(b)):
        assert oa == ob and np.array_equal(pa, pb)


@pytest.mark.parametrize("mix", MIXES)
def test_other_seed_same_sizes_other_tokens(mix):
    m = load_json(BENCH / "traffic" / f"{mix}.json")
    a, b = ClosedLoop(m, 1, 1000), ClosedLoop(m, 2**31 + 12, 1000)
    ra, rb = _requests(a), _requests(b)
    assert [(len(p), o) for p, o in ra] == [(len(p), o) for p, o in rb]
    assert any(not np.array_equal(pa, pb) for (pa, _), (pb, _) in zip(ra, rb))


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_within_the_mix(mix):
    m = load_json(BENCH / "traffic" / f"{mix}.json")
    loop = ClosedLoop(m, 5, 1000)
    sv = m["serve"]
    for p, o in _requests(loop, 4):
        assert m["prompt_tokens"]["min"] <= len(p) <= m["prompt_tokens"]["max"]
        assert 1 <= o <= m["output_tokens"]["max"]
        assert p.min() >= 0 and p.max() < 1000
    assert m["prompt_tokens"]["max"] + m["output_tokens"]["max"] <= sv["max_len"]


@pytest.mark.parametrize("mix", MIXES)
def test_means_are_the_sources(mix):
    """Every mix names a public source of its lengths, and its requests'
    mean prompt and output lengths are that source's, within 1 %."""
    m = load_json(BENCH / "traffic" / f"{mix}.json")
    assert 1 <= len(m["source"]) <= 200 and "arXiv" in m["source"]
    n = m["sizes"]
    for key, want in m["source_means"].items():
        got = _quantiles(m[f"{key}_tokens"], n).mean()
        assert got == pytest.approx(want, rel=0.01), (key, got, want)


@pytest.mark.parametrize("mix", MIXES)
def test_pool_holds_what_the_lanes_reserve(mix):
    """The pool (``n_pages``) holds every lane's reservation of the
    longest request, or the largest sum of reservations the loop makes
    (measured, ``reserved_max`` in ``PERF.md``), with the garbage page."""
    m = load_json(BENCH / "traffic" / f"{mix}.json")
    sv = m["serve"]
    longest = -(-(m["prompt_tokens"]["max"] + m["output_tokens"]["max"]) // sv["page_size"])
    mean = sum(m["source_means"].values()) / sv["page_size"]
    if sv.get("n_pages") is not None:
        assert longest + 1 < sv["n_pages"]
        assert sv["n_pages"] > sv["batch_size"] * mean + 1


def test_first_requests_take_a_residual_share():
    m = load_json(BENCH / "traffic" / "chat-b128.json")
    loop = ClosedLoop(m, 3, 1000)
    firsts = [loop.request(c, 0)[1] for c in range(loop.clients)]
    assert min(firsts) < m["output_tokens"]["min"]           # some finish early
    assert sorted(loop.first_share) == pytest.approx((np.arange(loop.clients) + 0.5) / loop.clients)


def test_quantiles_follow_the_distribution():
    lo = _quantiles({"dist": "lognormal", "median": 96, "sigma": 0.8, "min": 16, "max": 384}, 4001)
    assert np.median(lo) == 96 and lo.min() >= 16 and lo.max() <= 384
    un = _quantiles({"dist": "uniform", "min": 8, "max": 32}, 1000)
    assert un.min() == 8 and un.max() == 32 and abs(un.mean() - 20) < 0.1
