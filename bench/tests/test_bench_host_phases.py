"""The host-phase readers on a hand-built window: the program's tick
spans with and without their phase args, and a slice of labelled idle
gaps."""
from __future__ import annotations

import pytest

from bench.devtrace import Activity, Slice
from bench.readers import load_reader
from bench.serve import RunData

PHASE_METRICS = ("admit_ms", "pack_ms", "enqueue_ms", "fetch_ms", "sample_ms")
IDLE_METRICS = ("dispatch_idle_share", "sched_idle_share")

#: two ticks' args as the program writes them (seconds)
TICKS = [
    {"lanes": 4, "decode_lanes": 4, "admit_s": 0.001, "pack_s": 0.002,
     "enqueue_s": 0.100, "fetch_s": 0.030, "sample_s": 0.010},
    {"lanes": 4, "decode_lanes": 3, "admit_s": 0.003, "pack_s": 0.004,
     "enqueue_s": 0.200, "fetch_s": 0.050, "sample_s": 0.030},
]


def _slice() -> Slice:
    """A 2 s slice (µs clock), one kernel, and idle gaps under each kind
    of host label: 0.6 s of dispatch, 0.3 s of scheduler phases, 0.1 s
    of the harness."""
    gaps = [("paged_step[128x1]", 300e3), ("step.da_linear", 200e3),
            ("spec_verify[4x4]", 50e3), ("step.attention", 50e3),
            ("sched.sample", 200e3), ("sched.pack", 60e3), ("sched.fetch", 40e3),
            ("bench.tick", 80e3), ("harness (outside ticks)", 20e3)]
    return Slice(start=0.0, end=2e6, activities=[Activity("k", 0.0, 1e6, None)],
                 ops=[], gaps=gaps, ticks=12)


def _data(ticks, sl=None) -> RunData:
    return RunData(desc=None, mix={}, sent=[], t0=0.0, t1=1.0, window={},
                   tick_hist={"sum": 0.0, "count": 0}, tick_spans=ticks, slice=sl)


@pytest.mark.parametrize("name,want", [
    ("admit_ms", 2.0), ("pack_ms", 3.0), ("enqueue_ms", 150.0), ("fetch_ms", 40.0), ("sample_ms", 20.0),
    ("dispatch_idle_share", 30.0), ("sched_idle_share", 15.0)])
def test_readers_read_the_phases_and_labelled_gaps(name, want):
    assert load_reader(name)(_data(TICKS, _slice())) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", PHASE_METRICS + IDLE_METRICS)
def test_a_program_without_the_phase_args_reads_none(name):
    """A program whose tick spans lack the phase args (an older checkout)
    reads None, even with a slice whose gaps carry step labels."""
    bare = [{k: v for k, v in t.items() if not k.endswith("_s")} for t in TICKS]
    assert load_reader(name)(_data(bare, _slice())) is None
    assert load_reader(name)(_data([], _slice())) is None


@pytest.mark.parametrize("name", IDLE_METRICS)
def test_idle_shares_need_a_slice(name):
    assert load_reader(name)(_data(TICKS)) is None


def test_the_shares_stay_inside_the_device_idle_share():
    data = _data(TICKS, _slice())
    parts = sum(load_reader(n)(data) for n in IDLE_METRICS)
    assert parts <= load_reader("device_idle_share")(data)
