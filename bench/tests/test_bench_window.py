"""The window's arithmetic on synthetic timestamps."""
from __future__ import annotations

import numpy as np
import pytest

from bench.window import Sent, window_metrics


def _loop(lanes=20, ticks=300, length=10, prompt=8, tick=0.1, stall=0.0, every=5):
    """A closed loop stamped tick by tick: each lane's request is submitted
    at the end of the tick its last one finished and emits one token a
    tick from the next tick on, ``length`` tokens; every ``every``-th tick
    lasts ``stall`` seconds longer."""
    ends, t = [], 0.0
    for k in range(ticks):
        t += tick + (stall if k % every == every - 1 else 0.0)
        ends.append(t)
    sent = []
    for lane in range(lanes):
        k = lane % length          # lanes out of step
        while k + length <= ticks:
            r = Sent(uid=len(sent), client=lane, prompt=np.zeros(prompt, np.int32),
                     max_new=length, submit_t=ends[k - 1] if k else 0.0)
            r.times = ends[k:k + length]
            r.tokens = [0] * length
            sent.append(r)
            k += length
    return sent, ends


def test_steady_stream():
    sent, ends = _loop()
    m = window_metrics(sent, ends[49], ends[249])
    assert m["window_s"] == pytest.approx(20.0)
    assert m["itl_p95_ms"] == pytest.approx(100.0)
    assert m["ttft_p90_ms"] == pytest.approx(100.0)
    assert m["out_tokens"] == 20 * 200
    # every lane starts 20 requests in the window, each counting its prompt
    assert m["first_tokens"] == 20 * 20
    assert m["tokens_per_s"] == pytest.approx((4000 + 400 * 8) / 20.0)


def test_a_stall_inside_the_window_moves_the_rate_and_both_tails():
    sent, ends = _loop()
    base = window_metrics(sent, ends[49], ends[249])
    sent, ends = _loop(stall=0.2)
    hit = window_metrics(sent, ends[49], ends[249])
    assert hit["tokens_per_s"] < base["tokens_per_s"]
    assert hit["itl_p95_ms"] == pytest.approx(300.0)      # one gap in five
    assert hit["ttft_p90_ms"] == pytest.approx(300.0)     # one first token in five


def test_ttft_and_gaps_count_inside_the_window_only():
    r1 = Sent(0, 0, np.zeros(5, np.int32), 2, submit_t=0.0, times=[1.0, 2.0], tokens=[1, 2])
    r2 = Sent(1, 1, np.zeros(7, np.int32), 2, submit_t=3.0, times=[9.0, 10.0], tokens=[1, 2])
    m = window_metrics([r1, r2], 1.5, 10.0)
    assert m["first_tokens"] == 1 and m["ttft_p90_ms"] == pytest.approx(6000.0)
    assert m["prompt_tokens"] == 7 and m["out_tokens"] == 3
    assert m["gaps"] == 1 and m["itl_p95_ms"] == pytest.approx(1000.0)
    assert m["requests"] == 2
