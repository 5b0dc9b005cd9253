"""The window's end-to-end arithmetic, on the harness's own clock.

Each request the clients sent carries its prompt length, its submit time
and the time of each of its tokens, stamped in the ``on_token`` callback.
The window is ``(t0, t1]``: it opens once every lane has emitted a token
and closes at the end of the first scheduler tick that ends past
``t0 + seconds``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional

import numpy as np


@dataclasses.dataclass
class Sent:
    """One request as its client sees it."""

    uid: int
    client: int
    prompt: np.ndarray
    max_new: int
    submit_t: float
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """numpy's linear-interpolated ``q``-th percentile, or None when empty."""
    v = list(values)
    return float(np.percentile(v, q)) if v else None


def window_metrics(sent: Iterable[Sent], t0: float, t1: float) -> Dict[str, float]:
    """``tokens_per_s``: every output token stamped in the window, plus each
    request's prompt tokens counted at its first token when that falls in
    the window, over the window's seconds.  ``itl_p95_ms``: 95th
    percentile of the gaps between consecutive tokens of one request, both
    in the window.  ``ttft_p90_ms``: 90th percentile of submit to first
    token over the requests whose first token is in the window.  Also the
    counts each rests on."""
    out_tokens = prompt_tokens = 0
    gaps: List[float] = []
    ttft: List[float] = []
    requests = 0
    for r in sent:
        inside = [t for t in r.times if t0 < t <= t1]
        if not inside:
            continue
        requests += 1
        out_tokens += len(inside)
        if t0 < r.times[0] <= t1:
            prompt_tokens += len(r.prompt)
            ttft.append(r.times[0] - r.submit_t)
        gaps.extend(b - a for a, b in zip(inside, inside[1:]))
    span = t1 - t0
    itl = percentile(gaps, 95)
    tt = percentile(ttft, 90)
    return {"tokens_per_s": (out_tokens + prompt_tokens) / span,
            "itl_p95_ms": None if itl is None else itl * 1e3,
            "ttft_p90_ms": None if tt is None else tt * 1e3,
            "window_s": span, "out_tokens": out_tokens,
            "prompt_tokens": prompt_tokens, "gaps": len(gaps),
            "first_tokens": len(ttft), "requests": requests}
