"""The one traffic generator: a closed loop of clients, read from a mix
file ``bench/traffic/<mix>.json``.

Every run does the same work, whatever its seed: ``sizes`` (prompt,
output) pairs at evenly spaced quantiles of the mix's two length
distributions, paired by a fixed shuffle into one list, which client c
walks from entry ``c · sizes / clients`` on (its k-th request is the
entry k further, the list read as a ring).  A client's first request asks
for a share u_c ∈ (0, 1) of its drawn output (``first_output:
"residual"``), the shares evenly spaced and dealt by a fixed shuffle, so
the lanes finish out of step from the start.  The clients send their
first requests in client order.  The seed draws every prompt's token ids:
it changes what the model reads and writes, not how much.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

import numpy as np

#: fixed seed of the pairing and dealing shuffles: the sizes and their
#: order are the same for every run
_FIXED = 20240917


def _quantiles(spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of ``spec``: a
    lognormal (``median``, ``sigma``) or uniform distribution, rounded
    and clipped to [``min``, ``max``]."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "lognormal":
        nd = statistics.NormalDist()
        z = np.array([nd.inv_cdf(x) for x in q])
        v = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        v = lo + q * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


class ClosedLoop:
    """The requests of a closed-loop mix for one seed."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        if mix["loop"] != "closed":
            raise ValueError(f"mix loop {mix['loop']!r}: only 'closed' is generated")
        self.clients = mix["clients"]
        self.vocab = vocab
        self.seed = int(seed)
        n = mix["sizes"]
        fixed = np.random.default_rng(_FIXED)
        prompts = _quantiles(mix["prompt_tokens"], n)[fixed.permutation(n)]
        outputs = _quantiles(mix["output_tokens"], n)[fixed.permutation(n)]
        self.pairs = np.stack([prompts, outputs], axis=1)
        self.stride = n // self.clients
        share = (np.arange(self.clients) + 0.5) / self.clients
        self.first_share = share[fixed.permutation(self.clients)]
        self.residual = mix.get("first_output") == "residual"

    def request(self, client: int, k: int) -> Tuple[np.ndarray, int]:
        """(prompt token ids, output tokens) of client ``client``'s
        ``k``-th request."""
        p, o = self.pairs[(client * self.stride + k) % len(self.pairs)]
        if k == 0 and self.residual:
            o = max(1, int(math.ceil(self.first_share[client] * o)))
        rng = np.random.default_rng([self.seed, client, k])
        return rng.integers(0, self.vocab, size=int(p), dtype=np.int32), int(o)
