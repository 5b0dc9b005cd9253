"""The program's host phases of a scheduler tick, and the device's idle
time by the host annotation it fell in, for the per-layer readers.

A traced tick's ``tick`` span carries the seconds of its host phases
(``repro_torch.obs.trace.TICK_PHASES``, named here again: the readers run
against any checkout of the program); a program whose spans lack them
reads None.  The program annotates each phase (``sched.<phase>``) and each
device call (``paged_step[WxT]``, ``spec_*[WxT]``: the enqueue), so
``bench.devtrace`` labels the idle gaps of the slice by the innermost."""
from __future__ import annotations

from typing import Optional, Tuple

#: the tick span's phase args, seconds summed over the tick's device calls
PHASES = ("admit_s", "pack_s", "enqueue_s", "fetch_s", "sample_s")
#: idle labels of the host inside a device call: its enqueue (``step.``:
#: dispatch regions inside a call, which a program may annotate)
DISPATCH = ("paged_step[", "spec_", "step.")
#: idle labels of the scheduler's host phases around the device calls
SCHED = ("sched.",)


def phase_spans(data) -> list:
    """The window's tick args that carry every phase."""
    return [a for a in data.tick_spans if a and all(k in a for k in PHASES)]


def mean_ms(data, key: str) -> Optional[float]:
    """Mean ms of phase ``key`` a tick over the window."""
    spans = phase_spans(data)
    if not spans:
        return None
    return 1e3 * sum(a[key] for a in spans) / len(spans)


def idle_share(data, prefixes: Tuple[str, ...]) -> Optional[float]:
    """The slice's idle time under a host label starting with one of
    ``prefixes``, over the slice's wall, in %."""
    sl = data.slice
    if sl is None or sl.wall_s <= 0 or not sl.activities or not phase_spans(data):
        return None
    idle_us = sum(us for label, us in sl.gaps if label.startswith(prefixes))
    return 100.0 * idle_us / 1e6 / sl.wall_s
