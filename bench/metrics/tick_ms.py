"""Scheduler layer: mean wall ms of a tick over the window, from the
program's ``sched_tick_seconds`` histogram (its sum and count at the
window's close less those at its opening)."""


def read(data):
    h = data.tick_hist
    return h["sum"] / h["count"] * 1e3 if h["count"] else None
