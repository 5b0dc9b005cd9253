"""Scheduler layer: mean host ms of the admission that runs before each
tick (the queue's requests given lanes and pages, prefix lookups), from
the ``admit_s`` of the window's ``tick`` spans (traced run)."""
from bench.host_phases import mean_ms


def read(data):
    return mean_ms(data, "admit_s")
