"""Scheduler layer: mean host ms a tick spends packing its device calls'
rows (tokens, positions, page tables and their copies to the device),
from the ``pack_s`` of the window's ``tick`` spans (traced run)."""
from bench.host_phases import mean_ms


def read(data):
    return mean_ms(data, "pack_s")
