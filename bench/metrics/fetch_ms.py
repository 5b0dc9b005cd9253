"""Scheduler layer: mean host ms a tick waits on its device calls' results
(each ``.cpu()`` of the logits or tokens: the device's remaining work and
the copy), from the ``fetch_s`` of the window's ``tick`` spans (traced
run)."""
from bench.host_phases import mean_ms


def read(data):
    return mean_ms(data, "fetch_s")
