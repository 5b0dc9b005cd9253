"""Scheduler layer: mean host ms a tick spends sampling, emitting and
charging each row after a device call (the host argmax over the vocab, the
clients' token callbacks), from the ``sample_s`` of the window's ``tick``
spans (traced run)."""
from bench.host_phases import mean_ms


def read(data):
    return mean_ms(data, "sample_s")
