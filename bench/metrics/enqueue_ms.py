"""Model step: mean host ms a tick spends enqueueing its device calls (the
program's ``paged_step[WxT]`` / ``spec_*`` annotations), from the
``enqueue_s`` of the window's ``tick`` spans (traced run)."""
from bench.host_phases import mean_ms


def read(data):
    return mean_ms(data, "enqueue_s")
