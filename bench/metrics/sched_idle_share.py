"""Device: the share of the traced slice's wall time in which the device
idled while the host was in a scheduler phase around the device calls
(idle gaps labelled ``sched.``: admission, row packing, the results'
fetch, sampling)."""
from bench.host_phases import SCHED, idle_share


def read(data):
    return idle_share(data, SCHED)
