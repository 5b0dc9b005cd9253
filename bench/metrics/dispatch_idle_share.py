"""Device: the share of the traced slice's wall time in which the device
idled while the host was inside a device call's enqueue (idle gaps labelled
``paged_step[``, ``spec_`` or ``step.``)."""
from bench.host_phases import DISPATCH, idle_share


def read(data):
    return idle_share(data, DISPATCH)
