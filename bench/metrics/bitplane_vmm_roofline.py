"""DA linear: the 2-D bit-plane VMM entry's least time over its device
time in the traced slice.  Every call's bound comes from its recorded
input shapes (``bench.yardstick.vmm_bound_s``); the device time is every
kernel and memset the ``repro_torch::bitplane_vmm`` calls launched."""
from bench.readers import vmm_roofline


def read(data):
    return vmm_roofline(data, "repro_torch::bitplane_vmm")
