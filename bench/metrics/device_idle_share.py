"""Device: the share of the traced slice's wall time in which no device
activity ran (one less the union of kernels, memsets and copies over the
slice)."""


def read(data):
    sl = data.slice
    if sl is None or sl.wall_s <= 0 or not sl.activities:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.wall_s)
