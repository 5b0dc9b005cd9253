"""Scheduler layer: the mean share of the batch's lanes that decode in a
tick, from the ``decode_lanes`` of the program's ``tick`` spans over the
window's ticks (traced run)."""


def read(data):
    lanes = [a["decode_lanes"] for a in data.tick_spans if a and "decode_lanes" in a]
    if not lanes:
        return None
    return 100.0 * sum(lanes) / len(lanes) / data.mix["serve"]["batch_size"]
