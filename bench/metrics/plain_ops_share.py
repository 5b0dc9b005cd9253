"""Plain torch ops: the share of device time in the traced slice spent in
work that none of the port's kernel entries (``repro_torch::`` ops)
launched: quantize and dequantize, norms, RoPE, K/V writes, routing and
dispatch, copies."""


def read(data):
    sl = data.slice
    if sl is None:
        return None
    total = sl.time_s()
    return 100.0 * sl.time_s(op="") / total if total > 0 else None
