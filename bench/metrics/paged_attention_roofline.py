"""Attention kernel: the paged-attention reads' least time over their
device time in the traced slice.  Each read's rows are ``(t, ctx)`` as
the harness saw the tick (a prefill chunk's tokens and the context they
reach; a decode row's context), and every layer reads them once
(``bench.yardstick.attention_bound_s``)."""
from bench import yardstick

OP = "repro_torch::paged_attention"


def read(data):
    sl = data.slice
    if sl is None or not data.attention_calls:
        return None
    spent = sl.time_s(op=OP)
    if spent <= 0:
        return None
    d = data.desc
    bound = d.n_layers * sum(
        yardstick.attention_bound_s(rows, d.n_heads, d.n_kv_heads, d.head_dim)
        for rows in data.attention_calls)
    return 100.0 * bound / spent
