"""Model step: the window's model operations over the int8 peak.

Each token counted in ``tokens_per_s`` runs the model once: a prompt
token at its position when its request's first token falls in the
window, an output token (past the first) as the decode of the one before
it.  Each costs 2 × the body's matrix parameters (the experts ``top_k``
times) and attention's 4·ctx·H·hd in every layer; each sampled token adds
the LM head once (``bench.yardstick``).  Every weight product runs on
int8 codes, so the peak is the int8 one."""
from bench import yardstick


def read(data):
    d = data.desc
    counted = sampled = ctx = 0
    for r in data.sent:
        inside = [i for i, t in enumerate(r.times) if data.t0 < t <= data.t1]
        if not inside:
            continue
        p = len(r.prompt)
        for i in inside:
            sampled += 1
            if i == 0:
                counted += p
                ctx += p * (p + 1) // 2
            else:
                counted += 1
                ctx += p + i
    if not counted:
        return None
    ops = yardstick.window_ops(d, counted, ctx, sampled)
    return 100.0 * ops / (data.window["window_s"] * yardstick.INT8_PEAK)
