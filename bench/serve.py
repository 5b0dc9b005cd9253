"""One run of one cell: set-up, the closed loop, the window, the traced
slice, and the correctness check against the plain reference.

The program under test is ``repro_torch``: its layer freeze
(``core.freeze.freeze_model``, pinned to the cell's DA mode) and its
``serve.engine.ServeEngine`` on the paged runtime, driven through
``submit`` / ``step``.  Everything else here is the benchmark's own.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import random
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench import devtrace
from bench.model import Model, ModelDesc, model_of
from bench.traffic import ClosedLoop
from bench.window import Sent, window_metrics

#: the traced slice: SLICE_TICKS scheduler ticks from the window's
#: SLICE_START-th tick on.  Every seed runs the same schedule of ticks, so
#: every traced run profiles the same ticks.
SLICE_START = 20
SLICE_TICKS = 12
#: served tokens the correctness sample holds at least (the longest
#: finished request always among them)
SAMPLE_TOKENS = 300


def program_config(config: Dict):
    """The port's ModelConfig of a configuration file: the registry's
    ``arch`` with the file's ``overrides``."""
    from repro_torch.configs.registry import get

    return dataclasses.replace(get(config["arch"]), **config.get("overrides", {}))


def _freezer(config: Dict, cfg, device):
    from repro_torch.core.da import DAConfig
    from repro_torch.core.freeze import freeze_model

    fz = config["freeze"]
    da = DAConfig(group_size=fz["group_size"], x_bits=fz["x_bits"], x_signed=True)

    def freeze(tree):
        return freeze_model(tree, da, mode=fz["mode"], model_cfg=cfg,
                            device=device).params

    return freeze


@dataclasses.dataclass
class RunData:
    """What the per-layer readers read."""

    desc: ModelDesc
    mix: Dict
    sent: List[Sent]
    t0: float
    t1: float
    window: Dict
    tick_hist: Dict                  # sched_tick_seconds: sum and count in the window
    tick_spans: List[Dict]           # the tracer's tick args, window ticks
    pool: Dict = dataclasses.field(default_factory=dict)   # pages, read each window tick
    slice: Optional[devtrace.Slice] = None
    attention_calls: List[List] = dataclasses.field(default_factory=list)


class _Clients:
    """The closed loop: each client sends its next request when its last
    one has emitted all its tokens."""

    def __init__(self, eng, loop: ClosedLoop, request_cls):
        self.eng, self.loop, self.request_cls = eng, loop, request_cls
        self.sent: List[Sent] = []
        self.by_uid: Dict[int, Sent] = {}
        self.live: Dict[int, int] = {}      # uid -> tokens its lane reserves
        self.next_k = [0] * loop.clients
        self.finished: List[int] = []
        self.tick = 0
        self.tick_of: Dict[int, List[int]] = {}

    def send(self, client: int) -> None:
        prompt, n_out = self.loop.request(client, self.next_k[client])
        self.next_k[client] += 1
        s = Sent(uid=len(self.sent), client=client, prompt=prompt, max_new=n_out,
                 submit_t=time.perf_counter())
        self.sent.append(s)
        self.by_uid[s.uid] = s
        self.live[s.uid] = len(prompt) + n_out
        self.tick_of[s.uid] = []
        self.eng.submit(self.request_cls(uid=s.uid, prompt=prompt, max_new_tokens=n_out,
                                         on_token=self._on_token))

    def _on_token(self, uid: int, tok: int) -> None:
        now = time.perf_counter()
        s = self.by_uid[uid]
        s.times.append(now)
        s.tokens.append(int(tok))
        self.tick_of[uid].append(self.tick)
        if s.done:
            self.finished.append(s.client)
            del self.live[uid]

    def step(self) -> None:
        self.eng.step()
        self.tick += 1
        done, self.finished = self.finished, []
        for c in done:
            self.send(c)

    def reserved_pages(self, page: int) -> int:
        """Pages the live requests reserve under ``reserve`` admission:
        each its prompt and all its output."""
        return sum(-(-n // page) for n in self.live.values())


def _pool_reading(samples: List[tuple], n_pages: int) -> Dict:
    """The pool's pages and, over the window's ticks, the mean and most
    in use (the program's ``kv_used_pages`` gauge) and reserved."""
    out = {"pages": n_pages}
    for i, key in enumerate(("used", "reserved")):
        vals = [x[i] for x in samples if x[i] is not None]
        if vals:
            out[f"{key}_mean"] = sum(vals) / len(vals)
            out[f"{key}_max"] = max(vals)
    return out


def run_cell(cell: Dict, config: Dict, mix: Dict, seed: int, seconds: float,
             trace: bool, device, t_start: float, limit: Optional[float],
             tamper=None) -> Dict:
    """One run on ``device``: returns the window's :class:`RunData` for the
    readers, the set-up seconds (and by phase), the memory peaks, and the
    compared number (the sample's widest logit gap) with its limit.
    ``tamper`` (tests only) is applied to the engine after set-up, a fault
    planted under the timed path."""
    from repro_torch.serve.engine import Request, ServeEngine

    dev = torch.device(device)
    model = model_of(config)
    desc = model.desc
    cfg = program_config(config)
    phases = {"import": time.perf_counter() - t_start}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        _sync(dev)
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    if dev.type == "cuda":
        from repro_torch.kernels.build import build_all

        build_all()
    phase("build")
    params = model.make_params(desc, seed, dev, _freezer(config, cfg, dev))
    phase("weights")
    sv = mix["serve"]
    eng = ServeEngine(cfg, params, batch_size=sv["batch_size"], max_len=sv["max_len"],
                      greedy=True, runtime="paged", page_size=sv["page_size"],
                      prefill_chunk=sv["prefill_chunk"], prefill_lanes=sv["prefill_lanes"],
                      token_budget=sv["token_budget"], admission=sv["admission"],
                      kv_dtype=sv["kv_dtype"], n_pages=sv.get("n_pages"), trace=trace,
                      device=dev)
    del params
    eng.warmup()
    phase("warmup")
    if tamper is not None:
        tamper(eng)
    tracer = eng.obs.tracer
    used = eng.obs.registry.get("kv_used_pages")
    n_pages = sv.get("n_pages") or sv["batch_size"] * -(-sv["max_len"] // sv["page_size"]) + 1
    loop = ClosedLoop(mix, seed, desc.vocab)
    clients = _Clients(eng, loop, Request)
    for c in range(loop.clients):
        clients.send(c)
    first = clients.sent[:loop.clients]
    while not all(s.times for s in first):
        clients.step()
    if tracer.enabled:
        tracer.drain()
    phase("fill")
    setup_peak = _peak(dev)
    _reset_peak(dev)
    hist0 = _tick_hist(eng)
    t0 = time.perf_counter()
    tick_spans: List[Dict] = []
    attention_calls: List[List] = []
    prof, slice_ticks = None, 0    # the profiler, and the ticks it has traced
    tick0 = clients.tick
    pool_samples: List[tuple] = []
    while True:
        if trace and prof is None and clients.tick - tick0 >= SLICE_START:
            prof = _start_profiler()
        profiling = prof is not None and slice_ticks < SLICE_TICKS
        if profiling:
            with torch.profiler.record_function(devtrace.TICK):
                clients.step()
            slice_ticks += 1
        else:
            clients.step()
        pool_samples.append((used.value() if used is not None else None,
                             clients.reserved_pages(sv["page_size"])))
        if tracer.enabled:
            events = tracer.drain()
            tick_spans += [e.args for e in events if e.name == "tick" and e.ph == "X"]
            if profiling:
                attention_calls += _attention_calls(events, clients, desc)
        if profiling and slice_ticks == SLICE_TICKS:
            prof.stop()
        if time.perf_counter() >= t0 + seconds:
            break
    _sync(dev)
    t1 = time.perf_counter()
    window_peak = _peak(dev)
    hist1 = _tick_hist(eng)
    if prof is not None and slice_ticks < SLICE_TICKS:   # the window closed mid-slice
        prof.stop()
    sl = _reduce(prof) if prof is not None else None
    data = RunData(desc=desc, mix=mix, sent=clients.sent, t0=t0, t1=t1,
                   window=window_metrics(clients.sent, t0, t1),
                   tick_hist={"sum": hist1["sum"] - hist0["sum"],
                              "count": hist1["count"] - hist0["count"]},
                   tick_spans=tick_spans, pool=_pool_reading(pool_samples, n_pages),
                   slice=sl, attention_calls=attention_calls)
    sample = _sample(clients.sent, t0, t1, seed)
    del eng, clients, prof
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    gap = served_gap(model, seed, sample, dev)
    return {"data": data, "setup_s": t0 - t_start,
            "memory_peak_bytes": max(setup_peak, window_peak),
            "window_peak_bytes": window_peak, "gap": gap, "limit": limit,
            "correct": limit is not None and gap <= limit,
            "attempted": data.window["requests"], "sample": sample,
            "setup_phases": phases, "check_s": time.perf_counter() - t_check}


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=True)
    prof.start()
    return prof


def _reduce(prof) -> devtrace.Slice:
    """The slice of a stopped profiler, through its Chrome trace (written
    under ``TMPDIR`` and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return devtrace.reduce_trace(devtrace.load_trace(path))
    finally:
        os.unlink(path)


def _attention_calls(events, clients: _Clients, desc: ModelDesc) -> List[List]:
    """The attention reads of the tick just run, each a list of rows
    ``(t, ctx)``: the prefill call's rows from the tracer's
    ``prefill_chunk`` spans, the decode call's from the tokens the
    clients got this tick that were not a request's first."""
    calls = []
    rows = [(e.args["tokens"], e.args["pos"] + e.args["tokens"])
            for e in events if e.name == "prefill_chunk"]
    if rows:
        calls.append(rows)
    tick = clients.tick - 1
    rows = []
    for uid, ticks in clients.tick_of.items():
        if ticks and ticks[-1] == tick and len(ticks) > 1:
            rows.append((1, len(clients.by_uid[uid].prompt) + len(ticks) - 1))
    if rows:
        calls.append(rows)
    return calls


def _sample(sent: List[Sent], t0: float, t1: float, seed: int) -> List[Sent]:
    """The requests the check compares: the longest of those that finished
    in the window, then others of them drawn from the seed until
    ``SAMPLE_TOKENS`` served tokens (with none finished, those with a
    token in the window, their tokens so far)."""
    pool = [s for s in sent if s.done and t0 < s.times[-1] <= t1]
    if not pool:
        pool = [s for s in sent if any(t0 < t <= t1 for t in s.times)]
    pool.sort(key=lambda s: (-len(s.tokens), s.uid))
    picked, rest = pool[:1], pool[1:]
    random.Random(seed).shuffle(rest)
    for s in rest:
        if sum(len(p.tokens) for p in picked) >= SAMPLE_TOKENS:
            break
        picked.append(s)
    return picked


def served_gap(model: Model, seed: int, sample: List[Sent], device) -> float:
    """The widest gap by which a served token's reference logit (``model``'s
    plain reference) lies below the reference's best at its position, over
    the sample."""
    seqs = [list(s.prompt) + s.tokens[:-1] for s in sample]
    starts = [len(s.prompt) - 1 for s in sample]
    if not sample:
        return float("inf")
    worst = 0.0
    for i, logits in model.logits_at(model.desc, seed, seqs, starts, device):
        served = torch.tensor(sample[i].tokens, device=logits.device)
        gaps = logits.max(-1).values - logits.gather(1, served[:, None])[:, 0]
        worst = max(worst, float(gaps.max()))
    return worst


def _tick_hist(eng) -> Dict[str, float]:
    h = eng.metrics_snapshot().get("sched_tick_seconds", {})
    return {"sum": float(h.get("sum", 0.0)), "count": int(h.get("count", 0))}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated()) if dev.type == "cuda" else 0


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
