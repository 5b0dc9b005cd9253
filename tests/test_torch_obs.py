"""PyTorch port vs the JAX reference: the observability layer.

The port's registry, trace recorder, exporters, validators, check CLI and
regression gate are the reference's framework-free code, copied; their
units run here against the port's copy (and, where a result can differ,
against the reference's in the same test).  Then both packages serve the
same frozen weights (the reference's ``bitplane_stacked`` freeze of
``reduce_for_smoke(qwen3-8b)``, carried across by ``params_from_jax``) on
the CPU with the recorder on, greedy and with a truncated-bitplane spec
draft, and must agree on:

* the tokens;
* every counter and gauge series of ``metrics_snapshot()``, and the
  observation count of every histogram (their sums are wall-clock);
* ``metrics()["hw"]`` within 1e-9 relative;
* the trace's sequence of (name, track, phase, args), times left out and
  the ``est_pj`` args within 1e-9 relative.

Both packages' ``obs.check`` accept the port's exported trace, Prometheus
text and ``hw`` payload.  ``device_span`` puts each device step inside a
``torch.profiler`` annotation, checked here on the CPU (on the card in
``tests/test_torch_gpu.py``).
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core.da import DAConfig as JDA
from repro.core.freeze import freeze_model as jfreeze
from repro.models.model import init_model as jinit
from repro.obs import check as jcheck
from repro.obs import regress as jregress
from repro.obs.metrics import Histogram as JHistogram
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.spec import SpecConfig as JSpec
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.obs import (
    METRICS_SCHEMA_VERSION,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Observability,
    TraceRecorder,
    chrome_trace,
    device_span,
    prometheus_text,
    validate_chrome_trace,
    validate_prometheus_text,
)
from repro_torch.obs import check as tcheck
from repro_torch.obs import regress as tregress
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.spec import SpecConfig

MAX_NEW = 4
KW = dict(batch_size=2, max_len=32, page_size=8)
SPEC = dict(provider="bitplane", gamma=2, draft_x_bits=4, disable_below=0.0)
REL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's CPU ops
    in each take one thread (restored after the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# instruments / registry (the reference's test_obs.py units, on the copy)
# ---------------------------------------------------------------------------
def test_counter_labels_and_total():
    reg = MetricsRegistry()
    c = reg.counter("toks", "tokens emitted")
    c.inc()
    c.inc(3, backend="fused")
    c.inc(2, backend="gather")
    assert (c.value(), c.value(backend="fused"), c.total) == (1, 3, 6)
    assert reg.counter("toks") is c  # get-or-create
    with pytest.raises(ValueError):
        reg.gauge("toks")  # a kind conflict is an error


def test_gauge_last_write_wins():
    g = MetricsRegistry().gauge("lanes")
    g.set(3)
    g.set(1)
    assert g.value() == 1.0


def test_histogram_streaming_percentiles():
    h = MetricsRegistry().histogram("lat", buckets=(0.001, 0.01, 0.1, 1.0))
    for v in [0.0005] * 50 + [0.05] * 50:
        h.observe(v)
    assert h.count() == 100
    assert h.sum() == pytest.approx(50 * 0.0005 + 50 * 0.05)
    assert h.percentile(25) <= 0.001
    assert 0.01 <= h.percentile(75) <= 0.1
    h.observe(50.0)  # out of range: the +Inf bin, not a crash
    assert h.count() == 101 and h.percentile(100) > 1.0


def test_snapshot_schema_and_determinism():
    reg = MetricsRegistry()
    reg.counter("b").inc(2)
    reg.counter("a").inc(1, mode="x")
    reg.histogram("h").observe(0.01)
    snap = reg.snapshot()
    assert snap["metrics_schema_version"] == METRICS_SCHEMA_VERSION == 2
    assert snap["b"] == 2 and snap["a{mode=x}"] == 1
    assert snap["h"]["count"] == 1
    assert list(snap) == list(reg.snapshot())


def test_disabled_registry_short_circuits():
    reg = MetricsRegistry(enabled=False)
    c, g, h = reg.counter("c"), reg.gauge("g"), reg.histogram("h")
    c.inc(5)
    g.set(2)
    h.observe(0.1)
    assert c.total == 0 and g.value() == 0 and h.count() == 0
    assert isinstance(c, Counter) and isinstance(g, Gauge) \
        and isinstance(h, Histogram)
    assert reg.snapshot() == {"metrics_schema_version": METRICS_SCHEMA_VERSION}


def test_observability_bundle_defaults():
    obs = Observability.make()
    assert obs.registry.enabled and not obs.tracer.enabled
    assert Observability.make(trace=True).tracer.enabled
    assert not Observability.make(metrics=False).registry.enabled


# ---------------------------------------------------------------------------
# trace recorder
# ---------------------------------------------------------------------------
def test_span_balance_survives_ring_wraparound():
    tr = TraceRecorder(capacity=8)
    for i in range(20):  # 40 events through an 8-slot ring
        with tr.span("work", f"req:{i % 3}"):
            pass
    assert (len(tr), tr.dropped, tr.span_balance()) == (8, 32, {})
    tr.begin("open", "req:9")
    assert tr.span_balance() == {"req:9": 1}


def test_span_closes_on_exception():
    tr = TraceRecorder()
    with pytest.raises(RuntimeError):
        with tr.span("work", "t"):
            raise RuntimeError("body failed")
    assert tr.span_balance() == {}


def test_disabled_tracer_records_nothing():
    tr = TraceRecorder(enabled=False)
    tr.begin("a", "t")
    tr.instant("b", "t")
    tr.end("a", "t")
    assert len(tr) == 0 and tr.span_balance() == {}


def _annotations(fn):
    """Names of the ``torch.profiler`` user annotations ``fn`` opened."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("enabled", [True, False])
def test_device_span_annotates_the_profiler(enabled):
    """On: a ``record_function`` range of the span's name around the body;
    off: nothing (the body still runs)."""
    ran = []

    def body():
        with device_span("paged_step[4x1]", enabled):
            ran.append(torch.ones(3).sum().item())

    names = _annotations(body)
    assert ran == [3.0]
    assert ("paged_step[4x1]" in names) == enabled


# ---------------------------------------------------------------------------
# exporters, validators and the check CLI
# ---------------------------------------------------------------------------
def _sample_recorder():
    tr = TraceRecorder()
    tr.instant("submit", "req:0", ts=1.0)
    tr.begin("running", "req:0", ts=1.5)
    tr.complete("tick", "scheduler", 1.4, 0.3, lanes=1)
    tr.instant("token", "req:0", ts=2.0, n=1)
    tr.end("running", "req:0", ts=2.5)
    return tr


def test_chrome_trace_export_is_valid_and_complete():
    obj = chrome_trace(_sample_recorder())
    assert validate_chrome_trace(obj) == []
    evs = obj["traceEvents"]
    names = {(e["ph"], e["name"]) for e in evs}
    assert ("i", "submit") in names and ("X", "tick") in names
    meta = {e["args"]["name"] for e in evs
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"req:0", "scheduler"} <= meta
    submit = next(e for e in evs if e["name"] == "submit")
    assert submit["ts"] == pytest.approx(1.0e6)
    assert obj["otherData"]["metrics_schema_version"] == METRICS_SCHEMA_VERSION


def test_validators_catch_imbalance_and_garbage():
    tr = TraceRecorder()
    tr.begin("running", "req:0")  # B without E
    errs = validate_chrome_trace(chrome_trace(tr))
    assert errs and any("balance" in e or "unclosed" in e for e in errs)
    assert validate_prometheus_text("not a metric line at all!") != []
    bad = '# TYPE h histogram\nh_bucket{le="+Inf"} 1\nh_sum 0.5\n'
    assert validate_prometheus_text(bad) != []  # no _count


def test_prometheus_export_is_valid():
    reg = MetricsRegistry()
    reg.counter("sched_out_tokens", "tokens").inc(12)
    reg.gauge("kv_used_pages").set(3)
    h = reg.histogram("req_ttft_seconds", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(5.0)
    text = prometheus_text(reg)
    assert validate_prometheus_text(text) == []
    lines = text.splitlines()
    for want in ("# TYPE sched_out_tokens counter", "sched_out_tokens 12",
                 'req_ttft_seconds_bucket{le="0.1"} 1',
                 'req_ttft_seconds_bucket{le="+Inf"} 2',
                 "req_ttft_seconds_count 2"):
        assert want in lines


@pytest.mark.parametrize("check", [tcheck, jcheck], ids=["port", "ref"])
def test_check_cli_accepts_valid_rejects_invalid(tmp_path, capsys, check):
    """Both packages' CLIs, same exit codes, on the port's exports."""
    good_trace = tmp_path / "trace.json"
    good_trace.write_text(json.dumps(chrome_trace(_sample_recorder())))
    reg = MetricsRegistry()
    reg.counter("c").inc()
    good_prom = tmp_path / "metrics.prom"
    good_prom.write_text(prometheus_text(reg))
    assert check.main([str(good_trace), str(good_prom)]) == 0
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "B"}]}))
    assert check.main([str(bad)]) == 1
    other = tmp_path / "other.json"
    other.write_text(json.dumps({"neither": 1}))
    assert check.main([str(other)]) == 1
    assert check.main([]) == 2


# ---------------------------------------------------------------------------
# the regression gate (the reference's test_regress.py, both CLIs)
# ---------------------------------------------------------------------------
def _payload(**kw):
    base = {"metrics_schema_version": 1, "regress_keys": ["hw.energy_pj"],
            "hw": {"energy_pj": 100.0}}
    base.update(kw)
    return base


def _no_keys():
    p = _payload()
    del p["regress_keys"]
    return p


#: (fresh payload or raw text, committed payload, extra args, exit code)
REGRESS_CASES = {
    "clean": (_payload(), _payload(), [], 0),
    "no_regress_keys": (_payload(), _no_keys(), [], 2),
    "no_regress_keys_but_key_arg": (_payload(), _no_keys(),
                                    ["--key", "hw.energy_pj"], 0),
    "regress_keys_not_a_list": (_payload(),
                                _payload(regress_keys="hw.energy_pj"), [], 2),
    "nan": (_payload(hw={"energy_pj": math.nan}), _payload(), [], 1),
    "schema_skew": (_payload(metrics_schema_version=2), _payload(), [], 1),
    "unstamped": ({"hw": {"energy_pj": 100.0}}, _payload(), [], 2),
    "truncated_json": ('{"metrics_schema_version": 1, "hw": {', _payload(),
                       [], 2),
    "missing_key_in_fresh": (_payload(hw={}), _payload(), [], 1),
    "drift_outside_band": (_payload(hw={"energy_pj": 200.0}), _payload(), [],
                           1),
}


@pytest.mark.parametrize("case", list(REGRESS_CASES))
def test_regress_cli_exit_codes_match_the_reference(tmp_path, case):
    fresh, committed, extra, rc = REGRESS_CASES[case]
    f, c = tmp_path / "fresh.json", tmp_path / "committed.json"
    f.write_text(fresh if isinstance(fresh, str) else json.dumps(fresh))
    c.write_text(json.dumps(committed))
    args = [str(f), str(c), *extra]
    assert tregress.main(args) == rc
    assert jregress.main(args) == rc


@pytest.mark.parametrize("fresh,committed,needle", [
    (_payload(hw={"energy_pj": math.nan}), _payload(), "non-finite"),
    (_payload(), _payload(hw={"energy_pj": math.nan}), "non-finite"),
    (_payload(hw={"energy_pj": math.inf}), _payload(), "non-finite"),
    (_payload(metrics_schema_version=2), _payload(),
     "schema version mismatch")])
def test_regress_compare_names_the_fault(fresh, committed, needle):
    errs = tregress.compare(fresh, committed, ["hw.energy_pj"], 0.25)
    assert len(errs) == 1 and needle in errs[0]
    assert errs == jregress.compare(fresh, committed, ["hw.energy_pj"], 0.25)


# ---------------------------------------------------------------------------
# serving: the port against the reference, the recorder on
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]),
                               moe_dropless=True)
    tcfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    art = jfreeze(jinit(jax.random.key(0), jcfg), JDA(x_signed=True),
                  mode="bitplane_stacked", model_cfg=jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, art.params))
    rng = np.random.default_rng(7)
    prompts = {u: rng.integers(0, jcfg.vocab, 3 + u).astype(np.int32)
               for u in range(4)}
    return jcfg, tcfg, art, tparams, prompts


def _serve(eng, prompts, request_cls, new=MAX_NEW):
    for u, p in prompts.items():
        eng.submit(request_cls(uid=u, prompt=p, max_new_tokens=new))
    done = eng.run()
    return {u: list(r.generated) for u, r in done.items()}


def _ours(setup, spec=None, **kw):
    _, tcfg, _, tparams, prompts = setup
    eng = ServeEngine(tcfg, tparams, spec=SpecConfig(**spec) if spec else None,
                      device="cpu", **{**KW, **kw})
    return eng, _serve(eng, prompts, Request)


_SERVED: dict = {}


def _pair(setup, spec):
    """Both packages' traced serves of the fixture's prompts (once each per
    module): (ours, our tokens), (ref, its tokens)."""
    key = repr(spec)
    if key not in _SERVED:
        jcfg, _, art, _, prompts = setup
        ref = JServeEngine(jcfg, art.params, trace=True,
                           spec=JSpec(**spec) if spec else None, **KW)
        _SERVED[key] = (_ours(setup, spec, trace=True),
                        (ref, _serve(ref, prompts, JRequest)))
    return _SERVED[key]


def _close(a, b, path=""):
    """Nested equality, floats within REL relative."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=REL, abs=0.0), path
    else:
        assert a == b, path


def _series(snap):
    """Counter and gauge series exactly; each histogram by its count."""
    return {k: (v["count"] if isinstance(v, dict) else v)
            for k, v in snap.items()}


def _events(tracer):
    return [(e.name, e.track, e.ph,
             {k: v for k, v in (e.args or {}).items()}) for e in tracer.events]


@pytest.mark.parametrize("spec", [None, SPEC], ids=["greedy", "spec"])
def test_serve_matches_the_reference(setup, spec):
    (ours, toks), (ref, jtoks) = _pair(setup, spec)
    assert toks == jtoks
    snap, jsnap = ours.metrics_snapshot(), ref.metrics_snapshot()
    # the wall-clock histograms' sums differ; the hw series are floats
    assert _series(snap).keys() == _series(jsnap).keys()
    for k, v in _series(snap).items():
        _close(v, _series(jsnap)[k], k)
    for name, inst in ours.obs.registry.instruments().items():
        if isinstance(inst, Histogram):
            jinst = ref.obs.registry.instruments()[name]
            assert isinstance(jinst, JHistogram)
            assert inst.count() == jinst.count(), name
    hw, jhw = ours.metrics()["hw"], ref.metrics()["hw"]
    assert hw is not None
    _close(hw, jhw, "hw")
    ev, jev = _events(ours.obs.tracer), _events(ref.obs.tracer)
    assert [e[:3] for e in ev] == [e[:3] for e in jev]
    for (name, _, _, args), (_, _, _, jargs) in zip(ev, jev):
        _close(args, jargs, name)
    assert ours.obs.tracer.span_balance() == {} == ref.obs.tracer.span_balance()
    if spec:
        assert ours.metrics()["spec"]["rounds"] > 0
        assert hw["draft"]["x_bits_eff"] == SPEC["draft_x_bits"]


@pytest.mark.parametrize("spec", [None, SPEC], ids=["greedy", "spec"])
def test_exported_files_pass_both_checkers(setup, tmp_path, spec):
    (ours, _), _ = _pair(setup, spec)
    files = [ours.write_trace(str(tmp_path / "obs" / "trace.json")),
             ours.write_metrics(str(tmp_path / "obs" / "metrics.prom")),
             ours.write_hw_metrics(str(tmp_path / "hw.json"))]
    assert tcheck.main(files) == 0
    assert jcheck.main(files) == 0
    hw = json.loads(open(files[2]).read())
    assert hw["metrics_schema_version"] == METRICS_SCHEMA_VERSION
    trace = json.loads(open(files[0]).read())
    assert any("est_pj" in e.get("args", {}) for e in trace["traceEvents"])


def test_tracing_does_not_change_the_serve(setup):
    """Tokens, every counter and observation count, and the hw block equal
    with the recorder on and off; off records nothing."""
    (on, toks_on), _ = _pair(setup, SPEC)
    off, toks_off = _ours(setup, SPEC)
    assert toks_on == toks_off
    assert _series(on.metrics_snapshot()) == _series(off.metrics_snapshot())
    assert on.metrics()["hw"] == off.metrics()["hw"]
    assert len(off.obs.tracer) == 0 and len(on.obs.tracer) > 0


def test_trace_reconstructs_ttft_itl_exactly(setup):
    """The token instants carry the perf_counter stamps the scheduler wrote
    into Request.token_times: TTFT and ITL rebuilt from the trace equal
    metrics()'s to float precision."""
    (eng, _), _ = _pair(setup, None)
    m = eng.metrics()
    submit_ts, token_ts = {}, {}
    for ev in eng.obs.tracer.events:
        if ev.ph == "i" and ev.track.startswith("req:"):
            uid = int(ev.track.split(":")[1])
            if ev.name == "submit":
                submit_ts[uid] = ev.ts
            elif ev.name == "token":
                token_ts.setdefault(uid, []).append(ev.ts)
    assert sorted(token_ts) == sorted(setup[4])
    ttft = [token_ts[u][0] - submit_ts[u] for u in sorted(token_ts)]
    itl = [b - a for u in token_ts for a, b in zip(token_ts[u], token_ts[u][1:])]
    assert float(np.percentile(ttft, 50)) * 1e3 == pytest.approx(
        m["ttft_p50_ms"], abs=1e-9)
    assert float(np.percentile(itl, 50)) * 1e3 == pytest.approx(
        m["itl_p50_ms"], abs=1e-9)
    assert all(len(ts) == MAX_NEW for ts in token_ts.values())


def test_span_balance_through_preempt_defrag_spec_stress(setup):
    """Every span opened is closed across admit → forced preempt → re-admit
    → defrag → speculative rounds with rollback → finish, and the exported
    trace and Prometheus text validate."""
    _, tcfg, _, tparams, prompts = setup
    eng = ServeEngine(tcfg, tparams, batch_size=2, max_len=32, page_size=4,
                      spec=SpecConfig(provider="bitplane", gamma=2,
                                      draft_x_bits=6, disable_below=0.0),
                      trace=True, device="cpu")
    for uid, pr in prompts.items():
        eng.submit(Request(uid=uid, prompt=pr, max_new_tokens=12))
    eng.step()
    sched = eng._rt
    victims = [i for i, l in enumerate(sched.lanes) if l is not None]
    assert victims, "the first tick finished every request"
    sched._preempt(victims[-1])
    sched.defrag()
    assert sorted(eng.run()) == sorted(prompts)
    m = eng.metrics()
    assert m["preemptions"] >= 1 and m["spec"]["rounds"] > 0
    assert m["pool"]["used_pages"] == 0
    assert eng.obs.tracer.span_balance() == {}
    assert validate_chrome_trace(chrome_trace(eng.obs.tracer)) == []
    snap = eng.metrics_snapshot()
    assert snap["sched_preemptions"] >= 1 and snap["spec_rounds"] > 0
    assert validate_prometheus_text(prometheus_text(eng.obs.registry)) == []


def test_device_steps_run_inside_their_annotation(setup):
    """With the recorder on, each device call of a serve runs inside a
    ``torch.profiler`` annotation named for its kind and shape; off, none."""
    _, tcfg, _, tparams, prompts = setup
    names = {}
    for trace in (True, False):
        engines = [ServeEngine(tcfg, tparams, spec=spec, trace=trace,
                               device="cpu", **KW)
                   for spec in (None, SpecConfig(**SPEC))]
        names[trace] = _annotations(
            lambda: [_serve(e, prompts, Request) for e in engines])
    assert {"paged_step[2x1]", "spec_draft[2x1]", "spec_verify[2x4]"} <= \
        names[True]
    assert any(n.startswith("paged_step[2x") and not n.endswith("x1]")
               for n in names[True])  # the prefill chunks
    assert not any(n.startswith(("paged_step[", "spec_")) for n in names[False])


def test_obs_bundle_is_shared_and_warmup_counts_no_spec_steps(setup):
    """``obs=`` hands the scheduler a bundle (its series land there), and
    warmup's draft and verify calls count as compiles only, as the
    reference's: after warmup every series equals the reference's."""
    jcfg, tcfg, art, tparams, _ = setup
    obs = Observability.make(trace=True)
    ours = ServeEngine(tcfg, tparams, spec=SpecConfig(**SPEC), obs=obs,
                       device="cpu", **KW)
    ref = JServeEngine(jcfg, art.params, spec=JSpec(**SPEC), **KW)
    assert ours.obs is obs and ours._rt.obs is obs
    assert ours.warmup() == ref.warmup()
    assert ours.metrics()["spec"] == ref.metrics()["spec"]
    snap = ours.metrics_snapshot()
    assert snap == obs.registry.snapshot()
    assert _series(snap) == _series(ref.metrics_snapshot())
    assert ours._rt.draft_steps == ours._rt.verify_steps == 0
    assert ours._rt.draft_compiles > 0
    assert len(obs.tracer) == 0  # warmup serves no request


def test_kernels_in_spans_reads_the_launch_times():
    """Device work counts as inside when the runtime call that launched it
    (matched by correlation id) ran inside an annotation of the prefix."""
    from repro_torch.obs import kernels_in_spans

    def x(cat, name, ts, dur=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 1, "tid": 1, "args": args}

    trace = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1, "args": {}},
        x("user_annotation", "paged_step[4x1]", 100, 50),
        x("user_annotation", "other", 200, 50),
        x("cuda_runtime", "cudaLaunchKernel", 110, correlation=1),
        x("cuda_runtime", "cudaLaunchKernel", 149, correlation=2),
        x("cuda_runtime", "cudaMemcpyAsync", 90, correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", 210, correlation=4),
        x("kernel", "bitplane_vmm_kernel", 300, correlation=1),
        x("kernel", "paged_attn_pv_kernel", 310, correlation=2),
        x("gpu_memcpy", "Memcpy HtoD", 120, correlation=3),
        x("kernel", "bitplane_vmm_kernel", 400, correlation=4),
        x("kernel", "orphan", 500, correlation=9)]}
    assert kernels_in_spans(trace) == {
        "bitplane_vmm_kernel": [1, 1], "paged_attn_pv_kernel": [1, 0],
        "Memcpy HtoD": [0, 1], "orphan": [0, 1]}
    assert kernels_in_spans(trace, prefix="other")["bitplane_vmm_kernel"] == [1, 1]
    assert kernels_in_spans({}) == {}
