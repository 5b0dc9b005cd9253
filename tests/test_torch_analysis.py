"""The port's static-analysis layer (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU.

* findings: the JSON, the rendering and the dump file are the reference's,
  byte for byte;
* lint: each rule on the same planted sources gives the same findings, and
  the port's own paths lint clean;
* races: ``check_plan`` on the reference's race cases gives the same
  findings; ``PagedScheduler(analysis_debug=True)`` serves the CI smoke's
  artifact with the reference's ``plans_checked`` and tokens;
* the kernel ops: each custom op on the CPU equals its plain version, and
  its fake function gives the real output's shape and dtype;
* the graph passes: the frozen smoke model traced in both packages has no
  error on any step (the port's default allowlist; the reference's own);
  without the port's float64 entries exactly those sites appear; a traced
  step holds one op node per kernel call; every planted violation is
  flagged; the allowlist matches by substring;
* the CLI on a JAX-frozen artifact exits 0 and records a verdict the
  reference's ``load_artifact`` reads.

The reference's taint interpreter handles the call primitive under its
old name ``pjit``; JAX 0.9 names it ``jit``, so the reference's tests here
alias ``_h_jit`` to its ``_call_like`` handler (a test-side shim; without
it every jitted helper's float output counts as a float weight).
"""
import dataclasses
import glob
import json
import os
import textwrap

import jax
import numpy as np
import pytest
import torch

import repro.analysis.passes as jpasses
from repro.analysis import findings as jfindings
from repro.analysis import lint as jlint
from repro.analysis import races as jraces
from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core.da import DAConfig as JDA
from repro.core.freeze import freeze_model as jfreeze
from repro.core.freeze import load_artifact as jload
from repro.core.freeze import save_artifact as jsave
from repro.models.model import init_model as jinit
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.spec import SpecConfig as JSpec
from repro_torch.analysis import findings, lint, races
from repro_torch.analysis import passes
from repro_torch.analysis.check import main, verdict_of
from repro_torch.analysis.graph import trace_serving_steps, trace_step
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core.da import DAConfig, build_luts
from repro_torch.core.engine import dense, pack_weights, registered_backends
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import paged_gather_read
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.spec import SpecConfig


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's CPU ops take one thread in each xdist worker (restored after
    the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jit_alias(monkeypatch):
    monkeypatch.setattr(jpasses._TaintInterpreter, "_h_jit",
                        jpasses._TaintInterpreter._call_like, raising=False)


def _json(fs):
    return [f.to_json() for f in fs]


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------
_FINDINGS = [
    dict(pass_name="graph/multiplier-free", severity="error", op="mm(lhs x)",
         hint="h1", bytes=0, where="a.py:3", step="decode[fused]"),
    dict(pass_name="lint/raw-clock", severity="warning", op="time.time()",
         hint="h2", bytes=128, where="", step=""),
    dict(pass_name="graph/trace", severity="note", op="config x", hint="h3"),
]


def test_findings_json_render_and_dump_equal_the_reference(tmp_path):
    ours = [findings.Finding(**d) for d in _FINDINGS]
    theirs = [jfindings.Finding(**d) for d in _FINDINGS]
    assert _json(ours) == _json(theirs)
    assert [f.format() for f in ours] == [f.format() for f in theirs]
    assert findings.render(ours) == jfindings.render(theirs)
    assert findings.render([]) == jfindings.render([])
    assert findings.errors(ours) == [ours[0]]
    assert findings.Finding.from_json(ours[1].to_json()) == ours[1]
    findings.dump_json(ours, str(tmp_path / "ours.json"))
    jfindings.dump_json(theirs, str(tmp_path / "theirs.json"))
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()
    with pytest.raises(ValueError, match="severity"):
        findings.Finding(pass_name="p", severity="fatal", op="o", hint="h")


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------
_LINT_CASES = {
    "interpret-literal": ("src/repro_torch/kernels/k.py",
                          "f(x, interpret=True)\n"),
    "interpret-derived": ("src/repro_torch/kernels/k.py",
                          "f(x, interpret=backend() != 'tpu')\n"),
    "interpret-in-tests": ("tests/test_k.py", "f(x, interpret=True)\n"),
    "raw-clock-serve": ("src/repro_torch/serve/s.py",
                        "import time\nt = time.time()\n"),
    "raw-clock-obs": ("src/repro_torch/obs/o.py", "import time\nt = time.time()\n"),
    "perf-counter": ("src/repro_torch/serve/s.py",
                     "import time\nt = time.perf_counter()\n"),
    "raw-clock-elsewhere": ("src/repro_torch/core/c.py",
                            "import time\nt = time.time()\n"),
    "metric-total": ("src/repro_torch/serve/s.py", "c.total = 3\n"),
    "metric-value-aug": ("src/repro_torch/serve/s.py", "g.value += 1\n"),
    "registry-mutators": ("src/repro_torch/serve/s.py",
                          "c.inc()\ng.set(2)\nh.observe(0.1)\n"),
    "bench-writer": ("benchmarks/b.py", "open('BENCH_x.json', 'w')\n"),
    "bench-fstring": ("benchmarks/b.py",
                      "open(f'artifacts/BENCH_{name}.json', mode='w')\n"),
    "bench-read": ("benchmarks/b.py", "open('BENCH_y.json', 'r')\n"),
    "stamp-exempt": ("benchmarks/stamp.py", "open('BENCH_x.json', 'w')\n"),
    "syntax-error": ("src/repro_torch/x.py", "def f(:\n"),
}


@pytest.mark.parametrize("case", sorted(_LINT_CASES))
def test_lint_rule_equals_the_reference(case):
    path, src = _LINT_CASES[case]
    src = textwrap.dedent(src)
    ours = lint.lint_source(src, path)
    assert _json(ours) == _json(jlint.lint_source(src, path))
    flagged = {"interpret-literal", "raw-clock-serve", "raw-clock-obs",
               "metric-total", "metric-value-aug", "bench-writer",
               "bench-fstring", "syntax-error"}
    assert bool(ours) == (case in flagged)


def test_port_paths_lint_clean():
    root = lint.repo_root()
    assert root is not None and os.path.isdir(os.path.join(root, "src", "repro_torch"))
    assert lint.lint_repo() == []
    # the default paths reach the port, its tests and its card smoke
    files = {os.path.relpath(p, root) for d in lint.DEFAULT_LINT_DIRS
             for p in glob.glob(os.path.join(root, d))}
    assert {"src/repro_torch", "chip_smoke.py",
            "tests/test_torch_analysis.py"} <= files
    assert jlint.DEFAULT_LINT_DIRS == ("src/repro", "benchmarks", "examples", "tests")


# ---------------------------------------------------------------------------
# races
# ---------------------------------------------------------------------------
_W = lambda lane, uid, page, off: (lane, uid, page, off)  # noqa: E731
_RACES = {
    "clean": ([_W(0, 10, 3, 1), _W(1, 11, 5, 1)], {3: 1, 5: 1}, (), ()),
    "double-write": ([_W(0, 10, 3, 2), _W(1, 11, 3, 2)], {3: 1}, (), ()),
    "same-lane-rewrite": ([_W(0, 10, 3, 2), _W(0, 10, 3, 2)], {3: 1}, (), ()),
    "shared-page": ([_W(0, 10, 3, 0)], {3: 2}, (), ()),
    "trie-page": ([_W(0, 10, 7, 0)], {7: 1}, (7,), ()),
    "free-page": ([_W(0, 10, 4, 0)], {4: 0}, (), (4,)),
    "offset-outside": ([_W(0, 10, 3, 4)], {3: 1}, (), ()),
    "garbage-exempt": ([_W(0, 10, 0, 0), _W(1, 11, 0, 0), _W(2, 12, 0, 99)],
                       {}, (), ()),
    "one-bad-of-three": ([_W(0, 10, 3, 0), _W(1, 11, 5, 0), _W(2, 12, 5, 0)],
                         {3: 1, 5: 1}, (), ()),
}


@pytest.mark.parametrize("case", sorted(_RACES))
def test_check_plan_equals_the_reference(case):
    writes, refcounts, trie, free = _RACES[case]
    plans = [mod.TickPlan.build(
        phase="decode", page_size=4, writes=[mod.PageWrite(*w) for w in writes],
        refcounts=refcounts, trie_pages=trie, free_pages=free)
        for mod in (races, jraces)]
    ours, theirs = races.check_plan(plans[0]), jraces.check_plan(plans[1])
    assert _json(ours) == _json(theirs)
    clean = case in ("clean", "same-lane-rewrite", "garbage-exempt")
    assert (ours == []) == clean
    if clean:
        races.assert_plan_ok(plans[0])
    else:
        with pytest.raises(races.PageRaceError) as ei:
            races.assert_plan_ok(plans[0])
        assert ei.value.plan is plans[0] and ei.value.findings == ours
        assert str(ei.value) == str(jraces.PageRaceError(plans[1], theirs))


# ---------------------------------------------------------------------------
# the CI smoke's artifact (examples/serve_da.py), frozen by the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke_artifact(tmp_path_factory):
    cfg = dataclasses.replace(  # examples/serve_da.py::build_cfg
        ARCHS["qwen3-8b"], name="qwen3-20m", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=768, vocab=8000,
        param_dtype="float32", compute_dtype="float32", remat=False,
        moe_dropless=True)
    d = str(tmp_path_factory.mktemp("art") / "smoke_da")
    jsave(d, jfreeze(jinit(jax.random.key(0), cfg), JDA(x_signed=True),
                     mode="bitplane_stacked", model_cfg=cfg))
    return d


def _ci_serve(eng, request_cls, vocab):
    rng = np.random.default_rng(0)  # the smoke's requests, seed 0
    for u in range(2):
        eng.submit(request_cls(uid=u, prompt=rng.integers(
            0, vocab, rng.integers(4, 24)).astype(np.int32),
            max_new_tokens=int(rng.integers(8, 24))))
    done = eng.run()
    return {u: [int(t) for t in r.generated] for u, r in done.items()}


@pytest.mark.parametrize("spec", [False, True])
def test_analysis_debug_serve_equals_the_reference(smoke_artifact, spec):
    """``--requests 2 --artifact DIR`` (and ``--spec bitplane --spec-gamma
    2``) with ``analysis_debug=True``: every launch plan checked before the
    device call, the same plans as the reference's, the same tokens, and
    the same tokens as a serve without the check."""
    kw = dict(batch_size=4, max_len=96, analysis_debug=True)
    ours = ServeEngine.from_artifact(smoke_artifact, device="cpu", spec=(
        SpecConfig(provider="bitplane", gamma=2, draft_x_bits=4) if spec else None),
        **kw)
    theirs = JServeEngine.from_artifact(smoke_artifact, spec=(
        JSpec(provider="bitplane", gamma=2, draft_x_bits=4) if spec else None), **kw)
    toks = _ci_serve(ours, Request, ours.cfg.vocab)
    assert toks == _ci_serve(theirs, JRequest, ours.cfg.vocab)
    assert ours._rt.plans_checked == theirs._rt.plans_checked > 0
    plain = ServeEngine.from_artifact(smoke_artifact, device="cpu", batch_size=4,
                                      max_len=96)
    assert _ci_serve(plain, Request, ours.cfg.vocab) == toks
    assert plain._rt.plans_checked == 0


def test_analysis_debug_stress_schedule_and_a_forged_race():
    """The reference's stress schedule (prefix sharing, optimistic
    admission, a pool tight enough to preempt, spec with rollback) on the
    port: every plan passes, the tokens equal the unchecked serve's; then a
    lane's page forged shared makes the next launch raise."""
    cfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    from repro_torch.core.freeze import freeze_model
    from repro_torch.models.model import init_model

    art = freeze_model(init_model(cfg, seed=0, device="cpu"), DAConfig(x_signed=True),
                       mode="bitplane_stacked", model_cfg=cfg, device="cpu")
    kw = dict(batch_size=3, max_len=48, page_size=4, n_pages=12, prefill_chunk=4,
              admission="optimistic", prefix_cache=True, device="cpu",
              spec=SpecConfig(provider="bitplane", gamma=2, draft_x_bits=6,
                              disable_below=0.0))
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 90, size=n)) for n in (7, 9, 7, 5, 11, 9)]
    prompts[2] = prompts[0]

    def run(debug):
        eng = ServeEngine(cfg, art.params, greedy=True, analysis_debug=debug, **kw)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        done = eng.run()
        return {u: r.generated for u, r in sorted(done.items())}, eng._rt.plans_checked

    checked_out, checked = run(True)
    plain_out, unchecked = run(False)
    assert checked > 0 and unchecked == 0
    assert checked_out == plain_out
    assert all(len(t) == 6 for t in checked_out.values())

    eng = ServeEngine(cfg, art.params, greedy=True, analysis_debug=True,
                      **{**kw, "spec": None, "prefix_cache": False})
    eng.submit(Request(uid=0, prompt=prompts[1], max_new_tokens=6))
    rt = eng._rt
    for _ in range(8):  # until the lane's next write lands on a page it holds
        eng.step()
        lane = rt.lanes[0]
        if lane.pos // rt.page_size < len(lane.pages):
            break
    page = lane.pages[lane.pos // rt.page_size]
    rt.pool.incref([page])  # a second owner, and no copy-on-write
    with pytest.raises(races.PageRaceError, match=f"page={page} \\(refcount=2\\)"):
        eng.step()


def test_analysis_debug_still_refused_on_slots():
    cfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    from repro_torch.models.model import init_model

    with pytest.raises(ValueError, match="analysis_debug"):
        ServeEngine(cfg, init_model(cfg, seed=0, device="cpu"), batch_size=2,
                    max_len=32, runtime="slots", analysis_debug=True, device="cpu")


# ---------------------------------------------------------------------------
# the kernel ops on the CPU
# ---------------------------------------------------------------------------
def _op_cases():
    g = torch.Generator().manual_seed(0)
    cfg = DAConfig(x_signed=True)
    xq = torch.randint(-128, 128, (5, 37), generator=g, dtype=torch.int32)
    wq = torch.randint(-128, 128, (37, 11), generator=g, dtype=torch.int8)
    xe = torch.randint(-128, 128, (3, 4, 37), generator=g, dtype=torch.int32)
    we = torch.randint(-128, 128, (3, 37, 11), generator=g, dtype=torch.int8)
    luts = build_luts(wq, 8)
    lute = torch.stack([build_luts(we[e], 8) for e in range(3)])
    b, t, h, kv, hd, ps, w = 2, 3, 4, 2, 16, 4, 5
    q = torch.randn(b, t, h, hd, generator=g)
    kp = torch.randn(1 + b * w, ps, kv, hd, generator=g)
    vp = torch.randn(1 + b * w, ps, kv, hd, generator=g)
    table = torch.arange(1, 1 + b * w, dtype=torch.int32).reshape(b, w)
    tpos = torch.tensor([[4, 5, 6], [0, 1, 19]], dtype=torch.int32)
    kw = dict(softmax_dtype="float32", mask_mode="where")
    return {
        "bitplane_vmm": ((xq, wq, cfg), ops.bitplane_vmm, ref.bitplane_vmm_ref),
        "bitplane_vmm_experts": ((xe, we, cfg), ops.bitplane_vmm_experts,
                                 ref.bitplane_vmm_experts_ref),
        "da_vmm": ((xq, luts, cfg), ops.da_vmm, ref.da_vmm_ref),
        "da_vmm_experts": ((xe, lute, cfg), ops.da_vmm_experts,
                           ref.da_vmm_experts_ref),
        "paged_attention": ((q, kp, vp, table, tpos),
                            lambda *a: ops.paged_attention(*a, **kw),
                            lambda *a: paged_gather_read(*a, **kw)),
    }


@pytest.mark.parametrize("name", ops.OP_NAMES)
def test_custom_op_on_cpu_equals_plain_and_fake_shape(name):
    args, op, plain = _op_cases()[name]
    got = op(*args)
    assert torch.equal(got, plain(*args))
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    gm, _, _ = trace_step(op, tuple(args))
    nodes = [n for n in gm.graph.nodes if passes.port_op_name(n) == name]
    assert len(nodes) == 1 and len(tensors) <= len(gm.graph.find_nodes(op="placeholder"))
    fake = nodes[0].meta["val"]
    assert (tuple(fake.shape), fake.dtype) == (tuple(got.shape), got.dtype)
    assert getattr(torch.ops.repro_torch, name).default.namespace == "repro_torch"


def test_quantized_pages_through_the_op():
    from repro_torch.models import kv_quant

    args, _, _ = _op_cases()["paged_attention"]
    q, kp, vp, table, tpos = args
    for fmt in ("int8", "int4"):
        kc, ks = kv_quant.quantize_kv(kp, fmt)
        vc, vs = kv_quant.quantize_kv(vp, fmt)
        for sm in ("float32", "bfloat16"):
            kw = dict(softmax_dtype=sm, mask_mode="additive", k_scale=ks, v_scale=vs)
            assert torch.equal(ops.paged_attention(q, kc, vc, table, tpos, **kw),
                               paged_gather_read(q, kc, vc, table, tpos, **kw))


# ---------------------------------------------------------------------------
# the graph passes on the frozen smoke model, in both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke_model():
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]),
                               moe_dropless=True)
    tcfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    art = jfreeze(jinit(jax.random.key(0), jcfg), JDA(x_signed=True),
                  mode="bitplane_stacked", model_cfg=jcfg)
    return jcfg, tcfg, art, params_from_jax(jax.tree.map(np.asarray, art.params))


@pytest.fixture(scope="module")
def port_steps(smoke_model):
    _, tcfg, _, tparams = smoke_model
    return trace_serving_steps(tparams, tcfg, spec_gamma=2)


_STEPS = ["decode[gather]", "prefill[gather]", "decode[fused]",
          "prefill[fused]", "spec_draft[fused]"]


def test_frozen_serving_steps_equal_the_reference(smoke_model, port_steps, jit_alias):
    from repro.analysis.graph import trace_serving_steps as jtrace

    jcfg, _, art, _ = smoke_model
    jsteps = jtrace(art.params, jcfg, spec_gamma=2, compile_hlo=True)
    assert [s.name for s in port_steps] == [s.name for s in jsteps] == _STEPS
    ours, theirs = passes.run_passes(port_steps), jpasses.run_passes(jsteps)
    for name in _STEPS:
        assert (len(findings.errors([f for f in ours if f.step == name]))
                == len(jfindings.errors([f for f in theirs if f.step == name]))
                == 0), name
    # the served steps hold each kernel as one node: the attention read
    # once per layer (fused), no gather-sized index
    for s in port_steps:
        assert s.op_counts().get("paged_attention", 0) == (
            0 if not s.fused else (2 if s.name.startswith("spec") else 1)
            * smoke_model[1].n_layers)


def test_float64_sites_are_the_only_reference_allowlist_findings(port_steps):
    """Without the port's float64 entries, exactly those sites appear: the
    gather read's sums on the gather steps, the norm's sum of squares on
    every step, nothing else; and the fused steps hold no gather read."""
    found = passes.run_passes(port_steps, allow=passes.REFERENCE_ALLOWLIST)
    assert found and {f.severity for f in found} == {"error"}
    by_step = {s: [f for f in found if f.step == s] for s in _STEPS}
    for name, fs in by_step.items():
        assert fs, name
        assert {f.pass_name for f in fs} == {"graph/no-host-sync",
                                             "graph/dtype-discipline"}
        assert all(any(site in f.where for site in passes.PORT_FLOAT64_SITES)
                   for f in fs), name
        gather_read = [f for f in fs if "paged_gather_read" in f.where]
        assert bool(gather_read) == name.endswith("[gather]"), name
        assert any("_mean_square" in f.where for f in fs)
    assert passes.run_passes(port_steps) == []


@pytest.mark.parametrize("mode", ["pallas_bitplane", "pallas_lut"])
def test_traced_decode_holds_one_node_per_kernel_call(mode):
    """A traced step's op nodes, one per kernel call of a real step on the
    same arguments (counted by the dispatcher), and the passes clean."""
    from repro_torch.core.freeze import freeze_model
    from repro_torch.models.model import init_model
    from repro_torch.serve.kvcache import init_paged_caches
    from repro_torch.spec.decode import make_paged_step

    cfg = dataclasses.replace(treg.reduce_for_smoke(treg.get("qwen3-8b")),
                              paged_attn="fused", d_model=64, d_ff=128, vocab=512)
    art = freeze_model(init_model(cfg, seed=0, device="cpu"), DAConfig(x_signed=True),
                       mode=mode, model_cfg=cfg, device="cpu", lut_cell_limit=1 << 30)
    steps = trace_serving_steps(art.params, cfg, batch_size=2, max_len=32,
                                page_size=8, prefill_chunk=1, backends=("fused",))
    counted: dict = {}

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "repro_torch":
                counted[func._opname] = counted.get(func._opname, 0) + 1
            return func(*args, **(kwargs or {}))

    caches = init_paged_caches(cfg, 9, 8, cfg.dtype(), device="cpu")
    z = torch.zeros((2, 1), dtype=torch.int32)
    with Count(), torch.inference_mode():
        make_paged_step(cfg)(art.params, caches, z, z, torch.zeros(
            (2, 4), dtype=torch.int32), torch.zeros((2,), dtype=torch.int32))
    assert steps[0].op_counts() == counted
    vmm = "da_vmm" if mode == "pallas_lut" else "bitplane_vmm"
    assert counted[vmm] > 0 and counted["paged_attention"] == cfg.n_layers
    assert passes.run_passes(steps) == []


def test_cpu_lut_readout_is_not_a_page_view_gather():
    """The CPU's plain LUT readout gathers weight tables by PMA address
    (``da_vmm_lut``), more bytes than the page view at this size: a gather,
    but not of a KV pool, so no-big-gather does not count it."""
    from repro_torch.core.freeze import freeze_model
    from repro_torch.models.model import init_model

    cfg = dataclasses.replace(treg.reduce_for_smoke(treg.get("qwen3-8b")),
                              d_model=64, d_ff=128, vocab=512)
    art = freeze_model(init_model(cfg, seed=0, device="cpu"), DAConfig(x_signed=True),
                       mode="lut", model_cfg=cfg, device="cpu", lut_cell_limit=1 << 30)
    step, = trace_serving_steps(art.params, cfg, prefill_chunk=1, backends=("fused",))
    every = passes.no_big_gather(step.gm, step.view_bytes, step.name)
    assert every and all("da_vmm_lut" in f.where for f in every)
    assert passes.no_big_gather(step.gm, step.view_bytes, step.name, step.pools) == []
    assert passes.run_passes([step]) == []


def test_forged_fused_gather_is_caught(port_steps):
    gather = next(s for s in port_steps if s.name == "decode[gather]")
    forged = dataclasses.replace(gather, fused=True, name="decode[forged-fused]")
    hits = [f for f in findings.errors(passes.run_passes([forged]))
            if f.pass_name == "graph/no-big-gather"]
    assert hits and all(f.bytes >= gather.view_bytes for f in hits)
    assert all("paged_gather_read" in f.where for f in hits)


# ---------------------------------------------------------------------------
# planted violations
# ---------------------------------------------------------------------------
_X = torch.randn(4, 32, generator=torch.Generator().manual_seed(1))
_W_FLOAT = torch.randn(32, 16, generator=torch.Generator().manual_seed(2))
_PACKED = pack_weights(_W_FLOAT, DAConfig(x_signed=True), mode="bitplane")


def _findings_of(fn, params, name="planted"):
    gm, taints, _ = trace_step(fn, (_X, params))
    return findings.errors(
        passes.multiplier_free(gm, taints, name) + passes.no_host_sync(gm, name)
        + passes.dtype_discipline(gm, name))


@pytest.mark.parametrize("mode", sorted(registered_backends()))
def test_da_backend_is_multiplier_free(mode):
    packed = pack_weights(_W_FLOAT, DAConfig(x_signed=True), mode=mode)
    fs = _findings_of(lambda x, p: dense(x, p["mixer"]["wq"]), {"mixer": {"wq": packed}})
    assert [f for f in fs if f.pass_name == "graph/multiplier-free"] == []


_PLANTED = {
    "float-weight-matmul": (
        lambda x, p: x @ p["ffn"]["w_up"], {"ffn": {"w_up": _W_FLOAT}},
        "graph/multiplier-free", "float weight operand"),
    "dequantize-then-matmul": (
        lambda x, p: x @ (p["wq"].wq.to(torch.float32) * p["wq"].w_scale),
        {"wq": _PACKED}, "graph/multiplier-free", "float weight operand"),
    "float-codes-x-non-selector": (
        lambda x, p: x @ p["wq"].wq.to(torch.float32), {"wq": _PACKED},
        "graph/multiplier-free", "integer weight codes x non-selector"),
    "item-in-step": (
        lambda x, p: x * x.sum().item(), {}, "graph/no-host-sync", "_local_scalar_dense"),
    "bf16-exp": (
        lambda x, p: torch.exp(x.to(torch.bfloat16)), {},
        "graph/dtype-discipline", "exp"),
    "64-bit-dot": (
        lambda x, p: x.to(torch.int64) @ p["idx"], {"idx": torch.ones(
            32, 3, dtype=torch.int64)}, "graph/dtype-discipline", "mm"),
    "float64-escape": (
        lambda x, p: x.to(torch.float64).sum(), {}, "graph/no-host-sync", "_to_copy"),
    "int64-accumulator": (
        lambda x, p: x.to(torch.int32).sum(), {}, "graph/dtype-discipline", "sum"),
}


@pytest.mark.parametrize("case", sorted(_PLANTED))
def test_planted_violation_is_flagged(case):
    fn, params, pass_name, op = _PLANTED[case]
    fs = [f for f in _findings_of(fn, params) if f.pass_name == pass_name]
    assert fs and any(op in f.op for f in fs), case
    assert all(f.where.startswith("tests/") is False for f in fs)


def test_bitplane_selector_dot_is_not_flagged():
    """The sanctioned DA trick in float clothing: an extracted 0/1 plane
    against float-cast integer codes."""
    def fn(x, p):
        planes = torch.bitwise_and(torch.bitwise_right_shift(
            x.to(torch.int32), 3), 1)
        return planes.to(torch.float32) @ p["wq"].wq.to(torch.float32)

    assert _findings_of(fn, {"wq": _PACKED}) == []


def test_kernel_op_is_opened_with_its_plain_version(monkeypatch):
    """A kernel node's taint runs over the op's plain version: swap that
    plain version for a float multiply over the codes and the pass sees it."""
    fs = _findings_of(lambda x, p: ops.bitplane_vmm(
        x.to(torch.int32), p["wq"].wq, p["wq"].cfg), {"wq": _PACKED})
    assert fs == []
    monkeypatch.setitem(ops.PLAIN, "bitplane_vmm", lambda xq, w, *_: (
        xq.to(torch.float32) @ w.to(torch.float32)).to(torch.int32))
    monkeypatch.setattr(passes, "_PLAIN_GRAPHS", {})
    fs = _findings_of(lambda x, p: ops.bitplane_vmm(
        x.to(torch.int32), p["wq"].wq, p["wq"].cfg), {"wq": _PACKED})
    assert any("integer weight codes x non-selector" in f.op for f in fs)


def test_foreign_custom_op_is_a_warning():
    lib = torch.library.Library("repro_analysis_test", "FRAGMENT")
    lib.define("twice(Tensor x) -> Tensor")
    lib.impl("twice", lambda x: x * 2, "CPU")
    torch.library.register_fake("repro_analysis_test::twice",
                                lambda x: torch.empty_like(x), lib=lib)
    gm, _, _ = trace_step(lambda x, p: torch.ops.repro_analysis_test.twice(x),
                          (_X, {}))
    fs = passes.no_host_sync(gm, "foreign")
    assert [f.severity for f in fs] == ["warning"]
    assert "repro_analysis_test::twice" in fs[0].op


def test_allowlist_suppresses_by_substring():
    fs = _findings_of(lambda x, p: x @ p["ffn"]["w_up"], {"ffn": {"w_up": _W_FLOAT}})
    assert fs and all(f.where.startswith("tests/") is False for f in fs)
    f = fs[0]
    assert passes.apply_allowlist(fs, ("nothing-matches",)) == fs
    assert passes.apply_allowlist(fs, ("float weight",)) == []
    planted = dataclasses.replace(f, where="src/repro_torch/core/bitslice.py:40 in bitslice_vmm")
    assert passes.apply_allowlist([planted], passes.REFERENCE_ALLOWLIST) == []
    assert passes.apply_allowlist([planted], ("core/bitslice.py",)) == []
    assert passes.apply_allowlist([planted], ("core/da.py",)) == [planted]
    # a pass-scoped entry matches that pass's findings only
    assert passes.apply_allowlist(
        [planted], ("graph/dtype-discipline@bitslice_vmm",)) == [planted]
    assert passes.apply_allowlist(
        [planted], ("graph/multiplier-free@bitslice_vmm",)) == []


def test_where_names_the_port_frame_and_its_callers(port_steps):
    fused = next(s for s in port_steps if s.name == "decode[fused]")
    fs = passes.run_passes([fused], allow=passes.REFERENCE_ALLOWLIST)
    w = fs[0].where
    assert w.startswith("src/repro_torch/models/layers.py:")
    assert " in _mean_square < " in w and "forward" in w


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_on_a_jax_frozen_artifact(smoke_artifact, tmp_path):
    out = str(tmp_path / "findings.json")
    assert main(["--artifact", smoke_artifact, "--device", "cpu", "--json", out,
                 "--no-hlo"]) == 0
    with open(os.path.join(smoke_artifact, "manifest.json")) as f:
        verdict = json.load(f)["analysis"]
    assert verdict["ok"] is True and verdict["errors"] == 0
    assert verdict["steps_checked"] == _STEPS
    with open(out) as f:
        assert json.load(f) == []
    # the reference reads the verdict back
    assert jload(smoke_artifact).analysis["ok"] is True
    # --no-record leaves it alone
    from repro_torch.core.freeze import record_analysis

    record_analysis(smoke_artifact, {"ok": True, "marker": "before"})
    assert main(["--artifact", smoke_artifact, "--device", "cpu", "--no-record",
                 "--no-lint", "--spec-gamma", "0"]) == 0
    with open(os.path.join(smoke_artifact, "manifest.json")) as f:
        assert json.load(f)["analysis"] == {"ok": True, "marker": "before"}


def test_cli_lint_only_and_a_config_sweep(capsys):
    assert main(["--lint-only"]) == 0
    assert "[lint] 0 finding(s)" in capsys.readouterr().out
    # a LayerNorm stack (the norm's float64 mean is a named site) and one
    # the paged tracer does not cover
    assert main(["--configs", "minitron-8b,mamba2-780m", "--device", "cpu",
                 "--no-lint"]) == 0
    out = capsys.readouterr().out
    assert "configs:minitron-8b: 5 step(s) traced, 0 finding(s)" in out
    assert "outside paged-tracer coverage" in out


def test_cli_artifact_without_model_cfg_fails(smoke_artifact, tmp_path):
    """An artifact whose manifest lacks model_cfg cannot be traced: an
    error finding, exit 1."""
    import shutil

    d = str(tmp_path / "bare")
    shutil.copytree(smoke_artifact, d)
    path = os.path.join(d, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    del manifest["model_cfg"]
    with open(path, "w") as f:
        json.dump(manifest, f)
    assert main(["--artifact", d, "--device", "cpu", "--no-lint"]) == 1


@pytest.mark.parametrize("case", ["counts", "clean"])
def test_verdict_of_equals_the_reference(case):
    from repro.analysis.check import VERDICT_SCHEMA, verdict_of as jverdict

    fs = [findings.Finding(**d) for d in _FINDINGS] if case == "counts" else []
    ours = verdict_of(fs, ["decode[fused]"])
    theirs = jverdict([jfindings.Finding(**d) for d in _FINDINGS]
                      if case == "counts" else [], ["decode[fused]"])
    ours.pop("checked_at")
    theirs.pop("checked_at")
    assert ours == theirs and ours["schema"] == VERDICT_SCHEMA
    assert ours["ok"] is (case == "clean")
