"""PyTorch port vs the JAX reference: shared-prefix caching (trie hits, COW,
eviction under pressure, defrag, ownership under preemption and spec).
The scheduler's other knobs are in ``test_torch_sched.py``.

Both packages serve the same frozen weights (the reference's
``bitplane_stacked`` freeze of ``reduce_for_smoke(qwen3-8b)``, carried across
by ``params_from_jax``) on the CPU, with the same seeded numpy prompts.
Greedy tokens must be equal, and so must every counter the two report (steps,
context tokens, preemptions, prefix hits, cached tokens, COW copies, trie
pages, pool stats): the port's scheduler makes the reference's decisions.
Tokens must not depend on the cache being on, and no page may leak.

The CI serve smoke's model (``examples/serve_da.py``, float32, d 256) is
served from a JAX-written ``bitplane_stacked`` artifact; there the port is
held to its own plain serve, to the reference's prefix counters and to the
reference's tokens, up to the one place where they part: request 2 of the
prefix leg from its token 16 on (a near-tie of the top two logits; the port
parts there with the norm's sum of squares in float32 as in float64).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core.da import DAConfig as JDA
from repro.core.freeze import freeze_model as jfreeze
from repro.core.freeze import save_artifact as jsave
from repro.models.model import init_model as jinit
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.spec import SpecConfig as JSpec
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.spec import SpecConfig

MAX_NEW = 4
PS = 8  # an 18-token shared prefix = 2 full pages
#: counters both schedulers report, compared exactly
COUNTERS = ("requests_done", "out_tokens", "ctx_tokens", "steps",
            "preemptions", "step_compiles")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's CPU ops
    in each take one thread (restored after the module) instead of one per
    core, which the workers would share."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]),
                               moe_dropless=True)
    tcfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    art = jfreeze(jinit(jax.random.key(0), jcfg), JDA(x_signed=True),
                  mode="bitplane_stacked", model_cfg=jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, art.params))
    rng = np.random.default_rng(11)
    shared = rng.integers(0, jcfg.vocab, 18)
    prompts = {u: np.concatenate([shared, rng.integers(0, jcfg.vocab, 3 + u)])
               .astype(np.int32) for u in range(6)}
    return jcfg, tcfg, art, tparams, prompts


def _engines(setup, spec=None, jax_side=True, **kw):
    jcfg, tcfg, art, tparams, _ = setup
    kw.setdefault("batch_size", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("page_size", PS)
    ref = JServeEngine(jcfg, art.params, spec=JSpec(**spec) if spec else None,
                       **kw) if jax_side else None
    ours = ServeEngine(tcfg, tparams, spec=SpecConfig(**spec) if spec else None,
                       device="cpu", **kw)
    return ref, ours


def _serve(eng, prompts, request_cls, new=MAX_NEW):
    for u, p in prompts.items():
        eng.submit(request_cls(uid=u, prompt=p, max_new_tokens=new))
    done = eng.run()
    return {u: list(r.generated) for u, r in done.items()}


_BASELINES: dict = {}


def _baseline(setup, spec=None, **kw):
    """The port's tokens for the fixture's prompts under ``kw`` (served once
    in both packages, then remembered for the module)."""
    key = (repr(spec), tuple(sorted(kw.items())))
    if key not in _BASELINES:
        _BASELINES[key] = _both(setup, setup[4], spec=spec, **kw)[0][0]
    return _BASELINES[key]


def _both(setup, prompts, spec=None, **kw):
    """Serve ``prompts`` in both packages; returns (ours, ref) tokens and
    metrics, after checking the shared counters are equal."""
    ref, ours = _engines(setup, spec=spec, **kw)
    jt, tt = _serve(ref, prompts, JRequest), _serve(ours, prompts, Request)
    jm, tm = ref.metrics(), ours.metrics()
    for key in COUNTERS:
        assert tm[key] == jm[key], key
    assert tm["pool"] == jm["pool"]
    assert tm["prefix_cache"] == jm["prefix_cache"]
    assert tm["spec"] == jm["spec"]
    return (tt, tm), (jt, jm), ours


def _ours(setup, prompts, spec=None, **kw):
    """The port's tokens alone (for a comparison whose other side already
    equals the reference's)."""
    return _serve(_engines(setup, spec=spec, jax_side=False, **kw)[1], prompts,
                  Request)


def _spec():
    return dict(provider="bitplane", gamma=2, draft_x_bits=6, disable_below=0.0)


def test_tokens_identical_cache_on_off(setup):
    prompts = setup[4]
    (on, m), (ref_on, _), _ = _both(setup, prompts, prefix_cache=True)
    assert on == _baseline(setup) == ref_on
    assert m["prefix_cache"]["hits"] >= 2
    assert m["prefix_cache"]["cached_tokens"] >= 2 * 16
    assert 0 < m["prefix_cache"]["hit_rate"] < 1
    assert m["pool"]["used_pages"] == m["prefix_cache"]["trie_pages"]


def test_tokens_identical_with_spec_and_shared_checkpoints(setup):
    """Spec rounds on lanes whose tables start with shared pages (a
    full-prompt twin forces COW): rollback touches only exclusive growth."""
    prompts = dict(setup[4])
    prompts[6] = prompts[5].copy()
    (on, m), (ref_on, _), _ = _both(setup, prompts, spec=_spec(),
                                    prefix_cache=True)
    assert on == ref_on == _ours(setup, prompts, spec=_spec())
    assert m["spec"]["rounds"] > 0 and m["prefix_cache"]["cached_tokens"] > 0
    assert m["pool"]["used_pages"] == m["prefix_cache"]["trie_pages"]


def test_second_request_zero_prefill_for_shared_pages(setup):
    """The second of two requests sharing a 2-page prefix feeds the model
    only its tail (no model call covers a shared page's tokens)."""
    jcfg = setup[0]
    rng = np.random.default_rng(5)
    shared = rng.integers(0, jcfg.vocab, 2 * PS)
    first = np.concatenate([shared, rng.integers(0, jcfg.vocab, 6)])
    tail = 5
    second = np.concatenate([shared, rng.integers(0, jcfg.vocab, tail)])
    runs = []
    for eng, cls in zip(_engines(setup, prefix_cache=True), (JRequest, Request)):
        _serve(eng, {0: first}, cls)
        ctx0 = eng.metrics()["ctx_tokens"]
        toks = _serve(eng, {1: second}, cls)
        m = eng.metrics()
        runs.append((toks, m["ctx_tokens"] - ctx0, m["prefix_cache"]))
    assert runs[0] == runs[1]
    assert runs[1][1] == tail + MAX_NEW - 1
    assert runs[1][2]["cached_tokens"] == 2 * PS


def test_cow_divergence_after_shared_prefix_fork(setup):
    """Two requests with the same page-aligned prompt, one after the other:
    the hit caps at len-1, so the second lane's first write copies the last
    shared page, and both decode the cache-off tokens."""
    jcfg = setup[0]
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab, 2 * PS)
    prompts = {0: prompt, 1: prompt.copy()}
    off = _ours(setup, prompts)
    runs = []
    for eng, cls in zip(_engines(setup, prefix_cache=True), (JRequest, Request)):
        toks = _serve(eng, {0: prompts[0]}, cls)
        toks.update(_serve(eng, {1: prompts[1]}, cls))
        runs.append((toks, eng.metrics()["prefix_cache"],
                     eng.metrics()["pool"]))
    assert runs[0] == runs[1]
    toks, pc, pool = runs[1]
    assert toks == off
    assert pc["cow_copies"] >= 1 and pc["cached_tokens"] == 2 * PS - 1
    assert pool["used_pages"] == pc["trie_pages"]


def test_trie_eviction_under_pool_pressure(setup):
    jcfg = setup[0]
    rng = np.random.default_rng(8)
    a, b = rng.integers(0, jcfg.vocab, 16), rng.integers(0, jcfg.vocab, 20)
    runs = []
    for eng, cls in zip(_engines(setup, batch_size=1, max_len=32, page_size=4,
                                 n_pages=9, prefix_cache=True),
                        (JRequest, Request)):
        toks = _serve(eng, {0: a}, cls, new=2)
        trie0 = eng.metrics()["prefix_cache"]["trie_pages"]
        toks.update(_serve(eng, {1: b}, cls))
        runs.append((toks, trie0, eng.metrics()["prefix_cache"]))
    assert runs[0] == runs[1]
    assert runs[1][1] == 4 and runs[1][2]["evictions"] >= 1
    assert len(runs[1][0][1]) == MAX_NEW


def test_defrag_keeps_cached_prefixes_hitting(setup):
    prompts = setup[4]
    off = _baseline(setup)
    runs = []
    for eng, cls in zip(_engines(setup, prefix_cache=True), (JRequest, Request)):
        _serve(eng, {u: prompts[u] for u in (0, 1)}, cls)
        eng._rt.defrag()  # also the ledger check: raises on a leaked page
        cached0 = eng.metrics()["prefix_cache"]["cached_tokens"]
        toks = _serve(eng, {u: prompts[u] for u in (2, 3)}, cls)
        runs.append(({u: toks[u] for u in (2, 3)},
                     eng.metrics()["prefix_cache"]["cached_tokens"] - cached0,
                     eng.metrics()["pool"]))
    assert runs[0] == runs[1]
    assert runs[1][0] == {u: off[u] for u in (2, 3)}
    assert runs[1][1] >= 2 * 16


def test_ownership_stress_no_leaks_no_double_frees(setup):
    """Admit / preempt / evict / defrag / rollback over a tight pool with
    sharing and speculation on: tokens equal the baseline's and the
    reference's, the periodic defrag never finds a leak, and clearing the
    trie drains the pool to zero references."""
    prompts = setup[4]
    base = _baseline(setup, spec=_spec())
    runs = []
    for eng, cls in zip(_engines(setup, spec=_spec(), batch_size=3,
                                 page_size=4, n_pages=12,
                                 admission="optimistic", prefill_chunk=4,
                                 prefix_cache=True), (JRequest, Request)):
        for u, p in prompts.items():
            eng.submit(cls(uid=u, prompt=p, max_new_tokens=MAX_NEW))
        ticks = 0
        while eng.step() or eng.queue:
            ticks += 1
            if ticks % 5 == 0:
                eng._rt.defrag()
        m = eng.metrics()
        runs.append(({u: list(r.generated) for u, r in eng.done.items()},
                     ticks, {k: m[k] for k in COUNTERS}, m["prefix_cache"],
                     m["spec"], m["pool"]))
        sched = eng._rt
        assert m["pool"]["used_pages"] == m["prefix_cache"]["trie_pages"]
        sched.prefix.clear(sched.pool)
        assert sched.pool.used_pages == 0 and sum(sched.pool._ref) == 0
    assert runs[0] == runs[1]
    assert runs[1][0] == base


def test_from_artifact_plumbs_prefix_cache(setup, tmp_path):
    jcfg, _, art, _, prompts = setup
    d = jsave(str(tmp_path / "art"), art)
    eng = ServeEngine.from_artifact(d, batch_size=2, max_len=48, page_size=PS,
                                    prefix_cache=True, device="cpu")
    assert eng._rt.prefix is not None
    _serve(eng, {u: prompts[u] for u in (0, 1)}, Request, new=2)
    assert eng.metrics()["prefix_cache"]["lookups"] == 2


# ---------------------------------------------------------------------------
# the CI serve smoke's model, from a JAX-written artifact
# ---------------------------------------------------------------------------
def ci_smoke_cfg():
    """``examples/serve_da.py::build_cfg``: qwen3 family, 4 layers, d 256,
    4 heads over 2 KV heads of 64, d_ff 768, vocab 8000, float32."""
    return dataclasses.replace(
        ARCHS["qwen3-8b"], name="qwen3-20m", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=768, vocab=8000,
        param_dtype="float32", compute_dtype="float32", remat=False,
        moe_dropless=True)


def ci_smoke_requests(request_cls, n, shared_len, vocab=8000):
    """The smoke's requests (``examples/serve_da.py``): a shared prefix of
    ``shared_len`` tokens, 4–23 own tokens, 8–23 new tokens, seed 0."""
    rng = np.random.default_rng(0)
    shared = rng.integers(0, vocab, shared_len)
    return [request_cls(uid=u, prompt=np.concatenate(
        [shared, rng.integers(0, vocab, rng.integers(4, 24))]).astype(np.int32),
        max_new_tokens=int(rng.integers(8, 24))) for u in range(n)]


@pytest.fixture(scope="module")
def ci_artifact(tmp_path_factory):
    cfg = ci_smoke_cfg()
    art = jfreeze(jinit(jax.random.key(0), cfg), JDA(x_signed=True),
                  mode="bitplane_stacked", model_cfg=cfg)
    return jsave(str(tmp_path_factory.mktemp("ci") / "smoke_da"), art)


#: request 2 of the prefix leg leaves the reference's tokens at this token
CI_PREFIX_PARTS = {2: 16}


def test_ci_smoke_prefix_leg(ci_artifact):
    """``--requests 4 --batch 2 --prefix-cache`` on the smoke artifact: the
    cache changes no token, its counters are the reference's, and so are
    its tokens: requests 0, 1 and 3 whole, request 2 before its token 16."""
    runs = {}
    for pc in (False, True):
        eng = ServeEngine.from_artifact(ci_artifact, batch_size=2, max_len=96,
                                        prefix_cache=pc, device="cpu")
        for r in ci_smoke_requests(Request, 4, 32):
            eng.submit(r)
        done = eng.run()
        runs[pc] = ({u: list(r.generated) for u, r in done.items()},
                    eng.metrics())
    assert runs[True][0] == runs[False][0]
    ref = JServeEngine.from_artifact(ci_artifact, batch_size=2, max_len=96,
                                     prefix_cache=True)
    for r in ci_smoke_requests(JRequest, 4, 32):
        ref.submit(r)
    jdone = ref.run()
    assert sorted(jdone) == sorted(runs[True][0]) == [0, 1, 2, 3]
    for u, toks in runs[True][0].items():
        jtoks = [int(t) for t in jdone[u].generated]
        n = CI_PREFIX_PARTS.get(u, max(len(toks), len(jtoks)))  # else whole
        assert len(toks) == len(jtoks) and toks[:n] == jtoks[:n], u
    m, jm = runs[True][1], ref.metrics()
    assert m["prefix_cache"] == jm["prefix_cache"]
    assert m["prefix_cache"]["hits"] >= 2
    assert m["pool"]["used_pages"] == m["prefix_cache"]["trie_pages"]
