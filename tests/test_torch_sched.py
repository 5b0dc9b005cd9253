"""PyTorch port vs the JAX reference: the scheduler's knobs — optimistic
admission with preemption (prefix cache on and off), prefill chunking and
lanes, the token budget, warmup, the metrics surface, sampling, and the
knob not ported yet (``analysis_debug``).

Both packages serve the same frozen weights (the reference's
``bitplane_stacked`` freeze of ``reduce_for_smoke(qwen3-8b)``, carried across
by ``params_from_jax``) on the CPU, with the same seeded numpy prompts.
Greedy tokens must be equal, and so must every counter the two report:
the port's scheduler makes the reference's decisions.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core.da import DAConfig as JDA
from repro.core.freeze import freeze_model as jfreeze
from repro.models.model import init_model as jinit
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.spec import SpecConfig as JSpec
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.scheduler import PagedScheduler
from repro_torch.spec import SpecConfig

MAX_NEW = 4
PS = 8
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


def _spec():
    return dict(provider="bitplane", gamma=2, draft_x_bits=6, disable_below=0.0)


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_preemption_under_tight_pool(setup, prefix_cache):
    """Optimistic admission over a pool too small for every admitted lane's
    growth: the youngest lane is preempted and replayed, token-exactly."""
    prompts = setup[4]
    base = _baseline(setup)
    (toks, m), (ref, _), ours = _both(
        setup, prompts, batch_size=3, page_size=4, n_pages=12,
        admission="optimistic", prefill_chunk=4, prefix_cache=prefix_cache)
    assert toks == ref == base
    assert m["preemptions"] >= 1 and ours._rt.preemptions == m["preemptions"]
    assert m["pool"]["used_pages"] == (m["prefix_cache"]["trie_pages"]
                                       if prefix_cache else 0)


@pytest.mark.parametrize("knobs", [
    dict(prefill_chunk=4), dict(prefill_chunk=6, prefill_lanes=1),
    dict(prefill_chunk=4, token_budget=5), dict(batch_size=3, prefill_lanes=2)])
def test_scheduler_knobs_match_reference(setup, knobs):
    prompts = setup[4]
    base = _baseline(setup)
    (toks, m), (ref, _), ours = _both(setup, prompts, **knobs)
    assert toks == ref == base
    rt = ours._rt
    assert rt.prefill_chunk == knobs["prefill_chunk"] if "prefill_chunk" in knobs \
        else rt.prefill_chunk == 16


@pytest.mark.parametrize("spec", [None, "bitplane"])
def test_warmup_runs_the_reference_shapes(setup, spec):
    s = _spec() if spec else None
    ref, ours = _engines(setup, spec=s, batch_size=3, prefill_chunk=6)
    assert ours.warmup() == ref.warmup()
    assert ours.metrics()["step_compiles"] == ref.metrics()["step_compiles"]
    if spec:
        assert ours.metrics()["spec"]["verify_compiles"] == \
            ref.metrics()["spec"]["verify_compiles"]
    # warmup writes only the garbage page: serving afterwards is unchanged
    assert _serve(ours, setup[4], Request) == _baseline(setup, spec=s)


def test_metrics_keys_match_reference(setup):
    ref, ours = _engines(setup, spec=_spec(), prefix_cache=True)
    _serve(ref, setup[4], JRequest)
    _serve(ours, setup[4], Request)
    jm, tm = ref.metrics(), ours.metrics()
    assert set(tm) == set(jm)
    for block in ("pool", "kv", "spec", "prefix_cache"):
        assert set(tm[block]) == set(jm[block]), block
    for key in ("kv_dtypes", "bytes_per_token", "fp_bytes_per_token",
                "capacity_multiplier", "page_bytes", "used_bytes",
                "free_bytes", "pool_bytes"):
        assert tm["kv"][key] == jm["kv"][key], key
    # both derive the cost table from the frozen params
    assert set(tm["hw"]) == set(jm["hw"])
    assert tm["hw"]["tokens"] == jm["hw"]["tokens"]
    for name in ("steps", "out_tokens", "ctx_tokens", "preemptions",
                 "prefix_lookups", "prefix_hits", "cow_copies", "draft_steps",
                 "verify_steps", "spec_rounds", "drafted_tokens",
                 "accepted_drafts", "bonus_tokens", "spec_disabled",
                 "step_compiles", "draft_compiles", "verify_compiles"):
        assert getattr(ours._rt, name) == getattr(ref._rt, name), name


def test_knobs_not_yet_ported_raise_and_the_card_is_the_default(setup):
    _, tcfg, _, tparams, _ = setup
    with pytest.raises(NotImplementedError, match="Static analysis"):
        ServeEngine(tcfg, tparams, batch_size=2, max_len=16, device="cpu",
                    analysis_debug=True)
    with pytest.raises(ValueError, match="admission"):
        PagedScheduler(tcfg, tparams, batch_size=2, max_len=16,
                       admission="eager", device="cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="cuda"):
        PagedScheduler(tcfg, tparams, batch_size=2, max_len=16)


def test_sampling_is_seeded_and_in_vocab(setup):
    """greedy=False samples each token from its own seeded generator: two
    runs agree, and every token is in the vocabulary."""
    _, tcfg, _, tparams, prompts = setup
    out = []
    for _ in range(2):
        eng = ServeEngine(tcfg, tparams, batch_size=2, max_len=48, greedy=False,
                          page_size=PS, device="cpu")
        out.append(_serve(eng, prompts, Request))
    assert out[0] == out[1]
    assert all(0 <= t < tcfg.vocab for toks in out[0].values() for t in toks)
