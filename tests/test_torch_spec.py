"""PyTorch port vs the JAX reference: speculative decoding.

Partial-bits evaluation (``x_bits_eff`` and the ``x_bits_override`` context)
on every DA backend of the port, integer accumulators bit-exact to the
masked-codes product and to the reference; the acceptance math; and spec
serving with all three draft providers on the CPU.  Both packages serve the
same weights (``reduce_for_smoke(qwen3-8b)``, frozen with the reference's
``bitplane_stacked``, carried across by ``params_from_jax``) and the same
seeded numpy prompts: spec tokens must equal plain tokens and the
reference's, every spec counter must equal the reference's, and no page may
leak.  Float outputs of the DA linear agree with the reference to 1e-6
relative (the codes are identical; only float32 op scheduling differs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core import engine as jeng
from repro.core.da import DAConfig as JDA
from repro.core.freeze import freeze_model as jfreeze
from repro.core.freeze import save_artifact as jsave
from repro.models.model import count_params as jcount
from repro.models.model import init_model as jinit
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro.spec import SpecConfig as JSpec
from repro.spec import breakeven_acceptance as jbreakeven
from repro.spec import greedy_accept as jaccept
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import engine as teng
from repro_torch.core.da import DAConfig
from repro_torch.models.model import count_params
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.spec import SpecConfig, breakeven_acceptance, greedy_accept
from repro_torch.spec.decode import make_fused_draft

MAX_NEW = 4
#: every spec counter the two schedulers report, compared exactly
SPEC_KEYS = ("provider", "gamma", "cost_ratio", "rounds", "draft_steps",
             "verify_steps", "drafted_tokens", "accepted_drafts",
             "acceptance_rate", "bonus_tokens", "draft_compiles",
             "verify_compiles", "disable_floor", "disabled_requests",
             "enabled_requests")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs in several worker processes at once; torch's CPU ops
    in each take one thread (restored after the module) instead of one per
    core, which the workers would share."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# acceptance math
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("draft,verify", [
    ([5, 6], [1, 2, 3]), ([1, 6], [1, 2, 3]), ([1, 2], [1, 2, 3]),
    ([9, 2], [1, 2, 3]), ([7], [7, 1]), ([4, 4, 4, 4], [4, 4, 4, 9, 2])])
def test_greedy_accept_matches_reference(draft, verify):
    assert greedy_accept(draft, verify) == jaccept(draft, verify)


def test_greedy_accept_rejects_a_short_window():
    with pytest.raises(ValueError):
        greedy_accept([1, 2], [1, 2])


@pytest.mark.parametrize("gamma,c", [(4, 0.5), (8, 1.5), (2, -1.0), (2, 0.25)])
def test_breakeven_matches_reference(gamma, c):
    assert breakeven_acceptance(gamma, c) == jbreakeven(gamma, c)


def test_count_params_matches_reference():
    for name in ("qwen3-8b",):
        jcfg = dataclasses.replace(reduce_for_smoke(ARCHS[name]),
                                   moe_dropless=True)
        assert count_params(treg.reduce_for_smoke(treg.get(name))) == \
            jcount(jcfg)
    assert count_params(treg.get("qwen3-8b")) == jcount(ARCHS["qwen3-8b"])


# ---------------------------------------------------------------------------
# partial-bits evaluation on every backend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["lut", "onehot", "pallas_lut", "bitplane",
                                  "bitplane_stacked", "pallas_bitplane"])
@pytest.mark.parametrize("eff", [8, 6, 4, 1])
def test_da_vmm_x_bits_eff_equals_masked_codes(mode, eff):
    """``x_bits_eff`` keeps the top planes: exactly the low-bit-masked codes'
    product, and the reference's accumulator (its ``lut`` backend)."""
    rng = np.random.default_rng(eff)
    cfg = DAConfig(x_signed=True)
    w = rng.normal(size=(37, 11)).astype(np.float32)
    tp = teng.pack_weights(_t(w), cfg, mode="lut")
    jp = jeng.pack_weights(jnp.asarray(w), JDA(x_signed=True), mode="lut")
    xq = rng.integers(-128, 128, (3, 37)).astype(np.int32)
    got = teng.da_vmm(_t(xq), tp, mode=mode, x_bits_eff=eff).numpy()
    masked = (xq & ~((1 << (8 - eff)) - 1)).astype(np.int64)
    np.testing.assert_array_equal(got, masked @ tp.wq.numpy().astype(np.int64))
    np.testing.assert_array_equal(got, np.asarray(jeng.da_vmm(
        jnp.asarray(xq), jp, mode="lut", x_bits_eff=eff)))
    with teng.x_bits_override(eff):  # the context drives calls with no arg
        np.testing.assert_array_equal(
            teng.da_vmm(_t(xq), tp, mode=mode).numpy(), got)
    if eff < 8:
        assert not np.array_equal(got, teng.da_vmm(_t(xq), tp, mode=mode).numpy())


def test_effective_x_bits_resolution():
    cfg = DAConfig(x_bits=8, x_signed=True)
    assert teng.effective_x_bits(cfg, None) == 8
    assert teng.effective_x_bits(cfg, 12) == 8
    with teng.x_bits_override(3):
        assert teng.effective_x_bits(cfg, None) == 3
        assert teng.effective_x_bits(cfg, 5) == 5  # the call site wins
        with teng.x_bits_override(None):
            assert teng.effective_x_bits(cfg, None) == 8
    assert teng.effective_x_bits(cfg, None) == 8
    with pytest.raises(ValueError):
        teng.effective_x_bits(cfg, 0)


@pytest.mark.parametrize("mode", ["bitplane_stacked", "pallas_bitplane",
                                  "pallas_lut"])
def test_da_matmul_x_bits_eff_and_override_match_reference(mode):
    rng = np.random.default_rng(9)
    w = rng.normal(size=(32, 16)).astype(np.float32)
    x = rng.normal(size=(3, 32)).astype(np.float32)
    tp = teng.pack_weights(_t(w), mode=mode)
    jp = jeng.pack_weights(jnp.asarray(w), mode="lut")
    full = teng.da_matmul(_t(x), tp).numpy()
    np.testing.assert_array_equal(full, teng.da_matmul(_t(x), tp,
                                                       x_bits_eff=8).numpy())
    y4 = teng.da_matmul(_t(x), tp, x_bits_eff=4).numpy()
    assert not np.array_equal(y4, full)
    np.testing.assert_allclose(y4, np.asarray(jeng.da_matmul(
        jnp.asarray(x), jp, mode="lut", x_bits_eff=4)), rtol=1e-6, atol=1e-7)
    with teng.x_bits_override(4):
        np.testing.assert_array_equal(teng.da_matmul(_t(x), tp).numpy(), y4)
    np.testing.assert_array_equal(teng.da_matmul(_t(x), tp).numpy(), full)


@pytest.mark.parametrize("mode", ["pallas_bitplane", "pallas_lut"])
def test_da_qkv_matmul_x_bits_eff_equals_separate_calls(mode):
    """The fused pass truncates the shared codes once: equal to three
    truncated da_matmul calls and to the reference's fused pass."""
    from repro_torch.core.freeze import freeze_model_da

    rng = np.random.default_rng(5)
    ws = [rng.normal(size=(32, n)).astype(np.float32) / 6 for n in (16, 8, 8)]
    x = rng.normal(size=(2, 3, 32)).astype(np.float32)
    packs = freeze_model_da({"wq": _t(ws[0]), "wk": _t(ws[1]), "wv": _t(ws[2])},
                            mode=mode, device="cpu")
    packs = [packs[n] for n in ("wq", "wk", "wv")]
    jps = [jeng.pack_weights(jnp.asarray(w), mode="bitplane") for w in ws]
    ref = jeng.da_qkv_matmul(jnp.asarray(x), jps, x_bits_eff=5)
    got = teng.da_qkv_matmul(_t(x), packs, x_bits_eff=5)
    with teng.x_bits_override(5):
        ctx = teng.da_qkv_matmul(_t(x), packs)
    for g, c, r, p in zip(got, ctx, ref, packs):
        np.testing.assert_array_equal(
            g.numpy(), teng.da_matmul(_t(x), p, x_bits_eff=5).numpy())
        np.testing.assert_array_equal(g.numpy(), c.numpy())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)


def test_fused_draft_feeds_its_own_tokens_at_increasing_positions():
    """The fused loop: first feed at the caller's positions, then gamma-1
    single-token steps, each fed the previous argmax at the next position."""
    calls = []

    def step(params, caches, tokens, positions, table, last_idx):
        calls.append((tokens.tolist(), positions.tolist(), last_idx.tolist()))
        logits = torch.zeros(tokens.shape[0], 50)
        nxt = (tokens[torch.arange(tokens.shape[0]), last_idx.long()] * 3
               + positions[torch.arange(tokens.shape[0]), last_idx.long()]) % 50
        logits[torch.arange(tokens.shape[0]), nxt.long()] = 1.0
        return logits, caches

    fused = make_fused_draft(step, gamma=3)
    tokens = torch.tensor([[4, 7, 0], [9, 0, 0]], dtype=torch.int32)
    positions = torch.tensor([[5, 6, 30], [2, 30, 30]], dtype=torch.int32)
    drafts, _ = fused(None, "c", tokens, positions, None,
                      torch.tensor([1, 0], dtype=torch.int32))
    assert drafts.tolist() == [[27, 38, 22], [29, 40, 24]]
    assert [c[1] for c in calls[1:]] == [[[7], [3]], [[8], [4]]]
    assert [c[0] for c in calls[1:]] == [[[27], [29]], [[38], [40]]]
    assert drafts.dtype == torch.int32


# ---------------------------------------------------------------------------
# serving: token identity, leak freedom, counters, for all three providers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]),
                               moe_dropless=True)
    tcfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    params = jinit(jax.random.key(0), jcfg)
    art = jfreeze(params, JDA(x_signed=True), mode="bitplane_stacked",
                  model_cfg=jcfg)
    rng = np.random.default_rng(7)
    prompts = {u: rng.integers(0, jcfg.vocab, 3 + u).astype(np.int32)
               for u in range(4)}
    dcfg = (dataclasses.replace(jcfg, n_layers=1, name="draft"),
            dataclasses.replace(tcfg, n_layers=1, name="draft"))
    dparams = jinit(jax.random.key(1), dcfg[0])
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, art=art, prompts=prompts,
                dcfg=dcfg, dparams=dparams,
                tparams=params_from_jax(jax.tree.map(np.asarray, params)),
                tfrozen=params_from_jax(jax.tree.map(np.asarray, art.params)),
                tdraft=params_from_jax(jax.tree.map(np.asarray, dparams)))


def _specs(s, provider, **kw):
    """(reference, port) SpecConfig and params for ``provider``."""
    if provider == "layerskip":
        common = dict(provider="layerskip", gamma=2, disable_below=0.0, **kw)
        return JSpec(**common), SpecConfig(**common), s["params"], s["tparams"]
    if provider == "artifact":
        common = dict(provider="artifact", gamma=2, disable_below=0.0, **kw)
        return (JSpec(draft_params=s["dparams"], draft_model_cfg=s["dcfg"][0],
                      **common),
                SpecConfig(draft_params=s["tdraft"],
                           draft_model_cfg=s["dcfg"][1], **common),
                s["art"].params, s["tfrozen"])
    common = dict(provider="bitplane", gamma=2, draft_x_bits=6,
                  disable_below=0.0)
    common.update(kw)
    return JSpec(**common), SpecConfig(**common), s["art"].params, s["tfrozen"]


def _serve(eng, prompts, cls, steps=None):
    for uid, pr in prompts.items():
        eng.submit(cls(uid=uid, prompt=pr, max_new_tokens=MAX_NEW))
    if steps is not None:
        for _ in range(steps):
            eng.step()
        eng._rt.defrag()
    done = eng.run()
    return {u: list(r.generated) for u, r in done.items()}, eng.metrics()


def _pair(s, jspec, tspec, jparams, tparams, steps=None, **kw):
    kw = dict(dict(batch_size=2, max_len=32, page_size=4), **kw)
    ref = JServeEngine(s["jcfg"], jparams, spec=jspec, **kw)
    ours = ServeEngine(s["tcfg"], tparams, spec=tspec, device="cpu", **kw)
    return (_serve(ours, s["prompts"], Request, steps),
            _serve(ref, s["prompts"], JRequest, steps))


_PLAIN: dict = {}


def _plain(s, frozen: bool):
    """Plain (no spec) tokens of the fixture's prompts on the frozen or the
    float weights, served once in both packages (asserted equal), then
    remembered for the module."""
    if frozen not in _PLAIN:
        params = (s["art"].params, s["tfrozen"]) if frozen else (
            s["params"], s["tparams"])
        (ours, _), (ref, _) = _pair(s, None, None, *params)
        assert ours == ref
        _PLAIN[frozen] = ours
    return _PLAIN[frozen]


@pytest.mark.parametrize("provider", ["bitplane", "layerskip", "artifact"])
def test_spec_decode_token_identical_and_leak_free(setup, provider):
    jspec, tspec, jparams, tparams = _specs(setup, provider)
    base = _plain(setup, frozen=provider != "layerskip")
    (out, m), (ref, jm) = _pair(setup, jspec, tspec, jparams, tparams)
    assert out == base == ref
    assert {k: m["spec"][k] for k in SPEC_KEYS} == \
        {k: jm["spec"][k] for k in SPEC_KEYS}
    assert m["spec"]["rounds"] > 0 and m["spec"]["provider"] == provider
    assert m["pool"]["used_pages"] == 0 and m["pool"] == jm["pool"]
    assert m["ctx_tokens"] == jm["ctx_tokens"] and m["steps"] == jm["steps"]


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_spec_on_quantized_pages_leaves_no_draft_row(setup, kv_dtype):
    """Draft rows are quantized into int8 / int4 pages; verify overwrites
    them and rollback releases the rejected suffix, so spec tokens equal the
    plain serve's on the same pages, and the reference's."""
    jspec, tspec, jparams, tparams = _specs(setup, "bitplane")
    plain = ServeEngine(setup["tcfg"], tparams, batch_size=2, max_len=32,
                        page_size=4, kv_dtype=kv_dtype, device="cpu")
    base, _ = _serve(plain, setup["prompts"], Request)
    (out, m), (ref, jm) = _pair(setup, jspec, tspec, jparams, tparams,
                                kv_dtype=kv_dtype)
    assert out == base == ref
    assert m["spec"] == jm["spec"] and m["spec"]["rounds"] > 0
    assert m["kv"]["kv_dtypes"] == {"pos_0": kv_dtype}
    assert m["pool"]["used_pages"] == 0 and m["pool"] == jm["pool"]


def test_spec_acceptance_ema_auto_disable(setup):
    """1-bit drafts are noise: the EMA floor switches speculation off per
    request, and the tokens stay the baseline's."""
    jspec, tspec, jparams, tparams = _specs(
        setup, "bitplane", draft_x_bits=1, warmup_rounds=1, disable_below=None)
    base = _plain(setup, frozen=True)
    (out, m), (ref, jm) = _pair(setup, jspec, tspec, jparams, tparams)
    assert out == base == ref
    assert m["spec"] == jm["spec"]
    assert m["spec"]["disabled_requests"] >= 1
    assert m["spec"]["enabled_requests"] < len(setup["prompts"])
    assert m["spec"]["acceptance_rate"] < m["spec"]["disable_floor"]


def test_spec_metrics_surface_in_scheduler(setup):
    jspec, tspec, jparams, tparams = _specs(setup, "bitplane")
    (_, m), _ = _pair(setup, jspec, tspec, jparams, tparams)
    s = m["spec"]
    assert set(SPEC_KEYS) == set(s)
    assert s["draft_steps"] == s["gamma"] * s["verify_steps"]
    assert s["drafted_tokens"] == s["gamma"] * s["rounds"]
    assert s["rounds"] >= s["verify_steps"] > 0
    plain = ServeEngine(setup["tcfg"], tparams, batch_size=2, max_len=32,
                        page_size=4, device="cpu")
    assert _serve(plain, setup["prompts"], Request)[1]["spec"] is None


def test_artifact_draft_survives_defrag_and_chunked_catch_up(setup):
    """The draft's own pools move under the target's remap when defrag
    renumbers pages, and long catch-ups go in prefill-chunk slices."""
    jspec, tspec, jparams, tparams = _specs(setup, "artifact")
    kw = dict(prefill_chunk=4)
    (base, _), _ = _pair(setup, None, None, jparams, tparams, steps=3, **kw)
    (out, m), (ref, jm) = _pair(setup, jspec, tspec, jparams, tparams, steps=3,
                                **kw)
    assert out == base == ref
    assert m["spec"] == jm["spec"] and m["pool"]["used_pages"] == 0


@pytest.mark.parametrize("gamma", [1, 3])
def test_spec_gamma_matches_reference(setup, gamma):
    jspec, tspec, jparams, tparams = _specs(setup, "bitplane", gamma=gamma,
                                            draft_x_bits=5)
    base = _plain(setup, frozen=True)
    (out, m), (ref, jm) = _pair(setup, jspec, tspec, jparams, tparams)
    assert out == base == ref and m["spec"] == jm["spec"]


def test_spec_config_and_engine_validation(setup):
    s = setup
    kw = dict(batch_size=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="gamma"):
        SpecConfig(gamma=0)
    with pytest.raises(ValueError, match="ema_alpha"):
        SpecConfig(ema_alpha=0.0)
    with pytest.raises(ValueError, match="greedy"):
        ServeEngine(s["tcfg"], s["tfrozen"], greedy=False,
                    spec=SpecConfig(provider="bitplane"), **kw)
    with pytest.raises(ValueError, match="bit-planes"):
        ServeEngine(s["tcfg"], s["tparams"], spec="bitplane", **kw)
    with pytest.raises(ValueError, match="draft_x_bits"):
        ServeEngine(s["tcfg"], s["tfrozen"],
                    spec=SpecConfig(draft_x_bits=9), **kw)
    with pytest.raises(ValueError, match="draft_periods"):
        ServeEngine(s["tcfg"], s["tparams"],
                    spec=SpecConfig(provider="layerskip", draft_periods=5), **kw)
    with pytest.raises(ValueError, match="unknown draft provider"):
        ServeEngine(s["tcfg"], s["tfrozen"],
                    spec=SpecConfig(provider="telepathy"), **kw)
    with pytest.raises(ValueError, match="draft_artifact"):
        ServeEngine(s["tcfg"], s["tfrozen"],
                    spec=SpecConfig(provider="artifact"), **kw)
    with pytest.raises(ValueError, match="vocab"):
        ServeEngine(s["tcfg"], s["tfrozen"], spec=SpecConfig(
            provider="artifact", draft_params=s["tdraft"],
            draft_model_cfg=dataclasses.replace(s["dcfg"][1], vocab=50)), **kw)
    eng = ServeEngine(s["tcfg"], s["tfrozen"], spec="layerskip", **kw)
    assert eng._rt.spec.provider == "layerskip"


def test_draft_artifact_from_disk(setup, tmp_path):
    """``draft_artifact=DIR``: a JAX-written draft artifact drives the
    port's artifact provider, tokens equal the reference's."""
    s = setup
    dart = jfreeze(s["dparams"], JDA(x_signed=True), mode="bitplane_stacked",
                   model_cfg=s["dcfg"][0])
    d = jsave(str(tmp_path / "draft"), dart)
    common = dict(provider="artifact", gamma=2, draft_artifact=d,
                  disable_below=0.0)
    (out, m), (ref, jm) = _pair(s, JSpec(**common), SpecConfig(**common),
                                s["art"].params, s["tfrozen"])
    assert out == ref and m["spec"] == jm["spec"]


# ---------------------------------------------------------------------------
# the CI serve smoke's spec leg, from a JAX-written artifact
# ---------------------------------------------------------------------------
def test_ci_smoke_spec_leg(tmp_path):
    """``--requests 2 --artifact DIR --spec bitplane --spec-gamma 2`` (draft
    bits 4, batch 4) on the smoke artifact: the port's plain and spec tokens
    both equal the reference's plain tokens for every request, rounds ran,
    nothing leaked."""
    cfg = dataclasses.replace(  # examples/serve_da.py::build_cfg
        ARCHS["qwen3-8b"], name="qwen3-20m", n_layers=4, d_model=256,
        n_heads=4, n_kv_heads=2, head_dim=64, d_ff=768, vocab=8000,
        param_dtype="float32", compute_dtype="float32", remat=False,
        moe_dropless=True)
    d = jsave(str(tmp_path / "smoke_da"), jfreeze(
        jinit(jax.random.key(0), cfg), JDA(x_signed=True),
        mode="bitplane_stacked", model_cfg=cfg))

    def serve(eng, request_cls):
        rng = np.random.default_rng(0)  # the smoke's requests, seed 0
        shared = rng.integers(0, cfg.vocab, 0)  # no shared prefix off the cache
        for u in range(2):
            eng.submit(request_cls(uid=u, prompt=np.concatenate([shared, rng.integers(
                0, cfg.vocab, rng.integers(4, 24))]).astype(np.int32),
                max_new_tokens=int(rng.integers(8, 24))))
        done = eng.run()
        return {u: [int(t) for t in r.generated] for u, r in done.items()}, eng.metrics()

    runs = {}
    for spec in (None, SpecConfig(provider="bitplane", gamma=2, draft_x_bits=4)):
        runs[spec is None] = serve(ServeEngine.from_artifact(
            d, batch_size=4, max_len=96, spec=spec, device="cpu"), Request)
    ref, _ = serve(JServeEngine.from_artifact(d, batch_size=4, max_len=96),
                   JRequest)
    assert len(ref) == 2
    assert runs[True][0] == ref and runs[False][0] == ref
    m = runs[False][1]
    assert m["spec"]["rounds"] > 0 and m["pool"]["used_pages"] == 0
