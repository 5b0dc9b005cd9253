"""PyTorch port vs the JAX reference: the fixed-slot runtime, the paged
runtime on M-RoPE positions, and dense-variant artifacts across packages.

Both packages serve the same weights (the reference's ``init_model`` of a
``reduce_for_smoke`` config, carried across by ``params_from_jax``) on the
CPU with the same seeded numpy prompts, float and frozen by the engine
(``bitplane_stacked``, and ``auto`` with both cost tables set empty, so both
planners take the analytic ranking).  Greedy tokens must be EQUAL, and so
must the counters, the ``metrics()`` keys, ``warmup()``'s count and the
trace recorder's event sequence: the port's slot runtime makes the
reference's decisions.
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
from repro.models.model import forward as jforward
from repro.models.model import init_caches as jinit_caches
from repro.models.model import init_model as jinit
from repro.serve import engine as jengine
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import engine as teng
from repro_torch.models.model import init_caches
from repro_torch.serve import engine as tengine
from repro_torch.serve.engine import Request, ServeEngine

MAX_NEW = 6
KW = dict(batch_size=2, max_len=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch CPU thread per xdist worker (restored after the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def empty_cost_tables():
    """``da_mode="auto"`` plans from the analytic model in both packages."""
    teng.set_cost_table({})
    jeng.set_cost_table({})
    yield
    teng.set_cost_table(None)
    jeng.set_cost_table(None)


_CACHE = {}


def _model(name: str, **changes):
    key = (name, tuple(sorted(changes.items())))
    if key not in _CACHE:
        jcfg = dataclasses.replace(reduce_for_smoke(ARCHS[name]), **changes)
        tcfg = dataclasses.replace(treg.reduce_for_smoke(treg.get(name)),
                                   **changes)
        params = jinit(jax.random.key(0), jcfg)
        _CACHE[key] = (jcfg, tcfg, params,
                       params_from_jax(jax.tree.map(np.asarray, params)))
    return _CACHE[key]


def _prompts(vocab: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {u: rng.integers(0, vocab, n).astype(np.int32)
            for u, n in enumerate((5, 9, 3, 12, 17))}


def _serve(eng, prompts, request_cls):
    for u, p in prompts.items():
        eng.submit(request_cls(uid=u, prompt=p, max_new_tokens=MAX_NEW))
    done = eng.run()
    return {u: list(done[u].generated) for u in sorted(done)}


def _events(eng):
    return [(e.name, e.ph, e.track) for e in eng.obs.tracer.events]


@pytest.mark.parametrize("mode", [None, "bitplane_stacked", "auto"])
@pytest.mark.parametrize("name", ["qwen3-8b", "minitron-8b"])
def test_slot_serve_matches_reference(name, mode):
    """Tokens, counters, metrics() keys and the traced event sequence."""
    jcfg, tcfg, params, tparams = _model(name)
    ref = JServeEngine(jcfg, params, runtime="slots", da_mode=mode, trace=True,
                       **KW)
    ours = ServeEngine(tcfg, tparams, runtime="slots", da_mode=mode,
                       trace=True, device="cpu", **KW)
    prompts = _prompts(jcfg.vocab)
    assert _serve(ours, prompts, Request) == _serve(ref, prompts, JRequest)
    assert ours.runtime == ref.runtime == "slots"
    mr, mo = ref.metrics(), ours.metrics()
    assert mo.keys() == mr.keys()
    for key in ("runtime", "requests_done", "out_tokens", "prefill_compiles"):
        assert mo[key] == mr[key], key
    assert mo["prefill_compiles"] == 4   # buckets 4, 8, 16 and 32
    sr, so = ref.metrics_snapshot(), ours.metrics_snapshot()
    for series in ("slot_prefill_compiles", "sched_out_tokens"):
        assert so[series] == sr[series], series
    assert _events(ours) == _events(ref)
    assert ours.obs.tracer.span_balance() == {}


@pytest.mark.parametrize("name", ["qwen3-8b", "minitron-8b"])
def test_slot_warmup_matches_reference(name):
    """warmup() runs every bucket and the decode step, counts each bucket
    as a compile, and leaves the served tokens alone."""
    jcfg, tcfg, params, tparams = _model(name)
    ref = JServeEngine(jcfg, params, runtime="slots", **KW)
    ours = ServeEngine(tcfg, tparams, runtime="slots", device="cpu", **KW)
    assert ours.warmup() == ref.warmup() == 5    # 4, 8, 16, 32 and decode
    assert ours.metrics()["prefill_compiles"] == \
        ref.metrics()["prefill_compiles"] == 4
    assert not ours.caches["pos_0"].k.any()
    prompts = _prompts(jcfg.vocab, seed=1)
    assert _serve(ours, prompts, Request) == _serve(ref, prompts, JRequest)
    assert ours.metrics()["prefill_compiles"] == 4


def test_slot_steps_match_reference():
    """The slot prefill (into slot 1 of a warm batch tree) and a decode step
    of both packages give the same logits and cache rows (atol 1e-5)."""
    jcfg, tcfg, params, tparams = _model("minitron-8b")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (1, 8)).astype(np.int32)
    jc = jinit_caches(jcfg, 2, 16, np.float32)
    tc = init_caches(tcfg, 2, 16, torch.float32, device="cpu")
    pos = np.arange(8, dtype=np.int32)[None]
    jl, jc = jengine.make_prefill_into_slot(jcfg, 16)(
        params, jc, toks, pos, np.array([5], np.int32), np.int32(1))
    tl, tc = tengine.make_prefill_into_slot(tcfg, 16)(
        tparams, tc, torch.from_numpy(toks), torch.from_numpy(pos),
        torch.tensor([5], dtype=torch.int32), 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(tc["pos_0"].k.numpy(),
                               np.asarray(jc["pos_0"].k), atol=1e-5)
    assert tc["pos_0"].length.tolist() == np.asarray(jc["pos_0"].length).tolist()
    step = np.array([[7], [3]], np.int32)
    spos = np.array([[0], [6]], np.int32)
    jl, _ = jengine.make_serve_step(jcfg)(params, jc, step, spos)
    tl, _ = tengine.make_serve_step(tcfg)(tparams, tc, torch.from_numpy(step),
                                          torch.from_numpy(spos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    # the plain prefill step: the last position's logits of a batch prefill
    jl, _ = jengine.make_prefill_step(jcfg)(
        params, jinit_caches(jcfg, 1, 16, np.float32), toks, pos)
    tl, _ = tengine.make_prefill_step(tcfg)(
        tparams, init_caches(tcfg, 1, 16, torch.float32, device="cpu"),
        torch.from_numpy(toks), torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


@pytest.mark.parametrize("knob,match", [
    (dict(kv_dtype="int8"), "quantized KV"),
    (dict(kv_dtypes={"pos_0": "int4"}), "quantized KV"),
    (dict(paged_attn="fused"), "paged_attn"),
    (dict(spec="bitplane"), "speculative"),
    (dict(prefix_cache=True), "prefix caching"),
    (dict(analysis_debug=True), "analysis_debug"),
    (dict(runtime="ring"), "unknown runtime"),
])
def test_paged_only_knobs_raise_under_slots(knob, match):
    jcfg, tcfg, params, tparams = _model("qwen3-8b")
    kw = dict(runtime="slots", **KW)
    kw.update(knob)
    with pytest.raises(ValueError, match=match):
        JServeEngine(jcfg, params, **kw)
    with pytest.raises(ValueError, match=match):
        ServeEngine(tcfg, tparams, device="cpu", **kw)


def test_runtime_auto_is_paged_for_attention_stacks():
    jcfg, tcfg, params, tparams = _model("minitron-8b")
    assert ServeEngine(tcfg, tparams, device="cpu", **KW).runtime == \
        JServeEngine(jcfg, params, **KW).runtime == "paged"


def test_slot_sampling_is_seeded():
    """greedy=False draws from each request's seeded generator: two serves
    give the same tokens."""
    _, tcfg, _, tparams = _model("qwen3-8b")
    prompts = _prompts(tcfg.vocab, seed=2)
    runs = [_serve(ServeEngine(tcfg, tparams, runtime="slots", greedy=False,
                               device="cpu", **KW), prompts, Request)
            for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(len(t) == MAX_NEW for t in runs[0].values())


@pytest.mark.parametrize("runtime", ["paged", "slots"])
def test_text_mrope_model_serves_like_reference(runtime):
    """A text variant of reduced qwen2-vl (M-RoPE sections (4, 6, 6), q/k/v
    biases): positions reach the model as [B, T, 3] through mk_positions;
    the paged read takes their first coordinate.  Tokens EQUAL."""
    jcfg, tcfg, params, tparams = _model("qwen2-vl-72b", modality="text")
    assert tcfg.mrope_sections == (4, 6, 6) and tcfg.attn_bias
    kw = dict(KW, page_size=8) if runtime == "paged" else KW
    ref = JServeEngine(jcfg, params, runtime=runtime,
                       da_mode="bitplane_stacked", **kw)
    ours = ServeEngine(tcfg, tparams, runtime=runtime,
                       da_mode="bitplane_stacked", device="cpu", **kw)
    prompts = _prompts(jcfg.vocab, seed=4)
    assert _serve(ours, prompts, Request) == _serve(ref, prompts, JRequest)


@pytest.mark.parametrize("provider", ["bitplane", "layerskip"])
def test_text_mrope_model_spec_serve_equals_plain(provider):
    """Speculative decoding on the text qwen2-vl: the fused draft loop keeps
    [B, T, 3] positions; greedy tokens EQUAL the plain paged serve's."""
    from repro_torch.spec import SpecConfig

    _, tcfg, _, tparams = _model("qwen2-vl-72b", modality="text")
    kw = dict(KW, page_size=8, runtime="paged", da_mode="bitplane_stacked",
              device="cpu")
    prompts = _prompts(tcfg.vocab, seed=7)
    plain = _serve(ServeEngine(tcfg, tparams, **kw), prompts, Request)
    spec = ServeEngine(tcfg, tparams, spec=SpecConfig(
        provider, gamma=2, disable_below=0.0), **kw)
    assert _serve(spec, prompts, Request) == plain
    assert spec.metrics()["spec"]["rounds"] > 0


def test_text_mrope_model_logits_match_with_three_coordinates():
    """The text qwen2-vl's paged forward with [B, T, 3] positions equals the
    reference's (atol 2e-4)."""
    from repro.serve.kvcache import init_paged_caches as jpaged
    from repro_torch.models.model import forward
    from repro_torch.serve.kvcache import init_paged_caches as tpaged
    from repro_torch.spec.decode import mk_positions

    jcfg, tcfg, params, tparams = _model("qwen2-vl-72b", modality="text")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (2, 5)).astype(np.int32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    table = np.array([[1, 2, 0], [3, 4, 0]], np.int32)
    jl, _ = jforward(params, jnp.asarray(toks), jcfg,
                     positions=jnp.asarray(np.stack([pos] * 3, -1)),
                     caches=jpaged(jcfg, 6, 4, jnp.float32), update_cache=True,
                     page_table=jnp.asarray(table))
    tl, _ = forward(tparams, torch.from_numpy(toks), tcfg,
                    mk_positions(tcfg, torch.from_numpy(pos)),
                    tpaged(tcfg, 6, 4, torch.float32, device="cpu"),
                    torch.from_numpy(table))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)


@pytest.mark.parametrize("frozen_in", ["reference", "port"])
def test_minitron_artifact_boots_in_the_other_package(tmp_path, frozen_in):
    """Reduced minitron-8b (squared-ReLU MLP without w_gate, LayerNorm with
    biases) frozen with bitplane_stacked in one package, saved, booted by
    the other's ``from_artifact`` and served on both runtimes: tokens EQUAL
    to the freezing package's serve."""
    jcfg, tcfg, params, tparams = _model("minitron-8b")
    prompts = _prompts(jcfg.vocab, seed=6)
    directory = str(tmp_path / "art")
    if frozen_in == "reference":
        art = jfreeze(params, JDA(x_signed=True), mode="bitplane_stacked",
                      model_cfg=jcfg)
        jsave(directory, art)
        want = _serve(JServeEngine(jcfg, art.params, runtime="slots", **KW),
                      prompts, JRequest)
        for runtime in ("slots", "paged"):
            eng = ServeEngine.from_artifact(directory, runtime=runtime,
                                            device="cpu", **KW)
            assert eng.cfg.mlp_act == "relu2" and eng.cfg.norm_type == "layernorm"
            assert "w_gate" not in eng.params["blocks"][0]["ffn"]
            assert _serve(eng, prompts, Request) == want
    else:
        eng = ServeEngine(tcfg, tparams, runtime="slots",
                          da_mode="bitplane_stacked", device="cpu", **KW)
        eng.save_artifact(directory)
        want = _serve(eng, prompts, Request)
        for runtime in ("slots", "paged"):
            ref = JServeEngine.from_artifact(directory, runtime=runtime, **KW)
            assert ref.cfg.mlp_act == "relu2"
            assert _serve(ref, prompts, JRequest) == want


def test_embedding_model_artifact_has_no_embed_table(tmp_path):
    """musicgen-large (embedding inputs, GELU, LayerNorm): the frozen tree
    has no embed table, and an artifact saved by the port boots in the
    reference with equal leaves."""
    from repro.core.freeze import load_artifact as jload
    from repro_torch.core.freeze import freeze_model

    jcfg, tcfg, params, tparams = _model("musicgen-large")
    art = freeze_model(tparams, mode="bitplane_stacked", model_cfg=tcfg,
                       device="cpu")
    assert "embed" not in art.params
    tengine_art = str(tmp_path / "mg")
    from repro_torch.core.freeze import save_artifact

    save_artifact(tengine_art, art)
    back = jload(tengine_art)
    assert back.model_cfg.modality == "audio" and "embed" not in back.params
    ours = art.params["blocks"][1]["ffn"]["w_up"].wq.numpy()
    assert np.array_equal(np.asarray(back.params["periods"]["pos_0"]["ffn"]
                                     ["w_up"].wq)[1], ours)
