"""PyTorch port vs the JAX reference: the MoE, Mamba-2 and hybrid families.

The four configs that use them (mamba2-780m, qwen2-moe-a2.7b,
moonshot-v1-16b-a3b, jamba-1.5-large-398b) through ``reduce_for_smoke``,
dropless MoE as the reference's server runs it: weights from the
reference's ``init_model`` with biases, norm scales and the Mamba ``D`` /
``dt_bias`` / ``norm_scale`` / ``conv_b`` drawn from a numpy seed, carried
across by ``params_from_jax``, float and frozen (``bitplane_stacked``);
tokens from a numpy seed.  Serves run both packages on the CPU with the same
prompts (few distinct lengths: the reference's slot runtime compiles a
recurrent stack's prefill once per exact length).

Tolerances: logits float32 at atol 2e-4, rtol 2e-3 (the reference's own
bound for its decode-vs-forward test); parameter counts, plans, cost-table
rows and greedy tokens EQUAL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core import engine as jeng
from repro.core import freeze as jfreeze
from repro.core.da import DAConfig as JDA
from repro.models.model import count_active_params as jcount_active
from repro.models.model import count_params as jcount
from repro.models.model import forward as jforward
from repro.models.model import init_caches as jinit_caches
from repro.models.model import init_model as jinit
from repro.obs.hwcost import HardwareCostModel as JHardwareCostModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core import engine as teng
from repro_torch.core import freeze as tfreeze
from repro_torch.core.engine import PackedWeights
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import MambaCache
from repro_torch.models.model import (
    count_active_params,
    count_params,
    forward,
    init_caches,
    init_model,
)
from repro_torch.obs.hwcost import HardwareCostModel
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.kvcache import init_paged_caches

NEW = ("mamba2-780m", "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b",
       "jamba-1.5-large-398b")
TOL = dict(atol=2e-4, rtol=2e-3)
MAX_NEW = 5
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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _cfgs(name: str, **changes):
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS[name]), moe_dropless=True,
                               **changes)
    tcfg = dataclasses.replace(treg.reduce_for_smoke(treg.get(name)),
                               moe_dropless=True, **changes)
    return jcfg, tcfg


def _drawn(tree, seed: int = 1):
    """The reference's params with biases, norm scales and the Mamba
    constants drawn from a numpy seed instead of their zeros and ones."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = getattr(path[-1], "key", None)
        if name in ("bq", "bk", "bv", "bias", "conv_b", "dt_bias"):
            return jnp.asarray(0.3 * rng.normal(size=a.shape), a.dtype)
        if name in ("scale", "norm_scale", "D"):
            return jnp.asarray(1.0 + 0.2 * rng.normal(size=a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, tree)


_CACHE = {}


def _model(name: str, frozen: bool = False, **changes):
    """(jax cfg, port cfg, jax params, port params) for a reduced config."""
    key = (name, frozen, tuple(sorted(changes.items())))
    if key not in _CACHE:
        jcfg, tcfg = _cfgs(name, **changes)
        params = _drawn(jinit(jax.random.key(0), jcfg))
        if frozen:
            params = jfreeze.freeze_model(params, JDA(x_signed=True),
                                          mode="bitplane_stacked",
                                          model_cfg=jcfg).params
        _CACHE[key] = (jcfg, tcfg, params,
                       params_from_jax(jax.tree.map(np.asarray, params)))
    return _CACHE[key]


def _tokens_in(cfg, b: int, t: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t)).astype(np.int32)


# ---------------------------------------------------------------------------
# Configs, parameter trees and counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NEW)
def test_configs_match_reference(name):
    """Every field and derived shape equals the reference's, full size and
    reduced; the layer pattern (mixer and FFN per position) too."""
    for jcfg, tcfg in ((ARCHS[name], treg.get(name)),
                       (reduce_for_smoke(ARCHS[name]),
                        treg.reduce_for_smoke(treg.get(name)))):
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        for prop in ("period", "n_periods", "d_inner", "ssm_heads",
                     "conv_channels"):
            assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
        assert [(tcfg.mixer_kind(p), tcfg.ffn_kind(p)) for p in range(tcfg.period)] \
            == [(jcfg.mixer_kind(p), jcfg.ffn_kind(p)) for p in range(jcfg.period)]


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_full_size_param_counts_match_reference(name):
    """All ten configs of the zoo, at full size: the port's init tree
    (shapes on the meta device) counts the reference's parameters, and the
    MoE configs' active parameters alike."""
    cfg = treg.get(name)
    assert count_params(cfg) == jcount(ARCHS[name])
    assert count_active_params(cfg) == jcount_active(ARCHS[name])


@pytest.mark.parametrize("name", NEW)
def test_init_tree_matches_reference(name):
    """The port's init tree has the reference's leaves and shapes per
    layer: Mamba mixers, no FFN on ssm blocks, stacked experts, a float32
    router and the shared expert."""
    _, tcfg, _, tparams = _model(name)
    ours = init_model(tcfg, seed=0, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(ours) == shapes(tparams)
    for i, bp in enumerate(ours["blocks"]):
        pos = i % tcfg.period
        assert ("in_proj" in bp["mixer"]) == (tcfg.mixer_kind(pos) == "mamba")
        assert ("ffn" in bp) == (tcfg.ffn_kind(pos) != "none")
        assert ("router" in bp.get("ffn", {})) == (tcfg.ffn_kind(pos) == "moe")


def test_unknown_config_fields_still_raise():
    raw = dataclasses.asdict(reduce_for_smoke(ARCHS["jamba-1.5-large-398b"]))
    from repro_torch.models.config import ModelConfig

    assert ModelConfig.from_manifest(raw) == treg.reduce_for_smoke(
        treg.get("jamba-1.5-large-398b"))
    with pytest.raises(ValueError, match="whole periods"):
        dataclasses.replace(treg.get("jamba-1.5-large-398b"), n_layers=12).n_periods


# ---------------------------------------------------------------------------
# Forward, caches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("name", NEW)
def test_forward_without_cache_matches(name, frozen):
    jcfg, tcfg, params, tparams = _model(name, frozen)
    x = _tokens_in(jcfg, 2, 11)
    jl, _ = jforward(params, jnp.asarray(x), jcfg)
    tl, caches = forward(tparams, _t(x), tcfg)
    assert caches is None and tl.shape == (2, 11, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("name", NEW)
def test_prefill_then_decode_matches(name, frozen):
    """Prefill 8 positions into ``init_caches`` (KVCache at attention
    positions, MambaCache at Mamba positions), then decode 4 one by one:
    every step's logits equal the port's full forward at that position and,
    for float weights, the reference's cached steps (whose MambaCache rows
    equal the port's in-place ones).  Frozen weights are held against the
    port's own forward: across packages a float32 ulp may move one
    activation code (test_forward_without_cache_matches holds frozen logits
    across packages)."""
    jcfg, tcfg, params, tparams = _model(name, frozen)
    b, t, t0 = 2, 12, 8
    x = _tokens_in(jcfg, b, t, seed=2)
    full, _ = forward(tparams, _t(x), tcfg)
    caches = init_caches(tcfg, b, 20, torch.float32, device="cpu")
    for pos in range(tcfg.period):
        kind = MambaCache if tcfg.mixer_kind(pos) == "mamba" else KVCache
        assert isinstance(caches[f"pos_{pos}"], kind)
    jc = jinit_caches(jcfg, b, 20, jnp.float32)
    pos = np.broadcast_to(np.arange(t0, dtype=np.int32)[None], (b, t0))
    lg, _ = forward(tparams, _t(x[:, :t0]), tcfg, _t(pos), caches,
                    update_cache=True)
    np.testing.assert_allclose(lg.numpy(), full[:, :t0].numpy(), **TOL)
    if not frozen:
        jl, jc = jforward(params, jnp.asarray(x[:, :t0]), jcfg,
                          positions=jnp.asarray(pos), caches=jc,
                          update_cache=True)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    for step in range(t0, t):
        p1 = np.full((b, 1), step, np.int32)
        lg, _ = forward(tparams, _t(x[:, step:step + 1]), tcfg, _t(p1), caches)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, step].numpy(), **TOL)
        if not frozen:
            jl, jc = jforward(params, jnp.asarray(x[:, step:step + 1]), jcfg,
                              positions=jnp.asarray(p1), caches=jc)
            np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    if not frozen:
        for key, c in caches.items():
            if isinstance(c, MambaCache):
                np.testing.assert_allclose(c.ssm.numpy(), np.asarray(jc[key].ssm),
                                           **TOL)
                np.testing.assert_allclose(c.conv.numpy(),
                                           np.asarray(jc[key].conv), **TOL)


# ---------------------------------------------------------------------------
# Freeze, plans and cost tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_plan_freeze_and_costs_match_reference(name):
    """The analytic plan, the packed leaves (stacked experts bit-exact),
    the hardware-cost rows (every expert counted, ``periods/pos_j`` keys)
    and ``da_memory_report`` (no ``kv`` block for a stack with Mamba
    layers) equal the reference's."""
    jcfg, tcfg, params, tparams = _model(name)
    jart = jfreeze.freeze_model(params, mode="auto", model_cfg=jcfg)
    tart = tfreeze.freeze_model(tparams, mode="auto", model_cfg=tcfg,
                                device="cpu")
    as_json = lambda plan: {k: p.to_json() for k, p in plan.items()}  # noqa: E731
    assert as_json(tart.plan) == as_json(jart.plan)
    assert as_json(tfreeze.plan_model(tparams, period=tcfg.period)) == \
        as_json(jfreeze.plan_model(params))
    ref = params_from_jax(jax.tree.map(np.asarray, jart.params))
    for (path, ours), (_, theirs) in zip(tfreeze.packed_leaves(tart.params),
                                         tfreeze.packed_leaves(ref)):
        assert torch.equal(ours.wq, theirs.wq), path
        assert torch.equal(ours.w_scale, theirs.w_scale), path
    stacked = [p for k, p in tfreeze.packed_leaves(tart.params) if p.wq.ndim == 3]
    assert stacked and all(p.wq.shape[0] == 16 for p in stacked)
    assert all(not isinstance(v, PackedWeights)
               for bp in tart.params["blocks"]
               for k, v in bp.get("ffn", {}).items() if k == "router")
    ours = HardwareCostModel.from_frozen(tart.params, tart.plan, period=tcfg.period)
    theirs = JHardwareCostModel.from_frozen(jart.params, jart.plan)
    assert ours.layer_table() == theirs.layer_table()
    assert ours.summary() == theirs.summary()
    mem = tfreeze.da_memory_report(tart.params, tcfg)
    jmem = jfreeze.da_memory_report(jart.params, jcfg)
    assert mem == jmem
    assert ("kv" in mem) == (name == "qwen2-moe-a2.7b")


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _prompts(vocab: int, lengths, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {u: rng.integers(0, vocab, n).astype(np.int32)
            for u, n in enumerate(lengths)}


def _serve(eng, prompts, request_cls):
    for u, p in prompts.items():
        eng.submit(request_cls(uid=u, prompt=p, max_new_tokens=MAX_NEW))
    done = eng.run()
    return {u: list(done[u].generated) for u in sorted(done)}


#: each model's runtime and prompt lengths (one length for the recurrent
#: stack: one slot prefill compile in the reference).  qwen2-moe's serve
#: against the reference is in test_torch_moe.py, mamba2's in
#: test_torch_mamba.py; here it serves the artifact tests.
SERVES = {"jamba-1.5-large-398b": ("slots", (9, 9, 9)),
          "qwen2-moe-a2.7b": ("paged", (5, 9, 12))}
_SERVED = {}


def _jax_tokens(name, mode):
    """The reference's greedy tokens for a model and freeze mode (one
    engine per key per module)."""
    if (name, mode) not in _SERVED:
        jcfg, _, params, _ = _model(name)
        runtime, lengths = SERVES[name]
        kw = dict(KW, page_size=8) if runtime == "paged" else dict(KW)
        ref = JServeEngine(jcfg, params, runtime=runtime, da_mode=mode, **kw)
        _SERVED[(name, mode)] = _serve(ref, _prompts(jcfg.vocab, lengths),
                                       JRequest)
    return _SERVED[(name, mode)]


@pytest.mark.parametrize("mode", [None, "bitplane_stacked", "auto"])
@pytest.mark.parametrize("name", ["jamba-1.5-large-398b"])
def test_serve_matches_reference(name, mode):
    """The hybrid stack on the slot runtime (``runtime="auto"`` picks it):
    greedy tokens EQUAL to the reference's, float and frozen by the engine
    (``bitplane_stacked`` and the analytic ``auto`` plan)."""
    _, tcfg, _, tparams = _model(name)
    runtime, lengths = SERVES[name]
    kw = dict(KW, page_size=8) if runtime == "paged" else dict(KW)
    ours = ServeEngine(tcfg, tparams, da_mode=mode, device="cpu", **kw)
    assert ours.runtime == runtime
    got = _serve(ours, _prompts(tcfg.vocab, lengths), Request)
    assert got == _jax_tokens(name, mode)
    if runtime == "slots":  # recurrent stacks prefill at the exact length
        assert ours.metrics()["prefill_compiles"] == len(set(lengths))


def test_paged_pool_refuses_a_mamba_position():
    for name in ("mamba2-780m", "jamba-1.5-large-398b"):
        _, tcfg = _cfgs(name)
        with pytest.raises(ValueError, match="attention mixers only"):
            init_paged_caches(tcfg, 8, 4, torch.float32, device="cpu")
        with pytest.raises(ValueError, match="attention mixers only"):
            ServeEngine(tcfg, _model(name)[3], runtime="paged", device="cpu",
                        **KW)
    _, tcfg = _cfgs("qwen2-moe-a2.7b")
    assert ServeEngine(tcfg, _model("qwen2-moe-a2.7b")[3], device="cpu",
                       **KW).runtime == "paged"


# ---------------------------------------------------------------------------
# Artifacts across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_jax_artifact_serves_in_port(name, tmp_path):
    """Frozen and saved by the reference (``bitplane_stacked``), booted by
    the port: stacked-expert packs and Mamba float leaves cross, and the
    tokens equal the reference engine's on the same freeze."""
    jcfg, _, params, _ = _model(name)
    runtime, lengths = SERVES[name]
    kw = dict(KW, page_size=8) if runtime == "paged" else dict(KW)
    directory = str(tmp_path / "art")
    JServeEngine(jcfg, params, runtime=runtime, da_mode="bitplane_stacked",
                 **kw).save_artifact(directory)
    ours = ServeEngine.from_artifact(directory, device="cpu", **kw)
    assert ours.runtime == runtime
    ffn = ours.params["blocks"][1]["ffn"]
    assert ffn["w_up"].wq.shape == (16, 64, 32) and ffn["router"].dtype == torch.float32
    got = _serve(ours, _prompts(jcfg.vocab, lengths), Request)
    assert got == _jax_tokens(name, "bitplane_stacked")


@pytest.mark.parametrize("name", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_port_artifact_serves_in_jax(name, tmp_path):
    """Frozen and saved by the port (the analytic ``auto`` plan), booted by
    the reference: the reference's tokens on its boot equal the port's."""
    jcfg, tcfg, _, tparams = _model(name)
    runtime, lengths = SERVES[name]
    kw = dict(KW, page_size=8) if runtime == "paged" else dict(KW)
    ours = ServeEngine(tcfg, tparams, da_mode="auto", device="cpu", **kw)
    directory = ours.save_artifact(str(tmp_path / "art"))
    art = jfreeze.load_artifact(directory)
    assert all(getattr(art.model_cfg, f.name) == getattr(tcfg, f.name)
               for f in dataclasses.fields(tcfg))
    pos = "pos_1" if name == "jamba-1.5-large-398b" else "pos_0"
    w_up = art.params["periods"][pos]["ffn"]["w_up"]
    assert w_up.wq.shape == (jcfg.n_periods, 16, 64, 32)
    ref = JServeEngine.from_artifact(directory, **kw)
    prompts = _prompts(jcfg.vocab, lengths)
    assert _serve(ref, prompts, JRequest) == _serve(ours, prompts, Request)
