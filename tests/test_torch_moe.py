"""PyTorch port vs the JAX reference: the MoE layer, stacked-expert DA, and
qwen2-moe-a2.7b served on the paged runtime.

The same seeded numpy inputs and the reference's ``init_moe`` weights
(carried with ``params_from_jax`` / ``to_tensor``) go through both
packages.  Tolerances: routing integers (dispatch slots, expert choices,
capacities) and DA codes, scales and LUTs EQUAL; float MoE outputs atol
2e-5, rtol 2e-4 in float32 (summation order differs); the stacked-expert
``dense`` against the reference's at rtol 1e-6 (the integer products are
exact in both, only the dequantization's float32 products remain); served
greedy tokens EQUAL.
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
from repro.core import freeze as jfreeze_mod
from repro.core.freeze import freeze_model as jfreeze
from repro.models import moe as jmoe
from repro.models.model import init_model as jinit
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core import engine as teng
from repro_torch.core.da import DAConfig
from repro_torch.models import moe as tmoe
from repro_torch.serve.engine import Request, ServeEngine

TOL = dict(atol=2e-5, rtol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch CPU thread per xdist worker (restored after the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _cfgs(**changes):
    """Reduced qwen2-moe-a2.7b (6 experts padded to 16, top-2, 2 shared) in
    both packages."""
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen2-moe-a2.7b"]),
                               **changes)
    tcfg = dataclasses.replace(treg.reduce_for_smoke(treg.get("qwen2-moe-a2.7b")),
                               **changes)
    return jcfg, tcfg


_LAYERS = {}


def _layer(frozen: bool = False):
    """One MoE layer of the reduced model in both packages: float, or frozen
    by the reference's ``bitplane_stacked`` freeze of the whole model."""
    if frozen not in _LAYERS:
        jcfg, _ = _cfgs(moe_dropless=True)
        params = jinit(jax.random.key(0), jcfg)
        if frozen:
            params = jfreeze(params, JDA(x_signed=True), mode="bitplane_stacked",
                             model_cfg=jcfg).params
        jp = jax.tree.map(lambda a: a[0], params["periods"]["pos_0"]["ffn"])
        tp = params_from_jax(jax.tree.map(np.asarray, params))["blocks"][0]["ffn"]
        _LAYERS[frozen] = (jp, tp)
    return _LAYERS[frozen]


@pytest.mark.parametrize("group,dropless,factor", [
    (1, False, 1.25), (7, False, 1.25), (64, False, 1.25), (64, False, 0.1),
    (1024, False, 2.0), (64, True, 1.25), (5, True, 0.1)])
def test_capacity_matches_reference(group, dropless, factor):
    jcfg, tcfg = _cfgs(moe_dropless=dropless, capacity_factor=factor)
    assert tmoe.capacity(tcfg, group) == jmoe.capacity(jcfg, group)


def test_padded_experts_and_init_match_reference():
    for name in ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b"):
        assert tmoe.padded_experts(treg.get(name)) == jmoe.padded_experts(ARCHS[name])
    jcfg, tcfg = _cfgs()
    ours = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg)
    ref = jmoe.init_moe(jax.random.key(0), jcfg)
    shapes = lambda t: {k: (v if isinstance(v, dict) else tuple(v.shape))  # noqa: E731
                        for k, v in t.items()}
    assert shapes(ours).keys() == shapes(ref).keys()
    for k in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(ours[k].shape) == tuple(ref[k].shape), k
    assert ours["router"].dtype == torch.float32
    # the padded experts are zero: never routed, exact no-ops
    assert not ours["w_up"][tcfg.n_experts:].any()
    assert ours["w_up"][:tcfg.n_experts].abs().sum() > 0


def _gates(g, s, e, n_real, seed, tie: bool):
    """Routing probabilities [G, S, E] over ``n_real`` experts (the rest
    zero, as the -inf logits leave them); ``tie`` gives token 0 of every
    group two equal top gates and token 1 three equal gates at the
    top-k boundary."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(g, s, e)).astype(np.float32)
    if tie:
        logits[:, 0, 1] = logits[:, 0, 4] = 3.0
        logits[:, 1, 0] = logits[:, 1, 2] = logits[:, 1, 5] = 2.5
    logits[..., n_real:] = -np.inf
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("cap", [9, 3, 1])
@pytest.mark.parametrize("tie", [False, True])
def test_topk_dispatch_matches_reference(tie, cap):
    """Slot-major dispatch and combine with ties broken to the lower expert
    index, as ``jax.lax.top_k`` breaks them; capacity 3 and 1 drop."""
    gates = _gates(2, 9, 16, 6, seed=1, tie=tie)
    jd, jc = jmoe._topk_dispatch(jnp.asarray(gates), 2, cap)
    td, tc = tmoe._topk_dispatch(_t(gates), 2, cap)
    assert torch.equal(td, _t(np.asarray(jd)))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    if tie:  # token 0 picks experts 1 and 4, token 1 picks 0 and 2 (not 5)
        assert td[0, 0, [1, 4]].sum() == 2 or cap < 9
        assert td[0, 1, 5].sum() == 0 and td[0, 1, 0].sum() == 1


@pytest.mark.parametrize("cap", [9, 3, 1])
@pytest.mark.parametrize("tie", [False, True])
def test_sorted_dispatch_matches_reference(tie, cap):
    gates = _gates(2, 9, 16, 6, seed=2, tie=tie)
    jt, jw = jmoe._sorted_dispatch(jnp.asarray(gates), 3, cap)
    tt, tw = tmoe._sorted_dispatch(_t(gates), 3, cap)
    assert torch.equal(tt, _t(np.asarray(jt)).long())
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)


def test_top_k_breaks_ties_to_the_lower_index():
    gates = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3, 0.0]])
    w, i = tmoe._top_k(gates, 2)
    assert i.tolist() == [[1, 2]]
    jw, ji = jax.lax.top_k(jnp.asarray(gates.numpy()), 2)
    assert i.tolist() == np.asarray(ji).tolist()
    np.testing.assert_allclose(w.numpy(), [[0.5, 0.5]])


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("impl", ["dense", "sorted"])
def test_moe_forward_matches_reference(impl, frozen):
    """Dropless, with 2 shared experts and 10 padded experts, float and
    frozen (stacked-expert packs)."""
    jcfg, tcfg = _cfgs(moe_dropless=True, moe_impl=impl)
    jp, tp = _layer(frozen)
    if frozen:
        assert isinstance(tp["w_gate"], teng.PackedWeights)
        assert tp["w_gate"].wq.shape == (16, 64, 32)
        assert isinstance(tp["shared"]["w_up"], teng.PackedWeights)
    x = np.random.default_rng(3).normal(size=(2, 7, jcfg.d_model)).astype(np.float32)
    jy = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    ty = tmoe.moe_forward(tp, _t(x), tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("impl", ["dense", "sorted"])
def test_moe_forward_with_drops_and_groups_matches_reference(impl):
    """Capacity factor 0.5 over groups of 8 tokens (3 groups, the last one
    padded): tokens overflow and drop alike in both packages."""
    jcfg, tcfg = _cfgs(moe_dropless=False, capacity_factor=0.5,
                       moe_group_size=8, moe_impl=impl)
    jp, tp = _layer()
    x = np.random.default_rng(4).normal(size=(2, 11, jcfg.d_model)).astype(np.float32)
    jy = np.asarray(jmoe.moe_forward(jp, jnp.asarray(x), jcfg))
    ty = tmoe.moe_forward(tp, _t(x), tcfg).numpy()
    np.testing.assert_allclose(ty, jy, **TOL)
    full = tmoe.moe_forward(tp, _t(x), dataclasses.replace(tcfg, moe_dropless=True))
    assert np.abs(ty - full.numpy()).max() > 1e-4  # something was dropped


# ---------------------------------------------------------------------------
# Stacked-expert PackedWeights
# ---------------------------------------------------------------------------


def _experts(e=5, k=24, n=16, seed=0):
    return np.random.default_rng(seed).normal(size=(e, k, n)).astype(np.float32)


@pytest.mark.parametrize("with_luts", [False, True])
def test_stacked_pack_is_bit_exact_to_reference(with_luts):
    w = _experts()
    j = jeng.pack_weights(jnp.asarray(w), JDA(x_signed=True), mode="auto",
                          with_luts=with_luts)
    t = teng.pack_weights(_t(w), DAConfig(x_signed=True), mode="auto",
                          with_luts=with_luts)
    assert t.wq.dtype == torch.int8 and t.wq.shape == (5, 24, 16)
    assert t.w_scale.shape == (5, 1, 16) and t.k == 24 and t.n == 16
    assert torch.equal(t.wq, to_tensor(np.asarray(j.wq)))
    assert torch.equal(t.w_scale, to_tensor(np.asarray(j.w_scale)))
    if with_luts:
        assert t.luts.shape == tuple(j.luts.shape)
        assert torch.equal(t.luts, to_tensor(np.asarray(j.luts)))
    else:
        assert t.luts is None and j.luts is None


def test_stacked_pack_equals_the_stack_of_expert_packs():
    """bfloat16 experts, as the card packs them expert by expert."""
    w = _t(_experts(e=4, k=16, n=8, seed=1)).to(torch.bfloat16)
    stacked = teng.pack_weights(w, with_luts=True)
    views = stacked.experts()
    assert len(views) == 4 and stacked.experts() is views  # built once
    for i in range(4):
        one = teng.pack_weights(w[i], with_luts=True)
        assert torch.equal(views[i].wq, one.wq)
        assert torch.equal(views[i].w_scale, one.w_scale)
        assert torch.equal(views[i].luts, one.luts)
        assert views[i].wq.data_ptr() == stacked.wq[i].data_ptr()


@pytest.mark.parametrize("override", [None, 4])
@pytest.mark.parametrize("mode", ["lut", "onehot", "pallas_lut", "bitplane",
                                  "bitplane_stacked", "pallas_bitplane", "int8",
                                  "auto"])
def test_dense_on_stacked_pack_matches_reference(mode, override):
    """``dense`` on an [E, K, N] pack against [E, C, K] and grouped
    [G, E, C, K] activations, through every registered backend, at full
    precision and under ``x_bits_override(4)`` (the draft's planes)."""
    w = _experts(e=3, k=16, n=8, seed=2)
    rng = np.random.default_rng(5)
    j = jeng.pack_weights(jnp.asarray(w), mode=mode, with_luts=True)
    t = teng.pack_weights(_t(w), mode=mode, with_luts=True)
    for shape in ((3, 4, 16), (2, 3, 4, 16)):
        x = rng.normal(size=shape).astype(np.float32)
        with jeng.x_bits_override(override):
            jy = np.asarray(jeng.dense(jnp.asarray(x), j))
        with teng.x_bits_override(override):
            ty = teng.dense(_t(x), t)
        assert ty.shape == shape[:-1] + (8,) and ty.dtype == torch.float32
        np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-6, atol=1e-6)


def test_float_dense_on_stacked_weights_matches_reference():
    w = _experts(e=3, k=16, n=8, seed=3)
    rng = np.random.default_rng(6)
    for shape in ((3, 4, 16), (2, 3, 4, 16)):
        x = rng.normal(size=shape).astype(np.float32)
        np.testing.assert_allclose(
            teng.dense(_t(x), _t(w)).numpy(),
            np.asarray(jeng.dense(jnp.asarray(x), jnp.asarray(w))), **TOL)


# ---------------------------------------------------------------------------
# qwen2-moe-a2.7b on the paged runtime
# ---------------------------------------------------------------------------


@pytest.fixture
def empty_cost_tables():
    """``da_mode="auto"`` plans from the analytic model in both packages."""
    teng.set_cost_table({})
    jeng.set_cost_table({})
    yield
    teng.set_cost_table(None)
    jeng.set_cost_table(None)


KW = dict(batch_size=2, max_len=32, page_size=8)


def _serve(eng, request_cls, vocab, seed=0):
    rng = np.random.default_rng(seed)
    for u, n in enumerate((5, 9, 12)):
        eng.submit(request_cls(uid=u, prompt=rng.integers(0, vocab, n).astype(
            np.int32), max_new_tokens=5))
    done = eng.run()
    return {u: list(done[u].generated) for u in sorted(done)}


_MODELS = {}


def _model(**changes):
    """The reduced qwen2-moe (dropless, as the reference's server runs it)
    in both packages, its q/k/v biases drawn from a numpy seed."""
    key = tuple(sorted(changes.items()))
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(moe_dropless=True, **changes)
        rng = np.random.default_rng(1)

        def draw(path, a):
            if getattr(path[-1], "key", None) in ("bq", "bk", "bv"):
                return jnp.asarray(0.3 * rng.normal(size=a.shape), a.dtype)
            return a

        params = jax.tree_util.tree_map_with_path(
            draw, jinit(jax.random.key(0), jcfg))
        _MODELS[key] = (jcfg, tcfg, params,
                        params_from_jax(jax.tree.map(np.asarray, params)))
    return _MODELS[key]


@pytest.mark.parametrize("mode", [None, "bitplane_stacked", "auto"])
def test_paged_serve_matches_reference(mode, empty_cost_tables):
    """``runtime="auto"`` is the paged runtime for an attention-only MoE;
    greedy tokens EQUAL to the reference's, float and frozen by the engine
    (stacked-expert packs through the registered backend, one call per
    expert)."""
    jcfg, tcfg, params, tparams = _model()
    ref = JServeEngine(jcfg, params, da_mode=mode, **KW)
    ours = ServeEngine(tcfg, tparams, da_mode=mode, device="cpu", **KW)
    assert ours.runtime == ref.runtime == "paged"
    if mode is not None:
        assert ours.params["blocks"][0]["ffn"]["w_down"].wq.shape == (16, 32, 64)
    assert _serve(ours, Request, tcfg.vocab) == _serve(ref, JRequest, jcfg.vocab)


def test_per_position_kv_dtypes_boot_from_artifact(tmp_path):
    """An attention-only MoE with ``moe_period=2`` (period 2: a MoE block,
    then an MLP block), frozen by the reference with int8 pages at position
    0 and fp16 at position 1, boots through the port's ``from_artifact``
    with those KV dtypes and serves the reference's tokens; a global
    ``kv_dtype`` that would flatten them raises."""
    jcfg, tcfg, params, _ = _model(moe_period=2, d_ff=128)
    assert tcfg.period == 2 and tcfg.n_layers == 2
    assert (tcfg.ffn_kind(0), tcfg.ffn_kind(1)) == ("moe", "mlp")
    directory = str(tmp_path / "art")
    jfreeze_mod.save_artifact(directory, jfreeze(
        params, mode="bitplane_stacked", model_cfg=jcfg,
        kv_dtype_overrides={"pos_0": "int8"}))
    ours = ServeEngine.from_artifact(directory, device="cpu", **KW)
    assert ours._rt.kv_dtypes == {"pos_0": "int8", "pos_1": "fp16"}
    assert ours.caches["pos_0"].k.dtype == torch.int8
    assert ours.caches["pos_1"].k.dtype == torch.float32
    with pytest.raises(ValueError, match="per-layer KV dtypes"):
        ServeEngine.from_artifact(directory, kv_dtype="int8", device="cpu", **KW)
    ref = JServeEngine.from_artifact(directory, **KW)
    assert _serve(ours, Request, tcfg.vocab, seed=3) == \
        _serve(ref, JRequest, jcfg.vocab, seed=3)
