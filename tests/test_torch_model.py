"""PyTorch port vs the JAX reference: layers, paged attention, the model.

Weights come from the reference's ``init_model`` on ``reduce_for_smoke
(qwen3-8b)`` and are carried across by ``params_from_jax``, float and frozen
(``pallas_bitplane``, Pallas in interpret mode on the JAX side).  Float32
throughout; layer outputs agree to atol 1e-5 (op-by-op the same roundings,
float32 summation order and transcendental implementations differ), logits
to atol 2e-4.  Frozen logits may in rare lanes move one activation code
across a rounding boundary, worth about ``amax / 127 * |w|``; the seeds here
do not, and the logits bound would catch one that went further.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core.da import DAConfig as JDA
from repro.core.freeze import freeze_model as jfreeze
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import forward as jforward
from repro.models.model import init_model as jinit
from repro.serve.kvcache import init_paged_caches as jcaches
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.core.engine import PackedWeights
from repro_torch.core.freeze import freeze_model, freeze_model_da
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.model import forward as tforward
from repro_torch.models.model import init_model
from repro_torch.serve.kvcache import init_paged_caches as tcaches
from repro_torch.serve.kvcache import pad_position, table_width

ATOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]),
                               moe_dropless=True)
    tcfg = dataclasses.replace(treg.reduce_for_smoke(treg.get("qwen3-8b")),
                               moe_dropless=True)
    params = jinit(jax.random.key(0), jcfg)
    frozen = jfreeze(params, JDA(x_signed=True), mode="pallas_bitplane",
                     model_cfg=jcfg).params
    return jcfg, tcfg, params, frozen


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def test_smoke_config_matches_reference(setup):
    jcfg, tcfg, _, _ = setup
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    full = treg.get("qwen3-8b")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim_, full.d_ff, full.vocab) == (36, 4096, 32, 8, 128,
                                                       12288, 151936)


def test_norms_and_rope_match(setup):
    jcfg, tcfg, params, _ = setup
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.apply_norm({"scale": _t(scale)}, _t(x), tcfg).numpy(),
        np.asarray(jlayers.apply_norm({"scale": jnp.asarray(scale)},
                                      jnp.asarray(x), jcfg)), atol=ATOL)
    xh = x.reshape(2, 5, 4, 16)
    np.testing.assert_allclose(
        tlayers.rms_norm_headwise(_t(xh), _t(scale[:16]), 1e-5).numpy(),
        np.asarray(jlayers.rms_norm_headwise(jnp.asarray(xh),
                                             jnp.asarray(scale[:16]), 1e-5)),
        atol=ATOL)
    pos = rng.integers(0, 300, (2, 5)).astype(np.int32)
    ang_t = tlayers.rope_angles(_t(pos), 16, 1e6)
    ang_j = jlayers.rope_angles(jnp.asarray(pos), 16, 1e6)
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), rtol=1e-6)
    np.testing.assert_allclose(tlayers.apply_rope(_t(xh), ang_t).numpy(),
                               np.asarray(jlayers.apply_rope(jnp.asarray(xh),
                                                             ang_j)), atol=1e-4)


@pytest.mark.parametrize("frozen", [False, True])
def test_mlp_matches(setup, frozen):
    jcfg, tcfg, params, fparams = setup
    tree = fparams if frozen else params
    jp = jax.tree.map(lambda a: a[0], tree["periods"]["pos_0"]["ffn"])
    tp = params_from_jax(_np(tree))["blocks"][0]["ffn"]
    assert isinstance(tp["w_up"], PackedWeights) is frozen
    x = np.random.default_rng(1).normal(size=(2, 3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.apply_mlp(tp, _t(x), tcfg).numpy(),
        np.asarray(jlayers.apply_mlp(jp, jnp.asarray(x), jcfg)), atol=ATOL)


def _paged_inputs(cfg, b=2, t=5, ps=4, max_len=16, seed=0):
    rng = np.random.default_rng(seed)
    w = table_width(max_len, ps)
    tokens = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    pos[1, 3:] = pad_position(max_len, ps)   # ragged row: two pad lanes
    table = np.zeros((b, w), np.int32)
    table[0, :2] = [3, 1]
    table[1, :2] = [2, 5]
    last = np.array([t - 1, 2], np.int32)
    return tokens, pos, table, last


@pytest.mark.parametrize("frozen", [False, True])
def test_attention_block_matches(setup, frozen):
    jcfg, tcfg, params, fparams = setup
    tree = fparams if frozen else params
    jp = jax.tree.map(lambda a: a[0], tree["periods"]["pos_0"]["mixer"])
    tp = params_from_jax(_np(tree))["blocks"][0]["mixer"]
    _, pos, table, _ = _paged_inputs(jcfg)
    x = np.random.default_rng(2).normal(size=(2, 5, 64)).astype(np.float32)
    jc = jax.tree.map(lambda a: a[0], jcaches(jcfg, 8, 4, jnp.float32)["pos_0"])
    jy, jnew = jattn.attention_forward(jp, jnp.asarray(x), jcfg,
                                       jnp.asarray(pos), jc, True,
                                       page_table=jnp.asarray(table))
    tc = tcaches(tcfg, 8, 4, torch.float32, device="cpu")["pos_0"].layer(0)
    ty = tattn.attention_forward(tp, _t(x), tcfg, _t(pos), tc, _t(table))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jnew.k), atol=ATOL)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jnew.v), atol=ATOL)


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("paged_attn", ["gather", "fused"])
def test_forward_logits_match(setup, frozen, paged_attn):
    jcfg, tcfg, params, fparams = setup
    tree = fparams if frozen else params
    tokens, pos, table, last = _paged_inputs(jcfg, seed=3)
    jc = jcaches(jcfg, 8, 4, jnp.float32)
    jl, _ = jforward(tree, jnp.asarray(tokens),
                     dataclasses.replace(jcfg, paged_attn=paged_attn),
                     positions=jnp.asarray(pos), caches=jc, update_cache=True,
                     page_table=jnp.asarray(table), last_idx=jnp.asarray(last))
    tl, _ = tforward(params_from_jax(_np(tree)), _t(tokens),
                     dataclasses.replace(tcfg, paged_attn=paged_attn), _t(pos),
                     tcaches(tcfg, 8, 4, torch.float32, device="cpu"), _t(table),
                     last_idx=_t(last))
    assert tl.shape == (2, 1, tcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)


def test_port_freeze_matches_reference_freeze(setup):
    """Freezing in the port gives the reference's codes and scales, with the
    LM head packed too and the embedding left float."""
    _, tcfg, params, fparams = setup
    ours = freeze_model_da(params_from_jax(_np(params)), mode="pallas_bitplane",
                           device="cpu")
    theirs = params_from_jax(_np(fparams))
    for name in ("wq", "wk", "wv", "wo"):
        a, b = ours["blocks"][1]["mixer"][name], theirs["blocks"][1]["mixer"][name]
        assert torch.equal(a.wq, b.wq) and torch.equal(a.w_scale, b.w_scale)
        assert a.mode == "pallas_bitplane"
    assert torch.equal(ours["lm_head"]["w"].wq, theirs["lm_head"]["w"].wq)
    assert not isinstance(ours["embed"]["table"], PackedWeights)
    assert not isinstance(ours["blocks"][0]["mixer"]["q_norm"], PackedWeights)
    # mode="auto" plans per layer, as the reference's planner does
    planned = freeze_model(params_from_jax(_np(params)), mode="auto",
                           cost_table={}, device="cpu")
    ref = jfreeze(params, JDA(x_signed=True), mode="auto", cost_table={}).plan
    assert {k: p.to_json() for k, p in planned.plan.items()} == \
        {k: p.to_json() for k, p in ref.items()}


def test_init_model_shapes_match_reference(setup):
    jcfg, tcfg, params, _ = setup
    ours = init_model(tcfg, seed=0, device="cpu")
    ref = params_from_jax(_np(params))
    assert len(ours["blocks"]) == tcfg.n_layers

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(ours) == shapes(ref)
    again = init_model(tcfg, seed=0, device="cpu")
    assert torch.equal(ours["blocks"][1]["ffn"]["w_up"],
                       again["blocks"][1]["ffn"]["w_up"])


def test_entry_points_default_to_the_card():
    """Without device=, the entry points run on CUDA and refuse a machine
    with no card instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    with pytest.raises(RuntimeError, match="cuda"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        freeze_model({"w": torch.zeros(4, 4)})


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_forward_logits_match_quantized_pool(setup, kv_dtype):
    """int8 / packed-int4 KV pages on the CPU path (the plain read serves
    them there; on the card the fused kernel reads them)."""
    jcfg, tcfg, _, fparams = setup
    tokens, pos, table, last = _paged_inputs(jcfg, seed=4)
    jc = jcaches(jcfg, 8, 4, jnp.float32, kv_dtypes=kv_dtype)
    jl, jnew = jforward(fparams, jnp.asarray(tokens),
                        dataclasses.replace(jcfg, paged_attn="fused"),
                        positions=jnp.asarray(pos), caches=jc, update_cache=True,
                        page_table=jnp.asarray(table), last_idx=jnp.asarray(last))
    tc = tcaches(tcfg, 8, 4, torch.float32, kv_dtypes=kv_dtype, device="cpu")
    tl, _ = tforward(params_from_jax(_np(fparams)), _t(tokens),
                     dataclasses.replace(tcfg, paged_attn="fused"), _t(pos), tc,
                     _t(table), last_idx=_t(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4)
    # the codes written to real pages match (page 0 takes pad writes)
    np.testing.assert_array_equal(tc["pos_0"].k[:, 1:].numpy(),
                                  np.asarray(jnew["pos_0"].k)[:, 1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask_mode", ["where", "additive"])
def test_masked_softmax_without_grad_is_the_autograd_chain(dtype, mask_mode):
    """Where no gradient is recorded the softmax runs in place on its one
    copy of the scores in ``softmax_dtype``: bit for bit the autograd
    path's out-of-place chain, in float32 and bfloat16 scores and softmax
    dtypes, in both mask modes; within the reference's float32 bound of
    JAX's softmax."""
    rng = np.random.default_rng(7)
    raw = rng.normal(0.0, 4.0, (2, 3, 5, 9)).astype(np.float32)
    mask = rng.random((1, 1, 5, 9)) < 0.7
    mask[..., 0] = True                                 # no row wholly masked
    scores = torch.from_numpy(raw).to(getattr(torch, dtype))
    for sd in sorted({"float32", dtype}):
        with torch.enable_grad():
            want = tattn._masked_softmax(scores.clone().requires_grad_(True),
                                         torch.from_numpy(mask), sd, mask_mode)
        assert want.requires_grad
        with torch.no_grad():
            s = scores.clone()
            got = tattn._masked_softmax(s, torch.from_numpy(mask), sd, mask_mode)
        assert torch.equal(got, want.detach()), (sd, mask_mode)
        # scores already in softmax_dtype are the one buffer, written over
        assert (got.data_ptr() == s.data_ptr()) == (sd == dtype)
        ref = jattn._masked_softmax(jnp.asarray(scores.float().numpy()).astype(
            jnp.dtype(dtype)), jnp.asarray(mask), sd, mask_mode)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, dtype=np.float32),
                                   atol=ATOL if sd == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_unchanged_by_the_in_place_softmax(setup, dtype):
    """A reduced qwen3-8b prefill (no cache: the full-head naive attention)
    gives the same logits, bit for bit, with no gradient recorded (the
    softmax and the norm's float64 square in place) as through autograd
    (the out-of-place chains); the float32 logits within the logits bound
    of JAX's."""
    jcfg, tcfg, params, _ = setup
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(tcfg, param_dtype=dtype, compute_dtype=dtype)
    tp = tree_map(lambda t: t.to(getattr(torch, dtype)) if t.is_floating_point()
                  else t, params_from_jax(_np(params)))
    tokens = np.random.default_rng(11).integers(0, cfg.vocab, (2, 12))
    with torch.no_grad():
        fast, _ = tforward(tp, _t(tokens), cfg)
    with torch.enable_grad():
        grad_tp = tree_map(lambda t: t.detach().clone().requires_grad_(True)
                           if t.is_floating_point() else t, tp)
        chain, _ = tforward(grad_tp, _t(tokens), cfg)
    assert chain.requires_grad
    assert torch.equal(fast, chain.detach())
    if dtype == "float32":
        jl, _ = jforward(params, jnp.asarray(tokens), jcfg)
        np.testing.assert_allclose(fast.numpy(), np.asarray(jl), atol=2e-4)
