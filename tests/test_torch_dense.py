"""PyTorch port vs the JAX reference: the dense model family.

Every dense config of the zoo (qwen3-8b, mistral-nemo-12b, minitron-8b,
phi3-medium-14b, musicgen-large, qwen2-vl-72b) through ``reduce_for_smoke``:
weights from the reference's ``init_model``, with the q/k/v biases and the
norms' scales and biases set non-zero from a numpy seed (so a dropped bias
shows), carried across by ``params_from_jax``, float and frozen
(``bitplane_stacked``).  Inputs are tokens, or embeddings ``[B, T, D]`` for
the audio and vlm configs, from a numpy seed.

Tolerances: logits float32 at atol 2e-4, rtol 2e-3 (the reference's own
bound for its decode-vs-forward test); the ops round alike, float32
summation order and transcendental implementations differ.  RoPE angles
at rtol 1e-6.  Parameter counts exactly.
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
from repro.models import layers as jlayers
from repro.models.model import count_active_params as jcount_active
from repro.models.model import count_params as jcount
from repro.models.model import forward as jforward
from repro.models.model import init_caches as jinit_caches
from repro.models.model import init_model as jinit
from repro.models.model import lm_loss as jlm_loss
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.models import layers as tlayers
from repro_torch.models.attention import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    count_active_params,
    count_params,
    forward,
    init_caches,
    init_model,
    lm_loss,
)
from repro_torch.spec.decode import mk_positions

DENSE = ("qwen3-8b", "mistral-nemo-12b", "minitron-8b", "phi3-medium-14b",
         "musicgen-large", "qwen2-vl-72b")
TOL = dict(atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch CPU thread per xdist worker (restored after the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _nonzero_biases(tree, seed: int = 1):
    """The reference's params with every bias (q/k/v, norm) and norm scale
    drawn from a numpy seed instead of its zeros and ones."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = getattr(path[-1], "key", None)
        if name in ("bq", "bk", "bv", "bias"):
            return jnp.asarray(0.5 * rng.normal(size=a.shape), a.dtype)
        if name == "scale":
            return jnp.asarray(1.0 + 0.2 * rng.normal(size=a.shape), a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(draw, tree)


_CACHE = {}


def _model(name: str, frozen: bool = False):
    """(jax cfg, port cfg, jax params, port params) for a reduced config."""
    key = (name, frozen)
    if key not in _CACHE:
        jcfg = reduce_for_smoke(ARCHS[name])
        tcfg = treg.reduce_for_smoke(treg.get(name))
        params = _nonzero_biases(jinit(jax.random.key(0), jcfg))
        if frozen:
            params = jfreeze(params, JDA(x_signed=True), mode="bitplane_stacked",
                             model_cfg=jcfg).params
        tparams = params_from_jax(jax.tree.map(np.asarray, params))
        _CACHE[key] = (jcfg, tcfg, params, tparams)
    return _CACHE[key]


def _inputs(cfg, b: int, t: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if cfg.modality == "text":
        return rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    return rng.normal(size=(b, t, cfg.d_model)).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("name", DENSE)
def test_configs_match_reference(name):
    """Every field the port carries equals the reference's, at full size and
    reduced; the port accepts each config."""
    for jcfg, tcfg in ((ARCHS[name], treg.get(name)),
                       (reduce_for_smoke(ARCHS[name]),
                        treg.reduce_for_smoke(treg.get(name)))):
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name


@pytest.mark.parametrize("family", ["moe", "ssm", "hybrid", "unknown"])
def test_every_reference_family_is_accepted(family):
    """``ModelConfig`` and ``from_manifest`` accept the reference's MoE,
    Mamba-2 and hybrid families (ported since the dense slice refused
    them); a family the reference does not have still raises."""
    raw = dataclasses.asdict(dataclasses.replace(ARCHS["qwen3-8b"],
                                                 family=family))
    if family == "unknown":
        with pytest.raises(ValueError, match="unknown family"):
            ModelConfig(name="x", family=family, n_layers=1, d_model=8, vocab=4)
        with pytest.raises(ValueError, match="unknown family"):
            ModelConfig.from_manifest(raw)
        return
    assert ModelConfig(name="x", family=family, n_layers=1, d_model=8,
                       vocab=4).family == family
    assert ModelConfig.from_manifest(raw) == dataclasses.replace(
        treg.get("qwen3-8b"), family=family)


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("name", DENSE)
def test_forward_without_cache_matches(name, frozen):
    jcfg, tcfg, params, tparams = _model(name, frozen)
    x = _inputs(jcfg, 2, 9)
    jl, _ = jforward(params, jnp.asarray(x), jcfg)
    tl, caches = forward(tparams, _t(x), tcfg)
    assert caches is None and tl.shape == (2, 9, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("name", DENSE)
def test_init_tree_matches_reference(name):
    """The port's init tree has the reference's leaves and shapes: no
    ``w_gate`` without SwiGLU, norm biases under LayerNorm, q/k/v biases,
    no ``embed`` table for embedding inputs."""
    jcfg, tcfg, params, tparams = _model(name)
    ours = init_model(tcfg, seed=0, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(ours) == shapes(tparams)
    assert ("embed" in ours) == (tcfg.modality == "text")
    assert ("w_gate" in ours["blocks"][0]["ffn"]) == (tcfg.mlp_act == "swiglu")
    assert ("bias" in ours["final_norm"]) == (tcfg.norm_type == "layernorm")
    assert ("bq" in ours["blocks"][0]["mixer"]) == tcfg.attn_bias


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("name", DENSE)
def test_prefill_then_decode_matches_full_forward(name, frozen):
    """Prefill 8 positions into ``init_caches``, then decode 4 one by one:
    each step's logits equal the full forward's at that position (as the
    reference's test_decode does).  Float weights: the prefill also equals
    the reference's cached prefill.  Frozen weights are held against the
    port's own forward only: across packages a float32 ulp in a projection
    may move one per-row activation code at a rounding boundary (frozen
    musicgen-large's prefill here moves one wo code, 0.033 in the logits),
    and test_forward_without_cache_matches holds frozen logits across
    packages."""
    jcfg, tcfg, params, tparams = _model(name, frozen)
    b, t, t0 = 2, 12, 8
    x = _t(_inputs(jcfg, b, t, seed=2))
    full, _ = forward(tparams, x, tcfg)
    caches = init_caches(tcfg, b, 20, torch.float32, device="cpu")
    pos = mk_positions(tcfg, torch.arange(t0, dtype=torch.int32)[None].expand(b, t0))
    lg, caches = forward(tparams, x[:, :t0], tcfg, pos, caches, update_cache=True)
    np.testing.assert_allclose(lg.numpy(), full[:, :t0].numpy(), **TOL)
    if not frozen:
        jc = jinit_caches(jcfg, b, 20, jnp.float32)
        jl, _ = jforward(params, jnp.asarray(x[:, :t0].numpy()), jcfg,
                         positions=jnp.asarray(pos.numpy()), caches=jc,
                         update_cache=True)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert int(caches["pos_0"].length[0]) == t0
    for step in range(t0, t):
        p1 = mk_positions(tcfg, torch.full((b, 1), step, dtype=torch.int32))
        lg, caches = forward(tparams, x[:, step:step + 1], tcfg, p1, caches)
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, step].numpy(), **TOL)


@pytest.mark.parametrize("chunk", [4, 5, 16])
@pytest.mark.parametrize("name", ["qwen3-8b", "minitron-8b", "qwen2-vl-72b"])
def test_chunked_attention_equals_naive(name, chunk):
    """The online softmax over KV chunks equals the naive path, in the port
    and against the reference's chunked path."""
    jcfg, tcfg, params, tparams = _model(name)
    x = _inputs(jcfg, 2, 16, seed=3)
    naive, _ = forward(tparams, _t(x), tcfg)
    ccfg = dataclasses.replace(tcfg, attn_chunk_q=chunk)
    chunked, _ = forward(tparams, _t(x), ccfg)
    np.testing.assert_allclose(chunked.numpy(), naive.numpy(), **TOL)
    jl, _ = jforward(params, jnp.asarray(x),
                     dataclasses.replace(jcfg, attn_chunk_q=chunk))
    np.testing.assert_allclose(chunked.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("name", ["qwen3-8b", "musicgen-large"])
def test_lean_attention_equals_naive(name):
    jcfg, tcfg, params, tparams = _model(name)
    x = _inputs(jcfg, 2, 11, seed=4)
    naive, _ = forward(tparams, _t(x), tcfg)
    lean, _ = forward(tparams, _t(x), dataclasses.replace(tcfg, attn_impl="lean"))
    np.testing.assert_allclose(lean.numpy(), naive.numpy(), **TOL)
    jl, _ = jforward(params, jnp.asarray(x),
                     dataclasses.replace(jcfg, attn_impl="lean"))
    np.testing.assert_allclose(lean.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("name", ["qwen3-8b", "minitron-8b"])
def test_slice_cache_mode_equals_scatter(name):
    """``cache_mode="slice"`` (uniform positions: one slice write) gives the
    scatter mode's logits and cache at prefill and decode."""
    _, tcfg, _, tparams = _model(name)
    b, t0 = 2, 6
    x = _t(_inputs(tcfg, b, t0 + 3, seed=5))
    out = {}
    for mode in ("scatter", "slice"):
        cfg = dataclasses.replace(tcfg, cache_mode=mode)
        caches = init_caches(cfg, b, 16, torch.float32, device="cpu")
        lg, _ = forward(tparams, x[:, :t0], cfg, caches=caches,
                        update_cache=True)
        steps = [lg]
        for s in range(t0, t0 + 3):
            lg, _ = forward(tparams, x[:, s:s + 1], cfg,
                            torch.full((b, 1), s, dtype=torch.int32), caches)
            steps.append(lg)
        out[mode] = (steps, caches["pos_0"].k.clone())
    for a, c in zip(out["scatter"][0], out["slice"][0]):
        np.testing.assert_allclose(c.numpy(), a.numpy(), **TOL)
    assert torch.equal(out["scatter"][1], out["slice"][1])


def test_prefill_into_a_warm_dense_cache_raises():
    _, tcfg, _, tparams = _model("qwen3-8b")
    caches = init_caches(tcfg, 1, 16, torch.float32, device="cpu")
    x = _t(_inputs(tcfg, 1, 8, seed=6))
    forward(tparams, x[:, :4], tcfg, caches=caches, update_cache=True)
    with pytest.raises(ValueError, match="warm dense KVCache"):
        forward(tparams, x[:, 4:], tcfg,
                torch.arange(4, 8, dtype=torch.int32)[None], caches,
                update_cache=True)


@pytest.mark.parametrize("name", ["minitron-8b", "musicgen-large"])
def test_last_logit_only_and_last_idx_match(name):
    jcfg, tcfg, params, tparams = _model(name)
    x = _inputs(jcfg, 2, 7, seed=7)
    jl, _ = jforward(params, jnp.asarray(x), jcfg, last_logit_only=True)
    tl, _ = forward(tparams, _t(x), tcfg, last_logit_only=True)
    assert tl.shape == (2, 1, jcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    last = np.array([3, 6], np.int32)
    jl, _ = jforward(params, jnp.asarray(x), jcfg, last_idx=jnp.asarray(last))
    tl, _ = forward(tparams, _t(x), tcfg, last_idx=_t(last))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_lm_loss_matches():
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(2, 5, 97)).astype(np.float32) * 3
    labels = rng.integers(0, 97, (2, 5)).astype(np.int32)
    ours = lm_loss(_t(logits), _t(labels)).item()
    ref = float(jlm_loss(jnp.asarray(logits), jnp.asarray(labels)))
    assert ours == pytest.approx(ref, rel=1e-6)


def test_mrope_angles_match():
    """M-RoPE angles for [B, T, 3] positions (distinct coordinates) and for
    [B, T] positions broadcast to all three sections."""
    rng = np.random.default_rng(9)
    for sections, hd in (((4, 6, 6), 32), ((16, 24, 24), 128)):
        pos3 = rng.integers(0, 500, (2, 5, 3)).astype(np.int32)
        pos2 = rng.integers(0, 500, (2, 5)).astype(np.int32)
        for pos in (pos3, pos2):
            ours = tlayers.rope_angles(_t(pos), hd, 1e6, sections)
            ref = jlayers.rope_angles(jnp.asarray(pos), hd, 1e6, sections)
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6)
    with pytest.raises(ValueError, match="sum"):
        tlayers.rope_angles(_t(pos2), 32, 1e6, (4, 4, 4))


def test_mrope_positions_with_distinct_coordinates_match():
    """qwen2-vl with [B, T, 3] positions whose t, h, w differ (patches of an
    image), through the no-cache forward."""
    jcfg, tcfg, params, tparams = _model("qwen2-vl-72b")
    x = _inputs(jcfg, 2, 6, seed=10)
    pos = np.random.default_rng(10).integers(0, 40, (2, 6, 3)).astype(np.int32)
    jl, _ = jforward(params, jnp.asarray(x), jcfg, positions=jnp.asarray(pos))
    tl, _ = forward(tparams, _t(x), tcfg, _t(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("name", DENSE)
def test_param_counts_match_reference(name):
    """At full size: count_params from the init tree's shapes (meta tensors,
    no bytes) and count_active_params equal the reference's."""
    cfg = treg.get(name)
    assert count_params(cfg) == jcount(ARCHS[name])
    assert count_active_params(cfg) == jcount_active(ARCHS[name]) == \
        count_params(cfg)


def test_dense_cache_layers_are_views():
    cfg = treg.reduce_for_smoke(treg.get("minitron-8b"))
    caches = init_caches(cfg, 2, 8, device="cpu")
    stack = caches["pos_0"]
    assert isinstance(stack, KVCache)
    assert stack.k.shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads, cfg.head_dim_)
    one = stack.layer(1)
    one.k.fill_(3.0)
    one.length.add_(5)
    assert stack.k[1].eq(3.0).all() and stack.k[0].eq(0).all()
    assert stack.length.tolist() == [0, 5]
