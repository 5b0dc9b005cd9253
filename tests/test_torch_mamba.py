"""PyTorch port vs the JAX reference: the Mamba-2 (SSD) block, and
mamba2-780m served on the slot runtime.

The same seeded numpy inputs go through the reference's ``ssd_chunked``,
``ssd_step``, ``_causal_conv`` and ``mamba_forward`` and the port's
counterparts, in float32.  Tolerances: atol 2e-5, rtol 2e-4 (the
reference's own bound for its chunked-vs-recurrence test,
tests/test_ssd.py): the ops round alike, float32 summation order and the
exp / softplus implementations differ.  Served greedy tokens EQUAL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core import engine as jeng
from repro.models import mamba2 as jm
from repro.models.model import init_model as jinit
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core import engine as teng
from repro_torch.models import mamba2 as tm
from repro_torch.serve.engine import Request, ServeEngine

TOL = dict(atol=2e-5, rtol=2e-4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch CPU thread per xdist worker (restored after the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ssd_inputs(b, t, h, p, g, s, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, h, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(b, t, h))) * 0.2).astype(np.float32)
    a = -np.abs(rng.normal(size=(h,))).astype(np.float32)
    bm = rng.normal(size=(b, t, g, s)).astype(np.float32)
    cm = rng.normal(size=(b, t, g, s)).astype(np.float32)
    return x, dt, a, bm, cm


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("chunk", [4, 5, 8])
def test_ssd_chunked_matches_reference(chunk, groups, with_state):
    """t = 13: a ragged tail at every chunk; an initial state continues a
    scan."""
    b, t, h, p, s = 2, 13, 4, 8, 8
    ins = _ssd_inputs(b, t, h, p, groups, s, seed=chunk * 10 + groups)
    init = (np.random.default_rng(5).normal(size=(b, h, p, s)).astype(np.float32)
            if with_state else None)
    jy, jst = jm.ssd_chunked(*map(jnp.asarray, ins), chunk,
                             None if init is None else jnp.asarray(init))
    ty, tst = tm.ssd_chunked(*map(_t, ins), chunk,
                             None if init is None else _t(init))
    assert ty.dtype == tst.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_step_matches_reference(groups):
    b, h, p, s = 3, 4, 8, 8
    x, dt, a, bm, cm = _ssd_inputs(b, 1, h, p, groups, s, seed=groups)
    state = np.random.default_rng(9).normal(size=(b, h, p, s)).astype(np.float32)
    args = (state, x[:, 0], dt[:, 0], a, bm[:, 0], cm[:, 0])
    jy, jst = jm.ssd_step(*map(jnp.asarray, args))
    ty, tst = tm.ssd_step(*map(_t, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), **TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_chunked_prefill_then_steps_equals_one_scan(groups):
    """prefill(0:t0) by the chunked scan + step-by-step decode == one chunked
    scan over the whole sequence, in the port (the reference's
    tests/test_ssd.py continuation test)."""
    b, t, t0, h, p, s = 2, 20, 11, 4, 4, 8
    x, dt, a, bm, cm = map(_t, _ssd_inputs(b, t, h, p, groups, s, seed=7))
    want_y, want_state = tm.ssd_chunked(x, dt, a, bm, cm, 4)
    y0, st = tm.ssd_chunked(x[:, :t0], dt[:, :t0], a, bm[:, :t0], cm[:, :t0], 4)
    ys = [y0]
    for i in range(t0, t):
        y1, st = tm.ssd_step(st, x[:, i], dt[:, i], a, bm[:, i], cm[:, i])
        ys.append(y1[:, None])
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), want_y.numpy(), **TOL)
    np.testing.assert_allclose(st.numpy(), want_state.numpy(), **TOL)


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_matches_reference(with_cache):
    rng = np.random.default_rng(3)
    b, t, c, k = 2, 6, 10, 4
    xbc = rng.normal(size=(b, t, c)).astype(np.float32)
    w = (0.2 * rng.normal(size=(k, c))).astype(np.float32)
    bias = (0.1 * rng.normal(size=(c,))).astype(np.float32)
    cache = (rng.normal(size=(b, k - 1, c)).astype(np.float32)
             if with_cache else None)
    jy, jnew = jm._causal_conv(*map(jnp.asarray, (xbc, w, bias)),
                               None if cache is None else jnp.asarray(cache))
    ty, tnew = tm._causal_conv(*map(_t, (xbc, w, bias)),
                               None if cache is None else _t(cache))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert torch.equal(tnew, _t(np.asarray(jnew)))


def _block(seed: int = 0):
    """The reduced mamba2-780m's config and one block's Mamba params (the
    reference's init, D / dt_bias / norm_scale drawn non-default), in both
    packages."""
    jcfg = reduce_for_smoke(ARCHS["mamba2-780m"])
    tcfg = treg.reduce_for_smoke(treg.get("mamba2-780m"))
    p = jm.init_mamba(jax.random.key(seed), jcfg)
    rng = np.random.default_rng(seed)
    for name in ("D", "dt_bias", "norm_scale", "conv_b"):
        p[name] = jnp.asarray(p[name] + 0.3 * rng.normal(size=p[name].shape),
                              p[name].dtype)
    return jcfg, tcfg, p, {k: to_tensor(np.asarray(v)) for k, v in p.items()}


def test_init_mamba_has_the_reference_leaves():
    jcfg, tcfg, p, _ = _block()
    ours = tm.init_mamba(torch.Generator().manual_seed(0), tcfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in ours.items()} == \
        {k: (tuple(v.shape), to_tensor(np.asarray(v)).dtype) for k, v in p.items()}
    for name in ("A_log", "D", "dt_bias"):
        np.testing.assert_allclose(
            ours[name].numpy(),
            np.asarray(jm.init_mamba(jax.random.key(0), jcfg)[name]), rtol=1e-6)


def test_mamba_forward_train_matches_reference():
    jcfg, tcfg, p, tp = _block()
    x = np.random.default_rng(1).normal(size=(2, 13, jcfg.d_model)).astype(np.float32)
    jy, jc = jm.mamba_forward(p, jnp.asarray(x), jcfg)
    ty = tm.mamba_forward(tp, _t(x), tcfg)
    assert jc is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_mamba_prefill_and_decode_match_reference():
    """A prefill into a zero cache, then three decode steps: outputs and the
    cache's conv window and SSM state (written in place) against the
    reference's returned cache."""
    jcfg, tcfg, p, tp = _block(seed=2)
    b, t0, steps = 2, 9, 3
    x = np.random.default_rng(4).normal(
        size=(b, t0 + steps, jcfg.d_model)).astype(np.float32)
    jcache = jm.MambaCache.zeros(jcfg, b, jnp.float32)
    tcache = tm.MambaCache.zeros(tcfg, b, torch.float32)
    assert tcache.conv.shape == jcache.conv.shape
    assert tcache.ssm.shape == jcache.ssm.shape and tcache.ssm.dtype == torch.float32
    jy, jcache = jm.mamba_forward(p, jnp.asarray(x[:, :t0]), jcfg, jcache,
                                  update_cache=True)
    ty = tm.mamba_forward(tp, _t(x[:, :t0]), tcfg, tcache, update_cache=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for i in range(t0, t0 + steps):
        jy, jcache = jm.mamba_forward(p, jnp.asarray(x[:, i:i + 1]), jcfg, jcache)
        ty = tm.mamba_forward(tp, _t(x[:, i:i + 1]), tcfg, tcache)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(tcache.conv.numpy(), np.asarray(jcache.conv), **TOL)
        np.testing.assert_allclose(tcache.ssm.numpy(), np.asarray(jcache.ssm), **TOL)


def test_mamba_decode_continues_the_train_forward():
    """In the port: a cached prefill of t0 rows and steps of one row give
    the no-cache forward's outputs at every position."""
    _, tcfg, _, tp = _block(seed=3)
    b, t = 2, 12
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(b, t, tcfg.d_model)).astype(np.float32))
    full = tm.mamba_forward(tp, x, tcfg)
    cache = tm.MambaCache.zeros(tcfg, b, torch.float32)
    out = [tm.mamba_forward(tp, x[:, :5], tcfg, cache, update_cache=True)]
    out += [tm.mamba_forward(tp, x[:, i:i + 1], tcfg, cache) for i in range(5, t)]
    np.testing.assert_allclose(torch.cat(out, dim=1).numpy(), full.numpy(), **TOL)


def test_mamba_cache_stack_views_write_through():
    tcfg = dataclasses.replace(treg.reduce_for_smoke(treg.get("mamba2-780m")),
                               n_layers=6)
    stack = tm.MambaCache.zeros(tcfg, 3, torch.bfloat16, stack=(4,))
    assert stack.conv.shape == (4, 3, tcfg.ssm_conv - 1, tcfg.conv_channels)
    assert stack.conv.dtype == torch.bfloat16
    assert stack.ssm.shape == (4, 3, tcfg.ssm_heads, tcfg.ssm_head_dim,
                               tcfg.ssm_state)
    one = stack.layer(2)
    one.ssm.fill_(1.0)
    one.conv.fill_(2.0)
    assert stack.ssm[2].eq(1).all() and not stack.ssm[1].any()
    assert stack.conv[2].eq(2).all() and not stack.conv[3].any()


# ---------------------------------------------------------------------------
# mamba2-780m on the slot runtime
# ---------------------------------------------------------------------------


@pytest.fixture
def empty_cost_tables():
    """``da_mode="auto"`` plans from the analytic model in both packages."""
    teng.set_cost_table({})
    jeng.set_cost_table({})
    yield
    teng.set_cost_table(None)
    jeng.set_cost_table(None)


_MODEL = {}


def _model():
    """The reduced mamba2-780m in both packages, the Mamba constants drawn
    from a numpy seed."""
    if not _MODEL:
        jcfg = reduce_for_smoke(ARCHS["mamba2-780m"])
        rng = np.random.default_rng(1)

        def draw(path, a):
            if getattr(path[-1], "key", None) in ("D", "dt_bias", "norm_scale",
                                                  "conv_b", "scale"):
                return jnp.asarray(a + 0.2 * rng.normal(size=a.shape), a.dtype)
            return a

        params = jax.tree_util.tree_map_with_path(
            draw, jinit(jax.random.key(0), jcfg))
        _MODEL.update(jcfg=jcfg, params=params,
                      tcfg=treg.reduce_for_smoke(treg.get("mamba2-780m")),
                      tparams=params_from_jax(jax.tree.map(np.asarray, params)))
    return _MODEL


def _serve(eng, request_cls, vocab):
    rng = np.random.default_rng(0)
    for u, n in enumerate((5, 9, 5)):
        eng.submit(request_cls(uid=u, prompt=rng.integers(0, vocab, n).astype(
            np.int32), max_new_tokens=5))
    done = eng.run()
    return {u: list(done[u].generated) for u in sorted(done)}


@pytest.mark.parametrize("mode", [None, "bitplane_stacked", "auto"])
def test_slot_serve_matches_reference(mode, empty_cost_tables):
    """``runtime="auto"`` picks the slot runtime for the ssm stack in both
    packages; each prompt prefills at its exact length into a fresh
    MambaCache whose conv and ssm rows are copied into its slot; greedy
    tokens EQUAL to the reference's, float and frozen by the engine."""
    m = _model()
    kw = dict(batch_size=2, max_len=32, da_mode=mode)
    ref = JServeEngine(m["jcfg"], m["params"], **kw)
    ours = ServeEngine(m["tcfg"], m["tparams"], device="cpu", **kw)
    assert ours.runtime == ref.runtime == "slots"
    assert isinstance(ours.caches["pos_0"], tm.MambaCache)
    assert _serve(ours, Request, m["tcfg"].vocab) == \
        _serve(ref, JRequest, m["jcfg"].vocab)
    assert ours.metrics()["prefill_compiles"] == \
        ref.metrics()["prefill_compiles"] == 2
