"""PyTorch port vs the JAX reference: the paged serving runtime.

The port's ``ServeEngine(device="cpu")`` must emit the very greedy tokens the
JAX ``ServeEngine(..., da_mode="pallas_bitplane", paged_attn="fused")`` emits
on the same weights (carried over by ``params_from_jax``) and prompts; the
host-side pieces (page pool, tables, buckets, latency metrics) must agree
with their reference counterparts exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.models.model import init_model as jinit
from repro.serve import kvcache as jkv
from repro.serve import scheduler as jsched
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import registry as treg
from repro_torch.convert import params_from_jax
from repro_torch.serve import kvcache as tkv
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.engine import Request, ServeEngine

MAX_NEW = 6


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]),
                               moe_dropless=True)
    tcfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    params = jinit(jax.random.key(0), jcfg)
    rng = np.random.default_rng(3)
    prompts = {u: rng.integers(0, jcfg.vocab, 3 + 5 * u).astype(np.int32)
               for u in range(5)}
    return jcfg, tcfg, params, prompts


def test_greedy_tokens_match_jax_engine(model):
    """Chunked prefill beside decode through 2 lanes, 5 requests of 3..23
    prompt tokens (multi-chunk, page-straddling), frozen DA weights."""
    jcfg, tcfg, params, prompts = model
    kw = dict(batch_size=2, max_len=48, page_size=8)
    ref = JServeEngine(jcfg, params, da_mode="pallas_bitplane",
                       paged_attn="fused", **kw)
    ours = ServeEngine(tcfg, params_from_jax(jax.tree.map(np.asarray, params)),
                       da_mode="pallas_bitplane", paged_attn="fused",
                       device="cpu", **kw)
    streamed = []
    for uid, pr in prompts.items():
        ref.submit(JRequest(uid=uid, prompt=pr, max_new_tokens=MAX_NEW))
        ours.submit(Request(uid=uid, prompt=pr, max_new_tokens=MAX_NEW,
                            on_token=lambda u, t: streamed.append((u, t))))
    jd, td = ref.run(), ours.run()
    assert {u: td[u].generated for u in prompts} == \
        {u: jd[u].generated for u in prompts}
    assert len(streamed) == MAX_NEW * len(prompts)
    m = ours.metrics()
    assert m["requests_done"] == len(prompts)
    assert m["out_tokens"] == MAX_NEW * len(prompts)
    assert m["ctx_tokens"] == sum(len(p) for p in prompts.values()) + \
        (MAX_NEW - 1) * len(prompts)
    assert m["pool"]["used_pages"] == 0  # every page came back
    assert m["pool"]["alloc_count"] == m["pool"]["free_count"]


def test_serve_engine_defaults_to_the_card(model):
    _, tcfg, _, _ = model
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(tcfg, {}, batch_size=1, max_len=16)


def test_reserve_admission_backpressure():
    """A pool that holds one worst-case request admits one at a time and
    still serves both."""
    cfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    from repro_torch.models.model import init_model

    eng = ServeEngine(cfg, init_model(cfg, seed=1, device="cpu"), batch_size=2,
                      max_len=16, page_size=4, n_pages=4, da_mode="bitplane",
                      device="cpu")
    for uid in range(2):
        eng.submit(Request(uid=uid, prompt=np.arange(5, dtype=np.int32) + uid,
                           max_new_tokens=4))
    eng.step()
    assert sum(l is not None for l in eng._rt.lanes) == 1 and len(eng.queue) == 1
    done = eng.run()
    assert sorted(done) == [0, 1] and all(len(r.generated) == 4
                                          for r in done.values())
    with pytest.raises(ValueError, match="never be served"):
        eng.submit(Request(uid=9, prompt=np.arange(8, dtype=np.int32),
                           max_new_tokens=8))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 9, 16])
def test_buckets_match_reference(n):
    assert tsched.pow2_bucket(n) == jsched.pow2_bucket(n)
    assert tsched.pow2_bucket(n, lo=4) == jsched.pow2_bucket(n, lo=4)
    assert tsched.width_buckets(n) == jsched.width_buckets(n)
    assert tsched.width_bucket(n, 8) == jsched.width_bucket(n, 8)


def test_page_geometry_matches_reference():
    for max_len, ps in ((48, 8), (256, 16), (17, 4)):
        assert tkv.table_width(max_len, ps) == jkv.table_width(max_len, ps)
        assert tkv.pad_position(max_len, ps) == jkv.pad_position(max_len, ps)
        assert tkv.pages_for(max_len, ps) == jkv.pages_for(max_len, ps)
    tables = [[3, 1], [], [2, 5, 7]]
    np.testing.assert_array_equal(tkv.table_array(tables, 5),
                                  jkv.table_array(tables, 5))
    with pytest.raises(ValueError):
        tkv.table_array([[1, 2, 3]], 3)


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "int4"])
def test_kv_bytes_and_pools_match_reference(kv_dtype):
    jcfg = reduce_for_smoke(ARCHS["qwen3-8b"])
    tcfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    assert tkv.kv_page_bytes(tcfg, 8, kv_dtype) == \
        jkv.kv_page_bytes(jcfg, 8, kv_dtype)
    assert tkv.resolve_kv_dtypes(tcfg, kv_dtype) == \
        jkv.resolve_kv_dtypes(jcfg, kv_dtype)
    ours = tkv.init_paged_caches(tcfg, 6, 8, torch.float32, kv_dtypes=kv_dtype,
                                 device="cpu")
    theirs = jkv.init_paged_caches(jcfg, 6, 8, jax.numpy.float32,
                                   kv_dtypes=kv_dtype)
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(ours["pos_0"], name), getattr(theirs["pos_0"], name)
        assert (a is None) == (b is None)
        if a is not None:
            assert tuple(a.shape) == b.shape
    with pytest.raises(ValueError, match="unknown kv_dtype"):
        tkv.resolve_kv_dtypes(tcfg, "fp8")


def test_page_pool_refcount_ledger():
    ours, theirs = tkv.PagePool(6), jkv.PagePool(6)
    for pool in (ours, theirs):
        a = pool.alloc(3)
        pool.incref(a[:1])
        pool.free(a)
        assert pool.alloc(9) is None
    assert ours.stats() == theirs.stats()
    assert ours.refcount(1) == theirs.refcount(1) == 1
    for pool in (ours, theirs):
        with pytest.raises(ValueError, match="double-free"):
            pool.free([2])
        with pytest.raises(ValueError):
            pool.free([0])
        with pytest.raises(ValueError):
            pool.incref([3])
    with pytest.raises(ValueError):
        tkv.PagePool(1)


def test_latency_metrics_match_reference():
    reqs_t, reqs_j = [], []
    for uid, (sub, times) in enumerate([(0.0, [0.5, 0.7, 1.2]), (0.1, [0.4]),
                                        (0.2, [])]):
        for cls, out in ((Request, reqs_t), (JRequest, reqs_j)):
            r = cls(uid=uid, prompt=np.zeros(1, np.int32))
            r.submit_t = sub
            r.token_times = list(times)
            r.first_token_t = times[0] if times else None
            out.append(r)
    assert tsched.latency_metrics(reqs_t) == jsched.latency_metrics(reqs_j)
    assert tsched.latency_metrics([]) == jsched.latency_metrics([])
