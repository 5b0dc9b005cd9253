"""PyTorch port vs the JAX reference: the paged KV cache's host ledger and
device pools.

The same operations run on the port's ``repro_torch.serve.kvcache`` and on
the reference's ``repro.serve.kvcache``: page pool (``can_alloc``,
``free_page_ids``), speculative checkpoint / rollback, ``copy_page`` and
``defrag`` over fp, int8 and int4 pools (their float16 scales live in the
page), and the prefix trie.  Host state must match exactly; pools, built
from the same seeded numpy data, must be bit-equal after each operation.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kv_quant as jkvq
from repro.models.attention import PagedKVCache as JCache
from repro.serve import kvcache as jkv
from repro_torch.models import kv_quant as tkvq
from repro_torch.models.attention import PagedKVCache as TCache
from repro_torch.serve import kvcache as tkv

BOTH = (tkv, jkv)


def _state(pool):
    """Complete observable allocator state (free-list order included)."""
    return (list(pool._free), list(pool._ref), pool.stats())


def test_can_alloc_and_free_page_ids_match_reference():
    for mod in BOTH:
        pool = mod.PagePool(6)
        assert pool.can_alloc(5) and not pool.can_alloc(6)
        a = pool.alloc(3)
        assert pool.free_page_ids() == frozenset(range(1, 6)) - set(a)
        pool.free(a[1:2])
        assert pool.can_alloc(3) and not pool.can_alloc(4)
    ours, theirs = tkv.PagePool(6), jkv.PagePool(6)
    for pool in (ours, theirs):
        pool.free(pool.alloc(4)[::2])
    assert ours.free_page_ids() == theirs.free_page_ids()
    assert _state(ours) == _state(theirs)


def _spec_cycle(mod, keep):
    pool = mod.PagePool(10)
    table = pool.alloc(2)
    ck = mod.checkpoint(pool, table)
    grown = pool.alloc(4)
    table.extend(grown)
    freed = mod.rollback(pool, table, ck, keep=keep)
    return freed, list(table), _state(pool), ck.n_pages


@pytest.mark.parametrize("keep", [None, 0, 3, 5, 6])
def test_rollback_matches_reference(keep):
    assert _spec_cycle(tkv, keep) == _spec_cycle(jkv, keep)


def test_rollback_restores_pool_and_table_bit_identical():
    pool = tkv.PagePool(10)
    table = pool.alloc(2)
    before = (_state(pool), list(table))
    ck = tkv.checkpoint(pool, table)
    table.extend(pool.alloc(3))
    freed = tkv.rollback(pool, table, ck)
    assert len(freed) == 3
    assert (_state(pool), list(table)) == before
    assert tkv.rollback(pool, table, ck) == []  # idempotent
    assert pool.alloc(3) == freed               # same pages, same order


@pytest.mark.parametrize("fault", ["invalid", "shared", "beyond"])
def test_rollback_faults_leave_state_untouched(fault):
    for mod in BOTH:
        pool = mod.PagePool(8)
        table = pool.alloc(2)
        ck = mod.checkpoint(pool, table)
        grown = pool.alloc(2)
        table.extend(grown)
        keep = None
        if fault == "invalid":
            table.append(0)
        elif fault == "shared":
            pool.incref([grown[1]])
        else:
            keep = 9
        before = (_state(pool), list(table))
        with pytest.raises(ValueError):
            mod.rollback(pool, table, ck, keep=keep)
        assert (_state(pool), list(table)) == before


def test_rollback_interleaved_allocations_keep_membership_exact():
    out = []
    for mod in BOTH:
        pool = mod.PagePool(12)
        lane_a, lane_b = pool.alloc(2), pool.alloc(2)
        ck_a = mod.checkpoint(pool, lane_a)
        lane_a.extend(pool.alloc(2))
        lane_b.extend(pool.alloc(2))
        mod.rollback(pool, lane_a, ck_a)
        live = set(lane_a) | set(lane_b)
        assert set(pool._free) == set(range(1, 12)) - live
        out.append((_state(pool), lane_a, lane_b))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# device pools: copy_page and defrag, fp / int8 / int4, stacked or not
# ---------------------------------------------------------------------------
def _pools(kv_dtype, n_pages, ps, stacked, seed=0):
    """The same K/V content in both packages: page-id-coded floats (fp), or
    the quantized codes and float16 scales of seeded random rows."""
    rng = np.random.default_rng(seed)
    kv, hd = 2, 4
    lead = ((2,) if stacked else ()) + (n_pages, ps, kv)
    if kv_dtype == "fp16":
        base = (np.arange(n_pages, dtype=np.float32)[:, None, None, None]
                * np.ones((n_pages, ps, kv, hd), np.float32))
        if stacked:
            base = np.stack([base, base + 100.0])
        arrays = {"k": base, "v": base + 0.5 + rng.normal(size=base.shape)
                  .astype(np.float32)}
    else:
        fmt = kv_dtype
        arrays = {}
        for name in ("k", "v"):
            x = rng.normal(size=lead + (hd,)).astype(np.float32) * 3
            codes, scale = tkvq.quantize_kv(torch.from_numpy(x), fmt)
            arrays[name] = codes.numpy()
            arrays[f"{name}_scale"] = scale.numpy()
    ours = TCache(**{k: torch.from_numpy(v.copy()) for k, v in arrays.items()})
    theirs = JCache(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return {"pos_0": ours}, {"pos_0": theirs}


def _assert_pools_equal(ours, theirs):
    for name in ("k", "v", "k_scale", "v_scale"):
        a, b = getattr(ours["pos_0"], name), getattr(theirs["pos_0"], name)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quantized_pool_content_matches_reference_quantizer():
    """The quantized pools built above are the reference's quantize_kv of the
    same rows: the copy tests below start from equal pages."""
    x = np.random.default_rng(1).normal(size=(3, 4, 2, 8)).astype(np.float32)
    for fmt in ("int8", "int4"):
        qo, so = tkvq.quantize_kv(torch.from_numpy(x), fmt)
        qj, sj = jkvq.quantize_kv(jnp.asarray(x), fmt)
        np.testing.assert_array_equal(qo.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(so.numpy(), np.asarray(sj))


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "int4"])
def test_copy_page_matches_reference(kv_dtype, stacked):
    ours, theirs = _pools(kv_dtype, 6, 4, stacked)
    assert tkv.copy_page(ours, 3, 5) is ours
    theirs = jkv.copy_page(theirs, 3, 5)
    _assert_pools_equal(ours, theirs)
    leaf = ours["pos_0"].k
    axis = leaf.ndim - 4
    np.testing.assert_array_equal(leaf.select(axis, 5).numpy(),
                                  leaf.select(axis, 3).numpy())
    if kv_dtype != "fp16":  # the in-page scales travel with the codes
        s = ours["pos_0"].v_scale
        np.testing.assert_array_equal(s.select(axis, 5).numpy(),
                                      s.select(axis, 3).numpy())


def _fragmented(mod, n_pages):
    pool = mod.PagePool(n_pages)
    all_pages = pool.alloc(n_pages - 1)
    tables = [[5, 2], [7]]
    pool.free([p for p in all_pages if p not in {5, 2, 7}])
    return pool, tables


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "int4"])
def test_defrag_matches_reference(kv_dtype, stacked):
    n_pages, ps = 9, 4
    ours, theirs = _pools(kv_dtype, n_pages, ps, stacked, seed=2)
    pool_o, tables_o = _fragmented(tkv, n_pages)
    pool_j, tables_j = _fragmented(jkv, n_pages)
    leaf = ours["pos_0"].k
    axis = leaf.ndim - 4
    before = [leaf.index_select(axis, torch.tensor(t)).numpy() for t in tables_o]
    tkv.defrag(ours, pool_o, tables_o)
    theirs = jkv.defrag(theirs, pool_j, tables_j)
    assert tables_o == tables_j
    assert sorted(p for t in tables_o for p in t) == [1, 2, 3]
    assert _state(pool_o) == _state(pool_j)
    _assert_pools_equal(ours, theirs)
    after = [ours["pos_0"].k.index_select(axis, torch.tensor(t)).numpy()
             for t in tables_o]
    for b, a in zip(before, after):
        np.testing.assert_array_equal(b, a)


def test_rollback_state_identical_across_defrag():
    """checkpoint → draft writes → reject → defrag ends bit-identical (pool,
    tables, gathered pages) to a timeline that never speculated."""
    n_pages, ps = 12, 4

    def fragmented():
        pool = tkv.PagePool(n_pages)
        t0, t1 = pool.alloc(3), pool.alloc(2)
        pool.free([t0.pop(1)])
        return pool, [t0, t1], _pools("fp16", n_pages, ps, False)[0]

    pool_a, tables_a, caches_a = fragmented()
    ck = tkv.checkpoint(pool_a, tables_a[0])
    tables_a[0].extend(pool_a.alloc(3))
    caches_a["pos_0"].k[tables_a[0][-1]] += 99.0  # scribble into a draft page
    tkv.rollback(pool_a, tables_a[0], ck)
    pool_b, tables_b, caches_b = fragmented()
    assert _state(pool_a) == _state(pool_b) and tables_a == tables_b
    tkv.defrag(caches_a, pool_a, tables_a)
    tkv.defrag(caches_b, pool_b, tables_b)
    assert _state(pool_a) == _state(pool_b) and tables_a == tables_b
    for ta, tb in zip(tables_a, tables_b):
        assert torch.equal(caches_a["pos_0"].k[ta], caches_b["pos_0"].k[tb])


@pytest.mark.parametrize("kv_dtype", ["fp16", "int8", "int4"])
def test_kv_cache_nbytes_matches_reference(kv_dtype):
    ours, theirs = _pools(kv_dtype, 5, 4, True)
    assert tkv.kv_cache_nbytes(ours) == jkv.kv_cache_nbytes(theirs) > 0


def test_init_paged_caches_defaults_to_the_card():
    from repro_torch.configs import registry as treg

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = treg.reduce_for_smoke(treg.get("qwen3-8b"))
    with pytest.raises(RuntimeError, match="cuda"):
        tkv.init_paged_caches(cfg, 4, 4, torch.float32)
    assert tkv.init_paged_caches(cfg, 4, 4, torch.float32,
                                 device="cpu")["pos_0"].k.device.type == "cpu"


# ---------------------------------------------------------------------------
# the prefix trie
# ---------------------------------------------------------------------------
def _trie_match_insert_claim(mod):
    ps = 4
    pool = mod.PagePool(12)
    trie = mod.PrefixCache(ps)
    toks = list(range(10))
    pages = pool.alloc(3)
    out = [trie.match(toks), trie.insert(toks, pages, pool),
           pool.refcount(pages[0]), pool.refcount(pages[2])]
    for q in (toks, toks[:8], toks[:4] + [99, 98, 97, 96, 95]):
        nodes, hit = trie.match(q)
        out.append(([n.page for n in nodes], hit))
    nodes, _ = trie.match(toks[:4] + [99])
    out.append(trie.claim(nodes, pool))
    other = pool.alloc(2)
    out += [trie.insert(toks[:8], other, pool), pool.refcount(other[0]),
            trie.n_pages, sorted(trie.pages()), _state(pool)]
    return out


def test_prefix_trie_match_insert_claim():
    ours = _trie_match_insert_claim(tkv)
    assert ours == _trie_match_insert_claim(jkv)
    assert ours[0] == ([], 0) and ours[1] == 2
    assert ours[5] == ([1, 2], 7)  # an exactly-two-page prompt caps at len-1


def _trie_lru(mod):
    pool = mod.PagePool(12)
    trie = mod.PrefixCache(4)
    a = pool.alloc(2)
    trie.insert(list(range(8)), a, pool)
    b = pool.alloc(2)
    trie.insert([50, 51, 52, 53, 60, 61, 62, 63], b, pool)
    pool.free(a)
    pool.free(b)
    out = [trie.reclaimable(pool), trie.evict_one(pool), trie.evict_one(pool),
           pool.free_pages]
    nodes, hit = trie.match([50, 51, 52, 53, 60, 61, 62, 63, 70])
    claimed = trie.claim(nodes, pool)
    trie.clear(pool)
    out += [hit, claimed, trie.n_pages, [pool.refcount(p) for p in claimed],
            trie.evictions]
    pool.free(claimed)
    return out + [_state(pool)]


def test_prefix_trie_lru_eviction_and_pinning():
    ours = _trie_lru(tkv)
    assert ours == _trie_lru(jkv)
    assert ours[0] == 4 and ours[4] == 8


def test_defrag_remaps_trie_pages_and_detects_leaks():
    n_pages, ps = 10, 4
    ours, theirs = _pools("fp16", n_pages, ps, False)
    states, moved = [], []
    for mod, caches in ((tkv, ours), (jkv, theirs)):
        pool = mod.PagePool(n_pages)
        pages = pool.alloc(5)
        trie = mod.PrefixCache(ps)
        trie.insert(list(range(8)), pages[3:], pool)
        pool.free(pages)
        caches = mod.defrag(caches, pool, [], trie=trie)
        nodes, hit = trie.match(list(range(9)))
        states.append((sorted(trie.pages()), hit, [n.page for n in nodes],
                       _state(pool)))
        pool.alloc(1)
        with pytest.raises(ValueError, match="leak"):
            mod.defrag(caches, pool, [], trie=trie)
        moved.append(caches)
    assert states[0] == states[1]
    assert states[0][0] == [1, 2]
    _assert_pools_equal(*moved)


def _evict_pinned(mod):
    pool = mod.PagePool(12)
    trie = mod.PrefixCache(4)
    a = pool.alloc(2)
    trie.insert(list(range(8)), a, pool)
    out = [trie.reclaimable(pool), trie.evict_one(pool),
           trie.evict_until(pool, pool.free_pages + 1), trie.n_pages]
    pool.free(a)
    return out + [trie.evict_one(pool), _state(pool)]


def _evict_shielding(mod):
    pool = mod.PagePool(12)
    trie = mod.PrefixCache(4)
    b = pool.alloc(1)
    trie.insert([9, 9, 9, 9], b, pool)
    a = pool.alloc(2)
    trie.insert(list(range(8)), a, pool)
    pool.free([a[0]])
    free0 = pool.free_pages
    out = [trie.evict_one(pool), trie.match([9, 9, 9, 9, 1])[1],
           pool.free_pages - free0, trie.evict_one(pool),
           pool.free_pages - free0]
    return out + [_state(pool)]


@pytest.mark.parametrize("case", [_evict_pinned, _evict_shielding])
def test_evict_one_matches_reference(case):
    ours = case(tkv)
    assert ours == case(jkv)
    if case is _evict_pinned:
        assert ours[:4] == [0, False, False, 2] and ours[4] is True
    else:
        assert ours[:5] == [True, 4, 0, True, 1]
