"""PyTorch port vs the JAX reference: the logical-axis sharding rules, the
parameter / cache / batch specs and the int8 gradient compression, in one
process (no ranks).

* ``pspec`` equals the reference's over a grid of logical axes × shapes ×
  meshes (2, 2), (2, 4), (2, 2, 2) × ``LM_RULES`` / ``FSDP_RULES``: the
  reference runs under a stand-in mesh (an object with ``.shape``) set in
  its thread-local rules, the port under a stand-in with
  ``mesh_dim_names`` and ``shape``;
* ``da_leaf_axes``, ``paged_cache_axes`` and ``placements`` / ``spec_of``;
* ``tree_pspecs`` of the init train state and of a frozen tree for the
  ``--smoke`` qwen3-8b, qwen2-moe-a2.7b and mamba2-780m, leaf by leaf: a
  port leaf ``blocks[i]/…`` against the reference's ``periods/pos_<i %
  period>/…`` (the reference's spec without its leading stacked-axis
  ``None``);
* ``compress_leaf`` / ``compress_with_ef`` codes, scales and errors
  bit-equal to the reference's;
* without rules every ``constrain`` returns its argument itself and every
  ``shard_*`` its tree (a forward of each family, its ``constrain`` calls
  counted).
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS, reduce_for_smoke
from repro.core.da import DAConfig as JDAConfig
from repro.core.freeze import freeze_model_da as jfreeze
from repro.launch import sharding as jshd
from repro.launch import specs as jspecs
from repro.optim import compress as jcompress
from repro.train import trainer as jtrainer
from repro_torch.configs import registry as treg
from repro_torch.core.da import DAConfig
from repro_torch.core.freeze import freeze_model_da
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as SP
from repro_torch.optim import compress as tcompress
from repro_torch.train import trainer as ttrainer

MESHES = [((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]
RULES = {"lm": (jshd.LM_RULES, shd.LM_RULES),
         "fsdp": (jshd.FSDP_RULES, shd.FSDP_RULES)}
SMOKE_ARCHS = ("qwen3-8b", "qwen2-moe-a2.7b", "mamba2-780m")

#: every logical-axes tuple the rules, specs and models name
LOGICAL = sorted(
    {v for v in jspecs.PARAM_LOGICAL.values()}
    | {v for v in jspecs.CACHE_LOGICAL.values()}
    | {v for v in jspecs.BATCH_LOGICAL.values()}
    | {("batch", "seq", "embed"), ("batch", "seq", "ffn"),
       ("batch", "seq", "heads", "head_dim"),
       ("batch", "seq", "kv_heads", "head_dim"),
       ("batch", "kv_seq", "kv_heads", "head_dim"),
       ("batch", "expert", None, "embed"), ("batch", None, "embed"),
       ("batch", "seq", "vocab"), ("batch", "seq", "inner"),
       ("batch", "seq_sp", "embed"), ("state", "ssm_heads"), (None, None),
       ("page", "page_slot", "kv_heads", "head_dim"),
       (None, "page", "page_slot", "kv_heads", "head_dim"),
       ("da_in", "da_out"), (None, "da_in", "da_out"),
       ("groups", "lut_addr", "da_out"), (None, "da_out")},
    key=lambda t: tuple(str(a) for a in t))


class _JaxMesh:
    """What the reference's ``_resolve`` reads of a mesh: ``.shape``."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))


def _port_mesh(shape, axes):
    return types.SimpleNamespace(mesh_dim_names=tuple(axes), shape=tuple(shape))


@pytest.fixture
def rules(monkeypatch):
    """Install a mesh and rules table in both packages: the reference's
    through its thread-local, the port's through ``use_mesh_rules``."""
    stack = []

    def install(shape, axes, kind):
        jr, tr = RULES[kind]
        monkeypatch.setattr(jshd._LOCAL, "mesh_rules",
                            (_JaxMesh(shape, axes), dict(jr)), raising=False)
        cm = shd.use_mesh_rules(_port_mesh(shape, axes), tr)
        cm.__enter__()
        stack.append(cm)

    yield install
    for cm in reversed(stack):
        cm.__exit__(None, None, None)


def _shapes(n: int, rng):
    sizes = (1, 2, 3, 4, 6, 8, 12, 16)
    return [tuple(int(s) for s in rng.choice(sizes, n)) for _ in range(6)]


@pytest.mark.parametrize("kind", sorted(RULES))
@pytest.mark.parametrize("shape,axes", MESHES)
def test_pspec_matches_the_reference(rules, kind, shape, axes):
    rules(shape, axes, kind)
    rng = np.random.default_rng(len(shape) * 10 + len(kind))
    n = 0
    for logical in LOGICAL:
        for dims in _shapes(len(logical), rng) + [(16,) * len(logical)]:
            want = tuple(jshd.pspec(logical, dims))
            got = shd.pspec(logical, dims)
            assert isinstance(got, shd.P) and got == want, (logical, dims)
            n += 1
    assert n > 250


def test_pspec_without_rules_replicates():
    assert shd.pspec(("batch", "seq", "embed"), (8, 4, 16)) == shd.P() == ()


@pytest.mark.parametrize("name", ["wq", "w_scale", "luts", "w_up", "table"])
@pytest.mark.parametrize("ndim", [1, 2, 3, 4, 5])
def test_da_leaf_axes_match_the_reference(name, ndim):
    assert shd.da_leaf_axes(name, ndim) == jshd.da_leaf_axes(name, ndim)


@pytest.mark.parametrize("ndim", [3, 4, 5, 6])
def test_paged_cache_axes_match_the_reference(ndim):
    if ndim < 4:
        with pytest.raises(ValueError):
            jshd.paged_cache_axes(ndim)
        with pytest.raises(ValueError):
            shd.paged_cache_axes(ndim)
        return
    assert shd.paged_cache_axes(ndim) == jshd.paged_cache_axes(ndim)


def test_placements_follow_the_spec_in_mesh_order():
    mesh = _port_mesh((2, 2, 2), ("pod", "data", "model"))
    assert shd.placements(shd.P(("pod", "data"), None, "model"), mesh) == (
        shd.Shard(0), shd.Shard(0), shd.Shard(2))
    assert shd.placements(shd.P(), mesh) == (shd.Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements(shd.P(("data", "pod")), mesh)


def _ref_flat(tree):
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None)
    return {tuple(jspecs._entry_name(p) for p in path): leaf
            for path, leaf in flat}


def _port_flat(tree):
    out = {}
    SP._map_named(lambda names, s: out.__setitem__(names, s), tree)
    return out


def _ref_key(names, period: int):
    """A port leaf's path under the reference's stacked layout."""
    names = list(names)
    if "blocks" in names:
        i = names.index("blocks")
        names[i:i + 2] = ["periods", f"pos_{int(names[i + 1]) % period}"]
    return tuple(names)


def _compare(port_specs, ref_specs, period: int) -> int:
    ref = {k: v for k, v in _ref_flat(ref_specs).items() if v is not None}
    seen = set()
    for names, spec in _port_flat(port_specs).items():
        key = _ref_key(names, period)
        want = tuple(ref[key])
        if "periods" in key:   # the reference's stacked axis leads
            assert want[:1] in ((), (None,)), (key, want)
            want = want[1:]
        assert spec == want, (names, spec, want)
        seen.add(key)
    assert seen == set(ref), sorted(set(ref) ^ seen)[:5]
    return len(seen)


@pytest.mark.parametrize("shape,axes", MESHES[:2])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_tree_pspecs_of_the_train_state(rules, arch, shape, axes):
    import jax

    cfg = reduce_for_smoke(ARCHS[arch])
    tcfg = reduce_for_smoke(treg.ARCHS[arch])
    jstate = jax.eval_shape(lambda: jtrainer.init_state(jax.random.key(0), cfg))
    tstate = ttrainer.state_from_params(_meta_params(tcfg))
    rules(shape, axes, "lm")
    n = _compare(SP.tree_pspecs(tstate), jspecs.tree_pspecs(jstate), cfg.period)
    assert n > 10


def _meta_params(cfg):
    from repro_torch.models.model import _init_tree, _ShapeGen

    return _init_tree(_ShapeGen(), cfg)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_tree_pspecs_of_a_frozen_tree(rules, arch):
    import jax

    from repro.models.model import init_model as jinit
    from repro_torch.models.model import init_model

    cfg = reduce_for_smoke(ARCHS[arch])
    jfrozen = jax.eval_shape(lambda: jfreeze(
        jinit(jax.random.key(0), cfg), JDAConfig(x_signed=True), mode="lut"))
    frozen = freeze_model_da(init_model(reduce_for_smoke(treg.ARCHS[arch]),
                                        device="cpu"),
                             DAConfig(x_signed=True), mode="lut", device="cpu")
    rules((2, 2), ("data", "model"), "lm")
    _compare(SP.tree_pspecs(frozen), jspecs.tree_pspecs(jfrozen), cfg.period)


@pytest.mark.parametrize("kind", ["lm", "fsdp"])
def test_batch_and_cache_pspecs_match_the_reference(rules, kind):
    import jax

    from repro.configs.registry import ShapeSpec
    from repro.models.model import init_caches as jcaches
    from repro_torch.models.model import init_caches

    shape = ShapeSpec("t", 16, 8, "train")
    tshape = treg.ShapeSpec("t", 16, 8, "train")
    rules((2, 2), ("data", "model"), kind)
    for arch in ("qwen3-8b", "qwen2-vl-72b", "jamba-1.5-large-398b"):
        cfg, tcfg = reduce_for_smoke(ARCHS[arch]), reduce_for_smoke(treg.ARCHS[arch])
        jb = jspecs.batch_specs(cfg, shape)
        tb = SP.batch_specs(tcfg, tshape)
        assert {k: tuple(v.shape) for k, v in jb.items()} == {
            k: tuple(v.shape) for k, v in tb.items()}
        assert all(v.device.type == "meta" for v in tb.values())
        assert {k: tuple(v) for k, v in jspecs.batch_pspecs(jb).items()} == \
            SP.batch_pspecs(tb)
        for fn in ("decode_specs", "prefill_specs"):
            jt = getattr(jspecs, fn)(cfg, shape)
            tt = getattr(SP, fn)(tcfg, tshape)
            assert [tuple(a.shape) for a in jt] == [tuple(a.shape) for a in tt]
        jc = jax.eval_shape(lambda c=cfg: jcaches(c, 4, 16, jnp.float32))
        tc = init_caches(tcfg, 4, 16, device="cpu")
        want = {}
        for key, leaf in _ref_flat(jspecs.cache_pspecs(jc)).items():
            if leaf is not None:
                want[(key[0], key[-1])] = tuple(leaf)
        got = SP.cache_pspecs(tc)
        for pos, node in got.items():
            for f in dataclasses.fields(node):
                spec = getattr(node, f.name)
                if spec is not None:
                    assert spec == want[(pos, f.name)], (arch, pos, f.name)


@pytest.mark.parametrize("shape", [(64,), (8, 64), (3, 5, 7)])
@pytest.mark.parametrize("scale", [1e-6, 1.0, 300.0])
def test_compress_leaf_bit_equal(shape, scale):
    g = (np.random.default_rng(len(shape)).standard_normal(shape)
         * scale).astype(np.float32)
    jq, js = jcompress.compress_leaf(jnp.asarray(g))
    tq, ts = tcompress.compress_leaf(torch.from_numpy(g))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts.item()) == np.float32(js)
    np.testing.assert_array_equal(
        tcompress.decompress_leaf(tq, ts).numpy(),
        np.asarray(jcompress.decompress_leaf(jq, js)))


def test_compress_with_ef_bit_equal():
    rng = np.random.default_rng(7)
    grads = {"w": rng.standard_normal((16, 8)).astype(np.float32),
             "b": [rng.standard_normal(8).astype(np.float32) * 1e-3]}
    err = {"w": rng.standard_normal((16, 8)).astype(np.float32) * 0.01,
           "b": [np.zeros(8, np.float32)]}
    jcodes, jerr = jcompress.compress_with_ef(
        {"w": jnp.asarray(grads["w"]), "b": [jnp.asarray(grads["b"][0])]},
        {"w": jnp.asarray(err["w"]), "b": [jnp.asarray(err["b"][0])]})
    tcodes, terr = tcompress.compress_with_ef(
        {"w": torch.from_numpy(grads["w"]), "b": [torch.from_numpy(grads["b"][0])]},
        {"w": torch.from_numpy(err["w"]), "b": [torch.from_numpy(err["b"][0])]})
    for jc, tc in ((jcodes["w"], tcodes["w"]), (jcodes["b"][0], tcodes["b"][0])):
        np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc[0]))
        assert np.float32(tc[1].item()) == np.float32(jc[1])
    np.testing.assert_array_equal(terr["w"].numpy(), np.asarray(jerr["w"]))
    np.testing.assert_array_equal(terr["b"][0].numpy(), np.asarray(jerr["b"][0]))
    zeros = tcompress.init_error(tcodes)
    assert torch.equal(zeros["w"][0], torch.zeros(16, 8))


@pytest.mark.parametrize("arch", SMOKE_ARCHS + ("jamba-1.5-large-398b",))
def test_constrain_is_the_identity_without_rules(arch, monkeypatch):
    from repro_torch.models import attention, layers, mamba2, model, moe
    from repro_torch.models.model import forward, init_model

    calls = []

    def spy(x, logical_axes):
        out = shd.constrain(x, logical_axes)
        calls.append(out is x)
        return out

    for mod in (attention, layers, mamba2, model, moe):
        monkeypatch.setattr(mod, "constrain", spy)
    cfg = reduce_for_smoke(treg.ARCHS[arch])
    params = init_model(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 5), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        forward(params, toks, cfg)
    assert calls and all(calls)
    assert shd.shard_frozen_params(params) is params
    caches = {"pos_0": object()}
    assert shd.shard_paged_caches(caches) is caches
    x = torch.ones(2, 3)
    assert shd.constrain(x, ("batch", "embed")) is x
    assert shd.replicated(torch.add, x, x).equal(x + x)


def test_checkpoint_host_copy_of_a_dtensor_does_not_alias(tmp_path):
    """A DTensor leaf handed to the async checkpointer is copied on the
    caller's thread: the writer never reads the live state, which the next
    step updates in place (a replicated leaf's full value on a CPU mesh is
    its local tensor itself)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.checkpoint import ckpt as tckpt
    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        live = {"rep": DTensor.from_local(torch.zeros(4, 3), mesh,
                                          [Replicate(), Replicate()]),
                "shard": DTensor.from_local(torch.zeros(4, 3), mesh,
                                            [Replicate(), Shard(1)])}
        host = tckpt._on_host(live, copy=True)
        for k, t in live.items():
            assert not torch._C._is_alias_of(host[k], t.to_local()), k
        ac = tckpt.AsyncCheckpointer(str(tmp_path / "ckpt"), keep=2)
        ac.submit(1, live)
        for t in live.values():
            t.to_local().add_(1)  # the step goes on updating in place
        ac.wait()
        ac.close()
        out = tckpt.restore(str(tmp_path / "ckpt"), 1,
                            {k: torch.empty(4, 3) for k in live})
        for k in live:
            assert torch.equal(out[k], torch.zeros(4, 3)), k
    finally:
        dist.destroy_process_group()
