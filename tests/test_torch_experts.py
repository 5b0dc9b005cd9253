"""PyTorch port vs the JAX reference: both DA VMM kernels over stacked experts.

The reference applies a stacked ``[E, K, N]`` pack by ``jax.vmap`` of its
Pallas kernels, one ``pallas_call`` with the expert on its grid
(``(E, ..)``, or ``(G, E, ..)`` for grouped inputs).  The port's batched
entries (``kernels/ops.py: bitplane_vmm_experts`` / ``da_vmm_experts``) are
one call per pack too; on the CPU they run their plain versions, held here
bit-exactly against the vmapped Pallas kernels in interpret mode.  The port
folds the groups into each expert's rows, which gives the same integers
(quantization is per row).  Then: ``dense`` makes one backend call per pack,
the plans count the experts' blocks, and the expert strides the wrapper
hands to C are 64-bit.  The kernels themselves run in
``tests/test_torch_gpu.py`` on the card.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.da import DAConfig as JDA
from repro.core.da import build_luts as jbuild_luts
from repro.kernels.bitplane_vmm import bitplane_vmm_pallas
from repro.kernels.da_vmm import da_vmm_pallas
from repro_torch.core import engine as teng
from repro_torch.core.da import DAConfig
from repro_torch.kernels import bitplane_vmm as tbp
from repro_torch.kernels import da_vmm as tlut
from repro_torch.kernels import ops, ref

#: an H100's SMs
SMS = 132


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _codes(rng, shape, x_bits):
    half = 1 << (x_bits - 1)
    return rng.integers(-half, half, shape).astype(np.int32)


def _fold(x: np.ndarray) -> torch.Tensor:
    """[G, E, C, K] → [E, G·C, K]: each expert's rows of every group."""
    g, e, c, k = x.shape
    return _t(x).movedim(0, 1).reshape(e, g * c, k)


def _unfold(y: torch.Tensor, g: int) -> np.ndarray:
    e, gc, n = y.shape
    return y.reshape(e, g, gc // g, n).movedim(1, 0).numpy()


# ---------------------------------------------------------------------------
# the batched plain versions against the vmapped Pallas kernels
# ---------------------------------------------------------------------------

_SHAPES = [(4, 3, 200, 20), (8, 2, 256, 16), (2, 5, 37, 9)]


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("x_bits", [8, 4])
@pytest.mark.parametrize("e,c,k,n", _SHAPES)
def test_bitplane_experts_plain_matches_vmapped_pallas_interpret(e, c, k, n, x_bits,
                                                                grouped):
    """Ragged K (200, 37) and N (20, 9); x_bits 8 and the truncated draft's 4."""
    rng = np.random.default_rng(e + c + k + n + x_bits + grouped)
    x = _codes(rng, (2, e, c, k) if grouped else (e, c, k), x_bits)
    w = rng.integers(-127, 128, (e, k, n)).astype(np.int8)
    jcfg = JDA(x_bits=x_bits, x_signed=True)

    def one(xe, we):
        return bitplane_vmm_pallas(xe, we, jcfg, interpret=True)

    batched = jax.vmap(one)
    if grouped:
        want = jax.vmap(lambda xg: batched(xg, jnp.asarray(w)))(jnp.asarray(x))
        got = _unfold(ops.bitplane_vmm_experts(_fold(x), _t(w), DAConfig(
            x_bits=x_bits, x_signed=True)), 2)
    else:
        want = batched(jnp.asarray(x), jnp.asarray(w))
        got = ops.bitplane_vmm_experts(_t(x), _t(w), DAConfig(
            x_bits=x_bits, x_signed=True)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("x_bits", [8, 4])
@pytest.mark.parametrize("group", [4, 8])
def test_lut_experts_plain_matches_vmapped_pallas_interpret(group, x_bits, grouped):
    """K = 37 (not whole groups of 4 or 8), N = 19."""
    e, c, k, n = 3, 4, 37, 19
    rng = np.random.default_rng(group + x_bits + grouped)
    x = _codes(rng, (2, e, c, k) if grouped else (e, c, k), x_bits)
    w = rng.integers(-127, 128, (e, k, n)).astype(np.int32)
    jluts = jax.vmap(lambda we: jbuild_luts(we, group))(jnp.asarray(w))
    jcfg = JDA(group_size=group, x_bits=x_bits, x_signed=True)
    cfg = DAConfig(group_size=group, x_bits=x_bits, x_signed=True)

    def one(xe, le):
        return da_vmm_pallas(xe, le, jcfg, bm=8, bn=32, bg=4, interpret=True)

    batched = jax.vmap(one)
    luts = _t(np.asarray(jluts))
    if grouped:
        want = jax.vmap(lambda xg: batched(xg, jluts))(jnp.asarray(x))
        got = _unfold(ops.da_vmm_experts(_fold(x), luts, cfg), 2)
    else:
        want = batched(jnp.asarray(x), jluts)
        got = ops.da_vmm_experts(_t(x), luts, cfg).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("mode", ["pallas_bitplane", "pallas_lut"])
def test_reference_applies_a_stacked_pack_in_one_pallas_call(mode):
    """What the port's one call per pack mirrors: the reference's ``dense``
    on a [4, 64, 32] pack lowers to ONE ``pallas_call`` whose grid leads
    with the expert, (E, m, n, k), or (G, E, m, n, k) for grouped inputs."""
    from repro.core import engine as jeng

    w = np.random.default_rng(0).normal(size=(4, 64, 32)).astype(np.float32)
    pack = jeng.pack_weights(jnp.asarray(w), JDA(x_signed=True), mode=mode,
                             with_luts=mode == "pallas_lut")
    for shape, lead in (((4, 3, 64), (4,)), ((2, 4, 3, 64), (2, 4))):
        text = str(jax.make_jaxpr(lambda x: jeng.dense(x, pack))(jnp.ones(shape)))
        grids = re.findall(r"grid=\(([^)]*)\)", text)
        assert text.count("pallas_call") == 1 and len(grids) == 1
        assert tuple(int(v) for v in grids[0].split(","))[:len(lead)] == lead


def test_experts_refs_equal_the_2d_plain_versions():
    rng = np.random.default_rng(3)
    cfg = DAConfig(x_signed=True)
    x = _t(_codes(rng, (3, 5, 40), 8))
    w = _t(rng.integers(-127, 128, (3, 40, 12)).astype(np.int8))
    luts = torch.stack([teng.build_luts(w[i].to(torch.int32), 8) for i in range(3)])
    bp = ref.bitplane_vmm_experts_ref(x, w, cfg)
    lut = ref.da_vmm_experts_ref(x, luts, cfg)
    for i in range(3):
        assert torch.equal(bp[i], ref.bitplane_vmm_ref(x[i], w[i], cfg))
        assert torch.equal(lut[i], ref.da_vmm_ref(x[i], luts[i], cfg))


# ---------------------------------------------------------------------------
# dense: one backend call per pack
# ---------------------------------------------------------------------------

_MODES = ["lut", "onehot", "pallas_lut", "bitplane", "bitplane_stacked",
          "pallas_bitplane", "int8"]


def _counting(monkeypatch, owner, name, calls):
    """Replace ``owner.<name>`` by a call of itself that appends
    (name, codes' shape, x_bits) to ``calls``."""
    fn = getattr(owner, name)

    def counted(xq, table, cfg):
        calls.append((name, tuple(xq.shape), cfg.x_bits))
        return fn(xq, table, cfg)

    monkeypatch.setattr(owner, name, counted)


def test_every_kernel_mode_has_a_batched_form():
    """The six modes that run a kernel on CUDA have a form over stacked
    experts; ``int8`` (``torch._int_mm`` does not batch) has none."""
    have = {n for n, s in teng.registered_backends().items() if s.experts_fn}
    assert have == set(_MODES) - {"int8"}


#: what each mode calls on the CPU: (function, calls per pack)
_CPU_CALLS = {"pallas_bitplane": ("bitplane_vmm_experts", 1),
              "pallas_lut": ("da_vmm_experts", 1),
              "lut": ("da_vmm_lut", "E"), "onehot": ("da_vmm_onehot", "E"),
              "bitplane": ("da_vmm_bitplane", "E"),
              "bitplane_stacked": ("da_vmm_bitplane_stacked", "E"),
              "int8": ("int8", "E")}


@pytest.mark.parametrize("override", [None, 4])
@pytest.mark.parametrize("mode", _MODES)
def test_dense_on_stacked_pack_makes_one_backend_call_per_pack(monkeypatch, mode,
                                                               override):
    """[E, C, K] and grouped [G, E, C, K] activations: a ``pallas_*`` mode
    reaches its ops entry over stacked experts once per pack (on the CPU its
    plain version, on CUDA its kernel), at x_bits 4 under
    ``x_bits_override(4)``, every group's rows together; the other modes'
    plain CPU forms and ``int8`` run once per expert, and no mode reaches
    the 2-D ops entries.  Each output equals a :func:`da_matmul` of that
    expert's rows."""
    e, c, k, n = 3, 4, 16, 8
    rng = np.random.default_rng(11)
    pack = teng.pack_weights(_t(rng.normal(size=(e, k, n)).astype(np.float32)),
                             mode=mode, with_luts=True)
    calls = []
    for name in ("bitplane_vmm_experts", "da_vmm_experts", "bitplane_vmm", "da_vmm"):
        _counting(monkeypatch, ops, name, calls)
    for name in ("da_vmm_lut", "da_vmm_onehot", "da_vmm_bitplane",
                 "da_vmm_bitplane_stacked"):
        _counting(monkeypatch, teng, name, calls)
    spec = teng.get_backend("int8")
    monkeypatch.setitem(teng._REGISTRY, "int8", teng.dataclasses.replace(
        spec, fn=lambda xq, p, cfg: calls.append(("int8", tuple(xq.shape),
                                                  cfg.x_bits)) or spec.fn(xq, p, cfg)))
    name, per_pack = _CPU_CALLS[mode]
    for shape in ((e, c, k), (2, e, c, k)):
        x = _t(rng.normal(size=shape).astype(np.float32))
        with teng.x_bits_override(override):
            xe = x.movedim(-3, 0)
            want = torch.stack([teng.da_matmul(xe[i], pe)
                                for i, pe in enumerate(pack.experts())])
            calls.clear()
            y = teng.dense(x, pack)
        assert torch.equal(y, want.movedim(0, -3))
        rows = c * (2 if len(shape) == 4 else 1)
        bits = override or 8
        if per_pack == 1:
            assert calls == [(name, (e, rows, k), bits)]
        else:
            assert calls == [(name, (rows, k), bits)] * e


# ---------------------------------------------------------------------------
# plans and strides
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048)])
def test_bitplane_plan_with_experts_has_no_split_at_qwen2_moe_decode(k, n):
    """qwen2-moe-a2.7b's expert packs at width-4 decode (E = 64, M = 4):
    704 or 1024 tiles fill the card without a K split, so no zeroing memset;
    one of those matrices alone splits K."""
    plan = tbp.bitplane_plan(4, k, n, SMS, 64)
    assert plan.splits == 1 and plan.k_per_split >= k
    assert plan.blocks == 64 * -(-n // 128) and plan.blocks in (704, 1024)
    assert tbp.bitplane_plan(4, k, n, SMS).splits > 1


@pytest.mark.parametrize("m,k,n,want", [
    (4, 2048, 1408, (2, 1, 4, 4, 512, 44, 66560)),
    (4, 1408, 2048, (2, 1, 4, 3, 512, 48, 66560)),
    (16, 2048, 1408, (4, 2, 16, 4, 512, 44, 69632)),
    (4, 4096, 12288, (2, 1, 4, 3, 1408, 288, 66560)),
    (64, 4096, 4096, (4, 4, 32, 5, 896, 320, 73728))])
def test_bitplane_plan_of_one_matrix_is_unchanged(m, k, n, want):
    """E = 1 gives the plan a single matrix had before the expert axis."""
    assert tuple(tbp.bitplane_plan(m, k, n, SMS)) == want
    assert tbp.bitplane_plan(m, k, n, SMS, 1) == tbp.bitplane_plan(m, k, n, SMS)


@pytest.mark.parametrize("m,n,g,want", [
    (4, 512, 32, (4, 1, 1, 1, 512)), (16, 512, 32, (4, 2, 1, 1, 1024)),
    (4, 8000, 32, (4, 1, 8, 4, 1008)), (64, 768, 32, (4, 2, 8, 4, 768))])
def test_lut_plan_counts_the_experts_blocks(m, n, g, want):
    """E = 1 is unchanged; E experts' blocks count together, so the groups
    are cut into no more ranges than one matrix's (a stack that fills the
    card takes ``_GPB`` groups a block)."""
    assert tuple(tlut.lut_plan(m, n, g, SMS)) == want
    one = tlut.lut_plan(m, n, g, SMS)
    for e in (6, 64):
        plan = tlut.lut_plan(m, n, g, SMS, e)
        splits = -(-g // plan.gpb)
        assert plan.blocks == e * -(-n // (32 * plan.vec)) * -(-m // plan.bm) * splits
        assert splits <= -(-g // one.gpb) and plan.gpb <= 8
    # qwen2-moe's expert shape at decode, were it tabled (L = 8: 256 groups)
    plan = tlut.lut_plan(4, 1408, 256, SMS, 64)
    assert plan.gpb == 8 and plan.blocks == 64 * 11 * 4 * 32


def test_expert_strides_of_the_jamba_leaf_need_64_bits():
    """jamba-1.5-large's expert leaf [16, 8192, 24576] (3.2 GB of codes): the
    last expert starts 3.02e9 elements in, which int32 cannot hold, so the
    strides go to C as 64-bit integers."""
    e, k, n, m = 16, 8192, 24576, 4
    sx, sw, sy = tbp.expert_strides(m, k, n, (k * n, n, 1))
    assert (sx, sw, sy) == (m * k, k * n, m * n)
    last = (e - 1) * sw
    assert last == 3019898880 > torch.iinfo(torch.int32).max
    assert ctypes.c_int(last).value != last
    assert ctypes.c_longlong(last).value == last
    assert tbp.ARGTYPES[8:11] == [ctypes.c_longlong] * 3  # xq, w, y strides
    assert tlut.ARGTYPES[9:12] == [ctypes.c_longlong] * 3  # xq, luts, out
    assert len(tbp.ARGTYPES) == 18 and len(tlut.ARGTYPES) == 20


@pytest.mark.parametrize("strides", [
    (16 * 8 - 1, 8, 1),     # experts overlap
    (16 * 16, 16, 2),       # a column stride
    (16 * 8, 1, 16),        # the transpose
    (16 * 8, 7, 1)])        # rows shorter than N
def test_expert_strides_refuse_what_the_kernel_cannot_read(strides):
    with pytest.raises(ValueError, match="weight strides"):
        tbp.expert_strides(4, 16, 8, strides)
    assert tbp.expert_strides(4, 16, 8, (16 * 8 + 64, 8, 1))[1] == 16 * 8 + 64


def test_experts_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the ops entry takes the plain version; the kernel
    wrappers themselves take CUDA tensors only."""
    cfg = DAConfig(x_signed=True)
    x = torch.zeros((2, 3, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tbp.bitplane_vmm_experts_cuda(x, torch.zeros((2, 16, 8), dtype=torch.int8), cfg)
    with pytest.raises(ValueError, match="CUDA"):
        tlut.da_vmm_experts_cuda(x, torch.zeros((2, 2, 256, 8), dtype=torch.int32), cfg)
