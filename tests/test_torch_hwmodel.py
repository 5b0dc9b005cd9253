"""PyTorch port vs the JAX reference: the paper's hardware cost model
(``core/hwmodel.py``, a copy) reproduces Table I and scales per Fig. 5, and
the bit-slicing baseline (``core/bitslice.py``, plain int32 torch ops) is
bit-exact to the reference's at the reference's cases, ADC clipping
included.  The model's numbers are the paper's ReRAM circuits, reckoned; no
device is measured here.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitslice as jbs
from repro.core import hwmodel as jhw
from repro_torch.core.bitslice import (
    BitSliceConfig,
    adc_bits_required,
    bitslice_vmm,
    weight_bit_columns,
)
from repro_torch.core.hwmodel import (
    PJ,
    T_ADD_STAGE,
    T_READ_PIPE,
    BitSliceDesign,
    DADesign,
    split_groups,
    table1,
)

CONV1 = dict(k=25, n=6)


# ---------------------------------------------------------------------------
# the cost model: the paper's numbers (the reference's test_hwmodel.py)
# ---------------------------------------------------------------------------
def test_conv1_geometry():
    """§III: two 256×66 + one 512×66 arrays, 198 SAs, 12/13/21-bit adders."""
    d = DADesign(**CONV1)
    assert d.groups == [8, 8, 9]
    assert d.array_rows == [256, 256, 512]
    assert d.array_cols == 66
    assert d.memory_cells == 67584
    assert d.n_sense_amps == 198
    assert d.adder_widths == [12, 13, 21]


def test_latency_88ns_and_energy_110pj():
    """§III-D: 15 + 7·10 + 3 = 88 ns; 110.2 pJ per VMM, 6.88 pJ amortized
    pre-VMM (24576 adds × 52 fJ + 67584 writes × 1 pJ = 68.8 nJ)."""
    d = DADesign(**CONV1)
    assert d.latency_ns() == pytest.approx(88.0)
    assert d.energy_vmm_j() / PJ == pytest.approx(110.2, rel=1e-6)
    assert d.pre_vmm_energy_j() / 1e-9 == pytest.approx(68.8, rel=0.01)
    assert d.energy_per_vmm_amortized_j() / PJ == pytest.approx(117.0, rel=0.01)


def test_bitslice_baseline_numbers():
    """§IV: 25×48 array, 400 ns, 1421.5 pJ, 47286 T, 1584 R, 5-bit ADC."""
    b = BitSliceDesign(**CONV1)
    assert b.memory_cells == 1200
    assert b.adc_bits == 5
    assert b.latency_ns() == pytest.approx(400.0)
    assert b.energy_vmm_j() / PJ == pytest.approx(1421.5, rel=1e-6)
    assert round(b.transistors()) == 47286
    assert b.resistors() == 1584


def test_table1_ratios():
    """The paper's headline claims: 4.5× latency, 12× energy, 56× cells,
    2.3× transistors."""
    t = table1()
    assert t["latency_ratio"] == pytest.approx(4.5, rel=0.02)
    assert t["energy_ratio"] == pytest.approx(12.0, rel=0.05)
    assert t["cell_ratio"] == pytest.approx(56.0, rel=0.01)
    assert t["transistor_ratio"] == pytest.approx(2.3, rel=0.01)
    assert round(t["da"]["transistors"]) == 20622


@pytest.mark.parametrize("k,n,pmas,latency", [
    (8, 8, 1, 88.0), (16, 16, 2, 88.0),
    # 4 PMAs (chain depth 3): the stagger no longer fits the cycle
    (32, 32, 4, 97.0)])
def test_scaling_fig5(k, n, pmas, latency):
    """Fig. 5: 16×16 → two 256-row PMAs, one extra adder stage; latency is
    read-dominated while the 2 ns stagger hides inside the read cycle."""
    d = DADesign(k=k, n=n)
    assert d.n_arrays == pmas
    assert d.latency_ns() == pytest.approx(latency)
    if k == 16:
        assert d.array_cols == 16 * 11  # 176 columns (paper)
        assert d.energy_vmm_j() > DADesign(k=8, n=8).energy_vmm_j()


@pytest.mark.parametrize("k,groups", [
    (8, [8]), (16, [8, 8]), (25, [8, 8, 9]), (32, [8, 8, 8, 8]), (5, [5])])
def test_group_split_rules(k, groups):
    assert split_groups(k) == groups


def test_group_split_covers_k_and_columns_do_not_add_latency():
    """'If we had more columns (say 20 instead of 8), we will still require
    only 8 cycles' (§II-C)."""
    assert sum(split_groups(1000)) == 1000
    assert DADesign(k=8, n=8).latency_ns() == DADesign(k=8, n=20).latency_ns()


def test_energy_scales_to_lm_layer():
    d = DADesign(k=4096, n=12288)
    assert d.memory_cells == sum(1 << g for g in d.groups) * 12288 * 11
    assert d.latency_ns() > 88.0  # deep adder tree stretches the tail
    assert d.energy_vmm_j() > 0


def test_tree_topology_beyond_paper():
    """A pipelined adder tree keeps the cycle read-limited at any K; fair
    ADC scaling keeps bit-slicing honest at large K, and the advantage
    survives at LM-layer scale."""
    d = DADesign(k=4096, n=4096, adder_topology="tree")
    assert d.latency_ns() == pytest.approx(
        88.0 + math.ceil(math.log2(512)) * 2.5)
    d3 = DADesign(k=25, n=6, adder_topology="tree")
    assert d3.latency_ns() == pytest.approx(88.0 + 2 * 2.5 - 0.0, abs=5.1)
    b = BitSliceDesign(k=4096, n=4096)
    assert b.adc_bits == 13
    assert b._adc_scale == 2 ** 8 and BitSliceDesign(k=25, n=6)._adc_scale == 1.0
    assert b.energy_vmm_j() / d.energy_vmm_j() > 10
    assert b.latency_ns() / d.latency_ns() > 3


# ---------------------------------------------------------------------------
# the copy equals the reference
# ---------------------------------------------------------------------------
def test_table1_equals_the_reference_exactly():
    assert table1() == jhw.table1()
    assert table1(k=64, n=32) == jhw.table1(k=64, n=32)
    assert (T_ADD_STAGE, T_READ_PIPE) == (jhw.T_ADD_STAGE, jhw.T_READ_PIPE)


@pytest.mark.parametrize("k,n,x_bits,group,topology", [
    (25, 6, 8, 8, "chain"), (4096, 12288, 8, 8, "chain"),
    (4096, 4096, 4, 8, "tree"), (12288, 4096, 8, 4, "chain"),
    (256, 8000, 6, 8, "chain")])
def test_designs_equal_the_reference(k, n, x_bits, group, topology):
    ours = DADesign(k=k, n=n, x_bits=x_bits, base_group=group,
                    adder_topology=topology)
    ref = jhw.DADesign(k=k, n=n, x_bits=x_bits, base_group=group,
                       adder_topology=topology)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    for fn in ("latency_ns", "energy_vmm_j", "transistors",
               "energy_components_j", "pre_vmm_energy_j"):
        assert getattr(ours, fn)() == getattr(ref, fn)(), fn
    bs = BitSliceDesign(k=k, n=n, x_bits=x_bits)
    jbs_ = jhw.BitSliceDesign(k=k, n=n, x_bits=x_bits)
    for fn in ("latency_ns", "energy_vmm_j", "transistors",
               "energy_components_j", "resistors"):
        assert getattr(bs, fn)() == getattr(jbs_, fn)(), fn


# ---------------------------------------------------------------------------
# the bit-slicing baseline: bit-exact to the reference
# ---------------------------------------------------------------------------
def _both(x, w, **cfg):
    ref = np.asarray(jbs.bitslice_vmm(jnp.asarray(x), jnp.asarray(w),
                                      jbs.BitSliceConfig(**cfg)))
    ours = bitslice_vmm(torch.from_numpy(x), torch.from_numpy(w),
                        BitSliceConfig(**cfg))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    return ours.numpy()


@pytest.mark.parametrize("seed", range(10))
def test_bitslice_exact_with_sufficient_adc(seed):
    rng = np.random.default_rng(seed)
    m, k, n = (int(rng.integers(1, 7)), int(rng.integers(1, 31)),
               int(rng.integers(1, 9)))
    signed = bool(rng.integers(0, 2))
    x = (rng.integers(-128, 128, (m, k)) if signed
         else rng.integers(0, 256, (m, k))).astype(np.int32)
    w = rng.integers(-128, 128, (k, n)).astype(np.int32)
    got = _both(x, w, x_signed=signed, adc_bits=adc_bits_required(k))
    np.testing.assert_array_equal(got, x @ w)


@pytest.mark.parametrize("k,signed", [
    (1, False), (1, True), (25, False), (25, True), (30, False), (30, True)])
def test_bitslice_exact_edges(k, signed):
    """Pinned column depths: exactness holds at the resolution boundary."""
    rng = np.random.default_rng(k)
    x = (rng.integers(-128, 128, (4, k)) if signed
         else rng.integers(0, 256, (4, k))).astype(np.int32)
    w = rng.integers(-128, 128, (k, 5)).astype(np.int32)
    got = _both(x, w, x_signed=signed, adc_bits=adc_bits_required(k))
    np.testing.assert_array_equal(got, x @ w)


@pytest.mark.parametrize("adc_bits", [3, 4, None])
def test_bitslice_adc_clipping_equals_the_reference(adc_bits):
    """With all-ones inputs and weights a column counts K rows: an ADC below
    log2(K+1) bits clips and the result is wrong, identically in both
    packages (the resolution pressure DA removes)."""
    k = 25
    x = np.full((1, k), 255, dtype=np.int32)
    w = np.full((k, 1), 1, dtype=np.int32)
    got = _both(x, w, adc_bits=adc_bits)
    assert (got[0, 0] < 255 * k) == (adc_bits is not None)
    rng = np.random.default_rng(3)
    _both(rng.integers(-128, 128, (3, 30)).astype(np.int32),
          rng.integers(-128, 128, (30, 4)).astype(np.int32),
          x_signed=True, adc_bits=adc_bits)


def test_adc_bits_and_weight_columns():
    assert [adc_bits_required(r) for r in (25, 1, 255)] == [5, 1, 8]
    for r in (1, 7, 25, 1000):
        assert adc_bits_required(r) == jbs.adc_bits_required(r)
    w = np.random.default_rng(1).integers(-128, 128, (6, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        weight_bit_columns(torch.from_numpy(w), BitSliceConfig()).numpy(),
        np.asarray(jbs.weight_bit_columns(jnp.asarray(w), jbs.BitSliceConfig())))
