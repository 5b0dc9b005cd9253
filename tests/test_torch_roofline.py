"""PyTorch port vs the JAX reference: the roofline of the dry-run tools, in
one process (no world, no tensors).

* ``tests/test_roofline.py``'s cases on the port's ``Roofline`` with its
  own (H100) constants;
* ``model_flops``, ``count_params`` and ``count_active_params`` equal to
  the reference's for every arch × ``shapes_for`` shape;
* ``collective_bytes`` over hand-built ``(op name, result bytes)``
  records: each kind under the reference's name, a functional collective
  and its ``wait_tensor`` (the ``-start`` / ``-done`` pair) counted once;
* every term of the port's ``Roofline`` equal to the reference's on the
  same inputs times the ratio of the two packages' constants.
"""
import pytest

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.registry import shapes_for as jshapes_for
from repro.launch import roofline as jrl
from repro.models.model import count_active_params as jcount_active
from repro.models.model import count_params as jcount_params
from repro_torch.configs.registry import ARCHS, LM_SHAPES, shapes_for
from repro_torch.launch import roofline as rl
from repro_torch.launch.roofline import (
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    Roofline,
    collective_bytes,
    model_flops,
)
from repro_torch.models.model import count_active_params, count_params

RECORDS = [
    ("_c10d_functional.all_gather_into_tensor", 256 * 4096 * 2),
    ("_c10d_functional.wait_tensor", 256 * 4096 * 2),       # its -done
    ("_c10d_functional.all_reduce", 128 * 1024 * 4),
    ("_c10d_functional.wait_tensor", 128 * 1024 * 4),
    ("c10d.allreduce_", 2 * 2 * 4),                         # a c10d call
    ("_c10d_functional.reduce_scatter_tensor", 64 * 64 * 4),
    ("_c10d_functional.all_to_all_single", 2 * 8 * 8 * 4),
    ("c10d.send", 16 * 2),
    ("aten.add", 9 * 4),                                    # not a collective
]


def test_collective_records():
    got = collective_bytes(RECORDS)
    assert got["all-gather"] == 256 * 4096 * 2
    assert got["all-reduce"] == 128 * 1024 * 4 + 2 * 2 * 4  # each wait skipped
    assert got["reduce-scatter"] == 64 * 64 * 4
    assert got["all-to-all"] == 2 * 8 * 8 * 4
    assert got["collective-permute"] == 16 * 2
    assert set(got) == {"all-gather", "all-reduce", "reduce-scatter",
                        "all-to-all", "collective-permute"}


@pytest.mark.parametrize("name,kind", [
    ("_c10d_functional.all_gather_into_tensor", "all-gather"),
    ("c10d._allgather_base_", "all-gather"),
    ("c10d.reduce_scatter_", "reduce-scatter"),
    ("c10d.alltoall_base_", "all-to-all"),
    ("c10d.recv_", "collective-permute"),
    ("_c10d_functional.wait_tensor", None),
    ("c10d.barrier", None),
    ("aten.all_gather_like", None),
])
def test_collective_kind(name, kind):
    assert rl.collective_kind(name) == kind


def test_roofline_terms_and_bottleneck():
    r = Roofline(
        flops_per_chip=PEAK_FLOPS,          # exactly 1 s of compute
        bytes_per_chip=HBM_BW / 2,          # 0.5 s of HBM
        coll_bytes_per_chip=LINK_BW * 2,    # 2 s of NVLink
        chips=256,
        model_flops_global=PEAK_FLOPS * 256 / 2,
    )
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == pytest.approx(2.0)
    assert r.bottleneck == "collective"
    assert r.t_bound == pytest.approx(2.0)
    assert r.useful_flops_fraction == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(0.25)  # 0.5s useful / 2s bound


def test_h100_constants():
    assert (PEAK_FLOPS, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)


def test_model_flops_by_kind():
    train = next(s for s in LM_SHAPES if s.kind == "train")
    dec = next(s for s in LM_SHAPES if s.name == "decode_32k")
    n = 1e9
    assert model_flops(None, train, n, n) == 6 * n * train.global_batch * train.seq_len
    assert model_flops(None, dec, n, n) == 2 * n * dec.global_batch


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_and_counts_equal_the_reference(arch):
    cfg, jcfg = ARCHS[arch], JARCHS[arch]
    n, na = count_params(cfg), count_active_params(cfg)
    assert (n, na) == (jcount_params(jcfg), jcount_active(jcfg))
    shapes = shapes_for(cfg)
    assert [s.name for s in shapes] == [s.name for s in jshapes_for(jcfg)]
    for s, js in zip(shapes, jshapes_for(jcfg)):
        assert model_flops(cfg, s, n, na) == jrl.model_flops(jcfg, js, n, na)


@pytest.mark.parametrize("inputs", [
    (1.6e10, 1.85e9, 2.3e7, 256, 2.2e11),
    (6.4e14, 2.6e13, 6.7e11, 512, 5.2e16),
    (0.0, 1.0, 0.0, 1, 0.0),
])
def test_terms_equal_the_reference_times_the_constants(inputs):
    flops, byts, coll, chips, mf = inputs
    kw = dict(flops_per_chip=flops, bytes_per_chip=byts,
              coll_bytes_per_chip=coll, chips=chips, model_flops_global=mf)
    r, jr = Roofline(**kw), jrl.Roofline(**kw)
    assert r.t_compute == pytest.approx(jr.t_compute * jrl.PEAK_FLOPS / PEAK_FLOPS)
    assert r.t_memory == pytest.approx(jr.t_memory * jrl.HBM_BW / HBM_BW)
    assert r.t_collective == pytest.approx(jr.t_collective * jrl.ICI_BW / LINK_BW)
    assert r.useful_flops_fraction == pytest.approx(jr.useful_flops_fraction)
    assert set(r.as_dict()) == set(jr.as_dict())
