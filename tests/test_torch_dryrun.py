"""PyTorch port vs the JAX reference: the dry-run (``launch/dryrun.py``,
``launch/perf.py``) on fake worlds, on the CPU (``--device cpu``).

Each fake world runs in a subprocess of its own, so no process group
leaks between the tests of one xdist worker; the module's subprocesses
all start together, at its first test that needs one.

* the reference's ``test_dryrun_cells_on_small_mesh`` recast:
  ``reduce_for_smoke(jamba-1.5-large-398b)`` in bf16, train / prefill /
  decode on (2, 4) and (2, 2, 2): FLOPs > 0, memory recorded;
* one-device FLOPs of ``reduce_for_smoke(qwen3-8b)`` (f32, batch 4 × seq
  64) against the reference's ``cost_analysis()`` on one CPU device (a
  JAX subprocess): the port counts products only, XLA elementwise work
  too, so the ratio sits below 1 (0.940 train, 0.956 decode, measured),
  held within ``XLA_BAND`` of those;
* per-chip FLOPs on (2, 4) against the one-device count ÷ 8 (vocab 96 so
  that every product divides): decode and prefill exactly, train within
  ``TRAIN_LOCAL_BAND`` (at these widths DTensor gathers a few backward
  products); a count of the global-shape ops would be 8× or more.  The
  collectives the counter records are CommDebugMode's, call for call;
* a DA-frozen tiny model (``pallas_bitplane``, the kernel op on every
  device): counted bytes ≥ the codes' bytes, each VMM's 2·M·K·N present;
* the production-mesh repairs on the fake 256-rank world at qwen3-8b full
  width and 2 layers: decode, prefill and train run (8 KV heads on a
  16-way model axis, the dense caches placed and written on each rank's
  block, the prefill's fake caches taken as empty), and a one-device
  forward through the dense caches is EQUAL to one with the old code;
* ``mamba2-780m`` ``decode_32k`` ``DA_auto``: ``n_params`` and
  ``model_flops_global`` equal to the reference's committed record;
* the CLI refuses ``--device cuda`` without a card; ``perf.VARIANTS``
  names and levers equal the reference's.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's one-device FLOPs over XLA's, measured (train, decode), and
#: the band held around them
XLA_RATIO, XLA_BAND = {"train": 0.940, "decode": 0.956}, 0.02
#: per-chip train FLOPs × 8 over the one-device count on (2, 4)
TRAIN_LOCAL_BAND = (1.0, 1.6)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(code: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=_env(), cwd=ROOT)


def _finish(proc: subprocess.Popen, timeout: int = 600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def worlds():
    """Every subprocess of the module, started together; killed at the
    module's end if a test did not wait for it."""
    procs = {"2x4": _start(SMALL_MESH.format(shape=(2, 4), axes=("data", "model"))),
             "2x2x2": _start(SMALL_MESH.format(shape=(2, 2, 2),
                                               axes=("pod", "data", "model"))),
             "xla": _start(XLA_FLOPS), "local_only": _start(LOCAL_ONLY),
             "repairs": _start(REPAIRS), "mamba": _start(MAMBA_DA_AUTO)}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


SMALL_MESH = """
import dataclasses, json
from repro_torch.configs.registry import ARCHS, ShapeSpec, reduce_for_smoke
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh

D.start_fake_world(8)
cfg = dataclasses.replace(reduce_for_smoke(ARCHS["jamba-1.5-large-398b"]),
                          param_dtype="bfloat16", compute_dtype="bfloat16")
mesh = make_test_mesh({shape}, {axes}, device_type="cpu")
out = {{}}
for name, kind in [("train_4k", "train"), ("prefill_32k", "prefill"),
                   ("decode_32k", "decode")]:
    trace, aux = D.lower_cell(cfg, ShapeSpec(name, 32, 8, kind), mesh,
                              device="cpu")
    out[name] = {{"cost": D._cost_of(trace), "memory": trace.memory,
                 "chips": aux["chips"]}}
print(json.dumps(out))
"""


def test_dryrun_cells_on_small_mesh(worlds):
    for shape in ("2x4", "2x2x2"):
        got = _finish(worlds[shape])
        assert set(got) == {"train_4k", "prefill_32k", "decode_32k"}
        for cell in got.values():
            assert cell["chips"] == 8
            assert cell["cost"]["flops"] > 0 and cell["cost"]["bytes"] > 0
            assert cell["cost"]["coll"] > 0           # a sharded step talks
            mem = cell["memory"]
            assert mem["argument_bytes"] > 0 and mem["peak_bytes"] > 0
            assert mem["temp_bytes"] >= 0


XLA_FLOPS = """
import json
from repro.configs.registry import ARCHS, ShapeSpec, reduce_for_smoke
from repro.launch.dryrun import _cost_of, lower_cell
from repro.launch.mesh import make_test_mesh

cfg = reduce_for_smoke(ARCHS["qwen3-8b"])
mesh = make_test_mesh((1, 1), ("data", "model"))
out = {}
for kind in ("train", "decode"):
    lowered, _ = lower_cell(cfg, ShapeSpec("x", 64, 4, kind), mesh,
                            extra_cfg={"scan_unroll": True})
    out[kind] = _cost_of(lowered.compile())["flops"]
print(json.dumps(out))
"""


def _one_device_flops(cfg, kinds=("train", "decode", "prefill")):
    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.launch import dryrun as D

    return {k: D.lower_cell(cfg, ShapeSpec("x", 64, 4, k), None,
                            device="cpu")[0].counter.flops for k in kinds}


def test_one_device_flops_against_xla_cost_analysis(worlds):
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke

    port = _one_device_flops(reduce_for_smoke(ARCHS["qwen3-8b"]), ("train", "decode"))
    xla = _finish(worlds["xla"])
    for kind, ratio in XLA_RATIO.items():
        assert abs(port[kind] / xla[kind] - ratio) <= XLA_BAND, (kind, port, xla)


LOCAL_ONLY = """
import dataclasses, json
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.configs.registry import ARCHS, ShapeSpec, reduce_for_smoke
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh

D.start_fake_world(8)
cfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]), vocab=96)
mesh = make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
out = {}
for kind in ("train", "decode", "prefill"):
    with CommDebugMode() as comm:
        trace, _ = D.lower_cell(cfg, ShapeSpec("x", 64, 4, kind), mesh,
                                device="cpu", memory=False)
    out[kind] = {"flops": trace.counter.flops,
                 "comm": {str(k).split(".")[-1]: v
                          for k, v in comm.get_comm_counts().items()},
                 "calls": {k.split(".")[-1]: v
                           for k, v in trace.counter.calls.items()
                           if D.rl.collective_kind(k) is not None}}
print(json.dumps(out))
"""


def test_per_chip_flops_count_the_local_ops_only(worlds):
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke

    one = _one_device_flops(dataclasses.replace(
        reduce_for_smoke(ARCHS["qwen3-8b"]), vocab=96))
    got = _finish(worlds["local_only"])
    for kind in ("decode", "prefill"):
        assert got[kind]["flops"] * 8 == one[kind], (kind, got[kind], one[kind])
    ratio = got["train"]["flops"] * 8 / one["train"]
    assert TRAIN_LOCAL_BAND[0] <= ratio <= TRAIN_LOCAL_BAND[1], ratio
    for kind, cell in got.items():
        assert cell["comm"] == cell["calls"] and cell["calls"], (kind, cell)


def test_in_place_ops_count_their_read_and_write():
    """An op that reads and writes its tensor in place moves it twice, as
    the out-of-place op moves its input and its result (the no-grad
    softmax's chain counts what the autograd chain counts); ``copy_`` and
    ``fill_`` only write theirs."""
    from repro_torch.launch.dryrun import OpCounter

    x, y = torch.zeros(64, 32), torch.ones(64, 32)
    mask = y > 0
    n = x.numel() * x.element_size()
    cases = {"sub_": (lambda: x.sub_(y), 3 * n), "sub": (lambda: x - y, 3 * n),
             "exp_": (lambda: x.exp_(), 2 * n), "exp": (lambda: torch.exp(x), 2 * n),
             "where_out": (lambda: torch.where(mask, x, y, out=x),
                           3 * n + mask.numel()),
             "where": (lambda: torch.where(mask, x, y), 3 * n + mask.numel()),
             "copy_": (lambda: x.copy_(y), 2 * n), "fill_": (lambda: x.fill_(0.0), n)}
    for name, (fn, want) in cases.items():
        counter = OpCounter()
        with counter:
            fn()
        assert counter.bytes == want, (name, counter.bytes, want)


def test_da_frozen_decode_counts_the_codes():
    from repro_torch.configs.registry import ARCHS, ShapeSpec, reduce_for_smoke
    from repro_torch.core.engine import PackedWeights
    from repro_torch.launch import dryrun as D

    cfg = reduce_for_smoke(ARCHS["qwen3-8b"])
    trace, _ = D.lower_cell(cfg, ShapeSpec("x", 64, 4, "decode"), None,
                            quant="pallas_bitplane", device="cpu")
    packs = []

    def walk(node):
        if isinstance(node, PackedWeights):
            packs.append(node)
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(trace.args[0])
    codes = sum(p.wq.numel() * p.wq.element_size() for p in packs)
    c = trace.counter
    assert codes > 0 and c.bytes >= codes
    assert c.bytes_by_op["repro_torch.bitplane_vmm"] >= codes
    # q|k|v fused into one call a layer: every pack's product, 2·M·K·N
    products = sum(2 * 4 * p.wq.shape[0] * p.wq.shape[1] for p in packs)
    assert c.flops_by_op["repro_torch.bitplane_vmm"] == products
    assert c.calls["repro_torch.bitplane_vmm"] == len(packs) - cfg.n_layers * 2


REPAIRS = """
import dataclasses, json
from torch.distributed.tensor import DTensor, Shard
from repro_torch.configs.registry import ARCHS, LM_SHAPES
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh

D.start_fake_world(256)
mesh = make_production_mesh(device_type="cpu")
cfg = ARCHS["qwen3-8b"]
out = {}
for shape in LM_SHAPES[:3]:
    trace, aux = D.lower_cell(cfg, shape, mesh, extra_cfg={"n_layers": 2},
                              device="cpu")
    rec = {"flops": trace.counter.flops, "chips": aux["chips"],
           "memory": trace.memory}
    if shape.kind != "train":
        k = trace.args[1]["pos_0"].k
        rec["cache"] = [p.dim if isinstance(p, Shard) else None
                        for p in k.placements]
        rec["cache_local"] = list(k.to_local().shape)
    out[shape.name] = rec
print(json.dumps(out))
"""


def test_production_mesh_repairs_on_a_fake_256_rank_world(worlds):
    got = _finish(worlds["repairs"])
    assert set(got) == {"train_4k", "prefill_32k", "decode_32k"}
    for name, rec in got.items():
        assert rec["chips"] == 256 and rec["flops"] > 0, name
        assert rec["memory"]["alias_bytes"] > 0, name
    # 8 KV heads do not divide the 16-way model axis: the dense caches
    # fall back to their sequence axis there, each rank holding its block
    for name, s in (("decode_32k", (2, 8, 2048, 8, 128)),
                    ("prefill_32k", (2, 2, 2048, 8, 128))):
        assert got[name]["cache"] == [1, 2]
        assert got[name]["cache_local"] == list(s)


def _old_write(k, v, cache, tpos, cfg):
    """The dense-cache write before the sharded branch."""
    rows = torch.arange(k.shape[0], device=k.device)[:, None]
    tp = tpos.long()
    cache.k[rows, tp] = k.to(cache.k.dtype)
    cache.v[rows, tp] = v.to(cache.v.dtype)
    cache.length.add_(k.shape[1])


def _dense_serve(cfg):
    from repro_torch.models.model import forward, init_caches, init_model

    params = init_model(cfg, seed=0, device="cpu")
    caches = init_caches(cfg, 2, 24, device="cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=gen)
    pos = torch.arange(9, dtype=torch.int32)[None].expand(2, 9)
    logits = [forward(params, toks, cfg, pos, caches, update_cache=True)[0]]
    for i in range(3):
        p = torch.full((2, 1), 9 + i, dtype=torch.int32)
        logits.append(forward(params, toks[:, i:i + 1], cfg, p, caches)[0])
    return logits, caches


def test_repairs_leave_a_one_device_forward_equal(monkeypatch):
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke
    from repro_torch.models import attention as A

    cfg = reduce_for_smoke(ARCHS["qwen3-8b"])
    with torch.no_grad():
        new, new_c = _dense_serve(cfg)
        monkeypatch.setattr(A, "_split_heads",
                            lambda y, n, hd, axis: y.reshape(*y.shape[:2], n, hd))
        monkeypatch.setattr(A, "_dense_cache_write", _old_write)
        monkeypatch.setattr(A, "is_fake", lambda t: False)
        old, old_c = _dense_serve(cfg)
    for a, b in zip(new, old):
        assert torch.equal(a, b)
    assert torch.equal(new_c["pos_0"].k, old_c["pos_0"].k)
    assert torch.equal(new_c["pos_0"].length, old_c["pos_0"].length)


def test_warm_dense_prefill_still_raises_on_real_tensors():
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke
    from repro_torch.models.model import forward, init_caches, init_model

    cfg = reduce_for_smoke(ARCHS["qwen3-8b"])
    params = init_model(cfg, seed=0, device="cpu")
    caches = init_caches(cfg, 1, 16, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with torch.no_grad():
        forward(params, toks, cfg, caches=caches, update_cache=True)
        with pytest.raises(ValueError, match="warm dense KVCache"):
            forward(params, toks, cfg, caches=caches, update_cache=True)


MAMBA_DA_AUTO = """
import json, tempfile
from repro_torch.launch.perf import main
with tempfile.TemporaryDirectory() as tmp:
    rec = main(["--arch", "mamba2-780m", "--shape", "decode_32k", "--variant",
                "DA_auto", "--out", tmp, "--device", "cpu"])
print(json.dumps({k: rec.get(k) for k in ("ok", "error", "n_params", "roofline")}))
"""


def test_mamba2_da_auto_record_matches_the_reference_counts(worlds):
    got = _finish(worlds["mamba"])
    with open(os.path.join(ROOT, "artifacts", "perf",
                           "mamba2-780m__decode_32k__pod16x16__DA_auto.json")) as f:
        ref = json.load(f)
    assert got["ok"], got["error"]
    assert got["n_params"] == ref["n_params"] == 857379072
    r, jr = got["roofline"], ref["roofline"]
    assert r["model_flops_global"] == jr["model_flops_global"] == 219489042432.0
    assert r["chips"] == jr["chips"] == 256
    assert set(r) == set(jr)


def test_cli_refuses_cuda_without_a_card(monkeypatch):
    from repro_torch.launch import dryrun, perf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k"])
    with pytest.raises(RuntimeError, match="device 'cuda'"):
        perf.main(["--arch", "qwen3-8b", "--shape", "decode_32k",
                   "--variant", "baseline"])


def test_perf_variants_equal_the_reference():
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.perf import VARIANTS

    src = open(os.path.join(ROOT, "src", "repro", "launch", "perf.py")).read()
    node = next(n for n in ast.parse(src).body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "VARIANTS")
    ref = {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value)
                                 for kw in v.keywords}
           for k, v in zip(node.value.keys, node.value.values)}
    assert VARIANTS == ref
    cfg = ARCHS["qwen3-8b"]
    for v in VARIANTS.values():   # each lever a field, or inert in the port
        got = cfg.with_levers(**v["extra"])
        for k, x in v["extra"].items():
            assert getattr(got, k, x) == x
    assert not hasattr(cfg.with_levers(prefill_last_only=True), "prefill_last_only")
    with pytest.raises(TypeError):
        cfg.with_levers(not_a_lever=1)
