"""PyTorch port vs the JAX reference: a rank's share of the work on a mesh.

The dry-run counts one rank's FLOPs, bytes and collectives
(``launch/dryrun.py``); the reference's dry-run reads XLA's per-chip cost
and memory analyses.  Here both run the same reduced cells on a (2, 4)
world (data × model), at full depth (the reference unrolled, so XLA counts
every layer), and the port's per-chip counts must sit within the bands of
the reference's: FLOPs within ``FLOPS_BAND`` of the smaller of the
reference chip's count and its one-device count ÷ 8 (GSPMD itself runs
part of the uneven-head cells replicated), collective bytes at most
``COLL_MAX`` times.  The cells are the production mesh's faults, reduced:

* a dense config whose heads divide neither axis (10 q over 5 KV heads on
  a 4-way model axis, phi3's 40 over 10 on 16): train, prefill, decode;
* q heads that divide the model axis over KV heads that do not (8 over 2
  on 4, qwen3-8b's 32 over 8 on 16): train;
* ``reduce_for_smoke(moonshot-v1-16b-a3b)`` (16 padded experts, top-2):
  train, two token groups of 1024;
* ``reduce_for_smoke(mamba2-780m)``: train, and the ``int8`` freeze's
  decode (``DA_int8``);
* the decode of ``reduce_for_smoke`` of moonshot-v1-16b-a3b (through
  the one-hot dispatch and the sorted one) and of jamba-1.5-large-398b:
  one token group of 8, which cannot shard on the batch axes, its
  experts still split over the model axis;
* qwen3-8b's prefill, whose peak bytes (arguments and temporaries) must
  also stay within ``PEAK_MAX`` of the reference chip's, as for every
  cell in ``PEAK_CELLS``: the softmax holds one float32 score buffer.
  (Training's cells peak above it: each norm's float64 copies and the
  softmax's saved buffers, which XLA fuses.)

One JAX subprocess with 8 host devices and one port subprocess on a fake
8-rank world run together.  Besides, on gloo ranks: the uneven-head
config frozen by ``bitplane`` (an exact datapath, so only the attention
core's split could move a value) gives EQUAL logits on a (1, 4) mesh and
on one device, its queries split across the model axis; ``reduce_for_smoke
(mamba2-780m)``'s prefill and decode over dense caches on (1, 4) (the
conv window and the projection's columns exchanged between layouts)
within ``LOGIT_TOL`` of one device; ``reduce_for_smoke(moonshot-v1-16b-a3b)``
at one token group on (2, 2), each rank routing to its own experts
through either dispatch: its prefill and decode logits within
``LOGIT_TOL``, and its train step's loss and grad norm within the family
train steps' bound, of one device;
and the LUT-serving model frozen by ``int8`` serves EQUAL tokens
tensor-parallel on (1, 2).  The CPU-typed
fake world counts an all-to-all as the card's mesh issues it; a
checkpointed block recomputed on the backward's own thread (CUDA's) runs
under the forward's mesh rules; the ``auto`` attention read's shape
buckets equal the reference's; and ``tools/dryrun_compare.py`` reads JSON
only.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's per-chip FLOPs over the reference's per-chip work, and its
#: collective bytes over the reference's at most
FLOPS_BAND, COLL_MAX = (0.8, 1.3), 1.5
LOGIT_TOL = 1e-4
#: the port's peak bytes over the reference chip's at most, in these cells
PEAK_MAX, PEAK_CELLS = 1.05, ("dense:prefill", "moe:decode", "uneven:decode",
                                "hybrid:decode", "moe_sorted:decode")
#: loss and grad norm of a sharded train step against one device's,
#: relative above 1 (``tests/test_torch_distributed.py``'s family steps)
LOSS_TOL = 1e-3
#: cell → (arch, config changes on its reduced form, seq, kind, quant);
#: batch 8 everywhere
CELLS = {
    "uneven:train": ("qwen3-8b", {"n_heads": 10, "n_kv_heads": 5}, 64, "train", None),
    "uneven:prefill": ("qwen3-8b", {"n_heads": 10, "n_kv_heads": 5}, 64, "prefill", None),
    "uneven:decode": ("qwen3-8b", {"n_heads": 10, "n_kv_heads": 5}, 64, "decode", None),
    "kv_partial:train": ("qwen3-8b", {"n_heads": 8, "n_kv_heads": 2}, 64, "train", None),
    "moe:train": ("moonshot-v1-16b-a3b", {}, 256, "train", None),
    "ssm:train": ("mamba2-780m", {}, 64, "train", None),
    "ssm_int8:decode": ("mamba2-780m", {}, 64, "decode", "int8"),
    "moe:decode": ("moonshot-v1-16b-a3b", {}, 64, "decode", None),
    "hybrid:decode": ("jamba-1.5-large-398b", {}, 64, "decode", None),
    "dense:prefill": ("qwen3-8b", {}, 64, "prefill", None),
    "moe_sorted:decode": ("moonshot-v1-16b-a3b", {"moe_impl": "sorted"}, 64,
                          "decode", None),
}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


JAX_COSTS = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, sys
from repro.configs.registry import ARCHS, ShapeSpec, reduce_for_smoke
from repro.launch.dryrun import _cost_of, lower_cell
from repro.launch.mesh import make_test_mesh

mesh, one = (make_test_mesh(s, ("data", "model")) for s in ((2, 4), (1, 1)))
out = {}
for name, (arch, changes, seq, kind, quant) in json.loads(sys.argv[1]).items():
    cfg = dataclasses.replace(reduce_for_smoke(ARCHS[arch]), **changes)
    shape = ShapeSpec(name, seq, 8, kind)
    compiled = lower_cell(cfg, shape, mesh, extra_cfg={"scan_unroll": True},
                          quant=quant)[0].compile()
    mem = compiled.memory_analysis()
    alone = lower_cell(cfg, shape, one, extra_cfg={"scan_unroll": True},
                       quant=quant)[0].compile()
    out[name] = dict(_cost_of(compiled), peak=mem.argument_size_in_bytes
                     + mem.temp_size_in_bytes, one_flops=_cost_of(alone)["flops"])
print(json.dumps(out))
"""

PORT_COSTS = """
import dataclasses, json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.configs.registry import ARCHS, ShapeSpec, reduce_for_smoke
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_test_mesh

D.start_fake_world(8)
mesh = make_test_mesh((2, 4), ("data", "model"), device_type="cpu")
out = {}
for name, (arch, changes, seq, kind, quant) in json.loads(sys.argv[1]).items():
    cfg = dataclasses.replace(reduce_for_smoke(ARCHS[arch]), **changes)
    trace, _ = D.lower_cell(cfg, ShapeSpec(name, seq, 8, kind), mesh,
                            quant=quant, device="cpu")
    out[name] = dict(D._cost_of(trace), peak=trace.memory["peak_bytes"])
# a shard-to-shard reshard on the CPU-typed mesh: the card's all-to-all
with FakeTensorMode():
    x = distribute_tensor(torch.empty(8, 16, 32), mesh, [Shard(0), Shard(1)],
                          src_data_rank=None)
    counter = D.OpCounter()
    with counter:
        x.redistribute(mesh, [Shard(0), Shard(2)])
out["reshard"] = D.rl.collective_bytes(counter.collectives)

# the train step's backward on another thread, as CUDA's autograd engine
# runs it on its device thread: the dispatch and function modes and the
# implicit replication carried there, Python's thread-locals not
import contextlib, threading
from torch.distributed.tensor.experimental import implicit_replication
from torch.overrides import _get_current_function_mode_stack
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
grad = torch.autograd.grad

def grad_on_a_thread(*args, **kwargs):
    modes = _get_current_function_mode_stack() + _get_current_dispatch_mode_stack()
    got = {}

    def run():
        try:
            with contextlib.ExitStack() as stack:
                for mode in modes:
                    stack.enter_context(mode)
                stack.enter_context(implicit_replication())
                got["grads"] = grad(*args, **kwargs)
        except Exception as e:
            got["error"] = f"{type(e).__name__}: {e}"[:300]

    thread = threading.Thread(target=run)
    thread.start()
    thread.join()
    if "error" in got:
        raise RuntimeError(got["error"])
    return got["grads"]

torch.autograd.grad = grad_on_a_thread
out["remat_thread"] = {}
for name in ("uneven:train", "moe:train"):
    arch, changes, seq, kind, quant = json.loads(sys.argv[1])[name]
    cfg = dataclasses.replace(reduce_for_smoke(ARCHS[arch]), remat=True, **changes)
    try:
        D.lower_cell(cfg, ShapeSpec(name, seq, 8, kind), mesh, device="cpu",
                     memory=False)
        out["remat_thread"][name] = "ok"
    except Exception as e:
        out["remat_thread"][name] = f"{type(e).__name__}: {e}"[:300]
torch.autograd.grad = grad
print(json.dumps(out))
"""


def _start(code: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             json.dumps(CELLS)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)


def _finish(proc: subprocess.Popen, timeout: int = 600) -> dict:
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def costs():
    """Both sides' per-chip costs of every cell, from two subprocesses
    started together."""
    procs = {"ref": _start(JAX_COSTS), "port": _start(PORT_COSTS)}
    try:
        yield {k: _finish(p) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_rank_work_matches_the_reference_chip(costs, cell):
    """FLOPs within ``FLOPS_BAND`` of the reference's per-chip work, taken
    as the smaller of its chip's count and its one-device count ÷ 8:
    where GSPMD runs part of a cell replicated (the uneven heads: 1.4× its
    share a chip at these widths), a rank is held to the share, not to the
    replicated work."""
    ref, port = costs["ref"][cell], costs["port"][cell]
    work = min(ref["flops"], ref["one_flops"] / 8)
    assert FLOPS_BAND[0] <= port["flops"] / work <= FLOPS_BAND[1], \
        (cell, port["flops"] / work, port["flops"] / ref["flops"])
    assert ref["coll"] > 0 and port["coll"] <= COLL_MAX * ref["coll"], \
        (cell, port["coll"] / ref["coll"], port["coll_by_kind"], ref["coll_by_kind"])


@pytest.mark.parametrize("cell", PEAK_CELLS)
def test_rank_peak_matches_the_reference_chip(costs, cell):
    """Arguments and temporaries at their peak within ``PEAK_MAX`` of the
    reference chip's: a prefill's softmax keeps one float32 copy of the
    scores where no gradient is recorded, as XLA's fusion does."""
    ref, port = costs["ref"][cell], costs["port"][cell]
    assert port["peak"] <= PEAK_MAX * ref["peak"], (cell, port["peak"] / ref["peak"])


def test_remat_recompute_runs_under_the_mesh_rules(costs):
    """A checkpointed block's recompute runs in the backward, which CUDA
    runs on its device thread: it must run under the forward's mesh rules
    (``models/model.py: _remat_context``), or the uneven heads' reshape
    meets a split dim and the MoE routing the global batch."""
    assert costs["port"]["remat_thread"] == {"uneven:train": "ok",
                                             "moe:train": "ok"}


def test_cpu_mesh_counts_the_all_to_all(costs):
    """DTensor's gloo fallback (all-gather, then chunk) would read 4× the
    bytes as all-gather; the fake world issues the all-to-all instead."""
    assert costs["port"]["reshard"] == {"all-to-all": 8 // 2 * 16 * 32 // 4 * 4}


# ---------------------------------------------------------------------------
# gloo ranks (module level: the spawned ranks import them)
# ---------------------------------------------------------------------------
def _uneven_forward():
    """The uneven-head config frozen by ``bitplane``: logits on one device
    and on a (1, 4) mesh, and the number of attention cores that split
    their queries."""
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke
    from repro_torch.core.da import DAConfig
    from repro_torch.core.freeze import freeze_model
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import attention as A
    from repro_torch.models.model import forward, init_model

    cfg = dataclasses.replace(reduce_for_smoke(ARCHS["qwen3-8b"]),
                              **CELLS["uneven:train"][1])
    params = freeze_model(init_model(cfg, seed=0, device="cpu"),
                          DAConfig(x_signed=True), mode="bitplane",
                          device="cpu").params
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (4, 16)))
    calls = []
    split = A._query_parallel
    A._query_parallel = lambda *a, **kw: calls.append(1) or split(*a, **kw)
    try:
        with torch.no_grad():
            one, _ = forward(params, toks, cfg)
            mesh = make_test_mesh((1, 4), ("data", "model"))
            with shd.use_mesh_rules(mesh):
                got, _ = forward(shd.shard_frozen_params(params), toks, cfg)
    finally:
        A._query_parallel = split
    return {"one": one.numpy(), "mesh": shd.full(got).numpy(), "splits": len(calls)}


def _mamba_serve():
    """``reduce_for_smoke(mamba2-780m)``: a prefill and three decode steps
    over dense caches on one device and on a (1, 4) mesh."""
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_caches, init_model
    from repro_torch.serve.engine import make_prefill_step, make_serve_step

    cfg = dataclasses.replace(reduce_for_smoke(ARCHS["mamba2-780m"]), vocab=96)
    params = init_model(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 96, (2, 13)))
    prefill, decode = make_prefill_step(cfg), make_serve_step(cfg)

    def run(params, caches, place):
        pos = torch.arange(10, dtype=torch.int32)[None].expand(2, 10)
        out, caches = prefill(params, caches, place(toks[:, :10]), place(pos))
        logits = [shd.full(out)]
        for i in range(10, 13):
            p = torch.full((2, 1), i, dtype=torch.int32)
            out, caches = decode(params, caches, place(toks[:, i:i + 1]), place(p))
            logits.append(shd.full(out))
        return torch.stack(logits), caches

    with torch.no_grad():
        one, one_c = run(params, init_caches(cfg, 2, 16, device="cpu"), lambda t: t)
        mesh = make_test_mesh((1, 4), ("data", "model"))
        with shd.use_mesh_rules(mesh):
            caches = init_caches(cfg, 2, 16, device="cpu")
            caches = SP.place_caches(caches, SP.cache_pspecs(caches), mesh)
            rows = lambda t: shd.distribute(t, shd.NamedSharding(  # noqa: E731
                mesh, shd.pspec(("batch", None), t.shape)))
            got, got_c = run(SP.place(params, SP.tree_pspecs(params), mesh),
                             caches, rows)
    c = got_c["pos_0"]
    return {"logits": got.numpy(), "logits_1": one.numpy(),
            "conv": c.conv.full_tensor().numpy(),
            "conv_1": one_c["pos_0"].conv.numpy(),
            "ssm": c.ssm.full_tensor().numpy(), "ssm_1": one_c["pos_0"].ssm.numpy()}


def _moe_one_group():
    """``reduce_for_smoke(moonshot-v1-16b-a3b)`` at one token group (8 rows
    of at most 16 tokens, groups of 1024) on a (2, 2) mesh and on one
    device: a prefill and three decode steps over dense caches, and a
    train step, through the one-hot dispatch and again through the sorted
    one (``moe_impl="sorted"``); and the expert blocks each rank's
    dispatches routed to."""
    from repro_torch.configs.registry import ARCHS, reduce_for_smoke
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe as M
    from repro_torch.models.model import init_caches, init_model
    from repro_torch.serve.engine import make_prefill_step, make_serve_step
    from repro_torch.train.trainer import (TrainConfig, make_train_step,
                                           state_from_params)
    from repro_torch.tree import tree_map

    cfg = reduce_for_smoke(ARCHS["moonshot-v1-16b-a3b"])
    params = init_model(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(5).integers(0, cfg.vocab, (8, 13)))
    mesh = make_test_mesh((2, 2), ("data", "model"))

    def run(cfg, params, caches, place):
        prefill, decode = make_prefill_step(cfg), make_serve_step(cfg)
        pos = torch.arange(10, dtype=torch.int32)[None].expand(8, 10)
        out, caches = prefill(params, caches, place(toks[:, :10]), place(pos))
        logits = [shd.full(out)]
        for i in range(10, 13):
            p = torch.full((8, 1), i, dtype=torch.int32)
            out, caches = decode(params, caches, place(toks[:, i:i + 1]), place(p))
            logits.append(shd.full(out))
        return torch.stack(logits)

    blocks = {"one": [], "mesh": []}
    dispatch = {n: getattr(M, n) for n in ("_topk_dispatch", "_sorted_dispatch")}

    def recorded(where):
        for n, fn in dispatch.items():
            setattr(M, n, lambda *a, fn=fn, n=n, **kw: (
                blocks[where].append((n, kw.get("experts"), kw.get("slots")))
                or fn(*a, **kw)))

    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0)
    batch = {k: torch.as_tensor(v) for k, v in batch_at(dc, 0).items()}
    metrics = lambda sh, one: {k: (float(shd.full(sh[k])), float(one[k]))  # noqa: E731
                               for k in ("loss", "grad_norm")}
    out = {}
    try:
        for impl in ("dense", "sorted"):
            icfg = dataclasses.replace(cfg, moe_impl=impl)
            step = make_train_step(icfg, TrainConfig())
            recorded("one")
            with torch.no_grad():
                one = run(icfg, params, init_caches(icfg, 8, 16, device="cpu"),
                          lambda t: t)
            _, m_one = step(state_from_params(tree_map(torch.clone, params)), batch)
            recorded("mesh")
            with shd.use_mesh_rules(mesh):
                placed = SP.place(params, SP.tree_pspecs(params), mesh)
                caches = init_caches(icfg, 8, 16, device="cpu")
                caches = SP.place_caches(caches, SP.cache_pspecs(caches), mesh)
                rows = lambda t: shd.distribute(t, shd.NamedSharding(  # noqa: E731
                    mesh, shd.pspec(("batch", None), t.shape)))
                with torch.no_grad():
                    got = run(icfg, placed, caches, rows)
                _, m_sh = step(state_from_params(placed),
                               SP.place(batch, SP.batch_pspecs(batch), mesh))
            out[impl] = {"logits": got.numpy(), "logits_1": one.numpy(),
                         "train": metrics(m_sh, m_one)}
    finally:
        for n, fn in dispatch.items():
            setattr(M, n, fn)
    # groups of 32: four groups, sharded on the data axis
    gcfg = dataclasses.replace(cfg, moe_group_size=32)
    gstep = make_train_step(gcfg, TrainConfig())
    _, g_one = gstep(state_from_params(tree_map(torch.clone, params)), batch)
    with shd.use_mesh_rules(mesh):
        _, g_sh = gstep(state_from_params(SP.place(params, SP.tree_pspecs(params),
                                                   mesh)),
                        SP.place(batch, SP.batch_pspecs(batch), mesh))
    return {**out, "blocks_1": blocks["one"], "blocks": blocks["mesh"],
            "train_groups": metrics(g_sh, g_one)}


def _four_ranks():
    return {"uneven": _uneven_forward(), "mamba": _mamba_serve(),
            "moe": _moe_one_group()}


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    torch.set_num_threads(1)
    out = spawn(_four_ranks, 4, init_dir=str(tmp_path_factory.mktemp("store")))
    assert all(o is not None for o in out)
    return out


def test_uneven_heads_sharded_forward_is_equal(four):
    for rank in four:
        got = rank["uneven"]
        assert got["splits"] == 2                 # both layers split queries
        np.testing.assert_array_equal(got["mesh"], got["one"])


def test_mamba2_serve_on_a_mesh_matches_one_device(four):
    for rank in four:
        got = rank["mamba"]
        np.testing.assert_allclose(got["logits"], got["logits_1"], atol=LOGIT_TOL)
        np.testing.assert_allclose(got["conv"], got["conv_1"], atol=1e-5)
        np.testing.assert_allclose(got["ssm"], got["ssm_1"], atol=1e-5)


def test_moe_one_group_on_a_mesh_matches_one_device(four):
    """One token group cannot shard on the batch axes: each rank still
    routes it to its own 8 of the 16 (padded) experts, and fills its half
    of their capacity slots (the data axis), in the forward and in the
    train step, through either dispatch (one-hot, sorted); the Partial
    sums of the combine and of the tokens' and gates' gradients give one
    device's results.  With four groups on the data axis, the experts'
    weight gradients are Partial sums over it."""
    for rank in four:
        got = rank["moe"]
        assert {(e, s) for _, e, s in got["blocks_1"]} == {(None, None)}
        for name in ("_topk_dispatch", "_sorted_dispatch"):
            mine = [b[1:] for b in got["blocks"] if b[0] == name]
            assert len(mine) == 10                       # 4 forwards, 1 step, 2 layers
            for experts, (first, n) in mine:
                assert experts[1] == 8 and first in (0, n)
        metrics = {"G=4 " + k: v for k, v in got["train_groups"].items()}
        for impl in ("dense", "sorted"):
            np.testing.assert_allclose(got[impl]["logits"], got[impl]["logits_1"],
                                       atol=LOGIT_TOL, err_msg=impl)
            metrics.update({f"{impl} G=1 {k}": v
                            for k, v in got[impl]["train"].items()})
        for key, (sharded, one) in metrics.items():
            assert abs(sharded - one) < LOSS_TOL * max(1.0, abs(one)), \
                (key, sharded, one)


def _int8_serve():
    from repro_torch.core.da import DAConfig
    from repro_torch.core.freeze import freeze_model
    from repro_torch.examples.serve_da import build_cfg
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import init_model
    from repro_torch.serve.scheduler import PagedScheduler, Request

    cfg = build_cfg()
    art = freeze_model(init_model(cfg, seed=0, device="cpu"),
                       DAConfig(x_signed=True), mode="int8", device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 9, 12, 7)]

    def serve(params):
        s = PagedScheduler(cfg, params, batch_size=2, max_len=64, device="cpu")
        for i, p in enumerate(prompts):
            s.submit(Request(uid=i, prompt=p, max_new_tokens=8))
        return {u: list(r.generated) for u, r in s.run().items()}

    plain = serve(art.params)
    mesh = make_test_mesh((1, 2), ("data", "model"))
    with shd.use_mesh_rules(mesh):
        sharded = shd.shard_frozen_params(art.params)
        tp = serve(sharded)
    wq = sharded["blocks"][0]["mixer"]["wq"].wq
    return {"plain": plain, "tp": tp, "local": tuple(wq.to_local().shape),
            "global": tuple(wq.shape)}


def test_int8_tensor_parallel_tokens_equal(tmp_path):
    from repro_torch.launch.mesh import spawn

    torch.set_num_threads(1)
    out = spawn(_int8_serve, 2, init_dir=str(tmp_path))
    for rank in out:
        assert rank["tp"] == rank["plain"]
        assert all(len(t) == 8 for t in rank["tp"].values())
        assert rank["local"][1] * 2 == rank["global"][1]     # N split in two
    assert out[0]["tp"] == out[1]["tp"]


# ---------------------------------------------------------------------------
# the attention read's auto dispatch; the comparison tool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 1, 16), (4, 8, 256), (2, 9, 257),
                                   (8, 1, 2048), (1, 128, 2049), (3, 4, 65536)])
def test_attention_buckets_equal_the_reference(shape):
    from repro.core import engine as jeng
    from repro_torch.core import engine as teng

    assert teng.attn_shape_bucket(*shape) == jeng.attn_shape_bucket(*shape)


def test_auto_attention_reads_the_cost_table():
    from repro_torch.core import engine as teng

    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    shape = dict(batch=4, t=1, kv_len=4096)                    # attn:dec:l
    try:
        teng.set_cost_table({"attn:dec:l": {"gather": 5.0, "fused": 9.0},
                             "attn:pre:s": {"fused": 1.0, "gone": 0.1}})
        assert teng.select_attn_backend("auto", cuda, **shape) == "gather"
        assert teng.select_attn_backend("auto", cpu, batch=2, t=64,
                                        kv_len=128) == "fused"
        # no entry for the bucket, or no shape: the platform's choice
        assert teng.select_attn_backend(None, cpu, batch=2, t=64,
                                        kv_len=4096) == "gather"
        assert teng.select_attn_backend("auto", cuda) == "fused"
        assert teng.select_attn_backend("fused", cpu, **shape) == "fused"
    finally:
        teng.set_cost_table(None)


def _record(cell, flops, coll, kinds, args, temp, probes=None):
    return {"cell": cell, "ok": True, "memory": {"argument_bytes": args,
                                                 "temp_bytes": temp},
            "raw_full_cost": {"coll_by_kind": kinds}, "probes": probes,
            "roofline": {"flops_per_chip": flops, "coll_bytes_per_chip": coll}}


def test_dryrun_compare_reads_records(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import dryrun_compare as C
    finally:
        sys.path.pop(0)
    ref, port = tmp_path / "ref", tmp_path / "port"
    ref.mkdir()
    port.mkdir()
    # the reference's kinds extrapolate from its probes: totals 10, 16 at
    # 2 and 3 periods, 40 at full depth (factor 5)
    probes = {"probe_1": {"coll": 10, "coll_by_kind": {"all-reduce": 10}},
              "probe_2": {"coll": 16, "coll_by_kind": {"all-reduce": 12,
                                                       "all-gather": 4}}}
    for d, rec in ((ref, _record("a", 100.0, 40, {}, 5, 15, probes)),
                   (port, _record("a", 120.0, 30, {"all-reduce": 30}, 4, 6)),
                   (ref, {"cell": "b", "ok": False, "error": "boom"}),
                   (port, _record("b", 1.0, 1, {}, 1, 1)),
                   (port, _record("c", 1.0, 1, {}, 1, 1))):
        (d / f"{rec['cell']}.json").write_text(json.dumps(rec))
    rows = {r["cell"]: r for r in C.compare(str(ref), str(port))}
    a = rows["a"]
    assert a["flops"] == pytest.approx(1.2) and a["coll"] == pytest.approx(0.75)
    assert a["peak"] == pytest.approx(0.5)
    assert a["kinds"] == {"all-gather": (0, 20.0), "all-reduce": (30, 20.0)}
    assert rows["b"]["status"] == "reference failed" and rows["b"]["error"] == "boom"
    assert rows["c"]["status"] == "missing in reference"
    src = open(os.path.join(ROOT, "tools", "dryrun_compare.py")).read()
    imported = {(n.module or "") if isinstance(n, ast.ImportFrom) else a.name
                for n in ast.walk(ast.parse(src))
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in (n.names if isinstance(n, ast.Import) else [n])}
    assert not any(m.split(".")[0] in ("repro", "repro_torch", "jax")
                   for m in imported), imported
