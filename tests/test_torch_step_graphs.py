"""The paged decode step replayed in pieces from CUDA graphs
(``serve/step_graphs.py``).

On the CPU: where the scheduler may record (CUDA, a dense stack, params
not on a mesh), that a CPU warmup records nothing and serves the same
tokens, the static inputs' views and their packing, and the splitting of
a step at its kernel entries (with a stand-in for the graph, so the plain
work runs as it is queued): the eager step's logits, one call per entry.
The ``gpu``-marked tests skip without a card; there a replay's logits and
K/V pages are EQUAL to the eager step's at every decode width, of a small
model and of one at minitron-8b's widths; the records own none of the
pool, the recording's peak is the eager warmup's but for the logits
buffer and one entry's output, and a replayed call allocates at most what
the eager one does; warmed-up and un-warmed serves emit the eager serve's
tokens and kernel counts.  The file imports only torch, numpy and the
port:

    PYTHONPATH=src python -m pytest -q tests/test_torch_step_graphs.py
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import get, reduce_for_smoke
from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda
from repro_torch.kernels.ops import NAMESPACE
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.models.model import init_model
from repro_torch.serve.kvcache import GARBAGE_PAGE
from repro_torch.serve.scheduler import PagedScheduler, Request, width_buckets
from repro_torch.serve.step_graphs import (Splitter, StepGraphs, _Call,
                                           graphs_apply, unowned)
from repro_torch.spec.decode import mk_positions

PS = 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per worker process (restored after the module)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompts(vocab: int, n: int = 5, seed: int = 3):
    rng = np.random.default_rng(seed)
    return {u: rng.integers(0, vocab, 3 + 2 * u).astype(np.int32)
            for u in range(n)}


def _serve(sched, prompts, new: int = 5):
    for u, p in prompts.items():
        sched.submit(Request(uid=u, prompt=p, max_new_tokens=new))
    done = sched.run()
    return {u: list(done[u].generated) for u in sorted(done)}


# -- the gate ------------------------------------------------------------------

@pytest.mark.parametrize("arch,device,want", [
    ("qwen3-8b", "cuda", True), ("minitron-8b", "cuda", True),
    ("qwen2-vl-72b", "cuda", True), ("qwen3-8b", "cpu", False),
    ("qwen2-moe-a2.7b", "cuda", False), ("mamba2-780m", "cuda", False),
    ("jamba-1.5-large-398b", "cuda", False)])
def test_graphs_apply_to_dense_stacks_on_cuda(arch, device, want):
    """Dense stacks on CUDA replay; MoE routing, Mamba-2 state and the CPU
    stay eager.  Only the device's type is read, so no card is needed."""
    params = {"w": torch.zeros(2, 2)}
    assert graphs_apply(get(arch), params, torch.device(device)) is want


def test_params_on_a_mesh_stay_eager(tmp_path):
    """Params placed on a mesh (DTensors) are never captured: their
    collectives may stage through host memory."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import make_test_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh((1,), ("model",))
        params = {"blocks": [{"w": DTensor.from_local(torch.zeros(4, 3), mesh,
                                                      [Replicate()])}]}
        cuda = torch.device("cuda")
        assert not graphs_apply(get("qwen3-8b"), params, cuda)
        assert graphs_apply(get("qwen3-8b"), {"blocks": [{"w": torch.zeros(4, 3)}]},
                            cuda)
    finally:
        dist.destroy_process_group()


# -- the CPU path --------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_model():
    cfg = reduce_for_smoke(get("qwen3-8b"))
    return cfg, init_model(cfg, seed=0, device="cpu")


def test_cpu_warmup_captures_nothing_and_serves_the_same_tokens(cpu_model):
    cfg, params = cpu_model
    kw = dict(batch_size=3, max_len=40, page_size=PS, prefill_chunk=8,
              device="cpu")
    cold = PagedScheduler(cfg, params, **kw)
    warm = PagedScheduler(cfg, params, **kw)
    assert warm.warmup() > 0
    prompts = _prompts(cfg.vocab)
    assert _serve(warm, prompts) == _serve(cold, prompts)
    for s in (cold, warm):
        assert (s._graphs, s.graph_captures, s.graph_replays) == (None, 0, 0)


def test_static_inputs_are_contiguous_views_of_each_width(cpu_model):
    """One flat buffer per input; each width reads a contiguous prefix of
    it, shaped ``[w, 1]`` / ``[w, W]`` / ``[w]``, and the scheduler's pack
    fills it with what the eager pack hands the step."""
    cfg, params = cpu_model
    b = 12
    sched = PagedScheduler(cfg, params, batch_size=b, max_len=40, page_size=PS,
                           device="cpu")
    graphs = StepGraphs(sched._step, cfg, b, sched.W, sched.device)
    flat = (graphs._tokens, graphs._positions, graphs._table, graphs._last_idx)
    for w in width_buckets(b):
        views = graphs.inputs(w)
        assert [tuple(v.shape) for v in views] == [(w, 1), (w, 1), (w, sched.W), (w,)]
        assert all(v.is_contiguous() and v.dtype == torch.int32 for v in views)
        assert all(v.data_ptr() == f.data_ptr() for v, f in zip(views, flat))
    # two lanes decoding at width 3: a pad row, real pages, the garbage page
    sched.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32)))
    sched.submit(Request(uid=1, prompt=np.arange(11, dtype=np.int32)))
    sched._admit()
    rows = [(r, i, l) for r, (i, l) in enumerate(
        (i, l) for i, l in enumerate(sched.lanes) if l is not None)]
    for _, _, lane in rows:
        assert sched._ensure_pages(lane, lane.remaining) == lane.remaining
    toks = {i: [7 + i] for _, i, _ in rows}
    poss = {i: [4 + 6 * i] for _, i, _ in rows}
    eager = sched._pack_rows(rows, toks, poss, 3, 1)
    into = graphs.inputs(3)
    assert sched._pack_rows(rows, toks, poss, 3, 1, into=into) is into
    for e, g in zip(eager, graphs.inputs(3)):
        assert torch.equal(e, g)
    assert int(into[2][2, 0]) == GARBAGE_PAGE and int(into[2][0, 0]) != GARBAGE_PAGE


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph`` on the CPU: nothing is
    captured, so the plain work runs as it is queued, and a replay does
    nothing."""

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


class _Ops(TorchDispatchMode):
    """The ``repro_torch::`` ops a step calls, in their order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == NAMESPACE:
            self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _cpu_step(cfg, params, sched, w, mode=None):
    rng = np.random.default_rng(w)
    table = np.full((w, sched.W), GARBAGE_PAGE, np.int32)
    table[:, :2] = np.arange(1, 2 * w + 1).reshape(w, 2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (w, 1)).astype(np.int32))
    positions = torch.from_numpy(rng.integers(0, 2 * PS, (w, 1)).astype(np.int32))
    with torch.inference_mode(), (mode or torch.inference_mode()):
        logits, _ = sched._step(params, sched.caches, tokens,
                                mk_positions(cfg, positions),
                                torch.from_numpy(table), torch.zeros(w, dtype=torch.int32))
        return logits.clone()


@pytest.mark.parametrize("da_mode,paged_attn", [("float", None),
                                                 ("pallas_bitplane", "fused")])
def test_a_step_splits_at_each_kernel_entry(cpu_model, da_mode, paged_attn):
    """Under the splitter a step is graphs and kernel entries in turn: one
    call per ``repro_torch::`` op the eager step makes, in its order, each
    between two graphs, its output in a slot the step reads on, so the
    step's logits are the eager step's; each call's slot holds what its op
    computes from its operands, and a call's replay writes that there
    again."""
    from repro_torch.core.freeze import freeze_model_da

    cfg, params = cpu_model
    if da_mode != "float":
        params = freeze_model_da(params, mode=da_mode, device="cpu")
    sched = PagedScheduler(cfg, params, batch_size=4, max_len=40, page_size=PS,
                           paged_attn=paged_attn, device="cpu")
    eager_ops = _Ops()
    eager = _cpu_step(cfg, params, sched, 3, eager_ops)
    splitter = Splitter(None, new_graph=_Graph)
    split = _cpu_step(cfg, params, sched, 3, splitter)
    with torch.inference_mode():
        splitter.close()
    assert torch.equal(split, eager)
    calls = [s for s in splitter.steps if isinstance(s, _Call)]
    assert [c.op for c in calls] == eager_ops.ops
    if da_mode == "float":
        assert not calls      # no kernel entry: one graph holds the step
    else:   # the DA linears and the LM head, and each layer's attention read
        assert len(calls) > 2 * cfg.n_layers + 1
    kinds = [isinstance(s, _Call) for s in splitter.steps]
    assert kinds == [bool(i % 2) for i in range(2 * len(calls) + 1)]
    with torch.inference_mode():
        for c in calls:
            out = c.op(*c.args, **c.kwargs)
            assert out.shape == c.out.shape and out.dtype == c.out.dtype
            assert torch.equal(out, c.out)
            c.out.zero_()
            c.replay()
            assert torch.equal(out, c.out)


def test_unowned_leaves_all_but_cuda_tensors_as_they_are():
    x = torch.arange(6)
    assert unowned(x) is x and unowned(3) == 3 and unowned(None) is None


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


_FROZEN = {}


def _frozen(model: str):
    """A small dense model (head width 64, which the attention kernel is
    built for) in float32 or bfloat16, or minitron-8b at its widths on two
    layers, frozen for the bit-plane kernel, on the card."""
    if model not in _FROZEN:
        from repro_torch.core.freeze import freeze_model_da

        if model == "minitron-8b":
            cfg = dataclasses.replace(get("minitron-8b"), n_layers=2,
                                      paged_attn="fused")
        else:
            cfg = dataclasses.replace(get("qwen3-8b"), name="qwen3-20m",
                                      n_layers=4, d_model=256, n_heads=4,
                                      n_kv_heads=2, head_dim=64, d_ff=768,
                                      vocab=8000, param_dtype=model,
                                      compute_dtype=model, paged_attn="fused")
        _FROZEN[model] = cfg, freeze_model_da(init_model(cfg, seed=0),
                                              mode="pallas_bitplane")
    return _FROZEN[model]


def _pools(sched):
    from repro_torch.serve.kvcache import _leaves

    return list(_leaves(sched.caches))


@pytest.mark.gpu
@pytest.mark.parametrize("model,b", [("float32", 8), ("bfloat16", 8),
                                     ("minitron-8b", 128)])
def test_replay_equals_the_eager_step_at_every_width(card, model, b):
    """At each decode width, over a pool of random pages: the replay's
    float32 logits and every K/V pool after it are EQUAL to the eager
    step's from the same pool and inputs."""
    cfg, params = _frozen(model)
    sched = PagedScheduler(cfg, params, batch_size=b, max_len=64,
                           page_size=PS, device=card)
    sched.warmup()
    assert sched.graph_captures == len(width_buckets(b))
    g = torch.Generator(device=card).manual_seed(5)
    for leaf in _pools(sched):
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=card).to(leaf.dtype))
    rng = np.random.default_rng(0)
    for w in width_buckets(b):
        assert w in sched._graphs
        pages = rng.permutation(np.arange(1, sched.pool.n_pages))
        table = np.full((w, sched.W), GARBAGE_PAGE, np.int32)
        npg = sched.W - 1
        table[:, :npg] = pages[: w * npg].reshape(w, npg)
        inputs = (rng.integers(0, cfg.vocab, (w, 1)).astype(np.int32),
                  rng.integers(0, npg * PS, (w, 1)).astype(np.int32),
                  table, np.zeros((w,), np.int32))
        start = [leaf.clone() for leaf in _pools(sched)]
        dev = [torch.from_numpy(a).to(card) for a in inputs]
        with torch.inference_mode():
            logits, _ = sched._step(params, sched.caches, dev[0],
                                    mk_positions(cfg, dev[1]), dev[2], dev[3])
            eager = logits.float()
        eager_pools = [leaf.clone() for leaf in _pools(sched)]
        for leaf, s in zip(_pools(sched), start):
            leaf.copy_(s)
        for dst, a in zip(sched._graphs.inputs(w), inputs):
            dst.copy_(torch.from_numpy(a))
        with torch.inference_mode():
            replayed = sched._graphs.run(params, sched.caches, w).clone()
        torch.cuda.synchronize()
        assert torch.equal(replayed, eager), w
        for leaf, want in zip(_pools(sched), eager_pools):
            assert torch.equal(leaf, want), w
        assert not all(torch.equal(a, b) for a, b in zip(start, eager_pools))
    assert sched.graph_replays == len(width_buckets(b))


@pytest.mark.gpu
def test_records_hold_no_memory_of_the_pool(card):
    """After the warmup has recorded every width, the allocated bytes have
    grown by the logits buffer alone (the records' operands and slots do
    not own the pool's blocks); the recording's peak is the eager warmup's
    but for the logits buffer and one entry's output beside its slot (the
    LM head's, the widest, at most as large), and a replayed call's peak
    allocation is at most the eager call's."""
    cfg, params = _frozen("bfloat16")
    kw = dict(batch_size=8, max_len=64, page_size=PS, device=card)
    eager = PagedScheduler(cfg, params, **kw)
    eager._graphs = None
    eager.warmup()        # the weights' lazy layouts, made once for both
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager.warmup()
    torch.cuda.synchronize()
    eager_warm = torch.cuda.max_memory_allocated() - base
    sched = PagedScheduler(cfg, params, **kw)
    # while any graph lives, torch's CUDA generator keeps a state of its
    # own (two int64 scalars, 1 KiB of blocks): made here, before the count
    keep = torch.cuda.CUDAGraph()
    with torch.cuda.graph(keep):
        torch.zeros(1, device=card).add_(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    sched.warmup()
    torch.cuda.synchronize()
    assert sched.graph_captures == len(width_buckets(8))
    logits_bytes = sched._graphs._logits.numel() * 4
    assert torch.cuda.memory_allocated() - before == logits_bytes
    assert torch.cuda.max_memory_allocated() - before <= eager_warm + 2 * logits_bytes

    def peak(s):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        s._run_batch([], {}, 8, 1, phase="decode")
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    replays = sched.graph_replays
    replayed, eager_peak = peak(sched), peak(eager)
    assert sched.graph_replays == replays + 1
    assert 0 < replayed <= eager_peak


def _launches():
    return (bitplane_vmm_cuda.launches, bitplane_vmm_cuda.cuda_launches,
            paged_attention_cuda.launches, paged_attention_cuda.cuda_launches)


def _counted_serve(cfg, params, card, mode: str, spec):
    """A serve with its graphs taken away (``eager``), recorded at each
    width's second call (``lazy``) or in the warmup (``warm``); returns
    the scheduler, the tokens, the decode calls and the kernels' calls and
    launches."""
    sched = PagedScheduler(cfg, params, batch_size=4, max_len=48, page_size=PS,
                           prefill_chunk=8, spec=spec, device=card)
    if mode == "eager":
        sched._graphs = None
    elif mode == "warm":
        sched.warmup()
    decode_calls = []
    run_batch = sched._run_batch

    def counting(*args, **kw):
        decode_calls.append(kw.get("phase") == "decode")
        return run_batch(*args, **kw)

    sched._run_batch = counting
    before = _launches()
    tokens = _serve(sched, _prompts(cfg.vocab, n=6, seed=9), new=6)
    torch.cuda.synchronize()
    return sched, tokens, sum(decode_calls), tuple(
        a - b for a, b in zip(_launches(), before))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,spec", [("warm", False), ("warm", True),
                                       ("lazy", False), ("lazy", True)])
def test_served_decode_calls_replay(card, mode, spec):
    """A serve whose decode calls go through graphs emits the eager serve's
    tokens and makes the eager serve's kernel calls and launches; warmed
    up, every decode call replays, else each width runs once eagerly and
    once recording first.  With speculation on, the draft and verify
    calls stay eager and the lanes that decode plainly replay."""
    from repro_torch.spec import SpecConfig

    cfg, params = _frozen("bfloat16")
    spec = (SpecConfig("bitplane", gamma=2, draft_x_bits=4, disable_below=0.0)
            if spec else None)
    eager, eager_tokens, eager_decodes, eager_counts = _counted_serve(
        cfg, params, card, "eager", spec)
    sched, tokens, decodes, counts = _counted_serve(cfg, params, card, mode, spec)
    assert tokens == eager_tokens
    assert all(len(t) == 6 for t in tokens.values())
    assert decodes == eager_decodes > 0
    assert eager.graph_replays == eager.graph_captures == 0
    assert counts == eager_counts and min(counts) > 0
    if mode == "warm":
        assert sched.graph_captures == len(width_buckets(4))
        assert sched.graph_replays == decodes
    else:
        graphs = sched._graphs
        assert sched.graph_replays > 0
        assert sched.graph_replays + sched.graph_captures + len(graphs._eager) == decodes
