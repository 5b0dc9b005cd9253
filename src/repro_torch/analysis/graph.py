"""Trace the port's serving step functions to FX graphs for the passes.

The reference traces each step to a jaxpr (for the taint pass) and to
compiled HLO (for the structural passes).  The port traces each step once
with ``make_fx`` in fake mode: no kernel runs and no device memory is
taken, and every kernel call is one node of its custom op
(``repro_torch::bitplane_vmm`` ...), which the taint pass opens up through
the op's plain version and the structural passes read as opaque.
:func:`trace_serving_steps` builds the decode, chunked-prefill and
speculative-draft steps under the gather *and* fused attention backends,
with the synthetic paged-cache arguments of a live scheduler, on the
device the parameters live on (so a CUDA trace shows what the card runs).

Taint seeding mirrors the freeze planner's notion of "weight leaf"
(``core.freeze.DA_LEAF_NAMES`` / ``SKIP_CONTEXT``), over leaf paths from
``torch.utils._pytree`` that carry the reference's names: integer
``PackedWeights`` children (``wq``, ``luts``) seed ``INT_EXACT``; float
weight matrices (the unfrozen baseline) seed ``FLOAT``; dequant scales
(``w_scale``), router / embedding / conv leaves and everything non-weight
seed nothing.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree
from torch.fx.experimental.proxy_tensor import PythonKeyTracer, make_fx

from repro_torch.analysis.passes import Flavor, Taint, UNTAINTED
from repro_torch.core.engine import PackedWeights
from repro_torch.core.freeze import DA_LEAF_NAMES, SKIP_CONTEXT
from repro_torch.models.attention import PagedKVCache


@dataclasses.dataclass
class TracedStep:
    """One serving step function, traced for the pass pipeline.

    gm: the FX graph module (one placeholder per tensor leaf of the
    flattened arguments, in order).  view_bytes: size of the
    re-materialized ``[B, W·ps, kv, hd]`` page-table KV view at the
    narrowest pool dtype, the ``no-big-gather`` threshold.  fused: this
    step claims the in-kernel page walk (the gather pass gates only fused
    steps).  trace_s: seconds ``make_fx`` took.  pools: the placeholder
    positions of the KV pools (the gathers no-big-gather counts), or None
    for every gather.
    """

    name: str
    gm: Any
    arg_taints: List[Taint]
    view_bytes: int
    fused: bool
    trace_s: float = 0.0
    pools: Optional[Tuple[int, ...]] = None

    def op_counts(self) -> dict:
        """Nodes of each custom op of the port's namespace in this step."""
        from repro_torch.analysis.passes import port_op_name

        counts: dict = {}
        for node in self.gm.graph.nodes:
            name = port_op_name(node)
            if name is not None:
                counts[name] = counts.get(name, 0) + 1
        return counts


def _keyed(names: Sequence[str], obj: Any) -> List[Tuple[Any, Any]]:
    return [(pytree.GetAttrKey(n), getattr(obj, n)) for n in names]


def _register(cls, names: Sequence[str], context: Sequence[str] = ()) -> None:
    """Make ``cls`` a pytree node whose children are the fields ``names``
    (keyed by field name) and whose context is the fields ``context``."""
    if cls in pytree.SUPPORTED_NODES:
        return

    def rebuild(values, ctx):
        obj = cls(**dict(zip(names, values)), **dict(zip(context, ctx)))
        return obj

    pytree.register_pytree_node(
        cls,
        lambda obj: ([getattr(obj, n) for n in names],
                     tuple(getattr(obj, c) for c in context)),
        rebuild,
        flatten_with_keys_fn=lambda obj: (
            _keyed(names, obj), tuple(getattr(obj, c) for c in context)),
    )


_register(PackedWeights, ("wq", "w_scale", "luts"), ("cfg", "mode"))
_register(PagedKVCache, ("k", "v", "k_scale", "v_scale"))


def path_entry_name(entry: Any) -> str:
    """Canonical string of one pytree path entry (a mapping key, a
    sequence index or an attribute name)."""
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def _flat_tensors(args: Any):
    """(leaves, tree spec, [(leaf index, names)] of the tensor leaves)."""
    flat, spec = pytree.tree_flatten_with_path(args)
    leaves = [leaf for _, leaf in flat]
    tensors = [(i, [path_entry_name(p) for p in path])
               for i, (path, leaf) in enumerate(flat)
               if isinstance(leaf, torch.Tensor)]
    return leaves, spec, tensors


def arg_taints(args: Any) -> List[Taint]:
    """Seed taints for one argument tree, one per tensor leaf in the order
    :func:`trace_step` binds them to placeholders."""
    leaves, _, tensors = _flat_tensors(args)
    return [_leaf_taint(names, leaves[i]) for i, names in tensors]


def _leaf_taint(names: Sequence[str], leaf: Any) -> Taint:
    if not names or any(n in SKIP_CONTEXT for n in names):
        return UNTAINTED
    last = names[-1]
    if last == "w_scale":
        # dequant metadata: scaling an accumulated inner product is the
        # paper-sanctioned float epilogue, not a weight multiply
        return UNTAINTED
    if last in ("wq", "luts"):
        return Taint(Flavor.INT_EXACT, False)
    if last in DA_LEAF_NAMES:
        if not leaf.dtype.is_floating_point:
            return Taint(Flavor.INT_EXACT, False)
        return Taint(Flavor.FLOAT, False)
    return UNTAINTED


_PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_ANALYSIS_DIR = os.path.dirname(os.path.abspath(__file__)) + os.sep


def _port_frames(tracer, summary):
    """The tracer's stack filter, replaced: keep every frame of the port
    outside this package (torch's own keeps only frames named ``forward``)."""
    return traceback.StackSummary.from_list([
        f for f in summary
        if f.filename.startswith(_PORT_DIR) and not f.filename.startswith(_ANALYSIS_DIR)])


@contextlib.contextmanager
def _recording_port_frames():
    """``make_fx``'s tracer records the port's frames (the passes' ``where``)
    while this is open."""
    setattr(PythonKeyTracer, "_filter_traceback_frames", _port_frames)
    try:
        yield
    finally:
        delattr(PythonKeyTracer, "_filter_traceback_frames")


def trace_step(fn: Callable, args: Tuple[Any, ...]):
    """``fn(*args)`` traced in fake mode: (graph module, seed taints, seconds).
    Each tensor leaf of ``args`` becomes one placeholder; every other leaf
    is a constant of the trace."""
    leaves, spec, tensors = _flat_tensors(args)

    def flat_fn(*ts):
        full = list(leaves)
        for (i, _), t in zip(tensors, ts):
            full[i] = t
        out = fn(*pytree.tree_unflatten(full, spec))
        return [x for x in pytree.tree_leaves(out) if isinstance(x, torch.Tensor)]

    t0 = time.perf_counter()
    with _recording_port_frames():
        gm = make_fx(flat_fn, tracing_mode="fake", record_stack_traces=True)(
            *[leaves[i] for i, _ in tensors])
    secs = time.perf_counter() - t0
    return gm, [_leaf_taint(names, leaves[i]) for i, names in tensors], secs


def _min_pool_itemsize(caches: Any) -> int:
    """Narrowest dtype across the paged KV pools: a gather of the whole
    page-table view is a violation even at int8/int4 code width."""
    sizes = [leaf.element_size() for leaf in pytree.tree_leaves(caches)
             if isinstance(leaf, torch.Tensor)]
    return min(sizes) if sizes else 4


def page_view_bytes(cfg: Any, batch_size: int, table_width: int,
                    page_size: int, itemsize: int) -> int:
    """Bytes of one re-materialized ``[B, W·ps, kv, hd]`` KV view."""
    return (batch_size * table_width * page_size * cfg.n_kv_heads
            * cfg.head_dim_ * itemsize)


def supports_paged_tracing(cfg: Any) -> bool:
    """The paged step functions cover pure-attention *text* stacks.
    SSM/hybrid configs serve through the slot runtime, and embedding-input
    modalities (audio frames, vision patches) have no token embed table for
    the paged token step to drive."""
    try:
        if getattr(cfg, "modality", "text") != "text":
            return False
        return all(cfg.mixer_kind(i) == "attn" for i in range(cfg.period))
    except Exception:
        return False


def _device_of(params: Any) -> torch.device:
    for leaf in pytree.tree_leaves(params):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def trace_serving_steps(
    params: Any,
    cfg: Any,
    *,
    batch_size: int = 2,
    max_len: int = 32,
    page_size: int = 8,
    prefill_chunk: int = 8,
    spec_gamma: int = 0,
    spec_x_bits: int = 4,
    backends: Sequence[str] = ("gather", "fused"),
) -> List[TracedStep]:
    """Trace decode / chunked-prefill (/ spec-draft) steps for each
    attention backend, with synthetic args shaped like a live scheduler,
    on the parameters' device."""
    from repro_torch.serve.kvcache import init_paged_caches, pages_for, table_width
    from repro_torch.spec.decode import make_paged_step, mk_positions

    if not supports_paged_tracing(cfg):
        raise ValueError(
            f"config {getattr(cfg, 'name', cfg)} is outside the paged "
            "tracer's coverage (non-attention mixers, or an embedding-input "
            "modality with no token step to trace)"
        )
    dev = _device_of(params)
    b, ps = batch_size, page_size
    w = table_width(max_len, ps)
    n_pages = 1 + b * pages_for(max_len, ps)
    steps: List[TracedStep] = []
    for backend in backends:
        cfg_b = dataclasses.replace(cfg, paged_attn=backend)
        caches = init_paged_caches(cfg_b, n_pages, ps, cfg_b.dtype(), device=dev)
        view = page_view_bytes(cfg_b, b, w, ps, _min_pool_itemsize(caches))
        step = make_paged_step(cfg_b)
        fused = backend == "fused"

        def args_for(t: int) -> Tuple[Any, ...]:
            zeros = torch.zeros((b, t), dtype=torch.int32, device=dev)
            return (params, caches, zeros, mk_positions(cfg_b, zeros),
                    torch.zeros((b, w), dtype=torch.int32, device=dev),
                    torch.zeros((b,), dtype=torch.int32, device=dev))

        def one(name: str, fn: Callable, t: int) -> TracedStep:
            args = args_for(t)
            gm, taints, secs = trace_step(fn, args)
            # the caches are argument 1: their tensor leaves are the pools
            pools = tuple(j for j, (_, names) in enumerate(_flat_tensors(args)[2])
                          if names[0] == "1")
            return TracedStep(name=name, gm=gm, arg_taints=taints, view_bytes=view,
                              fused=fused, trace_s=secs, pools=pools)

        steps.append(one(f"decode[{backend}]", step, 1))
        if prefill_chunk > 1:
            steps.append(one(f"prefill[{backend}]", step, prefill_chunk))
        if spec_gamma > 0 and fused:
            draft = _make_draft(cfg_b, params, spec_gamma, spec_x_bits)
            if draft is not None:
                steps.append(one(f"spec_draft[{backend}]", draft, 1))
    return steps


def _make_draft(cfg: Any, params: Any, gamma: int,
                x_bits: int) -> Optional[Callable]:
    """The fused truncated-bitplane draft loop, or None for float params
    (no bit-planes to truncate: nothing extra to trace)."""
    from repro_torch.spec.decode import make_fused_draft
    from repro_torch.spec.providers import TruncatedBitplaneDraft

    try:
        provider = TruncatedBitplaneDraft(cfg, params, x_bits_eff=x_bits)
    except ValueError:
        return None
    return make_fused_draft(provider.make_step(), gamma)
