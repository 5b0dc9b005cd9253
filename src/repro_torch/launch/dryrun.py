"""Multi-pod dry-run: trace one rank of every (architecture × input shape)
cell on the production meshes, and record what that rank would do — FLOPs,
bytes, collectives, memory — and the roofline they bound.

This is the proof that the distribution config is coherent without the
hardware: a sharding mismatch, an op DTensor cannot place, or a read of a
device value in the step fails here.

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's analyses.  The port runs the cell's own step
eagerly, once, as rank 0 of a fake world (``torch.distributed``'s ``fake``
backend: every collective returns at once and moves nothing) on fake
tensors (``FakeTensorMode``: shapes, dtypes and devices, no bytes), placed
on the production mesh by the sharding rules, and counts that rank's local
ops (:class:`OpCounter`).  DTensor ops pass through to the local ops they
run, and the global-shape ops that DTensor's sharding propagation runs on
fake tensors are not counted, so every count is per chip:

* FLOPs: ``torch.utils.flop_counter``'s formulas, plus one for each
  ``repro_torch::`` kernel op and for ``torch._int_mm`` (its padded
  operands: the card multiplies 17 rows where a decode rank has 8).  A VMM counts the product it stands for,
  2·M·K·N (per expert for the stacked forms), so ``useful_flops_fraction``
  stays comparable with ``model_flops``; the paged-attention read counts
  the reference's score and PV products, 4·B·T·H·S·hd over its window of
  S = W·page_size positions.
* bytes: each distinct tensor among an op's operands and results, once
  (views, allocations and collectives move none), and twice the tensor an
  op reads and writes in place (``sub_``, ``exp_``, a ``where`` into its
  own operand; not ``copy_`` or ``fill_``, which only write it); an
  indexed read (``index``, ``gather``, ``embedding``) or write (``index_put_``,
  ``scatter``, ...) counts the rows it moves, twice (read and write), not
  the whole table it indexes.  The port runs eagerly, op by op, so these
  unfused bytes are what it moves; XLA's fused count is smaller.
* collectives: the result bytes of every collective by kind
  (:func:`repro_torch.launch.roofline.collective_bytes`).
* memory: ``argument_bytes`` / ``output_bytes`` are the rank's local bytes
  in and out, ``alias_bytes`` what the step updates in place (train state,
  caches), ``temp_bytes`` MemTracker's peak less the arguments.

The port's forward runs every layer in Python, so a trace at full depth
counts every layer: the reference's ``probe_costs`` (an affine fit of two
unrolled probes, since XLA counts a scan body once) has no counterpart,
and a record's ``probes`` is null.

The fake tensors and the mesh live on ``--device`` (``cuda`` by default;
``--device cpu`` runs without a card, and without one ``cuda`` raises).
DTensor replaces all-to-all by all-gather and chunk on a CPU-typed mesh;
on the fake world it issues the all-to-all there too
(:func:`_issue_all_to_all`), so both devices count the collectives a
card's mesh issues.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/torch/dryrun
Artifacts: one JSON per cell (cached — reruns skip completed cells).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import sys
import threading
import time
import traceback
from collections import Counter
from typing import Any, Callable, List, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs.registry import ARCHS, LM_SHAPES, ShapeSpec, get, shapes_for
from repro_torch.device import resolve_device
from repro_torch.launch import roofline as rl
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import LM_RULES, use_mesh_rules
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (
    abstract_params,
    count_active_params,
    count_params,
    init_caches,
)

#: ranks of the fake world: the multi-pod mesh's 512, whose first 256 hold
#: the single-pod mesh
FAKE_WORLD = 512

_LOCAL = threading.local()


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------


def start_fake_world(n: int = FAKE_WORLD) -> None:
    """Make this process rank 0 of an ``n``-rank world on the ``fake``
    backend (once; a fake world already started with at least ``n`` ranks
    is kept), whose CPU-typed meshes issue all-to-alls
    (:func:`_issue_all_to_all`)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    _issue_all_to_all()
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < n:
            raise RuntimeError(
                f"the dry-run needs a fake world of {n} ranks; this process "
                f"holds a {dist.get_backend()} group of {dist.get_world_size()}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _issue_all_to_all() -> None:
    """DTensor replaces the all-to-all of a shard-to-shard redistribution
    on a CPU-typed mesh by an all-gather and a chunk (gloo has no
    all-to-all); on a mesh of the ``fake`` backend, issue the all-to-all
    op as a ``cuda`` mesh does, so that a trace without a card counts the
    collectives a card's mesh would issue.  A mesh of any other backend
    keeps DTensor's own choice.  Idempotent."""
    import torch.distributed as dist
    from torch.distributed.tensor import placement_types as pt

    if getattr(pt.shard_dim_alltoall, "_repro_torch_issued", False):
        return
    plain = pt.shard_dim_alltoall

    def shard_dim_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        if mesh.device_type != "cpu" or dist.get_backend() != "fake":
            return plain(input, gather_dim, shard_dim, mesh, mesh_dim)
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    shard_dim_alltoall._repro_torch_issued = True
    pt.shard_dim_alltoall = shard_dim_alltoall


# ---------------------------------------------------------------------------
# Counting one rank's local ops
# ---------------------------------------------------------------------------


def _uncounted(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def run(*args, **kwargs):
        _LOCAL.propagating = getattr(_LOCAL, "propagating", 0) + 1
        try:
            return fn(*args, **kwargs)
        finally:
            _LOCAL.propagating -= 1

    run._repro_torch_uncounted = True
    return run


def _propagating() -> bool:
    return bool(getattr(_LOCAL, "propagating", 0))


def _hide_sharding_propagation() -> None:
    """Mark DTensor's output-metadata propagation (the op run once on fake
    tensors of the global shapes) so that the counters skip its ops.
    Idempotent."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    for name in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta"):
        fn = getattr(ShardingPropagator, name, None)
        if fn is not None:
            if not getattr(fn, "_repro_torch_uncounted", False):
                setattr(ShardingPropagator, name, _uncounted(fn))
            return
    raise RuntimeError("DTensor's sharding propagator has no tensor-meta "
                       "propagation to hide: per-chip counts would hold "
                       "global-shape ops")


def _vmm_flops(xq_shape, w_shape, *_, out_shape=None, **__) -> int:
    """The product a VMM stands for: 2·M·K·N, per expert when stacked."""
    return 2 * math.prod(out_shape) * xq_shape[-1]


def _attention_flops(q_shape, k_shape, v_shape, table_shape, *_, out_shape=None,
                     **__) -> int:
    """The reference's score and PV products over the read's window:
    4·B·T·H·hd·S, S = W·page_size."""
    return 4 * math.prod(q_shape) * table_shape[1] * k_shape[-3]


def _int_mm_flops(a_shape, b_shape, *_, **__) -> int:
    """``torch._int_mm`` (the ``int8`` backend on CUDA): 2·M·K·N of its
    operands, as they are padded (M above 16 rows)."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


def _register_kernel_flops() -> None:
    """A FLOP formula for each ``repro_torch::`` kernel op, and for
    ``torch._int_mm``, which torch's counter lacks (idempotent)."""
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    from repro_torch.kernels import ops

    for name in ops.OP_NAMES:
        packet = getattr(torch.ops.repro_torch, name)
        if packet not in flop_registry:
            register_flop_formula(packet)(
                _attention_flops if name == "paged_attention" else _vmm_flops)
    if torch.ops.aten._int_mm not in flop_registry:
        register_flop_formula(torch.ops.aten._int_mm)(_int_mm_flops)


#: ops that allocate, alias or query and move no bytes
_NO_BYTES = frozenset({
    "aten.empty", "aten.empty_strided", "aten.empty_like", "aten.new_empty",
    "aten.new_empty_strided", "aten.lift_fresh", "aten.detach", "aten.alias",
    "aten._unsafe_view",
    "aten._local_scalar_dense", "aten.sym_size", "aten.sym_stride",
    "aten.sym_numel", "aten.sym_storage_offset", "aten.is_same_size",
    "prim.device", "prim.layout",
})


#: in-place ops that write their tensor without reading it
_WRITE_ONLY = frozenset({"aten.copy_", "aten.fill_", "aten.zero_"})
#: ops that read the rows of their first operand (a table) that their
#: other operands name, and ops that write such rows in place
_INDEXED_READS = frozenset({"aten.index", "aten.gather", "aten.embedding",
                            "aten.index_select"})
_INDEXED_WRITES = frozenset({
    "aten.index_put_", "aten._index_put_impl_", "aten.scatter_",
    "aten.scatter_reduce_", "aten.scatter_add_", "aten.index_copy_",
    "aten.index_add_"})


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, sequences and dataclasses (caches,
    packed weights), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_bytes(tensors) -> dict:
    """``{storage id: local bytes}`` over ``tensors`` (a storage once, at
    its largest view)."""
    out: dict = {}
    for t in tensors:
        t = _local(t)
        key = t.untyped_storage()._cdata
        out[key] = max(out.get(key, 0), _nbytes(t))
    return out


#: the modules whose functions name a site (:func:`_site`); the dry-run
#: itself is not one
_SITE_MODULES = ("repro_torch.models.", "repro_torch.train.",
                 "repro_torch.core.", "repro_torch.launch.sharding",
                 "repro_torch.serve.")


def _frame_site(frame) -> Optional[str]:
    """``module.function`` of the innermost port frame at or above
    ``frame`` (the model code that issued an op), or None."""
    while frame is not None:
        mod = frame.f_globals.get("__name__", "")
        if mod.startswith(_SITE_MODULES):
            return f"{mod.rsplit('.', 1)[-1]}.{frame.f_code.co_name}"
        frame = frame.f_back
    return None


def _site() -> str:
    """Where the op being run comes from: the port function on the Python
    stack, or, in the backward (which autograd runs from C++), the
    forward site of the autograd node running (``bwd:`` before it, as
    :class:`_SiteTagger` tagged it)."""
    node = torch._C._current_autograd_node()
    if node is not None:
        return "bwd:" + node.metadata.get("site", node.name())
    return _frame_site(sys._getframe(2)) or "other"


class _SiteTagger(TorchFunctionMode):
    """Tags every autograd node a port function creates with that
    function's site (``node.metadata["site"]``), the nodes inside a
    composite op (an einsum's bmm and views) too, so the backward's ops
    can be attributed to the forward code they differentiate."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        site = None
        todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
        while todo:
            node = todo.pop()
            if node is None or "site" in node.metadata:
                continue
            site = site or _frame_site(sys._getframe(1)) or "other"
            node.metadata["site"] = site
            todo.extend(n for n, _ in node.next_functions)
        return out


class OpCounter(TorchDispatchMode):
    """Counts the local ops run under it: FLOPs, bytes and calls by op,
    and every collective's result bytes.  A DTensor op returns
    ``NotImplemented`` here, so DTensor runs it and its local ops come
    back through the mode; DTensor's global-shape propagation is skipped
    (:func:`_hide_sharding_propagation`).  With ``sites`` it also splits
    FLOPs and collective bytes by (site, op) (:func:`_site`; the trace
    then runs under :class:`_SiteTagger` too)."""

    def __init__(self, sites: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.sites = sites
        self.flops = 0
        self.bytes = 0
        self.calls: Counter = Counter()
        self.flops_by_op: Counter = Counter()
        self.bytes_by_op: Counter = Counter()
        #: FLOPs and collective result bytes by (site, op name), with sites
        self.flops_by_site: Counter = Counter()
        self.coll_by_site: Counter = Counter()
        #: (op name, result bytes) of each collective issued, in order
        self.collectives: List[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not _propagating():
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = str(func.overloadpacket)
        self.calls[name] += 1
        if rl.collective_kind(name) is not None:
            b = sum(_nbytes(t) for t in _tensors(out))
            self.collectives.append((name, b))
            if self.sites:
                self.coll_by_site[(_site(), name)] += b
            return
        if name.startswith(tuple(ns + "." for ns in rl.COLLECTIVE_NAMESPACES)) \
                or func.is_view \
                or name in _NO_BYTES:
            return
        formula = self._formulas.get(func.overloadpacket)
        if formula is not None:
            n = int(formula(*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[name] += n
            if self.sites and n:
                self.flops_by_site[(_site(), name)] += n
        if name in _INDEXED_READS or name in _INDEXED_WRITES:
            # the rows moved (and their indices), not the table
            b = sum(_nbytes(t) for t in tree_flatten((args[1:], kwargs))[0]
                    if isinstance(t, torch.Tensor))
            b += (b if name in _INDEXED_WRITES
                  else sum(2 * _nbytes(t) for t in _tensors(out)))
        else:
            seen, b = set(), 0
            for t in tree_flatten((args, kwargs, out))[0]:
                if isinstance(t, torch.Tensor) and id(t) not in seen:
                    seen.add(id(t))
                    b += _nbytes(t)
            if name not in _WRITE_ONLY:     # read and written in place
                b += sum(_nbytes(t) for t in _tensors(out)
                         if any(t is a for a in args))
        self.bytes += b
        self.bytes_by_op[name] += b

    def top_collectives(self, n: int = 20):
        """``(op name, kind, result bytes, calls)`` per distinct (op, size),
        largest total first."""
        agg: Counter = Counter()
        for name, b in self.collectives:
            agg[(name, b)] += 1
        rows = [(name, rl.collective_kind(name), b * c, c)
                for (name, b), c in agg.items()]
        return sorted(rows, key=lambda r: -r[2])[:n]

    def bytes_by_op_kind(self):
        """``(op name, bytes, calls)``, largest first."""
        return sorted(((k, v, self.calls[k]) for k, v in self.bytes_by_op.items()),
                      key=lambda r: -r[1])


def _mem_tracker():
    """``MemTracker`` that skips DTensor's global-shape propagation."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class _Tracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _propagating():
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return _Tracker()


@dataclasses.dataclass
class StepTrace:
    """One traced step: its counter, wall seconds, memory (bytes of the
    rank; ``peak_bytes`` None when memory was not tracked) and arguments."""

    counter: OpCounter
    seconds: float
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    peak_bytes: Optional[int]
    args: Any = None

    @property
    def memory(self) -> dict:
        temp = (None if self.peak_bytes is None
                else max(self.peak_bytes - self.argument_bytes, 0))
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": temp,
                "alias_bytes": self.alias_bytes,
                "peak_bytes": self.peak_bytes}


def trace_step(fn: Callable, args: tuple, *, grad: bool = False,
               memory: bool = True, sites: bool = False) -> StepTrace:
    """Run ``fn(*args)`` once under an :class:`OpCounter` (and MemTracker
    with ``memory``), gradients on with ``grad``; ``sites`` splits the
    counts by site."""
    _hide_sharding_propagation()
    _register_kernel_flops()
    arg_t = _tensors(args)
    counter = OpCounter(sites=sites)
    tracker = _mem_tracker() if memory else None
    with contextlib.ExitStack() as stack:
        if tracker is not None:
            tracker.track_external(*arg_t)
            stack.enter_context(tracker)
        if sites:
            stack.enter_context(_SiteTagger())
        stack.enter_context(counter)
        stack.enter_context(torch.enable_grad() if grad else torch.no_grad())
        t0 = time.perf_counter()
        out = fn(*args)
        seconds = time.perf_counter() - t0
    peak = None
    if tracker is not None:
        peak = max((snap.get("Total", 0) for snap in
                    tracker.get_tracker_snapshot("peak").values()), default=0)
    ins, outs = _storage_bytes(arg_t), _storage_bytes(_tensors(out))
    return StepTrace(counter=counter, seconds=seconds,
                     argument_bytes=sum(ins.values()),
                     output_bytes=sum(outs.values()),
                     alias_bytes=sum(b for k, b in outs.items() if k in ins),
                     peak_bytes=peak, args=args)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _fake_like(t: torch.Tensor, device) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device=device)


def _fake_tree(tree, device):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: _fake_like(t, device), tree)


def _cell_step(cfg: ModelConfig, shape: ShapeSpec, mesh, quant, device, tcfg):
    """(step, args, grad) of the cell, its inputs fake on ``device`` and
    placed on ``mesh`` by the active rules (``mesh`` None: one device)."""
    placed = mesh is not None

    def place(tree, specs):
        return SP.place(tree, specs, mesh) if placed else tree

    params = _fake_tree(abstract_params(cfg), device)
    if shape.kind == "train":
        from repro_torch.train.trainer import (TrainConfig, make_train_step,
                                               state_from_params)

        params = place(params, SP.tree_pspecs(params))
        state = state_from_params(params)
        batch = {k: _fake_like(v, device)
                 for k, v in SP.batch_specs(cfg, shape).items()}
        batch = place(batch, SP.batch_pspecs(batch))
        return make_train_step(cfg, tcfg or TrainConfig()), (state, batch), True

    from repro_torch.serve.engine import make_prefill_step, make_serve_step

    if quant:
        from repro_torch.core.da import DAConfig
        from repro_torch.core.freeze import freeze_model_da

        params = freeze_model_da(params, DAConfig(x_signed=True), mode=quant,
                                 device=device)
    params = place(params, SP.tree_pspecs(params))
    caches = init_caches(cfg, shape.global_batch, shape.seq_len, cfg.dtype(),
                         device=device)
    if shape.kind == "prefill":
        fn = make_prefill_step(cfg)
        tok, pos = SP.prefill_specs(cfg, shape)
    else:
        fn = make_serve_step(cfg)
        tok, pos = SP.decode_specs(cfg, shape)
    tok, pos = _fake_like(tok, device), _fake_like(pos, device)
    if placed:
        caches = SP.place_caches(caches, SP.cache_pspecs(caches), mesh)
        tok = shd.distribute(tok, shd.NamedSharding(mesh, shd.pspec(
            ("batch", "seq", "embed")[: tok.ndim], tok.shape)))
        pos = shd.distribute(pos, shd.NamedSharding(mesh, shd.pspec(
            ("batch", None, None)[: pos.ndim], pos.shape)))

    def step(params, caches, tok, pos):
        logits, caches = fn(params, caches, tok, pos)
        # the reference pins the logits' sharding (its out_shardings)
        return shd.constrain(logits, ("batch", "vocab")), caches

    return step, (params, caches, tok, pos), False


def lower_cell(
    cfg: ModelConfig,
    shape: ShapeSpec,
    mesh,
    rules=LM_RULES,
    extra_cfg: Optional[dict] = None,
    quant: Optional[str] = None,
    *,
    device="cuda",
    memory: bool = True,
    train_cfg=None,
    sites: bool = False,
):
    """Trace the cell's step on fake tensors placed on ``mesh`` (None: one
    device, no mesh).  Returns ``(trace, aux)``: the :class:`StepTrace`
    and the chips and MODEL_FLOPS for the roofline.

    quant: None, "auto", or any registered engine backend name (legacy
    "da_bitplane"/"da_lut" spellings accepted) — serve the DA-frozen model.
    ``train_cfg`` replaces the train step's ``TrainConfig()``; ``sites``
    splits the counts by site (:class:`OpCounter`)."""
    if extra_cfg:
        cfg = cfg.with_levers(**extra_cfg)
    n_params = count_params(cfg)
    n_active = count_active_params(cfg)
    aux = {
        "chips": mesh.size() if mesh is not None else 1,
        "model_flops": rl.model_flops(cfg, shape, n_params, n_active),
        "n_params": n_params,
        "n_active": n_active,
    }
    from torch._subclasses.fake_tensor import FakeTensorMode

    device = resolve_device(device)
    rules_ctx = (use_mesh_rules(mesh, rules) if mesh is not None
                 else contextlib.nullcontext())
    with FakeTensorMode(), rules_ctx:
        step, args, grad = _cell_step(cfg, shape, mesh, quant, device, train_cfg)
        trace = trace_step(step, args, grad=grad, memory=memory,
                           sites=sites)
    return trace, aux


def _cost_of(trace: StepTrace) -> dict:
    coll = rl.collective_bytes(trace.counter.collectives)
    return {
        "flops": float(trace.counter.flops),
        "bytes": float(trace.counter.bytes),
        "coll": float(sum(coll.values())),
        "coll_by_kind": coll,
    }


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: Optional[str] = None,
    extra_cfg: Optional[dict] = None,
    tag: str = "",
    rules=LM_RULES,
    skip_full: bool = False,
    do_probes: bool = True,
    quant: Optional[str] = None,
    device="cuda",
) -> dict:
    """Trace one cell on its production mesh and record it (cached under
    ``out_dir``).  ``skip_full`` leaves memory untracked; ``do_probes``
    False records no roofline (the multi-pod cells prove coherence)."""
    cfg = get(arch)
    shape = next(s for s in LM_SHAPES if s.name == shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    out_path = os.path.join(out_dir, cell_id + ".json") if out_dir else None
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)

    record = {"cell": cell_id, "arch": arch, "shape": shape_name,
              "mesh": mesh_name, "ok": False}
    t0 = time.time()
    try:
        start_fake_world()
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=torch.device(device).type)
        trace, aux = lower_cell(cfg, shape, mesh, rules=rules,
                                extra_cfg=extra_cfg, quant=quant,
                                device=device, memory=not skip_full)
        costs = _cost_of(trace)
        if not skip_full:
            record.update(memory=trace.memory, raw_full_cost=costs)
        record.update(ok=True, lower_compile_s=round(time.time() - t0, 1),
                      n_params=aux["n_params"], n_active=aux["n_active"])
        if do_probes:
            roof = rl.Roofline(
                flops_per_chip=costs["flops"],
                bytes_per_chip=costs["bytes"],
                coll_bytes_per_chip=costs["coll"],
                chips=aux["chips"],
                model_flops_global=aux["model_flops"],
            )
            record.update(probes=None, roofline=roof.as_dict())
    except Exception as e:  # the dry-run's job is to surface these
        record.update(ok=False, error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-2000:],
                      lower_compile_s=round(time.time() - t0, 1))
    if out_path:
        os.makedirs(out_dir, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1)
    return record


def roofline_line(rec: dict) -> str:
    """The one-line summary the CLI prints per cell."""
    r = rec.get("roofline", {})
    return (f"{rec['cell']:64s} ok={rec.get('ok')} "
            f"t_c={r.get('t_compute_s', 0):.3e} t_m={r.get('t_memory_s', 0):.3e} "
            f"t_coll={r.get('t_collective_s', 0):.3e} "
            f"bottleneck={r.get('bottleneck', '-'):10s} "
            f"frac={r.get('roofline_fraction', 0):.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/torch/dryrun")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors and the mesh (cpu "
                         "without a card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    cells = []
    if args.all:
        for arch, cfg in sorted(ARCHS.items()):
            for s in shapes_for(cfg):
                for mp in meshes:
                    cells.append((arch, s.name, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    n_ok = 0
    start_fake_world()
    for arch, shape_name, mp in cells:
        # multi-pod cells prove coherence; the roofline table is single-pod,
        # as the reference's
        rec = run_cell(arch, shape_name, mp, out_dir=args.out,
                       do_probes=not mp, device=args.device)
        ok = rec.get("ok")
        n_ok += bool(ok)
        print(roofline_line(rec), flush=True)
        if not ok:
            print("   ERROR:", rec.get("error"), flush=True)
    print(f"\n{n_ok}/{len(cells)} cells ok")
    return n_ok, len(cells)


if __name__ == "__main__":
    main()
