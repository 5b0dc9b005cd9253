"""Device meshes and the collectives that code inside a mesh calls by axis
name.

The reference's ``jax.make_mesh`` becomes a ``DeviceMesh`` with
``mesh_dim_names``, its ``shard_map`` a wrapper that hands a function its
local shards (:func:`shard_map_compat`), and the ``lax`` collectives by
axis name (``axis_index``, ``psum``, ``pmax``, ``ppermute``) work on that
mesh dimension's process group.  Meshes are built by FUNCTIONS, so
importing this module touches no process group.

A mesh spans the ranks of the default process group, which the caller
starts: ``torchrun`` (``WORLD_SIZE`` in the environment, NCCL, one card a
rank) or :func:`spawn` (N local ranks on gloo, the counterpart of the
reference's placeholder host devices; on ``cuda`` all of them share the one
card, where NCCL refuses two ranks of one device).

Gloo takes CUDA tensors in its c10d collectives (``all_reduce``,
``broadcast``, ``all_gather``, ``reduce_scatter``, ``all_to_all``: it
copies them through host memory itself) and in the functional
``all_reduce`` and ``reduce_scatter`` DTensor redistributes with, but not
in a point-to-point send (``writev … Bad address``) nor in the functional
``all_gather`` (the process dies of SIGSEGV; torch 2.11 on an H100,
``tools/gloo_cuda_probe.py``).  So on a gloo group those two go through
host memory explicitly: :func:`ppermute` copies a CUDA tensor to the host,
sends and receives there and copies back, and ranks started on ``cuda``
over gloo (:func:`init_local_rank`) route the functional ``all_gather``
the same way (:func:`stage_functional_collectives`).
:data:`HOST_STAGED` counts each staged collective by name.
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
import threading
from collections import Counter
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: collectives staged through host memory on a gloo group, by name
HOST_STAGED: Counter = Counter()

_LOCAL = threading.local()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def _make_mesh(shape: Sequence[int], axes: Sequence[str],
               device_type: Optional[str]) -> DeviceMesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a started process group "
                           "(torchrun, or repro_torch.launch.mesh.spawn)")
    if n > world_size():
        raise ValueError(f"mesh {shape} needs {n} ranks; the world has "
                         f"{world_size()}")
    return DeviceMesh(_device_type(device_type),
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """The reference's production layout: ``data × model`` = 16 × 16, or
    ``pod × data × model`` = 2 × 16 × 16.  Needs a world of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A small mesh over the first ``prod(shape)`` ranks of the world."""
    return _make_mesh(shape, axes, device_type)


def axis_sizes(mesh) -> dict:
    """``{axis name: extent}`` of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and ``shape``)."""
    shape = mesh.shape if isinstance(mesh.shape, tuple) else tuple(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, shape))


# ---------------------------------------------------------------------------
# shard_map and the collectives by axis name
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _inside(mesh: DeviceMesh):
    prev = getattr(_LOCAL, "mesh", None)
    _LOCAL.mesh = mesh
    try:
        yield
    finally:
        _LOCAL.mesh = prev


def current_mesh(mesh: Optional[DeviceMesh] = None) -> DeviceMesh:
    """``mesh``, else the mesh of the enclosing :func:`shard_map_compat`,
    else the active rules' mesh (:func:`repro_torch.launch.sharding.use_mesh_rules`)."""
    if mesh is not None:
        return mesh
    mesh = getattr(_LOCAL, "mesh", None)
    if mesh is None:
        from repro_torch.launch.sharding import active_mesh

        mesh = active_mesh()
    if mesh is None:
        raise RuntimeError("no mesh: call inside shard_map_compat or "
                           "use_mesh_rules, or pass mesh=")
    return mesh


def shard_map_compat(f: Callable, mesh: DeviceMesh, in_specs, out_specs,
                     check: bool = False) -> Callable:
    """``f`` on each rank's local shards, as ``jax.shard_map``: every
    argument is a tree of tensors (a DTensor is redistributed to its spec;
    a plain tensor is the global value, the same on every rank, and is cut
    locally), ``in_specs`` a spec per argument (a PartitionSpec covers a
    whole subtree), and ``f``'s results are wrapped as DTensors by
    ``out_specs``.  ``check`` is the reference's replication check and is
    not run."""
    from repro_torch.launch import sharding as shd

    def call(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} specs")
        local = [shd.map_specs(lambda s, t: shd.to_local(t, s, mesh), spec, a)
                 for spec, a in zip(in_specs, args)]
        with _inside(mesh):
            out = f(*local)
        return shd.map_specs(lambda s, t: shd.from_local(t, s, mesh),
                             out_specs, out)

    return call


def _group(axis: str, mesh: Optional[DeviceMesh]):
    return current_mesh(mesh).get_group(axis)


def axis_index(axis: str, mesh: Optional[DeviceMesh] = None) -> int:
    """This rank's coordinate along ``axis``."""
    return current_mesh(mesh).get_local_rank(axis)


def axis_size(axis: str, mesh: Optional[DeviceMesh] = None) -> int:
    return axis_sizes(current_mesh(mesh))[axis]


def _staged(name: str, x: torch.Tensor, group) -> bool:
    """Whether a point-to-point exchange of ``x`` goes through host memory
    (a CUDA tensor on a gloo group); counts it."""
    stage = x.is_cuda and dist.get_backend(group) == "gloo"
    if stage:
        HOST_STAGED[name] += 1
    return stage


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, axis: str, mesh: Optional[DeviceMesh] = None):
    """The sum over ``axis`` on every rank.  Differentiable as the
    reference's is under ``shard_map`` with a replicated output: every rank
    holds the same cotangent of the (replicated) sum, and each rank's input
    receives it as it is."""
    return _PSum.apply(x, _group(axis, mesh))


def pmax(x: torch.Tensor, axis: str, mesh: Optional[DeviceMesh] = None):
    """The maximum over ``axis`` on every rank (no gradient)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=_group(axis, mesh))
    return out


def _permute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """Send ``x`` to each pair's destination, receive from its source;
    a rank that no pair sends to gets zeros (as ``lax.ppermute``)."""
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    staged = _staged("ppermute", x, group)
    send = x.detach().cpu().contiguous() if staged else x.detach().contiguous()
    recv = torch.zeros_like(send)
    ops = []
    glob = lambda r: dist.get_global_rank(group, r)  # noqa: E731
    for d in dst:
        ops.append(dist.P2POp(dist.isend, send, glob(d), group))
    for s in src:
        ops.append(dist.P2POp(dist.irecv, recv, glob(s), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return recv.to(x.device) if staged else recv


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        return _permute(g, ctx.group, inv), None, None


def ppermute(x: torch.Tensor, axis: str, perm,
             mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` lists ``(source, destination)`` pairs of
    coordinates along ``axis``; differentiable (the backward sends the
    gradient back along the inverse pairs)."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _PPermute.apply(x, _group(axis, mesh), perm)


def _column_pieces(src, dst):
    """``(source rank, destination rank, global start, width)`` of every
    piece of columns an exchange from layout ``src`` to ``dst`` moves
    (:func:`exchange_columns`), each destination's in ascending order."""
    def source(j, col):
        """(rank, end of its run) of the rank that sends column ``col`` to
        ``j``: ``j`` itself where it holds it, else the lowest holder."""
        for i in [j] + [i for i in range(len(src)) if i != j]:
            for a, b in src[i]:
                if a <= col < b:
                    return i, b
        raise ValueError(f"column {col} is held by no rank")

    pieces = []
    for j, ranges in enumerate(dst):
        for a, b in ranges:
            col = a
            while col < b:
                i, end = source(j, col)
                if i != j:     # stop where j's own run starts
                    end = min([end] + [s for s, _ in src[j] if s > col])
                end = min(end, b)
                pieces.append((i, j, col, end - col))
                col = end
    return pieces


def _local_offset(ranges, col: int) -> int:
    """Where global column ``col`` sits in a tensor holding ``ranges``."""
    off = 0
    for a, b in ranges:
        if a <= col < b:
            return off + col - a
        off += b - a
    raise ValueError(f"column {col} is not in {ranges}")


def exchange_columns(x: torch.Tensor, src, dst, axis: str,
                     mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Move the columns of ``x``'s last dim from one layout over ``axis``
    to another: ``src[i]`` and ``dst[i]`` list the global column ranges
    ``(start, stop)``, ascending, that rank ``i`` holds before and after;
    ``x`` holds this rank's ``src`` columns in order, the result its
    ``dst`` columns in order.  A column that several ranks hold comes from
    the receiving rank itself where it holds it, else from the lowest
    holder.  The columns that change rank move in one all-to-all (none
    where every piece stays), the reference's collective-permute of a
    resharded slice; the rest are indexed locally.  Differentiable: a
    column sent to several ranks gets the sum of their gradients."""
    import torch.distributed._functional_collectives as funcol

    mesh = current_mesh(mesh)
    me, n = mesh.get_local_rank(axis), len(src)
    pieces = _column_pieces(src, dst)
    cols = lambda start, w: range(start, start + w)  # noqa: E731
    index = lambda v: torch.tensor(v, dtype=torch.long, device=x.device)  # noqa: E731
    xt = x.movedim(-1, 0)
    own = [c for i, j, a, w in pieces if i == j == me for c in cols(a, w)]
    parts, got = [xt.index_select(0, index([_local_offset(src[me], c)
                                            for c in own]))], list(own)
    if any(i != j for i, j, _, _ in pieces):
        sends = sorted((j, a, w) for i, j, a, w in pieces if i == me != j)
        recvs = sorted((i, a, w) for i, j, a, w in pieces if j == me != i)
        send = xt.index_select(0, index([_local_offset(src[me], c)
                                         for _, a, w in sends for c in cols(a, w)]))
        recv = funcol.all_to_all_single_autograd(
            send.contiguous(),
            [sum(w for i, _, w in recvs if i == r) for r in range(n)],
            [sum(w for j, _, w in sends if j == r) for r in range(n)],
            mesh.get_group(axis))
        if isinstance(recv, funcol.AsyncCollectiveTensor):
            recv = funcol.wait_tensor(recv)
        parts.append(recv)
        got += [c for _, a, w in recvs for c in cols(a, w)]
    order = sorted(range(len(got)), key=got.__getitem__)
    return torch.cat(parts).index_select(0, index(order)).movedim(0, -1)


#: the functional all-gather DTensor calls (its name across torch
#: versions): the one functional collective gloo cannot run on CUDA
_FUNCOL_NAMES = ("all_gather_tensor", "all_gather_single")


def stage_functional_collectives() -> None:
    """Route the functional all-gather of a CUDA tensor through host
    memory (copy to the host, the gather there, copy back), each counted
    in :data:`HOST_STAGED` as ``funcol.<name>``.  For gloo groups on CUDA
    only.  Idempotent."""
    import torch.distributed._functional_collectives as funcol

    if getattr(funcol, "_repro_torch_staged", False):
        return
    for name in _FUNCOL_NAMES:
        fn = getattr(funcol, name, None)
        if fn is not None:
            setattr(funcol, name, _host_staged(fn, f"funcol.{name}", funcol))
    funcol._repro_torch_staged = True


def _host_staged(fn: Callable, name: str, funcol) -> Callable:
    def staged(self, *args, **kwargs):
        if not self.is_cuda:
            return fn(self, *args, **kwargs)
        HOST_STAGED[name] += 1
        out = fn(self.detach().cpu(), *args, **kwargs)
        if isinstance(out, funcol.AsyncCollectiveTensor):
            out = out.wait()
        return out.to(self.device)

    staged.__wrapped__ = fn
    return staged


# ---------------------------------------------------------------------------
# Local ranks: the counterpart of the reference's placeholder devices
# ---------------------------------------------------------------------------


def init_local_rank(rank: int, world: int, init_file: str,
                    backend: str = "gloo", device: str = "cpu") -> None:
    """Join a ``world``-rank group through a file store.  ``device``
    ``cuda`` puts every rank on card 0 (gloo) or on card ``rank`` (NCCL)."""
    torch.set_num_threads(1)
    kw = {}
    if torch.device(device).type == "cuda":
        card = rank if backend == "nccl" else 0
        torch.cuda.set_device(card)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", card)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world, **kw)
    if backend == "gloo" and torch.device(device).type == "cuda":
        stage_functional_collectives()


def _spawned(rank: int, world: int, init_file: str, backend: str, device: str,
             fn: Callable, args: tuple, results) -> None:
    init_local_rank(rank, world, init_file, backend, device)
    try:
        out = fn(*args)
        if results is not None:
            results[rank] = out
    finally:
        dist.barrier()
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: tuple = (), *, device: str = "cpu",
          backend: str = "gloo", init_dir: Optional[str] = None):
    """Run ``fn(*args)`` on ``n`` local ranks (processes) joined in one
    process group (``backend``, a file store under ``init_dir`` or a fresh
    temporary directory); returns each rank's result, by rank.  ``fn``
    must be importable by the children (a module-level function)."""
    import torch.multiprocessing as mp

    tmp = None
    if init_dir is None:
        tmp = tempfile.TemporaryDirectory()
        init_dir = tmp.name
    init_file = os.path.join(init_dir, f"store_{os.getpid()}_{id(fn)}")
    try:
        with mp.get_context("spawn").Manager() as manager:
            results = manager.dict()
            mp.spawn(_spawned, args=(n, init_file, backend, device, fn, args,
                                     results), nprocs=n, join=True)
            return [results.get(r) for r in range(n)]
    finally:
        if tmp is not None:
            tmp.cleanup()
