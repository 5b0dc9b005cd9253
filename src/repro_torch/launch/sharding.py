"""Logical-axis sharding rules with a divisibility fallback, as DTensor
placements.

Activations and parameters are annotated with *logical* axis names; a rules
table maps logical names to mesh axes.  A logical axis is only sharded when
the dimension divides by the mapped mesh axes' extent — otherwise it falls
back to replication (e.g. 8 GQA kv-heads on a 16-way model axis
replicate).  The resulting :class:`P` (the reference's ``PartitionSpec``, a
tuple) becomes one DTensor placement per mesh dimension
(:func:`placements`): ``Shard(i)`` on the mesh axes that tensor dim ``i``
names, ``Replicate()`` on the others.

Usage::

    with use_mesh_rules(mesh, LM_RULES):
        y = constrain(y, ("batch", "seq", "ffn"))

Without active rules, or on a plain tensor, :func:`constrain` and the
``shard_*`` functions return their argument itself: the one-device path
never meets a DTensor.  Under rules, :func:`constrain` is
``DTensor.redistribute`` (the counterpart of ``with_sharding_constraint``,
whose transpose constrains the cotangent alike),
and :func:`distribute` / :func:`shard_frozen_params` /
:func:`shard_paged_caches` place tensors by ``distribute_tensor`` (every
rank holds the same full tensor and keeps its own slice: no transfer).

A few ops of the model have no DTensor sharding strategy.  Where their
rows are independent (routing per token group, the causal convolution per
row) they go through :func:`on_rows`: each rank runs the op on its own
block of the batch, everything else gathered.  The rest go through
:func:`replicated`: gathered to ``Replicate`` on every mesh dimension, the
op run on the full local tensors, and the result wrapped as replicated —
the counterpart of GSPMD's replicate fallback.  Each such site calls one
of them by name (``CHANGES.md`` lists them).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Callable, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch.mesh import axis_sizes

AxisName = Union[str, Tuple[str, ...], None]


class P(tuple):
    """A PartitionSpec: one entry per tensor dim (trailing replicated dims
    dropped), each None, a mesh axis name or a tuple of them; compares
    equal to the reference's ``tuple(spec)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# Default logical→mesh mapping for the LM family. "pod" exists only in the
# multi-pod mesh; missing mesh axes are dropped automatically.
LM_RULES: Mapping[str, AxisName] = {
    "batch": ("pod", "data"),
    "seq": None,               # sequence replicated in train fwd (SP optional)
    "seq_sp": ("data",),       # sequence-parallel variant (long prefill)
    "embed": None,
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "ffn": ("model",),
    "expert": ("model",),
    "expert_ffn": None,
    "inner": ("model",),       # mamba inner channels
    "ssm_heads": ("model",),
    "state": None,
    "kv_seq": ("model",),      # decode KV-cache sequence axis (seq-parallel KV)
    # Paged KV pools ([pages, page_slot, kv_heads, head_dim]): like the dense
    # cache, the kv-heads axis is the tensor-parallel one (same mesh rules as
    # the packed DA params the attention weights shard by), pages replicate —
    # every device holds its head-slice of every page, so host page tables
    # stay device-agnostic integers.
    "page": None,
    "page_slot": None,
    "lut_addr": None,
    "groups": None,
    # DA-frozen weight artifacts (PackedWeights leaves wq/w_scale/luts):
    # output columns shard over the model axis — each device holds the PMAs
    # (codes + LUT slabs) for its slice of N, the tensor-parallel mapping.
    # The contraction dim stays replicated: DA groups contract locally.
    "da_in": None,
    "da_out": ("model",),
}

# FSDP/ZeRO-3-style 2-D weight sharding: the "embed" logical axis (the
# d_model dim of every weight and the fp32 optimizer mirrors) additionally
# shards over the data axes, so parameters + optimizer state scale with the
# FULL device count instead of the model axis alone.
FSDP_RULES: Mapping[str, AxisName] = {**LM_RULES, "embed": ("data",)}

_LOCAL = threading.local()


def _active():
    return getattr(_LOCAL, "mesh_rules", None)


def active_mesh():
    """The mesh of the active rules, or None."""
    act = _active()
    return None if act is None else act[0]


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: Mapping[str, AxisName] = LM_RULES):
    """Activate ``rules`` over ``mesh`` on this thread.  Inside, a plain
    tensor that meets a DTensor in an op counts as replicated
    (``implicit_replication``), as a host array does under GSPMD."""
    prev = _active()
    _LOCAL.mesh_rules = (mesh, dict(rules))
    try:
        with implicit_replication():
            yield
    finally:
        _LOCAL.mesh_rules = prev


def rules_context():
    """A context that activates the rules active now (a no-op without
    any), for code that runs later on another thread: the backward's
    recompute of a checkpointed block runs on the autograd engine's
    device thread on CUDA, where this thread's rules are not set."""
    act = _active()
    return (contextlib.nullcontext() if act is None
            else use_mesh_rules(*act))


def _resolve(logical: str, dim: int, sizes: Mapping[str, int], rules,
             used: set) -> AxisName:
    axes = rules.get(logical)
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    # Drop mesh axes that don't exist (e.g. "pod" on the single-pod mesh)
    # or are already consumed by another dimension of this tensor.
    axes = tuple(a for a in axes if a in sizes and a not in used)
    if not axes:
        return None
    extent = 1
    for a in axes:
        extent *= sizes[a]
    if dim % extent != 0:
        return None  # divisibility fallback → replicate
    used.update(axes)
    return axes if len(axes) > 1 else axes[0]


def pspec(logical_axes: Sequence[Optional[str]], shape: Sequence[int]) -> P:
    """PartitionSpec for the active mesh/rules; fully replicated if none.

    Dims are assigned right-to-left (minor dims get priority for the model
    axis — e.g. a KV cache [B, S, KV, hd] shards KV heads when divisible,
    else falls back to sequence-sharding S) and each mesh axis is used at
    most once per tensor."""
    act = _active()
    if act is None:
        return P()
    mesh, rules = act
    sizes = axis_sizes(mesh)
    used: set = set()
    parts: list = [None] * len(logical_axes)
    for i in range(len(logical_axes) - 1, -1, -1):
        name, dim = logical_axes[i], shape[i]
        if name is not None:
            parts[i] = _resolve(name, int(dim), sizes, rules, used)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def rule_dims(logical: str) -> Tuple[int, ...]:
    """The dims of the active mesh that the active rules map ``logical``
    to (those the mesh has), whatever a tensor's divisibility; () without
    rules."""
    act = _active()
    if act is None:
        return ()
    mesh, rules = act
    axes = rules.get(logical)
    if axes is None:
        return ()
    names = tuple(mesh.mesh_dim_names)
    return tuple(names.index(a) for a in ((axes,) if isinstance(axes, str) else axes)
                 if a in names)


def placements(spec: Sequence[AxisName], mesh) -> Tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(i)`` where tensor dim ``i`` names that axis, else
    ``Replicate()``.  A dim split over several axes names them in mesh
    order (major first), as DTensor shards them."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in mesh order {names}")
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


def spec_of(x: torch.Tensor, mesh=None) -> P:
    """The PartitionSpec of a DTensor's placements (``P()`` for a plain
    tensor); a Partial placement raises."""
    if not isinstance(x, DTensor):
        return P()
    mesh = mesh or x.device_mesh
    parts: list = [[] for _ in range(x.ndim)]
    for name, pl in zip(mesh.mesh_dim_names, x.placements):
        if isinstance(pl, Shard):
            parts[pl.dim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"{pl} has no PartitionSpec")
    spec = [None if not a else a[0] if len(a) == 1 else tuple(a) for a in parts]
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


class NamedSharding(NamedTuple):
    """A mesh and a PartitionSpec (the reference's ``NamedSharding``)."""

    mesh: Any
    spec: P

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


class _ConstrainGrad(torch.autograd.Function):
    """The identity forward; the backward places the cotangent at
    ``target`` (``with_sharding_constraint`` constrains the cotangent as
    its transpose: a Partial sum arriving at a constrained activation is
    reduced there, and the products before it take their sharded
    strategy, not a gathered operand)."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.target = target
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.target:
            g = g.redistribute(g.device_mesh, ctx.target)
        return g, None


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """``redistribute`` to the logical axes' placements, the cotangent
    placed alike in the backward (:class:`_ConstrainGrad`); ``x`` itself
    without active rules or when ``x`` is not a DTensor."""
    act = _active()
    if act is None or not isinstance(x, DTensor):
        return x
    mesh, _ = act
    assert len(logical_axes) == x.ndim, (logical_axes, x.shape)
    target = placements(pspec(logical_axes, x.shape), mesh)
    if tuple(x.placements) != target:
        x = x.redistribute(mesh, target)
    if not x.requires_grad:
        return x
    return _ConstrainGrad.apply(x, target)


def named_sharding(logical_axes: Sequence[Optional[str]], shape
                   ) -> Optional[NamedSharding]:
    act = _active()
    if act is None:
        return None
    mesh, _ = act
    return NamedSharding(mesh, pspec(logical_axes, shape))


def distribute(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``t`` (the same full tensor on every rank) as a DTensor placed by
    ``sharding``: each rank keeps its own slice, nothing is sent."""
    if isinstance(t, DTensor):
        return t.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(t, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def replicated(fn: Callable, *args, **kwargs):
    """``fn`` on full local tensors: each DTensor argument is gathered to
    ``Replicate`` on every mesh dimension and unwrapped; tensor results are
    wrapped back as replicated DTensors on that mesh.  With no DTensor
    argument, ``fn(*args, **kwargs)`` as it is.  Differentiable."""
    mesh = None

    def unwrap(a):
        nonlocal mesh
        if isinstance(a, DTensor):
            mesh = a.device_mesh
            return a.full_tensor()
        return a

    args = [unwrap(a) for a in args]
    kwargs = {k: unwrap(v) for k, v in kwargs.items()}
    out = fn(*args, **kwargs)
    if mesh is None:
        return out
    rep = [Replicate()] * mesh.ndim
    wrap = lambda o: (DTensor.from_local(o, mesh, rep, run_check=False)  # noqa: E731
                      if isinstance(o, torch.Tensor) else o)
    if isinstance(out, tuple):
        return type(out)(wrap(o) for o in out)
    return wrap(out)


def block_of(t, mesh, target, partial_on: Sequence[int] = ()) -> torch.Tensor:
    """This rank's block of ``t`` under the placements ``target`` (a plain
    tensor counts as replicated), differentiable.  The mesh dims in
    ``partial_on`` are those along which this rank uses only part of the
    block (its own rows, or heads, of a computation that reads it whole):
    there its gradient is a ``Partial`` sum."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, target).to_local(grad_placements=[
        Partial() if i in partial_on else p for i, p in enumerate(target)])


def shard_block(mesh, placements_, dim: int, extent: int) -> Tuple[int, int]:
    """``(size, start)`` of this rank's block of a tensor dim ``dim`` of
    ``extent`` elements under ``placements_`` (an even split; a dim split
    over several mesh dims in mesh order, major first)."""
    size, start = extent, 0
    for i, p in enumerate(placements_):
        if p == Shard(dim):
            size //= mesh.size(i)
            start += mesh.get_local_rank(i) * size
    return size, start


def on_rows(fn: Callable, *args, whole: Sequence[int] = ()):
    """``fn`` on each rank's own rows: where the active rules shard the
    batch, every tensor argument (but those at the indices in ``whole``,
    taken whole) is cut to this rank's block of its dim 0, the batch axes'
    block, and gathered on every other mesh dimension; tensor results are
    wrapped back as that block of rows.  For ops whose rows are
    independent (per-group routing, a per-row convolution) and that
    DTensor cannot place.  Without a DTensor argument ``fn(*args)`` as it
    is; where the batch is not sharded, :func:`replicated`.
    Differentiable."""
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)), None)
    if mesh is None:
        return fn(*args)
    first = next(a for i, a in enumerate(args)
                 if isinstance(a, torch.Tensor) and i not in whole)
    rows = placements(pspec(("batch",), (first.shape[0],)), mesh)
    if all(p == Replicate() for p in rows):
        return replicated(fn, *args)
    rep = [Replicate()] * mesh.ndim
    row_dims = [j for j, p in enumerate(rows) if p != Replicate()]

    def cut(i, a):
        if not isinstance(a, torch.Tensor):
            return a
        if i in whole:              # read by this rank's rows only
            return block_of(a, mesh, rep, partial_on=row_dims)
        return block_of(a, mesh, rows)

    out = fn(*(cut(i, a) for i, a in enumerate(args)))
    wrap = lambda o: (DTensor.from_local(o, mesh, rows, run_check=False)  # noqa: E731
                      if isinstance(o, torch.Tensor) else o)
    if isinstance(out, tuple):
        return type(out)(wrap(o) for o in out)
    return wrap(out)


def full(x):
    """A DTensor's full value on every rank (a plain tensor); a plain
    tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def local_of(x):
    """A DTensor's local tensor (a view: writes land in the DTensor); a
    plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------
# Specs over trees (shard_map's in_specs / out_specs)
# ---------------------------------------------------------------------------


def map_specs(fn: Callable, specs, tree):
    """``fn(spec, leaf)`` over ``tree``; ``specs`` mirrors ``tree``, and a
    :class:`P` (or None: replicated) covers a whole subtree."""
    if specs is None or isinstance(specs, P):
        spec = specs if specs is not None else P()
        from repro_torch.tree import tree_map

        return tree_map(lambda t: fn(spec, t), tree)
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], tree[k]) for k in tree}
    if isinstance(specs, (list, tuple)):
        return type(tree)(map_specs(fn, s, t) for s, t in zip(specs, tree))
    raise TypeError(f"not a spec: {specs!r}")


def to_local(t, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec``: a DTensor redistributed
    and unwrapped, a plain tensor (the global value) cut by slicing.  Both
    differentiable."""
    target = placements(spec, mesh)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, target).to_local()
    for mesh_dim, pl in enumerate(target):
        if isinstance(pl, Shard):
            n = mesh.size(mesh_dim)
            t = t.chunk(n, dim=pl.dim)[mesh.get_local_rank(mesh_dim)]
    return t


def from_local(t: torch.Tensor, spec: P, mesh) -> DTensor:
    """A rank's block ``t`` as the DTensor ``spec`` places on ``mesh``."""
    return DTensor.from_local(t, mesh, placements(spec, mesh), run_check=False)


# ---------------------------------------------------------------------------
# DA artifact sharding: tensor-parallel the PMAs across the mesh
# ---------------------------------------------------------------------------

def da_leaf_axes(name: str, ndim: int) -> Optional[Tuple[Optional[str], ...]]:
    """Logical axes for a PackedWeights leaf by its field name.

    Leading dims (period stacks [P, ...], expert stacks [E, ...]) replicate;
    the output-column dim maps to ``da_out`` (→ model axis) on every leaf so
    codes, scales and LUT slabs of one column slice land on the same device.
    Returns None for names that are not packed-artifact leaves.
    """
    if name == "wq" and ndim >= 2:
        return (None,) * (ndim - 2) + ("da_in", "da_out")
    if name == "w_scale" and ndim >= 2:
        return (None,) * (ndim - 1) + ("da_out",)
    if name == "luts" and ndim >= 3:
        return (None,) * (ndim - 3) + ("groups", "lut_addr", "da_out")
    return None


def paged_cache_axes(ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes for a PagedKVCache pool leaf: [..., pages, page_slot,
    kv_heads, head_dim] with leading period-stack dims replicated.

    Quantized-KV scale pools ([..., pages, page_slot, kv_heads, 1]) reuse
    these axes: the kv-heads slice follows its code pool to the same device,
    and the size-1 head_dim axis replicates via the divisibility fallback —
    no separate rule needed."""
    if ndim < 4:
        raise ValueError(f"paged pool leaves are >=4-D, got ndim={ndim}")
    return (None,) * (ndim - 4) + ("page", "page_slot", "kv_heads", "head_dim")


def _place(t, axes):
    ns = named_sharding(axes, t.shape)
    return distribute(t, ns) if ns is not None else t


def shard_paged_caches(caches):
    """Place every paged-pool leaf per the active mesh rules (``caches``
    itself without rules) — the serving runtime's analogue of
    :func:`shard_frozen_params`: the kv-heads slice of every page lands on
    the rank holding the same head-slice of the packed attention PMAs, so
    the reads stay local.  The divisibility fallback applies (odd kv-head
    counts replicate)."""
    if _active() is None:
        return caches
    from repro_torch.models.attention import PagedKVCache

    def one(node):
        if isinstance(node, PagedKVCache):
            return dataclasses.replace(node, **{
                f: _place(getattr(node, f), paged_cache_axes(getattr(node, f).ndim))
                for f in ("k", "v", "k_scale", "v_scale")
                if getattr(node, f) is not None})
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        return _place(node, paged_cache_axes(node.ndim))

    return one(caches)


def shard_frozen_params(params):
    """Place every DA-packed leaf of a frozen tree per the active mesh rules
    (``params`` itself without rules; non-packed leaves are left as they
    are: plain tensors, replicated under the rules).

    This is the post-load "shard" stage of the artifact pipeline: a model
    restored by ``load_artifact`` is whole on every rank; this keeps each
    rank's column slice of its PMAs.  The divisibility fallback applies, so
    a column count that doesn't divide the model axis replicates instead of
    erroring."""
    if _active() is None:
        return params
    from repro_torch.core.engine import PackedWeights

    def one(node):
        if isinstance(node, PackedWeights):
            fields = {f: _place(getattr(node, f),
                                da_leaf_axes(f, getattr(node, f).ndim))
                      for f in ("wq", "w_scale", "luts")
                      if getattr(node, f) is not None}
            return dataclasses.replace(node, **fields)
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        if isinstance(node, list):
            return [one(v) for v in node]
        return node

    return one(params)


def is_sharded(tree) -> bool:
    """Whether any tensor of ``tree`` (dicts, lists, PackedWeights) is a
    DTensor."""
    from repro_torch.core.engine import PackedWeights

    if isinstance(tree, PackedWeights):
        return isinstance(tree.wq, DTensor)
    if isinstance(tree, dict):
        return any(is_sharded(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(is_sharded(v) for v in tree)
    return isinstance(tree, DTensor)

