"""Unified Distributed-Arithmetic execution engine (backend registry + dispatch).

One entry point per level::

    y = da_matmul(x, packed)          # float in → float out
    acc = da_vmm(xq, packed)          # integer codes → exact int32

``PackedWeights`` is the frozen-weight artifact (int8 codes + per-column
scale + optional weight-sum LUTs), built once by :func:`pack_weights`.  The
backends carry the reference's names and capability specs, so a plan
written for it resolves here:

===================  ==========  ===========================================
name                 needs LUTs  execution
===================  ==========  ===========================================
``lut``              yes         faithful PMA readout: LUT gather +
                                 shift-and-add (plain torch on the CPU; the
                                 LUT-readout kernel on CUDA)
``onehot``           yes         one-hot(addr) @ LUT in one product (plain
                                 torch on the CPU; the LUT-readout kernel on
                                 CUDA)
``pallas_lut``       yes         the hand-written LUT-readout kernel on CUDA
                                 (``kernels/csrc/da_vmm.cu``); its plain
                                 version on the CPU
``bitplane``         no          Σ_b 2^b · (xbit_b @ W), serial planes
                                 (plain torch on the CPU; the bit-plane
                                 kernel on CUDA)
``bitplane_stacked`` no          planes stacked on a leading axis: one
                                 product (plain torch on the CPU; the
                                 bit-plane kernel on CUDA)
``pallas_bitplane``  no          the hand-written bit-plane kernel on CUDA
                                 (``kernels/csrc/bitplane_vmm.cu``); its plain
                                 version on the CPU
``int8``             no          int8×int8 → int32 baseline matmul (not
                                 multiplier-free, never auto-picked):
                                 ``torch._int_mm`` on CUDA (operands padded;
                                 the weights laid out column-major once per
                                 pack), an exact int64 product on the CPU
===================  ==========  ===========================================

Every DA mode is bit-exact, so on CUDA the three LUT modes all run the
LUT-readout kernel and the three storage-free modes the bit-plane kernel: an
artifact keeps its mode names, and no registered DA mode runs a plain form
on the card.  The CPU keeps each mode's plain form.  On a stacked-expert
pack ([E, K, N]) each of those six modes runs its kernel once per pack
(``BackendSpec.experts_fn``, the expert on the kernel's grid, as the
reference's vmapped ``pallas_call``); ``int8`` and the CPU's plain forms
make one call per expert.  A mode whose
capabilities the artifact or config does not meet (a LUT mode without LUTs
or with tables of another group size, ``int8`` on unsigned codes) raises
instead of computing wrong integers.

``"auto"`` picks a backend per call from the ``(M, K, N, x_bits)`` shape, as
the reference does: :func:`shape_bucket` folds the shape into one of nine
buckets, and a measured cost table ranks the eligible DA backends of the
call's bucket; without a timing the heuristic reads the PMAs at decode-like
M ≤ 8 when LUTs exist (``lut``) and runs ``bitplane_stacked`` otherwise.
The port's table is its own: it is stamped with the framework and the
device it was timed on (:func:`device_stamp`, ``"torch:cuda:<card>"`` or
``"torch:cpu"``), lives at ``artifacts/torch/engine_autotune.json``
(override with ``REPRO_TORCH_ENGINE_AUTOTUNE``), and a table with another
stamp (the reference's, stamped ``"cpu"``, among them) is rejected.  An
absent table means the heuristic.  Every backend is exact, so a row
dispatched to ``lut`` at decode (M ≤ 8) and to ``bitplane_stacked`` at
verify (M = 16) gets the same int32 bits either way: shape-dependent
dispatch cannot make a row's result depend on the call it rides in.

``x_bits_eff`` (or the :func:`x_bits_override` context, read at call time)
evaluates only the top bit-planes of the activation codes against the same
weights: the truncated-bitplane draft pass of speculative decoding.
Dispatch sees the draft's bit count.

The paged-attention read has its own registry: ``gather`` (page-table gather
+ masked softmax in plain torch) and ``fused`` (the CUDA page-walk kernel,
``kernels/csrc/paged_attention.cu``, fp, int8 and int4 pages; its plain
version on the CPU).  Its ``auto`` reads the cost table's ``attn:*``
bucket of the read's shape, as the reference does, else the platform's
choice.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import warnings
import zlib
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.da import (
    MAX_GROUP_SIZE,
    DAConfig,
    build_luts,
    da_vmm_bitplane,
    da_vmm_bitplane_stacked,
    da_vmm_lut,
    da_vmm_onehot,
    num_groups,
    truncate_codes,
)
from repro_torch.core.quant import quantize_acts_signed, quantize_weights

# ---------------------------------------------------------------------------
# PackedWeights
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedWeights:
    """Frozen DA linear weights: the PMA contents for one weight matrix.

    wq:      [K, N] int8 codes (rows may be strided: q/k/v codes of one layer
             share a buffer so the fused projection reads them in one pass),
             or [E, K, N] for stacked experts (MoE), one PMA set per expert.
    w_scale: [1, N] per-output-column float32 scale ([E, 1, N] stacked).
    luts:    [G, 2^L, N] int32 weight-sum tables from build_luts
             ([E, G, 2^L, N] stacked), or None.
    cfg:     DAConfig the artifact was packed under.
    mode:    default execution mode for ``packed(x)`` ("auto" → dispatch).
    int8_operand: ``torch._int_mm``'s weight operand (:func:`int_mm_weights`),
             laid out by the first ``int8`` call on CUDA and kept.
    """

    wq: torch.Tensor
    w_scale: torch.Tensor
    luts: Optional[torch.Tensor]
    cfg: DAConfig
    mode: str = "auto"
    int8_operand: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _experts: Optional[Tuple["PackedWeights", ...]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _block: Optional["PackedWeights"] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def k(self) -> int:
        return self.wq.shape[-2]

    @property
    def n(self) -> int:
        return self.wq.shape[-1]

    @property
    def has_luts(self) -> bool:
        return self.luts is not None

    def experts(self) -> Tuple["PackedWeights", ...]:
        """The 2-D pack of each expert of a stacked [E, K, N] pack: views of
        its codes, scales and LUTs, built on the first call and kept (an
        ``int8`` call lays out each expert's operand once, too)."""
        if self.wq.ndim != 3:
            raise ValueError(f"experts() of a {self.wq.ndim}-D pack; stacked "
                             "experts are [E, K, N]")
        if self._experts is None:
            object.__setattr__(self, "_experts", tuple(
                PackedWeights(wq=self.wq[e], w_scale=self.w_scale[e],
                              luts=None if self.luts is None else self.luts[e],
                              cfg=self.cfg, mode=self.mode)
                for e in range(self.wq.shape[0])))
        return self._experts

    def block(self, placements_) -> "PackedWeights":
        """This rank's block of a pack placed on a mesh: its codes and
        scales under ``placements_`` (built on the first call and kept, so
        an ``int8`` call lays out the block's operand once)."""
        if self._block is None:
            mesh = self.wq.device_mesh
            w_pl = [Shard(self.w_scale.ndim - 1) if p == Shard(self.wq.ndim - 1)
                    else p for p in placements_]
            object.__setattr__(self, "_block", PackedWeights(
                wq=self.wq.redistribute(mesh, placements_).to_local(),
                w_scale=self.w_scale.redistribute(mesh, w_pl).to_local(),
                luts=None, cfg=self.cfg, mode=self.mode))
        return self._block

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return da_matmul(x, self)


def lut_cells(k: int, n: int, group_size: int) -> int:
    """Memory cells a materialized LUT costs (the 2^L/L× blow-up, Table I)."""
    return num_groups(k, group_size) * (1 << group_size) * n


#: Default LUT budget in cells per matrix (the reference's constant), shared
#: by the freeze planner and the cost-table timing: at group size 8 one
#: weight costs 32 cells, so 2^24 cells (64 MB of int32) admit layers up to
#: about 512K weights.
DEFAULT_LUT_LIMIT = 1 << 24


def pack_weights(w: torch.Tensor, cfg: DAConfig = DAConfig(x_signed=True),
                 mode: str = "auto", lut_cell_limit: int = DEFAULT_LUT_LIMIT,
                 with_luts: Optional[bool] = None) -> PackedWeights:
    """Pre-VMM procedure (§III-A): quantize once, sum weights, 'write the PMAs'.

    Float weights [K, N], or stacked experts [E, K, N], → per-column int8
    codes and float32 scales (per expert).
    LUTs are built once, here: when ``mode`` names a LUT backend, or under
    ``mode="auto"`` when the blow-up stays within ``lut_cell_limit`` cells
    (``lut_cells``, not weights).  ``with_luts`` (when not None) overrides
    that decision: the planner (:mod:`repro_torch.core.freeze`) decides
    lut-or-not per layer and passes its verdict down here.
    """
    mode = canonical_mode(mode)
    if w.ndim not in (2, 3):
        raise ValueError(f"pack_weights takes [K, N] or stacked experts "
                         f"[E, K, N], got {tuple(w.shape)}")
    if with_luts is None:
        if mode == "auto":
            with_luts = lut_cells(*w.shape[-2:], cfg.group_size) <= lut_cell_limit
        else:
            with_luts = get_backend(mode).needs_luts
    if w.ndim == 3:
        return _pack_experts(w, cfg, mode, with_luts)
    q = quantize_weights(w, bits=8, axis=0)
    luts = build_luts(q.q, cfg.group_size) if with_luts else None
    return PackedWeights(wq=q.q.to(torch.int8), w_scale=q.scale, luts=luts,
                         cfg=cfg, mode=mode)


def _pack_experts(w: torch.Tensor, cfg: DAConfig, mode: str,
                  with_luts: bool) -> PackedWeights:
    """Stacked experts [E, K, N], quantized along K and tabled expert by
    expert (the reference quantizes the stack along ``axis=-2`` in one go:
    the same per-expert, per-column scales; one expert at a time bounds
    the quantize temporaries to one expert's size)."""
    e, k, n = w.shape
    wq = torch.empty((e, k, n), dtype=torch.int8, device=w.device)
    scale = torch.empty((e, 1, n), dtype=torch.float32, device=w.device)
    luts = None
    for i in range(e):
        q = quantize_weights(w[i], bits=8, axis=0)
        wq[i] = q.q
        scale[i] = q.scale
        if with_luts:
            table = build_luts(q.q, cfg.group_size)
            if luts is None:
                luts = torch.empty((e,) + tuple(table.shape), dtype=table.dtype,
                                   device=w.device)
            luts[i] = table
    return PackedWeights(wq=wq, w_scale=scale, luts=luts, cfg=cfg, mode=mode)


def pack_quantized(wq, w_scale=1.0, cfg: DAConfig = DAConfig(),
                   mode: str = "auto", with_luts: bool = True) -> PackedWeights:
    """Wrap already-integer weight codes [K, N] as a PackedWeights artifact
    (codes kept in their dtype; scale float32)."""
    mode = canonical_mode(mode)
    wq = torch.as_tensor(wq)
    luts = build_luts(wq.to(torch.int32), cfg.group_size) if with_luts else None
    return PackedWeights(
        wq=wq, w_scale=torch.as_tensor(w_scale, dtype=torch.float32,
                                       device=wq.device),
        luts=luts, cfg=cfg, mode=mode)


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Capability spec + implementation of one DA execution mode.

    fn:             (xq int32 [M,K], packed, cfg) → int32 [M,N] == xq @ wq.
    experts_fn:     the same over a stacked-expert pack, (xq int32 [E,M,K],
                    packed [E,K,N], cfg) → int32 [E,M,N]: one kernel call
                    per pack where the mode runs a kernel; None → one ``fn``
                    call per expert (:meth:`PackedWeights.experts`).
    needs_luts:     reads materialized weight-sum LUTs from the artifact.
    is_da:          multiplier-free DA datapath (``auto`` only considers
                    these; baselines such as int8 are requested explicitly).
    signed_only:    requires two's-complement activation codes.

    Every backend zero-pads K to whole groups and addresses at most
    ``MAX_GROUP_SIZE`` rows per group.
    """

    name: str
    fn: Callable[[torch.Tensor, PackedWeights, DAConfig], torch.Tensor]
    description: str = ""
    experts_fn: Optional[Callable[[torch.Tensor, PackedWeights, DAConfig],
                                  torch.Tensor]] = None
    needs_luts: bool = False
    is_da: bool = True
    signed_only: bool = False

    def supports(self, cfg: DAConfig, has_luts: bool) -> bool:
        """Is this backend eligible for an artifact packed under ``cfg``?"""
        return ((has_luts or not self.needs_luts)
                and (cfg.x_signed or not self.signed_only)
                and cfg.group_size <= MAX_GROUP_SIZE)


_REGISTRY: Dict[str, BackendSpec] = {}

#: Legacy / call-site spellings → canonical registry names.
MODE_ALIASES = {
    "da_lut": "lut",
    "da_onehot": "onehot",
    "da_bitplane": "bitplane",
    "da_bitplane_stacked": "bitplane_stacked",
    "stacked": "bitplane_stacked",
    "pallas": "pallas_lut",
}


def canonical_mode(mode: str) -> str:
    return MODE_ALIASES.get(mode, mode)


def register_backend(name: str, **caps):
    """Decorator: register ``fn(xq, packed, cfg) → int32`` under ``name``."""

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(f"backend {name!r} already registered")
        _REGISTRY[name] = BackendSpec(name=name, fn=fn, **caps)
        return fn

    return deco


def registered_backends() -> Dict[str, BackendSpec]:
    return dict(_REGISTRY)


#: The reference's registry version: bumped with it when a backend's
#: implementation changes without a rename (invalidates every cost table).
REGISTRY_VERSION = 1


def registry_fingerprint() -> str:
    """crc32 of the registered backend names and the version, the stamp of
    artifact manifests and cost tables (equal to the reference's for the
    same backends)."""
    blob = f"v{REGISTRY_VERSION}:" + ",".join(sorted(_REGISTRY))
    return f"{zlib.crc32(blob.encode()):08x}"


def get_backend(mode: str) -> BackendSpec:
    name = canonical_mode(mode)
    if name not in _REGISTRY:
        raise ValueError(f"unknown DA mode {mode!r}; registered backends: "
                         f"{', '.join(sorted(_REGISTRY))} (plus 'auto' for "
                         "shape-based dispatch)")
    return _REGISTRY[name]


@register_backend(
    "lut", needs_luts=True,
    description="faithful PMA readout: LUT gather + bit-serial shift-and-add "
                "(the LUT-readout kernel on CUDA)")
def _lut_backend(xq, packed, cfg):
    if xq.device.type == "cuda":
        return _kernel_lut_backend(xq, packed, cfg)
    return da_vmm_lut(xq, packed.luts, cfg)


@register_backend(
    "onehot", needs_luts=True,
    description="address decoder as one-hot; LUT readout in one product "
                "(the LUT-readout kernel on CUDA)")
def _onehot_backend(xq, packed, cfg):
    if xq.device.type == "cuda":
        return _kernel_lut_backend(xq, packed, cfg)
    return da_vmm_onehot(xq, packed.luts, cfg)


@register_backend(
    "pallas_lut", needs_luts=True,
    description="hand-written LUT-readout kernel (plain version on CPU)")
def _kernel_lut_backend(xq, packed, cfg):
    from repro_torch.kernels.ops import da_vmm as kernel_da_vmm

    return kernel_da_vmm(xq, packed.luts, cfg)


@register_backend("bitplane",
                  description="storage-free serial DA: Σ_b 2^b · (xbit_b @ W)")
def _bitplane_backend(xq, packed, cfg):
    if xq.device.type == "cuda":
        return _kernel_bitplane_backend(xq, packed, cfg)
    return da_vmm_bitplane(xq, packed.wq, cfg)


@register_backend("bitplane_stacked",
                  description="bit-planes stacked on a leading axis: one product")
def _stacked_backend(xq, packed, cfg):
    if xq.device.type == "cuda":
        return _kernel_bitplane_backend(xq, packed, cfg)
    return da_vmm_bitplane_stacked(xq, packed.wq, cfg)


@register_backend("pallas_bitplane",
                  description="hand-written bit-plane kernel (plain version on CPU)")
def _kernel_bitplane_backend(xq, packed, cfg):
    from repro_torch.kernels.ops import bitplane_vmm

    return bitplane_vmm(xq, _int8_codes(xq, packed.wq), cfg)


def _int8_codes(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The weight codes as the bit-plane kernel reads them on CUDA: int8.
    :func:`pack_quantized` keeps the caller's dtype (int32 codes of int8
    range, e.g. ``quantize_weights(w).q``), as the reference does; the
    plain versions on the CPU take them as they are."""
    if xq.device.type != "cuda" or wq.dtype == torch.int8:
        return wq
    return wq.to(torch.int8)


def _each_expert(fn, xq, packed, cfg):
    """``fn`` once per expert of a stacked pack: expert e's rows ``xq[e]``
    against its 2-D pack."""
    return torch.stack([fn(xq[i], pe, cfg) for i, pe in enumerate(packed.experts())])


def _kernel_lut_experts(xq, packed, cfg):
    from repro_torch.kernels.ops import da_vmm_experts

    return da_vmm_experts(xq, packed.luts, cfg)


def _kernel_bitplane_experts(xq, packed, cfg):
    from repro_torch.kernels.ops import bitplane_vmm_experts

    return bitplane_vmm_experts(xq, _int8_codes(xq, packed.wq), cfg)


def _batched(kernel_experts, plain=None):
    """A kernel mode's form over stacked experts: the kernel's batched entry
    (one call per pack: the kernel on CUDA, its plain version on the CPU);
    a mode with a plain torch form of its own (``plain``) runs that once per
    expert on the CPU, as it runs it for one matrix."""
    def run(xq, packed, cfg):
        if plain is not None and xq.device.type != "cuda":
            return _each_expert(plain, xq, packed, cfg)
        return kernel_experts(xq, packed, cfg)

    return run


for _name, _kernel, _plain in (
        ("lut", _kernel_lut_experts, _lut_backend),
        ("onehot", _kernel_lut_experts, _onehot_backend),
        ("pallas_lut", _kernel_lut_experts, None),
        ("bitplane", _kernel_bitplane_experts, _bitplane_backend),
        ("bitplane_stacked", _kernel_bitplane_experts, _stacked_backend),
        ("pallas_bitplane", _kernel_bitplane_experts, None)):
    _REGISTRY[_name] = dataclasses.replace(_REGISTRY[_name],
                                           experts_fn=_batched(_kernel, _plain))
del _name, _kernel, _plain


def backend_fn(spec: BackendSpec, packed: PackedWeights, experts: bool = False):
    """The function that runs ``spec`` on ``packed``: its own ``fn`` (or
    ``experts_fn``), or, for a pack placed on a mesh, the kernel op of its
    family — the LUT readout for a LUT mode, the bit-plane VMM for a
    storage-free one.  The ops carry DTensor sharding rules
    (:mod:`repro_torch.kernels.ops`): each rank runs the kernel (its plain
    version on the CPU) on its own column slice, and every mode gives the
    same exact integers.  ``int8`` on a mesh runs its product on each
    rank's block alike (:func:`_int8_on_mesh`); another baseline has no
    rule and raises."""
    if isinstance(packed.wq, DTensor):  # placed by shard_frozen_params
        if spec.name == "int8":
            return functools.partial(_int8_on_mesh, experts=experts)
        if not spec.is_da:
            raise ValueError(f"backend {spec.name!r} has no sharding rule; a "
                             "pack placed on a mesh runs a DA mode")
        if spec.needs_luts:
            return _kernel_lut_experts if experts else _kernel_lut_backend
        return _kernel_bitplane_experts if experts else _kernel_bitplane_backend
    if experts:
        return spec.experts_fn or functools.partial(_each_expert, spec.fn)
    return spec.fn


#: torch._int_mm's shape rule on CUDA: M above 16, K and N multiples of 8
_INT_MM_MIN_M, _INT_MM_ALIGN = 17, 8


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


def _round_up(v: int) -> int:
    return -(-v // _INT_MM_ALIGN) * _INT_MM_ALIGN


def int_mm_weights(wq: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm``'s weight operand for ``xq @ wq`` on CUDA: the codes
    as int8, zero-padded to K and N multiples of 8 (zero rows and columns
    add nothing to a dot product), column-major, the one layout cuBLASLt's
    int8 product takes at every shape (row-major weights are refused at
    some, e.g. K=64, N=128).  [K', N']."""
    k, n = wq.shape
    return _pad_to(wq.to(torch.int8), _round_up(k), _round_up(n)).t().contiguous().t()


def int_mm_acts(xq: torch.Tensor, k_padded: int) -> torch.Tensor:
    """The activation operand: int8 codes zero-padded to M > 16 rows and
    ``k_padded`` columns.  [M', K']."""
    return _pad_to(xq.to(torch.int8), max(xq.shape[0], _INT_MM_MIN_M), k_padded)


@register_backend(
    "int8", is_da=False, signed_only=True,
    description="int8×int8 reference matmul (quantization baseline, not DA)")
def _int8_backend(xq, packed, cfg):
    if xq.device.type != "cuda":
        return (xq.to(torch.int8).to(torch.int64)
                @ packed.wq.to(torch.int8).to(torch.int64)).to(torch.int32)
    w8 = packed.int8_operand
    if w8 is None:  # laid out once per pack, not per call
        w8 = int_mm_weights(packed.wq)
        object.__setattr__(packed, "int8_operand", w8)
    return torch._int_mm(int_mm_acts(xq, w8.shape[0]), w8)[:xq.shape[0], :packed.n]


def _int8_on_mesh(xq: torch.Tensor, packed: PackedWeights, cfg: DAConfig,
                  experts: bool = False) -> DTensor:
    """The ``int8`` product of a pack placed on a mesh, as GSPMD splits the
    reference's plain product: on a mesh dim where the codes are split by
    columns (N) the activations' codes are whole and the product is split
    by columns; where they are split by rows (K, a row-parallel layer) the
    activations' codes are split alike and the int32 partial sums are
    added up (exact); where the stacked experts are split (E), both are;
    elsewhere the activations keep their block of rows and the codes are
    whole.  Each rank multiplies its own block (:func:`_int8_backend`, its
    operand laid out from that block once: :meth:`PackedWeights.block`)."""
    w = packed.wq
    mesh, nd = w.device_mesh, w.ndim
    rows = nd - 2                       # the rows' dim of xq ([E,] M, K)
    if not isinstance(xq, DTensor):
        xq = DTensor.from_local(xq, mesh, [Replicate()] * mesh.ndim,
                                run_check=False)
    w_pl, x_pl, out_pl = [], [], []
    for wp, xp in zip(w.placements, xq.placements):
        if wp in (Shard(nd - 1), Shard(nd - 2)) or (experts and wp == Shard(0)):
            w_pl.append(wp)
            x_pl.append(Shard(nd - 1) if wp == Shard(nd - 2)
                        else Shard(0) if wp == Shard(0) else Replicate())
            out_pl.append(Partial() if wp == Shard(nd - 2) else wp)
        else:
            w_pl.append(Replicate())
            x_pl.append(xp if xp == Shard(rows) else Replicate())
            out_pl.append(x_pl[-1])
    block = packed.block(w_pl)
    run = (functools.partial(_each_expert, _int8_backend) if experts
           else _int8_backend)
    acc = run(xq.redistribute(mesh, x_pl).to_local(), block, cfg)
    shape = torch.Size(tuple(xq.shape[:-1]) + (w.shape[-1],))
    acc = DTensor.from_local(acc, mesh, out_pl, run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta").stride())
    if Partial() in out_pl:             # the row-parallel sum, in int32
        acc = acc.redistribute(mesh, [Replicate() if p == Partial() else p
                                      for p in out_pl])
    return acc


#: the one name a cost table times per kernel on CUDA, where the three LUT
#: modes all run the LUT-readout kernel and the three storage-free modes the
#: bit-plane kernel (timing the aliases would rank one kernel against itself)
_CUDA_TIMED_DA = ("lut", "bitplane_stacked")


def timeable_backends(cfg: DAConfig, has_luts: bool,
                      include_baselines: bool = False, device="cuda"):
    """Backends worth timing on ``device``: capability-eligible, DA-only
    unless baselines are requested; on CUDA one name per kernel
    (``_CUDA_TIMED_DA``), off CUDA every DA name but the ``pallas_*`` ones
    (there they are the plain versions, as the reference skips its
    interpret-mode kernels off the TPU)."""
    on_cuda = torch.device(device).type == "cuda"
    for name, spec in sorted(_REGISTRY.items()):
        if not spec.supports(cfg, has_luts):
            continue
        if not (spec.is_da or include_baselines):
            continue
        if spec.is_da and (name not in _CUDA_TIMED_DA if on_cuda
                           else name.startswith("pallas")):
            continue
        yield spec


# ---------------------------------------------------------------------------
# Shape buckets + measured cost table (the "auto" policy)
# ---------------------------------------------------------------------------

_M_EDGES: Tuple[Tuple[int, str], ...] = ((8, "dec"), (256, "mid"))
_KN_EDGES: Tuple[Tuple[int, str], ...] = ((1 << 14, "s"), (1 << 20, "m"))

#: One representative (M, K, N) per (m-bucket, kn-bucket) cell (the
#: reference's): what a cost table times and what the dispatch tests probe.
BUCKET_SHAPES: Dict[str, Tuple[int, int, int]] = {
    "dec:s": (4, 64, 128),
    "dec:m": (4, 512, 1024),
    "dec:l": (4, 2048, 2048),
    "mid:s": (64, 64, 128),
    "mid:m": (64, 512, 1024),
    "mid:l": (64, 2048, 2048),
    "big:s": (512, 64, 128),
    "big:m": (512, 512, 1024),
    "big:l": (512, 2048, 2048),
}


def shape_bucket(m: int, k: int, n: int, x_bits: int) -> str:
    """Fold (M, K, N, x_bits) into a coarse cost-table key: M decode-like
    (≤8) / mid (≤256) / big; K·N small (≤2^14) / mid (≤2^20) / large;
    x_bits exact."""
    mb = next((tag for edge, tag in _M_EDGES if m <= edge), "big")
    kb = next((tag for edge, tag in _KN_EDGES if k * n <= edge), "l")
    return f"{mb}:{kb}:b{x_bits}"


#: environment variable naming the port's cost table (the reference's is
#: ``REPRO_ENGINE_AUTOTUNE``)
AUTOTUNE_ENV = "REPRO_TORCH_ENGINE_AUTOTUNE"


def default_cache_path() -> pathlib.Path:
    env = os.environ.get(AUTOTUNE_ENV)
    if env:
        return pathlib.Path(env)
    return (pathlib.Path(__file__).resolve().parents[3]
            / "artifacts" / "torch" / "engine_autotune.json")


def device_stamp(device=None) -> str:
    """The stamp of a cost table timed on ``device``: ``"torch:cpu"`` or
    ``"torch:cuda:<card name>"``; None → this process's device (the card
    when one is present)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"torch:cuda:{torch.cuda.get_device_name(dev)}"
    return f"torch:{dev.type}"


_COST_TABLE: Optional[Dict[str, Dict[str, float]]] = None  # None → not loaded


def load_cost_table(path: Optional[os.PathLike] = None) -> Dict[str, Dict[str, float]]:
    """Lazily load the cost table: {bucket: {backend: µs}}.

    Missing or unreadable tables degrade to the heuristic.  A table whose
    ``device`` stamp is not :func:`device_stamp`'s is rejected (timed on
    other hardware or by the reference), one stamped against another
    backend registry is ignored with a warning, and unregistered backend
    names are dropped with a warning.  Only default-path loads install the
    process-wide table that ``auto`` reads; an explicit ``path`` is read
    only (install it with :func:`set_cost_table`).
    """
    global _COST_TABLE
    if _COST_TABLE is not None and path is None:
        return _COST_TABLE
    p = pathlib.Path(path) if path is not None else default_cache_path()
    table: Dict[str, Dict[str, float]] = {}
    unknown: set = set()
    try:
        raw = json.loads(p.read_text())
        entries = raw.get("table", raw)
        device = raw.get("device") if isinstance(raw, dict) else None
        if device is not None and device != device_stamp():
            entries = {}  # timed on other hardware: fall back to heuristic
        stamp = raw.get("registry") if isinstance(raw, dict) else None
        if stamp is not None and stamp != registry_fingerprint():
            warnings.warn(
                f"autotune cache {p} was tuned against a different backend "
                f"registry (stamp {stamp!r} != {registry_fingerprint()!r}); "
                "ignoring it — time the backends again", stacklevel=2)
            entries = {}
        for bucket, costs in entries.items():
            if isinstance(costs, dict):
                # "attn:*" buckets rank attention reads, the rest DA backends
                reg = _ATTN_REGISTRY if bucket.startswith("attn:") else _REGISTRY
                unknown.update(b for b in costs if b not in reg)
                table[bucket] = {b: float(us) for b, us in costs.items()
                                 if b in reg and isinstance(us, (int, float))}
        if unknown:
            warnings.warn(
                f"autotune cache {p} names unregistered backends "
                f"{sorted(unknown)}; their timings are dropped (heuristic "
                "fallback where no eligible backend was timed)", stacklevel=2)
    except (OSError, ValueError, AttributeError):
        table = {}
    if path is None:
        _COST_TABLE = table
    return table


def set_cost_table(table: Optional[Dict[str, Dict[str, float]]]) -> None:
    """Install a cost table in-process; None → reload lazily."""
    global _COST_TABLE
    _COST_TABLE = dict(table) if table is not None else None
    _BUCKET_MISS_WARNED.clear()  # a new table resets the warn-once dedup


#: (bucket, fallback backend) pairs already warned about: the bucket-miss
#: diagnostic fires once per pair per process, not once per call.
_BUCKET_MISS_WARNED: set = set()


def select_backend(m: int, k: int, n: int, cfg: DAConfig,
                   has_luts: bool = True) -> str:
    """The ``"auto"`` policy: the cheapest measured eligible DA backend,
    else the heuristic.  Always a registered, eligible name."""
    eligible = [s for s in _REGISTRY.values()
                if s.is_da and s.supports(cfg, has_luts)]
    if not eligible:  # unreachable with the built-in backends
        raise ValueError(f"no DA backend supports cfg={cfg} has_luts={has_luts}")
    table = load_cost_table()
    bucket = shape_bucket(m, k, n, cfg.x_bits)
    costs = table.get(bucket, {})
    timed = [s for s in eligible if s.name in costs]
    if timed:
        return min(timed, key=lambda s: costs[s.name]).name
    choice = _fallback_backend(m, cfg, has_luts, eligible)
    if table and (bucket, choice) not in _BUCKET_MISS_WARNED:
        _BUCKET_MISS_WARNED.add((bucket, choice))
        warnings.warn(
            f"autotune cache has no timings for bucket {bucket!r} (eligible: "
            f"{', '.join(sorted(s.name for s in eligible))}); using the "
            f"heuristic fallback {choice!r} (warned once per bucket/backend)",
            stacklevel=2)
    return choice


def _fallback_backend(m, cfg, has_luts, eligible) -> str:
    """No measurement: decode-like shapes read the PMAs, everything else
    runs the one-product stacked bit-plane form."""
    names = {s.name for s in eligible}
    if has_luts and m <= 8 and "lut" in names:
        return "lut"
    if "bitplane_stacked" in names:
        return "bitplane_stacked"
    return sorted(names)[0]


# ---------------------------------------------------------------------------
# Execution entry points
# ---------------------------------------------------------------------------


#: Process-wide draft precision (see :func:`x_bits_override`); None → full.
_X_BITS_EFF: Optional[int] = None


@contextlib.contextmanager
def x_bits_override(x_bits_eff: Optional[int]):
    """Partial-precision context (the DA-native draft pass): inside it every
    :func:`da_vmm` / :func:`da_matmul` / :func:`da_qkv_matmul` call that
    passes no ``x_bits_eff`` evaluates only the top ``x_bits_eff`` bit-planes
    of its activations against the same packed weights.  Read at call time;
    ``None`` restores full precision."""
    global _X_BITS_EFF
    prev = _X_BITS_EFF
    _X_BITS_EFF = x_bits_eff
    try:
        yield
    finally:
        _X_BITS_EFF = prev


def effective_x_bits(cfg: DAConfig, x_bits_eff: Optional[int]) -> int:
    """Resolve a call-site ``x_bits_eff`` against the override context and
    the packed config (capped at ``cfg.x_bits``; below 1 raises)."""
    eff = x_bits_eff if x_bits_eff is not None else _X_BITS_EFF
    if eff is None:
        return cfg.x_bits
    eff = min(int(eff), cfg.x_bits)
    if eff < 1:
        raise ValueError(f"x_bits_eff={eff} must be >= 1")
    return eff


def _resolve_spec(mode: Optional[str], m: int, k: int, n: int, cfg: DAConfig,
                  has_luts: bool, default_mode: str) -> BackendSpec:
    """Resolve a call-site mode (None → the artifact's ``default_mode``;
    ``"auto"`` → :func:`select_backend` at this shape, even on an artifact
    packed with a concrete mode) and enforce the backend's capabilities, so
    a mismatch raises instead of computing wrong integers."""
    mode = canonical_mode(default_mode if mode is None else mode)
    if mode == "auto":
        return _REGISTRY[select_backend(m, k, n, cfg, has_luts)]
    spec = get_backend(mode)
    if not spec.supports(cfg, has_luts):
        why = ("reads materialized LUTs but the PackedWeights artifact has none"
               " — pack with a LUT mode or raise lut_cell_limit"
               if spec.needs_luts and not has_luts
               else "requires two's-complement (signed) activation codes"
               if spec.signed_only and not cfg.x_signed
               else f"supports group_size ≤ {MAX_GROUP_SIZE}, got "
               f"{cfg.group_size}")
        raise ValueError(f"backend {mode!r} {why}")
    return spec


def _check_lut_shape(spec: BackendSpec, packed: PackedWeights,
                     cfg: DAConfig) -> None:
    """A cfg whose group_size disagrees with the packed LUTs would address
    wrong rows: raise instead."""
    if spec.needs_luts and packed.luts.shape[-2] != 1 << cfg.group_size:
        raise ValueError(
            f"backend {spec.name!r}: LUTs were packed with "
            f"{packed.luts.shape[-2]} rows per PMA but cfg.group_size="
            f"{cfg.group_size} addresses {1 << cfg.group_size} — repack the "
            "weights or use the packed cfg")


def _rows(lead) -> int:
    m = 1
    for d in lead:
        m *= int(d)
    return m


def _truncated_acc(fn, xq: torch.Tensor, packed: PackedWeights,
                   cfg: DAConfig, eff: int) -> torch.Tensor:
    """The backend function ``fn`` on the top ``eff`` planes of ``xq``: the
    codes shifted right by ``drop``, the accumulator scaled back by
    ``2^drop``."""
    xs, rcfg, drop = truncate_codes(xq, cfg, eff)
    acc = fn(xs, packed, rcfg)
    return acc * (1 << drop) if drop else acc


def da_vmm(xq: torch.Tensor, packed: PackedWeights, mode: Optional[str] = None,
           cfg: Optional[DAConfig] = None,
           x_bits_eff: Optional[int] = None) -> torch.Tensor:
    """Integer-level entry: codes [.., K] → int32 [.., N] == xq @ wq.
    ``mode`` None → the artifact's default, ``"auto"`` → shape dispatch;
    ``cfg`` overrides the packed config (e.g. to flip x_signed);
    ``x_bits_eff`` (default: the :func:`x_bits_override` context, else
    full) keeps only the top planes."""
    cfg = cfg if cfg is not None else packed.cfg
    eff = effective_x_bits(cfg, x_bits_eff)
    ecfg = dataclasses.replace(cfg, x_bits=eff)  # dispatch sees draft cycles
    lead = xq.shape[:-1]
    spec = _resolve_spec(mode, _rows(lead), packed.k, packed.n, ecfg,
                         packed.has_luts, default_mode=packed.mode)
    _check_lut_shape(spec, packed, ecfg)
    acc = _truncated_acc(backend_fn(spec, packed),
                         xq.reshape(-1, xq.shape[-1]).to(torch.int32),
                         packed, cfg, eff)
    return acc.reshape(lead + (packed.n,))


def _whole_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its last dim (the contraction) gathered, when it is a
    DTensor sharded there (the attention output and the FFN's inner
    activations under tensor parallelism): the per-token quantization then
    reads whole rows on every rank, one gather of the activations where a
    sharded row would take an all-reduce of its amax and a gather of its
    codes.  Any other ``x`` as it is."""
    if not isinstance(x, DTensor):
        return x
    last = x.ndim - 1
    if not any(isinstance(p, Shard) and p.dim == last for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and p.dim == last else p
        for p in x.placements])


def da_matmul(x: torch.Tensor, weights: PackedWeights,
              cfg: Optional[DAConfig] = None, mode: Optional[str] = None,
              x_bits_eff: Optional[int] = None) -> torch.Tensor:
    """Float-level entry: quantize (signed, per token, in float32) → DA
    integer VMM (on the top ``x_bits_eff`` planes, see :func:`da_vmm`) →
    dequantize as ``acc.float() * x_scale * w_scale``."""
    cfg = cfg if cfg is not None else weights.cfg
    scfg = dataclasses.replace(cfg, x_signed=True)
    eff = effective_x_bits(scfg, x_bits_eff)
    rcfg = dataclasses.replace(scfg, x_bits=eff)  # dispatch sees draft cycles
    lead = x.shape[:-1]
    spec = _resolve_spec(mode, _rows(lead), weights.k, weights.n, rcfg,
                         weights.has_luts, default_mode=weights.mode)
    _check_lut_shape(spec, weights, rcfg)
    x2 = _whole_rows(x).reshape(-1, x.shape[-1]).to(torch.float32)
    xqt = quantize_acts_signed(x2, bits=scfg.x_bits)
    acc = _truncated_acc(backend_fn(spec, weights), xqt.q, weights, scfg, eff)
    y = acc.to(torch.float32) * xqt.scale * weights.w_scale
    return y.reshape(lead + (weights.n,))


def da_matmul_experts(x: torch.Tensor, weights: PackedWeights) -> torch.Tensor:
    """Stacked experts: x [.., E, C, K] float against an [E, K, N] pack →
    [.., E, C, N] float.  Each expert's rows (every group's, together: the
    reference's grid ``(G, E, ..)`` gives the same numbers, as quantization
    is per row) go through the backend's form over stacked experts, one
    call per pack (``BackendSpec.experts_fn``: one kernel launch on CUDA, as
    the reference's vmapped ``pallas_call`` puts the expert on its grid), or
    one call per expert where the mode has no such form (``int8``); the
    per-row quantization and the dequantization run once over all experts,
    so every output equals a :func:`da_matmul` of that expert's rows."""
    cfg = dataclasses.replace(weights.cfg, x_signed=True)
    eff = effective_x_bits(cfg, None)
    rcfg = dataclasses.replace(cfg, x_bits=eff)  # dispatch sees draft cycles
    lead, (e, c, k) = x.shape[:-3], x.shape[-3:]
    xe = _whole_rows(x).movedim(-3, 0).reshape(e, -1, k)   # [E, rows, K]
    spec = _resolve_spec(None, xe.shape[1], weights.k, weights.n, rcfg,
                         weights.has_luts, default_mode=weights.mode)
    _check_lut_shape(spec, weights, rcfg)
    xqt = quantize_acts_signed(xe.to(torch.float32), bits=cfg.x_bits)
    acc = _truncated_acc(backend_fn(spec, weights, experts=True), xqt.q,
                         weights, cfg, eff)
    y = acc.to(torch.float32) * xqt.scale * weights.w_scale  # [E, rows, N]
    return y.reshape((e,) + tuple(lead) + (c, weights.n)).movedim(0, -3)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """Weight application dispatching on the leaf type: a PackedWeights runs
    the multiplier-free datapath (cast back to x's dtype); a plain tensor is
    a float matmul.  Stacked experts ([E, K, N] against x [.., E, C, K],
    MoE's [E, C, K] or grouped [G, E, C, K]) apply each expert to its own
    rows (:func:`da_matmul_experts` for a stacked pack)."""
    if isinstance(w, PackedWeights):
        if w.wq.ndim == 3:
            return da_matmul_experts(x, w).to(x.dtype)
        return w(x).to(x.dtype)
    if w.ndim == 3:
        if isinstance(w, DTensor):
            return _expert_parallel(x, w)
        return torch.einsum("...ecd,edf->...ecf", x, w)
    if _row_sharded(w) and x.dtype in (torch.bfloat16, torch.float16):
        return _row_parallel(x, w)
    return x @ w


def _expert_parallel(x: torch.Tensor, w: DTensor) -> torch.Tensor:
    """Stacked experts ``w`` [E, K, N] placed on a mesh: each rank applies
    its own experts to their rows of ``x`` [.., E, C, K], the expert axis
    sharded alike on both; on the other mesh dims ``x`` keeps its block of
    a leading (group) dim or of the slots (C), the experts there gathered;
    every other dim is gathered.  The result is placed as ``x``'s block;
    the weights' gradient is a Partial sum over the mesh dims where ``x``
    keeps such a block (each rank's rows contribute their share)."""
    mesh, e_dim = w.device_mesh, x.ndim - 3
    on_e = [isinstance(p, Shard) and p.dim == 0 for p in w.placements]
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    xp = [Shard(e_dim) if e else p if isinstance(p, Shard) and p.dim != e_dim
          and p.dim < x.ndim - 1 else Replicate()
          for e, p in zip(on_e, x.placements)]
    wp = [Shard(0) if e else Replicate() for e in on_e]
    wgrad = [Partial() if not e and isinstance(p, Shard) else q
             for e, p, q in zip(on_e, xp, wp)]
    y = torch.einsum("...ecd,edf->...ecf", x.redistribute(mesh, xp).to_local(),
                     w.redistribute(mesh, wp).to_local(grad_placements=wgrad))
    return DTensor.from_local(y, mesh, xp, run_check=False)


def _row_sharded(w) -> bool:
    """Whether ``w`` is placed on a mesh with its rows (the contraction)
    sharded."""
    return isinstance(w, DTensor) and any(
        isinstance(p, Shard) and p.dim == 0 for p in w.placements)


def _row_parallel(x: torch.Tensor, w: DTensor) -> torch.Tensor:
    """``x @ w`` with ``w``'s rows sharded: each rank's partial product in
    float32, the partial sums reduced in float32, then rounded to ``x``'s
    dtype once, as one device's float32 accumulator rounds the whole sum
    once (16-bit partials would round each rank's share, then the sum)."""
    y = x.to(torch.float32) @ w.to(torch.float32)
    y = y.redistribute(y.device_mesh, [Replicate() if isinstance(p, Partial)
                                       else p for p in y.placements])
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Fused QKV projection — one DA pass over several PackedWeights
# ---------------------------------------------------------------------------


def _merged_codes(packs) -> torch.Tensor:
    """The packs' codes concatenated on N.  When they are adjacent column
    slices of one buffer (as :func:`repro_torch.core.freeze.freeze_model`
    lays q|k|v out) this is a view of that buffer, else a copy.  Packs
    placed on a mesh concatenate their local slices: the merged DTensor's
    rank-r block is [q_r | k_r | v_r] (:func:`_split_local` undoes it)."""
    ws = [p.wq for p in packs]
    if isinstance(ws[0], DTensor):
        local = torch.cat([w.to_local() for w in ws], dim=1)
        return DTensor.from_local(
            local, ws[0].device_mesh, ws[0].placements, run_check=False,
            shape=torch.Size((ws[0].shape[0], sum(w.shape[1] for w in ws))),
            stride=(sum(w.shape[1] for w in ws), 1))
    w0 = ws[0]
    adjacent = all(
        w.stride(1) == 1 and w.stride(0) == w0.stride(0)
        and torch._C._is_alias_of(w, w0)  # one storage (a fake one when traced)
        for w in ws)
    off = w0.storage_offset()
    for w in ws:
        adjacent = adjacent and w.storage_offset() == off
        off += w.shape[1]
    if adjacent:
        n = sum(w.shape[1] for w in ws)
        return w0.as_strided((w0.shape[0], n), (w0.stride(0), 1),
                             w0.storage_offset())
    return torch.cat(ws, dim=1)


def _mergeable(packs) -> bool:
    """Whether the packs' codes can run as one pass: all on one device, or
    all placed on one mesh alike."""
    ws = [p.wq for p in packs]
    if not isinstance(ws[0], DTensor):
        return not any(isinstance(w, DTensor) for w in ws)
    return all(isinstance(w, DTensor) and w.device_mesh == ws[0].device_mesh
               and w.placements == ws[0].placements for w in ws)


def _split_local(acc: DTensor, packs):
    """The merged pass's accumulator split back per pack on each rank's
    block (its local columns are [q_r | k_r | v_r])."""
    widths = [p.wq.to_local().shape[-1] for p in packs]
    parts = torch.split(acc.to_local(), widths, dim=-1)
    return tuple(DTensor.from_local(part, acc.device_mesh, acc.placements,
                                    run_check=False,
                                    shape=torch.Size(acc.shape[:-1] + (p.n,)),
                                    stride=(p.n, 1))
                 for part, p in zip(parts, packs))


def da_qkv_matmul(x: torch.Tensor, packs, cfg: Optional[DAConfig] = None,
                  mode: Optional[str] = None,
                  x_bits_eff: Optional[int] = None):
    """Fused multi-head projection: one DA pass over several PackedWeights.

    The activations are quantized once; when every matrix resolves to the
    same storage-free DA backend the VMMs run as ONE pass over the
    concatenated codes (one kernel launch on CUDA), then split; a LUT
    backend reads each pack's own tables, and ``int8`` each pack's own
    ``int8_operand``, one call per pack.  Each output column is an
    independent exact integer dot and dequantization is per column, so the
    outputs are bit-identical to separate :func:`da_matmul` calls, at any
    ``x_bits_eff`` (the shared codes are truncated once).
    """
    packs = tuple(packs)
    if not packs:
        raise ValueError("da_qkv_matmul needs at least one PackedWeights")
    base = cfg if cfg is not None else packs[0].cfg
    for p in packs:
        if not isinstance(p, PackedWeights) or p.wq.ndim != 2:
            raise ValueError("da_qkv_matmul fuses 2-D PackedWeights only")
        if cfg is None and p.cfg != base:
            raise ValueError("da_qkv_matmul: packs disagree on DAConfig — pass "
                             "cfg= to override")
        if p.k != packs[0].k:
            raise ValueError(f"da_qkv_matmul: contraction dims differ ({p.k} "
                             f"vs {packs[0].k})")
    scfg = dataclasses.replace(base, x_signed=True)
    eff = effective_x_bits(scfg, x_bits_eff)
    rcfg = dataclasses.replace(scfg, x_bits=eff)  # dispatch sees draft cycles
    lead = x.shape[:-1]
    specs = []
    for p in packs:
        spec = _resolve_spec(mode, _rows(lead), p.k, p.n, rcfg, p.has_luts,
                             default_mode=p.mode)
        _check_lut_shape(spec, p, rcfg)
        specs.append(spec)
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    xqt = quantize_acts_signed(x2, bits=scfg.x_bits)
    xs, rcfg, drop = truncate_codes(xqt.q, scfg, eff)
    if (len({s.name for s in specs}) == 1 and specs[0].is_da
            and not specs[0].needs_luts and _mergeable(packs)):
        merged = PackedWeights(wq=_merged_codes(packs), w_scale=packs[0].w_scale,
                               luts=None, cfg=rcfg, mode=specs[0].name)
        acc = backend_fn(specs[0], merged)(xs, merged, rcfg)
        accs = (_split_local(acc, packs) if isinstance(acc, DTensor)
                else torch.split(acc, [p.n for p in packs], dim=-1))
    else:
        accs = [backend_fn(s, p)(xs, p, rcfg) for s, p in zip(specs, packs)]
    return tuple(
        ((acc * (1 << drop) if drop else acc).to(torch.float32) * xqt.scale
         * p.w_scale).reshape(lead + (p.n,))
        for acc, p in zip(accs, packs))


# ---------------------------------------------------------------------------
# Paged-attention read backends
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnBackendSpec:
    """One execution of the paged-attention read: ``fn(q [B,T,H,hd], k_pool,
    v_pool [P,ps,kv,hd], page_table [B,W], tpos [B,T], *, softmax_dtype,
    mask_mode, k_scale=None, v_scale=None) → [B,T,H,hd]``."""

    name: str
    fn: Callable[..., torch.Tensor]
    description: str = ""


_ATTN_REGISTRY: Dict[str, AttnBackendSpec] = {}


def register_attn_backend(name: str, description: str = ""):
    def deco(fn):
        if name in _ATTN_REGISTRY:
            raise ValueError(f"attention backend {name!r} already registered")
        _ATTN_REGISTRY[name] = AttnBackendSpec(name=name, fn=fn,
                                               description=description)
        return fn

    return deco


def get_attn_backend(mode: str) -> AttnBackendSpec:
    if mode not in _ATTN_REGISTRY:
        raise ValueError(f"unknown paged-attention backend {mode!r}; "
                         f"registered: {', '.join(sorted(_ATTN_REGISTRY))} "
                         "(plus 'auto')")
    return _ATTN_REGISTRY[mode]


def attn_shape_bucket(batch: int, t: int, kv_len: int) -> str:
    """The cost table's key of a paged-attention read's shape, the
    reference's: ``attn:{dec|pre}:{s|m|l}``, decode-like steps (T ≤ 8:
    decode, and the draft / verify steps of speculative decoding) apart
    from prefill chunks, and the KV extent (table width · page size) in
    three bands of read volume."""
    phase = "dec" if t <= 8 else "pre"
    kb = "s" if kv_len <= 256 else ("m" if kv_len <= 2048 else "l")
    return f"attn:{phase}:{kb}"


def select_attn_backend(mode: Optional[str], device: torch.device, *,
                        batch: Optional[int] = None, t: Optional[int] = None,
                        kv_len: Optional[int] = None) -> str:
    """Resolve a ``cfg.paged_attn`` mode to a registered backend name.
    ``"auto"`` (or None) takes the fastest backend the cost table timed
    in the read's shape bucket (:func:`attn_shape_bucket`; a read given
    with its ``batch``, ``t`` and ``kv_len``), as the reference does; with
    no such entry, ``fused`` on CUDA and ``gather`` on the CPU."""
    if mode is not None and mode != "auto":
        return get_attn_backend(mode).name
    if None not in (batch, t, kv_len):
        timed = load_cost_table().get(attn_shape_bucket(batch, t, kv_len), {})
        timed = {n: c for n, c in timed.items() if n in _ATTN_REGISTRY}
        if timed:
            return min(timed, key=timed.get)
    return "fused" if device.type == "cuda" else "gather"


@register_attn_backend("gather",
                       "page-table gather to [B,S,kv,hd] + masked softmax")
def _gather_attn_backend(q, k_pool, v_pool, page_table, tpos, **kw):
    from repro_torch.models.attention import paged_gather_read

    return paged_gather_read(q, k_pool, v_pool, page_table, tpos, **kw)


@register_attn_backend("fused",
                       "CUDA page-walk kernel (plain version on CPU)")
def _fused_attn_backend(q, k_pool, v_pool, page_table, tpos, **kw):
    from repro_torch.kernels.ops import paged_attention

    return paged_attention(q, k_pool, v_pool, page_table, tpos, **kw)
