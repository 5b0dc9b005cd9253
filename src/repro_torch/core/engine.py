"""Unified Distributed-Arithmetic execution engine (backend registry + dispatch).

One entry point per level::

    y = da_matmul(x, packed)          # float in → float out
    acc = da_vmm(xq, packed)          # integer codes → exact int32

``PackedWeights`` is the frozen-weight artifact (int8 codes + per-column
scale + optional weight-sum LUTs), built once by :func:`pack_weights`.  The
backends carry the reference's names and whether they read LUTs, so a plan
written for it resolves here:

===================  ==========  ===========================================
name                 needs LUTs  execution
===================  ==========  ===========================================
``lut``              yes         faithful PMA readout: LUT gather +
                                 shift-and-add (plain torch)
``onehot``           yes         one-hot(addr) @ LUT in one product (plain)
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
===================  ==========  ===========================================

``"auto"`` resolves by device: ``pallas_bitplane`` on CUDA,
``bitplane_stacked`` on the CPU (the measured cost table arrives later).
A LUT mode on weights packed without LUTs (or with tables of another group
size) raises instead of computing wrong integers.  On CUDA the three
storage-free modes all run the bit-plane kernel, which is bit-exact, so an
artifact frozen with ``bitplane`` or ``bitplane_stacked`` keeps its mode
names and reads its codes once per call; on the CPU they keep their plain
float64 forms.

``x_bits_eff`` (or the :func:`x_bits_override` context, read at call time)
evaluates only the top bit-planes of the activation codes against the same
weights: the truncated-bitplane draft pass of speculative decoding.

The paged-attention read has its own registry: ``gather`` (page-table gather
+ masked softmax in plain torch) and ``fused`` (the CUDA page-walk kernel,
``kernels/csrc/paged_attention.cu``, fp, int8 and int4 pages; its plain
version on the CPU).
"""
from __future__ import annotations

import contextlib
import dataclasses
import zlib
from typing import Callable, Dict, Optional

import torch

from repro_torch.core.da import (
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
             share a buffer so the fused projection reads them in one pass).
    w_scale: [1, N] per-output-column float32 scale.
    luts:    [G, 2^L, N] int32 weight-sum tables from build_luts, or None.
    cfg:     DAConfig the artifact was packed under.
    mode:    default execution mode for ``packed(x)``.
    """

    wq: torch.Tensor
    w_scale: torch.Tensor
    luts: Optional[torch.Tensor]
    cfg: DAConfig
    mode: str = "auto"

    @property
    def k(self) -> int:
        return self.wq.shape[-2]

    @property
    def n(self) -> int:
        return self.wq.shape[-1]

    @property
    def has_luts(self) -> bool:
        return self.luts is not None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return da_matmul(x, self)


def lut_cells(k: int, n: int, group_size: int) -> int:
    """Memory cells a materialized LUT costs (the 2^L/L× blow-up, Table I)."""
    return num_groups(k, group_size) * (1 << group_size) * n


#: Default LUT budget in cells per matrix (the reference's constant): at
#: group size 8 one weight costs 32 cells, so 2^24 cells (64 MB of int32)
#: admit layers up to about 512K weights.
DEFAULT_LUT_LIMIT = 1 << 24


def pack_weights(w: torch.Tensor, cfg: DAConfig = DAConfig(x_signed=True),
                 mode: str = "auto") -> PackedWeights:
    """Pre-VMM procedure (§III-A): quantize once, sum weights, 'write the PMAs'.

    2-D float weights [K, N] → per-column int8 codes and float32 scales.
    LUTs are built once, here: when ``mode`` names a LUT backend, or under
    ``mode="auto"`` when the blow-up stays within ``DEFAULT_LUT_LIMIT`` cells.
    """
    mode = canonical_mode(mode)
    if w.ndim != 2:
        raise NotImplementedError(
            f"pack_weights: {w.ndim}-D weights (stacked experts) arrive with "
            "the MoE slice")
    if mode == "auto":
        with_luts = lut_cells(*w.shape, cfg.group_size) <= DEFAULT_LUT_LIMIT
    else:
        with_luts = get_backend(mode).needs_luts
    q = quantize_weights(w, bits=8, axis=0)
    luts = build_luts(q.q, cfg.group_size) if with_luts else None
    return PackedWeights(wq=q.q.to(torch.int8), w_scale=q.scale, luts=luts,
                         cfg=cfg, mode=mode)


# ---------------------------------------------------------------------------
# Backend registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """Capability spec + implementation of one DA execution mode.

    fn:         (xq int32 [M,K], packed, cfg) → int32 [M,N] == xq @ wq.
    needs_luts: reads materialized weight-sum LUTs from the artifact.
    """

    name: str
    fn: Callable[[torch.Tensor, PackedWeights, DAConfig], torch.Tensor]
    description: str = ""
    needs_luts: bool = False


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

#: Reference backends that arrive with later slices.
_NOT_YET = {"int8"}


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


def registry_fingerprint() -> str:
    """crc32 of the registered backend names, written into artifact
    manifests as the reference does (``v1:`` + sorted names)."""
    blob = "v1:" + ",".join(sorted(_REGISTRY))
    return f"{zlib.crc32(blob.encode()):08x}"


def get_backend(mode: str) -> BackendSpec:
    name = canonical_mode(mode)
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_YET:
        raise NotImplementedError(
            f"DA mode {mode!r} is not ported yet (the int8 baseline: ROADMAP "
            "Queue 1, 'Engine remainder')")
    raise ValueError(f"unknown DA mode {mode!r}; registered backends: "
                     f"{', '.join(sorted(_REGISTRY))} (plus 'auto')")


def resolve_backend(mode: str, device: torch.device) -> BackendSpec:
    """``"auto"`` → the device's backend; otherwise the named backend."""
    mode = canonical_mode(mode)
    if mode == "auto":
        mode = "pallas_bitplane" if device.type == "cuda" else "bitplane_stacked"
    return get_backend(mode)


def _resolve_spec(mode: Optional[str], packed: PackedWeights, cfg: DAConfig,
                  device: torch.device) -> BackendSpec:
    """Resolve a call-site mode (None → the artifact's default) and enforce
    the backend's capabilities, so a mismatch raises instead of computing
    wrong integers."""
    spec = resolve_backend(packed.mode if mode is None else mode, device)
    if spec.needs_luts and not packed.has_luts:
        raise ValueError(f"backend {spec.name!r} reads materialized LUTs but "
                         "the PackedWeights artifact has none — pack with a "
                         "LUT mode")
    if spec.needs_luts and packed.luts.shape[-2] != 1 << cfg.group_size:
        raise ValueError(
            f"backend {spec.name!r}: LUTs were packed with "
            f"{packed.luts.shape[-2]} rows per PMA but cfg.group_size="
            f"{cfg.group_size} addresses {1 << cfg.group_size} — repack the "
            "weights or use the packed cfg")
    return spec


@register_backend(
    "lut", needs_luts=True,
    description="faithful PMA readout: LUT gather + bit-serial shift-and-add")
def _lut_backend(xq, packed, cfg):
    return da_vmm_lut(xq, packed.luts, cfg)


@register_backend(
    "onehot", needs_luts=True,
    description="address decoder as one-hot; LUT readout in one product")
def _onehot_backend(xq, packed, cfg):
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

    return bitplane_vmm(xq, packed.wq, cfg)


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


def _truncated_acc(spec: BackendSpec, xq: torch.Tensor, packed: PackedWeights,
                   cfg: DAConfig, eff: int) -> torch.Tensor:
    """The backend on the top ``eff`` planes of ``xq``: the codes shifted
    right by ``drop``, the accumulator scaled back by ``2^drop``."""
    xs, rcfg, drop = truncate_codes(xq, cfg, eff)
    acc = spec.fn(xs, packed, rcfg)
    return acc * (1 << drop) if drop else acc


def da_vmm(xq: torch.Tensor, packed: PackedWeights, mode: Optional[str] = None,
           cfg: Optional[DAConfig] = None,
           x_bits_eff: Optional[int] = None) -> torch.Tensor:
    """Integer-level entry: codes [.., K] → int32 [.., N] == xq @ wq.
    ``mode`` None → the artifact's default; ``cfg`` overrides the packed
    config (e.g. to flip x_signed); ``x_bits_eff`` (default: the
    :func:`x_bits_override` context, else full) keeps only the top planes."""
    cfg = cfg if cfg is not None else packed.cfg
    eff = effective_x_bits(cfg, x_bits_eff)
    spec = _resolve_spec(mode, packed, cfg, xq.device)
    lead = xq.shape[:-1]
    acc = _truncated_acc(spec, xq.reshape(-1, xq.shape[-1]).to(torch.int32),
                         packed, cfg, eff)
    return acc.reshape(lead + (packed.n,))


def da_matmul(x: torch.Tensor, weights: PackedWeights,
              cfg: Optional[DAConfig] = None, mode: Optional[str] = None,
              x_bits_eff: Optional[int] = None) -> torch.Tensor:
    """Float-level entry: quantize (signed, per token, in float32) → DA
    integer VMM (on the top ``x_bits_eff`` planes, see :func:`da_vmm`) →
    dequantize as ``acc.float() * x_scale * w_scale``."""
    cfg = cfg if cfg is not None else weights.cfg
    scfg = dataclasses.replace(cfg, x_signed=True)
    eff = effective_x_bits(scfg, x_bits_eff)
    spec = _resolve_spec(mode, weights, scfg, x.device)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    xqt = quantize_acts_signed(x2, bits=scfg.x_bits)
    acc = _truncated_acc(spec, xqt.q, weights, scfg, eff)
    y = acc.to(torch.float32) * xqt.scale * weights.w_scale
    return y.reshape(lead + (weights.n,))


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """Weight application dispatching on the leaf type: a PackedWeights runs
    the multiplier-free datapath (cast back to x's dtype); a plain tensor is
    a float matmul."""
    if isinstance(w, PackedWeights):
        if w.wq.ndim != 2:
            raise NotImplementedError("stacked-expert PackedWeights arrive "
                                      "with the MoE slice")
        return w(x).to(x.dtype)
    return x @ w


# ---------------------------------------------------------------------------
# Fused QKV projection — one DA pass over several PackedWeights
# ---------------------------------------------------------------------------


def _merged_codes(packs) -> torch.Tensor:
    """The packs' codes concatenated on N.  When they are adjacent column
    slices of one buffer (as :func:`repro_torch.core.freeze.freeze_model`
    lays q|k|v out) this is a view of that buffer, else a copy."""
    ws = [p.wq for p in packs]
    w0 = ws[0]
    adjacent = all(
        w.stride(1) == 1 and w.stride(0) == w0.stride(0)
        and w.untyped_storage().data_ptr() == w0.untyped_storage().data_ptr()
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


def da_qkv_matmul(x: torch.Tensor, packs, cfg: Optional[DAConfig] = None,
                  mode: Optional[str] = None,
                  x_bits_eff: Optional[int] = None):
    """Fused multi-head projection: one DA pass over several PackedWeights.

    The activations are quantized once; when every matrix resolves to the
    same storage-free backend the VMMs run as ONE pass over the concatenated
    codes (one kernel launch on CUDA), then split; a LUT backend reads each
    pack's own tables, one call per pack.  Each output column is an
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
    specs = [_resolve_spec(mode, p, scfg, x.device) for p in packs]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    xqt = quantize_acts_signed(x2, bits=scfg.x_bits)
    xs, rcfg, drop = truncate_codes(xqt.q, scfg, eff)
    if len({s.name for s in specs}) == 1 and not specs[0].needs_luts:
        merged = PackedWeights(wq=_merged_codes(packs), w_scale=packs[0].w_scale,
                               luts=None, cfg=rcfg, mode=specs[0].name)
        accs = torch.split(specs[0].fn(xs, merged, rcfg),
                           [p.n for p in packs], dim=-1)
    else:
        accs = [s.fn(xs, p, rcfg) for s, p in zip(specs, packs)]
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


def select_attn_backend(mode: Optional[str], device: torch.device) -> str:
    """``"auto"`` (or None) → ``fused`` on CUDA, ``gather`` on the CPU."""
    if mode is None or mode == "auto":
        return "fused" if device.type == "cuda" else "gather"
    return get_attn_backend(mode).name


@register_attn_backend("gather",
                       "page-table gather to [B,S,kv,hd] + masked softmax")
def _gather_attn_backend(q, k_pool, v_pool, page_table, tpos, **kw):
    from repro_torch.models.attention import paged_gather_read

    return paged_gather_read(q, k_pool, v_pool, page_table, tpos, **kw)


@register_attn_backend("fused",
                       "CUDA page-walk kernel (plain version on CPU)")
def _fused_attn_backend(q, k_pool, v_pool, page_table, tpos, **kw):
    from repro_torch.kernels.paged_attention import paged_attention

    return paged_attention(q, k_pool, v_pool, page_table, tpos, **kw)
