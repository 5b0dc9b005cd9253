"""Public kernel entry points, each a custom op in the ``repro_torch``
namespace: ``repro_torch::bitplane_vmm`` and ``::bitplane_vmm_experts``,
``::da_vmm`` and ``::da_vmm_experts``, and ``::paged_attention``.

Each op has a CUDA implementation, the hand-written kernel's launch
(:mod:`repro_torch.kernels.bitplane_vmm`, ``da_vmm``, ``paged_attention``),
a CPU implementation, the kernel's plain version (:mod:`repro_torch.kernels.ref`,
:func:`repro_torch.models.attention.paged_gather_read`), and a fake function
that gives the output's shape and dtype.  The dispatcher picks the
implementation by the tensors' device: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, which launches or raises.  There is
no other path.  A trace (``make_fx``) records each call as one node of
its op, which :mod:`repro_torch.analysis` reads.

The ops are defined with ``torch.library.Library`` (def + impl): no
autograd wrapper sits between the dispatcher and the launch.  A
``DAConfig`` is not an op argument, so its fields travel as ints and bools.

Each op also has DTensor sharding rules (``register_sharding``), so a call
on tensors placed on a mesh runs the kernel on each rank's local blocks,
which DTensor hands it contiguous:

* the VMMs: the codes ``xq`` replicated and ``wq`` / ``luts`` sharded on
  their last dim (N) give an output sharded on N — the tensor-parallel
  DA linear, exact as the integers are; rows (``xq``'s M) sharded with the
  weights replicated give rows sharded; the experts' forms also shard on
  the expert axis;
* the attention read: q sharded on heads with the pools (and their
  scales) on kv-heads, the page table and ``tpos`` replicated, gives an
  output sharded on heads; or the batch rows sharded with the pools
  replicated.

Any call may also run fully replicated.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.da import DAConfig
from repro_torch.kernels import ref
from repro_torch.kernels.bitplane_vmm import bitplane_vmm_cuda, bitplane_vmm_experts_cuda
from repro_torch.kernels.da_vmm import da_vmm_cuda, da_vmm_experts_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda

#: the ops' namespace: ``torch.ops.repro_torch.<name>``
NAMESPACE = "repro_torch"
#: the op of each kernel entry
OP_NAMES = ("bitplane_vmm", "bitplane_vmm_experts", "da_vmm", "da_vmm_experts",
            "paged_attention")

_LIB = torch.library.Library(NAMESPACE, "DEF")
_VMM = "(Tensor xq, Tensor {w}, int group_size, int x_bits, bool x_signed) -> Tensor"
for _name, _w in (("bitplane_vmm", "wq"), ("bitplane_vmm_experts", "wq"),
                  ("da_vmm", "luts"), ("da_vmm_experts", "luts")):
    _LIB.define(_name + _VMM.format(w=_w))
_LIB.define("paged_attention(Tensor q, Tensor k_pool, Tensor v_pool, "
            "Tensor page_table, Tensor tpos, Tensor? k_scale, Tensor? v_scale, "
            "str softmax_dtype, str mask_mode) -> Tensor")
del _name, _w


def _cfg(group_size: int, x_bits: int, x_signed: bool) -> DAConfig:
    return DAConfig(group_size=group_size, x_bits=x_bits, x_signed=x_signed)


def _vmm_impls(name: str, cuda, plain) -> None:
    """Register the CUDA launch, the CPU plain version and the fake of one
    VMM op (output int32 ``[.., M, N]``, N the last dim of the weights)."""
    _LIB.impl(name, lambda xq, w, gs, bits, signed: cuda(
        xq.contiguous(), w, _cfg(gs, bits, signed)), "CUDA")
    PLAIN[name] = lambda xq, w, gs, bits, signed: plain(
        xq, w, _cfg(gs, bits, signed))
    _LIB.impl(name, PLAIN[name], "CPU")
    torch.library.register_fake(
        f"{NAMESPACE}::{name}",
        lambda xq, w, gs, bits, signed: xq.new_empty(
            tuple(xq.shape[:-1]) + (w.shape[-1],), dtype=torch.int32),
        lib=_LIB)


#: each op's plain version, taking the op's own arguments (the CPU
#: implementation; the static analysis traces it as the kernel's body)
PLAIN = {}
_vmm_impls("bitplane_vmm", bitplane_vmm_cuda, ref.bitplane_vmm_ref)
_vmm_impls("bitplane_vmm_experts", bitplane_vmm_experts_cuda, ref.bitplane_vmm_experts_ref)
_vmm_impls("da_vmm", da_vmm_cuda, ref.da_vmm_ref)
_vmm_impls("da_vmm_experts", da_vmm_experts_cuda, ref.da_vmm_experts_ref)


def _attention_plain(q, k_pool, v_pool, page_table, tpos, k_scale, v_scale,
                     softmax_dtype, mask_mode):
    from repro_torch.models.attention import paged_gather_read

    return paged_gather_read(q, k_pool, v_pool, page_table, tpos,
                             softmax_dtype=softmax_dtype, mask_mode=mask_mode,
                             k_scale=k_scale, v_scale=v_scale)


_LIB.impl("paged_attention", lambda q, k, v, table, tpos, ks, vs, sm, mask: (
    paged_attention_cuda(q, k, v, table, tpos, softmax_dtype=sm, mask_mode=mask,
                         k_scale=ks, v_scale=vs)), "CUDA")
PLAIN["paged_attention"] = _attention_plain
_LIB.impl("paged_attention", _attention_plain, "CPU")
torch.library.register_fake(f"{NAMESPACE}::paged_attention",
                            lambda q, *_: torch.empty_like(q), lib=_LIB)

_OPS = torch.ops.repro_torch


def _register_sharding_rules() -> None:
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    R = Replicate()
    scalars = [None, None, None]   # group_size, x_bits, x_signed

    def vmm_rules(xq, w, *_):
        return [([R], [R, R] + scalars),
                ([Shard(1)], [R, Shard(w.ndim - 1)] + scalars),   # N
                ([Shard(0)], [Shard(0), R] + scalars)]            # rows

    def experts_rules(xq, w, *_):
        return [([R], [R, R] + scalars),
                ([Shard(2)], [R, Shard(w.ndim - 1)] + scalars),   # N
                ([Shard(0)], [Shard(0), Shard(0)] + scalars),     # experts
                ([Shard(1)], [Shard(1), R] + scalars)]            # rows

    for name in ("bitplane_vmm", "da_vmm"):
        register_sharding(getattr(_OPS, name).default)(vmm_rules)
    for name in ("bitplane_vmm_experts", "da_vmm_experts"):
        register_sharding(getattr(_OPS, name).default)(experts_rules)

    @register_sharding(_OPS.paged_attention.default)
    def attention_rules(q, k_pool, v_pool, page_table, tpos, k_scale, v_scale,
                        softmax_dtype, mask_mode):
        def scales(pl):
            return [None if k_scale is None else pl,
                    None if v_scale is None else pl]

        tail = [None, None]
        return [([R], [R, R, R, R, R] + scales(R) + tail),
                ([Shard(2)], [Shard(2), Shard(2), Shard(2), R, R]
                 + scales(Shard(2)) + tail),                        # heads
                ([Shard(0)], [Shard(0), R, R, Shard(0), Shard(0)]
                 + scales(R) + tail)]                               # rows


_register_sharding_rules()


def da_vmm(xq: torch.Tensor, luts: torch.Tensor, cfg: DAConfig) -> torch.Tensor:
    """Faithful LUT-readout DA VMM (int32-exact). xq [M,K], luts [G,2^L,N]."""
    return _OPS.da_vmm.default(xq, luts, cfg.group_size, cfg.x_bits, cfg.x_signed)


def bitplane_vmm(xq: torch.Tensor, wq: torch.Tensor,
                 cfg: DAConfig) -> torch.Tensor:
    """Storage-free bit-plane DA VMM (int32-exact). xq [M,K], wq [K,N]."""
    return _OPS.bitplane_vmm.default(xq, wq, cfg.group_size, cfg.x_bits,
                                     cfg.x_signed)


def da_vmm_experts(xq: torch.Tensor, luts: torch.Tensor,
                   cfg: DAConfig) -> torch.Tensor:
    """The LUT readout over stacked experts, one kernel call on CUDA.
    xq [E,M,K], luts [E,G,2^L,N] → int32 [E,M,N]."""
    return _OPS.da_vmm_experts.default(xq, luts, cfg.group_size, cfg.x_bits,
                                       cfg.x_signed)


def bitplane_vmm_experts(xq: torch.Tensor, wq: torch.Tensor,
                         cfg: DAConfig) -> torch.Tensor:
    """The bit-plane VMM over stacked experts, one kernel call on CUDA.
    xq [E,M,K], wq [E,K,N] → int32 [E,M,N]."""
    return _OPS.bitplane_vmm_experts.default(xq, wq, cfg.group_size, cfg.x_bits,
                                             cfg.x_signed)


def paged_attention(q, k_pool, v_pool, page_table, tpos, *,
                    softmax_dtype="float32", mask_mode: str = "where",
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Paged-attention read over an already-written pool: the kernel on a
    CUDA tensor, the plain gather read on a CPU tensor."""
    return _OPS.paged_attention.default(
        q, k_pool, v_pool, page_table, tpos, k_scale, v_scale,
        str(softmax_dtype).replace("torch.", ""), mask_mode)
