"""Three-term roofline of one rank's step, from a dry-run trace
(:mod:`repro_torch.launch.dryrun`), with H100 SXM constants:

  compute    = flops      / 989 TFLOP/s (bf16 dense tensor cores)
  memory     = bytes      / 3.35 TB/s (HBM3)
  collective = coll_bytes / 450 GB/s (NVLink 4: 900 GB/s per GPU both
                                      ways together, 450 GB/s each way)

Every term is per-chip seconds per step, so the largest is the step-time
lower bound.  The collective term divides the bytes a rank *receives* (a
collective's result bytes, as the reference sums them) by one direction's
rate.  NVLink joins the 8 GPUs of one node; a 256-rank world crosses nodes
over InfiniBand (400 Gb/s, 50 GB/s a GPU), so on such a mesh the term is an
optimistic bound.

The reference reads flops and bytes from XLA's ``cost_analysis()`` and
parses the optimized HLO for collectives; the port's dry-run counts the
local ops of one rank and records each functional collective it issues.
:func:`collective_bytes` sums those records' result bytes by kind, under
the reference's kind names; a collective's wait (``wait_tensor``, the
``-done`` of its ``-start``) is not a second transfer and is not counted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM5 (data sheet; per GPU)
PEAK_FLOPS = 989e12      # bf16 dense
HBM_BW = 3.35e12         # bytes/s
LINK_BW = 450e9          # bytes/s, NVLink 4 one direction (900 GB/s both)

#: the reference's collective kinds, by the stem of the port's op name
#: (``_c10d_functional.<op>``, ``c10d.<op>``, or DTensor's own all-to-all
#: op ``_dtensor.shard_dim_alltoall``, which a traced redistribution
#: issues as one op)
KINDS = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("send", "collective-permute"), ("recv", "collective-permute"),
    ("broadcast", "broadcast"),
)
#: the op namespaces that hold collectives
COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d", "_dtensor")
#: a collective's completion: the pair's second half, not a transfer
WAIT_OPS = ("wait_tensor",)


def collective_kind(op_name: str):
    """The reference's kind of a collective op (``"all-gather"``, ...), or
    None for an op that is not one (a wait included)."""
    ns, _, stem = op_name.rpartition(".")
    if ns not in COLLECTIVE_NAMESPACES or stem in WAIT_OPS:
        return None
    for key, kind in KINDS:
        if key in stem:
            return kind
    return None


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, int]:
    """Sum result bytes per collective kind from ``(op name, result bytes)``
    records (what the dry-run's dispatch mode saw issued); waits and
    non-collectives are skipped."""
    out: Dict[str, int] = {}
    for name, nbytes in records:
        kind = collective_kind(name)
        if kind is not None:
            out[kind] = out.get(kind, 0) + int(nbytes)
    return out


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    chips: int
    model_flops_global: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): remat / redundancy waste."""
        counted_global = self.flops_per_chip * self.chips
        return self.model_flops_global / counted_global if counted_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the step-time bound: the score.

        = (MODEL_FLOPS / chips / PEAK) / max(t_c, t_m, t_coll)."""
        t_useful = self.model_flops_global / self.chips / PEAK_FLOPS
        return t_useful / self.t_bound if self.t_bound else 0.0

    def as_dict(self) -> dict:
        return {
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_global": self.model_flops_global,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape, n_params: int, n_active: int) -> float:
    """MODEL_FLOPS: 6·N·D train, 2·N·D prefill, 2·N·B decode (N = active)."""
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch  # decode: one token per row
