"""DA-quantized linear layer: a thin façade over the execution engine.

``freeze_da`` runs the pre-VMM step once (quantize + weight-sum LUTs) and
returns the :class:`~repro_torch.core.engine.PackedWeights` artifact;
applying it dispatches through the engine's backend registry, so every
registered mode and shape-aware ``auto`` are available from one surface.
``DAFrozenLinear`` is kept as an alias of PackedWeights, as in the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.da import DAConfig
from repro_torch.core.engine import (  # noqa: F401  (dense re-exported)
    DEFAULT_LUT_LIMIT,
    PackedWeights,
    dense,
    pack_weights,
)

#: the frozen linear IS the packed-weights container
DAFrozenLinear = PackedWeights


def freeze_da(w: torch.Tensor, cfg: DAConfig = DAConfig(x_signed=True),
              mode: str = "auto",
              lut_cell_limit: int = DEFAULT_LUT_LIMIT) -> PackedWeights:
    """Pre-VMM procedure (§III-A) for one [K, N] weight: ``mode`` is any
    registered backend (legacy ``da_*`` spellings accepted) or ``"auto"``:
    LUTs when they fit ``lut_cell_limit`` cells, and the backend picked per
    activation shape at run time."""
    return pack_weights(w, cfg, mode=mode, lut_cell_limit=lut_cell_limit)
