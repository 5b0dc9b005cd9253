"""Compat shim: model-level DA freezing lives in :mod:`repro_torch.core.freeze`.

Kept for call sites of the reference's old surface (``freeze_model_da``);
importing it emits a :class:`DeprecationWarning`.
"""
from __future__ import annotations

import warnings

warnings.warn(
    "repro_torch.serve.quantize is a compat shim; import from "
    "repro_torch.core.freeze instead",
    DeprecationWarning,
    stacklevel=2,
)

from repro_torch.core.freeze import (  # noqa: E402,F401
    DA_LEAF_NAMES,
    SKIP_CONTEXT,
    DAArtifact,
    LayerPlan,
    da_memory_report,
    freeze_model,
    freeze_model_da,
    load_artifact,
    plan_model,
    save_artifact,
)
