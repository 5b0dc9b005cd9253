"""DA core: the bit-plane identity, quantization, the unified execution
engine, the freeze pipeline and the frozen linear, under the reference's
names (``repro.core``).

The names resolve on first access (PEP 562): ``core.freeze`` imports
``repro_torch.convert`` and ``repro_torch.obs.hwcost``, which import
``core``'s submodules, so importing ``freeze`` here eagerly would close an
import cycle for whichever of them a program imports first.
"""
import importlib

#: each re-exported name and the submodule of ``core`` that defines it
_EXPORTS = {
    **dict.fromkeys(("DAConfig", "build_luts", "da_vmm_bitplane", "da_vmm_lut",
                     "da_vmm_onehot"), "da"),
    **dict.fromkeys(("BackendSpec", "PackedWeights", "da_matmul", "da_vmm",
                     "dense", "pack_quantized", "pack_weights",
                     "registered_backends", "select_backend"), "engine"),
    **dict.fromkeys(("DAArtifact", "LayerPlan", "da_memory_report",
                     "freeze_model", "load_artifact", "plan_model",
                     "save_artifact"), "freeze"),
    **dict.fromkeys(("DAFrozenLinear", "freeze_da"), "linear"),
    **dict.fromkeys(("QTensor", "int_matmul", "quantize_acts_signed",
                     "quantize_acts_unsigned", "quantize_weights"), "quant"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
