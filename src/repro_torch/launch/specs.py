"""Abstract input specs (``meta``-device tensors) and the PartitionSpecs of
parameter, cache and batch trees.

``batch_specs`` / ``decode_specs`` / ``prefill_specs`` build stand-ins for
every model input on the ``meta`` device — shapes and dtypes, no bytes.

``tree_pspecs`` / ``cache_pspecs`` / ``batch_pspecs`` map every leaf to a
PartitionSpec through the logical-axis rules (:mod:`repro_torch.launch.sharding`).
The port's param tree holds one dict per layer (``blocks[i]``), where the
reference stacks each layer position over periods (``periods/pos_<i>``,
a leading ``[P]`` axis): a port leaf's spec is the reference's without its
leading ``None``.  A tree in the reference's layout (``periods`` in the
path) gets the leading axis as there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.registry import ShapeSpec
from repro_torch.core.engine import PackedWeights
from repro_torch.launch import sharding as shd
from repro_torch.launch.sharding import P
from repro_torch.models.config import ModelConfig

# leaf name → logical axes, keyed by (name, ndim-without-stacking)
PARAM_LOGICAL: Dict[Tuple[str, int], Tuple[Optional[str], ...]] = {
    ("table", 2): ("vocab", "embed"),
    ("w", 2): ("embed", "vocab"),            # lm head
    ("wq", 2): ("embed", "heads"),
    ("wk", 2): ("embed", "heads"),           # flat kv dim (divisible even
    ("wv", 2): ("embed", "heads"),           #  when the kv-head count isn't)
    ("wo", 2): ("heads", "embed"),
    ("bq", 1): ("heads",),
    ("bk", 1): ("heads",),
    ("bv", 1): ("heads",),
    ("w_up", 2): ("embed", "ffn"),
    ("w_gate", 2): ("embed", "ffn"),
    ("w_down", 2): ("ffn", "embed"),
    ("w_up", 3): ("expert", "embed", "expert_ffn"),
    ("w_gate", 3): ("expert", "embed", "expert_ffn"),
    ("w_down", 3): ("expert", "expert_ffn", "embed"),
    ("router", 2): ("embed", "expert"),
    ("in_proj", 2): ("embed", "inner"),
    ("out_proj", 2): ("inner", "embed"),
    ("conv_w", 2): (None, "inner"),
}


DA_FIELDS = ("wq", "w_scale", "luts")


def _leaf_logical(path_names, shape) -> Tuple[Optional[str], ...]:
    name = path_names[-1]
    stacked = "periods" in path_names
    ndim = len(shape) - (1 if stacked else 0)
    if name in DA_FIELDS and len(path_names) >= 2:
        # DA-frozen linear: shard each artifact like the weight it derives
        # from. wq matches the parent weight's logical axes; the per-column
        # scale and the [.., G, 2^L, N] LUTs inherit only the output axis.
        parent = path_names[-2]
        base_ndim = ndim if name in ("wq", "w_scale") else ndim - 1
        base = PARAM_LOGICAL.get((parent, base_ndim))
        if base is not None:
            lead = base[:-2] if len(base) > 2 else ()
            out_ax = base[-1]
            if name == "wq":
                logical = base
            elif name == "w_scale":
                logical = lead + (None, out_ax)
            else:  # luts [.., G, 2^L, N]
                logical = lead + (None, "lut_addr", out_ax)
            if stacked:
                logical = (None,) + logical
            return logical
    logical = PARAM_LOGICAL.get((name, ndim), (None,) * ndim)
    if stacked:
        logical = (None,) + logical
    return logical


def _map_named(fn, tree, names=()):
    """``fn(path names, leaf)`` over a tree of dicts, lists, NamedTuples and
    PackedWeights (whose fields are named ``wq`` / ``w_scale`` / ``luts``,
    as the reference's pytree keys them; a missing ``luts`` stays None).
    A PartitionSpec is a leaf."""
    if isinstance(tree, P):
        return fn(names, tree)
    if isinstance(tree, PackedWeights):
        return dataclasses.replace(tree, **{
            f: _map_named(fn, getattr(tree, f), names + (f,))
            for f in DA_FIELDS if getattr(tree, f) is not None})
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, names + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_named(fn, getattr(tree, f), names + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, names + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(names, tree)


def tree_pspecs(tree: Any) -> Any:
    """PartitionSpec tree mirroring ``tree`` (under active mesh rules); a
    PackedWeights node holds its fields' specs."""
    return _map_named(lambda names, leaf: shd.pspec(
        _leaf_logical(names, leaf.shape), leaf.shape), tree)


def place(tree: Any, specs_tree: Any, mesh) -> Any:
    """``tree``'s tensors as DTensors placed by ``specs_tree`` (each rank
    holds the same full tensors and keeps its slices)."""
    flat_specs = {}
    _map_named(lambda names, s: flat_specs.__setitem__(names, s), specs_tree)
    return _map_named(lambda names, t: shd.distribute(
        t, shd.NamedSharding(mesh, flat_specs[names])), tree)


# ---------------------------------------------------------------------------
# cache specs
# ---------------------------------------------------------------------------
CACHE_LOGICAL = {
    "k": (None, "batch", "kv_seq", "kv_heads", "head_dim"),
    "v": (None, "batch", "kv_seq", "kv_heads", "head_dim"),
    "length": (None,),
    "conv": (None, "batch", None, "inner"),
    "ssm": (None, "batch", "ssm_heads", None, None),
}


def _cache_fields(cache):
    if dataclasses.is_dataclass(cache) and not isinstance(cache, type):
        return {f.name: getattr(cache, f.name) for f in dataclasses.fields(cache)}
    return None


def cache_pspecs(caches: Any) -> Any:
    """The PartitionSpec of every leaf of the dense decode caches
    (:func:`repro_torch.models.model.init_caches`: ``KVCache`` and
    ``MambaCache`` stacked over periods), by field name."""
    def one(node):
        fields = _cache_fields(node)
        if fields is not None:
            return dataclasses.replace(node, **{
                name: one_leaf(name, leaf) for name, leaf in fields.items()
                if leaf is not None})
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        raise TypeError(f"not a cache: {type(node).__name__}")

    def one_leaf(name, leaf):
        logical = CACHE_LOGICAL.get(name, (None,) * leaf.ndim)
        return shd.pspec(logical, leaf.shape)

    return one(caches)


def place_caches(caches: Any, specs: Any, mesh) -> Any:
    """The dense decode caches' tensors (``KVCache`` / ``MambaCache``
    fields) as DTensors placed by :func:`cache_pspecs`' specs, as
    :func:`place` places a param tree."""
    def one(node, spec):
        fields = _cache_fields(node)
        if fields is not None:
            return dataclasses.replace(node, **{
                name: shd.distribute(leaf, shd.NamedSharding(mesh, getattr(spec, name)))
                for name, leaf in fields.items() if leaf is not None})
        if isinstance(node, dict):
            return {k: one(v, spec[k]) for k, v in node.items()}
        raise TypeError(f"not a cache: {type(node).__name__}")

    return one(caches, specs)


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Abstract train batch: tokens or stub embeddings + labels."""
    b, t = shape.global_batch, shape.seq_len
    if cfg.modality == "text":
        inputs = _meta((b, t), torch.int32)
    else:  # [audio]/[vlm]: precomputed frame/patch embeddings (frontend stub)
        inputs = _meta((b, t, cfg.d_model), torch.bfloat16)
    out = {"inputs": inputs, "labels": _meta((b, t), torch.int32)}
    if cfg.mrope_sections:
        out["positions"] = _meta((b, t, 3), torch.int32)
    return out


BATCH_LOGICAL = {
    "inputs": ("batch", "seq", "embed"),
    "labels": ("batch", "seq"),
    "positions": ("batch", "seq", None),
}


def batch_pspecs(batch: Dict[str, Any]) -> Dict[str, P]:
    out = {}
    for k, v in batch.items():
        logical = BATCH_LOGICAL[k][: v.ndim]
        out[k] = shd.pspec(logical, v.shape)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeSpec):
    """Abstract decode inputs: one new token per row + positions."""
    b = shape.global_batch
    if cfg.modality == "text":
        tok = _meta((b, 1), torch.int32)
    else:
        tok = _meta((b, 1, cfg.d_model), torch.bfloat16)
    pos_shape = (b, 1, 3) if cfg.mrope_sections else (b, 1)
    return tok, _meta(pos_shape, torch.int32)


def prefill_specs(cfg: ModelConfig, shape: ShapeSpec):
    b, t = shape.global_batch, shape.seq_len
    if cfg.modality == "text":
        tok = _meta((b, t), torch.int32)
    else:
        tok = _meta((b, t, cfg.d_model), torch.bfloat16)
    pos_shape = (b, t, 3) if cfg.mrope_sections else (b, t)
    return tok, _meta(pos_shape, torch.int32)
