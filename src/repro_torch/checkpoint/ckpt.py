"""Atomic, checksummed tree I/O in the reference's on-disk layout.

``<dir>/arrays.npz`` + ``manifest.json``: the manifest records every array's
shape, dtype and crc32, and a ``"packed"`` table of the
:class:`~repro_torch.core.engine.PackedWeights` nodes (their DAConfig, mode
and whether they carry LUTs), so :func:`load_tree` rebuilds the tree without
a template.  Writes go to ``<dir>.tmp`` and are renamed after fsync, so a
crash never leaves a half-written tree under the final name.

npz holds no bfloat16: such arrays are stored byte-viewed as uint8 and the
manifest records ``"bfloat16"``; reading views the bytes back as
``torch.bfloat16``, so neither side needs ``ml_dtypes``.  Keys join the tree
path with ``/``; a PackedWeights node contributes ``<path>/wq``,
``<path>/w_scale`` and, with LUTs, ``<path>/luts``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.da import DAConfig
from repro_torch.core.engine import PackedWeights

_SEP = "/"
_PACKED_FIELDS = ("wq", "w_scale", "luts")


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    """Leaves of nested dicts by ``/``-joined key, PackedWeights nodes kept."""
    if isinstance(tree, dict):
        out: Dict[str, Any] = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], prefix + (str(k),)))
        return out
    return {_SEP.join(prefix): tree}


def _arrays(tree) -> Dict[str, torch.Tensor]:
    flat: Dict[str, torch.Tensor] = {}
    for key, leaf in _flatten(tree).items():
        if isinstance(leaf, PackedWeights):
            for name in _PACKED_FIELDS:
                if getattr(leaf, name) is not None:
                    flat[f"{key}{_SEP}{name}"] = getattr(leaf, name)
        else:
            flat[key] = torch.as_tensor(leaf)
    return flat


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _savable(t: torch.Tensor) -> np.ndarray:
    """A host numpy array of ``t``'s bytes; dtypes numpy lacks byte-viewed."""
    t = t.detach().cpu().contiguous()
    try:
        return t.numpy()
    except TypeError:
        return t.reshape(-1).view(torch.uint8).numpy()


def _packed_manifest(tree) -> Dict[str, dict]:
    """Manifest entries for PackedWeights nodes: path → what the arrays
    alone do not say (DAConfig, default mode, LUTs or not)."""
    return {key: {"cfg": dataclasses.asdict(leaf.cfg), "mode": leaf.mode,
                  "has_luts": leaf.has_luts}
            for key, leaf in _flatten(tree).items()
            if isinstance(leaf, PackedWeights)}


def save_tree(directory: str, tree: Any,
              extra_manifest: Optional[dict] = None) -> str:
    """Atomic, checksummed write of ``tree`` (nested dicts of tensors and
    PackedWeights) to ``<directory>/``.  ``extra_manifest`` entries merge into
    the manifest (reserved keys: ``arrays``, ``packed``).  Returns
    ``directory``."""
    tensors = _arrays(tree)
    flat = {k: _savable(v) for k, v in tensors.items()}
    final = directory.rstrip(os.sep)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    manifest = dict(extra_manifest or {})
    manifest["arrays"] = {
        k: {"shape": list(tensors[k].shape), "dtype": _dtype_name(tensors[k]),
            "crc32": zlib.crc32(np.ascontiguousarray(v).tobytes())}
        for k, v in flat.items()}
    packed = _packed_manifest(tree)
    if packed:
        manifest["packed"] = packed
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise IOError(f"array dtype {name!r} has no torch counterpart")
    return dt


def _load_array(data, manifest: dict, key: str, path: str) -> torch.Tensor:
    """One array out of the npz as a CPU tensor, crc-verified and un-byte-
    viewed."""
    arr = data[key]
    meta = manifest["arrays"][key]
    if zlib.crc32(np.ascontiguousarray(arr).tobytes()) != meta["crc32"]:
        raise IOError(f"checksum mismatch for {key} in {path}")
    t = torch.from_numpy(np.array(arr, copy=True))
    dt = _torch_dtype(meta["dtype"])
    if t.dtype != dt:  # byte-viewed dtype numpy lacks (bfloat16, fp8)
        t = t.reshape(-1).view(dt)
    return t.reshape(meta["shape"])


def load_tree(path: str) -> Dict[str, Any]:
    """Read a tree written by :func:`save_tree` (or the reference's
    ``save_tree``) without a template: nested string-keyed dicts of CPU
    tensors, with the manifest's ``"packed"`` paths reassembled into
    PackedWeights.  Every array's crc32 is verified."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    root: Dict[str, Any] = {}

    def insert(key: str, value) -> None:
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    with np.load(os.path.join(path, "arrays.npz")) as data:
        consumed = set()
        for prefix, meta in manifest.get("packed", {}).items():
            fields = {}
            for name in _PACKED_FIELDS:
                key = f"{prefix}{_SEP}{name}"
                if name == "luts" and not meta.get("has_luts", key in data):
                    fields[name] = None
                    continue
                fields[name] = _load_array(data, manifest, key, path)
                consumed.add(key)
            insert(prefix, PackedWeights(cfg=DAConfig(**meta["cfg"]),
                                         mode=meta.get("mode", "auto"), **fields))
        for key in manifest["arrays"]:
            if key not in consumed:
                insert(key, _load_array(data, manifest, key, path))
    return root
