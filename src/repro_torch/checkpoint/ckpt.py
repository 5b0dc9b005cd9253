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

Step checkpoints (:func:`save`, :func:`restore`, :class:`AsyncCheckpointer`)
use the reference's layout too: ``<dir>/step_%08d/`` holding one such tree,
its manifest stamped with the step, the last ``keep`` steps kept.  A
NamedTuple (a train or optimizer state) contributes its field names to the
keys, a list its indices, and a port param tree (a dict holding
``blocks``, one dict per layer) is written in the reference's stacked
``periods/pos_<i>`` layout (``period`` is its layer pattern's period), so a
checkpoint written by either package restores in the other.

On a mesh (a state of DTensor leaves) every rank gathers each leaf to its
full value on the main thread — collectives never run in the writer
thread — and rank 0 alone writes; :func:`restore` places each leaf by the
target shardings (the template's placements, or a ``shardings`` tree), so
a checkpoint written on one mesh resumes on another: the reference's
elastic restart.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import re
import shutil
import threading
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.convert import params_from_jax, params_to_ref
from repro_torch.core.da import DAConfig
from repro_torch.core.engine import PackedWeights
from repro_torch.launch.sharding import DTensor, NamedSharding, distribute, full, spec_of
from repro_torch.tree import tree_map

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


def load_tree(path: str, template: Any = None, shardings: Any = None,
              period: int = 1) -> Any:
    """Read a tree written by :func:`save_tree` (or the reference's
    ``save_tree``), verifying every array's crc32.

    With a ``template``: restore into its structure (a tree as :func:`save`
    takes; ``period`` its layer pattern's), each leaf cast to its template
    leaf's dtype and placed with the matching ``shardings`` entry (a
    :class:`~repro_torch.launch.sharding.NamedSharding`), else as its
    template leaf is (a DTensor's placements, else its device) — the
    elastic-restart path.

    Without a template: nested string-keyed dicts of CPU tensors, with the
    manifest's ``"packed"`` paths reassembled into PackedWeights."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if template is not None:
        return _load_into(path, manifest, template, shardings, period)
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


# ---------------------------------------------------------------------------
# Step checkpoints
# ---------------------------------------------------------------------------


def _to_ref(tree, period: int):
    """``tree`` as nested dicts under the reference's key names: NamedTuple
    fields and list indices become keys, port param trees take the
    reference's stacked layout."""
    if isinstance(tree, dict):
        if "blocks" in tree:
            return params_to_ref(tree, period)
        return {k: _to_ref(v, period) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: _to_ref(getattr(tree, f), period) for f in tree._fields}
    if isinstance(tree, (list, tuple)):
        return {str(i): _to_ref(v, period) for i, v in enumerate(tree)}
    return tree


def _place(t: torch.Tensor, tm, sh) -> torch.Tensor:
    """Loaded ``t`` placed by ``sh``, else like its template leaf ``tm``."""
    if sh is None and isinstance(tm, DTensor):
        sh = NamedSharding(tm.device_mesh, spec_of(tm))
    if sh is not None:
        return distribute(t.to(tm.device), sh)
    return t.to(tm.device)


def _sub(sh, key):
    return None if sh is None else sh[key]


def _placed(template, loaded, sh):
    """``loaded`` (``template``'s structure) with every leaf placed."""
    if isinstance(template, dict):
        return {k: _placed(v, loaded[k], _sub(sh, k)) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _placed(getattr(template, f), getattr(loaded, f),
                    None if sh is None else getattr(sh, f))
            for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_placed(v, loaded[i], _sub(sh, i))
                              for i, v in enumerate(template))
    return _place(loaded, template, sh)


def _from_ref(node, template, sh=None):
    """The inverse of :func:`_to_ref` into ``template``'s structure, each
    tensor placed by ``sh`` (a tree like ``template`` of NamedShardings),
    else like its template leaf."""
    if isinstance(template, dict):
        if "blocks" in template:
            return _placed(template, params_from_jax(node, device="cpu"), sh)
        return {k: _from_ref(node[k], v, _sub(sh, k)) for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _from_ref(node[f], getattr(template, f),
                      None if sh is None else getattr(sh, f))
            for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_from_ref(node[str(i)], v, _sub(sh, i))
                              for i, v in enumerate(template))
    return _place(node, template, sh)


def _writes() -> bool:
    """Whether this process writes checkpoints: rank 0 of a started
    process group, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()


def _on_host(tree, copy: bool):
    """Every tensor of ``tree`` in host memory, a DTensor gathered to its
    full value (a collective: every rank calls this, on its main thread);
    ``copy`` copies host tensors too (an async writer must not read tensors
    the train step goes on updating in place)."""
    def one(t):
        if not isinstance(t, torch.Tensor):
            return t
        if isinstance(t, DTensor):
            t = full(t)  # a replicated leaf's full value is its live local tensor
        return t.detach().to("cpu", copy=copy)

    return tree_map(one, tree)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree: Any, keep: int = 3,
         period: int = 1) -> str:
    """Synchronous atomic save of ``tree`` (tensors, dicts, lists,
    NamedTuples) as step ``step``; keeps the last ``keep`` steps.  Returns
    the checkpoint path.  On a mesh every rank calls it; rank 0 writes."""
    host = _on_host(tree, copy=False)
    path = (_write(directory, step, host, keep, period) if _writes()
            else _step_dir(directory, step))
    _barrier()
    return path


def _write(directory: str, step: int, host_tree: Any, keep: int,
           period: int) -> str:
    final = save_tree(_step_dir(directory, step), _to_ref(host_tree, period),
                      extra_manifest={"step": step})
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, template: Any, period: int = 1,
            shardings: Any = None) -> Any:
    """Restore step ``step`` into ``template``'s structure (a tree as
    :func:`save` takes), each leaf cast to its template leaf's dtype and
    placed by ``shardings`` or like its template leaf (see
    :func:`load_tree`); every checksum is verified."""
    return load_tree(_step_dir(directory, step), template, shardings, period)


def _load_into(path: str, manifest: dict, template: Any, shardings: Any,
               period: int) -> Any:
    shapes = _to_ref(tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                    device="meta"), template),
                     period)
    root: Dict[str, Any] = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key, meta in _flatten(shapes).items():
            node = root
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = _load_array(data, manifest, key, path).to(meta.dtype)
    return _from_ref(root, template, shardings)


class AsyncCheckpointer:
    """Background writer thread; the caller only pays the device→host
    copy."""

    def __init__(self, directory: str, keep: int = 3, period: int = 1):
        self.directory = directory
        self.keep = keep
        self.period = period
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, tree = item
                _write(self.directory, step, tree, self.keep, self.period)
            except BaseException as e:  # surfaced on next submit / wait
                self._exc = e
            finally:
                self._q.task_done()

    def submit(self, step: int, tree: Any) -> None:
        """Gather ``tree`` to the host now (every rank, on this thread);
        rank 0 queues the write."""
        if self._exc:
            raise self._exc
        host = _on_host(tree, copy=True)  # device→host now
        if _writes():
            self._q.put((step, host))

    def wait(self) -> None:
        """Every submitted checkpoint on disk, on every rank."""
        self._q.join()
        _barrier()
        if self._exc:
            raise self._exc

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._exc:
            raise self._exc
