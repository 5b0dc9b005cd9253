"""Build the CUDA sources under ``csrc/`` into shared libraries at first use.

Each ``csrc/<name>.cu`` becomes ``build/repro_torch/lib<name>-<hash>.so`` at
the repository root (git-ignored), compiled with plain ``nvcc`` into a
library with a C interface and loaded with ``ctypes``: no PyTorch headers, so
a build takes seconds.  The file name carries a hash of the source and the
flags, so an edited source rebuilds and a checkout with nothing built builds
on its own.  :func:`build_all` starts one ``nvcc`` per source together.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("bitplane_vmm", "da_vmm", "paged_attention")

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ``-Xptxas -v`` resource summary of each build made in this process
PTXAS_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels are "
                       "built from source at first use")


def library_path(name: str) -> pathlib.Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by source + flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = library_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: pathlib.Path, out: pathlib.Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    PTXAS_LOG[name] = log


def build_all() -> float:
    """Build every source that is not built yet, one ``nvcc`` each, all
    started together.  Returns the wall seconds spent."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if not library_path(n).exists()]
    started = [(n, *_start(n)) for n in todo]
    for n, proc, tmp, out in started:
        _finish(n, proc, tmp, out)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _LIBS:
        path = library_path(name)
        if not path.exists():
            _finish(name, *_start(name))
        _LIBS[name] = ctypes.CDLL(str(path))
    return _LIBS[name]


def ptxas_summary() -> List[str]:
    """The register / shared-memory / spill lines of this process's builds."""
    keep = ("registers", "spill", "smem", "Compiling entry")
    return [line.strip() for log in PTXAS_LOG.values()
            for line in log.splitlines() if any(k in line for k in keep)]


@functools.lru_cache(maxsize=None)
def sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the kernels'
    plans size their grids from it."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
