"""The paged decode step at each width of the ladder, replayed in pieces
from CUDA graphs.

A decode call at ``[w, 1]`` is one static shape: the kernels plan from
shapes and the SM count alone, the K/V pools are written in place and the
page table has one width per scheduler.  :class:`StepGraphs` runs a
width's first call eagerly (kernel attributes, occupancy caches and lazily
laid-out weights are set up by it), records its second while running it,
and replays that record for every later call.

The record is in pieces.  The plain torch work between two calls of the
port's kernel entries (the ``repro_torch::`` ops of
:mod:`repro_torch.kernels.ops`) is one CUDA graph; each kernel entry stays
an eager call between two graph replays, on the tensors the recording
handed it, and its output is copied into the tensor the graphs after it
were captured reading.  So a replayed step issues the eager step's kernel
entries with the eager step's shapes (the profiler records each as its
op, the kernels' counters count each launch), and replays the plain work:
the norms, quantizing and dequantizing, RoPE and the K/V writes, which
take most of the eager step's host time.

Every width's graphs share one memory pool: the widths never run at once,
and nothing in the pool is read after the call that wrote it (each call's
logits are fetched before the next).  A record holds no tensor of the
pool: the kernel entries' operands and slots are re-made over the same
memory without owning it, so the recording frees the pool's blocks as the
eager step frees its tensors, and a served call allocates at most what
the eager call does.
The inputs are one flat buffer each for tokens, positions, page table and
``last_idx``, sized once at the widest batch and read through contiguous
``[w, 1]`` / ``[w, W]`` views; every call writes its logits, in float32,
into the first ``w`` rows of one ``[batch, V]`` buffer.

The eager step stays the definition: a replay's logits and K/V pages are
``torch.equal`` to the eager call's on the same inputs (the kernels' integer
atomics and float64 sums do not depend on the order of their adds).
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from repro_torch.kernels.ops import NAMESPACE
from repro_torch.launch.sharding import is_sharded
from repro_torch.models.config import ModelConfig
from repro_torch.spec.decode import mk_positions


def graphs_apply(cfg: ModelConfig, params: Any, device: torch.device) -> bool:
    """Whether a scheduler's decode calls may replay recorded steps: on
    CUDA, for a dense stack (MoE routing and Mamba-2 state stay eager),
    with params not placed on a mesh (collectives staged through host
    memory cannot be captured)."""
    return (device.type == "cuda" and cfg.family == "dense"
            and not is_sharded(params))


class _Memory:
    """Device memory owned elsewhere, as a CUDA array of bytes:
    ``torch.as_tensor`` over it keeps this object alive, not the memory."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "version": 2}


def unowned(x):
    """``x`` re-made over its memory without owning it (anything but a
    non-empty CUDA tensor as it is)."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda" or not x.numel():
        return x
    st = x.untyped_storage()
    raw = torch.as_tensor(_Memory(st.data_ptr(), st.nbytes()), device=x.device)
    return raw.view(x.dtype).as_strided(x.shape, x.stride(), x.storage_offset())


class _Call:
    """A kernel entry of a recorded step: ``op(*args, **kwargs)``, its
    output copied into ``out``, which the graphs after it read."""

    def __init__(self, op, args, kwargs, out: torch.Tensor):
        self.op, self.args, self.kwargs, self.out = op, args, kwargs, out

    def replay(self) -> None:
        self.out.copy_(self.op(*self.args, **self.kwargs))


class Splitter(TorchDispatchMode):
    """While on, the work queued on the current stream is captured into a
    graph (``new_graph()``, in ``pool``) up to each call of a
    ``repro_torch::`` op; the graph is then replayed, the op runs eagerly
    on what it computed, and its output is copied into a slot allocated in
    the pool, which the next graph reads.  ``steps`` holds the graphs and
    the :class:`_Call` s in their order, each call's tensors
    :func:`unowned`; :meth:`close` ends the last graph."""

    def __init__(self, pool, new_graph: Callable = torch.cuda.CUDAGraph):
        super().__init__()
        self.pool, self.new_graph = pool, new_graph
        self.steps: List[Any] = []
        self._graph = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace != NAMESPACE:
            self._open()
            return func(*args, **kwargs)
        self.close()
        out = func(*args, **kwargs)
        self._open()     # a capture of nothing, so the slot is the pool's
        slot = torch.empty_like(out)
        self.close(keep=False)
        slot.copy_(out)
        # the step frees its tensors as the eager step does: the pool may
        # reuse their blocks past their last use, in this record or another
        self.steps.append(_Call(func, *tree_map(unowned, (args, kwargs, slot))))
        return slot

    def _open(self) -> None:
        if self._graph is None:
            self._graph = self.new_graph()
            self._graph.capture_begin(pool=self.pool)

    def close(self, keep: bool = True) -> None:
        """End the open graph's capture and, with ``keep``, replay it (a
        recording computes what it records) and add it to ``steps``."""
        graph, self._graph = self._graph, None
        if graph is None:
            return
        with warnings.catch_warnings():
            # a graph of views alone, or of a slot's allocation, is empty
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            graph.capture_end()
        if keep:
            graph.replay()
            self.steps.append(graph)


class StepGraphs:
    """The decode step ``step(params, caches, tokens, positions, table,
    last_idx) -> (logits [w, V], caches)`` of a scheduler of ``batch``
    lanes and a ``table_width``-page table, at each width: eager at its
    first call, recorded at its second, replayed after (``captures``,
    ``replays``)."""

    def __init__(self, step: Callable, cfg: ModelConfig, batch: int,
                 table_width: int, device: torch.device):
        self._step, self._cfg, self._w_table = step, cfg, table_width
        i32 = dict(dtype=torch.int32, device=device)
        self._tokens = torch.zeros(batch, **i32)
        self._positions = torch.zeros(batch, **i32)
        self._table = torch.zeros(batch * table_width, **i32)
        self._last_idx = torch.zeros(batch, **i32)
        self._logits: Optional[torch.Tensor] = None   # [batch, V], at the first call
        self._pool = None      # the widths' one memory pool, at the first record
        self._stream = None    # the side stream a record is captured on
        self._eager: set = set()                  # widths run once, eagerly
        self._records: Dict[int, List[Any]] = {}  # width -> graphs and calls
        self.captures = 0
        self.replays = 0

    def __contains__(self, width: int) -> bool:
        return width in self._records

    def inputs(self, width: int):
        """The static inputs of ``width``: tokens and positions ``[w, 1]``,
        page table ``[w, W]``, ``last_idx [w]`` (raw positions: M-RoPE's
        coordinates are made inside the step)."""
        w = width
        return (self._tokens[:w].view(w, 1), self._positions[:w].view(w, 1),
                self._table[:w * self._w_table].view(w, self._w_table),
                self._last_idx[:w])

    def _forward(self, params: Any, caches: Any, width: int) -> None:
        tokens, positions, table, last_idx = self.inputs(width)
        logits, _ = self._step(params, caches, tokens,
                               mk_positions(self._cfg, positions), table, last_idx)
        if self._logits is None:
            self._logits = torch.empty((self._tokens.shape[0], logits.shape[-1]),
                                       dtype=torch.float32, device=logits.device)
        self._logits[:width].copy_(logits)

    def run(self, params: Any, caches: Any, width: int) -> torch.Tensor:
        """One decode call at ``width`` on what :meth:`inputs` holds, over
        ``caches``' pools (written in place); returns its float32 logits
        ``[w, V]`` (a view, valid until the next call)."""
        steps = self._records.get(width)
        if steps is not None:
            for s in steps:
                s.replay()
            self.replays += 1
        elif width not in self._eager:
            self._forward(params, caches, width)
            self._eager.add(width)
        else:
            self._records[width] = self._record(params, caches, width)
            self.captures += 1
        return self._logits[:width]

    def _record(self, params: Any, caches: Any, width: int) -> List[Any]:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream()
        # captured on a side stream, after what the caller queued
        self._stream.wait_stream(torch.cuda.current_stream())
        splitter = Splitter(self._pool)
        with torch.cuda.stream(self._stream):
            try:
                with splitter:
                    self._forward(params, caches, width)
                splitter.close()
            finally:
                splitter.close(keep=False)   # an error mid-graph ends its capture
        torch.cuda.current_stream().wait_stream(self._stream)
        return splitter.steps
