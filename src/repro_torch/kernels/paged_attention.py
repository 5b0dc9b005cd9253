"""Paged-attention read: wrapper of the CUDA kernel ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/paged_attention.py``.  The
kernel walks each row's page table itself and skips the positions past the
row's largest tpos (masked for all its queries).  One block walking all of a
(KV head, row)'s positions would fill only B * KV SMs, so the positions are
split into chunks of whole pages (:func:`split_plan`, picked here from the
table width, the page size, the KV heads and the SM count, never from
tpos, the batch or the query rows: the chunk decides how a query's sums
round, so a row reads the same bits in a decode, a verify and a prefill
call of any batch).  A read is one
launch: the chunks of a (KV head, row) are one thread-block cluster, which
takes the row's max, its exp-sum and its PV sum across the chunks through
distributed shared memory, in chunk order.  The softmax stays deferred
(exp and normalise against the row's global max, probabilities rounded to
the input dtype), as in the TPU kernel, so it repeats every rounding of the
plain version, :func:`repro_torch.models.attention.paged_gather_read`, and
its three sums (q·k, the exp-sum, p·v) accumulate in float64 (the products
on the float64 tensor cores) as the plain read's do, so the two round the
same values and agree bit for bit.
``softmax_dtype="bfloat16"`` runs the reference's bfloat16 score pipeline:
scores rounded to bfloat16 before the mask, then x - max, exp, the row sum
and the divide each rounded to bfloat16, as the plain read's ops round
them.  Pools hold fp pages, or int8 / packed-int4 codes with float16
scales per (page slot, KV head), dequantized with the plain formula.  The
kernel keeps nothing in device memory between blocks; only a chunk whose
scores do not fit a block's shared memory (a long table at a prefill
width) gets a scratch slice of its own from torch's allocator.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.models import kv_quant

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head widths the kernel is built for (the registered configs' 64 and 128)
HEAD_DIMS = (64, 128)
_KV_FORMATS = {"fp": 0, "int8": 1, "int4": 2}
#: the score pipelines the kernel runs (``ModelConfig.softmax_dtype``)
_SOFTMAX_DTYPES = ("float32", "bfloat16")
#: dynamic shared memory a block may take (H100: 227 KB)
SMEM_LIMIT = 227 * 1024
#: clusters the kernel takes: at most 8 blocks (the portable limit; its
#: stats arrays are sized for that, ``NS_MAX`` in the source)
_CLUSTER_LIMIT = 8
#: chunks of a row at most: the cluster's size
_NS_MAX = 8
#: fewest positions a chunk holds when its row has more: a block's fixed
#: start (table, q, one round of loads, four cluster barriers) is paid per
#: chunk, so a chunk below two staged tiles buys no time
_MIN_CHUNK_POS = 32
#: batch rows whose clusters the plan fits in one wave (the serving width
#: of every path the plan was measured on), and the blocks an SM holds for
#: that: two by the kernel's launch bounds, less what clusters, which must
#: sit whole in one GPC, cannot use (an H100 held 30 clusters of 8 such
#: blocks, not 33)
_PLAN_ROWS, _WAVE_BLOCKS_PER_SM = 4, 1.75
#: tiles of K and of V a block stages at once (``NBUF`` in the source)
_NBUF = 2


class SplitPlan(NamedTuple):
    """How a read splits each row's W pages: ``ns`` chunks (the cluster's
    blocks) of ``chunk`` pages."""
    ns: int
    chunk: int


class BlockShape(NamedTuple):
    """A block's dynamic shared bytes, and the float32 words of the
    scratch area for the scores (0 when they live in shared memory)."""
    smem: int
    scratch: int


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention_run
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 9 + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        occ = lib.paged_attention_max_clusters
        occ.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
        occ.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def split_plan(kv: int, ps: int, w: int, sms: int) -> SplitPlan:
    """Chunks of a row's ``w`` pages of ``ps`` positions on a card of
    ``sms`` SMs, for a model of ``kv`` KV heads: as many as the cluster
    holds (``_NS_MAX``), each at least ``_MIN_CHUNK_POS`` positions unless
    the row has fewer, and no more than keep the clusters of
    ``_PLAN_ROWS`` rows in one wave.  Never the batch, T or tpos: a row's
    chunks, and the order its sums take, are the same in every call."""
    wave = max(1, int(_WAVE_BLOCKS_PER_SM * sms) // (kv * _PLAN_ROWS))
    ns = max(1, min(w, _NS_MAX, _CLUSTER_LIMIT, wave, -(-w * ps // _MIN_CHUNK_POS)))
    chunk = -(-w // ns)
    return SplitPlan(-(-w // chunk), chunk)


def _padded_rows(t: int, h: int, kv: int) -> int:
    """A block's G*t query rows padded to the MMA's 16."""
    return -(-(h // kv) * t // 16) * 16


def _score_stride(chunk: int, ps: int) -> int:
    """Floats per score row (``SLD`` in the source): the chunk's positions
    padded to 32, plus 4 so the MMA's fragment loads hit distinct banks."""
    return -(-chunk * ps // 32) * 32 + 4


def _stage_geometry(hd: int, elem: int, fmt: str) -> tuple:
    """Bytes of one pool row and positions per staged tile (``Geo`` in the
    source)."""
    rb = {"fp": hd * elem, "int8": hd, "int4": hd // 2}[fmt]
    return rb, min(64, 8192 // rb)


def block_smem(t: int, h: int, kv: int, hd: int, ps: int, chunk: int, elem: int,
               fmt: str, scores_here: bool) -> int:
    """A block's dynamic shared bytes (``layout`` in the source): query
    rows as float32 and two staged tiles of K beside them, overlaid by the
    float64 PV partial; two tiles of V; the cluster's chunk maxima and
    sums, the row sums, the chunk's pages and tpos; and the chunk's scores
    (G*t rows padded to 16, ``_score_stride`` floats each) when
    ``scores_here``."""
    gtp = _padded_rows(t, h, kv)
    rb, tp = _stage_geometry(hd, elem, fmt)
    scales = 0 if fmt == "fp" else _NBUF * tp * 4
    qk = gtp * (hd + 4) * 4 + _NBUF * tp * (rb + 16) + scales
    small = -(-(gtp * (_CLUSTER_LIMIT * 12 + 4) + 4 * (chunk + t)) // 16) * 16
    return (max(qk, gtp * (hd + 8) * 8) + _NBUF * tp * (rb + 32) + scales + small
            + (gtp * _score_stride(chunk, ps) * 4 if scores_here else 0))


@functools.lru_cache(maxsize=None)
def block_shape(t: int, h: int, kv: int, hd: int, ps: int, chunk: int, elem: int,
                fmt: str) -> BlockShape:
    """Scores in shared memory where they fit beside the staged tiles,
    else in a scratch slice per block; raises when even that does not
    fit."""
    here = block_smem(t, h, kv, hd, ps, chunk, elem, fmt, True)
    if here <= SMEM_LIMIT:
        return BlockShape(here, 0)
    smem = block_smem(t, h, kv, hd, ps, chunk, elem, fmt, False)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_attention: {(h // kv) * t} query rows x head_dim "
                         f"{hd} exceed the block's shared memory")
    return BlockShape(smem, _padded_rows(t, h, kv) * _score_stride(chunk, ps))


@functools.lru_cache(maxsize=None)
def max_clusters(dtype: torch.dtype, fmt: str, hd: int, ns: int, smem: int,
                 device: int) -> int:
    """Clusters of ``ns`` blocks of ``smem`` shared bytes the card holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    clusters = ctypes.c_int(0)
    with torch.cuda.device(device):
        build.check(_lib().paged_attention_max_clusters(
            _DTYPES[dtype], _KV_FORMATS[fmt], hd, ns, smem, ctypes.byref(clusters)),
            "paged_attention_max_clusters")
    return clusters.value


@functools.lru_cache(maxsize=None)
def _score_divisor(hd: int, dtype: torch.dtype) -> float:
    """sqrt(hd) rounded to the input dtype, as the plain version divides the
    scores by it in that dtype."""
    return torch.tensor(hd ** 0.5, dtype=dtype).item()


def paged_attention_cuda(q, k_pool, v_pool, page_table, tpos, *,
                         softmax_dtype="float32", mask_mode: str = "where",
                         k_scale=None, v_scale=None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns ``[B, T, H, hd]``.
    Quantized pools (int8 codes, or int4 packed two per byte along hd) come
    with their float16 scales ``[P, ps, kv, 1]``."""
    fmt = kv_quant.kv_format(k_pool, k_scale, q.shape[-1])
    scales = () if fmt == "fp" else (k_scale, v_scale)
    tensors = (q, k_pool, v_pool, page_table, tpos) + scales
    if any(x.device != q.device for x in tensors) or q.device.type != "cuda":
        raise ValueError("paged_attention_cuda: all operands on one CUDA device")
    pool_dtype = q.dtype if fmt == "fp" else torch.int8
    if q.dtype not in _DTYPES or k_pool.dtype != pool_dtype or v_pool.dtype != pool_dtype:
        raise TypeError(f"paged_attention_cuda: {fmt} pools of a {q.dtype} q "
                        f"must be {pool_dtype} ({k_pool.dtype}, {v_pool.dtype})")
    if fmt != "fp" and (v_scale is None or any(
            x.dtype != kv_quant.KV_SCALE_DTYPE
            or tuple(x.shape) != tuple(k_pool.shape[:-1]) + (1,) for x in scales)):
        raise ValueError("paged_attention_cuda: quantized pools need float16 "
                         "k_scale and v_scale of shape [P, ps, kv, 1]")
    if page_table.dtype != torch.int32 or tpos.dtype != torch.int32:
        raise TypeError("paged_attention_cuda: page_table and tpos are int32")
    sm = str(softmax_dtype).replace("torch.", "")
    if sm not in _SOFTMAX_DTYPES:
        raise ValueError(f"paged_attention_cuda: softmax_dtype {softmax_dtype!r} "
                         f"is not one of {_SOFTMAX_DTYPES}")
    if mask_mode not in ("where", "additive"):
        raise ValueError(f"unknown mask_mode {mask_mode!r}")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("paged_attention_cuda: operands must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k_pool, v_pool)):
        raise ValueError("paged_attention_cuda: q and the pools must be "
                         "16-byte aligned (the kernel loads K/V rows as vectors)")
    b, t, h, hd = q.shape
    _, ps, kv, _ = k_pool.shape
    w = page_table.shape[1]
    if (k_pool.shape[-1] != (hd // 2 if fmt == "int4" else hd)
            or v_pool.shape != k_pool.shape or h % kv
            or page_table.shape[0] != b or tuple(tpos.shape) != (b, t)):
        raise ValueError(f"paged_attention_cuda: inconsistent shapes q "
                         f"{tuple(q.shape)} pool {tuple(k_pool.shape)} table "
                         f"{tuple(page_table.shape)} tpos {tuple(tpos.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged_attention_cuda: head_dim {hd} is not one the "
                         f"kernel is built for {HEAD_DIMS}")
    plan = split_plan(kv, ps, w, build.sms(q.device.index))
    shape = block_shape(t, h, kv, hd, ps, plan.chunk, q.element_size(), fmt)
    if max_clusters(q.dtype, fmt, hd, plan.ns, shape.smem, q.device.index) < 1:
        raise RuntimeError(f"paged_attention_cuda: a cluster of {plan.ns} blocks "
                           f"of {shape.smem} shared bytes cannot be scheduled")
    scratch = (torch.empty(b * kv * plan.ns * shape.scratch, dtype=torch.float32,
                           device=q.device) if shape.scratch else None)
    out = torch.empty_like(q)
    ks, vs = (x.data_ptr() for x in scales) if scales else (None, None)
    queued = ctypes.c_int(0)
    err = _lib().paged_attention_run(
        _DTYPES[q.dtype], _KV_FORMATS[fmt], q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), ks, vs, page_table.data_ptr(), tpos.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), b, t, h,
        kv, hd, ps, w, plan.chunk, plan.ns, _score_divisor(hd, q.dtype),
        int(mask_mode == "additive"), int(sm == "bfloat16"), shape.smem,
        torch.cuda.current_stream(q.device).cuda_stream, ctypes.byref(queued))
    paged_attention_cuda.cuda_launches += queued.value
    build.check(err, "paged_attention_run")
    paged_attention_cuda.launches += 1
    paged_attention_cuda.launches_by_format[fmt] += 1
    paged_attention_cuda.launches_by_t[t] = paged_attention_cuda.launches_by_t.get(t, 0) + 1
    paged_attention_cuda.launches_by_softmax[sm] += 1
    return out


#: reads in this process, in all, by page format, by query rows T and by
#: softmax dtype, and
#: the CUDA launches the kernel's entry point queued for them (reset by
#: callers that count a run)
paged_attention_cuda.launches = 0
paged_attention_cuda.launches_by_format = dict.fromkeys(_KV_FORMATS, 0)
paged_attention_cuda.launches_by_t = {}
paged_attention_cuda.launches_by_softmax = dict.fromkeys(_SOFTMAX_DTYPES, 0)
paged_attention_cuda.cuda_launches = 0


def paged_attention(q, k_pool, v_pool, page_table, tpos, **kw) -> torch.Tensor:
    """Paged-attention read over an already-written pool.  A CUDA tensor
    launches the kernel; a CPU tensor runs the plain gather read."""
    if q.device.type == "cuda":
        return paged_attention_cuda(q, k_pool, v_pool, page_table, tpos, **kw)
    from repro_torch.models.attention import paged_gather_read

    return paged_gather_read(q, k_pool, v_pool, page_table, tpos, **kw)
