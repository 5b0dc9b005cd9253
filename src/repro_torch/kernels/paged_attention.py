"""Paged-attention read: wrapper of the CUDA kernel ``csrc/paged_attention.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/paged_attention.py``.  The
kernel walks each row's page table itself and skips the positions past the
row's largest tpos (masked for all its queries).  One block walking all of a
(KV head, row)'s positions would fill only B * KV SMs, so the positions are
split into chunks of whole pages (:func:`split_plan`, picked here from the
head shape, the table width and the SM count, never from tpos, the batch or
the query rows: the chunk decides how a query's sums round, so a row reads
the same bits in a decode, a verify and a prefill call of any batch) and a
read is two launches over a
grid of (KV head, row, chunk) blocks: scores of each chunk into a float32
workspace with the chunk's max; the PV pass of each chunk after taking the
row's max over the chunks and its exp-sum over all its scores, whose last
block to finish sums the chunks' partials in chunk order.  The softmax stays
deferred (exp and normalise against the row's global max, probabilities
rounded to the input dtype), as in the TPU kernel, so it repeats every
rounding of the plain version,
:func:`repro_torch.models.attention.paged_gather_read`, and its three sums
(q·k, the exp-sum, p·v) accumulate in float64 as the plain read's do, so
the two round the same values and agree bit for bit.
``softmax_dtype="bfloat16"`` runs the reference's bfloat16 score pipeline:
scores rounded to bfloat16 before the mask, then x - max, exp, the row sum
and the divide each rounded to bfloat16, as the plain read's ops round
them.  Pools hold fp pages, or int8 / packed-int4 codes with float16
scales per (page slot, KV head), dequantized in registers with the plain
formula.  The workspace comes from torch's allocator on the current stream.
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
#: the kernel's warps per block and query rows per accumulation chunk
#: (``NWARPS`` and ``RC`` in the source): its PV partials take
#: NWARPS * RC * hd doubles of shared memory
_NWARPS, _RC = 8, 8
#: blocks per SM the split aims at (about two waves), for _PLAN_ROWS batch
#: rows (the serving width of every path the split was tuned on); the chunk
#: is fixed from that width, whatever the batch of the call
_WAVES, _PLAN_ROWS = 2, 4
#: key positions a warp loads at once (``U`` in the source); a chunk holds at
#: most _ROUNDS such loads per warp: past that its serial rounds cost more
#: than another block's fixed start (H100: 18 pages beat 34 and 10 at W=300)
_U, _ROUNDS = 8, 4


class SplitPlan(NamedTuple):
    """How a read splits each row's W pages: ``ns`` chunks of ``chunk``
    pages, and the dynamic shared bytes of the score and PV launches."""
    ns: int
    chunk: int
    smem: int


def _lib():
    fn = build.load("paged_attention").paged_attention_run
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 9 + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def split_plan(t: int, h: int, kv: int, hd: int, ps: int, w: int,
               sms: int) -> SplitPlan:
    """Chunks of a row's ``w`` pages on a card of ``sms`` SMs: about
    ``_WAVES`` blocks per SM over the (kv, row, chunk) grid of ``_PLAN_ROWS``
    rows, at least two chunks when ``w > 1``, at most ``_ROUNDS`` loads of
    ``_U`` positions per warp in a chunk.  Only a chunk's ``G*t x chunk*ps``
    float scores, which must fit the shared memory beside q (score launch)
    or the PV partials (PV launch), can make it depend on ``t``; no served
    shape comes near that cap."""
    gt = (h // kv) * t
    base = max(4 * (gt * hd + t), 8 * _NWARPS * _RC * hd + 4 * 2 * gt)
    per_page = 4 * (gt * ps + 1)
    cap = (SMEM_LIMIT - base) // per_page
    if cap < 1:
        raise ValueError(f"paged_attention: {gt} query rows x head_dim {hd} "
                         f"with page size {ps} exceed the block's shared memory")
    ns = min(w, max(2, -(-_WAVES * sms // (_PLAN_ROWS * kv))))
    chunk = min(-(-w // ns), cap, max(1, _ROUNDS * _NWARPS * _U // ps))
    return SplitPlan(-(-w // chunk), chunk, base + per_page * chunk)


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
    plan = split_plan(t, h, kv, hd, ps, w, build.sms(q.device.index))
    # float64 partials [B, KV, NS, G*T, hd], scores [B, KV, G*T, W*ps],
    # chunk maxima [B, KV, NS, G*T], int32 counters [B, KV], carved by the
    # kernel in that order (in 4-byte words)
    workspace = torch.empty(
        b * kv * ((h // kv) * t * (plan.ns * (2 * hd + 1) + w * ps) + 1),
        dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    ks, vs = (x.data_ptr() for x in scales) if scales else (None, None)
    queued = ctypes.c_int(0)
    err = _lib()(_DTYPES[q.dtype], _KV_FORMATS[fmt], q.data_ptr(),
                 k_pool.data_ptr(), v_pool.data_ptr(), ks, vs,
                 page_table.data_ptr(), tpos.data_ptr(), out.data_ptr(),
                 workspace.data_ptr(), b, t, h, kv, hd, ps, w, plan.chunk,
                 plan.ns, _score_divisor(hd, q.dtype), int(mask_mode == "additive"),
                 int(sm == "bfloat16"), plan.smem, torch.cuda.current_stream(q.device).cuda_stream,
                 ctypes.byref(queued))
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
