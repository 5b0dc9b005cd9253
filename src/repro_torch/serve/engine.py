"""Serving engine: continuous batching with KV caches, with every weight
matrix frozen into DA form (the paper's inference setting: weights
constant, the DA precondition).

``ServeEngine`` is a facade over two runtimes:

* ``runtime="paged"`` (the default for attention stacks): the
  continuous-batching scheduler of :mod:`repro_torch.serve.scheduler` over
  the paged KV pool (chunked prefill, preemption, prefix cache, spec
  decoding, quantized pages);
* ``runtime="slots"``: the fixed-slot runtime over a dense ``[B, max_len]``
  cache (:class:`_SlotRuntime`), for mixers whose state does not page
  (Mamba, hybrid stacks: ``runtime="auto"`` picks it for them) and as the
  baseline.  A prompt prefills in one call (padded to a power-of-two length
  bucket for attention stacks, at its exact length for recurrent ones) into
  a fresh batch-1 cache whose rows (KV, or the Mamba conv window and SSM
  state) are copied into its slot; every step decodes all ``B`` slots.

``ServeEngine`` freezes float params through
:func:`repro_torch.core.freeze.freeze_model` when ``da_mode`` is given:
``"auto"`` (the default of the repo's serving surfaces) plans a backend,
group size and lut-or-not per layer at ``m_hint=batch_size``, a registered
backend pins every layer (params already frozen are never re-packed); it
serves them through the runtime; :meth:`ServeEngine.from_artifact` boots a DA artifact
(the reference's or the port's) from disk with no float weights and no
re-packing.  It runs on the card unless the caller passes ``device="cpu"``.

Observability: every engine carries a metrics registry (always on) and a
trace recorder (``trace=True``, off by default); ``obs=`` hands in a bundle
instead.  ``write_trace`` / ``write_metrics`` / ``write_hw_metrics`` export a
Chrome trace, Prometheus text and the stamped ``hw`` block, the files
``python -m repro_torch.obs.check`` validates.  The ``hw`` block prices the
executed work on the paper's DA circuits (reckoned, not measured).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.da import DAConfig
from repro_torch.core.freeze import (
    DAArtifact,
    freeze_model,
    is_frozen,
    load_artifact,
    save_artifact,
)
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import MambaCache
from repro_torch.models.model import forward, init_caches
from repro_torch.obs import Observability, write_chrome_trace, write_prometheus
from repro_torch.obs.hwcost import HardwareCostModel
from repro_torch.obs.metrics import METRICS_SCHEMA_VERSION
from repro_torch.obs.trace import request_track
from repro_torch.serve.scheduler import (  # noqa: F401  (Request re-exported)
    PagedScheduler,
    Request,
    base_metrics,
    mk_positions,
    pow2_bucket,
)
from repro_torch.spec import SpecConfig


def _refuse_paged_knobs(cfg: ModelConfig, kv_dtypes, paged_attn, spec,
                        prefix_cache: bool, analysis_debug: bool) -> None:
    """The reference's errors for knobs that exist only on the paged
    runtime."""
    if cfg.kv_dtype != "fp16" or any(dt != "fp16"
                                     for dt in (kv_dtypes or {}).values()):
        raise ValueError(
            "quantized KV (kv_dtype/kv_dtypes) lives in the paged runtime's "
            "page pool; the dense slot runtime has no pages — drop kv_dtype= "
            "or use runtime='paged'")
    if paged_attn not in (None, "auto"):
        raise ValueError(
            "paged_attn selects the paged runtime's attention read; the dense "
            "slot runtime has no page tables — drop paged_attn= or use "
            "runtime='paged'")
    if spec is not None:
        raise ValueError(
            "speculative decoding runs on the paged runtime only (draft "
            "rollback needs page tables); drop spec= or use runtime='paged'")
    if prefix_cache:
        raise ValueError(
            "prefix caching shares physical KV pages between requests; the "
            "dense slot runtime has no page tables to share — drop "
            "prefix_cache= or use runtime='paged'")
    if analysis_debug:
        raise ValueError(
            "analysis_debug validates paged-pool launch plans; the dense slot "
            "runtime has no pages — drop analysis_debug= or use "
            "runtime='paged'")


def _to_device(tree, dev: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def make_prefill_step(cfg: ModelConfig):
    """(params, caches, tokens [B,T], positions) → (logits of the last
    position [B,V], caches): a prefill into empty dense caches."""

    def prefill(params, caches, tokens, positions):
        logits, caches = forward(params, tokens, cfg, positions, caches,
                                 update_cache=True, last_logit_only=True)
        return logits[:, -1], caches

    return prefill


def make_serve_step(cfg: ModelConfig):
    """Single-token decode over dense caches: (params, caches, token [B,1],
    positions [B,1]) → (logits [B,V], caches)."""

    def serve_step(params, caches, token, positions):
        logits, caches = forward(params, token, cfg, positions, caches)
        return logits[:, 0], caches

    return serve_step


def scatter_cache_row(caches, c1, slot: int):
    """Copy batch row 0 of the batch-1 cache tree ``c1`` into row ``slot`` of
    the batch tree, in place: KVCache k/v ``[P, B, S, kv, hd]``, MambaCache
    conv ``[P, B, conv-1, ch]`` and ssm ``[P, B, H, Pd, S]``; the stacked
    ``length`` takes the elementwise max (per-slot lengths live on the host
    and reach the model as positions).  Returns ``caches``."""
    for key, big in caches.items():
        small = c1[key]
        if isinstance(big, MambaCache):
            big.conv[:, slot] = small.conv[:, 0].to(big.conv.dtype)
            big.ssm[:, slot] = small.ssm[:, 0].to(big.ssm.dtype)
            continue
        big.k[:, slot] = small.k[:, 0].to(big.k.dtype)
        big.v[:, slot] = small.v[:, 0].to(big.v.dtype)
        torch.maximum(big.length, small.length, out=big.length)
    return caches


def make_prefill_into_slot(cfg: ModelConfig, max_len: int):
    """Slot prefill: (params, caches, tokens [1,T_bucket], positions,
    last_idx [1], slot) → (logits [1,V], caches).  The prompt prefills into
    a fresh batch-1 cache of ``max_len`` rows, whose rows are then copied
    into row ``slot`` of the batch tree."""

    def prefill(params, caches, tokens, positions, last_idx, slot):
        c1 = init_caches(cfg, 1, max_len, cfg.dtype(), device=tokens.device)
        logits, c1 = forward(params, tokens, cfg, positions, c1,
                             last_idx=last_idx, update_cache=True)
        return logits[:, 0], scatter_cache_row(caches, c1, slot)

    return prefill


def _sample(req: Request, row: np.ndarray, greedy: bool) -> int:
    """Greedy argmax (first max), else a draw from softmax(row) seeded by
    the request and its token count, as the paged scheduler draws."""
    if greedy:
        return int(np.argmax(row))
    gen = torch.Generator().manual_seed((req.uid << 20) + len(req.generated))
    probs = torch.softmax(torch.from_numpy(row).double(), dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen))


class _SlotRuntime:
    """Fixed-slot continuous batching over a dense [B, max_len] cache."""

    def __init__(self, cfg: ModelConfig, params: Any, batch_size: int,
                 max_len: int, greedy: bool = True,
                 obs: Optional[Observability] = None, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.b = batch_size
        self.max_len = max_len
        self.greedy = greedy
        self.device = resolve_device(device)
        self.caches = init_caches(cfg, batch_size, max_len, cfg.dtype(),
                                  device=self.device)
        # prompt padding is sound for attention mixers only (pad KV rows stay
        # masked until decode overwrites them); a recurrent mixer would carry
        # the pads in its state, so such stacks prefill at the exact length
        self._bucketed = all(cfg.mixer_kind(p) == "attn"
                             for p in range(cfg.period))
        self.obs = obs if obs is not None else Observability.make()
        reg = self.obs.registry
        self._tr = self.obs.tracer
        self._c_prefill_compiles = reg.counter(
            "slot_prefill_compiles", "per-slot prefill shape compiles")
        self._c_out = reg.counter("sched_out_tokens", "tokens emitted")
        self._h_ttft = reg.histogram(
            "req_ttft_seconds", "submit to first token")
        self._h_itl = reg.histogram("req_itl_seconds", "inter-token latency")
        # the first prefill of a bucket shape counts as its compile (the
        # reference jit-compiles the slot prefill once per bucket)
        self._buckets: set = set()
        self._prefill_into = make_prefill_into_slot(cfg, max_len)
        self._decode = make_serve_step(cfg)
        self.slots: List[Optional[Request]] = [None] * batch_size
        self.slot_len = np.zeros(batch_size, dtype=np.int64)
        self.cur_token = np.zeros(batch_size, dtype=np.int32)
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}

    @property
    def prefill_compiles(self) -> int:
        return int(self._c_prefill_compiles.total)

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(self.device)

    def _run_prefill(self, tokens: np.ndarray, last: int, slot: int):
        t = tokens.shape[1]
        if t not in self._buckets:
            self._buckets.add(t)
            self._c_prefill_compiles.inc()
        pos = mk_positions(self.cfg, self._tensor(np.arange(t)[None]))
        with torch.inference_mode():
            logits, self.caches = self._prefill_into(
                self.params, self.caches, self._tensor(tokens), pos,
                self._tensor([last]), slot)
            return logits.float().cpu().numpy()

    def _run_decode(self, tokens: np.ndarray, positions: np.ndarray):
        pos = mk_positions(self.cfg, self._tensor(positions))
        with torch.inference_mode():
            logits, self.caches = self._decode(self.params, self.caches,
                                               self._tensor(tokens), pos)
            return logits.float().cpu().numpy()

    # -- admission -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt of {len(req.prompt)} tokens does "
                f"not fit max_len={self.max_len}")
        req.submit_t = time.perf_counter()
        self.queue.append(req)
        if self._tr.enabled:
            self._tr.instant("submit", request_track(req.uid),
                             ts=req.submit_t, prompt_tokens=len(req.prompt),
                             max_new_tokens=req.max_new_tokens)

    def _admit(self) -> None:
        for i in range(self.b):
            if self.slots[i] is None and self.queue:
                self._prefill_slot(i, self.queue.pop(0))

    def _prefill_slot(self, i: int, req: Request) -> None:
        """Prefill straight into slot ``i``: the prompt padded to the next
        power-of-two length (at least 4, at most max_len) for attention
        stacks; the pad rows stay masked (``kpos <= tpos``) until decode
        overwrites them.  Recurrent stacks use the exact length."""
        t0 = len(req.prompt)
        if self._tr.enabled:
            self._tr.begin("running", request_track(req.uid), slot=i,
                           prompt_tokens=t0)
        t_pf = time.perf_counter()
        bucket = (min(pow2_bucket(t0, lo=4), self.max_len) if self._bucketed
                  else t0)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :t0] = req.prompt
        logits = self._run_prefill(toks, t0 - 1, i)
        tok = _sample(req, logits[0], self.greedy)
        now = time.perf_counter()
        req.first_token_t = now
        self._h_ttft.observe(now - req.submit_t)
        req.token_times.append(now)
        req.generated.append(tok)
        self._c_out.inc()
        if self._tr.enabled:
            track = request_track(req.uid)
            self._tr.complete("prefill", track, t_pf, now - t_pf,
                              tokens=t0, bucket=bucket)
            self._tr.instant("token", track, ts=now, n=1)
        if req.on_token is not None:
            req.on_token(req.uid, tok)
        self.slots[i] = req
        self.slot_len[i] = t0 + 1
        self.cur_token[i] = tok

    # -- decode --------------------------------------------------------------
    def step(self) -> int:
        """Admit, then one batched decode step over every slot; returns the
        number of active slots."""
        self._admit()
        active = [i for i in range(self.b) if self.slots[i] is not None]
        if not active:
            return 0
        logits = self._run_decode(self.cur_token[:, None],
                                  (self.slot_len - 1)[:, None])
        now = time.perf_counter()
        for i in active:
            req = self.slots[i]
            tok = _sample(req, logits[i], self.greedy)
            if req.token_times:
                self._h_itl.observe(now - req.token_times[-1])
            req.token_times.append(now)
            req.generated.append(tok)
            self._c_out.inc()
            if self._tr.enabled:
                self._tr.instant("token", request_track(req.uid), ts=now,
                                 n=len(req.generated))
            if req.on_token is not None:
                req.on_token(req.uid, tok)
            self.slot_len[i] += 1
            self.cur_token[i] = tok
            exhausted = len(req.generated) >= req.max_new_tokens
            if (tok == req.eos_id or exhausted
                    or self.slot_len[i] >= self.max_len):
                req.finish_t = now
                self.done[req.uid] = req
                self.slots[i] = None
                if self._tr.enabled:
                    track = request_track(req.uid)
                    self._tr.instant("finish", track, ts=now,
                                     tokens=len(req.generated))
                    self._tr.end("running", track, ts=now)
        return len(active)

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        for _ in range(max_steps):
            if not self.step() and not self.queue:
                break
        return self.done

    def warmup(self) -> int:
        """Run every prefill length bucket and the decode step once; the
        outputs are discarded and the engine's caches keep their contents
        (each bucket prefills into a throwaway copy of them).  Recurrent
        stacks warm the decode step only.  Returns the shapes run."""
        buckets, b = [], 4
        while self._bucketed and b < self.max_len:
            buckets.append(b)
            b *= 2
        if self._bucketed:
            buckets.append(self.max_len)
        live = self.caches
        self.caches = init_caches(self.cfg, self.b, self.max_len,
                                  self.cfg.dtype(), device=self.device)
        try:
            for t in dict.fromkeys(buckets):
                self._run_prefill(np.zeros((1, t), np.int32), t - 1, 0)
            self._run_decode(np.zeros((self.b, 1), np.int32),
                             np.zeros((self.b, 1), np.int32))
        finally:
            self.caches = live
        return len(buckets) + 1

    def metrics(self) -> Dict[str, Any]:
        return {**base_metrics("slots", self.done, int(self._c_out.total)),
                "prefill_compiles": self.prefill_compiles}


class ServeEngine:
    """Freeze-once DA weights in front, one of two serving runtimes behind
    (``PagedScheduler`` or the fixed-slot runtime)."""

    def __init__(self, cfg: ModelConfig, params: Any, batch_size: int,
                 max_len: int, greedy: bool = True,
                 da_mode: Optional[str] = None, da_pin_modes: bool = True,
                 runtime: str = "auto", page_size: int = 16,
                 n_pages: Optional[int] = None, prefill_chunk: int = 16,
                 prefill_lanes: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 admission: str = "reserve", spec=None,
                 prefix_cache: bool = False, paged_attn: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 kv_dtypes: Optional[Dict[str, str]] = None,
                 trace: bool = False, obs: Optional[Observability] = None,
                 hw: Optional[HardwareCostModel] = None,
                 analysis_debug: bool = False, device="cuda"):
        # da_mode: freeze float params through the planner ("auto": a
        # backend per layer from measured + analytic costs at m_hint =
        # batch_size) or pin every layer to a registered backend; None /
        # "float" keeps float weights.  da_pin_modes=False keeps runtime
        # shape dispatch on the frozen artifact (prefill and decode may then
        # run different backends) instead of baking in the decode plan.
        # paged_attn: "gather"
        # | "fused" | "auto" (fused on CUDA, gather on the CPU); None
        # inherits cfg.paged_attn.  kv_dtype: KV page precision ("fp16" |
        # "int8" | "int4"); None inherits cfg.kv_dtype; kv_dtypes overrides
        # it per layer position.  spec: a SpecConfig, or a provider name
        # ("bitplane" | "layerskip" | "artifact") with its defaults.
        # prefix_cache: shared-prefix caching with copy-on-write pages.
        # trace: turn on the event recorder (export with write_trace()); the
        # metrics registry is always on.  obs: a prebuilt Observability
        # bundle instead (overrides trace=); each engine otherwise builds its
        # own, so two engines never share series.  hw: a HardwareCostModel
        # pricing the served work on the paper's DA circuits; None derives
        # it from the artifact or the frozen params (float weights: none).
        # runtime: "paged", "slots" or "auto" (paged when every mixer is
        # attention, slots for ssm and hybrid stacks).  The scheduler knobs
        # (greedy, prefill_chunk, prefill_lanes, token_budget, admission,
        # analysis_debug) pass through to PagedScheduler; the slot runtime
        # takes greedy and refuses the paged-only ones (kv_dtype(s),
        # paged_attn, spec, prefix_cache, analysis_debug).
        self.device = resolve_device(device)
        # the KV precision is part of the frozen model (the artifact records
        # it); the attention read is a choice of this engine
        if kv_dtype is not None:
            cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        #: the DAArtifact this engine froze or booted from, else None
        self.artifact: Optional[DAArtifact] = None
        if da_mode not in (None, "float") and not is_frozen(params):
            self.artifact = freeze_model(
                params, DAConfig(x_signed=True), mode=da_mode,
                m_hint=batch_size, model_cfg=cfg, pin_modes=da_pin_modes,
                kv_dtype_overrides=kv_dtypes, device=self.device)
            params = self.artifact.params
        else:
            params = _to_device(params, self.device)
        if hw is None:
            if self.artifact is not None:
                hw = self.artifact.hwcost
            elif is_frozen(params):
                hw = HardwareCostModel.from_frozen(params, period=cfg.period)
        self.hw = hw if hw else None
        self.obs = obs if obs is not None else Observability.make(trace=trace)
        if isinstance(spec, str):
            spec = SpecConfig(provider=spec)
        self.cfg = cfg
        self.params = params
        self.b = batch_size
        self.max_len = max_len
        if runtime == "auto":
            runtime = ("paged" if all(cfg.mixer_kind(p) == "attn"
                                      for p in range(cfg.period)) else "slots")
        self.runtime = runtime
        if runtime == "paged":
            self._rt = PagedScheduler(
                cfg, params, batch_size=batch_size, max_len=max_len,
                greedy=greedy, page_size=page_size, n_pages=n_pages,
                prefill_chunk=prefill_chunk, prefill_lanes=prefill_lanes,
                token_budget=token_budget, admission=admission, spec=spec,
                prefix_cache=prefix_cache, paged_attn=paged_attn,
                kv_dtypes=kv_dtypes, obs=self.obs, hw=self.hw,
                analysis_debug=analysis_debug, device=self.device)
        elif runtime == "slots":
            _refuse_paged_knobs(cfg, kv_dtypes, paged_attn, spec,
                                prefix_cache, analysis_debug)
            self._rt = _SlotRuntime(cfg, params, batch_size, max_len, greedy,
                                    obs=self.obs, device=self.device)
        else:
            raise ValueError(f"unknown runtime {runtime!r} "
                             "(expected auto | paged | slots)")
        self.cfg = self._rt.cfg

    # -- freeze-once, serve-many ---------------------------------------------
    @classmethod
    def from_artifact(cls, directory: str, batch_size: int, max_len: int,
                      kv_dtype: Optional[str] = None, device="cuda",
                      **kw) -> "ServeEngine":
        """Boot the serving runtime from a persisted DA artifact: the packed
        weights come straight off disk onto ``device``; ``kw`` are the
        engine's runtime knobs (``prefix_cache``, ``spec``, ...).

        KV precision follows the artifact: the plan's wk entries record the
        page dtype of each layer position, and the pool is built to match.
        An explicit ``kv_dtype`` (or ``kv_dtypes``) overrides a homogeneous
        plan and raises on a per-position one (it would flatten it)."""
        art = load_artifact(directory, device=device)
        if art.model_cfg is None:
            raise ValueError(f"artifact {directory} carries no model config; "
                             "it cannot be served")
        plan_kv: Dict[str, str] = {}
        for key, p in art.plan.items():
            if p.kv_dtype is not None and key.endswith("/wk"):
                seg = next((s for s in key.split("/") if s.startswith("pos_")),
                           None)
                if seg is not None:
                    plan_kv[seg] = p.kv_dtype
        explicit = kv_dtype is not None or bool(kw.get("kv_dtypes"))
        if explicit and len(set(plan_kv.values())) > 1:
            raise ValueError(
                f"artifact {directory} was frozen with per-layer KV dtypes "
                f"{plan_kv}; overriding them with a global kv_dtype= would "
                "silently flatten the plan — drop the override or re-freeze")
        if not explicit and plan_kv:
            kw["kv_dtypes"] = plan_kv
        kw.setdefault("hw", art.hwcost)  # the manifest's cost table
        eng = cls(art.model_cfg, art.params, batch_size, max_len,
                  kv_dtype=kv_dtype, device=device, **kw)
        eng.artifact = art
        return eng

    def save_artifact(self, directory: str) -> str:
        """Persist this engine's frozen weights + plan for later cold boots."""
        if self.artifact is None:
            raise ValueError("engine holds no DAArtifact (constructed without "
                             "da_mode and not from_artifact) — nothing to save")
        return save_artifact(directory, self.artifact)

    # -- runtime delegation --------------------------------------------------
    @property
    def queue(self) -> List[Request]:
        return self._rt.queue

    @property
    def done(self) -> Dict[int, Request]:
        return self._rt.done

    @property
    def caches(self):
        return self._rt.caches

    def submit(self, req: Request) -> None:
        self._rt.submit(req)

    def step(self) -> int:
        return self._rt.step()

    def run(self, max_steps: int = 100_000) -> Dict[int, Request]:
        return self._rt.run(max_steps)

    def warmup(self) -> int:
        """Run every step shape of the runtime once."""
        return self._rt.warmup()

    def metrics(self) -> Dict[str, Any]:
        return self._rt.metrics()

    # -- observability export ------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, Any]:
        """Flat registry snapshot (every counter, gauge and histogram
        series), the schema the Prometheus export shares."""
        return self.obs.registry.snapshot()

    def write_trace(self, path: str) -> str:
        """Dump the recorded events as Chrome trace_event JSON (loadable in
        Perfetto); empty unless the recorder is on (``trace=True``)."""
        return write_chrome_trace(path, self.obs.tracer)

    def write_metrics(self, path: str) -> str:
        """Dump the registry in Prometheus text exposition format."""
        return write_prometheus(path, self.obs.registry)

    def write_hw_metrics(self, path: str) -> str:
        """Dump ``metrics()["hw"]`` (the DA hardware-cost block, null without
        a cost model) as schema-stamped JSON."""
        payload = {"metrics_schema_version": METRICS_SCHEMA_VERSION,
                   "hw": self.metrics().get("hw")}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        return path
