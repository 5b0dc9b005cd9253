"""Fault-tolerant single-device trainer.

Layers of defense, as in the reference (``repro/train/trainer.py``):
  * NaN/inf guard — non-finite grads skip the update on the device
    (``optim/adamw.py``), so one bad batch never poisons the parameters;
  * checkpoint/restart — async checksummed checkpoints every N steps; the
    loop catches step-level exceptions, restores the last checkpoint and
    replays (the stateless data pipeline makes replay exact);
  * straggler monitor — per-step wall-time EWMAs with a z-threshold flag;
  * microbatching — gradients accumulated in float32 over the microbatches
    (the reference's ``lax.scan``), memory constant in their number;
  * remat — ``cfg.remat`` recomputes each block in the backward
    (``repro_torch.models.model``).

The step runs eagerly: each microbatch's loss and gradients come from
``torch.autograd.grad`` over detached aliases of the params, its products
on ``torch.matmul`` (the reference computes them outside any Pallas
kernel: training runs no hand-written kernel).  The loop reads the step's
metrics on the host once per step.  Distributed training (meshes, sharded
state, compressed all-reduce) is not part of this module.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as C
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import forward, init_model, lm_loss
from repro_torch.optim import adamw
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatches: int = 1
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    straggler_z: float = 3.0


class TrainState(NamedTuple):
    step: torch.Tensor   # int32 scalar on the params' device
    params: Any
    opt: adamw.AdamWState


def init_state(cfg: ModelConfig, seed: int = 0, device="cuda") -> TrainState:
    """Random params from ``seed`` on ``device`` and a fresh optimizer."""
    params = init_model(cfg, seed=seed, device=device)
    return state_from_params(params)


def state_from_params(params) -> TrainState:
    """A step-0 train state over ``params`` (float tensors, one device).
    The state owns the tensors: each step updates them in place."""
    return TrainState(
        step=torch.zeros((), dtype=torch.int32, device=leaves(params)[0].device),
        params=params, opt=adamw.init(params))


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    logits, _ = forward(params, batch["inputs"], cfg,
                        positions=batch.get("positions"))
    return lm_loss(logits, batch["labels"])


def value_and_grad(params, batch, cfg: ModelConfig):
    """(loss, grads): ``loss_fn`` and its gradient with respect to every
    leaf of ``params``, as a tree like ``params`` in the params' dtypes.
    The batch (numpy arrays or tensors) moves to the params' device."""
    xs = [p.detach().requires_grad_(True) for p in leaves(params)]
    it = iter(xs)
    batch = _to_device(batch, xs[0].device)
    loss = loss_fn(tree_map(lambda _: next(it), params), batch, cfg)
    grads = iter(torch.autograd.grad(loss, xs))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                               else v, device=device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig
                    ) -> Callable[[TrainState, Dict[str, Any]], tuple]:
    """The train step: loss and grads (accumulated over microbatches in
    float32) → clipped AdamW update with NaN guard.  The batch may hold
    numpy arrays or tensors; it moves to the params' device.  Returns
    ``(state, metrics)``, the metrics float32 scalars on the device."""

    def train_step(state: TrainState, batch):
        mb = tcfg.microbatches
        batch = _to_device(batch, state.step.device)
        if mb > 1:
            loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), state.params)
            for i in range(mb):
                mbatch = {k: x.reshape((mb, x.shape[0] // mb) + x.shape[1:])[i]
                          for k, x in batch.items()}
                l, g = value_and_grad(state.params, mbatch, cfg)
                loss = loss + l / mb
                for a, b in zip(leaves(grads), leaves(g)):
                    a.add_(b / mb)
                del g
        else:
            loss, grads = value_and_grad(state.params, batch, cfg)

        lr_scale = warmup_cosine(state.step, tcfg.warmup_steps, tcfg.total_steps)
        params, opt, metrics = adamw.update(grads, state.opt, state.params,
                                            tcfg.opt, lr_scale)
        metrics["loss"] = loss
        return TrainState(step=state.step + 1, params=params, opt=opt), metrics

    return train_step


class StragglerMonitor:
    """EWMA step-time tracker; flags steps slower than mean + z·std."""

    def __init__(self, z: float = 3.0, alpha: float = 0.1):
        self.z, self.alpha = z, alpha
        self.mean = None
        self.var = 0.0
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        slow = dt > self.mean + self.z * (self.var ** 0.5) and dt > 1.5 * self.mean
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        self.flagged += int(slow)
        return slow


class Trainer:
    """Checkpoint/restart training loop: everything stateful lives in
    (TrainState, step) and the stateless data pipeline."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, data_iter_fn):
        self.cfg, self.tcfg = cfg, tcfg
        self.data_iter_fn = data_iter_fn  # step → batch (pure)
        self.step_fn = make_train_step(cfg, tcfg)
        self.monitor = StragglerMonitor(z=tcfg.straggler_z)
        self.ckpt = None
        if tcfg.ckpt_dir:
            self.ckpt = C.AsyncCheckpointer(tcfg.ckpt_dir, keep=tcfg.keep_ckpts,
                                            period=cfg.period)

    def _maybe_restore(self, state: TrainState) -> TrainState:
        """The last checkpoint, once every submitted one is on disk; the
        state as it is without a checkpoint directory or checkpoint."""
        if not self.tcfg.ckpt_dir:
            return state
        self.ckpt.wait()
        last = C.latest_step(self.tcfg.ckpt_dir)
        if last is None:
            return state
        return C.restore(self.tcfg.ckpt_dir, last, state, period=self.cfg.period)

    def run(self, state: TrainState, n_steps: int, max_retries: int = 3):
        state = self._maybe_restore(state)
        history = []
        retries = 0
        step = int(state.step)
        while step < n_steps:
            try:
                batch = self.data_iter_fn(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batch)
                # the step's one read on the host
                values = torch.stack([v.to(torch.float32)
                                      for v in metrics.values()]).tolist()
                metrics = dict(zip(metrics, values))
                dt = time.perf_counter() - t0
                slow = self.monitor.observe(dt)
                metrics.update(step=step, time_s=dt, straggler=slow)
                history.append(metrics)
                step += 1
                if self.ckpt and step % self.tcfg.ckpt_every == 0:
                    self.ckpt.submit(step, state)
                retries = 0
            except (FloatingPointError, RuntimeError):
                # device error / failed step: restore + replay
                retries += 1
                if retries > max_retries or not self.tcfg.ckpt_dir:
                    raise
                state = self._maybe_restore(state)
                step = int(state.step)
        if self.ckpt:
            self.ckpt.wait()
        return state, history
