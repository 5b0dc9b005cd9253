"""Deterministic, stateless, shardable data pipeline.

Every batch is a pure function of ``(seed, step)`` — no iterator state to
checkpoint, any host can materialize any shard, and elastic re-scaling (a
different number of hosts after restart) changes nothing about the stream.
This is the property that makes checkpoint/restart and elasticity trivial:
restoring a run only needs the step counter.

Two modes:
  * uniform synthetic tokens (throughput/dry-run work), and
  * packed "documents" (zipf unigram docs of random length packed to seq_len
    with EOS separators — exercises real padding/packing behavior).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    packed: bool = False
    eos_id: int = 0
    mean_doc_len: int = 512
    embed_dim: int = 0      # >0 → modality-stub embeddings instead of tokens
    mrope: bool = False     # emit 3-D position ids


def _rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step & 0x7FFFFFFF])
    )


def _packed_tokens(cfg: DataConfig, rng: np.random.Generator) -> np.ndarray:
    b, t = cfg.global_batch, cfg.seq_len
    out = np.empty((b, t + 1), dtype=np.int32)
    ranks = np.arange(1, cfg.vocab, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    for i in range(b):
        row, fill = [], 0
        while fill < t + 1:
            dl = int(rng.exponential(cfg.mean_doc_len)) + 1
            doc = rng.choice(cfg.vocab - 1, size=dl, p=probs) + 1
            row.append(doc.astype(np.int32))
            row.append(np.array([cfg.eos_id], dtype=np.int32))
            fill += dl + 1
        out[i] = np.concatenate(row)[: t + 1]
    return out


def batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """The (seed, step) → batch pure function."""
    rng = _rng(cfg, step)
    b, t = cfg.global_batch, cfg.seq_len
    if cfg.embed_dim:
        emb = rng.standard_normal((b, t, cfg.embed_dim), dtype=np.float32)
        labels = rng.integers(0, cfg.vocab, (b, t), dtype=np.int32)
        batch = {"inputs": emb, "labels": labels}
    else:
        if cfg.packed:
            toks = _packed_tokens(cfg, rng)
        else:
            toks = rng.integers(0, cfg.vocab, (b, t + 1), dtype=np.int32)
        batch = {"inputs": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.mrope:
        pos = np.broadcast_to(
            np.arange(t, dtype=np.int32)[None, :, None], (b, t, 3)
        ).copy()
        batch["positions"] = pos
    return batch


def host_shard(batch: Dict[str, np.ndarray], host_id: int, n_hosts: int):
    """Slice a global batch for one host (multi-host data loading)."""
    out = {}
    for k, v in batch.items():
        per = v.shape[0] // n_hosts
        out[k] = v[host_id * per : (host_id + 1) * per]
    return out


def iterate(cfg: DataConfig, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield batch_at(cfg, step)
        step += 1


def for_model(mcfg: ModelConfig, seq_len: int, global_batch: int,
              seed: int = 0, packed: bool = False) -> DataConfig:
    return DataConfig(
        vocab=mcfg.vocab,
        seq_len=seq_len,
        global_batch=global_batch,
        seed=seed,
        packed=packed,
        embed_dim=mcfg.d_model if mcfg.modality != "text" else 0,
        mrope=mcfg.mrope_sections is not None,
    )
