"""End-to-end driver: train a ~100M-parameter qwen3-family LM for a few
hundred steps on the synthetic packed-document stream, with the full
production substrate — AdamW + warmup-cosine, microbatch accumulation,
NaN guard, straggler monitor, async checksummed checkpointing, and
crash-resume (kill it mid-run and start again: it continues).

Run: PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
[--device cpu]

The reference's ``examples/train_lm.py`` on the port: the same model, flags
and printed lines, plus ``--device`` (default ``cuda``).  The default
checkpoint directory is ``train_lm`` under the system's temporary
directory.
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import batch_at, for_model
from repro_torch.device import resolve_device
from repro_torch.models.model import count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import TrainConfig, Trainer, init_state


def build_cfg():
    # ~100M-param member of the qwen3 family (qk-norm GQA + SwiGLU)
    return dataclasses.replace(
        ARCHS["qwen3-8b"],
        name="qwen3-100m",
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        head_dim=64,
        d_ff=1536,
        vocab=32000,
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "train_lm"))
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu: the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = build_cfg()
    print(f"model: {cfg.name}  params={count_params(cfg)/1e6:.1f}M")

    dc = for_model(cfg, seq_len=args.seq, global_batch=args.batch, packed=True)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=6e-4),
        warmup_steps=20,
        total_steps=args.steps,
        microbatches=2,
        ckpt_every=50,
        ckpt_dir=args.ckpt_dir,
    )
    trainer = Trainer(cfg, tcfg, lambda s: batch_at(dc, s))
    state = init_state(cfg, seed=0, device=device)
    state, hist = trainer.run(state, args.steps)

    for h in hist[:: max(1, len(hist) // 15)]:
        flag = " STRAGGLER" if h["straggler"] else ""
        print(f"step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.2f}  lr {h['lr']:.2e}  "
              f"{h['time_s']*1e3:6.0f} ms{flag}")
    if hist:
        print(f"\nfinal loss {hist[-1]['loss']:.4f} "
              f"(first {hist[0]['loss']:.4f}) over {len(hist)} steps")
    print(f"checkpoints in {args.ckpt_dir} "
          f"(restart this script to resume from the last one)")


if __name__ == "__main__":
    main()
