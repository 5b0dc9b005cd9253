"""Training launcher, one device.

  python -m repro_torch.launch.train --arch qwen3-8b --smoke --steps 100 \\
      --batch 32 --seq 512

The reference's flags, plus ``--device`` (default ``cuda``; ``--device cpu``
runs the plain PyTorch path on the host).  The mesh is one device:
``--mesh 1x1``, the default.  A larger mesh, or ``--fake-devices`` (an XLA
host-platform flag of the reference), exits with a message: distributed
training is the next slice of the port (ROADMAP.md, Queue 1), and nothing is
silently replicated here.  Fault tolerance: ``--ckpt-dir`` enables async
checkpoints + crash resume.
"""
import argparse

#: what a multi-device request is told
DISTRIBUTED = ("this launcher trains on one device; meshes larger than 1x1 "
               "(sharding, GPipe, the compressed all-reduce over "
               "torch.distributed) are the port's distributed slice, still to "
               "come (ROADMAP.md, Queue 1)")


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--mesh", default="1x1", help="one device: 1x1")
    ap.add_argument("--axes", default="data,model")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for the arch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="the reference's placeholder devices; refused here")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu: the plain path)")
    return ap.parse_args(argv)


def main(argv=None):
    args = _parse(argv)
    shape = tuple(int(x) for x in args.mesh.split("x"))
    axes = tuple(args.axes.split(","))
    assert len(shape) == len(axes)
    if args.fake_devices or any(s != 1 for s in shape):
        raise SystemExit(f"--mesh {args.mesh}"
                         + (f" --fake-devices {args.fake_devices}"
                            if args.fake_devices else "")
                         + f": {DISTRIBUTED}")

    from repro_torch.configs.registry import ARCHS, reduce_for_smoke
    from repro_torch.data.pipeline import batch_at, for_model
    from repro_torch.device import resolve_device
    from repro_torch.models.model import count_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer, init_state

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    print(f"arch={cfg.name} params={count_params(cfg)/1e6:.1f}M devices=1")

    dc = for_model(cfg, seq_len=args.seq, global_batch=args.batch, packed=True)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr),
        total_steps=args.steps,
        microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    state = init_state(cfg, seed=0, device=device)
    trainer = Trainer(cfg, tcfg, lambda step: batch_at(dc, step))
    state, hist = trainer.run(state, args.steps)

    for h in hist[:: max(1, len(hist) // 20)]:
        print(f"step {h['step']:5d} loss {h['loss']:.4f} "
              f"gnorm {h['grad_norm']:.2f} {h['time_s']*1e3:.0f} ms"
              + (" STRAGGLER" if h.get("straggler") else ""))
    if trainer.monitor.flagged:
        print(f"stragglers flagged: {trainer.monitor.flagged}")
    print(f"done at step {int(state.step)}")


if __name__ == "__main__":
    main()
