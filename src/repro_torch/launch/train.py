"""Distributed training launcher.

  python -m repro_torch.launch.train --arch qwen3-8b --steps 100 \\
      --mesh 2x2 --axes data,model --batch 32 --seq 512

The reference's flags, plus ``--device`` (default ``cuda``; ``--device cpu``
runs the plain PyTorch path on the host).  The mesh's ranks come from the
process group:

* under ``torchrun`` (``WORLD_SIZE`` in the environment) each rank runs
  this module, on NCCL with one card a rank (``--device cuda``; gloo for
  ``--device cpu``);
* ``--fake-devices N`` (the counterpart of the reference's placeholder
  devices) starts N local ranks on gloo on ``--device``: with ``cuda`` all
  N share the one card (NCCL refuses two ranks of one card);
* otherwise one process: ``--mesh 1x1`` trains on one device without a
  mesh, as before.

The mesh must hold exactly the world's ranks, or the launcher raises; a
failed NCCL start raises too (it never becomes gloo).  On a mesh the state
is placed by ``tree_pspecs`` and each step's batch by ``batch_pspecs``
under ``LM_RULES``; rank 0 prints.  Fault tolerance: ``--ckpt-dir``
enables async checkpoints + crash resume (a checkpoint resumes on any
mesh).
"""
import argparse
import math
import os


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--mesh", default="1x1", help="e.g. 2x2 or 2x2x2")
    ap.add_argument("--axes", default="data,model")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for the arch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="start N local ranks on gloo (the reference's "
                         "placeholder devices)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu: the plain path)")
    return ap.parse_args(argv)


def _mesh_shape(args):
    shape = tuple(int(x) for x in args.mesh.split("x"))
    axes = tuple(args.axes.split(","))
    if len(shape) != len(axes):
        raise SystemExit(f"--mesh {args.mesh} and --axes {args.axes} differ "
                         "in length")
    return shape, axes


def main(argv=None):
    """Run the launcher; returns rank 0's (printed lines, loss history) when
    it started its own ranks (``--fake-devices``), else this process's."""
    args = _parse(argv)
    shape, _ = _mesh_shape(args)
    if args.fake_devices:
        if "WORLD_SIZE" in os.environ:
            raise SystemExit("--fake-devices starts its own ranks; not under "
                             "torchrun")
        if math.prod(shape) != args.fake_devices:
            raise SystemExit(f"--mesh {args.mesh} needs {math.prod(shape)} "
                             f"ranks; --fake-devices starts {args.fake_devices}")
        from repro_torch.launch.mesh import spawn

        out = spawn(_rank_main, args.fake_devices, (argv,), device=args.device,
                    backend="gloo")
        lines, hist = out[0]
        for line in lines:
            print(line)
        return lines, hist
    if "WORLD_SIZE" in os.environ:
        _init_torchrun(args.device)
    elif math.prod(shape) != 1:
        raise SystemExit(f"--mesh {args.mesh} needs {math.prod(shape)} ranks; "
                         "this process is one (start them with torchrun or "
                         "--fake-devices)")
    return _run(args, echo=True)


def _rank_main(argv):
    """One rank of ``--fake-devices``: its lines and history, unprinted."""
    return _run(_parse(argv), echo=False)


def _init_torchrun(device: str) -> None:
    """Join torchrun's group: NCCL with card ``LOCAL_RANK`` on CUDA, gloo on
    the CPU.  A failed NCCL start raises."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if torch.device(device).type == "cuda":
        card = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(card)
        dist.init_process_group("nccl", device_id=torch.device("cuda", card))
    else:
        dist.init_process_group("gloo")


def _run(args, echo: bool):
    import contextlib

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import ARCHS, reduce_for_smoke
    from repro_torch.data.pipeline import batch_at, for_model
    from repro_torch.device import resolve_device
    from repro_torch.launch import specs as SP
    from repro_torch.launch.mesh import make_test_mesh, world_size
    from repro_torch.launch.sharding import use_mesh_rules
    from repro_torch.models.model import count_params, init_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer, state_from_params

    shape, axes = _mesh_shape(args)
    sharded = dist.is_initialized()
    world = world_size()
    if math.prod(shape) != world:
        raise ValueError(f"--mesh {args.mesh} has {math.prod(shape)} ranks; "
                         f"the world has {world}")
    rank0 = not sharded or dist.get_rank() == 0
    device = resolve_device(args.device)
    if device.type == "cuda" and sharded and dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    lines = []

    def say(line: str) -> None:
        if rank0:
            lines.append(line)
            if echo:
                print(line)

    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    say(f"arch={cfg.name} params={count_params(cfg)/1e6:.1f}M devices={world}")

    dc = for_model(cfg, seq_len=args.seq, global_batch=args.batch, packed=True)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr),
        total_steps=args.steps,
        microbatches=args.microbatches,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    mesh = make_test_mesh(shape, axes, device_type=device.type) if sharded else None
    rules = use_mesh_rules(mesh) if sharded else contextlib.nullcontext()
    with rules:
        params = init_model(cfg, seed=0, device=device)
        if sharded:
            params = SP.place(params, SP.tree_pspecs(params), mesh)
        state = state_from_params(params)

        def data_fn(step):
            batch = {k: torch.as_tensor(np.asarray(v), device=device)
                     for k, v in batch_at(dc, step).items()}
            if not sharded:
                return batch
            return SP.place(batch, SP.batch_pspecs(batch), mesh)

        trainer = Trainer(cfg, tcfg, data_fn)
        state, hist = trainer.run(state, args.steps)

    for h in hist[:: max(1, len(hist) // 20)]:
        say(f"step {h['step']:5d} loss {h['loss']:.4f} "
            f"gnorm {h['grad_norm']:.2f} {h['time_s']*1e3:.0f} ms"
            + (" STRAGGLER" if h.get("straggler") else ""))
    if trainer.monitor.flagged:
        say(f"stragglers flagged: {trainer.monitor.flagged}")
    from repro_torch.launch.sharding import full

    say(f"done at step {int(full(state.step))}")
    return lines, hist


if __name__ == "__main__":
    main()
