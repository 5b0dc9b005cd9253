"""Which collectives two ranks on one card can run: NCCL, and gloo on CUDA
tensors (c10d and the functional collectives DTensor redistributes with).

    python3 tools/gloo_cuda_probe.py          # on a machine with a card

Each case runs in two fresh processes on card 0 joined by a file store, so
a case that kills its process (gloo aborts or segfaults on some CUDA
collectives) only ends its own pair.  Prints the card's name and power
limit, then one JSON line: each case ``ok`` or how its processes ended.
``launch/mesh.py`` stages through host memory exactly the cases that do
not come back ``ok``.
"""
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile

CASES = ("nccl_all_reduce", "all_reduce", "broadcast", "all_gather_into_tensor",
         "reduce_scatter_tensor", "all_to_all_single", "isend_irecv",
         "funcol_all_reduce", "funcol_all_gather_tensor",
         "funcol_reduce_scatter_tensor")


def _run(case: str, rank: int, store: str, q) -> None:
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    torch.cuda.set_device(0)
    backend = "nccl" if case.startswith("nccl") else "gloo"
    kw = {"device_id": torch.device("cuda", 0)} if backend == "nccl" else {}
    try:
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=2, **kw)
        x = torch.full((4, 8), float(rank + 1), device="cuda")
        g = dist.group.WORLD
        if case in ("nccl_all_reduce", "all_reduce"):
            dist.all_reduce(x)
        elif case == "broadcast":
            dist.broadcast(x, 0)
        elif case == "all_gather_into_tensor":
            dist.all_gather_into_tensor(torch.empty(8, 8, device="cuda"), x)
        elif case == "reduce_scatter_tensor":
            dist.reduce_scatter_tensor(torch.empty(2, 8, device="cuda"), x)
        elif case == "all_to_all_single":
            dist.all_to_all_single(torch.empty_like(x), x)
        elif case == "isend_irecv":
            y = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x, 1 - rank),
                   dist.P2POp(dist.irecv, y, 1 - rank)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        elif case == "funcol_all_reduce":
            funcol.wait_tensor(funcol.all_reduce(x, "sum", g))
        elif case == "funcol_all_gather_tensor":
            funcol.wait_tensor(funcol.all_gather_tensor(x, 0, g))
        elif case == "funcol_reduce_scatter_tensor":
            funcol.wait_tensor(funcol.reduce_scatter_tensor(x, "sum", 0, g))
        torch.cuda.synchronize()
        q.put((rank, "ok"))
        dist.destroy_process_group()
    except Exception as e:  # the case's own failure, reported
        q.put((rank, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"))


def probe(case: str, timeout: float = 60.0) -> str:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_run, args=(case, r, os.path.join(tmp, "s"), q))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    said = {}
    while not q.empty():
        rank, msg = q.get()
        said[rank] = msg
    if all(said.get(r) == "ok" for r in range(2)):
        return "ok"
    ends = [said.get(r) or f"exit {p.exitcode}" for r, p in enumerate(procs)]
    return "; ".join(sorted(set(ends)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(json.dumps({"torch": torch.__version__,
                      "cases": {c: probe(c) for c in CASES}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
