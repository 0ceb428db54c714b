"""Which collectives a gloo world accepts on CUDA tensors when its ranks
share one card, and how fast they move them; NCCL in a world of one rank.

    python3 scripts/torch_gloo_probe.py

For NCCL at 1 rank and gloo at 2 and 4 ranks (every rank on cuda:0):
all_reduce, all_gather, broadcast, all_gather_into_tensor and
reduce_scatter_tensor of a 4 MiB f32 tensor, each "ok", "wrong" or
"refused" with its ms, then a 256 MiB f32 all_reduce timed after one warm
call. Prints the card's name and power limit first. Needs a GPU; imports
nothing of this repo.
"""

import json
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, world, port, backend, results):
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    res = {}
    for name in ("all_reduce", "all_gather", "broadcast", "all_gather_into_tensor", "reduce_scatter"):
        try:
            t = torch.full((1 << 20,), float(rank + 1), device=dev)
            t0 = time.perf_counter()
            if name == "all_reduce":
                dist.all_reduce(t)
                ok = float(t[0]) == sum(range(1, world + 1))
            elif name == "all_gather":
                out = [torch.empty_like(t) for _ in range(world)]
                dist.all_gather(out, t)
                ok = float(out[-1][0]) == world
            elif name == "broadcast":
                dist.broadcast(t, 0)
                ok = float(t[0]) == 1.0
            elif name == "all_gather_into_tensor":
                out = torch.empty(world * t.numel(), device=dev)
                dist.all_gather_into_tensor(out, t)
                ok = float(out[-1]) == world
            else:
                out = torch.empty(t.numel() // world, device=dev)
                dist.reduce_scatter_tensor(out, t)
                ok = float(out[0]) == sum(range(1, world + 1))
            torch.cuda.synchronize()
            res[name] = ("ok" if ok else "wrong", round((time.perf_counter() - t0) * 1e3, 3))
        except Exception as e:  # a refusal is the measurement
            res[name] = ("refused", repr(e)[:200])
    t = torch.ones(64 << 20, device=dev)
    dist.all_reduce(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist.all_reduce(t)
    torch.cuda.synchronize()
    res["all_reduce_256MiB_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    if rank == 0:
        results.put(res)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, "|", sys.version.split()[0], torch.__version__, torch.version.cuda, flush=True)
    ctx = mp.get_context("spawn")
    for backend, world in (("nccl", 1), ("gloo", 2), ("gloo", 4)):
        results = ctx.SimpleQueue()
        t0 = time.perf_counter()
        procs = [ctx.Process(target=worker, args=(r, world, 29500 + world, backend, results)) for r in range(world)]
        for p in procs:
            p.start()
        res = results.get()
        for p in procs:
            p.join()
        print(backend, world, json.dumps(res), "world s", round(time.perf_counter() - t0, 1),
              [p.exitcode for p in procs], flush=True)
        if any(p.exitcode for p in procs):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
