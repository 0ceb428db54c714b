"""Starting a world of ranks for a mesh: one command line, as the JAX CLI's
`train --mesh dp,mp` is one command.

`launch(fn, world, args)` spawns `world` processes (start method "spawn")
that meet on 127.0.0.1 at a free port, each running fn(rank, world, device,
*args) under an initialized `torch.distributed` group, and returns rank
0's return value (tensors in it as numpy arrays). Where the rank / world
variables of `torchrun` are set, the process is already one rank of a
world: it joins it and runs fn itself, spawning nothing.

- Backend: NCCL where every rank has a GPU of its own; gloo on the CPU and
  where ranks outnumber the GPUs (ranks that share one card compute on it,
  and gloo moves their CUDA tensors). The backend and the rank -> device
  map go to stderr.
- A rank that raises sends its traceback and exits non-zero; the parent
  then stops the others and raises, so a failed rank fails the command.
  `init_process_group` and every collective have a timeout, so a lost rank
  fails the run instead of hanging it.
- `kernels`: the CUDA libraries (`ops/cuda_build.load` names) the ranks'
  path needs, built once in the parent before the spawn.
- fn must be a module-level function the children can import again: one
  of this package (the tests' `runs.run_cases`, the CLI's), or of the
  main script, which spawn runs again in each child under another name
  (`chip_smoke.py`'s phase 9). Nothing that imports JAX may reach them.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import sys
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pick_backend(world: int, device_type: str) -> str:
    """NCCL when each of the `world` ranks has a GPU of its own, else gloo."""
    if device_type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def _to_host(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _init(backend: str, device: torch.device, timeout_s: int, init_method=None, rank=None, world=None) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout_s))
    if init_method is not None:
        kw.update(init_method=init_method, rank=rank, world_size=world)
    if backend == "nccl":
        kw["device_id"] = device
    dist.init_process_group(**kw)


def _rank_main(rank, world, port, backend, device_type, fn, args, results, threads, timeout_s):
    torch.set_num_threads(threads)
    device = rank_device(rank, device_type)
    try:
        _init(backend, device, timeout_s, f"tcp://127.0.0.1:{port}", rank, world)
        out = fn(rank, world, device, *args)
        if rank == 0:
            results.put((rank, True, _to_host(out)))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()  # the traceback is in the pipe before the exit
        sys.stderr.flush()
        os._exit(1)


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def launch(fn: Callable, world: int, args: Sequence[Any] = (), device_type: str = "cpu",
           kernels: Sequence[str] = (), threads: int = 1, timeout_s: int = TIMEOUT_S) -> Any:
    """Run fn(rank, world, device, *args) on `world` ranks; rank 0's
    return value (see the module docstring). Raises RuntimeError with the
    failing rank's traceback if any rank fails."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA world was asked for, but no CUDA device is available")
        from ..ops import cuda_build

        for name in kernels:
            cuda_build.load(name)
    if _torchrun_env():
        rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if n != world:
            raise RuntimeError(f"torchrun started {n} ranks; the mesh needs {world}")
        device = rank_device(int(os.environ.get("LOCAL_RANK", rank)), device_type)
        backend = pick_backend(int(os.environ.get("LOCAL_WORLD_SIZE", n)), device_type)
        _init(backend, device, timeout_s)
        print(f"world: rank {rank} of {n}, backend {backend}, device {device}", file=sys.stderr)
        try:
            return fn(rank, n, device, *args)
        finally:
            dist.destroy_process_group()
    backend = pick_backend(world, device_type)
    devices = ", ".join(f"{r}->{rank_device(r, device_type)}" for r in range(world))
    print(f"world: {world} ranks, backend {backend}, ranks -> devices {devices}", file=sys.stderr)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, backend, device_type, fn, tuple(args), results,
                                                  threads, timeout_s)) for r in range(world)]
    for p in procs:
        p.start()
    out, failure = None, None
    got = False
    deadline = time.monotonic() + 4 * timeout_s
    try:
        while failure is None:
            try:
                rank, ok, payload = results.get(timeout=0.2)
                if not ok:
                    failure = f"rank {rank} failed:\n{payload}"
                    break
                out, got = payload, True
            except queue_mod.Empty:
                pass
            codes = [p.exitcode for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:  # its traceback may still be on its way
                try:
                    rank, ok, payload = results.get(timeout=2.0)
                    failure = f"rank {rank} failed:\n{payload}" if not ok else None
                except queue_mod.Empty:
                    pass
                failure = failure or f"rank {bad[0][0]} exited with code {bad[0][1]}"
            elif all(c == 0 for c in codes):
                if not got:
                    try:  # rank 0's result, flushed before it exited
                        rank, ok, payload = results.get(timeout=5.0)
                        out, got = payload, ok
                    except queue_mod.Empty:
                        pass
                if not got:
                    failure = "every rank exited without a result from rank 0"
                break
            elif time.monotonic() > deadline:
                failure = f"the world did not finish within {4 * timeout_s} s"
    finally:
        for p in procs:
            if p.is_alive() and failure is not None:
                p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        raise RuntimeError(f"{world}-rank world ({backend}): {failure}")
    return out
