"""Decode steps replayed as CUDA graphs over device-resident state.

The JAX package runs a whole decode loop as one device program: a jitted
`lax.while_loop` (`greedy_generate`, the lookup loops) or `lax.scan` (the
continuous engine's chunks). This module is the port's counterpart. A
decode loop keeps its state in static device tensors (token buffer,
lengths, done flags, PRNG key, block tables, the KV cache or pool), hands
its step (one token, one lookup forward, or a whole chunk of the
continuous engine) to `DecodeGraphs.steps`, and runs it through
`decode_loop`:

- the first run of a step at a key is a real step, run eagerly on a side
  stream. It builds the kernels and makes the buffers that kernels keep
  across calls (`ops.paged_attention._arrival_counters`), so the capture
  allocates none of them. The step is then captured on that stream into a
  `torch.cuda.CUDAGraph` (capture mode "thread_local": the continuous
  engine's preprocessing thread issues CUDA work meanwhile), and every
  later run is a replay on the caller's stream;
- a graph bakes in its shapes, its buffers' addresses, the params' tensors
  and every Python value the step reads. `steps` keys it on all of them
  (the caller names the static values; the identity of every tensor of the
  params and of the static buffers is added here, and so are
  `DEEPSEEK_DECODE_ATTN` and `DEEPSEEK_FUSED_ATTN`, which the step reads)
  and captures at most once a key while the key's tensors live. A graph
  goes as soon as one of the tensors it was keyed on is freed;
- `buffers` keeps a decode's static buffers (a cache and a state, or the
  continuous engine's pool and state) for the next decode of the same
  key, and only while no other key needs buffers: a set of a new key is
  made after every set not in use is dropped, and their graphs with them.
  So the card holds at most one decode's buffers between decodes, as many
  as the eager loop held during one;
- the host reads the loop's flags back every `SYNC_EVERY` runs (1: after
  every replay, as measured below) and never runs more steps than the
  loop's budget (`decode_loop`);
- the kernels' launch counts stay true. The wrappers count in Python
  (`fn.launches += 1`), and a replay calls no wrapper, so the counts a
  capture adds are taken back and recorded a replay, and every replay adds
  them again.

What stays eager: CPU tensors (the same step callable, called; the CPU path
and the tests' path), and params sharded onto a mesh, whose collectives run
through `torch.distributed` process groups (gloo in the tests), which a CUDA
graph cannot capture. `_eager` runs the step eagerly on the card too: it is
private, for the comparisons of `chip_smoke.py` and the tests; no CLI flag
or environment variable reaches it. A failed capture or replay raises.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from typing import Callable, Dict, Hashable, Iterator, List

import torch

# Runs of a step between two readbacks of the loop's flags. A readback leaves
# the card idle while the host waits and launches the next replay; an
# interval above 1 runs up to SYNC_EVERY - 1 frozen steps after the last row
# finished. On pages that end at EOS (scripts/torch_decode_sync.py on an
# H100 80GB HBM3 at 700 W, PERF.md section 6) 1 was faster than 8 by up to
# half on 5-token pages and by 0.1-8 % in seven of eight cells at 60-220
# tokens, and 0.7-1.6 % slower in three of four cells at ~1000 tokens: a
# readback after every replay.
SYNC_EVERY = 1

_EAGER = threading.local()


@contextlib.contextmanager
def _eager() -> Iterator[None]:
    """Run every decode step eagerly on this thread, on the card too (the
    comparisons of chip_smoke.py and the tests); restored on exit."""
    before = getattr(_EAGER, "on", False)
    _EAGER.on = True
    try:
        yield
    finally:
        _EAGER.on = before


def graphed(device: torch.device, params) -> bool:
    """Whether a decode on `device` with `params` replays captured steps:
    CUDA tensors and params on no mesh, outside `_eager`."""
    return device.type == "cuda" and params.get("mesh") is None and not getattr(_EAGER, "on", False)


def decode_loop(run: Callable[[int], object], n_steps: int, alive: Callable[[], bool]) -> None:
    """Run a step up to `n_steps` times, `SYNC_EVERY` runs between two
    readbacks, while `alive()` (one readback) says a row still decodes. A
    step run after every row has finished must change nothing that the
    caller reads."""
    left = n_steps
    while left > 0 and alive():
        n = min(SYNC_EVERY, left)
        run(n)
        left -= n


def _leaves(tree) -> List[torch.Tensor]:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def counted_wrappers() -> list:
    """Every kernel wrapper of the port that counts its launches."""
    from ..ops import (attn_fused, flash_attention, fused_mlp, linear_q4, linear_q8, moe_decode, moe_gmm, moe_q4,
                       moe_q8, paged_attention)

    mods = (attn_fused, flash_attention, fused_mlp, linear_q4, linear_q8, moe_decode, moe_gmm, moe_q4, moe_q8,
            paged_attention)
    fns = {id(f): f for m in mods for f in vars(m).values()
           if callable(f) and isinstance(getattr(f, "launches", None), int)}
    return list(fns.values())


class _Graph:
    __slots__ = ("graph", "out", "per_replay", "label", "capture_ms", "replays", "watch", "serial")

    def __init__(self, graph, out, per_replay, label, capture_ms, watch, serial):
        self.graph, self.out, self.per_replay, self.label = graph, out, per_replay, label
        self.capture_ms, self.replays, self.watch, self.serial = capture_ms, 0, watch, serial


class _Set:
    """A set of static buffers, the lock its decodes take turns on, and the
    number of decodes holding it."""

    __slots__ = ("bufs", "lock", "watch", "users")

    def __init__(self, bufs):
        self.bufs, self.lock, self.watch, self.users = bufs, threading.Lock(), [], 0


class DecodeGraphs:
    """The process's captured decode steps and the static buffers they run
    on, each keyed and kept as the module docstring says."""

    def __init__(self):
        self._lock = threading.RLock()  # one capture at a time in a process (torch.cuda.graph's rule)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._buffers: Dict[Hashable, _Set] = {}
        self.captures: Dict[Hashable, int] = {}  # live key -> captures (at most 1)
        self.replays = 0  # every graph's, evicted ones included
        self.log: List[dict] = []  # one a capture: serial (its index here), label, capture_ms
        # One capture stream a device: cuBLAS keeps a workspace for every
        # stream it runs on, so a fresh stream a capture would add one each.
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}

    def _watch(self, store: dict, key, tensors) -> list:
        return [weakref.finalize(t, self._evict, store, key) for t in tensors]

    def _evict(self, store: dict, key) -> None:
        with self._lock:
            entry = store.pop(key, None)
            if store is self._graphs:
                self.captures.pop(key, None)  # its tensors' ids may come back as another key's
        if entry is not None:
            for f in entry.watch:
                f.detach()

    @contextlib.contextmanager
    def buffers(self, key: Hashable, owners, make: Callable[[], object], static: bool):
        """The static buffers `make()` builds for `key` and the tensors of
        `owners` (the params), kept for the next decode of the key as the
        module docstring says, and held by the caller for the duration of
        the `with` (two decodes at one key take turns). Not `static` (a
        decode that is not `graphed`): fresh buffers a call, as an eager
        loop makes them."""
        if not static:
            yield make()
            return
        key = (key, tuple(map(id, _leaves(owners))))
        with self._lock:
            entry = self._buffers.get(key)
            if entry is None:
                for k in [k for k, e in self._buffers.items() if e.users == 0]:
                    self._evict(self._buffers, k)  # their memory first, as an eager loop frees its own
                entry = self._buffers[key] = _Set(make())
                entry.watch = self._watch(self._buffers, key, _leaves(owners))
            entry.users += 1
        try:
            with entry.lock:
                yield entry.bufs
        finally:
            with self._lock:
                entry.users -= 1

    def steps(self, key: Hashable, label: str, params, state, step: Callable[[], object], device: torch.device,
              graph: bool) -> Callable[[int], object]:
        """`run(n)`: the step run n times, the last run's output returned
        (a captured step's static output, valid until the next run).
        `graph`: replay a graph captured once for the key (see the module
        docstring); else call the step. `state`: the static buffers the
        step reads and writes (a tree of tensors)."""
        if not graph:
            def run_eager(n: int):
                out = None
                for _ in range(n):
                    out = step()
                return out
            return run_eager
        key = (key, os.environ.get("DEEPSEEK_DECODE_ATTN", "pool"), os.environ.get("DEEPSEEK_FUSED_ATTN", "1"),
               tuple(map(id, _leaves(params))), tuple(map(id, _leaves(state))))

        def run(n: int):
            if n <= 0:
                return None
            g = self._graphs.get(key)
            out = None
            if g is None:
                g, out = self._capture(key, label, step, device, _leaves(params) + _leaves(state))
                n -= 1
            if n > 0:
                for _ in range(n):
                    g.graph.replay()
                out = g.out
                g.replays += n
                self.replays += n
                for fn, k in g.per_replay.items():
                    fn.launches += k * n
            return out
        return run

    def _capture(self, key, label: str, step, device: torch.device, tensors):
        """One real step on a side stream, then its capture. Returns the
        graph entry and the real step's output."""
        with self._lock:
            caller = torch.cuda.current_stream(device)
            side = self._streams.get(device)
            if side is None:
                side = self._streams[device] = torch.cuda.Stream(device)
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                out = step()
            wrappers = counted_wrappers()
            before = [fn.launches for fn in wrappers]
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                static = step()
            capture_ms = (time.perf_counter() - t0) * 1e3
            per_replay = {}
            for fn, n0 in zip(wrappers, before):
                if fn.launches != n0:  # the capture launched nothing: a replay does
                    per_replay[fn] = fn.launches - n0
                    fn.launches = n0
            caller.wait_stream(side)
            if torch.is_tensor(out):  # made on the side stream, read on the caller's
                out.record_stream(caller)
            g = _Graph(graph, static, per_replay, label, capture_ms, self._watch(self._graphs, key, tensors),
                       len(self.log))
            self._graphs[key] = g
            self.captures[key] = self.captures.get(key, 0) + 1
            self.log.append({"serial": g.serial, "label": label, "capture_ms": capture_ms})
            return g, out

    def report(self) -> List[dict]:
        """One row a live graph: its serial and label, capture ms, replays,
        the MiB its private memory pool holds on the card, and its launches
        a replay by wrapper name."""
        with self._lock:
            graphs = list(self._graphs.values())
        pools: Dict[tuple, int] = {}
        if graphs:
            for seg in torch.cuda.memory_snapshot():
                pid = tuple(seg["segment_pool_id"])
                pools[pid] = pools.get(pid, 0) + seg["total_size"]
        return [{"serial": g.serial, "label": g.label, "capture_ms": g.capture_ms, "replays": g.replays,
                 "pool_mib": pools.get(tuple(g.graph.pool()), 0) / 2**20,
                 "launches": {fn.__name__: k for fn, k in g.per_replay.items()}} for g in graphs]


RUNNER = DecodeGraphs()
