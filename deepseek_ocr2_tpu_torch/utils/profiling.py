"""Profiling helpers (the port's copy of deepseek_ocr2_tpu/utils/profiling.py).

`device_trace` records a `torch.profiler` trace where the JAX package has
its `jax.profiler` one; `PhaseTimer` is the same wall-clock phase timer.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace of the block (host ops, and the CUDA kernels
    when a GPU is present) written into `log_dir` as
    `<host>_<pid>.<time>.pt.trace.json` (Chrome trace format, which
    TensorBoard's profiler plugin and Perfetto read); a no-op if `log_dir`
    is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class PhaseTimer:
    """Wall-clock per-phase timing with a one-line report."""

    def __init__(self) -> None:
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.phases.values())
        parts = ", ".join(f"{k}={v * 1e3:.1f}ms" for k, v in self.phases.items())
        return f"phases: {parts} (total {total * 1e3:.1f}ms)"
