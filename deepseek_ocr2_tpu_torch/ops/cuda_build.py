"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes plain `extern "C"` entry points. It is compiled
with nvcc for sm_90a into `build/torch_kernels/` at the repo root, at first
use, under a name keyed by a hash of the source and of the shared headers
(`csrc/*.cuh`), and bound with ctypes (no
PyTorch headers, so a build takes seconds, not minutes). Nothing here runs
at import: the CPU tests import every module.

Bound functions take every pointer and the stream as `ctypes.c_void_p` and
return `cudaGetLastError()` after the launch; `check` raises on non-zero.
`entry` binds an entry point's argtypes once.
Every wrapper checks its inputs with `require_cuda`, which also refuses an
input that requires grad while grad mode is on (`refuse_autograd`): a
kernel's output has no autograd history.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: Dict[str, float] = {}
BUILD_LOG: Dict[str, str] = {}  # nvcc -Xptxas -v output: registers, smem, spills


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME); nvcc is needed to build kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if its hashed library is missing; load it."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))  # shared device code
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}\n{proc.stderr}")
            BUILD_LOG[name] = proc.stdout + proc.stderr
            os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        BUILD_SECONDS[name] = time.perf_counter() - t0
    _LIBS[name] = ctypes.CDLL(str(so))
    return _LIBS[name]


_ENTRIES: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def entry(name: str, fn: str, argtypes: List) -> ctypes._CFuncPtr:
    """Entry point `fn` of `csrc/<name>.cu` returning an int, its argtypes
    bound once (the library built at first use): binding them on every call
    costs a wrapper host time."""
    bound = _ENTRIES.get((name, fn))
    if bound is None:
        bound = getattr(load(name), fn)
        bound.argtypes = argtypes
        bound.restype = ctypes.c_int
        _ENTRIES[(name, fn)] = bound
    return bound


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    """The current stream of t's device, as a raw handle (without building a
    torch.cuda.Stream object: a few microseconds less host time a launch)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return ctypes.c_void_p(raw(t.get_device()) if raw is not None else torch.cuda.current_stream(t.device).cuda_stream)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def refuse_autograd(*tensors: torch.Tensor) -> None:
    """A kernel writes into a buffer it was handed, so autograd would see
    its output as a fresh tensor with no history and cut the gradient off
    from everything upstream. While grad mode is on, an input that requires
    grad is refused: train through the kernel's autograd Function (the
    grouped-GEMM MoE's `MoeFfnGmm`, whose forward and backward run with
    grad mode off) or the plain path (`lm_forward(..., training=True)`),
    or call it under `torch.no_grad()`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "a hand-written CUDA kernel was given a tensor that requires grad with grad mode on; "
            "its output would carry no gradient. Run it under torch.no_grad(), or train through "
            "its autograd Function or the plain path (lm_forward(..., training=True))"
        )


def require_cuda(*tensors: torch.Tensor) -> None:
    """A wrapper takes its plain twin only for CPU tensors; anything else
    must be a contiguous tensor on one CUDA device, and none may require
    grad while grad mode is on (`refuse_autograd`)."""
    refuse_autograd(*tensors)
    dev = tensors[0].get_device()  # an int: cheaper than building torch.device objects
    for t in tensors:
        if not t.is_cuda or t.get_device() != dev:
            raise ValueError(f"kernel inputs must share one CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
