"""Fused ViT MLP, kernel C: CUDA wrapper and its plain twin.

Port of the Pallas kernel `_mlp_kernel` (via `mlp_gelu`) in
deepseek_ocr2_tpu/ops/fused_mlp.py: linear -> exact-erf GELU -> linear. The
CUDA source is `csrc/fused_mlp.cu` (its header gives the design and what
bounds it): two launches of a TMA + wgmma GEMM on the tensor cores (bf16;
f32 as three TF32 products), the bias and GELU fused into the first one's
epilogue, the bias into the second's; the [M, F] intermediate goes through
a workspace this wrapper allocates. The TPU gate (E and F multiples of
128) was a Mosaic tiling choice; the CUDA kernel takes every M and any E
and F that are multiples of 8 (16-byte rows for TMA).

Weights are in HF nn.Linear layout: w1 [F, E], w2 [E, F].
Rounding points (identity for f32), as in the TPU kernel and the XLA form:
h = round(x W1^T); h = round(h + b1); g = round(gelu_f32(h));
out = round(round(g W2^T) + b2).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build


def mlp_gelu_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain twin of C with the same rounding points."""
    dt = x.dtype
    h = F.linear(x, w1.to(dt)) + b1.to(dt)
    g = F.gelu(h.float(), approximate="none").to(dt)
    return F.linear(g, w2.to(dt)) + b2.to(dt)


def mlp_gelu(
    x: torch.Tensor,  # [M, E]
    w1: torch.Tensor,  # [F, E]
    b1: torch.Tensor,  # [F]
    w2: torch.Tensor,  # [E, F]
    b2: torch.Tensor,  # [E]
) -> torch.Tensor:
    """Kernel C. Returns [M, E] in x.dtype."""
    if x.device.type == "cpu":
        return mlp_gelu_reference(x, w1, b1, w2, b2)
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel C takes f32 or bf16, got {dt}")
    m, e = x.shape
    f = w1.shape[0]
    if w1.shape != (f, e) or w2.shape != (e, f) or b1.shape != (f,) or b2.shape != (e,):
        raise ValueError("expected w1 [F, E], b1 [F], w2 [E, F], b2 [E]")
    if e % 8 or f % 8:
        raise ValueError(f"kernel C reads 16-byte rows: E = {e} and F = {f} must be multiples of 8")
    args = [t.to(dt).contiguous() for t in (x, w1, b1, w2, b2)]
    cuda_build.require_cuda(*args)
    # 16-byte aligned for TMA and the vector loads (a view may start anywhere).
    x, w1, b1, w2, b2 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in args)
    fn = cuda_build.entry("fused_mlp", "mlp_gelu_f32" if dt == torch.float32 else "mlp_gelu_bf16",
                          [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    g = torch.empty((m, f), dtype=dt, device=x.device)  # the intermediate, written then read on the stream
    out = torch.empty_like(x)
    p = cuda_build.ptr
    err = fn(p(x), p(w1), p(b1), p(w2), p(b2), p(g), p(out), m, e, f, cuda_build.stream_of(x))
    cuda_build.check(err, "fused_mlp")
    mlp_gelu.launches += 1
    return out


mlp_gelu.launches = 0
