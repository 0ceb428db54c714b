"""Weight-only int8 linears: quantization, the decode kernel H and the
prefill form (port of deepseek_ocr2_tpu/ops/linear_q8.py).

Quantization is symmetric per output channel: scale = max(absmax, 1e-8) /
127 over the input dim, codes clip(round(w / scale), -127, 127), rounding
half to even (as `jnp.round`). The port keeps HF's [out, in] layout:
a quantized linear is {"q8": int8 [Out, In], "scale": f32 [Out]}, so each
output's codes are one contiguous row (16-byte loads along the contraction).
The JAX package stores [In, Out] and pads In to a multiple of 128 for the
TPU's lane-aligned K blocks; the port needs no padding and holds the same
codes and scales.

- `linear_q8` is kernel H (`csrc/linear_q8.cu`, the skinny GEMM of a decode
  step: lm_head, the fused qkv and wo streams of paged serving, the dense
  MLP, the shared MLP when it is not folded into the expert kernels). Its
  plain twin is `linear_q8_reference`. `launches` counts calls that launch H.
- `linear_q8_plain` is the prefill form, what the JAX package leaves to XLA
  (`linear_q8_xla`: codes cast to x's dtype, the product kept in f32, the
  scale after it, one cast). It is H's twin: the codes and x widened to f32
  are exact, so is each bf16 x int8 product, and TF32 is off (package
  `__init__`), so one f32 `F.linear` has XLA's rounding points in bf16 too.

A wrapper runs its plain twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises. Nothing here reads a value back to the host.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .linear_q4 import linear_q4, linear_q4_plain

QLinear = Dict[str, torch.Tensor]  # {"q8": int8 [Out, In], "scale": f32 [Out]}


def quantize_per_col(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., Out, In] -> (int8 codes of the same shape, f32 scales [..., Out]):
    one scale per output channel, over the input dim."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    # A tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, one ulp off the true quotient the JAX package computes.
    scale = absmax / absmax.new_full((), 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


def quantize_linear(w: torch.Tensor) -> QLinear:
    """HF-layout [Out, In] weight -> {"q8", "scale"}."""
    q, s = quantize_per_col(w)
    return {"q8": q.contiguous(), "scale": s.contiguous()}


def is_qlinear(w) -> bool:
    """An int8 linear, or an int4 one ("q4" dict, `linear_q4`)."""
    return isinstance(w, dict) and ("q8" in w or "q4" in w)


def _out_dtype(x: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.dtype:
    return x.dtype if out_dtype is None else out_dtype


def linear_q8_reference(x: torch.Tensor, w: QLinear, *, out_dtype=None) -> torch.Tensor:
    """Plain twin of H and the prefill form: x and the codes widened to f32,
    one f32 product, the scale after it, one cast."""
    acc = F.linear(x.float(), w["q8"].float())
    return (acc * w["scale"]).to(_out_dtype(x, out_dtype))


linear_q8_plain = linear_q8_reference


def linear_q8(x: torch.Tensor, w: QLinear, *, out_dtype=None) -> torch.Tensor:
    """Kernel H: x [B, In] (f32 or bf16) times the int8 linear. Returns
    [B, Out] in `out_dtype` (default x's dtype)."""
    if x.device.type == "cpu":
        return linear_q8_reference(x, w, out_dtype=out_dtype)
    q, scale = w["q8"], w["scale"]
    od = _out_dtype(x, out_dtype)
    b, in_dim = x.shape
    out_dim = q.shape[0]
    if x.dtype not in (torch.float32, torch.bfloat16) or od not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel H takes f32 or bf16 x and output, got {x.dtype} -> {od}")
    if q.dtype != torch.int8 or q.shape != (out_dim, in_dim) or scale.dtype != torch.float32 \
            or scale.shape != (out_dim,):
        raise ValueError(f"int8 linear {q.dtype} {tuple(q.shape)} / scale {scale.dtype} {tuple(scale.shape)} "
                         f"does not fit x {tuple(x.shape)}")
    if in_dim % 16:
        raise ValueError(f"kernel H needs In ({in_dim}) a multiple of 16")
    x = x.contiguous()
    cuda_build.require_cuda(x, q, scale)
    if x.data_ptr() % 16 or q.data_ptr() % 16:
        raise ValueError("kernel H reads 16-byte aligned rows")
    out = torch.empty(b, out_dim, dtype=od, device=x.device)
    lib = cuda_build.load("linear_q8")
    fn = lib.linear_q8
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    err = fn(p(x), p(q), p(scale), p(out), b, in_dim, out_dim, int(x.dtype == torch.bfloat16),
             int(od == torch.bfloat16), cuda_build.stream_of(x))
    cuda_build.check(err, "linear_q8")
    linear_q8.launches += 1
    return out


linear_q8.launches = 0


def qmm(x: torch.Tensor, w, *, decode: bool = False, out_dtype=None) -> torch.Tensor:
    """x [N, In] times a plain HF-layout weight [Out, In], an int8 or an int4
    linear: kernel H (L for int4) when `decode` (a decode step's few rows),
    the prefill form otherwise (the JAX package's `qmm`)."""
    if not is_qlinear(w):
        y = F.linear(x, w)
        return y if out_dtype is None else y.to(out_dtype)
    if "q4" in w:
        return (linear_q4 if decode else linear_q4_plain)(x, w, out_dtype=out_dtype)
    if decode:
        return linear_q8(x, w, out_dtype=out_dtype)
    return linear_q8_plain(x, w, out_dtype=out_dtype)


def swiglu_q8(x: torch.Tensor, gu: QLinear, down: QLinear, *, decode: bool = False) -> torch.Tensor:
    """SwiGLU with the fused gate||up stream [2I, H] (int8 or int4): gate
    and up kept in f32 after the scale, silu in f32, the activation rounded
    to x's dtype."""
    h2 = qmm(x, gu, decode=decode, out_dtype=torch.float32)
    i = h2.shape[-1] // 2
    act = (F.silu(h2[:, :i]) * h2[:, i:]).to(x.dtype)
    return qmm(act, down, decode=decode)
