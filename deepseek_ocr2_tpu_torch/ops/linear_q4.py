"""Weight-only int4 linears (w4a16): quantization, the decode kernel L and
the prefill form (port of deepseek_ocr2_tpu/ops/linear_q4.py).

Quantization is symmetric with group-wise scales: for each output channel
and each group of 128 input rows, s = max(absmax, 1e-8) / 7 and levels
clip(round(w / s), -7, 7), rounding half to even (as `jnp.round`). The port
keeps HF's [out, in] layout, as the int8 linears do:
- codes uint8 [Out, In_p / 2]: byte j of a row holds input rows 2j (low
  nibble) and 2j + 1 (high nibble), each as level + 8 (offset binary, 1..15);
- scales f32 [Out, In_p / 128];
- In_p is In rounded up to a multiple of 128; padding levels are 0.
So one 16-byte load holds 32 consecutive levels of one group. For every
real input row the level and its group's scale equal the JAX package's bit
for bit; the JAX package pads In to 256 and packs block-local split halves
with an offset low nibble for the TPU (`from_jax_q4` converts).

- `linear_q4` is kernel L (`csrc/linear_q4.cu`, device code in
  `csrc/linear_q4.cuh`): the skinny GEMM of a decode step; at 1-4 rows of
  x (lm_head at batch 1) a persistent kernel that streams whole code rows
  through shared memory by bulk async copies. Its plain twin
  `linear_q4_reference` computes sum_g s_g * (x_g . q_g) in f32, the TPU
  kernel's rounding points (each group's f32 dot scaled, then summed).
  `launches` counts calls that launch L.
- `linear_q4_plain` is the prefill form, the JAX package's `linear_q4_xla`:
  the weights dequantized to x's dtype first (levels times scale in f32,
  then one cast), then one f32-accumulated product. It is not the int8
  prefill form, which keeps the product in f32 and scales after it.

A wrapper runs its plain twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises. Nothing here reads a value back to the host.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import cuda_build

GROUP = 128  # input rows per scale group
QLinear4 = Dict[str, torch.Tensor]  # {"q4": uint8 [Out, In_p / 2], "scale": f32 [Out, In_p / 128]}


def padded(n: int) -> int:
    return -(-n // GROUP) * GROUP


def pack_q4(levels: torch.Tensor) -> torch.Tensor:
    """int levels in [-7, 7], [..., K] with K even -> uint8 [..., K / 2]."""
    u = (levels.to(torch.int32) + 8).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack_q4(codes: torch.Tensor) -> torch.Tensor:
    """uint8 [..., K / 2] -> int8 levels [..., K]."""
    lo = (codes & 0xF).to(torch.int8) - 8
    hi = (codes >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).flatten(-2)


def quantize_q4(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., Out, In] -> (codes uint8 [..., Out, In_p / 2], scales f32
    [..., Out, In_p / 128])."""
    w32 = w.float()
    in_dim = w32.shape[-1]
    if padded(in_dim) != in_dim:
        w32 = F.pad(w32, (0, padded(in_dim) - in_dim))
    wg = w32.reshape(*w32.shape[:-1], -1, GROUP)
    absmax = wg.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    # A tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, one ulp off the true quotient the JAX package computes.
    scale = absmax / absmax.new_full((), 7.0)
    q = torch.clamp(torch.round(wg / scale), -7, 7)
    return pack_q4(q.flatten(-2)).contiguous(), scale.squeeze(-1).contiguous()


def quantize_linear_q4(w: torch.Tensor) -> QLinear4:
    """HF-layout [Out, In] weight -> {"q4", "scale"}."""
    q, s = quantize_q4(w)
    return {"q4": q, "scale": s}


def from_jax_q4(packed, scale, in_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's int4 tensors (packed int8 [..., Kp / 2, Out] in its
    block-local split-half, offset-lo order, scales [..., Kp / 128, Out],
    Kp = In padded to 256) -> the port's codes and scales for In = in_dim."""
    p = np.asarray(packed).view(np.int8).astype(np.int32)
    *lead, kp2, out = p.shape
    lo = (p & 0xF) - 8
    hi = p >> 4  # arithmetic: the high nibble is two's complement
    blocks = p.shape[-2] // 128
    lo = lo.reshape(*lead, blocks, 128, out)
    hi = hi.reshape(*lead, blocks, 128, out)
    levels = np.stack([lo, hi], axis=-3).reshape(*lead, 2 * kp2, out)  # original row order
    ip = padded(in_dim)
    levels = torch.from_numpy(np.array(np.swapaxes(levels[..., :ip, :], -1, -2), order="C"))
    s = np.asarray(scale, np.float32)[..., : ip // GROUP, :]
    return pack_q4(levels).contiguous(), torch.from_numpy(np.array(np.swapaxes(s, -1, -2), order="C"))


def dequantize_q4(codes: torch.Tensor, scale: torch.Tensor, in_dim: int, dtype=torch.float32) -> torch.Tensor:
    """Codes [..., Out, In_p / 2] + scales -> contiguous [..., Out, In] in
    `dtype`: levels times scale in f32, one cast (the JAX package's
    `dequantize_q4`)."""
    lv = unpack_q4(codes).float()
    lv = lv.reshape(*lv.shape[:-1], -1, GROUP) * scale[..., None]
    return lv.flatten(-2)[..., :in_dim].to(dtype).contiguous()


def q4_dot(x32: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """sum_g s_g * (x_g . q_g) in f32: x32 [N, In] f32 against codes [Out,
    In_p / 2] (one weight) or [N, Out, In_p / 2] (one weight per row).
    Returns [N, Out] f32."""
    n, in_dim = x32.shape
    ip = codes.shape[-1] * 2
    xg = F.pad(x32, (0, ip - in_dim)).reshape(n, ip // GROUP, GROUP)
    lv = unpack_q4(codes).float()
    lv = lv.reshape(*lv.shape[:-1], ip // GROUP, GROUP)
    if codes.dim() == 2:
        part = torch.einsum("ngk,ogk->nog", xg, lv)
    else:
        part = torch.einsum("ngk,nogk->nog", xg, lv)
    return (part * scale).sum(-1)


def _out_dtype(x: torch.Tensor, out_dtype: Optional[torch.dtype]) -> torch.dtype:
    return x.dtype if out_dtype is None else out_dtype


def linear_q4_reference(x: torch.Tensor, w: QLinear4, *, out_dtype=None) -> torch.Tensor:
    """Plain twin of L: each group's f32 dot times its scale, summed in
    f32, one cast."""
    return q4_dot(x.float(), w["q4"], w["scale"]).to(_out_dtype(x, out_dtype))


def linear_q4_plain(x: torch.Tensor, w: QLinear4, *, out_dtype=None) -> torch.Tensor:
    """The prefill form (`linear_q4_xla`): weights dequantized to x's dtype,
    then an f32-accumulated product (x and the rounded weights widened to
    f32 are exact, and so is each product; TF32 is off), one cast."""
    wd = dequantize_q4(w["q4"], w["scale"], x.shape[-1], dtype=x.dtype)
    return F.linear(x.float(), wd.float()).to(_out_dtype(x, out_dtype))


_DTYPES = (torch.float32, torch.bfloat16)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def linear_q4(x: torch.Tensor, w: QLinear4, *, out_dtype=None) -> torch.Tensor:
    """Kernel L: x [B, In] (f32 or bf16) times the int4 linear. Returns
    [B, Out] in `out_dtype` (default x's dtype)."""
    if x.is_cpu:
        return linear_q4_reference(x, w, out_dtype=out_dtype)
    q, scale = w["q4"], w["scale"]
    od = _out_dtype(x, out_dtype)
    b, in_dim = x.shape
    out_dim = q.shape[0]
    if x.dtype not in _DTYPES or od not in _DTYPES:
        raise ValueError(f"kernel L takes f32 or bf16 x and output, got {x.dtype} -> {od}")
    ip = padded(in_dim)
    if q.dtype != torch.uint8 or q.shape != (out_dim, ip // 2) or scale.dtype != torch.float32 \
            or scale.shape != (out_dim, ip // GROUP):
        raise ValueError(f"int4 linear {q.dtype} {tuple(q.shape)} / scale {scale.dtype} {tuple(scale.shape)} "
                         f"does not fit x {tuple(x.shape)}")
    if in_dim % 32:
        raise ValueError(f"kernel L needs In ({in_dim}) a multiple of 32")
    x = x.contiguous()
    cuda_build.require_cuda(x, q, scale)
    xp, qp, sp = x.data_ptr(), q.data_ptr(), scale.data_ptr()
    if (xp | qp | sp) % 16:
        raise ValueError("kernel L reads 16-byte aligned x, codes and scales")
    out = x.new_empty((b, out_dim), dtype=od)
    err = cuda_build.entry("linear_q4", "linear_q4", _ARGTYPES)(
        xp, qp, sp, out.data_ptr(), b, in_dim, out_dim, x.dtype == torch.bfloat16, od == torch.bfloat16,
        cuda_build.stream_of(x))
    cuda_build.check(err, "linear_q4")
    linear_q4.launches += 1
    return out


linear_q4.launches = 0
