"""Batched-decode MoE, kernel F: the visit schedule, the CUDA wrapper and
its plain twin.

Port of deepseek_ocr2_tpu/ops/moe_decode.py (`moe_ffn_decode_fused`, the
Pallas kernel `_decode_kernel`). Once a decode batch selects more experts
than there are (B * k > E), most experts are chosen by some row, and the
cheapest plan reads each selected expert once for the whole batch:
- `distinct_schedule` lists the distinct selected experts in ascending
  order, padded to E entries by repeating the last, with a validity flag;
- `combine_table` scatters the routing weights into a dense [E, B] table,
  zero where a row did not select the visit's expert and for pad visits;
- kernel F (`csrc/moe_decode.cu`, whose header gives the design) runs the
  SwiGLU of every visit over all rows and sums y * w over the visits in
  ascending expert id, in f32.
The JAX package lifts the layer-stacked experts out of its scan so the
kernel can index the stack; the port keeps one expert stack per layer and
needs no such lift.

On CUDA nothing here reads a value back to the host: the schedule comes from
`scatter_add_`, `sort` and `cumsum` (not `bincount`, `unique` or `nonzero`,
which size their output from the data), and the grid is the static E visits.
A wrapper runs its plain twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises. `launches` counts calls that launch F (one
per MoE layer per decode step; F is three CUDA launches).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build


def distinct_schedule(idx: torch.Tensor, e: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Port of `_distinct_schedule`: (ve [E] int32, the distinct selected
    experts ascending, padded by repeating the last; valid [E] int32, 1 for
    a real visit)."""
    flat = idx.reshape(-1).long()
    counts = torch.zeros(e, dtype=torch.int32, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    present = counts > 0
    ids = torch.arange(e, device=idx.device)
    ve_sorted = torch.sort(torch.where(present, ids, e)).values  # distinct first, then E
    n_distinct = torch.cumsum(present.long(), 0)[-1:]  # [1], stays on the device
    last = ve_sorted.gather(0, (n_distinct - 1).clamp(min=0))
    ve = torch.where(ve_sorted == e, last, ve_sorted)
    return ve.to(torch.int32), (ids < n_distinct).to(torch.int32)


def combine_table(
    idx: torch.Tensor,  # [B, k]
    weights: torch.Tensor,  # [B, k] f32
    ve: torch.Tensor,  # [E] int32
    valid: torch.Tensor,  # [E] int32
    e: int,
) -> torch.Tensor:
    """Port of `_combine_table`: dense per-(visit, row) combine weights
    [E, B] f32 (the JAX [V, B_pad, 1] without the TPU's row padding)."""
    b = idx.shape[0]
    w_full = torch.zeros(e, b, dtype=torch.float32, device=idx.device)
    rows = torch.arange(b, device=idx.device)[:, None].expand_as(idx)
    w_full.index_put_((idx.long(), rows), weights.float(), accumulate=True)
    return w_full.index_select(0, ve.long()) * valid[:, None].float()


def moe_ffn_decode_visits_reference(
    x: torch.Tensor,  # [B, H]
    experts: Dict[str, torch.Tensor],  # gate / up [E, I, H], down [E, H, I]
    weights: torch.Tensor,  # [B, k] f32
    idx: torch.Tensor,  # [B, k]
) -> torch.Tensor:
    """Plain twin of F: every visit of the schedule over all rows, at F's
    rounding points (gate and up each accumulated in f32 and rounded once,
    silu in f32, y = act Wd^T kept in f32), summed over the visits in
    order. Pad visits repeat a real expert with zero weights, so they add
    exact zeros, as they do in the kernel. Returns [B, H] in x's dtype."""
    e = experts["gate"].shape[0]
    dt = x.dtype
    ve, valid = distinct_schedule(idx, e)
    w_visit = combine_table(idx, weights, ve, valid, e)
    out = torch.zeros(x.shape[0], experts["down"].shape[1], dtype=torch.float32, device=x.device)
    x32 = x.float()
    for v in range(e):
        ex = ve[v : v + 1].long()
        wg, wu, wd = (experts[n].index_select(0, ex)[0].float() for n in ("gate", "up", "down"))
        gate = F.linear(x32, wg).to(dt)
        up = F.linear(x32, wu).to(dt)
        act = F.silu(gate.float()).to(dt) * up
        out += F.linear(act.float(), wd) * w_visit[v][:, None]
    return out.to(dt)


def moe_ffn_decode_fused(
    x: torch.Tensor,  # [B, H]
    experts: Dict[str, torch.Tensor],
    weights: torch.Tensor,  # [B, k] f32
    idx: torch.Tensor,  # [B, k]
) -> torch.Tensor:
    """Kernel F: the distinct-expert batched-decode MoE FFN. Returns [B, H]
    in x's dtype."""
    if x.device.type == "cpu":
        return moe_ffn_decode_visits_reference(x, experts, weights, idx)
    wg, wu, wd = experts["gate"], experts["up"], experts["down"]
    e, i, h = wg.shape
    b = x.shape[0]
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16) or any(w.dtype != dt for w in (wg, wu, wd)):
        raise ValueError(f"kernel F takes f32 or bf16 x and experts of the same dtype, got {dt}")
    if x.shape != (b, h) or wu.shape != (e, i, h) or wd.shape != (e, h, i):
        raise ValueError(f"shapes x {tuple(x.shape)} gate {tuple(wg.shape)} up {tuple(wu.shape)} "
                         f"down {tuple(wd.shape)} do not fit")
    if h % 8 or i % 8:
        raise ValueError(f"kernel F needs H ({h}) and I ({i}) multiples of 8")
    x = x.contiguous()
    cuda_build.require_cuda(x, wg, wu, wd, weights.contiguous(), idx.contiguous())
    if any(t.data_ptr() % 16 for t in (x, wg, wu, wd)):
        raise ValueError("kernel F reads 16-byte aligned rows")
    ve, valid = distinct_schedule(idx, e)
    w_visit = combine_table(idx, weights, ve, valid, e).contiguous()
    act = torch.empty(e, b, i, dtype=dt, device=x.device)
    yw = torch.empty(e, b, h, dtype=torch.float32, device=x.device)
    out = torch.empty(b, h, dtype=dt, device=x.device)
    lib = cuda_build.load("moe_decode")
    fn = lib.moe_decode_f32 if dt == torch.float32 else lib.moe_decode_bf16
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    err = fn(p(x), p(wg), p(wu), p(wd), p(ve), p(valid), p(w_visit), p(act), p(yw), p(out),
             b, e, h, i, cuda_build.stream_of(x))
    cuda_build.check(err, "moe_decode")
    moe_ffn_decode_fused.launches += 1
    return out


moe_ffn_decode_fused.launches = 0
