"""Batched-decode MoE, kernels F (bf16 / f32 experts) and J (int8
experts): the visit schedule, the CUDA wrappers and their plain twins.

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
  ascending expert id, in f32; in bf16 its products run on the tensor
  cores, the expert weights streamed once by bulk copies.
The JAX package lifts the layer-stacked experts out of its scan so the
kernel can index the stack; the port keeps one expert stack per layer and
needs no such lift.

`distinct_schedule` and `combine_table` are the twins' plan. On CUDA, F and
J take the same plan from one launch, `device_schedule` (`schedule_kernel`
in `csrc/moe_decode.cu`), which reads nothing back to the host; the grid is
the static E visits. Kernel J (`moe_ffn_decode_q8_fused`, port of the JAX
function of that name and its Pallas kernels `_decode_q8_kernel` /
`_decode_q8_pe_kernel`) is the same plan over int8 experts
(`moe_q8.quantize_experts`), with the q8 rounding points: gate and up stay
in f32 after the scale (F rounds them to the model dtype before silu). When
the experts carry the shared pseudo-experts (`pe_*` keys), their n_sh
visits follow the valid expert visits with weight 1 for every row, and the
caller adds no separate shared term. Its source is `csrc/moe_q8.cu`, shared
with kernel I. With bf16 x, H <= TC_MAX_H and H and I multiples of 64, J
runs F's bf16 design over the codes (`moe_q8_stream_bf16`: blocks of code
rows by bulk copies into an mbarrier ring, mma.sync with the decode rows as
A, the combine folded into down); f32 x and other shapes keep the first
form (`moe_q8.launch_moe_quant`, shared with kernels I, M and N). The
choice goes by dtype and shape alone (`q8_stream_takes`).

A wrapper runs its plain twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises. `launches` counts calls that launch F or J
(one per MoE layer per decode step). F in bf16 and J on the stream are
three CUDA launches each, the schedule's included (gate/up, then down with
the combine folded in; two more per further group of 32 rows); F in f32
and J's first form four.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .moe_q8 import QExperts, check_out_dtype, expert_swiglu_q8, launch_moe_quant, pseudo_experts, routing_rows


def distinct_schedule(idx: torch.Tensor, e: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Port of `_distinct_schedule`: (ve [E] int32, the distinct selected
    experts ascending, padded by repeating the last; valid [E] int32, 1 for
    a real visit). Id E (another rank's expert, under EP) is no visit; with
    no visit at all every entry is a pad of expert 0."""
    flat = idx.reshape(-1).long()
    counts = torch.zeros(e + 1, dtype=torch.int32, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    present = counts[:e] > 0
    ids = torch.arange(e, device=idx.device)
    ve_sorted = torch.sort(torch.where(present, ids, e)).values  # distinct first, then E
    n_distinct = torch.cumsum(present.long(), 0)[-1:]  # [1], stays on the device
    last = ve_sorted.gather(0, (n_distinct - 1).clamp(min=0))
    ve = torch.where(ve_sorted == e, last, ve_sorted) % e  # E only where nothing is present
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
    w_full = torch.zeros(e + 1, b, dtype=torch.float32, device=idx.device)  # row E: other ranks' experts
    rows = torch.arange(b, device=idx.device)[:, None].expand_as(idx)
    w_full.index_put_((idx.long(), rows), weights.float(), accumulate=True)
    return w_full.index_select(0, ve.long()) * valid[:, None].float()


def device_schedule(idx: torch.Tensor, weights: torch.Tensor, e: int, b: int):
    """The plan of F and J, `distinct_schedule` and `combine_table` in one
    CUDA launch (`moe_decode_schedule` in `csrc/moe_decode.cu`; the same
    outputs): (ve [E] int32, valid [E] int32, w_visit [E, B] f32)."""
    idx, weights, ld = routing_rows(idx, weights)
    if idx.shape != weights.shape or idx.shape[0] != b or not 0 < e <= 1024:
        raise ValueError(f"routing idx {tuple(idx.shape)} / weights {tuple(weights.shape)}, {b} rows, E {e}")
    if idx.device.type != "cuda" or weights.device != idx.device:
        raise ValueError(f"the schedule's inputs must share one CUDA device, got {idx.device} / {weights.device}")
    cuda_build.refuse_autograd(weights)
    ve = torch.empty(e, dtype=torch.int32, device=idx.device)
    valid = torch.empty_like(ve)
    w_visit = torch.empty(e, b, dtype=torch.float32, device=idx.device)
    lib = cuda_build.load("moe_decode")
    fn = lib.moe_decode_schedule
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    err = fn(p(idx), p(weights), b, idx.shape[1], ld, e, p(ve), p(valid), p(w_visit), cuda_build.stream_of(idx))
    cuda_build.check(err, "moe_decode_schedule")
    return ve, valid, w_visit


def act_stride(i: int) -> int:
    """Row stride, in elements, of F's bf16 act workspace [E, B, stride]
    (`act_stride` in `csrc/moe_decode.cu`): I rounded up to 16, its 16-byte
    units 1 mod 8, so that one bulk copy of a visit's rows lands in shared
    memory with every ldmatrix free of bank conflicts."""
    units = -(-i // 16) * 2
    return (units + (9 - units % 8) % 8) * 8


# F in bf16 keeps each consumer warp's x fragments (an eighth of H) in
# registers: 10 k16 steps a warp. J's stream takes the same limit.
TC_MAX_H = 1280


def q8_stream_takes(x: torch.Tensor, eq: QExperts) -> bool:
    """Whether kernel J runs on the stream (`moe_q8_stream_bf16`): bf16 x,
    H <= TC_MAX_H (x's fragments in registers) and H and I multiples of 64
    (its 64-wide contraction chunks); otherwise its first form."""
    h, i = x.shape[-1], eq["gu_q8"].shape[1] // 2
    return x.dtype == torch.bfloat16 and h <= TC_MAX_H and h % 64 == 0 and i % 64 == 0


def moe_ffn_decode_visits_reference(
    x: torch.Tensor,  # [B, H]
    experts: Dict[str, torch.Tensor],  # gate / up [E, I, H], down [E, H, I]
    weights: torch.Tensor,  # [B, k] f32
    idx: torch.Tensor,  # [B, k]
    out_dtype=None,
) -> torch.Tensor:
    """Plain twin of F: every visit of the schedule over all rows, at F's
    rounding points (gate and up each accumulated in f32 and rounded once,
    silu in f32, y = act Wd^T kept in f32), summed over the visits in
    order. Pad visits repeat a real expert with zero weights, so they add
    exact zeros, as they do in the kernel. Returns [B, H] in `out_dtype`
    (x's dtype by default; f32 leaves the sum unrounded)."""
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
    return out.to(out_dtype or dt)


def moe_ffn_decode_fused(
    x: torch.Tensor,  # [B, H]
    experts: Dict[str, torch.Tensor],
    weights: torch.Tensor,  # [B, k] f32
    idx: torch.Tensor,  # [B, k]
    out_dtype=None,
) -> torch.Tensor:
    """Kernel F: the distinct-expert batched-decode MoE FFN. Returns [B, H]
    in `out_dtype`: x's dtype (the default) or f32, the visits' sum not
    rounded (`moe_decode_bf16_out_f32` for bf16 x)."""
    if x.device.type == "cpu":
        return moe_ffn_decode_visits_reference(x, experts, weights, idx, out_dtype)
    wg, wu, wd = experts["gate"], experts["up"], experts["down"]
    e, i, h = wg.shape
    b = x.shape[0]
    dt = x.dtype
    out_dt = out_dtype or dt
    if dt not in (torch.float32, torch.bfloat16) or any(w.dtype != dt for w in (wg, wu, wd)):
        raise ValueError(f"kernel F takes f32 or bf16 x and experts of the same dtype, got {dt}")
    if out_dt not in (dt, torch.float32):
        raise ValueError(f"kernel F writes x's dtype or f32, not {out_dt}")
    if x.shape != (b, h) or wu.shape != (e, i, h) or wd.shape != (e, h, i):
        raise ValueError(f"shapes x {tuple(x.shape)} gate {tuple(wg.shape)} up {tuple(wu.shape)} "
                         f"down {tuple(wd.shape)} do not fit")
    if h % 8 or i % 8:
        raise ValueError(f"kernel F needs H ({h}) and I ({i}) multiples of 8")
    if dt == torch.bfloat16 and (h % 16 or i % 16 or h > TC_MAX_H):
        raise ValueError(f"kernel F in bf16 needs H ({h}) and I ({i}) multiples of 16 and H <= {TC_MAX_H}")
    x = x.contiguous()
    cuda_build.require_cuda(x, wg, wu, wd)
    if any(t.data_ptr() % 16 for t in (x, wg, wu, wd)):
        raise ValueError("kernel F reads 16-byte aligned rows")
    ve, valid, w_visit = device_schedule(idx, weights, e, b)
    if dt == torch.bfloat16:  # act at a padded stride; y * w summed in the down kernel
        act = torch.empty(e, min(b, 32), act_stride(i), dtype=dt, device=x.device)
        yw = None
    else:
        act = torch.empty(e, b, i, dtype=dt, device=x.device)
        yw = torch.empty(e, b, h, dtype=torch.float32, device=x.device)
    out = torch.empty(b, h, dtype=out_dt, device=x.device)
    lib = cuda_build.load("moe_decode")
    if dt == torch.float32:
        fn = lib.moe_decode_f32
    else:
        fn = lib.moe_decode_bf16_out_f32 if out_dt == torch.float32 else lib.moe_decode_bf16
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    p = cuda_build.ptr
    err = fn(p(x), p(wg), p(wu), p(wd), p(ve), p(valid), p(w_visit), p(act), None if yw is None else p(yw),
             p(out), b, e, h, i, cuda_build.stream_of(x))
    cuda_build.check(err, "moe_decode")
    moe_ffn_decode_fused.launches += 1
    return out


moe_ffn_decode_fused.launches = 0


def moe_ffn_decode_q8_visits_reference(
    x: torch.Tensor,  # [B, H]
    eq: QExperts,  # gu_q8 [E, 2I, H], gu_scale, down_q8 [E, H, I], down_scale (+ pe_* streams)
    weights: torch.Tensor,  # [B, k] f32
    idx: torch.Tensor,  # [B, k]
    out_dtype=None,
) -> torch.Tensor:
    """Plain twin of J: every visit of the schedule over all rows at the q8
    rounding points (`moe_q8.expert_swiglu_q8`), y * w summed in f32 in
    visit order, then the pseudo-experts with weight 1. Pad visits (and,
    under EP, another rank's selections: no visit) add exact zeros. Returns
    [B, H] in `out_dtype` (x's dtype by default; f32 leaves the sum
    unrounded)."""
    e = eq["gu_q8"].shape[0]
    ve, valid = distinct_schedule(idx, e)
    w_visit = combine_table(idx, weights, ve, valid, e)
    x32 = x.float()
    out = torch.zeros(x.shape[0], eq["down_q8"].shape[1], dtype=torch.float32, device=x.device)
    for v in range(e):
        ex = ve[v : v + 1].long()
        wts = [eq[n].index_select(0, ex)[0] for n in ("gu_q8", "gu_scale", "down_q8", "down_scale")]
        out = out + expert_swiglu_q8(x32, *wts, x.dtype) * w_visit[v][:, None]
    if "pe_gu_q8" in eq:
        for pe in pseudo_experts(eq):
            out = out + expert_swiglu_q8(x32, *pe, x.dtype)
    return out.to(out_dtype or x.dtype)


def moe_ffn_decode_q8_fused(
    x: torch.Tensor,  # [B, H]
    eq: QExperts,
    weights: torch.Tensor,  # [B, k] f32
    idx: torch.Tensor,  # [B, k]
    out_dtype=None,
) -> torch.Tensor:
    """Kernel J: the int8 distinct-expert batched-decode MoE FFN, the shared
    pseudo-experts folded in when `eq` has them. Returns [B, H] in
    `out_dtype` (x's dtype by default, or f32)."""
    if x.device.type == "cpu":
        return moe_ffn_decode_q8_visits_reference(x, eq, weights, idx, out_dtype)
    check_out_dtype(x, out_dtype, "J")
    e = eq["gu_q8"].shape[0]
    n_sh = eq["pe_gu_q8"].shape[0] if "pe_gu_q8" in eq else 0
    ve, valid, w_visit = device_schedule(idx, weights, e, x.shape[0])
    if q8_stream_takes(x, eq):
        out = _launch_q8_stream(x, eq, n_sh, ve, valid, w_visit, out_dtype)
    else:
        out = launch_moe_quant(8, False, x, eq, n_sh, ve=ve, valid=valid, w_visit=w_visit, out_dtype=out_dtype)
    moe_ffn_decode_q8_fused.launches += 1
    return out


moe_ffn_decode_q8_fused.launches = 0

_Q8_STREAM_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _launch_q8_stream(x, eq: QExperts, n_sh: int, ve, valid, w_visit, out_dtype=None) -> torch.Tensor:
    """Kernel J with bf16 x on F's bulk-copy tensor-core stream
    (`moe_q8_stream_bf16` in `csrc/moe_q8.cu`): gate/up, then down with the
    combine folded in, on the schedule's ve / valid / w_visit. Returns [B,
    H] bf16, or f32 (`out_dtype`)."""
    names = ("gu_q8", "gu_scale", "down_q8", "down_scale")
    gu, gus, down, ds = (eq[n] for n in names)
    e, i2, h = gu.shape
    i, b = i2 // 2, x.shape[0]
    shapes = ((i2, h), (i2,), (h, i), (h,))
    pe = [eq[f"pe_{n}"] for n in names] if n_sh else []
    if x.shape != (b, h) or not q8_stream_takes(x, eq) \
            or any(t.shape != (e, *sh) for t, sh in zip((gu, gus, down, ds), shapes)) \
            or any(t.shape != (n_sh, *sh) for t, sh in zip(pe, shapes)) \
            or any(t.dtype != dt for t, dt in zip((gu, gus, down, ds, *pe), (torch.int8, torch.float32) * 4)):
        raise ValueError(f"kernel J takes bf16 x [B, H] with H, I multiples of 64 and H <= {TC_MAX_H}, and int8 "
                         f"experts: x {tuple(x.shape)} gu {tuple(gu.shape)} down {tuple(down.shape)}")
    if ve.dtype != torch.int32 or valid.dtype != torch.int32 or w_visit.dtype != torch.float32:
        raise ValueError("kernel J takes an int32 schedule and an f32 combine table")
    x = x.contiguous()
    cuda_build.require_cuda(x, gu, gus, down, ds, *pe, ve, valid, w_visit)
    if any(t.data_ptr() % 16 for t in (x, gu, gus, down, ds, *pe)):
        raise ValueError("kernel J reads 16-byte aligned rows and scales")
    act = torch.empty(e + n_sh, min(b, 32), i, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x, dtype=check_out_dtype(x, out_dtype, "J"))
    fn = cuda_build.entry("moe_q8", "moe_q8_stream_bf16", _Q8_STREAM_ARGTYPES)
    p = cuda_build.ptr
    pgu, pgus, pdown, pds = (p(t) for t in pe) if pe else (None,) * 4
    err = fn(p(x), p(gu), p(gus), p(down), p(ds), pgu, pgus, pdown, pds, p(ve), p(valid), p(w_visit), p(act),
             p(out), b, e, n_sh, h, i, int(out.dtype == torch.float32), cuda_build.stream_of(x))
    cuda_build.check(err, "moe_q8 (J)")
    return out
