"""Int4-weight MoE decode, kernels M (one visit per (row, selection)) and N
(one visit per distinct expert) (port of deepseek_ocr2_tpu/ops/moe_q4.py).

Quantization keeps the port's [out, in] layout with the group-128 scales
and packing of `linear_q4`:
- gu_q4 uint8 [E, 2I, H_p / 2] (gate rows, then up rows: one weight stream
  per expert), gu_scale f32 [E, 2I, H_p / 128], groups along H;
- down_q4 uint8 [E, H, I_p / 2], down_scale f32 [E, H, I_p / 128], groups
  along I.
Groups run along the contraction, so the gate||up concat changes no level
or scale: they are the JAX package's, transposed and repacked.

- `moe_ffn_decode_q4` is kernel M: for each row, its k selected experts in
  top-k order and, with `with_shared`, the n_sh shared pseudo-experts
  (`pe_*` keys) with weight 1, summed in that order in f32. The JAX package
  takes it while B * k <= E, folding the pseudo-experts in at B = 1 only.
- `moe_ffn_decode_q4_fused` is kernel N: the distinct-expert plan of kernels
  F and J (`moe_decode.device_schedule`, one launch, no host sync) over
  int4 experts, the pseudo-experts always folded in when present.
Both run at the TPU kernels' rounding points (`_q4_swiglu`): gate and up
kept in f32 after their group scales, act = round(silu(gate) * up) to x's
dtype, the down product in f32 (`expert_swiglu_q4`). Both build from
`csrc/moe_q4.cu`. M and N with f32 x or a shape their streams do not take
run the int4 instance of the kernels I and J share (`csrc/moe_quant.cuh`),
launched by `moe_q8.launch_moe_quant`. M with bf16 x, H and I multiples of
128 and the rows and visits within the stream's shared memory
(`q4_sel_takes`: dtype and shape alone) runs its own stream
(`moe_q4_sel_bf16`, the header of `csrc/moe_q4.cu` gives the design):
gate/up as units of 8 columns over every SM, each a warp's whole dot fed
by bulk copies, then down with the combine folded in (a block owns 16
columns of H of one row over its visits, adding y * w in visit order),
launched as a programmatic dependent of gate/up so that its code rows
stream while gate/up runs. N with bf16 x, H and I multiples of
128 and H <= STREAM_MAX_H (`q4_stream_takes`: dtype and shape alone) runs
J's bulk-copy tensor-core stream over int4 codes (`moe_q4_stream_bf16`, the
header of `csrc/moe_q4.cu` gives the design): gate/up, then down with the
visits cut into parts at fixed expert ids (`down_split`, `part_bounds`),
the parts' sums added in order by the last block of each column tile. The
plain twins are `moe_ffn_decode_q4_reference` and
`moe_ffn_decode_q4_visits_reference`. Under expert parallelism both take
another rank's selection (id E_local) and write f32 partials as I and J do
(`moe_q8`'s docstring).

A wrapper runs its plain twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises. Nothing here reads a value back to the host.
`launches` counts calls that launch M or N (M on its stream two CUDA
launches, its first form three; N on the stream three, its schedule's
included, two more a further group of 32 rows; N's first form four).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from . import cuda_build
from .linear_q4 import GROUP, dequantize_q4, q4_dot, quantize_q4
from .moe_decode import combine_table, device_schedule, distinct_schedule
from .moe_q8 import check_out_dtype, launch_moe_quant, routing_rows, selection_terms
from .paged_attention import _arrival_counters

QExperts4 = Dict[str, torch.Tensor]
_NAMES = ("gu_q4", "gu_scale", "down_q4", "down_scale")


def quantize_experts_q4(experts: Dict[str, torch.Tensor]) -> QExperts4:
    """{gate, up: [E, I, H], down: [E, H, I]} -> {gu_q4, gu_scale, down_q4,
    down_scale} (gate||up fused along the output rows)."""
    gu_q4, gu_scale = quantize_q4(torch.cat([experts["gate"], experts["up"]], dim=-2))
    down_q4, down_scale = quantize_q4(experts["down"])
    return {"gu_q4": gu_q4, "gu_scale": gu_scale, "down_q4": down_q4, "down_scale": down_scale}


def dequantize_experts_q4(eq: QExperts4, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Int4 experts back to {gate, up: [E, I, H], down: [E, H, I]} in
    `dtype` (levels times scale in f32, one cast: the JAX package's
    `dequantize_experts_q4`), contiguous, for the prefill MoE forms."""
    h = eq["down_q4"].shape[-2]
    i = eq["gu_q4"].shape[-2] // 2
    gu = dequantize_q4(eq["gu_q4"], eq["gu_scale"], h, dtype)
    return {"gate": gu[..., :i, :].contiguous(), "up": gu[..., i:, :].contiguous(),
            "down": dequantize_q4(eq["down_q4"], eq["down_scale"], i, dtype)}


def expert_swiglu_q4(x32: torch.Tensor, gu, gus, down, ds, dtype: torch.dtype) -> torch.Tensor:
    """One int4 expert on f32 rows x32 [N, H] at the kernels' rounding
    points: gate and up in f32 after their group scales, silu in f32, the
    activation rounded to `dtype`, y = sum_g s_g (act_g . down_g) in f32.
    gu [2I, H_p / 2] or a batch [N, 2I, H_p / 2] (one expert per row), and
    so on."""
    h2 = q4_dot(x32, gu, gus)
    i = h2.shape[-1] // 2
    act = (F.silu(h2[:, :i]) * h2[:, i:]).to(dtype).float()
    return q4_dot(act, down, ds)


def pseudo_experts_q4(eq: QExperts4):
    """The n_sh shared pseudo-experts as (gu, gus, down, ds) tuples."""
    return [tuple(eq[f"pe_{n}"][t] for n in _NAMES) for t in range(eq["pe_gu_q4"].shape[0])]


def moe_ffn_decode_q4_reference(x, eq: QExperts4, weights, idx, *, with_shared: bool = False,
                                out_dtype=None) -> torch.Tensor:
    """Plain twin of M: each row's selections in top-k order (the selected
    experts gathered per row; another rank's selection, id E, adds
    nothing), then the pseudo-experts with weight 1, accumulated in f32 in
    that order. Returns [B, H] in `out_dtype` (x's dtype by default; f32
    leaves the sum unrounded)."""
    x32 = x.float()
    e = eq["gu_q4"].shape[0]
    out = torch.zeros(x.shape[0], eq["down_q4"].shape[1], dtype=torch.float32, device=x.device)
    for j in range(idx.shape[1]):
        local = idx[:, j] < e
        ex = idx[:, j].long().clamp(max=e - 1)
        y = expert_swiglu_q4(x32, *(eq[n][ex] for n in _NAMES), x.dtype)
        out = selection_terms(out, y, weights[:, j], local)
    if with_shared:
        for pe in pseudo_experts_q4(eq):
            out = out + expert_swiglu_q4(x32, *pe, x.dtype)
    return out.to(out_dtype or x.dtype)


def moe_ffn_decode_q4_visits_reference(x, eq: QExperts4, weights, idx, out_dtype=None) -> torch.Tensor:
    """Plain twin of N: every visit of the schedule over all rows, y * w
    summed in f32 in visit order (pad visits repeat a real expert with zero
    weights, so they add exact zeros; another rank's selection, id E, is no
    visit), then the pseudo-experts with weight 1. Returns [B, H] in
    `out_dtype` (x's dtype by default, or f32)."""
    e = eq["gu_q4"].shape[0]
    ve, valid = distinct_schedule(idx, e)
    w_visit = combine_table(idx, weights, ve, valid, e)
    x32 = x.float()
    out = torch.zeros(x.shape[0], eq["down_q4"].shape[1], dtype=torch.float32, device=x.device)
    for v in range(e):
        ex = ve[v : v + 1].long()
        wts = [eq[n].index_select(0, ex)[0] for n in _NAMES]
        out = out + expert_swiglu_q4(x32, *wts, x.dtype) * w_visit[v][:, None]
    if "pe_gu_q4" in eq:
        for pe in pseudo_experts_q4(eq):
            out = out + expert_swiglu_q4(x32, *pe, x.dtype)
    return out.to(out_dtype or x.dtype)


def moe_ffn_decode_q4(x: torch.Tensor, eq: QExperts4, weights: torch.Tensor, idx: torch.Tensor, *,
                      with_shared: bool = False, out_dtype=None) -> torch.Tensor:
    """Kernel M: the per-selection int4 MoE decode FFN. With `with_shared`
    the shared pseudo-experts are folded in and the caller adds no separate
    shared term. Returns [B, H] in `out_dtype` (x's dtype by default, or
    f32)."""
    if x.device.type == "cpu":
        return moe_ffn_decode_q4_reference(x, eq, weights, idx, with_shared=with_shared, out_dtype=out_dtype)
    n_sh = eq["pe_gu_q4"].shape[0] if with_shared else 0
    if q4_sel_takes(x, eq, idx.shape[1] + n_sh):
        out = _launch_q4_sel(x, eq, n_sh, idx, weights, out_dtype)
    else:
        out = launch_moe_quant(4, True, x, eq, n_sh, idx=idx, weights=weights, out_dtype=out_dtype)
    moe_ffn_decode_q4.launches += 1
    return out


moe_ffn_decode_q4.launches = 0


def moe_ffn_decode_q4_fused(x: torch.Tensor, eq: QExperts4, weights: torch.Tensor, idx: torch.Tensor,
                            out_dtype=None) -> torch.Tensor:
    """Kernel N: the int4 distinct-expert batched-decode MoE FFN, the shared
    pseudo-experts folded in when `eq` has them. Returns [B, H] in
    `out_dtype` (x's dtype by default, or f32)."""
    if x.device.type == "cpu":
        return moe_ffn_decode_q4_visits_reference(x, eq, weights, idx, out_dtype)
    check_out_dtype(x, out_dtype, "N")
    e = eq["gu_q4"].shape[0]
    n_sh = eq["pe_gu_q4"].shape[0] if "pe_gu_q4" in eq else 0
    ve, valid, w_visit = device_schedule(idx, weights, e, x.shape[0])
    if q4_stream_takes(x, eq):
        out = _launch_q4_stream(x, eq, n_sh, ve, valid, w_visit, out_dtype)
    else:
        out = launch_moe_quant(4, False, x, eq, n_sh, ve=ve, valid=valid, w_visit=w_visit, out_dtype=out_dtype)
    moe_ffn_decode_q4_fused.launches += 1
    return out


moe_ffn_decode_q4_fused.launches = 0

STREAM_MAX_H = 1280  # gate/up: a compute warp for each 128-level group of H, 10 at most
STREAM_ROWS = 32  # decode rows a launch pair
ACT_PAD = 32  # act rows I + 32 apart


def q4_stream_takes(x: torch.Tensor, eq: QExperts4) -> bool:
    """Whether kernel N runs on the stream (`moe_q4_stream_bf16`): bf16 x, H
    and I multiples of 128 (whole groups) and H <= STREAM_MAX_H; otherwise
    its first form."""
    h, i = x.shape[-1], eq["gu_q4"].shape[1] // 2
    return x.dtype == torch.bfloat16 and h <= STREAM_MAX_H and h % GROUP == 0 and i % GROUP == 0


def down_split(h: int, n_ids: int, sm_count: int):
    """(consumer warps, parts) of N's down launch: a block takes 8 warps
    columns of H, warps the largest divisor of H / 8 up to 10; the visits'
    ids (E routed + n_sh pseudo) are cut into parts = SMs / tiles parts at
    fixed ids (at most one an id). Neither depends on B, so a row's bits
    do not either."""
    warps = max(w for w in range(1, 11) if (h // 8) % w == 0)
    return warps, max(1, min(sm_count // (h // (8 * warps)), n_ids))


def part_bounds(n_ids: int, parts: int):
    """The ids [lo, hi) of each part: part p holds [n_ids p / P, n_ids (p +
    1) / P), routed expert e id e, pseudo-expert t id E + t."""
    return [(n_ids * p // parts, n_ids * (p + 1) // parts) for p in range(parts)]


_SM_COUNT: Dict[int, int] = {}
_STREAM_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _stream_operands(x, eq: QExperts4, n_sh: int, takes: bool, kernel: str, rule: str):
    """The routed experts' four tensors and the n_sh pseudo-experts' (an
    empty list without them) for stream kernel `kernel`, checked: `takes`
    (the stream's own dtype and shape rule, `rule` in words) and x 2-D, the
    experts in `linear_q4`'s layout for x's H, on x's device and 16-byte
    aligned. Returns (gu, gus, down, ds, pe, x contiguous)."""
    gu, gus, down, ds = (eq[n] for n in _NAMES)
    e, i2, _ = gu.shape
    i, h = i2 // 2, x.shape[-1]
    shapes = ((i2, h // 2), (i2, h // GROUP), (h, i // 2), (h, i // GROUP))
    pe = [eq[f"pe_{n}"] for n in _NAMES] if n_sh else []
    if not takes or x.dim() != 2 \
            or any(t.shape != (e, *sh) for t, sh in zip((gu, gus, down, ds), shapes)) \
            or any(t.shape != (n_sh, *sh) for t, sh in zip(pe, shapes)) \
            or any(t.dtype != dt for t, dt in zip((gu, gus, down, ds, *pe), (torch.uint8, torch.float32) * 4)):
        raise ValueError(f"kernel {kernel} takes {rule}, and int4 experts: x {tuple(x.shape)} gu {tuple(gu.shape)} "
                         f"down {tuple(down.shape)}")
    x = x.contiguous()
    cuda_build.require_cuda(x, gu, gus, down, ds, *pe)
    if any(t.data_ptr() % 16 for t in (x, gu, gus, down, ds, *pe)):
        raise ValueError(f"kernel {kernel} reads 16-byte aligned rows and scales")
    return gu, gus, down, ds, pe, x


def _launch_q4_stream(x, eq: QExperts4, n_sh: int, ve, valid, w_visit, out_dtype=None) -> torch.Tensor:
    """Kernel N with bf16 x on J's bulk-copy tensor-core stream
    (`moe_q4_stream_bf16` in `csrc/moe_q4.cu`): gate/up, then down over the
    visits cut into parts at fixed ids, the parts' sums added by the last
    block of each column tile. Returns [B, H] bf16, or f32 (`out_dtype`)."""
    gu, gus, down, ds, pe, x = _stream_operands(
        x, eq, n_sh, q4_stream_takes(x, eq), "N", f"bf16 x [B, H] with H, I multiples of {GROUP} and H <= {STREAM_MAX_H}")
    if ve.dtype != torch.int32 or valid.dtype != torch.int32 or w_visit.dtype != torch.float32:
        raise ValueError("kernel N takes an int32 schedule and an f32 combine table")
    cuda_build.require_cuda(x, ve, valid, w_visit)
    e, i, (b, h) = gu.shape[0], gu.shape[1] // 2, x.shape
    dev = x.get_device()
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    warps, parts = down_split(h, e + n_sh, _SM_COUNT[dev])
    act = torch.empty(e + n_sh, STREAM_ROWS, i + ACT_PAD, dtype=x.dtype, device=x.device)
    yw = torch.empty(parts, min(b, STREAM_ROWS), h, dtype=torch.float32, device=x.device)
    counters = _arrival_counters(x, h // (8 * warps))
    out = torch.empty_like(x, dtype=check_out_dtype(x, out_dtype, "N"))
    fn = cuda_build.entry("moe_q4", "moe_q4_stream_bf16", _STREAM_ARGTYPES)
    p = cuda_build.ptr
    pgu, pgus, pdown, pds = (p(t) for t in pe) if pe else (None,) * 4
    err = fn(p(x), p(gu), p(gus), p(down), p(ds), pgu, pgus, pdown, pds, p(ve), p(valid), p(w_visit), p(act),
             p(yw), p(counters), p(out), b, e, n_sh, h, i, warps, parts, int(out.dtype == torch.float32),
             cuda_build.stream_of(x))
    cuda_build.check(err, "moe_q4 (N)")
    return out


# Kernel M's stream (`moe_q4_sel_bf16`): x rows a gate/up block stages, act
# values a down block stages.
SEL_MAX_X = 16 * 1280
SEL_MAX_ACT = 32 * 1024
SEL_SMEM = 128 * 1024  # gate/up's shared memory at most: x, then a ring of stages, 8 at least
_SEL_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def q4_sel_takes(x: torch.Tensor, eq: QExperts4, kv: int) -> bool:
    """Whether kernel M runs on its stream (`moe_q4_sel_bf16`): bf16 x, H
    and I multiples of 128, B H <= SEL_MAX_X, kv I <= SEL_MAX_ACT (kv =
    k + n_sh visits a row) and room for x and 8 stages in gate/up's shared
    memory; otherwise its first form."""
    h, i = x.shape[-1], eq["gu_q4"].shape[1] // 2
    if not (x.dtype == torch.bfloat16 and h % GROUP == 0 and i % GROUP == 0 and x.shape[0] * h <= SEL_MAX_X
            and kv * i <= SEL_MAX_ACT):
        return False
    # gate/up's ring (csrc/moe_q4.cu SelGuLayout): x's rows, then stages of
    # 8 gate and 8 up code rows with their scales, a multiple of 8 of them.
    x_bytes = -(-x.shape[0] * h * 2 // 128) * 128
    stage = -(-16 * (h // 2 + h // GROUP * 4) // 128) * 128
    return (SEL_SMEM - x_bytes - 256) // stage >= 8


def _launch_q4_sel(x, eq: QExperts4, n_sh: int, idx, weights, out_dtype=None) -> torch.Tensor:
    """Kernel M with bf16 x on its stream (`moe_q4_sel_bf16` in
    `csrc/moe_q4.cu`): gate/up over every SM, then down with the combine
    folded in, launched as a programmatic dependent of gate/up so that its
    code rows stream while gate/up runs. Returns [B, H] bf16, or f32
    (`out_dtype`)."""
    idx, weights, ld = routing_rows(idx, weights)
    k = idx.shape[1]
    gu, gus, down, ds, pe, x = _stream_operands(
        x, eq, n_sh, q4_sel_takes(x, eq, k + n_sh), "M",
        f"bf16 x [B, H] with H, I multiples of {GROUP}, B H <= {SEL_MAX_X} and (k + n_sh) I <= {SEL_MAX_ACT}")
    e, i, (b, h) = gu.shape[0], gu.shape[1] // 2, x.shape
    if idx.shape != weights.shape or idx.shape[0] != b:
        raise ValueError(f"routing idx {tuple(idx.shape)} / weights {tuple(weights.shape)} do not fit x")
    cuda_build.refuse_autograd(idx, weights)
    if idx.device != x.device or weights.device != x.device:
        raise ValueError("kernel M's routing must lie on x's device")
    act = torch.empty(b * (k + n_sh), i, dtype=x.dtype, device=x.device)
    out = torch.empty_like(x, dtype=check_out_dtype(x, out_dtype, "M"))
    fn = cuda_build.entry("moe_q4", "moe_q4_sel_bf16", _SEL_ARGTYPES)
    p = cuda_build.ptr
    pgu, pgus, pdown, pds = (p(t) for t in pe) if pe else (None,) * 4
    err = fn(p(x), p(gu), p(gus), p(down), p(ds), pgu, pgus, pdown, pds, p(idx), p(weights), p(act), p(out),
             b, e, k, ld, n_sh, h, i, int(out.dtype == torch.float32), cuda_build.stream_of(x))
    cuda_build.check(err, "moe_q4 (M)")
    return out
