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
`csrc/moe_q4.cu`, the int4 instance of the kernels I and J share
(`csrc/moe_quant.cuh`, whose header gives the design), launched by
`moe_q8.launch_moe_quant`; their plain twins are
`moe_ffn_decode_q4_reference` and `moe_ffn_decode_q4_visits_reference`.

A wrapper runs its plain twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises. Nothing here reads a value back to the host.
`launches` counts calls that launch M or N (three CUDA launches each, N's
schedule a fourth).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .linear_q4 import dequantize_q4, q4_dot, quantize_q4
from .moe_decode import combine_table, device_schedule, distinct_schedule
from .moe_q8 import launch_moe_quant

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


def moe_ffn_decode_q4_reference(x, eq: QExperts4, weights, idx, *, with_shared: bool = False) -> torch.Tensor:
    """Plain twin of M: each row's selections in top-k order (the selected
    experts gathered per row), then the pseudo-experts with weight 1,
    accumulated in f32 in that order. Returns [B, H] in x's dtype."""
    x32 = x.float()
    out = torch.zeros(x.shape[0], eq["down_q4"].shape[1], dtype=torch.float32, device=x.device)
    for j in range(idx.shape[1]):
        ex = idx[:, j].long()
        y = expert_swiglu_q4(x32, *(eq[n][ex] for n in _NAMES), x.dtype)
        out = out + y * weights[:, j : j + 1].float()
    if with_shared:
        for pe in pseudo_experts_q4(eq):
            out = out + expert_swiglu_q4(x32, *pe, x.dtype)
    return out.to(x.dtype)


def moe_ffn_decode_q4_visits_reference(x, eq: QExperts4, weights, idx) -> torch.Tensor:
    """Plain twin of N: every visit of the schedule over all rows, y * w
    summed in f32 in visit order (pad visits repeat a real expert with zero
    weights, so they add exact zeros), then the pseudo-experts with weight
    1. Returns [B, H] in x's dtype."""
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
    return out.to(x.dtype)


def moe_ffn_decode_q4(x: torch.Tensor, eq: QExperts4, weights: torch.Tensor, idx: torch.Tensor, *,
                      with_shared: bool = False) -> torch.Tensor:
    """Kernel M: the per-selection int4 MoE decode FFN. With `with_shared`
    the shared pseudo-experts are folded in and the caller adds no separate
    shared term. Returns [B, H] in x's dtype."""
    if x.device.type == "cpu":
        return moe_ffn_decode_q4_reference(x, eq, weights, idx, with_shared=with_shared)
    n_sh = eq["pe_gu_q4"].shape[0] if with_shared else 0
    out = launch_moe_quant(4, True, x, eq, n_sh, idx=idx, weights=weights)
    moe_ffn_decode_q4.launches += 1
    return out


moe_ffn_decode_q4.launches = 0


def moe_ffn_decode_q4_fused(x: torch.Tensor, eq: QExperts4, weights: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel N: the int4 distinct-expert batched-decode MoE FFN, the shared
    pseudo-experts folded in when `eq` has them. Returns [B, H] in x's
    dtype."""
    if x.device.type == "cpu":
        return moe_ffn_decode_q4_visits_reference(x, eq, weights, idx)
    e = eq["gu_q4"].shape[0]
    n_sh = eq["pe_gu_q4"].shape[0] if "pe_gu_q4" in eq else 0
    ve, valid, w_visit = device_schedule(idx, weights, e, x.shape[0])
    out = launch_moe_quant(4, False, x, eq, n_sh, ve=ve, valid=valid, w_visit=w_visit)
    moe_ffn_decode_q4_fused.launches += 1
    return out


moe_ffn_decode_q4_fused.launches = 0
