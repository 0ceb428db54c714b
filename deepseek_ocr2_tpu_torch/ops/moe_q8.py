"""Int8-weight MoE decode, kernel I: one visit per (row, selection)
(port of deepseek_ocr2_tpu/ops/moe_q8.py).

Quantization keeps the port's [out, in] layout, symmetric per output
channel as `linear_q8.quantize_per_col`:
- gu_q8 int8 [E, 2I, H] (gate rows, then up rows: one weight stream per
  expert), gu_scale f32 [E, 2I];
- down_q8 int8 [E, H, I], down_scale f32 [E, H].
A per-output-channel scale is unchanged by the gate||up concat, so the codes
and scales are the JAX package's, transposed.

`moe_ffn_decode_q8` is kernel I (`csrc/moe_q8.cu`, whose header gives the
design and the rounding points): for each row, its k selected experts in
top-k order and, with `with_shared`, the n_sh shared pseudo-experts
(`pe_*` keys, the shared MLP split along its intermediate dim) with weight
1, summed in that order in f32. Its plain twin is
`moe_ffn_decode_q8_reference`. The JAX package takes it while B * k <= E;
above, kernel J (`moe_decode.moe_ffn_decode_q8_fused`) reads each distinct
expert once. Both kernels share one CUDA source. Its launcher here,
`launch_moe_quant`, launches I, J's first form (f32 x, or a shape the
stream does not take: `moe_decode.q8_stream_takes`; otherwise J runs its
own stream, `moe_decode._launch_q8_stream`) and the int4 kernels M and N
(`moe_q4`).

Under expert parallelism (`ops.moe.local_routing`) a rank holds E_local
experts and another rank's selection carries the id E_local and weight 0:
I (and M) take it as a visit with no work, which reads no expert and adds
nothing, so a row with no local selection gives an exact zero; J and N
never see it (their schedule gives it no visit). Every kernel here writes
x's dtype or, with `out_dtype=torch.float32`, the rank's partial
unrounded, summed over the ranks before one rounding. The sharded forward
passes `routed_only(eq)`: the pseudo-experts are whole on every rank, and
folded into each rank's partial they would be counted once a rank.

A wrapper runs its plain twin only for CPU tensors; for CUDA tensors it
launches the kernel or raises. Nothing here reads a value back to the host.
`launches` counts calls that launch I (three CUDA launches each).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from . import cuda_build
from .linear_q4 import GROUP, padded
from .linear_q8 import quantize_per_col

QExperts = Dict[str, torch.Tensor]


def quantize_experts(experts: Dict[str, torch.Tensor]) -> QExperts:
    """{gate, up: [E, I, H], down: [E, H, I]} -> {gu_q8, gu_scale, down_q8,
    down_scale} (gate||up fused along the output rows)."""
    gu_q8, gu_scale = quantize_per_col(torch.cat([experts["gate"], experts["up"]], dim=-2))
    down_q8, down_scale = quantize_per_col(experts["down"])
    return {"gu_q8": gu_q8.contiguous(), "gu_scale": gu_scale.contiguous(),
            "down_q8": down_q8.contiguous(), "down_scale": down_scale.contiguous()}


def expert_swiglu_q8(x32: torch.Tensor, gu, gus, down, ds, dtype: torch.dtype) -> torch.Tensor:
    """One int8 expert on f32 rows x32 [N, H] at the kernels' rounding
    points: gate and up in f32 after the scale, silu in f32, the activation
    rounded to `dtype`, y = (act . down) * ds in f32. gu [2I, H] or a batch
    [N, 2I, H] (one expert per row), and so on."""
    if gu.dim() == 2:
        h2 = F.linear(x32, gu.float()) * gus
    else:
        h2 = torch.einsum("nh,nih->ni", x32, gu.float()) * gus
    i = h2.shape[-1] // 2
    act = (F.silu(h2[:, :i]) * h2[:, i:]).to(dtype).float()
    if down.dim() == 2:
        return F.linear(act, down.float()) * ds
    return torch.einsum("ni,nhi->nh", act, down.float()) * ds


def routed_only(eq: QExperts) -> QExperts:
    """The routed experts of `eq` without the shared pseudo-experts (`pe_*`
    keys), int8 or int4."""
    return {k: v for k, v in eq.items() if not k.startswith("pe_")}


def selection_terms(out: torch.Tensor, y: torch.Tensor, w: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """out + y * w for the rows whose selection is one of the rank's
    experts (`local`), out unchanged for the others: the per-selection
    kernels' rule for another rank's selection (no term at all)."""
    return torch.where(local[:, None], out + y * w.float()[:, None], out)


def pseudo_experts(eq: QExperts):
    """The n_sh shared pseudo-experts as (gu, gus, down, ds) tuples."""
    return [(eq["pe_gu_q8"][t], eq["pe_gu_scale"][t], eq["pe_down_q8"][t], eq["pe_down_scale"][t])
            for t in range(eq["pe_gu_q8"].shape[0])]


def moe_ffn_decode_q8_reference(x, eq: QExperts, weights, idx, *, with_shared: bool = False,
                                out_dtype=None) -> torch.Tensor:
    """Plain twin of I: each row's selections in top-k order (the selected
    experts gathered per row; another rank's selection, id E, adds
    nothing), then the pseudo-experts with weight 1, accumulated in f32 in
    that order. Returns [B, H] in `out_dtype` (x's dtype by default; f32
    leaves the sum unrounded)."""
    x32 = x.float()
    e = eq["gu_q8"].shape[0]
    out = torch.zeros(x.shape[0], eq["down_q8"].shape[1], dtype=torch.float32, device=x.device)
    for j in range(idx.shape[1]):
        local = idx[:, j] < e
        ex = idx[:, j].long().clamp(max=e - 1)
        y = expert_swiglu_q8(x32, eq["gu_q8"][ex], eq["gu_scale"][ex], eq["down_q8"][ex], eq["down_scale"][ex],
                             x.dtype)
        out = selection_terms(out, y, weights[:, j], local)
    if with_shared:
        for pe in pseudo_experts(eq):
            out = out + expert_swiglu_q8(x32, *pe, x.dtype)
    return out.to(out_dtype or x.dtype)


def routing_rows(idx: torch.Tensor, weights: torch.Tensor):
    """(idx, weights, row stride) for the kernels of `csrc/moe_q8.cu`: the
    router's outputs are [:, :k] slices of its sorted [B, E] tensors, read
    in place (rows E apart) when their rows are unit-stride and share a
    stride; otherwise copied contiguous."""
    weights = weights.float()
    if idx.dtype != torch.int64:
        idx = idx.long()
    if idx.stride(1) != 1 or weights.stride(1) != 1 or idx.stride(0) != weights.stride(0):
        idx, weights = idx.contiguous(), weights.contiguous()
    return idx, weights, idx.stride(0)


def _stream_shapes(bits: int, rows: int, in_dim: int):
    """(codes, scales) shapes of `rows` quantized rows over `in_dim` inputs:
    int8 [rows, In] with one scale a row, or int4 [rows, In_p / 2] with one
    a group of 128 (`linear_q4`'s layout)."""
    if bits == 8:
        return (rows, in_dim), (rows,)
    return (rows, padded(in_dim) // 2), (rows, padded(in_dim) // GROUP)


def check_out_dtype(x: torch.Tensor, out_dtype, name: str) -> torch.dtype:
    """The output dtype of a decode MoE kernel: x's (the default) or f32."""
    od = out_dtype or x.dtype
    if od not in (x.dtype, torch.float32):
        raise ValueError(f"kernel {name} writes x's dtype or f32, not {od}")
    return od


def launch_moe_quant(bits: int, per_sel: bool, x: torch.Tensor, eq: QExperts, n_sh: int, *, idx=None,
                     weights=None, ve=None, valid=None, w_visit=None, out_dtype=None) -> torch.Tensor:
    """Launch kernel I (`per_sel`, with idx / weights) or J's first form
    (with the visit schedule ve / valid / w_visit) of `csrc/moe_q8.cu` over
    int8 experts (bits 8), or M or N of `csrc/moe_q4.cu` over int4 ones
    (bits 4). One set of kernels serves both (`csrc/moe_quant.cuh`).
    Returns [B, H] in `out_dtype` (x's dtype by default, or f32)."""
    names = (f"gu_q{bits}", "gu_scale", f"down_q{bits}", "down_scale")
    gu, gus, down, ds = (eq[n] for n in names)
    e, i2 = gu.shape[:2]
    i = i2 // 2
    b, h = x.shape
    dt = x.dtype
    name = ("I" if per_sel else "J") if bits == 8 else ("M" if per_sel else "N")
    code_dt, align = (torch.int8, 16) if bits == 8 else (torch.uint8, 32)
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernel {name} takes f32 or bf16 x, got {dt}")
    od = check_out_dtype(x, out_dtype, name)
    (cg, sg), (cd, sd) = _stream_shapes(bits, i2, h), _stream_shapes(bits, h, i)
    if gu.shape != (e, *cg) or gus.shape != (e, *sg) or down.shape != (e, *cd) or ds.shape != (e, *sd) \
            or gu.dtype != code_dt or down.dtype != code_dt or gus.dtype != torch.float32 \
            or ds.dtype != torch.float32:
        raise ValueError(f"x {tuple(x.shape)} and int{bits} experts gu {tuple(gu.shape)} down {tuple(down.shape)} "
                         "do not fit")
    if h % align or i % align:
        raise ValueError(f"kernel {name} needs H ({h}) and I ({i}) multiples of {align}")
    pe = [eq[f"pe_{n}"] for n in names] if n_sh else []
    if pe and (pe[0].shape != (n_sh, *cg) or pe[2].shape != (n_sh, *cd)):
        raise ValueError(f"pseudo-experts {tuple(pe[0].shape)} / {tuple(pe[2].shape)} do not fit")
    x = x.contiguous()
    sched = [t for t in (ve, valid, w_visit) if t is not None]
    cuda_build.require_cuda(x, gu, gus, down, ds, *pe, *sched)
    if any(t.data_ptr() % 16 for t in (x, gu, down, *pe[::2])):
        raise ValueError(f"kernel {name} reads 16-byte aligned rows")
    ld = 1
    if per_sel:
        idx, weights, ld = routing_rows(idx, weights)
        if idx.device != x.device or weights.device != x.device or idx.shape != weights.shape \
                or idx.shape[0] != b:
            raise ValueError(f"routing idx {tuple(idx.shape)} / weights {tuple(weights.shape)} do not fit x")
        n_rows, n_visits = 1, b * (idx.shape[1] + n_sh)
    else:
        if ve.dtype != torch.int32 or valid.dtype != torch.int32 or w_visit.dtype != torch.float32:
            raise ValueError(f"kernel {name} takes an int32 schedule and an f32 combine table")
        n_rows, n_visits = b, e + n_sh
    act = torch.empty(n_visits, n_rows, i, dtype=dt, device=x.device)
    yw = torch.empty(n_visits, n_rows, h, dtype=torch.float32, device=x.device)
    out = torch.empty(b, h, dtype=od, device=x.device)
    lib = cuda_build.load(f"moe_q{bits}")
    fn = getattr(lib, f"moe_q{bits}_{'f32' if dt == torch.float32 else 'bf16'}")
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def p(t: Optional[torch.Tensor]):
        return ctypes.c_void_p(None) if t is None else cuda_build.ptr(t)

    pgu, pgus, pdown, pds = pe or (None,) * 4
    k = idx.shape[1] if per_sel else 1
    err = fn(int(per_sel), p(x), p(gu), p(gus), p(down), p(ds), p(pgu), p(pgus), p(pdown), p(pds),
             p(idx), p(weights), p(ve), p(valid), p(w_visit), p(act), p(yw), p(out),
             b, e, k, ld, n_sh, h, i, int(od == torch.float32), cuda_build.stream_of(x))
    cuda_build.check(err, f"moe_q{bits}")
    return out


def moe_ffn_decode_q8(x: torch.Tensor, eq: QExperts, weights: torch.Tensor, idx: torch.Tensor, *,
                      with_shared: bool = False, out_dtype=None) -> torch.Tensor:
    """Kernel I: the per-selection int8 MoE decode FFN. With `with_shared`
    the shared pseudo-experts are folded in and the caller adds no separate
    shared term. Returns [B, H] in `out_dtype` (x's dtype by default, or
    f32)."""
    if x.device.type == "cpu":
        return moe_ffn_decode_q8_reference(x, eq, weights, idx, with_shared=with_shared, out_dtype=out_dtype)
    n_sh = eq["pe_gu_q8"].shape[0] if with_shared else 0
    out = launch_moe_quant(8, True, x, eq, n_sh, idx=idx, weights=weights, out_dtype=out_dtype)
    moe_ffn_decode_q8.launches += 1
    return out


moe_ffn_decode_q8.launches = 0
