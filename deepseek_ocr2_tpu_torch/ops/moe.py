"""Mixture-of-Experts ops (port of deepseek_ocr2_tpu.ops.moe).

Weights keep HF's [out, in] layout, stacked per layer over experts:
gate/up [E, I, H], down [E, H, I].

Numeric policy: gate logits and softmax in f32; top-k with the first index
winning ties (as `lax.top_k`; `torch.topk` makes no promise on ties, so the
selection is a stable descending sort); silu in f32, rounded back to the
model dtype before the up product; expert outputs combined in f32.

Under expert parallelism a rank holds E_local = E / mp experts, the global
ids [r E_local, (r + 1) E_local). `local_routing` maps the routing onto
them: a selection of another rank's expert gets the id E_local (no expert
of this rank) and weight 0. Every form here takes such ids: the grouped
form gives them no slot, kernel F's schedule no visit, the dense and
per-selection forms an exact zero.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .moe_decode import moe_ffn_decode_fused
from .moe_gmm import moe_ffn_gmm

# Prefill rows above which the JAX package switches from the dense form to
# the expert-aligned grouped GEMM (ops/moe.py there); the port keeps the
# cut-over (an H100 measurement has not moved it yet).
GMM_ROWS = 512


def route(x_flat: torch.Tensor, router_w: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights [N, k] f32, idx [N, k] int64); router_w is [E, H]."""
    logits = F.linear(x_flat.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return weights[:, :top_k], idx[:, :top_k]


def local_routing(weights: torch.Tensor, idx: torch.Tensor, e_local: int, rank: int):
    """(weights, idx) of the selections on rank `rank`'s experts in local
    ids; the others id e_local and weight 0."""
    local = idx - rank * e_local
    mine = (local >= 0) & (local < e_local)
    return torch.where(mine, weights, 0.0), torch.where(mine, local, e_local)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Dense SwiGLU MLP with HF-layout weights."""
    gate = F.linear(x, w_gate)
    up = F.linear(x, w_up)
    act = F.silu(gate.float()).to(gate.dtype) * up
    return F.linear(act, w_down)


def moe_ffn_dense(
    x_flat: torch.Tensor,  # [N, H]
    experts: Dict[str, torch.Tensor],
    weights: torch.Tensor,  # [N, k] f32
    idx: torch.Tensor,  # [N, k]
    out_dtype=None,
) -> torch.Tensor:
    """Every expert on every row, combined with the routing weights; the
    experts are summed in ascending id order (HF `moe_infer`), in f32, cast
    to `out_dtype` (x's dtype by default)."""
    n, h = x_flat.shape
    e = experts["gate"].shape[0]
    idx = idx.clamp(max=e - 1)  # another rank's selection (id e) has weight 0
    gate = torch.einsum("nh,eih->nei", x_flat, experts["gate"])
    up = torch.einsum("nh,eih->nei", x_flat, experts["up"])
    act = F.silu(gate.float()).to(gate.dtype) * up
    y = torch.einsum("nei,ehi->neh", act, experts["down"])  # [N, E, H]
    w_full = torch.zeros(n, e, dtype=torch.float32, device=x_flat.device)
    w_full.scatter_add_(1, idx, weights)
    y = y.float()
    out = torch.zeros(n, h, dtype=torch.float32, device=x_flat.device)
    for j in range(e):
        out.addcmul_(y[:, j], w_full[:, j : j + 1])
    return out.to(out_dtype or x_flat.dtype)


def moe_ffn_prefill(x_flat, experts, weights, idx, n_rows=None, out_dtype=None) -> torch.Tensor:
    """Prefill MoE. At most GMM_ROWS rows: the dense form. Above: the
    grouped GEMM (`moe_gmm.moe_ffn_gmm`), kernels D and E on CUDA and the
    grouped twin on the CPU, as the JAX package's CPU path runs its ragged
    grouped form there. `n_rows`: the rows the cut-over reads (the global
    count under a mesh, as GSPMD's logical shapes; default x's rows)."""
    if (x_flat.shape[0] if n_rows is None else n_rows) > GMM_ROWS:
        return moe_ffn_gmm(x_flat, experts, weights, idx, out_dtype)
    return moe_ffn_dense(x_flat, experts, weights, idx, out_dtype)


def moe_ffn_decode_per_selection(x_flat, experts, weights, idx, out_dtype=None) -> torch.Tensor:
    """Per selection: each row against only its selected experts (gathered by
    index on the device, no host sync), accumulated in selection order in
    f32, cast to `out_dtype` (x's dtype by default)."""
    n, h = x_flat.shape
    k = idx.shape[1]
    acc = torch.zeros(n, h, dtype=torch.float32, device=x_flat.device)
    idx = idx.clamp(max=experts["gate"].shape[0] - 1)  # another rank's selection has weight 0
    for t in range(n):
        sel = idx[t]
        x_t = x_flat[t]
        gate = torch.einsum("h,kih->ki", x_t, experts["gate"][sel])
        up = torch.einsum("h,kih->ki", x_t, experts["up"][sel])
        act = F.silu(gate.float()).to(gate.dtype) * up
        y = torch.einsum("ki,khi->kh", act, experts["down"][sel])
        for j in range(k):
            acc[t] += y[j].float() * weights[t, j]
    return acc.to(out_dtype or x_flat.dtype)


def moe_ffn_decode(x_flat, experts, weights, idx, n_rows=None, n_experts=None, out_dtype=None) -> torch.Tensor:
    """Decode MoE. N*k <= E: the per-selection path. Otherwise one visit per
    distinct selected expert (`moe_decode.moe_ffn_decode_fused`): kernel F
    on CUDA tensors, its plain twin on CPU tensors. The cut-over is the JAX
    package's; N is the static decode batch, every slot, not only the
    active rows. Under a mesh the caller passes the global N (`n_rows`)
    and E (`n_experts`), and f32 as `out_dtype` (x's dtype by default)."""
    n = x_flat.shape[0] if n_rows is None else n_rows
    if n * idx.shape[1] > (experts["gate"].shape[0] if n_experts is None else n_experts):
        return moe_ffn_decode_fused(x_flat, experts, weights, idx, out_dtype)
    return moe_ffn_decode_per_selection(x_flat, experts, weights, idx, out_dtype)
