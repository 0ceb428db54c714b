"""Mixture-of-Experts ops (port of deepseek_ocr2_tpu.ops.moe).

Weights keep HF's [out, in] layout, stacked per layer over experts:
gate/up [E, I, H], down [E, H, I].

Numeric policy: gate logits and softmax in f32; top-k with the first index
winning ties (as `lax.top_k`; `torch.topk` makes no promise on ties, so the
selection is a stable descending sort); silu in f32, rounded back to the
model dtype before the up product; expert outputs combined in f32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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
) -> torch.Tensor:
    """Every expert on every row, combined with the routing weights; the
    experts are summed in ascending id order (HF `moe_infer`)."""
    n, h = x_flat.shape
    e = experts["gate"].shape[0]
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
    return out.to(x_flat.dtype)


def moe_ffn_prefill(x_flat, experts, weights, idx) -> torch.Tensor:
    """Prefill MoE. At most GMM_ROWS rows: the dense form. Above: the
    grouped GEMM (`moe_gmm.moe_ffn_gmm`), kernels D and E on CUDA and the
    grouped twin on the CPU, as the JAX package's CPU path runs its ragged
    grouped form there."""
    if x_flat.shape[0] > GMM_ROWS:
        return moe_ffn_gmm(x_flat, experts, weights, idx)
    return moe_ffn_dense(x_flat, experts, weights, idx)


def moe_ffn_decode(x_flat, experts, weights, idx) -> torch.Tensor:
    """Decode MoE. N*k <= E: per selection, reading only the selected
    experts (gathered by index on device, no host sync), accumulated in
    selection order in f32. Otherwise the dense form."""
    n, h = x_flat.shape
    k = idx.shape[1]
    if n * k > experts["gate"].shape[0]:
        return moe_ffn_dense(x_flat, experts, weights, idx)
    acc = torch.zeros(n, h, dtype=torch.float32, device=x_flat.device)
    for t in range(n):
        sel = idx[t]
        x_t = x_flat[t]
        gate = torch.einsum("h,kih->ki", x_t, experts["gate"][sel])
        up = torch.einsum("h,kih->ki", x_t, experts["up"][sel])
        act = F.silu(gate.float()).to(gate.dtype) * up
        y = torch.einsum("ki,khi->kh", act, experts["down"][sel])
        for j in range(k):
            acc[t] += y[j].float() * weights[t, j]
    return acc.to(x_flat.dtype)
