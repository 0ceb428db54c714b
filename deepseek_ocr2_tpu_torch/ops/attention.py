"""Attention ops — plain paths (port of deepseek_ocr2_tpu.ops.attention).

Scores, softmax and PV in f32; masked positions are -1e4 (not -inf), the
reference's mask constant; the output is cast to the requested dtype.
`sdpa` is written as matmul + softmax on purpose, and not as
`F.scaled_dot_product_attention`, so that its numerics are those of the
JAX function it mirrors.
"""

from __future__ import annotations

from typing import Optional

import torch

MASK_VALUE = -1.0e4


def sdpa(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Sk, D]
    v: torch.Tensor,  # [B, H, Sk, D]
    *,
    scale: float,
    mask: Optional[torch.Tensor] = None,  # bool, True = disallowed
    bias: Optional[torch.Tensor] = None,  # f32, added before the mask
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    out_dtype = out_dtype or q.dtype
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    if mask is not None:
        scores = scores.masked_fill(mask, MASK_VALUE)
    weights = torch.softmax(scores, dim=-1)
    return torch.matmul(weights, v.float()).to(out_dtype)


def causal_mask(seq_q: int, seq_k: int, q_start: int = 0, device=None) -> torch.Tensor:
    """[Sq, Sk] bool, True where key position > query position."""
    q_pos = q_start + torch.arange(seq_q, device=device)[:, None]
    return torch.arange(seq_k, device=device)[None, :] > q_pos


def prefix_lm_mask(seq: int, n_prefix: int, device=None) -> torch.Tensor:
    """[S, S] bool, True = disallowed: prefix rows see prefix columns only;
    suffix rows see the prefix plus causal self-attention."""
    pos = torch.arange(seq, device=device)
    row, col = pos[:, None], pos[None, :]
    query_col = col >= n_prefix
    disallow_prefix = (row < n_prefix) & query_col
    disallow_query = (row >= n_prefix) & query_col & (col > row)
    return disallow_prefix | disallow_query


def decode_mask(cap: int, pos: int, device=None) -> torch.Tensor:
    """[1, cap] bool for one decode step at absolute position `pos`."""
    return torch.arange(cap, device=device)[None, :] > pos


def repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, Hk, S, D] -> [B, Hk*groups, S, D], each KV head repeated
    `groups` times contiguously (HF `repeat_kv` order)."""
    if groups == 1:
        return x
    b, hk, s, d = x.shape
    return x[:, :, None].expand(b, hk, groups, s, d).reshape(b, hk * groups, s, d)
