"""Rotary position embeddings, half-split (LLaMA/Qwen) variant, in f32.

Port of deepseek_ocr2_tpu.ops.rope: the cos/sin cache is computed with the
same numpy expression, so both packages hold bit-identical tables.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rope_cache(
    max_pos: int, head_dim: int, theta: float, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin caches `[max_pos, head_dim]` f32; emb = concat([freqs, freqs])."""
    exponents = np.arange(0, head_dim, 2, dtype=np.float32) / np.float32(head_dim)
    inv_freq = (1.0 / (np.float32(theta) ** exponents)).astype(np.float32)
    pos = np.arange(max_pos, dtype=np.float32)
    emb = np.concatenate([np.outer(pos, inv_freq)] * 2, axis=-1)
    cos = torch.from_numpy(np.cos(emb).astype(np.float32))
    sin = torch.from_numpy(np.sin(emb).astype(np.float32))
    return cos.to(device), sin.to(device)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,  # [B, H, S, D]
    k: torch.Tensor,  # [B, Hk, S, D]
    cos_cache: torch.Tensor,  # [max_pos, D] f32
    sin_cache: torch.Tensor,
    start: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE on tokens at positions [start, start+S); returns f32 q, k."""
    seq = q.shape[2]
    cos = cos_cache[start : start + seq][None, None]
    sin = sin_cache[start : start + seq][None, None]
    q32 = q.float()
    k32 = k.float()
    return q32 * cos + _rotate_half(q32) * sin, k32 * cos + _rotate_half(k32) * sin


def rope_rows(
    cos_cache: torch.Tensor, sin_cache: torch.Tensor, pos: torch.Tensor, seq: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [B, 1, S, D] for each row's S tokens at positions pos[b] ..
    pos[b] + S - 1 (per-row positions, `pos` [B] on the device)."""
    posq = pos.long()[:, None] + torch.arange(seq, device=pos.device)
    return cos_cache[posq][:, None], sin_cache[posq][:, None]


def apply_rope_rows(
    q: torch.Tensor, k: torch.Tensor, cos_b: torch.Tensor, sin_b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE with the per-row tables of `rope_rows` on q, k [B, H, S, D];
    returns f32 q, k (the arithmetic of `apply_rope`)."""
    q32 = q.float()
    k32 = k.float()
    return q32 * cos_b + _rotate_half(q32) * sin_b, k32 * cos_b + _rotate_half(k32) * sin_b
