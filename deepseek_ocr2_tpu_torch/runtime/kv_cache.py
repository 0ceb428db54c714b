"""Preallocated contiguous KV cache (port of deepseek_ocr2_tpu.runtime.kv_cache).

One [L, B, Hh, capacity, D] buffer each for K and V, in f32 or bf16,
written in place as tokens arrive. Attention always widens cached K/V to f32.
The int8 / int8tail kinds are paged pools only (runtime/paged_kv.py): asked
for here they raise the JAX package's error, so `generate-ocr` and the group
engine refuse them as the JAX CLI does.
"""

from __future__ import annotations

from typing import Dict

import torch

KVCache = Dict[str, torch.Tensor]


def make_kv_cache(
    num_layers: int, batch: int, num_heads: int, capacity: int, head_dim: int,
    dtype: torch.dtype = torch.bfloat16, device=None,
) -> KVCache:
    if dtype in ("int8", "int8tail", torch.int8):
        raise ValueError(
            "int8/int8tail KV applies to the paged pool only (serve "
            "--continuous/--http with --kv-cache int8|int8tail); contiguous "
            "caches are f32/bf16"
        )
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"contiguous KV caches are f32 or bf16, not {dtype}")
    shape = (num_layers, batch, num_heads, capacity, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def bucket_capacity(needed: int, bucket: int = 256, minimum: int = 1024) -> int:
    """Round capacity up to a bucket boundary (same rule as the JAX package)."""
    cap = max(needed, minimum)
    return ((cap + bucket - 1) // bucket) * bucket
