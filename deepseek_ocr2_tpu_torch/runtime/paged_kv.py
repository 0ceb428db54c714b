"""Paged KV cache: fixed-size pages from a shared pool + per-slot block
tables (port of deepseek_ocr2_tpu.runtime.paged_kv, f32 and bf16 pools).

The pool keeps the JAX layout, {"k", "v"}: [L, P, Hh, page, D], so a port
pool and a JAX pool compare element by element after the same admissions.
Sequences of very different lengths share it, pages are recycled on
completion, and capacity is bounded by the tokens in flight rather than
slots x max_len. Page allocation is on the host (the engine owns the free
list); decode attention over the pages is kernel G
(`ops.paged_attention.paged_decode_attention_pool`).

Page 0 is reserved as a scratch page: finished and empty slots of a batched
decode step write their discarded K/V there, so they never clobber a live
sequence's pages. Duplicate writes to it are harmless: no live row reads it.

The pool is updated in place. The JAX package's per-row
dynamic_update_slice chain (paged_kv.py:221-241) works around XLA's copy of
a scattered carry; here one `index_put_` per layer writes every row's token.
Only plain decode (one query per row) is ported: the chunk mode of lookup
decoding and the int8 / int8tail pools belong to later slices.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import DeepseekV2Config
from ..models.deepseek_v2 import rope_consts
from ..ops.moe import moe_ffn_decode, route, swiglu
from ..ops.norms import rms_norm
from ..ops.paged_attention import paged_decode_attention_pool

PagedKV = Dict[str, torch.Tensor]  # {"k": [L, P, Hh, page, D], "v": ...}

_QUANTIZED = ("int8", "int8tail")


def make_paged_kv_cache(
    num_layers: int,
    num_pages: int,
    num_heads: int,
    page_size: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device=None,
) -> PagedKV:
    """Zeroed K/V pool [L, P, Hh, page, D] in f32 or bf16."""
    if isinstance(dtype, str) and dtype in _QUANTIZED:
        raise ValueError(f"the {dtype} KV pool belongs to the quantized slice of the port, not ported yet")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged KV pools are f32 or bf16, not {dtype}")
    shape = (num_layers, num_pages, num_heads, page_size, head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


class PageAllocator:
    """Host-side free list over the page pool (page 0 reserved as scratch)."""

    def __init__(self, num_pages: int):
        self.free: List[int] = list(range(1, num_pages))

    @property
    def n_free(self) -> int:
        return len(self.free)

    def allocate(self, n: int) -> List[int]:
        if n > len(self.free):
            raise RuntimeError(f"page pool exhausted (need {n}, have {len(self.free)})")
        out = self.free[:n]
        del self.free[:n]
        return out

    def release(self, pages: List[int]) -> None:
        self.free.extend(pages)


def pages_for(seq_len: int, page_size: int) -> int:
    return -(-seq_len // page_size)


def write_prompt_pages_batched(
    pool: torch.Tensor,  # [L, P, Hh, page, D], written in place
    k_prompt: torch.Tensor,  # [L, G, Hh, cap, D] (batched contiguous prefill)
    page_ids: torch.Tensor,  # [G, n_pages] int
    seq_len: int,
) -> torch.Tensor:
    """Scatter a same-length admission group's K (or V) into its pages,
    one `index_put_` for the whole group. Positions past `seq_len` in the
    last page carry the prefill cache's zeros, as in the JAX package."""
    l, g, hh, cap, d = k_prompt.shape
    page = pool.shape[3]
    n_pages = page_ids.shape[1]
    padded = n_pages * page
    if cap < padded or padded < seq_len:
        raise ValueError(f"prefill capacity {cap} / pages {n_pages} x {page} do not cover {seq_len} tokens")
    kp = k_prompt[:, :, :, :padded].reshape(l, g, hh, n_pages, page, d).permute(0, 1, 3, 2, 4, 5)
    pool[:, page_ids.reshape(-1).long()] = kp.reshape(l, g * n_pages, hh, page, d).to(pool.dtype)
    return pool


def write_prompt_pool_batched(
    cache: PagedKV,
    k_new: torch.Tensor,  # [L, G, Hh, cap, D] contiguous prefill K
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # [G, n_pages] int
    seq_len: int,
) -> PagedKV:
    """Scatter an admission group's prompt K/V into the pool, in place."""
    write_prompt_pages_batched(cache["k"], k_new, page_ids, seq_len)
    write_prompt_pages_batched(cache["v"], v_new, page_ids, seq_len)
    return cache


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _paged_attention_step(
    xn: torch.Tensor,  # [B, S, H] normed input
    layer,
    cfg: DeepseekV2Config,
    cache: PagedKV,  # updated in place
    li: int,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    pos: torch.Tensor,  # [B] position of xn[:, 0]
    cos_b: torch.Tensor,  # [B, 1, 1, D]
    sin_b: torch.Tensor,
) -> torch.Tensor:
    """QKV + per-row RoPE + paged KV write + kernel G + out projection, for
    one query per row (S == 1). Row r's token lands in page
    block_tables[r, pos // page] at offset pos % page, then attends over
    its pos + 1 tokens."""
    b, s, h = xn.shape
    if s != 1:
        raise ValueError("paged decode takes one query per row here; the chunk mode (S > 1) "
                         "belongs to the lookup-decoding slice of the port")
    nh, d = cfg.num_attention_heads, cfg.head_dim

    def heads(w):
        return F.linear(xn, w).reshape(b, s, nh, d).transpose(1, 2)  # [B, Hh, 1, D]

    q, k, v = heads(layer["wq"]), heads(layer["wk"]), heads(layer["wv"])
    q32, k32 = q.float(), k.float()
    q32 = q32 * cos_b + _rotate_half(q32) * sin_b
    k32 = k32 * cos_b + _rotate_half(k32) * sin_b
    v32 = v.float()

    k_pool, v_pool = cache["k"], cache["v"]
    page = k_pool.shape[3]
    rows = torch.arange(b, device=xn.device)
    pos_l = pos.long()
    page_ids = block_tables.long()[rows, pos_l // page]
    off = pos_l % page
    k_pool[li][page_ids, :, off] = k32[:, :, 0, :].to(k_pool.dtype)  # one index_put_ per pool
    v_pool[li][page_ids, :, off] = v32[:, :, 0, :].to(v_pool.dtype)
    seq_lens = (pos + 1).to(torch.int32)
    ctx = paged_decode_attention_pool(
        q32[:, :, 0, :].contiguous(), k_pool, v_pool, block_tables, seq_lens, li, scale=1.0 / math.sqrt(d)
    )
    return F.linear(ctx.reshape(b, 1, h).to(xn.dtype), layer["wo"])


def _chunk_rope(cos: torch.Tensor, sin: torch.Tensor, pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin broadcastable to [B, Hh, 1, D] for per-row positions pos [B]."""
    idx = pos.long()
    return cos[idx][:, None, None, :], sin[idx][:, None, None, :]


@torch.no_grad()
def lm_decode_step_paged(
    params,
    cfg: DeepseekV2Config,
    embeds: torch.Tensor,  # [B, 1, H]
    cache: PagedKV,  # updated in place
    block_tables: torch.Tensor,  # [B, max_pages] int32
    pos: torch.Tensor,  # [B] per-row position of embeds[:, 0]
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """One decode step over the paged pool; returns the final-normed hidden
    [B, 1, H]. The routed MoE of a layer is kernel F when B * k > E (every
    slot counts, active or not), the per-selection path otherwise."""
    cos, sin = rope if rope is not None else rope_consts(cfg, embeds.device)
    cos_b, sin_b = _chunk_rope(cos, sin, pos)
    b, s, h = embeds.shape
    x = embeds
    for li, layer in enumerate(params["layers"]):
        res = x
        xn = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        x = res + _paged_attention_step(xn, layer, cfg, cache, li, block_tables, pos, cos_b, sin_b)
        res = x
        xn = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
        x_flat = xn.reshape(b * s, h)
        if "mlp" in layer:
            m = layer["mlp"]
            out = swiglu(x_flat, m["gate"], m["up"], m["down"])
        else:
            weights, idx = route(x_flat, layer["router"], cfg.num_experts_per_tok)
            sh = layer["shared"]
            out = moe_ffn_decode(x_flat, layer["experts"], weights, idx) + swiglu(
                x_flat, sh["gate"], sh["up"], sh["down"]
            )
        x = res + out.reshape(b, s, h)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)
