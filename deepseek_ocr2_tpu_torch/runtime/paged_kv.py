"""Paged KV cache: fixed-size pages from a shared pool + per-slot block
tables (port of deepseek_ocr2_tpu.runtime.paged_kv).

The pool keeps the JAX layout, {"k", "v"}: [L, P, Hh, page, D], so a port
pool and a JAX pool compare element by element after the same admissions.
Sequences of very different lengths share it, pages are recycled on
completion, and capacity is bounded by the tokens in flight rather than
slots x max_len. Page allocation is on the host (the engine owns the free
list). Decode attention over the pages is kernel G
(`ops.paged_attention.paged_decode_attention_pool`) on an f32 or bf16 pool,
and in the chunk mode of lookup decoding (S > 1 queries a row, each with its
own causal budget) kernel Q (`paged_decode_attention_pool_chunk`).

The quantized pools ("int8", "int8tail") hold int8 codes in "k"/"v" and
per-(token, head) f32 absmax scales in "k_scale"/"v_scale": [L, P, Hh,
page]. "int8tail" adds one bf16 open page a slot, "open_k"/"open_v": [L,
slots, Hh, page, D], holding each row's newest page exactly; attention
reads the row's last page from it. Decode attention over them is kernel P
(`paged_decode_attention_pool_q8`), and in the chunk mode kernel R
(`paged_decode_attention_pool_chunk_q8`).

Page 0 is reserved as a scratch page: finished and empty slots of a batched
decode step write their discarded K/V there, so they never clobber a live
sequence's pages. Duplicate writes to it are harmless: no live row reads it.

The pool is updated in place. The JAX package's per-row
dynamic_update_slice chain (paged_kv.py:221-241) works around XLA's copy of
a scattered carry; here one `index_put_` per pool plane and layer writes
every row's tokens, in plain decode (one a row) as in the chunk mode (S a
row, each at its own page and offset).

On params sharded onto a mesh (`parallel.shard_params`) the pool holds the
rank's heads (`models.deepseek_v2.n_heads`), Hh = heads / mp, and a step
runs the rank's heads, columns and experts with the mesh's collectives
(the projections of `models.deepseek_v2`: `qkv_proj`, `out_proj`, `ffn`).
The int8 pools quantize each (token, head) vector on its own, so a rank's
pool of its heads holds exactly the codes and scales of those heads in the
whole pool: they need nothing more under mp.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..configs import DeepseekV2Config
from ..models.deepseek_v2 import ffn, n_heads, out_proj, qkv_proj, rope_consts
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope_rows, rope_rows
from ..ops.paged_attention import (
    paged_decode_attention_pool,
    paged_decode_attention_pool_chunk,
    paged_decode_attention_pool_chunk_q8,
    paged_decode_attention_pool_q8,
)

PagedKV = Dict[str, torch.Tensor]  # {"k": [L, P, Hh, page, D], "v": ...} (+ the quantized pools' planes)


def make_paged_kv_cache(
    num_layers: int,
    num_pages: int,
    num_heads: int,
    page_size: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device=None,
    slots: int = 0,
) -> PagedKV:
    """Zeroed K/V pool [L, P, Hh, page, D]: f32 or bf16, or "int8" (also
    torch.int8) with f32 scale planes [L, P, Hh, page], or "int8tail", which
    adds the bf16 open pages [L, slots, Hh, page, D] and needs `slots`, the
    decode batch width."""
    shape = (num_layers, num_pages, num_heads, page_size, head_dim)
    tail = dtype == "int8tail"
    if tail or dtype in ("int8", torch.int8):
        sshape = (num_layers, num_pages, num_heads, page_size)
        cache = {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32, device=device),
        }
        if tail:
            if slots <= 0:
                raise ValueError("int8tail pool needs slots= (decode batch width)")
            oshape = (num_layers, slots, num_heads, page_size, head_dim)
            cache["open_k"] = torch.zeros(oshape, dtype=torch.bfloat16, device=device)
            cache["open_v"] = torch.zeros(oshape, dtype=torch.bfloat16, device=device)
        return cache
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"paged KV pools are f32, bf16, int8 or int8tail, not {dtype}")
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 over the trailing (head_dim) axis, bit for
    bit the JAX package's: (codes int8 [..., D], scale f32 [...]), scale =
    max(absmax / 127, 1e-8), codes = clip(round(x / scale), -127, 127) with
    ties to even (torch.round, as jnp.round). The divisor 127 is a tensor:
    CUDA turns a division by a Python scalar into a multiply by its
    reciprocal, one ulp off."""
    x = x.float()
    absmax = x.abs().amax(dim=-1)
    c127 = torch.full((), 127.0, dtype=torch.float32, device=x.device)  # a fill kernel: no host copy
    scale = torch.maximum(absmax / c127, torch.full((), 1e-8, dtype=torch.float32, device=x.device))
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


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


def write_prompt_scales_batched(
    spool: torch.Tensor,  # [L, P, Hh, page] f32, written in place
    s_prompt: torch.Tensor,  # [L, G, Hh, cap] per-token scales
    page_ids: torch.Tensor,  # [G, n_pages] int
    seq_len: int,
) -> torch.Tensor:
    """Scatter an admission group's per-token scales into a quantized
    pool's scale plane (the page walk of `write_prompt_pages_batched`)."""
    return write_prompt_pages_batched(spool[..., None], s_prompt[..., None], page_ids, seq_len)[..., 0]


def write_prompt_pool_batched(
    cache: PagedKV,
    k_new: torch.Tensor,  # [L, G, Hh, cap, D] contiguous prefill K
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # [G, n_pages] int
    seq_len: int,
    slot_ids: Optional[torch.Tensor] = None,  # [G] int: needed by int8tail pools
) -> PagedKV:
    """Scatter an admission group's prompt K/V into the pool, in place,
    quantizing on the way in when the pool is int8. An int8tail pool also
    stages each prompt's last page, exact in bf16, into its slot's open
    page."""
    if "k_scale" not in cache:
        write_prompt_pages_batched(cache["k"], k_new, page_ids, seq_len)
        write_prompt_pages_batched(cache["v"], v_new, page_ids, seq_len)
        return cache
    for name, new in (("k", k_new), ("v", v_new)):
        codes, scales = quantize_kv(new)
        write_prompt_pages_batched(cache[name], codes, page_ids, seq_len)
        write_prompt_scales_batched(cache[name + "_scale"], scales, page_ids, seq_len)
        if "open_" + name in cache:
            if slot_ids is None:
                raise ValueError("int8tail prompt write needs slot_ids")
            page = cache[name].shape[3]
            sl = (seq_len - 1) // page * page  # the group's last page
            cache["open_" + name][:, slot_ids.long()] = new[:, :, :, sl : sl + page].to(torch.bfloat16)
    return cache


def _paged_attention_step(
    xn: torch.Tensor,  # [B, S, H] normed input
    layer,
    cfg: DeepseekV2Config,
    cache: PagedKV,  # updated in place
    li: int,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    pos: torch.Tensor,  # [B] position of xn[:, 0]
    cos_b: torch.Tensor,  # [B, 1, S, D]
    sin_b: torch.Tensor,
    mesh=None,
) -> torch.Tensor:
    """QKV + per-row RoPE + paged KV write + attention + out projection
    (the rank's heads under a `mesh`).
    Token j of row r sits at posq = pos + j, lands in page
    block_tables[r, posq // page] at offset posq % page, and attends over
    its posq + 1 tokens: kernel G (Q for S > 1) on an f32 / bf16 pool, P (R)
    on a quantized one (codes and scales written after RoPE; an int8tail
    pool also keeps the exact K/V at open_k[li, r, :, posq % page] for every
    row and token, finished rows included, as the JAX package does: a chunk
    that crosses a page boundary writes its later tokens at the open page's
    low offsets, and its earlier ones land past the row's largest budget).
    Tokens past a row's allocation land on the scratch page 0, whose
    block-table entries fill the rest of the row."""
    b, s, h = xn.shape
    nh, d = n_heads(cfg, mesh), cfg.head_dim
    q, k, v = (t.reshape(b, s, nh, d).transpose(1, 2) for t in qkv_proj(xn.reshape(b * s, h), layer, True, cfg, mesh))
    q32, k32 = apply_rope_rows(q, k, cos_b, sin_b)
    k_new, v_new = k32.transpose(1, 2), v.float().transpose(1, 2)  # [B, S, Hh, D]

    k_pool, v_pool = cache["k"], cache["v"]
    page = k_pool.shape[3]
    rows = torch.arange(b, device=xn.device)[:, None]
    posq = pos.long()[:, None] + torch.arange(s, device=xn.device)  # [B, S]
    # The JAX gather clamps a column past the table to its last one.
    page_ids = block_tables.long()[rows, (posq // page).clamp(max=block_tables.shape[1] - 1)]
    off = posq % page
    seq_lens = (posq + 1).to(torch.int32)  # per-query budgets
    scale = 1.0 / math.sqrt(d)
    if s == 1:
        q_in, seq_lens = q32[:, :, 0, :].contiguous(), seq_lens[:, 0]
    else:
        q_in = q32.transpose(1, 2).contiguous()  # [B, S, Hh, D]
    if "k_scale" in cache:
        for name, new in (("k", k_new), ("v", v_new)):
            codes, scales = quantize_kv(new.reshape(b * s, nh, d))  # [B * S, Hh, D] / [B * S, Hh]
            cache[name][li][page_ids, :, off] = codes.reshape(b, s, nh, d)  # one index_put_ a plane
            cache[name + "_scale"][li][page_ids, :, off] = scales.reshape(b, s, nh)
            if "open_" + name in cache:
                cache["open_" + name][li][rows.expand(b, s), :, off] = new.to(torch.bfloat16)
        attend = paged_decode_attention_pool_q8 if s == 1 else paged_decode_attention_pool_chunk_q8
        ctx = attend(q_in, k_pool, v_pool, cache["k_scale"], cache["v_scale"], block_tables, seq_lens, li,
                     scale=scale, open_k=cache.get("open_k"), open_v=cache.get("open_v"))
    else:
        k_pool[li][page_ids, :, off] = k_new.to(k_pool.dtype)
        v_pool[li][page_ids, :, off] = v_new.to(v_pool.dtype)
        attend = paged_decode_attention_pool if s == 1 else paged_decode_attention_pool_chunk
        ctx = attend(q_in, k_pool, v_pool, block_tables, seq_lens, li, scale=scale)
    return out_proj(ctx.reshape(b * s, nh * d).to(xn.dtype), layer["wo"], mesh, True).reshape(b, s, h)


@torch.no_grad()
def lm_decode_step_paged(
    params,
    cfg: DeepseekV2Config,
    embeds: torch.Tensor,  # [B, S, H]: S == 1 plain decode, S > 1 a lookup chunk
    cache: PagedKV,  # updated in place
    block_tables: torch.Tensor,  # [B, max_pages] int32
    pos: torch.Tensor,  # [B] per-row position of embeds[:, 0]
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """One decode step over the paged pool; returns the final-normed hidden
    [B, S, H]. The routed MoE of a layer is kernel F (J with int8 experts,
    N with int4) when B * S * k > E (every slot counts, active or not), the
    per-selection path (I with int8 experts, M with int4) otherwise; int8
    linears run kernel H, int4 ones L, and the attention kernel G (Q for a
    chunk) on an f32 or bf16 pool and P (R) on a quantized one, whatever
    the weights (the JAX package's `_lm_decode_step_paged_q8` is this
    loop). Sharded params: see the module docstring."""
    b, s, h = embeds.shape
    cos, sin = rope if rope is not None else rope_consts(cfg, embeds.device)
    cos_b, sin_b = rope_rows(cos, sin, pos, s)  # once a step, for every layer
    mesh = params.get("mesh")
    x = embeds
    for li, layer in enumerate(params["layers"]):
        res = x
        xn = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        x = res + _paged_attention_step(xn, layer, cfg, cache, li, block_tables, pos, cos_b, sin_b, mesh)
        res = x
        xn = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
        x = res + ffn(xn.reshape(b * s, h), layer, cfg, decode=True, mesh=mesh).reshape(b, s, h)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)
