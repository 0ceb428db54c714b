"""Fused decode attention with int8 or int4 weights, kernels K and O: the
CUDA wrappers and their plain twin (port of deepseek_ocr2_tpu/ops/
attn_fused.py, the Pallas kernel `_fused_kernel` at bits = 8 and 4).

One decode step of one layer's attention block on the contiguous cache
[L, B, Hh, cap, D]: the fused qkv projection (int8, or int4 with group-128
scales as `linear_q4`; rounded to the activation dtype, as the unfused
projection's output is), per-row RoPE in f32 at each row's position, an f32
online softmax over the row's cached keys seeded with the current token
from registers (the current token is attended in f32, before it is rounded
into the cache), the context rounded to the activation dtype, and the wo
projection. The functions return (out [B, 1, H], k_new, v_new), the new
token's K/V in the cache dtype; the caller writes them into
cache[li, rows, :, pos]. `csrc/attn_fused.cu`'s header gives the design and
what bounds it: the projections are kernel H's (int8) or L's (int4) device
code, and the attention one launch of the split-key walk of kernels G and U
(`csrc/split_walk.cuh`): blocks of 64 cached keys of a (row, head), each
with its own online softmax, and the last block of the (row, head) to
arrive merging the current token's seed and the chunks' partials in
ascending order. It shares G's arrival counters (`paged_attention.
_arrival_counters`) and writes its partials to a workspace made with
torch.empty, so a CUDA graph captures the call; a row's bits depend on its
own pos alone.

The JAX package takes the fused kernel only when head_dim % 128 == 0 and
cap <= 512 or cap % 512 == 0 (its lane and chunk layout); the port's K takes
any capacity. `DEEPSEEK_FUSED_ATTN=0` turns it off, as in the JAX package;
decode then runs the two projections through kernel H (L) and the attention
in plain torch.

`attn_decode_fused` takes int8 weights to K and int4 weights ("q4" dicts) to
O (`attn_decode_fused_q4`). A wrapper runs its plain twin only for CPU
tensors; for CUDA tensors it launches the kernel or raises. `launches`
counts calls that launch K, or O (three CUDA launches each). Nothing here
reads a value back to the host.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Dict, Tuple

import torch

from . import cuda_build
from .linear_q4 import GROUP, linear_q4_reference, padded
from .linear_q8 import linear_q8_reference
from .paged_attention import U_CHUNK, U_PART, _arrival_counters

_HEAD_DIM = 128  # the LM's


def fused_attn_enabled() -> bool:
    return os.environ.get("DEEPSEEK_FUSED_ATTN", "1") != "0"


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _pos_rows(pos, b: int, device) -> torch.Tensor:
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int32).reshape(-1).expand(b).contiguous()
    return torch.full((b,), int(pos), dtype=torch.int32, device=device)


def attn_decode_fused_reference(
    xn: torch.Tensor,  # [B, 1, H]
    attn: Dict,  # {"wqkv": int8 or int4 linear [3H, H], "wo": the same [H, H]}
    cfg,
    cos: torch.Tensor,  # [max_pos, D] f32
    sin: torch.Tensor,
    k_all: torch.Tensor,  # [L, B, Hh, cap, D]
    v_all: torch.Tensor,
    li: int,
    pos,  # int or [B]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of K and O, at their rounding points: the full score row
    of the cached keys (masked at and past pos) and the current token's
    score in one exact softmax."""
    b, _, h = xn.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    pos_l = _pos_rows(pos, b, xn.device).long()
    proj = linear_q4_reference if "q4" in attn["wqkv"] else linear_q8_reference
    qkv = proj(xn.reshape(b, h), attn["wqkv"]).float()
    q, k, v = (t.reshape(b, nh, d) for t in qkv.split(h, dim=-1))
    c, s = cos[pos_l][:, None, :], sin[pos_l][:, None, :]
    q = q * c + _rotate_half(q) * s
    k = k * c + _rotate_half(k) * s
    scale = 1.0 / math.sqrt(d)
    keys, vals = k_all[li].float(), v_all[li].float()  # [B, Hh, cap, D]
    s_hist = torch.einsum("bhd,bhkd->bhk", q, keys) * scale
    k_pos = torch.arange(keys.shape[2], device=xn.device)
    s_hist = s_hist.masked_fill(k_pos[None, None, :] >= pos_l[:, None, None], float("-inf"))
    s_cur = (q * k).sum(-1, keepdim=True) * scale
    p = torch.softmax(torch.cat([s_hist, s_cur], dim=-1), dim=-1)
    ctx = torch.einsum("bhk,bhkd->bhd", p[..., :-1], vals) + p[..., -1:] * v
    out = proj(ctx.reshape(b, h).to(xn.dtype), attn["wo"])
    return out.reshape(b, 1, h), k.to(k_all.dtype), v.to(v_all.dtype)


def _launch(bits: int, name: str, xn, attn, cfg, cos, sin, k_all, v_all, li: int, pos):
    """Check the inputs of K (bits 8) or O (bits 4) and launch it."""
    b, s, h = xn.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    wq, wo = attn["wqkv"], attn["wo"]
    if s != 1 or d != _HEAD_DIM or nh * d != h or h % (32 if bits == 4 else 16):
        raise ValueError(f"kernel {name} takes one query a row, head dim {_HEAD_DIM} and H = heads x D "
                         f"(a multiple of {32 if bits == 4 else 16}), got xn {tuple(xn.shape)}, {nh} heads of {d}")
    dt, kv_dt = xn.dtype, k_all.dtype
    if dt not in (torch.float32, torch.bfloat16) or kv_dt not in (torch.float32, torch.bfloat16) \
            or v_all.dtype != kv_dt:
        raise ValueError(f"kernel {name} takes f32 or bf16 activations and caches, got {dt} / {kv_dt} / {v_all.dtype}")
    cap = k_all.shape[3]
    if k_all.shape[1:] != (b, nh, cap, d) or v_all.shape != k_all.shape:
        raise ValueError(f"cache {tuple(k_all.shape)} does not fit {b} rows of {nh} heads x {d}")
    if cos.shape != sin.shape or cos.shape[1] != d or cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise ValueError(f"RoPE tables {tuple(cos.shape)} / {tuple(sin.shape)} must be f32 [max_pos, {d}]")
    if bits == 8:
        codes = (wq["q8"], wo["q8"])
        fits = (codes[0].shape == (3 * h, h) and codes[1].shape == (h, h) and codes[0].dtype == torch.int8
                and codes[1].dtype == torch.int8 and wq["scale"].shape == (3 * h,) and wo["scale"].shape == (h,))
    else:
        codes, ng = (wq["q4"], wo["q4"]), padded(h) // GROUP
        fits = (codes[0].shape == (3 * h, padded(h) // 2) and codes[1].shape == (h, padded(h) // 2)
                and codes[0].dtype == torch.uint8 and codes[1].dtype == torch.uint8
                and wq["scale"].shape == (3 * h, ng) and wo["scale"].shape == (h, ng))
    if not fits or wq["scale"].dtype != torch.float32 or wo["scale"].dtype != torch.float32:
        raise ValueError(f"int{bits} wqkv {tuple(codes[0].shape)} / wo {tuple(codes[1].shape)} do not fit H = {h}")
    x2 = xn.reshape(b, h).contiguous()
    kl, vl = k_all[li], v_all[li]  # views
    pos_b = _pos_rows(pos, b, xn.device)
    cuda_build.require_cuda(x2, codes[0], wq["scale"], codes[1], wo["scale"], kl, vl, pos_b, cos, sin)
    if any(t.data_ptr() % 16 for t in (x2, *codes, kl, vl)):
        raise ValueError(f"kernel {name} reads 16-byte aligned rows")
    qkv = torch.empty(b, 3 * h, dtype=dt, device=xn.device)
    ctx = torch.empty(b, h, dtype=dt, device=xn.device)
    part = torch.empty(b, nh, -(-cap // U_CHUNK), U_PART, dtype=torch.float32, device=xn.device)
    counters = _arrival_counters(x2, b * nh)
    out = torch.empty(b, 1, h, dtype=dt, device=xn.device)
    k_new = torch.empty(b, nh, d, dtype=kv_dt, device=xn.device)
    v_new = torch.empty_like(k_new)
    fn = cuda_build.entry("attn_fused", "attn_fused", _ARGTYPES)
    p = cuda_build.ptr
    err = fn(bits, p(x2), p(codes[0]), p(wq["scale"]), p(codes[1]), p(wo["scale"]), p(kl), p(vl), p(pos_b), p(cos),
             p(sin), p(qkv), p(ctx), p(part), p(counters), p(out), p(k_new), p(v_new), b, nh, d, cap, cos.shape[0],
             1.0 / math.sqrt(d), int(dt == torch.bfloat16), int(kv_dt == torch.bfloat16), cuda_build.stream_of(x2))
    cuda_build.check(err, "attn_fused")
    return out, k_new, v_new


_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p]


def attn_decode_fused(
    xn: torch.Tensor,  # [B, 1, H] post-ln1
    attn: Dict,
    cfg,
    cos: torch.Tensor,
    sin: torch.Tensor,
    k_all: torch.Tensor,
    v_all: torch.Tensor,
    li: int,
    pos,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K on layer `li` (kernel O for int4 weights). Returns (out
    [B, 1, H] in xn's dtype, k_new, v_new [B, Hh, D] in the cache dtype)."""
    if "q4" in attn["wqkv"]:
        return attn_decode_fused_q4(xn, attn, cfg, cos, sin, k_all, v_all, li, pos)
    if xn.device.type == "cpu":
        return attn_decode_fused_reference(xn, attn, cfg, cos, sin, k_all, v_all, li, pos)
    out = _launch(8, "K", xn, attn, cfg, cos, sin, k_all, v_all, li, pos)
    attn_decode_fused.launches += 1
    return out


attn_decode_fused.launches = 0


def attn_decode_fused_q4(xn, attn: Dict, cfg, cos, sin, k_all, v_all, li: int, pos):
    """Kernel O: `attn_decode_fused` with int4 weights."""
    if xn.device.type == "cpu":
        return attn_decode_fused_reference(xn, attn, cfg, cos, sin, k_all, v_all, li, pos)
    out = _launch(4, "O", xn, attn, cfg, cos, sin, k_all, v_all, li, pos)
    attn_decode_fused_q4.launches += 1
    return out


attn_decode_fused_q4.launches = 0
