"""Exact attention kernels A, B and V: CUDA wrappers and their plain twins.

Port of the Pallas kernels in deepseek_ocr2_tpu/ops/flash_attention.py:
- A, `mha` (replaces `_attn_kernel` via `mha_pallas`): modes none / causal /
  prefix. LM prefill runs it in causal mode on f32 q/k/v after RoPE. In f32
  it runs on the tensor cores in 3xTF32 (each operand split into TF32 high
  and low parts, three products with f32 sums: f32-accurate), skipping the
  key tiles whose keys are all masked for a row group (`tc_key_tiles` is
  the plain form of that walk); bf16 runs the CUDA-core template below.
- B, `mha_relpos` (replaces `_attn_kernel_relpos` via
  `mha_pallas(rel_h=, rel_w=)`): SAM attention with the decomposed relative
  position bias bias[q, kh*Kw + kw] = rel_h[q, kh] + rel_w[q, kw], folded in
  per score; the [L, L] bias is never built. In f32 (D 64, SAM's) it runs
  A's tensor-core kernel with the block's rows of rel_h / rel_w staged in
  shared memory; bf16 runs the CUDA-core template.
- V, `mha_win` (replaces `_attn_kernel_relwin` via `mha_win_pallas`): SAM's
  windowed attention with the decomposed bias built inside the kernel from
  the flattened rel-pos tables rhf, rwf [D, T2] (each query's win rel-h and
  win rel-w dot products), keys of a padded window (`valid < win`) at
  -1e30. `models.sam` runs it in the windowed blocks under
  `DEEPSEEK_SAM_WIN_KERNEL=1`. The TPU's `t2 % 128 == 0` assertion was a
  lane rule: V takes any win.

The CUDA source is `csrc/flash_attention.cu` (see its header for the
designs: A and B in f32 a 3xTF32 tensor-core kernel, everything else one
CUDA-core template of 64-query blocks streaming 64-key tiles, both with an
online f32 softmax).
The TPU gates on these kernels (L % 128, L >= 256, S >= 256) were Mosaic
tiling choices; the CUDA kernel takes every shape and masks the ragged edge.

A wrapper runs its plain twin only for CPU tensors. For CUDA tensors it
launches the kernel or raises; there is no fallback. `launches` counts
kernel launches (the twin does not count).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .attention import MASK_VALUE

_MODES = {"none": 0, "causal": 1, "prefix": 2}
_RELPOS, _RELWIN = 3, 4
_HEAD_DIMS = (64, 128)  # SAM, LM


# Kernels A and B in f32 (csrc/flash_attention.cu `attn_tc_kernel`): blocks of
# TC_BQ query rows in row groups of 16; each step stages 2 * TC_KW keys,
# and the two warps of a row group take TC_KW keys each (key tile t, of
# TC_KW keys, goes to the warp of half t % 2), each with its own online
# softmax, merged at the end.
TC_BQ, TC_KW = 64, 32


def tc_key_tiles(lq: int, lk: int, mode: str = "none", n_prefix: int = 0) -> torch.Tensor:
    """The plain form of A's tile walk in f32: [ceil(Lq / TC_BQ), TC_BQ // 16]
    int64, the TC_KW-key tiles that row group r of query block b needs (0
    for a group past Lq): its half-0 warp multiplies the even ones, its
    half-1 warp the odd ones, and the block stages ceil(max / 2) tiles of
    2 TC_KW keys. The tiles past a group's count hold only keys masked for
    all its rows (causal: key > row; prefix: key >= P and (row < P or key >
    row)), which add exactly 0 to its softmax: skipped (see the kernel's
    header)."""
    r0 = torch.arange(0, -(-lq // TC_BQ) * TC_BQ, 16).reshape(-1, TC_BQ // 16)
    q_max = (r0 + 16).clamp(max=lq) - 1
    if mode == "causal":
        keys = q_max + 1
    elif mode == "prefix":
        keys = torch.where(q_max < n_prefix, n_prefix, q_max + 1)
    else:
        keys = torch.full_like(q_max, lk)
    return torch.where(r0 < lq, (keys.clamp(max=lk) + TC_KW - 1) // TC_KW, 0)


def mha_reference(
    q: torch.Tensor,  # [B, H, Lq, D]
    k: torch.Tensor,  # [B, H, Lk, D]
    v: torch.Tensor,
    *,
    scale: float,
    mode: str = "none",
    n_prefix: int = 0,
    rel_h: Optional[torch.Tensor] = None,  # [B, H, Lq, Kh] f32
    rel_w: Optional[torch.Tensor] = None,  # [B, H, Lq, Kw] f32
) -> torch.Tensor:
    """Plain twin of A and B: full f32 score rows and an exact softmax,
    written in q's dtype."""
    lq, lk = q.shape[2], k.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if rel_h is not None:
        kh, kw = rel_h.shape[-1], rel_w.shape[-1]
        bias = rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
        scores = scores + bias.reshape(*rel_h.shape[:-1], kh * kw)
    q_pos = torch.arange(lq, device=q.device)[:, None]
    k_pos = torch.arange(lk, device=q.device)[None, :]
    if mode == "causal":
        scores = scores.masked_fill(k_pos > q_pos, MASK_VALUE)
    elif mode == "prefix":
        query_col = k_pos >= n_prefix
        disallow = ((q_pos < n_prefix) & query_col) | (
            (q_pos >= n_prefix) & query_col & (k_pos > q_pos)
        )
        scores = scores.masked_fill(disallow, MASK_VALUE)
    return torch.matmul(torch.softmax(scores, dim=-1), v.float()).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with a 16-byte aligned start (A's f32 kernel loads
    16-byte chunks; `_launch` holds every kernel of the file to it): a copy
    where a view starts off that boundary."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]


def _launch(q, k, v, out, rel_h, rel_w, mode_id, n_prefix, kh, kw, scale) -> None:
    b, h, lq, d = q.shape
    lk = k.shape[2]
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share one dtype, f32 or bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, h, lk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if mode_id == _RELPOS and q.dtype == torch.float32 and d != 64:
        raise ValueError(f"kernel B in f32 takes head dim 64 (SAM's), not {d}")
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("kernels A, B and V read 16-byte aligned q, k, v and write a 16-byte aligned output")
    fn = cuda_build.entry("flash_attention", "attn_f32" if q.dtype == torch.float32 else "attn_bf16", _ARGTYPES)
    rh = cuda_build.ptr(rel_h) if rel_h is not None else None
    rw = cuda_build.ptr(rel_w) if rel_w is not None else None
    err = fn(
        cuda_build.ptr(q), cuda_build.ptr(k), cuda_build.ptr(v), cuda_build.ptr(out), rh, rw,
        b * h, lq, lk, d, mode_id, n_prefix, kh, kw, scale, cuda_build.stream_of(q),
    )
    cuda_build.check(err, "flash_attention")


def mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    mode: str = "none",
    n_prefix: int = 0,
) -> torch.Tensor:
    """Kernel A. Returns [B, H, Lq, D] in q's dtype."""
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r} not in {tuple(_MODES)}")
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale=scale, mode=mode, n_prefix=n_prefix)
    q, k, v = (_aligned(t) for t in (q, k, v))
    cuda_build.require_cuda(q, k, v)
    out = torch.empty_like(q)
    _launch(q, k, v, out, None, None, _MODES[mode], n_prefix, 0, 0, scale)
    mha.launches += 1
    return out


mha.launches = 0


def mha_relpos(
    q: torch.Tensor,  # [B, H, L, D], L = Kh * Kw
    k: torch.Tensor,
    v: torch.Tensor,
    rel_h: torch.Tensor,  # [B, H, L, Kh] f32
    rel_w: torch.Tensor,  # [B, H, L, Kw] f32
    *,
    scale: float,
) -> torch.Tensor:
    """Kernel B. Returns [B, H, L, D] in q's dtype."""
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    if kh * kw != k.shape[2]:
        raise ValueError(f"rel-pos grid {kh}x{kw} does not cover {k.shape[2]} keys")
    if q.device.type == "cpu":
        return mha_reference(q, k, v, scale=scale, rel_h=rel_h, rel_w=rel_w)
    q, k, v = (_aligned(t) for t in (q, k, v))
    rel_h = rel_h.float().contiguous()
    rel_w = rel_w.float().contiguous()
    cuda_build.require_cuda(q, k, v, rel_h, rel_w)
    if rel_h.shape[:3] != q.shape[:3] or rel_w.shape[:3] != q.shape[:3]:
        raise ValueError("rel_h / rel_w must be [B, H, Lq, K*]")
    out = torch.empty_like(q)
    _launch(q, k, v, out, rel_h, rel_w, _RELPOS, 0, kh, kw, scale)
    mha_relpos.launches += 1
    return out


mha_relpos.launches = 0


def window_bias(q: torch.Tensor, rhf: torch.Tensor, rwf: torch.Tensor, win: int, valid: int) -> torch.Tensor:
    """The explicit [B, H, T2, T2] f32 bias V builds inside the kernel (the
    JAX package's test oracle): bias[q, kk] = q . rhf[:, (q // win) win +
    kk // win] + q . rwf[:, (q % win) win + kk % win], and -1e30 on keys
    whose row or column is >= valid."""
    b, h, t2, _ = q.shape
    q32 = q.float()
    pos = torch.arange(t2, device=q.device)
    col_h = ((pos // win)[:, None] * win + (pos // win)[None, :]).expand(b, h, t2, t2)
    col_w = ((pos % win)[:, None] * win + (pos % win)[None, :]).expand(b, h, t2, t2)
    bias = torch.gather(torch.matmul(q32, rhf.float()), -1, col_h) + \
        torch.gather(torch.matmul(q32, rwf.float()), -1, col_w)
    pad = (pos // win >= valid) | (pos % win >= valid)
    return bias + torch.where(pad, -1.0e30, 0.0)


def mha_win_reference(
    q: torch.Tensor,  # [B, H, T2, D], T2 = win * win
    k: torch.Tensor,
    v: torch.Tensor,
    rhf: torch.Tensor,  # [D, T2] f32: rhf[c, h * win + kh] = rel_h_table[h, kh, c]
    rwf: torch.Tensor,  # [D, T2] f32: rwf[c, w * win + kw] = rel_w_table[w, kw, c]
    *,
    scale: float,
    win: int,
    valid: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain twin of V: `window_bias` added to full f32 score rows, exact
    softmax."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + window_bias(q, rhf, rwf, win, valid)
    return torch.matmul(torch.softmax(scores, dim=-1), v.float()).to(out_dtype or q.dtype)


def mha_win(
    q: torch.Tensor,  # [B, H, T2, D], T2 = win * win
    k: torch.Tensor,
    v: torch.Tensor,
    rhf: torch.Tensor,  # [D, T2] f32
    rwf: torch.Tensor,  # [D, T2] f32
    *,
    scale: float,
    win: int,
    valid: int,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Kernel V. Returns [B, H, T2, D] in out_dtype (q's dtype by default;
    the kernel writes q's dtype, so on CUDA another one is refused). Rows
    of padded queries are garbage, as in the JAX package: the caller slices
    them off."""
    b, h, t2, d = q.shape
    if t2 != win * win or not 1 <= valid <= win:
        raise ValueError(f"T2 = {t2} must be win * win = {win * win}, and 1 <= valid = {valid} <= win")
    if q.device.type == "cpu":
        return mha_win_reference(q, k, v, rhf, rwf, scale=scale, win=win, valid=valid, out_dtype=out_dtype)
    if out_dtype not in (None, q.dtype):
        raise ValueError(f"kernel V writes q's dtype {q.dtype}, not {out_dtype}")
    if rhf.shape != (d, t2) or rwf.shape != (d, t2):
        raise ValueError(f"rhf {tuple(rhf.shape)} / rwf {tuple(rwf.shape)} must be [{d}, {t2}]")
    q, k, v = (_aligned(t) for t in (q, k, v))
    rhf, rwf = rhf.float().contiguous(), rwf.float().contiguous()
    cuda_build.require_cuda(q, k, v, rhf, rwf)
    out = torch.empty_like(q)
    _launch(q, k, v, out, rhf, rwf, _RELWIN, valid, win, win, scale)
    mha_win.launches += 1
    return out


mha_win.launches = 0
