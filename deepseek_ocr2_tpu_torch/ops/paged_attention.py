"""Paged decode attention, kernel G: the CUDA wrapper and its plain twin.

Port of `paged_decode_attention_pool` in deepseek_ocr2_tpu/ops/paged_attention.py
(the Pallas kernel `_paged_kernel_pool`): one query per row against the
row's pages of the layer-stacked pool [L, P, Hh, page, D], listed by its
block-table row, keys at or beyond `seq_lens[row]` masked to -inf, f32 online
softmax. The CUDA source is `csrc/paged_attention.cu` (its header gives the
design and what bounds it).

The JAX kernel reads the layer index through scalar prefetch only because
XLA copies a scan-sliced operand; here `k_pool[layer]` is a view of the pool
and the kernel takes its pointer, so no layer is ever copied.

A wrapper runs its plain twin only for CPU tensors. For CUDA tensors it
launches the kernel or raises; there is no fallback. `launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_HEAD_DIM = 128  # the LM's
_MAX_PAGE = 128


def paged_decode_attention_reference(
    q: torch.Tensor,  # [B, Hh, D]
    k_pages: torch.Tensor,  # [P, Hh, page, D]: one layer of the pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int
    seq_lens: torch.Tensor,  # [B] int
    *,
    scale: float,
) -> torch.Tensor:
    """Plain twin of G, the gather form of `paged_decode_attention_xla`:
    gather every block-table page, full f32 score rows, -inf past each
    row's length, exact softmax. Returns [B, Hh, D] f32."""
    b, hh, d = q.shape
    max_pages = block_tables.shape[1]
    page = k_pages.shape[2]
    bt = block_tables.long()

    def gather(pages):  # [B, max_pages, Hh, page, D] -> [B, Hh, max_pages * page, D]
        return pages[bt].permute(0, 2, 1, 3, 4).reshape(b, hh, max_pages * page, d).float()

    k, v = gather(k_pages), gather(v_pages)
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k) * scale
    k_pos = torch.arange(max_pages * page, device=q.device)
    s = s.masked_fill(k_pos[None, None, :] >= seq_lens.long()[:, None, None], float("-inf"))
    return torch.einsum("bhk,bhkd->bhd", torch.softmax(s, dim=-1), v)


def paged_decode_attention_pool(
    q: torch.Tensor,  # [B, Hh, D] f32
    k_pool: torch.Tensor,  # [L, P, Hh, page, D] f32 or bf16
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    seq_lens: torch.Tensor,  # [B] int32
    layer: int,
    *,
    scale: float,
) -> torch.Tensor:
    """Kernel G on layer `layer` of the pool. Returns [B, Hh, D] f32."""
    k_pages, v_pages = k_pool[layer], v_pool[layer]  # views
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages, block_tables, seq_lens, scale=scale)
    b, hh, d = q.shape
    n_pages, _, page, _ = k_pages.shape
    if q.dtype != torch.float32 or d != _HEAD_DIM:
        raise ValueError(f"kernel G takes f32 q with head dim {_HEAD_DIM}, got {q.dtype} {tuple(q.shape)}")
    if k_pool.dtype not in (torch.float32, torch.bfloat16) or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"the pool must be f32 or bf16, got {k_pool.dtype} / {v_pool.dtype}")
    if k_pages.shape != (n_pages, hh, page, d) or v_pages.shape != k_pages.shape or page > _MAX_PAGE:
        raise ValueError(f"pool layer {tuple(k_pages.shape)} does not fit q {tuple(q.shape)} (page <= {_MAX_PAGE})")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_tables and seq_lens must be int32")
    if block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / seq_lens {tuple(seq_lens.shape)} vs {b} rows")
    cuda_build.require_cuda(q, k_pages, v_pages, block_tables, seq_lens)
    lib = cuda_build.load("paged_attention")
    fn = lib.paged_decode_f32 if k_pool.dtype == torch.float32 else lib.paged_decode_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    p = cuda_build.ptr
    err = fn(p(q), p(k_pages), p(v_pages), p(block_tables), p(seq_lens), p(out),
             b, hh, d, page, block_tables.shape[1], scale, cuda_build.stream_of(q))
    cuda_build.check(err, "paged_attention")
    paged_decode_attention_pool.launches += 1
    return out


paged_decode_attention_pool.launches = 0
