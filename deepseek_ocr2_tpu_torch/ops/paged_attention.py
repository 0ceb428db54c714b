"""Decode attention, kernels G, P, Q, R, U and X: the CUDA wrappers and
their plain twins.

Port of `paged_decode_attention_pool` in deepseek_ocr2_tpu/ops/paged_attention.py
(the Pallas kernel `_paged_kernel_pool`): one query per row against the
row's pages of the layer-stacked pool [L, P, Hh, page, D], listed by its
block-table row, keys at or beyond `seq_lens[row]` masked to -inf, f32 online
softmax. The CUDA source is `csrc/paged_attention.cu` (its header gives the
design and what bounds it). G is a split-key decode in one launch: a block
takes one chunk of min(U_CHUNK, page) keys of a (row, head), never across a
page end (`paged_chunks`), and writes its partial (acc, m, l) to a workspace
this wrapper allocates; the last block of the (row, head) to finish merges
the partials in ascending chunk order, counted on a per-device buffer of
arrival counters (`_arrival_counters`) that the merging block sets back to
zero. A row's output is bit-identical whatever the other rows hold.

Kernel P (`paged_decode_attention_pool_q8`) is the same attention over an
int8 pool on G's split-key walk, one launch: port of the Pallas kernel
`_paged_kernel_pool_q8`. A page arrives as int8 codes plus a per-(token,
head) f32 scale row; where the twin widens each key to f32 before the dot
product, the kernel folds the scales out of its loops (s_j = scale ks_j
(q . c_j), acc += p_j vs_j c_j), so its sums round differently, well within
the tolerance. With the open pages of an int8tail pool, the chunks of each
row's last page are read exact in bf16 from its slot's open page instead.

The JAX kernel reads the layer index through scalar prefetch only because
XLA copies a scan-sliced operand; here `k_pool[layer]` is a view of the pool
and the kernel takes its pointer, so no layer is ever copied.

Kernels Q and R (`paged_decode_attention_pool_chunk` and its `_q8` form)
are the chunk forms of G and P that lookup decoding's verification step
runs: ports of `_paged_kernel_pool_chunk` and `_paged_kernel_pool_chunk_q8`.
S queries a row (the last token and its drafts) share the row's pages, each
with its own causal budget `seq_lens[row, i]` (its position + 1); an
int8tail row's open page is its last one by the row's largest budget. Both
are G's split-key walk up to the row's largest budget (R over P's codes and
scales), each chunk's K and V read once for all S queries and S partials a
chunk in the workspace; a query with no live key in a chunk adds exact
zeros, so query i's output is G's (Q) or P's (R, no tail) at its budget,
bit for bit.

Kernel X (`paged_decode_attention`) ports `paged_decode_attention` (the
Pallas kernel `_paged_kernel`): the per-sequence form from before the
pool, one query per row over a pool [P, Hh, page, D] with no layer axis.
That is the view G walks, so X launches G's device code; it has its own
entry point and counter, and the twin is G's (the JAX package's
`paged_decode_attention_xla`). The JAX package calls it only from its tests.

Kernel U (`decode_attention_stacked`) ports `decode_attention_stacked` (the
Pallas kernel `_stacked_kernel`): decode attention read straight from the
layer-stacked contiguous cache [L, B, Hh, cap, D], the decode path of
`DEEPSEEK_DECODE_ATTN=stacked` (`models.deepseek_v2.decode_attn_mode`).
Like G it takes the pointer of the `k_all[layer]` view. It is a split-key
decode: a block takes one chunk of U_CHUNK keys of a (row, head) (blocks
past the row's length exit at once), two warps of U_WARP_KEYS keys each
with its own softmax, and writes the chunk's partial (acc, m, l) to a
workspace the wrapper allocates; a second launch merges a row's partials
in ascending chunk order, so a row's output is bit-identical whatever the
other rows hold. It reads only each row's valid keys, so it needs neither
the TPU kernel's 512-key chunk nor its `cap % 512 == 0` assertion (Mosaic
tiling rules): any capacity works. `launches` counts one per call.

A wrapper runs its plain twin only for CPU tensors. For CUDA tensors it
launches the kernel or raises; there is no fallback. `launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

_HEAD_DIM = 128  # the LM's
_MAX_PAGE = 128
_MAX_CHUNK = 8  # the most queries a row kernels Q and R take
# Kernels G, X, P, Q, R and U (csrc/paged_attention.cu): a block takes one
# chunk of at most U_CHUNK keys of a (row, head), U_WARP_KEYS a warp, and
# writes its partial (acc[D], m, l, in rows of U_PART floats; Q and R one a
# query) to a workspace whose partials are merged in ascending chunk order
# (G, X, P, Q, R: by the last block of the row to finish; U: by a second
# launch).
U_CHUNK, U_WARP_KEYS = 64, 32
U_PART = _HEAD_DIM + 4


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


def paged_chunks(page: int, max_pages: int) -> int:
    """Chunks a row's keys take in G's split-key walk: min(U_CHUNK, page)
    keys a chunk, never across a page end, ceil(page / chunk) a page."""
    ck = min(U_CHUNK, page)
    return max_pages * -(-page // ck)


_COUNTERS: dict = {}  # device index -> int32 arrival counters of G, X, P, Q and R, zero between launches
_RETIRED: list = []  # counter buffers outgrown, kept alive for the CUDA graphs that captured them


def _arrival_counters(q: torch.Tensor, n: int) -> torch.Tensor:
    """The arrival counters of G, X, P, Q and R ([n] int32 on q's device, n
    = B * Hh, one a (row, head)), zero between launches: the merging block of
    each (row, head) sets its counter back to zero. One buffer a device, made
    at first use by a fill kernel, so a CUDA graph captured after a first
    call reuses it. A call with more (row, head) pairs than the buffer holds
    gets a larger one; the old buffer is never freed, since a graph captured
    earlier still launches on it. The five kernels share a buffer because
    launches on one stream run in order and each leaves every counter at
    zero: the launches that share it must run on one stream."""
    buf = _COUNTERS.get(q.get_device())
    if buf is None or buf.numel() < n:
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=q.device)
        _COUNTERS[q.get_device()] = buf
    return buf


def _split_workspace(q: torch.Tensor, page: int, max_pages: int, *per_chunk: int):
    """The workspace of G's walk (G, X, P, Q, R): the partials [B, Hh,
    n_chunks, *per_chunk, U_PART] f32 (Q, R: per_chunk = (S,), one a
    query), made with torch.empty so that a CUDA graph captures them, and
    the arrival counters."""
    b, hh = q.shape[0], q.shape[-2]
    part = torch.empty((b, hh, paged_chunks(page, max_pages), *per_chunk, U_PART), dtype=torch.float32,
                       device=q.device)
    return part, _arrival_counters(q, b * hh)


_PAGED_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
_Q8_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
_CHUNK_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
_CHUNK_Q8_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]


def _launch_paged(q, k_pages, v_pages, block_tables, seq_lens, scale: float, kernel: str) -> torch.Tensor:
    """G's device code (kernels G and X) on a [P, Hh, page, D] pool view."""
    b, hh, d = q.shape
    n_pages, _, page, _ = k_pages.shape
    if q.dtype != torch.float32 or d != _HEAD_DIM:
        raise ValueError(f"kernel {kernel} takes f32 q with head dim {_HEAD_DIM}, got {q.dtype} {tuple(q.shape)}")
    if k_pages.dtype not in (torch.float32, torch.bfloat16) or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"the pool must be f32 or bf16, got {k_pages.dtype} / {v_pages.dtype}")
    if k_pages.shape != (n_pages, hh, page, d) or v_pages.shape != k_pages.shape or page > _MAX_PAGE:
        raise ValueError(f"pool pages {tuple(k_pages.shape)} do not fit q {tuple(q.shape)} (page <= {_MAX_PAGE})")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_tables and seq_lens must be int32")
    if block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / seq_lens {tuple(seq_lens.shape)} vs {b} rows")
    cuda_build.require_cuda(q, k_pages, v_pages, block_tables, seq_lens)
    fn = cuda_build.entry("paged_attention", "paged_decode_f32" if k_pages.dtype == torch.float32 else
                          "paged_decode_bf16", _PAGED_ARGTYPES)
    max_pages = block_tables.shape[1]
    part, counters = _split_workspace(q, page, max_pages)
    out = torch.empty_like(q)
    p = cuda_build.ptr
    err = fn(p(q), p(k_pages), p(v_pages), p(block_tables), p(seq_lens), p(part), p(counters), p(out),
             b, hh, d, page, max_pages, scale, cuda_build.stream_of(q))
    cuda_build.check(err, f"paged_attention ({kernel})")
    return out


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
    out = _launch_paged(q, k_pages, v_pages, block_tables, seq_lens, scale, "G")
    paged_decode_attention_pool.launches += 1
    return out


paged_decode_attention_pool.launches = 0


def paged_decode_attention(
    q: torch.Tensor,  # [B, Hh, D] f32
    k_pages: torch.Tensor,  # [P, Hh, page, D] f32 or bf16: a per-sequence pool, no layer axis
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    seq_lens: torch.Tensor,  # [B] int32 (valid keys, the new token included)
    *,
    scale: float,
) -> torch.Tensor:
    """Kernel X (G's device code) on a per-sequence pool. Returns [B, Hh, D]
    f32."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(q, k_pages, v_pages, block_tables, seq_lens, scale=scale)
    out = _launch_paged(q, k_pages, v_pages, block_tables, seq_lens, scale, "X")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def decode_attention_stacked_reference(
    q: torch.Tensor,  # [B, Hh, D]
    k_all: torch.Tensor,  # [L, B, Hh, cap, D]
    v_all: torch.Tensor,
    layer: int,
    seq_lens: torch.Tensor,  # [B] int
    *,
    scale: float,
) -> torch.Tensor:
    """Plain twin of U, the masked-SDPA form of the JAX package's test
    oracle: layer `layer`'s full f32 score rows, -inf at key positions >=
    seq_lens[row], exact softmax. Returns [B, Hh, D] f32."""
    k, v = k_all[layer].float(), v_all[layer].float()
    s = torch.einsum("bhd,bhkd->bhk", q.float(), k) * scale
    k_pos = torch.arange(k.shape[2], device=q.device)
    s = s.masked_fill(k_pos[None, None, :] >= seq_lens.long()[:, None, None], float("-inf"))
    return torch.einsum("bhk,bhkd->bhd", torch.softmax(s, dim=-1), v)


_STACKED_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def decode_attention_stacked(
    q: torch.Tensor,  # [B, Hh, D] f32: the new token's query, after RoPE
    k_all: torch.Tensor,  # [L, B, Hh, cap, D] f32 or bf16: the contiguous layer-stacked cache
    v_all: torch.Tensor,
    layer: int,
    seq_lens: torch.Tensor,  # [B] int32: pos + 1 (the new token's K/V already written)
    *,
    scale: float,
) -> torch.Tensor:
    """Kernel U on layer `layer` of the contiguous cache. Returns [B, Hh, D]
    f32."""
    if q.device.type == "cpu":
        return decode_attention_stacked_reference(q, k_all, v_all, layer, seq_lens, scale=scale)
    q = q.contiguous()
    k_layer, v_layer = k_all[layer], v_all[layer]  # views, never copies
    b, hh, d = q.shape
    cap = k_all.shape[3]
    if q.dtype != torch.float32 or d != _HEAD_DIM:
        raise ValueError(f"kernel U takes f32 q with head dim {_HEAD_DIM}, got {q.dtype} {tuple(q.shape)}")
    if k_all.dtype not in (torch.float32, torch.bfloat16) or v_all.dtype != k_all.dtype:
        raise ValueError(f"the cache must be f32 or bf16, got {k_all.dtype} / {v_all.dtype}")
    if k_layer.shape != (b, hh, cap, d) or v_layer.shape != k_layer.shape:
        raise ValueError(f"cache layer {tuple(k_layer.shape)} does not fit q {tuple(q.shape)}")
    if seq_lens.dtype != torch.int32 or seq_lens.shape != (b,):
        raise ValueError(f"seq_lens must be int32 [{b}], got {seq_lens.dtype} {tuple(seq_lens.shape)}")
    cuda_build.require_cuda(q, k_layer, v_layer, seq_lens)
    fn = cuda_build.entry("paged_attention", "decode_stacked_f32" if k_all.dtype == torch.float32
                          else "decode_stacked_bf16", _STACKED_ARGTYPES)
    out = torch.empty_like(q)
    part = torch.empty(b * hh * -(-cap // U_CHUNK) * U_PART, dtype=torch.float32, device=q.device)
    p = cuda_build.ptr
    err = fn(p(q), p(k_layer), p(v_layer), p(seq_lens), p(part), p(out), b, hh, d, cap, scale,
             cuda_build.stream_of(q))
    cuda_build.check(err, "paged_attention (U)")
    decode_attention_stacked.launches += 1
    return out


decode_attention_stacked.launches = 0


def dequant_pages(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[..., page, D] int8 codes and [..., page] f32 scales -> f32 (the JAX
    package's `dequant_pages`)."""
    return codes.float() * scales[..., None]


def paged_decode_attention_q8_reference(
    q: torch.Tensor,  # [B, Hh, D]
    k_pool: torch.Tensor,  # [L, P, Hh, page, D] int8
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # [L, P, Hh, page] f32
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int
    seq_lens: torch.Tensor,  # [B] int
    layer: int,
    *,
    scale: float,
    open_k: Optional[torch.Tensor] = None,  # [L, B, Hh, page, D] bf16: int8tail
    open_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain twin of P, the JAX package's XLA oracle: dequantize layer
    `layer`, overwrite each row's last page with its open page (tail mode;
    a row's pages are its own, and finished rows all land on the scratch
    page, which no live row reads), then G's gather twin. [B, Hh, D] f32."""
    k_layer = dequant_pages(k_pool[layer], k_scale[layer])
    v_layer = dequant_pages(v_pool[layer], v_scale[layer])
    if open_k is not None:
        page = k_pool.shape[3]
        rows = torch.arange(q.shape[0], device=q.device)
        last_pg = block_tables.long()[rows, (seq_lens.long() - 1) // page]
        k_layer[last_pg] = open_k[layer].float()
        v_layer[last_pg] = open_v[layer].float()
    return paged_decode_attention_reference(q, k_layer, v_layer, block_tables, seq_lens, scale=scale)


def paged_decode_attention_pool_q8(
    q: torch.Tensor,  # [B, Hh, D] f32
    k_pool: torch.Tensor,  # [L, P, Hh, page, D] int8
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # [L, P, Hh, page] f32
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    seq_lens: torch.Tensor,  # [B] int32
    layer: int,
    *,
    scale: float,
    open_k: Optional[torch.Tensor] = None,  # [L, B, Hh, page, D] bf16: int8tail
    open_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel P on layer `layer` of an int8 pool; with open_k / open_v
    (int8tail), each row's last page is read from its open page, whose
    second axis is the row. Returns [B, Hh, D] f32."""
    if q.device.type == "cpu":
        return paged_decode_attention_q8_reference(q, k_pool, v_pool, k_scale, v_scale, block_tables, seq_lens,
                                                   layer, scale=scale, open_k=open_k, open_v=open_v)
    b, hh, d = q.shape
    n_layers, n_pages, _, page, _ = k_pool.shape
    tail = open_k is not None
    if q.dtype != torch.float32 or d != _HEAD_DIM:
        raise ValueError(f"kernel P takes f32 q with head dim {_HEAD_DIM}, got {q.dtype} {tuple(q.shape)}")
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8 or k_scale.dtype != torch.float32 \
            or v_scale.dtype != torch.float32:
        raise ValueError(f"kernel P takes int8 pools and f32 scales, got {k_pool.dtype} / {k_scale.dtype}")
    if k_pool.shape != (n_layers, n_pages, hh, page, d) or v_pool.shape != k_pool.shape or page > _MAX_PAGE \
            or k_scale.shape != k_pool.shape[:4] or v_scale.shape != k_scale.shape:
        raise ValueError(f"pool {tuple(k_pool.shape)} / scales {tuple(k_scale.shape)} do not fit q "
                         f"{tuple(q.shape)} (page <= {_MAX_PAGE})")
    if tail and (open_v is None or open_k.dtype != torch.bfloat16 or open_v.dtype != torch.bfloat16
                 or open_k.shape != (n_layers, b, hh, page, d) or open_v.shape != open_k.shape):
        raise ValueError(f"open pages must be bf16 [{n_layers}, {b}, {hh}, {page}, {d}] (one a row), got "
                         f"{None if open_k is None else tuple(open_k.shape)}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_tables and seq_lens must be int32")
    if block_tables.shape[0] != b or seq_lens.shape != (b,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / seq_lens {tuple(seq_lens.shape)} vs {b} rows")
    views = [k_pool[layer], v_pool[layer], k_scale[layer], v_scale[layer]]  # views, never copies
    opens = [open_k[layer], open_v[layer]] if tail else []
    cuda_build.require_cuda(q, *views, *opens, block_tables, seq_lens)
    fn = cuda_build.entry("paged_attention", "paged_decode_q8", _Q8_ARGTYPES)
    max_pages = block_tables.shape[1]
    part, counters = _split_workspace(q, page, max_pages)
    out = torch.empty_like(q)
    p = cuda_build.ptr
    open_ptrs = [p(t) for t in opens] if tail else [None, None]  # NULL pointers: no tail
    err = fn(p(q), *(p(t) for t in views), *open_ptrs, p(block_tables), p(seq_lens), p(part), p(counters), p(out),
             b, hh, d, page, max_pages, int(tail), scale, cuda_build.stream_of(q))
    cuda_build.check(err, "paged_attention (P)")
    paged_decode_attention_pool_q8.launches += 1
    return out


paged_decode_attention_pool_q8.launches = 0


def paged_decode_attention_chunk_reference(
    q: torch.Tensor,  # [B, S, Hh, D]
    k_pages: torch.Tensor,  # [P, Hh, page, D]: one layer of the pool
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int
    seq_lens: torch.Tensor,  # [B, S] int: per-query budgets
    *,
    scale: float,
) -> torch.Tensor:
    """Plain twin of Q, the JAX package's `paged_decode_attention_xla_chunk`:
    gather every block-table page, full f32 score rows, -inf at key
    positions >= the query's budget, exact softmax. Returns [B, S, Hh, D]
    f32."""
    b, _, hh, d = q.shape
    max_pages = block_tables.shape[1]
    page = k_pages.shape[2]
    bt = block_tables.long()

    def gather(pages):  # [B, max_pages, Hh, page, D] -> [B, Hh, max_pages * page, D]
        return pages[bt].permute(0, 2, 1, 3, 4).reshape(b, hh, max_pages * page, d).float()

    k, v = gather(k_pages), gather(v_pages)
    s = torch.einsum("bshd,bhkd->bhsk", q.float(), k) * scale
    k_pos = torch.arange(max_pages * page, device=q.device)
    s = s.masked_fill(k_pos >= seq_lens.long()[:, None, :, None], float("-inf"))
    return torch.einsum("bhsk,bhkd->bshd", torch.softmax(s, dim=-1), v)


def _check_chunk(kernel: str, q, k_pool, block_tables, seq_lens) -> None:
    b, s, _, d = q.shape
    page = k_pool.shape[3]
    if q.dtype != torch.float32 or d != _HEAD_DIM or q.dim() != 4:
        raise ValueError(f"kernel {kernel} takes f32 q [B, S, Hh, {_HEAD_DIM}], got {q.dtype} {tuple(q.shape)}")
    if not 2 <= s <= min(_MAX_CHUNK, page):
        raise ValueError(f"kernel {kernel} takes 2..{_MAX_CHUNK} queries a row, at most a page ({page}); got {s}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise ValueError("block_tables and seq_lens must be int32")
    if block_tables.shape[0] != b or seq_lens.shape != (b, s):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / seq_lens {tuple(seq_lens.shape)} vs "
                         f"q {tuple(q.shape)}")


def paged_decode_attention_pool_chunk(
    q: torch.Tensor,  # [B, S, Hh, D] f32: a row's last token and its drafts
    k_pool: torch.Tensor,  # [L, P, Hh, page, D] f32 or bf16
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    seq_lens: torch.Tensor,  # [B, S] int32: per-query budgets
    layer: int,
    *,
    scale: float,
) -> torch.Tensor:
    """Kernel Q on layer `layer` of the pool. Returns [B, S, Hh, D] f32."""
    k_pages, v_pages = k_pool[layer], v_pool[layer]  # views
    if q.device.type == "cpu":
        return paged_decode_attention_chunk_reference(q, k_pages, v_pages, block_tables, seq_lens, scale=scale)
    b, s, hh, d = q.shape
    n_pages, _, page, _ = k_pages.shape
    _check_chunk("Q", q, k_pool, block_tables, seq_lens)
    if k_pool.dtype not in (torch.float32, torch.bfloat16) or v_pool.dtype != k_pool.dtype:
        raise ValueError(f"the pool must be f32 or bf16, got {k_pool.dtype} / {v_pool.dtype}")
    if k_pages.shape != (n_pages, hh, page, d) or v_pages.shape != k_pages.shape or page > _MAX_PAGE:
        raise ValueError(f"pool layer {tuple(k_pages.shape)} does not fit q {tuple(q.shape)} (page <= {_MAX_PAGE})")
    cuda_build.require_cuda(q, k_pages, v_pages, block_tables, seq_lens)
    fn = cuda_build.entry("paged_attention", "paged_chunk_f32" if k_pool.dtype == torch.float32 else
                          "paged_chunk_bf16", _CHUNK_ARGTYPES)
    max_pages = block_tables.shape[1]
    part, counters = _split_workspace(q, page, max_pages, s)
    out = torch.empty_like(q)
    p = cuda_build.ptr
    err = fn(p(q), p(k_pages), p(v_pages), p(block_tables), p(seq_lens), p(part), p(counters), p(out),
             b, s, hh, d, page, max_pages, scale, cuda_build.stream_of(q))
    cuda_build.check(err, "paged_attention (Q)")
    paged_decode_attention_pool_chunk.launches += 1
    return out


paged_decode_attention_pool_chunk.launches = 0


def paged_decode_attention_chunk_q8_reference(
    q: torch.Tensor,  # [B, S, Hh, D]
    k_pool: torch.Tensor,  # [L, P, Hh, page, D] int8
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # [L, P, Hh, page] f32
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int
    seq_lens: torch.Tensor,  # [B, S] int: per-query budgets
    layer: int,
    *,
    scale: float,
    open_k: Optional[torch.Tensor] = None,  # [L, B, Hh, page, D] bf16: int8tail
    open_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain twin of R, the JAX package's CPU path: dequantize layer
    `layer`, overwrite each row's last page by its largest budget
    (seq_lens[:, -1]) with its open page (tail mode), then Q's gather twin.
    [B, S, Hh, D] f32."""
    k_layer = dequant_pages(k_pool[layer], k_scale[layer])
    v_layer = dequant_pages(v_pool[layer], v_scale[layer])
    if open_k is not None:
        page = k_pool.shape[3]
        rows = torch.arange(q.shape[0], device=q.device)
        last_pg = block_tables.long()[rows, (seq_lens.long()[:, -1] - 1) // page]
        k_layer[last_pg] = open_k[layer].float()
        v_layer[last_pg] = open_v[layer].float()
    return paged_decode_attention_chunk_reference(q, k_layer, v_layer, block_tables, seq_lens, scale=scale)


def paged_decode_attention_pool_chunk_q8(
    q: torch.Tensor,  # [B, S, Hh, D] f32
    k_pool: torch.Tensor,  # [L, P, Hh, page, D] int8
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # [L, P, Hh, page] f32
    v_scale: torch.Tensor,
    block_tables: torch.Tensor,  # [B, max_pages] int32
    seq_lens: torch.Tensor,  # [B, S] int32: per-query budgets
    layer: int,
    *,
    scale: float,
    open_k: Optional[torch.Tensor] = None,  # [L, B, Hh, page, D] bf16: int8tail
    open_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel R on layer `layer` of an int8 pool; with open_k / open_v
    (int8tail), each row's last page by its largest budget is read from its
    open page. Returns [B, S, Hh, D] f32."""
    if q.device.type == "cpu":
        return paged_decode_attention_chunk_q8_reference(q, k_pool, v_pool, k_scale, v_scale, block_tables, seq_lens,
                                                         layer, scale=scale, open_k=open_k, open_v=open_v)
    b, s, hh, d = q.shape
    n_layers, n_pages, _, page, _ = k_pool.shape
    tail = open_k is not None
    _check_chunk("R", q, k_pool, block_tables, seq_lens)
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8 or k_scale.dtype != torch.float32 \
            or v_scale.dtype != torch.float32:
        raise ValueError(f"kernel R takes int8 pools and f32 scales, got {k_pool.dtype} / {k_scale.dtype}")
    if k_pool.shape != (n_layers, n_pages, hh, page, d) or v_pool.shape != k_pool.shape or page > _MAX_PAGE \
            or k_scale.shape != k_pool.shape[:4] or v_scale.shape != k_scale.shape:
        raise ValueError(f"pool {tuple(k_pool.shape)} / scales {tuple(k_scale.shape)} do not fit q "
                         f"{tuple(q.shape)} (page <= {_MAX_PAGE})")
    if tail and (open_v is None or open_k.dtype != torch.bfloat16 or open_v.dtype != torch.bfloat16
                 or open_k.shape != (n_layers, b, hh, page, d) or open_v.shape != open_k.shape):
        raise ValueError(f"open pages must be bf16 [{n_layers}, {b}, {hh}, {page}, {d}] (one a row), got "
                         f"{None if open_k is None else tuple(open_k.shape)}")
    views = [k_pool[layer], v_pool[layer], k_scale[layer], v_scale[layer]]  # views, never copies
    opens = [open_k[layer], open_v[layer]] if tail else []
    cuda_build.require_cuda(q, *views, *opens, block_tables, seq_lens)
    fn = cuda_build.entry("paged_attention", "paged_chunk_q8", _CHUNK_Q8_ARGTYPES)
    max_pages = block_tables.shape[1]
    part, counters = _split_workspace(q, page, max_pages, s)
    out = torch.empty_like(q)
    p = cuda_build.ptr
    open_ptrs = [p(t) for t in opens] if tail else [None, None]  # NULL pointers: no tail
    err = fn(p(q), *(p(t) for t in views), *open_ptrs, p(block_tables), p(seq_lens), p(part), p(counters), p(out),
             b, s, hh, d, page, max_pages, int(tail), scale, cuda_build.stream_of(q))
    cuda_build.check(err, "paged_attention (R)")
    paged_decode_attention_pool_chunk_q8.launches += 1
    return out


paged_decode_attention_pool_chunk_q8.launches = 0
