"""Expert-aligned grouped-GEMM MoE prefill, kernels D and E: CUDA wrappers,
the device-side layout around them, and the plain twins.

Port of deepseek_ocr2_tpu/ops/moe_gmm.py (`moe_ffn_gmm`, forward only):
- `aligned_layout` ports `_aligned_layout`: each expert's sorted group is
  padded to a multiple of `GMM_BM` rows, so every row tile holds one expert;
- D, `moe_gmm_swiglu` (replaces `_gmm_swiglu_kernel_al`), and E,
  `moe_gmm_down` (replaces `_gmm_down_kernel_al`); run in turn they give the
  bits of the fused `_gmm_ffn_kernel_al` the JAX package runs by default.
  The CUDA source is `csrc/moe_gmm.cu` (its header gives the design and
  what bounds it);
- `moe_ffn_gmm_reference` is the grouped plain twin (the counterpart of
  `moe_ffn_ragged`): what the CPU runs above the dense cut-over, and the
  oracle of the kernels on the card.

Weights keep HF's [out, in] layout, stacked over experts: gate/up [E, I, H],
down [E, H, I]. Rounding points (identity for f32), as in the TPU kernels:
gate = round(x Wg^T), up = round(x Wu^T), act = round(round(silu_f32(gate))
* up), y = round(act Wd^T), each product accumulated in f32; the routed
outputs are combined over k in f32 with the routing weights.

On CUDA nothing here reads a value back to the host: group sizes come from
`scatter_add_` (not `bincount`), the layout from `cumsum` and
`searchsorted`, and the grid is the static worst case.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

# Row-tile height. 32 pads an expert's group by 16 rows on average (about
# E * 16 = 1024 rows per layer, 15-30 % of a crop page's 3300-6750
# assignments), half of what 64 would: the f32 instance multiplies with
# FMAs on the CUDA cores, where a pad row costs as much as a real one. The
# bf16 instance (tensor cores) is bound by streaming weights instead, and
# 32 rows still reuse each staged weight element 32 times. The CUDA source
# has the same constant and refuses any other.
GMM_BM = 32


def aligned_layout(group_sizes: torch.Tensor, m_pad: int, bm: int):
    """Port of `_aligned_layout`. From group sizes [E] (sorted-row order),
    returns (src_slot [S] int32, the sorted row each slot takes;
    slot_valid [S] bool; slot_of_sorted [m_pad] int32, the inverse map;
    e_tile [T] int32, each tile's expert; tile_valid [T] int32), with
    S = m_pad + E * bm the static worst case and T = S / bm. Invalid tail
    tiles point at the last real tile's expert, as in the JAX package."""
    dev = group_sizes.device
    e = group_sizes.shape[0]
    s_total = m_pad + e * bm
    gs = group_sizes.long()
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev), torch.cumsum(gs, 0)])
    aligned_sizes = (gs + bm - 1) // bm * bm
    aligned_end = torch.cumsum(aligned_sizes, 0)
    shift = aligned_end - aligned_sizes - offsets[:-1]  # slot = sorted row + shift[expert]

    slots = torch.arange(s_total, device=dev)
    e_slot = torch.searchsorted(aligned_end, slots, right=True).clamp(max=e - 1)
    src_slot = slots - shift[e_slot]
    slot_valid = (slots < aligned_end[e_slot]) & (src_slot < offsets[e_slot + 1])

    rows = torch.arange(m_pad, device=dev)
    g_row = torch.searchsorted(offsets[1:], rows, right=True).clamp(max=e - 1)
    slot_of_sorted = rows + shift[g_row]

    t0 = torch.arange(s_total // bm, device=dev) * bm
    e_tile = torch.searchsorted(aligned_end, t0, right=True).clamp(max=e - 1)
    total = aligned_end[-1:]
    tile_valid = t0 < total
    e_last = torch.searchsorted(aligned_end, (total - 1).clamp(min=0), right=True).clamp(max=e - 1)
    e_tile = torch.where(tile_valid, e_tile, e_last)
    i32 = torch.int32
    return src_slot.to(i32), slot_valid, slot_of_sorted.to(i32), e_tile.to(i32), tile_valid.to(i32)


# ---------------------------------------------------------------------------
# Kernels D and E


def _tiles(x: torch.Tensor, e_tile: torch.Tensor) -> Tuple[int, int]:
    n_tiles = e_tile.shape[0]
    if x.dim() != 2 or n_tiles == 0 or x.shape[0] % n_tiles:
        raise ValueError(f"x {tuple(x.shape)} is not {n_tiles} row tiles")
    return n_tiles, x.shape[0] // n_tiles


def gmm_swiglu_reference(x_al, w_gate, w_up, e_tile, tile_valid) -> torch.Tensor:
    """Plain twin of D: each tile against its expert's gathered weights.
    Rows of invalid tiles are zero."""
    n_tiles, bm = _tiles(x_al, e_tile)
    xt = x_al.reshape(n_tiles, bm, -1)
    e = e_tile.long()
    gate = torch.bmm(xt, w_gate[e].transpose(1, 2))
    up = torch.bmm(xt, w_up[e].transpose(1, 2))
    act = F.silu(gate.float()).to(x_al.dtype) * up
    return torch.where(tile_valid.bool()[:, None, None], act, 0).reshape(x_al.shape[0], -1)


def gmm_down_reference(act, w_down, e_tile, tile_valid) -> torch.Tensor:
    """Plain twin of E. Rows of invalid tiles are zero."""
    n_tiles, bm = _tiles(act, e_tile)
    y = torch.bmm(act.reshape(n_tiles, bm, -1), w_down[e_tile.long()].transpose(1, 2))
    return torch.where(tile_valid.bool()[:, None, None], y, 0).reshape(act.shape[0], -1)


def _check(x, ws, e_tile, tile_valid, k_dim: int) -> None:
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernels D and E take f32 or bf16, got {dt}")
    if any(w.dtype != dt for w in ws):
        raise ValueError("weights must have the activations' dtype")
    if e_tile.dtype != torch.int32 or tile_valid.dtype != torch.int32:
        raise ValueError("e_tile and tile_valid must be int32")
    k_align = 4 if dt == torch.float32 else 8  # 16-byte loads along K
    if x.shape[1] != k_dim or k_dim % k_align or ws[0].shape[1] % 4:
        raise ValueError(f"K = {x.shape[1]} must match the weights and be a multiple of {k_align}, "
                         f"N = {ws[0].shape[1]} a multiple of 4")
    cuda_build.require_cuda(x, *ws, e_tile, tile_valid)
    if any(t.data_ptr() % 16 for t in (x, *ws)):
        raise ValueError("kernels D and E read 16-byte aligned rows")


def moe_gmm_swiglu(x_al, w_gate, w_up, e_tile, tile_valid) -> torch.Tensor:
    """Kernel D: x_al [S, H] (row tiles of one expert each), w_gate / w_up
    [E, I, H], e_tile / tile_valid [T] int32 -> act [S, I] in x_al.dtype."""
    if x_al.device.type == "cpu":
        return gmm_swiglu_reference(x_al, w_gate, w_up, e_tile, tile_valid)
    n_tiles, bm = _tiles(x_al, e_tile)
    e, i, h = w_gate.shape
    if w_up.shape != (e, i, h):
        raise ValueError(f"gate {tuple(w_gate.shape)} and up {tuple(w_up.shape)} differ")
    _check(x_al, (w_gate, w_up), e_tile, tile_valid, h)
    lib = cuda_build.load("moe_gmm")
    fn = lib.gmm_swiglu_f32 if x_al.dtype == torch.float32 else lib.gmm_swiglu_bf16
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    act = torch.zeros(x_al.shape[0], i, dtype=x_al.dtype, device=x_al.device)
    p = cuda_build.ptr
    err = fn(p(x_al), p(w_gate), p(w_up), p(e_tile), p(tile_valid), p(act), n_tiles, bm, h, i,
             cuda_build.stream_of(x_al))
    cuda_build.check(err, "moe_gmm swiglu")
    moe_gmm_swiglu.launches += 1
    return act


moe_gmm_swiglu.launches = 0


def moe_gmm_down(act, w_down, e_tile, tile_valid) -> torch.Tensor:
    """Kernel E: act [S, I], w_down [E, H, I] -> y [S, H] in act.dtype."""
    if act.device.type == "cpu":
        return gmm_down_reference(act, w_down, e_tile, tile_valid)
    n_tiles, bm = _tiles(act, e_tile)
    e, h, i = w_down.shape
    _check(act, (w_down,), e_tile, tile_valid, i)
    lib = cuda_build.load("moe_gmm")
    fn = lib.gmm_down_f32 if act.dtype == torch.float32 else lib.gmm_down_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = torch.zeros(act.shape[0], h, dtype=act.dtype, device=act.device)
    p = cuda_build.ptr
    err = fn(p(act), p(w_down), p(e_tile), p(tile_valid), p(y), n_tiles, bm, i, h,
             cuda_build.stream_of(act))
    cuda_build.check(err, "moe_gmm down")
    moe_gmm_down.launches += 1
    return y


moe_gmm_down.launches = 0


# ---------------------------------------------------------------------------
# The MoE FFN


def _combine(y_sorted_rows: torch.Tensor, weights: torch.Tensor, dtype) -> torch.Tensor:
    """[N*k, H] token-major outputs -> f32 weighted sum over k, cast."""
    n, k = weights.shape
    y = y_sorted_rows.reshape(n, k, -1).float()
    return (y * weights[:, :, None]).sum(1).to(dtype)


def _sort(idx: torch.Tensor):
    flat = idx.reshape(-1).to(torch.int32)
    order = torch.argsort(flat, stable=True)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.shape[0], device=order.device))
    return flat, order, inv


def align_rows(x_flat: torch.Tensor, idx: torch.Tensor, n_experts: int, bm: int = GMM_BM):
    """Sort the [N, k] assignments by expert and lay their rows out in
    expert-aligned slots. Returns (x_al [S, H] with zero pad rows, e_tile
    [T] int32, tile_valid [T] int32, rows [N * k] int64: the slot of each
    assignment in token-major order)."""
    m = idx.numel()
    k = idx.shape[1]
    m_pad = -(-m // bm) * bm
    flat, order, inv = _sort(idx)
    group_sizes = torch.zeros(n_experts, dtype=torch.int32, device=x_flat.device)
    group_sizes.scatter_add_(0, flat.long(), torch.ones_like(flat))
    src_slot, slot_valid, slot_of_sorted, e_tile, tile_valid = aligned_layout(group_sizes, m_pad, bm)
    # The sort's gather and the aligned scatter compose into one row gather.
    token_of = torch.zeros(m_pad, dtype=torch.long, device=x_flat.device)
    token_of[:m] = order // k
    token_of_slot = token_of.index_select(0, src_slot.long().clamp(0, m_pad - 1))
    x_al = torch.where(slot_valid[:, None], x_flat.index_select(0, token_of_slot), 0)
    # Assignment j (token j // k, selection j % k) sits at slot slot_of_sorted[inv[j]].
    rows = slot_of_sorted.long().index_select(0, inv)
    return x_al, e_tile, tile_valid, rows


def moe_ffn_gmm_aligned(x_flat, experts: Dict[str, torch.Tensor], weights, idx) -> torch.Tensor:
    """The aligned path of `_moe_ffn_gmm_impl`: `align_rows`, kernel D, then
    kernel E, unsort, f32 combine. On CPU tensors D and E run their plain
    twins (the tests use that)."""
    x_al, e_tile, tile_valid, rows = align_rows(x_flat, idx, experts["gate"].shape[0])
    act = moe_gmm_swiglu(x_al, experts["gate"], experts["up"], e_tile, tile_valid)
    y_al = moe_gmm_down(act, experts["down"], e_tile, tile_valid)
    return _combine(y_al.index_select(0, rows), weights, x_flat.dtype)


def moe_ffn_gmm_reference(x_flat, experts: Dict[str, torch.Tensor], weights, idx) -> torch.Tensor:
    """Grouped plain twin: sort by expert, one F.linear chain per non-empty
    group (group sizes read on the host), unsort, f32 combine over k."""
    k = idx.shape[1]
    e = experts["gate"].shape[0]
    flat, order, inv = _sort(idx)
    x_sorted = x_flat[order // k]
    sizes = torch.bincount(flat.long(), minlength=e).tolist()
    y_sorted = torch.empty(x_sorted.shape[0], experts["down"].shape[1], dtype=x_flat.dtype, device=x_flat.device)
    start = 0
    for ex, size in enumerate(sizes):
        if size:
            xs = x_sorted[start : start + size]
            gate = F.linear(xs, experts["gate"][ex])
            up = F.linear(xs, experts["up"][ex])
            act = F.silu(gate.float()).to(gate.dtype) * up
            y_sorted[start : start + size] = F.linear(act, experts["down"][ex])
        start += size
    return _combine(y_sorted[inv], weights, x_flat.dtype)


def moe_ffn_gmm(x_flat, experts: Dict[str, torch.Tensor], weights, idx) -> torch.Tensor:
    """Exact grouped-GEMM MoE FFN at prefill scale. Returns [N, H] in x's
    dtype: kernels D and E on CUDA tensors, the grouped twin on the CPU."""
    if x_flat.device.type == "cpu":
        return moe_ffn_gmm_reference(x_flat, experts, weights, idx)
    return moe_ffn_gmm_aligned(x_flat, experts, weights, idx)
