"""Expert-aligned grouped-GEMM MoE: the prefill forward as one routed chain
(the routing layout, kernels D and E on row maps, the k-combine), the
backward kernels S and T, the plain twins, and the differentiable
`moe_ffn_gmm`.

Port of deepseek_ocr2_tpu/ops/moe_gmm.py (`moe_ffn_gmm` and its custom VJP):
- `aligned_layout` ports `_aligned_layout`: each expert's sorted group is
  padded to a multiple of `GMM_BM` rows, so every row tile holds one expert;
- `routed_layout` is the whole layout of a routing idx [N, k] in one CUDA
  launch (`route_layout` in csrc/moe_gmm.cu: a stable counting sort, the
  aligned slots, D's and E's schedule and their row maps), the counterpart
  of the glue before `_gmm_ffn_kernel_al` in `_moe_ffn_gmm_impl` (the
  stable argsort, bincount, `_aligned_layout`); its plain twin
  `routed_layout_reference` is `aligned_assignments` + `row_schedule`, the
  torch forms every integer of the kernel equals;
- D, `moe_gmm_swiglu` (replaces `_gmm_swiglu_kernel_al`), and E,
  `moe_gmm_down` (replaces `_gmm_down_kernel_al`); run in turn they compute
  the fused `_gmm_ffn_kernel_al` the JAX package runs by default, with the
  act rounded at the same point. D reads x through a slot -> row map (no
  [S, H] copy of x) and E writes each slot's y through a slot -> row map
  (no unsort), and `moe_combine` sums each token's k rows in f32: the
  forward of a MoE layer on CUDA is four launches, `_forward_routed`. The
  backward's recompute (`_gmm_down_kernel` there) is E three times. In
  bf16 E runs S's kernel (below) with the weight read K-major, on S's
  schedule, and D the same kernel with gate and up in each stage and the
  SwiGLU in its epilogue, on (row block, SWIGLU_COLS columns of I) items
  (`swiglu_grid`): each weight slice is read once per 128 rows, where D's
  first form, a 32-row mma.sync kernel, re-read its expert's gate and up
  for every 32-row tile;
- S, `moe_gmm_dx` (replaces `_gmm_dx_kernel`): per tile a @ W_e, the
  weight contracted on its row dim; T, `moe_gmm_dw` (replaces
  `_gmm_dw_kernel`): per expert the sum of dy_t^T x_t over its tiles, in
  f32. The CUDA source is `csrc/moe_gmm.cu` (its header gives the design
  and what bounds each kernel). In bf16 both run wgmma fed by TMA
  (`csrc/sm90.cuh`) on persistent grids: S and E (and D, by 128 columns)
  on (row block of up to 128 rows of one expert, 256 columns) work items
  (`row_block_lo`, `dx_grid`; `dx_row_blocks` is the plain form of its
  row-block map), T on (expert, 128 x 256 outputs) work items (`dw_grid`;
  `dw_work_items` the plain form of its walk);
- `MoeFfnGmm`, the autograd Function: forward the routed chain, backward
  `_moe_ffn_gmm_bwd`'s rounding points on the same saved layout (E x 3,
  S x 3, T x 3). The kernels are forward-only outside it
  (`cuda_build.require_cuda` refuses an input that requires grad while grad
  mode is on);
- `moe_ffn_gmm_reference` is the grouped plain twin (the counterpart of
  `moe_ffn_ragged`): the CPU's forward above the dense cut-over, and the
  oracle of the kernels on the card;
- W, the boundary-visit forward the aligned layout superseded, on the
  port's copy of `_visit_schedule` and `_pick_bm` (`visit_schedule`,
  `pick_bm`): `gmm_swiglu_visit` (replaces `_gmm_swiglu_kernel`) and
  `gmm_ffn_visit` (replaces `_gmm_ffn_kernel`), run on D and E with the
  slot -> sorted-row map of the sorted rows' own aligned layout, on their
  loads and on D's (swiglu) or E's (ffn) stores; no device code of its own.
  No path of the JAX package calls either, so none of the port's does.

Weights keep HF's [out, in] layout, stacked over experts: gate/up [E, I, H],
down [E, H, I]. Rounding points (identity for f32), as in the TPU kernels:
gate = round(x Wg^T), up = round(x Wu^T), act = round(round(silu_f32(gate))
* up), y = round(act Wd^T), each product accumulated in f32; the routed
outputs are combined over k in f32 with the routing weights.

On CUDA nothing here reads a value back to the host: the layout is built on
the device (by the layout kernel, or by the twin's `scatter_add_`,
`cumsum` and `searchsorted`), and the grid is the static worst case.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

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

# ctypes signatures of csrc/moe_gmm.cu's entry points ("p" a pointer or the
# stream, "i" an int), set once when the library is first used.
_SIGNATURES = {
    "route_layout": "piiiiippppppppppp", "moe_combine": "ppipiipiiiiiip",
    "gmm_swiglu_f32": "ppppppppiiiip", "gmm_swiglu_bf16": "ppppppppiiiiiip",
    "gmm_down_f32": "ppppppiiiip", "gmm_down_bf16": "ppppppiiiiiip",
    "gmm_dx_f32": "pppppiiiip", "gmm_dx_bf16": "pppppiiiiiip",
    "gmm_dw_f32": "ppppiiip", "gmm_dw_bf16": "ppppiiiiip",
}
_ARGTYPES = {name: [ctypes.c_void_p if c == "p" else ctypes.c_int for c in sig] for name, sig in _SIGNATURES.items()}


def _fn(name: str):
    """The library's entry point `name`, its argtypes bound (builds the
    library at first use)."""
    return cuda_build.entry("moe_gmm", name, _ARGTYPES[name])


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


def _align(dt) -> int:
    return 4 if dt == torch.float32 else 8  # elements in a 16-byte load


def _check(x, ws, e_tile, tile_valid, k_dim: int, n_dim: int, n_align: int = 4, extra=()) -> None:
    """The inputs of D, E and S; `extra`: more tensors that must share x's
    device (S's schedule)."""
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernels D, E and S take f32 or bf16, got {dt}")
    if any(w.dtype != dt for w in ws):
        raise ValueError("weights must have the activations' dtype")
    if e_tile.dtype != torch.int32 or tile_valid.dtype != torch.int32:
        raise ValueError("e_tile and tile_valid must be int32")
    if x.shape[1] != k_dim or k_dim % _align(dt) or n_dim % n_align:
        raise ValueError(f"K = {x.shape[1]} must match the weights and be a multiple of {_align(dt)}, "
                         f"N = {n_dim} a multiple of {n_align}")
    cuda_build.require_cuda(x, *ws, e_tile, tile_valid, *extra)
    # K and N in multiples of 16 bytes (checked above) also give S's TMA
    # maps in bf16 the 16-byte row strides they need.
    if any(t.data_ptr() % 16 for t in (x, *ws)):
        raise ValueError("kernels D, E and S read 16-byte aligned rows")


def _slot_rows(x: torch.Tensor, x_rows: torch.Tensor) -> torch.Tensor:
    """[S, K]: row x_rows[s] of x for each slot s, zeros where it is -1 (the
    plain form of D's loads through a map)."""
    return torch.where(x_rows[:, None] >= 0, x.index_select(0, x_rows.clamp(min=0).long()), 0)


def _put_rows(out: torch.Tensor, vals: torch.Tensor, out_rows: torch.Tensor) -> torch.Tensor:
    """Slot s's row of vals into row out_rows[s] of out, none where -1 (the
    plain form of D's and E's stores through a map); returns out."""
    keep = out_rows >= 0
    out[out_rows[keep].long()] = vals[keep].to(out.dtype)
    return out


def _mapped(x, x_rows, e_tile, out_rows, out, n_cols: int, dtype) -> Tuple[int, int]:
    """(n_tiles, bm) of a D or E call: S slots, x [S, K] or x [R, K] read
    through x_rows [S] int32; `out` [R', n_cols] given exactly when
    out_rows [S] int32 is."""
    n_slots = x.shape[0] if x_rows is None else x_rows.shape[0]
    n_tiles = e_tile.shape[0]
    if x.dim() != 2 or n_tiles == 0 or n_slots % n_tiles:
        raise ValueError(f"{n_slots} slots are not {n_tiles} row tiles")
    for rows in (x_rows, out_rows):
        if rows is not None and (rows.dtype != torch.int32 or rows.shape != (n_slots,)):
            raise ValueError(f"a row map must be int32 [{n_slots}], got {rows.dtype} {tuple(rows.shape)}")
    if (out is None) != (out_rows is None):
        raise ValueError("out and out_rows go together")
    if out is not None and (out.dim() != 2 or out.shape[1] != n_cols or out.dtype != dtype):
        raise ValueError(f"out must be [rows, {n_cols}] {dtype}, got {out.dtype} {tuple(out.shape)}")
    return n_tiles, n_slots // n_tiles


def _opt(t):
    """A tensor's pointer, or NULL for an absent map."""
    return None if t is None else cuda_build.ptr(t)


def moe_gmm_swiglu(x, w_gate, w_up, e_tile, tile_valid, tile_lo=None, blk_lo=None, x_rows=None, out_rows=None,
                   out=None) -> torch.Tensor:
    """Kernel D: slots of x (x [S, H], row tiles of one expert each; or, with
    x_rows [S] int32, slot s reads row x_rows[s] of x [R, H], zeros where
    -1), w_gate / w_up [E, I, H], e_tile / tile_valid [T] int32 -> act [S,
    I] in x.dtype, the invalid tail tiles' rows zero; or, with out_rows [S]
    int32 (and x_rows), slot s's act into row out_rows[s] of `out` (none
    where -1), which is returned. bf16 runs E's row-block kernel with two
    weights and the SwiGLU epilogue, on the schedule of `row_schedule`,
    built here unless the caller passes it (the forward's layout carries
    it)."""
    n_tiles, bm = _mapped(x, x_rows, e_tile, out_rows, out, w_gate.shape[1], x.dtype)
    if x.device.type == "cpu":
        act = gmm_swiglu_reference(x if x_rows is None else _slot_rows(x, x_rows), w_gate, w_up, e_tile, tile_valid)
        return act if out_rows is None else _put_rows(out, act, out_rows)
    e, i, h = w_gate.shape
    if w_up.shape != (e, i, h):
        raise ValueError(f"gate {tuple(w_gate.shape)} and up {tuple(w_up.shape)} differ")
    if out_rows is not None and x_rows is None:
        raise ValueError("kernel D stores through a row map only when it loads through one")
    maps = tuple(t for t in (x_rows, out_rows, out) if t is not None)
    act = torch.empty(n_tiles * bm, i, dtype=x.dtype, device=x.device) if out is None else out
    p = cuda_build.ptr
    if x.dtype == torch.bfloat16:
        tile_lo, blk_lo = _checked_schedule(e_tile, tile_valid, e, tile_lo, blk_lo)
        _check(x, (w_gate, w_up), e_tile, tile_valid, h, i, 8, (tile_lo, blk_lo, *maps))
        err = _fn("gmm_swiglu_bf16")(p(x), p(w_gate), p(w_up), p(tile_lo), p(blk_lo), _opt(x_rows), _opt(out_rows),
                                     p(act), n_tiles, bm, h, i, e, swiglu_grid(n_tiles, e, i, _n_sms(x.device)),
                                     cuda_build.stream_of(x))
    else:
        _check(x, (w_gate, w_up), e_tile, tile_valid, h, i, extra=maps)
        err = _fn("gmm_swiglu_f32")(p(x), p(w_gate), p(w_up), p(e_tile), p(tile_valid), _opt(x_rows), _opt(out_rows),
                                    p(act), n_tiles, bm, h, i, cuda_build.stream_of(x))
    cuda_build.check(err, "moe_gmm swiglu")
    moe_gmm_swiglu.launches += 1
    return act


moe_gmm_swiglu.launches = 0


def moe_gmm_down(act, w_down, e_tile, tile_valid, tile_lo=None, blk_lo=None, out_rows=None, out=None) -> torch.Tensor:
    """Kernel E: act [S, I], w_down [E, H, I] -> y [S, H] in act.dtype, the
    invalid tail tiles' rows zero; or, with out_rows [S] int32, slot s's y
    into row out_rows[s] of `out` (none where -1), which is returned. bf16
    runs S's row-block kernel on S's schedule (`row_schedule`), built here
    unless the caller passes it (the forward's layout carries it, the
    backward builds it once a layer)."""
    n_tiles, bm = _mapped(act, None, e_tile, out_rows, out, w_down.shape[1], act.dtype)
    if act.device.type == "cpu":
        y = gmm_down_reference(act, w_down, e_tile, tile_valid)
        return y if out_rows is None else _put_rows(out, y, out_rows)
    e, h, i = w_down.shape
    maps = tuple(t for t in (out_rows, out) if t is not None)
    y = torch.empty(act.shape[0], h, dtype=act.dtype, device=act.device) if out is None else out
    p = cuda_build.ptr
    if act.dtype == torch.bfloat16:
        tile_lo, blk_lo = _checked_schedule(e_tile, tile_valid, e, tile_lo, blk_lo)
        _check(act, (w_down,), e_tile, tile_valid, i, h, 8, (tile_lo, blk_lo, *maps))
        err = _fn("gmm_down_bf16")(p(act), p(w_down), p(tile_lo), p(blk_lo), _opt(out_rows), p(y), n_tiles, bm, i, h,
                                   e, dx_grid(n_tiles, e, h, _n_sms(act.device)), cuda_build.stream_of(act))
    else:
        _check(act, (w_down,), e_tile, tile_valid, i, h, extra=maps)
        err = _fn("gmm_down_f32")(p(act), p(w_down), p(e_tile), p(tile_valid), _opt(out_rows), p(y), n_tiles, bm, i,
                                  h, cuda_build.stream_of(act))
    cuda_build.check(err, "moe_gmm down")
    moe_gmm_down.launches += 1
    return y


moe_gmm_down.launches = 0


def gmm_dx_reference(a, w, e_tile, tile_valid) -> torch.Tensor:
    """Plain twin of S: each tile times its expert's [O, C] weight, rounded
    to a's dtype. Rows of invalid tiles are zero."""
    n_tiles, bm = _tiles(a, e_tile)
    out = torch.bmm(a.reshape(n_tiles, bm, -1), w[e_tile.long()])
    return torch.where(tile_valid.bool()[:, None, None], out, 0).reshape(a.shape[0], -1)


def expert_tile_ranges(e_tile: torch.Tensor, tile_valid: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[E + 1] int32: expert e owns tiles tile_lo[e] .. tile_lo[e + 1] - 1
    (valid tiles are sorted by expert; the invalid tail is keyed past E).
    On the device, no host sync."""
    key = torch.where(tile_valid.bool(), e_tile, n_experts).contiguous()
    bounds = torch.arange(n_experts + 1, dtype=key.dtype, device=key.device)
    return torch.searchsorted(key, bounds, out_int32=True)


# Kernel S in bf16 takes an expert's rows a row block at a time: up to
# DX_TILES tiles (128 rows), so it reads each weight slice once per 128
# rows; the expert's last block may hold fewer tiles. A work item is a row
# block by DX_COLS output columns.
DX_TILES, DX_COLS = 4, 256
_SMS: Dict[int, int] = {}


def _n_sms(dev: torch.device) -> int:
    """The card's SM count (the persistent grids' bound), read once."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def row_block_lo(tile_lo: torch.Tensor) -> torch.Tensor:
    """[E + 1] int32 from tile_lo [E + 1]: expert e's row blocks are S's
    blocks blk_lo[e] .. blk_lo[e + 1] - 1, ceil(tiles / DX_TILES) of them.
    On the device, no host sync."""
    per_expert = torch.div(tile_lo[1:] - tile_lo[:-1] + (DX_TILES - 1), DX_TILES, rounding_mode="floor")
    blk_lo = torch.zeros_like(tile_lo)
    torch.cumsum(per_expert, 0, out=blk_lo[1:])
    return blk_lo


def dx_grid_rows(n_tiles: int, n_experts: int) -> int:
    """Row blocks in S's static walk: enough for every expert's blocks and
    for the blocks that zero the invalid tail, DX_TILES tiles each."""
    return -(-n_tiles // DX_TILES) + n_experts + 1


def dx_grid(n_tiles: int, n_experts: int, c_dim: int, n_sms: int) -> int:
    """S's persistent grid: one block per SM, or one per work item (row
    block by DX_COLS columns) if there are fewer."""
    return min(n_sms, dx_grid_rows(n_tiles, n_experts) * -(-c_dim // DX_COLS))


# Kernel D in bf16 walks S's row blocks by SWIGLU_COLS columns of I: a
# stage holds both weights' slices, so half of S's 256 columns.
SWIGLU_COLS = 128


def swiglu_grid(n_tiles: int, n_experts: int, i_dim: int, n_sms: int) -> int:
    """D's persistent grid: one block per SM, or one per work item (row
    block by SWIGLU_COLS columns of I) if there are fewer."""
    return min(n_sms, dx_grid_rows(n_tiles, n_experts) * -(-i_dim // SWIGLU_COLS))


def dx_row_blocks(tile_lo: torch.Tensor, blk_lo: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """The plain form of S's row-block map (csrc/moe_gmm.cu
    `gmm_dx_wgmma_kernel`): [dx_grid_rows, 3] int64, per row block b its
    (expert, first tile, end tile); the kernel's work item i is row block
    i // ceil(C / DX_COLS) by column block i % ceil(C / DX_COLS) (D's: by
    SWIGLU_COLS columns of I). Row block
    b < blk_lo[E] multiplies tiles [first, end) of the expert e with
    blk_lo[e] <= b < blk_lo[e + 1]; the next ones zero the invalid tail,
    DX_TILES tiles each (expert -1); the rest have first = end = n_tiles
    and do nothing."""
    n_experts = tile_lo.shape[0] - 1
    tile_lo, blk_lo = tile_lo.long(), blk_lo.long()
    b = torch.arange(dx_grid_rows(n_tiles, n_experts), device=tile_lo.device)
    e = (torch.searchsorted(blk_lo, b, right=True) - 1).clamp(0, n_experts - 1)
    first = tile_lo[e] + DX_TILES * (b - blk_lo[e])
    end = torch.minimum(first + DX_TILES, tile_lo[e + 1])
    tail = b >= blk_lo[-1]
    z = (tile_lo[-1] + DX_TILES * (b - blk_lo[-1])).clamp(max=n_tiles)
    first = torch.where(tail, z, first)
    end = torch.where(tail, (z + DX_TILES).clamp(max=n_tiles), end)
    return torch.stack([torch.where(tail, -1, e), first, end], 1)


def row_schedule(e_tile: torch.Tensor, tile_valid: torch.Tensor, n_experts: int):
    """(tile_lo, blk_lo): the schedule of D, S and E in bf16 for one
    layout, on the device, no host sync."""
    tile_lo = expert_tile_ranges(e_tile, tile_valid, n_experts)
    return tile_lo, row_block_lo(tile_lo)


def _checked_schedule(e_tile, tile_valid, n_experts: int, tile_lo, blk_lo):
    """The caller's schedule, or one built here; refused unless each is
    int32 [E + 1]."""
    if tile_lo is None:
        tile_lo = expert_tile_ranges(e_tile, tile_valid, n_experts)
    if blk_lo is None:
        blk_lo = row_block_lo(tile_lo)
    _check_ranges(tile_lo, n_experts, "tile_lo")
    _check_ranges(blk_lo, n_experts, "blk_lo")
    return tile_lo, blk_lo


# Kernel T in bf16: a work item is an expert's DW_TILE_O x DW_TILE_C block
# of dW.
DW_TILE_O, DW_TILE_C = 128, 256


def dw_grid(n_experts: int, o_dim: int, c_dim: int, n_sms: int) -> int:
    """T's persistent grid: one block per SM, or one per work item if there
    are fewer."""
    return min(n_sms, n_experts * -(-o_dim // DW_TILE_O) * -(-c_dim // DW_TILE_C))


def dw_work_items(n_experts: int, o_dim: int, c_dim: int) -> torch.Tensor:
    """The plain form of T's walk (csrc/moe_gmm.cu `gmm_dw_wgmma_kernel`):
    [n_items, 3] int64 (expert, o0, c0) of item i, expert slowest, then the
    o block, then the c block; block k of a grid of G takes items k, k + G,
    k + 2 G, ..."""
    n_ot, n_ct = -(-o_dim // DW_TILE_O), -(-c_dim // DW_TILE_C)
    i = torch.arange(n_experts * n_ot * n_ct)
    oc = i % (n_ot * n_ct)
    return torch.stack([i // (n_ot * n_ct), oc // n_ct * DW_TILE_O, oc % n_ct * DW_TILE_C], 1)


def _check_ranges(ranges: torch.Tensor, n_experts: int, what: str) -> None:
    if ranges.dtype != torch.int32 or ranges.shape != (n_experts + 1,):
        raise ValueError(f"{what} must be int32 [{n_experts + 1}], got {ranges.dtype} {tuple(ranges.shape)}")


def gmm_dw_reference(x, dy, e_tile, tile_valid, n_experts: int) -> torch.Tensor:
    """Plain twin of T: per tile dy_t^T x_t in f32 (the products of the
    working dtype's values are exact in f32), summed into the tile's
    expert. [E, O, C] f32; an expert with no tiles gets zeros."""
    n_tiles, bm = _tiles(x, e_tile)
    prod = torch.bmm(dy.float().reshape(n_tiles, bm, -1).transpose(1, 2), x.float().reshape(n_tiles, bm, -1))
    key = torch.where(tile_valid.bool(), e_tile, n_experts).long()
    out = torch.zeros(n_experts + 1, *prod.shape[1:], dtype=torch.float32, device=x.device)
    return out.index_add_(0, key, prod)[:n_experts]


def moe_gmm_dx(a, w, e_tile, tile_valid, tile_lo=None, blk_lo=None) -> torch.Tensor:
    """Kernel S: a [S, O] (row tiles of one expert each), w [E, O, C] ->
    a_t @ w[e_t], [S, C] in a.dtype (f32 sums). The weight is read as it
    lies, contracted on its row dim: dact = dy Wd, dx = dgate Wg + dup Wu
    with the port's HF-layout weights. bf16 takes the schedule tile_lo
    (`expert_tile_ranges`) and blk_lo (`row_block_lo`), built here unless
    the caller passes them (the backward builds them once a layer)."""
    if a.device.type == "cpu":
        return gmm_dx_reference(a, w, e_tile, tile_valid)
    n_tiles, bm = _tiles(a, e_tile)
    e, o, c = w.shape
    p = cuda_build.ptr
    if a.dtype == torch.bfloat16:
        tile_lo, blk_lo = _checked_schedule(e_tile, tile_valid, e, tile_lo, blk_lo)
        _check(a, (w,), e_tile, tile_valid, o, c, 8, (tile_lo, blk_lo))
        out = torch.empty(a.shape[0], c, dtype=a.dtype, device=a.device)  # the kernel writes every row
        err = _fn("gmm_dx_bf16")(p(a), p(w), p(tile_lo), p(blk_lo), p(out), n_tiles, bm, o, c, e,
                                 dx_grid(n_tiles, e, c, _n_sms(a.device)), cuda_build.stream_of(a))
    else:
        _check(a, (w,), e_tile, tile_valid, o, c)
        out = torch.empty(a.shape[0], c, dtype=a.dtype, device=a.device)  # the kernel zeroes the invalid tiles
        err = _fn("gmm_dx_f32")(p(a), p(w), p(e_tile), p(tile_valid), p(out), n_tiles, bm, o, c,
                                cuda_build.stream_of(a))
    cuda_build.check(err, "moe_gmm dx")
    moe_gmm_dx.launches += 1
    return out


moe_gmm_dx.launches = 0


def moe_gmm_dw(x, dy, e_tile, tile_valid, n_experts: int, tile_lo=None) -> torch.Tensor:
    """Kernel T: x [S, C], dy [S, O] on the same row tiles -> dW [E, O, C]
    f32, dW[e] = sum over e's tiles of dy_t^T x_t, in tile order (no
    atomics); an expert with no rows gets zeros. tile_lo
    (`expert_tile_ranges`) is built here unless the caller passes it."""
    if x.device.type == "cpu":
        return gmm_dw_reference(x, dy, e_tile, tile_valid, n_experts)
    _tiles(x, e_tile)
    c, o = x.shape[1], dy.shape[1]
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16) or dy.dtype != dt:
        raise ValueError(f"kernel T takes x and dy of one dtype, f32 or bf16; got {dt}, {dy.dtype}")
    # 16-byte loads (f32) and TMA's 16-byte row strides (bf16) both need
    # C and O in multiples of 16 bytes.
    if dy.shape[0] != x.shape[0] or c % _align(dt) or o % _align(dt):
        raise ValueError(f"x {tuple(x.shape)} and dy {tuple(dy.shape)}: rows must match, C and O be "
                         f"multiples of {_align(dt)}")
    if not 0 < n_experts <= 65535:
        raise ValueError(f"kernel T takes 1..65535 experts, got {n_experts}")
    if tile_lo is None:
        tile_lo = expert_tile_ranges(e_tile, tile_valid, n_experts)
    _check_ranges(tile_lo, n_experts, "tile_lo")
    cuda_build.require_cuda(x, dy, e_tile, tile_valid, tile_lo)
    if any(t.data_ptr() % 16 for t in (x, dy)):
        raise ValueError("kernel T reads 16-byte aligned rows")
    dw = torch.empty(n_experts, o, c, dtype=torch.float32, device=x.device)
    p = cuda_build.ptr
    stream = cuda_build.stream_of(x)
    if dt == torch.float32:
        err = _fn("gmm_dw_f32")(p(x), p(dy), p(tile_lo), p(dw), n_experts, c, o, stream)
    else:
        err = _fn("gmm_dw_bf16")(p(x), p(dy), p(tile_lo), p(dw), n_experts, c, o, x.shape[0],
                                 dw_grid(n_experts, o, c, _n_sms(x.device)), stream)
    cuda_build.check(err, "moe_gmm dw")
    moe_gmm_dw.launches += 1
    return dw


moe_gmm_dw.launches = 0


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


def aligned_assignments(idx: torch.Tensor, n_experts: int, bm: int = GMM_BM):
    """Sort the [N, k] assignments by expert and lay them out in
    expert-aligned slots. Returns (assign [S] int64: the token-major
    assignment j each slot holds (token j // k, selection j % k); a pad
    slot holds that of its clamped source row, 0 past the N k real ones;
    slot_valid [S] bool; e_tile [T] int32; tile_valid [T] int32; rows
    [N * k] int64: the slot of each assignment in token-major order). An
    assignment to id n_experts (another rank's expert under EP) takes no
    slot; its entry of `rows` is some slot, which the callers mask."""
    m = idx.numel()
    m_pad = -(-m // bm) * bm
    flat, order, inv = _sort(idx)
    # Id n_experts (another rank's expert, under EP) sorts last and takes no slot.
    group_sizes = torch.zeros(n_experts + 1, dtype=torch.int32, device=idx.device)
    group_sizes.scatter_add_(0, flat.long(), torch.ones_like(flat))
    group_sizes = group_sizes[:n_experts]
    src_slot, slot_valid, slot_of_sorted, e_tile, tile_valid = aligned_layout(group_sizes, m_pad, bm)
    # The sort's gather and the aligned scatter compose into one gather.
    sorted_assign = torch.zeros(m_pad, dtype=torch.long, device=idx.device)
    sorted_assign[:m] = order
    assign = sorted_assign.index_select(0, src_slot.long().clamp(0, m_pad - 1))
    # Assignment j sits at slot slot_of_sorted[inv[j]].
    rows = slot_of_sorted.long().index_select(0, inv)
    return assign, slot_valid, e_tile, tile_valid, rows


class RoutedLayout(NamedTuple):
    """The layout of a routing idx [N, k] on E experts: S = m_pad + E GMM_BM
    slots (m = N k rounded up to GMM_BM), T = S / GMM_BM tiles."""

    assign: torch.Tensor  # [S] int64, `aligned_assignments`
    slot_valid: torch.Tensor  # [S] bool
    e_tile: torch.Tensor  # [T] int32
    tile_valid: torch.Tensor  # [T] int32
    rows: torch.Tensor  # [N k] int64: each assignment's slot
    tile_lo: torch.Tensor  # [E + 1] int32, `row_schedule`
    blk_lo: torch.Tensor  # [E + 1] int32
    x_rows: torch.Tensor  # [S] int32: the token each slot reads (D's map), -1 in pad slots
    y_rows: torch.Tensor  # [S] int32: the token-major row each slot writes (E's map), -1 in pad slots


def routed_layout_reference(idx: torch.Tensor, n_experts: int) -> RoutedLayout:
    """Plain twin of the layout kernel: the torch forms (`aligned_assignments`,
    `row_schedule`) and D's and E's maps from them."""
    assign, slot_valid, e_tile, tile_valid, rows = aligned_assignments(idx, n_experts)
    tile_lo, blk_lo = row_schedule(e_tile, tile_valid, n_experts)
    x_rows = torch.where(slot_valid, assign // idx.shape[1], -1).to(torch.int32)
    y_rows = torch.where(slot_valid, assign, -1).to(torch.int32)
    return RoutedLayout(assign, slot_valid, e_tile, tile_valid, rows, tile_lo, blk_lo, x_rows, y_rows)


def _rows_view(t: torch.Tensor) -> torch.Tensor:
    """t [N, k] as the layout and combine kernels read it: selections
    contiguous, any row stride (route's top-k slices are such views)."""
    return t if t.stride(1) == 1 and t.stride(0) >= t.shape[1] else t.contiguous()


def _check_idx(idx: torch.Tensor) -> torch.Tensor:
    if idx.dim() != 2 or idx.dtype not in (torch.int64, torch.int32) or idx.numel() == 0:
        raise ValueError(f"idx must be a non-empty int64 or int32 [N, k], got {idx.dtype} {tuple(idx.shape)}")
    return _rows_view(idx)


def routed_layout(idx: torch.Tensor, n_experts: int) -> RoutedLayout:
    """The `RoutedLayout` of idx [N, k] (an id outside [0, n_experts): no
    slot, as id E under expert parallelism). CUDA: one launch of
    `route_layout` (csrc/moe_gmm.cu), every integer equal to
    `routed_layout_reference`'s, which the CPU runs."""
    if idx.device.type == "cpu":
        return routed_layout_reference(idx, n_experts)
    idx = _check_idx(idx)
    n, k = idx.shape
    if not 0 < n_experts <= 1024:
        raise ValueError(f"the layout kernel takes 1..1024 experts, got {n_experts}")
    cuda_build.require_cuda(idx[:1])  # one row: contiguous at any row stride
    m = n * k
    s_total = -(-m // GMM_BM) * GMM_BM + n_experts * GMM_BM
    t, dev = s_total // GMM_BM, idx.device
    # Three allocations carved into the outputs and the sort's scratch.
    i64 = torch.empty(s_total + m, dtype=torch.int64, device=dev)
    cuts = [t, t, n_experts + 1, n_experts + 1, s_total, s_total, m]
    e_tile, tile_valid, tile_lo, blk_lo, x_rows, y_rows, order = torch.empty(
        sum(cuts), dtype=torch.int32, device=dev).split(cuts)
    slot_valid = torch.empty(s_total, dtype=torch.bool, device=dev)
    assign, rows = i64[:s_total], i64[s_total:]
    p = cuda_build.ptr
    err = _fn("route_layout")(p(idx), int(idx.dtype == torch.int64), idx.stride(0), n, k, n_experts, p(assign),
                              p(slot_valid), p(e_tile), p(tile_valid), p(rows), p(tile_lo), p(blk_lo), p(x_rows),
                              p(y_rows), p(order), cuda_build.stream_of(idx))
    cuda_build.check(err, "moe_gmm route_layout")
    routed_layout.launches += 1
    return RoutedLayout(assign, slot_valid, e_tile, tile_valid, rows, tile_lo, blk_lo, x_rows, y_rows)


routed_layout.launches = 0


def moe_combine_reference(y: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor, n_experts: int,
                          out_dtype) -> torch.Tensor:
    """Plain twin of the combine kernel: out[t] = the sum over selections s =
    0 .. k-1 of token t with an id in [0, n_experts) of float(y[t k + s]) *
    weights[t, s], in f32, cast to out_dtype, in the order `_combine`'s
    `.sum(1)` takes on the card: four running sums, selection s of each
    whole group of four into sum s % 4, the rest into sums 0, 1, 2, then the
    four added in order. Other selections add nothing (their rows of y are
    never written)."""
    n, k = idx.shape
    yk = y.reshape(n, k, -1)
    mine = (idx >= 0) & (idx < n_experts)
    acc = [torch.zeros(n, y.shape[1], dtype=torch.float32, device=y.device) for _ in range(4)]
    full = k // 4 * 4
    for s in range(k):
        a = s % 4 if s < full else s - full
        acc[a] = acc[a] + torch.where(mine[:, s, None], yk[:, s].float() * weights[:, s, None].float(), 0.0)
    return (((acc[0] + acc[1]) + acc[2]) + acc[3]).to(out_dtype)


def moe_combine(y: torch.Tensor, weights: torch.Tensor, idx: torch.Tensor, n_experts: int, out_dtype) -> torch.Tensor:
    """The k-combine kernel (csrc/moe_gmm.cu `moe_combine`): y [N k, H]
    token-major (f32 or bf16), weights [N, k] f32, idx [N, k] -> [N, H] in
    out_dtype (f32 or bf16), each token's selections of an id in [0,
    n_experts) summed in f32 in `_combine`'s order on the card (its twin's
    docstring); deterministic (no atomics)."""
    if y.device.type == "cpu":
        return moe_combine_reference(y, weights, idx, n_experts, out_dtype)
    idx = _check_idx(idx)
    n, k = idx.shape
    if y.dim() != 2 or y.shape[0] != n * k or y.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"y must be f32 or bf16 [{n * k}, H], got {y.dtype} {tuple(y.shape)}")
    if weights.shape != (n, k) or weights.dtype != torch.float32:
        raise ValueError(f"weights must be f32 [{n}, {k}], got {weights.dtype} {tuple(weights.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16) or y.shape[1] % _align(y.dtype):
        raise ValueError(f"out_dtype {out_dtype} must be f32 or bf16, H = {y.shape[1]} a multiple of 16 bytes")
    weights = _rows_view(weights)
    cuda_build.require_cuda(y, weights[:1], idx[:1])  # one row each: contiguous at any row stride
    if y.data_ptr() % 16:
        raise ValueError("the combine kernel reads 16-byte aligned rows")
    out = torch.empty(n, y.shape[1], dtype=out_dtype, device=y.device)
    p = cuda_build.ptr
    err = _fn("moe_combine")(p(y), p(weights), weights.stride(0), p(idx), int(idx.dtype == torch.int64),
                             idx.stride(0), p(out), n, k, y.shape[1], n_experts, int(y.dtype == torch.bfloat16),
                             int(out_dtype == torch.bfloat16), cuda_build.stream_of(y))
    cuda_build.check(err, "moe_gmm combine")
    moe_combine.launches += 1
    return out


moe_combine.launches = 0


def _gather_rows(x_flat, assign, slot_valid, k: int) -> torch.Tensor:
    return torch.where(slot_valid[:, None], x_flat.index_select(0, assign // k), 0)


def align_rows(x_flat: torch.Tensor, idx: torch.Tensor, n_experts: int, bm: int = GMM_BM):
    """`aligned_assignments` and the rows of x in their slots. Returns
    (x_al [S, H] with zero pad rows, e_tile [T] int32, tile_valid [T]
    int32, rows [N * k] int64)."""
    assign, slot_valid, e_tile, tile_valid, rows = aligned_assignments(idx, n_experts, bm)
    return _gather_rows(x_flat, assign, slot_valid, idx.shape[1]), e_tile, tile_valid, rows


def _forward_routed(x_flat, experts, weights, idx, lay: RoutedLayout, out_dtype) -> torch.Tensor:
    """The routed chain: D reads x through the slot -> token map, E writes
    each slot's y to its token-major row (rows of id-E selections are not
    written), the combine sums each token's k rows. Four launches with the
    layout's, none between them."""
    act = moe_gmm_swiglu(x_flat, experts["gate"], experts["up"], lay.e_tile, lay.tile_valid, lay.tile_lo, lay.blk_lo,
                         x_rows=lay.x_rows)
    y = torch.empty(idx.numel(), experts["down"].shape[1], dtype=x_flat.dtype, device=x_flat.device)
    moe_gmm_down(act, experts["down"], lay.e_tile, lay.tile_valid, lay.tile_lo, lay.blk_lo, out_rows=lay.y_rows, out=y)
    return moe_combine(y, weights.float(), idx, experts["gate"].shape[0], out_dtype)


def moe_ffn_gmm_reference(x_flat, experts: Dict[str, torch.Tensor], weights, idx, out_dtype=None) -> torch.Tensor:
    """Grouped plain twin: sort by expert, one F.linear chain per non-empty
    group (group sizes read on the host), unsort, f32 combine over k, cast
    to `out_dtype` (x's dtype by default). Assignments to id E (another
    rank's expert) sort last and give zeros."""
    k = idx.shape[1]
    e = experts["gate"].shape[0]
    flat, order, inv = _sort(idx)
    x_sorted = x_flat[order // k]
    sizes = torch.bincount(flat.long(), minlength=e)[:e].tolist()
    y_sorted = torch.zeros(x_sorted.shape[0], experts["down"].shape[1], dtype=x_flat.dtype, device=x_flat.device)
    start = 0
    for ex, size in enumerate(sizes):
        if size:
            xs = x_sorted[start : start + size]
            gate = F.linear(xs, experts["gate"][ex])
            up = F.linear(xs, experts["up"][ex])
            act = F.silu(gate.float()).to(gate.dtype) * up
            y_sorted[start : start + size] = F.linear(act, experts["down"][ex])
        start += size
    return _combine(y_sorted[inv], weights, out_dtype or x_flat.dtype)


class MoeFfnGmm(torch.autograd.Function):
    """The grouped-GEMM MoE FFN with `_moe_ffn_gmm_bwd`'s backward, on the
    aligned layout the forward uses. Saves x, the weights, the routing and
    the layout (integers), no activations: the backward recomputes gate, up
    and y with E, then
    - d_weights = sum_h y * g_rows in f32; dy = round(g_rows * w);
    - dact = S(dy, Wd); the SwiGLU backward in f32; dgate, dup rounded;
    - dx_slots = S(dgate, Wg) + S(dup, Wu) in the working dtype, and each
      token's k slots summed in f32 in selection order (a gather through
      `rows`, no scatter-add);
    - dWg = T(x, dgate), dWu = T(x, dup), dWd = T(act, dy), cast to the
      weights' dtype. idx gets no gradient.
    On CPU tensors every kernel is its twin and the forward is the grouped
    twin `moe_ffn_gmm_reference` (the CPU's forward before the Function
    existed); the layout is built there only when a gradient is wanted.
    Under EP, selections of id E (another rank's experts) take no slot and
    get zero d_weights and no dx; `out_dtype` f32 keeps the combine's sum
    unrounded for the reduction over mp."""

    @staticmethod
    def forward(ctx, x_flat, w_gate, w_up, w_down, weights, idx, out_dtype=None):
        experts = {"gate": w_gate, "up": w_up, "down": w_down}
        out_dtype = out_dtype or x_flat.dtype
        cpu, needs_grad = x_flat.device.type == "cpu", any(ctx.needs_input_grad)
        layout = routed_layout(idx, w_gate.shape[0]) if needs_grad or not cpu else ()
        if needs_grad:
            mine = idx.reshape(-1) < w_gate.shape[0]
            ctx.save_for_backward(x_flat, w_gate, w_up, w_down, weights, *layout[:7], mine)
        if cpu:
            return moe_ffn_gmm_reference(x_flat, experts, weights, idx, out_dtype)
        return _forward_routed(x_flat, experts, weights, idx, layout, out_dtype)

    @staticmethod
    def backward(ctx, g):
        (x_flat, wg, wu, wd, weights, assign, slot_valid, e_tile, tile_valid, rows, tile_lo, blk_lo,
         mine) = ctx.saved_tensors
        n, k = weights.shape
        e = wg.shape[0]
        dt = x_flat.dtype
        valid = slot_valid[:, None]
        x_al = _gather_rows(x_flat, assign, slot_valid, k)
        # The forward's schedule of E and S, and T's tile_lo, for the
        # layer's nine calls.
        # Recompute the pre-activations (kernel E: x W^T for gate and up too).
        gate = moe_gmm_down(x_al, wg, e_tile, tile_valid, tile_lo, blk_lo)
        up = moe_gmm_down(x_al, wu, e_tile, tile_valid, tile_lo, blk_lo)
        gate_f = gate.float()
        sig = torch.sigmoid(gate_f)
        silu_g = gate_f * sig
        act = silu_g.to(dt) * up
        # Combine backward: out[n] = sum_j w[n, j] y[n, j] in f32.
        g_slot = torch.where(valid, g.float().contiguous().index_select(0, assign // k), 0)
        w_slot = weights.reshape(-1).float().index_select(0, assign)
        dy_al = (g_slot * w_slot[:, None]).to(dt)
        y_al = moe_gmm_down(act, wd, e_tile, tile_valid, tile_lo, blk_lo)
        dwt = (y_al.float() * g_slot).sum(1)
        d_weights = torch.where(mine, dwt.index_select(0, rows), 0).reshape(n, k).to(weights.dtype)
        del y_al, g_slot
        # SwiGLU backward in f32: silu'(x) = sig(x) (1 + x (1 - sig(x))).
        dact = moe_gmm_dx(dy_al, wd, e_tile, tile_valid, tile_lo, blk_lo).float()
        dup = (dact * silu_g).to(dt)
        dgate = (dact * up.float() * (sig * (1.0 + gate_f * (1.0 - sig)))).to(dt)
        del dact, sig, silu_g, gate, gate_f, up
        dx_al = (moe_gmm_dx(dgate, wg, e_tile, tile_valid, tile_lo, blk_lo)
                 + moe_gmm_dx(dup, wu, e_tile, tile_valid, tile_lo, blk_lo))
        dx_sel = torch.where(mine[:, None], dx_al.index_select(0, rows), 0)
        dx = dx_sel.reshape(n, k, -1).float().sum(1).to(dt)
        del dx_al
        dwg = moe_gmm_dw(x_al, dgate, e_tile, tile_valid, e, tile_lo).to(wg.dtype)
        dwu = moe_gmm_dw(x_al, dup, e_tile, tile_valid, e, tile_lo).to(wu.dtype)
        dwd = moe_gmm_dw(act, dy_al, e_tile, tile_valid, e, tile_lo).to(wd.dtype)
        return dx, dwg, dwu, dwd, d_weights, None, None


def moe_ffn_gmm(x_flat, experts: Dict[str, torch.Tensor], weights, idx, out_dtype=None) -> torch.Tensor:
    """Exact grouped-GEMM MoE FFN at prefill scale, differentiable in x, the
    experts and the routing weights. Returns [N, H] in `out_dtype` (x's
    dtype by default): on CUDA tensors the routed chain (the layout kernel,
    D, E, the combine kernel; S, T and E in the backward), on the CPU the
    grouped twin (the twins in the backward)."""
    return MoeFfnGmm.apply(x_flat, experts["gate"], experts["up"], experts["down"], weights, idx, out_dtype)


# ---------------------------------------------------------------------------
# Kernel W: the boundary-visit forward


def pick_bm(m: int) -> int:
    """Port of `_pick_bm`: the visit tile height for M sorted rows, 64 from
    2048 rows, else 32. A caller that wants another height passes its own
    `bm`."""
    return 64 if m >= 2048 else 32


def visit_schedule(group_sizes: torch.Tensor, m_pad: int, bm: int):
    """Port of `_visit_schedule`, the same integers. From group sizes [E]
    (sorted-row order), returns (tile [V], expert [V], lo [V], hi [V])
    int32 with V = m_pad / bm + E: visit v covers row tile tile[v] against
    expert expert[v] and owns the sorted rows [lo[v], hi[v]). Unused slots
    point at the last tile with an empty range. On the device, no host
    sync."""
    dev = group_sizes.device
    e = group_sizes.shape[0]
    n_tiles = m_pad // bm
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev), torch.cumsum(group_sizes.long(), 0)])
    starts, ends = offsets[:-1].contiguous(), offsets[1:].contiguous()
    tile_start = torch.arange(n_tiles, device=dev) * bm
    e_first = torch.searchsorted(ends, tile_start, right=True)
    e_last = torch.searchsorted(starts, tile_start + bm) - 1
    count = (e_last - e_first + 1).clamp(min=0)
    cum = torch.cumsum(count, 0)
    v_ids = torch.arange(n_tiles + e, device=dev)
    tile = torch.searchsorted(cum, v_ids, right=True)
    valid = tile < n_tiles
    tile_c = tile.clamp(max=n_tiles - 1)
    rank = v_ids - torch.where(valid, cum[tile_c] - count[tile_c], 0)
    expert = (e_first[tile_c] + rank).clamp(0, e - 1)
    lo = torch.where(valid, torch.maximum(offsets[expert], tile_c * bm), 0)
    hi = torch.where(valid, torch.minimum(offsets[expert + 1], tile_c * bm + bm), 0)
    i32 = torch.int32
    return tile_c.to(i32), expert.to(i32), lo.to(i32), hi.to(i32)


def sorted_rows(x_flat: torch.Tensor, idx: torch.Tensor, n_experts: int, bm: int):
    """The assignments sorted by expert, as the JAX package's `moe_ffn_gmm`
    lays them out for the visit kernels: (x_sorted [m_pad, H], zero past
    the N k real rows; group_sizes [E] int32), m_pad = N k rounded up to
    bm."""
    k = idx.shape[1]
    m = idx.numel()
    m_pad = -(-m // bm) * bm
    flat, order, _ = _sort(idx)
    group_sizes = torch.zeros(n_experts, dtype=torch.int32, device=idx.device)
    group_sizes.scatter_add_(0, flat.long(), torch.ones_like(flat))
    x_sorted = torch.zeros(m_pad, x_flat.shape[1], dtype=x_flat.dtype, device=x_flat.device)
    x_sorted[:m] = x_flat.index_select(0, order // k)
    return x_sorted, group_sizes


def _visit_rows(schedule, bm: int, m_pad: int):
    """[V, bm] destination rows of each visit's tile rows: the row where it
    owns it, m_pad (a discard row) elsewhere."""
    vt, _, lo, hi = (t.long() for t in schedule)
    rows = vt[:, None] * bm + torch.arange(bm, device=vt.device)
    return torch.where((rows >= lo[:, None]) & (rows < hi[:, None]), rows, m_pad)


def _visit_scatter(out_rows: torch.Tensor, schedule, bm: int, m_pad: int) -> torch.Tensor:
    """[V, bm, N] per-visit tile results -> [m_pad, N], each row from the
    visit that owns it, zero where none does."""
    dest = _visit_rows(schedule, bm, m_pad).reshape(-1)
    out = out_rows.new_zeros(m_pad + 1, out_rows.shape[-1])
    out[dest] = out_rows.reshape(dest.shape[0], -1)
    return out[:m_pad]


def _visit_act(x, w_gate, w_up, schedule, bm: int) -> torch.Tensor:
    """[V, bm, I] each visit's tile against its expert's gathered gate/up
    weights at D's rounding points: silu in f32, the product in x's
    dtype."""
    vt, ve = schedule[0].long(), schedule[1].long()
    xt = x[vt[:, None] * bm + torch.arange(bm, device=x.device)]  # [V, bm, H]
    gate = torch.bmm(xt, w_gate[ve].transpose(1, 2))
    up = torch.bmm(xt, w_up[ve].transpose(1, 2))
    return F.silu(gate.float()).to(x.dtype) * up


def gmm_swiglu_visit_reference(x, w_gate, w_up, schedule, bm: int) -> torch.Tensor:
    """Plain twin of W's swiglu mode: each visit's act, each row taken from
    the visit that owns it (zero where none does)."""
    return _visit_scatter(_visit_act(x, w_gate, w_up, schedule, bm), schedule, bm, x.shape[0])


def gmm_ffn_visit_reference(x, w_gate, w_up, w_down, schedule, bm: int) -> torch.Tensor:
    """Plain twin of W's ffn mode: the swiglu twin's act per visit (rounded
    to x's dtype), then round(act Wd^T), each row from the visit that owns
    it (zero where none does)."""
    act = _visit_act(x, w_gate, w_up, schedule, bm)
    y = torch.bmm(act, w_down[schedule[1].long()].transpose(1, 2))
    return _visit_scatter(y, schedule, bm, x.shape[0])


def _check_visits(x, ws, schedule, bm: int, in_dims) -> None:
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16) or any(w.dtype != dt for w in ws):
        raise ValueError(f"kernel W takes x and weights of one dtype, f32 or bf16; got {dt}, "
                         f"{[w.dtype for w in ws]}")
    if len(schedule) != 4 or any(t.dtype != torch.int32 or t.shape != schedule[0].shape for t in schedule):
        raise ValueError("the schedule must be four int32 [V] tensors (tile, expert, lo, hi)")
    if bm <= 0 or bm % GMM_BM or x.dim() != 2 or x.shape[0] % bm:
        raise ValueError(f"kernel W takes bm a multiple of {GMM_BM} and m_pad rows a multiple of bm; "
                         f"got bm {bm}, x {tuple(x.shape)}")
    if any(d % _align(dt) for d in in_dims):
        raise ValueError(f"H and I must be multiples of {_align(dt)}, got {in_dims}")
    if x.device.type != "cpu":
        cuda_build.require_cuda(x, *ws, *schedule)


def _visit_layout(schedule, m_pad: int, n_experts: int) -> RoutedLayout:
    """The routed layout of W's expert-sorted rows: each expert's group size
    is the sum of its visits' [lo, hi), sorted row r takes the id of its
    group (n_experts past the real rows: no slot), and `routed_layout` of
    those ids as one selection a row. Its maps are then the slot ->
    sorted-row map both ways: x_rows and y_rows are the sorted row a slot
    holds, -1 in pad slots. On the device, no host sync."""
    vt, ve, lo, hi = schedule
    sizes = torch.zeros(n_experts, dtype=torch.int32, device=vt.device).scatter_add_(0, ve.long(), hi - lo)
    rows = torch.arange(m_pad, dtype=torch.int32, device=vt.device)
    ids = torch.searchsorted(torch.cumsum(sizes, 0, dtype=torch.int32), rows, right=True)
    return routed_layout(ids[:, None], n_experts)


def gmm_swiglu_visit(x, w_gate, w_up, schedule, bm: int) -> torch.Tensor:
    """Kernel W, swiglu mode: x [m_pad, H] (expert-sorted rows), w_gate /
    w_up [E, I, H], schedule = `visit_schedule(...)` -> act [m_pad, I] in
    x's dtype; rows no visit owns (those past the N k real rows) are zero.
    Runs D on the sorted rows' own aligned layout (`_visit_layout`), loading
    and storing through the slot -> sorted-row map; the twins on the CPU."""
    e, i, h = w_gate.shape
    if w_up.shape != (e, i, h) or x.shape[1] != h:
        raise ValueError(f"x {tuple(x.shape)}, gate {tuple(w_gate.shape)} and up {tuple(w_up.shape)} do not fit")
    _check_visits(x, (w_gate, w_up), schedule, bm, (h, i))
    lay = _visit_layout(schedule, x.shape[0], e)
    act = torch.zeros(x.shape[0], i, dtype=x.dtype, device=x.device)
    moe_gmm_swiglu(x, w_gate, w_up, lay.e_tile, lay.tile_valid, lay.tile_lo, lay.blk_lo, x_rows=lay.x_rows,
                   out_rows=lay.y_rows, out=act)
    gmm_swiglu_visit.launches += 1
    return act


gmm_swiglu_visit.launches = 0


def gmm_ffn_visit(x, w_gate, w_up, w_down, schedule, bm: int) -> torch.Tensor:
    """Kernel W, ffn mode: as `gmm_swiglu_visit` with w_down [E, H, I] ->
    y [m_pad, H] in x's dtype: D loading through the map onto the aligned
    act, then E storing through it."""
    e, i, h = w_gate.shape
    if w_up.shape != (e, i, h) or w_down.shape != (e, h, i) or x.shape[1] != h:
        raise ValueError(f"x {tuple(x.shape)}, gate {tuple(w_gate.shape)}, up {tuple(w_up.shape)} and down "
                         f"{tuple(w_down.shape)} do not fit")
    _check_visits(x, (w_gate, w_up, w_down), schedule, bm, (h, i))
    lay = _visit_layout(schedule, x.shape[0], e)
    act = moe_gmm_swiglu(x, w_gate, w_up, lay.e_tile, lay.tile_valid, lay.tile_lo, lay.blk_lo, x_rows=lay.x_rows)
    y = torch.zeros(x.shape[0], h, dtype=x.dtype, device=x.device)
    moe_gmm_down(act, w_down, lay.e_tile, lay.tile_valid, lay.tile_lo, lay.blk_lo, out_rows=lay.y_rows, out=y)
    gmm_ffn_visit.launches += 1
    return y


gmm_ffn_visit.launches = 0
