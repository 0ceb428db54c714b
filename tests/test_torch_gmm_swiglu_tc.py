"""Kernel D in bf16 (grouped-GEMM gate/up + SwiGLU on the expert-aligned
layout), its walk emulated in torch on the CPU.

csrc/moe_gmm.cu runs D in bf16 on `gmm_rows_wgmma_kernel` (E's and S's
TMA + wgmma kernel) with two weights:
- a persistent grid walks items (row block, 128 columns of I): a row block
  is up to 4 row tiles (128 rows) of one expert (`row_schedule`,
  `dx_row_blocks`), the row blocks past the experts' zero the invalid tail
  tiles' rows;
- each of the block's two warpgroups multiplies its 64 rows (a warpgroup
  whose rows hold no tile of the expert multiplies nothing) by the
  expert's gate and up slices, K in stages of 64, with f32 sums;
- the epilogue rounds: act = round(round(silu(round(gate))) * round(up)),
  and stores only the expert's tiles, columns clipped at I.
The emulation takes each stage's products in f32 (the order inside a
wgmma step is the hardware's; each product of two bf16 values is exact in
f32) and keeps the stage order, the item map and the epilogue. It is held
to the plain twin `gmm_swiglu_reference` and to the JAX package's
`_gmm_swiglu_kernel_al` (interpret mode) at three routings: every row on
one expert (two row blocks, the second of two tiles), most experts empty,
and a ragged random routing. Tolerance: 4 bf16 ulps of the largest output
(tests/test_torch_kernels.py's bf16 bound: one f32 sum on the other side
of a rounding boundary moves gate or up by an ulp, and the product after
it). The kernel itself runs on the card (tests/test_torch_kernels.py, -m
gpu).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops.moe_gmm import _gmm_aligned_call, _gmm_swiglu_kernel_al
from deepseek_ocr2_tpu_torch.ops import moe_gmm
from deepseek_ocr2_tpu_torch.ops.moe import route

BM, KB = moe_gmm.GMM_BM, 64
E, H, I = 8, 192, 320  # K in three stages of 64; I in 128 + 128 + 64 columns
BF16_RTOL = 4 * 2.0**-8


def epilogue(gate32: torch.Tensor, up32: torch.Tensor) -> torch.Tensor:
    """D's epilogue: round(round(silu(round(gate))) * round(up)) in bf16."""
    g = gate32.bfloat16().float()
    return (F.silu(g).bfloat16().float() * up32.bfloat16().float()).bfloat16()


def walk_emulation(x_al, wg, wu, e_tile, tile_valid):
    """D's persistent walk on the CPU. Returns (act [S, I] bf16, NaN where
    no item wrote; writes [S, I] int32, the times each element was
    written)."""
    n_tiles, e, i = e_tile.shape[0], wg.shape[0], wg.shape[1]
    tile_lo, blk_lo = moe_gmm.row_schedule(e_tile, tile_valid, e)
    blocks = moe_gmm.dx_row_blocks(tile_lo, blk_lo, n_tiles).tolist()
    n_cb = -(-i // moe_gmm.SWIGLU_COLS)
    s_rows = x_al.shape[0]
    a_pad = torch.cat([x_al.float(), torch.zeros(4 * BM, x_al.shape[1])])  # the A box past the end reads zeros
    act = torch.full((s_rows, i), float("nan")).bfloat16()
    writes = torch.zeros(s_rows, i, dtype=torch.int32)
    for item in range(len(blocks) * n_cb):
        b, n0 = item // n_cb, item % n_cb * moe_gmm.SWIGLU_COLS
        ex, t0, t_end = blocks[b]
        cols = slice(n0, min(n0 + moe_gmm.SWIGLU_COLS, i))
        if ex < 0:  # a tail row block: its tiles' rows zeroed
            act[t0 * BM:t_end * BM, cols] = 0
            writes[t0 * BM:t_end * BM, cols] += 1
            continue
        for grp in range(2):  # the two warpgroups, 64 rows each
            first = t0 + 2 * grp
            if first >= t_end:
                continue  # no tile of the expert in its rows: no products, no stores
            a = a_pad[first * BM:first * BM + 64]
            gate = torch.zeros(64, cols.stop - n0)
            up = torch.zeros(64, cols.stop - n0)
            for k0 in range(0, x_al.shape[1], KB):  # the stages, in order
                ks = slice(k0, k0 + KB)
                gate = gate + a[:, ks] @ wg[ex, cols, ks].float().T
                up = up + a[:, ks] @ wu[ex, cols, ks].float().T
            out = epilogue(gate, up)
            for rt in range(2):
                t = first + rt
                if t >= t_end:
                    break
                act[t * BM:(t + 1) * BM, cols] = out[rt * BM:(rt + 1) * BM]
                writes[t * BM:(t + 1) * BM, cols] += 1
    return act, writes


def _case(routing: str, seed: int = 3):
    """bf16 rows, experts and a routing: "one" (170 rows on expert 3: 6
    tiles, two row blocks), "few" (96 x 2 selections on experts 0 and 5,
    the rest empty), "ragged" (75 x 2 from a random f32 router)."""
    rng = np.random.default_rng(seed)
    n, k = {"one": (170, 1), "few": (96, 2), "ragged": (75, 2)}[routing]
    x = torch.from_numpy(rng.standard_normal((n, H)).astype(np.float32)).bfloat16()
    wg, wu = (torch.from_numpy((rng.standard_normal((E, I, H)) * H**-0.5).astype(np.float32)).bfloat16()
              for _ in range(2))
    if routing == "one":
        idx = torch.full((n, 1), 3)
    elif routing == "few":
        idx = torch.stack([torch.zeros(n, dtype=torch.long), torch.full((n,), 5)], 1)
    else:
        _, idx = route(x, torch.from_numpy(rng.standard_normal((E, H)).astype(np.float32)) * H**-0.5, k)
    x_al, e_tile, tile_valid, _ = moe_gmm.align_rows(x, idx, E)
    return x_al, wg, wu, e_tile, tile_valid


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32) if not isinstance(want, torch.Tensor) else want.float().numpy()
    tol = BF16_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol, f"max abs err {err} above {tol}"


@pytest.mark.parametrize("routing", ["one", "few", "ragged"])
def test_walk_matches_twin_and_jax(routing):
    x_al, wg, wu, e_tile, tile_valid = _case(routing)
    act, writes = walk_emulation(x_al, wg, wu, e_tile, tile_valid)
    # Every element written once: the valid tiles by their expert's items,
    # the invalid tail by the tail row blocks, with zeros.
    assert bool((writes == 1).all())
    tail = ~tile_valid.bool().repeat_interleave(BM)
    assert bool(tail.any()) and bool((act[tail] == 0).all())
    _close(act, moe_gmm.gmm_swiglu_reference(x_al, wg, wu, e_tile, tile_valid))
    to_jax = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    with jax.default_matmul_precision("default"):
        want = _gmm_aligned_call(_gmm_swiglu_kernel_al, jnp.asarray(e_tile.numpy()), jnp.asarray(tile_valid.numpy()),
                                 to_jax(x_al), [to_jax(wg.transpose(1, 2)), to_jax(wu.transpose(1, 2))], I, bm=BM,
                                 interpret=True)
    valid = ~tail.numpy()  # the JAX kernel skips the invalid tiles, leaving their rows unwritten
    _close(act[~tail], np.asarray(want.astype(jnp.float32))[valid])


def test_item_map_covers_every_valid_tile_once():
    """The row blocks of `dx_row_blocks` (the kernel's map) hold each valid
    tile in exactly one block of its own expert, at most 4 tiles a block,
    and each invalid tail tile in exactly one tail block; the walk has
    (ceil(T / 4) + E + 1) x ceil(I / 128) items, and the grid is one block
    an SM or one an item."""
    for routing in ("one", "few", "ragged"):
        _, _, _, e_tile, tile_valid = _case(routing)
        n_tiles = e_tile.shape[0]
        tile_lo, blk_lo = moe_gmm.row_schedule(e_tile, tile_valid, E)
        blocks = moe_gmm.dx_row_blocks(tile_lo, blk_lo, n_tiles)
        assert blocks.shape[0] == moe_gmm.dx_grid_rows(n_tiles, E)
        seen = torch.zeros(n_tiles, dtype=torch.int32)
        for ex, first, end in blocks.tolist():
            assert 0 <= end - first <= moe_gmm.DX_TILES
            seen[first:end] += 1
            if ex >= 0:
                assert bool((e_tile[first:end] == ex).all()) and bool(tile_valid[first:end].all())
            else:
                assert not bool(tile_valid[first:end].any())
        assert bool((seen == 1).all())
        n_items = blocks.shape[0] * -(-I // moe_gmm.SWIGLU_COLS)
        assert moe_gmm.swiglu_grid(n_tiles, E, I, 132) == min(132, n_items)


def test_epilogue_keeps_the_rounding_points():
    """The epilogue equals the twin's formula on the same f32 sums (gate
    and up rounded to bf16, silu in f32 rounded, the product rounded), bit
    for bit; leaving out the rounding of gate before silu changes some
    outputs, so the test sees the rounding point."""
    rng = np.random.default_rng(0)
    gate, up = (torch.from_numpy(rng.standard_normal((4096,)).astype(np.float32) * 3) for _ in range(2))
    twin = F.silu(gate.bfloat16().float()).bfloat16() * up.bfloat16()
    assert torch.equal(epilogue(gate, up), twin)
    unrounded = (F.silu(gate).bfloat16().float() * up.bfloat16().float()).bfloat16()
    assert not torch.equal(epilogue(gate, up), unrounded)
