"""The schedules of kernels S, E and T in bf16 (deepseek_ocr2_tpu_torch/ops/moe_gmm.py)
against brute-force Python loops, on the CPU.

S and E (one kernel) multiply row blocks of up to DX_TILES tiles of one
expert: `row_block_lo`
is the prefix the wrapper builds on the device, `dx_row_blocks` the plain
form of the kernel's block map on it (which block takes which tiles, and
which blocks zero the invalid tail). T walks (expert, o block, c block)
work items on a persistent grid: `dw_work_items` is the plain form of its
order, `dw_grid` the grid the wrapper launches. `row_schedule` is the pair
(tile_lo, blk_lo) the wrappers of S and E take. The CUDA kernels run these
maps on the card (tests/test_torch_kernels.py, `gmm_backward`).
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu_torch.ops import moe_gmm
from deepseek_ocr2_tpu_torch.ops.moe import route

BM = moe_gmm.GMM_BM


def _layout(idx: torch.Tensor, n_experts: int):
    """(tile_lo, blk_lo, n_tiles) of the aligned layout of idx [N, k]."""
    _, _, e_tile, tile_valid, _ = moe_gmm.aligned_assignments(idx, n_experts)
    tile_lo = moe_gmm.expert_tile_ranges(e_tile, tile_valid, n_experts)
    return tile_lo, moe_gmm.row_block_lo(tile_lo), e_tile.shape[0]


def _idx_of_sizes(sizes, seed: int = 0) -> torch.Tensor:
    """[sum(sizes), 1] expert ids with these group sizes, tokens shuffled."""
    groups = np.repeat(np.arange(len(sizes)), sizes)
    return torch.from_numpy(np.random.default_rng(seed).permutation(groups))[:, None]


def _real_routing():
    """A training step's MoE layer: B 4 x S 512 = 2048 tokens at the LM's
    H = 1280, top-6 of 64 experts by a random f32 router (12 288 rows)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2048, 1280), dtype=np.float32))
    router = torch.from_numpy(rng.standard_normal((64, 1280), dtype=np.float32) * 1280**-0.5)
    return route(x, router, 6)[1], 64


CASES = {
    "empty experts": (lambda: (_idx_of_sizes([0, 40, 0, 0, 97, 0]), 6)),
    "one expert": (lambda: (_idx_of_sizes([0, 0, 0, 515]), 4)),
    "ragged groups": (lambda: (_idx_of_sizes([32, 128, 160, 33, 0, 97, 1, 64]), 8)),
    "one row": (lambda: (_idx_of_sizes([0, 1]), 2)),
    "real 12 288-row routing": _real_routing,
}


@pytest.mark.parametrize("case", list(CASES))
def test_row_blocks_match_a_loop(case):
    idx, n_experts = CASES[case]()
    tile_lo, blk_lo, n_tiles = _layout(idx, n_experts)
    _, _, e_tile, tile_valid, _ = moe_gmm.aligned_assignments(idx, n_experts)
    assert all(torch.equal(a, b) for a, b in zip(moe_gmm.row_schedule(e_tile, tile_valid, n_experts),
                                                  (tile_lo, blk_lo)))
    lo = tile_lo.tolist()
    # Brute force: each expert's tiles in chunks of DX_TILES, then the
    # invalid tail in chunks; every other grid row does nothing.
    want = []
    for e in range(n_experts):
        assert lo[e + 1] - lo[e] == -(-int((idx == e).sum()) // BM)  # the expert's row tiles
        for t in range(lo[e], lo[e + 1], moe_gmm.DX_TILES):
            want.append((e, t, min(t + moe_gmm.DX_TILES, lo[e + 1])))
        assert blk_lo[e + 1] - blk_lo[e] == -(-(lo[e + 1] - lo[e]) // moe_gmm.DX_TILES)
    assert blk_lo.dtype == torch.int32 and int(blk_lo[0]) == 0 and int(blk_lo[-1]) == len(want)
    for t in range(lo[-1], n_tiles, moe_gmm.DX_TILES):
        want.append((-1, t, min(t + moe_gmm.DX_TILES, n_tiles)))
    rows = moe_gmm.dx_grid_rows(n_tiles, n_experts)
    assert len(want) <= rows  # the static walk covers every block and the whole tail
    # 256-column items: N 896 (S's dact, E's recompute of gate and up) and
    # N 1280 (S's dx, E's down projection), 4 and 5 column blocks.
    for n_cols, n_cb in ((896, 4), (1280, 5), (264, 2), (136, 1)):
        assert moe_gmm.dx_grid(n_tiles, n_experts, n_cols, 132) == min(132, rows * n_cb)
    want += [(-1, n_tiles, n_tiles)] * (rows - len(want))
    got = moe_gmm.dx_row_blocks(tile_lo, blk_lo, n_tiles)
    assert got.tolist() == [list(w) for w in want]
    # Every tile is written by exactly one block, at most DX_TILES * BM rows.
    covered = [t for _, t0, t1 in want for t in range(t0, t1)]
    assert sorted(covered) == list(range(n_tiles))


@pytest.mark.parametrize("n_experts,o,c,n_sms", [
    (64, 896, 1280, 132),  # dW_gate and dW_up of the LM: 2240 items on 132 SMs
    (64, 1280, 896, 132),  # dW_down: 2560 items, the last c block half past C
    (8, 264, 136, 132),  # O and C not multiples of 128: 24 items, fewer than the SMs
    (3, 8, 8, 7),
])
def test_dw_walk_matches_a_loop(n_experts, o, c, n_sms):
    want = [(e, o0, c0) for e in range(n_experts) for o0 in range(0, o, moe_gmm.DW_TILE_O)
            for c0 in range(0, c, moe_gmm.DW_TILE_C)]
    items = moe_gmm.dw_work_items(n_experts, o, c)
    assert items.tolist() == [list(w) for w in want]
    grid = moe_gmm.dw_grid(n_experts, o, c, n_sms)
    assert grid == min(n_sms, len(want))
    # Block k takes items k, k + grid, ...: each item once, and each
    # block's experts in order (the block walks expert-major).
    walks = [want[k::grid] for k in range(grid)]
    assert sorted(w for walk in walks for w in walk) == sorted(want)
    assert all([w[0] for w in walk] == sorted(w[0] for w in walk) for walk in walks)
