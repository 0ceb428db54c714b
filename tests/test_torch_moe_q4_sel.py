"""Kernel M's stream (the int4 per-selection decode MoE, bf16 x),
emulated in torch on the CPU.

csrc/moe_q4.cu runs M with bf16 x in two launches (`moe_q4_sel_bf16`):
- the visits are v = b kv + j, kv = k + n_sh: row b's selections in top-k
  order, then its pseudo-experts (weight 1);
- gate/up: units (visit, 8 columns of I) over a persistent grid, each a
  warp's whole dot over H: its 8 gate and 8 up code rows against the
  visit's x row, each 128-level group's f32 dot times the group's scale,
  the groups summed in order; act = bf16(silu(gate) * up), stored at
  `pair_slot` (bits 0 and 1 of the position swapped, the k order of the
  products);
- down, the combine folded in: a block owns 16 columns of H of one row
  over all of the row's visits; per visit y = sum_g s_g (act_g . down_g)
  in group order, times the visit's weight; the row's y w added from 0 in
  visit order and rounded once.
The emulation takes each group's dot in f32 (the order inside an mma step
is the hardware's; each product of a bf16 and a level is exact in f32)
and keeps the rest of the arithmetic in the kernel's order. It is held to
the plain twin `moe_ffn_decode_q4_reference` and to the JAX package's
`moe_ffn_decode_q4` in interpret mode at B 1 with the pseudo-experts and
at B 3 and 8 without; and to itself: a row's bits do not depend on the
other rows. The unit map (gate/up's grid, its warps' turns) and down's
blocks cover every (visit, column) and (row, column of H) once, and act's
storage order agrees with the products' k order. Tolerance: 4 bf16 ulps of
the largest output (tests/test_torch_q4.py's bf16 bound). The kernel
itself runs on the card (tests/test_torch_kernels.py, -m gpu).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops import moe as jmoe
from deepseek_ocr2_tpu.ops import moe_q4 as jmoe_q4
from deepseek_ocr2_tpu_torch.ops import linear_q4, moe_q4

GROUP = 128
SEL_COLS, SEL_WARPS, SD_ROWS = 8, 8, 16  # csrc/moe_q4.cu's unit width, gate/up warps, down's columns a block
BF16_RTOL = 4 * 2.0**-8
H100_SMS = 132
E, H, I, K, N_SH = 16, 256, 256, 2, 2


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _case(b, seed=5):
    """JAX int4 experts (and pseudo-experts) and the port's (`from_jax_q4`:
    the same levels and group scales); bf16 x and routing from a random f32
    router."""
    rng = np.random.default_rng(seed)

    def experts(n):
        return jmoe_q4.quantize_experts_q4({
            "gate": jnp.asarray(rng.standard_normal((n, H, I)).astype(np.float32) * H**-0.5),
            "up": jnp.asarray(rng.standard_normal((n, H, I)).astype(np.float32) * H**-0.5),
            "down": jnp.asarray(rng.standard_normal((n, I, H)).astype(np.float32) * I**-0.5)})

    jeq = experts(E)
    jeq.update({f"pe_{name}": v for name, v in experts(N_SH).items()})
    x = jnp.asarray(rng.standard_normal((b, H)).astype(np.float32)).astype(jnp.bfloat16)
    w, idx = jmoe.route(x.astype(jnp.float32), jnp.asarray(rng.standard_normal((H, E)).astype(np.float32)), K)
    teq = {}
    for pre in ("", "pe_"):
        for name, in_dim in (("gu", H), ("down", I)):
            teq[f"{pre}{name}_q4"], teq[f"{pre}{name}_scale"] = linear_q4.from_jax_q4(
                jeq[f"{pre}{name}_q4"], jeq[f"{pre}{name}_scale"], in_dim)
    return (x, jeq, w, idx), (_t(np.asarray(x)), teq, _t(np.asarray(w)), _t(np.asarray(idx)).long())


def group_dots(a32: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[K] f32 row against [N, K / 2] int4 code rows with [N, K / 128]
    scales, as a warp takes them: group g's dot (a sum of exact products)
    times its scale, the groups summed in order from 0."""
    lv = linear_q4.unpack_q4(codes).float()
    total = torch.zeros(codes.shape[0])
    for grp in range(a32.shape[0] // GROUP):
        ks = slice(GROUP * grp, GROUP * (grp + 1))
        total = total + (a32[None, ks] * lv[:, ks]).sum(-1) * scales[:, grp]
    return total


def silu(v: torch.Tensor) -> torch.Tensor:
    return v / (1.0 + torch.exp(-v))  # the kernel's form


def sel_emulation(x: torch.Tensor, eq, weights: torch.Tensor, idx: torch.Tensor, n_sh: int) -> torch.Tensor:
    """M's stream on the CPU. x [B, H] bf16; returns [B, H] bf16."""
    b_rows, k = idx.shape
    n_exp, i2, _ = eq["gu_q4"].shape
    i = i2 // 2
    kv = k + n_sh
    names = moe_q4._NAMES
    out = torch.empty(b_rows, x.shape[1], dtype=torch.bfloat16)
    for b in range(b_rows):
        x32 = x[b].float()
        yw = []
        for j in range(kv):
            if j < k:
                gu, gus, down, ds = (eq[n][int(idx[b, j])] for n in names)
                wt = weights[b, j].float()
            else:
                gu, gus, down, ds = (eq[f"pe_{n}"][j - k] for n in names)
                wt = torch.tensor(1.0)
            # gate/up: units of 8 columns, each column's gate and up a whole dot over H.
            act = torch.empty(i)
            for i0 in range(0, i, SEL_COLS):
                rows = slice(i0, i0 + SEL_COLS)
                gate = group_dots(x32, gu[rows], gus[rows])
                up = group_dots(x32, gu[i:][rows], gus[i:][rows])
                act[rows] = (silu(gate) * up).bfloat16().float()
            # down: 16 columns of H a block, y times the visit's weight.
            y = torch.cat([group_dots(act, down[h0:h0 + SD_ROWS], ds[h0:h0 + SD_ROWS])
                           for h0 in range(0, x.shape[1], SD_ROWS)])
            yw.append(y * wt)
        o = torch.zeros(x.shape[1])
        for v in yw:  # the row's visits in order, from 0
            o = o + v
        out[b] = o.bfloat16()
    return out


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32)) if not isinstance(want, torch.Tensor) else want.float().numpy()
    tol = BF16_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol, f"max abs err {err} above {tol}"


@pytest.mark.parametrize("b,with_shared", [(1, True), (3, False), (8, False)])
def test_stream_matches_twin_and_jax(b, with_shared):
    (jx, jeq, jw, jidx), (x, eq, w, idx) = _case(b)
    n_sh = N_SH if with_shared else 0
    assert b * K <= E  # M's side of the cut-over
    assert moe_q4.q4_sel_takes(x, eq, K + n_sh)
    got = sel_emulation(x, eq, w, idx, n_sh)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _close(got, moe_q4.moe_ffn_decode_q4_reference(x, eq, w, idx, with_shared=with_shared))
    _close(got, jmoe_q4.moe_ffn_decode_q4(jx, jeq, jw, jidx, with_shared=with_shared, interpret=True))


def test_row_does_not_depend_on_the_other_rows():
    """Row 0 beside other rows of other values and routing, and alone,
    bit-equal."""
    _, (x, eq, w, idx) = _case(8)
    x2, w2, idx2 = x.clone(), w.clone(), idx.clone()
    x2[1:] = x[1:].flip(0)
    idx2[1:] = (idx[1:] + 3) % E
    w2[1:] = w[1:].flip(1)
    first = sel_emulation(x, eq, w, idx, 0)
    assert torch.equal(sel_emulation(x2, eq, w2, idx2, 0)[0], first[0])
    assert torch.equal(sel_emulation(x[:1], eq, w[:1], idx[:1], 0)[0], first[0])


@pytest.mark.parametrize("b,kv", [(1, 8), (8, 6), (10, 6), (3, 1), (16, 6)])
def test_units_and_down_blocks_cover_everything_once(b, kv):
    """At the LM's widths (H 1280, I 896): gate/up's grid of min(units,
    SMs) blocks, block g taking units g, g + G, ... and its warp w the
    block's j-th units with j = w mod 8, covers every (visit, 8 columns)
    unit once; down's (H / 16, B) blocks cover every (row, column of H)
    once; the shapes are the stream's."""
    h, i = 1280, 896
    n_units = b * kv * (i // SEL_COLS)
    grid = min(n_units, H100_SMS)
    seen = np.zeros(n_units, np.int32)
    for blk in range(grid):
        units = list(range(blk, n_units, grid))
        for w in range(SEL_WARPS):
            for u in units[w::SEL_WARPS]:
                seen[u] += 1
    assert (seen == 1).all()
    cols = np.zeros((b, h), np.int32)
    for tile in range(h // SD_ROWS):
        for row in range(b):
            cols[row, tile * SD_ROWS:(tile + 1) * SD_ROWS] += 1
    assert (cols == 1).all()
    x = torch.zeros(b, h, dtype=torch.bfloat16)
    eq = {"gu_q4": torch.zeros(64, 2 * i, h // 2, dtype=torch.uint8)}
    assert moe_q4.q4_sel_takes(x, eq, kv) and not moe_q4.q4_sel_takes(x.float(), eq, kv)
    # 17 rows leave gate/up no room for 8 stages beside x: the first form.
    assert not moe_q4.q4_sel_takes(torch.zeros(17, h, dtype=torch.bfloat16), eq, kv)


def pair_slot(i: int) -> int:
    """csrc/moe_q4.cu's pair_slot: where logical column i of an act or x row
    lies."""
    return (i & ~3) | ((i & 1) << 1) | ((i >> 1) & 1)


def test_act_storage_matches_the_products_k_order():
    """stream_item_mma (csrc/linear_q4.cuh) takes lane q's 32 levels of a
    group, word t's nibbles as k16 pairs (0, 2), (1, 3), (4, 6), (5, 7) of
    its 8, against 8 values of its row read at 32 q + 8 t: the value at
    slot s must be logical k pair_slot(s), a permutation within each 4.
    The gate/up epilogue writes column i at pair_slot(i), so down reads
    act in the order its codes decode."""
    slots = [pair_slot(i) for i in range(2 * GROUP)]
    assert sorted(slots) == list(range(2 * GROUP))
    assert all(pair_slot(pair_slot(i)) == i for i in range(2 * GROUP))  # an involution: write and read agree
    # the 8 values at slots 0..7 of a chunk hold logical 0 2 1 3 4 6 5 7:
    # words (0, 2), (1, 3), (4, 6), (5, 7), the pairs the code words decode to
    assert [pair_slot(s) for s in range(8)] == [0, 2, 1, 3, 4, 6, 5, 7]
