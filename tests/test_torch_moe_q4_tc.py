"""Kernel N's stream (int4 distinct-expert batched-decode MoE, bf16 x),
emulated in torch on the CPU.

csrc/moe_q4.cu runs N with bf16 x on kernel J's bulk-copy tensor-core
design over int4 codes (`moe_q4_stream_bf16`):
- the visits are the valid routed ones in ascending expert id, then the
  n_sh pseudo-experts;
- gate/up: a consumer warp for each 128-level group of H, codes decoded to
  bf16 (exact), products on mma.sync with f32 sums; each warp's tile is its
  group's dot times the group's scale, the warps' tiles summed in warp
  (group) order, act = bf16(silu(gate) * up);
- down: the visits cut into parts at fixed ids (routed expert e id e,
  pseudo-expert t id E + t; part p the ids [NI p / P, NI (p + 1) / P)); in
  a part, every decode row's y = sum_g s_g (act_g . down_g) (group order)
  times the visit's weight (0 for a row that did not select it, 1 for a
  pseudo-expert) added visit after visit in ascending id; out = bf16(the
  parts' sums added in part order).
The emulation takes each group's dot in f32 (the order inside an mma step is
the hardware's; each product of a bf16 and a level is exact in f32) and
keeps the rest of the arithmetic in the kernel's order. It is held to the
plain twin `moe_ffn_decode_q4_visits_reference` and to the JAX package's
`moe_ffn_decode_q4_fused` in interpret mode at B 11, 16 and 40 (the kernel's
groups of 32 rows compute each row alike), with and without the
pseudo-experts, at the parts an H100 (132 SMs) gives, at one part and at
three; and to itself: a row's bits do not depend on the other rows. Also
exact, exhaustively: the decode of every byte's two levels to bf16 (into
the mantissa of bf16 128, then 136 off), and the k order inside a group (k16
step (c, s) of lane t: logical k (2t, 2t + 1) at the physical 32 t + 8 c + 4
s + (0, 2), (2t + 8, 2t + 9) at + (1, 3)) is a permutation, with x's and
act's fragment order and act's storage order agreeing with it.
Tolerance: 4 bf16 ulps of the largest output (tests/test_torch_q4.py's bf16
bound). The kernel itself runs on the card (tests/test_torch_kernels.py,
-m gpu).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops import moe as jmoe
from deepseek_ocr2_tpu.ops import moe_q4 as jmoe_q4
from deepseek_ocr2_tpu_torch.ops import linear_q4, moe_decode, moe_q4

GROUP = 128
BF16_RTOL = 4 * 2.0**-8
H100_SMS = 132


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _case(b, *, n_sh, e=8, h=256, i=256, k=2, seed=4):
    """JAX int4 experts and the port's (`from_jax_q4`: the same levels and
    group scales); bf16 x and routing from a random f32 router."""
    rng = np.random.default_rng(seed)

    def experts(n):
        return jmoe_q4.quantize_experts_q4({
            "gate": jnp.asarray(rng.standard_normal((n, h, i)).astype(np.float32) * h**-0.5),
            "up": jnp.asarray(rng.standard_normal((n, h, i)).astype(np.float32) * h**-0.5),
            "down": jnp.asarray(rng.standard_normal((n, i, h)).astype(np.float32) * i**-0.5)})

    jeq = experts(e)
    if n_sh:
        jeq.update({f"pe_{name}": v for name, v in experts(n_sh).items()})
    x = jnp.asarray(rng.standard_normal((b, h)).astype(np.float32)).astype(jnp.bfloat16)
    w, idx = jmoe.route(x.astype(jnp.float32), jnp.asarray(rng.standard_normal((h, e)).astype(np.float32)), k)
    teq = {}
    for pre in ("", "pe_") if n_sh else ("",):
        for name, in_dim in (("gu", h), ("down", i)):
            teq[f"{pre}{name}_q4"], teq[f"{pre}{name}_scale"] = linear_q4.from_jax_q4(
                jeq[f"{pre}{name}_q4"], jeq[f"{pre}{name}_scale"], in_dim)
    return (x, jeq, w, idx), (_t(np.asarray(x)), teq, _t(np.asarray(w)), _t(np.asarray(idx)).long())


def group_dots(a32: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[B, K] f32 rows against [N, K / 2] int4 code rows with [N, K / 128]
    scales, as the kernel's warps take them: group g's dot [B, N] (each a
    sum of exact products) times its scales, the groups summed in order
    from 0. Row by row, so that a row's bits depend on its own values
    alone."""
    lv = linear_q4.unpack_q4(codes).float()
    total = torch.zeros(a32.shape[0], codes.shape[0])
    for grp in range(a32.shape[1] // GROUP):
        ks = slice(GROUP * grp, GROUP * (grp + 1))
        total = total + (a32[:, None, ks] * lv[None, :, ks]).sum(-1) * scales[:, grp]
    return total


def silu(v: torch.Tensor) -> torch.Tensor:
    return v / (1.0 + torch.exp(-v))  # the kernel's form


def stream_emulation(x: torch.Tensor, eq, weights: torch.Tensor, idx: torch.Tensor, parts=None) -> torch.Tensor:
    """N's stream on the CPU, down cut into `parts` parts (by default the
    H100's, `moe_q4.down_split`). x [B, H] bf16; returns [B, H] bf16."""
    e, i2, _ = eq["gu_q4"].shape
    i, h = i2 // 2, x.shape[1]
    n_sh = eq["pe_gu_q4"].shape[0] if "pe_gu_q4" in eq else 0
    if parts is None:
        parts = moe_q4.down_split(h, e + n_sh, H100_SMS)[1]
    ve, valid = moe_decode.distinct_schedule(idx, e)
    w_visit = moe_decode.combine_table(idx, weights, ve, valid, e)
    # (id, weights or None for 1, the expert's streams), ascending id.
    visits = [(ex, w_visit[v], [eq[n][ex] for n in moe_q4._NAMES]) for v, ex in enumerate(ve.tolist()) if valid[v]]
    visits += [(e + t, None, [eq[f"pe_{n}"][t] for n in moe_q4._NAMES]) for t in range(n_sh)]
    x32 = x.float()
    out = torch.zeros(x.shape[0], h)
    for lo, hi in moe_q4.part_bounds(e + n_sh, parts):
        part = torch.zeros(x.shape[0], h)
        for vid, wv, (gu, gus, down, ds) in visits:
            if not lo <= vid < hi:
                continue
            g2 = group_dots(x32, gu, gus)
            act = (silu(g2[:, :i]) * g2[:, i:]).to(torch.bfloat16).float()
            y = group_dots(act, down, ds)
            part = part + (y if wv is None else y * wv[:, None])
        out = out + part
    return out.to(torch.bfloat16)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32)) if not isinstance(want, torch.Tensor) else want.float().numpy()
    tol = BF16_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol, f"max abs err {err} above {tol}"


@pytest.mark.parametrize("n_sh", [0, 2])
@pytest.mark.parametrize("b", [11, 16, 40])
def test_stream_matches_twin_and_jax(b, n_sh):
    (jx, jeq, jw, jidx), (x, eq, w, idx) = _case(b, n_sh=n_sh)
    assert b * idx.shape[1] > eq["gu_q4"].shape[0]  # N's side of the cut-over
    assert moe_q4.q4_stream_takes(x, eq)
    got = stream_emulation(x, eq, w, idx)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    twin = moe_q4.moe_ffn_decode_q4_visits_reference(x, eq, w, idx)
    _close(got, twin)
    _close(got, jmoe_q4.moe_ffn_decode_q4_fused(jx, jeq, jw, jidx, interpret=True))
    for parts in (1, 3):
        _close(stream_emulation(x, eq, w, idx, parts=parts), twin)


def test_stream_row_does_not_depend_on_the_other_rows():
    """Row 0 beside other rows of other values and routing (other visits,
    where row 0 adds y * 0), and alone, bit-equal, at the H100's parts and
    at three."""
    _, (x, eq, w, idx) = _case(16, n_sh=2)
    x2, w2, idx2 = x.clone(), w.clone(), idx.clone()
    x2[1:] = x[1:].flip(0)
    idx2[1:] = (idx[1:] + 3) % eq["gu_q4"].shape[0]
    w2[1:] = w[1:].flip(1)
    for parts in (None, 3):
        first = stream_emulation(x, eq, w, idx, parts=parts)
        assert torch.equal(stream_emulation(x2, eq, w2, idx2, parts=parts)[0], first[0])
        assert torch.equal(stream_emulation(x[:1], eq, w[:1], idx[:1], parts=parts)[0], first[0])


def test_down_parts_cover_every_id_once_and_do_not_depend_on_b():
    """The parts' id ranges tile [0, E + n_sh) in ascending order; their
    count and down's tile width follow H, the ids and the SMs alone (at the
    LM's shape: 10 warps, 80 columns, 16 tiles, 8 parts)."""
    assert moe_q4.down_split(1280, 66, H100_SMS) == (10, 8)
    for n_ids, parts in ((66, 8), (10, 10), (10, 3), (7, 1)):
        bounds = moe_q4.part_bounds(n_ids, parts)
        assert [lo for lo, _ in bounds] == [0] + [hi for _, hi in bounds[:-1]] and bounds[-1][1] == n_ids
        assert all(hi > lo for lo, hi in bounds)


def _bf16_bits(u16: np.ndarray) -> np.ndarray:
    return (u16.astype(np.uint32) << 16).view(np.float32)


def decode_pairs(u: np.ndarray) -> np.ndarray:
    """csrc/moe_q4.cu's decode_pairs on uint32 words: [..., 4 pairs, 2 halves]
    f32, pair j = (byte-permuted next to 0x43, as bf16) - 136 in bf16
    (exact here: checked against the f32 difference below)."""
    lo, hi = u & 0x0F0F0F0F, (u >> 4) & 0x0F0F0F0F

    def perm(v, sel):  # __byte_perm(v, 0x43434343, sel): bytes (v.b0 | 0x43 .. ) per selector
        b = [(v >> (8 * k)) & 0xFF for k in range(4)] + [np.full_like(v, 0x43)] * 4
        out = np.zeros_like(v)
        for k in range(4):
            out |= b[(sel >> (4 * k)) & 0xF] << (8 * k)
        return out

    pairs = [perm(lo, 0x4140), perm(hi, 0x4140), perm(lo, 0x4342), perm(hi, 0x4342)]
    halves = np.stack([np.stack([_bf16_bits(p & 0xFFFF), _bf16_bits(p >> 16)], -1) for p in pairs], -2)
    diff = halves - np.float32(136.0)
    assert np.array_equal(diff.astype(ml_dtypes.bfloat16).astype(np.float32), diff)  # representable: the bf16 sub is exact
    return diff


def test_nibble_decode_is_exact_for_every_byte():
    """Every byte value at each of a word's 4 places: its low nibble is
    level 2j (code - 8) and its high nibble level 2j + 1, and decode_pairs
    gives pair 0 = (n0, n2), 1 = (n1, n3), 2 = (n4, n6), 3 = (n5, n7)."""
    byte = np.arange(256, dtype=np.uint32)
    for place in range(4):
        u = (byte << (8 * place)) | (np.uint32(0x88888888) & ~np.uint32(0xFF << (8 * place)))
        levels = np.stack([((u >> (4 * n)) & 0xF).astype(np.float32) - 8 for n in range(8)], -1)
        want = levels[:, [[0, 2], [1, 3], [4, 6], [5, 7]]]
        assert np.array_equal(decode_pairs(u), want)
    # and the port's packing: byte j holds input rows 2j (low) and 2j + 1 (high)
    codes = torch.from_numpy(np.arange(256, dtype=np.uint8)[None])
    lv = linear_q4.unpack_q4(codes)[0].numpy()
    assert np.array_equal(lv[0::2], (np.arange(256) & 0xF) - 8) and np.array_equal(lv[1::2], (np.arange(256) >> 4) - 8)


def act_index(i: int) -> int:
    """csrc/moe_q4.cu's act_index: where logical column i of an act row lies."""
    r = i % GROUP
    t, c, e = r // 32, (r % 32) // 8, r % 8
    return i - r + 32 * c + 8 * t + ((e & 4) | ((e & 1) << 1) | ((e >> 1) & 1))


def test_group_k_order_is_a_permutation_and_the_fragments_agree():
    """Lane t's 16 code bytes hold a group's physical k 32 t .. 32 t + 31
    (word c: 32 t + 8 c + n for nibble n). k16 step (c, s) takes logical (2t,
    2t + 1) at physical 32 t + 8 c + 4 s + (0, 2) and (2t + 8, 2t + 9) at +
    (1, 3): within a step a permutation of its 16 logical k, over the 8 steps
    every physical k once. x's chunks in fragment order (bits 0 and 1 of a
    position swapped) and act's storage (act_index, chunk (c, t) at 32 c + 8
    t) put the same physical k in the A registers: word 2 s of chunk c =
    logical (2t, 2t + 1), word 2 s + 1 = (2t + 8, 2t + 9)."""
    physical = []
    for c in range(4):
        for s in range(2):
            logical = []
            for t in range(4):
                base = 32 * t + 8 * c + 4 * s
                logical += [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]
                physical += [base + 0, base + 2, base + 1, base + 3]
            assert sorted(logical) == list(range(16))
    assert sorted(physical) == list(range(GROUP))
    frag = [(p & 4) | ((p & 1) << 1) | ((p >> 1) & 1) for p in range(8)]  # frag_order: stored slot of position p
    stored = [frag.index(j) for j in range(8)]  # the position at slot j
    assert stored == [0, 2, 1, 3, 4, 6, 5, 7]
    # word j of a chunk in fragment order holds positions stored[2j], stored[2j + 1]: decode_pairs' pair j
    assert [stored[2 * j:2 * j + 2] for j in range(4)] == [[0, 2], [1, 3], [4, 6], [5, 7]]
    slots = [act_index(i) for i in range(2 * GROUP)]
    assert sorted(slots) == list(range(2 * GROUP))
    for i in range(2 * GROUP):
        r = i % GROUP
        t, c, e = r // 32, (r % 32) // 8, r % 8
        assert act_index(i) == i - r + 32 * c + 8 * t + frag[e]
