"""The routed chain of the prefill MoE FFN (deepseek_ocr2_tpu_torch/ops/moe_gmm.py)
against the JAX package, on the CPU.

On CUDA `moe_ffn_gmm`'s forward is four launches: the layout kernel
(`routed_layout`: a stable counting sort of the flat expert ids, the
expert-aligned slots, D's and E's schedule and row maps), D reading x
through the slot -> token map, E writing each slot's y to its token-major
row, and the k-combine. On CPU tensors each is its plain twin:
- the layout's twin (`routed_layout_reference`) integer for integer against
  the JAX package's own stable `jnp.argsort` + `bincount` +
  `_aligned_layout` (`_moe_ffn_gmm_impl`'s), over routings with an empty
  expert, every row on one expert, N k not a multiple of 32 and id E (an
  expert of another rank under expert parallelism: no slot);
- the kernel's algorithm (32 warps, each a contiguous segment, lanes of
  one bucket ranked by `__match_any_sync`) emulated with numpy, equal to
  the twin;
- the composed twins (D with the map, E with the map, the combine) against
  the JAX package's `moe_ffn_gmm` in interpret mode (its fused
  `_gmm_ffn_kernel_al`). f32 within 1e-5 of the largest output (sums in
  another order); bf16 within 2^-7 of it: both sides round gate, up, act
  and y to bf16 at the same points, an f32 sum on the other side of a
  rounding boundary moves one of them by an ulp (2^-8 relative), and the
  combine adds k such rows;
- W's two modes on their new route (D and E with the slot -> sorted-row map
  of the sorted rows' own aligned layout) against `_gmm_swiglu_call` /
  `_gmm_ffn_call` in interpret mode, under the same bounds.
The kernels run on the card (tests/test_torch_kernels.py, -m gpu).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops import moe_gmm as jgmm
from deepseek_ocr2_tpu_torch.ops import moe_gmm as tgmm

BM = tgmm.GMM_BM


def _ids(case: str, seed: int = 0):
    """(idx [N, k] int64, E) of a routing."""
    rng = np.random.default_rng(seed)
    if case == "empty expert":
        e, idx = 8, np.stack([rng.choice([0, 1, 2, 4, 5, 6, 7], 2, replace=False) for _ in range(45)])
    elif case == "one expert":
        e, idx = 6, np.full((70, 1), 4)
    elif case == "ragged":  # N k = 111, not a multiple of 32
        e, idx = 5, np.stack([rng.choice(5, 3, replace=False) for _ in range(37)])
    elif case == "expert parallel":  # id E: another rank's expert
        e, idx = 8, np.where(rng.random((60, 3)) < 0.4, 8, rng.integers(0, 8, (60, 3)))
    elif case == "all remote":
        e, idx = 4, np.full((20, 2), 4)
    else:  # a router's top-6 of 64 experts
        e, idx = 64, np.argsort(-rng.random((300, 64)), 1)[:, :6]
    return torch.from_numpy(np.asarray(idx, np.int64)), e


CASES = ["empty expert", "one expert", "ragged", "expert parallel", "all remote", "router"]


@functools.partial(jax.jit, static_argnums=1)
def _jax_layout_jit(flat, e: int):
    m = flat.shape[0]
    m_pad = -(-m // BM) * BM
    order = jnp.argsort(flat, stable=True)
    sizes = jnp.bincount(flat, length=e).astype(jnp.int32)  # id E lies past `length`: dropped
    src_slot, slot_valid, slot_of_sorted, e_tile, tile_valid = jgmm._aligned_layout(sizes, m_pad, BM)
    order_pad = jnp.concatenate([order, jnp.zeros((m_pad - m,), order.dtype)])
    assign = jnp.take(order_pad, jnp.clip(src_slot, 0, m_pad - 1))
    rows = jnp.take(slot_of_sorted, jnp.argsort(order, stable=True))
    return assign, slot_valid, e_tile, tile_valid, rows


def _jax_layout(idx: np.ndarray, e: int):
    """The JAX package's integers for idx: its stable sort and
    `_aligned_layout` at the port's tile of 32 rows, composed as the port
    names them (assign, slot_valid, e_tile, tile_valid, rows); jitted."""
    return [np.asarray(a) for a in _jax_layout_jit(jnp.asarray(idx.reshape(-1).astype(np.int32)), e)]


@pytest.mark.parametrize("case", CASES)
def test_layout_twin_matches_jax_integers(case):
    idx, e = _ids(case)
    before = tgmm.routed_layout.launches
    got = tgmm.routed_layout(idx, e)  # CPU tensors: the twin
    assert tgmm.routed_layout.launches == before
    for name, want in zip(("assign", "slot_valid", "e_tile", "tile_valid", "rows"), _jax_layout(idx.numpy(), e)):
        t = getattr(got, name)
        assert t.dtype == {"assign": torch.int64, "rows": torch.int64, "slot_valid": torch.bool}.get(
            name, torch.int32), name
        np.testing.assert_array_equal(t.numpy(), want, err_msg=name)
    # D's and E's maps and the schedule, from the same integers.
    k = idx.shape[1]
    valid = got.slot_valid.numpy()
    np.testing.assert_array_equal(got.x_rows.numpy(), np.where(valid, got.assign.numpy() // k, -1))
    np.testing.assert_array_equal(got.y_rows.numpy(), np.where(valid, got.assign.numpy(), -1))
    assert all(torch.equal(a, b) for a, b in zip((got.tile_lo, got.blk_lo),
                                                  tgmm.row_schedule(got.e_tile, got.tile_valid, e)))
    # Each assignment of a local expert has one slot, and that slot holds it.
    mine = (idx.reshape(-1) < e).numpy()
    rows = got.rows.numpy()
    assert valid[rows[mine]].all() and (got.y_rows.numpy()[rows[mine]] == np.flatnonzero(mine)).all()
    assert valid.sum() == mine.sum()


def _emulate_layout_kernel(idx: np.ndarray, e: int):
    """csrc/moe_gmm.cu `route_layout_kernel`'s sort, step for step: 32 warps,
    warp w walking its contiguous segment 32 lanes a step; pass 1 counts each
    warp's buckets, the scan turns counts into each warp's start within a
    bucket, pass 2 places lane l at start + its rank among the lanes of its
    step with the same bucket (what `__match_any_sync` and `__popc` give).
    Returns (order, rows, group starts)."""
    warps = 32
    k = idx.shape[1]
    flat = idx.reshape(-1)
    m = flat.size
    bucket = np.where((flat >= 0) & (flat < e), flat, e)
    seg = (-(-m // warps) + 31) // 32 * 32
    segments = [(min(w * seg, m), min(min(w * seg, m) + seg, m)) for w in range(warps)]
    hist = np.zeros((warps, e + 1), np.int64)
    for w, (lo, hi) in enumerate(segments):
        for j0 in range(lo, hi, 32):
            np.add.at(hist[w], bucket[j0:min(j0 + 32, hi)], 1)
    within = np.cumsum(hist, 0) - hist  # each warp's start within its buckets
    start = np.concatenate([[0], np.cumsum(hist.sum(0))])
    sizes = hist.sum(0)[:e]
    aligned_end = np.cumsum(-(-sizes // BM) * BM)
    shift = aligned_end - (-(-sizes // BM) * BM) - start[:e]
    order, rows = np.empty(m, np.int64), np.empty(m, np.int64)
    for w, (lo, hi) in enumerate(segments):
        for j0 in range(lo, hi, 32):
            step = bucket[j0:min(j0 + 32, hi)]
            for lane, b in enumerate(step):
                pos = start[b] + within[w, b] + int((step[:lane] == b).sum())
                order[pos] = j0 + lane
                rows[j0 + lane] = pos + shift[min(b, e - 1)]
            np.add.at(within[w], step, 1)
    return order, rows, start


@pytest.mark.parametrize("case", CASES)
def test_layout_kernel_algorithm_matches_twin(case):
    idx, e = _ids(case)
    order, rows, start = _emulate_layout_kernel(idx.numpy(), e)
    flat = idx.reshape(-1).clamp(max=e).to(torch.int32)
    np.testing.assert_array_equal(order, torch.argsort(flat, stable=True).numpy())
    np.testing.assert_array_equal(rows, tgmm.routed_layout_reference(idx, e).rows.numpy())
    assert start[-1] == idx.numel() and start[e] == int((idx < e).sum())


def test_layout_reads_route_views():
    """route's idx is a [N, E][:, :k] slice: the kernel reads its row stride,
    the twin the same values."""
    rng = np.random.default_rng(3)
    full = torch.from_numpy(np.argsort(-rng.random((50, 16)), 1))
    view = full[:, :4]
    assert not view.is_contiguous() and tgmm._rows_view(view) is view
    a, b = tgmm.routed_layout(view, 16), tgmm.routed_layout(view.contiguous(), 16)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _moe_case(seed: int, n: int, e: int, h: int, i: int, k: int, remote: bool = False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h)).astype(np.float32)
    ws = {name: (rng.standard_normal(shape) / np.sqrt(shape[-1])).astype(np.float32)
          for name, shape in (("gate", (e, i, h)), ("up", (e, i, h)), ("down", (e, h, i)))}  # HF [out, in]
    idx = np.stack([rng.choice(e - 1, k, replace=False) for _ in range(n)])  # expert e - 1 gets no row
    if remote:
        idx = np.where(rng.random((n, k)) < 0.3, e, idx)
    weights = rng.uniform(0.1, 0.6, (n, k)).astype(np.float32)
    weights = np.where(idx < e, weights, 0.0).astype(np.float32)
    return x, ws, weights, idx


def _bound(ref: np.ndarray, dtype: str) -> float:
    return (1e-5 if dtype == "float32" else 2.0**-7) * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(70, 2), (1100, 2)])  # JAX bm 32; 2200 rows: bm 64
def test_composed_twins_match_jax_moe_ffn_gmm(dtype, n, k):
    """The chain's twins composed as `_forward_routed` composes the kernels
    (D through x_rows, E through y_rows onto torch.empty, the combine)
    against the JAX `moe_ffn_gmm` in interpret mode; the chain against the
    grouped twin too."""
    e, h, i = 8, 64, 48
    x, ws, weights, idx = _moe_case(n, n, e, h, i, k)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jax.jit(functools.partial(jgmm.moe_ffn_gmm, interpret=True))(
        jnp.asarray(x, jdt), {name: jnp.asarray(w.transpose(0, 2, 1), jdt) for name, w in ws.items()},
        jnp.asarray(weights), jnp.asarray(idx.astype(np.int32))).astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt)
    tws = {name: torch.from_numpy(w).to(tdt) for name, w in ws.items()}
    tidx, tw = torch.from_numpy(idx), torch.from_numpy(weights)
    lay = tgmm.routed_layout(tidx, e)
    got = tgmm._forward_routed(tx, tws, tw, tidx, lay, tdt)
    assert got.dtype == tdt and got.shape == (n, h)
    assert np.abs(got.float().numpy() - want).max() <= _bound(want, dtype)
    grouped = tgmm.moe_ffn_gmm_reference(tx, tws, tw, tidx)
    assert float((got.float() - grouped.float()).abs().max()) <= _bound(grouped.float().numpy(), dtype)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_composed_twins_under_expert_parallelism(out_dtype):
    """Selections of id E take no slot and add nothing; E never writes their
    rows of y (NaN left there stays out of the sum). f32 out keeps the sum
    unrounded, as the mesh's reduction over mp wants it."""
    e, h, i, n, k = 8, 32, 24, 90, 3
    x, ws, weights, idx = _moe_case(5, n, e, h, i, k, remote=True)
    tx = torch.from_numpy(x).bfloat16()
    tws = {name: torch.from_numpy(w).bfloat16() for name, w in ws.items()}
    tidx, tw = torch.from_numpy(idx), torch.from_numpy(weights)
    lay = tgmm.routed_layout(tidx, e)
    act = tgmm.moe_gmm_swiglu(tx, tws["gate"], tws["up"], lay.e_tile, lay.tile_valid, lay.tile_lo, lay.blk_lo,
                              x_rows=lay.x_rows)
    y = torch.full((n * k, h), float("nan"), dtype=torch.bfloat16)
    tgmm.moe_gmm_down(act, tws["down"], lay.e_tile, lay.tile_valid, out_rows=lay.y_rows, out=y)
    remote = (tidx.reshape(-1) == e)
    assert bool(remote.any()) and bool(y[remote].isnan().all()) and not bool(y[~remote].isnan().any())
    got = tgmm.moe_combine(y, tw, tidx, e, out_dtype)
    assert got.dtype == out_dtype and bool(torch.isfinite(got).all())
    ref = tgmm.moe_ffn_gmm_reference(tx, tws, tw, tidx, out_dtype)
    assert float((got.float() - ref.float()).abs().max()) <= _bound(ref.float().numpy(), "bfloat16")


@pytest.mark.parametrize("k", [2, 6, 8])
def test_combine_twin_sums_in_the_torch_combines_card_order(k):
    """The combine's twin is the torch combine's rounding points (f32
    products summed in f32, one cast at the end) in the order its `.sum(1)`
    takes on the card: four running sums, selection s of each whole group of
    four into sum s % 4, the rest into sums 0, 1, 2, added in order. Equal
    to `_combine` within f32 rounding on the CPU, whose sum order is its
    own; selections of id E add nothing."""
    rng = np.random.default_rng(9)
    n, h = 40, 16
    y = torch.from_numpy(rng.standard_normal((n * k, h)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.uniform(0, 1, (n, k)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 8, (n, k)))
    got = tgmm.moe_combine(y, w, idx, 8, torch.float32)
    p = y.reshape(n, k, h).float() * w[:, :, None]
    acc = [torch.zeros(n, h) for _ in range(4)]
    for s in range(k):
        a = s % 4 if s < k // 4 * 4 else s - k // 4 * 4
        acc[a] = acc[a] + p[:, s]
    assert torch.equal(got, ((acc[0] + acc[1]) + acc[2]) + acc[3])
    assert float((got - tgmm._combine(y, w, torch.float32)).abs().max()) <= 1e-6 * float(got.abs().max())
    remote = idx.clone()
    remote[:, 0] = 8
    want = tgmm.moe_combine(y, w.masked_fill(remote == 8, 0.0), idx, 8, torch.float32)
    assert torch.equal(tgmm.moe_combine(y, w, remote, 8, torch.float32), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,e", [(300, 3, 8), (1030, 2, 6)])  # bm 32 with two empty experts; 2060 rows: bm 64
def test_visit_route_matches_jax_visit_kernels(dtype, n, k, e):
    """W's two modes on D and E with the sorted rows' own layout against
    `_gmm_swiglu_call` / `_gmm_ffn_call` in interpret mode, on the first N k
    rows (the rest: written by no visit, zero), and against the visit
    twins; the route's maps are `aligned_layout`'s src_slot both ways."""
    rng = np.random.default_rng(n)
    h, i = 64, 48
    x = rng.standard_normal((n, h)).astype(np.float32)
    wg, wu = ((rng.standard_normal((e, i, h)) / np.sqrt(h)).astype(np.float32) for _ in range(2))
    wd = (rng.standard_normal((e, h, i)) / np.sqrt(i)).astype(np.float32)
    used = [j for j in range(e) if j not in (1, e - 1)]
    idx = np.stack([rng.choice(used, k, replace=False) for _ in range(n)])
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    m, bm = n * k, tgmm.pick_bm(n * k)
    x_sorted, sizes = tgmm.sorted_rows(torch.from_numpy(x).to(tdt), torch.from_numpy(idx), e, bm)
    sched = tgmm.visit_schedule(sizes, x_sorted.shape[0], bm)
    lay = tgmm._visit_layout(sched, x_sorted.shape[0], e)
    src, slot_valid, _, e_tile, tile_valid = tgmm.aligned_layout(sizes, x_sorted.shape[0], BM)
    want_map = torch.where(slot_valid, src, -1)
    assert torch.equal(lay.x_rows, want_map) and torch.equal(lay.y_rows, want_map)
    assert torch.equal(lay.e_tile, e_tile) and torch.equal(lay.tile_valid, tile_valid)
    jsched = tuple(jnp.asarray(t.numpy()) for t in sched)
    jx = jnp.asarray(x_sorted.float().numpy()).astype(jdt)
    jw = [jnp.asarray(w.transpose(0, 2, 1)).astype(jdt) for w in (wg, wu, wd)]
    tw = [torch.from_numpy(w).to(tdt) for w in (wg, wu, wd)]
    cases = (
        (jgmm._gmm_swiglu_call(jsched, jx, *jw[:2], bm=bm, interpret=True),
         tgmm.gmm_swiglu_visit(x_sorted, *tw[:2], sched, bm),
         tgmm.gmm_swiglu_visit_reference(x_sorted, *tw[:2], sched, bm)),
        (jgmm._gmm_ffn_call(jsched, jx, *jw, bm=bm, interpret=True),
         tgmm.gmm_ffn_visit(x_sorted, *tw, sched, bm),
         tgmm.gmm_ffn_visit_reference(x_sorted, *tw, sched, bm)),
    )
    for want, got, twin in cases:
        want = np.asarray(want.astype(jnp.float32))[:m]
        assert np.abs(got.float().numpy()[:m] - want).max() <= _bound(want, dtype)
        assert float((got[:m].float() - twin[:m].float()).abs().max()) <= _bound(want, dtype)
        assert not bool(got[m:].any())
