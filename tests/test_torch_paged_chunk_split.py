"""Kernels P and Q on G's split-key walk, emulated in torch on the CPU.

csrc/paged_attention.cu runs P (one query a row over an int8 / int8tail
pool) and Q (S = 2..8 queries a row over an f32 / bf16 pool, each at its
own causal budget) as G's `paged_split_kernel`: a row's keys are cut into
chunks of ck = min(U_CHUNK, page) keys that never cross a page end, up to
the row's largest budget; within a chunk two warps of U_WARP_KEYS keys, one
key a lane, each take their own softmax for each query (m = the largest
score, p = exp(s - m), l = sum p, acc = sum p v), merged in the block (warp
0, then warp 1) into the chunk's partial of each query; the last block of
the (row, head) merges each query's partials in ascending chunk order.
- P folds the scales out of its loops: s_j = (scale ks_j) (q . c_j) and
  acc += (p_j vs_j) c_j, where the twin dequantizes first. In tail mode the
  chunks of the row's last page, (len - 1) // page, read the row's bf16
  open page instead, with no scales.
- Q: a query whose budget ends before a warp's (or the chunk's) first key
  has no live key there. Its maximum is -inf, and the softmax subtracts 0
  instead (the guard), so the partial adds exact zeros; a warp with no
  live key of any query copies nothing and adds zeros as well.
The emulation scores every chunk of every block-table entry unless told to
keep to the live ones, so chunks past a row's length go through the merge
too. It is held to:
- the plain twins (`paged_decode_attention_q8_reference`,
  `paged_decode_attention_chunk_reference`) and the JAX package's Pallas
  kernels in interpret mode (`paged_decode_attention_pool_q8`, int8 and
  int8tail, as tests/test_torch_kvq8.py runs it;
  `paged_decode_attention_pool_chunk`, f32 and bf16 pools, as
  tests/test_torch_lookup.py runs it), at ragged lengths with 1 and the
  edges of a warp's, a chunk's and a page's keys, pages of 16, 100 and 128,
  budgets across a page end, S = 2, 4 and 8, and rows on the scratch page
  0;
- itself: query i's output is bit-equal to the one-query walk at its own
  budget (the partials past a query's budget add exact zeros, whatever the
  other queries' budgets), a row's bits do not depend on the other rows,
  and without the guard a query with no live key in a warp makes its
  output NaN.
Tolerances, f32 sums in another order on both sides: Q 1e-6 against its
twin and 2e-6 against the JAX kernel (G's emulation's bounds; a bf16 pool
1e-5 against the JAX kernel, which rounds its bf16 products elsewhere); P
1e-5 against both (the bound of P's twin test: folding the scales rounds
each score once more or less).
The kernels themselves run on the card (tests/test_torch_kernels.py, -m gpu).
"""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops import paged_attention as jpa
from deepseek_ocr2_tpu_torch.ops.paged_attention import (
    U_CHUNK,
    U_WARP_KEYS,
    paged_chunks,
    paged_decode_attention_chunk_reference,
    paged_decode_attention_q8_reference,
)

INF = math.inf
Q_TWIN = dict(rtol=1e-6, atol=1e-6)
Q_JAX = dict(rtol=2e-6, atol=2e-6)
Q_JAX_BF16 = dict(rtol=1e-5, atol=1e-5)
P_TOL = dict(rtol=1e-5, atol=1e-5)


def warp_partials(q, k, v, nq, scale, ks=None, vs=None, guard=True):
    """One warp's softmax for each query, as the kernel's lanes take it: q [S,
    Hh, D]; k, v [Hh, U_WARP_KEYS, D] (values, or int8 codes as f32 with
    their scales ks, vs [Hh, U_WARP_KEYS]); query i sees the warp's first
    nq[i] keys. Each query alone, so its bits do not depend on the others'.
    Returns [(m [Hh], l [Hh], acc [Hh, D])] a query."""
    out = []
    for i in range(q.shape[0]):
        s = torch.einsum("hd,hkd->hk", q[i], k) * (scale * ks if ks is not None else scale)
        s = s.masked_fill(torch.arange(k.shape[1]) >= nq[i], -INF)
        m = s.amax(-1)
        p = torch.exp(s - (torch.where(m == -INF, 0.0, m) if guard else m)[:, None])
        out.append((m, p.sum(-1), torch.einsum("hk,hkd->hd", p * vs if vs is not None else p, v)))
    return out


def merge(parts, guard: bool = True):
    """Partials (m, l, acc) merged in list order; with `guard`, one with
    m = -inf weighs exactly 0."""
    mm = torch.stack([m for m, _, _ in parts]).amax(0)
    l_out, acc_out = torch.zeros_like(mm), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - mm)
        if guard:
            w = torch.where(m == -INF, 0.0, w)
        l_out = l_out + l * w
        acc_out = acc_out + acc * w[..., None]
    return mm, l_out, acc_out


def split_walk(q, fetch, budgets, page, max_pages, *, scale, live_only=False, guard=True):
    """The kernel's walk: q [B, S, Hh, D] f32, budgets [B, S]; fetch(row,
    p, off, span, length) gives the chunk's K / V rows [Hh, span, D] f32 and
    their scales [Hh, span] (or None). For each row, every chunk of every
    block-table entry (or, with `live_only`, the chunks holding a key below
    the row's largest budget) as the two warps' partials merged in the
    block, then each query's chunks merged in ascending order. Returns [B,
    S, Hh, D] f32."""
    b, s_q, hh, d = q.shape
    ck = min(U_CHUNK, page)
    cpp = -(-page // ck)
    assert paged_chunks(page, max_pages) == max_pages * cpp
    out = torch.zeros(b, s_q, hh, d)
    for r in range(b):
        bud = [min(int(x), max_pages * page) for x in budgets[r]]
        length = max(bud)
        if length <= 0:
            continue
        chunks = []
        for c in range(max_pages * cpp):
            p, off = c // cpp, c % cpp * ck
            k0 = p * page + off
            if live_only and k0 >= length:
                continue
            n = max(0, min(ck, page - off, length - k0))  # the chunk's copied keys
            nq = [max(0, min(n, x - k0)) for x in bud]
            k, v = torch.zeros(hh, U_CHUNK, d), torch.zeros(hh, U_CHUNK, d)
            ks = vs = None
            if n:
                kr, vr, ksr, vsr = fetch(r, p, off, n, length)
                k[:, :n], v[:, :n] = kr, vr
                if ksr is not None:
                    ks, vs = torch.zeros(hh, U_CHUNK), torch.zeros(hh, U_CHUNK)
                    ks[:, :n], vs[:, :n] = ksr, vsr
            warps = []
            for w in range(0, U_CHUNK, U_WARP_KEYS):
                sl = slice(w, w + U_WARP_KEYS)
                if n - w <= 0:  # no live key of any query: the warp copies nothing
                    warps.append([(torch.full((hh,), -INF), torch.zeros(hh), torch.zeros(hh, d))] * s_q)
                else:
                    warps.append(warp_partials(q[r], k[:, sl], v[:, sl], [x - w for x in nq], scale,
                                               None if ks is None else ks[:, sl], None if vs is None else vs[:, sl],
                                               guard))
            chunks.append([merge([wp[i] for wp in warps], guard) for i in range(s_q)])
        for i in range(s_q):
            _, l, acc = merge([ch[i] for ch in chunks], guard)
            out[r, i] = acc / l.clamp(min=1e-37)[:, None]
    return out


def pool_fetch(k_pages, v_pages, bt, k_scale=None, v_scale=None, open_k=None, open_v=None):
    """fetch() over one layer [P, Hh, page, D] (codes with scales [P, Hh,
    page], and in tail mode the open pages [B, Hh, page, D] for each row's
    last page)."""
    page = k_pages.shape[2]

    def fetch(r, p, off, span, length):
        if open_k is not None and p == (length - 1) // page:
            return open_k[r, :, off:off + span].float(), open_v[r, :, off:off + span].float(), None, None
        pg = int(bt[r, p])
        rows = slice(off, off + span)
        if k_scale is None:
            return k_pages[pg, :, rows].float(), v_pages[pg, :, rows].float(), None, None
        return k_pages[pg, :, rows].float(), v_pages[pg, :, rows].float(), k_scale[pg, :, rows], v_scale[pg, :, rows]

    return fetch


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _tables(rng, b, max_pages, n_pages, scratch_rows=()):
    """Row-exclusive block tables over pages 1.. (as the engine keeps them);
    finished rows point at the scratch page 0 only."""
    bt = (rng.permutation(n_pages - 1)[: b * max_pages] + 1).reshape(b, max_pages).astype(np.int32)
    for r in scratch_rows:
        bt[r] = 0
    return bt


def _q8_inputs(page, lens, seed, hh=2, d=128, layers=2, scratch_rows=()):
    rng = np.random.default_rng(seed)
    b, max_pages = len(lens), -(-max(lens) // page)
    n_pages = b * max_pages + 1
    codes = [rng.integers(-127, 128, (layers, n_pages, hh, page, d), dtype=np.int8) for _ in range(2)]
    scales = [(rng.random((layers, n_pages, hh, page)) * 0.02 + 1e-3).astype(np.float32) for _ in range(2)]
    opens = [rng.standard_normal((layers, b, hh, page, d)).astype(ml_dtypes.bfloat16) for _ in range(2)]
    q = rng.standard_normal((b, hh, d)).astype(np.float32)
    bt = _tables(rng, b, max_pages, n_pages, scratch_rows)
    return q, codes, scales, opens, bt, np.asarray(lens, np.int32)


def p_walk(q, codes, scales, opens, bt, lens, li, *, tail, scale, **kw):
    t = torch.from_numpy
    fetch = pool_fetch(t(codes[0][li]), t(codes[1][li]), t(bt), t(scales[0][li]), t(scales[1][li]),
                       *((_t(opens[0][li]), _t(opens[1][li])) if tail else ()))
    page = codes[0].shape[3]
    return split_walk(t(q)[:, None], fetch, t(lens)[:, None], page, bt.shape[1], scale=scale, **kw)[:, 0]


P_CASES = [
    (16, [1, 15, 16, 17, 33, 200]),  # one chunk a page of 16
    (128, [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 300]),  # two chunks a page of 128
    (100, [1, 64, 65, 100, 101, 164, 165, 250]),  # chunks of 64 and 36 keys
]


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("page,lens", P_CASES)
def test_p_split_matches_twin_and_jax(page, lens, tail):
    """The last row is finished on the scratch page 0: held to the JAX
    kernel (which, as P, reads its open page for its last page only) but not
    to the twin in tail mode (which patches every page-0 entry)."""
    lens = lens + [40]
    q, codes, scales, opens, bt, seq = _q8_inputs(page, lens, seed=page + tail, scratch_rows=(len(lens) - 1,))
    scale, li = 1.0 / math.sqrt(q.shape[-1]), 1
    got = p_walk(q, codes, scales, opens, bt, seq, li, tail=tail, scale=scale).numpy()
    topen = dict(open_k=_t(opens[0]), open_v=_t(opens[1])) if tail else {}
    twin = paged_decode_attention_q8_reference(*map(torch.from_numpy, (q, *codes, *scales, bt, seq)), li,
                                               scale=scale, **topen).numpy()
    jopen = dict(open_k=jnp.asarray(opens[0]), open_v=jnp.asarray(opens[1])) if tail else {}
    want = np.asarray(jpa.paged_decode_attention_pool_q8(*map(jnp.asarray, (q, *codes, *scales, bt, seq)), li,
                                                         scale=scale, interpret=True, **jopen))
    live = slice(0, -1) if tail else slice(None)
    np.testing.assert_allclose(got[live], twin[live], **P_TOL)
    np.testing.assert_allclose(got, want, **P_TOL)


def _chunk_inputs(page, ends, s, seed, dtype=np.float32, hh=2, d=128, scratch_rows=()):
    """Q's inputs: a 2-layer pool; row r's budgets ends[r] - s + 1 .. ends[r]
    (the last token and its drafts), or a list of s budgets as given."""
    rng = np.random.default_rng(seed)
    lens = np.asarray([e if isinstance(e, list) else list(range(e - s + 1, e + 1)) for e in ends], np.int32)
    b, max_pages = len(ends), -(-int(lens.max()) // page)
    n_pages = b * max_pages + 1
    k_pool, v_pool = (rng.standard_normal((2, n_pages, hh, page, d)).astype(dtype) for _ in range(2))
    q = rng.standard_normal((b, s, hh, d)).astype(np.float32)
    return q, k_pool, v_pool, _tables(rng, b, max_pages, n_pages, scratch_rows), lens


def q_walk(q, k_pool, v_pool, bt, lens, li, *, scale, **kw):
    page = k_pool.shape[3]
    fetch = pool_fetch(_t(k_pool[li]), _t(v_pool[li]), torch.from_numpy(bt))
    return split_walk(torch.from_numpy(q), fetch, torch.from_numpy(lens), page, bt.shape[1], scale=scale, **kw)


Q_CASES = [  # (page, s, row ends): the chunk opens the row, ends at warp / chunk / page edges, crosses a page end
    (16, 2, [2, 16, 17, 33, 100]),
    (16, 8, [8, 16, 18, 23, 40]),
    (128, 4, [4, 32, 33, 64, 66, 127, 130, 300]),
    (128, 8, [8, 35, 64, 70, 129, 135]),
    (100, 4, [4, 65, 67, 100, 102, 165, 250]),
]


@pytest.mark.parametrize("page,s,ends", Q_CASES)
def test_q_split_matches_twin_and_jax(page, s, ends):
    """Plus one row with budgets out of order (any order is the kernel's)
    and a finished row on the scratch page 0."""
    ends = ends + [[3, 70, 34, 1, 66, 2, 65, 64][:s], 20]
    q, k_pool, v_pool, bt, lens = _chunk_inputs(page, ends, s, seed=page + s, scratch_rows=(len(ends) - 1,))
    scale, li = 1.0 / math.sqrt(q.shape[-1]), 1
    got = q_walk(q, k_pool, v_pool, bt, lens, li, scale=scale).numpy()
    twin = paged_decode_attention_chunk_reference(*map(torch.from_numpy, (q, k_pool[li], v_pool[li], bt, lens)),
                                                  scale=scale).numpy()
    want = np.asarray(jpa.paged_decode_attention_pool_chunk(*map(jnp.asarray, (q, k_pool, v_pool, bt, lens)),
                                                            jnp.int32(li), scale=scale, interpret=True))
    np.testing.assert_allclose(got, twin, **Q_TWIN)
    np.testing.assert_allclose(got, want, **Q_JAX)


def test_q_split_bf16_pool_matches_twin_and_jax():
    q, k_pool, v_pool, bt, lens = _chunk_inputs(128, [4, 65, 130, 256], 4, seed=1, dtype=ml_dtypes.bfloat16)
    scale = 1.0 / math.sqrt(q.shape[-1])
    got = q_walk(q, k_pool, v_pool, bt, lens, 0, scale=scale).numpy()
    twin = paged_decode_attention_chunk_reference(torch.from_numpy(q), _t(k_pool[0]), _t(v_pool[0]),
                                                  *map(torch.from_numpy, (bt, lens)), scale=scale).numpy()
    want = np.asarray(jpa.paged_decode_attention_pool_chunk(*map(jnp.asarray, (q, k_pool, v_pool, bt, lens)),
                                                            jnp.int32(0), scale=scale, interpret=True))
    np.testing.assert_allclose(got, twin, **Q_TWIN)
    np.testing.assert_allclose(got, want, **Q_JAX_BF16)


@pytest.mark.parametrize("page,s", [(16, 2), (128, 4), (100, 8)])
def test_q_query_equals_the_one_query_walk_at_its_budget(page, s):
    """Query i of a row, beside queries whose budgets reach further (and
    over every block-table entry, the chunks past the row's length
    included), is bit-equal to the one-query walk over its own live chunks:
    the partials past its budget add exact zeros."""
    ends = [[1, 64, 33, 2, 3, 4, 5, 6][:s], [page - 1, page + 5, 2 * page + 3, 64, 7, 8, 9, 10][:s]]
    q, k_pool, v_pool, bt, lens = _chunk_inputs(page, ends, s, seed=11)
    bt = np.concatenate([bt, bt[:, :2]], axis=1)  # entries past every budget
    scale, li = 0.1, 0
    every = q_walk(q, k_pool, v_pool, bt, lens, li, scale=scale)
    assert torch.isfinite(every).all()
    for i in range(s):
        alone = q_walk(np.ascontiguousarray(q[:, i:i + 1]), k_pool, v_pool, bt, np.ascontiguousarray(lens[:, i:i + 1]),
                       li, scale=scale, live_only=True)
        assert torch.equal(every[:, i], alone[:, 0]), i


@pytest.mark.parametrize("s", [2, 4, 8])
def test_q_without_the_guard_a_query_with_no_live_key_in_a_warp_is_nan(s):
    """Budgets 10 and 60 (and more) of one row: in the chunk of keys 0..63
    the first query has no live key in warp 1, which holds keys of the
    others. With the guard the output is finite; without it that query's
    output is NaN (exp(-inf - -inf)) and the other queries' are not. (The
    live chunk alone: without the guard a chunk past the row's length, whose
    warps copy nothing, would make every query NaN in the merges.)"""
    q, k_pool, v_pool, bt, lens = _chunk_inputs(128, [[10] + [60] * (s - 1)], s, seed=12)
    args = (q, k_pool, v_pool, bt, lens, 1)
    assert torch.isfinite(q_walk(*args, scale=0.1)).all()
    bad = q_walk(*args, scale=0.1, live_only=True, guard=False)
    assert torch.isnan(bad[0, 0]).all() and torch.isfinite(bad[0, 1:]).all()


def test_a_rows_bits_do_not_depend_on_the_other_rows():
    """P in tail mode and Q: row 0 beside other lengths, block tables and
    pages, and alone at B 1, bit-equal: the merges' order depends on the
    row's own budgets and the page size alone."""
    rng = np.random.default_rng(5)
    scale = 0.1
    q, codes, scales, opens, bt, seq = _q8_inputs(128, [300, 1, 700, 65], seed=4)
    first = p_walk(q, codes, scales, opens, bt, seq, 1, tail=True, scale=scale)
    codes2 = [c.copy() for c in codes]
    others = np.setdiff1d(np.arange(codes[0].shape[1]), bt[0])  # pages row 0 does not read
    for c in codes2:
        c[:, others] = rng.integers(-127, 128, c[:, others].shape, dtype=np.int8)
    bt2 = bt.copy()
    bt2[1:] = bt[1:, ::-1]
    seq2 = np.asarray([300, 700, 2, 64], np.int32)
    changed = p_walk(q, codes2, scales, opens, bt2, seq2, 1, tail=True, scale=scale)
    alone = p_walk(q[:1], codes, scales, [o[:, :1] for o in opens], bt[:1, :3], seq[:1], 1, tail=True, scale=scale)
    assert torch.equal(changed[0], first[0]) and torch.equal(alone[0], first[0])

    q, k_pool, v_pool, bt, lens = _chunk_inputs(128, [300, 5, 500, 129], 4, seed=6)
    first = q_walk(q, k_pool, v_pool, bt, lens, 0, scale=scale)
    k2 = k_pool.copy()
    others = np.setdiff1d(np.arange(k2.shape[1]), bt[0])
    k2[:, others] = rng.standard_normal(k2[:, others].shape)
    bt2, lens2 = bt.copy(), lens.copy()
    bt2[1:], lens2[1:] = bt[1:, ::-1], lens[1:, ::-1]
    changed = q_walk(q, k2, v_pool, bt2, lens2, 0, scale=scale)
    alone = q_walk(q[:1], k_pool, v_pool, bt[:1, :3], lens[:1], 0, scale=scale)
    assert torch.equal(changed[0], first[0]) and torch.equal(alone[0], first[0])
