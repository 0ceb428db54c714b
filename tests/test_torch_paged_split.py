"""Kernel G's page-aware split-key decode, emulated in torch on the CPU.

csrc/paged_attention.cu runs G (and X, its per-sequence form) as blocks of
one chunk of one (row, head): a row's keys are cut into chunks of ck =
min(U_CHUNK, page) keys that never cross a page end (ceil(page / ck) a
page, `paged_chunks`), each found through the row's block-table entry.
Within a chunk two warps of U_WARP_KEYS keys, one key a lane, each take
their own softmax (m = the largest score, p = exp(s - m), l = sum p, acc =
sum p v), merged in the block (warp 0, then warp 1) into the chunk's
partial (acc, m, l); the last block of the (row, head) to finish merges the
row's live chunks in ascending chunk order: out = sum_c acc_c e^(m_c - m)
/ max(sum_c l_c e^(m_c - m), 1e-37), m = max_c m_c. A partial that saw no
key has m = -inf and adds exact zeros. The emulation scores every chunk of
every block-table entry, so chunks wholly past a row's length go through
the merge too. It is held to:
- `paged_decode_attention_reference` (the gather twin) and the JAX
  package's `paged_decode_attention_pool` in interpret mode (as
  tests/test_paged_attention.py runs it), at ragged lengths with 1, the
  edges of a warp's, a chunk's and a page's keys, pages of 16, 100 and
  128, rows on the scratch page 0, f32 and a bf16 pool;
- itself: the chunks past a row's length add exact zeros (bit-equal to
  merging the row's live chunks, as the kernel does), and a row's bits do
  not depend on the other rows' lengths, block tables and pages, or on
  running alone.
The kernel itself runs on the card (tests/test_torch_kernels.py, -m gpu).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops.paged_attention import paged_decode_attention_pool as jax_pool
from deepseek_ocr2_tpu_torch.ops.paged_attention import (
    U_CHUNK,
    U_WARP_KEYS,
    paged_chunks,
    paged_decode_attention_reference,
)


def merge(parts, guard: bool = True):
    """Partials (m, l, acc) merged in list order; with `guard`, one with
    m = -inf weighs exactly 0."""
    mm = torch.stack([m for m, _, _ in parts]).amax(0)
    l_out, acc_out = torch.zeros_like(mm), torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        w = torch.exp(m - mm)
        if guard:
            w = torch.where(m == -math.inf, 0.0, w)
        l_out = l_out + l * w
        acc_out = acc_out + acc * w[..., None]
    return mm, l_out, acc_out


def warp_partial(q, k, v, n, scale):
    """One warp's softmax over its first n of U_WARP_KEYS keys ([Hh, 32,
    D] each): (m, l, acc), m = -inf and zeros when n = 0."""
    s = torch.einsum("hd,hkd->hk", q, k) * scale
    s = s.masked_fill(torch.arange(k.shape[1]) >= n, -math.inf)
    m = s.amax(-1)
    p = torch.exp(s - torch.where(m == -math.inf, 0.0, m)[:, None])
    return m, p.sum(-1), torch.einsum("hk,hkd->hd", p, v)


def split_decode(q, k_pages, v_pages, block_tables, seq_lens, *, scale, live_only: bool = False,
                 guard: bool = True):
    """G's walk on one layer [P, Hh, page, D]: for each row, every chunk of
    every block-table entry (or, with `live_only`, the chunks holding a key
    below the row's length) as the two warps' partials merged in the
    block, then the chunks merged in ascending order. Returns [B, Hh, D]
    f32."""
    q, k_pages, v_pages = q.float(), k_pages.float(), v_pages.float()
    b, hh, d = q.shape
    max_pages, page = block_tables.shape[1], k_pages.shape[2]
    ck = min(U_CHUNK, page)
    cpp = -(-page // ck)
    assert paged_chunks(page, max_pages) == max_pages * cpp
    out = []
    for r in range(b):
        length = min(int(seq_lens[r]), max_pages * page)
        parts = []
        for c in range(max_pages * cpp):
            p, off = c // cpp, c % cpp * ck
            if live_only and p * page + off >= length:
                continue
            n = max(0, min(ck, page - off, length - p * page - off))  # the chunk's live keys
            pg = int(block_tables[r, p])
            keys = torch.zeros(hh, U_CHUNK, d), torch.zeros(hh, U_CHUNK, d)
            span = min(ck, page - off)
            keys[0][:, :span], keys[1][:, :span] = k_pages[pg, :, off:off + span], v_pages[pg, :, off:off + span]
            warps = [warp_partial(q[r], keys[0][:, w:w + U_WARP_KEYS], keys[1][:, w:w + U_WARP_KEYS],
                                  max(0, min(U_WARP_KEYS, n - w)), scale) for w in range(0, U_CHUNK, U_WARP_KEYS)]
            parts.append(merge(warps, guard))
        _, l, acc = merge(parts, guard)
        out.append(acc / l.clamp(min=1e-37)[:, None])
    return torch.stack(out)


def _inputs(page, lens, seed, n_pages=24, max_pages=None, hh=4, d=128, layers=2, scratch_rows=()):
    rng = np.random.default_rng(seed)
    b = len(lens)
    max_pages = max_pages or -(-max(lens) // page)
    k_pool, v_pool = (rng.standard_normal((layers, n_pages, hh, page, d)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((b, hh, d)).astype(np.float32)
    bt = rng.integers(1, n_pages, (b, max_pages)).astype(np.int32)
    for r in scratch_rows:  # a finished slot: every entry the scratch page 0
        bt[r] = 0
    return q, k_pool, v_pool, bt, np.asarray(lens, np.int32)


CASES = [
    (16, [1, 15, 16, 17, 33, 64, 200]),  # one chunk a page of 16
    (128, [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 300]),  # two chunks a page of 128
    (100, [1, 64, 65, 100, 101, 164, 165, 250]),  # chunks of 64 and 36 keys
]


@pytest.mark.parametrize("page,lens", CASES)
def test_split_decode_matches_twin_and_jax(page, lens):
    q, k_pool, v_pool, bt, seq = _inputs(page, lens, seed=page, scratch_rows=(1,))
    scale = 1.0 / math.sqrt(q.shape[-1])
    t = torch.from_numpy
    for li in range(k_pool.shape[0]):
        got = split_decode(t(q), t(k_pool[li]), t(v_pool[li]), t(bt), t(seq), scale=scale)
        twin = paged_decode_attention_reference(t(q), t(k_pool[li]), t(v_pool[li]), t(bt), t(seq), scale=scale)
        want = np.asarray(jax_pool(*map(jnp.asarray, (q, k_pool, v_pool, bt, seq)), jnp.int32(li), scale=scale,
                                   interpret=True))
        np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


def test_split_decode_bf16_pool_matches_twin_and_jax():
    q, k_pool, v_pool, bt, seq = _inputs(128, [5, 64, 129, 256], seed=1, n_pages=8)
    kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (k_pool, v_pool))
    tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in (kb, vb))
    scale = 1.0 / math.sqrt(q.shape[-1])
    t = torch.from_numpy
    got = split_decode(t(q), tk[1], tv[1], t(bt), t(seq), scale=scale)
    twin = paged_decode_attention_reference(t(q), tk[1], tv[1], t(bt), t(seq), scale=scale)
    want = np.asarray(jax_pool(jnp.asarray(q), kb, vb, jnp.asarray(bt), jnp.asarray(seq), jnp.int32(1),
                               scale=scale, interpret=True))
    np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("page", [16, 128])
def test_chunks_past_the_length_add_exact_zeros(page):
    """Rows whose block tables reach 512 keys but hold 1, 33, 64, 65 or
    page + 1: the chunks past their length hold no live key. Merged with
    them the output is finite and bit-equal to merging the live chunks
    alone, as the kernel does; without the -inf guard they make it NaN."""
    lens = [1, 33, 64, 65, page + 1]
    q, k_pool, v_pool, bt, seq = _inputs(page, lens, seed=3, max_pages=512 // page)
    args = (*map(torch.from_numpy, (q, k_pool[0], v_pool[0], bt, seq)),)
    every = split_decode(*args, scale=0.1)
    live = split_decode(*args, scale=0.1, live_only=True)
    assert torch.isfinite(every).all() and torch.equal(every, live)
    assert torch.isnan(split_decode(*args, scale=0.1, guard=False)).all()


def test_a_rows_bits_do_not_depend_on_the_other_rows():
    """The same row beside other lengths, block tables and pages, and alone
    at B 1: bit-equal, as the merge's order depends on the row's own length
    and the page size alone."""
    q, k_pool, v_pool, bt, seq = _inputs(128, [300, 1, 1024, 65, 700], seed=4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    first = split_decode(t(q), t(k_pool[1]), t(v_pool[1]), t(bt), t(seq), scale=0.1)
    rng = np.random.default_rng(5)
    k2, v2, bt2 = k_pool.copy(), v_pool.copy(), bt.copy()
    others = np.setdiff1d(np.arange(k2.shape[1]), bt[0])  # pages row 0 does not read
    k2[:, others] = rng.standard_normal(k2[:, others].shape)
    v2[:, others] = rng.standard_normal(v2[:, others].shape)
    bt2[1:] = rng.integers(0, k2.shape[1], bt2[1:].shape)
    seq2 = np.asarray([300, 1024, 1, 64, 2], np.int32)
    changed = split_decode(t(q), t(k2[1]), t(v2[1]), t(bt2), t(seq2), scale=0.1)
    alone = split_decode(t(q[:1]), t(k_pool[1]), t(v_pool[1]), t(bt[:1, :3]), t(seq[:1]), scale=0.1)
    assert torch.equal(changed[0], first[0]) and torch.equal(alone[0], first[0])
