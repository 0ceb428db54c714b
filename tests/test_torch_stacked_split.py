"""Kernel U's split-key decode, emulated in torch on the CPU.

csrc/paged_attention.cu runs U as blocks of U_CHUNK (64) keys of one (row,
head): two warps of U_WARP_KEYS (32) keys, one key a lane, each with its
own softmax over its keys (m = the largest score, p = exp(s - m), l = sum p,
acc = sum p v), merged in the block (warp 0, then warp 1) into a partial
(acc, m, l) a chunk; a second pass merges a row's ceil(len / 64) partials
in ascending chunk order: out = sum_c acc_c e^(m_c - m) / max(sum_c l_c
e^(m_c - m), 1e-37), m = max_c m_c. A partial that saw no key has m =
-inf and adds exact zeros. The emulation scores every chunk of every row
up to cap, so a chunk wholly past a row's length goes through the merge
too. It is held to:
- `decode_attention_stacked_reference` (masked full rows, exact softmax)
  and the JAX package's `decode_attention_stacked` in interpret mode (as
  tests/test_stacked_attention.py runs it), at ragged lengths with 1, the
  edges of the warps' and chunks' keys, and cap (1024 and 1280), f32 and a
  bf16 cache;
- itself: a chunk wholly past a row's length adds exact zeros (no NaN,
  bit-equal to merging only the row's own chunks), and a row's bits do not
  depend on the other rows' lengths and K/V, or on running alone;
and the merge without the -inf guard turns such a chunk into NaN, which
shows the test can see it. The kernel itself runs on the card
(tests/test_torch_kernels.py, -m gpu).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops.paged_attention import decode_attention_stacked as jax_stacked
from deepseek_ocr2_tpu_torch.ops.paged_attention import U_CHUNK, U_WARP_KEYS, decode_attention_stacked_reference


def merge(m, l, acc, guard: bool = True):
    """Partials along dim -1 of m, l ([..., n]) and dim -2 of acc ([..., n,
    D]) merged in ascending order; with `guard`, one with m = -inf weighs
    exactly 0."""
    mm = m.amax(-1)
    w = torch.exp(m - mm[..., None])
    if guard:
        w = torch.where(m == -math.inf, 0.0, w)
    l_out, acc_out = torch.zeros_like(mm), torch.zeros_like(acc[..., 0, :])
    for c in range(m.shape[-1]):
        l_out = l_out + l[..., c] * w[..., c]
        acc_out = acc_out + acc[..., c, :] * w[..., c, None]
    return mm, l_out, acc_out


def split_decode(q, k_all, v_all, layer, seq_lens, *, scale, guard: bool = True, n_chunks=None):
    """U's walk: per (row, head) the warps' 32-key softmaxes, merged in
    pairs into 64-key chunk partials, merged over the first `n_chunks`
    chunks (all of them, up to cap, by default). Returns [B, Hh, D] f32."""
    k, v = k_all[layer].float(), v_all[layer].float()
    b, hh, cap, d = k.shape
    n_w = -(-cap // U_CHUNK) * (U_CHUNK // U_WARP_KEYS)
    pad = n_w * U_WARP_KEYS - cap
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    s = (q.float()[:, :, None, :] * k).sum(-1) * scale  # [B, Hh, keys]: per key, whatever the other rows
    live = torch.arange(n_w * U_WARP_KEYS)[None, None, :] < seq_lens.long().clamp(max=cap)[:, None, None]
    s = s.masked_fill(~live, -math.inf).reshape(b, hh, n_w, U_WARP_KEYS)
    m = s.amax(-1)  # -inf for a warp with no live key
    p = torch.exp(s - torch.where(m == -math.inf, 0.0, m)[..., None])
    l, acc = p.sum(-1), torch.einsum("bhwk,bhwkd->bhwd", p, v.reshape(b, hh, n_w, U_WARP_KEYS, d))
    pair = U_CHUNK // U_WARP_KEYS
    m, l, acc = merge(m.reshape(b, hh, -1, pair), l.reshape(b, hh, -1, pair),
                      acc.reshape(b, hh, -1, pair, d), guard)  # the chunks' partials
    n = m.shape[-1] if n_chunks is None else n_chunks
    _, l, acc = merge(m[..., :n], l[..., :n], acc[..., :n, :], guard)
    return acc / l.clamp(min=1e-37)[..., None]


def _inputs(cap, lens, seed, b=None, hh=4, d=128, layers=2):
    rng = np.random.default_rng(seed)
    b = len(lens) if b is None else b
    k_all, v_all = (rng.standard_normal((layers, b, hh, cap, d)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((b, hh, d)).astype(np.float32)
    return q, k_all, v_all, np.asarray(lens, np.int32)


EDGES_1024 = [1, 31, 32, 33, 63, 64, 65, 129, 1000, 1023, 1024]


@pytest.mark.parametrize("cap,lens", [(64, [1, 7, 33, 64, 40]), (1024, EDGES_1024)])
def test_split_decode_matches_twin_and_jax(cap, lens):
    q, k_all, v_all, seq = _inputs(cap, lens, seed=cap)
    scale = 1.0 / math.sqrt(q.shape[-1])
    for li in range(k_all.shape[0]):
        got = split_decode(*map(torch.from_numpy, (q, k_all, v_all)), li, torch.from_numpy(seq), scale=scale)
        twin = decode_attention_stacked_reference(*map(torch.from_numpy, (q, k_all, v_all)), li,
                                                  torch.from_numpy(seq), scale=scale)
        want = np.asarray(jax_stacked(*map(jnp.asarray, (q, k_all, v_all)), li, jnp.asarray(seq), scale=scale,
                                      interpret=True))
        np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_split_decode_bf16_cache_matches_twin_and_jax():
    q, k_all, v_all, seq = _inputs(128, [5, 64, 100, 128], seed=1, d=64)
    kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (k_all, v_all))
    tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16) for a in (kb, vb))
    scale = 1.0 / 8.0
    got = split_decode(torch.from_numpy(q), tk, tv, 1, torch.from_numpy(seq), scale=scale)
    twin = decode_attention_stacked_reference(torch.from_numpy(q), tk, tv, 1, torch.from_numpy(seq), scale=scale)
    want = np.asarray(jax_stacked(jnp.asarray(q), kb, vb, 1, jnp.asarray(seq), scale=scale, interpret=True))
    np.testing.assert_allclose(got.numpy(), twin.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_split_decode_at_a_bucket_capacity():
    """cap 1280 (bucket_capacity's), not a multiple of the TPU kernel's 512:
    against the twin alone."""
    q, k_all, v_all, seq = _inputs(1280, [1, 64, 65, 640, 1216, 1217, 1279, 1280], seed=2)
    args = (*map(torch.from_numpy, (q, k_all, v_all)), 0, torch.from_numpy(seq))
    np.testing.assert_allclose(split_decode(*args, scale=0.1).numpy(),
                               decode_attention_stacked_reference(*args, scale=0.1).numpy(), rtol=1e-6, atol=1e-6)


def test_chunk_wholly_past_the_length_adds_exact_zeros():
    """Rows of 1, 33, 64 and 65 keys at cap 1024: the chunks past their
    ceil(len / 64) hold no live key. Merged with them the output is finite
    and bit-equal to merging the row's own chunks, as the kernel does;
    without the -inf guard they make it NaN."""
    q, k_all, v_all, _ = _inputs(1024, [0, 0, 0], seed=3)
    for n in (1, 33, 64, 65):
        seq = torch.full((3,), n, dtype=torch.int32)
        args = (*map(torch.from_numpy, (q, k_all, v_all)), 0, seq)
        every = split_decode(*args, scale=0.1)
        own = split_decode(*args, scale=0.1, n_chunks=-(-n // U_CHUNK))
        assert torch.isfinite(every).all() and torch.equal(every, own), n
        assert torch.isnan(split_decode(*args, scale=0.1, guard=False)).all(), n


def test_a_rows_bits_do_not_depend_on_the_other_rows():
    """The same row beside other lengths and other K/V, and alone at B 1:
    bit-equal, as the merge's order depends on the row's own length."""
    q, k_all, v_all, seq = _inputs(1024, [300, 1, 1024, 65, 700], seed=4)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    first = split_decode(t(q), t(k_all), t(v_all), 1, t(seq), scale=0.1)
    rng = np.random.default_rng(5)
    k2, v2 = k_all.copy(), v_all.copy()
    k2[:, 1:] = rng.standard_normal(k2[:, 1:].shape)
    v2[:, 1:] = rng.standard_normal(v2[:, 1:].shape)
    seq2 = np.asarray([300, 1024, 1, 64, 2], np.int32)
    changed = split_decode(t(q), t(k2), t(v2), 1, t(seq2), scale=0.1)
    alone = split_decode(t(q[:1]), t(k_all[:, :1]), t(v_all[:, :1]), 1, t(seq[:1]), scale=0.1)
    assert torch.equal(changed[0], first[0]) and torch.equal(alone[0], first[0])
