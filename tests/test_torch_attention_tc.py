"""Kernel A's f32 arithmetic on the tensor cores (3xTF32), emulated in torch
on the CPU.

csrc/flash_attention.cu `attn_tc_kernel` runs the f32 prefill attention
(modes none, causal and prefix) as mma.sync m16n8k8 TF32 products: each f32
operand x is split into hi = rna(x) and lo = rna(x - hi) (cvt.rna.tf32.f32:
round to 10 explicit mantissa bits, ties away from zero), and each product
is lo.hi + hi.lo + hi.hi with f32 sums. Two warps share each 16-row group,
one taking the even and one the odd TC_KW-key tiles, each with its own
online softmax, merged at the end; the tiles that hold only masked keys
for a row group are skipped (`tc_key_tiles`). The emulation
below does the same arithmetic on the CPU (a TF32 product is exact in f32,
so f32 matmuls of the split parts model the tensor cores up to the order
of the sums) and is held to:
- `mha_reference` (full f32 rows, exact softmax) within A's stated 1e-4 at
  the LM's prefill shapes [1, 10, 260, 128] and [1, 10, 1125, 128];
- the JAX package's `mha_pallas` in interpret mode at a tiny shape, as
  tests/test_torch_kernels.py holds the twin;
- itself without the tile skip, bit for bit (the skip is exact);
and the same emulation without the split (1xTF32, what torch's allow_tf32
would give) must miss the 1e-4 bound: the test tells the two apart. The
kernel itself runs on the card (tests/test_torch_kernels.py, -m gpu).
"""

import math

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu_torch.ops.attention import MASK_VALUE
from deepseek_ocr2_tpu_torch.ops.flash_attention import TC_BQ, TC_KW, mha_reference, tc_key_tiles

F32_TOL = 1e-4  # A's tolerance against mha_reference (chip_smoke.F32_TOL)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: half an ulp of TF32 (bit 12) added to the
    magnitude bits, the low 13 bits cleared."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def split_3x(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def split_1x(x: torch.Tensor):
    return tf32_rna(x), torch.zeros_like(x)


def mm_tf32(a, b, split) -> torch.Tensor:
    """a @ b as the kernel's three TF32 products (the cross terms first)."""
    (ah, al), (bh, bl) = split(a), split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _softmax_walk(q, k, v, tiles, row_tiles, *, scale, mode, n_prefix, split):
    """One warp half's online softmax over the TC_KW-key tiles in `tiles`,
    each row visiting those below its row group's count: (m, l, O)."""
    lq, lk = q.shape[2], k.shape[2]
    rows = torch.arange(lq)[:, None]
    m = torch.full(q.shape[:3], -math.inf)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for j in tiles:
        keys = torch.arange(j * TC_KW, min((j + 1) * TC_KW, lk))[None, :]
        kt, vt = k[..., keys[0], :], v[..., keys[0], :]
        s = mm_tf32(q, kt.transpose(-1, -2), split) * scale
        if mode == "causal":
            s = s.masked_fill(keys > rows, MASK_VALUE)
        elif mode == "prefix":
            s = s.masked_fill((keys >= n_prefix) & ((rows < n_prefix) | (keys > rows)), MASK_VALUE)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        live = (row_tiles > j)[None, None, :]
        acc = torch.where(live[..., None], acc * alpha[..., None] + mm_tf32(p, vt, split), acc)
        l = torch.where(live, l * alpha + p.sum(-1), l)
        m = torch.where(live, m_new, m)
    return m, l, acc


def attention_tc(q, k, v, *, scale: float, mode: str = "none", n_prefix: int = 0, split=split_3x,
                 skip: bool = True) -> torch.Tensor:
    """Kernel A's f32 walk: TC_KW-key tiles, scores and P V in TF32
    products, the online softmax in f32 (masked scores -1e4); tile t goes
    to the row group's warp of half t % 2, each row visiting the tiles
    below the count `tc_key_tiles` gives its row group (all of them with
    skip=False), and the two halves' states are merged at the end."""
    lq, lk = q.shape[2], k.shape[2]
    n_all = -(-lk // TC_KW)
    tiles = tc_key_tiles(lq, lk, mode, n_prefix) if skip else torch.full((-(-lq // TC_BQ), TC_BQ // 16), n_all)
    row_tiles = tiles.reshape(-1).repeat_interleave(16)[:lq]  # each row's row group's count
    kw = dict(scale=scale, mode=mode, n_prefix=n_prefix, split=split)
    n = int(row_tiles.max())
    m0, l0, o0 = _softmax_walk(q, k, v, range(0, n, 2), row_tiles, **kw)
    m1, l1, o1 = _softmax_walk(q, k, v, range(1, n, 2), row_tiles, **kw)
    mm = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - mm)[..., None], torch.exp(m1 - mm)[..., None]
    return (o0 * a0 + o1 * a1) / (l0[..., None] * a0 + l1[..., None] * a1)


def _qkv(shape, seed: int, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)) for _ in range(3)]


@pytest.mark.parametrize("length", [260, 1125])
def test_emulated_kernel_holds_the_f32_tolerance(length):
    """The LM's prefill shapes: a no-crop prompt and a (2, 3) crop one."""
    q, k, v = _qkv((1, 10, length, 128), seed=length)
    scale = 1 / math.sqrt(128)
    ref = mha_reference(q, k, v, scale=scale, mode="causal")
    got = attention_tc(q, k, v, scale=scale, mode="causal")
    err = float((got - ref).abs().max())
    assert err <= F32_TOL, err
    # The tile skip is exact: visiting the skipped tiles changes no bit.
    assert torch.equal(got, attention_tc(q, k, v, scale=scale, mode="causal", skip=False))


def test_one_pass_tf32_misses_the_bound():
    """Without the split (1xTF32) the same walk misses 1e-4: the test can
    tell the two apart."""
    q, k, v = _qkv((1, 10, 260, 128), seed=260)
    scale = 1 / math.sqrt(128)
    ref = mha_reference(q, k, v, scale=scale, mode="causal")
    err_1x = float((attention_tc(q, k, v, scale=scale, mode="causal", split=split_1x) - ref).abs().max())
    err_3x = float((attention_tc(q, k, v, scale=scale, mode="causal") - ref).abs().max())
    assert err_1x > F32_TOL > err_3x, (err_1x, err_3x)


@pytest.mark.parametrize("mode,lq,d", [("none", 200, 64), ("causal", 77, 64), ("prefix", 150, 128),
                                       ("causal", 65, 128)])
def test_emulated_kernel_with_large_scores(mode, lq, d):
    """Scores up to ~80 (q and k scaled by 4): the split's error grows
    with the scores (2-3e-5 here), and stays inside the bound."""
    q, k, v = _qkv((2, 3, lq, d), seed=lq + d, scale=4.0)
    v = v / 4.0
    kw = dict(scale=1 / math.sqrt(d), mode=mode, n_prefix=lq // 2)
    err = float((attention_tc(q, k, v, **kw) - mha_reference(q, k, v, **kw)).abs().max())
    assert err <= F32_TOL, err


@pytest.mark.parametrize("mode,lq", [("none", 256), ("causal", 300), ("prefix", 288)])
def test_emulated_kernel_matches_pallas(mode, lq):
    import jax.numpy as jnp
    from deepseek_ocr2_tpu.ops.flash_attention import mha_pallas

    rng = np.random.default_rng(0)
    q, k, v = ((rng.standard_normal((1, 2, lq, 64))).astype(np.float32) for _ in range(3))
    n_prefix = lq // 2 if mode == "prefix" else 0
    want = mha_pallas(*map(jnp.asarray, (q, k, v)), scale=0.125, mode=mode, n_prefix=n_prefix, interpret=True)
    got = attention_tc(*map(torch.from_numpy, (q, k, v)), scale=0.125, mode=mode, n_prefix=n_prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mode", ["none", "causal", "prefix"])
@pytest.mark.parametrize("lq,lk,n_prefix", [(1, 1, 0), (63, 63, 10), (64, 64, 64), (65, 65, 1), (260, 260, 100),
                                            (1125, 1125, 700), (100, 300, 0)])
def test_key_tiles_visit_every_unmasked_key_and_no_masked_tile(mode, lq, lk, n_prefix):
    """`tc_key_tiles` against the reference's mask: every key a row group's
    rows may see lies in a tile it visits, and its last tile holds such a
    key (no tile of masked keys only is multiplied)."""
    tiles = tc_key_tiles(lq, lk, mode, n_prefix)
    assert tiles.shape == (-(-lq // TC_BQ), TC_BQ // 16)
    rows, keys = torch.arange(lq)[:, None], torch.arange(lk)[None, :]
    masked = torch.zeros(lq, lk, dtype=torch.bool)
    if mode == "causal":
        masked = keys > rows
    elif mode == "prefix":
        masked = (keys >= n_prefix) & ((rows < n_prefix) | (keys > rows))
    for w, count in enumerate(tiles.reshape(-1).tolist()):
        seen = ~masked[16 * w: 16 * w + 16]
        if seen.shape[0] == 0:
            assert count == 0
            continue
        last = int(seen.any(0).nonzero().max())  # the group's last key that some row sees
        assert count == last // TC_KW + 1, (w, count, last)
