"""Kernel B's f32 arithmetic on the tensor cores (3xTF32), emulated in torch
on the CPU.

csrc/flash_attention.cu `attn_tc_kernel` in its rel-pos mode runs SAM's
attention in f32 as kernel A does (tests/test_torch_attention_tc.py): each
f32 operand split into hi = rna(x) and lo = rna(x - hi), each product lo.hi
+ hi.lo + hi.hi with f32 sums, the two warps of a 16-row group taking the
even and the odd TC_KW-key tiles with their own online softmax, merged at
the end; B visits every tile (no key is masked). Each score then gets
rel_h[row, key / Kw] + rel_w[row, key % Kw] after the scale, where key is
the one the score accumulator holds: in a tile, n8 tile n, lane t, column c
holds key 8 n + 2 t + c (`KERNEL_KEYS`). P V's A fragment takes the same
registers in another k order (k t and t + 4 are keys 2 t and 2 t + 1);
reading the bias in that order (`PV_ORDER_KEYS`) gives each score a
neighbour's bias. The emulation is held to:
- `mha_reference` (full f32 rows, the built [L, L] bias, exact softmax)
  within B's stated 1e-4 at SAM's shapes with fewer heads: the 1024^2
  view's global attention (Kw 64), its windows (Kw 14, 196 keys: the last
  tile partial) and six crops' global attention (Kw 48);
- the JAX package's `mha_pallas(rel_h=, rel_w=)` in interpret mode at a
  tiny shape, on the same seeded numpy inputs;
and two faults must miss the 1e-4 bound, which shows the test can see
them: the walk without the split (1xTF32), and the bias read in P V's k
order, at Kw 14 and 48 (widths a 32-key tile does not divide). The kernel
itself runs on the card (tests/test_torch_kernels.py, -m gpu).
"""

import math

import numpy as np
import pytest
import torch
from test_torch_attention_tc import mm_tf32, split_1x, split_3x
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu_torch.ops.flash_attention import TC_KW, mha_reference

F32_TOL = 1e-4  # B's tolerance against mha_reference (chip_smoke.F32_TOL)


def _fragment_keys(order: str) -> torch.Tensor:
    """For each score column j of a TC_KW-key tile (the K row it was
    multiplied with: n8 tile n, lane t, column c), the key whose bias the
    kernel adds: `kernel` reads j itself (8 n + 2 t + c), `pv` reads P V's
    k order (8 n + t + 4 c), a neighbour's inside each 8-key step."""
    n, t, c = torch.meshgrid(torch.arange(TC_KW // 8), torch.arange(4), torch.arange(2), indexing="ij")
    key = 8 * n + 2 * t + c if order == "kernel" else 8 * n + t + 4 * c
    col = (8 * n + 2 * t + c).reshape(-1)
    out = torch.empty(TC_KW, dtype=torch.long)
    out[col] = key.reshape(-1)
    return out


KERNEL_KEYS = _fragment_keys("kernel")
PV_ORDER_KEYS = _fragment_keys("pv")


def _walk(q, k, v, rel_h, rel_w, tiles, *, scale, split, keys_of):
    """One warp half's online softmax over the TC_KW-key tiles in `tiles`:
    (m, l, O)."""
    lk, kw = k.shape[2], rel_w.shape[-1]
    m = torch.full(q.shape[:3], -math.inf)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for j in tiles:
        cols = torch.arange(j * TC_KW, min((j + 1) * TC_KW, lk))  # keys past Lk: -inf, weight 0
        keys = (j * TC_KW + keys_of[: len(cols)]).clamp(max=lk - 1)
        s = mm_tf32(q, k[..., cols, :].transpose(-1, -2), split) * scale
        s = s + (rel_h[..., keys // kw] + rel_w[..., keys % kw])
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        acc = acc * alpha[..., None] + mm_tf32(p, v[..., cols, :], split)
        l = l * alpha + p.sum(-1)
        m = m_new
    return m, l, acc


def relpos_tc(q, k, v, rel_h, rel_w, *, scale: float, split=split_3x, keys_of=KERNEL_KEYS) -> torch.Tensor:
    """Kernel B's f32 walk: every TC_KW-key tile, tile t to the row
    group's warp of half t % 2, scores and P V in TF32 products, the bias
    of the key `keys_of` gives each score column added after the scale,
    the online softmax in f32, the two halves merged at the end."""
    n = -(-k.shape[2] // TC_KW)
    kw = dict(scale=scale, split=split, keys_of=keys_of)
    m0, l0, o0 = _walk(q, k, v, rel_h, rel_w, range(0, n, 2), **kw)
    m1, l1, o1 = _walk(q, k, v, rel_h, rel_w, range(1, n, 2), **kw)
    mm = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - mm)[..., None], torch.exp(m1 - mm)[..., None]
    return (o0 * a0 + o1 * a1) / (l0[..., None] * a0 + l1[..., None] * a1)


def _case(b: int, heads: int, side: int, seed: int):
    rng = np.random.default_rng(seed)
    l = side * side

    def rand(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    q, k, v = (rand(b, heads, l, 64) for _ in range(3))
    return q, k, v, rand(b, heads, l, side, std=0.3), rand(b, heads, l, side, std=0.3)


def _err(got, q, k, v, rh, rw) -> float:
    return float((got - mha_reference(q, k, v, scale=0.125, rel_h=rh, rel_w=rw)).abs().max())


@pytest.mark.parametrize("b,heads,side", [(1, 2, 64), (4, 12, 14), (1, 2, 48)])
def test_emulated_relpos_holds_the_f32_tolerance(b, heads, side):
    """SAM's global view (Kw 64), its windows (Kw 14) and the crops' global
    view (Kw 48), with fewer heads than the path's 12 where the view is
    global."""
    q, k, v, rh, rw = _case(b, heads, side, seed=side)
    err = _err(relpos_tc(q, k, v, rh, rw, scale=0.125), q, k, v, rh, rw)
    assert err <= F32_TOL, err


def test_emulated_relpos_matches_pallas():
    import jax.numpy as jnp
    from deepseek_ocr2_tpu.ops.flash_attention import mha_pallas

    rng = np.random.default_rng(1)
    side = 16
    l = side * side
    q, k, v = ((rng.standard_normal((1, 2, l, 64))).astype(np.float32) for _ in range(3))
    rh, rw = ((rng.standard_normal((1, 2, l, side)) * 0.3).astype(np.float32) for _ in range(2))
    want = mha_pallas(*map(jnp.asarray, (q, k, v)), scale=0.125, rel_h=jnp.asarray(rh), rel_w=jnp.asarray(rw),
                      interpret=True)
    got = relpos_tc(*map(torch.from_numpy, (q, k, v, rh, rw)), scale=0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_one_pass_tf32_misses_the_bound():
    """Without the split (1xTF32) the same walk misses 1e-4 at the windows'
    shape, where the 3xTF32 walk holds it."""
    q, k, v, rh, rw = _case(4, 12, 14, seed=14)
    err_1x = _err(relpos_tc(q, k, v, rh, rw, scale=0.125, split=split_1x), q, k, v, rh, rw)
    err_3x = _err(relpos_tc(q, k, v, rh, rw, scale=0.125), q, k, v, rh, rw)
    assert err_1x > F32_TOL > err_3x, (err_1x, err_3x)


@pytest.mark.parametrize("b,heads,side", [(4, 2, 14), (1, 1, 48)])
def test_bias_read_in_pv_order_misses_the_bound(b, heads, side):
    """The bias of a neighbour key inside each 8-key step (P V's k order
    in place of the score accumulator's) misses 1e-4 by far."""
    assert not torch.equal(PV_ORDER_KEYS, KERNEL_KEYS) and torch.equal(KERNEL_KEYS, torch.arange(TC_KW))
    q, k, v, rh, rw = _case(b, heads, side, seed=side + 1)
    err = _err(relpos_tc(q, k, v, rh, rw, scale=0.125, keys_of=PV_ORDER_KEYS), q, k, v, rh, rw)
    assert err > 10 * F32_TOL, err
