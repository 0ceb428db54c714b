"""Kernel B's bf16 walk on the tensor cores, emulated in torch on the CPU.

csrc/flash_attention.cu `attn_tc_kernel` runs SAM's rel-pos attention in
bf16 (`serve`'s vision dtype) in bf16 m16n8k16 products with f32 sums:
- Q K^T is one product: bf16 products are exact in f32, so the scores are
  the f32 dot products of the bf16 values (an f32 matmul of the widened
  values, summed in another order);
- the softmax runs in base 2: the scores times scale log2(e), plus the
  bias rows staged times log2(e), read at the key the score accumulator
  holds (n8 tile n, lane t, column c: key 8 n + 2 t + c, `KERNEL_KEYS`;
  in the k16 layout P V's A fragment reads the same key);
- the two warps of a 16-row group take the even and the odd TC_KW-key
  tiles, each with its own online softmax, merged at the end;
- P V splits P into hi = bf16(P) and lo = bf16(P - hi), O += lo V + hi V;
- the output is rounded to bf16 once.
The emulation is held to:
- `mha_reference` (full f32 rows, the built [L, L] bias, exact softmax)
  within the bf16 tolerance of the GPU tests (4 bf16 ulps of the largest
  output, `tests/test_torch_kernels.py` `_tol`) at SAM's shapes with fewer
  heads: the 1024^2 view's global attention (Kw 64), its windows (Kw 14,
  196 keys: the last tile partial) and six crops' global attention (Kw 48);
- the JAX package's `mha_pallas(rel_h=, rel_w=)` in interpret mode at a
  tiny shape, on the same seeded numpy inputs;
and a fault must miss the bound, which shows the test can see it: the bias
read in a wrong key order (`PV_ORDER_KEYS`, the TF32 walk's P V order: a
neighbour's bias inside each 8-key step). The kernel itself runs on the
card (tests/test_torch_kernels.py, -m gpu).
"""

import math

import numpy as np
import pytest
import torch
from test_torch_relpos_tc import KERNEL_KEYS, PV_ORDER_KEYS
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu_torch.ops.flash_attention import TC_KW, mha_reference

LOG2E = 1.4426950408889634


def bf16_tol(ref: torch.Tensor) -> float:
    """tests/test_torch_kernels.py `_tol` for bf16: 4 ulps of max |ref|."""
    return 4 * 2.0**-8 * max(1.0, float(ref.float().abs().max()))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _walk(q, k, v, rh2, rw2, tiles, *, scale2, keys_of):
    """One warp half's online softmax in base 2 over the TC_KW-key tiles in
    `tiles`: (m, l, O), all f32."""
    lk, kw = k.shape[2], rw2.shape[-1]
    m = torch.full(q.shape[:3], -math.inf)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for j in tiles:
        cols = torch.arange(j * TC_KW, min((j + 1) * TC_KW, lk))  # keys past Lk: -inf, weight 0
        keys = (j * TC_KW + keys_of[: len(cols)]).clamp(max=lk - 1)
        s = torch.matmul(q, k[..., cols, :].transpose(-1, -2)) * scale2
        s = s + (rh2[..., keys // kw] + rw2[..., keys % kw])
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        p_hi = _bf16(p)
        p_lo = _bf16(p - p_hi)
        acc = acc * alpha[..., None] + torch.matmul(p_lo, v[..., cols, :]) + torch.matmul(p_hi, v[..., cols, :])
        l = l * alpha + p.sum(-1)
        m = m_new
    return m, l, acc


def relpos_bf16_tc(q, k, v, rel_h, rel_w, *, scale: float, keys_of=KERNEL_KEYS) -> torch.Tensor:
    """Kernel B's bf16 walk (q, k, v bf16; rel_h, rel_w f32): returns bf16."""
    q, k, v = q.float(), k.float(), v.float()
    rh2, rw2 = rel_h.float() * LOG2E, rel_w.float() * LOG2E  # the staged rows, base 2
    n = -(-k.shape[2] // TC_KW)
    kw = dict(scale2=scale * LOG2E, keys_of=keys_of)
    m0, l0, o0 = _walk(q, k, v, rh2, rw2, range(0, n, 2), **kw)
    m1, l1, o1 = _walk(q, k, v, rh2, rw2, range(1, n, 2), **kw)
    mm = torch.maximum(m0, m1)
    a0, a1 = torch.exp2(m0 - mm)[..., None], torch.exp2(m1 - mm)[..., None]
    return ((o0 * a0 + o1 * a1) / (l0[..., None] * a0 + l1[..., None] * a1)).to(torch.bfloat16)


def _case(b: int, heads: int, side: int, seed: int):
    rng = np.random.default_rng(seed)
    l = side * side

    def rand(*shape, std=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))

    q, k, v = (rand(b, heads, l, 64).to(torch.bfloat16) for _ in range(3))
    return q, k, v, rand(b, heads, l, side, std=0.3), rand(b, heads, l, side, std=0.3)


def _err(got, q, k, v, rh, rw):
    ref = mha_reference(q, k, v, scale=0.125, rel_h=rh, rel_w=rw)
    assert ref.dtype == torch.bfloat16
    return float((got.float() - ref.float()).abs().max()), bf16_tol(ref)


@pytest.mark.parametrize("b,heads,side", [(1, 2, 64), (4, 4, 14), (1, 2, 48)])
def test_emulated_relpos_bf16_holds_the_tolerance(b, heads, side):
    """SAM's global view (Kw 64), its windows (Kw 14) and the crops' global
    view (Kw 48), with fewer heads than the path's 12."""
    q, k, v, rh, rw = _case(b, heads, side, seed=side)
    err, tol = _err(relpos_bf16_tc(q, k, v, rh, rw, scale=0.125), q, k, v, rh, rw)
    assert err <= tol, (err, tol)


def test_emulated_relpos_bf16_matches_pallas():
    import jax.numpy as jnp
    from deepseek_ocr2_tpu.ops.flash_attention import mha_pallas

    rng = np.random.default_rng(2)
    side = 16
    l = side * side
    q, k, v = (rng.standard_normal((1, 2, l, 64)).astype(np.float32) for _ in range(3))
    rh, rw = ((rng.standard_normal((1, 2, l, side)) * 0.3).astype(np.float32) for _ in range(2))
    want = mha_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), scale=0.125, rel_h=jnp.asarray(rh),
                      rel_w=jnp.asarray(rw), interpret=True)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    got = relpos_bf16_tc(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), torch.from_numpy(rh),
                         torch.from_numpy(rw), scale=0.125)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert float((got.float() - want).abs().max()) <= bf16_tol(want)


@pytest.mark.parametrize("b,heads,side", [(4, 2, 14), (1, 1, 48)])
def test_bias_read_in_a_wrong_key_order_misses_the_bound(b, heads, side):
    """The bias of a neighbour key inside each 8-key step (the TF32 walk's
    P V order in place of the score accumulator's key) misses the bf16
    tolerance."""
    assert not torch.equal(PV_ORDER_KEYS, KERNEL_KEYS)
    q, k, v, rh, rw = _case(b, heads, side, seed=side + 1)
    err, tol = _err(relpos_bf16_tc(q, k, v, rh, rw, scale=0.125, keys_of=PV_ORDER_KEYS), q, k, v, rh, rw)
    assert err > tol, (err, tol)
