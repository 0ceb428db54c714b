"""Kernel C's tensor-core arithmetic, emulated in torch on the CPU.

csrc/fused_mlp.cu runs C as two launches of a TMA + wgmma GEMM, each over
tiles of 128 rows by BN columns with loads past M, N and K read as zeros,
and epilogues at the TPU kernel's rounding points:
- f32, 3xTF32: each operand split into hi = rna_tf32(v) and lo =
  rna_tf32(v - hi) (round to nearest, ties away from zero, 10 mantissa
  bits), a stage of 32 k summed as lo(A) hi(W) + hi(A) lo(W) + hi(A) hi(W)
  (emulated exactly, in f64, then rounded to f32), the stages added to an
  f32 sum;
- bf16: every product in f32, summed over K, then h = bf16(h); h =
  bf16(h + b1); g = bf16(gelu(h)); out = bf16(bf16(g W2^T) + b2);
with M not a multiple of 128 (the tile clipping at the row edge). Held to
the JAX package's `mlp_gelu` (the Pallas kernel in interpret mode, as
tests/test_fused_mlp.py runs it) and to the port's twin (bf16: equal to the
twin but for rare one-sided roundings); 1xTF32 (hi alone)
fails the f32 bound, which shows the split is needed and that the test can
see it. The kernel itself runs on the card (tests/test_torch_kernels.py,
-m gpu).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops.fused_mlp import mlp_gelu as jax_mlp_gelu
from deepseek_ocr2_tpu_torch.ops.fused_mlp import mlp_gelu_reference

BM, BK_F32 = 128, 32
UP_BN = {torch.float32: 128, torch.bfloat16: 256}
DOWN_BN = {torch.float32: 128, torch.bfloat16: 192}  # the wider of the down product's two widths
F32_TOL = 1e-4  # chip_smoke's f32 bound for C against its twin


def rna_tf32(t: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero (on
    the magnitude bits; finite inputs)."""
    return ((t.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def gemm(a: torch.Tensor, w: torch.Tensor, bn: int, split: bool, parts: int = 3) -> torch.Tensor:
    """a [M, K] . w [N, K]^T as the kernel's tiles: M padded to 128 rows, N
    to bn columns, K to a whole stage, with zeros (TMA's fill), then the
    clipped tile written back. f32 sums (3xTF32 stages with `split`, or
    `parts` = 1: hi alone); bf16 operands multiplied exactly and summed over
    K. Returns [M, N] f32."""
    m, k = a.shape
    n = w.shape[0]
    pm, pn, pk = -m % BM, -n % bn, -k % BK_F32
    a = torch.nn.functional.pad(a.float(), (0, pk, 0, pm))
    w = torch.nn.functional.pad(w.float(), (0, pk, 0, pn))
    if not split:
        out = (a.double() @ w.double().T).float()
    else:
        ah, wh = rna_tf32(a), rna_tf32(w)
        al, wl = rna_tf32(a - ah), rna_tf32(w - wh)
        out = torch.zeros(a.shape[0], w.shape[0])
        for k0 in range(0, a.shape[1], BK_F32):
            ks = slice(k0, k0 + BK_F32)
            stage = ah[:, ks].double() @ wh[:, ks].double().T
            if parts == 3:
                stage = stage + al[:, ks].double() @ wh[:, ks].double().T + ah[:, ks].double() @ wl[:, ks].double().T
            out = out + stage.float()
    return out[:m, :n]


def mlp_tc(x, w1, b1, w2, b2, parts: int = 3) -> torch.Tensor:
    """C's two launches: up (+ b1, exact-erf GELU) and down (+ b2), rounded
    to x.dtype where the kernel rounds (identity for f32)."""
    dt = x.dtype
    split = dt == torch.float32

    def rnd(t):
        return t.to(dt).float()

    h = rnd(rnd(gemm(x, w1, UP_BN[dt], split, parts)) + b1.float())
    g = rnd(0.5 * h * (1.0 + torch.erf(h * 0.7071067811865476)))
    return rnd(rnd(gemm(g.to(dt), w2, DOWN_BN[dt], split, parts)) + b2.float()).to(dt)


def _inputs(m, e, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, e)).astype(np.float32), (rng.standard_normal((f, e)) * e**-0.5).astype(np.float32),
            (0.02 * rng.standard_normal(f)).astype(np.float32),
            (rng.standard_normal((e, f)) * f**-0.5).astype(np.float32), (0.02 * rng.standard_normal(e)).astype(np.float32))


def _jax(args, dtype):
    x, w1, b1, w2, b2 = args
    jdt = jnp.dtype(dtype)
    return np.asarray(jax_mlp_gelu(jnp.asarray(x, jdt), jnp.asarray(w1.T, jdt), jnp.asarray(b1, jdt),
                                   jnp.asarray(w2.T, jdt), jnp.asarray(b2, jdt), block_m=256, interpret=True),
                      np.float32)


SHAPES = [(300, 128, 256), (130, 256, 384), (129, 128, 512)]  # M past a 128-row tile; the TPU gate's E, F


@pytest.mark.parametrize("m,e,f", SHAPES)
def test_3xtf32_matches_jax_and_twin(m, e, f):
    args = _inputs(m, e, f, seed=m + e)
    t = [torch.from_numpy(a) for a in args]
    got = mlp_tc(*t)
    want = _jax(args, "float32")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), mlp_gelu_reference(*t).numpy(), rtol=2e-5, atol=2e-5)


def test_1xtf32_fails_the_f32_bound():
    """hi alone (TF32's 10 mantissa bits, torch's allow_tf32) at SAM's
    widths: above the 1e-4 bound that 3xTF32 meets far inside."""
    args = _inputs(128, 768, 3072, seed=7)
    t = [torch.from_numpy(a) for a in args]
    twin = mlp_gelu_reference(*t)
    err3 = float((mlp_tc(*t) - twin).abs().max())
    err1 = float((mlp_tc(*t, parts=1) - twin).abs().max())
    assert err3 < F32_TOL / 10 < F32_TOL < err1, (err3, err1)


@pytest.mark.parametrize("m,e,f", SHAPES)
def test_bf16_rounding_points_match_twin_and_jax(m, e, f):
    """The epilogues' bf16 rounding points against the twin's: equal but
    where an f32 sum taken in another order lands on the other side of a
    bf16 rounding boundary of h (at most 2 outputs in 1000 here, by a few bf16
    ulps). The JAX kernel in interpret mode rounds elsewhere (44 % of its
    outputs equal the twin's): held to it at chip_smoke's bf16 bound for C,
    4 bf16 ulps of the largest output."""
    args = _inputs(m, e, f, seed=m + f)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in args]
    got = mlp_tc(*t).float().numpy()
    twin = mlp_gelu_reference(*t).float().numpy()
    want = _jax(args, "bfloat16")
    diff = np.abs(got - twin)
    assert diff.max() <= 4 * 2.0**-8 * max(1.0, np.abs(twin).max()) and np.mean(diff == 0) > 0.99
    assert np.abs(got - want).max() <= 4 * 2.0**-8 * max(1.0, np.abs(want).max())
