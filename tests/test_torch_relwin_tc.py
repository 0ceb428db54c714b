"""Kernel V's arithmetic on the tensor cores, emulated in torch on the CPU.

csrc/flash_attention.cu `attn_tc_kernel` in mode RELWIN runs SAM's windowed
attention as kernel B's walk (tests/test_torch_relpos_tc.py) with Kh = Kw =
win and its rel rows built in the block: rel_h[q, kh] = q . rhf[:, (q //
win) win + kh] and rel_w[q, kw] = q . rwf[:, (q % win) win + kw] in f32
FMAs on q as given (not the TF32 split), a padded window row kh >= valid
(column kw >= valid) carrying -1e30 in rel_h (rel_w). A padded key's bias is
then -1e30 or -2e30, and its weight an exact 0 beside any real score, as
the twin's -1e30. Each score reads its bias at the key its accumulator
holds (`KERNEL_KEYS`). In f32 every product is 3xTF32; in bf16 q, k and v
are exact in TF32 (their lo parts are zero), so Q K^T is the one product
hi.hi and P V the two P.lo V + P.hi V, with the same f32 softmax and the
output rounded to bf16 once. The emulation is held to:
- `mha_win_reference` (the built [T2, T2] bias, exact softmax) within V's
  1e-4 in f32 and the bf16 tolerance of tests/test_torch_kernels.py, on
  the valid rows, at SAM's 14 / 14 windows (T2 196: a 4-key last tile) and
  the JAX package's padded 16 / 14 form;
- the JAX package's `mha_win_pallas` in interpret mode at a tiny shape;
and the walk with the pad mask dropped must miss the bound at 16 / 14,
which shows the test can see it. The kernel itself runs on the card
(tests/test_torch_kernels.py, -m gpu).
"""

import numpy as np
import pytest
import torch
from test_torch_attention_tc import split_3x
from test_torch_relpos_tc import relpos_tc
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu_torch.ops.flash_attention import mha_win_reference

F32_TOL = 1e-4  # V's tolerance against mha_win_reference (chip_smoke.F32_TOL)
SCALE = 0.125


def bf16_tol(ref: torch.Tensor) -> float:
    """tests/test_torch_kernels.py `_tol` for bf16: 4 bf16 ulps of the
    largest output."""
    return 4 * 2.0**-8 * max(1.0, float(ref.abs().max()))


def relwin_rows(q, rhf, rwf, win: int, valid: int, pad: bool = True):
    """The rel rows V stages for each query: rel_h, rel_w [..., T2, win] in
    f32 from q as given, -1e30 on a padded window row (column)."""
    t2 = win * win
    pos, kk = torch.arange(t2)[:, None], torch.arange(win)[None, :]
    col_h, col_w = pos // win * win + kk, pos % win * win + kk  # [T2, win]
    q32 = q.float()
    rel_h = torch.einsum("...qd,dqk->...qk", q32, rhf.float()[:, col_h])
    rel_w = torch.einsum("...qd,dqk->...qk", q32, rwf.float()[:, col_w])
    if pad:
        cut = torch.where(torch.arange(win) >= valid, -1.0e30, 0.0)
        rel_h, rel_w = rel_h + cut, rel_w + cut
    return rel_h, rel_w


def relwin_tc(q, k, v, rhf, rwf, *, win: int, valid: int, pad: bool = True) -> torch.Tensor:
    """V's walk: B's (every 32-key tile, the two key halves merged, the
    bias at the accumulator's key) on the staged rows, in q's dtype."""
    rel_h, rel_w = relwin_rows(q, rhf, rwf, win, valid, pad)
    out = relpos_tc(q.float(), k.float(), v.float(), rel_h, rel_w, scale=SCALE, split=split_3x)
    return out.to(q.dtype)


def _case(b, heads, win, valid, seed, dtype=torch.float32):
    """Random q, k, v with the padded window tokens zeroed (as SAM's window
    pad leaves them) and tables [valid, valid, 64] zero-padded and
    flattened to [64, win^2], as the JAX package's test builds them."""
    rng = np.random.default_rng(seed)
    t2 = win * win
    pos = np.arange(t2)
    tok = ((pos // win < valid) & (pos % win < valid)).astype(np.float32)[:, None]
    q, k, v = (torch.from_numpy(rng.standard_normal((b, heads, t2, 64)).astype(np.float32) * tok).to(dtype)
               for _ in range(3))
    rhf, rwf = (torch.from_numpy(np.pad(rng.standard_normal((valid, valid, 64)).astype(np.float32) * 0.3,
                                        ((0, win - valid), (0, win - valid), (0, 0)))
                                 .transpose(2, 0, 1).reshape(64, t2).copy()) for _ in range(2))
    return q, k, v, rhf, rwf, torch.from_numpy(tok[:, 0] > 0)


def _err(got, ref, live) -> float:
    return float((got.float() - ref.float())[:, :, live].abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("win,valid", [(14, 14), (16, 14)])
def test_emulated_relwin_holds_the_tolerance(dtype, win, valid):
    q, k, v, rhf, rwf, live = _case(3, 4, win, valid, seed=win + valid, dtype=dtype)
    ref = mha_win_reference(q, k, v, rhf, rwf, scale=SCALE, win=win, valid=valid)
    got = relwin_tc(q, k, v, rhf, rwf, win=win, valid=valid)
    assert got.dtype == ref.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else bf16_tol(ref[:, :, live].float())
    assert _err(got, ref, live) <= tol


def test_bf16_operands_are_exact_in_tf32():
    """Why bf16 V takes one product for Q K^T and two for P V: a bf16 value
    widened to f32 is its own TF32 high part, its low part exactly 0, so
    the 3xTF32 walk's cross terms with it vanish."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(4096).astype(np.float32)).to(torch.bfloat16)
    hi, lo = split_3x(x.float())
    assert torch.equal(hi, x.float()) and not lo.any()


def test_emulated_relwin_matches_pallas():
    import jax.numpy as jnp
    from deepseek_ocr2_tpu.ops.flash_attention import mha_win_pallas

    win, valid = 16, 14  # the TPU kernel takes T2 % 128 == 0
    q, k, v, rhf, rwf, live = _case(1, 2, win, valid, seed=7)
    want = np.asarray(mha_win_pallas(*(jnp.asarray(t.numpy()) for t in (q, k, v, rhf, rwf)), scale=SCALE, win=win,
                                     valid=valid, interpret=True))
    got = relwin_tc(q, k, v, rhf, rwf, win=win, valid=valid).numpy()
    np.testing.assert_allclose(got[:, :, live.numpy()], want[:, :, live.numpy()], rtol=3e-5, atol=3e-5)


def test_dropped_pad_mask_misses_the_bound():
    """Without the -1e30 on padded rows and columns the padded keys take
    weight at 16 / 14 (their scores are O(1), not -1e30): the valid rows
    miss 1e-4 by far."""
    q, k, v, rhf, rwf, live = _case(3, 4, 16, 14, seed=3)
    ref = mha_win_reference(q, k, v, rhf, rwf, scale=SCALE, win=16, valid=14)
    assert _err(relwin_tc(q, k, v, rhf, rwf, win=16, valid=14), ref, live) <= F32_TOL
    assert _err(relwin_tc(q, k, v, rhf, rwf, win=16, valid=14, pad=False), ref, live) > 100 * F32_TOL
