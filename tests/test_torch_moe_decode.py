"""Kernel F's schedule and plain twin (the batched-decode MoE) against the
JAX package's fused distinct-expert kernel in interpret mode, on the CPU.

Tolerances are those of the JAX package's own tests (tests/test_moe_decode.py):
f32 2e-6 (the same rounding points; only the f32 summation order differs);
bf16 0.05 (one f32 sum landing on the other side of a bf16 rounding boundary
moves gate, up or act by an ulp). The schedule and the combine table are
exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops import moe as jmoe
from deepseek_ocr2_tpu.ops.moe_decode import _combine_table, _distinct_schedule
from deepseek_ocr2_tpu.ops.moe_decode import moe_ffn_decode_fused as jax_fused
from deepseek_ocr2_tpu_torch.ops import moe as tmoe
from deepseek_ocr2_tpu_torch.ops import moe_decode


def _case(b, e=16, h=64, i=96, k=4, seed=0, dtype="float32"):
    """Experts in both layouts (port [E, I, H] / [E, H, I], JAX transposed)
    and routing from a random f32 router, made with numpy."""
    rng = np.random.default_rng(seed)
    gate, up = (rng.standard_normal((e, i, h)).astype(np.float32) * 0.05 for _ in range(2))
    down = rng.standard_normal((e, h, i)).astype(np.float32) * 0.05
    x = rng.standard_normal((b, h)).astype(np.float32)
    w, idx = jmoe.route(jnp.asarray(x), jnp.asarray(rng.standard_normal((h, e)).astype(np.float32) * 0.1), k)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jex = {n: jnp.asarray(a.transpose(0, 2, 1)).astype(jdt) for n, a in (("gate", gate), ("up", up), ("down", down))}
    tex = {n: torch.from_numpy(a).to(tdt) for n, a in (("gate", gate), ("up", up), ("down", down))}
    return ((jnp.asarray(x).astype(jdt), jex, w, idx),
            (torch.from_numpy(x).to(tdt), tex, torch.from_numpy(np.array(w)), torch.from_numpy(np.array(idx)).long()))


@pytest.mark.parametrize("idx_rows", [
    [[0, 1], [2, 3]],  # all distinct
    [[5, 5], [5, 5]],  # one expert repeated (a duplicate within a row)
    [[0, 7], [7, 0]],  # shared across rows
])
def test_distinct_schedule_matches_jax(idx_rows):
    e = 8
    want_ve, want_valid = (np.asarray(a) for a in _distinct_schedule(jnp.asarray(idx_rows, jnp.int32), e))
    ve, valid = moe_decode.distinct_schedule(torch.tensor(idx_rows), e)
    assert ve.dtype == valid.dtype == torch.int32
    np.testing.assert_array_equal(ve.numpy(), want_ve)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    w = torch.full((2, 2), 0.25)
    want = np.asarray(_combine_table(jnp.asarray(idx_rows, jnp.int32), jnp.asarray(w.numpy()), want_ve, want_valid, e, 2))
    got = moe_decode.combine_table(torch.tensor(idx_rows), w, ve, valid, e)
    np.testing.assert_array_equal(got.numpy(), want[:, :, 0])


@pytest.mark.parametrize("b", [4, 13, 16])
def test_visits_twin_matches_jax_fused_f32(b):
    (jx, jex, w, idx), (tx, tex, tw, tidx) = _case(b)
    want = np.asarray(jax_fused(jx, jex, w, idx, interpret=True))
    before = moe_decode.moe_ffn_decode_fused.launches
    got = moe_decode.moe_ffn_decode_fused(tx, tex, tw, tidx)
    assert moe_decode.moe_ffn_decode_fused.launches == before  # CPU tensors: the twin, not the kernel
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=2e-6)
    np.testing.assert_allclose(moe_decode.moe_ffn_decode_visits_reference(tx, tex, tw, tidx).numpy(), want,
                               atol=2e-6, rtol=2e-6)


def test_visits_twin_matches_jax_fused_bf16():
    (jx, jex, w, idx), (tx, tex, tw, tidx) = _case(13, dtype="bfloat16")
    want = np.asarray(jax_fused(jx, jex, w, idx, interpret=True).astype(jnp.float32))
    got = moe_decode.moe_ffn_decode_fused(tx, tex, tw, tidx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05, rtol=0.05)


def test_unselected_experts_add_nothing():
    """An expert no row selects never reaches the output: changing its
    weights leaves every bit of the result as it was; pad visits (repeats
    of the last selected expert) add exact zeros."""
    _, (tx, tex, tw, tidx) = _case(3, e=16, k=2)
    want = moe_decode.moe_ffn_decode_visits_reference(tx, tex, tw, tidx)
    unused = sorted(set(range(16)) - set(tidx.flatten().tolist()))
    assert unused
    changed = {n: t.clone() for n, t in tex.items()}
    for n in changed:
        changed[n][unused] = 1e3
    torch.testing.assert_close(moe_decode.moe_ffn_decode_visits_reference(tx, changed, tw, tidx), want,
                               rtol=0, atol=0)
    # The sum over selected experts only, in ascending id, at F's rounding points.
    y = torch.zeros_like(want)
    for ex in sorted(set(tidx.flatten().tolist())):
        wrow = (tw * (tidx == ex)).sum(1, keepdim=True)
        act = torch.nn.functional.silu(tx @ tex["gate"][ex].T) * (tx @ tex["up"][ex].T)
        y += (act @ tex["down"][ex].T) * wrow
    torch.testing.assert_close(want, y, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [3, 5, 16])
def test_decode_dispatch_matches_jax(n):
    """`moe_ffn_decode` at the tiny LM's 8 experts, top-2: n * k <= 8 keeps
    the per-selection path, above it F's twin on the CPU; both against the
    JAX package's `moe_ffn_decode` (its dense form on the CPU)."""
    (jx, jex, w, idx), (tx, tex, tw, tidx) = _case(n, e=8, h=32, i=16, k=2, seed=3)
    want = np.asarray(jmoe.moe_ffn_decode(jx, jex, w, idx))
    np.testing.assert_allclose(tmoe.moe_ffn_decode(tx, tex, tw, tidx).numpy(), want, atol=2e-6, rtol=2e-6)
