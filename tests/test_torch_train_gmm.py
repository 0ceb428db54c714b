"""The differentiable grouped-GEMM MoE of the PyTorch port against the JAX
package's Pallas backward, on the CPU.

- Kernel S's and T's plain twins (`gmm_dx_reference`, `gmm_dw_reference`,
  reached through the wrappers on CPU tensors) against `_gmm_dx_call` and
  `_gmm_dw_call` in interpret mode. The JAX kernels run on the boundary-
  visit layout (sorted rows, padded at the end), the port's on the
  expert-aligned one: rows are mapped through `slot_of_sorted`, weights
  transposed (JAX [in, out], the port HF [out, in]).
- `MoeFfnGmm` (`moe_ffn_gmm`): dx, dW and d_weights against `jax.grad` of
  the JAX `moe_ffn_gmm(..., interpret=True)`, whose custom VJP runs
  `_moe_ffn_gmm_bwd`. f32 within 3e-6, the bound of the JAX package's own
  backward test (tests/test_moe_gmm.py); bf16 within 2e-2: both sides
  round gate, up, act, dy, dact, dgate, dup and dx to bf16 at the same
  points, but an f32 sum on the other side of a rounding boundary moves a
  bf16 value by one ulp (2^-8 relative) and that carries into the
  products downstream.
- The routing leaves experts without rows; their dW is zero on both sides
  (the JAX caller masks its untouched blocks).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops import moe_gmm as jgmm
from deepseek_ocr2_tpu_torch.ops import moe_gmm as tgmm

E, H, I, K, N = 8, 64, 96, 2, 70
EMPTY = (3, 6)  # experts no row selects


def _case(seed=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, H)).astype(np.float32)
    gate = (rng.standard_normal((E, H, I)) * 0.05).astype(np.float32)  # JAX layout [E, in, out]
    up = (rng.standard_normal((E, H, I)) * 0.05).astype(np.float32)
    down = (rng.standard_normal((E, I, H)) * 0.05).astype(np.float32)
    used = [e for e in range(E) if e not in EMPTY]
    idx = np.stack([rng.choice(used, K, replace=False) for _ in range(N)]).astype(np.int32)
    weights = rng.uniform(0.1, 0.6, (N, K)).astype(np.float32)
    cot = rng.standard_normal((N, H)).astype(np.float32)
    return x, {"gate": gate, "up": up, "down": down}, weights, idx, cot


def _layouts(idx):
    """Both layouts of the same assignments: (JAX schedule, bm, m_pad,
    order, group sizes) and the port's (slot_of_sorted [m], e_tile,
    tile_valid)."""
    m = idx.size
    bm = jgmm._pick_bm(m)
    m_pad = -(-m // bm) * bm
    flat = jnp.asarray(idx.reshape(-1))
    order = np.asarray(jnp.argsort(flat, stable=True))
    sizes = jnp.bincount(flat, length=E).astype(jnp.int32)
    schedule = jgmm._visit_schedule(sizes, m_pad, bm)
    t_sizes = torch.from_numpy(np.array(sizes))
    _, _, slot_of_sorted, e_tile, tile_valid = tgmm.aligned_layout(t_sizes, -(-m // tgmm.GMM_BM) * tgmm.GMM_BM,
                                                                   tgmm.GMM_BM)
    return (schedule, bm, m_pad, order, np.asarray(sizes)), (slot_of_sorted[:m].long(), e_tile, tile_valid)


def _to_slots(a_sorted, slot_of_sorted, n_slots):
    out = torch.zeros(n_slots, a_sorted.shape[1], dtype=a_sorted.dtype)
    out[slot_of_sorted] = a_sorted
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dx_twin_matches_pallas_dx_kernel(dtype):
    x, ex, _, idx, _ = _case()
    (schedule, bm, m_pad, _, _), (slots, e_tile, tile_valid) = _layouts(idx)
    m = idx.size
    rng = np.random.default_rng(1)
    a_sorted = rng.standard_normal((m, H)).astype(np.float32)  # dy rows, contracted with Wd
    jdt = jnp.dtype(dtype)
    a_pad = jnp.pad(jnp.asarray(a_sorted, jdt), ((0, m_pad - m), (0, 0)))
    w_jax = jnp.asarray(ex["down"], jdt)  # [E, I, H]: contracted on its last dim
    want = np.asarray(jgmm._gmm_dx_call(schedule, a_pad, w_jax, bm=bm, interpret=True).astype(jnp.float32))[:m]

    tdt = getattr(torch, dtype)
    a_al = _to_slots(torch.from_numpy(a_sorted).to(tdt), slots, e_tile.numel() * tgmm.GMM_BM)
    w_port = torch.from_numpy(ex["down"]).transpose(1, 2).contiguous().to(tdt)  # HF [E, H, I]
    before = tgmm.moe_gmm_dx.launches
    got = tgmm.moe_gmm_dx(a_al, w_port, e_tile, tile_valid)
    assert tgmm.moe_gmm_dx.launches == before  # CPU tensors run the twin
    assert got.dtype == tdt and got.shape == (a_al.shape[0], I)
    assert float(got[~torch.isin(torch.arange(a_al.shape[0]), slots)].abs().max()) == 0.0  # pad slots
    tol = dict(rtol=3e-6, atol=3e-6) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got[slots].float().numpy(), want, **tol)


def test_dw_twin_matches_pallas_dw_kernel():
    x, _, _, idx, _ = _case()
    (schedule, bm, m_pad, order, sizes), (slots, e_tile, tile_valid) = _layouts(idx)
    m = idx.size
    rng = np.random.default_rng(2)
    x_sorted = x[order // K]
    dy_sorted = rng.standard_normal((m, I)).astype(np.float32)
    pad = ((0, m_pad - m), (0, 0))
    dw = jgmm._gmm_dw_call(schedule, jnp.pad(jnp.asarray(x_sorted), pad), jnp.pad(jnp.asarray(dy_sorted), pad),
                           E, bm=bm, interpret=True)
    want = np.where((sizes > 0)[:, None, None], np.asarray(dw), 0.0)  # [E, H, I], masked as the caller does
    n_slots = e_tile.numel() * tgmm.GMM_BM
    got = tgmm.moe_gmm_dw(_to_slots(torch.from_numpy(x_sorted), slots, n_slots),
                          _to_slots(torch.from_numpy(dy_sorted), slots, n_slots), e_tile, tile_valid, E)
    assert got.dtype == torch.float32 and got.shape == (E, I, H)
    assert all(float(got[e].abs().max()) == 0.0 for e in EMPTY)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, rtol=3e-6, atol=3e-6)


def test_expert_tile_ranges():
    sizes = torch.tensor([5, 0, 70, 0, 32, 1], dtype=torch.int32)
    _, _, _, e_tile, tile_valid = tgmm.aligned_layout(sizes, 128, 32)
    lo = tgmm.expert_tile_ranges(e_tile, tile_valid, 6)
    assert lo.tolist() == [0, 1, 1, 4, 4, 5, 6]


@pytest.fixture(scope="module")
def jax_grads():
    """jax.grad of the JAX moe_ffn_gmm (interpret-mode Pallas backward),
    per dtype, jitted once each."""
    x, ex, weights, idx, cot = _case()
    out = {}
    for dtype in ("float32", "bfloat16"):
        jdt = jnp.dtype(dtype)
        j_ex = {k: jnp.asarray(v, jdt) for k, v in ex.items()}

        @jax.jit
        def grads(x_, ex_, w_):
            return jax.grad(lambda a, b, c: jnp.sum(
                jgmm.moe_ffn_gmm(a, b, c, jnp.asarray(idx), interpret=True).astype(jnp.float32) * cot),
                argnums=(0, 1, 2))(x_, ex_, w_)

        out[dtype] = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                            grads(jnp.asarray(x, jdt), j_ex, jnp.asarray(weights)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_function_grads_match_jax_pallas_backward(dtype, jax_grads):
    x, ex, weights, idx, cot = _case()
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    t_ex = {k: torch.from_numpy(v).transpose(1, 2).contiguous().to(tdt).requires_grad_() for k, v in ex.items()}
    tw = torch.from_numpy(weights).requires_grad_()
    out = tgmm.moe_ffn_gmm(tx, t_ex, tw, torch.from_numpy(idx).long())
    assert out.dtype == tdt and out.grad_fn is not None
    leaves = [tx, t_ex["gate"], t_ex["up"], t_ex["down"], tw]
    got = torch.autograd.grad((out.float() * torch.from_numpy(cot)).sum(), leaves)
    dx, d_ex, d_w = jax_grads[dtype]
    want = [dx, d_ex["gate"].transpose(0, 2, 1), d_ex["up"].transpose(0, 2, 1), d_ex["down"].transpose(0, 2, 1), d_w]
    tol = dict(rtol=3e-6, atol=3e-6) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    for name, g, w in zip(("dx", "dW gate", "dW up", "dW down", "d_weights"), got, want):
        assert g.dtype == (torch.float32 if name == "d_weights" else tdt), name
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **tol)
    for g in got[1:4]:
        assert all(float(g[e].abs().max()) == 0.0 for e in EMPTY)


def test_function_backward_matches_autograd_of_the_grouped_twin():
    """The same backward against plain autograd through the grouped twin
    (`moe_ffn_gmm_reference`), f32: the Function's algebra, independent of
    the JAX package. Both round at the same points; only the order of f32
    sums differs (outputs O(1-10): 1e-5)."""
    x, ex, weights, idx, cot = _case(seed=9)
    grads = []
    for fn in (tgmm.moe_ffn_gmm, tgmm.moe_ffn_gmm_reference):
        tx = torch.from_numpy(x).requires_grad_()
        t_ex = {k: torch.from_numpy(v).transpose(1, 2).contiguous().requires_grad_() for k, v in ex.items()}
        tw = torch.from_numpy(weights).requires_grad_()
        out = fn(tx, t_ex, tw, torch.from_numpy(idx).long())
        grads.append(torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                         [tx, t_ex["gate"], t_ex["up"], t_ex["down"], tw]))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
