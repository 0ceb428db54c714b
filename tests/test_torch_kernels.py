"""Kernels A, B, C, D, E of the PyTorch port: plain twins against the JAX
Pallas kernels (interpret mode on the CPU) and the JAX XLA paths; CUDA
kernels against their twins where a card is present. (D and E's CPU parity
with the JAX package is in tests/test_torch_crop.py.)

Tolerances: f32 twins agree with the JAX kernels to 2e-5 (f32 summation
order only; the JAX package's own kernel tests use the same bound). In
bf16 the fused MLP keeps the same rounding points, but the JAX kernel's
polynomial erf (1.5e-7 abs) and the compiler's folding of a bf16->f32
convert chain may move an output by one bf16 ulp: 2e-3 abs / 5e-2 rel,
the bound of the JAX package's own bf16 MLP test. The CUDA cases use the
tolerances stated in chip_smoke.py: 1e-4 abs in f32, 4 bf16 ulps of the
largest output in bf16.

JAX is imported inside the tests that use it, so that the CUDA cases run
on a machine without it:
    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from deepseek_ocr2_tpu_torch.ops.flash_attention import mha, mha_reference, mha_relpos
from deepseek_ocr2_tpu_torch.ops.fused_mlp import mlp_gelu, mlp_gelu_reference
from deepseek_ocr2_tpu_torch.ops import moe_gmm
from deepseek_ocr2_tpu_torch.ops.moe import route

F32 = dict(rtol=2e-5, atol=2e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    import deepseek_ocr2_tpu_torch  # noqa: F401  (f32 numerics flags)

    return torch.device("cuda")


@pytest.mark.parametrize("mode,lq", [("none", 256), ("causal", 300), ("prefix", 288)])
def test_attention_twin_matches_pallas(mode, lq):
    import jax.numpy as jnp
    from deepseek_ocr2_tpu.ops.flash_attention import mha_pallas

    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, 1, 2, lq, 64) for _ in range(3))
    n_prefix = lq // 2 if mode == "prefix" else 0
    want = mha_pallas(*map(jnp.asarray, (q, k, v)), scale=0.125, mode=mode, n_prefix=n_prefix, interpret=True)
    before = mha.launches
    got = mha(*map(torch.from_numpy, (q, k, v)), scale=0.125, mode=mode, n_prefix=n_prefix)
    assert mha.launches == before  # the CPU path runs the twin, not the kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_relpos_twin_matches_pallas():
    import jax.numpy as jnp
    from deepseek_ocr2_tpu.ops.flash_attention import mha_pallas

    rng = np.random.default_rng(1)
    side, d = 16, 64
    l = side * side
    q, k, v = (_rand(rng, 1, 2, l, d) for _ in range(3))
    rh, rw = _rand(rng, 1, 2, l, side, scale=0.3), _rand(rng, 1, 2, l, side, scale=0.3)
    want = mha_pallas(*map(jnp.asarray, (q, k, v)), scale=0.125, rel_h=jnp.asarray(rh), rel_w=jnp.asarray(rw), interpret=True)
    got = mha_relpos(*map(torch.from_numpy, (q, k, v, rh, rw)), scale=0.125)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)


def test_sam_window_attention_matches_jax_xla_path():
    """True 14x14 windows (196 keys) through the port's SAM attention (kernel
    B's twin on the CPU) against the JAX XLA path at the same windows."""
    import jax.numpy as jnp
    from deepseek_ocr2_tpu.models.sam import _attention as jax_attention
    from deepseek_ocr2_tpu_torch.models.sam import _attention as torch_attention

    rng = np.random.default_rng(7)
    heads, hd, win = 2, 64, 14
    dim = heads * hd
    wins = _rand(rng, 3, win, win, dim)
    attn = {
        "qkv_w": _rand(rng, dim, 3 * dim, scale=0.05), "qkv_b": _rand(rng, 3 * dim, scale=0.02),
        "proj_w": _rand(rng, dim, dim, scale=0.05), "proj_b": _rand(rng, dim, scale=0.02),
        "rel_h": _rand(rng, 2 * win - 1, hd, scale=0.1), "rel_w": _rand(rng, 2 * win - 1, hd, scale=0.1),
    }
    want = np.asarray(jax_attention(jnp.asarray(wins), {k: jnp.asarray(v) for k, v in attn.items()}, heads))
    blk = {k: torch.from_numpy(np.ascontiguousarray(v.T if k.endswith("_w") and v.ndim == 2 and "rel" not in k else v))
           for k, v in attn.items()}
    got = torch_attention(torch.from_numpy(wins), blk, heads).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)


def _mlp_inputs(rng, m, e, f):
    return (
        _rand(rng, m, e, scale=0.1), _rand(rng, f, e, scale=0.05), _rand(rng, f, scale=0.02),
        _rand(rng, e, f, scale=0.05), _rand(rng, e, scale=0.02),
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_twin_matches_pallas(dtype):
    import jax.numpy as jnp
    from deepseek_ocr2_tpu.ops.fused_mlp import mlp_gelu as jax_mlp_gelu

    rng = np.random.default_rng(2)
    x, w1, b1, w2, b2 = _mlp_inputs(rng, 300, 128, 256)
    jdt = jnp.dtype(dtype)
    want = jax_mlp_gelu(
        jnp.asarray(x, jdt), jnp.asarray(w1.T, jdt), jnp.asarray(b1, jdt), jnp.asarray(w2.T, jdt),
        jnp.asarray(b2, jdt), block_m=256, interpret=True,
    )
    tdt = getattr(torch, dtype)
    before = mlp_gelu.launches
    got = mlp_gelu(*(torch.from_numpy(a).to(tdt) for a in (x, w1, b1, w2, b2)))
    assert mlp_gelu.launches == before and got.dtype == tdt
    tol = F32 if dtype == "float32" else dict(atol=2e-3, rtol=0.05)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_wrappers_refuse_non_cuda_devices():
    """Only CPU tensors take the twin; any other device raises (no fallback)."""
    q = torch.zeros(1, 1, 4, 16, device="meta")
    with pytest.raises(ValueError):
        mha(q, q, q, scale=1.0)
    x = torch.zeros(4, 16, device="meta")
    with pytest.raises(ValueError):
        mlp_gelu(x, torch.zeros(8, 16, device="meta"), torch.zeros(8, device="meta"),
                 torch.zeros(16, 8, device="meta"), torch.zeros(16, device="meta"))
    tiles = torch.zeros(2, dtype=torch.int32, device="meta")
    w = torch.zeros(3, 8, 16, device="meta")
    with pytest.raises(ValueError):
        moe_gmm.moe_gmm_swiglu(torch.zeros(64, 16, device="meta"), w, w, tiles, tiles)
    with pytest.raises(ValueError):
        moe_gmm.moe_gmm_down(torch.zeros(64, 16, device="meta"), torch.zeros(3, 8, 16, device="meta"), tiles, tiles)


# ---------------------------------------------------------------------------
# CUDA kernels against their twins (skip without a card)


def _tol(ref, dtype):
    return 1e-4 if dtype == torch.float32 else 4 * 2.0**-8 * max(1.0, float(ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("mode,lq,d", [("none", 200, 64), ("causal", 260, 128), ("prefix", 288, 64), ("causal", 77, 64)])
def test_cuda_attention_matches_twin(cuda, mode, lq, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 3, lq, d, generator=g, device=cuda) for _ in range(3))
    kw = dict(scale=1.0 / math.sqrt(d), mode=mode, n_prefix=lq // 2)
    before = mha.launches
    got = mha(q, k, v, **kw)
    torch.cuda.synchronize()
    assert mha.launches == before + 1
    ref = mha_reference(q, k, v, **kw)
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,side", [(1, 64), (25, 14), (2, 9)])
def test_cuda_relpos_matches_twin(cuda, dtype, b, side):
    g = torch.Generator(device=cuda).manual_seed(1)
    l = side * side
    q, k, v = (torch.randn(b, 12, l, 64, generator=g, device=cuda).to(dtype) for _ in range(3))
    rh, rw = (0.3 * torch.randn(b, 12, l, side, generator=g, device=cuda) for _ in range(2))
    got = mha_relpos(q, k, v, rh, rw, scale=0.125)
    ref = mha_reference(q, k, v, scale=0.125, rel_h=rh, rel_w=rw)
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,e,f", [(4096, 768, 3072), (100, 32, 64), (33, 200, 96)])
def test_cuda_mlp_matches_twin(cuda, dtype, m, e, f):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(m, e, generator=g, device=cuda).to(dtype)
    w1 = (torch.randn(f, e, generator=g, device=cuda) * e**-0.5).to(dtype)
    w2 = (torch.randn(e, f, generator=g, device=cuda) * f**-0.5).to(dtype)
    b1 = (0.02 * torch.randn(f, generator=g, device=cuda)).to(dtype)
    b2 = (0.02 * torch.randn(e, generator=g, device=cuda)).to(dtype)
    before = mlp_gelu.launches
    got = mlp_gelu(x, w1, b1, w2, b2)
    assert mlp_gelu.launches == before + 1
    ref = mlp_gelu_reference(x, w1, b1, w2, b2)
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)


def _moe_case(dev, dtype, n, e, h, i, k, routing):
    """Experts with fan-in scaled weights; `routing` is "router" (a random
    f32 router: realistic group sizes), "one" (every row on expert 5) or
    "few" (every row on experts 0-2, the others empty)."""
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(n, h, generator=g, device=dev).to(dtype)
    experts = {
        name: (torch.randn(e, *shape, generator=g, device=dev) * shape[1] ** -0.5).to(dtype)
        for name, shape in (("gate", (i, h)), ("up", (i, h)), ("down", (h, i)))
    }
    if routing == "router":
        return x, experts, *route(x, torch.randn(e, h, generator=g, device=dev) * h**-0.5, k)
    weights = torch.rand(n, k, generator=g, device=dev)
    if routing == "one":
        idx = torch.full((n, k), 5, device=dev)
    else:
        idx = torch.randint(0, 3, (n, k), generator=g, device=dev)
    return x, experts, weights, idx


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,h,i,k,routing", [
    (550, 64, 1280, 896, 6, "router"),  # a 2-crop prompt at full LM width
    (77, 8, 200, 96, 2, "router"),  # ragged K and N edges
    (300, 8, 128, 64, 1, "one"),  # all rows on one expert
    (200, 64, 256, 128, 2, "few"),  # most experts empty
])
def test_cuda_gmm_matches_twin(cuda, dtype, n, e, h, i, k, routing):
    x, experts, weights, idx = _moe_case(cuda, dtype, n, e, h, i, k, routing)
    before = (moe_gmm.moe_gmm_swiglu.launches, moe_gmm.moe_gmm_down.launches)
    got = moe_gmm.moe_ffn_gmm(x, experts, weights, idx)
    torch.cuda.synchronize()
    assert (moe_gmm.moe_gmm_swiglu.launches, moe_gmm.moe_gmm_down.launches) == (before[0] + 1, before[1] + 1)
    ref = moe_gmm.moe_ffn_gmm_reference(x, experts, weights, idx)
    assert got.dtype == dtype and got.shape == (n, h)
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)
    # Each kernel alone against its per-tile twin, on the same aligned rows.
    x_al, e_tile, tile_valid, _ = moe_gmm.align_rows(x, idx, e)
    act = moe_gmm.gmm_swiglu_reference(x_al, experts["gate"], experts["up"], e_tile, tile_valid)
    got_act = moe_gmm.moe_gmm_swiglu(x_al, experts["gate"], experts["up"], e_tile, tile_valid)
    assert float((got_act.float() - act.float()).abs().max()) <= _tol(act.float(), dtype)
    y = moe_gmm.gmm_down_reference(act, experts["down"], e_tile, tile_valid)
    got_y = moe_gmm.moe_gmm_down(act, experts["down"], e_tile, tile_valid)
    assert float((got_y.float() - y.float()).abs().max()) <= _tol(y.float(), dtype)


@pytest.mark.gpu
def test_cuda_gmm_makes_no_host_sync(cuda):
    x, experts, weights, idx = _moe_case(cuda, torch.bfloat16, 550, 64, 1280, 896, 6, "router")
    moe_gmm.moe_ffn_gmm(x, experts, weights, idx)  # builds the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe_gmm.moe_ffn_gmm(x, experts, weights, idx)
    finally:
        torch.cuda.set_sync_debug_mode(0)
