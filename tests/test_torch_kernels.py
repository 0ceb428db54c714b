"""Kernels A-X of the PyTorch port: plain twins against the JAX Pallas
kernels (interpret mode on the CPU) and the JAX XLA paths; CUDA kernels
against their twins where a card is present, and the autograd guard every
wrapper applies. (D and E's CPU parity with the
JAX package is in tests/test_torch_crop.py, S's and T's and the
differentiable MoE's in test_torch_train_gmm.py, F's in test_torch_moe_decode.py,
G's in test_torch_paged.py, H-K's in test_torch_q8.py, L-O's in
test_torch_q4.py, P's in test_torch_kvq8.py, Q and R's in
test_torch_lookup.py, U, V, W and X's in test_torch_remaining_kernels.py;
P's, Q's and R's split walks emulated in test_torch_paged_chunk_split.py,
J's stream in test_torch_moe_q8_tc.py, N's in test_torch_moe_q4_tc.py, K's
and O's split walk in test_torch_attn_fused_split.py.)

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
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu_torch.ops.flash_attention import mha, mha_reference, mha_relpos, mha_win, mha_win_reference
from deepseek_ocr2_tpu_torch.ops.fused_mlp import mlp_gelu, mlp_gelu_reference
from deepseek_ocr2_tpu_torch.ops import (attn_fused, linear_q4, linear_q8, moe_decode, moe_gmm, moe_q4, moe_q8,
                                         paged_attention)
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
    ex = {"gate": w, "up": w, "down": torch.zeros(3, 16, 8, device="meta")}
    sel = torch.zeros(4, 2, dtype=torch.long, device="meta")
    with pytest.raises(ValueError):
        moe_decode.moe_ffn_decode_fused(torch.zeros(4, 16, device="meta"), ex, torch.zeros(4, 2, device="meta"), sel)
    pool = torch.zeros(2, 3, 10, 16, 128, device="meta")
    with pytest.raises(ValueError):
        paged_attention.paged_decode_attention_pool(
            torch.zeros(4, 10, 128, device="meta"), pool, pool, torch.zeros(4, 2, dtype=torch.int32, device="meta"),
            torch.zeros(4, dtype=torch.int32, device="meta"), 1, scale=1.0)
    codes, scales = torch.zeros(2, 3, 10, 16, 128, dtype=torch.int8, device="meta"), torch.zeros(2, 3, 10, 16,
                                                                                                  device="meta")
    with pytest.raises(ValueError):
        paged_attention.paged_decode_attention_pool_q8(
            torch.zeros(4, 10, 128, device="meta"), codes, codes, scales, scales,
            torch.zeros(4, 2, dtype=torch.int32, device="meta"), torch.zeros(4, dtype=torch.int32, device="meta"),
            1, scale=1.0)


def _remaining_calls(dev, grad=False):
    """One call of each wrapper of U, V, W (both modes) and X on `dev`
    tensors of valid shapes; with `grad`, the query or x requires grad."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device=dev)

    q = torch.zeros(2, 10, 128, device=dev, requires_grad=grad)
    cache, lens = z(3, 2, 10, 64, 128), z(2, dtype=torch.int32)
    pool, bt = z(4, 10, 16, 128), z(2, 3, dtype=torch.int32)
    qw = torch.zeros(2, 12, 196, 64, device=dev, requires_grad=grad)
    x = torch.zeros(64, 16, device=dev, requires_grad=grad)
    w, wd = z(3, 8, 16), z(3, 16, 8)
    sched = tuple(z(4, dtype=torch.int32) for _ in range(4))
    return (lambda: paged_attention.decode_attention_stacked(q, cache, cache, 1, lens, scale=1.0),
            lambda: paged_attention.paged_decode_attention(q, pool, pool, bt, lens, scale=1.0),
            lambda: mha_win(qw, qw, qw, z(64, 196), z(64, 196), scale=1.0, win=14, valid=14),
            lambda: moe_gmm.gmm_swiglu_visit(x, w, w, sched, 32),
            lambda: moe_gmm.gmm_ffn_visit(x, w, w, wd, sched, 32))


def test_remaining_wrappers_refuse_other_devices_and_grad_inputs():
    """U, V, W and X as the other wrappers: a non-CPU, non-CUDA tensor raises
    (no fallback); an input that requires grad is refused with grad mode
    on, before the device is looked at."""
    for call in _remaining_calls("meta"):
        with pytest.raises(ValueError):
            call()
    for call in _remaining_calls("meta", grad=True):
        with pytest.raises(RuntimeError, match="requires grad"):
            call()


def test_autograd_guard_refuses_grad_inputs_outside_a_function():
    """A kernel's output has no autograd history: `refuse_autograd` (run by
    every wrapper's `require_cuda`) raises for an input that requires grad
    while grad mode is on, and lets it through under no_grad or when no
    input requires grad."""
    from deepseek_ocr2_tpu_torch.ops import cuda_build

    w = torch.zeros(3, 4, requires_grad=True)
    x = torch.zeros(2, 3)
    with pytest.raises(RuntimeError, match="requires grad"):
        cuda_build.refuse_autograd(x, w)
    cuda_build.refuse_autograd(x, w.detach())
    with torch.no_grad():
        cuda_build.refuse_autograd(x, w)
    # The wrappers check before they look at the device: a meta tensor that
    # requires grad is refused as such, not as a non-CUDA device.
    tiles = torch.zeros(2, dtype=torch.int32, device="meta")
    wd = torch.zeros(3, 16, 8, device="meta", requires_grad=True)
    for call in (lambda: moe_gmm.moe_gmm_down(torch.zeros(64, 8, device="meta"), wd, tiles, tiles),
                 lambda: moe_gmm.moe_gmm_dx(torch.zeros(64, 16, device="meta"), wd, tiles, tiles),
                 lambda: moe_gmm.moe_gmm_dw(torch.zeros(64, 8, device="meta", requires_grad=True),
                                            torch.zeros(64, 16, device="meta"), tiles, tiles, 3),
                 lambda: mha(*(torch.zeros(1, 1, 4, 16, device="meta", requires_grad=True),) * 3, scale=1.0)):
        with pytest.raises(RuntimeError, match="requires grad"):
            call()
        with torch.no_grad(), pytest.raises(ValueError):
            call()


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
@pytest.mark.parametrize("mode", ["none", "causal", "prefix"])
@pytest.mark.parametrize("lq", [1, 63, 64, 65, 260, 1125])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_attention_tc_matches_twin(cuda, mode, lq, d):
    """Kernel A in f32 (3xTF32 on the tensor cores) at the edges of its
    64-row query blocks and 32 / 64-key tiles and at the LM's prefill
    lengths, BH = 6, within A's 1e-4 of the f32 twin."""
    g = torch.Generator(device=cuda).manual_seed(lq + d)
    q, k, v = (torch.randn(2, 3, lq, d, generator=g, device=cuda) for _ in range(3))
    kw = dict(scale=1.0 / math.sqrt(d), mode=mode, n_prefix=lq // 2)
    before = mha.launches
    got = mha(q, k, v, **kw)
    torch.cuda.synchronize()
    assert mha.launches == before + 1
    assert float((got - mha_reference(q, k, v, **kw)).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("mode,lq,d", [("causal", 260, 128), ("prefix", 150, 128), ("none", 200, 64)])
def test_cuda_attention_tc_large_scores(cuda, mode, lq, d):
    """Scores up to ~80 (q and k scaled by 4): the 3xTF32 split's error
    grows with them (2-3e-5 in the CPU emulation, tests/test_torch_attention_tc.py)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k = (4.0 * torch.randn(2, 3, lq, d, generator=g, device=cuda) for _ in range(2))
    v = torch.randn(2, 3, lq, d, generator=g, device=cuda)
    kw = dict(scale=1.0 / math.sqrt(d), mode=mode, n_prefix=lq // 2)
    assert float((mha(q, k, v, **kw) - mha_reference(q, k, v, **kw)).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,side", [(1, 64), (25, 14), (2, 9), (6, 48), (96, 14)])
def test_cuda_relpos_matches_twin(cuda, dtype, b, side):
    """SAM's four shapes (the 1024^2 view's global and window attention,
    six crops' global and window attention) and an odd grid; in f32 the
    tensor-core kernel (Kw 9: the unpaired bias reads). The output's block
    is filled with NaN first: a row left unwritten shows."""
    g = torch.Generator(device=cuda).manual_seed(1)
    l = side * side
    q, k, v = (torch.randn(b, 12, l, 64, generator=g, device=cuda).to(dtype) for _ in range(3))
    rh, rw = (0.3 * torch.randn(b, 12, l, side, generator=g, device=cuda) for _ in range(2))
    torch.full_like(q, float("nan"))
    before = mha_relpos.launches
    got = mha_relpos(q, k, v, rh, rw, scale=0.125)
    torch.cuda.synchronize()
    assert mha_relpos.launches == before + 1
    ref = mha_reference(q, k, v, scale=0.125, rel_h=rh, rel_w=rw)
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_relpos_refuses_other_head_dims(cuda, dtype):
    """B runs the tensor-core kernel at SAM's head dim 64 only, in both
    dtypes."""
    q = torch.zeros(1, 2, 16, 128, device=cuda, dtype=dtype)
    rh = torch.zeros(1, 2, 16, 4, device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        mha_relpos(q, q, q, rh, rh, scale=0.125)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,e,f", [(4096, 768, 3072), (2304, 768, 3072), (13824, 768, 3072), (300, 768, 3072),
                                   (100, 32, 64), (33, 200, 96)])
def test_cuda_mlp_matches_twin(cuda, dtype, m, e, f):
    """SAM's MLP at a 1024^2 view (M 4096), a 768^2 crop (2304), six crops
    (13 824) and a ragged M (300: the last 128-row tile clipped), and
    narrow widths. The blocks the output and the intermediate will reuse
    are filled with NaN first: a tile left unwritten shows."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(m, e, generator=g, device=cuda).to(dtype)
    w1 = (torch.randn(f, e, generator=g, device=cuda) * e**-0.5).to(dtype)
    w2 = (torch.randn(e, f, generator=g, device=cuda) * f**-0.5).to(dtype)
    b1 = (0.02 * torch.randn(f, generator=g, device=cuda)).to(dtype)
    b2 = (0.02 * torch.randn(e, generator=g, device=cuda)).to(dtype)
    torch.full((m, f), float("nan"), dtype=dtype, device=cuda)
    torch.full((m, e), float("nan"), dtype=dtype, device=cuda)
    before = mlp_gelu.launches
    got = mlp_gelu(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert mlp_gelu.launches == before + 1
    ref = mlp_gelu_reference(x, w1, b1, w2, b2)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)


def _moe_case(dev, dtype, n, e, h, i, k, routing):
    """Experts with fan-in scaled weights; `routing` is "router" (a random
    f32 router: realistic group sizes), "one" (every row on expert 5),
    "few" (every row on experts 0-2, the others empty) or "tiles" (k = 1,
    e = 8, n = 515: groups of 32, 128, 160, 33, 0, 97, 1 and 64 rows, i.e.
    1, 4, 5, 2, 0, 4, 1 and 2 row tiles, in a random order of tokens)."""
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
    elif routing == "tiles":
        sizes = torch.tensor([32, 128, 160, 33, 0, 97, 1, 64], device=dev)
        assert (n, k, e) == (int(sizes.sum()), 1, sizes.numel())
        groups = torch.repeat_interleave(torch.arange(e, device=dev), sizes)
        idx = groups[torch.randperm(n, generator=g, device=dev)][:, None]
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


def _f32_tol(ref):
    return 1e-4 * max(1.0, float(ref.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,e,h,i,k,routing", [
    (2048, 64, 1280, 896, 6, "router"),  # a training batch's MoE layer at full LM width
    (77, 8, 200, 96, 2, "router"),  # ragged C and O edges
    (300, 8, 264, 136, 2, "router"),  # O and C not multiples of 128: 264 and 136 both ways
    (200, 64, 256, 128, 2, "few"),  # most experts empty: T writes their zeros
    (515, 8, 256, 128, 1, "tiles"),  # experts of 1, 4 and 5 tiles: S's and E's partial last row block
    (2048, 64, 1280, 896, 6, "one"),  # 12 288 rows on one expert: T's longest walk, 96 S / E row blocks
])
def test_cuda_gmm_backward_kernels_match_twins(cuda, dtype, n, e, h, i, k, routing):
    """S (dact = dy Wd, dx = dgate Wg), T (dW of gate and down) and E at
    the gate/up shape (K = H, N = I) and the down shape (K = I, N = H),
    each against its twin on the same aligned rows. T's sums are f32 over
    exact products: the f32 bound for both dtypes. S's and E's rows past
    the last valid tile must read as zeros: in bf16 (one kernel, S's row
    blocks) the wrapper hands the kernel an uninitialized output."""
    x, experts, weights, idx = _moe_case(cuda, dtype, n, e, h, i, k, routing)
    x_al, e_tile, tile_valid, _ = moe_gmm.align_rows(x, idx, e)
    g = torch.Generator(device=cuda).manual_seed(6)
    dy = torch.randn(x_al.shape[0], h, generator=g, device=cuda).to(dtype)
    dgate = torch.randn(x_al.shape[0], i, generator=g, device=cuda).to(dtype)
    before = (moe_gmm.moe_gmm_dx.launches, moe_gmm.moe_gmm_dw.launches, moe_gmm.moe_gmm_down.launches)
    cases = [
        (moe_gmm.moe_gmm_dx, moe_gmm.gmm_dx_reference, (dy, experts["down"], e_tile, tile_valid), _tol),
        (moe_gmm.moe_gmm_dx, moe_gmm.gmm_dx_reference, (dgate, experts["gate"], e_tile, tile_valid), _tol),
        (moe_gmm.moe_gmm_down, moe_gmm.gmm_down_reference, (x_al, experts["gate"], e_tile, tile_valid), _tol),
        (moe_gmm.moe_gmm_down, moe_gmm.gmm_down_reference, (dgate, experts["down"], e_tile, tile_valid), _tol),
        (moe_gmm.moe_gmm_dw, moe_gmm.gmm_dw_reference, (x_al, dgate, e_tile, tile_valid, e), None),
        (moe_gmm.moe_gmm_dw, moe_gmm.gmm_dw_reference, (dgate, dy, e_tile, tile_valid, e), None),
    ]
    for kernel, twin, args, tol in cases:
        if kernel is not moe_gmm.moe_gmm_dw:
            # NaNs in the block the wrapper's output will reuse: a row the
            # kernel fails to write shows.
            n_out = args[1].shape[2] if kernel is moe_gmm.moe_gmm_dx else args[1].shape[1]
            torch.full((args[0].shape[0], n_out), float("nan"), dtype=dtype, device=cuda)
        got = kernel(*args)
        torch.cuda.synchronize()
        ref = twin(*args)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        bound = _tol(ref.float(), dtype) if tol else _f32_tol(ref)
        assert float((got.float() - ref.float()).abs().max()) <= bound, kernel.__name__
    assert (moe_gmm.moe_gmm_dx.launches, moe_gmm.moe_gmm_dw.launches, moe_gmm.moe_gmm_down.launches) == (
        before[0] + 2, before[1] + 2, before[2] + 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_gmm_function_backward_matches_autograd_of_the_twin(cuda, dtype):
    """`moe_ffn_gmm`'s gradients on the card (E, S, T) against plain
    autograd through the grouped twin, computed in f32 from the same
    inputs: f32 within 1e-4 of each leaf's largest entry; bf16 within
    2e-2, the Function's bf16 rounding points against f32 autograd. Then a
    forward and backward under sync-debug "error"."""
    x, experts, weights, idx = _moe_case(cuda, dtype, 550, 64, 1280, 896, 6, "router")
    g = torch.Generator(device=cuda).manual_seed(7)
    cot = torch.randn(550, 1280, generator=g, device=cuda)

    def grads(fn, up):
        leaves = [t.detach().to(up).requires_grad_() for t in (x, experts["gate"], experts["up"], experts["down"])]
        w = weights.detach().clone().requires_grad_()
        out = fn(leaves[0], dict(zip(("gate", "up", "down"), leaves[1:])), w, idx)
        return torch.autograd.grad((out.float() * cot).sum(), [*leaves, w])

    counts = (moe_gmm.moe_gmm_down.launches, moe_gmm.moe_gmm_dx.launches, moe_gmm.moe_gmm_dw.launches)
    got = grads(moe_gmm.moe_ffn_gmm, dtype)
    torch.cuda.synchronize()
    assert (moe_gmm.moe_gmm_down.launches, moe_gmm.moe_gmm_dx.launches, moe_gmm.moe_gmm_dw.launches) == (
        counts[0] + 4, counts[1] + 3, counts[2] + 3)
    want = grads(moe_gmm.moe_ffn_gmm_reference, torch.float32)
    for a, b in zip(got, want):
        scale = max(1e-6, float(b.abs().max()))
        assert float((a.float() - b).abs().max()) <= (1e-4 if dtype == torch.float32 else 2e-2) * scale
    torch.cuda.set_sync_debug_mode("error")
    try:
        grads(moe_gmm.moe_ffn_gmm, dtype)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# Kernels F (batched-decode MoE) and G (paged decode attention) against
# their twins, at the serving shapes: 64 experts of the full-width LM, top-6,
# H = 1280, I = 896; a [12, P, 10, 128, 128] pool with 128-token pages.


def _decode_moe_case(dev, dtype, b, e=64, h=1280, i=896, k=6, seed=5):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, generator=g, device=dev).to(dtype)
    experts = {
        name: (torch.randn(e, *shape, generator=g, device=dev) * shape[1] ** -0.5).to(dtype)
        for name, shape in (("gate", (i, h)), ("up", (i, h)), ("down", (h, i)))
    }
    weights, idx = route(x, torch.randn(e, h, generator=g, device=dev) * h**-0.5, k)
    return x, experts, weights, idx


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b", [(torch.bfloat16, 16), (torch.bfloat16, 32), (torch.float32, 16),
                                     (torch.bfloat16, 5), (torch.float32, 40), (torch.bfloat16, 17),
                                     (torch.bfloat16, 40)])
def test_cuda_moe_decode_matches_twin(cuda, dtype, b):
    """bf16 at B 17 (a second row tile holding one row) and 40 (a second
    group of 32 rows). The output's block is filled with NaN first: a row
    left unwritten shows."""
    x, experts, weights, idx = _decode_moe_case(cuda, dtype, b)
    torch.full_like(x, float("nan"))
    before = moe_decode.moe_ffn_decode_fused.launches
    got = moe_decode.moe_ffn_decode_fused(x, experts, weights, idx)
    torch.cuda.synchronize()
    assert moe_decode.moe_ffn_decode_fused.launches == before + 1
    ref = moe_decode.moe_ffn_decode_visits_reference(x, experts, weights, idx)
    assert got.dtype == dtype and got.shape == x.shape
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)


@pytest.mark.gpu
def test_cuda_moe_decode_rows_do_not_depend_on_the_batch(cuda):
    """No atomics, a fixed visit order: a row's output is bit-identical from
    run to run and whatever the other rows select (a visit it did not select
    adds an exact zero), which preemption in the continuous engine needs."""
    x, experts, weights, idx = _decode_moe_case(cuda, torch.bfloat16, 16)
    a = moe_decode.moe_ffn_decode_fused(x, experts, weights, idx)
    assert torch.equal(a, moe_decode.moe_ffn_decode_fused(x, experts, weights, idx))
    idx2, w2 = idx.clone(), weights.clone()
    idx2[1:] = (idx2[1:] + 7) % 64  # every other row picks other experts
    w2[1:] = w2[1:].flip(1)
    b = moe_decode.moe_ffn_decode_fused(x, experts, w2, idx2)
    assert torch.equal(a[0], b[0])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_moe_decode_graph_replay_equals_eager(cuda, dtype):
    """F captured in a CUDA graph (the static decode batch) replays to the
    eager call's bits, on new inputs copied into the captured buffers."""
    x, experts, weights, idx = _decode_moe_case(cuda, dtype, 16)
    x2, _, w2, idx2 = _decode_moe_case(cuda, dtype, 16, seed=9)
    moe_decode.moe_ffn_decode_fused(x, experts, weights, idx)  # builds the library first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = moe_decode.moe_ffn_decode_fused(x, experts, weights, idx)
    for xs, ws, ids in ((x, weights, idx), (x2, w2, idx2)):
        x.copy_(xs), weights.copy_(ws), idx.copy_(ids)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, moe_decode.moe_ffn_decode_fused(x, experts, weights, idx))


@pytest.mark.gpu
def test_cuda_moe_decode_makes_no_host_sync(cuda):
    x, experts, weights, idx = _decode_moe_case(cuda, torch.bfloat16, 16)
    moe_decode.moe_ffn_decode_fused(x, experts, weights, idx)  # builds the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        moe_decode.moe_ffn_decode_fused(x, experts, weights, idx)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _paged_case(dev, dtype, b=16, n_pages=64, page=128, seed=6):
    """A [12, P, 10, 128, 128] pool, ragged lengths 260..2048, random block
    tables over pages 1..P-1; the last row points at the scratch page 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (12, n_pages, 10, page, 128)
    k_pool = torch.randn(shape, generator=g, device=dev).to(dtype)
    v_pool = torch.randn(shape, generator=g, device=dev).to(dtype)
    q = torch.randn(b, 10, 128, generator=g, device=dev)
    max_pages = 2048 // page
    bt = torch.randint(1, n_pages, (b, max_pages), generator=g, device=dev, dtype=torch.int32)
    bt[-1] = 0
    seq_lens = torch.linspace(260, 2048, b, device=dev).round().to(torch.int32)
    return q, k_pool, v_pool, bt, seq_lens


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", [0, 11])
def test_cuda_paged_attention_matches_twin(cuda, dtype, layer):
    q, k_pool, v_pool, bt, seq_lens = _paged_case(cuda, dtype)
    before = paged_attention.paged_decode_attention_pool.launches
    got = paged_attention.paged_decode_attention_pool(q, k_pool, v_pool, bt, seq_lens, layer, scale=128**-0.5)
    torch.cuda.synchronize()
    assert paged_attention.paged_decode_attention_pool.launches == before + 1
    ref = paged_attention.paged_decode_attention_reference(q, k_pool[layer], v_pool[layer], bt, seq_lens,
                                                           scale=128**-0.5)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert float((got - ref).abs().max()) <= 1e-4  # f32 math on both sides, whatever the pool's type


@pytest.mark.gpu
def test_cuda_paged_attention_small_pages(cuda):
    q, k_pool, v_pool, bt, seq_lens = _paged_case(cuda, torch.float32, b=5, n_pages=300, page=16)
    got = paged_attention.paged_decode_attention_pool(q, k_pool, v_pool, bt, seq_lens, 3, scale=0.1)
    ref = paged_attention.paged_decode_attention_reference(q, k_pool[3], v_pool[3], bt, seq_lens, scale=0.1)
    assert float((got - ref).abs().max()) <= 1e-4


_PAGED_EDGES = [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 300, 2047, 2048]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,page", [(1, 128), (16, 128), (13, 100), (13, 16)])
def test_cuda_paged_attention_split_edges(cuda, dtype, b, page):
    """G's split-key walk at one and 16 rows (pages of 128: two 64-key
    chunks a page) and at pages of 100 (chunks of 64 and 36) and 16 (one
    chunk a page): lengths at the edges of the warps', chunks' and pages'
    keys, each row taking each length in turn. The output's and the
    workspace's blocks are filled with NaN first: a dim left unwritten or a
    partial read before it was written shows."""
    q, k_pool, v_pool, bt, _ = _paged_case(cuda, dtype, b=b, n_pages=300 if page == 16 else 64, page=page)
    max_pages = bt.shape[1]
    n_part = b * 10 * paged_attention.paged_chunks(page, max_pages) * paged_attention.U_PART
    edges = [n for n in _PAGED_EDGES if n <= max_pages * page]
    for shift in range(len(edges)):
        seq = torch.tensor([edges[(i + shift) % len(edges)] for i in range(b)], dtype=torch.int32, device=cuda)
        torch.full_like(q, float("nan"))
        torch.full((n_part,), float("nan"), device=cuda)
        before = paged_attention.paged_decode_attention_pool.launches
        got = paged_attention.paged_decode_attention_pool(q, k_pool, v_pool, bt, seq, 5, scale=128**-0.5)
        torch.cuda.synchronize()
        assert paged_attention.paged_decode_attention_pool.launches == before + 1
        ref = paged_attention.paged_decode_attention_reference(q, k_pool[5], v_pool[5], bt, seq, scale=128**-0.5)
        assert float((got - ref).abs().max()) <= 1e-4, seq.tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_attention_is_bit_identical_and_row_independent(cuda, dtype):
    """G merges a row's partials in ascending chunk order, fixed by the
    row's own length and the page size, whichever block merges: the same
    call twice is bit-equal, and so is a row whose neighbours' lengths,
    block tables and pages change, or that runs alone at B 1."""
    q, k_pool, v_pool, bt, seq = _paged_case(cuda, dtype, b=16, seed=60)
    kw = dict(scale=128**-0.5)
    first = paged_attention.paged_decode_attention_pool(q, k_pool, v_pool, bt, seq, 2, **kw)
    again = paged_attention.paged_decode_attention_pool(q, k_pool, v_pool, bt, seq, 2, **kw)
    assert torch.equal(first, again)
    others = torch.arange(16, device=cuda) % 2 == 1
    seq2 = torch.where(others, 2308 - seq, seq).to(torch.int32)
    bt2 = bt.clone()
    bt2[others] = bt[others].flip(1)
    changed = paged_attention.paged_decode_attention_pool(q, k_pool, v_pool, bt2, seq2, 2, **kw)
    assert torch.equal(changed[~others], first[~others])
    for r in (0, 8, 15):
        alone = paged_attention.paged_decode_attention_pool(q[r:r + 1], k_pool, v_pool, bt[r:r + 1], seq[r:r + 1],
                                                            2, **kw)
        assert torch.equal(alone[0], first[r]), r


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 16])
def test_cuda_paged_attention_replays_in_a_cuda_graph(cuda, b):
    """G captured once (its workspace allocated inside the capture, its
    arrival counters made by an eager call before) and replayed three times
    after q and the lengths change in place, as a decode step's graph
    would: each replay matches the twin on the new inputs, which it can
    only if every merging block set its counter back to zero. Before the
    second replay an eager call with more (row, head) pairs than the counter
    buffer holds makes it grow: the graph still launches on the old buffer,
    which must stay alive and zero."""
    q, k_pool, v_pool, bt, seq = _paged_case(cuda, torch.bfloat16, b=b, seed=70)
    if b == 1:
        seq.fill_(300)
    g = torch.Generator(device=cuda).manual_seed(71)
    kw = dict(scale=128**-0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention.paged_decode_attention_pool(q, k_pool, v_pool, bt, seq, 7, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention.paged_decode_attention_pool(q, k_pool, v_pool, bt, seq, 7, **kw)
    for step in range(3):
        q.copy_(torch.randn(q.shape, generator=g, device=cuda))
        seq.sub_(step * 37 + 1)
        if step == 1:
            wide = paged_attention._COUNTERS[q.get_device()].numel() // q.shape[1] + 1
            paged_attention.paged_decode_attention_pool(q[:1].expand(wide, -1, -1).contiguous(), k_pool, v_pool,
                                                        bt[:1].expand(wide, -1).contiguous(),
                                                        seq[:1].expand(wide).contiguous(), 7, **kw)
        graph.replay()
        torch.cuda.synchronize()
        ref = paged_attention.paged_decode_attention_reference(q, k_pool[7], v_pool[7], bt, seq, **kw)
        assert float((out - ref).abs().max()) <= 1e-4, step


def _paged_q8_case(dev, tail, lens, page, finished, seed=7):
    """Kernel P's inputs: a 2-layer int8 pool with 10 heads of 128, random
    codes in [-127, 127] and scales, row-exclusive block tables (as the
    engine keeps them: the twin's open-page patch needs it), bf16 open pages
    one a row in tail mode; with `finished` the last row points at the
    scratch page 0 only."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, max_pages = len(lens), -(-max(lens) // page)
    n_pages = b * max_pages + 1
    codes = [torch.randint(-127, 128, (2, n_pages, 10, page, 128), generator=g, device=dev, dtype=torch.int8)
             for _ in range(2)]
    scales = [torch.rand(2, n_pages, 10, page, generator=g, device=dev) * 0.02 + 1e-3 for _ in range(2)]
    opens = [torch.randn(2, b, 10, page, 128, generator=g, device=dev).to(torch.bfloat16) for _ in range(2)] \
        if tail else [None, None]
    bt = (torch.randperm(n_pages - 1, generator=g, device=dev)[: b * max_pages] + 1).reshape(b, max_pages)
    bt = bt.to(torch.int32)
    if finished:
        bt[-1] = 0
    q = torch.randn(b, 10, 128, generator=g, device=dev)
    return q, codes, scales, opens, bt, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("b,page", [(1, 16), (1, 128), (3, 16), (3, 128), (16, 16), (16, 128)])
def test_cuda_paged_q8_matches_twin(cuda, tail, b, page):
    """Lengths 1, page, page + 1 and 2048 (a row whose last page is its
    first, one that ends on a page end, one a token past it); at B >= 3 the
    last row is finished on the scratch page 0. In tail mode a finished
    row's output is not compared: the kernel reads codes for its earlier
    pages, the twin's patch puts its open page on every page-0 entry, and
    the engine discards it either way."""
    edge = [1, page, page + 1, 2048]
    cases = [[n] for n in edge] if b == 1 else [[edge[(i + r) % 4] for i in range(b)] for r in range(2)]
    for lens in cases:
        q, (kc, vc), (ks, vs), (ok, ov), bt, seq_lens = _paged_q8_case(cuda, tail, lens, page, finished=b > 1)
        before = paged_attention.paged_decode_attention_pool_q8.launches
        got = paged_attention.paged_decode_attention_pool_q8(q, kc, vc, ks, vs, bt, seq_lens, 1, scale=128**-0.5,
                                                             open_k=ok, open_v=ov)
        torch.cuda.synchronize()
        assert paged_attention.paged_decode_attention_pool_q8.launches == before + 1
        ref = paged_attention.paged_decode_attention_q8_reference(q, kc, vc, ks, vs, bt, seq_lens, 1,
                                                                  scale=128**-0.5, open_k=ok, open_v=ov)
        live = slice(None, -1) if tail and b > 1 else slice(None)
        assert got.shape == q.shape and bool(torch.isfinite(got).all())
        assert float((got[live] - ref[live]).abs().max()) <= 1e-4, lens  # f32 math on both sides


@pytest.mark.gpu
def test_cuda_paged_q8_makes_no_host_sync(cuda):
    q, (kc, vc), (ks, vs), (ok, ov), bt, seq_lens = _paged_q8_case(cuda, True, [300, 5, 2048], 128, True)
    args = (q, kc, vc, ks, vs, bt, seq_lens, 1)
    paged_attention.paged_decode_attention_pool_q8(*args, scale=0.1, open_k=ok, open_v=ov)  # builds first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        paged_attention.paged_decode_attention_pool_q8(*args, scale=0.1, open_k=ok, open_v=ov)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("b,page", [(1, 128), (16, 128), (17, 100), (17, 16)])
def test_cuda_paged_q8_split_edges(cuda, tail, b, page):
    """P's split-key walk (G's, over int8 codes) at one, 16 and 17 rows,
    pages of 128 (two 64-key chunks a page), 100 (chunks of 64 and 36) and
    16 (one chunk a page): lengths at the edges of the warps', chunks' and
    pages' keys, each row taking each length in turn. The output's and the
    workspace's blocks are filled with NaN first: a dim left unwritten or a
    partial read before it was written shows. At B > 1 the last row is
    finished on the scratch page 0, and in tail mode not compared (see
    test_cuda_paged_q8_matches_twin)."""
    for shift in range(len(_PAGED_EDGES)):
        lens = [_PAGED_EDGES[(i + shift) % len(_PAGED_EDGES)] for i in range(b)]
        q, (kc, vc), (ks, vs), (ok, ov), bt, seq = _paged_q8_case(cuda, tail, lens, page, finished=b > 1,
                                                                 seed=shift)
        n_part = b * 10 * paged_attention.paged_chunks(page, bt.shape[1]) * paged_attention.U_PART
        torch.full_like(q, float("nan"))
        torch.full((n_part,), float("nan"), device=cuda)
        before = paged_attention.paged_decode_attention_pool_q8.launches
        got = paged_attention.paged_decode_attention_pool_q8(q, kc, vc, ks, vs, bt, seq, 1, scale=128**-0.5,
                                                             open_k=ok, open_v=ov)
        torch.cuda.synchronize()
        assert paged_attention.paged_decode_attention_pool_q8.launches == before + 1
        ref = paged_attention.paged_decode_attention_q8_reference(q, kc, vc, ks, vs, bt, seq, 1, scale=128**-0.5,
                                                                  open_k=ok, open_v=ov)
        live = slice(None, -1) if tail and b > 1 else slice(None)
        assert float((got[live] - ref[live]).abs().max()) <= 1e-4, lens


@pytest.mark.gpu
@pytest.mark.parametrize("tail", [False, True])
def test_cuda_paged_q8_is_bit_identical_and_row_independent(cuda, tail):
    """P merges a row's partials in ascending chunk order, fixed by the
    row's own length and the page size, whichever block merges: the same
    call twice is bit-equal, and so is a row whose neighbours' lengths and
    block tables change, or that runs alone at B 1 (with its own open
    page)."""
    lens = torch.linspace(260, 2048, 16).round().int().tolist()
    q, (kc, vc), (ks, vs), (ok, ov), bt, seq = _paged_q8_case(cuda, tail, lens, 128, finished=False, seed=61)
    args, kw = (kc, vc, ks, vs), dict(scale=128**-0.5)
    opens = dict(open_k=ok, open_v=ov)
    first = paged_attention.paged_decode_attention_pool_q8(q, *args, bt, seq, 1, **kw, **opens)
    again = paged_attention.paged_decode_attention_pool_q8(q, *args, bt, seq, 1, **kw, **opens)
    assert torch.equal(first, again)
    others = torch.arange(16, device=cuda) % 2 == 1
    seq2 = torch.where(others, 2308 - seq, seq).to(torch.int32)
    bt2 = bt.clone()
    bt2[others] = bt[others].flip(1)
    changed = paged_attention.paged_decode_attention_pool_q8(q, *args, bt2, seq2, 1, **kw, **opens)
    assert torch.equal(changed[~others], first[~others])
    for r in (0, 8, 15):
        own = {k: v[:, r:r + 1].contiguous() for k, v in opens.items()} if tail else {}
        alone = paged_attention.paged_decode_attention_pool_q8(q[r:r + 1], *args, bt[r:r + 1], seq[r:r + 1], 1, **kw,
                                                               **own)
        assert torch.equal(alone[0], first[r]), r


@pytest.mark.gpu
@pytest.mark.parametrize("tail", [False, True])
def test_cuda_paged_q8_replays_in_a_cuda_graph(cuda, tail):
    """P captured once (its workspace allocated inside the capture, the
    shared arrival counters made by an eager call before) and replayed three
    times after q and the lengths change in place: each replay matches the
    twin on the new inputs, which it can only if every merging block set its
    counter back to zero."""
    lens = torch.linspace(260, 2048, 16).round().int().tolist()
    q, (kc, vc), (ks, vs), (ok, ov), bt, seq = _paged_q8_case(cuda, tail, lens, 128, finished=False, seed=71)
    g = torch.Generator(device=cuda).manual_seed(72)
    args, kw = (kc, vc, ks, vs), dict(scale=128**-0.5, open_k=ok, open_v=ov)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention.paged_decode_attention_pool_q8(q, *args, bt, seq, 1, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention.paged_decode_attention_pool_q8(q, *args, bt, seq, 1, **kw)
    for step in range(3):
        q.copy_(torch.randn(q.shape, generator=g, device=cuda))
        seq.sub_(step * 37 + 1)
        graph.replay()
        torch.cuda.synchronize()
        ref = paged_attention.paged_decode_attention_q8_reference(q, *args, bt, seq, 1, **kw)
        assert float((out - ref).abs().max()) <= 1e-4, step


# ---------------------------------------------------------------------------
# Kernels Q and R (the chunk forms of G and P: S queries a row, each at its
# own budget) against their twins. A row's budgets are largest - S + 1 ..
# largest; the largest are S (the chunk opens the row), page + 2 (the chunk
# crosses a page end), 2 page - 1, 700 and 2048; the last row is finished on
# the scratch page 0 (in tail mode not compared, as for P).


def _chunk_budgets(dev, s, page):
    ends = torch.tensor([s, page + 2, 2 * page - 1, 700, 2048], dtype=torch.int32, device=dev)
    return (ends[:, None] - s + 1 + torch.arange(s, dtype=torch.int32, device=dev)).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("page", [16, 128])
def test_cuda_paged_chunk_matches_twin(cuda, dtype, s, page):
    g = torch.Generator(device=cuda).manual_seed(8)
    n_pages = 300
    k_pool, v_pool = (torch.randn(3, n_pages, 10, page, 128, generator=g, device=cuda).to(dtype) for _ in range(2))
    lens = _chunk_budgets(cuda, s, page)
    b = lens.shape[0]
    bt = torch.randint(1, n_pages, (b, 2048 // page), generator=g, device=cuda, dtype=torch.int32)
    bt[-1] = 0
    q = torch.randn(b, s, 10, 128, generator=g, device=cuda)
    before = paged_attention.paged_decode_attention_pool_chunk.launches
    got = paged_attention.paged_decode_attention_pool_chunk(q, k_pool, v_pool, bt, lens, 2, scale=128**-0.5)
    torch.cuda.synchronize()
    assert paged_attention.paged_decode_attention_pool_chunk.launches == before + 1
    ref = paged_attention.paged_decode_attention_chunk_reference(q, k_pool[2], v_pool[2], bt, lens, scale=128**-0.5)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert float((got - ref).abs().max()) <= 1e-4  # f32 math on both sides, whatever the pool's type


@pytest.mark.gpu
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("s", [2, 4, 8])
@pytest.mark.parametrize("page", [16, 128])
def test_cuda_paged_chunk_q8_matches_twin(cuda, tail, s, page):
    lens = _chunk_budgets(cuda, s, page)
    _, (kc, vc), (ks, vs), (ok, ov), bt, _ = _paged_q8_case(cuda, tail, lens[:, -1].tolist(), page, finished=True)
    q = torch.randn(lens.shape[0], s, 10, 128, generator=torch.Generator(device=cuda).manual_seed(9), device=cuda)
    before = paged_attention.paged_decode_attention_pool_chunk_q8.launches
    got = paged_attention.paged_decode_attention_pool_chunk_q8(q, kc, vc, ks, vs, bt, lens, 1, scale=128**-0.5,
                                                               open_k=ok, open_v=ov)
    torch.cuda.synchronize()
    assert paged_attention.paged_decode_attention_pool_chunk_q8.launches == before + 1
    ref = paged_attention.paged_decode_attention_chunk_q8_reference(q, kc, vc, ks, vs, bt, lens, 1,
                                                                    scale=128**-0.5, open_k=ok, open_v=ov)
    live = slice(None, -1) if tail else slice(None)
    assert got.shape == q.shape and bool(torch.isfinite(got).all())
    assert float((got[live] - ref[live]).abs().max()) <= 1e-4  # f32 math on both sides


@pytest.mark.gpu
def test_cuda_paged_chunk_kernels_make_no_host_sync_and_check_s(cuda):
    lens = _chunk_budgets(cuda, 4, 128)
    _, (kc, vc), (ks, vs), (ok, ov), bt, _ = _paged_q8_case(cuda, True, lens[:, -1].tolist(), 128, finished=True)
    q = torch.randn(lens.shape[0], 4, 10, 128, device=cuda)
    pool = kc.float()
    calls = [lambda: paged_attention.paged_decode_attention_pool_chunk(q, pool, pool, bt, lens, 1, scale=0.1),
             lambda: paged_attention.paged_decode_attention_pool_chunk_q8(q, kc, vc, ks, vs, bt, lens, 1, scale=0.1,
                                                                          open_k=ok, open_v=ov)]
    for call in calls:
        call()  # builds first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    q9 = torch.randn(lens.shape[0], 9, 10, 128, device=cuda)
    with pytest.raises(ValueError, match="2..8 queries"):
        paged_attention.paged_decode_attention_pool_chunk(q9, pool, pool, bt, lens.repeat(1, 3)[:, :9].contiguous(),
                                                          1, scale=0.1)


def _chunk_case(dev, dtype, b, page, s, seed):
    """Kernel Q's inputs: a [3, P, 10, page, 128] pool (300 pages at page
    16), random block tables over pages 1.. reaching 2048 keys, the last
    row on the scratch page 0, q [b, s, 10, 128]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 300 if page == 16 else 64
    k_pool, v_pool = (torch.randn(3, n_pages, 10, page, 128, generator=g, device=dev).to(dtype) for _ in range(2))
    bt = torch.randint(1, n_pages, (b, -(-2048 // page)), generator=g, device=dev, dtype=torch.int32)
    bt[-1] = 0
    return torch.randn(b, s, 10, 128, generator=g, device=dev), k_pool, v_pool, bt


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,page", [(1, 128), (16, 128), (17, 100), (17, 16)])
def test_cuda_paged_chunk_split_edges(cuda, dtype, b, page):
    """Q's split-key walk at S = 2..8, one, 16 and 17 rows, pages of 128,
    100 and 16: each row's largest budget at the edges of the warps',
    chunks' and pages' keys (at least S), its S budgets ending there, each
    row taking each end in turn (every other one at each S); the output's
    and the workspace's blocks filled with NaN first."""
    for s in range(2, 9):
        q, k_pool, v_pool, bt = _chunk_case(cuda, dtype, b, page, s, seed=s)
        ends = [n for n in _PAGED_EDGES if n >= s]
        n_part = b * 10 * paged_attention.paged_chunks(page, bt.shape[1]) * s * paged_attention.U_PART
        for shift in range(s % 2, len(ends), 2):
            end = torch.tensor([ends[(i + shift) % len(ends)] for i in range(b)], dtype=torch.int32, device=cuda)
            lens = (end[:, None] - s + 1 + torch.arange(s, dtype=torch.int32, device=cuda)).contiguous()
            torch.full_like(q, float("nan"))
            torch.full((n_part,), float("nan"), device=cuda)
            before = paged_attention.paged_decode_attention_pool_chunk.launches
            got = paged_attention.paged_decode_attention_pool_chunk(q, k_pool, v_pool, bt, lens, 2, scale=128**-0.5)
            torch.cuda.synchronize()
            assert paged_attention.paged_decode_attention_pool_chunk.launches == before + 1
            ref = paged_attention.paged_decode_attention_chunk_reference(q, k_pool[2], v_pool[2], bt, lens,
                                                                         scale=128**-0.5)
            assert float((got - ref).abs().max()) <= 1e-4, (s, end.tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_chunk_is_bit_identical_and_row_independent(cuda, dtype):
    """Q merges each query's partials in ascending chunk order and a query
    with no live key in a chunk adds exact zeros: the same call twice is
    bit-equal, so is a row whose neighbours' budgets and block tables change
    or that runs alone at B 1, and query i of every row is bit-equal to
    kernel G at its budget, whatever the other queries' budgets."""
    s = 4
    q, k_pool, v_pool, bt = _chunk_case(cuda, dtype, 16, 128, s, seed=62)
    end = torch.linspace(260, 2048, 16, device=cuda).round().to(torch.int32)
    lens = (end[:, None] - 3 * torch.arange(s, dtype=torch.int32, device=cuda).flip(0) ** 2).contiguous()
    kw = dict(scale=128**-0.5)
    first = paged_attention.paged_decode_attention_pool_chunk(q, k_pool, v_pool, bt, lens, 1, **kw)
    again = paged_attention.paged_decode_attention_pool_chunk(q, k_pool, v_pool, bt, lens, 1, **kw)
    assert torch.equal(first, again)
    others = torch.arange(16, device=cuda) % 2 == 1
    lens2 = torch.where(others[:, None], 2308 - lens, lens).to(torch.int32).contiguous()
    bt2 = bt.clone()
    bt2[others] = bt[others].flip(1)
    changed = paged_attention.paged_decode_attention_pool_chunk(q, k_pool, v_pool, bt2, lens2, 1, **kw)
    assert torch.equal(changed[~others], first[~others])
    for r in (0, 8, 15):
        alone = paged_attention.paged_decode_attention_pool_chunk(q[r:r + 1], k_pool, v_pool, bt[r:r + 1],
                                                                  lens[r:r + 1], 1, **kw)
        assert torch.equal(alone[0], first[r]), r
    for i in range(s):
        g_out = paged_attention.paged_decode_attention_pool(q[:, i].contiguous(), k_pool, v_pool, bt,
                                                            lens[:, i].contiguous(), 1, **kw)
        assert torch.equal(g_out, first[:, i]), i


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_chunk_replays_in_a_cuda_graph(cuda, dtype):
    """Q captured once (workspace inside the capture, counters made by an
    eager call before) and replayed three times after q and the budgets
    change in place: each replay matches the twin on the new inputs."""
    q, k_pool, v_pool, bt = _chunk_case(cuda, dtype, 16, 128, 4, seed=73)
    end = torch.linspace(300, 2000, 16, device=cuda).round().to(torch.int32)
    lens = (end[:, None] - 3 + torch.arange(4, dtype=torch.int32, device=cuda)).contiguous()
    g = torch.Generator(device=cuda).manual_seed(74)
    kw = dict(scale=128**-0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention.paged_decode_attention_pool_chunk(q, k_pool, v_pool, bt, lens, 0, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention.paged_decode_attention_pool_chunk(q, k_pool, v_pool, bt, lens, 0, **kw)
    for step in range(3):
        q.copy_(torch.randn(q.shape, generator=g, device=cuda))
        lens.sub_(step * 37 + 1)
        graph.replay()
        torch.cuda.synchronize()
        ref = paged_attention.paged_decode_attention_chunk_reference(q, k_pool[0], v_pool[0], bt, lens, **kw)
        assert float((out - ref).abs().max()) <= 1e-4, step


def _chunk_q8_case(dev, tail, lens, page, finished, seed):
    """Kernel R's inputs: P's (`_paged_q8_case`) for the rows' largest
    budgets, and q [B, S, 10, 128]."""
    q, codes, scales, opens, bt, _ = _paged_q8_case(dev, tail, lens.max(1).values.tolist(), page, finished, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1000)
    return torch.randn(lens.shape[0], lens.shape[1], 10, 128, generator=g, device=dev), codes, scales, opens, bt


@pytest.mark.gpu
@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("b,page", [(1, 128), (16, 128), (17, 100), (17, 16)])
def test_cuda_paged_chunk_q8_split_edges(cuda, tail, b, page):
    """R's split-key walk (Q's, over P's codes) at S = 2..8, as
    test_cuda_paged_chunk_split_edges: each row's largest budget at the
    edges of the warps', chunks' and pages' keys, its S budgets ending
    there; the output's and the workspace's blocks filled with NaN first; at
    B > 1 the last row on the scratch page 0, in tail mode not compared."""
    for s in range(2, 9):
        ends = [n for n in _PAGED_EDGES if n >= s]
        for shift in range(s % 2, len(ends), 2):
            end = torch.tensor([ends[(i + shift) % len(ends)] for i in range(b)], dtype=torch.int32, device=cuda)
            lens = (end[:, None] - s + 1 + torch.arange(s, dtype=torch.int32, device=cuda)).contiguous()
            q, (kc, vc), (ks, vs), (ok, ov), bt = _chunk_q8_case(cuda, tail, lens, page, b > 1, seed=s + shift)
            n_part = b * 10 * paged_attention.paged_chunks(page, bt.shape[1]) * s * paged_attention.U_PART
            torch.full_like(q, float("nan"))
            torch.full((n_part,), float("nan"), device=cuda)
            kw = dict(scale=128**-0.5, open_k=ok, open_v=ov)
            before = paged_attention.paged_decode_attention_pool_chunk_q8.launches
            got = paged_attention.paged_decode_attention_pool_chunk_q8(q, kc, vc, ks, vs, bt, lens, 1, **kw)
            torch.cuda.synchronize()
            assert paged_attention.paged_decode_attention_pool_chunk_q8.launches == before + 1
            ref = paged_attention.paged_decode_attention_chunk_q8_reference(q, kc, vc, ks, vs, bt, lens, 1, **kw)
            live = slice(None, -1) if tail and b > 1 else slice(None)
            assert float((got[live] - ref[live]).abs().max()) <= 1e-4, (s, end.tolist())


@pytest.mark.gpu
@pytest.mark.parametrize("tail", [False, True])
def test_cuda_paged_chunk_q8_is_bit_identical_and_row_independent(cuda, tail):
    """R merges each query's partials in ascending chunk order: the same
    call twice is bit-equal, so is a row whose neighbours' budgets and block
    tables change or that runs alone at B 1 (with its own open page), and
    query i of every row is bit-equal to kernel P at its budget: on an int8
    pool at any budgets; on an int8tail pool where a row's budgets lie in
    one page (the open page follows the row's largest budget), here all of
    them."""
    s = 4
    end = torch.linspace(260, 2048, 16).round().int()
    if tail:  # the row's four budgets in the page of its largest, out of order
        end = (end - 1) // 128 * 128 + 4
        lens = (end[:, None] - torch.tensor([3, 0, 2, 1])).to(torch.int32).to(cuda).contiguous()
    else:
        lens = (end[:, None] - 3 * torch.arange(s).flip(0) ** 2).to(torch.int32).to(cuda).contiguous()
    q, (kc, vc), (ks, vs), (ok, ov), bt = _chunk_q8_case(cuda, tail, lens, 128, False, seed=63)
    args, opens = (kc, vc, ks, vs), dict(open_k=ok, open_v=ov)
    kw = dict(scale=128**-0.5)
    first = paged_attention.paged_decode_attention_pool_chunk_q8(q, *args, bt, lens, 1, **kw, **opens)
    again = paged_attention.paged_decode_attention_pool_chunk_q8(q, *args, bt, lens, 1, **kw, **opens)
    assert torch.equal(first, again)
    others = torch.arange(16, device=cuda) % 2 == 1
    lens2 = torch.where(others[:, None], lens.flip(0), lens).to(torch.int32).contiguous()
    bt2 = bt.clone()
    bt2[others] = bt[others].flip(1)
    changed = paged_attention.paged_decode_attention_pool_chunk_q8(q, *args, bt2, lens2, 1, **kw, **opens)
    assert torch.equal(changed[~others], first[~others])
    for r in (0, 8, 15):
        own = {k: v[:, r:r + 1].contiguous() for k, v in opens.items()} if tail else {}
        alone = paged_attention.paged_decode_attention_pool_chunk_q8(q[r:r + 1], *args, bt[r:r + 1], lens[r:r + 1], 1,
                                                                     **kw, **own)
        assert torch.equal(alone[0], first[r]), r
    for i in range(s):
        p_out = paged_attention.paged_decode_attention_pool_q8(q[:, i].contiguous(), *args, bt,
                                                               lens[:, i].contiguous(), 1, **kw, **opens)
        assert torch.equal(p_out, first[:, i]), i


@pytest.mark.gpu
@pytest.mark.parametrize("tail", [False, True])
def test_cuda_paged_chunk_q8_replays_in_a_cuda_graph(cuda, tail):
    """R captured once (workspace inside the capture, counters made by an
    eager call before) and replayed three times after q and the budgets
    change in place: each replay matches the twin on the new inputs, and
    every arrival counter is back at zero after it."""
    end = torch.linspace(300, 2000, 16).round().int()
    lens = (end[:, None] - 3 + torch.arange(4)).to(torch.int32).to(cuda).contiguous()
    q, (kc, vc), (ks, vs), (ok, ov), bt = _chunk_q8_case(cuda, tail, lens, 128, False, seed=75)
    g = torch.Generator(device=cuda).manual_seed(76)
    args, kw = (kc, vc, ks, vs), dict(scale=128**-0.5, open_k=ok, open_v=ov)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention.paged_decode_attention_pool_chunk_q8(q, *args, bt, lens, 0, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention.paged_decode_attention_pool_chunk_q8(q, *args, bt, lens, 0, **kw)
    counters = paged_attention._COUNTERS[q.get_device()]
    for step in range(3):
        q.copy_(torch.randn(q.shape, generator=g, device=cuda))
        lens.sub_(step * 37 + 1)
        graph.replay()
        torch.cuda.synchronize()
        ref = paged_attention.paged_decode_attention_chunk_q8_reference(q, *args, bt, lens, 0, **kw)
        assert float((out - ref).abs().max()) <= 1e-4, step
        assert int(counters.abs().sum()) == 0, step


# ---------------------------------------------------------------------------
# The int8 kernels H (linear), I (per-selection MoE), J (distinct-expert MoE)
# and K (fused decode attention) against their twins, at the LM's shapes
# (H = 1280, 10 heads of 128, E = 64, k = 6, I = 896, 2 pseudo-experts) and
# ragged ones.


def _qlin(dev, out_dim, in_dim, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return linear_q8.quantize_linear(torch.randn(out_dim, in_dim, generator=g, device=dev) * in_dim**-0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,in_dim,out_dim", [
    (1, 1280, 129280),  # lm_head at one row
    (16, 1280, 129280),  # lm_head at 16 slots
    (3, 6848, 1280),  # the dense down projection: In not a multiple of 128
    (32, 1280, 3584),  # the shared gate||up stream
    (6, 1280, 3840),  # the tensor-core form's one 8-row tile
    (40, 208, 1000),  # more than one row tile, ragged Out
])
def test_cuda_linear_q8_matches_twin(cuda, dtype, b, in_dim, out_dim):
    w = _qlin(cuda, out_dim, in_dim, seed=7)
    x = torch.randn(b, in_dim, generator=torch.Generator(device=cuda).manual_seed(8), device=cuda).to(dtype)
    for out_dtype in (None, torch.float32):
        before = linear_q8.linear_q8.launches
        got = linear_q8.linear_q8(x, w, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert linear_q8.linear_q8.launches == before + 1
        ref = linear_q8.linear_q8_reference(x, w, out_dtype=out_dtype)
        assert got.dtype == ref.dtype and got.shape == (b, out_dim)
        assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), ref.dtype)


def _q8_moe_case(dev, dtype, b, e=64, h=1280, i=896, k=6, n_sh=2, seed=9):
    g = torch.Generator(device=dev).manual_seed(seed)

    def experts(n):
        return moe_q8.quantize_experts({
            name: torch.randn(n, *shape, generator=g, device=dev) * shape[1] ** -0.5
            for name, shape in (("gate", (i, h)), ("up", (i, h)), ("down", (h, i)))})

    eq = experts(e)
    if n_sh:
        eq.update({f"pe_{n}": t for n, t in experts(n_sh).items()})
    x = torch.randn(b, h, generator=g, device=dev).to(dtype)
    weights, idx = route(x, torch.randn(e, h, generator=g, device=dev) * h**-0.5, k)
    return x, eq, weights, idx


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,with_shared", [(1, 6, True), (8, 6, False), (3, 1, False), (1, 1, True)])
def test_cuda_moe_q8_matches_twin(cuda, dtype, b, k, with_shared):
    x, eq, weights, idx = _q8_moe_case(cuda, dtype, b, k=k)
    before = moe_q8.moe_ffn_decode_q8.launches
    got = moe_q8.moe_ffn_decode_q8(x, eq, weights, idx, with_shared=with_shared)
    torch.cuda.synchronize()
    assert moe_q8.moe_ffn_decode_q8.launches == before + 1
    ref = moe_q8.moe_ffn_decode_q8_reference(x, eq, weights, idx, with_shared=with_shared)
    assert got.dtype == dtype and got.shape == x.shape
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,n_sh,h", [(torch.bfloat16, 16, 2, 1280), (torch.bfloat16, 32, 2, 1280),
                                            (torch.float32, 16, 2, 1280), (torch.bfloat16, 11, 0, 1280),
                                            (torch.float32, 40, 2, 1280), (torch.bfloat16, 5, 2, 1280),
                                            (torch.bfloat16, 17, 2, 1280), (torch.bfloat16, 40, 2, 1280),
                                            (torch.bfloat16, 16, 2, 1536), (torch.bfloat16, 16, 0, 256),
                                            (torch.bfloat16, 16, 2, 1216)])
def test_cuda_moe_q8_fused_matches_twin(cuda, dtype, b, n_sh, h, monkeypatch):
    """bf16 x with H <= 1280 takes the stream (B 17: a second row tile of
    one row; B 40: a second group of 32 rows; H 256: warps with no chunk of
    H; H 1216: 19 chunks, three for warps 0-2), f32 x and H 1536 the first
    form; the output's block is filled with NaN first."""
    x, eq, weights, idx = _q8_moe_case(cuda, dtype, b, h=h, n_sh=n_sh)
    streamed = []
    stream = moe_decode._launch_q8_stream
    monkeypatch.setattr(moe_decode, "_launch_q8_stream", lambda *a: streamed.append(1) or stream(*a))
    torch.full_like(x, float("nan"))
    before = moe_decode.moe_ffn_decode_q8_fused.launches
    got = moe_decode.moe_ffn_decode_q8_fused(x, eq, weights, idx)
    torch.cuda.synchronize()
    assert moe_decode.moe_ffn_decode_q8_fused.launches == before + 1
    assert len(streamed) == int(dtype == torch.bfloat16 and h <= moe_decode.TC_MAX_H)
    assert len(streamed) == int(moe_decode.q8_stream_takes(x, eq))
    ref = moe_decode.moe_ffn_decode_q8_visits_reference(x, eq, weights, idx)
    assert got.dtype == dtype and got.shape == x.shape
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)


@pytest.mark.gpu
def test_cuda_moe_q8_rows_do_not_depend_on_the_batch(cuda):
    """As for F: a row's bits under J do not change with the other rows'
    routing, nor from run to run; nor under I with the batch."""
    x, eq, weights, idx = _q8_moe_case(cuda, torch.bfloat16, 16)
    a = moe_decode.moe_ffn_decode_q8_fused(x, eq, weights, idx)
    assert torch.equal(a, moe_decode.moe_ffn_decode_q8_fused(x, eq, weights, idx))
    idx2, w2 = idx.clone(), weights.clone()
    idx2[1:] = (idx2[1:] + 7) % 64
    w2[1:] = w2[1:].flip(1)
    assert torch.equal(a[0], moe_decode.moe_ffn_decode_q8_fused(x, eq, w2, idx2)[0])
    one = moe_q8.moe_ffn_decode_q8(x[:1], eq, weights[:1], idx[:1])
    assert torch.equal(one[0], moe_q8.moe_ffn_decode_q8(x, eq, weights, idx)[0])


@pytest.mark.gpu
def test_cuda_moe_q8_stream_rows_alone_and_in_groups(cuda):
    """J's stream: row 0 of 16 is bit-equal to the same row alone (B 1: one
    row tile, its own visits), as row 0 of 32 (two row tiles) and of 40 (a
    second group of 32 rows), whatever the other rows hold."""
    x, eq, weights, idx = _q8_moe_case(cuda, torch.bfloat16, 40)
    first = moe_decode.moe_ffn_decode_q8_fused(x[:16], eq, weights[:16], idx[:16])
    for b in (1, 32, 40):
        got = moe_decode.moe_ffn_decode_q8_fused(x[:b], eq, weights[:b], idx[:b])
        assert torch.equal(got[0], first[0]), b
    row = moe_decode.moe_ffn_decode_q8_fused(x[32:], eq, weights[32:], idx[32:])
    assert torch.equal(row, moe_decode.moe_ffn_decode_q8_fused(x, eq, weights, idx)[32:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_moe_q8_fused_graph_replay_equals_eager(cuda, dtype):
    """J captured in a CUDA graph (the static decode batch) replays to the
    eager call's bits, on new inputs copied into the captured buffers: the
    stream in bf16, the first form in f32."""
    x, eq, weights, idx = _q8_moe_case(cuda, dtype, 16)
    x2, _, w2, idx2 = _q8_moe_case(cuda, dtype, 16, seed=10)
    moe_decode.moe_ffn_decode_q8_fused(x, eq, weights, idx)  # builds the library first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = moe_decode.moe_ffn_decode_q8_fused(x, eq, weights, idx)
    for xs, ws, ids in ((x, weights, idx), (x2, w2, idx2)):
        x.copy_(xs), weights.copy_(ws), idx.copy_(ids)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, moe_decode.moe_ffn_decode_q8_fused(x, eq, weights, idx))


def _attn_case(dev, dtype, kv_dtype, b, cap, hidden=1280, heads=10, seed=10):
    from deepseek_ocr2_tpu_torch.configs import DeepseekV2Config
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import rope_consts

    cfg = DeepseekV2Config(hidden_size=hidden, num_attention_heads=heads)
    g = torch.Generator(device=dev).manual_seed(seed)
    attn = {"wqkv": linear_q8.quantize_linear(torch.randn(3 * hidden, hidden, generator=g, device=dev) * 0.03),
            "wo": linear_q8.quantize_linear(torch.randn(hidden, hidden, generator=g, device=dev) * 0.03)}
    shape = (2, b, heads, cap, 128)
    k_all = (torch.randn(shape, generator=g, device=dev) * 0.5).to(kv_dtype)
    v_all = torch.randn(shape, generator=g, device=dev).to(kv_dtype)
    xn = torch.randn(b, 1, hidden, generator=g, device=dev).to(dtype)
    return cfg, attn, k_all, v_all, xn, rope_consts(cfg, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kv_dtype", [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                                            (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("b,cap,pos", [
    (1, 1024, [300]),  # one page
    (16, 1024, "ragged"),  # the group engine's 16 pages, one at pos 0
    (3, 1280, [0, 700, 1279]),  # a capacity the TPU kernel refuses (not a multiple of 512)
    (2, 100, [99, 37]),  # a capacity under one 64-key tile's multiple
])
def test_cuda_attn_fused_matches_twin(cuda, dtype, kv_dtype, b, cap, pos):
    cfg, attn, k_all, v_all, xn, (cos, sin) = _attn_case(cuda, dtype, kv_dtype, b, cap)
    if pos == "ragged":
        pos = [0] + torch.linspace(1, cap - 1, b - 1).round().int().tolist()
    pos_b = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = attn_fused.attn_decode_fused.launches
    got, k_new, v_new = attn_fused.attn_decode_fused(xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b)
    torch.cuda.synchronize()
    assert attn_fused.attn_decode_fused.launches == before + 1
    ref, k_ref, v_ref = attn_fused.attn_decode_fused_reference(xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b)
    assert got.dtype == dtype and got.shape == xn.shape and k_new.dtype == kv_dtype
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)
    for a, r in ((k_new, k_ref), (v_new, v_ref)):
        assert float((a.float() - r.float()).abs().max()) <= _tol(r.float(), dtype if kv_dtype == dtype else
                                                                   torch.bfloat16)


@pytest.mark.gpu
def test_cuda_int8_kernels_make_no_host_sync(cuda):
    w = _qlin(cuda, 1000, 1280, seed=11)
    x, eq, weights, idx = _q8_moe_case(cuda, torch.bfloat16, 16)
    cfg, attn, k_all, v_all, xn, (cos, sin) = _attn_case(cuda, torch.bfloat16, torch.bfloat16, 4, 256)
    pos_b = torch.tensor([0, 5, 100, 255], dtype=torch.int32, device=cuda)

    def run():
        linear_q8.linear_q8(x, w)
        moe_q8.moe_ffn_decode_q8(x[:1], eq, weights[:1], idx[:1], with_shared=True)
        moe_decode.moe_ffn_decode_q8_fused(x, eq, weights, idx)
        attn_fused.attn_decode_fused(xn, attn, cfg, cos, sin, k_all, v_all, 0, pos_b)

    run()  # builds the libraries first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.gpu
def test_cuda_quantization_matches_cpu(cuda):
    """The card quantizes to the CPU's codes and scales, bit for bit (the
    CPU's are the JAX package's: tests/test_torch_q8.py)."""
    g = torch.Generator().manual_seed(12)
    w = torch.randn(300, 1280, generator=g) * 0.03
    w[7] = 0.0
    want, got = linear_q8.quantize_linear(w), linear_q8.quantize_linear(w.to(cuda))
    assert torch.equal(got["q8"].cpu(), want["q8"]) and torch.equal(got["scale"].cpu(), want["scale"])
    ex = {n: torch.randn(4, *s, generator=g) * 0.05 for n, s in (("gate", (64, 128)), ("up", (64, 128)),
                                                                 ("down", (128, 64)))}
    want = moe_q8.quantize_experts(ex)
    got = moe_q8.quantize_experts({n: t.to(cuda) for n, t in ex.items()})
    assert all(torch.equal(got[n].cpu(), want[n]) for n in want)


@pytest.mark.gpu
@pytest.mark.parametrize("b,k", [(16, 6), (1, 6), (40, 2)])
def test_cuda_device_schedule_matches_the_torch_schedule(cuda, b, k):
    """F and J's one-launch schedule equals distinct_schedule + combine_table, read
    from the router's strided [:, :k] outputs."""
    g = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(b, 256, generator=g, device=cuda)
    weights, idx = route(x, torch.randn(64, 256, generator=g, device=cuda), k)
    assert not idx.is_contiguous() or b == 1
    ve, valid, w_visit = moe_decode.device_schedule(idx, weights, 64, b)
    want_ve, want_valid = moe_decode.distinct_schedule(idx, 64)
    assert torch.equal(ve, want_ve) and torch.equal(valid, want_valid)
    assert torch.equal(w_visit, moe_decode.combine_table(idx, weights, want_ve, want_valid, 64))


# ---------------------------------------------------------------------------
# The int4 kernels L (linear), M (per-selection MoE), N (distinct-expert MoE)
# and O (fused decode attention with int4 weights) against their twins, at
# the LM's shapes and ragged ones.


def _qlin4(dev, out_dim, in_dim, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return linear_q4.quantize_linear_q4(torch.randn(out_dim, in_dim, generator=g, device=dev) * in_dim**-0.5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,in_dim,out_dim", [
    (1, 1280, 129280),  # lm_head at one row
    (16, 1280, 129280),  # lm_head at 16 slots
    (3, 6848, 1280),  # the dense down projection: the last group half padding
    (32, 1280, 3584),  # the shared gate||up stream
    (6, 1792, 1280),  # the shared down, the tensor-core form's one 8-row tile
    (40, 224, 1000),  # more than one row tile, ragged Out, a partial group
])
def test_cuda_linear_q4_matches_twin(cuda, dtype, b, in_dim, out_dim):
    w = _qlin4(cuda, out_dim, in_dim, seed=7)
    x = torch.randn(b, in_dim, generator=torch.Generator(device=cuda).manual_seed(8), device=cuda).to(dtype)
    for out_dtype in (None, torch.float32):
        before = linear_q4.linear_q4.launches
        got = linear_q4.linear_q4(x, w, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert linear_q4.linear_q4.launches == before + 1
        ref = linear_q4.linear_q4_reference(x, w, out_dtype=out_dtype)
        assert got.dtype == ref.dtype and got.shape == (b, out_dim)
        assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), ref.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("in_dim,out_dim", [(1280, 129280), (1280, 1000), (6848, 1280), (6848, 1001), (224, 1001)])
def test_cuda_linear_q4_stream_matches_twin(cuda, dtype, in_dim, out_dim):
    """L's streaming form (1-4 rows of x): lm_head, Out that leaves the
    last stage partial (1000, 1001: its scales end off a 16-byte boundary
    at In 6848 and 224), the dense down (In 6848, a stage of 16 rows) and a
    partial group (In 224). The output's block is filled with NaN first: a
    row left unwritten shows."""
    w = _qlin4(cuda, out_dim, in_dim, seed=17)
    gx = torch.Generator(device=cuda).manual_seed(18)
    for b in (1, 2, 3, 4):
        x = torch.randn(b, in_dim, generator=gx, device=cuda).to(dtype)
        for out_dtype in (None, torch.float32):
            od = out_dtype or dtype
            torch.full((b, out_dim), float("nan"), dtype=od, device=cuda)
            before = linear_q4.linear_q4.launches
            got = linear_q4.linear_q4(x, w, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert linear_q4.linear_q4.launches == before + 1
            ref = linear_q4.linear_q4_reference(x, w, out_dtype=out_dtype)
            assert got.dtype == ref.dtype and got.shape == (b, out_dim)
            assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), ref.dtype), (b, out_dtype)


def _q4_moe_case(dev, dtype, b, e=64, h=1280, i=896, k=6, n_sh=2, seed=9):
    g = torch.Generator(device=dev).manual_seed(seed)

    def experts(n):
        return moe_q4.quantize_experts_q4({
            name: torch.randn(n, *shape, generator=g, device=dev) * shape[1] ** -0.5
            for name, shape in (("gate", (i, h)), ("up", (i, h)), ("down", (h, i)))})

    eq = experts(e)
    if n_sh:
        eq.update({f"pe_{n}": t for n, t in experts(n_sh).items()})
    x = torch.randn(b, h, generator=g, device=dev).to(dtype)
    weights, idx = route(x, torch.randn(e, h, generator=g, device=dev) * h**-0.5, k)
    return x, eq, weights, idx


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,k,with_shared", [(1, 6, True), (8, 6, False), (3, 1, False), (1, 1, True)])
def test_cuda_moe_q4_matches_twin(cuda, dtype, b, k, with_shared):
    x, eq, weights, idx = _q4_moe_case(cuda, dtype, b, k=k)
    before = moe_q4.moe_ffn_decode_q4.launches
    got = moe_q4.moe_ffn_decode_q4(x, eq, weights, idx, with_shared=with_shared)
    torch.cuda.synchronize()
    assert moe_q4.moe_ffn_decode_q4.launches == before + 1
    ref = moe_q4.moe_ffn_decode_q4_reference(x, eq, weights, idx, with_shared=with_shared)
    assert got.dtype == dtype and got.shape == x.shape
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,b,n_sh,h,i", [
    (torch.bfloat16, 16, 2, 1280, 896), (torch.bfloat16, 32, 2, 1280, 896), (torch.float32, 16, 2, 1280, 896),
    (torch.bfloat16, 11, 0, 1280, 896), (torch.float32, 40, 2, 1280, 896), (torch.bfloat16, 40, 2, 1280, 896),
    (torch.bfloat16, 16, 2, 256, 128),  # the stream at another width: 33 down parts of 4 tiles
    (torch.bfloat16, 12, 2, 320, 96),  # partial groups along H and I: the first form on the tensor cores
])
def test_cuda_moe_q4_fused_matches_twin(cuda, dtype, b, n_sh, h, i):
    x, eq, weights, idx = _q4_moe_case(cuda, dtype, b, n_sh=n_sh, h=h, i=i)
    before = moe_q4.moe_ffn_decode_q4_fused.launches
    got = moe_q4.moe_ffn_decode_q4_fused(x, eq, weights, idx)
    torch.cuda.synchronize()
    assert moe_q4.moe_ffn_decode_q4_fused.launches == before + 1
    ref = moe_q4.moe_ffn_decode_q4_visits_reference(x, eq, weights, idx)
    assert got.dtype == dtype and got.shape == x.shape
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)


@pytest.mark.gpu
def test_cuda_moe_q4_rows_do_not_depend_on_the_batch(cuda):
    x, eq, weights, idx = _q4_moe_case(cuda, torch.bfloat16, 16)
    a = moe_q4.moe_ffn_decode_q4_fused(x, eq, weights, idx)
    assert torch.equal(a, moe_q4.moe_ffn_decode_q4_fused(x, eq, weights, idx))
    idx2, w2 = idx.clone(), weights.clone()
    idx2[1:] = (idx2[1:] + 7) % 64
    w2[1:] = w2[1:].flip(1)
    assert torch.equal(a[0], moe_q4.moe_ffn_decode_q4_fused(x, eq, w2, idx2)[0])
    one = moe_q4.moe_ffn_decode_q4(x[:1], eq, weights[:1], idx[:1])
    assert torch.equal(one[0], moe_q4.moe_ffn_decode_q4(x, eq, weights, idx)[0])


@pytest.mark.gpu
def test_cuda_moe_q4_stream_rows_alone_and_in_groups(cuda):
    """N's stream: row 0 of 16 is bit-equal to the same row alone (B 1), as
    row 0 of 32 (two row tiles) and of 40 (a second group of 32 rows), since
    down's parts are cut at fixed expert ids whatever B is."""
    x, eq, weights, idx = _q4_moe_case(cuda, torch.bfloat16, 40)
    assert moe_q4.q4_stream_takes(x, eq)
    first = moe_q4.moe_ffn_decode_q4_fused(x[:16], eq, weights[:16], idx[:16])
    for b in (1, 32, 40):
        got = moe_q4.moe_ffn_decode_q4_fused(x[:b], eq, weights[:b], idx[:b])
        assert torch.equal(got[0], first[0]), b
    row = moe_q4.moe_ffn_decode_q4_fused(x[32:], eq, weights[32:], idx[32:])
    assert torch.equal(row, moe_q4.moe_ffn_decode_q4_fused(x, eq, weights, idx)[32:])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_moe_q4_fused_graph_replay_equals_eager(cuda, dtype):
    """N captured in a CUDA graph replays to the eager call's bits, on new
    inputs copied into the captured buffers, twice (down's arrival counters
    are back at zero after each replay): the stream in bf16, the first form
    in f32."""
    x, eq, weights, idx = _q4_moe_case(cuda, dtype, 16)
    x2, _, w2, idx2 = _q4_moe_case(cuda, dtype, 16, seed=10)
    moe_q4.moe_ffn_decode_q4_fused(x, eq, weights, idx)  # builds the library first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = moe_q4.moe_ffn_decode_q4_fused(x, eq, weights, idx)
    for xs, ws, ids in ((x, weights, idx), (x2, w2, idx2), (x2, w2, idx2)):
        x.copy_(xs), weights.copy_(ws), idx.copy_(ids)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, moe_q4.moe_ffn_decode_q4_fused(x, eq, weights, idx))


def _attn_weights(dev, bits):
    if bits == 8:
        return {"wqkv": _qlin(dev, 3 * 1280, 1280, seed=12), "wo": _qlin(dev, 1280, 1280, seed=13)}
    return {"wqkv": _qlin4(dev, 3 * 1280, 1280, seed=12), "wo": _qlin4(dev, 1280, 1280, seed=13)}


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_cuda_attn_fused_graph_replay_equals_eager(cuda, bits, kv_dtype):
    """K (bits 8) and O (bits 4) captured in a CUDA graph replay to the
    eager call's bits on new inputs (activations, positions from 0 to cap -
    1, caches) copied into the captured buffers, replay after replay: the
    merging blocks leave the arrival counters at zero."""
    cap = 1024
    cfg, _, k_all, v_all, xn, (cos, sin) = _attn_case(cuda, torch.bfloat16, kv_dtype, 16, cap)
    _, _, k2, v2, xn2, _ = _attn_case(cuda, torch.bfloat16, kv_dtype, 16, cap, seed=11)
    attn = _attn_weights(cuda, bits)
    pos_b = torch.tensor([0] + torch.linspace(1, cap - 1, 15).round().int().tolist(), dtype=torch.int32, device=cuda)
    pos2 = pos_b.flip(0).clone()
    attn_fused.attn_decode_fused(xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b)  # builds the library first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = attn_fused.attn_decode_fused(xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b)
    for xs, ks, vs, ps in ((xn, k_all, v_all, pos_b), (xn2, k2, v2, pos2), (xn2, k2, v2, pos2)):
        xn.copy_(xs), k_all.copy_(ks), v_all.copy_(vs), pos_b.copy_(ps)
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, attn_fused.attn_decode_fused(xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b)):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 4])
def test_cuda_attn_fused_rows_do_not_depend_on_the_batch(cuda, bits):
    """K's and O's rows at pos 0 and cap - 1 (and the others) keep their bits
    when the other rows' activations, positions and caches change: the
    split walk's merge order depends on the row's own pos alone."""
    cap = 1024
    cfg, _, k_all, v_all, xn, (cos, sin) = _attn_case(cuda, torch.bfloat16, torch.bfloat16, 16, cap)
    attn = _attn_weights(cuda, bits)
    pos = [0] + torch.linspace(1, cap - 1, 15).round().int().tolist()
    pos_b = torch.tensor(pos, dtype=torch.int32, device=cuda)
    first = attn_fused.attn_decode_fused(xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b)
    assert all(torch.equal(a, b) for a, b in
               zip(first, attn_fused.attn_decode_fused(xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b)))
    for keep in (0, 15):
        others = [r for r in range(16) if r != keep]
        _, _, k2, v2, xn2, _ = _attn_case(cuda, torch.bfloat16, torch.bfloat16, 16, cap, seed=20 + keep)
        xn2[keep], k2[:, keep], v2[:, keep] = xn[keep], k_all[:, keep], v_all[:, keep]
        pos2 = pos_b.clone()
        pos2[others] = pos_b[others].flip(0)
        got = attn_fused.attn_decode_fused(xn2, attn, cfg, cos, sin, k2, v2, 1, pos2)
        for a, b in zip(first, got):
            assert torch.equal(a[keep], b[keep]), keep


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kv_dtype", [(torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
                                            (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("b,cap,pos", [(1, 1024, [300]), (16, 1024, "ragged"), (3, 1280, [0, 700, 1279])])
def test_cuda_attn_fused_q4_matches_twin(cuda, dtype, kv_dtype, b, cap, pos):
    cfg, _, k_all, v_all, xn, (cos, sin) = _attn_case(cuda, dtype, kv_dtype, b, cap)
    attn = {"wqkv": _qlin4(cuda, 3 * 1280, 1280, seed=12), "wo": _qlin4(cuda, 1280, 1280, seed=13)}
    if pos == "ragged":
        pos = [0] + torch.linspace(1, cap - 1, b - 1).round().int().tolist()
    pos_b = torch.tensor(pos, dtype=torch.int32, device=cuda)
    before = (attn_fused.attn_decode_fused.launches, attn_fused.attn_decode_fused_q4.launches)
    got, k_new, v_new = attn_fused.attn_decode_fused(xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b)
    torch.cuda.synchronize()
    assert (attn_fused.attn_decode_fused.launches, attn_fused.attn_decode_fused_q4.launches) == (
        before[0], before[1] + 1)
    ref, k_ref, v_ref = attn_fused.attn_decode_fused_reference(xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b)
    assert got.dtype == dtype and got.shape == xn.shape and k_new.dtype == kv_dtype
    assert float((got.float() - ref.float()).abs().max()) <= _tol(ref.float(), dtype)
    for a, r in ((k_new, k_ref), (v_new, v_ref)):
        assert float((a.float() - r.float()).abs().max()) <= _tol(r.float(), dtype if kv_dtype == dtype else
                                                                   torch.bfloat16)


@pytest.mark.gpu
def test_cuda_int4_kernels_make_no_host_sync_and_quantize_as_the_cpu(cuda):
    w = _qlin4(cuda, 1000, 1280, seed=11)
    x, eq, weights, idx = _q4_moe_case(cuda, torch.bfloat16, 16)
    cfg, _, k_all, v_all, xn, (cos, sin) = _attn_case(cuda, torch.bfloat16, torch.bfloat16, 4, 256)
    attn = {"wqkv": _qlin4(cuda, 3 * 1280, 1280, seed=12), "wo": _qlin4(cuda, 1280, 1280, seed=13)}
    pos_b = torch.tensor([0, 5, 100, 255], dtype=torch.int32, device=cuda)

    def run():
        linear_q4.linear_q4(x, w)
        moe_q4.moe_ffn_decode_q4(x[:1], eq, weights[:1], idx[:1], with_shared=True)
        moe_q4.moe_ffn_decode_q4_fused(x, eq, weights, idx)
        attn_fused.attn_decode_fused(xn, attn, cfg, cos, sin, k_all, v_all, 0, pos_b)

    run()  # builds the libraries first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    g = torch.Generator().manual_seed(12)
    wc = torch.randn(300, 6848, generator=g) * 0.03
    wc[7] = 0.0
    want, got = linear_q4.quantize_linear_q4(wc), linear_q4.quantize_linear_q4(wc.to(cuda))
    assert torch.equal(got["q4"].cpu(), want["q4"]) and torch.equal(got["scale"].cpu(), want["scale"])


# ---------------------------------------------------------------------------
# Kernels U (stacked-cache decode attention), V (windowed rel-pos attention,
# the bias built in the kernel), W (boundary-visit grouped GEMM, both modes)
# and X (per-sequence paged decode attention, G's device code).


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cap,lens", [
    (5, 64, [1, 7, 33, 64, 40]),
    (5, 1024, [1, 513, 1024, 640, 512]),
    (16, 1280, "ragged"),  # a bucket_capacity cap, not a multiple of 512
    (1, 1024, [301]),
])
def test_cuda_decode_stacked_matches_twin(cuda, dtype, b, cap, lens):
    g = torch.Generator(device=cuda).manual_seed(12)
    k_all, v_all = (torch.randn(3, b, 10, cap, 128, generator=g, device=cuda).to(dtype) for _ in range(2))
    q = torch.randn(b, 10, 128, generator=g, device=cuda)
    if lens == "ragged":
        seq = torch.linspace(1, cap, b, device=cuda).round().to(torch.int32)
    else:
        seq = torch.tensor(lens, dtype=torch.int32, device=cuda)
    for layer in (0, 2):
        before = paged_attention.decode_attention_stacked.launches
        got = paged_attention.decode_attention_stacked(q, k_all, v_all, layer, seq, scale=128**-0.5)
        torch.cuda.synchronize()
        assert paged_attention.decode_attention_stacked.launches == before + 1
        ref = paged_attention.decode_attention_stacked_reference(q, k_all, v_all, layer, seq, scale=128**-0.5)
        assert got.dtype == torch.float32 and got.shape == q.shape
        assert float((got - ref).abs().max()) <= 1e-4  # f32 math on both sides


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_paged_decode_matches_twin(cuda, dtype):
    """Kernel X on a per-sequence pool [P, Hh, page, D] (one layer of G's
    case, made contiguous: no layer axis)."""
    q, k_pool, v_pool, bt, seq_lens = _paged_case(cuda, dtype)
    k_pages, v_pages = k_pool[5].contiguous(), v_pool[5].contiguous()
    before = (paged_attention.paged_decode_attention.launches, paged_attention.paged_decode_attention_pool.launches)
    got = paged_attention.paged_decode_attention(q, k_pages, v_pages, bt, seq_lens, scale=128**-0.5)
    torch.cuda.synchronize()
    assert (paged_attention.paged_decode_attention.launches,
            paged_attention.paged_decode_attention_pool.launches) == (before[0] + 1, before[1])
    ref = paged_attention.paged_decode_attention_reference(q, k_pages, v_pages, bt, seq_lens, scale=128**-0.5)
    assert float((got - ref).abs().max()) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,win,valid", [(25, 14, 14), (96, 14, 14), (6, 16, 14), (4, 16, 16), (3, 7, 5)])
def test_cuda_window_attention_matches_twin(cuda, dtype, b, win, valid):
    """Kernel V on the tensor cores: the 1024^2 view's 25 windows and six
    crops' 96 at win = valid = 14 (T2 196: a 4-row last query block, a
    4-key last key tile), the JAX package's padded 16 / 14 form, 16 / 16,
    and an odd win (7 / 5: the unpaired bias reads). The output's block is
    filled with NaN first: a row left unwritten shows."""
    g = torch.Generator(device=cuda).manual_seed(13)
    t2 = win * win
    q, k, v = (torch.randn(b, 12, t2, 64, generator=g, device=cuda).to(dtype) for _ in range(3))
    rhf, rwf = (0.3 * torch.randn(64, t2, generator=g, device=cuda) for _ in range(2))
    pos = torch.arange(t2, device=cuda)
    live = (pos // win < valid) & (pos % win < valid)  # padded queries are garbage by contract
    torch.full_like(q, float("nan"))
    before = mha_win.launches
    got = mha_win(q, k, v, rhf, rwf, scale=0.125, win=win, valid=valid)
    torch.cuda.synchronize()
    assert mha_win.launches == before + 1 and got.dtype == dtype
    ref = mha_win_reference(q, k, v, rhf, rwf, scale=0.125, win=win, valid=valid)
    err = float((got.float() - ref.float())[:, :, live].abs().max())
    assert err <= _tol(ref[:, :, live].float(), dtype)


@pytest.mark.gpu
def test_cuda_window_attention_refuses_other_head_dims(cuda):
    q = torch.zeros(1, 2, 196, 128, device=cuda)
    tab = torch.zeros(128, 196, device=cuda)
    with pytest.raises(ValueError, match="head dim 64"):
        mha_win(q, q, q, tab, tab, scale=0.1, win=14, valid=14)


_STACKED_EDGES = [1, 2, 31, 32, 33, 63, 64, 65, 127, 128, 129, 301]  # U's 32-key warp halves, 64-key chunks


def _stacked_case(dev, dtype, b, cap, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    k_all, v_all = (torch.randn(2, b, 10, cap, 128, generator=g, device=dev).to(dtype) for _ in range(2))
    q = torch.randn(b, 10, 128, generator=g, device=dev)
    return g, q, k_all, v_all


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,cap", [(1, 1024), (16, 1024), (17, 1280), (16, 1280)])
def test_cuda_decode_stacked_split_chunk_edges(cuda, dtype, b, cap):
    """Kernel U's split-key walk at B 1, 16 and 17 and caps 1024 and 1280
    (a bucket_capacity cap): lengths at the edges of its 32-key warp halves
    and 64-key chunks, and cap - 65, cap - 64, cap - 1 and cap, each row
    taking each length in turn. The output's and the workspace's blocks are
    filled with NaN first: a dim left unwritten or a partial read before it
    was written shows."""
    _, q, k_all, v_all = _stacked_case(cuda, dtype, b, cap, seed=30 + b)
    edges = _STACKED_EDGES + [cap - 65, cap - 64, cap - 1, cap]
    n_part = b * 10 * -(-cap // paged_attention.U_CHUNK) * paged_attention.U_PART
    for shift in range(len(edges)):
        seq = torch.tensor([edges[(i + shift) % len(edges)] for i in range(b)], dtype=torch.int32, device=cuda)
        torch.full_like(q, float("nan"))
        torch.full((n_part,), float("nan"), device=cuda)
        before = paged_attention.decode_attention_stacked.launches
        got = paged_attention.decode_attention_stacked(q, k_all, v_all, 1, seq, scale=128**-0.5)
        torch.cuda.synchronize()
        assert paged_attention.decode_attention_stacked.launches == before + 1
        ref = paged_attention.decode_attention_stacked_reference(q, k_all, v_all, 1, seq, scale=128**-0.5)
        assert float((got - ref).abs().max()) <= 1e-4, seq.tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_stacked_is_bit_identical_and_row_independent(cuda, dtype):
    """U's merge runs in ascending chunk order, fixed by a row's own length:
    the same call twice is bit-equal, and so is a row whose neighbours'
    lengths and K/V change, or that runs alone at B 1."""
    b, cap = 17, 1280
    g, q, k_all, v_all = _stacked_case(cuda, dtype, b, cap, seed=40)
    seq = torch.linspace(1, cap, b, device=cuda).round().to(torch.int32)
    kw = dict(scale=128**-0.5)
    first = paged_attention.decode_attention_stacked(q, k_all, v_all, 0, seq, **kw)
    again = paged_attention.decode_attention_stacked(q, k_all, v_all, 0, seq, **kw)
    assert torch.equal(first, again)
    others = torch.arange(b, device=cuda) % 2 == 1
    seq2 = torch.where(others, cap + 1 - seq, seq).to(torch.int32)
    k2, v2 = k_all.clone(), v_all.clone()
    k2[:, others] = torch.randn(k2[:, others].shape, generator=g, device=cuda).to(dtype)
    v2[:, others] = torch.randn(v2[:, others].shape, generator=g, device=cuda).to(dtype)
    changed = paged_attention.decode_attention_stacked(q, k2, v2, 0, seq2, **kw)
    assert torch.equal(changed[~others], first[~others])
    for r in (0, 8, 16):
        alone = paged_attention.decode_attention_stacked(q[r:r + 1], k_all[:, r:r + 1].contiguous(),
                                                         v_all[:, r:r + 1].contiguous(), 0, seq[r:r + 1], **kw)
        assert torch.equal(alone[0], first[r]), r


@pytest.mark.gpu
def test_cuda_decode_stacked_replays_in_a_cuda_graph(cuda):
    """U captured once (its workspace allocated inside the capture) and
    replayed after q and the lengths change in place, as a decode step's
    graph would: each replay matches the twin on the new inputs."""
    b, cap = 16, 1024
    g, q, k_all, v_all = _stacked_case(cuda, torch.bfloat16, b, cap, seed=50)
    seq = torch.linspace(260, 1000, b, device=cuda).round().to(torch.int32)
    kw = dict(scale=128**-0.5)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        paged_attention.decode_attention_stacked(q, k_all, v_all, 1, seq, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_attention.decode_attention_stacked(q, k_all, v_all, 1, seq, **kw)
    for step in range(3):
        q.copy_(torch.randn(q.shape, generator=g, device=cuda))
        seq.add_(step * 7 + 1)
        graph.replay()
        torch.cuda.synchronize()
        ref = paged_attention.decode_attention_stacked_reference(q, k_all, v_all, 1, seq, **kw)
        assert float((out - ref).abs().max()) <= 1e-4, step


def _visit_case(dev, dtype, n, k, e=64, h=1280, i=896, seed=14):
    """The LM's MoE widths; experts 0-7 get no rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, h, generator=g, device=dev).to(dtype)
    ws = [(torch.randn(e, i, h, generator=g, device=dev) * h**-0.5).to(dtype) for _ in range(2)]
    ws.append((torch.randn(e, h, i, generator=g, device=dev) * i**-0.5).to(dtype))
    idx = torch.randint(8, e, (n, k), generator=g, device=dev)
    return x, ws, idx


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k", [(548, 6), (200, 6), (37, 1)])  # bm 64, 32, 32
def test_cuda_gmm_visit_matches_twin_and_the_aligned_pair(cuda, dtype, n, k):
    """Both modes of W against their twins on the first N k rows, and the
    ffn mode bit for bit equal to D then E on the expert-aligned layout for
    the same rows (the same sums in the same order, act rounded at the same
    point); rows past N k are written by no visit."""
    x, (wg, wu, wd), idx = _visit_case(cuda, dtype, n, k)
    e, m = wg.shape[0], n * k
    bm = moe_gmm.pick_bm(m)
    x_sorted, sizes = moe_gmm.sorted_rows(x, idx, e, bm)
    sched = moe_gmm.visit_schedule(sizes, x_sorted.shape[0], bm)
    before = (moe_gmm.gmm_swiglu_visit.launches, moe_gmm.gmm_ffn_visit.launches)
    act = moe_gmm.gmm_swiglu_visit(x_sorted, wg, wu, sched, bm)
    y = moe_gmm.gmm_ffn_visit(x_sorted, wg, wu, wd, sched, bm)
    torch.cuda.synchronize()
    assert (moe_gmm.gmm_swiglu_visit.launches, moe_gmm.gmm_ffn_visit.launches) == (before[0] + 1, before[1] + 1)
    ref_act = moe_gmm.gmm_swiglu_visit_reference(x_sorted, wg, wu, sched, bm)
    ref_y = moe_gmm.gmm_ffn_visit_reference(x_sorted, wg, wu, wd, sched, bm)
    for got, ref in ((act, ref_act), (y, ref_y)):
        assert float((got[:m].float() - ref[:m].float()).abs().max()) <= _tol(ref[:m].float(), dtype)
        assert not bool(got[m:].any())  # no visit owns them: the wrapper's zeros
    # D then E on the aligned layout of the same assignments.
    src_slot, slot_valid, slot_of_sorted, e_tile, tile_valid = moe_gmm.aligned_layout(sizes, x_sorted.shape[0],
                                                                                      moe_gmm.GMM_BM)
    x_al = torch.where(slot_valid[:, None], x_sorted[src_slot.long().clamp(max=x_sorted.shape[0] - 1)], 0)
    act_al = moe_gmm.moe_gmm_swiglu(x_al, wg, wu, e_tile, tile_valid)
    y_al = moe_gmm.moe_gmm_down(act_al, wd, e_tile, tile_valid)
    rows = slot_of_sorted[:m].long()
    assert torch.equal(act[:m], act_al[rows]) and torch.equal(y[:m], y_al[rows])


@pytest.mark.gpu
def test_cuda_remaining_kernels_make_no_host_sync(cuda):
    x, (wg, wu, wd), idx = _visit_case(cuda, torch.bfloat16, 300, 6)
    bm = moe_gmm.pick_bm(x.shape[0] * 6)
    x_sorted, sizes = moe_gmm.sorted_rows(x, idx, wg.shape[0], bm)
    sched = moe_gmm.visit_schedule(sizes, x_sorted.shape[0], bm)
    cache = torch.randn(2, 4, 10, 512, 128, device=cuda)
    q = torch.randn(4, 10, 128, device=cuda)
    lens = torch.tensor([1, 100, 300, 512], dtype=torch.int32, device=cuda)
    qw = torch.randn(25, 12, 196, 64, device=cuda)
    tab = torch.randn(64, 196, device=cuda)
    calls = [lambda: moe_gmm.gmm_swiglu_visit(x_sorted, wg, wu, sched, bm),
             lambda: moe_gmm.gmm_ffn_visit(x_sorted, wg, wu, wd, sched, bm),
             lambda: paged_attention.decode_attention_stacked(q, cache, cache, 1, lens, scale=0.1),
             lambda: mha_win(qw, qw, qw, tab, tab, scale=0.125, win=14, valid=14)]
    for call in calls:
        call()  # builds first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
