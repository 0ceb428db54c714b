"""The port's int8 weight tier, ops level, on the CPU: quantization bit for
bit against the JAX package, and the plain twins of kernels H (int8
linear), I (per-selection int8 MoE), J (distinct-expert int8 MoE) and K
(fused decode attention) against the JAX package's Pallas kernels in
interpret mode, on the same numpy-seeded inputs.

Tolerances, relative to the largest output of the JAX kernel:
- f32: 1e-5. Both sides widen the same int8 codes exactly and scale at the
  same points; only the order of the f32 sums differs.
- bf16: 4 bf16 ulps (4 * 2^-8). The rounding points are the same, but an f32
  sum that lands on the other side of a bf16 rounding boundary moves an
  intermediate (qkv, act, ctx) by one ulp, which the next product carries.
The CUDA kernels are held to these twins on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.configs import DeepseekV2Config, tiny_lm_config
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
from deepseek_ocr2_tpu.ops import attn_fused as jattn
from deepseek_ocr2_tpu.ops import linear_q8 as jlq8
from deepseek_ocr2_tpu.ops import moe as jmoe
from deepseek_ocr2_tpu.ops import moe_decode as jmoe_decode
from deepseek_ocr2_tpu.ops import moe_q8 as jmoe_q8
from deepseek_ocr2_tpu.ops.rope import rope_cache as jrope_cache
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.ops import attn_fused, linear_q8, moe_decode, moe_q8
from deepseek_ocr2_tpu_torch.ops.linear_q8 import qmm, quantize_linear

import reference_torch as ref

F32_RTOL = 1e-5
BF16_RTOL = 4 * 2.0**-8


def _close(got, want, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    tol = (F32_RTOL if dtype == "float32" else BF16_RTOL) * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max abs err {err} above {tol}"


def _t(a) -> torch.Tensor:
    """JAX or numpy array -> torch, bf16 kept (through f32)."""
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(a))


def _qlin_from_jax(qd, in_dim):
    """JAX int8 linear {"q8": [In_pad, Out], "scale": [1, Out]} -> the port's."""
    return {"q8": _t(np.asarray(qd["q8"])[:in_dim].T.copy()), "scale": _t(np.asarray(qd["scale"])[0])}


def _qexperts_from_jax(qd):
    return {k: _t(np.swapaxes(np.asarray(v), -1, -2).copy()) if k.endswith("q8") else _t(np.asarray(v)[..., 0, :])
            for k, v in qd.items()}


# ---------------------------------------------------------------------------
# Quantization: bit for bit


@pytest.mark.parametrize("in_dim,out_dim,dtype", [(200, 96, "float32"), (256, 130, "bfloat16")])
def test_quantize_linear_matches_jax(in_dim, out_dim, dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((in_dim, out_dim)).astype(np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    jw = jnp.asarray(w).astype(dtype)
    want = jlq8.quantize_linear(jw)
    got = quantize_linear(_t(jw).T.contiguous())
    assert got["q8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(want["q8"])[:in_dim].T)
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"])[0])


def test_quantize_experts_matches_jax():
    rng = np.random.default_rng(1)
    e, h, i = 4, 64, 48
    gate, up = (rng.standard_normal((e, h, i)).astype(np.float32) * 0.05 for _ in range(2))
    down = rng.standard_normal((e, i, h)).astype(np.float32) * 0.05
    want = jmoe_q8.quantize_experts({"gate": jnp.asarray(gate), "up": jnp.asarray(up), "down": jnp.asarray(down)})
    got = moe_q8.quantize_experts({"gate": torch.from_numpy(gate.transpose(0, 2, 1).copy()),
                                   "up": torch.from_numpy(up.transpose(0, 2, 1).copy()),
                                   "down": torch.from_numpy(down.transpose(0, 2, 1).copy())})
    conv = _qexperts_from_jax(want)
    assert set(got) == set(conv)
    for k in got:
        assert torch.equal(got[k], conv[k]), k


def _jax_lm(seed=9, cfg=None):
    cfg = cfg or tiny_lm_config()
    params, _ = jdsv2.params_from_flat(ref.random_lm_flat(cfg, seed=seed), cfg)
    return cfg, jax.tree_util.tree_map(jnp.asarray, params)


def _assert_same_tree(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), f"{path}: {sorted(got)} vs {sorted(want)}"
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for j, (g, w) in enumerate(zip(got, want)):
            _assert_same_tree(g, w, f"{path}[{j}]")
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), path


@pytest.mark.parametrize("scope", ["experts", "full"])
def test_quantize_lm_params_matches_jax(scope):
    """The port quantizes its own params (pseudo-experts included) to the
    codes and scales of the JAX package's quantized tree, read through
    `params_from_jax`."""
    cfg, jparams = _jax_lm()
    want = tdsv2.params_from_jax(jdsv2.quantize_lm_params(jparams, scope=scope), cfg)
    got = tdsv2.quantize_lm_params(tdsv2.params_from_jax(jparams, cfg), scope=scope)
    _assert_same_tree(got, want)
    if scope == "full":
        assert "pe_gu_q8" in got["layers"][-1]["experts_q8"] and "wqkv" in got["layers"][0]
        assert tdsv2.vocab_size_of(got) == cfg.vocab_size == jdsv2.vocab_size_of(
            jdsv2.quantize_lm_params(jparams, scope=scope))


def test_dequantize_experts_matches_jax():
    cfg, jparams = _jax_lm()
    jq = jdsv2.quantize_lm_params(jparams)["moe_q8"][0]
    want = jdsv2._dequantize_experts(jq, jnp.float32)
    got = tdsv2.dequantize_experts(_qexperts_from_jax(jq), torch.float32)
    for n in ("gate", "up", "down"):
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]).swapaxes(-1, -2))


# ---------------------------------------------------------------------------
# H: the int8 linear


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,in_dim,out_dim", [
    (3, 256, 384),  # column-blocked on the TPU
    (5, 6848, 1280),  # K-blocked on the TPU (In >= 2 Out, over its VMEM budget), In not a multiple of 128
])
def test_linear_q8_twin_matches_pallas(dtype, b, in_dim, out_dim):
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.standard_normal((in_dim, out_dim)).astype(np.float32) * in_dim**-0.5)
    jq = jlq8.quantize_linear(w)
    x = jnp.asarray(rng.standard_normal((b, in_dim)).astype(np.float32)).astype(dtype)
    for out_dtype in (None, jnp.float32):
        want = jlq8.linear_q8(x, jq, out_dtype=out_dtype, interpret=True)
        before = linear_q8.linear_q8.launches
        got = linear_q8.linear_q8(_t(x), _qlin_from_jax(jq, in_dim),
                                  out_dtype=None if out_dtype is None else torch.float32)
        assert linear_q8.linear_q8.launches == before  # CPU tensors: the twin, not the kernel
        assert got.dtype == (_t(x).dtype if out_dtype is None else torch.float32)
        _close(got, want, dtype if out_dtype is None else "float32")


def test_linear_q8_plain_matches_xla_form():
    rng = np.random.default_rng(3)
    w = jnp.asarray(rng.standard_normal((96, 160)).astype(np.float32) * 0.1)
    jq = jlq8.quantize_linear(w)
    x = jnp.asarray(rng.standard_normal((40, 96)).astype(np.float32))
    tq = _qlin_from_jax(jq, 96)
    _close(qmm(_t(x), tq), jlq8.linear_q8_xla(x, jq), "float32")
    _close(qmm(_t(x), tq, decode=True), jlq8.linear_q8_xla(x, jq), "float32")
    gu = jlq8.quantize_linear(jnp.asarray(rng.standard_normal((96, 128)).astype(np.float32) * 0.1))
    down = jlq8.quantize_linear(jnp.asarray(rng.standard_normal((64, 96)).astype(np.float32) * 0.1))
    want = jlq8.swiglu_q8(x, gu, down)
    for decode in (False, True):
        got = linear_q8.swiglu_q8(_t(x), _qlin_from_jax(gu, 96), _qlin_from_jax(down, 64), decode=decode)
        _close(got, want, "float32")


def test_linear_q8_plain_bf16_keeps_the_product_in_f32():
    """bf16 rows, f32 output (the gate||up stream of `swiglu_q8`): XLA keeps
    the product in f32 before the scale, so the prefill form agrees to f32
    rounding. A bf16 rounding of the product before the scale is off by up
    to 2^-9 of it, 400x this bound."""
    rng = np.random.default_rng(13)
    jq = jlq8.quantize_linear(jnp.asarray(rng.standard_normal((96, 160)).astype(np.float32) * 0.1))
    x = jnp.asarray(rng.standard_normal((40, 96)).astype(np.float32)).astype(jnp.bfloat16)
    got = linear_q8.linear_q8_plain(_t(x), _qlin_from_jax(jq, 96), out_dtype=torch.float32)
    _close(got, jlq8.linear_q8_xla(x, jq, out_dtype=jnp.float32), "float32")


# ---------------------------------------------------------------------------
# I and J: the int8 MoE decode


def _q8_moe_case(b, *, e=8, h=64, i=32, k=2, n_sh=2, seed=4, dtype="float32"):
    rng = np.random.default_rng(seed)

    def experts(n):
        return {"gate": jnp.asarray(rng.standard_normal((n, h, i)).astype(np.float32) * h**-0.5),
                "up": jnp.asarray(rng.standard_normal((n, h, i)).astype(np.float32) * h**-0.5),
                "down": jnp.asarray(rng.standard_normal((n, i, h)).astype(np.float32) * i**-0.5)}

    jeq = jmoe_q8.quantize_experts(experts(e))
    if n_sh:
        jeq.update({f"pe_{k_}": v for k_, v in jmoe_q8.quantize_experts(experts(n_sh)).items()})
    x = jnp.asarray(rng.standard_normal((b, h)).astype(np.float32)).astype(dtype)
    w, idx = jmoe.route(x.astype(jnp.float32), jnp.asarray(rng.standard_normal((h, e)).astype(np.float32)), k)
    return (x, jeq, w, idx), (_t(x), _qexperts_from_jax(jeq), _t(w), _t(idx).long())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,with_shared", [(1, True), (1, False), (3, False), (4, True)])
def test_moe_q8_twin_matches_pallas(dtype, b, with_shared):
    (jx, jeq, w, idx), (tx, teq, tw, tidx) = _q8_moe_case(b, dtype=dtype)
    want = jmoe_q8.moe_ffn_decode_q8(jx, jeq, w, idx, with_shared=with_shared, interpret=True)
    before = moe_q8.moe_ffn_decode_q8.launches
    got = moe_q8.moe_ffn_decode_q8(tx, teq, tw, tidx, with_shared=with_shared)
    assert moe_q8.moe_ffn_decode_q8.launches == before and got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("b,n_sh,dtype", [(5, 2, "float32"), (7, 0, "float32"), (5, 2, "bfloat16"),
                                           (16, 2, "bfloat16")])
def test_moe_q8_fused_twin_matches_pallas(b, n_sh, dtype):
    """B * k > E, J's side of the cut-over: with and without the
    pseudo-experts folded in."""
    (jx, jeq, w, idx), (tx, teq, tw, tidx) = _q8_moe_case(b, n_sh=n_sh, dtype=dtype)
    assert b * 2 > 8
    want = jmoe_decode.moe_ffn_decode_q8_fused(jx, jeq, w, idx, interpret=True)
    before = moe_decode.moe_ffn_decode_q8_fused.launches
    got = moe_decode.moe_ffn_decode_q8_fused(tx, teq, tw, tidx)
    assert moe_decode.moe_ffn_decode_q8_fused.launches == before and got.dtype == tx.dtype
    _close(got, want, dtype)


def test_moe_q8_forms_agree():
    """I (with the pseudo-experts) and J see the same function: they differ
    only in the order of the f32 sum."""
    _, (tx, teq, tw, tidx) = _q8_moe_case(6)
    a = moe_q8.moe_ffn_decode_q8(tx, teq, tw, tidx, with_shared=True)
    b = moe_decode.moe_ffn_decode_q8_fused(tx, teq, tw, tidx)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K: fused decode attention


H, HEADS, D, L = 256, 2, 128, 2


def _attn_case(b, cap, dtype, kv_dtype, seed=5):
    rng = np.random.default_rng(seed)
    cfg = DeepseekV2Config(hidden_size=H, num_attention_heads=HEADS)
    wq = jnp.asarray(rng.standard_normal((H, 3 * H)).astype(np.float32) * 0.05)
    wo = jnp.asarray(rng.standard_normal((H, H)).astype(np.float32) * 0.05)
    jattn_w = {"wqkv": jlq8.quantize_linear(wq), "wo": jlq8.quantize_linear(wo)}
    k_all = jnp.asarray(rng.standard_normal((L, b, HEADS, cap, D)).astype(np.float32) * 0.3).astype(kv_dtype)
    v_all = jnp.asarray(rng.standard_normal((L, b, HEADS, cap, D)).astype(np.float32) * 0.3).astype(kv_dtype)
    xn = jnp.asarray(rng.standard_normal((b, 1, H)).astype(np.float32) * 0.5).astype(dtype)
    tattn = {"wqkv": _qlin_from_jax(jattn_w["wqkv"], H), "wo": _qlin_from_jax(jattn_w["wo"], H)}
    return cfg, (xn, jattn_w, k_all, v_all), (_t(xn), tattn, _t(k_all), _t(v_all))


@pytest.mark.parametrize("dtype,kv_dtype", [("float32", "float32"), ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("b,pos", [(1, 37), (1, 0), (4, 100), (4, [0, 5, 63, 200])])
def test_attn_fused_twin_matches_pallas(dtype, kv_dtype, b, pos):
    cap = 256
    cfg, (jxn, jw, jk, jv), (txn, tw, tk, tv) = _attn_case(b, cap, dtype, kv_dtype)
    cos, sin = (jnp.asarray(a) for a in jrope_cache(cfg.max_position_embeddings, D, cfg.rope_theta))
    jpos = jnp.asarray(pos, jnp.int32)
    li = 1
    want, wk, wv = jattn.attn_decode_fused(jxn, jw, cfg, cos, sin, jk, jv, li, jpos, interpret=True)
    tcos, tsin = tdsv2.rope_consts(cfg, "cpu")
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) else pos
    before = attn_fused.attn_decode_fused.launches
    got, k_new, v_new = attn_fused.attn_decode_fused(txn, tw, cfg, tcos, tsin, tk, tv, li, tpos)
    assert attn_fused.attn_decode_fused.launches == before
    assert got.shape == (b, 1, H) and got.dtype == txn.dtype and k_new.dtype == tk.dtype
    _close(got, want, dtype)
    rows = np.arange(b)
    pos_b = np.broadcast_to(np.asarray(pos), (b,))
    _close(k_new, np.asarray(jnp.asarray(wk, jnp.float32))[li, rows, :, pos_b], kv_dtype)
    _close(v_new, np.asarray(jnp.asarray(wv, jnp.float32))[li, rows, :, pos_b], kv_dtype)


def test_attn_fused_twin_matches_unfused_path_at_any_capacity():
    """K's twin against the port's own unfused decode (H projections, the
    plain attention over the written cache) at a capacity the TPU kernel
    refuses (1280, the (2, 3) crop page's): equal in f32, where the current
    token's K/V round-trip through the cache exactly."""
    cap = 1280
    cfg, _, (txn, tw, tk, tv) = _attn_case(2, cap, "float32", "float32")
    rope = tdsv2.rope_consts(cfg, "cpu")
    layer = {**tw, "ln1": None}
    cache = {"k": tk.clone(), "v": tv.clone()}
    want = tdsv2._attention(txn, layer, cfg, rope, cache, 1, 700, is_prefill=False)
    fused_cache = {"k": tk.clone(), "v": tv.clone()}
    got = tdsv2._fused_attention(txn, layer, cfg, rope, fused_cache, 1, 700, torch.full((2,), 700, dtype=torch.int32))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(fused_cache["k"], cache["k"], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(fused_cache["v"], cache["v"], rtol=0, atol=0)


def test_wrappers_refuse_bad_inputs_on_cuda_only_paths():
    """A wrapper on a non-CPU, non-CUDA tensor raises instead of falling
    back (the meta device stands in for a card the check refuses)."""
    x = torch.empty(2, 64, device="meta")
    w = {"q8": torch.empty(32, 64, dtype=torch.int8, device="meta"), "scale": torch.empty(32, device="meta")}
    with pytest.raises(ValueError):
        linear_q8.linear_q8(x, w)
