"""The port's int4 weight tier, ops level, on the CPU: quantization bit for
bit against the JAX package (levels and group scales, through
`from_jax_q4`), and the plain twins of kernels L (int4 linear), M
(per-selection int4 MoE), N (distinct-expert int4 MoE) and O (fused decode
attention with int4 weights) against the JAX package's Pallas kernels in
interpret mode, on the same numpy-seeded inputs.

Tolerances, relative to the largest output of the JAX kernel:
- f32: 1e-5. Both sides take the same levels and group scales at the same
  points; the JAX kernels' dot identity x . lo = x . v - 16 x . hi - 8 sum(x)
  (`q4_dot_slabs`) has an x . v term up to 16 times the result, so its f32
  rounding is a little larger than a direct dot's: up to 4e-6 of the
  largest output measured here.
- bf16: 4 bf16 ulps (4 * 2^-8), for an f32 sum that lands on the other side
  of a bf16 rounding boundary of an intermediate (qkv, act, ctx).
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
from deepseek_ocr2_tpu.ops import linear_q4 as jlq4
from deepseek_ocr2_tpu.ops import moe as jmoe
from deepseek_ocr2_tpu.ops import moe_q4 as jmoe_q4
from deepseek_ocr2_tpu.ops.rope import rope_cache as jrope_cache
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.ops import attn_fused, linear_q4, moe_q4
from deepseek_ocr2_tpu_torch.ops.linear_q8 import qmm, swiglu_q8

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


def _qlin(qd, in_dim):
    """JAX int4 linear -> the port's."""
    return dict(zip(("q4", "scale"), linear_q4.from_jax_q4(qd["q4"], qd["scale"], in_dim)))


def _qexperts(qd, h, i):
    out = {}
    for pre in ("", "pe_") if "pe_gu_q4" in qd else ("",):
        for n, in_dim in (("gu", h), ("down", i)):
            out[f"{pre}{n}_q4"], out[f"{pre}{n}_scale"] = linear_q4.from_jax_q4(
                qd[f"{pre}{n}_q4"], qd[f"{pre}{n}_scale"], in_dim)
    return out


# ---------------------------------------------------------------------------
# Quantization: bit for bit


@pytest.mark.parametrize("in_dim,out_dim,dtype", [
    (200, 96, "float32"),  # one group partly padding (JAX pads to 256, the port to 256)
    (256, 130, "bfloat16"),
    (6848, 40, "float32"),  # the dense down's In: the last group half padding (JAX 6912 -> 7168)
    (64, 48, "float32"),  # the tiny LM's H: one group, mostly padding
])
def test_quantize_linear_q4_matches_jax(in_dim, out_dim, dtype):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((in_dim, out_dim)).astype(np.float32) * 0.05
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    w[: min(in_dim, 128), 5] = 0.0  # and an all-zero group
    jw = jnp.asarray(w).astype(dtype)
    want = jlq4.quantize_linear_q4(jw)
    got = linear_q4.quantize_linear_q4(_t(jw).T.contiguous())
    ip = -(-in_dim // 128) * 128
    assert got["q4"].dtype == torch.uint8 and got["q4"].shape == (out_dim, ip // 2)
    assert got["scale"].dtype == torch.float32 and got["scale"].shape == (out_dim, ip // 128)
    conv = _qlin(want, in_dim)
    assert torch.equal(got["q4"], conv["q4"]) and torch.equal(got["scale"], conv["scale"])
    # The levels of every real row, and the scales of its group, are the JAX package's.
    lv = linear_q4.unpack_q4(got["q4"])[:, :in_dim].T.numpy()
    lo, hi = jlq4.unpack_q4(np.asarray(want["q4"]).astype(np.int32).reshape(-1, 128, out_dim))
    jlv = np.stack([np.asarray(lo), np.asarray(hi)], axis=1).reshape(-1, out_dim)[:in_dim]
    np.testing.assert_array_equal(lv, jlv)
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"])[: ip // 128].T)


def test_pack_round_trip_and_dequantize():
    rng = np.random.default_rng(1)
    levels = torch.from_numpy(rng.integers(-7, 8, (5, 256)).astype(np.int8))
    assert torch.equal(linear_q4.unpack_q4(linear_q4.pack_q4(levels)), levels)
    w = jnp.asarray(rng.standard_normal((200, 24)).astype(np.float32))
    jq = jlq4.quantize_linear_q4(w)
    tq = _qlin(jq, 200)
    for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(jlq4.dequantize_q4(jq["q4"], jq["scale"], dt).astype(jnp.float32))[:200].T
        got = linear_q4.dequantize_q4(tq["q4"], tq["scale"], 200, tdt)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("e,h,i", [(4, 64, 48), (2, 64, 896)])  # I = 896: 7 groups, JAX pads to 1024
def test_quantize_experts_q4_matches_jax(e, h, i):
    rng = np.random.default_rng(1)
    gate, up = (rng.standard_normal((e, h, i)).astype(np.float32) * 0.05 for _ in range(2))
    down = rng.standard_normal((e, i, h)).astype(np.float32) * 0.05
    want = jmoe_q4.quantize_experts_q4({"gate": jnp.asarray(gate), "up": jnp.asarray(up), "down": jnp.asarray(down)})
    got = moe_q4.quantize_experts_q4({"gate": torch.from_numpy(gate.transpose(0, 2, 1).copy()),
                                      "up": torch.from_numpy(up.transpose(0, 2, 1).copy()),
                                      "down": torch.from_numpy(down.transpose(0, 2, 1).copy())})
    conv = _qexperts(want, h, i)
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
def test_quantize_lm_params_q4_matches_jax(scope):
    """The port quantizes its own params (pseudo-experts included) to the
    levels and scales of the JAX package's int4 tree, read through
    `params_from_jax`."""
    cfg, jparams = _jax_lm()
    jq = jdsv2.quantize_lm_params(jparams, scope=scope, bits=4)
    want = tdsv2.params_from_jax(jq, cfg)
    got = tdsv2.quantize_lm_params(tdsv2.params_from_jax(jparams, cfg), scope=scope, bits=4)
    _assert_same_tree(got, want)
    eq = got["layers"][-1]["experts_q8"]
    assert "gu_q4" in eq and "gu_q8" not in eq
    if scope == "full":
        assert "pe_gu_q4" in eq and "q4" in got["layers"][0]["wqkv"] and "q4" in got["lm_head"]
        assert tdsv2.vocab_size_of(got) == cfg.vocab_size == jdsv2.vocab_size_of(jq)


def test_pseudo_experts_q4_equal_the_fused_shared_stream():
    """With I a multiple of 128 (the full width's 896), the pseudo-experts'
    int4 levels and scales are the fused shared MLP's, cut along I."""
    cfg = tiny_lm_config(hidden_size=128, moe_intermediate_size=128, intermediate_size=256,
                         num_attention_heads=1, num_key_value_heads=1, num_hidden_layers=2)
    _, jparams = _jax_lm(cfg=cfg)
    q = tdsv2.quantize_lm_params(tdsv2.params_from_jax(jparams, cfg), scope="full", bits=4)["layers"][1]
    eq, sh, i = q["experts_q8"], q["shared"], cfg.moe_intermediate_size
    for t in range(cfg.n_shared_experts):
        gate_up = torch.cat([sh["gu"]["q4"][t * i : (t + 1) * i], sh["gu"]["q4"][2 * i + t * i : 2 * i + (t + 1) * i]])
        assert torch.equal(eq["pe_gu_q4"][t], gate_up)
        assert torch.equal(eq["pe_down_q4"][t], sh["down"]["q4"][:, t * i // 2 : (t + 1) * i // 2])
        assert torch.equal(eq["pe_down_scale"][t], sh["down"]["scale"][:, t * i // 128 : (t + 1) * i // 128])


def test_dequantize_experts_q4_matches_jax():
    cfg, jparams = _jax_lm()
    jq = jdsv2.quantize_lm_params(jparams, bits=4)["moe_q8"][0]
    h, i = cfg.hidden_size, cfg.moe_intermediate_size
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jdsv2._dequantize_experts(jq, jdt, cfg)
        got = tdsv2.dequantize_experts(_qexperts(jq, h, i), tdt)
        for n in ("gate", "up", "down"):
            assert got[n].is_contiguous()
            np.testing.assert_array_equal(got[n].float().numpy(),
                                          np.asarray(want[n].astype(jnp.float32)).swapaxes(-1, -2))


# ---------------------------------------------------------------------------
# L: the int4 linear


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,in_dim,out_dim", [
    (3, 256, 384),  # wide: column-blocked on the TPU
    (5, 6848, 1280),  # tall: K-blocked on the TPU (In >= 2 Out), the last group half padding
    (2, 64, 96),  # the tiny LM's H: mostly padding
])
def test_linear_q4_twin_matches_pallas(dtype, b, in_dim, out_dim):
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.standard_normal((in_dim, out_dim)).astype(np.float32) * in_dim**-0.5)
    jq = jlq4.quantize_linear_q4(w)
    x = jnp.asarray(rng.standard_normal((b, in_dim)).astype(np.float32)).astype(dtype)
    for out_dtype in (None, jnp.float32):
        want = jlq4.linear_q4(x, jq, out_dtype=out_dtype, interpret=True)
        before = linear_q4.linear_q4.launches
        got = linear_q4.linear_q4(_t(x), _qlin(jq, in_dim), out_dtype=None if out_dtype is None else torch.float32)
        assert linear_q4.linear_q4.launches == before  # CPU tensors: the twin, not the kernel
        assert got.dtype == (_t(x).dtype if out_dtype is None else torch.float32)
        _close(got, want, dtype if out_dtype is None else "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_q4_plain_matches_xla_form(dtype):
    """The prefill form against `linear_q4_xla`, to f32 rounding also in
    bf16: it rounds each dequantized weight to x's dtype before the product,
    as XLA does (the int8 prefill form's product-then-scale would be off by
    the bf16 rounding of every weight). Through `qmm` and `swiglu_q8`."""
    rng = np.random.default_rng(3)
    jq = jlq4.quantize_linear_q4(jnp.asarray(rng.standard_normal((96, 160)).astype(np.float32) * 0.1))
    x = jnp.asarray(rng.standard_normal((40, 96)).astype(np.float32)).astype(dtype)
    tq = _qlin(jq, 96)
    _close(qmm(_t(x), tq, out_dtype=torch.float32), jlq4.linear_q4_xla(x, jq, out_dtype=jnp.float32), "float32")
    _close(qmm(_t(x), tq), jlq4.linear_q4_xla(x, jq), dtype)
    _close(qmm(_t(x), tq, decode=True, out_dtype=torch.float32),
           jlq4.linear_q4(x, jq, out_dtype=jnp.float32, interpret=True), "float32")
    if dtype == "bfloat16":
        twin = linear_q4.linear_q4_reference(_t(x), tq, out_dtype=torch.float32)
        plain = linear_q4.linear_q4_plain(_t(x), tq, out_dtype=torch.float32)
        assert float((twin - plain).abs().max()) > 1e-4  # the two forms do differ in bf16
    gu = jlq4.quantize_linear_q4(jnp.asarray(rng.standard_normal((96, 128)).astype(np.float32) * 0.1))
    down = jlq4.quantize_linear_q4(jnp.asarray(rng.standard_normal((64, 96)).astype(np.float32) * 0.1))
    from deepseek_ocr2_tpu.ops.linear_q8 import swiglu_q8 as jswiglu_q8

    want = jswiglu_q8(x, gu, down)
    _close(swiglu_q8(_t(x), _qlin(gu, 96), _qlin(down, 64)), want, dtype)


# ---------------------------------------------------------------------------
# M and N: the int4 MoE decode


def _q4_moe_case(b, *, e=8, h=64, i=32, k=2, n_sh=2, seed=4, dtype="float32"):
    rng = np.random.default_rng(seed)

    def experts(n):
        return {"gate": jnp.asarray(rng.standard_normal((n, h, i)).astype(np.float32) * h**-0.5),
                "up": jnp.asarray(rng.standard_normal((n, h, i)).astype(np.float32) * h**-0.5),
                "down": jnp.asarray(rng.standard_normal((n, i, h)).astype(np.float32) * i**-0.5)}

    jeq = jmoe_q4.quantize_experts_q4(experts(e))
    if n_sh:
        jeq.update({f"pe_{k_}": v for k_, v in jmoe_q4.quantize_experts_q4(experts(n_sh)).items()})
    x = jnp.asarray(rng.standard_normal((b, h)).astype(np.float32)).astype(dtype)
    w, idx = jmoe.route(x.astype(jnp.float32), jnp.asarray(rng.standard_normal((h, e)).astype(np.float32)), k)
    return (x, jeq, w, idx), (_t(x), _qexperts(jeq, h, i), _t(w), _t(idx).long())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,with_shared", [(1, True), (1, False), (3, False), (4, True)])
def test_moe_q4_twin_matches_pallas(dtype, b, with_shared):
    (jx, jeq, w, idx), (tx, teq, tw, tidx) = _q4_moe_case(b, dtype=dtype)
    want = jmoe_q4.moe_ffn_decode_q4(jx, jeq, w, idx, with_shared=with_shared, interpret=True)
    before = moe_q4.moe_ffn_decode_q4.launches
    got = moe_q4.moe_ffn_decode_q4(tx, teq, tw, tidx, with_shared=with_shared)
    assert moe_q4.moe_ffn_decode_q4.launches == before and got.dtype == tx.dtype
    _close(got, want, dtype)


def test_moe_q4_twin_at_full_width_groups():
    """H = 256 and I = 896 (the full width's I: 7 groups, the JAX package
    pads to 1024): no padding inside a group of the port."""
    (jx, jeq, w, idx), (tx, teq, tw, tidx) = _q4_moe_case(2, e=4, h=256, i=896, k=2)
    want = jmoe_q4.moe_ffn_decode_q4(jx, jeq, w, idx, with_shared=True, interpret=True)
    _close(moe_q4.moe_ffn_decode_q4(tx, teq, tw, tidx, with_shared=True), want, "float32")


@pytest.mark.parametrize("b,n_sh,dtype", [(5, 2, "float32"), (7, 0, "float32"), (5, 2, "bfloat16"),
                                           (16, 2, "bfloat16")])
def test_moe_q4_fused_twin_matches_pallas(b, n_sh, dtype):
    """B * k > E, N's side of the cut-over (rows share experts): with and
    without the pseudo-experts folded in."""
    (jx, jeq, w, idx), (tx, teq, tw, tidx) = _q4_moe_case(b, n_sh=n_sh, dtype=dtype)
    assert b * 2 > 8 and len(set(np.asarray(idx).ravel().tolist())) < b * 2
    want = jmoe_q4.moe_ffn_decode_q4_fused(jx, jeq, w, idx, interpret=True)
    before = moe_q4.moe_ffn_decode_q4_fused.launches
    got = moe_q4.moe_ffn_decode_q4_fused(tx, teq, tw, tidx)
    assert moe_q4.moe_ffn_decode_q4_fused.launches == before and got.dtype == tx.dtype
    _close(got, want, dtype)


def test_moe_q4_forms_agree():
    """M (with the pseudo-experts) and N see the same function: they differ
    only in the order of the f32 sum."""
    _, (tx, teq, tw, tidx) = _q4_moe_case(6)
    a = moe_q4.moe_ffn_decode_q4(tx, teq, tw, tidx, with_shared=True)
    b = moe_q4.moe_ffn_decode_q4_fused(tx, teq, tw, tidx)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# O: fused decode attention with int4 weights


H, HEADS, D, L = 256, 2, 128, 2


def _attn_case(b, cap, dtype, kv_dtype, seed=5):
    rng = np.random.default_rng(seed)
    cfg = DeepseekV2Config(hidden_size=H, num_attention_heads=HEADS)
    wq = jnp.asarray(rng.standard_normal((H, 3 * H)).astype(np.float32) * 0.05)
    wo = jnp.asarray(rng.standard_normal((H, H)).astype(np.float32) * 0.05)
    jattn_w = {"wqkv": jlq4.quantize_linear_q4(wq), "wo": jlq4.quantize_linear_q4(wo)}
    k_all = jnp.asarray(rng.standard_normal((L, b, HEADS, cap, D)).astype(np.float32) * 0.3).astype(kv_dtype)
    v_all = jnp.asarray(rng.standard_normal((L, b, HEADS, cap, D)).astype(np.float32) * 0.3).astype(kv_dtype)
    xn = jnp.asarray(rng.standard_normal((b, 1, H)).astype(np.float32) * 0.5).astype(dtype)
    tattn = {"wqkv": _qlin(jattn_w["wqkv"], H), "wo": _qlin(jattn_w["wo"], H)}
    return cfg, (xn, jattn_w, k_all, v_all), (_t(xn), tattn, _t(k_all), _t(v_all))


@pytest.mark.parametrize("dtype,kv_dtype", [("float32", "float32"), ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("b,pos", [(1, 37), (1, 0), (4, 100), (4, [0, 5, 63, 200])])
def test_attn_fused_q4_twin_matches_pallas(dtype, kv_dtype, b, pos):
    cap = 256
    cfg, (jxn, jw, jk, jv), (txn, tw, tk, tv) = _attn_case(b, cap, dtype, kv_dtype)
    cos, sin = (jnp.asarray(a) for a in jrope_cache(cfg.max_position_embeddings, D, cfg.rope_theta))
    jpos = jnp.asarray(pos, jnp.int32)
    li = 1
    want, wk, wv = jattn.attn_decode_fused(jxn, jw, cfg, cos, sin, jk, jv, li, jpos, interpret=True)
    tcos, tsin = tdsv2.rope_consts(cfg, "cpu")
    tpos = torch.tensor(pos, dtype=torch.int32) if isinstance(pos, list) else pos
    before = (attn_fused.attn_decode_fused.launches, attn_fused.attn_decode_fused_q4.launches)
    got, k_new, v_new = attn_fused.attn_decode_fused(txn, tw, cfg, tcos, tsin, tk, tv, li, tpos)
    assert (attn_fused.attn_decode_fused.launches, attn_fused.attn_decode_fused_q4.launches) == before
    assert got.shape == (b, 1, H) and got.dtype == txn.dtype and k_new.dtype == tk.dtype
    _close(got, want, dtype)
    rows = np.arange(b)
    pos_b = np.broadcast_to(np.asarray(pos), (b,))
    _close(k_new, np.asarray(jnp.asarray(wk, jnp.float32))[li, rows, :, pos_b], kv_dtype)
    _close(v_new, np.asarray(jnp.asarray(wv, jnp.float32))[li, rows, :, pos_b], kv_dtype)


def test_attn_fused_q4_twin_matches_unfused_path():
    """O's twin against the port's own unfused int4 decode (L projections,
    the plain attention over the written cache) at a capacity the TPU
    kernel refuses (1280): equal to f32 rounding."""
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


def test_int4_wrappers_refuse_non_cuda_devices():
    """A wrapper on a non-CPU, non-CUDA tensor raises instead of falling
    back (the meta device stands in for a card the check refuses)."""
    x = torch.empty(2, 64, device="meta")
    w = {"q4": torch.empty(32, 64, dtype=torch.uint8, device="meta"), "scale": torch.empty(32, 1, device="meta")}
    with pytest.raises(ValueError):
        linear_q4.linear_q4(x, w)
    with pytest.raises(ValueError):
        linear_q4.linear_q4(torch.empty(2, 48, device="meta"), w)  # In not a multiple of 32
