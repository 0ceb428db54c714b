"""Kernels K and O's attention (fused int8 / int4 decode attention), the
split-key walk, emulated in torch on the CPU.

csrc/attn_fused.cu runs the attention between K's (or O's) two projections
as one launch of blocks (64-key chunk, head, row) over the row's pos cached
keys: two warps of 32 keys, one key a lane, each with its own softmax (m =
the largest score, p = exp(s - m), or exp(s - 0) for a warp with no live key,
l = sum p, acc = sum p v), merged in the block (warp 0, then warp 1) into a
partial (acc, m, l) a chunk; the last block of the (row, head) merges the
current token's seed first (m0 = q . k_cur * scale, l = 1, acc = v_cur, in
f32) and then the chunks' partials in ascending order: m = max(m0, max_c
m_c), out = (v_cur e^(m0 - m) + sum_c acc_c e^(m_c - m)) / max(e^(m0 - m) +
sum_c l_c e^(m_c - m), 1e-37), a partial with m_c = -inf weighing 0. Every
block rotates q itself (RoPE at the row's pos, f32), the merging block
rotates k_cur and writes k_new / v_new once in the cache dtype. The
projections are the twin's (kernels H and L on the card).

The emulation is held to:
- `attn_decode_fused_reference` (one exact softmax over the cached keys and
  the current token) and the JAX package's `attn_decode_fused` in interpret
  mode (as tests/test_torch_q4.py runs it), at bits 8 and 4, f32 and bf16
  caches, pos 0, 1, 63, 64, 65, 300 and cap - 1 at cap 512 (the JAX kernel
  takes cap <= 512 or a multiple of 512), two heads of the LM's head dim;
- itself: the chunks wholly past pos (walked up to cap here) add exact zeros
  (no NaN, bit-equal to merging the row's own chunks), and without the -inf
  guards they make the output NaN, which shows the test can see that fault;
  the seed counts once (counted twice, the output moves far past the
  tolerance); a row's bits do not depend on the other rows' positions and
  caches, or on running alone.
Tolerances as tests/test_torch_q4.py's: f32 1e-5 of the largest output,
bf16 4 ulps. The kernel itself runs on the card (tests/test_torch_kernels.py,
-m gpu).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.configs import DeepseekV2Config
from deepseek_ocr2_tpu.ops import attn_fused as jattn
from deepseek_ocr2_tpu.ops import linear_q4 as jlq4
from deepseek_ocr2_tpu.ops import linear_q8 as jlq8
from deepseek_ocr2_tpu.ops.rope import rope_cache as jrope_cache
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.ops import attn_fused, linear_q4
from deepseek_ocr2_tpu_torch.ops.linear_q4 import linear_q4_reference
from deepseek_ocr2_tpu_torch.ops.linear_q8 import linear_q8_reference
from deepseek_ocr2_tpu_torch.ops.paged_attention import U_CHUNK, U_WARP_KEYS

H, HEADS, D, L, CAP = 256, 2, 128, 2, 512
POS = [0, 1, 63, 64, 65, 300, CAP - 1]
F32_RTOL = 1e-5
BF16_RTOL = 4 * 2.0**-8


def _t(a) -> torch.Tensor:
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
    return torch.from_numpy(np.array(a))


def _case(bits, dtype, pos, seed=7):
    """JAX int8 / int4 attention weights and the port's (the same codes and
    scales), a cache [L, B, Hh, CAP, D] and xn, one row a position."""
    rng = np.random.default_rng(seed)
    b = len(pos)
    cfg = DeepseekV2Config(hidden_size=H, num_attention_heads=HEADS)
    wq = jnp.asarray(rng.standard_normal((H, 3 * H)).astype(np.float32) * 0.05)
    wo = jnp.asarray(rng.standard_normal((H, H)).astype(np.float32) * 0.05)
    if bits == 8:
        jw = {"wqkv": jlq8.quantize_linear(wq), "wo": jlq8.quantize_linear(wo)}
        tw = {n: {"q8": _t(np.asarray(jw[n]["q8"])[:H].T.copy()), "scale": _t(np.asarray(jw[n]["scale"])[0])}
              for n in jw}
    else:
        jw = {"wqkv": jlq4.quantize_linear_q4(wq), "wo": jlq4.quantize_linear_q4(wo)}
        tw = {n: dict(zip(("q4", "scale"), linear_q4.from_jax_q4(jw[n]["q4"], jw[n]["scale"], H))) for n in jw}
    k_all = jnp.asarray(rng.standard_normal((L, b, HEADS, CAP, D)).astype(np.float32) * 0.3).astype(dtype)
    v_all = jnp.asarray(rng.standard_normal((L, b, HEADS, CAP, D)).astype(np.float32) * 0.3).astype(dtype)
    xn = jnp.asarray(rng.standard_normal((b, 1, H)).astype(np.float32) * 0.5).astype(dtype)
    return cfg, (xn, jw, k_all, v_all), (_t(xn), tw, _t(k_all), _t(v_all))


def _rotate(x, c, s):
    """RoPE as the kernel's threads take it: thread t owns dims t and t +
    D / 2, each the other's partner."""
    half = x.shape[-1] // 2
    lo, hi = x[..., :half], x[..., half:]
    return torch.cat([lo * c[..., :half] - hi * s[..., :half], hi * c[..., half:] + lo * s[..., half:]], -1)


def _warp_softmax(s, v, guard):
    """One warp's keys (score -inf past the live ones): m, l, acc, with p =
    exp(s - 0) where the warp has no live key (the guard) or exp(s - m)."""
    m = s.amax(-1)
    p = torch.exp(s - (torch.where(m == -math.inf, 0.0, m) if guard else m)[..., None])
    return m, p.sum(-1), torch.einsum("...k,...kd->...d", p, v)


def _merge_in(m, l, acc, m1, l1, acc1, guard):
    """Fold partial 1 into partial 0 (the in-block merge): a partial with m =
    -inf weighs exactly 0 under the guard."""
    mm = torch.maximum(m, m1)
    a0, a1 = torch.exp(m - mm), torch.exp(m1 - mm)
    if guard:
        a0, a1 = torch.where(m == -math.inf, 0.0, a0), torch.where(m1 == -math.inf, 0.0, a1)
    return mm, l1 * a1 + l * a0, acc1 * a1[..., None] + acc * a0[..., None]


def split_attention(xn, attn, cfg, cos, sin, k_all, v_all, li, pos, *, guard=True, every_chunk=False, seeds=1):
    """K's or O's decode step with the kernel's split walk. Returns (out [B,
    1, H], k_new, v_new) as the twin does. `every_chunk` walks the chunks up
    to the capacity (the kernel exits those at or past pos); `seeds` counts
    the current token that many times (1: the kernel)."""
    b, _, h = xn.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim
    pos_l = torch.as_tensor(pos, dtype=torch.long).reshape(-1).expand(b)
    proj = linear_q4_reference if "q4" in attn["wqkv"] else linear_q8_reference
    qkv = proj(xn.reshape(b, h), attn["wqkv"]).float()
    q, k, v = (t.reshape(b, nh, d) for t in qkv.split(h, dim=-1))
    c, s = cos[pos_l][:, None, :], sin[pos_l][:, None, :]
    q, k = _rotate(q, c, s), _rotate(k, c, s)
    scale = 1.0 / math.sqrt(d)
    keys, vals = k_all[li].float(), v_all[li].float()  # [B, Hh, cap, D]
    cap = keys.shape[2]
    n_chunks = -(-cap // U_CHUNK)
    ctx = torch.empty(b, nh, d)
    for r in range(b):
        p_r = int(pos_l[r])
        live = max(1, -(-p_r // U_CHUNK)) if not every_chunk else n_chunks
        m0 = (q[r] * k[r]).sum(-1) * scale  # [Hh]
        m, ml = m0.clone(), []
        for ch in range(live):
            part = None
            for w in range(U_CHUNK // U_WARP_KEYS):
                j0 = ch * U_CHUNK + w * U_WARP_KEYS
                kk = torch.zeros(nh, U_WARP_KEYS, d)
                vv = torch.zeros(nh, U_WARP_KEYS, d)
                n = max(0, min(U_WARP_KEYS, min(p_r, cap) - j0))
                kk[:, :n], vv[:, :n] = keys[r, :, j0:j0 + n], vals[r, :, j0:j0 + n]
                sc = (q[r][:, None, :] * kk).sum(-1) * scale
                sc[:, n:] = -math.inf
                wp = _warp_softmax(sc, vv, guard)
                part = wp if part is None else _merge_in(*part, *wp, guard)
            ml.append(part)
            m = torch.maximum(m, part[0])
        w0 = torch.exp(m0 - m)
        l_acc, acc = w0 * seeds, v[r] * (w0 * seeds)[:, None]
        for mc, lc, ac in ml:
            wc = torch.exp(mc - m)
            if guard:
                wc = torch.where(mc == -math.inf, 0.0, wc)
            l_acc, acc = lc * wc + l_acc, ac * wc[:, None] + acc
        ctx[r] = acc / l_acc.clamp(min=1e-37)[:, None]
    out = proj(ctx.reshape(b, h).to(xn.dtype), attn["wo"])
    return out.reshape(b, 1, h), k.to(k_all.dtype), v.to(v_all.dtype)


def _close(got, want, dtype):
    want = want.float().numpy() if isinstance(want, torch.Tensor) else np.asarray(jnp.asarray(want, jnp.float32))
    tol = (F32_RTOL if dtype == "float32" else BF16_RTOL) * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol, f"max abs err {err} above {tol}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_split_attention_matches_twin_and_jax(bits, dtype):
    cfg, (jxn, jw, jk, jv), (txn, tw, tk, tv) = _case(bits, dtype, POS)
    li = 1
    cos, sin = (jnp.asarray(a) for a in jrope_cache(cfg.max_position_embeddings, D, cfg.rope_theta))
    want, wk, wv = jattn.attn_decode_fused(jxn, jw, cfg, cos, sin, jk, jv, li, jnp.asarray(POS, jnp.int32),
                                           interpret=True)
    tcos, tsin = tdsv2.rope_consts(cfg, "cpu")
    tpos = torch.tensor(POS, dtype=torch.int32)
    got, k_new, v_new = split_attention(txn, tw, cfg, tcos, tsin, tk, tv, li, tpos)
    twin = attn_fused.attn_decode_fused_reference(txn, tw, cfg, tcos, tsin, tk, tv, li, tpos)
    assert got.dtype == txn.dtype and got.shape == txn.shape and k_new.dtype == tk.dtype
    _close(got, twin[0], dtype)
    _close(got, want, dtype)
    rows = np.arange(len(POS))
    for new, ref, j in ((k_new, twin[1], wk), (v_new, twin[2], wv)):
        _close(new, ref, dtype)
        _close(new, np.asarray(jnp.asarray(j, jnp.float32))[li, rows, :, np.asarray(POS)], dtype)


def test_chunks_past_pos_add_exact_zeros():
    """Every chunk up to the capacity walked: bit-equal to the row's own
    chunks and finite; without the guards (a warp with no live key
    subtracting -inf, a partial with m = -inf weighed by exp) NaN in every
    row that has such a chunk (all but pos cap - 1's)."""
    cfg, _, (txn, tw, tk, tv) = _case(8, "float32", POS)
    cos, sin = tdsv2.rope_consts(cfg, "cpu")
    pos = torch.tensor(POS, dtype=torch.int32)
    own = split_attention(txn, tw, cfg, cos, sin, tk, tv, 0, pos)[0]
    every = split_attention(txn, tw, cfg, cos, sin, tk, tv, 0, pos, every_chunk=True)[0]
    assert torch.isfinite(every).all() and torch.equal(every, own)
    bare = split_attention(txn, tw, cfg, cos, sin, tk, tv, 0, pos, every_chunk=True, guard=False)[0]
    assert torch.isnan(bare[:-1]).all() and torch.equal(bare[-1], own[-1])


def test_the_seed_counts_once():
    """The current token enters the merge once: the emulation matches the
    twin, and counting the seed twice moves the output far past the
    tolerance (so the test sees that fault)."""
    cfg, _, (txn, tw, tk, tv) = _case(4, "float32", [1, 65, 300])
    cos, sin = tdsv2.rope_consts(cfg, "cpu")
    pos = torch.tensor([1, 65, 300], dtype=torch.int32)
    twin = attn_fused.attn_decode_fused_reference(txn, tw, cfg, cos, sin, tk, tv, 1, pos)[0]
    _close(split_attention(txn, tw, cfg, cos, sin, tk, tv, 1, pos)[0], twin, "float32")
    twice = split_attention(txn, tw, cfg, cos, sin, tk, tv, 1, pos, seeds=2)[0]
    assert float((twice - twin).abs().max()) > 100 * F32_RTOL * max(1.0, float(twin.abs().max()))


def test_a_rows_bits_do_not_depend_on_the_other_rows():
    """Row 0 beside other positions and other caches, and alone: bit-equal,
    as its merge order depends on its own pos alone."""
    cfg, _, (txn, tw, tk, tv) = _case(8, "bfloat16", POS)
    cos, sin = tdsv2.rope_consts(cfg, "cpu")
    pos = torch.tensor([300] + POS[1:], dtype=torch.int32)
    first = split_attention(txn, tw, cfg, cos, sin, tk, tv, 1, pos)
    g = torch.Generator().manual_seed(3)
    tk2, tv2, pos2 = tk.clone(), tv.clone(), pos.clone()
    tk2[:, 1:] = torch.randn(tk2[:, 1:].shape, generator=g).to(tk.dtype)
    tv2[:, 1:] = torch.randn(tv2[:, 1:].shape, generator=g).to(tv.dtype)
    pos2[1:] = pos2[1:].flip(0)
    changed = split_attention(txn, tw, cfg, cos, sin, tk2, tv2, 1, pos2)
    alone = split_attention(txn[:1], tw, cfg, cos, sin, tk[:, :1], tv[:, :1], 1, pos[:1])
    for a, b_, c in zip(first, changed, alone):
        assert torch.equal(a[0], b_[0]) and torch.equal(a[0], c[0])
