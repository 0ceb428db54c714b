"""Op-level parity of the PyTorch port against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both. Tolerances:
f32 ops agree to ~1e-6 (same math, other summation order); masks, tables,
routing indices and sampling picks are exact.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops import attention as jattn
from deepseek_ocr2_tpu.ops import moe as jmoe
from deepseek_ocr2_tpu.ops import norms as jnorms
from deepseek_ocr2_tpu.ops import rope as jrope
from deepseek_ocr2_tpu.ops import sampling as jsampling
from deepseek_ocr2_tpu_torch.ops import attention as tattn
from deepseek_ocr2_tpu_torch.ops import moe as tmoe
from deepseek_ocr2_tpu_torch.ops import norms as tnorms
from deepseek_ocr2_tpu_torch.ops import rope as trope
from deepseek_ocr2_tpu_torch.ops import sampling as tsampling

F32 = dict(rtol=1e-6, atol=1e-6)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_rms_norm_and_layer_norm():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 3, 5, 64), 1 + _rand(rng, 64, scale=0.1), _rand(rng, 64, scale=0.1)
    got = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    want = np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    np.testing.assert_allclose(got, want, **F32)
    got = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-6)
    want = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_rope_cache_bit_identical_and_apply():
    cos_t, sin_t = trope.rope_cache(64, 16, 10_000.0)
    cos_j, sin_j = jrope.rope_cache(64, 16, 10_000.0)
    np.testing.assert_array_equal(cos_t.numpy(), cos_j)
    np.testing.assert_array_equal(sin_t.numpy(), sin_j)
    rng = np.random.default_rng(1)
    q, k = _rand(rng, 1, 4, 7, 16), _rand(rng, 1, 2, 7, 16)
    for start in (0, 11):
        tq, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), cos_t, sin_t, start=start)
        jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(cos_j), jnp.asarray(sin_j), start=start)
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **F32)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **F32)


def test_masks_exact():
    np.testing.assert_array_equal(tattn.causal_mask(5, 9, q_start=3).numpy(), np.asarray(jattn.causal_mask(5, 9, 3)))
    np.testing.assert_array_equal(tattn.prefix_lm_mask(12, 5).numpy(), np.asarray(jattn.prefix_lm_mask(12, 5)))
    np.testing.assert_array_equal(tattn.decode_mask(16, 6).numpy(), np.asarray(jattn.decode_mask(16, 6)))


@pytest.mark.parametrize("with_bias", [False, True])
def test_sdpa_matches_jax(with_bias):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 3, 9, 16), _rand(rng, 2, 3, 9, 16), _rand(rng, 2, 3, 9, 16)
    bias = _rand(rng, 2, 3, 9, 9, scale=0.3) if with_bias else None
    mask = np.array(jattn.prefix_lm_mask(9, 4))[None, None]
    got = tattn.sdpa(
        *map(torch.from_numpy, (q, k, v)), scale=0.25, mask=torch.from_numpy(mask),
        bias=None if bias is None else torch.from_numpy(bias),
    )
    want = jattn.sdpa(
        *map(jnp.asarray, (q, k, v)), scale=0.25, mask=jnp.asarray(mask),
        bias=None if bias is None else jnp.asarray(bias),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_repeat_kv_exact():
    x = np.arange(2 * 2 * 3 * 4, dtype=np.float32).reshape(2, 2, 3, 4)
    np.testing.assert_array_equal(
        tattn.repeat_kv(torch.from_numpy(x), 3).numpy(), np.asarray(jattn.repeat_kv(jnp.asarray(x), 3))
    )


@pytest.mark.parametrize("ties", [False, True])
def test_route_first_index_tie_break(ties):
    rng = np.random.default_rng(3)
    n, h, e, k = 6, 16, 8, 3
    x = _rand(rng, n, h)
    router = _rand(rng, e, h)  # HF [E, H]
    if ties:
        # Experts 1, 4 and 6 score identically: the top-k must keep the
        # lowest index first, as lax.top_k does.
        router[4] = router[1]
        router[6] = router[1]
        x = np.abs(x) * np.sign(router[1])[None]  # make the tied experts win
    tw, ti = tmoe.route(torch.from_numpy(x), torch.from_numpy(router), k)
    jw, ji = jmoe.route(jnp.asarray(x), jnp.asarray(router.T), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **F32)
    if ties:
        assert ti[:, :3].tolist() == [[1, 4, 6]] * n


def _experts(rng, e, h, i):
    gate, up, down = _rand(rng, e, i, h, scale=0.3), _rand(rng, e, i, h, scale=0.3), _rand(rng, e, h, i, scale=0.3)
    torch_ex = {"gate": torch.from_numpy(gate), "up": torch.from_numpy(up), "down": torch.from_numpy(down)}
    jax_ex = {
        "gate": jnp.asarray(gate.transpose(0, 2, 1)),
        "up": jnp.asarray(up.transpose(0, 2, 1)),
        "down": jnp.asarray(down.transpose(0, 2, 1)),
    }
    return torch_ex, jax_ex


@pytest.mark.parametrize("n", [1, 5])
def test_moe_dense_and_decode_match_jax(n):
    rng = np.random.default_rng(4)
    e, h, i, k = 8, 16, 12, 2
    tex, jex = _experts(rng, e, h, i)
    x = _rand(rng, n, h)
    w, idx = jmoe.route(jnp.asarray(x), jnp.asarray(_rand(rng, h, e)), k)
    tw, tidx = torch.from_numpy(np.array(w)), torch.from_numpy(np.array(idx)).long()
    want = np.asarray(jmoe.moe_ffn_dense(jnp.asarray(x), jex, w, idx))
    np.testing.assert_allclose(tmoe.moe_ffn_dense(torch.from_numpy(x), tex, tw, tidx).numpy(), want, **F32)
    want = np.asarray(jmoe.moe_ffn_decode(jnp.asarray(x), jex, w, idx))
    np.testing.assert_allclose(tmoe.moe_ffn_decode(torch.from_numpy(x), tex, tw, tidx).numpy(), want, **F32)
    np.testing.assert_allclose(tmoe.moe_ffn_prefill(torch.from_numpy(x), tex, tw, tidx).numpy(), want, rtol=1e-5, atol=1e-5)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(5)
    x, g, u, d = _rand(rng, 4, 16), _rand(rng, 24, 16), _rand(rng, 24, 16), _rand(rng, 16, 24)
    got = tmoe.swiglu(*map(torch.from_numpy, (x, g, u, d))).numpy()
    want = np.asarray(jmoe.swiglu(jnp.asarray(x), jnp.asarray(g.T), jnp.asarray(u.T), jnp.asarray(d.T)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ngram", [0, 2, 3])
def test_ngram_ban_mask_matches_jax(ngram):
    tokens = np.array([5, 7, 9, 5, 7, 3, 5, 7, 600, 0, 0, 0], np.int32)  # 600 lies outside the vocab
    for cur_len in (2, 5, 7, 8, 9):
        got = tsampling.ngram_ban_mask_batched(torch.from_numpy(tokens)[None], torch.tensor([cur_len]), ngram, 32)[0]
        want = np.asarray(jsampling.ngram_ban_mask(jnp.asarray(tokens), jnp.int32(cur_len), ngram, 32))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ngram", [0, 2, 3])
def test_ngram_ban_mask_batched_matches_jax_vmap(ngram):
    """Per-row lengths in a [B] tensor, as the continuous engine's
    `jax.vmap(ngram_ban_mask, in_axes=(0, 0, None, None))`."""
    import jax

    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 6, (5, 14)).astype(np.int32)
    tokens[1, 4] = 600  # outside the vocab
    lens = np.array([0, 5, 9, 14, 2], np.int32)
    want = np.asarray(jax.vmap(jsampling.ngram_ban_mask, in_axes=(0, 0, None, None))(
        jnp.asarray(tokens), jnp.asarray(lens), ngram, 32))
    got = tsampling.ngram_ban_mask_batched(torch.from_numpy(tokens), torch.from_numpy(lens), ngram, 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_greedy_pick_first_index_nan_and_ban():
    logits = np.array([[1.0, 3.0, np.nan, 3.0, 2.0], [0.5, 0.5, 0.1, np.nan, 0.5]], np.float32)
    ban = np.array([[False, False, False, False, False], [True, False, False, False, False]])
    for b in (None, ban):
        got = tsampling.greedy_pick(torch.from_numpy(logits), None if b is None else torch.from_numpy(b))
        want = [int(jsampling.greedy_pick(jnp.asarray(row), None if b is None else jnp.asarray(br)))
                for row, br in zip(logits, b if b is not None else [None, None])]
        assert got.tolist() == want
