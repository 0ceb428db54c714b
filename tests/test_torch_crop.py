"""Crop mode of the PyTorch port against the JAX package, on the CPU at tiny
widths: the expert-aligned layout, the grouped-GEMM MoE twin and its
dispatch, SAM at the crop size (pos-embed and rel-pos resize), the
local -> global -> separator injection, greedy tokens end to end, and the
pipeline's crop decision.

Tolerances: the layout is exact; f32 MoE results agree to 2e-5 and bf16 to
rtol 2e-2 / atol 8e-3, the bounds of the JAX package's own gmm tests
(tests/test_moe_gmm.py: f32 summation order; in bf16 one f32 sum landing on
the other side of a rounding boundary moves an output by an ulp); the
resizes agree to 1e-6 (both sides compute the same f32 filter taps); the
towers in f32 to 1e-4 (a dozen f32 ops deep, other summation orders);
greedy tokens are equal.
"""

import dataclasses
from contextlib import nullcontext

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.configs import tiny_lm_config, tiny_ocr2_config
from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
from deepseek_ocr2_tpu.models import sam as jsam
from deepseek_ocr2_tpu.ops import moe as jmoe
from deepseek_ocr2_tpu.ops.moe_gmm import _aligned_layout as jax_aligned_layout
from deepseek_ocr2_tpu.ops.moe_gmm import moe_ffn_gmm as jax_moe_ffn_gmm
from deepseek_ocr2_tpu.runtime.generate import greedy_generate as jax_greedy
from deepseek_ocr2_tpu_torch.io import DtypePolicy
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.models import sam as tsam
from deepseek_ocr2_tpu_torch.ops import moe as tmoe
from deepseek_ocr2_tpu_torch.ops import moe_gmm as tgmm
from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate

import reference_torch_vision as refv

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=8e-3)
TOWER = dict(rtol=1e-4, atol=1e-4)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("bm", [32, 64])
@pytest.mark.parametrize("sizes", [[5, 0, 700, 3, 0, 60], [0, 0, 0, 768], [256, 256, 256], [1] * 64])
def test_aligned_layout_matches_jax(sizes, bm):
    m = sum(sizes)
    m_pad = -(-m // bm) * bm
    want = jax_aligned_layout(jnp.asarray(sizes, jnp.int32), m_pad, bm)
    got = tgmm.aligned_layout(torch.tensor(sizes, dtype=torch.int32), m_pad, bm)
    for name, w, g in zip(("src_slot", "slot_valid", "slot_of_sorted", "e_tile", "tile_valid"), want, got):
        assert g.shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _moe_case(dtype, n, seed=0, e=8, h=64, i=32, k=2):
    """Experts in both layouts (port [E, I, H] / [E, H, I], JAX [E, H, I] /
    [E, I, H]) and routing from a random f32 router, made with numpy."""
    rng = np.random.default_rng(seed)
    gate, up, down = _rand(rng, e, i, h, scale=0.05), _rand(rng, e, i, h, scale=0.05), _rand(rng, e, h, i, scale=0.05)
    x = _rand(rng, n, h)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx = jnp.asarray(x).astype(jdt)
    jex = {name: jnp.asarray(a.transpose(0, 2, 1)).astype(jdt) for name, a in (("gate", gate), ("up", up), ("down", down))}
    w, idx = jmoe.route(jx.astype(jnp.float32), jnp.asarray(_rand(rng, h, e, scale=0.1)), k)
    tex = {name: torch.from_numpy(a).to(tdt) for name, a in (("gate", gate), ("up", up), ("down", down))}
    tx = torch.from_numpy(x).to(tdt)
    return (jx, jex, w, idx), (tx, tex, torch.from_numpy(np.array(w)), torch.from_numpy(np.array(idx)).long())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_twin_and_aligned_path_match_jax_gmm_and_ragged(dtype):
    """The grouped twin (the CPU path above 512 rows) and the aligned path
    (the routed chain's layout, D through its row map, E through its row
    map and the combine as their plain twins: what the card runs) against
    JAX `moe_ffn_gmm` in interpret mode and `moe_ffn_ragged`, at N = 600 >
    512."""
    (jx, jex, w, idx), (tx, tex, tw, tidx) = _moe_case(dtype, 600)
    # bf16 at DEFAULT precision, as tests/test_moe_gmm.py runs it.
    with jax.default_matmul_precision("default") if dtype == "bfloat16" else nullcontext():
        want_gmm = np.asarray(jax_moe_ffn_gmm(jx, jex, w, idx, interpret=True).astype(jnp.float32))
        want_ragged = np.asarray(jmoe.moe_ffn_ragged(jx, jex, w, idx).astype(jnp.float32))
    tol = F32 if dtype == "float32" else BF16
    twin = tgmm.moe_ffn_gmm_reference(tx, tex, tw, tidx)
    aligned = tgmm._forward_routed(tx, tex, tw, tidx, tgmm.routed_layout(tidx, tex["gate"].shape[0]), tx.dtype)
    assert twin.dtype == aligned.dtype == getattr(torch, dtype) and twin.shape == (600, 64)
    for got in (twin, aligned, tgmm.moe_ffn_gmm(tx, tex, tw, tidx)):
        np.testing.assert_allclose(got.float().numpy(), want_gmm, **tol)
        np.testing.assert_allclose(got.float().numpy(), want_ragged, **tol)


def test_gmm_plain_kernel_twins_zero_invalid_tiles():
    """D and E's plain twins: each valid tile against its expert's weights,
    rows of invalid tiles zero (the kernels leave the zeroed output)."""
    rng = np.random.default_rng(1)
    bm, e, h, i = 4, 3, 8, 12
    x = torch.from_numpy(_rand(rng, 5 * bm, h))
    wg, wu, wd = (torch.from_numpy(_rand(rng, e, *s)) for s in ((i, h), (i, h), (h, i)))
    e_tile = torch.tensor([2, 0, 0, 1, 1], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 0, 0], dtype=torch.int32)
    act = tgmm.moe_gmm_swiglu(x, wg, wu, e_tile, valid)
    y = tgmm.moe_gmm_down(act, wd, e_tile, valid)
    for t in range(5):
        rows = slice(t * bm, (t + 1) * bm)
        if valid[t]:
            ex = int(e_tile[t])
            want = tmoe.swiglu(x[rows], wg[ex], wu[ex], wd[ex])
            torch.testing.assert_close(y[rows], want, **F32)
        else:
            assert not act[rows].any() and not y[rows].any()


@pytest.mark.parametrize("n", [600, 300])
def test_moe_prefill_dispatch_matches_jax(n):
    """Above 512 rows both sides take the grouped form (the ragged path in
    the JAX package on the CPU), at or below it the dense form."""
    (jx, jex, w, idx), (tx, tex, tw, tidx) = _moe_case("float32", n, seed=2)
    want = np.asarray(jmoe.moe_ffn_prefill(jx, jex, w, idx))
    np.testing.assert_allclose(tmoe.moe_ffn_prefill(tx, tex, tw, tidx).numpy(), want, **F32)
    grouped = tgmm.moe_ffn_gmm_reference(tx, tex, tw, tidx)
    dense = tmoe.moe_ffn_dense(tx, tex, tw, tidx)
    assert torch.equal(tmoe.moe_ffn_prefill(tx, tex, tw, tidx), grouped if n > 512 else dense)


def test_resizes_match_jax_at_crop_shapes():
    """The full model's crop resizes: pos-embed 64x64x768 -> 48x48 (bicubic,
    antialias) and a global block's rel-pos table 127 -> 95 (linear)."""
    rng = np.random.default_rng(3)
    pos = _rand(rng, 1, 64, 64, 768, scale=0.02)
    want = np.asarray(jsam.resize_pos_embed(jnp.asarray(pos), 48, 48))
    got = tsam.resize_pos_embed(torch.from_numpy(pos), 48, 48).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    rel = _rand(rng, 127, 64, scale=0.1)
    want = np.asarray(jsam.get_rel_pos(48, 48, jnp.asarray(rel)))
    np.testing.assert_allclose(tsam.get_rel_pos(48, 48, torch.from_numpy(rel)).numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_ocr2_config(lm=tiny_lm_config(max_position_embeddings=1024))
    flat = refv.random_ocr2_flat(cfg, seed=11)
    jp, rep = jocr2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    tp, rep = tocr2.params_from_flat(flat, cfg, policy=DtypePolicy(default="float32"))
    rep.raise_on_errors()
    return cfg, jp, tp


def _views(cfg, n_patches, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-1, 1, (1, 3, cfg.base_image_size, cfg.base_image_size)).astype(np.float32)
    patches = rng.uniform(-1, 1, (n_patches, 3, cfg.crop_image_size, cfg.crop_image_size)).astype(np.float32)
    return base, patches


def test_sam_crop_view_matches_jax(models):
    """[2, 3, 192, 192] crops: the 16x16 pos-embed goes to 12x12 and the
    global block's 31-row rel-pos tables to 23."""
    cfg, jp, tp = models
    _, x = _views(cfg, 2, seed=4)
    want = np.asarray(jsam.sam_forward(jp["sam"], cfg.sam, jnp.asarray(x)))
    with torch.no_grad():
        got = tsam.sam_forward(tp["sam"], cfg.sam, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, cfg.sam.net_3_chans, 3, 3)
    np.testing.assert_allclose(got, want, **TOWER)


def test_encode_views_with_patches_matches_jax(models):
    cfg, jp, tp = models
    base, patches = _views(cfg, 2, seed=5)
    want = np.asarray(jocr2.encode_views(jp, cfg, jnp.asarray(base), jnp.asarray(patches)))
    with torch.no_grad():
        got = tocr2.encode_views(tp, cfg, torch.from_numpy(base), torch.from_numpy(patches))
        global_only = tocr2.encode_views(tp, cfg, torch.from_numpy(base))
    nq_crop = cfg.num_queries(cfg.crop_image_size) ** 2
    nq_base = cfg.num_queries(cfg.base_image_size) ** 2
    assert got.shape == want.shape == (cfg.image_token_count((2, 1)), cfg.lm.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, **TOWER)
    # Order: local (2 x 9 rows) -> global (16) -> separator.
    torch.testing.assert_close(got[2 * nq_crop : 2 * nq_crop + nq_base], global_only[:nq_base])
    torch.testing.assert_close(got[-1], tp["view_seperator"])


@pytest.mark.parametrize("text_tail", [2, 520])
def test_crop_greedy_tokens_match_jax_f32(models, text_tail, monkeypatch):
    """2 crops, f32. With a 520-token text tail the prompt is over 512
    tokens, so both LMs take the grouped MoE path in prefill."""
    cfg, jp, tp = models
    base, patches = _views(cfg, 2, seed=6)
    n_img = cfg.image_token_count((2, 1))
    tail = np.random.default_rng(7).integers(2, cfg.lm.vocab_size, text_tail).tolist()
    ids = [cfg.bos_token_id, 17] + [cfg.image_token_id % cfg.lm.vocab_size] * n_img + tail
    gen = dict(max_new_tokens=8, ngram_size=3, eos_id=1, capacity=640)

    je = jocr2.ocr_prefill_embeds(jp, cfg, jnp.asarray(ids, jnp.int32)[None], jnp.asarray(base), jnp.asarray(patches), 2)
    tokens, n_gen = jax_greedy(jp["lm"], cfg.lm, je, jnp.asarray(ids, jnp.int32), kv_dtype="float32", **gen)
    want = np.asarray(tokens[0, : len(ids) + int(n_gen[0])]).tolist()

    grouped_calls = []
    monkeypatch.setattr(tmoe, "moe_ffn_gmm", lambda *a: grouped_calls.append(1) or tgmm.moe_ffn_gmm(*a))
    with torch.no_grad():
        vision = tocr2.encode_views(tp, cfg, torch.from_numpy(base), torch.from_numpy(patches))
        te = tocr2.build_inputs_embeds(tp, torch.tensor([ids]), vision, 2)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOWER)
    tokens, n_gen = greedy_generate(tp["lm"], cfg.lm, te, torch.tensor(ids), kv_dtype=torch.float32, **gen)
    assert tokens[0, : len(ids) + int(n_gen[0])].tolist() == want
    assert len(grouped_calls) == (cfg.lm.num_moe_layers if len(ids) > 512 else 0)


def test_pipeline_takes_crop_mode_on_a_large_page(models):
    """A 500x300 page at the tiny config (crop size 192): the grid and the
    prompt length are those of the JAX package's tiling and tokenizer."""
    from PIL import Image

    from chip_smoke import StubTokenizer
    from deepseek_ocr2_tpu.preprocess.image import candidate_ratios, find_closest_aspect_ratio
    from deepseek_ocr2_tpu.utils.tokenizer import tokenize_with_image
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    cfg, _, tp = models
    page = Image.fromarray(np.random.default_rng(8).integers(0, 256, (300, 500, 3), np.uint8))
    tok = StubTokenizer(cfg.lm.vocab_size)
    pipe = OCR2Pipeline(tp, cfg, tok, device="cpu")
    r = pipe.generate_ocr(page, max_new_tokens=4, ngram_size=3)
    ratio = find_closest_aspect_ratio(500 / 300, candidate_ratios(cfg.min_crop_tiles, cfg.max_crop_tiles), 500, 300,
                                      cfg.crop_image_size)
    ids, _, _ = tokenize_with_image(tok, cfg.default_ocr_prompt, cfg, ratio)
    assert r.crop_ratio == ratio == (3, 2)
    assert cfg.image_token_count(ratio) == 17 + 6 * 9 == 71
    assert r.prompt_len == len(ids) and r.token_ids[: len(ids)] == ids
    assert bool(torch.isfinite(r.logits0).all())
    pre = pipe.preprocess_host(page)
    assert pre["patches"].shape == (6, 3, 192, 192) and pre["patches"].dtype == np.uint8
    assert pipe.preprocess_host(page, no_crop=True)["patches"] is None
    with pytest.raises(ValueError, match="patches"):
        pipe.preprocess_finish(dict(pre, patches=pre["patches"][:5]))
