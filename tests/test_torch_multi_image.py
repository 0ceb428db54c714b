"""Multi-image / non-contiguous placeholder injection in the port, against the
JAX package (tests/test_multi_image.py's cases): `tokenize_with_images`,
`build_inputs_embeds_masked` (HF `masked_scatter` semantics) and
`encode_views_multi`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
from deepseek_ocr2_tpu.utils import tokenizer as jtok
from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.utils.tokenizer import tokenize_with_image, tokenize_with_images

import reference_torch_vision as refv


class _WordTok:
    """4-word whitespace tokenizer stand-in."""

    _vocab = {"Free": 10, "OCR.": 11, "hello": 13, "and": 14}

    def encode(self, text, add_special_tokens=False):
        class Enc:
            pass

        e = Enc()
        e.ids = [self._vocab.get(w, 2) for w in text.split()]
        return e


def _cfg():
    return dataclasses.replace(tiny_ocr2_config(), image_token_id=500)


def test_tokenize_with_images_two_blocks_as_jax():
    cfg = _cfg()
    prompt = "hello <image> and <image> Free OCR."
    ids, mask, starts = tokenize_with_images(_WordTok(), prompt, cfg, [(1, 1), (2, 1)])
    assert (ids, mask, starts) == jtok.tokenize_with_images(_WordTok(), prompt, cfg, [(1, 1), (2, 1)])
    n0, n1 = cfg.image_token_count((1, 1)), cfg.image_token_count((2, 1))
    s0, s1 = starts
    assert ids[s0 : s0 + n0] == [cfg.image_token_id] * n0 and ids[s1 : s1 + n1] == [cfg.image_token_id] * n1
    assert sum(mask) == n0 + n1 and mask[s0 + n0] is False and ids[0] == cfg.bos_token_id


def test_tokenize_with_image_still_requires_exactly_one():
    cfg = _cfg()
    for prompt in ("no placeholder", "<image> two <image>"):
        with pytest.raises(ValueError):
            tokenize_with_image(_WordTok(), prompt, cfg)
    ids, mask, start = tokenize_with_image(_WordTok(), "x <image> y", cfg)
    assert (ids, mask, [start]) == tokenize_with_images(_WordTok(), "x <image> y", cfg, [(1, 1)])
    with pytest.raises(ValueError):
        tokenize_with_images(_WordTok(), "a <image> b", cfg, [(1, 1), (1, 1)])


def _embed(cfg, seed=0):
    return np.random.default_rng(seed).standard_normal((cfg.lm.vocab_size, cfg.lm.hidden_size)).astype(np.float32)


def test_masked_matches_contiguous_single_block():
    cfg = _cfg()
    embed = _embed(cfg)
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.lm.vocab_size, (1, 12)))
    vis = torch.from_numpy(rng.standard_normal((5, cfg.lm.hidden_size)).astype(np.float32))
    mask = torch.zeros(12, dtype=torch.bool)
    mask[3:8] = True
    params = {"lm": {"embed": torch.from_numpy(embed)}}
    a = tocr2.build_inputs_embeds(params, ids, vis, 3)
    b = tocr2.build_inputs_embeds_masked(params, ids, vis, mask)
    assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["two_blocks", "interleaved"])
def test_masked_scatter_parity_vs_torch_and_jax(layout):
    cfg = _cfg()
    embed = _embed(cfg)
    s = 20
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.lm.vocab_size, (1, s)).astype(np.int32)
    mask = np.zeros((s,), bool)
    if layout == "two_blocks":
        mask[2:6] = True
        mask[10:13] = True
    else:
        mask[[1, 4, 5, 9, 15, 19]] = True
    vis = rng.standard_normal((int(mask.sum()), cfg.lm.hidden_size)).astype(np.float32)
    got = tocr2.build_inputs_embeds_masked({"lm": {"embed": torch.from_numpy(embed)}}, torch.from_numpy(ids).long(),
                                           torch.from_numpy(vis), torch.from_numpy(mask)).numpy()
    base = torch.from_numpy(embed)[torch.from_numpy(ids.astype(np.int64))]  # [1, S, H]
    expected = base.masked_scatter(torch.from_numpy(mask)[None, :, None], torch.from_numpy(vis))
    np.testing.assert_array_equal(got, expected.numpy())
    want = jocr2.build_inputs_embeds_masked({"lm": {"embed": jnp.asarray(embed)}}, cfg, jnp.asarray(ids),
                                            jnp.asarray(vis), jnp.asarray(mask))
    np.testing.assert_array_equal(got, np.asarray(want))
    # A placeholder id outside the vocabulary is never looked up.
    ids_img = ids.copy()
    ids_img[0, mask] = cfg.lm.vocab_size + 7
    again = tocr2.build_inputs_embeds_masked({"lm": {"embed": torch.from_numpy(embed)}},
                                             torch.from_numpy(ids_img).long(), torch.from_numpy(vis),
                                             torch.from_numpy(mask))
    np.testing.assert_array_equal(again.numpy(), got)


def test_encode_views_multi_concatenates_in_order_as_jax():
    cfg = _cfg()
    flat = refv.random_ocr2_flat(cfg, seed=9)
    params, report = tocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    s, c = cfg.base_image_size, cfg.crop_image_size
    rng = np.random.default_rng(3)
    img1, img2 = (rng.standard_normal((1, 3, s, s)).astype(np.float32) * 0.1 for _ in range(2))
    crops2 = rng.standard_normal((2, 3, c, c)).astype(np.float32) * 0.1
    t = torch.from_numpy
    with torch.no_grad():
        v1 = tocr2.encode_views(params, cfg, t(img1))
        v2 = tocr2.encode_views(params, cfg, t(img2), t(crops2))
        both = tocr2.encode_views_multi(params, cfg, [(t(img1), None), (t(img2), t(crops2))])
    assert torch.equal(both, torch.cat([v1, v2]))
    assert both.shape[0] == cfg.image_token_count((1, 1)) + cfg.image_token_count((2, 1))
    jparams = jax.tree_util.tree_map(jnp.asarray, jocr2.params_from_flat(flat, cfg)[0])
    want = jocr2.encode_views_multi(jparams, cfg, [(jnp.asarray(img1), None), (jnp.asarray(img2), jnp.asarray(crops2))])
    np.testing.assert_allclose(both.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
