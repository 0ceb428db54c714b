"""The port's device resize (deepseek_ocr2_tpu_torch/preprocess/device_resize.py)
against PIL and the JAX package's, on the CPU.

Every case of tests/test_device_resize.py (seven plain shapes, four
letterboxes, four tile grids, the bucket padding, a whole crop and no-crop
page) is bit-equal to PIL's bytes and to the JAX functions' on random
noise, the planner's tables are equal to the JAX package's element for
element, the auto / 1 / 0 choice is the JAX pipeline's, and one page,
the group engine and the continuous engine give the host path's tokens with
the device path (`device_resize=True`).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.preprocess import device_resize as jdr
from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline as JaxPipeline
from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.preprocess import device_resize as tdr
from deepseek_ocr2_tpu_torch.preprocess.image import (
    candidate_ratios,
    find_closest_aspect_ratio,
    pad_to_square,
    preprocess_base_u8,
    preprocess_tiles_u8,
)
from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

import reference_torch_vision as refv


def _noise(w: int, h: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _ship(img):
    return tdr.ship_image(img, "cpu")


@pytest.mark.parametrize("in_size,out_size", [(333, 97), (50, 160), (64, 64), (640, 7), (3, 5), (2200, 1536)])
def test_planner_tables_equal_jax(in_size, out_size):
    for a, b in zip(tdr.pil_coeffs(in_size, out_size), jdr.pil_coeffs(in_size, out_size)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdr._plain_plan(in_size, out_size), jdr._plain_plan(in_size, out_size)):
        np.testing.assert_array_equal(a, b)
    canvas = max(out_size, 8)
    valid = max(out_size // 2, 1)
    for a, b in zip(tdr._placed_plan(in_size, canvas, valid, (canvas - valid) // 2),
                    jdr._placed_plan(in_size, canvas, valid, (canvas - valid) // 2)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(in_size)
    kk = rng.integers(-6_000_000, 6_000_000, (40, 11), np.int64).astype(np.int32)
    d = tdr._digits3(kk)
    np.testing.assert_array_equal(d, jdr._digits3(kk))
    np.testing.assert_array_equal(d[0].astype(np.int64) * 65536 + d[1] * 256 + d[2], kk)
    img = _noise(in_size % 600 + 1, out_size % 300 + 1, seed=1)
    np.testing.assert_array_equal(tdr.bucket_pad(img), jdr.bucket_pad(img))


def test_dense_expansion_equals_jax():
    xmin, digs = tdr._plain_plan(333, 97)
    got = tdr._expand_dense(xmin, digs, 512, "cpu").numpy()
    want = np.asarray(jdr._expand_dense(xmin, digs, 512)).astype(np.float32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "in_w,in_h,out_w,out_h",
    [(333, 217, 97, 120), (50, 40, 160, 90), (64, 64, 64, 64), (640, 480, 7, 5), (3, 4, 5, 7), (500, 100, 100, 300),
     (257, 129, 256, 128)],
)
def test_plain_resize_bit_exact(in_w, in_h, out_w, out_h):
    img = _noise(in_w, in_h, seed=in_w * in_h)
    want = np.asarray(Image.fromarray(img).resize((out_w, out_h), Image.BICUBIC)).transpose(2, 0, 1)
    got = tdr.device_resize_u8(_ship(img), in_w, in_h, out_w, out_h)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdr.device_resize_u8(jdr.ship_image(img), in_w, in_h,
                                                                                 out_w, out_h)))


@pytest.mark.parametrize("w,h", [(550, 425), (210, 430), (256, 256), (90, 513)])
def test_letterbox_bit_exact(w, h):
    img = _noise(w, h, seed=w + h)
    want = np.asarray(pad_to_square(Image.fromarray(img), 256, 127)).transpose(2, 0, 1)
    got = tdr.device_letterbox_u8(_ship(img), w, h, 256, 127).numpy()
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got, np.asarray(jdr.device_letterbox_u8(jdr.ship_image(img), w, h, 256, 127)))


@pytest.mark.parametrize("ratio", [(2, 1), (1, 2), (3, 2), (2, 3)])
def test_tiles_bit_exact(ratio):
    w, h = 530, 410
    img = _noise(w, h, seed=ratio[0] * 10 + ratio[1])
    got = tdr.device_tiles_u8(_ship(img), w, h, 96, ratio).numpy()
    np.testing.assert_array_equal(got, preprocess_tiles_u8(Image.fromarray(img), 96, ratio))
    np.testing.assert_array_equal(got, np.asarray(jdr.device_tiles_u8(jdr.ship_image(img), w, h, 96, ratio)))


def test_bucket_pad_invariance():
    """Zero-padding the input to its shape bucket must not change the output."""
    img = _noise(300, 200, seed=7)
    assert tdr.bucket_pad(img).shape == (256, 512, 3)
    assert tuple(_ship(img).shape) == (256, 512, 3)
    got = tdr.device_resize_u8(_ship(img), 300, 200, 128, 96).numpy()
    want = np.asarray(Image.fromarray(img).resize((128, 96), Image.BICUBIC)).transpose(2, 0, 1)
    np.testing.assert_array_equal(got, want)
    unpadded = tdr.device_resize_u8(torch.from_numpy(img), 300, 200, 128, 96).numpy()
    np.testing.assert_array_equal(unpadded, want)


def test_full_page_matches_host_path():
    """device_preprocess_page == preprocess_base_u8 / preprocess_tiles_u8
    == the JAX package's device_preprocess_page."""
    w, h = 700, 330
    img = _noise(w, h, seed=42)
    pim = Image.fromarray(img)
    ratio = find_closest_aspect_ratio(w / h, candidate_ratios(2, 6), w, h, 128)
    base, tiles = tdr.device_preprocess_page(img, 256, 128, ratio, 127, device="cpu")
    np.testing.assert_array_equal(base.numpy(), preprocess_base_u8(pim, 256, 127))
    np.testing.assert_array_equal(tiles.numpy(), preprocess_tiles_u8(pim, 128, ratio))
    jbase, jtiles = jdr.device_preprocess_page(img, 256, 128, ratio, 127)
    np.testing.assert_array_equal(base.numpy(), np.asarray(jbase))
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jtiles))


def test_full_page_no_crop():
    img = _noise(180, 240, seed=3)
    base, tiles = tdr.device_preprocess_page(img, 256, 128, None, 127, device="cpu")
    assert tiles is None
    np.testing.assert_array_equal(base.numpy(), preprocess_base_u8(Image.fromarray(img), 256, 127))


def _tokenizer():
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tok


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    params, report = tocr2.params_from_flat(refv.random_ocr2_flat(cfg, seed=5), cfg)
    report.raise_on_errors()
    pipe = OCR2Pipeline(params, cfg, _tokenizer(), device="cpu")
    rng = np.random.default_rng(13)
    pages = [Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
             for w, h in ((500, 300), (160, 120), (300, 260), (90, 200))]  # crop, no-crop, crop, crop
    return cfg, pipe, pages


@pytest.mark.parametrize("setting,env", [(None, "auto"), (None, "1"), (None, "0"), (None, ""), ("auto", "1"),
                                         (True, "0"), (False, "1")])
def test_device_resize_choice_as_jax(setup, monkeypatch, setting, env):
    """The pipeline takes the device path exactly where the JAX pipeline
    does: the argument, else DEEPSEEK_DEVICE_RESIZE ("auto" = crop pages)."""
    cfg, pipe, pages = setup
    monkeypatch.setenv("DEEPSEEK_DEVICE_RESIZE", env)
    jpipe = JaxPipeline({}, cfg, _tokenizer(), device_resize=setting)
    port = OCR2Pipeline({}, cfg, _tokenizer(), device="cpu", device_resize=setting)
    for page in pages[:2]:
        got, want = port.preprocess_host(page), jpipe.preprocess_host(page)
        assert got["mode"] == want["mode"]
        assert tuple(got["ratio"]) == tuple(want["ratio"])
        if got["mode"] == "device":
            np.testing.assert_array_equal(got["arr"], want["arr"])
            assert got["cropping"] == want["cropping"]


def test_device_resize_token_exact(setup):
    """One page, the group engine and the continuous engine with the device
    path give the host path's tokens (the pixels are bit-equal)."""
    cfg, pipe, pages = setup
    host = [pipe.generate_ocr(p, max_new_tokens=5, ngram_size=2) for p in pages]
    dev = OCR2Pipeline(pipe.params, cfg, pipe.tokenizer, device="cpu", device_resize=True)
    pre = dev.preprocess_host(pages[0])
    assert pre["mode"] == "device" and "base" not in pre
    single = [dev.generate_ocr(p, max_new_tokens=5, ngram_size=2) for p in pages]
    group = OCR2Engine(dev, batch_size=2).run(pages, max_new_tokens=5, ngram_size=2)
    cont = ContinuousOCREngine(dev, slots=2, capacity=128, chunk_steps=4).run(pages, max_new_tokens=5, ngram_size=2)
    for h, s, g, c in zip(host, single, group, cont):
        assert s.token_ids == h.token_ids
        assert torch.equal(s.logits0, h.logits0)
        assert g.token_ids == h.token_ids
        assert c.token_ids == h.token_ids
    assert [r.crop_ratio for r in single] == [r.crop_ratio for r in host]
    assert host[0].crop_ratio != (1, 1) and host[1].crop_ratio == (1, 1)


def test_device_resize_env_reaches_the_engines(setup, monkeypatch):
    """DEEPSEEK_DEVICE_RESIZE=auto with the pipeline's default (None): crop
    pages take the device path in the continuous engine's prefetch worker,
    no-crop pages the host one; the tokens are the host path's."""
    cfg, pipe, pages = setup
    host = [pipe.generate_ocr(p, max_new_tokens=4, ngram_size=2) for p in pages]
    monkeypatch.setenv("DEEPSEEK_DEVICE_RESIZE", "auto")
    modes = [pipe.preprocess_host(p)["mode"] for p in pages]
    assert modes == ["device", "host", "device", "device"]
    engine = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=4)
    engine.start(ngram_size=2)
    try:
        reqs = [engine.submit(p, max_new_tokens=4) for p in pages]
        served = [r.result(timeout=300) for r in reqs]
    finally:
        engine.stop(timeout=120)
    assert [r.token_ids for r in served] == [r.token_ids for r in host]
    assert os.environ["DEEPSEEK_DEVICE_RESIZE"] == "auto"
