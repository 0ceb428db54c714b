"""The port's debug channels against the JAX package's (tests/test_debug_channels.py's
cases, plus the lines themselves).

- DEEPSEEK_DEBUG_TOPK dumps every greedy step's top-10 and keeps the tokens;
- DEEPSEEK_DEBUG_OCR prints the embedding fingerprints;
- DEEPSEEK_SAM_POS_RESIZE's three modes equal the JAX `resize_pos_embed`
  within 1e-5 (bicubic with antialias, bilinear and bicubic without);
- with every channel on (OCR, VISION, ATTN, MOE, LAYER0, TOPK, TOKENS), the
  port prints the JAX package's lines in the JAX package's order on the same
  tiny crop page: the same names, shapes and dtypes, and the same rotation,
  routing counts, top-10 ids and token ids (f32 weights).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
from deepseek_ocr2_tpu.models.sam import resize_pos_embed as jax_resize_pos_embed
from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline as JaxPipeline
from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.models.sam import resize_pos_embed
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

import reference_torch_vision as refv

CHANNELS = ("OCR", "VISION", "ATTN", "MOE", "LAYER0", "TOPK", "TOKENS")


def _tiny_tokenizer():
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tok


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    flat = refv.random_ocr2_flat(cfg, seed=5)
    params, report = tocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    pipe = OCR2Pipeline(params, cfg, _tiny_tokenizer(), device="cpu")
    rng = np.random.default_rng(1)
    page = Image.fromarray(rng.integers(0, 256, (96, 128, 3), np.uint8))
    return cfg, flat, pipe, page


@pytest.fixture(autouse=True)
def _channels_off(monkeypatch):
    for ch in CHANNELS:
        monkeypatch.delenv(f"DEEPSEEK_DEBUG_{ch}", raising=False)
    monkeypatch.delenv("DEEPSEEK_SAM_POS_RESIZE", raising=False)


def test_topk_per_step_dumps_and_token_identical(setup, monkeypatch, capfd):
    cfg, _, pipe, page = setup
    base = pipe.generate_ocr(page, max_new_tokens=4, ngram_size=3)
    capfd.readouterr()
    monkeypatch.setenv("DEEPSEEK_DEBUG_TOPK", "1")
    dbg = pipe.generate_ocr(page, max_new_tokens=4, ngram_size=3)
    err = capfd.readouterr().err
    assert dbg.token_ids == base.token_ids  # the debug loop stays token-exact
    assert "step0 top10 ids=" in err
    assert "step1 top10 ids=" in err  # every decode step
    assert "step0 top10 logit=" in err
    # Under lookup decoding the debug loop is the plain one, as in the JAX package.
    lookup = OCR2Pipeline(pipe.params, cfg, pipe.tokenizer, device="cpu", lookup_chunk=4)
    assert lookup.generate_ocr(page, max_new_tokens=4, ngram_size=3).token_ids == base.token_ids
    assert f"step{base.new_tokens - 1} top10 ids=" in capfd.readouterr().err


def test_ocr_embedding_fingerprints(setup, monkeypatch, capfd):
    _, _, pipe, page = setup
    monkeypatch.setenv("DEEPSEEK_DEBUG_OCR", "1")
    pipe.generate_ocr(page, max_new_tokens=2, ngram_size=0)
    err = capfd.readouterr().err
    for line in ("rotate_used=0", "inputs_embeds nan=", "inputs_embeds fingerprint=", "inputs_embeds[pos0]=",
                 "inputs_embeds[pos1]=", "inputs_embeds[pos_last]=", "prompt_len="):
        assert f"debug: {line}" in err, line


@pytest.mark.parametrize("shape,out", [((1, 8, 8, 4), (6, 6)), ((1, 8, 8, 4), (11, 13)), ((1, 64, 64, 8), (48, 48)),
                                       ((1, 16, 16, 8), (3, 5))])
def test_sam_pos_resize_modes_match_jax(monkeypatch, shape, out):
    """DEEPSEEK_SAM_POS_RESIZE switches the pos-embed resize filter; each
    mode equals the JAX package's within 1e-5, and the modes differ."""
    pos = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = {}
    for mode in ("", "interp_bilinear", "interp_bicubic"):
        monkeypatch.setenv("DEEPSEEK_SAM_POS_RESIZE", mode)
        got[mode] = resize_pos_embed(torch.from_numpy(pos), *out).numpy()
        want = np.asarray(jax_resize_pos_embed(jnp.asarray(pos), *out))
        assert got[mode].shape == want.shape == (1, *out, shape[-1])
        np.testing.assert_allclose(got[mode], want, rtol=0, atol=1e-5, err_msg=mode or "default")
    assert not np.allclose(got[""], got["interp_bilinear"])
    assert not np.allclose(got[""], got["interp_bicubic"])
    assert not np.allclose(got["interp_bilinear"], got["interp_bicubic"])
    monkeypatch.delenv("DEEPSEEK_SAM_POS_RESIZE")
    np.testing.assert_array_equal(resize_pos_embed(torch.from_numpy(pos), *out).numpy(), got[""])
    bf = resize_pos_embed(torch.from_numpy(pos).to(torch.bfloat16), *out)
    assert bf.dtype == torch.bfloat16


_STATS = re.compile(r"(\S+): nan=(\d+) min=\S+ max=\S+ shape=(\(.*\)) dtype=(\S+)$")
_EXACT = re.compile(r"(rotate_used|layer\d+ moe counts|step\d+ top10 ids|step\d+ top10 tok|step\d+ next_id)=(.*)$")


def _line_keys(err: str):
    """Each debug line as what must agree across the packages: a stat dump's
    name, nan count, shape and dtype; the discrete values of the rotation,
    routing counts, top-10 ids and tokens; else the text before its first
    '=' (a line of floats)."""
    keys = []
    for line in err.splitlines():
        if not line.startswith("debug: "):
            continue
        body = line[len("debug: "):]
        m = _STATS.match(body) or _EXACT.match(body)
        keys.append(m.groups() if m else body.split("=", 1)[0])
    return keys


def test_all_channels_print_the_jax_lines_in_order(setup, monkeypatch, capfd):
    cfg, flat, pipe, _ = setup
    page = Image.fromarray(np.random.default_rng(2).integers(0, 256, (300, 500, 3), np.uint8))  # crop grid (3, 2)
    jparams, report = jocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    jpipe = JaxPipeline(jax.tree_util.tree_map(jnp.asarray, jparams), cfg, pipe.tokenizer, kv_dtype="float32",
                        act_dtype="float32")
    for ch in CHANNELS:
        monkeypatch.setenv(f"DEEPSEEK_DEBUG_{ch}", "1")
    capfd.readouterr()
    want = jpipe.generate_ocr(page, max_new_tokens=4, ngram_size=3)
    jax_err = capfd.readouterr().err
    got = pipe.generate_ocr(page, max_new_tokens=4, ngram_size=3)
    port_err = capfd.readouterr().err
    assert got.token_ids == want.token_ids
    want_keys, got_keys = _line_keys(jax_err), _line_keys(port_err)
    names = {k[0] if isinstance(k, tuple) else k for k in want_keys}
    for name in ("vision.local.sam", "vision.global.proj", "mm.merged", "inputs_embeds[pos_last]", "layer0.attn.in_x",
                 "layer0.after_attn", "layer1 moe counts", "layer1.moe.out_total", "step0 top10 logit",
                 "step3 next_id"):
        assert name in names, name
    assert got_keys == want_keys
