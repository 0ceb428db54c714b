"""Batched and continuous serving of the PyTorch port, on the CPU at tiny
widths (f32): the group engine and the continuous engine against the JAX
package's engines, and the continuous engine's scheduling (more pages than
slots, a tight pool, growth and preemption, the online API, streaming)
against the port's single-page pipeline, which tests/test_torch_e2e.py and
test_torch_crop.py hold to the JAX package. Tokens are compared exactly.

The tiny LM has 8 experts and top-2 routing, so a decode batch of 5 or more
rows takes kernel F's twin (B * k > E) and smaller ones the per-selection
path.
"""

import dataclasses
import signal

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine, _TextStream
from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine
from deepseek_ocr2_tpu_torch.runtime.paged_kv import pages_for
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline
from deepseek_ocr2_tpu.utils.tokenizer import tokenize_with_image

import reference_torch_vision as refv


def _tiny_tokenizer():
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tok


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    flat = refv.random_ocr2_flat(cfg, seed=21)
    params, report = tocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    pipe = OCR2Pipeline(params, cfg, _tiny_tokenizer(), device="cpu", kv_dtype="float32", act_dtype="float32")
    return cfg, flat, pipe


@pytest.fixture(scope="module")
def jax_pipe(setup):
    from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
    from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline as JaxPipeline

    cfg, flat, _ = setup
    params, report = jocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return JaxPipeline(params, cfg, _tiny_tokenizer(), kv_dtype="float32", act_dtype="float32")


SIZES = [(500, 300), (160, 120), (400, 400), (640, 200)]  # tiny crop size 192: three crop grids and no-crop


def _pages(n, sizes=SIZES, seed=3):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)) for w, h in (sizes[i % len(sizes)]
                                                                                      for i in range(n))]


def _singles(pipe, pages, **kw):
    return [pipe.generate_ocr(p, **kw) for p in pages]


def test_group_engine_matches_jax_engine(setup, jax_pipe):
    """Mixed crop grids; five no-crop pages in one chunk decode at B = 5
    (kernel F's twin), the crop pages in chunks of their own grid."""
    from deepseek_ocr2_tpu.runtime.engine import OCR2Engine as JaxEngine

    _, _, pipe = setup
    pages = _pages(5, sizes=[(160, 120)], seed=8) + _pages(2, sizes=[(500, 300), (400, 400)], seed=9)
    want = JaxEngine(jax_pipe, batch_size=6).run(pages, max_new_tokens=8, ngram_size=3)
    got = OCR2Engine(pipe, batch_size=6).run(pages, max_new_tokens=8, ngram_size=3)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.token_ids == w.token_ids, (i, w.token_ids, g.token_ids)
        assert g.text == w.text and g.prompt_len == w.prompt_len


@pytest.mark.parametrize("slots", [2, 6])
def test_continuous_engine_matches_jax_engine(setup, jax_pipe, slots):
    from deepseek_ocr2_tpu.runtime.continuous import ContinuousOCREngine as JaxContinuous

    _, _, pipe = setup
    pages = _pages(6)
    want = JaxContinuous(jax_pipe, slots=slots, capacity=128, chunk_steps=4).run(pages, max_new_tokens=8, ngram_size=3)
    got = ContinuousOCREngine(pipe, slots=slots, capacity=128, chunk_steps=4).run(pages, max_new_tokens=8,
                                                                                 ngram_size=3)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.token_ids == w.token_ids, (i, w.token_ids, g.token_ids)
        assert g.text == w.text


def test_continuous_more_pages_than_slots(setup):
    _, _, pipe = setup
    pages = _pages(5)
    results = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=3).run(pages, max_new_tokens=4,
                                                                                 ngram_size=0)
    for s, b in zip(_singles(pipe, pages, max_new_tokens=4, ngram_size=0), results):
        assert b.token_ids == s.token_ids


def test_continuous_max_new_tokens_one(setup):
    """Slots whose first token meets the stop rule are frozen at admission."""
    _, _, pipe = setup
    pages = _pages(2)
    results = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=4).run(pages, max_new_tokens=1,
                                                                                 ngram_size=0)
    for s, b in zip(_singles(pipe, pages, max_new_tokens=1, ngram_size=0), results):
        assert b.new_tokens == 1 and b.token_ids == s.token_ids


def test_continuous_small_pool_token_exact(setup):
    """A pool of about half slots * capacity: admissions wait for pages."""
    _, _, pipe = setup
    pages = _pages(4)
    engine = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=4, page_size=64, pool_tokens=128)
    results = engine.run(pages, max_new_tokens=5, ngram_size=3)
    for s, b in zip(_singles(pipe, pages, max_new_tokens=5, ngram_size=3), results):
        assert b.token_ids == s.token_ids
    assert all(r.prefill_seconds > 0 and r.decode_seconds > 0 for r in results)


def _tight_pool(cfg, pipe, page_size=16, max_new=64, chunk=8):
    """A pool where both slots admit and grow, but not both to full size."""
    s = len(tokenize_with_image(pipe.tokenizer, cfg.default_ocr_prompt, cfg, (1, 1))[0])
    per_admit = pages_for(min(s + 1 + chunk, s + max_new), page_size)
    full = pages_for(s + max_new, page_size)
    pool_pages = max(2 * per_admit + (full - per_admit) + (full - per_admit) // 2, pages_for(128, page_size))
    return dict(slots=2, capacity=128, chunk_steps=chunk, page_size=page_size, pool_tokens=pool_pages * page_size)


def test_continuous_page_growth_preemption(setup):
    """Lazy pages: admission claims prompt + first chunk, growth the rest, and
    on exhaustion the younger slot is preempted and re-admitted; the results
    stay token-exact (greedy decode is deterministic)."""
    cfg, _, pipe = setup
    pages = _pages(2)[1:2] * 2  # two identical no-crop pages
    engine = ContinuousOCREngine(pipe, **_tight_pool(cfg, pipe))
    results = engine.run(pages, max_new_tokens=64, ngram_size=3)
    assert engine.last_preempted >= 1, "pool sizing did not force a preemption"
    for s, b in zip(_singles(pipe, pages, max_new_tokens=64, ngram_size=3), results):
        assert b.token_ids == s.token_ids


def test_continuous_no_mutual_preemption_livelock(setup):
    """Two crop pages that admit at 5 pages each and both need a 6th, in a
    pool of 10: growth only preempts strictly younger slots, so the oldest
    always finishes and the run ends, token-exact."""
    _, _, pipe = setup

    def bail(signum, frame):
        raise TimeoutError("continuous engine livelocked (mutual preemption)")

    pages = _pages(4)
    old = signal.signal(signal.SIGALRM, bail)
    signal.alarm(300)
    try:
        engine = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=32, page_size=16, pool_tokens=160)
        got = engine.run(pages, max_new_tokens=48, ngram_size=3)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    for w, g in zip(_singles(pipe, pages, max_new_tokens=48, ngram_size=3), got):
        assert g.token_ids == w.token_ids


def test_online_submit_while_running(setup):
    """Requests submitted while the loop decodes join the running batch,
    with mixed max_new_tokens within one admission group."""
    import time

    _, _, pipe = setup
    pages = _pages(4)
    budgets = [6, 9, 6, 5]
    engine = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=4)
    engine.start(ngram_size=3)
    try:
        futs = []
        for p, m in zip(pages, budgets):
            futs.append(engine.submit(p, max_new_tokens=m))
            time.sleep(0.02)
        results = [f.result(timeout=120) for f in futs]
    finally:
        engine.stop(timeout=60)
    for p, m, r in zip(pages, budgets, results):
        want = pipe.generate_ocr(p, max_new_tokens=m, ngram_size=3)
        assert r.token_ids == want.token_ids and r.text == want.text


def test_online_bad_image_and_bad_request_fail_only_themselves(setup):
    _, _, pipe = setup
    good = _pages(1)[0]
    want = pipe.generate_ocr(good, max_new_tokens=4, ngram_size=0)
    engine = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=4)
    engine.start(ngram_size=0)
    try:
        bad = engine.submit("/nonexistent/page.png", max_new_tokens=4)
        too_big = engine.submit(good, max_new_tokens=10_000)
        bad_prompt = engine.submit(good, prompt="no placeholder here", max_new_tokens=4)
        ok = engine.submit(good, max_new_tokens=4)
        res = ok.result(timeout=120)
        with pytest.raises(OSError):
            bad.result(timeout=120)
        with pytest.raises(ValueError):
            too_big.result(timeout=120)
        with pytest.raises(Exception):
            bad_prompt.result(timeout=120)
        assert engine.submit(good, max_new_tokens=4).result(timeout=120).token_ids == want.token_ids
    finally:
        engine.stop(timeout=60)
    assert res.token_ids == want.token_ids


def test_online_stop_drains(setup):
    _, _, pipe = setup
    engine = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=4)
    engine.start(ngram_size=0)
    futs = [engine.submit(p, max_new_tokens=4) for p in _pages(3)]
    engine.stop(timeout=120)
    assert engine._thread is None
    for f in futs:
        assert f.done() and f.result(timeout=0).new_tokens >= 1
    with pytest.raises(RuntimeError):
        engine.submit(_pages(1)[0])


def test_text_stream_holdback():
    """Stop-string fragments and split UTF-8 bytes never leak into the
    deltas, and the stop string cuts the stream."""

    class WordTok:
        table = {1: "he", 2: "llo ", 3: "wor", 4: "<D", 5: "ONE>", 6: "!"}

        def decode(self, ids, skip_special_tokens=False):
            return "".join(self.table[i] for i in ids)

    ts = _TextStream(WordTok(), stop_string="<DONE>")
    assert ts.push([1]) == "he"
    assert ts.push([2, 4]) == "llo "  # "<D" is a prefix of the stop string: held back
    assert not ts.stopped
    assert ts.push([5, 6]) == ""
    assert ts.stopped and ts.push([6]) == ""

    class ByteTok:
        table = {1: b"a", 2: b"\xe2", 3: b"\x82\xac", 4: b"b"}

        def decode(self, ids, skip_special_tokens=False):
            return b"".join(self.table[i] for i in ids).decode("utf-8", "replace")

    ts = _TextStream(ByteTok())
    assert ts.push([1, 2]) == ""  # a lone "\xe2" decodes to U+FFFD: held back
    assert ts.push([3, 4]) == "a€b"


def test_continuous_streaming_online(setup):
    """Streamed chunks concatenate to exactly the final generated ids, over
    several emissions, and stream_text reassembles the final text."""
    cfg, _, pipe = setup
    pages = _pages(2)
    engine = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=2)
    engine.start(ngram_size=3)
    try:
        for req in [engine.submit(p, max_new_tokens=6, stream=True) for p in pages]:
            chunks = list(req.stream_token_ids(timeout=120))
            res = req.result(timeout=10)
            assert [t for c in chunks for t in c] == res.token_ids[res.prompt_len:]
            assert len(chunks) >= 2, "chunk_steps=2 must emit incrementally"
        req = engine.submit(pages[0], max_new_tokens=6, stream=True)
        text = "".join(req.stream_text(pipe.tokenizer, cfg.stop_string, timeout=120))
        assert text.strip() == req.result(timeout=10).text
    finally:
        engine.stop(timeout=60)


def test_continuous_streaming_preemption_no_dup_no_gap(setup):
    """A preempted streaming request re-decodes; its stream neither repeats
    nor drops a token."""
    cfg, _, pipe = setup
    pages = _pages(2)[1:2] * 2
    engine = ContinuousOCREngine(pipe, **_tight_pool(cfg, pipe))
    engine.start(ngram_size=3)
    try:
        outs = []
        for req in [engine.submit(p, max_new_tokens=64, stream=True) for p in pages]:
            chunks = list(req.stream_token_ids(timeout=120))
            outs.append(([t for c in chunks for t in c], req.result(timeout=10)))
    finally:
        engine.stop(timeout=60)
    assert engine.last_preempted >= 1, "pool sizing did not force a preemption"
    for got, res in outs:
        assert got == res.token_ids[res.prompt_len:]


def test_prestage_run_requests_token_exact(setup):
    _, _, pipe = setup
    pages = _pages(3)
    normal = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=4).run(pages, max_new_tokens=6,
                                                                                ngram_size=3)
    engine = ContinuousOCREngine(pipe, slots=2, capacity=128, chunk_steps=4)
    reqs = engine.prestage(pages, max_new_tokens=6)
    assert all(r.pre is not None and isinstance(r.pre[0], torch.Tensor) for r in reqs)
    staged = engine.run_requests(reqs, ngram_size=3)
    for a, b in zip(normal, staged):
        assert b.token_ids == a.token_ids and b.text == a.text


def test_out_of_slice_options_name_their_slice(setup):
    _, _, pipe = setup
    with pytest.raises(ValueError, match="lookup"):
        ContinuousOCREngine(pipe, slots=2, capacity=128, lookup_chunk=4)
    engine = ContinuousOCREngine(pipe, slots=2, capacity=128)
    with pytest.raises(ValueError, match="sampl"):
        engine.run(_pages(1), max_new_tokens=2, sampling=dict(temperature=1.0))
    with pytest.raises(ValueError, match="sampl"):
        engine.start(sampling=dict(temperature=0.7))
    with pytest.raises(ValueError, match="sampl"):
        OCR2Engine(pipe).run(_pages(1), max_new_tokens=2, sampling=dict(temperature=1.0))
    with pytest.raises(ValueError, match="cannot hold"):
        ContinuousOCREngine(pipe, slots=2, capacity=128, page_size=16, pool_tokens=64)
