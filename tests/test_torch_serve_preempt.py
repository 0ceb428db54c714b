"""The two longest preemption runs of the continuous engine, beside
tests/test_torch_serve.py (its fixtures and helpers, imported from there)
so that a run spread over workers file by file takes them on another
worker: growth that preempts the younger slot, and two crop pages that
would preempt each other forever if growth could evict an older slot. The
results are held token for token to the port's single-page pipeline.
"""

import signal

from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine

from test_torch_serve import _pages, _singles, _tight_pool, setup  # noqa: F401 (setup is a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)


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
