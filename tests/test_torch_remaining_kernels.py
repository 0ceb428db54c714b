"""Kernels U, V, W and X of the PyTorch port (their plain twins, which the
CPU runs) against the JAX package's Pallas kernels in interpret mode, the
boundary-visit schedule, and the two switched paths end to end:
`DEEPSEEK_DECODE_ATTN=stacked` (kernel U in every one-token decode step on
the contiguous cache) and `DEEPSEEK_SAM_WIN_KERNEL=1` (kernel V in SAM's
windowed blocks).

Tolerances:
- U and X: f32 1e-6 (an exact softmax against the kernel's online one over
  chunks or pages; outputs O(1)); a bf16 cache 1e-5, both sides computing in
  f32 on the same bf16 values.
- V: 3e-5 on the valid rows, the JAX package's own bound for this kernel
  (tests/test_flash_attention.py::test_windowed_inkernel_relpos).
- W: f32 1e-5 (f32 sums in another order); bf16 one bf16 ulp of the largest
  output (both sides round the same f32 sums to bf16 at the same points; a
  sum on the other side of a rounding boundary moves an output by an ulp).
- The slice: greedy tokens equal, and every step's logits within 1e-4 of
  the largest logit (f32 sums in another order through the towers and the
  LM). On the CPU the JAX package runs both switches as its default paths
  ("stacked" needs Pallas there; so does the window kernel): the same
  functions the port computes through U's and V's twins.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.configs import tiny_ocr2_config
from deepseek_ocr2_tpu.ops import moe_gmm as jgmm
from deepseek_ocr2_tpu.ops.flash_attention import mha_win_pallas
from deepseek_ocr2_tpu.ops.paged_attention import decode_attention_stacked as jax_stacked
from deepseek_ocr2_tpu.ops.paged_attention import paged_decode_attention as jax_paged
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.ops import moe_gmm as tgmm
from deepseek_ocr2_tpu_torch.ops.flash_attention import mha_win
from deepseek_ocr2_tpu_torch.ops.paged_attention import decode_attention_stacked, paged_decode_attention
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

import reference_torch_vision as refv


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# U and X


@pytest.mark.parametrize("cap,lens", [
    (64, [1, 7, 33, 64, 40]),          # one TPU chunk
    (1024, [1, 513, 1024, 640, 512]),  # the TPU kernel's chunked walk
])
def test_stacked_twin_matches_jax(cap, lens):
    rng = np.random.default_rng(0)
    l, b, hh, d = 2, 5, 4, 32
    k_all = rng.standard_normal((l, b, hh, cap, d)).astype(np.float32)
    v_all = rng.standard_normal((l, b, hh, cap, d)).astype(np.float32)
    q = rng.standard_normal((b, hh, d)).astype(np.float32)
    seq_lens = np.asarray(lens, np.int32)
    scale = 1.0 / math.sqrt(d)
    for li in range(l):
        want = np.asarray(jax_stacked(jnp.asarray(q), jnp.asarray(k_all), jnp.asarray(v_all), li,
                                      jnp.asarray(seq_lens), scale=scale, interpret=True))
        got = decode_attention_stacked(_t(q), _t(k_all), _t(v_all), li, torch.from_numpy(seq_lens), scale=scale)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_stacked_twin_bf16_cache_matches_jax():
    rng = np.random.default_rng(1)
    l, b, hh, cap, d = 2, 3, 2, 128, 64
    k_all = jnp.asarray(rng.standard_normal((l, b, hh, cap, d)), jnp.bfloat16)
    v_all = jnp.asarray(rng.standard_normal((l, b, hh, cap, d)), jnp.bfloat16)
    q = rng.standard_normal((b, hh, d)).astype(np.float32)
    seq_lens = np.asarray([5, 100, 128], np.int32)
    scale = 1.0 / math.sqrt(d)
    want = np.asarray(jax_stacked(jnp.asarray(q), k_all, v_all, 1, jnp.asarray(seq_lens), scale=scale,
                                  interpret=True))

    def bf16(a):  # the same bf16 values
        return _t(a.astype(jnp.float32)).to(torch.bfloat16)

    got = decode_attention_stacked(_t(q), bf16(k_all), bf16(v_all), 1, torch.from_numpy(seq_lens), scale=scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_paged_twin_matches_jax():
    """Kernel X's twin (G's gather twin on a per-sequence pool) against the
    JAX package's `_paged_kernel`, its test's shapes: rows of 1 token, a
    page and 7, and a whole table."""
    rng = np.random.default_rng(2)
    b, hh, d, page, n_pool, max_pages = 3, 4, 128, 128, 16, 4
    q = rng.standard_normal((b, hh, d)).astype(np.float32)
    k_pages = rng.standard_normal((n_pool, hh, page, d)).astype(np.float32)
    v_pages = rng.standard_normal((n_pool, hh, page, d)).astype(np.float32)
    tables = rng.permutation(n_pool)[: b * max_pages].reshape(b, max_pages).astype(np.int32)
    seq_lens = np.asarray([1, page + 7, max_pages * page], np.int32)
    scale = 1 / math.sqrt(d)
    want = np.asarray(jax_paged(*(jnp.asarray(a) for a in (q, k_pages, v_pages, tables, seq_lens)), scale=scale,
                                interpret=True))
    got = paged_decode_attention(_t(q), _t(k_pages), _t(v_pages), torch.from_numpy(tables),
                                 torch.from_numpy(seq_lens), scale=scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# V


@pytest.mark.parametrize("win,valid", [(16, 14), (16, 16)])
def test_window_twin_matches_jax(win, valid):
    """The JAX test's case: padded tokens zeroed as the model's window pad
    does, tables [valid, valid, d] padded and flattened to [d, win^2];
    padded query rows are garbage by contract and not compared."""
    rng = np.random.default_rng(11)
    b, h, d = 3, 2, 64
    t2 = win * win
    pos = np.arange(t2)
    valid_tok = ((pos // win < valid) & (pos % win < valid)).astype(np.float32)
    q, k, v = (rng.standard_normal((b, h, t2, d)).astype(np.float32) * valid_tok[None, None, :, None]
               for _ in range(3))
    pad = win - valid
    rhf, rwf = (np.pad(rng.standard_normal((valid, valid, d)).astype(np.float32) * 0.3,
                       ((0, pad), (0, pad), (0, 0))).transpose(2, 0, 1).reshape(d, t2) for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    want = np.asarray(mha_win_pallas(*(jnp.asarray(a) for a in (q, k, v, rhf, rwf)), scale=scale, win=win,
                                     valid=valid, interpret=True))
    got = mha_win(*(_t(a) for a in (q, k, v, rhf, rwf)), scale=scale, win=win, valid=valid).numpy()
    vq = valid_tok.astype(bool)
    np.testing.assert_allclose(got[:, :, vq], want[:, :, vq], rtol=3e-5, atol=3e-5)


# ---------------------------------------------------------------------------
# W


_jax_visit_schedule = jax.jit(jgmm._visit_schedule, static_argnums=(1, 2))


@pytest.mark.parametrize("bm", [32, 64])
@pytest.mark.parametrize("sizes", [[5, 0, 70, 3, 0, 60], [0, 0, 0, 97], [32, 32, 64], [1] * 64, [0, 200, 0]])
def test_visit_schedule_matches_jax(sizes, bm):
    m = sum(sizes)
    m_pad = -(-m // bm) * bm
    want = _jax_visit_schedule(jnp.asarray(sizes, jnp.int32), m_pad, bm)
    got = tgmm.visit_schedule(torch.tensor(sizes, dtype=torch.int32), m_pad, bm)
    for name, w, g in zip(("tile", "expert", "lo", "hi"), want, got):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_pick_bm_matches_jax(monkeypatch):
    monkeypatch.delenv("DEEPSEEK_GMM_BM", raising=False)
    for m in (1, 2047, 2048, 13_000):
        assert tgmm.pick_bm(m) == jgmm._pick_bm(m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k", [(40, 2), (1100, 2)])  # bm 32, and 2200 rows: bm 64
def test_visit_twins_match_jax(dtype, n, k):
    """Both modes of W against `_gmm_swiglu_call` / `_gmm_ffn_call` in
    interpret mode on the same expert-sorted rows and schedule (expert 5 of
    6 gets no rows), on the first N k rows: rows past them are written by no
    visit in either package."""
    rng = np.random.default_rng(n)
    e, h, i = 6, 32, 24
    x = rng.standard_normal((n, h)).astype(np.float32)
    wg, wu = ((rng.standard_normal((e, i, h)) / np.sqrt(h)).astype(np.float32) for _ in range(2))
    wd = (rng.standard_normal((e, h, i)) / np.sqrt(i)).astype(np.float32)
    idx = np.stack([rng.choice(e - 1, k, replace=False) for _ in range(n)])
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    bm = tgmm.pick_bm(n * k)
    x_sorted, sizes = tgmm.sorted_rows(torch.from_numpy(x).to(tdt), torch.from_numpy(idx), e, bm)
    sched = tgmm.visit_schedule(sizes, x_sorted.shape[0], bm)
    assert int(sizes[e - 1]) == 0
    jsched = tuple(jnp.asarray(t.numpy()) for t in sched)
    jx = jnp.asarray(x_sorted.float().numpy()).astype(jdt)
    jw = [jnp.asarray(w.transpose(0, 2, 1)).astype(jdt) for w in (wg, wu, wd)]  # x @ W layout
    tw = [torch.from_numpy(w).to(tdt) for w in (wg, wu, wd)]
    m = n * k
    cases = (
        (jgmm._gmm_swiglu_call(jsched, jx, *jw[:2], bm=bm, interpret=True),
         tgmm.gmm_swiglu_visit(x_sorted, *tw[:2], sched, bm)),
        (jgmm._gmm_ffn_call(jsched, jx, *jw, bm=bm, interpret=True),
         tgmm.gmm_ffn_visit(x_sorted, *tw, sched, bm)),
    )
    for want, got in cases:
        want, got = np.asarray(want.astype(jnp.float32))[:m], got.float().numpy()[:m]
        top = float(np.abs(want).max())
        tol = 1e-5 if dtype == "float32" else 2.0 ** (math.floor(math.log2(top)) - 7)
        assert np.abs(got - want).max() <= tol


# ---------------------------------------------------------------------------
# The slice: both switches end to end


def _tiny_tokenizer():
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tok


@pytest.fixture(scope="module")
def pipes():
    """(cfg, JAX pipeline, port pipeline, JAX params, port params) on the
    same tiny f32 weights."""
    from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
    from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline as JaxPipeline

    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    flat = refv.random_ocr2_flat(cfg, seed=21)
    tparams, report = tocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    jparams, report = jocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    kw = dict(kv_dtype="float32", act_dtype="float32")
    return (cfg, JaxPipeline(jparams, cfg, _tiny_tokenizer(), **kw),
            OCR2Pipeline(tparams, cfg, _tiny_tokenizer(), device="cpu", **kw), jparams, tparams)


def _page(size, seed):
    w, h = size
    return Image.fromarray(np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8))


def _jax_step_logits(cfg, jpipe, jlm, page, token_ids, prompt_len):
    """The JAX package's logits at every step of `token_ids`' generation:
    its own preprocess, towers and injection, prefill, then one jitted
    decode step a token (the default decode path)."""
    from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
    from deepseek_ocr2_tpu.runtime.kv_cache import make_kv_cache as jax_make_kv_cache
    from deepseek_ocr2_tpu.runtime.pipeline import tokenize_with_image

    base, patches, ratio, _ = jpipe.preprocess_image(page, no_crop=False, rotate=0, auto_rotate=False)
    ids, _, image_start = tokenize_with_image(jpipe.tokenizer, cfg.default_ocr_prompt, cfg, ratio)
    embeds = jpipe.build_ocr_embeds(ids, base, patches, image_start)
    assert embeds.shape[1] == prompt_len
    lm = cfg.lm
    n = len(token_ids) - prompt_len
    cache = jax_make_kv_cache(lm.num_hidden_layers, 1, lm.num_attention_heads, prompt_len + n, lm.head_dim,
                              jnp.float32)
    hidden, cache = jdsv2.lm_forward(jlm, lm, embeds.astype(jnp.float32), cache, pos=0, is_prefill=True)
    logits = [jdsv2.logits_last(jlm, hidden)]
    step = jax.jit(lambda c, e, pos: jdsv2.lm_forward(jlm, lm, e, c, pos=pos, is_prefill=False))
    for j in range(n - 1):
        emb = jnp.take(jlm["embed"], jnp.asarray([[token_ids[prompt_len + j]]], jnp.int32), axis=0)
        hidden, cache = step(cache, emb.astype(jnp.float32), prompt_len + j)
        logits.append(jdsv2.logits_last(jlm, hidden))
    return [np.asarray(x, np.float32).reshape(-1) for x in logits]


@pytest.mark.parametrize("size", [(160, 120), (500, 300)])  # no crop; crop grid (3, 2)
def test_switched_slice_matches_jax(pipes, monkeypatch, size):
    """generate_ocr with DEEPSEEK_DECODE_ATTN=stacked and
    DEEPSEEK_SAM_WIN_KERNEL=1 set for both packages: U's twin in every
    decode step, V's in every windowed SAM block."""
    cfg, jpipe, tpipe, jparams, _ = pipes
    monkeypatch.setenv("DEEPSEEK_DECODE_ATTN", "stacked")
    monkeypatch.setenv("DEEPSEEK_SAM_WIN_KERNEL", "1")
    calls = {"U": 0, "V": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    from deepseek_ocr2_tpu_torch.models import sam as tsam

    monkeypatch.setattr(tdsv2, "decode_attention_stacked", spy("U", tdsv2.decode_attention_stacked))
    monkeypatch.setattr(tsam, "mha_win", spy("V", tsam.mha_win))
    page = _page(size, seed=5)
    want = jpipe.generate_ocr(page, max_new_tokens=8, ngram_size=3)
    got = tpipe.generate_ocr(page, max_new_tokens=8, ngram_size=3, keep_logits=True)
    assert got.prompt_len == want.prompt_len
    assert got.token_ids == want.token_ids
    n_windowed = cfg.sam.depth - len(cfg.sam.global_attn_indexes)
    n_sam_batches = 1 if got.crop_ratio == (1, 1) else 2  # the global view, then the crops
    assert calls == {"U": cfg.lm.num_hidden_layers * (got.new_tokens - 1), "V": n_windowed * n_sam_batches}
    want_logits = _jax_step_logits(cfg, jpipe, jparams["lm"], page, got.token_ids, got.prompt_len)
    assert len(want_logits) == len(got.step_logits)
    for step, (w, g) in enumerate(zip(want_logits, got.step_logits)):
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max(), step


def test_slice_mode_equals_pool(pipes, monkeypatch):
    """"slice" has no copy to make in the port (a layer is a view): it
    computes what "pool" computes, bit for bit."""
    _, _, tpipe, _, _ = pipes
    page = _page((160, 120), seed=6)
    runs = {}
    for mode in ("pool", "slice"):
        monkeypatch.setenv("DEEPSEEK_DECODE_ATTN", mode)
        runs[mode] = tpipe.generate_ocr(page, max_new_tokens=6, ngram_size=3, keep_logits=True)
    assert runs["slice"].token_ids == runs["pool"].token_ids
    for a, b in zip(runs["slice"].step_logits, runs["pool"].step_logits):
        assert torch.equal(a, b)


def test_stacked_int8_skips_fused_attention(pipes, monkeypatch):
    """With --int8 weights the fused attention kernel K runs only under
    "pool", as the JAX package's `_decode_attention` gates it: under
    "stacked" the projections go through H's twin and attention through
    U's, and the tokens equal the JAX package's."""
    cfg, jpipe, tpipe, jparams, tparams = pipes
    from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
    from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline as JaxPipeline

    kw = dict(kv_dtype="float32", act_dtype="float32")
    jq = JaxPipeline({**jparams, "lm": jdsv2.quantize_lm_params(jparams["lm"], scope="full")}, cfg,
                     _tiny_tokenizer(), **kw)
    tq = OCR2Pipeline({**tparams, "lm": tdsv2.quantize_lm_params(tparams["lm"], scope="full")}, cfg,
                      _tiny_tokenizer(), device="cpu", **kw)
    calls = {"K": 0, "U": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(tdsv2, "attn_decode_fused", spy("K", tdsv2.attn_decode_fused))
    monkeypatch.setattr(tdsv2, "decode_attention_stacked", spy("U", tdsv2.decode_attention_stacked))
    page = _page((160, 120), seed=5)
    pool = tq.generate_ocr(page, max_new_tokens=8, ngram_size=3)
    assert calls == {"K": cfg.lm.num_hidden_layers * (pool.new_tokens - 1), "U": 0}  # the spy sees K
    calls.update(K=0)
    monkeypatch.setenv("DEEPSEEK_DECODE_ATTN", "stacked")
    got = tq.generate_ocr(page, max_new_tokens=8, ngram_size=3)
    assert calls == {"K": 0, "U": cfg.lm.num_hidden_layers * (got.new_tokens - 1)}
    want = jq.generate_ocr(page, max_new_tokens=8, ngram_size=3)
    assert got.token_ids == want.token_ids
