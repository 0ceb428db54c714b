"""The quantized paged KV pools of the PyTorch port ("int8", "int8tail") and
kernel P's twin against the JAX package, on the CPU.

- `quantize_kv` equals the JAX package's bit for bit: codes and scales.
- After the same admissions (two groups; one prompt whose last page is its
  first) and decode steps, the port's pool equals the JAX pool
  (`make_paged_kv_cache` + `write_prompt_pool_batched` +
  `lm_decode_step_paged(use_pallas=False)`). Admission quantizes the same
  inputs on both sides: its codes, scales and open pages are equal bit for
  bit. A decode step quantizes the K/V that each package computed, which
  agree to about 2e-6 relative (f32 projections summed in another order):
  the scales agree within 1e-5 relative, the open pages within one bf16
  ulp (at most 2^-7 relative), and the codes exactly, except where the
  port's x / scale lies within 1e-4 of a rounding half-way point, where a
  code may be one apart (the test finds those points itself). The scratch
  page 0 is not compared: finished rows overwrite it and no live row reads
  it.
- P's twin agrees with the JAX package's XLA oracle (dequantize, patch the
  open pages, gather attention) and with its Pallas kernel in interpret
  mode to 1e-5 (f32 sums in another order).
- The continuous engine's tokens against the JAX engine's on both pools,
  with preemption, on int8 weights and on a bf16 LM, tie-aware
  (tests/engine_ties.py). Both LMs decode in bf16 (int8 weights quantized
  from the bf16 one), where the engines' logits differ by bf16 ulps: the
  jitted JAX engine keeps some values in f32 that its source rounds to bf16
  (XLA's excess precision), and the JAX package's own CPU path and TPU
  dispatch differ by up to 1.08e-2 on the int8 LM. So every decode step of
  the JAX engine is also run, on its own inputs, through the port and
  through the JAX package's TPU dispatch compiled to round where its source
  does: the port's logits lie within 1e-4 of the largest logit at 84 to 87
  of 88 steps, within one bf16 rounding at the others. End to end the
  tokens are equal up to a first difference that must be a near-tie of both
  engines: on AMD EPYC hosts the int8-weight, int8-pool case meets one at
  new token 12 of page 3 (JAX 330 by 3.2e-3 over 55, the port 55 by 7e-5;
  the two rows of logits 9.7e-3 apart; the port within 1e-4 of the dispatch
  on that step's inputs); on others every token is equal.
- The drift table of docs/DESIGN.md, on the port's pools (printed with -s).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)
from PIL import Image

from deepseek_ocr2_tpu.configs import tiny_lm_config
from deepseek_ocr2_tpu.io import DtypePolicy as JaxPolicy
from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
from deepseek_ocr2_tpu.ops import paged_attention as jpa
from deepseek_ocr2_tpu.runtime import paged_kv as jpaged
from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu_torch.io import DtypePolicy
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.ops import paged_attention as tpa
from deepseek_ocr2_tpu_torch.runtime import paged_kv as tpaged
from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
from deepseek_ocr2_tpu_torch.runtime.kv_cache import make_kv_cache
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

from reference_torch import random_lm_flat
import reference_torch_vision as refv
from engine_ties import INT8_BF16_GAP, assert_steps_match_dispatch, assert_tokens_match, record_steps


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_pool_kind(kv):
    return kv if kv == "int8tail" else jnp.int8


# ---------------------------------------------------------------------------
# quantize_kv


def _edge_vectors():
    """Rows with exact halves (absmax 127: scale 1, x / scale = k + 0.5,
    ties to even), an all-zero row (the 1e-8 floor), +-absmax, and a row of
    tiny values."""
    d = 16
    halves = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -1.5, 126.5, -126.5, 4.5, 5.5, -6.5, 0, 1, -1, 2],
                      np.float32)
    rows = [halves, np.zeros(d, np.float32), np.full(d, -3.25, np.float32),
            np.linspace(-1, 1, d, dtype=np.float32), np.full(d, 1e-12, np.float32)]
    return np.stack(rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact(dtype):
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal((64, 16)).astype(np.float32) * 3, _edge_vectors()])
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    jq, js = jpaged.quantize_kv(jnp.asarray(x))
    tx = _t(x.view(np.uint16)).view(torch.bfloat16) if dtype == "bfloat16" else _t(x)
    tq, ts = tpaged.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    if dtype == "float32":  # the ties went to even
        assert tq[64, 1:6].tolist() == [2, -4, 0, 0, 2] and float(ts[65]) == np.float32(1e-8)


def test_int8_kinds_are_paged_only():
    """generate-ocr and the group engine build a contiguous cache: the JAX
    package's error, word for word."""
    for kind in ("int8", "int8tail"):
        with pytest.raises(ValueError, match=r"paged pool only \(serve --continuous/--http"):
            make_kv_cache(2, 1, 2, 16, 8, dtype=kind)


# ---------------------------------------------------------------------------
# The pools after the same admissions and decode steps


@pytest.fixture(scope="module")
def lm():
    cfg = tiny_lm_config()
    flat = random_lm_flat(cfg, seed=9)
    jp, rep = jdsv2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    tp, rep = tdsv2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    return cfg, jax.tree_util.tree_map(jnp.asarray, jp), tp


def _compare_pools(tpool, jpool, where, halfway=None):
    """`halfway`: {"k", "v"} -> bool [L, P, Hh, page, D], the codes a decode
    step quantized at a half-way point; None: everything bit for bit."""
    for name in tpool:
        got, want = tpool[name][:, 1:].float().numpy(), np.asarray(jpool[name][:, 1:]).astype(np.float32)
        if name.startswith("open"):  # one a slot, no scratch page
            got, want = tpool[name].float().numpy(), np.asarray(jpool[name]).astype(np.float32)
        if halfway is None:
            np.testing.assert_array_equal(got, want, err_msg=f"{name}, {where}")
        elif name in ("k", "v"):
            near = halfway[name][:, 1:]
            np.testing.assert_array_equal(got[~near], want[~near], err_msg=f"{name} codes, {where}")
            assert np.abs(got[near] - want[near]).max(initial=0) <= 1, f"{name} codes, {where}"
        elif name.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=f"{name}, {where}")
        else:
            np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=0, err_msg=f"{name}, {where}")


@pytest.mark.parametrize("kv", ["int8", "int8tail"])
def test_pools_match_jax_after_admissions_and_steps(lm, kv, monkeypatch):
    """Rows 0-1: a 13-token prompt over two 8-token pages; rows 2-3: a
    5-token prompt, whose last page is its first. Six decode steps at
    per-row positions; row 3 finishes after three and points at the
    scratch page 0 (its output is discarded, as in the engine)."""
    cfg, jp, tp = lm
    b, page, n_pool, max_pages = 4, 8, 20, 4
    l, hh, d = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    rng = np.random.default_rng(1)
    jpool = jpaged.make_paged_kv_cache(l, n_pool, hh, page, d, _jax_pool_kind(kv), slots=b)
    tpool = tpaged.make_paged_kv_cache(l, n_pool, hh, page, d, kv, slots=b)
    tables = np.zeros((b, max_pages), np.int32)
    for rows, s, pages in (([0, 1], 13, [[1, 2, 3], [4, 5, 6]]), ([2, 3], 5, [[7, 8], [9, 10]])):
        n_prompt = tpaged.pages_for(s, page)
        k_new, v_new = (rng.standard_normal((l, 2, hh, n_prompt * page, d)).astype(np.float32) for _ in range(2))
        k_new[:, :, :, s:] = 0  # the prefill cache's zeros past the prompt
        v_new[:, :, :, s:] = 0
        ids = np.array([p[:n_prompt] for p in pages], np.int32)
        jpool = jpaged.write_prompt_pool_batched(jpool, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(ids), s,
                                                 slot_ids=jnp.asarray(rows, jnp.int32))
        out = tpaged.write_prompt_pool_batched(tpool, _t(k_new), _t(v_new), _t(ids), s, slot_ids=torch.tensor(rows))
        assert out["k"] is tpool["k"]  # in place
        for r, p in zip(rows, pages):
            tables[r, : len(p)] = p
    _compare_pools(tpool, jpool, "after admission")  # the same inputs: bit for bit
    if kv == "int8tail":  # the last prompt page staged, exact up to bf16
        np.testing.assert_array_equal(tpool["open_k"][:, 2, :, :5].float().numpy(),
                                      k_new[:, 0, :, :5].astype(ml_dtypes.bfloat16).astype(np.float32))

    # The decode steps' quantizer inputs, one call a layer and K or V (in
    # that order), to find the codes written at a half-way point.
    calls = []
    quantize = tpaged.quantize_kv
    monkeypatch.setattr(tpaged, "quantize_kv", lambda x: calls.append(x.float()) or quantize(x))
    halfway = {name: np.zeros(tpool[name].shape, bool) for name in ("k", "v")}
    # One trace for the six steps (positions and tables are traced).
    jax_step = jax.jit(lambda p, e, c, t, q: jpaged.lm_decode_step_paged(p, cfg, e, c, t, q, use_pallas=False))
    pos = np.array([13, 13, 5, 5], np.int32)
    for step in range(6):
        toks = rng.integers(0, cfg.vocab_size, (b,))
        bt = tables.copy()
        if step >= 3:
            bt[3] = 0
        calls.clear()
        jh, jpool = jax_step(jp, jnp.take(jp["embed"], jnp.asarray(toks), axis=0)[:, None], jpool, jnp.asarray(bt),
                             jnp.asarray(pos))
        th = tpaged.lm_decode_step_paged(tp, cfg, torch.nn.functional.embedding(_t(toks), tp["embed"])[:, None],
                                         tpool, _t(bt), _t(pos))
        live = slice(0, 3) if step >= 3 else slice(None)
        np.testing.assert_allclose(th[live].numpy(), np.asarray(jh)[live], rtol=1e-4, atol=1e-4)
        rows = np.arange(b)
        for i, x in enumerate(calls):  # x: [B, Hh, D]
            ratio = (x / quantize(x)[1][..., None]).numpy()
            near = np.abs(ratio - np.floor(ratio) - 0.5) < 1e-4
            halfway["kv"[i % 2]][i // 2, bt[rows, pos // page], :, pos % page] |= near
        _compare_pools(tpool, jpool, f"step {step}", halfway)
        pos = pos + np.array([1, 1, 1, 0 if step >= 3 else 1], np.int32)


# ---------------------------------------------------------------------------
# Kernel P's twin


def _q8_case(tail, seed=3):
    """Two layers, 3 heads of 128, 16-token pages; row lengths 41 (last
    page partial), 1 (one token, its only page), 32 (ends on a page end),
    17; the last row is finished and points at the scratch page 0."""
    rng = np.random.default_rng(seed)
    l, hh, d, page, b, per = 2, 3, 128, 16, 4, 3
    n_pool = b * per + 1
    kf, vf = (rng.standard_normal((l, n_pool, hh, page, d)).astype(np.float32) for _ in range(2))
    (kq, ks), (vq, vs) = (jpaged.quantize_kv(jnp.asarray(x)) for x in (kf, vf))
    tables = np.arange(1, n_pool, dtype=np.int32).reshape(b, per)
    tables[-1] = 0
    lens = np.array([41, 1, 32, 17], np.int32)
    opens = [None, None]
    if tail:
        opens = [rng.standard_normal((l, b, hh, page, d)).astype(ml_dtypes.bfloat16) for _ in range(2)]
    q = rng.standard_normal((b, hh, d)).astype(np.float32)
    return q, [np.asarray(a) for a in (kq, vq, ks, vs)], opens, tables, lens


@pytest.mark.parametrize("tail", [False, True])
def test_p_twin_matches_jax_oracle_and_pallas(tail):
    q, (kq, vq, ks, vs), (ok, ov), tables, lens = _q8_case(tail)
    li, scale, page = 1, 1 / math.sqrt(128), kq.shape[3]
    # The JAX package's XLA oracle: dequantize, patch each row's last page.
    k_layer = jpa.dequant_pages(jnp.asarray(kq[li]), jnp.asarray(ks[li]))
    v_layer = jpa.dequant_pages(jnp.asarray(vq[li]), jnp.asarray(vs[li]))
    if tail:
        last = jnp.asarray(tables)[jnp.arange(len(lens)), (jnp.asarray(lens) - 1) // page]
        k_layer = k_layer.at[last].set(jnp.asarray(ok[li]).astype(jnp.float32))
        v_layer = v_layer.at[last].set(jnp.asarray(ov[li]).astype(jnp.float32))
    want = np.asarray(jpa.paged_decode_attention_xla(jnp.asarray(q), k_layer, v_layer, jnp.asarray(tables),
                                                     jnp.asarray(lens), scale=scale))
    jopen = dict(open_k=jnp.asarray(ok), open_v=jnp.asarray(ov)) if tail else {}
    pallas = np.asarray(jpa.paged_decode_attention_pool_q8(
        *map(jnp.asarray, (q, kq, vq, ks, vs, tables, lens)), li, scale=scale, interpret=True, **jopen))

    topen = dict(open_k=_t(ok.view(np.uint16)).view(torch.bfloat16),
                 open_v=_t(ov.view(np.uint16)).view(torch.bfloat16)) if tail else {}
    before = tpa.paged_decode_attention_pool_q8.launches
    got = tpa.paged_decode_attention_pool_q8(*map(_t, (q, kq, vq, ks, vs, tables, lens)), li, scale=scale, **topen)
    assert tpa.paged_decode_attention_pool_q8.launches == before  # CPU tensors: the twin
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # The Pallas kernel reads a finished row's earlier pages from the codes
    # where the oracle patched them: live rows only in tail mode.
    live = slice(0, 3) if tail else slice(None)
    np.testing.assert_allclose(got.numpy()[live], pallas[live], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The continuous engine against the JAX engine


def _tiny_tokenizer():
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tok


def _policy(cls, lm_dtype):
    p = cls(default=lm_dtype)
    for prefix in ("model.sam_model", "model.qwen2_model", "model.projector", "model.view_seperator"):
        p = p.with_prefix(prefix, "float32")
    return p


def build_ocr_params():
    """(cfg, {"bf16": (jax, port), "int8": (jax, port)}): the tiny OCR model
    with its LM in bf16, and that LM quantized with --int8 (scope full)."""
    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    flat = refv.random_ocr2_flat(cfg, seed=21)
    tp, rep = tocr2.params_from_flat(flat, cfg, policy=_policy(DtypePolicy, "bfloat16"))
    rep.raise_on_errors()
    jp, rep = jocr2.params_from_flat({k: _policy(JaxPolicy, "bfloat16").apply(k, v) for k, v in flat.items()}, cfg)
    rep.raise_on_errors()
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    q8 = ({**jp, "lm": jdsv2.quantize_lm_params(jp["lm"], scope="full")},
          {**tp, "lm": tdsv2.quantize_lm_params(tp["lm"], scope="full")})
    return cfg, {"bf16": (jp, tp), "int8": q8}


@pytest.fixture(scope="module")
def ocr_params():
    return build_ocr_params()


def run_engines(ocr_params, weights, kv):
    """Both continuous engines on four pages (seed 6 for the bf16 LM, 3 for
    int8 weights), two slots, 16-token pages and a 160-token pool, every
    decode step recorded: (jax engine, port engine, want, got, jax_steps,
    port_steps)."""
    from deepseek_ocr2_tpu.runtime.continuous import ContinuousOCREngine as JaxContinuous
    from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline as JaxPipeline

    cfg, params = ocr_params
    jp, tp = params[weights]
    rng = np.random.default_rng(6 if weights == "bf16" else 3)
    pages = [Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
             for w, h in [(500, 300), (160, 120), (400, 400), (640, 200)]]
    kw = dict(slots=2, capacity=128, chunk_steps=8, page_size=16, pool_tokens=160)
    gen = dict(max_new_tokens=32, ngram_size=3)
    with record_steps() as (jax_steps, port_steps):
        jengine = JaxContinuous(JaxPipeline(jp, cfg, _tiny_tokenizer(), kv_dtype=kv, act_dtype="float32"), **kw)
        want = jengine.run(pages, **gen)
        engine = ContinuousOCREngine(
            OCR2Pipeline(tp, cfg, _tiny_tokenizer(), device="cpu", kv_dtype=kv, act_dtype="float32"), **kw)
        got = engine.run(pages, **gen)
    return jengine, engine, want, got, jax_steps, port_steps


@pytest.mark.parametrize("weights", ["bf16", "int8"])
@pytest.mark.parametrize("kv", ["int8", "int8tail"])
def test_continuous_engine_matches_jax_on_quantized_pools(ocr_params, weights, kv):
    """Slots grow and the younger one is preempted and re-admitted (its
    open page staged again)."""
    cfg, params = ocr_params
    jp, tp = params[weights]
    jengine, engine, want, got, jax_steps, port_steps = run_engines(ocr_params, weights, kv)
    assert engine.last_preempted >= 1 and engine.last_preempted == jengine.last_preempted
    errs = assert_steps_match_dispatch(jax_steps, jp["lm"], tp["lm"], cfg.lm)
    assert_tokens_match(want, got, jax_steps, port_steps, errs, gap=INT8_BF16_GAP)
    assert engine.alloc.n_free == engine.num_pages - 1


# ---------------------------------------------------------------------------
# Drift (docs/DESIGN.md's table, on the port's pools)


def _attend(q, k, v, tables, lens, kv, page):
    """The port's attention over 2048-token rows held in pool `kv`."""
    if kv == "f32":
        return tpa.paged_decode_attention_reference(q, k, v, tables, lens, scale=128**-0.5)
    if kv == "bf16":
        return tpa.paged_decode_attention_reference(q, k.bfloat16(), v.bfloat16(), tables, lens, scale=128**-0.5)
    (kq, ks), (vq, vs) = tpaged.quantize_kv(k), tpaged.quantize_kv(v)
    opens = {}
    if kv == "int8tail":
        last = tables[torch.arange(len(lens)), (lens.long() - 1) // page]
        opens = dict(open_k=k[last][None].bfloat16(), open_v=v[last][None].bfloat16())
    return tpa.paged_decode_attention_pool_q8(q, kq[None], vq[None], ks[None], vs[None], tables, lens, 0,
                                              scale=128**-0.5, **opens)


def test_drift_table():
    """Max relative error of the attention output against an f32 pool, at
    2048 tokens of random K/V (2 rows, 4 heads of 128, 128-token pages):
    random queries, and queries aligned with each row's newest key (the
    recency-weighted decode regime, where the exact tail pays)."""
    g = torch.Generator().manual_seed(21)
    b, hh, d, page, seq = 2, 4, 128, 128, 2048
    n_pool = b * seq // page + 1
    k, v = (torch.randn(n_pool, hh, page, d, generator=g) for _ in range(2))
    tables = torch.arange(1, n_pool, dtype=torch.int32).reshape(b, seq // page)
    lens = torch.tensor([seq, seq - 37], dtype=torch.int32)
    rows = torch.arange(b)
    last = tables[rows, (lens.long() - 1) // page].long()
    queries = {"random": torch.randn(b, hh, d, generator=g),
               "recency": 2.0 * k[last, :, (lens.long() - 1) % page]}
    table = {}
    for name, q in queries.items():
        want = _attend(q, k, v, tables, lens, "f32", page)
        for kv in ("bf16", "int8", "int8tail"):
            got = _attend(q, k, v, tables, lens, kv, page)
            table[name, kv] = float((got - want).abs().max() / want.abs().max())
    print("\ndrift (max rel err vs an f32 pool, 2048 tokens, CPU):")
    for (name, kv), err in table.items():
        print(f"  {name:8s} queries, {kv:8s} pool: {err:.2e}")
    assert table["random", "int8"] < 1e-2
    assert table["recency", "int8tail"] < table["recency", "int8"]
