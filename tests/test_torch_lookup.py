"""Prompt-lookup decoding in the PyTorch port, on the CPU at tiny widths,
against the JAX package on the same numpy-seeded weights and inputs.

- `_lookup_draft` equals the JAX package's (vmapped) on random histories.
- Kernels Q's and R's twins equal the JAX package's Pallas kernels in
  interpret mode and its XLA chunk oracle to 1e-5 (f32 sums in another
  order; the kernels take an online softmax over pages). R is checked in
  int8 and int8tail mode, with a chunk that crosses a page boundary and a
  finished row on the scratch page 0 (its tail-mode output is not compared
  with the Pallas kernel, as in tests/test_torch_kvq8.py).
- The contiguous chunk decode step (S = 4 at a shared and at per-row
  positions) and the paged chunk step (`lm_decode_step_paged` at S = 4 on
  f32, bf16, int8 and int8tail pools): hidden states within 1e-5 of the
  JAX package's (f32 LM; 1e-3 on the bf16 pool), the cache and pool after the write element for
  element: f32 within 1e-5, int8 codes by the half-way rule of
  tests/test_torch_kvq8.py (exact except within 1e-4 of a rounding
  half-way point, there at most one apart), scales within 1e-5 relative,
  bf16 planes and open pages within one bf16 ulp (f32 K/V 2e-6 apart may
  round to neighbouring bf16 values).
- `lookup_greedy_generate` and `_batched`: tokens and forwards equal the
  JAX package's, tokens equal the port's plain greedy; ngram 0 and 3, chunk
  2, 4 and 5, an EOS stop, int8, int4 (I = 128, as in
  tests/test_torch_q4_e2e.py) and bf16 weights, and a deterministic cycle,
  where the drafts accept and the forwards fall under a third of the
  tokens.
Tokens are compared exactly. The engines, the CLI and HTTP with lookup are
in tests/test_torch_lookup_serve.py (a file of its own, so that a run
spread over workers file by file takes the two halves side by side).
"""

import functools
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.configs import tiny_lm_config
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
from deepseek_ocr2_tpu.ops import paged_attention as jpa
from deepseek_ocr2_tpu.runtime import generate as jgen
from deepseek_ocr2_tpu.runtime import paged_kv as jpaged
from deepseek_ocr2_tpu.runtime.kv_cache import make_kv_cache as jax_make_kv_cache
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.ops import paged_attention as tpa
from deepseek_ocr2_tpu_torch.runtime import generate as tgen
from deepseek_ocr2_tpu_torch.runtime import paged_kv as tpaged
from deepseek_ocr2_tpu_torch.runtime.kv_cache import make_kv_cache

from reference_torch import random_lm_flat

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# Drafts


def test_lookup_draft_matches_jax():
    """Random histories over a 6-token alphabet (matches at every n),
    lengths from 1 to the buffer, match_n 1..3, 1..4 drafts."""
    rng = np.random.default_rng(0)
    b, t_buf = 16, 40
    hist = rng.integers(0, 6, (b, t_buf)).astype(np.int32)
    lens = rng.integers(1, t_buf + 1, b).astype(np.int32)
    draft = jax.jit(jax.vmap(jgen._lookup_draft, in_axes=(0, 0, None, None)), static_argnums=(2, 3))
    for match_n in (1, 3):
        for draft_k in (1, 4):
            want = draft(jnp.asarray(hist), jnp.asarray(lens), match_n, draft_k)
            got = tgen._lookup_draft(_t(hist).long(), _t(lens), match_n, draft_k)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"{match_n}, {draft_k}")


# ---------------------------------------------------------------------------
# Kernels Q and R: the twins


def _chunk_case(seed=3):
    """Two layers, 3 heads of 128, 16-token pages, S = 4; row budgets end at
    41, 4 (its first page), 18 (the chunk crosses from page 0 into page 1)
    and 30; the last row is finished on the scratch page 0."""
    rng = np.random.default_rng(seed)
    l, hh, d, page, b, s, per = 2, 3, 128, 16, 4, 4, 3
    n_pool = b * per + 1
    tables = np.arange(1, n_pool, dtype=np.int32).reshape(b, per)
    tables[-1] = 0
    ends = np.array([41, 4, 18, 30], np.int32)
    lens = (ends[:, None] - s + 1 + np.arange(s)).astype(np.int32)  # [B, S] per-query budgets
    q = rng.standard_normal((b, s, hh, d)).astype(np.float32)
    kf, vf = (rng.standard_normal((l, n_pool, hh, page, d)).astype(np.float32) for _ in range(2))
    return q, kf, vf, tables, lens


def test_q_twin_matches_jax_kernel_and_xla():
    q, kf, vf, tables, lens = _chunk_case()
    scale = 1 / math.sqrt(128)
    for dtype in (np.float32, ml_dtypes.bfloat16):
        k_pool, v_pool = kf.astype(dtype), vf.astype(dtype)
        li = 1
        want = np.asarray(jpa.paged_decode_attention_pool_chunk(
            *map(jnp.asarray, (q, k_pool, v_pool, tables, lens)), jnp.int32(li), scale=scale, interpret=True))
        want_xla = np.asarray(jpa.paged_decode_attention_xla_chunk(
            *map(jnp.asarray, (q, k_pool[li], v_pool[li], tables, lens)), scale=scale))
        before = tpa.paged_decode_attention_pool_chunk.launches
        got = tpa.paged_decode_attention_pool_chunk(*map(_t, (q, k_pool, v_pool, tables, lens)), li, scale=scale)
        assert tpa.paged_decode_attention_pool_chunk.launches == before  # CPU tensors: the twin
        assert got.shape == q.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(got.numpy(), want_xla, **TOL)


@pytest.mark.parametrize("tail", [False, True])
def test_r_twin_matches_jax_oracle_and_pallas(tail):
    q, kf, vf, tables, lens = _chunk_case(seed=4)
    li, scale, page = 1, 1 / math.sqrt(128), kf.shape[3]
    (kq, ks), (vq, vs) = (jpaged.quantize_kv(jnp.asarray(x)) for x in (kf, vf))
    kq, ks, vq, vs = (np.asarray(a) for a in (kq, ks, vq, vs))
    rng = np.random.default_rng(5)
    ok, ov = (rng.standard_normal((2, len(lens), 3, page, 128)).astype(ml_dtypes.bfloat16) for _ in range(2))
    # The JAX package's CPU path: dequantize, patch each row's last page by
    # its largest budget, the XLA chunk oracle.
    k_layer = jpa.dequant_pages(jnp.asarray(kq[li]), jnp.asarray(ks[li]))
    v_layer = jpa.dequant_pages(jnp.asarray(vq[li]), jnp.asarray(vs[li]))
    if tail:
        last = jnp.asarray(tables)[jnp.arange(len(lens)), (jnp.asarray(lens[:, -1]) - 1) // page]
        k_layer = k_layer.at[last].set(jnp.asarray(ok[li]).astype(jnp.float32))
        v_layer = v_layer.at[last].set(jnp.asarray(ov[li]).astype(jnp.float32))
    want = np.asarray(jpa.paged_decode_attention_xla_chunk(jnp.asarray(q), k_layer, v_layer, jnp.asarray(tables),
                                                           jnp.asarray(lens), scale=scale))
    jopen = dict(open_k=jnp.asarray(ok), open_v=jnp.asarray(ov)) if tail else {}
    pallas = np.asarray(jpa.paged_decode_attention_pool_chunk_q8(
        *map(jnp.asarray, (q, kq, vq, ks, vs, tables, lens)), li, scale=scale, interpret=True, **jopen))

    topen = dict(open_k=_t(ok), open_v=_t(ov)) if tail else {}
    before = tpa.paged_decode_attention_pool_chunk_q8.launches
    got = tpa.paged_decode_attention_pool_chunk_q8(*map(_t, (q, kq, vq, ks, vs, tables, lens)), li, scale=scale,
                                                   **topen)
    assert tpa.paged_decode_attention_pool_chunk_q8.launches == before  # CPU tensors: the twin
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    live = slice(0, 3) if tail else slice(None)  # the finished row: see the module docstring
    np.testing.assert_allclose(got.numpy()[live], pallas[live], **TOL)


# ---------------------------------------------------------------------------
# Chunk decode steps


@pytest.fixture(scope="module")
def lm():
    cfg = tiny_lm_config(num_hidden_layers=2)  # a dense and a MoE layer; each JAX compile scales with depth
    flat = random_lm_flat(cfg, seed=9)
    jp, rep = jdsv2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    tp, rep = tdsv2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    return cfg, flat, jax.tree_util.tree_map(jnp.asarray, jp), tp


def test_contiguous_chunk_decode_matches_jax(lm):
    """Prefill 10 tokens of 2 rows, then a 4-token chunk at the shared
    position 10 and one at per-row positions (14, 12): query j sees the
    keys up to its own position only."""
    cfg, _, jp, tp = lm
    rng = np.random.default_rng(2)
    b, cap = 2, 32
    args = (cfg.num_hidden_layers, b, cfg.num_attention_heads, cap, cfg.head_dim)
    jcache, tcache = jax_make_kv_cache(*args, jnp.float32), make_kv_cache(*args, dtype=torch.float32)
    forward = jax.jit(lambda p, e, c, q, pre: jdsv2.lm_forward(p, cfg, e, c, pos=q, is_prefill=pre),
                      static_argnums=(4,))
    for pos, s in ((0, 10), (10, 4), (np.array([14, 12], np.int32), 4)):
        ids = rng.integers(0, cfg.vocab_size, (b, s))
        prefill = s == 10
        jh, jcache = forward(jp, jnp.take(jp["embed"], jnp.asarray(ids), axis=0), jcache, jnp.asarray(pos),
                             prefill)
        th = tdsv2.lm_forward(tp, cfg, torch.nn.functional.embedding(_t(ids), tp["embed"]), tcache,
                              pos=_t(pos) if isinstance(pos, np.ndarray) else pos, is_prefill=prefill)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL, err_msg=f"pos {pos}")
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), **TOL)


def _compare_pools(tpool, jpool, where, halfway):
    for name in tpool:
        got, want = tpool[name][:, 1:].float().numpy(), np.asarray(jpool[name][:, 1:]).astype(np.float32)
        if name.startswith("open"):  # one a slot, no scratch page
            got, want = tpool[name].float().numpy(), np.asarray(jpool[name]).astype(np.float32)
        if name in ("k", "v") and tpool[name].dtype == torch.int8:
            near = halfway[name][:, 1:]
            np.testing.assert_array_equal(got[~near], want[~near], err_msg=f"{name} codes, {where}")
            assert np.abs(got[near] - want[near]).max(initial=0) <= 1, f"{name} codes, {where}"
        elif name.endswith("scale"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, err_msg=f"{name}, {where}")
        elif name.startswith("open") or tpool[name].dtype == torch.bfloat16:
            np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=0, err_msg=f"{name}, {where}")
        else:
            np.testing.assert_allclose(got, want, **TOL, err_msg=f"{name}, {where}")


@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8", "int8tail"])
def test_paged_chunk_step_matches_jax(lm, kv, monkeypatch):
    """Rows 0-1 hold a 13-token prompt over 8-token pages, rows 2-3 a
    5-token one; two chunk steps of S = 4 at per-row positions (row 0's
    first chunk crosses from page 1 into page 2); row 3 is finished and
    points at the scratch page 0."""
    cfg, _, jp, tp = lm
    b, s, page, n_pool, max_pages = 4, 4, 8, 20, 4
    l, hh, d = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    rng = np.random.default_rng(1)
    jkind = {"float32": jnp.float32, "bfloat16": jnp.bfloat16, "int8": jnp.int8}.get(kv, kv)
    tkind = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(kv, kv)
    jpool = jpaged.make_paged_kv_cache(l, n_pool, hh, page, d, jkind, slots=b)
    tpool = tpaged.make_paged_kv_cache(l, n_pool, hh, page, d, tkind, slots=b)
    tables = np.zeros((b, max_pages), np.int32)
    for rows, plen, pages in (([0, 1], 13, [[1, 2, 3], [4, 5, 6]]), ([2, 3], 5, [[7, 8], [9, 10]])):
        n_prompt = tpaged.pages_for(plen, page)
        k_new, v_new = (rng.standard_normal((l, 2, hh, n_prompt * page, d)).astype(np.float32) for _ in range(2))
        k_new[:, :, :, plen:] = 0
        v_new[:, :, :, plen:] = 0
        ids = np.array([p[:n_prompt] for p in pages], np.int32)
        jpool = jpaged.write_prompt_pool_batched(jpool, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(ids),
                                                 plen, slot_ids=jnp.asarray(rows, jnp.int32))
        tpaged.write_prompt_pool_batched(tpool, _t(k_new), _t(v_new), _t(ids), plen, slot_ids=torch.tensor(rows))
        for r, p in zip(rows, pages):
            tables[r, : len(p)] = p
    tables[3] = 0
    calls = []
    quantize = tpaged.quantize_kv
    monkeypatch.setattr(tpaged, "quantize_kv", lambda x: calls.append(x.float()) or quantize(x))
    halfway = {name: np.zeros(tpool[name].shape, bool) for name in ("k", "v")}
    jax_step = jax.jit(lambda p, e, c, t, q: jpaged.lm_decode_step_paged(p, cfg, e, c, t, q, use_pallas=False))
    pos = np.array([14, 13, 5, 5], np.int32)
    rows = np.arange(b)[:, None]
    for step in range(2):
        toks = rng.integers(0, cfg.vocab_size, (b, s))
        calls.clear()
        jh, jpool = jax_step(jp, jnp.take(jp["embed"], jnp.asarray(toks), axis=0), jpool, jnp.asarray(tables),
                             jnp.asarray(pos))
        th = tpaged.lm_decode_step_paged(tp, cfg, torch.nn.functional.embedding(_t(toks), tp["embed"]), tpool,
                                         _t(tables), _t(pos))
        # A bf16 pool element one ulp apart (see _compare_pools) moves the
        # attention output by up to 2^-8 of its weight: 1e-3 there.
        tol = dict(rtol=1e-3, atol=1e-3) if kv == "bfloat16" else TOL
        np.testing.assert_allclose(th[:3].numpy(), np.asarray(jh)[:3], **tol, err_msg=f"step {step}")
        posq = pos[:, None] + np.arange(s)
        for i, x in enumerate(calls):  # x: [B * S, Hh, D], one a layer and K or V
            ratio = (x / quantize(x)[1][..., None]).numpy().reshape(b, s, hh, d)
            near = np.abs(ratio - np.floor(ratio) - 0.5) < 1e-4
            halfway["kv"[i % 2]][i // 2, tables[rows, posq // page], :, posq % page] |= near
        _compare_pools(tpool, jpool, f"step {step}", halfway)
        pos = pos + np.array([3, 2, 4, 0], np.int32)  # accepted tokens vary by row


# ---------------------------------------------------------------------------
# lookup_greedy_generate and _batched


def _gen_both(cfg, jp, tp, ids, *, batched=False, kv_dtypes=("float32", torch.float32), **kw):
    """(port lookup tokens, n, steps) after checking them against the JAX
    package's lookup and the port's plain greedy."""
    kw = {"eos_id": 1, "capacity": 128, **kw}
    jemb = jnp.take(jp["embed"], jnp.asarray(ids), axis=0)
    temb = tp["embed"][_t(ids).long()]
    jfn, tfn = ((jgen.lookup_greedy_generate_batched, tgen.lookup_greedy_generate_batched) if batched else
                (jgen.lookup_greedy_generate, tgen.lookup_greedy_generate))
    jt, jn, js = jfn(jp, cfg, jemb, jnp.asarray(ids, jnp.int32), kv_dtype=kv_dtypes[0], return_steps=True, **kw)
    tt, tn, ts = tfn(tp, cfg, temb, _t(ids).long(), kv_dtype=kv_dtypes[1], return_steps=True, **kw)
    kw.pop("chunk", None)
    gt, gn = tgen.greedy_generate(tp, cfg, temb, _t(ids).long(), kv_dtype=kv_dtypes[1], **kw)
    s = ids.shape[1]
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tn.numpy(), gn.numpy())
    assert ts == int(np.asarray(js)), (ts, int(np.asarray(js)))
    for r in range(ids.shape[0]):
        n = int(tn[r])
        np.testing.assert_array_equal(tt[r, : s + n].numpy(), np.asarray(jt)[r, : s + n], err_msg=f"row {r}")
        np.testing.assert_array_equal(tt[r, : s + n].numpy(), gt[r, : s + n].numpy(), err_msg=f"row {r}")
    return tt, tn, ts


@pytest.mark.parametrize("ngram,max_new,chunk", [(0, 24, 4), (3, 24, 5), (3, 40, 2)])
def test_lookup_generate_matches_jax_and_greedy(lm, ngram, max_new, chunk):
    cfg, _, jp, tp = lm
    rng = np.random.default_rng(ngram * 100 + max_new)
    ids = rng.integers(2, cfg.vocab_size, (1, 10))
    _gen_both(cfg, jp, tp, ids, max_new_tokens=max_new, ngram_size=ngram, chunk=chunk)


def test_lookup_generate_eos_stop_and_batched(lm):
    """The 5th greedy token of a row becomes the stop token: the lookup
    stops on it mid-chunk; then 3 rows at once (the JAX package's batched
    test), rows stopping at different forwards."""
    cfg, _, jp, tp = lm
    rng = np.random.default_rng(7)
    ids = rng.integers(2, cfg.vocab_size, (1, 10))
    gt, gn = tgen.greedy_generate(tp, cfg, tp["embed"][_t(ids).long()], _t(ids).long(), max_new_tokens=24,
                                  eos_id=1, capacity=128, kv_dtype=torch.float32)
    eos = int(gt[0, 14])
    tt, tn, _ = _gen_both(cfg, jp, tp, ids, max_new_tokens=24, ngram_size=0, chunk=4, eos_id=eos)
    assert int(tt[0, 10 + int(tn[0]) - 1]) == eos and int(tn[0]) <= 5
    ids3 = rng.integers(2, cfg.vocab_size, (3, 10))
    ids3[1] = np.tile(ids3[1, :4], 3)[:10]  # one repetitive prompt
    _gen_both(cfg, jp, tp, ids3, batched=True, max_new_tokens=24, ngram_size=3, chunk=4, eos_id=int(gt[0, 12]))


@pytest.mark.parametrize("bits", [8, 4, 16])
def test_lookup_generate_quantized_matches_jax(bits):
    """--int8 and --int4 weights (scope full) on a 2-layer LM with I = 128:
    the chunk takes kernels H and I (L and M) at B * S rows, never K or O;
    bits 16: the same LM in bf16 (weights, activations and cache)."""
    cfg = tiny_lm_config(num_hidden_layers=2, moe_intermediate_size=128)
    jp, _ = jdsv2.params_from_flat(random_lm_flat(cfg, seed=11), cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    if bits == 16:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    else:  # quantized once, jitted (the eager form takes seconds), and carried
        # over: both packages decode from the same levels and scales
        jp = jax.jit(functools.partial(jdsv2.quantize_lm_params, scope="full", bits=bits))(jp)
    tp = tdsv2.params_from_jax(jp, cfg)
    ids = np.random.default_rng(20 + bits).integers(2, cfg.vocab_size, (1, 10))
    _gen_both(cfg, jp, tp, ids, max_new_tokens=16, ngram_size=3, chunk=4,
              **({"kv_dtypes": ("bfloat16", torch.bfloat16)} if bits == 16 else {}))


def test_lookup_accelerates_deterministic_cycle():
    """The JAX package's hand-built Markov LM (attention, MLPs and experts
    zeroed; embed -> lm_head maps token t to t + 1 mod 24): after the
    prompt's period every draft accepts, 96 tokens in at most 32 forwards."""
    cfg = tiny_lm_config(num_hidden_layers=2)
    h, period = cfg.hidden_size, 24
    flat = {k: (np.zeros_like(v) if ("self_attn" in k or ".mlp." in k) else v)
            for k, v in random_lm_flat(cfg, seed=0).items()}
    emb = np.zeros((cfg.vocab_size, h), np.float32)
    head = np.zeros((cfg.vocab_size, h), np.float32)  # HF [out, in]
    for t in range(period):
        emb[t, t] = 1.0
        head[(t + 1) % period, t] = 1.0
    flat["model.embed_tokens.weight"], flat["lm_head.weight"] = emb, head
    jp, _ = jdsv2.params_from_flat(flat, cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    tp, _ = tdsv2.params_from_flat(flat, cfg)
    ids = np.asarray(list(range(period)) + list(range(4)))[None]
    tt, tn, steps = _gen_both(cfg, jp, tp, ids, max_new_tokens=96, ngram_size=0, chunk=6, eos_id=255, capacity=256)
    assert int(tn[0]) == 96 and steps <= 32
    np.testing.assert_array_equal(tt[0, 28:].numpy(), [(4 + i) % period for i in range(96)])


def test_chunk_wrappers_refuse_non_cuda_devices():
    """Only CPU tensors take Q's and R's twins; any other device raises (no
    fallback), as do more queries a row than the kernels take."""
    q = torch.zeros(2, 4, 10, 128, device="meta")
    pool = torch.zeros(2, 3, 10, 16, 128, device="meta")
    bt, lens = torch.zeros(2, 2, dtype=torch.int32, device="meta"), torch.zeros(2, 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention_pool_chunk(q, pool, pool, bt, lens, 1, scale=1.0)
    codes, scales = torch.zeros(2, 3, 10, 16, 128, dtype=torch.int8, device="meta"), torch.zeros(2, 3, 10, 16,
                                                                                                  device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention_pool_chunk_q8(q, codes, codes, scales, scales, bt, lens, 1, scale=1.0)
    q9 = torch.zeros(2, 9, 10, 128, device="meta")
    with pytest.raises(ValueError, match="2..8 queries"):
        tpa.paged_decode_attention_pool_chunk(q9, pool, pool, bt, torch.zeros(2, 9, dtype=torch.int32, device="meta"),
                                              1, scale=1.0)
