"""The paged KV cache and kernel G's twin against the JAX package, on the
CPU: paged decode attention over the layer-stacked pool, the prompt scatter
and the page allocator, and whole paged decode steps with per-row positions.

Tolerances: G's twin agrees with the JAX Pallas kernel (interpret mode) and
its XLA gather form to 2e-5, the JAX package's own bound (f32, other
summation orders; the kernel takes an online softmax over pages). The
prompt scatter is exact. Decode steps in f32 agree to 1e-4 on the hidden
state and the pool (three layers of f32 GEMMs in other orders).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from deepseek_ocr2_tpu.configs import tiny_lm_config
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
from deepseek_ocr2_tpu.ops.paged_attention import paged_decode_attention_pool as jax_pool_attention
from deepseek_ocr2_tpu.ops.paged_attention import paged_decode_attention_xla
from deepseek_ocr2_tpu.runtime import paged_kv as jpaged
from deepseek_ocr2_tpu.runtime.kv_cache import make_kv_cache as jax_make_kv_cache
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.ops import paged_attention as tpa
from deepseek_ocr2_tpu_torch.runtime import paged_kv as tpaged

from reference_torch import random_lm_flat

F32 = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("page,seq_lens", [(128, [1, 135, 512]), (16, [16, 17, 40])])
def test_paged_attention_twin_matches_jax_kernel_and_xla(page, seq_lens):
    n_layers, b, hh, d, n_pool = 3, 3, 4, 128, 16
    max_pages = max(-(-s // page) for s in seq_lens)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((b, hh, d)).astype(np.float32)
    k_pool, v_pool = (rng.standard_normal((n_layers, n_pool, hh, page, d)).astype(np.float32) for _ in range(2))
    tables = np.stack([rng.permutation(np.arange(1, n_pool))[:max_pages] for _ in range(b)]).astype(np.int32)
    lens = np.asarray(seq_lens, np.int32)
    scale = 1 / math.sqrt(d)
    for li in (0, n_layers - 1):
        want = np.asarray(jax_pool_attention(*map(jnp.asarray, (q, k_pool, v_pool, tables, lens)), jnp.int32(li),
                                             scale=scale, interpret=True))
        want_xla = np.asarray(paged_decode_attention_xla(*map(jnp.asarray, (q, k_pool[li], v_pool[li], tables, lens)),
                                                         scale=scale))
        before = tpa.paged_decode_attention_pool.launches
        got = tpa.paged_decode_attention_pool(*map(_t, (q, k_pool, v_pool, tables, lens)), li, scale=scale)
        assert tpa.paged_decode_attention_pool.launches == before  # CPU tensors: the twin
        np.testing.assert_allclose(got.numpy(), want, **F32)
        np.testing.assert_allclose(got.numpy(), want_xla, **F32)


def test_paged_attention_twin_reads_bf16_pools_in_f32():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 128)).astype(np.float32)
    pool = rng.standard_normal((2, 6, 4, 16, 128)).astype(np.float32)
    tables, lens = np.array([[1, 2, 3], [4, 5, 0]], np.int32), np.array([40, 20], np.int32)
    want = np.asarray(paged_decode_attention_xla(jnp.asarray(q), jnp.asarray(pool[1], jnp.bfloat16),
                                                 jnp.asarray(pool[1], jnp.bfloat16), jnp.asarray(tables),
                                                 jnp.asarray(lens), scale=0.1))
    bf = _t(pool).to(torch.bfloat16)
    got = tpa.paged_decode_attention_pool(_t(q), bf, bf, _t(tables), _t(lens), 1, scale=0.1)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_write_prompt_pool_and_allocator_match_jax():
    l, g, hh, d, page, cap, n_pages = 2, 3, 4, 8, 16, 48, 12
    rng = np.random.default_rng(5)
    k_new, v_new = (rng.standard_normal((l, g, hh, cap, d)).astype(np.float32) for _ in range(2))
    ja, ta = jpaged.PageAllocator(n_pages), tpaged.PageAllocator(n_pages)
    for n in (3, 2, 4):
        assert ta.allocate(n) == ja.allocate(n)
    ta.release([5, 1]), ja.release([5, 1])
    assert ta.allocate(3) == ja.allocate(3) and ta.n_free == ja.n_free
    with pytest.raises(RuntimeError):
        ta.allocate(ta.n_free + 1)
    assert tpaged.pages_for(33, 16) == jpaged.pages_for(33, 16) == 3

    page_ids = np.array([[3, 7, 1], [2, 9, 4], [11, 5, 6]], np.int32)
    seq_len = 40  # three pages, the last one partly filled
    jcache = jpaged.make_paged_kv_cache(l, n_pages, hh, page, d, jnp.float32)
    jcache = jpaged.write_prompt_pool_batched(jcache, jnp.asarray(k_new), jnp.asarray(v_new),
                                              jnp.asarray(page_ids), seq_len)
    for dtype in (torch.float32, torch.bfloat16):
        tcache = tpaged.make_paged_kv_cache(l, n_pages, hh, page, d, dtype)
        out = tpaged.write_prompt_pool_batched(tcache, _t(k_new), _t(v_new), _t(page_ids), seq_len)
        assert out["k"] is tcache["k"]  # in place
        for name in ("k", "v"):
            want = np.asarray(jnp.asarray(jcache[name]).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
                              .astype(jnp.float32))
            np.testing.assert_array_equal(tcache[name].float().numpy(), want)


def test_quantized_pools_name_their_slice():
    for dtype in ("int8", "int8tail"):
        with pytest.raises(ValueError, match="quantized slice"):
            tpaged.make_paged_kv_cache(2, 4, 2, 16, 8, dtype)


@pytest.fixture(scope="module")
def lm():
    cfg = tiny_lm_config()
    flat = random_lm_flat(cfg, seed=9)
    jp, rep = jdsv2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    tp, rep = tdsv2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    return cfg, jp, tp


@pytest.mark.parametrize("b", [3, 5])  # 5 rows x top-2 > 8 experts: kernel F's twin
def test_lm_decode_step_paged_matches_jax(lm, b):
    """Prompts of different lengths in their own pages, then three paged
    decode steps at per-row positions; the last row is finished and points
    at the scratch page 0. Hidden states and the whole pool against JAX."""
    cfg, jp, tp = lm
    page, s, cap = 8, 13, 32
    rng = np.random.default_rng(b)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    jcache = jax_make_kv_cache(cfg.num_hidden_layers, b, cfg.num_attention_heads, cap, cfg.head_dim, jnp.float32)
    _, jcache = jdsv2.lm_forward(jp, cfg, jnp.take(jp["embed"], jnp.asarray(ids), axis=0), jcache,
                                 pos=0, is_prefill=True)
    n_per = tpaged.pages_for(cap, page)
    n_pool = b * n_per + 1
    alloc = tpaged.PageAllocator(n_pool)
    tables = np.stack([alloc.allocate(n_per) for _ in range(b)]).astype(np.int32)
    tables[-1] = 0
    prompt_pages = tables[:, : tpaged.pages_for(s, page)]
    jpool = jpaged.write_prompt_pool_batched(
        jpaged.make_paged_kv_cache(cfg.num_hidden_layers, n_pool, cfg.num_attention_heads, page, cfg.head_dim,
                                   jnp.float32),
        jcache["k"], jcache["v"], jnp.asarray(prompt_pages), s)
    tpool = {name: _t(jpool[name]) for name in ("k", "v")}
    pos = np.array([s - 4 + r for r in range(b)], np.int32)  # per-row positions
    for step in range(3):
        toks = rng.integers(0, cfg.vocab_size, (b,))
        jh, jpool = jpaged.lm_decode_step_paged(
            jp, cfg, jnp.take(jp["embed"], jnp.asarray(toks), axis=0)[:, None], jpool, jnp.asarray(tables),
            jnp.asarray(pos), use_pallas=False)
        th = tpaged.lm_decode_step_paged(tp, cfg, torch.nn.functional.embedding(_t(toks), tp["embed"])[:, None],
                                         tpool, _t(tables), _t(pos))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-4, err_msg=f"step {step}")
        for name in ("k", "v"):
            np.testing.assert_allclose(tpool[name].numpy(), np.asarray(jpool[name]), rtol=1e-4, atol=1e-4)
        pos = pos + 1


def test_paged_step_refuses_chunk_mode(lm):
    cfg, _, tp = lm
    pool = tpaged.make_paged_kv_cache(cfg.num_hidden_layers, 3, cfg.num_attention_heads, 8, cfg.head_dim,
                                      torch.float32)
    with pytest.raises(ValueError, match="lookup"):
        tpaged.lm_decode_step_paged(tp, cfg, torch.zeros(1, 2, cfg.hidden_size), pool,
                                    torch.ones(1, 2, dtype=torch.int32), torch.zeros(1, dtype=torch.int32))
