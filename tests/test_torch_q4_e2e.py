"""The port's int4 weight tier (`--int4`) end to end on the CPU, at tiny
widths in f32, against the JAX package on the same numpy-seeded weights:
the quantized LM's logits in both scopes, the bf16 prefill, `generate_ocr`
with --int4 (no-crop and crop pages), both serving engines with --int4 (a
preemption, and decode batches with B * k > E through kernel N's twin), and
the CLI (generate-ocr and serve, with and without --continuous).

The logits test runs the JAX package's TPU dispatch of the int4 decode path
(`pallas_enabled()` true at its call-time lookups, the Pallas kernels in
interpret mode), so both packages take the same kernels: kernel M with the
shared pseudo-experts at one row, kernel N above E / k rows, kernel L for
the int4 linears. Only the attention differs: the port's kernel O (the JAX
package's needs head_dim % 128 == 0) against the JAX package's unfused
projections and attention, which agree in f32. Bound: 1e-4 of the largest
logit, for f32 sums taken in another order through the layers.

The token tests run the JAX package's jitted pipeline and engines as they
are on the CPU (its XLA fallbacks: the shared MLP as a plain int4 SwiGLU
where the port's kernels take the pseudo-experts, the int4 linears in the
prefill form). Their LM has the tiny widths but the full width's property
that the experts' intermediate size is a multiple of 128 (128 here, 896
there): the pseudo-experts' levels and group scales are then the fused
shared stream's, both forms compute from the same weights, and they differ
only in the order of the f32 sums. (At I = 32 the pseudo-experts' groups
are not the fused stream's: the JAX package's own fallback and TPU dispatch
then differ by 2.4 % of the largest logit.) Tokens are compared exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)
import torch.nn.functional as F
from PIL import Image

from deepseek_ocr2_tpu.configs import tiny_lm_config
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
from deepseek_ocr2_tpu.runtime.kv_cache import make_kv_cache as jax_make_kv_cache
from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.ops import attn_fused, linear_q4, linear_q8, moe_decode, moe_q4, moe_q8
from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine
from deepseek_ocr2_tpu_torch.runtime.kv_cache import make_kv_cache
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

import reference_torch as ref
import reference_torch_vision as refv

LOGITS_RTOL = 1e-4


@pytest.fixture
def jax_tpu_dispatch(monkeypatch):
    from deepseek_ocr2_tpu.ops import flash_attention, linear_q4 as jlinear_q4, moe_q4 as jmoe_q4

    monkeypatch.setattr(flash_attention, "pallas_enabled", lambda: True)
    for mod, name in ((jlinear_q4, "linear_q4"), (jmoe_q4, "moe_ffn_decode_q4"),
                      (jmoe_q4, "moe_ffn_decode_q4_fused")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))


def _tiny_lm(seed=11, dtype=None):
    cfg = tiny_lm_config(num_hidden_layers=4)
    jparams, _ = jdsv2.params_from_flat(ref.random_lm_flat(cfg, seed=seed), cfg)
    cast = (lambda a: jnp.asarray(a, dtype if np.issubdtype(np.asarray(a).dtype, np.floating) else None)) \
        if dtype else jnp.asarray
    return cfg, jax.tree_util.tree_map(cast, jparams)


@pytest.mark.parametrize("scope,b", [("experts", 1), ("experts", 5), ("full", 1), ("full", 5)])
def test_quantized_lm_q4_matches_jax(jax_tpu_dispatch, scope, b):
    """Prefill and three decode steps; the JAX run's greedy tokens feed both."""
    cfg, jparams = _tiny_lm()
    jq = jdsv2.quantize_lm_params(jparams, scope=scope, bits=4)
    tq = tdsv2.params_from_jax(jq, cfg)
    ids = np.random.default_rng(b).integers(0, cfg.vocab_size, (b, 9))
    shape = (cfg.num_hidden_layers, b, cfg.num_attention_heads, 32, cfg.head_dim)
    jcache = jax_make_kv_cache(*shape[:3], 32, cfg.head_dim, jnp.float32)
    tcache = make_kv_cache(*shape[:3], 32, cfg.head_dim, dtype=torch.float32)
    jemb = jnp.take(jq["embed"], jnp.asarray(ids, jnp.int32), axis=0)
    temb = F.embedding(torch.from_numpy(ids), tq["embed"])
    # One trace for the three decode steps (the position is traced): eager
    # interpret-mode kernels cost seconds a call.
    jax_decode = jax.jit(lambda p, e, c, pos: jdsv2.lm_forward(p, cfg, e, c, pos=pos, is_prefill=False))
    for step in range(4):
        pos, prefill = (0, True) if step == 0 else (8 + step, False)
        if prefill:
            jh, jcache = jdsv2.lm_forward(jq, cfg, jemb, jcache, pos=0, is_prefill=True)
        else:
            jh, jcache = jax_decode(jq, jemb, jcache, jnp.int32(pos))
        want = np.asarray(jdsv2.logits_last(jq, jh), np.float32)
        got = tdsv2.logits_last(tq, tdsv2.lm_forward(tq, cfg, temb, tcache, pos=pos, is_prefill=prefill))
        assert got.dtype == torch.float32
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= LOGITS_RTOL * np.abs(want).max(), (step, err)
        tok = np.argmax(want, axis=-1)
        jemb = jnp.take(jq["embed"], jnp.asarray(tok, jnp.int32), axis=0)[:, None]
        temb = F.embedding(torch.from_numpy(tok), tq["embed"])[:, None]


def test_quantized_lm_q4_prefill_bf16_matches_jax(jax_tpu_dispatch):
    """`--int4` prefill in bf16 (the CLI's LM dtype) against the JAX package
    on the same bf16 weights and levels: the int4 projections round each
    dequantized weight to bf16 before the product (`linear_q4_xla`), unlike
    the int8 ones; lm_head takes the kernel (L), which does not. Bound: 1e-3
    of the largest logit."""
    cfg, jparams = _tiny_lm(dtype=jnp.bfloat16)
    jq = jdsv2.quantize_lm_params(jparams, scope="full", bits=4)
    tq = tdsv2.params_from_jax(jq, cfg)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 40))
    jcache = jax_make_kv_cache(cfg.num_hidden_layers, 2, cfg.num_attention_heads, 64, cfg.head_dim, jnp.bfloat16)
    jh, _ = jdsv2.lm_forward(jq, cfg, jnp.take(jq["embed"], jnp.asarray(ids, jnp.int32), axis=0), jcache,
                             pos=0, is_prefill=True)
    want = np.asarray(jdsv2.logits_last(jq, jh), np.float32)
    tcache = make_kv_cache(cfg.num_hidden_layers, 2, cfg.num_attention_heads, 64, cfg.head_dim,
                           dtype=torch.bfloat16)
    temb = F.embedding(torch.from_numpy(ids), tq["embed"])
    assert temb.dtype == torch.bfloat16
    got = tdsv2.logits_last(tq, tdsv2.lm_forward(tq, cfg, temb, tcache, pos=0, is_prefill=True))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= 1e-3 * np.abs(want).max(), err


def test_int4_decode_takes_the_int4_kernels_twins(monkeypatch):
    """A decode step of the int4 LM reaches L, M (one row) and N (B * k > E)
    and O, and none of the int8 wrappers (counted through their twins)."""
    cfg, jparams = _tiny_lm(seed=12)
    tq = tdsv2.quantize_lm_params(tdsv2.params_from_jax(jparams, cfg), scope="full", bits=4)
    calls = []
    for mod, name in ((linear_q4, "linear_q4_reference"), (moe_q4, "moe_ffn_decode_q4_reference"),
                      (moe_q4, "moe_ffn_decode_q4_visits_reference"),
                      (attn_fused, "attn_decode_fused_reference"), (linear_q8, "linear_q8_reference"),
                      (moe_q8, "moe_ffn_decode_q8_reference"), (moe_decode, "moe_ffn_decode_q8_visits_reference")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **k: (calls.append(_n), _fn(*a, **k))[1])
    for b, moe_twin in ((1, "moe_ffn_decode_q4_reference"), (5, "moe_ffn_decode_q4_visits_reference")):
        calls.clear()
        cache = make_kv_cache(cfg.num_hidden_layers, b, cfg.num_attention_heads, 16, cfg.head_dim,
                              dtype=torch.float32)
        emb = F.embedding(torch.arange(2, 2 + b)[:, None], tq["embed"])
        tdsv2.logits_last(tq, tdsv2.lm_forward(tq, cfg, emb, cache, pos=3, is_prefill=False))
        n_moe = cfg.num_hidden_layers - cfg.first_k_dense_replace
        assert calls.count(moe_twin) == n_moe and calls.count("attn_decode_fused_reference") == cfg.num_hidden_layers
        # dense gate||up and down, and lm_head: the shared MLP is folded in (one row, or N)
        assert calls.count("linear_q4_reference") == 3 and len(calls) == 3 + n_moe + cfg.num_hidden_layers, calls


# ---------------------------------------------------------------------------
# Pages and engines


def _tiny_tokenizer():
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tok


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_ocr2_config()
    cfg = dataclasses.replace(cfg, image_token_id=500, lm=dataclasses.replace(cfg.lm, moe_intermediate_size=128))
    flat = refv.random_ocr2_flat(cfg, seed=21)
    params, report = tocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    return cfg, flat, params


@pytest.fixture(scope="module")
def int4_pipes(setup):
    """(JAX pipeline, port pipeline) on the same weights, the LM int4."""
    from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
    from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline as JaxPipeline

    cfg, flat, params = setup
    jparams, report = jocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    jparams["lm"] = jdsv2.quantize_lm_params(jparams["lm"], scope="full", bits=4)
    tparams = {**params, "lm": tdsv2.quantize_lm_params(params["lm"], scope="full", bits=4)}
    jpipe = JaxPipeline(jparams, cfg, _tiny_tokenizer(), kv_dtype="float32", act_dtype="float32")
    tpipe = OCR2Pipeline(tparams, cfg, _tiny_tokenizer(), device="cpu", kv_dtype="float32", act_dtype="float32")
    return jpipe, tpipe


def _pages(sizes, seed):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)) for w, h in sizes]


@pytest.mark.parametrize("size", [(160, 120), (500, 300)])  # no crop; crop grid (3, 2)
def test_generate_ocr_int4_matches_jax(int4_pipes, size):
    jpipe, tpipe = int4_pipes
    page = _pages([size], seed=5)[0]
    want = jpipe.generate_ocr(page, max_new_tokens=12, ngram_size=3)
    got = tpipe.generate_ocr(page, max_new_tokens=12, ngram_size=3)
    assert got.prompt_len == want.prompt_len
    assert got.token_ids == want.token_ids and got.text == want.text


def test_group_engine_int4_matches_jax(int4_pipes):
    """Six no-crop pages decode in one chunk at B = 6 (B * k = 12 > E = 8:
    kernel N's twin, O's for the attention), the crop page in a chunk of its
    own (kernel M with the pseudo-experts)."""
    from deepseek_ocr2_tpu.runtime.engine import OCR2Engine as JaxEngine

    jpipe, tpipe = int4_pipes
    pages = _pages([(160, 120)] * 6 + [(500, 300)], seed=8)
    want = JaxEngine(jpipe, batch_size=6).run(pages, max_new_tokens=8, ngram_size=3)
    got = OCR2Engine(tpipe, batch_size=6).run(pages, max_new_tokens=8, ngram_size=3)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.token_ids == w.token_ids, (i, w.token_ids, g.token_ids)


def test_continuous_engine_int4_matches_jax(int4_pipes):
    """Six slots decode at B * k = 12 > E (kernel N's twin; L for the int4
    projections around G)."""
    from deepseek_ocr2_tpu.runtime.continuous import ContinuousOCREngine as JaxContinuous

    jpipe, tpipe = int4_pipes
    pages = _pages([(500, 300), (160, 120), (400, 400), (640, 200), (160, 120), (300, 200)], seed=3)
    kw = dict(slots=6, capacity=128, chunk_steps=4)
    want = JaxContinuous(jpipe, **kw).run(pages, max_new_tokens=8, ngram_size=3)
    got = ContinuousOCREngine(tpipe, **kw).run(pages, max_new_tokens=8, ngram_size=3)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.token_ids == w.token_ids, (i, w.token_ids, g.token_ids)


def test_continuous_int4_preemption_token_exact(int4_pipes):
    """A pool that makes both slots grow and the younger one preempt: the
    re-admitted page gives the single page's tokens (which
    test_generate_ocr_int4_matches_jax holds to the JAX package)."""
    _, tpipe = int4_pipes
    pages = _pages([(160, 120)], seed=4) * 2
    engine = ContinuousOCREngine(tpipe, slots=2, capacity=128, chunk_steps=8, page_size=16, pool_tokens=160)
    got = engine.run(pages, max_new_tokens=64, ngram_size=3)
    assert engine.last_preempted >= 1, "pool sizing did not force a preemption"
    single = tpipe.generate_ocr(pages[0], max_new_tokens=64, ngram_size=3)
    for g in got:
        assert g.token_ids == single.token_ids


# ---------------------------------------------------------------------------
# CLI


@pytest.fixture(scope="module")
def cli_assets(tmp_path_factory, setup):
    import json

    from deepseek_ocr2_tpu_torch.io import save_flat

    cfg, flat, _ = setup
    d = tmp_path_factory.mktemp("clitest_q4")
    (d / "tiny_config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    save_flat(flat, str(d / "tiny.safetensors"))
    _tiny_tokenizer().save(str(d / "tokenizer.json"))
    for name, page in zip(("page.png", "page_crop.png"), _pages([(160, 120), (500, 300)], seed=6)):
        page.save(d / name)
    return d


def _base(d, command):
    return [command, "--backend", "cpu", "--weights", str(d / "tiny.safetensors"), "--tokenizer",
            str(d / "tokenizer.json"), "--config", str(d / "tiny_config.json"), "--max-new-tokens", "6",
            "--no-repeat-ngram-size", "3", "--vision-dtype", "f32", "--lm-dtype", "f32"]


def test_cli_generate_ocr_int4(cli_assets, capsys):
    from deepseek_ocr2_tpu_torch.cli import main

    d = cli_assets
    assert main([*_base(d, "generate-ocr"), "--image", str(d / "page_crop.png"), "--image-token-id", "500",
                 "--int4", "--int8"]) == 0  # --int4 wins, as in the JAX CLI
    err = capsys.readouterr().err
    assert "int4: LM weights quantized (scope=full)" in err and "tokens" in err


@pytest.mark.parametrize("mode", [["--continuous", "--capacity", "128", "--page-size", "16"], []])
def test_cli_serve_int4(cli_assets, capsys, mode):
    from deepseek_ocr2_tpu_torch.cli import main

    d = cli_assets
    assert main([*_base(d, "serve"), "--images", str(d / "page.png"), str(d / "page_crop.png"),
                 "--batch-size", "2", "--int4", *mode]) == 0
    out = capsys.readouterr()
    assert "int4: LM weights quantized (scope=full)" in out.err and out.out.count("=== ") == 2
    assert "pages/s" in out.err


def test_cli_int8_scope_takes_bits():
    from deepseek_ocr2_tpu_torch.cli import build_parser, int8_scope

    def scope(*flags):
        return int8_scope(build_parser().parse_args(["serve", "--weights", "w", "--tokenizer", "t", *flags]))

    assert scope() == (None, 8) and scope("--moe-int8") == ("experts", 8) and scope("--int8") == ("full", 8)
    assert scope("--int4") == scope("--int4", "--int8", "--moe-int8") == ("full", 4)
