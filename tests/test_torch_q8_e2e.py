"""The port's int8 weight tier end to end on the CPU, at tiny widths in f32,
against the JAX package on the same numpy-seeded weights: the quantized LM's
logits in both scopes, `generate_ocr` with --int8 (no-crop and crop
pages), both serving engines with --int8 (a preemption, and a decode batch
with B * k > E through kernel J's twin), and the CLI (--int8, and
--moe-int8 on both engines).

The logits test runs the JAX package's TPU dispatch of the int8 decode path
(`pallas_enabled()` true at its call-time lookups, the Pallas kernels in
interpret mode), so both packages take the same kernels: kernel I with the
shared pseudo-experts at one row, kernel J above E / k rows, kernel H for
the int8 linears. Only the attention differs: the port's kernel K (the JAX
package's needs head_dim % 128 == 0) against the JAX package's unfused
projections and attention, which agree in f32 (the current token's K/V
round-trip through an f32 cache exactly). Bound: 1e-4 of the largest logit,
for f32 sums taken in another order through the layers.

The token tests run the JAX package's jitted pipeline and engines as they
are on the CPU (its XLA fallbacks): those fold the shared MLP in as a plain
int8 SwiGLU where the port's kernels take the pseudo-experts, whose down
scales are per half. Tokens are compared exactly; on these seeds the
difference never reaches an argmax.
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
from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine
from deepseek_ocr2_tpu_torch.runtime.kv_cache import make_kv_cache
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

import reference_torch as ref
import reference_torch_vision as refv

LOGITS_RTOL = 1e-4


@pytest.fixture
def jax_tpu_dispatch(monkeypatch):
    from deepseek_ocr2_tpu.ops import flash_attention, linear_q8, moe_decode, moe_q8

    monkeypatch.setattr(flash_attention, "pallas_enabled", lambda: True)
    for mod, name in ((linear_q8, "linear_q8"), (moe_q8, "moe_ffn_decode_q8"),
                      (moe_decode, "moe_ffn_decode_q8_fused")):
        monkeypatch.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))


@pytest.mark.parametrize("scope,b", [("experts", 1), ("experts", 5), ("full", 1), ("full", 5)])
def test_quantized_lm_matches_jax(jax_tpu_dispatch, scope, b):
    """Prefill and three decode steps; the JAX run's greedy tokens feed both."""
    cfg = tiny_lm_config(num_hidden_layers=4)
    jparams, _ = jdsv2.params_from_flat(ref.random_lm_flat(cfg, seed=11), cfg)
    jq = jdsv2.quantize_lm_params(jax.tree_util.tree_map(jnp.asarray, jparams), scope=scope)
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
        assert got.dtype == torch.float32  # f32 weights; an int8 lm_head gives f32 logits in any dtype
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= LOGITS_RTOL * np.abs(want).max(), (step, err)
        tok = np.argmax(want, axis=-1)
        jemb = jnp.take(jq["embed"], jnp.asarray(tok, jnp.int32), axis=0)[:, None]
        temb = F.embedding(torch.from_numpy(tok), tq["embed"])[:, None]


def test_quantized_lm_prefill_bf16_matches_jax():
    """`--int8` prefill in bf16 (the CLI's LM dtype) against the JAX package
    on the same bf16 weights and codes. The int8 projections keep their
    product in f32 before the scale, as XLA does; with the product rounded
    to bf16 first these logits were 7.4e-3 of the largest apart. Bound:
    1e-3 of the largest logit."""
    cfg = tiny_lm_config(num_hidden_layers=4)
    jparams, _ = jdsv2.params_from_flat(ref.random_lm_flat(cfg, seed=11), cfg)
    jparams = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16 if np.issubdtype(np.asarray(a).dtype, np.floating) else None),
        jparams)
    jq = jdsv2.quantize_lm_params(jparams, scope="full")
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


def test_fused_attention_switch_changes_nothing_in_f32(monkeypatch):
    """DEEPSEEK_FUSED_ATTN=0 (the JAX package's ablation switch) takes the
    unfused int8 decode attention; in f32 it gives K's logits."""
    cfg = tiny_lm_config()
    jparams, _ = jdsv2.params_from_flat(ref.random_lm_flat(cfg, seed=12), cfg)
    tq = tdsv2.quantize_lm_params(tdsv2.params_from_jax(jparams, cfg), scope="full")
    emb = F.embedding(torch.arange(2, 10)[None], tq["embed"])

    def run():
        cache = make_kv_cache(cfg.num_hidden_layers, 1, cfg.num_attention_heads, 16, cfg.head_dim,
                              dtype=torch.float32)
        tdsv2.lm_forward(tq, cfg, emb, cache, pos=0, is_prefill=True)
        return tdsv2.logits_last(tq, tdsv2.lm_forward(tq, cfg, emb[:, :1], cache, pos=8, is_prefill=False))

    fused = run()
    monkeypatch.setenv("DEEPSEEK_FUSED_ATTN", "0")
    torch.testing.assert_close(run(), fused, rtol=1e-5, atol=1e-5 * float(fused.abs().max()))


# ---------------------------------------------------------------------------
# Pages and engines


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
    return cfg, flat, params


def _pipes(setup, scope):
    """(JAX pipeline, port pipeline) on the same weights, LM int8."""
    from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
    from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline as JaxPipeline

    cfg, flat, params = setup
    jparams, report = jocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    jparams["lm"] = jdsv2.quantize_lm_params(jparams["lm"], scope=scope)
    tparams = {**params, "lm": tdsv2.quantize_lm_params(params["lm"], scope=scope)}
    jpipe = JaxPipeline(jparams, cfg, _tiny_tokenizer(), kv_dtype="float32", act_dtype="float32")
    tpipe = OCR2Pipeline(tparams, cfg, _tiny_tokenizer(), device="cpu", kv_dtype="float32", act_dtype="float32")
    return jpipe, tpipe


@pytest.fixture(scope="module")
def int8_pipes(setup):
    return _pipes(setup, "full")


def _pages(sizes, seed):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)) for w, h in sizes]


@pytest.mark.parametrize("size", [(160, 120), (500, 300)])  # no crop; crop grid (3, 2)
def test_generate_ocr_int8_matches_jax(int8_pipes, size):
    jpipe, tpipe = int8_pipes
    page = _pages([size], seed=5)[0]
    want = jpipe.generate_ocr(page, max_new_tokens=12, ngram_size=3)
    got = tpipe.generate_ocr(page, max_new_tokens=12, ngram_size=3)
    assert got.prompt_len == want.prompt_len
    assert got.token_ids == want.token_ids and got.text == want.text


def test_group_engine_int8_matches_jax(int8_pipes):
    """Six no-crop pages decode in one chunk at B = 6 (B * k = 12 > E = 8:
    kernel J's twin, K's for the attention), the crop page in a chunk of
    its own (kernel I with the pseudo-experts)."""
    from deepseek_ocr2_tpu.runtime.engine import OCR2Engine as JaxEngine

    jpipe, tpipe = int8_pipes
    pages = _pages([(160, 120)] * 6 + [(500, 300)], seed=8)
    want = JaxEngine(jpipe, batch_size=6).run(pages, max_new_tokens=8, ngram_size=3)
    got = OCR2Engine(tpipe, batch_size=6).run(pages, max_new_tokens=8, ngram_size=3)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.token_ids == w.token_ids, (i, w.token_ids, g.token_ids)


def test_continuous_engine_int8_matches_jax(int8_pipes):
    """Six slots decode at B * k = 12 > E (kernel J's twin; H for the int8
    projections around G)."""
    from deepseek_ocr2_tpu.runtime.continuous import ContinuousOCREngine as JaxContinuous

    jpipe, tpipe = int8_pipes
    pages = _pages([(500, 300), (160, 120), (400, 400), (640, 200), (160, 120), (300, 200)], seed=3)
    kw = dict(slots=6, capacity=128, chunk_steps=4)
    want = JaxContinuous(jpipe, **kw).run(pages, max_new_tokens=8, ngram_size=3)
    got = ContinuousOCREngine(tpipe, **kw).run(pages, max_new_tokens=8, ngram_size=3)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.token_ids == w.token_ids, (i, w.token_ids, g.token_ids)


def test_continuous_int8_preemption_token_exact(int8_pipes):
    """A pool that makes both slots grow and the younger one preempt: the
    re-admitted page gives the single page's tokens (which
    test_generate_ocr_int8_matches_jax holds to the JAX package)."""
    _, tpipe = int8_pipes
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

    from tokenizers import Tokenizer, models, pre_tokenizers

    from deepseek_ocr2_tpu_torch.io import save_flat

    cfg, flat, _ = setup
    d = tmp_path_factory.mktemp("clitest_q8")
    (d / "tiny_config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    save_flat(flat, str(d / "tiny.safetensors"))
    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(d / "tokenizer.json"))
    for name, page in zip(("page.png", "page_crop.png"), _pages([(160, 120), (500, 300)], seed=6)):
        page.save(d / name)
    return d


def _base(d, command):
    return [command, "--backend", "cpu", "--weights", str(d / "tiny.safetensors"), "--tokenizer",
            str(d / "tokenizer.json"), "--config", str(d / "tiny_config.json"), "--max-new-tokens", "6",
            "--no-repeat-ngram-size", "3", "--vision-dtype", "f32", "--lm-dtype", "f32"]


def test_cli_generate_ocr_int8(cli_assets, capsys):
    from deepseek_ocr2_tpu_torch.cli import main

    d = cli_assets
    assert main([*_base(d, "generate-ocr"), "--image", str(d / "page_crop.png"), "--image-token-id", "500",
                 "--int8"]) == 0
    err = capsys.readouterr().err
    assert "int8: LM weights quantized (scope=full)" in err and "tokens" in err


@pytest.mark.parametrize("mode", [["--continuous", "--capacity", "128", "--page-size", "16"], []])
def test_cli_serve_moe_int8(cli_assets, capsys, mode):
    from deepseek_ocr2_tpu_torch.cli import main

    d = cli_assets
    assert main([*_base(d, "serve"), "--images", str(d / "page.png"), str(d / "page_crop.png"),
                 "--batch-size", "2", "--moe-int8", *mode]) == 0
    out = capsys.readouterr()
    assert "scope=experts" in out.err and out.out.count("=== ") == 2 and "pages/s" in out.err


@pytest.mark.parametrize("flags,named", [(["--kv-cache", "int8"], "--kv-cache int8"),
                                         (["--int8", "--kv-cache", "int8tail"], "--kv-cache int8")])
def test_cli_refuses_the_next_slice_by_name(cli_assets, capsys, flags, named):
    """The quantized pools are ported: `serve --continuous` takes them (with
    and without int8 weights) where it refused them by name."""
    from deepseek_ocr2_tpu_torch.cli import main

    d = cli_assets
    assert main([*_base(d, "serve"), "--images", str(d / "page.png"), str(d / "page_crop.png"), "--continuous",
                 "--capacity", "128", "--page-size", "16", "--batch-size", "2", *flags]) == 0
    out = capsys.readouterr()
    assert out.out.count("=== ") == 2 and "pages/s" in out.err and named.split()[0] not in out.err
