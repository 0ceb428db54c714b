"""Prompt-lookup decoding through the port's engines, CLI and HTTP server,
on the CPU at tiny widths (f32), against the JAX package on the same
numpy-seeded weights (tests/test_torch_lookup.py holds the drafts, the
kernels' twins, the chunk steps and `lookup_greedy_generate`).

- The continuous engine with lookup_chunk = 4 against the JAX engine on
  f32 and int8tail pools, through a preemption: tokens,
  `last_lookup_forwards` and preemptions equal; on bf16 and int8 pools
  against the port's plain engine, token for token (tests/test_torch_lookup.py
  holds the chunk step to the JAX package's on all four pools).
- The CLI: `generate-ocr --lookup-decode 4` prints the JAX CLI's text and
  `[lookup-decode: ...]` line; `serve --continuous --lookup-decode 4` on
  the engine test's pages and settings prints the JAX engine's texts and
  the `[lookup: ...]` line its counts give; serve notes that
  `--temperature > 0` turns lookup off.
- `/v1/stats` names `lookup_chunk` and `lookup_forwards`.
Tokens are compared exactly.
"""

import dataclasses
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu_torch.io import save_flat
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
from deepseek_ocr2_tpu_torch.runtime.http_server import OCRHttpServer
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

import reference_torch_vision as refv
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

# Two slots of 80 tokens, 16-token pages and a 128-token pool over four
# no-crop pages (20-token prompts, 48 new tokens; admission reserves 32
# tokens ahead, eight chunk forwards of 4 at the default chunk_steps 32):
# slots grow, and the younger one is preempted and re-admitted. The CLI's
# flags can say all of it.
ENGINE = dict(slots=2, capacity=80, page_size=16, pool_tokens=128, lookup_chunk=4)
GEN = dict(max_new_tokens=48, ngram_size=3)


def _tiny_tokenizer():
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tok


@pytest.fixture(scope="module")
def ocr():
    """(cfg, flat, JAX params, port params, pages): the tiny OCR model in
    f32 and four no-crop pages."""
    from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2

    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    flat = refv.random_ocr2_flat(cfg, seed=21)
    jp, rep = jocr2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    tp, rep = tocr2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    rng = np.random.default_rng(3)
    pages = [Image.fromarray(rng.integers(0, 256, (120, 160, 3), np.uint8)) for _ in range(4)]
    return cfg, flat, jax.tree_util.tree_map(jnp.asarray, jp), tp, pages


def _jax_engine_run(ocr, kv):
    from deepseek_ocr2_tpu.runtime.continuous import ContinuousOCREngine as JaxContinuous
    from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline as JaxPipeline

    cfg, _, jp, _, pages = ocr
    engine = JaxContinuous(JaxPipeline(jp, cfg, _tiny_tokenizer(), kv_dtype=kv, act_dtype="float32"), **ENGINE)
    return engine, engine.run(pages, **GEN)


@pytest.fixture(scope="module")
def jax_f32_run(ocr):
    """The JAX engine on the f32 pool, shared by the engine and CLI tests."""
    return _jax_engine_run(ocr, "float32")


@pytest.mark.parametrize("kv", ["float32", "int8tail"])
def test_continuous_lookup_matches_jax_engine(ocr, jax_f32_run, kv):
    cfg, _, _, tp, pages = ocr
    jengine, want = jax_f32_run if kv == "float32" else _jax_engine_run(ocr, kv)
    engine = ContinuousOCREngine(
        OCR2Pipeline(tp, cfg, _tiny_tokenizer(), device="cpu", kv_dtype=kv, act_dtype="float32"), **ENGINE)
    assert (engine.lookup_steps, engine.dispatch_tokens) == (8, 32)
    got = engine.run(pages, **GEN)
    assert engine.last_preempted >= 1 and engine.last_preempted == jengine.last_preempted
    assert engine.last_lookup_forwards == jengine.last_lookup_forwards > 0
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.token_ids == w.token_ids, (i, w.token_ids[w.prompt_len:], g.token_ids[g.prompt_len:])
    assert engine.alloc.n_free == engine.num_pages - 1


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_continuous_lookup_matches_plain_engine(ocr, kv):
    cfg, _, _, tp, pages = ocr
    pipe = OCR2Pipeline(tp, cfg, _tiny_tokenizer(), device="cpu", kv_dtype=kv, act_dtype="float32")
    plain = ContinuousOCREngine(pipe, **{**ENGINE, "lookup_chunk": 0}).run(pages, **GEN)
    engine = ContinuousOCREngine(pipe, **ENGINE)
    got = engine.run(pages, **GEN)
    assert engine.last_preempted >= 1 and engine.last_lookup_forwards > 0
    assert [g.token_ids for g in got] == [w.token_ids for w in plain]


@pytest.fixture(scope="module")
def cli_assets(tmp_path_factory, ocr):
    cfg, flat, _, _, pages = ocr
    d = tmp_path_factory.mktemp("lookupcli")
    (d / "tiny_config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    save_flat(flat, str(d / "tiny.safetensors"))
    _tiny_tokenizer().save(str(d / "tokenizer.json"))
    for i, page in enumerate(pages):  # PNG is lossless: the CLI reads the engine test's pixels
        page.save(d / f"page{i}.png")
    return d


def _lookup_lines(err: str):
    return [ln for ln in err.splitlines() if ln.startswith("[lookup") or ln.startswith("note: --lookup")]


def test_cli_lookup_matches_jax(cli_assets, jax_f32_run, capsys):
    """generate-ocr: the port's CLI prints the JAX CLI's text and lookup
    line. serve --continuous with the engine test's settings: the JAX
    engine's texts, and its chunk tokens over its forwards."""
    from deepseek_ocr2_tpu.cli import main as jmain
    from deepseek_ocr2_tpu_torch.cli import main as tmain

    d = cli_assets
    common = ["--weights", str(d / "tiny.safetensors"), "--tokenizer", str(d / "tokenizer.json"),
              "--config", str(d / "tiny_config.json"), "--max-new-tokens", str(GEN["max_new_tokens"]),
              "--no-repeat-ngram-size", str(GEN["ngram_size"]), "--vision-dtype", "f32", "--lm-dtype", "f32",
              "--kv-cache", "f32", "--lookup-decode", "4"]
    one = ["generate-ocr", "--image", str(d / "page0.png"), "--image-token-id", "500", *common]
    outs = []
    for main, extra in ((jmain, []), (tmain, ["--backend", "cpu"])):
        assert main([*one, *extra]) == 0
        out = capsys.readouterr()
        outs.append((out.out, _lookup_lines(out.err)))
    assert outs[1] == outs[0] and len(outs[0][1]) == 1, outs

    jengine, want = jax_f32_run
    images = [str(d / f"page{i}.png") for i in range(len(want))]
    serve = ["serve", "--images", *images, "--continuous", "--capacity", str(ENGINE["capacity"]), "--page-size",
             str(ENGINE["page_size"]), "--pool-tokens", str(ENGINE["pool_tokens"]), "--batch-size",
             str(ENGINE["slots"]), *common, "--backend", "cpu"]
    assert tmain(serve) == 0
    out = capsys.readouterr()
    assert out.out == "".join(f"=== {p} ===\n{r.text}\n" for p, r in zip(images, want))
    chunk_tokens = sum(r.new_tokens - 1 for r in want)
    fw = jengine.last_lookup_forwards
    assert _lookup_lines(out.err) == [
        f"[lookup: {chunk_tokens} tokens / {fw} chunk forwards = {chunk_tokens / fw:.2f} tok/forward]"]
    assert tmain([*serve, "--temperature", "0.7", "--seed", "1"]) == 0
    assert _lookup_lines(capsys.readouterr().err) == [
        "note: --lookup-decode requires greedy decoding; ignoring it because --temperature > 0"]


def test_http_stats_name_lookup(ocr):
    cfg, _, _, tp, pages = ocr
    pipe = OCR2Pipeline(tp, cfg, _tiny_tokenizer(), device="cpu", kv_dtype="float32", act_dtype="float32")
    engine = ContinuousOCREngine(pipe, slots=2, capacity=128, lookup_chunk=4).start(ngram_size=3)
    server = OCRHttpServer(engine, port=0).start_background()
    try:
        assert engine.submit(pages[0], max_new_tokens=6).result(timeout=120).new_tokens >= 1
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/v1/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        server.shutdown()
        engine.stop(timeout=60)
    assert stats["lookup_chunk"] == 4 and stats["lookup_forwards"] >= 1
