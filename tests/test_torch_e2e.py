"""The port's OCR path end to end on the CPU, against the JAX package:
no-crop greedy tokens (f32), bf16-LM logits, the CLI on a no-crop and a crop
page, `serve` (group and continuous engines), the flags `--device-resize`,
`--profile-dir` and `--trim-memory`, and the guarantees that the
port imports neither jax nor anything of the JAX package (over a no-crop
and a crop page, both serving engines and, with int8 weights, a page and
the continuous engine; the int8tail continuous engine sampling, and a sampled
`greedy_generate`, a device-resized crop page's validate transcript) and
never runs on the CPU when a GPU is asked for. Crop mode's
parity with the JAX package is in tests/test_torch_crop.py.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu.io import DtypePolicy as JaxPolicy
from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
from deepseek_ocr2_tpu.runtime.generate import greedy_generate as jax_greedy
from deepseek_ocr2_tpu.runtime.kv_cache import make_kv_cache as jax_make_kv_cache
from deepseek_ocr2_tpu_torch.io import DtypePolicy, save_flat
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate

import reference_torch_vision as refv

REPO = Path(__file__).resolve().parents[1]


def _policy(cls, lm_dtype):
    p = cls(default=lm_dtype)
    for prefix in ("model.sam_model", "model.qwen2_model", "model.projector", "model.view_seperator"):
        p = p.with_prefix(prefix, "float32")
    return p


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_ocr2_config()
    flat = refv.random_ocr2_flat(cfg, seed=11)
    n_img = cfg.image_token_count((1, 1))
    ids = [cfg.bos_token_id, 17] + [cfg.image_token_id % cfg.lm.vocab_size] * n_img + [23, 29]
    base = np.random.default_rng(42).uniform(-1, 1, (1, 3, cfg.base_image_size, cfg.base_image_size))
    return cfg, flat, ids, base.astype(np.float32)


def _jax_embeds(cfg, flat, ids, base, lm_dtype):
    jp = jocr2.params_from_flat({k: _policy(JaxPolicy, lm_dtype).apply(k, v) for k, v in flat.items()}, cfg)[0]
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    return jp, jocr2.ocr_prefill_embeds(jp, cfg, jnp.asarray(ids, jnp.int32)[None], jnp.asarray(base), None, 2)


def _torch_embeds(cfg, flat, ids, base, lm_dtype):
    tp, report = tocr2.params_from_flat(flat, cfg, policy=_policy(DtypePolicy, lm_dtype))
    report.raise_on_errors()
    with torch.no_grad():
        vision = tocr2.encode_views(tp, cfg, torch.from_numpy(base))
        return tp, tocr2.build_inputs_embeds(tp, torch.tensor([ids]), vision, 2)


def test_no_crop_greedy_tokens_match_jax_f32(setup):
    cfg, flat, ids, base = setup
    jp, je = _jax_embeds(cfg, flat, ids, base, "float32")
    tokens, n_gen = jax_greedy(jp["lm"], cfg.lm, je, jnp.asarray(ids, jnp.int32), max_new_tokens=8,
                               ngram_size=3, eos_id=1, capacity=128, kv_dtype="float32")
    want = np.asarray(tokens[0, : len(ids) + int(n_gen[0])]).tolist()

    tp, te = _torch_embeds(cfg, flat, ids, base, "float32")
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4, atol=1e-4)
    tokens, n_gen = greedy_generate(tp["lm"], cfg.lm, te, torch.tensor(ids), max_new_tokens=8,
                                    ngram_size=3, eos_id=1, capacity=128, kv_dtype=torch.float32)
    assert tokens[0, : len(ids) + int(n_gen[0])].tolist() == want


def test_no_crop_bf16_lm_logits_match_jax(setup):
    """LM weights and embeddings in bf16, vision f32 (the CLI defaults). Both
    sides round to bf16 at the same points, but one f32 sum that lands on
    the other side of a rounding boundary moves a bf16 activation by an ulp
    (2^-8 relative) and the LM's layers carry that on. The step-0 logits
    (bf16, like the JAX ones) differ by one bf16 ulp of the largest logit
    on this input (seeds 11-13 alike); the bound is 4 x 2^-8 of the
    largest logit, two to four ulps."""
    cfg, flat, ids, base = setup
    lm = cfg.lm
    jp, je = _jax_embeds(cfg, flat, ids, base, "bfloat16")
    cache = jax_make_kv_cache(lm.num_hidden_layers, 1, lm.num_attention_heads, 128, lm.head_dim, jnp.float32)
    hidden, _ = jdsv2.lm_forward(jp["lm"], lm, je, cache, pos=0, is_prefill=True)
    want = np.asarray(jdsv2.logits_last(jp["lm"], hidden).astype(jnp.float32))

    tp, te = _torch_embeds(cfg, flat, ids, base, "bfloat16")
    assert te.dtype == torch.bfloat16
    stats = {}
    greedy_generate(tp["lm"], lm, te, torch.tensor(ids), max_new_tokens=1, capacity=128,
                    kv_dtype=torch.float32, stats=stats)
    got = stats["logits0"].numpy()
    assert np.abs(got - want).max() <= 4 * 2.0**-8 * np.abs(want).max()


@pytest.fixture(scope="module")
def cli_assets(tmp_path_factory):
    """The tiny CLI assets of the verify recipe: checkpoint, config,
    word-level tokenizer and a small page."""
    from PIL import Image
    from tokenizers import Tokenizer, models, pre_tokenizers

    d = tmp_path_factory.mktemp("clitest")
    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    (d / "tiny_config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    save_flat(refv.random_ocr2_flat(cfg, seed=21), str(d / "tiny.safetensors"))
    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(d / "tokenizer.json"))
    rng = np.random.default_rng(3)
    Image.fromarray(rng.integers(0, 256, (120, 160, 3), np.uint8)).save(d / "page.png")
    # A side above the tiny config's crop size (192): crop mode, grid (3, 2).
    Image.fromarray(rng.integers(0, 256, (300, 500, 3), np.uint8)).save(d / "page_crop.png")
    return d


def test_cli_generate_ocr_runs(cli_assets, capsys):
    from deepseek_ocr2_tpu_torch.cli import main

    d = cli_assets
    rc = main([
        "generate-ocr", "--backend", "cpu", "--weights", str(d / "tiny.safetensors"),
        "--tokenizer", str(d / "tokenizer.json"), "--config", str(d / "tiny_config.json"),
        "--image", str(d / "page.png"), "--image-token-id", "500", "--max-new-tokens", "6",
        "--no-repeat-ngram-size", "3",
    ])
    assert rc == 0
    err = capsys.readouterr().err
    assert "missing=0" in err and "tokens" in err


def test_cli_generate_ocr_runs_a_crop_page(cli_assets, capsys):
    from deepseek_ocr2_tpu_torch.cli import main

    d = cli_assets
    rc = main([
        "generate-ocr", "--backend", "cpu", "--weights", str(d / "tiny.safetensors"),
        "--tokenizer", str(d / "tokenizer.json"), "--config", str(d / "tiny_config.json"),
        "--image", str(d / "page_crop.png"), "--image-token-id", "500", "--max-new-tokens", "6",
        "--no-repeat-ngram-size", "3",
    ])
    assert rc == 0
    assert "tokens" in capsys.readouterr().err


@pytest.mark.parametrize("mode", [["--continuous", "--capacity", "128", "--page-size", "16", "--pool-tokens", "160"],
                                  []])
def test_cli_serve_runs(cli_assets, capsys, mode):
    """`serve` over a no-crop and a crop page: the continuous engine with a
    tight pool, and the group engine."""
    from deepseek_ocr2_tpu_torch.cli import main

    d = cli_assets
    rc = main([
        "serve", "--backend", "cpu", "--weights", str(d / "tiny.safetensors"),
        "--tokenizer", str(d / "tokenizer.json"), "--config", str(d / "tiny_config.json"),
        "--images", str(d / "page.png"), str(d / "page_crop.png"), "--batch-size", "2",
        "--max-new-tokens", "6", "--no-repeat-ngram-size", "3", "--vision-dtype", "f32", "--lm-dtype", "f32",
        "--per-page-stats", *mode,
    ])
    assert rc == 0
    out = capsys.readouterr()
    assert out.out.count("=== ") == 2 and "pages/s" in out.err and "tokens]" in out.err


def test_cli_serve_refuses_what_it_cannot_run(cli_assets):
    from deepseek_ocr2_tpu_torch.cli import main

    d = cli_assets
    base = ["serve", "--weights", str(d / "tiny.safetensors"), "--tokenizer", str(d / "tokenizer.json"),
            "--images", str(d / "page.png")]
    tiny = ["--config", str(d / "tiny_config.json"), "--max-new-tokens", "4", "--no-repeat-ngram-size", "3",
            "--vision-dtype", "f32", "--lm-dtype", "f32"]
    # The quantized pools and sampling are ported: these run where they were refused.
    assert main([*base, *tiny, "--backend", "cpu", "--continuous", "--capacity", "128", "--kv-cache", "int8"]) == 0
    assert main([*base, *tiny, "--backend", "cpu", "--temperature", "0.7", "--top-k", "50", "--seed", "3"]) == 0
    with pytest.raises(SystemExit, match="top-p"):
        main([*base, "--backend", "cpu", "--temperature", "0.7", "--top-p", "0"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(base)  # --backend cuda is the default


def test_cli_device_resize_profile_dir_and_trim_memory_run(cli_assets, capsys, tmp_path):
    """The three flags the CLI refused until they were ported now run:
    `--trim-memory` prints its line, `--profile-dir` writes a trace, and
    `--device-resize always` gives the host path's tokens (validate-hf's
    transcript of a crop page, with and without it)."""
    from deepseek_ocr2_tpu_torch.cli import main

    d = cli_assets
    base = ["--backend", "cpu", "--weights", str(d / "tiny.safetensors"), "--tokenizer", str(d / "tokenizer.json"),
            "--config", str(d / "tiny_config.json"), "--image", str(d / "page_crop.png"), "--image-token-id", "500",
            "--max-new-tokens", "6", "--no-repeat-ngram-size", "3"]
    prof = tmp_path / "prof"
    capsys.readouterr()
    assert main(["generate-ocr", *base, "--trim-memory", "--profile-dir", str(prof), "--device-resize", "always",
                 "--lookup-decode", "4"]) == 0
    err = capsys.readouterr().err
    assert "trim-memory: rss_kb" in err and "tokens" in err
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1 and json.loads(traces[0].read_text())["traceEvents"]
    for flags in ([], ["--device-resize", "always"]):
        assert main(["validate-hf", *base, "--emit", str(tmp_path / f"t{len(flags)}.json"), *flags]) == 0
    host, dev = (json.loads((tmp_path / f"t{n}.json").read_text()) for n in (0, 2))
    assert host["crop_ratio"] != [1, 1] and len(host["generated_ids"]) > 0
    assert dev["generated_ids"] == host["generated_ids"]
    assert dev["inputs_embeds"] == host["inputs_embeds"] and dev["step0_top10"] == host["step0_top10"]
    assert main(["generate-text", "--backend", "cpu", "--weights", str(d / "tiny.safetensors"), "--tokenizer",
                 str(d / "tokenizer.json"), "--config", str(d / "tiny_config.json"), "--prompt", "hello",
                 "--max-new-tokens", "3", "--num-hidden-layers", "3", "--trim-memory"]) == 0
    assert "trim-memory: rss_kb" in capsys.readouterr().err
    # generate-ocr's contiguous cache has no int8 kind: the JAX CLI's error.
    with pytest.raises(ValueError, match="int8/int8tail KV applies to the paged pool only"):
        main(["generate-ocr", "--backend", "cpu", "--weights", str(d / "tiny.safetensors"),
              "--tokenizer", str(d / "tokenizer.json"), "--config", str(d / "tiny_config.json"),
              "--image", str(d / "page.png"), "--int8", "--kv-cache", "int8tail", "--max-new-tokens", "2"])


_NO_JAX_SCRIPT = """
import dataclasses, sys
import torch
import deepseek_ocr2_tpu_torch
import deepseek_ocr2_tpu_torch.parallel
import deepseek_ocr2_tpu_torch.parallel.launch
import deepseek_ocr2_tpu_torch.parallel.runs
from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline
import chip_smoke as cs

cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
g = torch.Generator().manual_seed(0)
flat = cs.random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g) * std)
params = cs.load_model(cfg, flat, "cpu", "bfloat16", "float32")
pipe = OCR2Pipeline(params, cfg, cs.StubTokenizer(cfg.lm.vocab_size), device="cpu")
canvas = torch.full((1, 3, cfg.base_image_size, cfg.base_image_size), 127, dtype=torch.uint8)
r = pipe.generate_ocr({"base": canvas.numpy()}, max_new_tokens=4, ngram_size=3)
assert r.new_tokens >= 1 and bool(torch.isfinite(r.logits0).all())
c = cfg.crop_image_size
crops = torch.randint(0, 256, (2, 3, c, c), generator=g, dtype=torch.uint8)
r = pipe.generate_ocr({"base": canvas.numpy(), "patches": crops.numpy(), "ratio": (2, 1)},
                      max_new_tokens=4, ngram_size=3)
assert r.crop_ratio == (2, 1) and r.prompt_len > cfg.image_token_count((2, 1))
assert r.new_tokens >= 1 and bool(torch.isfinite(r.logits0).all())
import os
os.environ.update(DEEPSEEK_DECODE_ATTN="stacked", DEEPSEEK_SAM_WIN_KERNEL="1")  # kernels U and V (twins)
r = pipe.generate_ocr({"base": canvas.numpy()}, max_new_tokens=4, ngram_size=3)
assert r.new_tokens >= 1 and bool(torch.isfinite(r.logits0).all())
del os.environ["DEEPSEEK_DECODE_ATTN"], os.environ["DEEPSEEK_SAM_WIN_KERNEL"]
from deepseek_ocr2_tpu_torch.ops import moe_gmm, paged_attention  # noqa: F401
xs, sizes = moe_gmm.sorted_rows(torch.randn(10, 16), torch.randint(0, 4, (10, 2)), 4, 32)  # kernel W's twins
w = torch.randn(4, 8, 16)
assert moe_gmm.gmm_ffn_visit(xs, w, w, w.transpose(1, 2), moe_gmm.visit_schedule(sizes, 32, 32), 32).shape == (32, 16)
from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine
from deepseek_ocr2_tpu_torch.runtime.http_server import OCRHttpServer  # noqa: F401
pages = [{"base": canvas.numpy()}, {"base": canvas.numpy(), "patches": crops.numpy(), "ratio": (2, 1)}] * 3
group = OCR2Engine(pipe, batch_size=6).run(pages, max_new_tokens=3, ngram_size=3)
cont = ContinuousOCREngine(pipe, slots=6, capacity=256, chunk_steps=2).run(pages, max_new_tokens=3, ngram_size=3)
assert [r.token_ids for r in group] == [r.token_ids for r in cont]
from deepseek_ocr2_tpu_torch import cli  # noqa: F401
from deepseek_ocr2_tpu_torch.models.deepseek_v2 import quantize_lm_params
q8 = OCR2Pipeline({**params, "lm": quantize_lm_params(params["lm"], scope="full")}, cfg,
                  cs.StubTokenizer(cfg.lm.vocab_size), device="cpu")
r = q8.generate_ocr({"base": canvas.numpy()}, max_new_tokens=4, ngram_size=3)
assert r.new_tokens >= 1 and bool(torch.isfinite(r.logits0).all())
cont = ContinuousOCREngine(q8, slots=6, capacity=256, chunk_steps=2).run(pages, max_new_tokens=3, ngram_size=3)
assert all(r.new_tokens >= 1 for r in cont)
q4 = OCR2Pipeline({**params, "lm": quantize_lm_params(params["lm"], scope="full", bits=4)}, cfg,
                  cs.StubTokenizer(cfg.lm.vocab_size), device="cpu")
r = q4.generate_ocr({"base": canvas.numpy()}, max_new_tokens=4, ngram_size=3)
assert r.new_tokens >= 1 and bool(torch.isfinite(r.logits0).all())
cont = ContinuousOCREngine(q4, slots=6, capacity=256, chunk_steps=2).run(pages, max_new_tokens=3, ngram_size=3)
assert all(r.new_tokens >= 1 for r in cont)
tail = OCR2Pipeline(params, cfg, cs.StubTokenizer(cfg.lm.vocab_size), device="cpu", kv_dtype="int8tail")
cont = ContinuousOCREngine(tail, slots=6, capacity=256, chunk_steps=2).run(
    pages, max_new_tokens=3, ngram_size=3, sampling=dict(temperature=0.8, top_k=50, top_p=0.9, seed=1))
assert all(r.new_tokens >= 1 for r in cont)
cont = ContinuousOCREngine(tail, slots=6, capacity=256, chunk_steps=2, lookup_chunk=4).run(
    pages, max_new_tokens=6, ngram_size=3)
assert all(r.new_tokens >= 1 for r in cont)
import numpy as np
from PIL import Image
from deepseek_ocr2_tpu_torch.preprocess import device_resize
from deepseek_ocr2_tpu_torch.runtime import validate
from deepseek_ocr2_tpu_torch.utils.profiling import device_trace
page = Image.fromarray(np.random.default_rng(0).integers(0, 256, (300, 500, 3), np.uint8))  # a crop page
dev_pipe = OCR2Pipeline(params, cfg, cs.StubTokenizer(cfg.lm.vocab_size), device="cpu", device_resize=True)
assert dev_pipe.preprocess_host(page)["mode"] == "device"
with device_trace(None):
    t = validate.collect_transcript(dev_pipe, page, None, 4, False, 0, False, 3, None)
assert validate.compare_transcripts(t, t)[0] and t["crop_ratio"] != [1, 1]
os.environ.update(DEEPSEEK_DEBUG_ATTN="1", DEEPSEEK_DEBUG_MOE="1", DEEPSEEK_DEBUG_LAYER0="1")
assert pipe.generate_ocr(page, max_new_tokens=2, ngram_size=3).new_tokens >= 1
for k in ("DEEPSEEK_DEBUG_ATTN", "DEEPSEEK_DEBUG_MOE", "DEEPSEEK_DEBUG_LAYER0"):
    del os.environ[k]
from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate
from deepseek_ocr2_tpu_torch.runtime import decode_graph  # the captured decode's runner, its wrappers' modules too
assert decode_graph.SYNC_EVERY >= 1 and len(decode_graph.counted_wrappers()) >= 25
ids = torch.tensor([[0, 5, 9], [0, 7, 3]])
toks, n_gen = greedy_generate(params["lm"], cfg.lm, params["lm"]["embed"][ids], ids, max_new_tokens=4, capacity=64,
                              kv_dtype=torch.float32, temperature=0.7, top_p=0.9, seed=2)
assert bool((n_gen >= 1).all())
from deepseek_ocr2_tpu_torch.runtime.train import adamw_train_step, make_optimizer
tx = make_optimizer(lr=1e-3)
state = tx.init(params["lm"])
ids = torch.randint(0, cfg.lm.vocab_size, (3, 200), generator=g)  # 600 rows: the grouped-GEMM Function
losses = [float(adamw_train_step(params["lm"], state, cfg.lm, ids, tx)) for _ in range(2)]
assert all(torch.isfinite(torch.tensor(losses))) and state["count"] == 2
from deepseek_ocr2_tpu_torch.runtime.train import adamw_ocr_train_step, ocr_loss, value_and_grad
n_img = cfg.image_token_count((2, 1))
ids = torch.randint(2, cfg.lm.vocab_size - 20, (1, n_img + 24), generator=g)  # through the towers, uint8 pages
ids[0, 0], ids[0, 1 : 1 + n_img] = cfg.bos_token_id, cfg.image_token_id
mask = torch.zeros(ids.shape)
mask[0, 1 + n_img :] = 1.0
loss, grads = value_and_grad(ocr_loss, params, cfg, ids, canvas, crops[None], 1, mask)
assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(t).all()) for t in grads)
state = tx.init(params)
assert bool(torch.isfinite(adamw_ocr_train_step(params, state, cfg, ids, canvas, crops[None], 1, mask, tx)))
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "deepseek_ocr2_tpu" or m.startswith("deepseek_ocr2_tpu."))
print("JAX_MODULES", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"  # as `one_torch_thread` for the in-process tests
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "JAX_MODULES []" in proc.stdout


def test_no_silent_cpu_run_when_cuda_is_asked_for(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU refusal cannot be observed")
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    cfg, flat, _, _ = setup
    with pytest.raises(RuntimeError, match="cuda"):
        OCR2Pipeline({}, cfg, tokenizer=None, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        tocr2.params_from_flat(flat, cfg, device="cuda")
