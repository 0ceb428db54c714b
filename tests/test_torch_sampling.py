"""Sampling in the PyTorch port against the JAX package, on the CPU: JAX's
threefry stream in torch integer ops (`ops/prng.py`), `sample_pick`,
sampled tokens of `greedy_generate`, the group engine and the continuous
engine, and the CLI commands of the slice (`inspect`, `generate-text`,
`debug-rope`, and `generate-ocr --kv-cache int8`'s refusal).

Exactness: keys and random bits are integers and equal exactly, uniform
floats equal exactly (the same bit pattern under the exponent of 1.0).
Gumbel noise is -log(-log(u)) with the port's copy of XLA's CPU log
(`prng.xla_log`; torch's own log differs from XLA's in the last bit for
about a fifth of the inputs), so it equals JAX's noise bit for bit: checked
over all 2^23 values `uniform` can return. Sampled tokens are compared
exactly.
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)
from PIL import Image

from deepseek_ocr2_tpu.configs import tiny_lm_config
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
from deepseek_ocr2_tpu.ops.sampling import greedy_pick as jax_greedy_pick
from deepseek_ocr2_tpu.ops.sampling import sample_pick as jax_sample_pick
from deepseek_ocr2_tpu.runtime.generate import greedy_generate as jax_generate
from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu_torch.io import save_flat
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.ops import prng
from deepseek_ocr2_tpu_torch.ops.sampling import greedy_pick, sample_pick
from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine
from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

from reference_torch import random_lm_flat
import reference_torch_vision as refv

SEEDS = [0, 1, 2**31 - 1, 123456789]


def _words(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_words_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(jk))
    for num in (2, 5):
        np.testing.assert_array_equal(prng.split(tk, num).numpy(), _words(jax.random.split(jk, num)))
    for data in (0, 7, 123456, 2**31 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(), _words(jax.random.fold_in(jk, data)))
    np.testing.assert_array_equal(prng.random_bits(tk, (3, 129)).numpy(), _words(jax.random.bits(jk, (3, 129))))
    # Batched keys, as jax.vmap over keys: bits and per-row fold_in.
    jkeys, tkeys = jax.random.split(jk, 4), prng.split(tk, 4)
    want = jax.vmap(lambda k: jax.random.bits(k, (17,)))(jkeys)
    np.testing.assert_array_equal(prng.random_bits(tkeys, (17,)).numpy(), _words(want))
    data = jnp.arange(4, dtype=jnp.int32) * 1000 + 3
    want = jax.vmap(jax.random.fold_in)(jkeys, data)
    np.testing.assert_array_equal(prng.fold_in(tkeys, torch.from_numpy(np.array(data))).numpy(), _words(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_exact_and_gumbel_within_one_ulp(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(prng.uniform(tk, (4096,)).numpy(), np.asarray(jax.random.uniform(jk, (4096,))))
    want = np.asarray(jax.random.gumbel(jk, (4096,)))
    got = prng.gumbel(tk, (4096,)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_gumbel_transform_bit_equal_to_jax_on_every_uniform():
    """`uniform` returns one of 2^23 values (k 2^-23 for k >= 1, and the
    floor `tiny` for k = 0), so the Gumbel transform is checked on all of
    them: the port's -log(-log(u)) against XLA's under `jax.jit`."""
    k = np.arange(2**23, dtype=np.int32)
    u = np.maximum(np.finfo(np.float32).tiny, (k | 0x3F800000).view(np.float32) - np.float32(1.0))
    want = np.asarray(jax.jit(lambda u: -jnp.log(-jnp.log(u)))(u))
    got = (-prng.xla_log(-prng.xla_log(torch.from_numpy(u)))).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.fixture(scope="module")
def jax_pick():
    """JAX's batched sample_pick, one compile per configuration."""
    cache = {}

    def pick(logits, keys, ban, **cfg):
        key = tuple(sorted(cfg.items()))
        if key not in cache:
            cache[key] = jax.jit(jax.vmap(lambda l, k, m: jax_sample_pick(l, k, m, **cfg)))
        return np.asarray(cache[key](jnp.asarray(logits), keys, jnp.asarray(ban)))

    return pick


@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("top_k", [0, 1, 50])
@pytest.mark.parametrize("temperature", [0.5, 1.3])
def test_sample_pick_matches_jax(jax_pick, temperature, top_k, top_p):
    """17 seeded cases a configuration (204 in all), 3 rows each over 300
    tokens: ties among the largest logits, a fifth of the tokens banned,
    and every third case a row with every token banned (greedy fallback
    over the masked row for top-k / nucleus, as in the JAX package)."""
    rng = np.random.default_rng(int(temperature * 10) + 7 * top_k + int(100 * top_p))
    for case in range(17):
        logits = (rng.standard_normal((3, 300)) * rng.choice([0.5, 3.0])).astype(np.float32)
        logits[:, 5:9] = logits[:, 4:5]  # ties
        ban = rng.random((3, 300)) < 0.2
        if case % 3 == 0:
            ban[1] = True
        seed = int(rng.integers(0, 2**31 - 1))
        cfg = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        want = jax_pick(logits, jax.random.split(jax.random.PRNGKey(seed), 3), ban, **cfg)
        got = sample_pick(torch.from_numpy(logits), prng.split(prng.prng_key(seed), 3), torch.from_numpy(ban), **cfg)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"case {case}")


def test_sample_pick_temperature_zero_is_greedy_and_keeps_ties():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 100)).astype(np.float32)
    ban = rng.random((4, 100)) < 0.3
    keys = prng.split(prng.prng_key(0), 4)
    t = torch.from_numpy
    assert torch.equal(sample_pick(t(logits), keys, t(ban), temperature=0.0), greedy_pick(t(logits), t(ban)))
    want = jax.vmap(jax_greedy_pick)(jnp.asarray(logits), jnp.asarray(ban))
    np.testing.assert_array_equal(greedy_pick(t(logits), t(ban)).numpy(), np.asarray(want))
    # The kept set with ties (tests/test_sampling.py): five tokens tie at
    # the top; top-3 keeps the three lowest indices, as lax.top_k does.
    tied = np.zeros((1, 50), np.float32)
    tied[0, [7, 11, 20, 31, 40]] = 5.0
    seen = set()
    for s in range(60):
        key = prng.prng_key(s)[None]
        tok = int(sample_pick(t(tied), key, temperature=1.0, top_k=3)[0])
        assert tok == int(jax_sample_pick(jnp.asarray(tied[0]), jax.random.PRNGKey(s), temperature=1.0, top_k=3))
        seen.add(tok)
    assert seen == {7, 11, 20}


# ---------------------------------------------------------------------------
# Sampled tokens: generate, the group engine, the continuous engine


SAMPLINGS = [dict(temperature=0.8, top_k=50, top_p=0.9), dict(temperature=1.0)]


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("sampling", SAMPLINGS, ids=["top-k-top-p", "full-vocab"])
def test_greedy_generate_sampled_matches_jax(seed, sampling):
    cfg = tiny_lm_config()
    flat = random_lm_flat(cfg, seed=3)
    jp, _ = jdsv2.params_from_flat(flat, cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    tp, _ = tdsv2.params_from_flat(flat, cfg)
    ids = np.random.default_rng(seed).integers(2, cfg.vocab_size, (2, 6))
    kw = dict(max_new_tokens=12, ngram_size=3, eos_id=1, capacity=32, seed=seed, **sampling)
    tokens, n_gen = jax_generate(jp, cfg, jnp.take(jp["embed"], jnp.asarray(ids), axis=0), jnp.asarray(ids),
                                 kv_dtype="float32", **kw)
    got, got_n = greedy_generate(tp, cfg, tp["embed"][torch.from_numpy(ids)], torch.from_numpy(ids),
                                 kv_dtype=torch.float32, **kw)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(n_gen))
    for r in range(2):
        n = 6 + int(n_gen[r])
        assert got[r, :n].tolist() == np.asarray(tokens)[r, :n].tolist()


def _tiny_tokenizer():
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tok


@pytest.fixture(scope="module")
def pipes():
    from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
    from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline as JaxPipeline

    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    flat = refv.random_ocr2_flat(cfg, seed=21)
    tp, rep = tocr2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    jp, rep = jocr2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    return (JaxPipeline(jp, cfg, _tiny_tokenizer(), kv_dtype="float32", act_dtype="float32"),
            OCR2Pipeline(tp, cfg, _tiny_tokenizer(), device="cpu", kv_dtype="float32", act_dtype="float32"))


def _pages(seed, sizes=((500, 300), (160, 120), (400, 400), (640, 200))):
    rng = np.random.default_rng(seed)
    return [Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)) for w, h in sizes]


@pytest.mark.parametrize("seed", [0, 7])
def test_group_engine_sampled_matches_jax(pipes, seed):
    """Three no-crop pages in chunks of two: chunk i samples with seed + i."""
    from deepseek_ocr2_tpu.runtime.engine import OCR2Engine as JaxEngine

    jpipe, tpipe = pipes
    pages = _pages(seed, [(160, 120)] * 3)
    kw = dict(max_new_tokens=10, ngram_size=3, sampling=dict(temperature=0.8, top_k=50, top_p=0.9, seed=seed))
    want = JaxEngine(jpipe, batch_size=2).run(pages, **kw)
    got = OCR2Engine(tpipe, batch_size=2).run(pages, **kw)
    assert [g.token_ids for g in got] == [w.token_ids for w in want]


@pytest.mark.parametrize("seed", [0, 7])
def test_continuous_engine_sampled_matches_jax(pipes, seed):
    """Four pages on two slots: page i samples with seed + i at each
    position; its first token comes from the admission and is greedy."""
    from deepseek_ocr2_tpu.runtime.continuous import ContinuousOCREngine as JaxContinuous

    jpipe, tpipe = pipes
    pages = _pages(3)
    samp = dict(temperature=0.8, top_k=50, top_p=0.9, seed=seed)
    kw = dict(slots=2, capacity=128, chunk_steps=4)
    want = JaxContinuous(jpipe, **kw).run(pages, max_new_tokens=16, ngram_size=3, sampling=samp)
    got = ContinuousOCREngine(tpipe, **kw).run(pages, max_new_tokens=16, ngram_size=3, sampling=samp)
    assert [g.token_ids for g in got] == [w.token_ids for w in want]
    greedy = ContinuousOCREngine(tpipe, **kw).run(pages, max_new_tokens=16, ngram_size=3)
    assert [g.token_ids[: g.prompt_len + 1] for g in greedy] == [g.token_ids[: g.prompt_len + 1] for g in got]


# ---------------------------------------------------------------------------
# CLI


@pytest.fixture(scope="module")
def lm_assets(tmp_path_factory):
    """An LM-only checkpoint, its config and a word-level tokenizer whose
    words cover the whole vocabulary (so the printed text shows the ids)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    d = tmp_path_factory.mktemp("lm_cli")
    cfg = tiny_lm_config()
    save_flat(random_lm_flat(cfg, seed=5), str(d / "lm.safetensors"))
    (d / "lm_config.json").write_text(json.dumps({"lm": dataclasses.asdict(cfg)}))
    vocab = {f"w{i}": i for i in range(cfg.vocab_size)}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="w2"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(d / "tokenizer.json"))
    return d


def test_cli_inspect_lists_what_jax_lists(lm_assets, capsys):
    from deepseek_ocr2_tpu.cli import main as jax_main
    from deepseek_ocr2_tpu_torch.cli import main

    for take in ("0", "7"):
        args = ["inspect", "--weights", str(lm_assets / "lm.safetensors"), "--take", take]
        assert jax_main(args) == 0
        want = capsys.readouterr().out
        assert main(args) == 0
        assert capsys.readouterr().out == want and "model.embed_tokens.weight\t[512, 64]\tF32" in want


@pytest.mark.parametrize("flags", [["--temperature", "0"], ["--temperature", "0.8", "--seed", "3"]])
def test_cli_generate_text_matches_jax(lm_assets, capsys, flags, monkeypatch, tmp_path):
    from deepseek_ocr2_tpu.cli import main as jax_main
    from deepseek_ocr2_tpu_torch.cli import main

    d = lm_assets
    common = ["--weights", str(d / "lm.safetensors"), "--tokenizer", str(d / "tokenizer.json"), "--config",
              str(d / "lm_config.json"), "--prompt", "w5 w9 w77 w3", "--max-new-tokens", "12", *flags]
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))  # the JAX CLI sets a default in $HOME
    assert jax_main(["generate-text", "--backend", "cpu", *common]) == 0
    want = capsys.readouterr().out
    assert main(["generate-text", "--backend", "cpu", *common]) == 0
    got = capsys.readouterr()
    assert got.out == want and len(want.split()) >= 1 and "tokens" in got.err


def test_cli_debug_rope_prints_the_jax_lines(capsys):
    from deepseek_ocr2_tpu.cli import main as jax_main
    from deepseek_ocr2_tpu_torch.cli import main

    assert jax_main(["debug-rope"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert main(["debug-rope", "--backend", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    arrays = re.compile(r"=\[([^\]]*)\]")
    for g, w in zip(got, want):
        assert arrays.sub("=[]", g) == arrays.sub("=[]", w)  # the same labels and counts
        for a, b in zip(arrays.findall(g), arrays.findall(w)):
            np.testing.assert_allclose(np.array(a.split(), float), np.array(b.split(), float), atol=1e-6)


def test_cli_generate_ocr_refuses_int8_kv_as_jax_does(tmp_path):
    """The contiguous cache of generate-ocr has no int8 kind: the JAX
    package's ValueError, from make_kv_cache."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    from deepseek_ocr2_tpu_torch.cli import main

    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    (tmp_path / "cfg.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    save_flat(refv.random_ocr2_flat(cfg, seed=21), str(tmp_path / "w.safetensors"))
    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(tmp_path / "tok.json"))
    _pages(1, [(160, 120)])[0].save(tmp_path / "page.png")
    with pytest.raises(ValueError, match=r"int8/int8tail KV applies to the paged pool only"):
        main(["generate-ocr", "--backend", "cpu", "--weights", str(tmp_path / "w.safetensors"), "--tokenizer",
              str(tmp_path / "tok.json"), "--config", str(tmp_path / "cfg.json"), "--image",
              str(tmp_path / "page.png"), "--kv-cache", "int8", "--max-new-tokens", "4"])
