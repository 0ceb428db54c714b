"""Lookup decoding, the paged pool and the continuous engine on a sharded LM
in the port against the JAX package on the CPU (its tests/test_sharding_q8.py
and its dryrun's step 4b).

The port's cases run in one 8-rank gloo world started once for the module
(`launch.launch(runs.run_cases, ...)`: no rank imports JAX); the JAX side
runs unsharded in this process on its CPU paths. The JAX package's own
tests hold its sharded runs token-exact to its unsharded ones.

- Batched prompt-lookup greedy decode (chunk 3) with int8 "full" params at
  (4, 2): tokens and `n_gen` equal the JAX package's
  `lookup_greedy_generate_batched`.
- `decode_chunk_lookup` (3 forwards of chunk 3, match_n 2) over a fresh
  paged f32 pool of the rank's heads, int8 "full" params at (4, 2): tokens
  and the packed status equal the JAX function's (the dryrun's step 4b);
  the same over bf16 and int8tail pools at (1, 2) equals the port's
  unsharded run (the int8 pools quantize each head's vectors on their own,
  so a pool of the rank's heads needs nothing more).
- The continuous engine (2 slots, chunk_steps 4) on an `OCR2Pipeline`
  whose LM is sharded with `lm_param_specs` at (4, 2), the towers whole,
  every rank on every page: with lookup 0 and 3 the JAX engine's tokens
  on three pages, and `generate_ocr` of one page on the same pipeline the
  engine's tokens of that page;
- the same engine when one rank preprocesses its pages later than the
  idle engine's grace: every rank still admits the same pages (the tokens
  stay the JAX engine's), and online serving is refused.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

sys.path.insert(0, str(Path(__file__).resolve().parent))

import reference_torch_vision as refv  # noqa: E402
from deepseek_ocr2_tpu.configs import tiny_lm_config, tiny_ocr2_config  # noqa: E402
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2  # noqa: E402
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2  # noqa: E402
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2  # noqa: E402
from deepseek_ocr2_tpu_torch.parallel.launch import launch  # noqa: E402
from deepseek_ocr2_tpu_torch.parallel.runs import run_cases  # noqa: E402
from deepseek_ocr2_tpu_torch.runtime.continuous import DecodeState, decode_chunk_lookup  # noqa: E402
from deepseek_ocr2_tpu_torch.runtime.paged_kv import make_paged_kv_cache, pages_for  # noqa: E402

LOOKUP = dict(max_new_tokens=6, ngram_size=3, eos_id=1, capacity=32, chunk=3)
PAGED = dict(n_steps=3, chunk=3, match_n=2, ngram_size=2, eos_id=1)
TOK_CAP, PAGE = 64, 16
ENGINE = dict(slots=2, capacity=128, chunk_steps=4)
RUN = dict(max_new_tokens=6, ngram_size=3)


def _tokenizer():
    from tokenizers import Tokenizer, models as tok_models, pre_tokenizers

    tok = Tokenizer(tok_models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    return tok


def _lm():
    cfg = tiny_lm_config()
    jp = jdsv2.quantize_lm_params(jdsv2.init_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32), scope="full")
    ids = np.random.default_rng(0).integers(2, cfg.vocab_size, (4, 12))
    toks0 = np.zeros((4, TOK_CAP), np.int64)
    toks0[:, :12] = ids
    return cfg, jp, tdsv2.params_from_jax(jp, cfg), ids, toks0


def _ocr():
    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    flat = refv.random_ocr2_flat(cfg, seed=21)
    params, report = tocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    rng = np.random.default_rng(9)
    pages = [rng.integers(0, 256, (120, 160, 3), np.uint8) for _ in range(3)]
    return cfg, flat, params, pages


@pytest.fixture(scope="module")
def world():
    cfg, jp, tp, ids, toks0 = _lm()
    ocr_cfg, flat, ocr_params, pages = _ocr()
    cases = [
        dict(name="lookup", kind="lookup", dp=4, mp=2,
             args=dict(cfg=cfg, params=tp, ids=ids, kv_dtype=torch.float32, **LOOKUP)),
        dict(name="paged f32", kind="paged_lookup", dp=4, mp=2,
             args=dict(cfg=cfg, params=tp, tokens=toks0, cur_len=12, page=PAGE, **PAGED)),
        *[dict(name=f"paged {kv}", kind="paged_lookup", dp=1, mp=2,
               args=dict(cfg=cfg, params=tp, tokens=toks0, cur_len=12, page=PAGE, kv_dtype=dt, **PAGED))
          for kv, dt in (("bf16", torch.bfloat16), ("int8tail", "int8tail"))],
        dict(name="engine", kind="engine", dp=4, mp=2,
             args=dict(cfg=ocr_cfg, params=ocr_params, tokenizer_json=_tokenizer().to_str(), pages=pages,
                       lookups=(0, 3), single=True, **ENGINE, **RUN)),
        dict(name="engine late", kind="engine", dp=1, mp=2,
             args=dict(cfg=ocr_cfg, params=ocr_params, tokenizer_json=_tokenizer().to_str(), pages=pages,
                       lookups=(0,), late_rank=1, late_seconds=0.6, **ENGINE, **RUN)),
    ]
    return (cfg, jp, tp, ids, toks0), (ocr_cfg, flat, pages), launch(run_cases, 8, (cases,))


def test_sharded_batched_lookup_matches_jax(world):
    from deepseek_ocr2_tpu.runtime.generate import lookup_greedy_generate_batched

    (cfg, jp, _, ids, _), _, results = world
    ids_j = jnp.asarray(ids, jnp.int32)
    want_tok, want_n = lookup_greedy_generate_batched(jp, cfg, jnp.take(jp["embed"], ids_j, axis=0), ids_j,
                                                      kv_dtype="float32", **LOOKUP)
    got = results["lookup"]
    assert got["same_on_every_rank"]
    np.testing.assert_array_equal(np.asarray(got["n_gen"]).reshape(-1), np.asarray(want_n).reshape(-1))
    np.testing.assert_array_equal(got["tokens"], np.asarray(want_tok))


def test_sharded_paged_lookup_matches_jax(world):
    from deepseek_ocr2_tpu.runtime.continuous import decode_chunk_lookup as jax_chunk_lookup
    from deepseek_ocr2_tpu.runtime.paged_kv import make_paged_kv_cache as jax_pool

    (cfg, jp, _, _, toks0), _, results = world
    b, n_per = 4, pages_for(TOK_CAP, PAGE)
    pool = jax_pool(cfg.num_hidden_layers, b * n_per + 1, cfg.num_attention_heads, PAGE, cfg.head_dim, jnp.float32)
    tables = jnp.asarray(np.arange(1, b * n_per + 1, dtype=np.int32).reshape(b, n_per))
    out = jax_chunk_lookup(jp, pool, jnp.asarray(toks0, jnp.int32), jnp.full((b,), 12, jnp.int32),
                           jnp.zeros((b,), bool), jnp.full((b,), TOK_CAP, jnp.int32), tables, cfg, **PAGED)
    got = results["paged f32"]
    assert got["same_on_every_rank"]
    np.testing.assert_array_equal(got["tokens"], np.asarray(out[1]))
    np.testing.assert_array_equal(np.asarray(got["status"]), np.asarray(out[4]))


@pytest.mark.parametrize("kv", ["bf16", "int8tail"])
def test_sharded_paged_lookup_on_other_pools_matches_unsharded(world, kv):
    (cfg, _, tp, _, toks0), _, results = world
    b, n_per = 4, pages_for(TOK_CAP, PAGE)
    pool = make_paged_kv_cache(cfg.num_hidden_layers, b * n_per + 1, cfg.num_attention_heads, PAGE, cfg.head_dim,
                               dtype=torch.bfloat16 if kv == "bf16" else kv, slots=b)
    state = DecodeState.empty(b, TOK_CAP, "cpu")
    state.tokens.copy_(torch.as_tensor(toks0))
    state.cur_lens.fill_(12)
    state.done.fill_(False)
    state.limits.fill_(TOK_CAP)
    tables = torch.arange(1, b * n_per + 1, dtype=torch.int32).reshape(b, n_per)
    status = decode_chunk_lookup(tp, cfg, pool, state, tables, rope=tdsv2.rope_consts(cfg, "cpu"), **PAGED)
    got = results[f"paged {kv}"]
    np.testing.assert_array_equal(got["tokens"], state.tokens.numpy())
    np.testing.assert_array_equal(np.asarray(got["status"]), status.numpy())


@pytest.fixture(scope="module")
def jax_engine_tokens(world):
    from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
    from deepseek_ocr2_tpu.runtime.continuous import ContinuousOCREngine
    from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline

    _, (cfg, flat, pages), _ = world
    jparams, report = jocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    pipe = OCR2Pipeline(jax.tree_util.tree_map(jnp.asarray, jparams), cfg, _tokenizer(), kv_dtype="float32",
                        act_dtype="float32")
    return [r.token_ids for r in ContinuousOCREngine(pipe, **ENGINE).run([Image.fromarray(a) for a in pages], **RUN)]


def test_sharded_continuous_engine_matches_jax(world, jax_engine_tokens):
    got, want = world[2]["engine"], jax_engine_tokens
    for lookup in (0, 3):
        assert got[lookup] == want, lookup
    assert got["single"] == want[0]


def test_sharded_engine_admits_alike_when_a_rank_preprocesses_late(world, jax_engine_tokens):
    got = world[2]["engine late"]
    assert got[0] == jax_engine_tokens
    assert "online serving takes an unsharded LM" in got["start"]
