"""The port's validate-hf harness and `convert`, against the JAX package's.

- Transcripts cross over: a port transcript PASSes the JAX package's
  `compare_transcripts` and a JAX transcript the port's (tiny weights, f32,
  a no-crop and a crop page), key for key the same JSON.
- The port CLI's cycle, in-process: emit, re-validate PASS (rc 0); a
  perturbed lm_head FAILs (rc 1) at step0_top10 and the tokens, not at the
  embeddings; a perturbed projector on a crop page FAILs at the embedding
  fingerprints; `--tiers bf16,int8,int4` emits and re-validates PASS per
  tier; a debug-channel stderr log of the port turns into a transcript
  (tools/transcript_from_debug_log.py) that PASSes.
- `convert` writes the same tensors, dtypes and bits as the JAX CLI's.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
from deepseek_ocr2_tpu.runtime import validate as jvalidate
from deepseek_ocr2_tpu.runtime.pipeline import OCR2Pipeline as JaxPipeline
from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config
from deepseek_ocr2_tpu_torch.io import DtypePolicy, load_flat, save_flat
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.runtime import validate as tvalidate
from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

import reference_torch_vision as refv

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The JAX cycle test's assets: tiny checkpoint, an lm_head-perturbed
    and a projector-perturbed copy, config, tokenizer, a no-crop and a crop
    page."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    d = tmp_path_factory.mktemp("validate_hf_torch")
    cfg = dataclasses.replace(tiny_ocr2_config(), image_token_id=500)
    (d / "tiny_config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    flat = refv.random_ocr2_flat(cfg, seed=21)
    save_flat(flat, str(d / "tiny.safetensors"))
    rng = np.random.default_rng(0)
    bad = {k: (v + rng.standard_normal(v.shape).astype(np.float32)).astype(v.dtype) if "lm_head" in k else v
           for k, v in flat.items()}
    save_flat(bad, str(d / "tiny_bad.safetensors"))
    badvis = {k: (v + 0.5 * rng.standard_normal(v.shape).astype(np.float32)).astype(v.dtype)
              if "projector" in k else v for k, v in flat.items()}
    save_flat(badvis, str(d / "tiny_badvis.safetensors"))
    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(d / "tokenizer.json"))
    Image.fromarray(rng.integers(0, 256, (120, 160, 3), np.uint8)).save(d / "page.png")
    Image.fromarray(rng.integers(0, 256, (300, 500, 3), np.uint8)).save(d / "page_crop.png")  # crop grid (3, 2)
    return d, cfg, flat, tok


@pytest.fixture(autouse=True)
def _no_debug_env(monkeypatch):
    """validate-hf sets DEEPSEEK_DEBUG_OCR in the process: undone after each test."""
    for ch in ("OCR", "TOPK", "TOKENS", "VISION", "ATTN", "MOE", "LAYER0"):
        monkeypatch.delenv(f"DEEPSEEK_DEBUG_{ch}", raising=False)


def _collect(mod, pipe, image, no_crop):
    return mod.collect_transcript(pipe, image, prompt=None, max_new_tokens=8, no_crop=no_crop, rotate=0,
                                  auto_rotate=False, ngram_size=3, eos_token_id=None)


@pytest.mark.parametrize("page,no_crop", [("page.png", True), ("page_crop.png", False)])
def test_transcripts_cross_validate_with_jax(assets, page, no_crop):
    d, cfg, flat, tok = assets
    params, report = tocr2.params_from_flat(flat, cfg)
    report.raise_on_errors()
    port = _collect(tvalidate, OCR2Pipeline(params, cfg, tok, device="cpu"), str(d / page), no_crop)
    jparams, jreport = jocr2.params_from_flat(flat, cfg)
    jreport.raise_on_errors()
    jpipe = JaxPipeline(jax.tree_util.tree_map(jnp.asarray, jparams), cfg, tok, kv_dtype="float32",
                        act_dtype="float32")
    want = json.loads(json.dumps(_collect(jvalidate, jpipe, str(d / page), no_crop)))
    got = json.loads(json.dumps(port))
    assert set(got) == set(want)
    assert set(got["inputs_embeds"]) == set(want["inputs_embeds"])
    assert set(got["inputs_embeds"]["positions"]) == set(want["inputs_embeds"]["positions"])
    assert got["crop_ratio"] == want["crop_ratio"] and (got["crop_ratio"] == [1, 1]) == no_crop
    assert len(got["generated_ids"]) > 0
    ok, lines = jvalidate.compare_transcripts(got, want)
    assert ok, lines
    ok, lines = tvalidate.compare_transcripts(want, got)
    assert ok, lines
    assert tvalidate.TRANSCRIPT_VERSION == jvalidate.TRANSCRIPT_VERSION == got["version"]


def test_compare_transcripts_reports_as_jax():
    """The compare half is the JAX package's: the same verdict and lines on
    tiered, plain, missing-tier and perturbed transcripts."""
    rng = np.random.default_rng(4)
    t = {"version": 2, "prompt_len": 9, "generated_ids": [5, 6, 7],
         "inputs_embeds": {"stats": {"nan": 0, "min": -1.0, "max": 1.0, "mean": 0.01},
                           "first16": rng.standard_normal(16).tolist(), "seq_len": 300,
                           "positions": {"0": rng.standard_normal(16).tolist(), "289": rng.standard_normal(16).tolist(),
                                         "last": rng.standard_normal(16).tolist()}},
         "step0_top10": {"ids": list(range(10)), "logits": np.linspace(3, 1, 10).tolist()}}
    shifted = json.loads(json.dumps(t))
    shifted["inputs_embeds"]["positions"]["289"][3] += 0.1
    short = {**t, "generated_ids": [5, 6]}
    cases = [(t, t), (shifted, t), (short, t), ({"tiers": {"bf16": t, "int8": short}}, t),
             ({"tiers": {"bf16": t}}, {"tiers": {"bf16": t, "int4": t}}), (t, {"generated_ids": [5, 6, 7]})]
    for got, want in cases:
        assert tvalidate.compare_transcripts(got, want) == jvalidate.compare_transcripts(got, want)
        assert tvalidate.compare_transcripts(got, want, rtol=1e-6, atol=1e-7) == \
            jvalidate.compare_transcripts(got, want, rtol=1e-6, atol=1e-7)


def _validate_hf(assets, weights, extra, image="page.png", crop=False):
    from deepseek_ocr2_tpu_torch.cli import main

    d = assets[0]
    return main(["validate-hf", "--backend", "cpu", "--weights", str(d / weights), "--tokenizer",
                 str(d / "tokenizer.json"), "--config", str(d / "tiny_config.json"), "--image", str(d / image),
                 "--max-new-tokens", "10", "--lm-dtype", "float32", "--vision-dtype", "float32",
                 *([] if crop else ["--no-crop"]), *extra])


def test_cli_emit_pass_then_perturbed_lm_head_fails(assets, capsys):
    d = assets[0]
    transcript = d / "transcript.json"
    assert _validate_hf(assets, "tiny.safetensors", ["--emit", str(transcript)]) == 0
    recorded = json.loads(transcript.read_text())
    assert len(recorded["generated_ids"]) > 0
    assert "first16" in recorded["inputs_embeds"] and "0" in recorded["inputs_embeds"]["positions"]
    assert len(recorded["step0_top10"]["ids"]) == 10
    capsys.readouterr()

    assert _validate_hf(assets, "tiny.safetensors", ["--expected", str(transcript)]) == 0
    assert "PASS: token-exact" in capsys.readouterr().out

    assert _validate_hf(assets, "tiny_bad.safetensors", ["--expected", str(transcript)]) == 1
    out = capsys.readouterr().out
    assert "FAIL: diverges at generated position" in out, out
    assert "FAIL step0_top10" in out, out
    assert "FAIL inputs_embeds" not in out, out
    # --lookup-decode is ignored, with the JAX CLI's note.
    assert _validate_hf(assets, "tiny.safetensors", ["--expected", str(transcript), "--lookup-decode", "4"]) == 0
    assert "--lookup-decode is ignored" in capsys.readouterr().err


def test_cli_crop_cycle_catches_projector_at_embeddings(assets, capsys):
    d = assets[0]
    transcript = d / "transcript_crop.json"
    assert _validate_hf(assets, "tiny.safetensors", ["--emit", str(transcript)], image="page_crop.png", crop=True) == 0
    recorded = json.loads(transcript.read_text())
    assert recorded["crop_ratio"] != [1, 1] and recorded["inputs_embeds"]["seq_len"] > 16
    assert _validate_hf(assets, "tiny.safetensors", ["--expected", str(transcript)], image="page_crop.png",
                        crop=True) == 0
    capsys.readouterr()
    assert _validate_hf(assets, "tiny_badvis.safetensors", ["--expected", str(transcript)], image="page_crop.png",
                        crop=True) == 1
    out = capsys.readouterr().out
    assert "FAIL inputs_embeds" in out, out


def test_cli_tiers_cycle(assets, capsys):
    d = assets[0]
    transcript = d / "transcript_tiers.json"
    assert _validate_hf(assets, "tiny.safetensors", ["--tiers", "bf16,int8,int4", "--emit", str(transcript)]) == 0
    recorded = json.loads(transcript.read_text())
    assert set(recorded["tiers"]) == {"bf16", "int8", "int4"}
    for name, t in recorded["tiers"].items():
        assert t["tier"] == name and len(t["generated_ids"]) > 0 and len(t["step0_top10"]["ids"]) == 10
    capsys.readouterr()
    assert _validate_hf(assets, "tiny.safetensors", ["--tiers", "bf16,int8,int4", "--expected", str(transcript)]) == 0
    out = capsys.readouterr().out
    for name in ("bf16", "int8", "int4"):
        assert f"[{name}] tokens: exact" in out, out
    assert _validate_hf(assets, "tiny.safetensors", ["--tiers", "bf16,int3"]) == 2


def test_debug_log_parses_to_passing_transcript(assets, capsys, monkeypatch):
    """The port's debug-channel stderr -> transcript_from_debug_log -> PASS."""
    d = assets[0]
    for ch in ("OCR", "TOPK", "TOKENS"):
        monkeypatch.setenv(f"DEEPSEEK_DEBUG_{ch}", "1")
    capsys.readouterr()
    assert _validate_hf(assets, "tiny.safetensors", []) == 0
    err = capsys.readouterr().err
    assert "debug: inputs_embeds fingerprint=" in err and "debug: step0 top10 ids=" in err
    assert "debug: step0 next_id=" in err
    log = d / "debug_run.log"
    log.write_text(err)
    parsed = d / "transcript_from_log.json"
    tool = subprocess.run([sys.executable, str(REPO / "tools" / "transcript_from_debug_log.py"), str(log), "-o",
                           str(parsed)], capture_output=True, text=True, timeout=120)
    assert tool.returncode == 0, tool.stdout + tool.stderr
    t = json.loads(parsed.read_text())
    assert {"generated_ids", "inputs_embeds", "step0_top10"} <= set(t)
    for ch in ("TOPK", "TOKENS"):
        monkeypatch.delenv(f"DEEPSEEK_DEBUG_{ch}")
    assert _validate_hf(assets, "tiny.safetensors", ["--expected", str(parsed)]) == 0
    assert "PASS: token-exact" in capsys.readouterr().out


def test_convert_matches_jax_cli(assets, tmp_path):
    """`convert --dtype bf16 --keep-f32-prefix ...` of both CLIs: the same
    names, dtypes and bits."""
    from deepseek_ocr2_tpu.cli import main as jax_main
    from deepseek_ocr2_tpu_torch.cli import main

    d = assets[0]
    flags = ["--weights", str(d / "tiny.safetensors"), "--dtype", "bf16", "--keep-f32-prefix", "model.projector",
             "--keep-f32-prefix", "model.sam_model.blocks.0."]
    assert main(["convert", "--out", str(tmp_path / "port.safetensors"), *flags]) == 0
    assert jax_main(["convert", "--out", str(tmp_path / "jax.safetensors"), *flags]) == 0
    got = load_flat(str(tmp_path / "port.safetensors"), DtypePolicy(default=None))
    want = load_flat(str(tmp_path / "jax.safetensors"), DtypePolicy(default=None))
    assert set(got) == set(want) == set(load_flat(str(d / "tiny.safetensors"), DtypePolicy(default=None)))
    dtypes = set()
    for name, t in got.items():
        w = want[name]
        assert t.dtype == w.dtype and t.shape == w.shape, name
        assert torch.equal(t.view(torch.uint8) if t.dtype.is_floating_point else t,
                           w.view(torch.uint8) if w.dtype.is_floating_point else w), name
        dtypes.add((name.startswith(("model.projector", "model.sam_model.blocks.0.")), t.dtype))
    assert dtypes == {(True, torch.float32), (False, torch.bfloat16)}
    assert os.path.getsize(tmp_path / "port.safetensors") < os.path.getsize(d / "tiny.safetensors")
