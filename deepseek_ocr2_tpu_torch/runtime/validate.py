"""HF-parity transcripts: record and compare every reference fingerprint
(the port's copy of deepseek_ocr2_tpu/runtime/validate.py).

The reference's parity interface is its debug hooks: embedding fingerprints
at positions 0/1/last/289/545 plus global stats, the step-0 top-10 logits
and the per-step token ids. This module turns them into a
machine-checkable transcript:

- `collect_transcript` runs one greedy OCR pass and records the generated
  ids and the numeric fingerprints (embeddings sliced at the reference's
  positions, step-0 top-10 ids / logits) into one JSON-able dict;
- `compare_transcripts` checks a fresh run against a recorded transcript:
  token ids exactly, fingerprints within float tolerance, and names the
  first diverging channel: vision tower / projector / injection (embedding
  fingerprints), LM stack (step-0 logits) or decode loop (token ids);
- a transcript comes from `validate-hf --emit` of either package (the JSON
  is key for key the JAX package's, so each accepts the other's), or from
  a debug-channel stderr log through tools/transcript_from_debug_log.py.

Tolerances: token ids must match exactly (greedy parity is the contract).
Fingerprints default to rtol 5e-3 / atol 1e-4: loose enough for
bf16-vs-f32 tower differences and printed-float truncation, tight enough
that a wrong expert order or mask constant (errors >> 1e-2) always trips.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

TRANSCRIPT_VERSION = 2

# Fingerprint positions the reference dumps: 289 = just
# past the 288 local tokens of a 2-tile crop, 545 = past local+global.
_FP_POSITIONS = (0, 1, 289, 545)
_FP_WIDTH = 16


def embed_fingerprints(embeds: np.ndarray) -> Dict[str, Any]:
    """Fingerprint dict from inputs_embeds [1, S, H] (f32 host array)."""
    data = np.asarray(embeds, np.float32)
    flat = data.reshape(-1)
    nan = int(np.isnan(flat).sum())
    finite = flat[~np.isnan(flat)]
    stats = {
        "nan": nan,
        "min": float(finite.min()) if finite.size else float("nan"),
        "max": float(finite.max()) if finite.size else float("nan"),
        "mean": float(finite.mean()) if finite.size else float("nan"),
    }
    s = data.shape[1]
    positions: Dict[str, List[float]] = {}
    for pos in _FP_POSITIONS:
        if s > pos:
            positions[str(pos)] = data[0, pos, :_FP_WIDTH].tolist()
    positions["last"] = data[0, s - 1, :_FP_WIDTH].tolist()
    return {
        "stats": stats,
        "first16": flat[:_FP_WIDTH].tolist(),
        "positions": positions,
        "seq_len": int(s),
    }


def step0_top10(lm_params, lm_cfg, embeds) -> Dict[str, List]:
    """Step-0 top-10 ids + logits of a prefill of `embeds` [1, S, H] into a
    bf16 cache, as the JAX package's."""
    import torch

    from ..models import deepseek_v2 as dsv2
    from .kv_cache import bucket_capacity, make_kv_cache

    s = embeds.shape[1]
    cache = make_kv_cache(lm_cfg.num_hidden_layers, 1, lm_cfg.num_attention_heads, bucket_capacity(s),
                          lm_cfg.head_dim, dtype=torch.bfloat16, device=embeds.device)
    with torch.no_grad():
        hidden = dsv2.lm_forward(lm_params, lm_cfg, embeds, cache, pos=0, is_prefill=True)
        logits = dsv2.logits_last(lm_params, hidden)[0].float().cpu().numpy()
    order = np.argsort(-np.nan_to_num(logits, nan=-np.inf))[:10]
    return {
        "ids": [int(i) for i in order],
        "logits": [float(logits[i]) for i in order],
    }


def collect_transcript(
    pipe,
    image,
    prompt: Optional[str],
    max_new_tokens: int,
    no_crop: bool,
    rotate: int,
    auto_rotate: bool,
    ngram_size: int,
    eos_token_id: Optional[int],
) -> Dict[str, Any]:
    """One greedy OCR pass of `pipe` (an OCR2Pipeline) -> transcript dict
    (tokens + all fingerprints).

    Computes inputs_embeds once and reuses them for the fingerprints, the
    step-0 logits, and the decode loop, so the recorded channels all come
    from the same forward pass."""
    from ..utils.debug import enabled
    from ..utils.tokenizer import tokenize_with_image

    cfg = pipe.cfg
    prompt = prompt or cfg.default_ocr_prompt
    eos = cfg.eos_token_id if eos_token_id is None else eos_token_id

    image_base, patches, crop_ratio, rotate_used = pipe.preprocess_image(
        image, no_crop=no_crop, rotate=rotate, auto_rotate=auto_rotate
    )
    ids, _, image_start = tokenize_with_image(pipe.tokenizer, prompt, cfg, crop_ratio)
    embeds = pipe.build_ocr_embeds(ids, image_base, patches, image_start)
    embeds_h = embeds.float().cpu().numpy()
    if enabled("DEEPSEEK_DEBUG_OCR"):
        # The stderr log keeps the reference's format, so a validate-hf run
        # is itself parseable by transcript_from_debug_log.
        pipe._debug_embeds_fingerprints(embeds_h)

    result = pipe._generate(embeds, ids, max_new_tokens, ngram_size, eos, None)
    return {
        "version": TRANSCRIPT_VERSION,
        "prompt_len": result.prompt_len,
        "generated_ids": result.token_ids[result.prompt_len :],
        "text": result.text,
        "max_new_tokens": max_new_tokens,
        "ngram_size": ngram_size,
        "no_crop": bool(no_crop),
        "crop_ratio": list(crop_ratio),
        "rotate_used": int(rotate_used),
        "inputs_embeds": embed_fingerprints(embeds_h),
        "step0_top10": step0_top10(pipe.params["lm"], cfg.lm, embeds),
    }


def _close(got: List[float], want: List[float], rtol: float, atol: float) -> Tuple[bool, float]:
    a = np.asarray(got, np.float64)
    b = np.asarray(want, np.float64)
    if a.shape != b.shape:
        return False, float("inf")
    diff = float(np.abs(a - b).max()) if a.size else 0.0
    return bool(np.allclose(a, b, rtol=rtol, atol=atol)), diff


def compare_transcripts(
    got: Dict[str, Any],
    want: Dict[str, Any],
    rtol: float = 5e-3,
    atol: float = 1e-4,
) -> Tuple[bool, List[str]]:
    """(ok, report lines). Tiered transcripts ({"tiers": {bf16|int8|int4:
    transcript}}, from validate-hf --tiers) compare tier-by-tier; a plain
    transcript on either side stands in for its bf16 tier, so a reference-
    binary golden log (always unquantized) still validates a tiered run's
    bf16 tier while the quantized tiers check against their own goldens."""
    if "tiers" in got or "tiers" in want:
        gt = got["tiers"] if "tiers" in got else {"bf16": got}
        wt = want["tiers"] if "tiers" in want else {"bf16": want}
        ok = True
        lines: List[str] = []
        for name, w in wt.items():
            g = gt.get(name)
            if g is None:
                lines.append(f"skip tier {name}: not collected in this run")
                continue
            o, ls = _compare_one(g, w, rtol, atol)
            ok = ok and o
            lines.extend(f"[{name}] {line}" for line in ls)
        for name in gt:
            if name not in wt:
                lines.append(f"skip tier {name}: no golden recorded")
        return ok, lines
    return _compare_one(got, want, rtol, atol)


def _compare_one(
    got: Dict[str, Any],
    want: Dict[str, Any],
    rtol: float = 5e-3,
    atol: float = 1e-4,
) -> Tuple[bool, List[str]]:
    """Single-tier compare. Channels compare in causal order — embeddings,
    then step-0 logits, then token ids — so the FIRST failure names the
    earliest diverging stage. Channels absent from `want` are skipped
    (token-only v1 transcripts and partial reference logs still validate)."""
    lines: List[str] = []
    ok = True

    want_fp = want.get("inputs_embeds")
    got_fp = got.get("inputs_embeds")
    if want_fp and got_fp:
        if "seq_len" in want_fp and want_fp["seq_len"] != got_fp.get("seq_len"):
            ok = False
            lines.append(
                f"FAIL inputs_embeds.seq_len: expected {want_fp['seq_len']}, "
                f"got {got_fp.get('seq_len')} (prompt/injection geometry differs)"
            )
        channels = [("first16", want_fp.get("first16"), got_fp.get("first16"))]
        for pos, vals in (want_fp.get("positions") or {}).items():
            channels.append(
                (f"pos{pos}", vals, (got_fp.get("positions") or {}).get(pos))
            )
        for name, wv, gv in channels:
            if wv is None:
                continue
            if gv is None:
                ok = False
                lines.append(f"FAIL inputs_embeds.{name}: missing in this run")
                continue
            close, diff = _close(gv, wv, rtol, atol)
            if not close:
                ok = False
                lines.append(
                    f"FAIL inputs_embeds.{name}: max |diff| {diff:.3e} "
                    f"(rtol {rtol}, atol {atol})"
                )
        ws, gs = want_fp.get("stats"), got_fp.get("stats")
        if ws and gs:
            if ws.get("nan", 0) != gs.get("nan", 0):
                ok = False
                lines.append(
                    f"FAIL inputs_embeds.stats: nan count {gs.get('nan')} vs "
                    f"expected {ws.get('nan')}"
                )
            close, diff = _close(
                [gs.get(k, np.nan) for k in ("min", "max", "mean")],
                [ws.get(k, np.nan) for k in ("min", "max", "mean")],
                max(rtol, 1e-2),
                max(atol, 1e-3),
            )
            if not close:
                ok = False
                lines.append(f"FAIL inputs_embeds.stats: min/max/mean off by {diff:.3e}")

    want_t10 = want.get("step0_top10")
    got_t10 = got.get("step0_top10")
    if want_t10 and got_t10:
        if list(want_t10.get("ids", [])) != list(got_t10.get("ids", [])):
            ok = False
            lines.append(
                f"FAIL step0_top10.ids: expected {want_t10.get('ids')}, "
                f"got {got_t10.get('ids')}"
            )
        elif want_t10.get("logits"):
            close, diff = _close(
                got_t10.get("logits", []), want_t10["logits"], max(rtol, 1e-2), max(atol, 1e-2)
            )
            if not close:
                ok = False
                lines.append(f"FAIL step0_top10.logits: max |diff| {diff:.3e}")

    want_ids = want.get("generated_ids")
    if want_ids is not None:
        got_ids = got.get("generated_ids", [])
        n = min(len(want_ids), len(got_ids))
        diverge = next((i for i in range(n) if want_ids[i] != got_ids[i]), None)
        if diverge is None and len(want_ids) == len(got_ids):
            lines.append(f"tokens: exact ({len(got_ids)} tokens)")
        else:
            if diverge is None:
                diverge = n
            ok = False
            lines.append(
                f"FAIL: diverges at generated position {diverge} "
                f"(expected {want_ids[diverge] if diverge < len(want_ids) else '<end>'}, "
                f"got {got_ids[diverge] if diverge < len(got_ids) else '<end>'}); "
                f"lengths {len(want_ids)} vs {len(got_ids)}"
            )
    return ok, lines


def load_transcript(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)
