"""Env-var-gated debug channels (the port's copy of
deepseek_ocr2_tpu/utils/debug.py) — the HF-parity debugging interface.

Mirrors the reference's debug hooks (SURVEY.md C16): stat dumps keyed by the
same env var names (DEEPSEEK_DEBUG_VISION, DEEPSEEK_DEBUG_ATTN,
DEEPSEEK_DEBUG_MOE, DEEPSEEK_DEBUG_TOPK, DEEPSEEK_DEBUG_TOKENS,
DEEPSEEK_DEBUG_OCR). Dumps print nan/min/max/shape/dtype to stderr.
"""

from __future__ import annotations

import json
import os
import re
import sys

import numpy as np


def enabled(channel: str) -> bool:
    return os.environ.get(channel) is not None


def dbg_stats(channel: str, name: str, arr) -> None:
    """Print tensor stats when `channel` is set (reference deepseek_v2.rs:18-43).
    A torch tensor (any device, bf16 included) is read back to the host as
    f32; its dtype prints by the JAX name ("float32", not "torch.float32")."""
    if not enabled(channel):
        return
    if hasattr(arr, "detach"):  # a torch tensor
        dtype = str(arr.dtype).replace("torch.", "")
        a = arr.detach().float().cpu().numpy()
    else:
        dtype = getattr(arr, "dtype", "?")
        a = np.asarray(arr).astype(np.float32)
    nan = int(np.isnan(a).sum())
    finite = a[~np.isnan(a)]
    mn = float(finite.min()) if finite.size else float("nan")
    mx = float(finite.max()) if finite.size else float("nan")
    print(
        f"debug: {name}: nan={nan} min={mn} max={mx} shape={tuple(np.shape(a))} "
        f"dtype={dtype}",
        file=sys.stderr,
    )


def dbg_print(channel: str, msg: str) -> None:
    if enabled(channel):
        print(f"debug: {msg}", file=sys.stderr)


_STATS = re.compile(r"debug: (\S+): nan=(\d+) min=(\S+) max=(\S+) shape=(\(.*\)) dtype=(\S+)$")
_PICKS = re.compile(r"debug: (layer\d+) moe topk_idx\[:4\]=(.*) topk_weight\[:4\]=(.*)$")


def debug_line_gap(lines, ref_lines) -> float:
    """The worst gap between two runs' debug prefill lines: each line's
    exact part (a stat line's name, nan count, shape and dtype; the routing
    counts; the top-k ids) must be equal, and its numbers (min and max;
    the top-k weights) are compared as max |a - b| over the line's largest
    |b|. Raises on a difference in an exact part."""

    def parse(line):
        m = _STATS.match(line)
        if m:
            name, nan, lo, hi, shape, dtype = m.groups()
            return (name, nan, shape, dtype), [float(lo), float(hi)]
        m = _PICKS.match(line)
        if m:
            return (m.group(1), m.group(2)), list(np.ravel(json.loads(m.group(3))))
        return line, []

    if len(lines) != len(ref_lines):
        raise AssertionError(f"debug prefill: {len(lines)} lines against {len(ref_lines)}")
    worst = 0.0
    for line, ref in zip(lines, ref_lines):
        (key, a), (ref_key, b) = parse(line), parse(ref)
        if key != ref_key:
            raise AssertionError(f"debug prefill: {line!r} against {ref!r}")
        if b:
            worst = max(worst, float(np.abs(np.subtract(a, b)).max()) / max(float(np.abs(b).max()), 1e-30))
    return worst
