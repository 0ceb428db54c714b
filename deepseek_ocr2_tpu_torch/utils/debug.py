"""Env-var-gated debug channels (the port's copy of
deepseek_ocr2_tpu/utils/debug.py) — the HF-parity debugging interface.

Mirrors the reference's debug hooks (SURVEY.md C16): stat dumps keyed by the
same env var names (DEEPSEEK_DEBUG_VISION, DEEPSEEK_DEBUG_ATTN,
DEEPSEEK_DEBUG_MOE, DEEPSEEK_DEBUG_TOPK, DEEPSEEK_DEBUG_TOKENS,
DEEPSEEK_DEBUG_OCR). Dumps print nan/min/max/shape/dtype to stderr.
"""

from __future__ import annotations

import os
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
