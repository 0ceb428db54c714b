#!/usr/bin/env python3
"""Where one decode chunk of the continuous engine spends its time, on one GPU.

    python3 scripts/torch_serve_profile.py [--slots 16] [--steps 32] [--kv float32]

Builds the full-width model with random weights (as chip_smoke.py does: LM
bf16, vision f32), fills a paged pool for `--slots` rows at prompt-like
lengths (260 to 700 tokens, the no-crop and 2-crop prompts), runs one
warm-up chunk, then profiles one `decode_chunk` of `--steps` steps with
torch.profiler: host wall time, summed device kernel time, the device idle
share (1 - kernel time / wall time) and the kernels that take the most
device time, kernels F and G among them. The pool's contents are random:
the kernels' times depend on the lengths, not on the values. Print the
numbers with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402
from torch_page_profile import profiled, report  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--kv", choices=["float32", "bfloat16"], default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import rope_consts
    from deepseek_ocr2_tpu_torch.ops.moe_decode import moe_ffn_decode_fused
    from deepseek_ocr2_tpu_torch.ops.paged_attention import paged_decode_attention_pool
    from deepseek_ocr2_tpu_torch.runtime.continuous import DecodeState, decode_chunk
    from deepseek_ocr2_tpu_torch.runtime.paged_kv import make_paged_kv_cache, pages_for

    dev = torch.device("cuda", 0)
    print("[device]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    cfg = OCR2Config()
    lm = cfg.lm
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flat = cs.random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    params = cs.load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype="float32")["lm"]
    del flat

    b, page, cap = args.slots, 128, 1024
    per_row = pages_for(cap, page)
    pool = make_paged_kv_cache(lm.num_hidden_layers, b * per_row + 1, lm.num_attention_heads, page, lm.head_dim,
                               dtype=getattr(torch, args.kv), device=dev)
    pool["k"].normal_(generator=g)
    pool["v"].normal_(generator=g)
    state = DecodeState.empty(b, cap, dev)
    state.tokens.random_(2, lm.vocab_size, generator=g)
    lens = torch.linspace(260, 700, b, device=dev).round().to(torch.int32)
    state.cur_lens.copy_(lens)
    state.done.zero_()
    state.limits.fill_(cap)
    tables = torch.arange(1, b * per_row + 1, dtype=torch.int32, device=dev).reshape(b, per_row)
    chunk = dict(n_steps=args.steps, ngram_size=20, eos_id=-1, rope=rope_consts(lm, dev))
    decode_chunk(params, lm, pool, state, tables, **chunk)  # warm-up: builds the kernels
    state.cur_lens.copy_(lens)
    print(f"[chunk] {b} slots, lengths {int(lens[0])}..{int(lens[-1])}, {args.steps} steps, "
          f"{args.kv} pool of {pool['k'].shape[1]} pages")
    f0, g0 = moe_ffn_decode_fused.launches, paged_decode_attention_pool.launches
    _, wall, busy, rows = profiled(lambda: decode_chunk(params, lm, pool, state, tables, **chunk), dev)
    print(f"[chunk] {wall * 1e3 / args.steps:.2f} ms a step wall, {busy * 1e3 / args.steps:.2f} ms device; "
          f"{b * args.steps / wall:.1f} tok/s in total, {args.steps / wall:.1f} per slot; launches F "
          f"{moe_ffn_decode_fused.launches - f0}, G {paged_decode_attention_pool.launches - g0}")
    report("decode chunk", wall, busy, rows, top=12)
    return 0


if __name__ == "__main__":
    sys.exit(main())
