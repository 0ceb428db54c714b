#!/usr/bin/env python3
"""Where one page's time goes in the PyTorch port, on one GPU.

    python3 scripts/torch_page_profile.py [--new-tokens 32] [--crop W H]

Builds the full-width model with random weights (as chip_smoke.py does:
LM bf16, vision f32), runs one warm-up page, then profiles the three
stages of a second page with torch.profiler. The page is a 700x500 no-crop
page, or with `--crop W H` a W x H page that takes crop mode (for example
`--crop 1700 2200`, a (2, 3) grid of 768^2 crops). Stages: vision (towers + injection),
LM prefill (one forward + the first pick) and the decode loop. For each
stage it prints the host wall time, the summed device kernel time, the
device idle share (1 - kernel time / wall time) and the kernels that take
the most device time. Numbers are the card's own; print them with its
name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def profiled(fn, dev):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not rows:  # older builds file kernel time on the CPU-side entries
        rows = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    return out, wall, busy_us / 1e6, sorted(rows, key=lambda e: -e.self_device_time_total)


def report(stage, wall, busy, rows, top=8):
    print(f"[{stage}] wall {wall * 1e3:.2f} ms, device kernels {busy * 1e3:.2f} ms, "
          f"device idle share {max(0.0, 1 - busy / wall):.3f}")
    for e in rows[:top]:
        print(f"[{stage}]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--crop", type=int, nargs=2, metavar=("W", "H"), default=None,
                    help="profile a W x H page in crop mode instead of the no-crop page")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.utils.tokenizer import tokenize_with_image
    from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate
    from deepseek_ocr2_tpu_torch.runtime.kv_cache import bucket_capacity
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    dev = torch.device("cuda", 0)
    print("[device]", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    cfg = OCR2Config()
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flat = cs.random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    params = cs.load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype="float32")
    del flat
    pipe = OCR2Pipeline(params, cfg, cs.StubTokenizer(cfg.lm.vocab_size), device=dev)
    if args.crop:
        w, h = args.crop
        grid = {(cw, ch): cg for cw, ch, cg in cs.CROP_PAGES}.get((w, h))
        page, how = cs.synthetic_page(w, h, cfg, seed=0, grid=grid or (1, 1))
        if how != "pil" and grid is None:  # a page drawn without PIL needs its grid given
            raise SystemExit(f"without PIL, --crop takes a size of chip_smoke.CROP_PAGES: {cs.CROP_PAGES}")
    else:
        page, _ = cs.synthetic_page(700, 500, cfg, seed=0)
    pipe.generate_ocr(page, max_new_tokens=4)  # warm-up: builds kernels, cuBLAS handles

    pre = page if isinstance(page, dict) else pipe.preprocess_host(page)
    base, patches, ratio, _ = pipe.preprocess_finish(pre)
    ids, _, start = tokenize_with_image(pipe.tokenizer, cfg.default_ocr_prompt, cfg, ratio)
    print(f"[page] crop grid {ratio}, prompt {len(ids)} tokens")
    embeds, wall, busy, rows = profiled(lambda: pipe.build_ocr_embeds(ids, base, patches, start), dev)
    report("vision", wall, busy, rows)

    def gen(n):
        return greedy_generate(
            params["lm"], cfg.lm, embeds, torch.tensor(ids), max_new_tokens=n, ngram_size=20,
            eos_id=-1, capacity=bucket_capacity(len(ids) + n), kv_dtype=torch.float32,
            rope=pipe.rope,
        )

    _, wall_p, busy_p, rows = profiled(lambda: gen(1), dev)
    report("prefill", wall_p, busy_p, rows)
    _, wall_a, busy_a, rows = profiled(lambda: gen(args.new_tokens), dev)
    steps = args.new_tokens - 1
    wall_d, busy_d = wall_a - wall_p, busy_a - busy_p
    print(f"[decode] {steps} steps: wall {wall_d * 1e3 / steps:.2f} ms/token "
          f"({steps / wall_d:.1f} tok/s), device kernels {busy_d * 1e3 / steps:.2f} ms/token, "
          f"device idle share {max(0.0, 1 - busy_d / wall_d):.3f} (prefill+decode profile minus prefill)")
    report("prefill+decode", wall_a, busy_a, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
