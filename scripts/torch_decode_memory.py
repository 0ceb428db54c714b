#!/usr/bin/env python3
"""Device memory of the group engine over pages of several crop ratios, on one GPU.

    python3 scripts/torch_decode_memory.py [--root DIR] [--max-new 64] [--rounds 2]

Builds the full-width model with random weights (as chip_smoke.py does: LM
bf16, vision f32, an f32 cache) and runs `OCR2Engine(batch_size=16)` over
25 pages: 20 no-crop pages (chunks of 16 and 4 rows), 3 pages of crop grid
(2, 1) and 2 of (2, 3), so the decodes take three prompt lengths, two
capacity buckets and four batch sizes. Each round prints the wall, the
peak of allocated device memory over the round, the memory still allocated
after it (what the engine keeps between calls) and the reserved memory, all
beside the weights' own; where the package has `runtime/decode_graph.py`,
also the static buffer sets and graphs it keeps and their pools' MiB.
`--root` runs another checkout's package (and its chip_smoke.py helpers),
so that two versions are measured with the same script on one card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    import chip_smoke as cs
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    try:
        from deepseek_ocr2_tpu_torch.runtime import decode_graph
    except ImportError:
        decode_graph = None
    dev = torch.device("cuda", 0)
    gib = 2**30
    print("[device]", subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True, check=True).stdout.strip())
    print(f"[memory] package {Path(cs.__file__).resolve().parent}")
    cfg = OCR2Config()
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flat = cs.random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    params = cs.load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype="float32")
    del flat
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    weights = torch.cuda.memory_allocated(dev)
    pipe = OCR2Pipeline(params, cfg, cs.StubTokenizer(cfg.lm.vocab_size), device=dev, kv_dtype="float32",
                        act_dtype="float32")
    sizes = cs.PAGES + [(600, 760), (512, 512)]
    pages = [cs.synthetic_page(*sizes[i % len(sizes)], cfg, seed=300 + i)[0] for i in range(20)]
    pages += [cs.synthetic_page(1400, 800, cfg, seed=330 + i)[0] for i in range(3)]
    pages += [cs.synthetic_page(1700, 2200, cfg, seed=340 + i)[0] for i in range(2)]
    engine = OCR2Engine(pipe, batch_size=16)
    for rnd in range(args.rounds):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = engine.run(pages, max_new_tokens=args.max_new, ngram_size=20)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        prompts = sorted({(r.crop_ratio, r.prompt_len) for r in res})
        kept = ""
        if decode_graph is not None:
            runner = decode_graph.RUNNER
            pools = sum(r["pool_mib"] for r in runner.report())
            kept = (f"; the runner keeps {len(runner._buffers)} buffer sets and {len(runner._graphs)} graphs "
                    f"(pools {pools:.1f} MiB), {len(runner.log)} captures so far")
        print(f"[memory] round {rnd + 1}: {len(pages)} pages (grid, prompt) {prompts}, {args.max_new} new tokens: "
              f"{wall:.2f} s; weights {weights / gib:.3f} GiB, peak allocated "
              f"{torch.cuda.max_memory_allocated(dev) / gib:.3f} GiB, allocated after "
              f"{torch.cuda.memory_allocated(dev) / gib:.3f} GiB, reserved {torch.cuda.memory_reserved(dev) / gib:.3f} "
              f"GiB{kept}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
