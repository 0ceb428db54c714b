#!/usr/bin/env python3
"""What the readback interval of the captured decode costs, on one GPU.

    python3 scripts/torch_decode_sync.py [--lengths 16,64,256,1024] [--every 1,8] [--batches 1,16]

A captured `greedy_generate` (`runtime/decode_graph.py`) replays its step
`SYNC_EVERY` times between two readbacks of the done flags (the script
sets the module's constant to each value it compares). A readback
leaves the card idle while the host waits and launches the next replay; an
interval above 1 runs up to `SYNC_EVERY - 1` frozen steps after the last
row reaches EOS. This script measures both sides on pages that end at EOS.

Builds the full-width model with random weights (as chip_smoke.py does: LM
bf16, vision f32, an f32 cache), takes the first no-crop page of
chip_smoke's, repeats it over the batch's rows, and decodes it once without
an EOS to learn its tokens. For each output length L it then takes as EOS
a token that first appears as the L-th generated one (or the nearest one
before it), so every row ends at EOS after about L tokens, within a budget
of the longest length + 64. Each (weights, batch, L, interval) decodes
twice, after a decode that captures its graph, in the order 1, 8, 8, 1
of the intervals; the script prints the decode wall (`stats["decode_s"]`, to the
last readback, no profiler), tokens, steps run and graph replays of the
timed runs, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _eos_at(stream: list, length: int) -> tuple:
    """(eos, n): a token whose first occurrence in `stream` is its n-th
    entry, n <= length and as large as it can be."""
    for p in range(length - 1, -1, -1):
        if stream[p] not in stream[:p]:
            return stream[p], p + 1
    raise ValueError("no token of the stream appears first at or before the length")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lengths", default="16,64,256,1024")
    ap.add_argument("--every", default="1,8")
    ap.add_argument("--batches", default="1,16")
    ap.add_argument("--tiers", default="bf16,int8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import quantize_lm_params
    from deepseek_ocr2_tpu_torch.runtime import decode_graph
    from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate
    from deepseek_ocr2_tpu_torch.runtime.kv_cache import bucket_capacity
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline
    from deepseek_ocr2_tpu_torch.utils.tokenizer import tokenize_with_image

    lengths = [int(x) for x in args.lengths.split(",")]
    everies = [int(x) for x in args.every.split(",")]
    order = everies + everies[::-1]
    dev = torch.device("cuda", 0)
    print("[device]", subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True, check=True).stdout.strip())
    cfg = OCR2Config()
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    flat = cs.random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    params = cs.load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype="float32")
    del flat
    pipe = OCR2Pipeline(params, cfg, cs.StubTokenizer(cfg.lm.vocab_size), device=dev, kv_dtype="float32",
                        act_dtype="float32")
    page = cs.synthetic_page(*cs.PAGES[0], cfg, seed=0)[0]
    base, patches, ratio, _ = pipe.preprocess_finish(pipe.preprocess_host(page))
    ids, _, start = tokenize_with_image(pipe.tokenizer, cfg.default_ocr_prompt, cfg, ratio)
    embeds1 = pipe.build_ocr_embeds(ids, base, patches, start)
    budget = max(lengths) + 64
    capacity = bucket_capacity(len(ids) + budget)
    bf16_lm = params["lm"]
    runner, sync_every = decode_graph.RUNNER, decode_graph.SYNC_EVERY
    for tier in args.tiers.split(","):
        lm = bf16_lm if tier == "bf16" else quantize_lm_params(bf16_lm, scope="full", bits=8 if tier == "int8" else 4)
        for b in (int(x) for x in args.batches.split(",")):
            embeds = embeds1.expand(b, -1, -1).contiguous()
            ids_t = torch.tensor([ids] * b, device=dev)

            def gen(eos, stats=None):
                return greedy_generate(lm, cfg.lm, embeds, ids_t, max_new_tokens=budget, ngram_size=20, eos_id=eos,
                                       capacity=capacity, kv_dtype=pipe.kv_dtype, rope=pipe.rope, stats=stats)

            toks, n_gen = gen(-1)
            stream = toks[0, len(ids):].tolist()
            same = bool((toks == toks[:1]).all())
            for length in lengths:
                eos, n = _eos_at(stream, length)
                walls = {k: [] for k in everies}
                gen(eos)  # its graph captured
                for every in order:
                    decode_graph.SYNC_EVERY = every
                    stats = {}
                    r0 = runner.replays
                    _, n_gen = gen(eos, stats)
                    walls[every].append((stats["decode_s"] * 1e3, runner.replays - r0))
                    if int(n_gen[0]) != n:
                        raise AssertionError(f"row 0 ended after {int(n_gen[0])} tokens, expected {n}")
                last = int(n_gen.max())
                for every in everies:
                    ms = [w for w, _ in walls[every]]
                    replays = walls[every][0][1]
                    print(f"[sync] LM {tier}, batch {b}{' (equal rows)' if same else ''}, page ends at EOS after "
                          f"{n} tokens (the last row {last}), budget {budget}: SYNC_EVERY {every}: decode "
                          f"{ms[0]:.2f} / {ms[1]:.2f} ms ({min(ms) / max(last - 1, 1):.4f} ms a token), {replays} "
                          f"replays for {last - 1} steps ({replays - (last - 1)} after the last EOS)")
        del lm
    decode_graph.SYNC_EVERY = sync_every
    return 0


if __name__ == "__main__":
    sys.exit(main())
