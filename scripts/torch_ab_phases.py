"""Run chosen `chip_smoke.py` phases of two checkouts in turns on one card.

Each turn is its own process, rooted at one checkout (its `chip_smoke.py`
and `deepseek_ocr2_tpu_torch/` are the ones imported; each builds its own
kernels), and the turns go A, B, B, A, so that drift of the card's clocks
over the call falls on both. Compare two commits only inside one such run.

Phases:
- `gmm_forward`: phase 2's grouped-GEMM forward cases (D, E and the whole
  `moe_ffn_gmm` at N 550, 1125 and 2048, bf16 and f32);
- `gmm_backward`: phase 2's grouped-GEMM backward cases (S, T and E at a
  training step's MoE layer, bf16 and f32), every case's line as
  chip_smoke prints it;
- `prefill_attention`: kernel A at the LM's prefill shapes, causal f32
  [1, 10, 260, 128] and [1, 10, 1125, 128], with SDPA beside it (both
  through the wrapper and in a CUDA graph);
- `crop_prefill`: the full-width model (random weights, LM bf16, vision
  f32) on chip_smoke's (2, 3) crop page: the LM prefill of its 1124-token
  prompt (one forward and the first pick) profiled three times, its wall
  ms, device ms and the device ms and launches of A (attention kernels)
  and of D and E;
- `train`: phase 8 (`phase_train`), the full-width LM's AdamW steps with
  the step time and the profiled step.

    git archive <commit> | tar -x -C build/parent   # a checkout git ignores
    python3 scripts/torch_ab_phases.py build/parent . --phases gmm_backward train
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = r"""
import sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
import deepseek_ocr2_tpu_torch  # noqa: F401  (the f32 numerics flags)

dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(cs.SEED)


def randn(*shape, std=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


def record(kernel, case, ref, got, tol, ms, plain_ms, bound=None, library=None, graph=None, library_graph=False):
    err = float((got.float() - ref.float()).abs().max())
    lib = cs.median_ms(library) if library is not None else None
    dev_ms = cs.graph_ms(graph) if graph is not None else None
    try:  # a library call that cannot be captured in a graph is left out
        lib_dev = cs.graph_ms(library) if library is not None else None
    except RuntimeError as exc:
        lib_dev = f"none ({{exc}})"[:80]
    print(f"[ab {{sys.argv[1]}}] {{kernel}} {{case}}: err {{err:.3e}} (tol {{tol:.1e}}) kernel {{ms:.4f}} ms, graph "
          f"{{dev_ms}}, plain {{plain_ms:.3f}}, bound {{bound}}, library {{lib}}, library graph {{lib_dev}}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{{kernel}} {{case}}: error {{err}} above {{tol}}")


def prefill_attention():
    import math
    import torch.nn.functional as F
    from deepseek_ocr2_tpu_torch.ops.flash_attention import mha, mha_reference

    for length in (260, 1125):
        q, k, v = (randn(1, 10, length, 128) for _ in range(3))
        scale = 1.0 / math.sqrt(128)
        ref = mha_reference(q, k, v, scale=scale, mode="causal")
        record("A", f"causal {{tuple(q.shape)}} float32", ref, mha(q, k, v, scale=scale, mode="causal"), cs.F32_TOL,
               cs.median_ms(lambda: mha(q, k, v, scale=scale, mode="causal")),
               cs.median_ms(lambda: mha_reference(q, k, v, scale=scale, mode="causal")), None,
               lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale),
               graph=lambda: mha(q, k, v, scale=scale, mode="causal"))


def crop_prefill():
    import time
    from torch.profiler import ProfilerActivity, profile
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate
    from deepseek_ocr2_tpu_torch.runtime.kv_cache import bucket_capacity
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline
    from deepseek_ocr2_tpu_torch.utils.tokenizer import tokenize_with_image

    cfg = OCR2Config()
    flat = cs.random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    params = cs.load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype="float32")
    del flat
    pipe = OCR2Pipeline(params, cfg, cs.StubTokenizer(cfg.lm.vocab_size), device=dev)
    w, h, grid = cs.CROP_PAGES[1]
    page, _ = cs.synthetic_page(w, h, cfg, seed=0, grid=grid)
    pipe.generate_ocr(page, max_new_tokens=2)  # warm-up: kernels built, cuBLAS handles
    pre = page if isinstance(page, dict) else pipe.preprocess_host(page)
    base, patches, ratio, _ = pipe.preprocess_finish(pre)
    ids, _, start = tokenize_with_image(pipe.tokenizer, cfg.default_ocr_prompt, cfg, ratio)
    embeds = pipe.build_ocr_embeds(ids, base, patches, start)

    def prefill():
        return greedy_generate(params["lm"], cfg.lm, embeds, torch.tensor(ids), max_new_tokens=1, ngram_size=20,
                               eos_id=-1, capacity=bucket_capacity(len(ids) + 1), kv_dtype=torch.float32,
                               rope=pipe.rope)

    prefill()
    for rep in range(3):
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill()
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        parts = {{}}
        for e in rows:
            kind = "A" if "attn" in e.key else cs._gmm_kernel_of(e.key) if "gmm_" in e.key else None
            if kind is not None:
                ms, n = parts.get(kind, (0.0, 0))
                parts[kind] = (ms + e.self_device_time_total / 1e3, n + e.count)
        print(f"[ab {{sys.argv[1]}}] crop (2, 3) prefill, {{len(ids)}} tokens, run {{rep}}: wall {{wall * 1e3:.2f}} ms, "
              f"device {{busy:.3f}} ms in {{sum(e.count for e in rows)}} launches; "
              + ", ".join(f"{{k}} {{ms:.3f}} ms x{{n}}" for k, (ms, n) in sorted(parts.items())), flush=True)


for phase in {phases!r}:
    if phase == "gmm_forward":
        cs.gmm_results(dev, randn, record)
    elif phase == "gmm_backward":
        cs.gmm_backward_results(dev, randn, record)
    elif phase == "prefill_attention":
        prefill_attention()
    elif phase == "crop_prefill":
        crop_prefill()
    elif phase == "train":
        cs.phase_train(dev)
    else:
        raise SystemExit(f"unknown phase {{phase}}")
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="checkout A (e.g. the parent commit, unpacked)")
    ap.add_argument("b", help="checkout B (e.g. .)")
    ap.add_argument("--phases", nargs="+", default=["gmm_backward", "train"])
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for label, tree in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)):
        root = os.path.abspath(tree)
        print(f"[ab] turn {label}: {root}", flush=True)
        code = CHILD.format(root=root, phases=args.phases)
        rc = subprocess.run([sys.executable, "-c", code, label], cwd=root).returncode
        if rc != 0:
            print(f"[ab] turn {label} failed: rc {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
