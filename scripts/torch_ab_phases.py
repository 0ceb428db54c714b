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
- `crop_vision`: the same page's vision (SAM, Qwen2 and the injection of
  its 1024^2 view and six 768^2 crops) profiled three times: wall ms,
  device ms, and the device ms and launches of B and C;
- `sam_attention`: kernel B in f32 at SAM's four shapes (the 1024^2
  view's global [1, 12, 4096, 64] and windows [25, 12, 196, 64], six
  crops' global [6, 12, 2304, 64] and windows [96, 12, 196, 64]), with
  SDPA given the bias beside it, both through the wrapper and in a CUDA
  graph;
- `int4_head`: kernel L at the int4 lm_head (129 280 x 1280, bf16 x, f32
  out) at B 1 and 16, with `torch._weight_int4pack_mm` on the same levels
  and scales beside it, both through the wrapper and in a CUDA graph;
- `train`: phase 8 (`phase_train`), the full-width LM's AdamW steps with
  the step time and the profiled step.

    git archive <commit> | tar -x -C build/parent   # a checkout git ignores
    python3 scripts/torch_ab_phases.py build/parent . --phases gmm_backward train

With one checkout it runs its phases once (the "before" numbers of a
kernel, say): `python3 scripts/torch_ab_phases.py . --phases int4_head`.
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


def crop_page():
    # The full-width model (random weights, LM bf16, vision f32) and
    # chip_smoke's (2, 3) crop page, after one warm-up page.
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
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
    return pipe, params, cfg, ids, base, patches, start


def profiled(what, fn, kind_of):
    # fn() under torch.profiler three times: wall ms, device ms, launches,
    # and the device ms and launches of each kernel kind (kind_of(name);
    # None for the rest).
    import time
    from torch.profiler import ProfilerActivity, profile

    fn()
    for rep in range(3):
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        parts = {{}}
        for e in rows:
            kind = kind_of(e.key)
            if kind is not None:
                ms, n = parts.get(kind, (0.0, 0))
                parts[kind] = (ms + e.self_device_time_total / 1e3, n + e.count)
        print(f"[ab {{sys.argv[1]}}] {{what}}, run {{rep}}: wall {{wall * 1e3:.2f}} ms, "
              f"device {{busy:.3f}} ms in {{sum(e.count for e in rows)}} launches; "
              + ", ".join(f"{{k}} {{ms:.3f}} ms x{{n}}" for k, (ms, n) in sorted(parts.items())), flush=True)


def crop_prefill():
    from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate
    from deepseek_ocr2_tpu_torch.runtime.kv_cache import bucket_capacity

    pipe, params, cfg, ids, base, patches, start = crop_page()
    embeds = pipe.build_ocr_embeds(ids, base, patches, start)

    def prefill():
        return greedy_generate(params["lm"], cfg.lm, embeds, torch.tensor(ids), max_new_tokens=1, ngram_size=20,
                               eos_id=-1, capacity=bucket_capacity(len(ids) + 1), kv_dtype=torch.float32,
                               rope=pipe.rope)

    profiled(f"crop (2, 3) prefill, {{len(ids)}} tokens", prefill,
             lambda key: "A" if "attn" in key else cs._gmm_kernel_of(key) if "gmm_" in key else None)


def crop_vision():
    pipe, params, cfg, ids, base, patches, start = crop_page()
    profiled("crop (2, 3) vision", lambda: pipe.build_ocr_embeds(ids, base, patches, start),
             lambda key: "B" if "attn" in key else "C" if "mlp_kernel" in key else None)


def sam_attention():
    import torch.nn.functional as F
    from deepseek_ocr2_tpu_torch.ops.flash_attention import mha_reference, mha_relpos

    for case, b, side in (("global", 1, 64), ("window", 25, 14), ("crop global", 6, 48), ("crop window", 96, 14)):
        l = side * side
        q, k, v = (randn(b, 12, l, 64) for _ in range(3))
        rh, rw = randn(b, 12, l, side, std=0.3), randn(b, 12, l, side, std=0.3)
        bias = (rh[..., :, None] + rw[..., None, :]).reshape(b, 12, l, l)
        ref = mha_reference(q, k, v, scale=0.125, rel_h=rh, rel_w=rw)
        record("B", f"{{case}} {{tuple(q.shape)}} float32", ref, mha_relpos(q, k, v, rh, rw, scale=0.125), cs.F32_TOL,
               cs.median_ms(lambda: mha_relpos(q, k, v, rh, rw, scale=0.125)),
               cs.median_ms(lambda: mha_reference(q, k, v, scale=0.125, rel_h=rh, rel_w=rw)), None,
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=0.125),
               graph=lambda: mha_relpos(q, k, v, rh, rw, scale=0.125))
        del q, k, v, rh, rw, bias, ref
        torch.cuda.empty_cache()


def int4_head():
    from deepseek_ocr2_tpu_torch.ops import linear_q4

    w = linear_q4.quantize_linear_q4(randn(129280, 1280, std=1280**-0.5))
    # The library's layout of the same levels (unsigned, + 8; the even one in
    # the high nibble) and its (scale, zero 0) pairs in bf16, as chip_smoke's.
    u = linear_q4.unpack_q4(w["q4"]).to(torch.int32) + 8
    packed = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([w["scale"].T, torch.zeros_like(w["scale"].T)], dim=-1).to(torch.bfloat16).contiguous()
    for b in (1, 16):
        x = randn(b, 1280, dtype=torch.bfloat16)
        ref = linear_q4.linear_q4_reference(x, w, out_dtype=torch.float32)
        record("L", f"lm_head B {{b}} [129280, 1280] bf16 -> float32", ref,
               linear_q4.linear_q4(x, w, out_dtype=torch.float32), cs.tolerance(ref, torch.float32),
               cs.median_ms(lambda: linear_q4.linear_q4(x, w, out_dtype=torch.float32)),
               cs.median_ms(lambda: linear_q4.linear_q4_reference(x, w, out_dtype=torch.float32)), None,
               lambda: torch._weight_int4pack_mm(x, packed, 128, sz),
               graph=lambda: linear_q4.linear_q4(x, w, out_dtype=torch.float32))


for phase in {phases!r}:
    if phase == "gmm_forward":
        cs.gmm_results(dev, randn, record)
    elif phase == "gmm_backward":
        cs.gmm_backward_results(dev, randn, record)
    elif phase == "prefill_attention":
        prefill_attention()
    elif phase == "crop_prefill":
        crop_prefill()
    elif phase == "crop_vision":
        crop_vision()
    elif phase == "sam_attention":
        sam_attention()
    elif phase == "int4_head":
        int4_head()
    elif phase == "train":
        cs.phase_train(dev)
    else:
        raise SystemExit(f"unknown phase {{phase}}")
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="checkout A (e.g. the parent commit, unpacked)")
    ap.add_argument("b", nargs="?", help="checkout B (e.g. .); without it, A's phases run once")
    ap.add_argument("--phases", nargs="+", default=["gmm_backward", "train"])
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)) if args.b else (("A", args.a),)
    for label, tree in turns:
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
