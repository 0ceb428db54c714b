"""Run chosen `chip_smoke.py` phases of two checkouts in turns on one card.

Each turn is its own process, rooted at one checkout (its `chip_smoke.py`
and `deepseek_ocr2_tpu_torch/` are the ones imported; each builds its own
kernels), and the turns go A, B, B, A, so that drift of the card's clocks
over the call falls on both. Compare two commits only inside one such run.

Phases:
- `gmm_forward`: phase 2's grouped-GEMM forward cases (D, E and the whole
  `moe_ffn_gmm` at N 550, 1125 and 2048, bf16 and f32);
- `gmm_chain`: the whole `moe_ffn_gmm` forward (the prefill MoE layer)
  at N 550, 1125 and 2048, k 6, bf16: median eager ms, ms in a CUDA graph
  and the device launches of one call; at N 550 every launch of one call
  in a CUDA graph with its device us and the gap before it;
- `visit`: phase 2's kernel W cases (`visit_results`: both modes at 548
  and 1124 tokens x 6, bf16 and f32, through the wrapper and in a CUDA
  graph, and the ffn mode against D then E);
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
- `sam_attention`: kernel B in f32 and bf16 at SAM's four shapes (the
  1024^2 view's global [1, 12, 4096, 64] and windows [25, 12, 196, 64],
  six crops' global [6, 12, 2304, 64] and windows [96, 12, 196, 64]), with
  SDPA given the bias beside it, both through the wrapper and in a CUDA
  graph;
- `int4_head`: kernel L at the int4 lm_head (129 280 x 1280, bf16 x, f32
  out) at B 1 and 16, with `torch._weight_int4pack_mm` on the same levels
  and scales beside it, both through the wrapper and in a CUDA graph;
- `sam_windows`: kernel V at SAM's two window shapes (the 1024^2 view's
  [25, 12, 196, 64] and six crops' [96, 12, 196, 64], win = valid = 14),
  f32 and bf16, with SDPA given the bias beside it, both through the
  wrapper and in a CUDA graph; then chip_smoke's (2, 1) crop page's vision
  profiled three times each on the default path and with the switches set
  (`DEEPSEEK_SAM_WIN_KERNEL=1`: V in the windowed blocks), vision f32 and
  bf16: wall ms, device ms, and the device ms and launches of B, V and C;
- `stacked_decode`: chip_smoke's kernel U and X cases (`stacked_results`),
  then its per-token decode profile of a no-crop page at batch 1, LM bf16,
  on the default path (pool) and under `DEEPSEEK_DECODE_ATTN=stacked`
  (kernel U), each twice, in turns;
- `decode_moe`: kernel F at one MoE decode layer (E 64, k 6, H 1280, I
  896, a random f32 router) at B 8, 16 and 32 in bf16 and 16 in f32
  against its visit twin, through the wrapper and in a CUDA graph, with
  its bound; then one `decode_chunk` of 32 steps of the continuous engine
  at 16 slots (full-width LM bf16, an f32 pool, lengths 260..700, as
  `scripts/torch_serve_profile.py`) profiled three times: wall ms, device
  ms, and the device ms and launches of F's parts (schedule, gate/up,
  down, the f32 form's combine) and of G;
- `sam_mlp`: kernel C at SAM's MLP (768 -> 3072 -> 768) at M 4096 (one
  1024^2 view), 2304 (one 768^2 crop) and 13 824 (six crops), f32 and
  bf16, against its twin, through the wrapper and in a CUDA graph, with its
  bound; then chip_smoke's (2, 3) crop page's vision in f32 and (2, 1)
  page's in bf16, each profiled three times: wall ms, device ms, and the
  device ms and launches of B and C;
- `paged_decode`: kernel G at 16 rows of 260..2048 tokens and at one row
  of 300, f32 and bf16 pools, and X at the 16 rows, each against the
  twin, through the wrapper and in a CUDA graph, with its bound; then
  `decode_moe`'s continuous-engine step on an f32 and on a bf16 pool,
  profiled three times each (F's parts and G);
- `paged_q8`: chip_smoke's kernel P cases (`paged_q8_results`: 16 rows of
  260..2048 tokens and one row of 1500, int8 and int8tail pools, through
  the wrapper and in a CUDA graph, with the bound); then `decode_moe`'s
  continuous-engine step on an int8 and on an int8tail pool, profiled three
  times each (F's parts, G and P);
- `paged_chunk`: chip_smoke's kernel Q and R cases (`chunk_results`: 16
  rows, S = 4, f32 and bf16 pools for Q, int8 and int8tail for R); then
  eight lookup forwards (`decode_chunk_lookup`, chunk 4) of the continuous
  engine at 16 slots on a bf16 pool and on an int8tail pool (the LM in
  bf16, lengths 260..700), each profiled three times (F's parts and Q or
  R);
- `moe_q8`: chip_smoke's int8 kernel cases (`q8_results`: H, I, J at 16
  and 32 rows, K, and the I / J cut-over line at B 8, 11 and 16) and int4
  ones (`q4_results`: L, M, N, O); then the continuous engine's 32-step
  chunk at 16 slots with the LM quantized as `--int8` and as `--int4`
  (`quantize_lm_params(scope="full", bits=8 or 4)`, a bf16 pool), each
  profiled three times: wall ms, device ms, and the device ms and launches
  of J's or N's parts (schedule, gate/up, down, the first form's combine),
  H or L, and G;
- `kernel_parts`: K and O at B 1 (cap 1024, pos 300, f32 and bf16 caches)
  and B 16 (ragged positions from 0), and N at B 16 and 32, each replayed
  in a CUDA graph under torch.profiler: every launch of one call (K's and
  O's qkv GEMV, attention and wo GEMV; N's schedule, gate/up, down and the
  first form's combine) with its device us and the gap before it. Put it
  first in `--phases`: after the profiled phases the trace lost some of
  its kernel events on the H100, and the split was then not printed;
- `decode_quant`: decode per token of a no-crop page at batch 1 on the
  contiguous cache, the LM as `--int8` and as `--int4`, two readings each:
  device ms and launches a token, and K's or O's attention kernel's device
  ms and its three launches' span on the device; with `--int4` also M's
  device ms and launches a token (its stream's two kernels or its first
  form's three);
- `moe_q4_sel`: kernel M at one int4 MoE decode layer (E 64 + 2
  pseudo-experts, k 6, H 1280, I 896) at B 1 with the pseudo-experts, 8
  and 10 without, against its twin, through the wrapper and in a CUDA
  graph, with its bound; then the layer as M and as N in a CUDA graph at
  B 8, 11 and 16 (the B k <= E cut-over);
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
from concurrent.futures import ThreadPoolExecutor
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
import deepseek_ocr2_tpu_torch  # noqa: F401  (the f32 numerics flags)
from deepseek_ocr2_tpu_torch.ops import cuda_build

dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(cs.SEED)
with ThreadPoolExecutor(len(cs.KERNEL_SOURCES)) as pool:  # every library built first, nvcc side by side
    list(pool.map(cuda_build.load, cs.KERNEL_SOURCES))


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
             lambda key: "A" if "attn" in key else cs._gmm_kernel_of(key) if "gmm_" in key or "route_layout" in key
             or "moe_combine" in key else None)


def gmm_chain():
    # The whole moe_ffn_gmm forward (the prefill MoE layer) at N 550, 1125
    # and 2048, k 6, bf16, full LM width, a random f32 router: median eager
    # ms, ms in a CUDA graph, and the device launches of one eager call;
    # then at N 550 each launch of one call in a CUDA graph with its device
    # us and the gap before it.
    from torch.profiler import ProfilerActivity, profile
    from deepseek_ocr2_tpu_torch.ops import moe_gmm
    from deepseek_ocr2_tpu_torch.ops.moe import route

    e, k, h, i = 64, 6, 1280, 896
    for n in (550, 1125, 2048):
        x = randn(n, h, dtype=torch.bfloat16)
        ex = {{"gate": randn(e, i, h, std=h**-0.5, dtype=torch.bfloat16),
              "up": randn(e, i, h, std=h**-0.5, dtype=torch.bfloat16),
              "down": randn(e, h, i, std=i**-0.5, dtype=torch.bfloat16)}}
        weights, idx = route(x, randn(e, h, std=h**-0.5), k)
        call = lambda: moe_gmm.moe_ffn_gmm(x, ex, weights, idx)  # noqa: E731
        call()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize(dev)
        launches = sum(ev.count for ev in prof.key_averages() if ev.device_type == torch.autograd.DeviceType.CUDA)
        print(f"[ab {{sys.argv[1]}}] moe_ffn_gmm N {{n}} k {{k}} bf16: eager {{cs.median_ms(call):.4f}} ms, in a CUDA "
              f"graph {{cs.graph_ms(call):.4f}} ms, {{launches}} device launches a call", flush=True)
        if n == 550:
            graph_parts(f"moe_ffn_gmm N {{n}} bf16", call)
        del x, ex
    torch.cuda.empty_cache()


def crop_vision():
    pipe, params, cfg, ids, base, patches, start = crop_page()
    profiled("crop (2, 3) vision", lambda: pipe.build_ocr_embeds(ids, base, patches, start),
             lambda key: "B" if "attn" in key else "C" if "mlp_" in key else None)


def sam_attention():
    import torch.nn.functional as F
    from deepseek_ocr2_tpu_torch.ops.flash_attention import mha_reference, mha_relpos

    for (case, b, side), dt in ((c, dt) for dt in (torch.float32, torch.bfloat16)
                                for c in (("global", 1, 64), ("window", 25, 14), ("crop global", 6, 48),
                                          ("crop window", 96, 14))):
        l = side * side
        q, k, v = (randn(b, 12, l, 64, dtype=dt) for _ in range(3))
        rh, rw = randn(b, 12, l, side, std=0.3), randn(b, 12, l, side, std=0.3)
        bias = (rh[..., :, None] + rw[..., None, :]).reshape(b, 12, l, l).to(dt)
        ref = mha_reference(q, k, v, scale=0.125, rel_h=rh, rel_w=rw)
        record("B", f"{{case}} {{tuple(q.shape)}} {{str(dt)[6:]}}", ref, mha_relpos(q, k, v, rh, rw, scale=0.125),
               cs.tolerance(ref, dt),
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


def sam_windows():
    import torch.nn.functional as F
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.ops.flash_attention import mha_win, mha_win_reference, window_bias
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline
    from deepseek_ocr2_tpu_torch.utils.tokenizer import tokenize_with_image

    for b in (25, 96):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (randn(b, 12, 196, 64, dtype=dt) for _ in range(3))
            rhf, rwf = randn(64, 196, std=0.3), randn(64, 196, std=0.3)
            kw = dict(scale=0.125, win=14, valid=14)
            bias = window_bias(q, rhf, rwf, 14, 14).to(dt)
            ref = mha_win_reference(q, k, v, rhf, rwf, **kw)
            record("V", f"windows {{tuple(q.shape)}} win 14 valid 14 {{str(dt)[6:]}}", ref, mha_win(q, k, v, rhf, rwf, **kw),
                   cs.tolerance(ref, dt), cs.median_ms(lambda: mha_win(q, k, v, rhf, rwf, **kw)),
                   cs.median_ms(lambda: mha_win_reference(q, k, v, rhf, rwf, **kw)), None,
                   lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=0.125),
                   graph=lambda: mha_win(q, k, v, rhf, rwf, **kw))
            del q, k, v, bias, ref
    torch.cuda.empty_cache()

    cfg = OCR2Config()
    flat = cs.random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    w, h, grid = cs.CROP_PAGES[0]
    page, _ = cs.synthetic_page(w, h, cfg, seed=0, grid=grid)
    for vision in ("float32", "bfloat16"):
        params = cs.load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype=vision)
        pipe = OCR2Pipeline(params, cfg, cs.StubTokenizer(cfg.lm.vocab_size), device=dev, act_dtype=vision)
        base, patches, ratio, _ = pipe.preprocess_finish(page if isinstance(page, dict) else pipe.preprocess_host(page))
        ids, _, start = tokenize_with_image(pipe.tokenizer, cfg.default_ocr_prompt, cfg, ratio)
        for on in (False, True):
            with cs.switched(on):
                profiled(f"crop {{grid}} vision {{vision}}{{', switched' if on else ''}}",
                         lambda: pipe.build_ocr_embeds(ids, base, patches, start),
                         lambda key: ("V" if ", 64, 4>" in key else "B") if "attn" in key
                         else "C" if "mlp_" in key else None)
        del params, pipe
        torch.cuda.empty_cache()


def decode_moe():
    from deepseek_ocr2_tpu_torch.ops import moe_decode
    from deepseek_ocr2_tpu_torch.ops.moe import route

    e, k, h, i = 64, 6, 1280, 896
    router = randn(e, h, std=h**-0.5)
    for b, dt in ((8, torch.bfloat16), (16, torch.bfloat16), (32, torch.bfloat16), (16, torch.float32)):
        ex = {{"gate": randn(e, i, h, std=h**-0.5, dtype=dt), "up": randn(e, i, h, std=h**-0.5, dtype=dt),
               "down": randn(e, h, i, std=i**-0.5, dtype=dt)}}
        x = randn(b, h, dtype=dt)
        args = (x, ex, *route(x, router, k))
        n_visits = int(moe_decode.distinct_schedule(args[3], e)[1].sum())
        ref = moe_decode.moe_ffn_decode_visits_reference(*args)
        record("F", f"B {{b}} k {{k}}: {{n_visits}} distinct experts, {{str(dt)[6:]}}", ref,
               moe_decode.moe_ffn_decode_fused(*args), cs.tolerance(ref, dt),
               cs.median_ms(lambda: moe_decode.moe_ffn_decode_fused(*args)),
               cs.median_ms(lambda: moe_decode.moe_ffn_decode_visits_reference(*args)),
               cs.bound_ms(cs.nbytes(x, ref, *args[2:]) + n_visits * 3 * cs.nbytes(ex["gate"][0]),
                           2 * b * k * 3 * h * i, dt),
               graph=lambda: moe_decode.moe_ffn_decode_fused(*args))
        del ex, args, ref
    torch.cuda.empty_cache()

    serve_step(torch.float32)


def paged_kind(key):
    # The decode-attention kernel a profiler key names, in any checkout since
    # G's split walk: paged_split_kernel<T, S, TAIL> runs G (f32 / bf16, S 1),
    # P (int8 codes, S 1), Q (f32 / bf16, S > 1) and R (int8 codes, S > 1);
    # before, G alone (paged_split_kernel<T>), P paged_q8_kernel, Q
    # paged_chunk_kernel and R paged_chunk_q8_kernel.
    import re

    if "paged_chunk_q8_kernel" in key:
        return "R"
    if "paged_q8_kernel" in key:
        return "P"
    if "paged_chunk_kernel" in key:
        return "Q"
    m = re.search(r"paged_split_kernel<([^,>]+)(?:, (\d+))?", key)
    if m:
        chunk = int(m.group(2) or 1) > 1
        if "char" in m.group(1):
            return "R" if chunk else "P"
        return "Q" if chunk else "G"
    return "G" if "paged_kernel" in key else None


def serve_step(pool_dtype, lookup=False, bits=None):
    # One decode chunk of the continuous engine, as scripts/torch_serve_profile.py:
    # 16 slots, 32 steps, the full-width LM in bf16, lengths 260..700; the
    # pool f32, bf16, "int8" or "int8tail" (random codes and scales). With
    # `lookup`, eight lookup forwards of chunk 4 (decode_chunk_lookup) instead;
    # with `bits` 8 or 4, the LM quantized as `--int8` or `--int4`
    # (quantize_lm_params, scope "full": J and H, or N and L, and the pool's
    # attention kernel).
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import quantize_lm_params, rope_consts
    from deepseek_ocr2_tpu_torch.runtime.continuous import DecodeState, decode_chunk, decode_chunk_lookup
    from deepseek_ocr2_tpu_torch.runtime.paged_kv import make_paged_kv_cache, pages_for

    cfg = OCR2Config()
    lm = cfg.lm
    flat = cs.random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    params = cs.load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype="float32")["lm"]
    del flat
    if bits:
        params = quantize_lm_params(params, scope="full", bits=bits)
    b, page, cap, steps = 16, 128, 1024, 32
    per_row = pages_for(cap, page)
    pool = make_paged_kv_cache(lm.num_hidden_layers, b * per_row + 1, lm.num_attention_heads, page, lm.head_dim,
                               dtype=pool_dtype, device=dev, slots=b)
    for name, t in pool.items():
        if t.dtype == torch.int8:
            t.random_(-127, 128, generator=g)
        elif name.endswith("scale"):
            t.uniform_(1e-3, 2e-2, generator=g)
        else:
            t.normal_(generator=g)
    state = DecodeState.empty(b, cap, dev)
    state.tokens.random_(2, lm.vocab_size, generator=g)
    lens = torch.linspace(260, 700, b, device=dev).round().to(torch.int32)
    state.cur_lens.copy_(lens)
    state.done.zero_()
    state.limits.fill_(cap)
    tables = torch.arange(1, b * per_row + 1, dtype=torch.int32, device=dev).reshape(b, per_row)
    chunk = dict(n_steps=steps, ngram_size=20, eos_id=-1, rope=rope_consts(lm, dev))
    if lookup:
        chunk.update(n_steps=8, chunk=4, match_n=3)
    # F's launches by part (both forms): its schedule, gate/up, down, the f32
    # form's combine; with `bits` 8 J's (the stream: gu_q8_kernel,
    # down_q8_kernel; the first form: swiglu_mma_kernel, down_mma_kernel,
    # combine_kernel) and H, with 4 N's (the stream: gu_q4_kernel,
    # down_q4_kernel; the first form as J's) and L.
    if bits:
        kn, lin = ("J", "H") if bits == 8 else ("N", "L")
        f_parts = (("schedule_kernel", f"{{kn}} schedule"), (f"gu_q{{bits}}_kernel", f"{{kn}} gate/up"),
                   ("swiglu_mma_kernel", f"{{kn}} gate/up"), (f"down_q{{bits}}_kernel", f"{{kn}} down"),
                   ("down_mma_kernel", f"{{kn}} down"), ("combine_kernel", f"{{kn}} combine"), ("gemv", lin))
    else:
        f_parts = (("schedule_kernel", "F schedule"), ("gu_tc_kernel", "F gate/up"), ("::swiglu_kernel<", "F gate/up"),
                   ("down_tc_kernel", "F down"), ("::down_kernel<", "F down"), ("combine_kernel", "F combine"))

    def kind_of(key):
        return next((name for pat, name in f_parts if pat in key), None) or paged_kind(key)

    def step():
        state.cur_lens.copy_(lens)
        (decode_chunk_lookup if lookup else decode_chunk)(params, lm, pool, state, tables, **chunk)

    what = "decode_chunk_lookup, 8 forwards of chunk 4" if lookup else f"decode_chunk, {{steps}} steps"
    lm_kind = {{None: "LM bf16", 8: "LM bf16, --int8", 4: "LM bf16, --int4"}}[bits]
    profiled(f"{{what}}, {{b}} slots, {{lm_kind}}, {{str(pool_dtype).replace('torch.', '')}} pool, lengths 260..700",
             step, kind_of)
    del params, pool, state
    torch.cuda.empty_cache()


def sam_mlp():
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.ops.fused_mlp import mlp_gelu, mlp_gelu_reference
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline
    from deepseek_ocr2_tpu_torch.utils.tokenizer import tokenize_with_image

    # Kernel C at SAM's MLP (768 -> 3072 -> 768): one 1024^2 view (M 4096),
    # one 768^2 crop (M 2304) and six crops batched (M 13 824).
    for m in (4096, 2304, 6 * 2304):
        for dt in (torch.float32, torch.bfloat16):
            x = randn(m, 768, dtype=dt)
            w1, b1 = randn(3072, 768, std=768**-0.5, dtype=dt), randn(3072, std=0.02, dtype=dt)
            w2, b2 = randn(768, 3072, std=3072**-0.5, dtype=dt), randn(768, std=0.02, dtype=dt)
            ref = mlp_gelu_reference(x, w1, b1, w2, b2)
            record("C", f"{{tuple(x.shape)}} x (3072, 768) {{str(dt)[6:]}}", ref, mlp_gelu(x, w1, b1, w2, b2),
                   cs.tolerance(ref, dt), cs.median_ms(lambda: mlp_gelu(x, w1, b1, w2, b2)),
                   cs.median_ms(lambda: mlp_gelu_reference(x, w1, b1, w2, b2)),
                   cs.bound_ms(cs.nbytes(x, w1, b1, w2, b2, ref), 2 * 2 * m * 768 * 3072, dt),
                   graph=lambda: mlp_gelu(x, w1, b1, w2, b2))
            del x, w1, b1, w2, b2, ref
    torch.cuda.empty_cache()

    # The pages' vision: the (2, 3) crop page in f32 (the CLI's vision
    # dtype) and the (2, 1) page in bf16 (serve's).
    cfg = OCR2Config()
    flat = cs.random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    for (w, h, grid), vision in ((cs.CROP_PAGES[1], "float32"), (cs.CROP_PAGES[0], "bfloat16")):
        page, _ = cs.synthetic_page(w, h, cfg, seed=0, grid=grid)
        params = cs.load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype=vision)
        pipe = OCR2Pipeline(params, cfg, cs.StubTokenizer(cfg.lm.vocab_size), device=dev, act_dtype=vision)
        base, patches, ratio, _ = pipe.preprocess_finish(page if isinstance(page, dict) else pipe.preprocess_host(page))
        ids, _, start = tokenize_with_image(pipe.tokenizer, cfg.default_ocr_prompt, cfg, ratio)
        profiled(f"crop {{grid}} vision {{vision}}", lambda: pipe.build_ocr_embeds(ids, base, patches, start),
                 lambda key: "B" if "attn" in key else "C" if "mlp_" in key else None)
        del params, pipe
        torch.cuda.empty_cache()


def paged_decode():
    from deepseek_ocr2_tpu_torch.ops.paged_attention import (
        paged_decode_attention,
        paged_decode_attention_pool,
        paged_decode_attention_reference,
    )

    # Kernel G at the serving shape (16 rows of 260..2048 tokens, one row on
    # the scratch page 0, pages of 128, 10 heads, layer 11 of 12) and at one
    # row of 300 tokens, f32 and bf16 pools; X (G's device code on a
    # per-sequence pool) at the 16 rows.
    scale = 128**-0.5
    for dt in (torch.float32, torch.bfloat16):
        n_pages, page = 64, 128
        k_pool = randn(12, n_pages, 10, page, 128, dtype=dt)
        v_pool = randn(12, n_pages, 10, page, 128, dtype=dt)
        for b in (16, 1):
            q = randn(b, 10, 128)
            bt = torch.randint(1, n_pages, (b, 2048 // page), device=dev, dtype=torch.int32, generator=g)
            if b > 1:
                bt[-1] = 0
            lens = (torch.linspace(260, 2048, b, device=dev).round() if b > 1
                    else torch.tensor([300.0], device=dev)).to(torch.int32)
            n_keys = int(lens.sum())
            ref = paged_decode_attention_reference(q, k_pool[11], v_pool[11], bt, lens, scale=scale)
            bound = cs.bound_ms(cs.nbytes(q, ref, bt, lens) + 2 * n_keys * 10 * 128 * k_pool.element_size(),
                                4 * n_keys * 10 * 128, torch.float32)
            record("G", f"pool {{tuple(k_pool.shape)}} {{str(dt)[6:]}}, B {{b}}, {{n_keys}} keys", ref,
                   paged_decode_attention_pool(q, k_pool, v_pool, bt, lens, 11, scale=scale), cs.F32_TOL,
                   cs.median_ms(lambda: paged_decode_attention_pool(q, k_pool, v_pool, bt, lens, 11, scale=scale)),
                   cs.median_ms(lambda: paged_decode_attention_reference(q, k_pool[11], v_pool[11], bt, lens,
                                                                         scale=scale)),
                   bound, graph=lambda: paged_decode_attention_pool(q, k_pool, v_pool, bt, lens, 11, scale=scale))
            if b > 1:
                record("X", f"per-sequence pool {{tuple(k_pool[11].shape)}} {{str(dt)[6:]}}, B {{b}}", ref,
                       paged_decode_attention(q, k_pool[11], v_pool[11], bt, lens, scale=scale), cs.F32_TOL,
                       cs.median_ms(lambda: paged_decode_attention(q, k_pool[11], v_pool[11], bt, lens, scale=scale)),
                       cs.median_ms(lambda: paged_decode_attention_reference(q, k_pool[11], v_pool[11], bt, lens,
                                                                             scale=scale)),
                       bound, graph=lambda: paged_decode_attention(q, k_pool[11], v_pool[11], bt, lens, scale=scale))
        del k_pool, v_pool
        torch.cuda.empty_cache()
    for dt in (torch.float32, torch.bfloat16):
        serve_step(dt)


def stacked_decode():
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    cs.stacked_results(dev, record)
    cfg = OCR2Config()
    flat = cs.random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    params = cs.load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype="float32")
    del flat
    pipe = OCR2Pipeline(params, cfg, cs.StubTokenizer(cfg.lm.vocab_size), device=dev)
    page = cs.synthetic_page(*cs.PAGES[0], cfg, seed=0)[0]
    for mode in ("pool", "stacked", "stacked", "pool"):
        with cs.switched(mode == "stacked"):
            t = cs.decode_per_token(pipe, page)
        print(f"[ab {{sys.argv[1]}}] decode per token, no-crop page, batch 1, LM bf16, {{mode}}: device "
              f"{{t['device_ms']:.3f}} ms, {{t['launches']:.1f}} device launches, wall {{t['wall_ms']:.2f}} ms "
              f"(torch.profiler)", flush=True)


def graph_parts(what, fn, reps=20):
    # fn captured in a CUDA graph and replayed `reps` times under
    # torch.profiler; from the exported trace, each replay's kernels in launch
    # order: every launch's mean device us, the mean gap before it (from the
    # end of the one before, inside a replay) and a replay's mean span.
    import json
    import tempfile
    from torch.profiler import ProfilerActivity, profile

    fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = tmp + "/trace.json"
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = sorted((e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"),
                            key=lambda e: e["ts"])
    # A replay's launches: the profiler may drop the first replay's first
    # events, so the calls are read from the end.
    n = round(len(events) / reps)
    calls = [events[len(events) - (r + 1) * n:len(events) - r * n] for r in range(reps - 1)]
    if n == 0 or any([e["name"] for e in c] != [e["name"] for e in calls[0]] for c in calls):
        print(f"[ab {{sys.argv[1]}}] {{what}}: {{len(events)}} kernel events for {{reps}} replays", flush=True)
        return
    reps -= 1
    cols = []
    for j in range(n):
        dur = sum(c[j]["dur"] for c in calls) / reps
        gap = sum(c[j]["ts"] - (c[j - 1]["ts"] + c[j - 1]["dur"]) for c in calls) / reps if j else 0.0
        name = calls[0][j]["name"].split("(")[0].split("<")[0].split("::")[-1]
        cols.append(f"{{name}} {{dur:.2f}} us (gap before {{gap:.2f}})")
    span = sum(c[-1]["ts"] + c[-1]["dur"] - c[0]["ts"] for c in calls) / reps
    print(f"[ab {{sys.argv[1]}}] {{what}}: span {{span:.2f}} us a call in a graph; " + "; ".join(cols), flush=True)


def kernel_parts():
    # The launches inside one call of K and O (B 1, cap 1024, pos 300, f32
    # and bf16 caches; B 16 at chip_smoke's ragged positions from 0) and of N
    # (B 16 and 32, E 64, k 6, 2 pseudo-experts), each in a CUDA graph:
    # every launch's device us and the gaps between them.
    from deepseek_ocr2_tpu_torch.configs import DeepseekV2Config
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import rope_consts
    from deepseek_ocr2_tpu_torch.ops import attn_fused, linear_q4, linear_q8, moe_q4
    from deepseek_ocr2_tpu_torch.ops.moe import route

    bf, f32 = torch.bfloat16, torch.float32
    cfg = DeepseekV2Config()
    h, hh, d = cfg.hidden_size, cfg.num_attention_heads, cfg.head_dim
    cos, sin = rope_consts(cfg, dev)
    for name, quant in (("K", linear_q8.quantize_linear), ("O", linear_q4.quantize_linear_q4)):
        attn = {{"wqkv": quant(randn(3 * h, h, std=h**-0.5)), "wo": quant(randn(h, h, std=h**-0.5))}}
        for b, kv_dt in ((1, f32), (1, bf), (16, f32), (16, bf)):
            cap = 1024
            k_all = randn(2, b, hh, cap, d, std=0.5, dtype=kv_dt)
            v_all = randn(2, b, hh, cap, d, dtype=kv_dt)
            xn = randn(b, 1, h, dtype=bf)
            pos = [300] if b == 1 else [0] + torch.linspace(1, cap - 1, b - 1).round().int().tolist()
            pos_b = torch.tensor(pos, dtype=torch.int32, device=dev)
            graph_parts(f"{{name}} B {{b}} cap {{cap}} pos {{pos[0] if b == 1 else '0..1023'}}, {{str(kv_dt)[6:]}} cache",
                        lambda: attn_fused.attn_decode_fused(xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b))
            del k_all, v_all
    e, k, i, n_sh = 64, 6, 896, 2

    def experts(n):
        return moe_q4.quantize_experts_q4({{"gate": randn(n, i, h, std=h**-0.5), "up": randn(n, i, h, std=h**-0.5),
                                           "down": randn(n, h, i, std=i**-0.5)}})

    eq = {{**experts(e), **{{f"pe_{{n}}": t for n, t in experts(n_sh).items()}}}}
    router = randn(e, h, std=h**-0.5)
    for b in (16, 32):
        x = randn(b, h, dtype=bf)
        wts, idx = route(x, router, k)
        graph_parts(f"N B {{b}}: {{int(torch.unique(idx).numel())}} experts + {{n_sh}} pseudo-experts",
                    lambda: moe_q4.moe_ffn_decode_q4_fused(x, eq, wts, idx))
    del eq
    torch.cuda.empty_cache()


def moe_q4_sel():
    # Kernel M (the per-selection int4 MoE) at one int4 MoE decode layer of
    # the served LM (E 64 + 2 pseudo-experts, k 6, H 1280, I 896, a random
    # f32 router): B 1 with the pseudo-experts, 8 and 10 without, against
    # its twin, through the wrapper and in a CUDA graph, with its bound;
    # then the layer as M and as N in a CUDA graph at B 8, 11 and 16 (the
    # B k <= E cut-over).
    from deepseek_ocr2_tpu_torch.ops import moe_q4
    from deepseek_ocr2_tpu_torch.ops.moe import route

    bf = torch.bfloat16
    e, k, h, i, n_sh = 64, 6, 1280, 896, 2

    def experts(n):
        return moe_q4.quantize_experts_q4({{"gate": randn(n, i, h, std=h**-0.5), "up": randn(n, i, h, std=h**-0.5),
                                           "down": randn(n, h, i, std=i**-0.5)}})

    eq = experts(e)
    eq_pe = {{**eq, **{{f"pe_{{n}}": t for n, t in experts(n_sh).items()}}}}
    router = randn(e, h, std=h**-0.5)
    e_bytes = cs.nbytes(*(eq[n][0] for n in ("gu_q4", "gu_scale", "down_q4", "down_scale")))
    for b, shared in ((1, True), (8, False), (10, False)):
        x = randn(b, h, dtype=bf)
        wts, idx = route(x, router, k)
        args = (x, eq_pe, wts, idx)
        n_read = int(torch.unique(idx).numel()) + (n_sh if shared else 0)
        ref = moe_q4.moe_ffn_decode_q4_reference(*args, with_shared=shared)
        record("M", f"B {{b}}{{' + 2 pseudo-experts' if shared else ''}}: {{n_read}} experts read, bf16", ref,
               moe_q4.moe_ffn_decode_q4(*args, with_shared=shared), cs.tolerance(ref, bf),
               cs.median_ms(lambda: moe_q4.moe_ffn_decode_q4(*args, with_shared=shared)),
               cs.median_ms(lambda: moe_q4.moe_ffn_decode_q4_reference(*args, with_shared=shared)),
               cs.bound_ms(cs.nbytes(x, ref, wts, idx) + n_read * e_bytes,
                           2 * b * (k + (n_sh if shared else 0)) * 3 * h * i, bf),
               graph=lambda: moe_q4.moe_ffn_decode_q4(*args, with_shared=shared))
    for b in (8, 11, 16):
        x = randn(b, h, dtype=bf)
        args = (x, eq, *route(x, router, k))
        print(f"[ab {{sys.argv[1]}}] cut-over, one int4 MoE decode layer, B {{b}}: M graph "
              f"{{cs.graph_ms(lambda: moe_q4.moe_ffn_decode_q4(*args)):.4f}} ms, N graph "
              f"{{cs.graph_ms(lambda: moe_q4.moe_ffn_decode_q4_fused(*args)):.4f}} ms", flush=True)
    del eq, eq_pe
    torch.cuda.empty_cache()


def decode_quant():
    # Decode per token of a no-crop page at batch 1 on the contiguous cache,
    # the LM quantized as --int8 (K, H, I) and as --int4 (O, L, M), two
    # readings each: device ms and launches a token (as chip_smoke's
    # decode_per_token: 1 and 17 new tokens under torch.profiler, the
    # difference over 16), and K's or O's share: the device time of its
    # attention kernel, and the span on the device of its three launches (a
    # record_function range around the wrapper's launch: the range's GPU
    # annotation); with --int4 M's device time and launches too.
    from torch.profiler import ProfilerActivity, profile, record_function

    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import quantize_lm_params
    from deepseek_ocr2_tpu_torch.ops import attn_fused
    from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate
    from deepseek_ocr2_tpu_torch.runtime.kv_cache import bucket_capacity
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline
    from deepseek_ocr2_tpu_torch.utils.tokenizer import tokenize_with_image

    cfg = OCR2Config()
    flat = cs.random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    params = cs.load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype="float32")
    del flat
    pipe = OCR2Pipeline(params, cfg, cs.StubTokenizer(cfg.lm.vocab_size), device=dev)
    page = cs.synthetic_page(*cs.PAGES[0], cfg, seed=0)[0]
    base, patches, ratio, _ = pipe.preprocess_finish(page if isinstance(page, dict) else pipe.preprocess_host(page))
    ids, _, start = tokenize_with_image(pipe.tokenizer, cfg.default_ocr_prompt, cfg, ratio)
    embeds = pipe.build_ocr_embeds(ids, base, patches, start)
    launch = attn_fused._launch

    def ranged(*a):
        with record_function("fused attention"):
            return launch(*a)

    attn_fused._launch = ranged

    def measure(lm, m):
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            greedy_generate(lm, cfg.lm, embeds, torch.tensor(ids), max_new_tokens=m, ngram_size=20, eos_id=-1,
                            capacity=bucket_capacity(len(ids) + m), kv_dtype=pipe.kv_dtype, rope=pipe.rope)
            torch.cuda.synchronize(dev)
        rows = prof.key_averages()
        kern = [e for e in rows if e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        attn = sum(e.self_device_time_total for e in kern if "attn_" in e.key) / 1e3
        rng = [e for e in rows if e.key == "fused attention" and e.device_type == torch.autograd.DeviceType.CPU]
        calls = sum(e.count for e in rng)
        # The range's span on the device (its GPU user annotation: from its
        # first launch's start to its last one's end).
        span = sum(e.self_device_time_total for e in rows if e.key == "fused attention"
                   and e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        m_rows = [e for e in kern if is_m(e.key)]
        return (busy, sum(e.count for e in kern), attn, span, calls,
                sum(e.self_device_time_total for e in m_rows) / 1e3, sum(e.count for e in m_rows))

    def is_m(key):
        # Kernel M's launches: its stream's two kernels, or its first form's
        # three (moe_quant's int4 swiglu and down, the per-selection combine).
        return ("sel_gu_q4" in key or "sel_down_q4" in key or ("moe_quant::" in key and "Q4" in key)
                or "combine_kernel<__nv_bfloat16, true>" in key)

    bf16_lm = params["lm"]
    for flag, bits, kernel in (("--int8", 8, "K"), ("--int4", 4, "O")):
        lm = quantize_lm_params(bf16_lm, scope="full", bits=bits)
        n = 16
        measure(lm, n + 1)  # warm-up
        for rep in range(2):
            one, many = measure(lm, 1), measure(lm, n + 1)
            dev_ms, launches, attn_ms, span_ms, calls, m_ms, m_launches = ((b - a) / n for a, b in zip(one, many))
            m_part = f"; M {{m_ms:.3f}} ms in {{m_launches:.1f}} launches" if bits == 4 else ""
            print(f"[ab {{sys.argv[1]}}] decode per token, no-crop page, batch 1, LM {{flag}}, run {{rep}}: device "
                  f"{{dev_ms:.3f}} ms in {{launches:.1f}} launches; {{kernel}}'s attention kernel {{attn_ms:.3f}} ms "
                  f"({{100 * attn_ms / dev_ms:.1f}} %), {{kernel}}'s span on the device {{span_ms:.3f}} ms "
                  f"({{100 * span_ms / dev_ms:.1f}} %) in {{calls:.1f}} calls{{m_part}}", flush=True)
        del lm
        torch.cuda.empty_cache()
    attn_fused._launch = launch


for phase in {phases!r}:
    if phase == "gmm_forward":
        cs.gmm_results(dev, randn, record)
    elif phase == "gmm_chain":
        gmm_chain()
    elif phase == "visit":
        cs.visit_results(dev, randn, record)
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
    elif phase == "sam_windows":
        sam_windows()
    elif phase == "stacked_decode":
        stacked_decode()
    elif phase == "decode_moe":
        decode_moe()
    elif phase == "sam_mlp":
        sam_mlp()
    elif phase == "paged_decode":
        paged_decode()
    elif phase == "paged_q8":
        cs.paged_q8_results(dev, record)
        for pool_dtype in ("int8", "int8tail"):
            serve_step(pool_dtype)
    elif phase == "paged_chunk":
        cs.chunk_results(dev, record)
        serve_step(torch.bfloat16, lookup=True)
        serve_step("int8tail", lookup=True)
    elif phase == "moe_q8":
        cs.q8_results(dev, randn, record)
        cs.q4_results(dev, randn, record)
        serve_step(torch.bfloat16, bits=8)
        serve_step(torch.bfloat16, bits=4)
    elif phase == "kernel_parts":
        kernel_parts()
    elif phase == "decode_quant":
        decode_quant()
    elif phase == "moe_q4_sel":
        moe_q4_sel()
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
