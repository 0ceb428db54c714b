#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`deepseek_ocr2_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):
1. device: require CUDA, print the card's name and power limit, build the
   hand-written kernels from `deepseek_ocr2_tpu_torch/csrc/` (one nvcc per
   source, all started together);
2. kernels: each CUDA kernel against its plain PyTorch twin on the card at
   the main path's shapes (no-crop and crop pages), with the max abs error
   beside its tolerance and both median times (CUDA events); the grouped-
   GEMM MoE (D, E) also whole against its grouped twin, and once under
   `torch.cuda.set_sync_debug_mode("error")` (no host sync);
3. model: HF-layout random weights for the full-width default OCR2Config
   (about 3.4 B parameters) from a seeded torch.Generator on the card,
   loaded through `params_from_flat` with the CLI's default dtype policy
   (LM bf16, vision f32);
4. main path: `OCR2Pipeline.generate_ocr` on 3 synthetic no-crop pages and
   2 crop pages (grids (2, 1) and (2, 3)); every kernel must launch, D and
   E once per MoE layer on a crop page and never on a no-crop page, every
   step-0 logit must be finite;
5. card vs CPU: full widths at reduced depth, f32, the same numpy-seeded
   weights, a no-crop page and a (2, 1) crop page (over 512 prompt tokens:
   D and E on the card, the grouped twin on the CPU); step-0 logits within
   tolerance, greedy tokens compared.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports neither jax nor PIL, tokenizers or safetensors (PIL is used for the
pages only if it is installed).
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SEED = 0
PAGES = [(700, 500), (768, 768), (420, 640)]  # (w, h): both sides <= 768 -> no crop
CROP_PAGES = [(1400, 800, (2, 1)), (1700, 2200, (2, 3))]  # (w, h, the crop grid it takes)
KERNEL_SOURCES = ("flash_attention", "fused_mlp", "moe_gmm")

# Tolerances on max |kernel - twin| (both on the card, same inputs):
# - f32: the kernels take sums in another order and A/B take an online
#   softmax over key tiles instead of a full-row one; outputs are O(1), so
#   f32 rounding stays far below 1e-4.
# - bf16: both sides round the same f32 values to bf16 at the same points;
#   an f32 sum that lands on the other side of a rounding boundary moves
#   an output by one bf16 ulp (2^-8 relative), and in C such a flip of the
#   hidden activation propagates through the down product. The bound is 4
#   ulps of the largest output.
F32_TOL = 1e-4


def bf16_tol(ref: torch.Tensor) -> float:
    return 4 * 2.0**-8 * max(1.0, float(ref.abs().max()))


def tolerance(ref: torch.Tensor, dtype: torch.dtype) -> float:
    return F32_TOL if dtype == torch.float32 else bf16_tol(ref)


# Step-0 logits, card vs CPU, f32 at reduced depth: every layer's sums are
# taken in another order (cuBLAS vs the CPU BLAS, the kernels vs the twins);
# the bound is relative to the largest logit.
LOGITS_RTOL = 1e-3


class StubTokenizer:
    """Pure-Python stand-in with the `encode(...).ids` / `decode` interface:
    whitespace words map to stable ids in [2, vocab_size)."""

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    class _Enc:
        def __init__(self, ids):
            self.ids = ids

    def encode(self, text, add_special_tokens=False):
        ids = []
        for word in text.split():
            h = 0
            for ch in word.encode():
                h = (h * 131 + ch) % 65536
            ids.append(2 + h % (self.vocab_size - 2))
        return self._Enc(ids)

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(f"<{i}>" for i in ids)


# ---------------------------------------------------------------------------
# Timing


def median_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phase 1


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke run needs a GPU")
    from deepseek_ocr2_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)  # as nvidia-smi gives it, on a line of its own
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:  # nvcc runs as a child process
        list(pool.map(cuda_build.load, KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        log = cuda_build.BUILD_LOG.get(name, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"[build] {name}: {cuda_build.BUILD_SECONDS.get(name, 0.0):.1f} s, "
              f"{len(regs)} kernels, registers <= {max(regs, default=0)}, "
              f"spill stores <= {max(spills, default=0)} bytes")
    return smi


# ---------------------------------------------------------------------------
# Phase 2


def gmm_results(dev, randn, record) -> None:
    """Kernels D and E at the LM's MoE shapes (E = 64, k = 6, H = 1280,
    I = 896) for the prompts of a 2-crop and a 6-crop page (N = 550, 1125),
    routed by a random f32 router: each kernel alone against its per-tile
    twin on the same aligned rows, then the whole `moe_ffn_gmm` against the
    grouped twin `moe_ffn_gmm_reference`, and the dense form's time at
    N = 550 (the 512-row cut-over). One call runs in sync-debug mode."""
    from deepseek_ocr2_tpu_torch.ops import moe_gmm
    from deepseek_ocr2_tpu_torch.ops.moe import moe_ffn_dense, route

    e, k, h, i = 64, 6, 1280, 896
    for n in (550, 1125):
        for dt in (torch.bfloat16, torch.float32):
            x = randn(n, h, dtype=dt)
            ex = {
                "gate": randn(e, i, h, std=h**-0.5, dtype=dt),
                "up": randn(e, i, h, std=h**-0.5, dtype=dt),
                "down": randn(e, h, i, std=i**-0.5, dtype=dt),
            }
            weights, idx = route(x, randn(e, h, std=h**-0.5), k)
            x_al, e_tile, tile_valid, _ = moe_gmm.align_rows(x, idx, e)
            n_valid = int(tile_valid.sum())
            dts = str(dt)[6:]
            case = f"N {n} k {k}: {tile_valid.numel()} tiles, {n_valid} valid, {dts}"

            args_d = (x_al, ex["gate"], ex["up"], e_tile, tile_valid)
            act = moe_gmm.gmm_swiglu_reference(*args_d)
            got = moe_gmm.moe_gmm_swiglu(*args_d)
            record("D", f"swiglu {case}", act, got, tolerance(act, dt),
                   median_ms(lambda: moe_gmm.moe_gmm_swiglu(*args_d)),
                   median_ms(lambda: moe_gmm.gmm_swiglu_reference(*args_d)))
            args_e = (act, ex["down"], e_tile, tile_valid)
            y = moe_gmm.gmm_down_reference(*args_e)
            got = moe_gmm.moe_gmm_down(*args_e)
            record("E", f"down {case}", y, got, tolerance(y, dt),
                   median_ms(lambda: moe_gmm.moe_gmm_down(*args_e)),
                   median_ms(lambda: moe_gmm.gmm_down_reference(*args_e)))
            del act, got, y, args_d, args_e

            args = (x, ex, weights, idx)
            ref = moe_gmm.moe_ffn_gmm_reference(*args)
            got = moe_gmm.moe_ffn_gmm(*args)
            record("D+E", f"moe_ffn_gmm vs grouped twin, {case}", ref, got, tolerance(ref, dt),
                   median_ms(lambda: moe_gmm.moe_ffn_gmm(*args)),
                   median_ms(lambda: moe_gmm.moe_ffn_gmm_reference(*args)))
            if n == 550:
                print(f"[kernel] dense all-expert MoE N {n} {dts}: "
                      f"{median_ms(lambda: moe_ffn_dense(*args)):.3f} ms")
            if n == 1125 and dt == torch.bfloat16:
                torch.cuda.synchronize(dev)
                torch.cuda.set_sync_debug_mode("error")
                try:
                    moe_gmm.moe_ffn_gmm(*args)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize(dev)
                print(f"[kernel] moe_ffn_gmm under set_sync_debug_mode('error'), {case}: no host sync ok")
            del x, ex, args, ref, got
    torch.cuda.empty_cache()


def phase_kernels(dev) -> dict:
    from deepseek_ocr2_tpu_torch.ops.flash_attention import mha, mha_reference, mha_relpos
    from deepseek_ocr2_tpu_torch.ops.fused_mlp import mlp_gelu, mlp_gelu_reference

    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    results = {}

    def record(kernel, case, ref, got, tol, ms, plain_ms):
        err = float((got.float() - ref.float()).abs().max())
        ok = err <= tol and bool(torch.isfinite(got.float()).all())
        print(f"[kernel] {kernel} {case}: max_abs_err {err:.3e} (tol {tol:.1e}) "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} {case}: error {err} above {tol}")
        results.setdefault(kernel, []).append(
            dict(case=case, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms)
        )

    # D, E: the routed-expert MoE of a crop prompt at full LM width (bf16,
    # the CLI's LM dtype, first: it is the main-path case of the record).
    gmm_results(dev, randn, record)

    # B: SAM global [1, 12, 4096, 64] (64 x 64 grid) and windows [25, 12, 196, 64]
    # (14 x 14) of the 1024^2 view; at a 6-crop page the crops' global
    # [6, 12, 2304, 64] (48 x 48) and windows [96, 12, 196, 64], f32.
    cases = [("global", 1, 64, dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [("window", 25, 14, dt) for dt in (torch.float32, torch.bfloat16)]
    cases += [("crop global", 6, 48, torch.float32), ("crop window", 96, 14, torch.float32)]
    for case, b, side, dt in cases:
        l = side * side
        q, k, v = (randn(b, 12, l, 64, dtype=dt) for _ in range(3))
        rh, rw = randn(b, 12, l, side, std=0.3), randn(b, 12, l, side, std=0.3)
        scale = 1.0 / 8.0
        ref = mha_reference(q, k, v, scale=scale, rel_h=rh, rel_w=rw)
        got = mha_relpos(q, k, v, rh, rw, scale=scale)
        ms = median_ms(lambda: mha_relpos(q, k, v, rh, rw, scale=scale))
        plain = median_ms(lambda: mha_reference(q, k, v, scale=scale, rel_h=rh, rel_w=rw))
        record("B", f"{case} {tuple(q.shape)} {str(dt)[6:]}", ref, got, tolerance(ref, dt), ms, plain)
        del q, k, v, rh, rw, ref, got

    # A: LM prefill, causal, f32: a no-crop prompt [1, 10, 260, 128] and a
    # 6-crop one [1, 10, 1125, 128].
    for length in (260, 1125):
        q, k, v = (randn(1, 10, length, 128) for _ in range(3))
        scale = 1.0 / math.sqrt(128)
        ref = mha_reference(q, k, v, scale=scale, mode="causal")
        got = mha(q, k, v, scale=scale, mode="causal")
        ms = median_ms(lambda: mha(q, k, v, scale=scale, mode="causal"))
        plain = median_ms(lambda: mha_reference(q, k, v, scale=scale, mode="causal"))
        record("A", f"causal {tuple(q.shape)} float32", ref, got, F32_TOL, ms, plain)

    # C: SAM MLP 768 -> 3072 -> 768, M = 4096 (one 1024^2 view) and, f32,
    # M = 6 * 2304 = 13824 (six 768^2 crops in one batch).
    for m, dt in ((4096, torch.float32), (4096, torch.bfloat16), (6 * 2304, torch.float32)):
        x = randn(m, 768, dtype=dt)
        w1, b1 = randn(3072, 768, std=768**-0.5, dtype=dt), randn(3072, std=0.02, dtype=dt)
        w2, b2 = randn(768, 3072, std=3072**-0.5, dtype=dt), randn(768, std=0.02, dtype=dt)
        ref = mlp_gelu_reference(x, w1, b1, w2, b2)
        got = mlp_gelu(x, w1, b1, w2, b2)
        ms = median_ms(lambda: mlp_gelu(x, w1, b1, w2, b2))
        plain = median_ms(lambda: mlp_gelu_reference(x, w1, b1, w2, b2))
        record("C", f"{tuple(x.shape)} x {tuple(w1.shape)} {str(dt)[6:]}", ref, got, tolerance(ref, dt), ms, plain)
    torch.cuda.synchronize(dev)
    return results


# ---------------------------------------------------------------------------
# Weights


def random_hf_flat(cfg, randn) -> dict:
    """HF-layout random weights for an OCR2Config. `randn(shape, std)`
    returns an f32 tensor; linears use std fan_in^-1/2, norms 1 + noise."""
    lm, sam, qw = cfg.lm, cfg.sam, cfg.qwen2
    flat = {}

    def lin(name, out_f, in_f):
        flat[name] = randn((out_f, in_f), in_f**-0.5)

    def ones(name, n):
        flat[name] = 1.0 + randn((n,), 0.02)

    h = lm.hidden_size
    flat["model.embed_tokens.weight"] = randn((lm.vocab_size, h), 1.0)
    ones("model.norm.weight", h)
    lin("lm_head.weight", lm.vocab_size, h)
    for i in range(lm.num_hidden_layers):
        lp = f"model.layers.{i}."
        ones(lp + "input_layernorm.weight", h)
        ones(lp + "post_attention_layernorm.weight", h)
        for n in "qkvo":
            lin(f"{lp}self_attn.{n}_proj.weight", h, h)
        if i < lm.first_k_dense_replace:
            lin(lp + "mlp.gate_proj.weight", lm.intermediate_size, h)
            lin(lp + "mlp.up_proj.weight", lm.intermediate_size, h)
            lin(lp + "mlp.down_proj.weight", h, lm.intermediate_size)
        else:
            lin(lp + "mlp.gate.weight", lm.n_routed_experts, h)
            im = lm.moe_intermediate_size
            for e in range(lm.n_routed_experts):
                ep = f"{lp}mlp.experts.{e}."
                lin(ep + "gate_proj.weight", im, h)
                lin(ep + "up_proj.weight", im, h)
                lin(ep + "down_proj.weight", h, im)
            ish = im * lm.n_shared_experts
            lin(lp + "mlp.shared_experts.gate_proj.weight", ish, h)
            lin(lp + "mlp.shared_experts.up_proj.weight", ish, h)
            lin(lp + "mlp.shared_experts.down_proj.weight", h, ish)

    sp = "model.sam_model."
    e, p, side = sam.embed_dim, sam.patch_size, sam.tokens_per_side
    flat[sp + "patch_embed.proj.weight"] = randn((e, 3, p, p), (3 * p * p) ** -0.5)
    flat[sp + "patch_embed.proj.bias"] = randn((e,), 0.02)
    flat[sp + "pos_embed"] = randn((1, side, side, e), 0.02)
    f = int(e * sam.mlp_ratio)
    for i in range(sam.depth):
        bp = f"{sp}blocks.{i}."
        size = side if i in sam.global_attn_indexes else sam.window_size
        ones(bp + "norm1.weight", e)
        ones(bp + "norm2.weight", e)
        flat[bp + "norm1.bias"] = randn((e,), 0.02)
        flat[bp + "norm2.bias"] = randn((e,), 0.02)
        lin(bp + "attn.qkv.weight", 3 * e, e)
        flat[bp + "attn.qkv.bias"] = randn((3 * e,), 0.02)
        lin(bp + "attn.proj.weight", e, e)
        flat[bp + "attn.proj.bias"] = randn((e,), 0.02)
        flat[bp + "attn.rel_pos_h"] = randn((2 * size - 1, sam.head_dim), 0.1)
        flat[bp + "attn.rel_pos_w"] = randn((2 * size - 1, sam.head_dim), 0.1)
        lin(bp + "mlp.lin1.weight", f, e)
        flat[bp + "mlp.lin1.bias"] = randn((f,), 0.02)
        lin(bp + "mlp.lin2.weight", e, f)
        flat[bp + "mlp.lin2.bias"] = randn((e,), 0.02)
    oc = sam.out_chans
    flat[sp + "neck.0.weight"] = randn((oc, e, 1, 1), e**-0.5)
    ones(sp + "neck.1.weight", oc)
    flat[sp + "neck.1.bias"] = randn((oc,), 0.02)
    flat[sp + "neck.2.weight"] = randn((oc, oc, 3, 3), (9 * oc) ** -0.5)
    ones(sp + "neck.3.weight", oc)
    flat[sp + "neck.3.bias"] = randn((oc,), 0.02)
    flat[sp + "net_2.weight"] = randn((sam.net_2_chans, oc, 3, 3), (9 * oc) ** -0.5)
    flat[sp + "net_3.weight"] = randn((sam.net_3_chans, sam.net_2_chans, 3, 3), (9 * sam.net_2_chans) ** -0.5)

    qp = "model.qwen2_model."
    mp = qp + "model.model."
    qh, qi, kvh = qw.hidden_size, qw.intermediate_size, qw.num_key_value_heads * qw.head_dim
    ones(mp + "norm.weight", qh)
    flat[qp + "query_768.weight"] = randn((qw.n_query_768, qh), 1.0)
    flat[qp + "query_1024.weight"] = randn((qw.n_query_1024, qh), 1.0)
    for i in range(qw.num_hidden_layers):
        lp = f"{mp}layers.{i}."
        ones(lp + "input_layernorm.weight", qh)
        ones(lp + "post_attention_layernorm.weight", qh)
        lin(lp + "self_attn.q_proj.weight", qh, qh)
        lin(lp + "self_attn.k_proj.weight", kvh, qh)
        lin(lp + "self_attn.v_proj.weight", kvh, qh)
        for n, width in (("q", qh), ("k", kvh), ("v", kvh)):
            flat[f"{lp}self_attn.{n}_proj.bias"] = randn((width,), 0.02)
        lin(lp + "self_attn.o_proj.weight", qh, qh)
        lin(lp + "mlp.gate_proj.weight", qi, qh)
        lin(lp + "mlp.up_proj.weight", qi, qh)
        lin(lp + "mlp.down_proj.weight", qh, qi)

    lin("model.projector.layers.weight", h, cfg.projector_in)
    flat["model.projector.layers.bias"] = randn((h,), 0.02)
    flat["model.view_seperator"] = randn((h,), 0.02)
    return flat


def load_model(cfg, flat, device, lm_dtype: str, vision_dtype: str):
    from deepseek_ocr2_tpu_torch.io import DtypePolicy
    from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as ocr2

    policy = DtypePolicy(default=lm_dtype)
    for prefix in ("model.sam_model", "model.qwen2_model", "model.projector", "model.view_seperator"):
        policy = policy.with_prefix(prefix, vision_dtype)
    params, report = ocr2.params_from_flat(flat, cfg, device=device, policy=policy)
    report.raise_on_errors()
    if report.missing or report.skipped:
        raise AssertionError(f"weights missing {report.missing[:4]} skipped {report.skipped[:4]}")
    return params


def synthetic_page(w: int, h: int, cfg, seed: int, grid=(1, 1)):
    """A page with text-like dark strokes. Returns a PIL image when PIL is
    installed (the pipeline then decides the crop grid itself); otherwise
    the host-stage dict of the pipeline: the page drawn straight at its
    letterboxed size into a [1, 3, S, S] uint8 canvas of pad colour 127 and,
    for a crop grid (gw, gh), drawn at gw x gh crop sizes and cut into
    [gw * gh, 3, c, c] row-major tiles."""
    rng = np.random.default_rng(seed)
    try:
        from PIL import Image
    except ImportError:
        Image = None

    def draw(w, h):
        page = np.full((h, w, 3), 235, np.uint8)
        for _ in range(40 * max(1, w * h // 10**6)):
            y, x = int(rng.integers(0, h - 8)), int(rng.integers(0, w - 60))
            page[y : y + 6, x : x + int(rng.integers(20, 60))] = rng.integers(0, 60, 3, dtype=np.uint8)
        return page

    if Image is not None:
        return Image.fromarray(draw(w, h)), "pil"
    size = cfg.base_image_size
    scale = min(size / w, size / h)
    bw, bh = max(round(w * scale), 1), max(round(h * scale), 1)
    canvas = np.full((1, 3, size, size), 127, np.uint8)
    y0, x0 = (size - bh) // 2, (size - bw) // 2
    canvas[0, :, y0 : y0 + bh, x0 : x0 + bw] = draw(bw, bh).transpose(2, 0, 1)
    pre = {"base": canvas, "rot": 0}
    if grid != (1, 1):
        c, (gw, gh) = cfg.crop_image_size, grid
        big = draw(gw * c, gh * c).transpose(2, 0, 1)
        pre["patches"] = np.stack(
            [big[:, r * c : (r + 1) * c, q * c : (q + 1) * c] for r in range(gh) for q in range(gw)]
        )
        pre["ratio"] = grid
    return pre, "host-stage dict"


# ---------------------------------------------------------------------------
# Phases 3-4


def counters():
    from deepseek_ocr2_tpu_torch.ops.flash_attention import mha, mha_relpos
    from deepseek_ocr2_tpu_torch.ops.fused_mlp import mlp_gelu
    from deepseek_ocr2_tpu_torch.ops.moe_gmm import moe_gmm_down, moe_gmm_swiglu

    return {"A": mha, "B": mha_relpos, "C": mlp_gelu, "D": moe_gmm_swiglu, "E": moe_gmm_down}


def phase_main_path(dev) -> dict:
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    cfg = OCR2Config()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    flat = random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    n_params = sum(t.numel() for t in flat.values())
    params = load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype="float32")
    del flat
    torch.cuda.synchronize(dev)
    print(f"[model] full width, {n_params / 1e9:.3f} B parameters, LM bf16 / vision f32, "
          f"made and loaded in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB on the card")

    pipe = OCR2Pipeline(params, cfg, StubTokenizer(cfg.lm.vocab_size), device=dev, kv_dtype="float32", act_dtype="float32")
    kernels = counters()
    pages = [(f"{w}x{h}", (1, 1), *synthetic_page(w, h, cfg, seed=i)) for i, (w, h) in enumerate(PAGES)]
    pages += [(f"{w}x{h} crop", grid, *synthetic_page(w, h, cfg, seed=10 + i, grid=grid))
              for i, (w, h, grid) in enumerate(CROP_PAGES)]
    print(f"[main] pages handed to the pipeline as {pages[0][3]}")
    for fn in kernels.values():
        fn.launches = 0
    for name, grid, page, _ in pages:
        before = {k: fn.launches for k, fn in kernels.items()}
        r = pipe.generate_ocr(page, max_new_tokens=32, ngram_size=20)
        delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
        finite = bool(torch.isfinite(r.logits0).all())
        print(f"[main] page {name}: crop grid {r.crop_ratio}, prompt {r.prompt_len} tokens, "
              f"vision {r.vision_seconds * 1e3:.1f} ms, prefill {r.prefill_seconds * 1e3:.1f} ms, "
              f"decode {r.decode_seconds * 1e3:.1f} ms for {r.new_tokens} tokens "
              f"({r.decode_tokens_per_sec:.1f} tok/s), launches {delta}, logits finite {finite}")
        print(f"[main]   tokens {r.token_ids[r.prompt_len:]}")
        if not finite:
            raise AssertionError(f"page {name}: non-finite step-0 logits")
        if r.crop_ratio != grid:
            raise AssertionError(f"page {name}: crop grid {r.crop_ratio}, expected {grid}")
        moe_launches = cfg.lm.num_moe_layers if grid != (1, 1) else 0  # crop prompts are > 512 rows
        if delta["D"] != moe_launches or delta["E"] != moe_launches:
            raise AssertionError(f"page {name}: D/E launched {delta['D']}/{delta['E']} times, "
                                 f"expected {moe_launches} (one per MoE layer in prefill)")
        if grid != (1, 1) and min(delta[k] for k in "ABC") == 0:
            raise AssertionError(f"page {name}: a kernel of A, B, C did not launch: {delta}")
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"[main] launches over {len(pages)} pages {launches}")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    del pipe, params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 5


def phase_card_vs_cpu(dev) -> None:
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    base = OCR2Config()
    cfg = dataclasses.replace(
        base,
        lm=dataclasses.replace(base.lm, num_hidden_layers=2),
        qwen2=dataclasses.replace(base.qwen2, num_hidden_layers=2),
        sam=dataclasses.replace(base.sam, depth=3, global_attn_indexes=(2,)),
    )
    rng = np.random.default_rng(SEED + 1)
    flat = random_hf_flat(
        cfg, lambda shape, std: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(std))
    )
    w, h, grid = CROP_PAGES[0]
    pages = {"no-crop": synthetic_page(*PAGES[0], cfg, seed=99)[0],
             f"{grid} crop": synthetic_page(w, h, cfg, seed=98, grid=grid)[0]}
    kernels = counters()
    results = {}
    for device in ("cpu", dev):
        params = load_model(cfg, flat, device, lm_dtype="float32", vision_dtype="float32")
        pipe = OCR2Pipeline(params, cfg, StubTokenizer(cfg.lm.vocab_size), device=device, kv_dtype="float32", act_dtype="float32")
        for name, page in pages.items():
            before = {k: fn.launches for k, fn in kernels.items()}
            t0 = time.perf_counter()
            r = results[name, str(device)] = pipe.generate_ocr(page, max_new_tokens=8, ngram_size=20, keep_logits=True)
            delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
            print(f"[cpu-vs-card] {name} page on {device}: prompt {r.prompt_len} tokens, "
                  f"{time.perf_counter() - t0:.1f} s, launches {delta}")
            if name != "no-crop" and device != "cpu" and (delta["D"] == 0 or delta["E"] == 0):
                raise AssertionError(f"{name} page: the card's MoE did not run D and E")
        del pipe, params
    for name in pages:
        cpu, card = results[name, "cpu"], results[name, str(dev)]
        err = float((cpu.logits0 - card.logits0).abs().max())
        tol = LOGITS_RTOL * float(cpu.logits0.abs().max())
        print(f"[cpu-vs-card] {name}: step-0 logits max_abs_err {err:.3e} (tol {tol:.3e}, "
              f"max |logit| {float(cpu.logits0.abs().max()):.3f})")
        if not err <= tol:
            raise AssertionError(f"{name}: step-0 logits differ by {err}, above {tol}")
        a, b = cpu.token_ids[cpu.prompt_len:], card.token_ids[card.prompt_len:]
        print(f"[cpu-vs-card] {name}: greedy tokens agree: {a == b} (cpu {a}, card {b})")
        if a != b:
            step = next(i for i in range(min(len(a), len(b))) if a[i] != b[i])
            top2 = torch.topk(cpu.step_logits[step], 2).values
            print(f"[cpu-vs-card] {name}: first difference at step {step}: cpu top-2 margin "
                  f"{float(top2[0] - top2[1]):.3e}")


# ---------------------------------------------------------------------------


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import deepseek_ocr2_tpu_torch  # noqa: F401  (sets the f32 numerics flags)

    dev = torch.device("cuda", 0)
    smi = phase_device()
    results = phase_kernels(dev)
    launches = phase_main_path(dev)
    phase_card_vs_cpu(dev)
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    meta = {
        "A": ("flash_attention.mha causal (LM prefill)", "deepseek_ocr2_tpu/ops/flash_attention.py:54"),
        "B": ("flash_attention.mha_relpos (SAM attention)", "deepseek_ocr2_tpu/ops/flash_attention.py:101"),
        "C": ("fused_mlp.mlp_gelu (SAM MLP)", "deepseek_ocr2_tpu/ops/fused_mlp.py:66"),
        "D": ("moe_gmm.moe_gmm_swiglu (grouped-GEMM MoE prefill, gate/up + SwiGLU)",
              "deepseek_ocr2_tpu/ops/moe_gmm.py:223"),
        "E": ("moe_gmm.moe_gmm_down (grouped-GEMM MoE prefill, down)", "deepseek_ocr2_tpu/ops/moe_gmm.py:237"),
    }
    sources = {"A": "flash_attention.cu", "B": "flash_attention.cu", "C": "fused_mlp.cu",
               "D": "moe_gmm.cu", "E": "moe_gmm.cu"}
    record = {"kernels": []}
    for k in ("A", "B", "C", "D", "E"):
        # The first case is the main path's: f32 at the no-crop shapes for
        # A, B (SAM global) and C; bf16 at the 2-crop prompt for D and E.
        main_case = results[k][0]
        record["kernels"].append({
            "name": meta[k][0],
            "route": "cuda",
            "source": f"deepseek_ocr2_tpu_torch/csrc/{sources[k]}",
            "replaces": meta[k][1],
            "launches": launches[k],
            "max_abs_err": max(c["max_abs_err"] for c in results[k]),
            "ms": main_case["ms"],
            "plain_ms": main_case["plain_ms"],
        })
    print(f"[done] {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
