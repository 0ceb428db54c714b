#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`deepseek_ocr2_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure, so the exit code is non-zero):
1. device: require CUDA, print the card's name and power limit, build the
   hand-written kernels from `deepseek_ocr2_tpu_torch/csrc/` (one nvcc per
   source, all started together);
2. kernels: each CUDA kernel against its plain PyTorch twin on the card at
   the main path's shapes (no-crop and crop pages, the 16-slot decode
   batch on f32, bf16, int8 and int8tail pools, the int8 and int4 decode
   steps, the chunk form of lookup decoding at S = 4 on f32, bf16, int8
   and int8tail pools, chunks across a page end among them), with the max
   abs error beside its
   tolerance, both median times (CUDA events), the least time the card
   could take (`bound_ms`) and, where one PyTorch call computes the same
   function, that call's time (`library_ms`; `torch._grouped_mm` for D's
   gate||up products, E, S and T in bf16); A (at the no-crop and the
   (2, 3) crop prompt), B (SAM's four shapes, f32 and bf16), D and E (at
   the prompts of the crop pages and a training step's forward, E also at
   its recompute), F (B 16 and 32 in bf16, 16 in f32; and on one
   rank's 32 experts under expert parallelism, local ids, out f32 and
   bf16, with a batch none of whose selections is the rank's)
   and L (at lm_head) also in a CUDA graph, beside the library call in one
   where there is one, with A's visited and skipped key
   tiles at 1125 tokens; the grouped-GEMM MoE (D, E)
   also whole against its grouped twin; D+E, F, H-O and P once each
   and Q, R under `torch.cuda.set_sync_debug_mode("error")` (no host
   sync); one
   batched-decode MoE layer timed in its three forms at the B * k <= E
   cut-over (F in a graph too), its int8 layer as I and as J, its int4 layer as M and as N;
   and the kernels off the default paths: U (stacked-cache decode
   attention, one and 16 rows), X (G's device code on a per-sequence
   pool), V (SAM's windowed attention, the bias built in the kernel, at
   win 14 for the 1024^2 view's 25 windows and six crops' 96, and the 16 /
   14 padded form) and W (the boundary-visit grouped GEMM, both modes, its
   ffn mode also against D then E), each with its time in a CUDA graph
   (U and V with the library call's beside it);
3. model: HF-layout random weights for the full-width default OCR2Config
   (about 3.4 B parameters) from a seeded torch.Generator on the card,
   loaded through `params_from_flat` with the CLI's default dtype policy
   (LM bf16, vision f32);
4. main path: `OCR2Pipeline.generate_ocr` on 3 synthetic no-crop pages and
   2 crop pages (grids (2, 1) and (2, 3)); every kernel must launch, D and
   E once per MoE layer on a crop page and never on a no-crop page, every
   step-0 logit must be finite;
4b. int8 weights: phase 3's LM quantized on the card, scope "full"
   (`--int8`) then "experts" (`--moe-int8`); a no-crop and the (2, 1) crop
   page through `generate_ocr` for each, every kernel's launches held to
   the count derived from the code (`quant_launches_per_step`, PERF.md);
4c. the same with int4 weights (`--int4`: L, M, N, O in place of H, I, J,
   K);
4d. prompt-lookup decoding (`lookup_chunk=4`) of one no-crop page through
   `generate_ocr` on phase 3's bf16 LM: tokens, forwards and decode tok/s,
   held to no decode kernel at all (the chunk's attention is plain on the
   contiguous cache, its MoE the per-selection path at 4 rows x 6 <= 64);
4f. the device resize (`--device-resize`): the (2, 3) crop page 1700 x 2200
   and the no-crop page 700 x 500 resized, letterboxed and tiled on the
   card bit-equal to host PIL and to the CPU form, timed against host PIL;
   generate_ocr with device_resize=True on the crop page equal to phase 4's
   tokens; phase 4's four pages through the continuous engine (4 slots)
   under DEEPSEEK_DEVICE_RESIZE=auto (the crop pages resized by the
   prefetch worker on the serve stream) against their single runs;
4g. (run after the per-token profile) the validate-hf harness on the (2, 1)
   page, 32 tokens: a transcript against itself PASS, the device-resize
   transcript against the host-resize one PASS, a perturbed projector FAIL
   at the embedding fingerprints; one page under `device_trace`
   (`--profile-dir`), whose trace must name B's and C's device kernels;
4e. (run after 6b) the JAX package's switches DEEPSEEK_DECODE_ATTN=stacked
   and DEEPSEEK_SAM_WIN_KERNEL=1, set for the phase only: a no-crop and
   the (2, 1) page (U 12 a decode step, V 8 and B 4 a SAM batch), the
   group engine on 6b's 16 pages, one --int8 page (K never), tokens
   against the default paths under phase 7's margin rule;
5. card vs CPU: full widths at reduced depth, f32, the same numpy-seeded
   weights, a no-crop page and a (2, 1) crop page (over 512 prompt tokens:
   D and E on the card, the grouped twin on the CPU); step-0 logits within
   tolerance, greedy tokens compared; then the same with `--int8` (5b: the
   card's and the CPU's int8 codes equal, K, I and H on the card) and with
   `--int4` (5c: levels and scales equal, O, M and L on the card); 5d:
   both switches, step-0 logits and tokens, U and V on the card;
6. serving at full width, on phase 3's model: `OCR2Engine(batch_size=16)`
   on 16 no-crop and 2 crop pages; `ContinuousOCREngine(slots=16)` on 24
   pages with a pool that makes slots grow (and preempt); one
   `decode_chunk` under sync-debug mode "error"; the online engine behind
   `OCRHttpServer` (4 concurrent POSTs, one SSE stream, /healthz,
   /v1/stats). F must launch once per MoE layer and G once per layer in
   every decode step of the continuous engine; 6b: with `--int8`, both
   engines at 16 on 16 pages, held to K 12, J 11, H 3 a step (group) and
   J 11, G 12, H 27 a step (continuous), beside the same pages on the
   bf16 LM; 6c: the same with `--int4` (O, N, L in place of K, J, H); then
   device time and device launches per decode token for bf16, both int8
   scopes and `--int4` (torch.profiler, after every timed phase); 6d: the
   continuous engine at 16 slots on 6b's pages with the bf16 LM on a bf16,
   an int8 (`--kv-cache int8`) and an int8tail pool, and with `--int8` on
   int8tail: pages/s, decode tok/s and pool bytes, held to P 12 and G 0 a
   step on the quantized pools; one sampled `decode_chunk` on an int8tail
   pool under sync-debug mode "error"; 6e: the continuous engine with
   `lookup_chunk=4` on 6d's pages and slots, on the bf16 and the int8tail
   pool (Q or R 12 and F 11 a chunk forward, G and P none), and on a
   full-width LM that emits a cycle of period 24 (attention and MLPs zero,
   embedding -> lm_head a shift): there the drafts accept, forwards under
   half the tokens;
7. serving is token-exact: on phase 5's card model, both engines (16
   slots) against each page's single-page `generate_ocr`, in bf16-free f32
   weights and again with `--int8` (7b) and `--int4` (7c); a difference
   is accepted only where the single run's top-2 margin at the first
   differing step is below LOGITS_RTOL of its largest logit. 7d: on the
   same model, card against CPU with the quantized pools: the pools after
   one admission (the card's codes, scales and open pages bit-identical to
   the CPU's quantization of the card's own prefill K/V; card and CPU
   within the stated bounds), the continuous engine's tokens on int8 and
   int8tail under the margin rule on the CPU engine's logits, and sampled
   `generate_ocr` (temperature 0.7, top-k 50, top-p 0.9, seed 3) under the
   same rule on logits / T + Gumbel noise; at temperature 0 it is greedy.
   7e: lookup decoding on the same model: `generate_ocr` with lookup_chunk
   4 against plain greedy on the card, both engines with lookup against
   single pages (the continuous one on an f32 and an int8tail pool, on
   which single pages decode the plain engine's way), and the card's lookup
   tokens against the CPU's, each under the margin rule.
8. fine-tuning: phase 2 also holds S, T and E (the backward's recompute)
   at a training step's MoE layer (B 4 x S 512, 12 288 rows) to their
   twins (E, S and T called as the backward calls them, with the layer's
   schedule; their library call timed in a CUDA graph too), and the whole
   `moe_ffn_gmm` backward to autograd through the
   grouped twin (one forward + backward under sync-debug "error"); then
   the full-width 12-layer LM in bf16 takes 5 AdamW steps and one remat
   step on one repeated batch through `runtime.train.adamw_train_step`
   (the train CLI's step), loss finite and falling, launches held to
   `train_launches_per_step`, with step ms, tokens/s, peak memory, the
   forward + backward / update split and a profiled step's idle share and
   device ms of D, E, S and T;
   8b: the loss and every gradient leaf of a 2-layer f32 LM, card against
   CPU; 8c: a resumed run bit-identical to a straight one on the card;
   8d: OCR fine-tuning through the vision towers
   (`runtime.train.adamw_ocr_train_step`) on a fresh full-width composite
   with the CLI's dtype policy: 3 AdamW steps on 2 no-crop uint8 pages at
   S 512, then 3 on a (2, 1) crop page at S 768, each held to
   `train_launches_per_step` (D, E, S, T; B, C and V never: SAM's training
   form), the loss finite and falling, every tower's gradient nonzero,
   with step ms, tokens/s, peak memory, the forward + backward / update
   split and a profiled step's idle share and top kernels; 8e: the loss
   and every gradient leaf of `ocr_loss`, card against CPU, at full widths
   and reduced depth in f32 (SAM 3 blocks at 1024^2, Qwen2 and the LM 2
   layers each, 600 rows), under 8b's rule.
9. multi-GPU training on the one card (`phase_multi_gpu`): worlds started
   through `parallel.launch`, ranks sharing the card over gloo (one rank
   over NCCL). 9a: the LM at full width and 3 layers in f32, B 4 x S 512,
   one forward and backward at (dp, mp) = (1, 1), (2, 1), (4, 1), (1, 2),
   (2, 2): the loss within 1e-5 and every gathered gradient leaf within
   1e-4 of its largest entry of (1, 1)'s, D, E, S, T on every rank (the
   (1, 1) routing replayed), (1, 1) again alone over NCCL; 9b: the
   full-width 12-layer LM in bf16 at (1, 2): the first batch's loss and
   every gradient leaf against (1, 1)'s on the same weights (routing
   replayed) within MESH_BF16_LOSS_RTOL and MESH_BF16_GRAD_RTOL, a planted
   fault (`dropped_partial`) beyond the latter; then 3 AdamW steps, the
   loss finite and falling, the first within MESH_BF16_LOSS_RTOL of the
   (1, 1) forward's, each rank's launches held to `train_launches_per_step`, with
   step ms, each rank's peak memory and a profiled step's share of
   collective time; 9c: `greedy_generate` of 16 prompts of 256 tokens, 32
   new, on 9b's trained shards (A, D, E in the prefill, F on each rank's
   32 experts) against the whole params gathered to rank 0, under phase
   7's margin rule; 9d: the OCR loss's gradients at reduced depth (8e's
   widths, 2 pages at S 300) at (1, 1), (2, 1), (1, 2): the towers'
   gradients equal on every rank and to (1, 1)'s, then the OCR prefill's
   last logits at (2, 1) (a page a rank) and (1, 2) within
   MESH_LOGITS_RTOL of (1, 1)'s (A, B, C, D, E on every rank).

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports neither jax nor PIL, tokenizers or safetensors (PIL is used for the
pages only if it is installed).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
TRAIN_B, TRAIN_S = 4, 512  # the train CLI's --batch-size and --seq-len defaults
PAGES = [(700, 500), (768, 768), (420, 640)]  # (w, h): both sides <= 768 -> no crop
CROP_PAGES = [(1400, 800, (2, 1)), (1700, 2200, (2, 3))]  # (w, h, the crop grid it takes)
KERNEL_SOURCES = ("moe_q4", "linear_q4", "attn_fused", "moe_q8", "flash_attention", "fused_mlp", "moe_gmm",
                  "moe_decode", "paged_attention", "linear_q8")  # the slowest builds first
SERVE_PAGES = [(700, 500), (768, 768), (420, 640), (600, 760), (512, 512), (760, 430)]  # no crop

# Tolerances on max |kernel - twin| (both on the card, same inputs):
# - f32: the kernels take sums in another order and A/B take an online
#   softmax over key tiles instead of a full-row one; outputs are O(1), so
#   f32 rounding stays far below 1e-4.
#   G reads f32 or bf16 pools but computes in f32 on both sides: F32_TOL;
#   so does P, from int8 codes times f32 scales (and bf16 open pages), and
#   so do their chunk forms Q and R.
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


# The least time the card could take for a kernel's work (`bound_ms`): the
# larger of the bytes it must move (each input read once, each output
# written once) over the memory rate, and its operations over the peak rate
# of their type. NVIDIA H100 SXM data sheet, dense, at the full 700 W:
# 3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores. f32 products: the
# card's least time for f32-accurate products, 3xTF32 on the tensor cores
# (each operand split into a TF32 high and low part, three products with
# f32 sums, as kernel A does and PyTorch's own f32 attention): 495 / 3
# TFLOP/s, faster than the 67 TFLOP/s of f32 FMAs on the CUDA cores, so a
# tensor-core kernel cannot read above 100 % of its bound. (1xTF32, torch's
# allow_tf32, is not f32-accurate and stays off.)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def row_bytes(n_rows: int, *tensors) -> int:
    """Bytes of n_rows rows of each 2-D tensor: the N k real rows of an
    expert-aligned buffer, whose pad slots and invalid tail tiles are no
    part of the function's work."""
    return sum(n_rows * t.shape[1] * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, flops: float, dtype: torch.dtype):
    """(ms, "bytes" or "operations": which of the two sets it)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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


def graph_ms(fn, reps: int = 20) -> float:
    """The card's time per call of fn, without the host's: fn captured once
    into a CUDA graph and replayed reps times between two events (a replay
    is enqueued in a few microseconds, so the card, not the wrapper's Python,
    sets the time). `median_ms` of a decode kernel's wrapper is mostly the
    wrapper's host time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up off the capture, as capture requires
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def no_host_sync(dev, what: str, fn):
    """fn() with any host sync raising; returns its result."""
    torch.cuda.synchronize(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize(dev)
    print(f"[sync] {what} under set_sync_debug_mode('error'): no host sync ok")
    return out


def gmm_results(dev, randn, record) -> None:
    """Kernels D and E at the LM's MoE shapes (E = 64, k = 6, H = 1280,
    I = 896) for the prompts of a 2-crop and a 6-crop page (N = 550, 1125)
    and the forward of one training step (N = TRAIN_B x TRAIN_S = 2048),
    routed by a random f32 router: each kernel alone against its per-tile
    twin on the same aligned rows, then the whole `moe_ffn_gmm` against the
    grouped twin `moe_ffn_gmm_reference`, and the dense form's time at
    N = 550 (the 512-row cut-over). One call runs in sync-debug mode."""
    from deepseek_ocr2_tpu_torch.ops import moe_gmm
    from deepseek_ocr2_tpu_torch.ops.moe import moe_ffn_dense, route

    e, k, h, i = 64, 6, 1280, 896
    for n in (550, 1125, TRAIN_B * TRAIN_S):
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
            # This routing's work: the selected experts' weights once, the
            # N * k (row, expert) products.
            n_used = int(torch.unique(idx).numel())
            w_expert = nbytes(ex["gate"][0])
            flops_gu, flops_d = 2 * 2 * n * k * h * i, 2 * n * k * i * h

            # D and E as the forward calls them: bf16 on S's schedule, built
            # once a layer (outside the wrappers' time).
            sched = moe_gmm.row_schedule(e_tile, tile_valid, e) if dt == torch.bfloat16 else ()
            args_d = (x_al, ex["gate"], ex["up"], e_tile, tile_valid)
            act = moe_gmm.gmm_swiglu_reference(*args_d)
            torch.full(act.shape, float("nan"), dtype=dt, device=dev)  # D's output block: an unwritten row shows
            got = moe_gmm.moe_gmm_swiglu(*args_d, *sched)
            # Library (bf16): the gate||up products alone ([E, 2I, H]
            # concatenated outside the timing), no SwiGLU.
            library = (grouped_mm_library("D", x_al, torch.cat([ex["gate"], ex["up"]], 1), e_tile, tile_valid)
                       if dt == torch.bfloat16 else None)
            record("D", f"swiglu {case}", act, got, tolerance(act, dt),
                   median_ms(lambda: moe_gmm.moe_gmm_swiglu(*args_d, *sched)),
                   median_ms(lambda: moe_gmm.gmm_swiglu_reference(*args_d)),
                   bound_ms(row_bytes(n * k, x_al, act) + 2 * n_used * w_expert, flops_gu, dt), library,
                   graph=lambda: moe_gmm.moe_gmm_swiglu(*args_d, *sched), library_graph=True)
            del library
            args_e = (act, ex["down"], e_tile, tile_valid)
            y = moe_gmm.gmm_down_reference(*args_e)
            # NaNs in the block the wrapper's output will reuse: a row the
            # kernel fails to write shows.
            torch.full(y.shape, float("nan"), dtype=dt, device=dev)
            got = moe_gmm.moe_gmm_down(*args_e, *sched)
            record("E", f"down {case}", y, got, tolerance(y, dt),
                   median_ms(lambda: moe_gmm.moe_gmm_down(*args_e, *sched)),
                   median_ms(lambda: moe_gmm.gmm_down_reference(*args_e)),
                   bound_ms(row_bytes(n * k, act, y) + n_used * w_expert, flops_d, dt),
                   grouped_mm_library("E", act, ex["down"], e_tile, tile_valid),
                   graph=lambda: moe_gmm.moe_gmm_down(*args_e, *sched), library_graph=True)
            del act, got, y, args_d, args_e

            args = (x, ex, weights, idx)
            ref = moe_gmm.moe_ffn_gmm_reference(*args)
            got = moe_gmm.moe_ffn_gmm(*args)
            record("D+E", f"moe_ffn_gmm vs grouped twin, {case}", ref, got, tolerance(ref, dt),
                   median_ms(lambda: moe_gmm.moe_ffn_gmm(*args)),
                   median_ms(lambda: moe_gmm.moe_ffn_gmm_reference(*args)),
                   bound_ms(nbytes(x, ref, weights, idx) + 3 * n_used * w_expert, flops_gu + flops_d, dt))
            if n == 550:
                print(f"[kernel] dense all-expert MoE N {n} {dts}: "
                      f"{median_ms(lambda: moe_ffn_dense(*args)):.3f} ms")
            if n == 1125 and dt == torch.bfloat16:
                no_host_sync(dev, f"D+E ({case})", lambda: moe_gmm.moe_ffn_gmm(*args))
            del x, ex, args, ref, got
    torch.cuda.empty_cache()


def decode_results(dev, randn, record) -> None:
    """Kernels F and G at the serving shapes. F: the routed MoE of one
    decode step (E = 64, k = 6, H = 1280, I = 896) at B = 16 and 32 in bf16
    and B = 16 in f32, against the visit twin, each also in a CUDA graph;
    one call in sync-debug mode; one rank's 32 experts under expert
    parallelism (phase 9c's decode), out f32 and bf16; then one MoE layer at B = 8, 11, 16, 32
    timed in its three forms (F, the per-selection path, the dense form)
    around the B * k <= E cut-over (11 rows), and F in a CUDA graph. G:
    [12, P, 10, 128, 128] pools in f32 and bf16, 16 rows of ragged lengths
    260..2048 with random block tables, one row on the scratch page 0,
    layers 0 and 11, and one row of 300 tokens."""
    from deepseek_ocr2_tpu_torch.ops import moe_decode
    from deepseek_ocr2_tpu_torch.ops import moe as moe_ops
    from deepseek_ocr2_tpu_torch.ops.paged_attention import (
        paged_decode_attention_pool,
        paged_decode_attention_reference,
    )

    e, k, h, i = 64, 6, 1280, 896

    def experts(dt):
        return {"gate": randn(e, i, h, std=h**-0.5, dtype=dt), "up": randn(e, i, h, std=h**-0.5, dtype=dt),
                "down": randn(e, h, i, std=i**-0.5, dtype=dt)}

    router = randn(e, h, std=h**-0.5)
    for b, dt in ((16, torch.bfloat16), (32, torch.bfloat16), (16, torch.float32)):
        ex = experts(dt)
        x = randn(b, h, dtype=dt)
        args = (x, ex, *moe_ops.route(x, router, k))
        n_visits = int(moe_decode.distinct_schedule(args[3], e)[1].sum())
        ref = moe_decode.moe_ffn_decode_visits_reference(*args)
        got = moe_decode.moe_ffn_decode_fused(*args)
        record("F", f"B {b} k {k}: {n_visits} distinct experts, {str(dt)[6:]}", ref, got, tolerance(ref, dt),
               median_ms(lambda: moe_decode.moe_ffn_decode_fused(*args)),
               median_ms(lambda: moe_decode.moe_ffn_decode_visits_reference(*args)),
               bound_ms(nbytes(x, ref, *args[2:]) + n_visits * 3 * nbytes(ex["gate"][0]), 2 * b * k * 3 * h * i, dt),
               graph=lambda: moe_decode.moe_ffn_decode_fused(*args))
        if b == 16 and dt == torch.bfloat16:
            no_host_sync(dev, "F (B 16 bf16)", lambda: moe_decode.moe_ffn_decode_fused(*args))
        del ex, args, ref, got

    # F under expert parallelism at mp 2 (phase 9c's decode): a rank's 32
    # experts on the local ids of a 64-expert routing (`local_routing`: the
    # other rank's selections id 32, weight 0), its partial in f32 (what
    # `_ffn_mp` asks for) and in bf16; then a batch none of whose
    # selections is rank 0's, where every visit is a pad and F adds zeros.
    ex = experts(torch.bfloat16)
    x = randn(16, h, dtype=torch.bfloat16)
    weights, idx = moe_ops.route(x, router, k)
    e_l = e // 2
    for rank, sel, what in ((0, idx, "rank 0"), (1, idx, "rank 1"), (0, idx % e_l + e_l, "rank 0, none local")):
        w_l, idx_l = moe_ops.local_routing(weights, sel, e_l, rank)
        local = {n: t[rank * e_l:(rank + 1) * e_l] for n, t in ex.items()}
        n_visits = int(moe_decode.distinct_schedule(idx_l, e_l)[1].sum())
        for out_dt in (torch.float32, torch.bfloat16):
            args = (x, local, w_l, idx_l, out_dt)
            ref = moe_decode.moe_ffn_decode_visits_reference(*args)
            got = moe_decode.moe_ffn_decode_fused(*args)
            if got.dtype != out_dt or (n_visits == 0 and not torch.equal(got, torch.zeros_like(got))):
                raise AssertionError(f"F on local ids, {what}: {got.dtype} out, {n_visits} visits, "
                                     f"max |out| {float(got.float().abs().max())}")
            record("F", f"EP {what}: 32 local experts, B 16 k {k}, {n_visits} visits, bf16, out {str(out_dt)[6:]}",
                   ref, got, bf16_tol(ref), median_ms(lambda: moe_decode.moe_ffn_decode_fused(*args)),
                   median_ms(lambda: moe_decode.moe_ffn_decode_visits_reference(*args)),
                   bound_ms(nbytes(x, ref, w_l, idx_l) + n_visits * 3 * nbytes(ex["gate"][0]),
                            2 * int((idx_l < e_l).sum()) * 3 * h * i, torch.bfloat16),
                   graph=lambda: moe_decode.moe_ffn_decode_fused(*args))
            del args, ref, got
    del ex

    ex = experts(torch.bfloat16)
    for b in (8, 11, 16, 32):
        x = randn(b, h, dtype=torch.bfloat16)
        args = (x, ex, *moe_ops.route(x, router, k))
        forms = {"F": moe_decode.moe_ffn_decode_fused, "per-selection": moe_ops.moe_ffn_decode_per_selection,
                 "dense": moe_ops.moe_ffn_dense}
        times = ", ".join(f"{name} {median_ms(lambda: fn(*args)):.3f} ms" for name, fn in forms.items())
        f_graph = graph_ms(lambda: moe_decode.moe_ffn_decode_fused(*args))
        print(f"[cut-over] one MoE decode layer, bf16, B {b} (B*k {'<=' if b * k <= e else '>'} E): {times}; "
              f"F in a CUDA graph {f_graph:.4f} ms")
    del ex

    scale = 128**-0.5
    for dt in (torch.float32, torch.bfloat16):
        n_pages, page, b = 64, 128, 16
        k_pool = randn(12, n_pages, 10, page, 128, dtype=dt)
        v_pool = randn(12, n_pages, 10, page, 128, dtype=dt)
        q = randn(b, 10, 128)
        bt = torch.randint(1, n_pages, (b, 2048 // page), device=dev, dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(SEED))
        bt[-1] = 0  # a finished row: every page is the scratch page
        lens = torch.linspace(260, 2048, b, device=dev).round().to(torch.int32)
        # The 16 rows at layers 0 and 11, then one row of 300 tokens (a
        # batch-1 pool step).
        for li, rows in ((0, b), (11, b), (11, 1)):
            args = (q[:rows], k_pool, v_pool, bt[:rows], lens[:rows] if rows > 1 else torch.full_like(lens[:1], 300))
            ref = paged_decode_attention_reference(args[0], k_pool[li], v_pool[li], *args[3:], scale=scale)
            got = paged_decode_attention_pool(*args, li, scale=scale)
            n_keys = int(args[4].sum())
            what = "lengths 260..2048" if rows > 1 else "length 300"
            record("G", f"pool {tuple(k_pool.shape)} {str(dt)[6:]}, B {rows}, {what}, layer {li}",
                   ref, got, F32_TOL, median_ms(lambda: paged_decode_attention_pool(*args, li, scale=scale)),
                   median_ms(lambda: paged_decode_attention_reference(args[0], k_pool[li], v_pool[li], *args[3:],
                                                                      scale=scale)),
                   bound_ms(nbytes(args[0], ref, args[3], args[4]) + 2 * n_keys * 10 * 128 * k_pool.element_size(),
                            4 * n_keys * 10 * 128, torch.float32),
                   graph=lambda: paged_decode_attention_pool(*args, li, scale=scale))
        del k_pool, v_pool
    torch.cuda.empty_cache()
    paged_q8_results(dev, record)
    chunk_results(dev, record)


def paged_q8_results(dev, record) -> None:
    """Kernel P at G's main-path shape (16 rows of lengths 260..2048 over
    128-token pages, a [12, 257, 10, 128, 128] int8 pool) and at one row of
    1500 tokens, plain int8 and int8tail, layer 11. Block tables are
    row-exclusive, as the engine keeps them (the twin's open-page patch
    needs it); at 16 rows the last row is finished on the scratch page 0,
    and in tail mode its output is not compared (the twin puts its open
    page on every one of its page-0 entries, the kernel only on the last;
    the engine discards it). The bound counts each row's tokens once: codes
    and scales of K and V, and in tail mode the last page's tokens as bf16
    instead. One int8tail launch runs in sync-debug mode."""
    from deepseek_ocr2_tpu_torch.ops.paged_attention import (
        paged_decode_attention_pool_q8,
        paged_decode_attention_q8_reference,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    page, heads, d, li, scale = 128, 10, 128, 11, 128**-0.5
    for b in (16, 1):
        max_pages = 2048 // page
        n_pages = b * max_pages + 1
        codes = [torch.randint(-127, 128, (12, n_pages, heads, page, d), generator=g, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.rand(12, n_pages, heads, page, generator=g, device=dev) * 0.02 + 1e-3 for _ in range(2)]
        opens = [torch.randn(12, b, heads, page, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(2)]
        bt = (torch.randperm(n_pages - 1, generator=g, device=dev)[: b * max_pages] + 1).reshape(b, max_pages)
        bt = bt.to(torch.int32)
        lens = torch.linspace(260, 2048, b, device=dev).round().to(torch.int32) if b > 1 else \
            torch.full((1,), 1500, dtype=torch.int32, device=dev)
        if b > 1:
            bt[-1] = 0
        q = torch.randn(b, heads, d, generator=g, device=dev)
        n = lens.long().cpu()
        n_tail = n - (n - 1) // page * page  # tokens of each row's last page
        for tail in (False, True):
            kw = dict(scale=scale, open_k=opens[0], open_v=opens[1]) if tail else dict(scale=scale)
            args = (q, codes[0], codes[1], scales[0], scales[1], bt, lens, li)
            ref = paged_decode_attention_q8_reference(*args, **kw)
            got = paged_decode_attention_pool_q8(*args, **kw)
            live = slice(None, -1) if tail and b > 1 else slice(None)
            if tail:
                kv_bytes = int((n - n_tail).sum()) * 2 * heads * (d + 4) + int(n_tail.sum()) * 2 * heads * d * 2
            else:
                kv_bytes = int(n.sum()) * 2 * heads * (d + 4)
            record("P", f"{'int8tail' if tail else 'int8'} pool {tuple(codes[0].shape)}, B {b}, "
                        f"lengths {int(n.min())}..{int(n.max())}, layer {li}",
                   ref[live], got[live], F32_TOL,
                   median_ms(lambda: paged_decode_attention_pool_q8(*args, **kw)),
                   median_ms(lambda: paged_decode_attention_q8_reference(*args, **kw)),
                   bound_ms(nbytes(q, ref, bt, lens) + kv_bytes, 4 * int(n.sum()) * heads * d, torch.float32),
                   graph=lambda: paged_decode_attention_pool_q8(*args, **kw))
            if tail and b > 1:
                no_host_sync(dev, "P (int8tail, B 16)", lambda: paged_decode_attention_pool_q8(*args, **kw))
        del codes, scales, opens
    torch.cuda.empty_cache()


def chunk_results(dev, record) -> None:
    """Kernels Q and R, the chunk forms of G and P that lookup decoding's
    verification runs, at S = 4 queries a row, layer 11 of [12, 257, 10,
    128, 128] pools with row-exclusive block tables (the engine's), 16 rows:
    - "lengths 260..2048": the rows' largest budgets spread as in G's case
      (query i of a row at budget largest - 3 + i);
    - "across a page end": largest budgets 128 j + 2 (the chunk's first two
      queries in one page, its last two in the next), rows 14 and 15
      finished on the scratch page 0.
    Q on f32 and bf16 pools, R on int8 codes and on int8tail (bf16 open
    pages, read for the page of the row's largest budget). In tail mode the
    scratch rows' outputs are not compared: the twin puts an open page on
    every page-0 entry of such a row, the kernel on its last only, and the
    engine discards them. The bound counts each row's tokens up to its
    largest budget once (K and V); each kernel launches once in sync-debug
    mode."""
    from deepseek_ocr2_tpu_torch.ops.paged_attention import (
        paged_decode_attention_chunk_q8_reference,
        paged_decode_attention_chunk_reference,
        paged_decode_attention_pool_chunk,
        paged_decode_attention_pool_chunk_q8,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    page, heads, d, li, scale, b, s = 128, 10, 128, 11, 128**-0.5, 16, 4
    max_pages = 2048 // page
    n_pages = b * max_pages + 1
    bt0 = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1).reshape(b, max_pages).to(torch.int32)
    spread = torch.linspace(260, 2048, b, device=dev).round().to(torch.int32)
    across = (128 * torch.arange(1, b + 1, device=dev).clamp(max=max_pages - 1) + 2).to(torch.int32)
    cases = []
    for name, ends, n_scratch in (("lengths 260..2048", spread, 0), ("across a page end", across, 2)):
        bt = bt0.clone()
        if n_scratch:
            bt[-n_scratch:] = 0
        lens = (ends[:, None] - s + 1 + torch.arange(s, device=dev, dtype=torch.int32)).contiguous()  # [B, S]
        cases.append((name, bt, lens, b - n_scratch))
    q = torch.randn(b, s, heads, d, generator=g, device=dev)
    shape = (12, n_pages, heads, page, d)
    for dt in (torch.bfloat16, torch.float32):  # the bf16 pool first: the main path's (phase 6e)
        k_pool = torch.randn(shape, generator=g, device=dev).to(dt)
        v_pool = torch.randn(shape, generator=g, device=dev).to(dt)
        for name, bt, lens, _ in cases:
            n_keys = int(lens[:, -1].sum())
            args = (q, k_pool, v_pool, bt, lens, li)
            ref = paged_decode_attention_chunk_reference(q, k_pool[li], v_pool[li], bt, lens, scale=scale)
            got = paged_decode_attention_pool_chunk(*args, scale=scale)
            record("Q", f"{str(dt)[6:]} pool {shape}, B {b}, S {s}, {name}, layer {li}", ref, got, F32_TOL,
                   median_ms(lambda: paged_decode_attention_pool_chunk(*args, scale=scale)),
                   median_ms(lambda: paged_decode_attention_chunk_reference(q, k_pool[li], v_pool[li], bt, lens,
                                                                            scale=scale)),
                   bound_ms(nbytes(q, ref, bt, lens) + 2 * n_keys * heads * d * k_pool.element_size(),
                            4 * s * n_keys * heads * d, torch.float32),
                   graph=lambda: paged_decode_attention_pool_chunk(*args, scale=scale))
        no_host_sync(dev, f"Q ({str(dt)[6:]} pool, B 16, S 4)",
                     lambda: paged_decode_attention_pool_chunk(q, k_pool, v_pool, *cases[0][1:3], li, scale=scale))
        del k_pool, v_pool
    torch.cuda.empty_cache()
    codes = [torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(shape[:4], generator=g, device=dev) * 0.02 + 1e-3 for _ in range(2)]
    opens = [torch.randn(12, b, heads, page, d, generator=g, device=dev).to(torch.bfloat16) for _ in range(2)]
    for tail in (True, False):  # int8tail first: the main path's (phase 6e)
        kw = dict(scale=scale, open_k=opens[0], open_v=opens[1]) if tail else dict(scale=scale)
        for name, bt, lens, n_live in cases:
            args = (q, codes[0], codes[1], scales[0], scales[1], bt, lens, li)
            ref = paged_decode_attention_chunk_q8_reference(*args, **kw)
            got = paged_decode_attention_pool_chunk_q8(*args, **kw)
            live = slice(None, n_live) if tail else slice(None)
            n = lens[:, -1].long().cpu()
            n_tail = n - (n - 1) // page * page  # tokens of each row's last page
            kv_bytes = int((n - n_tail).sum()) * 2 * heads * (d + 4) + int(n_tail.sum()) * 2 * heads * d * 2 \
                if tail else int(n.sum()) * 2 * heads * (d + 4)
            record("R", f"{'int8tail' if tail else 'int8'} pool {shape}, B {b}, S {s}, {name}, layer {li}",
                   ref[live], got[live], F32_TOL,
                   median_ms(lambda: paged_decode_attention_pool_chunk_q8(*args, **kw)),
                   median_ms(lambda: paged_decode_attention_chunk_q8_reference(*args, **kw)),
                   bound_ms(nbytes(q, ref, bt, lens) + kv_bytes, 4 * s * int(n.sum()) * heads * d, torch.float32),
                   graph=lambda: paged_decode_attention_pool_chunk_q8(*args, **kw))
        no_host_sync(dev, f"R ({'int8tail' if tail else 'int8'}, B 16, S 4)",
                     lambda: paged_decode_attention_pool_chunk_q8(q, codes[0], codes[1], scales[0], scales[1],
                                                                  *cases[0][1:3], li, **kw))
    del codes, scales, opens
    torch.cuda.empty_cache()


def stacked_results(dev, record) -> None:
    """Kernel U at the decode shapes of DEEPSEEK_DECODE_ATTN=stacked (phase
    4e): layer 11 of a [12, B, 10, 1024, 128] contiguous cache, one row at
    position 300 and 16 rows at positions 260..1000, on an f32 cache (the
    pipeline's) and a bf16 one; library: SDPA on the layer view with the
    length mask. Kernel X (G's device code) at G's 16-row shape on a
    per-sequence pool [64, 10, 128, 128] (no layer axis), f32 and bf16. One
    launch of each in sync-debug mode."""
    from deepseek_ocr2_tpu_torch.ops.paged_attention import (
        decode_attention_stacked,
        decode_attention_stacked_reference,
        paged_decode_attention,
        paged_decode_attention_reference,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    heads, d, cap, li, scale = 10, 128, 1024, 11, 128**-0.5
    for dt in (torch.float32, torch.bfloat16):  # the f32 cache first: the main path's (phase 4e)
        for b in (1, 16):
            k_all, v_all = (torch.randn(12, b, heads, cap, d, generator=g, device=dev).to(dt) for _ in range(2))
            q = torch.randn(b, heads, d, generator=g, device=dev)
            pos = torch.tensor([300.0]) if b == 1 else torch.linspace(260, 1000, b)
            lens = (pos.round() + 1).to(torch.int32).to(dev)
            n_keys = int(lens.sum())
            args = (q, k_all, v_all, li, lens)
            ref = decode_attention_stacked_reference(*args, scale=scale)
            got = decode_attention_stacked(*args, scale=scale)
            attend = (torch.arange(cap, device=dev) < lens.long()[:, None])[:, None, None, :]
            q4, k_l, v_l = q[:, :, None].to(dt), k_all[li], v_all[li]
            record("U", f"cache {tuple(k_all.shape)} {str(dt)[6:]}, B {b}, positions "
                   f"{int(pos.min())}..{int(pos.max())}, layer {li}", ref, got, F32_TOL,
                   median_ms(lambda: decode_attention_stacked(*args, scale=scale)),
                   median_ms(lambda: decode_attention_stacked_reference(*args, scale=scale)),
                   bound_ms(nbytes(q, ref, lens) + 2 * n_keys * heads * d * k_all.element_size(),
                            4 * n_keys * heads * d, torch.float32),
                   lambda: F.scaled_dot_product_attention(q4, k_l, v_l, attn_mask=attend, scale=scale),
                   graph=lambda: decode_attention_stacked(*args, scale=scale), library_graph=True)
            if b == 16 and dt == torch.float32:
                no_host_sync(dev, "U (B 16, f32 cache)", lambda: decode_attention_stacked(*args, scale=scale))
            del k_all, v_all, args, q4, k_l, v_l
    torch.cuda.empty_cache()

    n_pages, page, b = 64, 128, 16
    bt = torch.randint(1, n_pages, (b, 2048 // page), device=dev, dtype=torch.int32, generator=g)
    bt[-1] = 0  # a finished row: every page is the scratch page
    lens = torch.linspace(260, 2048, b, device=dev).round().to(torch.int32)
    q = torch.randn(b, heads, d, generator=g, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        k_pages, v_pages = (torch.randn(n_pages, heads, page, d, generator=g, device=dev).to(dt) for _ in range(2))
        args = (q, k_pages, v_pages, bt, lens)
        ref = paged_decode_attention_reference(*args, scale=scale)
        got = paged_decode_attention(*args, scale=scale)
        n_keys = int(lens.sum())
        record("X", f"per-sequence pool {tuple(k_pages.shape)} {str(dt)[6:]}, B {b}, lengths 260..2048", ref, got,
               F32_TOL, median_ms(lambda: paged_decode_attention(*args, scale=scale)),
               median_ms(lambda: paged_decode_attention_reference(*args, scale=scale)),
               bound_ms(nbytes(q, ref, bt, lens) + 2 * n_keys * heads * d * k_pages.element_size(),
                        4 * n_keys * heads * d, torch.float32),
               graph=lambda: paged_decode_attention(*args, scale=scale))
        if dt == torch.float32:
            no_host_sync(dev, "X (B 16, f32 pool)", lambda: paged_decode_attention(*args, scale=scale))
    torch.cuda.empty_cache()


def window_results(dev, randn, record) -> None:
    """Kernel V at the windowed SAM blocks (phase 4e runs it there): the
    no-crop global view's 25 windows x 12 heads and a 6-crop page's 96 at
    win = valid = 14 (T2 196) in f32 (the vision dtype) and bf16 (serve's),
    and the JAX package's 16 / 14 padded form (T2 256, padded tokens
    zeroed, padded query rows not compared);
    library: SDPA with the [T2, T2] bias built outside the timing, as for
    B. The bound counts the valid queries and keys."""
    from deepseek_ocr2_tpu_torch.ops.flash_attention import mha_win, mha_win_reference, window_bias

    scale = 1.0 / 8.0
    for nw, win, valid, dt in ((25, 14, 14, torch.float32), (25, 14, 14, torch.bfloat16), (96, 14, 14, torch.float32),
                               (96, 14, 14, torch.bfloat16), (25, 16, 14, torch.float32)):
        t2 = win * win
        pos = torch.arange(t2, device=dev)
        live = (pos // win < valid) & (pos % win < valid)
        q, k, v = ((randn(nw, 12, t2, 64) * live[:, None]).to(dt) for _ in range(3))
        rhf, rwf = (F.pad(randn(valid, valid, 64, std=0.3), (0, 0, 0, win - valid, 0, win - valid))
                    .permute(2, 0, 1).reshape(64, t2).contiguous() for _ in range(2))
        kw = dict(scale=scale, win=win, valid=valid)
        ref = mha_win_reference(q, k, v, rhf, rwf, **kw)
        got = mha_win(q, k, v, rhf, rwf, **kw)
        bias = window_bias(q, rhf, rwf, win, valid).to(dt)
        n = nw * 12 * valid * valid  # valid queries; each sees valid^2 keys
        record("V", f"windows {tuple(q.shape)} win {win} valid {valid} {str(dt)[6:]}", ref[:, :, live],
               got[:, :, live], tolerance(ref[:, :, live], dt),
               median_ms(lambda: mha_win(q, k, v, rhf, rwf, **kw)),
               median_ms(lambda: mha_win_reference(q, k, v, rhf, rwf, **kw)),
               bound_ms(nbytes(q, k, v, rhf, rwf, ref), n * (4 * valid * valid + 4 * win) * 64, dt),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale),
               graph=lambda: mha_win(q, k, v, rhf, rwf, **kw), library_graph=True)
        del q, k, v, ref, got, bias
    torch.cuda.empty_cache()


def visit_results(dev, randn, record) -> None:
    """Kernel W, both modes, at the MoE layer of the (2, 1) crop page's
    prompt (548 tokens x 6) and of the (2, 3) page's (1124 x 6), bf16 then
    f32 (E = 64, H = 1280, I = 896, a random f32 router), on the JAX
    package's own layout: the expert-sorted rows and `visit_schedule` at
    `pick_bm` (64 at these sizes), against the visit twins on the N k real
    rows; then the ffn mode against D then E on the aligned layout for the
    same rows (the same sums in the same order: bit-equal expected). No
    path runs W (neither package calls it), and no one PyTorch call computes
    either mode."""
    from deepseek_ocr2_tpu_torch.ops import moe_gmm
    from deepseek_ocr2_tpu_torch.ops.moe import route

    e, k, h, i = 64, 6, 1280, 896
    for n in (548, 1124):
        for dt in (torch.bfloat16, torch.float32):
            x = randn(n, h, dtype=dt)
            wg, wu = (randn(e, i, h, std=h**-0.5, dtype=dt) for _ in range(2))
            wd = randn(e, h, i, std=i**-0.5, dtype=dt)
            _, idx = route(x, randn(e, h, std=h**-0.5), k)
            m, bm = n * k, moe_gmm.pick_bm(n * k)
            x_sorted, sizes = moe_gmm.sorted_rows(x, idx, e, bm)
            sched = moe_gmm.visit_schedule(sizes, x_sorted.shape[0], bm)
            n_live = int((sched[3] > sched[2]).sum())
            n_used = int(torch.unique(idx).numel())
            w_expert = nbytes(wg[0])
            flops_gu, flops_d = 2 * 2 * m * h * i, 2 * m * i * h
            case = f"N {n} k {k}: bm {bm}, {sched[0].numel()} visit slots, {n_live} non-empty, {str(dt)[6:]}"
            args = (x_sorted, wg, wu, sched, bm)
            ref = moe_gmm.gmm_swiglu_visit_reference(*args)[:m]
            got = moe_gmm.gmm_swiglu_visit(*args)[:m]
            record("W", f"swiglu {case}", ref, got, tolerance(ref, dt),
                   median_ms(lambda: moe_gmm.gmm_swiglu_visit(*args)),
                   median_ms(lambda: moe_gmm.gmm_swiglu_visit_reference(*args)),
                   bound_ms(row_bytes(m, x_sorted, ref) + 2 * n_used * w_expert, flops_gu, dt),
                   graph=lambda: moe_gmm.gmm_swiglu_visit(*args))
            args = (x_sorted, wg, wu, wd, sched, bm)
            ref = moe_gmm.gmm_ffn_visit_reference(*args)[:m]
            y = moe_gmm.gmm_ffn_visit(*args)
            record("W", f"ffn {case}", ref, y[:m], tolerance(ref, dt),
                   median_ms(lambda: moe_gmm.gmm_ffn_visit(*args)),
                   median_ms(lambda: moe_gmm.gmm_ffn_visit_reference(*args)),
                   bound_ms(row_bytes(m, x_sorted, ref) + 3 * n_used * w_expert, flops_gu + flops_d, dt),
                   graph=lambda: moe_gmm.gmm_ffn_visit(*args))
            # D then E on the aligned layout of the same sorted rows.
            src, slot_valid, slot_of_sorted, e_tile, tile_valid = moe_gmm.aligned_layout(
                sizes, x_sorted.shape[0], moe_gmm.GMM_BM)
            x_al = torch.where(slot_valid[:, None], x_sorted[src.long().clamp(max=x_sorted.shape[0] - 1)], 0)

            def pair():
                return moe_gmm.moe_gmm_down(moe_gmm.moe_gmm_swiglu(x_al, wg, wu, e_tile, tile_valid), wd, e_tile,
                                            tile_valid)

            y_al = pair()[slot_of_sorted[:m].long()]
            err = float((y[:m].float() - y_al.float()).abs().max())
            tol = tolerance(y_al, dt)
            print(f"[kernel] W ffn vs D then E on the aligned layout, the same rows, {case}: max_abs_err "
                  f"{err:.3e} (tol {tol:.1e}), bit-equal {bool(torch.equal(y[:m], y_al))}; W ffn "
                  f"{median_ms(lambda: moe_gmm.gmm_ffn_visit(*args)):.3f} ms, D then E {median_ms(pair):.3f} ms "
                  f"{'ok' if err <= tol else 'FAIL'}")
            if not err <= tol:
                raise AssertionError(f"W ffn differs from D then E by {err}, above {tol}")
            if n == 548 and dt == torch.bfloat16:
                no_host_sync(dev, f"W ffn ({case})", lambda: moe_gmm.gmm_ffn_visit(*args))
            del x, wg, wu, wd, x_sorted, x_al, args, ref, y, y_al
    torch.cuda.empty_cache()


def q8_results(dev, randn, record) -> None:
    """Kernels H, I, J and K at the int8 decode shapes of the full-width LM
    (H = 1280, 10 heads of 128, E = 64, k = 6, I = 896, 2 shared
    pseudo-experts), bf16 activations as the CLI's LM dtype. H: lm_head at
    B = 1 and 16 (f32 logits), the dense down 6848 -> 1280, the shared
    gate||up 1280 -> 3584 (f32 out, as swiglu_q8). I: one row with the
    pseudo-experts, 8 rows without. J: 16 and 32 rows with them. K: one row
    at capacity 1024 and pos 300, f32 and bf16 caches; 16 rows at ragged
    positions from 0. Then one int8 MoE decode layer timed as I and as J at
    B = 8, 11 and 16 (the B * k <= E cut-over), and each kernel once in
    sync-debug mode."""
    from deepseek_ocr2_tpu_torch.configs import DeepseekV2Config
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import rope_consts
    from deepseek_ocr2_tpu_torch.ops import attn_fused, linear_q8, moe_decode, moe_q8
    from deepseek_ocr2_tpu_torch.ops.moe import route

    bf, f32 = torch.bfloat16, torch.float32

    def qlin(out_dim, in_dim):
        return linear_q8.quantize_linear(randn(out_dim, in_dim, std=in_dim**-0.5))

    def int8pack(x, w):
        """`torch._weight_int8pack_mm` (w8a16, scales and output in x's
        dtype) where this build runs it on CUDA, else None: the library
        yardstick of H."""
        fn = getattr(torch, "_weight_int8pack_mm", None)
        if fn is None:
            return None
        scale = w["scale"].to(x.dtype)
        try:
            fn(x, w["q8"], scale)
            torch.cuda.synchronize(dev)
        except (RuntimeError, NotImplementedError) as e:
            print(f"[kernel] torch._weight_int8pack_mm unavailable here: {str(e).splitlines()[0][:120]}")
            return None
        return lambda: fn(x, w["q8"], scale)

    head = qlin(129280, 1280)
    for name, b, w, od in (("lm_head", 1, head, f32), ("lm_head", 16, head, f32), ("dense down", 1, qlin(1280, 6848), None),
                           ("shared gate||up", 1, qlin(3584, 1280), f32)):
        out_dim, in_dim = w["q8"].shape
        x = randn(b, in_dim, dtype=bf)
        ref = linear_q8.linear_q8_reference(x, w, out_dtype=od)
        got = linear_q8.linear_q8(x, w, out_dtype=od)
        record("H", f"{name} B {b} [{out_dim}, {in_dim}] bf16 -> {str(ref.dtype)[6:]}", ref, got,
               tolerance(ref, ref.dtype), median_ms(lambda: linear_q8.linear_q8(x, w, out_dtype=od)),
               median_ms(lambda: linear_q8.linear_q8_reference(x, w, out_dtype=od)),
               bound_ms(nbytes(x, w["q8"], w["scale"], ref), 2 * b * in_dim * out_dim, bf),
               int8pack(x, w), graph=lambda: linear_q8.linear_q8(x, w, out_dtype=od), library_graph=True)
    del head
    no_host_sync(dev, "H", lambda: linear_q8.linear_q8(x, w, out_dtype=od))

    e, k, h, i, n_sh = 64, 6, 1280, 896, 2

    def experts(n):
        return moe_q8.quantize_experts({"gate": randn(n, i, h, std=h**-0.5), "up": randn(n, i, h, std=h**-0.5),
                                        "down": randn(n, h, i, std=i**-0.5)})

    eq = experts(e)
    eq_pe = {**eq, **{f"pe_{n}": t for n, t in experts(n_sh).items()}}
    router = randn(e, h, std=h**-0.5)
    e_bytes = nbytes(*(eq[n][0] for n in ("gu_q8", "gu_scale", "down_q8", "down_scale")))
    for b, with_shared in ((1, True), (8, False)):
        x = randn(b, h, dtype=bf)
        wts, idx = route(x, router, k)
        n_visit = b * k + (b * n_sh if with_shared else 0)
        n_read = int(torch.unique(idx).numel()) + (n_sh if with_shared else 0)
        args = (x, eq_pe, wts, idx)
        ref = moe_q8.moe_ffn_decode_q8_reference(*args, with_shared=with_shared)
        got = moe_q8.moe_ffn_decode_q8(*args, with_shared=with_shared)
        record("I", f"B {b} k {k}{' + 2 pseudo-experts' if with_shared else ''}: {n_read} experts read, bf16", ref,
               got, tolerance(ref, bf), median_ms(lambda: moe_q8.moe_ffn_decode_q8(*args, with_shared=with_shared)),
               median_ms(lambda: moe_q8.moe_ffn_decode_q8_reference(*args, with_shared=with_shared)),
               bound_ms(nbytes(x, ref, wts, idx) + n_read * e_bytes, 2 * n_visit * 3 * h * i, bf),
               graph=lambda: moe_q8.moe_ffn_decode_q8(*args, with_shared=with_shared))
    no_host_sync(dev, "I (B 8)", lambda: moe_q8.moe_ffn_decode_q8(*args))
    for b in (16, 32):
        x = randn(b, h, dtype=bf)
        wts, idx = route(x, router, k)
        n_read = int(torch.unique(idx).numel()) + n_sh
        args = (x, eq_pe, wts, idx)
        ref = moe_decode.moe_ffn_decode_q8_visits_reference(*args)
        got = moe_decode.moe_ffn_decode_q8_fused(*args)
        record("J", f"B {b} k {k} + 2 pseudo-experts: {n_read} experts read, bf16", ref, got, tolerance(ref, bf),
               median_ms(lambda: moe_decode.moe_ffn_decode_q8_fused(*args)),
               median_ms(lambda: moe_decode.moe_ffn_decode_q8_visits_reference(*args)),
               bound_ms(nbytes(x, ref, wts, idx) + n_read * e_bytes, 2 * b * (k + n_sh) * 3 * h * i, bf),
               graph=lambda: moe_decode.moe_ffn_decode_q8_fused(*args))
    no_host_sync(dev, "J (B 32)", lambda: moe_decode.moe_ffn_decode_q8_fused(*args))
    for b in (8, 11, 16):
        x = randn(b, h, dtype=bf)
        args = (x, eq, *route(x, router, k))
        print(f"[cut-over] one int8 MoE decode layer, bf16, B {b} (B*k {'<=' if b * k <= e else '>'} E): "
              f"I {median_ms(lambda: moe_q8.moe_ffn_decode_q8(*args)):.3f} ms, "
              f"J {median_ms(lambda: moe_decode.moe_ffn_decode_q8_fused(*args)):.3f} ms")
    del eq, eq_pe

    cfg = DeepseekV2Config()
    hh, d = cfg.num_attention_heads, cfg.head_dim
    cos, sin = rope_consts(cfg, dev)
    attn = {"wqkv": qlin(3 * h, h), "wo": qlin(h, h)}
    for b, cap, kv_dt in ((1, 1024, f32), (1, 1024, bf), (16, 1024, f32), (16, 1024, bf)):
        k_all = randn(2, b, hh, cap, d, std=0.5, dtype=kv_dt)
        v_all = randn(2, b, hh, cap, d, dtype=kv_dt)
        xn = randn(b, 1, h, dtype=bf)
        pos = [300] if b == 1 else [0] + torch.linspace(1, cap - 1, b - 1).round().int().tolist()
        pos_b = torch.tensor(pos, dtype=torch.int32, device=dev)
        args = (xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b)
        ref = attn_fused.attn_decode_fused_reference(*args)
        got = attn_fused.attn_decode_fused(*args)
        n_keys = sum(pos)
        n_bytes = (nbytes(xn, attn["wqkv"]["q8"], attn["wqkv"]["scale"], attn["wo"]["q8"], attn["wo"]["scale"],
                          ref[0], ref[1], ref[2]) + 2 * n_keys * hh * d * k_all.element_size() + 2 * b * d * 4)
        flops = 2 * b * h * 4 * h + 4 * (n_keys + b) * hh * d
        for j, (r, g) in enumerate(zip(ref, got)):
            if j == 0:
                record("K", f"B {b} cap {cap} pos {pos[0] if b == 1 else '0..1023'}, bf16, "
                            f"{str(kv_dt)[6:]} cache", r, g, tolerance(r, bf),
                       median_ms(lambda: attn_fused.attn_decode_fused(*args)),
                       median_ms(lambda: attn_fused.attn_decode_fused_reference(*args)), bound_ms(n_bytes, flops, bf),
                       graph=lambda: attn_fused.attn_decode_fused(*args))
            elif not float((g.float() - r.float()).abs().max()) <= tolerance(r.float(), bf):
                raise AssertionError(f"K: new {'kv'[j - 1]} rows differ from the twin's")
    no_host_sync(dev, "K (B 16)", lambda: attn_fused.attn_decode_fused(*args))
    del k_all, v_all, attn
    torch.cuda.empty_cache()


def q4_results(dev, randn, record) -> None:
    """Kernels L, M, N and O at the int4 decode shapes of the full-width LM
    (`--int4`; the same shapes as q8_results), bf16 activations. L: lm_head
    at B = 1 and 16 (f32 logits), the dense down 6848 -> 1280 (its last
    group half padding); library call `torch._weight_int4pack_mm` (group
    128, unsigned levels + 8, zero point 0) where this build runs it. M: one
    row with the pseudo-experts, 8 rows without. N: 16 and 32 rows with
    them. O: one row at capacity 1024 and pos 300, f32 and bf16 caches; 16
    rows at ragged positions from 0. Then one int4 MoE decode layer timed as
    M and as N at B = 8, 11 and 16 (the B * k <= E cut-over), and each
    kernel once in sync-debug mode."""
    from deepseek_ocr2_tpu_torch.configs import DeepseekV2Config
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import rope_consts
    from deepseek_ocr2_tpu_torch.ops import attn_fused, linear_q4, moe_q4
    from deepseek_ocr2_tpu_torch.ops.moe import route

    bf, f32 = torch.bfloat16, torch.float32

    def qlin(out_dim, in_dim):
        return linear_q4.quantize_linear_q4(randn(out_dim, in_dim, std=in_dim**-0.5))

    def int4pack(x, w, ref):
        """`torch._weight_int4pack_mm` on the same levels and scales (bf16)
        where this build runs it on these shapes, else None: the library
        yardstick of L."""
        out_dim, in_dim = w["q4"].shape[0], x.shape[1]
        u = (linear_q4.unpack_q4(w["q4"])[:, :in_dim].to(torch.int32) + 8)
        sz = torch.stack([w["scale"].T, torch.zeros_like(w["scale"].T)], dim=-1).to(x.dtype).contiguous()
        try:  # uint8 [N, K / 2], the even element in the high nibble (PyTorch >= 2.5)
            packed = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
            got = torch._weight_int4pack_mm(x, packed, 128, sz)
            torch.cuda.synchronize(dev)
        except (AttributeError, RuntimeError, NotImplementedError) as e:
            print(f"[kernel] torch._weight_int4pack_mm unavailable here: {str(e).splitlines()[0][:160]}")
            return None
        print(f"[kernel] torch._weight_int4pack_mm [{out_dim}, {in_dim}] B {x.shape[0]}: max_abs_err "
              f"{float((got.float() - ref.float()).abs().max()):.3e} against L's twin")
        return lambda: torch._weight_int4pack_mm(x, packed, 128, sz)

    head = qlin(129280, 1280)
    for name, b, w, in_dim, od in (("lm_head", 1, head, 1280, f32), ("lm_head", 16, head, 1280, f32),
                                   ("dense down", 1, qlin(1280, 6848), 6848, None)):
        out_dim = w["q4"].shape[0]
        x = randn(b, in_dim, dtype=bf)
        ref = linear_q4.linear_q4_reference(x, w, out_dtype=od)
        got = linear_q4.linear_q4(x, w, out_dtype=od)
        record("L", f"{name} B {b} [{out_dim}, {in_dim}] bf16 -> {str(ref.dtype)[6:]}", ref, got,
               tolerance(ref, ref.dtype), median_ms(lambda: linear_q4.linear_q4(x, w, out_dtype=od)),
               median_ms(lambda: linear_q4.linear_q4_reference(x, w, out_dtype=od)),
               bound_ms(nbytes(x, w["q4"], w["scale"], ref), 2 * b * in_dim * out_dim, bf),
               int4pack(x, w, ref), graph=lambda: linear_q4.linear_q4(x, w, out_dtype=od), library_graph=True)
    del head
    no_host_sync(dev, "L", lambda: linear_q4.linear_q4(x, w, out_dtype=od))

    e, k, h, i, n_sh = 64, 6, 1280, 896, 2

    def experts(n):
        return moe_q4.quantize_experts_q4({"gate": randn(n, i, h, std=h**-0.5), "up": randn(n, i, h, std=h**-0.5),
                                           "down": randn(n, h, i, std=i**-0.5)})

    eq = experts(e)
    eq_pe = {**eq, **{f"pe_{n}": t for n, t in experts(n_sh).items()}}
    router = randn(e, h, std=h**-0.5)
    e_bytes = nbytes(*(eq[n][0] for n in ("gu_q4", "gu_scale", "down_q4", "down_scale")))
    for b, with_shared in ((1, True), (8, False)):
        x = randn(b, h, dtype=bf)
        wts, idx = route(x, router, k)
        n_visit = b * k + (b * n_sh if with_shared else 0)
        n_read = int(torch.unique(idx).numel()) + (n_sh if with_shared else 0)
        args = (x, eq_pe, wts, idx)
        ref = moe_q4.moe_ffn_decode_q4_reference(*args, with_shared=with_shared)
        got = moe_q4.moe_ffn_decode_q4(*args, with_shared=with_shared)
        record("M", f"B {b} k {k}{' + 2 pseudo-experts' if with_shared else ''}: {n_read} experts read, bf16", ref,
               got, tolerance(ref, bf), median_ms(lambda: moe_q4.moe_ffn_decode_q4(*args, with_shared=with_shared)),
               median_ms(lambda: moe_q4.moe_ffn_decode_q4_reference(*args, with_shared=with_shared)),
               bound_ms(nbytes(x, ref, wts, idx) + n_read * e_bytes, 2 * n_visit * 3 * h * i, bf),
               graph=lambda: moe_q4.moe_ffn_decode_q4(*args, with_shared=with_shared))
    no_host_sync(dev, "M (B 8)", lambda: moe_q4.moe_ffn_decode_q4(*args))
    for b in (16, 32):
        x = randn(b, h, dtype=bf)
        wts, idx = route(x, router, k)
        n_read = int(torch.unique(idx).numel()) + n_sh
        args = (x, eq_pe, wts, idx)
        ref = moe_q4.moe_ffn_decode_q4_visits_reference(*args)
        got = moe_q4.moe_ffn_decode_q4_fused(*args)
        record("N", f"B {b} k {k} + 2 pseudo-experts: {n_read} experts read, bf16", ref, got, tolerance(ref, bf),
               median_ms(lambda: moe_q4.moe_ffn_decode_q4_fused(*args)),
               median_ms(lambda: moe_q4.moe_ffn_decode_q4_visits_reference(*args)),
               bound_ms(nbytes(x, ref, wts, idx) + n_read * e_bytes, 2 * b * (k + n_sh) * 3 * h * i, bf),
               graph=lambda: moe_q4.moe_ffn_decode_q4_fused(*args))
    no_host_sync(dev, "N (B 32)", lambda: moe_q4.moe_ffn_decode_q4_fused(*args))
    for b in (8, 11, 16):
        x = randn(b, h, dtype=bf)
        args = (x, eq, *route(x, router, k))
        print(f"[cut-over] one int4 MoE decode layer, bf16, B {b} (B*k {'<=' if b * k <= e else '>'} E): "
              f"M {median_ms(lambda: moe_q4.moe_ffn_decode_q4(*args)):.3f} ms "
              f"(in a CUDA graph {graph_ms(lambda: moe_q4.moe_ffn_decode_q4(*args)):.4f}), "
              f"N {median_ms(lambda: moe_q4.moe_ffn_decode_q4_fused(*args)):.3f} ms "
              f"(in a CUDA graph {graph_ms(lambda: moe_q4.moe_ffn_decode_q4_fused(*args)):.4f})")
    del eq, eq_pe

    cfg = DeepseekV2Config()
    hh, d = cfg.num_attention_heads, cfg.head_dim
    cos, sin = rope_consts(cfg, dev)
    attn = {"wqkv": qlin(3 * h, h), "wo": qlin(h, h)}
    for b, cap, kv_dt in ((1, 1024, f32), (1, 1024, bf), (16, 1024, f32), (16, 1024, bf)):
        k_all = randn(2, b, hh, cap, d, std=0.5, dtype=kv_dt)
        v_all = randn(2, b, hh, cap, d, dtype=kv_dt)
        xn = randn(b, 1, h, dtype=bf)
        pos = [300] if b == 1 else [0] + torch.linspace(1, cap - 1, b - 1).round().int().tolist()
        pos_b = torch.tensor(pos, dtype=torch.int32, device=dev)
        args = (xn, attn, cfg, cos, sin, k_all, v_all, 1, pos_b)
        ref = attn_fused.attn_decode_fused_reference(*args)
        got = attn_fused.attn_decode_fused(*args)
        n_keys = sum(pos)
        n_bytes = (nbytes(xn, *attn["wqkv"].values(), *attn["wo"].values(), ref[0], ref[1], ref[2])
                   + 2 * n_keys * hh * d * k_all.element_size() + 2 * b * d * 4)
        flops = 2 * b * h * 4 * h + 4 * (n_keys + b) * hh * d
        for j, (r, g) in enumerate(zip(ref, got)):
            if j == 0:
                record("O", f"B {b} cap {cap} pos {pos[0] if b == 1 else '0..1023'}, bf16, "
                            f"{str(kv_dt)[6:]} cache", r, g, tolerance(r, bf),
                       median_ms(lambda: attn_fused.attn_decode_fused(*args)),
                       median_ms(lambda: attn_fused.attn_decode_fused_reference(*args)), bound_ms(n_bytes, flops, bf),
                       graph=lambda: attn_fused.attn_decode_fused(*args))
            elif not float((g.float() - r.float()).abs().max()) <= tolerance(r.float(), bf):
                raise AssertionError(f"O: new {'kv'[j - 1]} rows differ from the twin's")
    no_host_sync(dev, "O (B 16)", lambda: attn_fused.attn_decode_fused(*args))
    del k_all, v_all, attn
    torch.cuda.empty_cache()


def grouped_mm_library(kind: str, a, b, e_tile, tile_valid, n_experts: int = 0):
    """One `torch._grouped_mm` call computing kernel `kind`'s function on
    its aligned rows, for `library_ms`, or None (the reason printed): E
    a_t W_e^T and S a_t W_e per expert group of rows (2-D x 3-D, `offs` the
    groups' aligned ends); D as E on the gate||up weight [E, 2I, H] (the
    products alone, no SwiGLU); T dy^T x per group (2-D x 2-D, the groups along
    K; bf16 out where the card's torch takes no out_dtype). bf16 only. The
    operands are laid out as it asks (a transposed copy where the kernel
    reads in place) outside the timing. Timed only; the port never calls it."""
    from deepseek_ocr2_tpu_torch.ops.moe_gmm import GMM_BM, expert_tile_ranges

    if not hasattr(torch, "_grouped_mm"):
        print(f"[kernel] {kind} library: none (torch {torch.__version__} has no torch._grouped_mm)")
        return None
    if a.dtype != torch.bfloat16:
        print(f"[kernel] {kind} library: none in {a.dtype} (torch._grouped_mm takes bf16)")
        return None
    e = n_experts or b.shape[0]
    offs = (expert_tile_ranges(e_tile, tile_valid, e)[1:] * GMM_BM).to(torch.int32)
    if kind in ("D", "E"):
        forms = [(a, b.transpose(1, 2))]
    elif kind == "S":
        forms = [(a, b), (a, b.transpose(1, 2).contiguous().transpose(1, 2))]
    else:  # T: a = x [S, C], b = dy [S, O]
        forms = [(b.t().contiguous(), a), (b.t().contiguous(), a.t().contiguous().t())]
    errors = []
    for mat_a, mat_b in forms:
        for kw in ({"out_dtype": torch.float32}, {}) if kind == "T" else ({},):
            try:
                fn = (lambda mat_a=mat_a, mat_b=mat_b, kw=kw: torch._grouped_mm(mat_a, mat_b, offs=offs, **kw))
                fn()
                torch.cuda.synchronize()
                if kind == "T":
                    form = "out_dtype f32, the kernel's output" if kw else "bf16 out, half the bytes written"
                    print(f"[kernel] T library: torch._grouped_mm with {form}")
                return fn
            except Exception as exc:  # a layout or option this torch refuses: try the next
                errors.append(f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}")
    print(f"[kernel] {kind} library: none (torch._grouped_mm refused every layout: {errors})")
    return None


# T: dW sums in f32 over the expert's rows (exact bf16 products in bf16),
# another order than the twin's: the f32 bound relative to the largest
# output, for both dtypes.
def dw_tol(ref: torch.Tensor) -> float:
    return F32_TOL * max(1.0, float(ref.abs().max()))


# The Function's gradients against autograd through the grouped twin in
# f32: f32 within 1e-4 of each leaf's largest entry (sums in other orders
# through the backward); bf16 within 2e-2 (the Function rounds gate, up,
# act, dy, dact, dgate, dup and dx to bf16, the f32 autograd nothing).
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def gmm_backward_results(dev, randn, record) -> None:
    """Phase 8's kernels at one MoE layer of a training step at full width:
    B 4 x S 512 = 2048 tokens, k 6 (12 288 assignments), E 64, H 1280,
    I 896, bf16 (the main path's) then f32. E at the recompute's gate/up
    shape (K 1280, N 896), S for dact = dy Wd and dx_gate = dgate Wg, T for
    dW_gate = dgate^T x and dW_down = dy^T act, each against its twin on
    the same aligned rows (D, E at the down shape and the whole forward at
    this N are `gmm_results`'); then the whole backward of `moe_ffn_gmm`
    (dx, dW, d_weights) against autograd through `moe_ffn_gmm_reference`,
    and one forward and backward under sync-debug mode "error"."""
    from deepseek_ocr2_tpu_torch.ops import moe_gmm
    from deepseek_ocr2_tpu_torch.ops.moe import route

    e, k, h, i = 64, 6, 1280, 896
    n = TRAIN_B * TRAIN_S
    for dt in (torch.bfloat16, torch.float32):
        x = randn(n, h, dtype=dt)
        ex = {
            "gate": randn(e, i, h, std=h**-0.5, dtype=dt),
            "up": randn(e, i, h, std=h**-0.5, dtype=dt),
            "down": randn(e, h, i, std=i**-0.5, dtype=dt),
        }
        weights, idx = route(x, randn(e, h, std=h**-0.5), k)
        x_al, e_tile, tile_valid, _ = moe_gmm.align_rows(x, idx, e)
        dy = randn(x_al.shape[0], h, dtype=dt)  # the backward's [S, H] and [S, I] operands
        act = randn(x_al.shape[0], i, dtype=dt)
        dts = str(dt)[6:]
        case = f"N {n} k {k}: {tile_valid.numel()} tiles, {int(tile_valid.sum())} valid, {dts}"
        n_used = int(torch.unique(idx).numel())
        w_expert = nbytes(ex["gate"][0])
        flops = 2 * n * k * h * i  # every product here: M = N k rows by H by I

        # E, S and T as the backward calls them: the schedule built once for
        # the layer and passed to each call (the wrapper's own time excludes it).
        sched_s = moe_gmm.row_schedule(e_tile, tile_valid, e)
        sched_t = sched_s[:1]
        args = (x_al, ex["gate"], e_tile, tile_valid)
        ref = moe_gmm.gmm_down_reference(*args)
        torch.full(ref.shape, float("nan"), dtype=dt, device=dev)  # an unwritten row shows
        record("E", f"recompute gate = x Wg^T (K {h}, N {i}), {case}", ref, moe_gmm.moe_gmm_down(*args, *sched_s),
               tolerance(ref, dt), median_ms(lambda: moe_gmm.moe_gmm_down(*args, *sched_s)),
               median_ms(lambda: moe_gmm.gmm_down_reference(*args)),
               bound_ms(row_bytes(n * k, x_al, ref) + n_used * w_expert, flops, dt),
               grouped_mm_library("E", *args), graph=lambda: moe_gmm.moe_gmm_down(*args, *sched_s),
               library_graph=True)
        for what, a, w in (("dact = dy Wd", dy, ex["down"]), ("dx_gate = dgate Wg", act, ex["gate"])):
            args = (a, w, e_tile, tile_valid)
            ref = moe_gmm.gmm_dx_reference(*args)
            record("S", f"{what}, {tuple(a.shape)} x {tuple(w.shape)}, {case}", ref,
                   moe_gmm.moe_gmm_dx(*args, *sched_s), tolerance(ref, dt),
                   median_ms(lambda: moe_gmm.moe_gmm_dx(*args, *sched_s)),
                   median_ms(lambda: moe_gmm.gmm_dx_reference(*args)),
                   bound_ms(row_bytes(n * k, a, ref) + n_used * w_expert, flops, dt),
                   grouped_mm_library("S", *args), graph=lambda: moe_gmm.moe_gmm_dx(*args, *sched_s),
                   library_graph=True)
            del ref
        for what, xx, yy in (("dW_gate = dgate^T x", x_al, act), ("dW_down = dy^T act", act, dy)):
            args = (xx, yy, e_tile, tile_valid, e)
            ref = moe_gmm.gmm_dw_reference(*args)
            record("T", f"{what}, -> {tuple(ref.shape)} f32, {case}", ref, moe_gmm.moe_gmm_dw(*args, *sched_t),
                   dw_tol(ref), median_ms(lambda: moe_gmm.moe_gmm_dw(*args, *sched_t)),
                   median_ms(lambda: moe_gmm.gmm_dw_reference(*args), reps=3),
                   bound_ms(row_bytes(n * k, xx, yy) + nbytes(ref), flops, dt),
                   grouped_mm_library("T", *args), graph=lambda: moe_gmm.moe_gmm_dw(*args, *sched_t),
                   library_graph=True)
            if dt == torch.bfloat16 and xx is x_al:
                # T's floor on this card: its f32 output written once, by a fill in a graph.
                print(f"[kernel] T write floor: a fill of its {nbytes(ref) / 1e6:.1f} MB f32 output in a CUDA "
                      f"graph {graph_ms(lambda: ref.fill_(0.0)):.4f} ms")
            del ref
        del x_al, dy, act

        cot = randn(n, h)

        def grads(fn, up):
            leaves = [t.detach().to(up).requires_grad_() for t in (x, ex["gate"], ex["up"], ex["down"])]
            w = weights.detach().clone().requires_grad_()
            out = fn(leaves[0], dict(zip(("gate", "up", "down"), leaves[1:])), w, idx)
            return torch.autograd.grad((out.float() * cot).sum(), [*leaves, w])

        got = grads(moe_gmm.moe_ffn_gmm, dt)
        want = grads(moe_gmm.moe_ffn_gmm_reference, torch.float32)
        for name, a, b in zip(("dx", "dW_gate", "dW_up", "dW_down", "d_weights"), got, want):
            err, scale = float((a.float() - b).abs().max()), float(b.abs().max())
            tol = GRAD_RTOL[dt] * scale
            print(f"[kernel] moe_ffn_gmm backward {name} {dts}: max_abs_err {err:.3e} (tol {tol:.3e}, "
                  f"max |grad| {scale:.3e}) {'ok' if err <= tol else 'FAIL'}")
            if not err <= tol:
                raise AssertionError(f"moe_ffn_gmm backward {name} {dts}: error {err} above {tol}")
        del got, want
        if dt == torch.bfloat16:
            no_host_sync(dev, f"moe_ffn_gmm forward + backward ({case})", lambda: grads(moe_gmm.moe_ffn_gmm, dt))
        del x, ex
        torch.cuda.empty_cache()


def phase_kernels(dev) -> dict:
    from deepseek_ocr2_tpu_torch.ops.flash_attention import TC_KW, mha, mha_reference, mha_relpos, tc_key_tiles
    from deepseek_ocr2_tpu_torch.ops.fused_mlp import mlp_gelu, mlp_gelu_reference

    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, std=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    results = {}

    def record(kernel, case, ref, got, tol, ms, plain_ms, bound=None, library=None, graph=None,
               library_graph=False):
        """`bound`: bound_ms of the case's work; `library`: a callable of one
        PyTorch call computing the same function, timed here, or None;
        `graph`: a callable of the kernel's wrapper, timed by `graph_ms`, or
        None; `library_graph`: also time the library call by `graph_ms`
        (device time against device time)."""
        err = float((got.float() - ref.float()).abs().max())
        ok = err <= tol and bool(torch.isfinite(got.float()).all())
        lib_ms = median_ms(library) if library is not None else None
        dev_ms = graph_ms(graph) if graph is not None else None
        lib_dev_ms = None
        if library is not None and library_graph:
            try:
                lib_dev_ms = graph_ms(library)
            except RuntimeError as exc:  # a yardstick only: a call that cannot be captured is left out
                print(f"[kernel] {kernel} library: not captured in a CUDA graph ({str(exc).splitlines()[0][:120]})")
        bound, by = bound if bound is not None else (None, None)
        print(f"[kernel] {kernel} {case}: max_abs_err {err:.3e} (tol {tol:.1e}) "
              f"kernel {ms:.3f} ms{'' if dev_ms is None else f' (in a CUDA graph {dev_ms:.4f})'}, "
              f"plain {plain_ms:.3f} ms, bound {'-' if bound is None else f'{bound:.4f}'} ms "
              f"({by}), library {'none' if lib_ms is None else f'{lib_ms:.3f} ms'}"
              f"{'' if lib_dev_ms is None else f' (in a CUDA graph {lib_dev_ms:.4f})'} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{kernel} {case}: error {err} above {tol}")
        results.setdefault(kernel, []).append(dict(case=case, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                                                   bound_ms=bound, bound_by=by, library_ms=lib_ms, graph_ms=dev_ms,
                                                   library_graph_ms=lib_dev_ms))

    # D, E: the routed-expert MoE of a crop prompt at full LM width (bf16,
    # the CLI's LM dtype, first: it is the main-path case of the record).
    gmm_results(dev, randn, record)
    # F, G: the decode step of the 16-slot serving batch.
    decode_results(dev, randn, record)
    # H, I, J, K: the int8 decode step (--int8 and --moe-int8).
    q8_results(dev, randn, record)
    # L, M, N, O: the int4 decode step (--int4).
    q4_results(dev, randn, record)
    # S, T (and E at the recompute's shape): a training step's MoE backward.
    gmm_backward_results(dev, randn, record)
    # U, X: decode attention on the stacked contiguous cache, and on a
    # per-sequence pool; V: SAM's windowed attention, the bias built in the
    # kernel; W: the boundary-visit grouped GEMM, both modes.
    stacked_results(dev, record)
    window_results(dev, randn, record)
    visit_results(dev, randn, record)

    # B: SAM global [1, 12, 4096, 64] (64 x 64 grid) and windows [25, 12, 196, 64]
    # (14 x 14) of the 1024^2 view; at a 6-crop page the crops' global
    # [6, 12, 2304, 64] (48 x 48) and windows [96, 12, 196, 64]. Both dtypes
    # on the tensor cores: f32 (the CLI's vision dtype) in 3xTF32, bf16
    # (serve's) in bf16 m16n8k16 products; each also in a CUDA graph beside
    # SDPA in one.
    cases = [(case, b, side, dt) for case, b, side in (("global", 1, 64), ("window", 25, 14),
                                                       ("crop global", 6, 48), ("crop window", 96, 14))
             for dt in (torch.float32, torch.bfloat16)]
    for case, b, side, dt in cases:
        l = side * side
        q, k, v = (randn(b, 12, l, 64, dtype=dt) for _ in range(3))
        rh, rw = randn(b, 12, l, side, std=0.3), randn(b, 12, l, side, std=0.3)
        scale = 1.0 / 8.0
        ref = mha_reference(q, k, v, scale=scale, rel_h=rh, rel_w=rw)
        got = mha_relpos(q, k, v, rh, rw, scale=scale)
        ms = median_ms(lambda: mha_relpos(q, k, v, rh, rw, scale=scale))
        plain = median_ms(lambda: mha_reference(q, k, v, scale=scale, rel_h=rh, rel_w=rw))
        # Library: SDPA with the rel-pos bias materialized (outside the timing).
        bias = (rh[..., :, None] + rw[..., None, :]).reshape(b, 12, l, l).to(dt)
        record("B", f"{case} {tuple(q.shape)} {str(dt)[6:]}", ref, got, tolerance(ref, dt), ms, plain,
               bound_ms(nbytes(q, k, v, rh, rw, ref), 4 * b * 12 * l * l * 64, dt),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale),
               graph=lambda: mha_relpos(q, k, v, rh, rw, scale=scale), library_graph=True)
        del q, k, v, rh, rw, ref, got, bias

    # A: LM prefill, causal, f32 (3xTF32 on the tensor cores): a no-crop
    # prompt [1, 10, 260, 128] and a 6-crop one [1, 10, 1125, 128]. The
    # bound counts the causal products, 2 x 2 D per (query, key <= query).
    for length in (260, 1125):
        q, k, v = (randn(1, 10, length, 128) for _ in range(3))
        scale = 1.0 / math.sqrt(128)
        ref = mha_reference(q, k, v, scale=scale, mode="causal")
        got = mha(q, k, v, scale=scale, mode="causal")
        ms = median_ms(lambda: mha(q, k, v, scale=scale, mode="causal"))
        plain = median_ms(lambda: mha_reference(q, k, v, scale=scale, mode="causal"))
        record("A", f"causal {tuple(q.shape)} float32", ref, got, F32_TOL, ms, plain,
               bound_ms(nbytes(q, k, v, ref), 2 * 10 * 128 * length * (length + 1), torch.float32),
               lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, scale=scale),
               graph=lambda: mha(q, k, v, scale=scale, mode="causal"), library_graph=True)
        if length == 1125:
            # The walk of one head: TC_KW-key tiles each row group multiplies
            # (halved between its two warps) and the block stages, against
            # the tiles a walk of every key would visit.
            tiles = tc_key_tiles(length, length, "causal")
            n_all = -(-length // TC_KW)
            staged = int(((tiles.max(1).values + 1) // 2).sum()) * 2
            print(f"[kernel] A key tiles at {length} tokens, a head ({TC_KW} keys a tile): the row groups "
                  f"multiply {int(tiles.sum())} of {tiles.numel() * n_all} ({tiles.numel() * n_all - int(tiles.sum())} "
                  f"skipped), the blocks stage {staged} of {tiles.shape[0] * n_all}")

    # C: SAM MLP 768 -> 3072 -> 768, M = 4096 (one 1024^2 view), f32 M = 6 *
    # 2304 = 13824 (six 768^2 crops in one batch), bf16 M = 2304 (one crop,
    # serve's vision dtype).
    for m, dt in ((4096, torch.float32), (4096, torch.bfloat16), (6 * 2304, torch.float32), (2304, torch.bfloat16)):
        x = randn(m, 768, dtype=dt)
        w1, b1 = randn(3072, 768, std=768**-0.5, dtype=dt), randn(3072, std=0.02, dtype=dt)
        w2, b2 = randn(768, 3072, std=3072**-0.5, dtype=dt), randn(768, std=0.02, dtype=dt)
        ref = mlp_gelu_reference(x, w1, b1, w2, b2)
        got = mlp_gelu(x, w1, b1, w2, b2)
        ms = median_ms(lambda: mlp_gelu(x, w1, b1, w2, b2))
        plain = median_ms(lambda: mlp_gelu_reference(x, w1, b1, w2, b2))
        record("C", f"{tuple(x.shape)} x {tuple(w1.shape)} {str(dt)[6:]}", ref, got, tolerance(ref, dt), ms, plain,
               bound_ms(nbytes(x, w1, b1, w2, b2, ref), 2 * 2 * m * 768 * 3072, dt),
               graph=lambda: mlp_gelu(x, w1, b1, w2, b2))
    torch.cuda.synchronize(dev)
    return results


# ---------------------------------------------------------------------------
# Weights


def random_hf_flat(cfg, randn) -> dict:
    """HF-layout random weights for an OCR2Config. `randn(shape, std)`
    returns an f32 tensor; linears use std fan_in^-1/2, norms 1 + noise."""
    sam, qw = cfg.sam, cfg.qwen2
    flat = random_lm_hf_flat(cfg.lm, randn)

    def lin(name, out_f, in_f):
        flat[name] = randn((out_f, in_f), in_f**-0.5)

    def ones(name, n):
        flat[name] = 1.0 + randn((n,), 0.02)

    h = cfg.lm.hidden_size
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


def random_lm_hf_flat(lm, randn) -> dict:
    """The LM's part of `random_hf_flat` (a DeepseekV2Config), drawn first
    and in the same order."""
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


def synthetic_page(w: int, h: int, cfg, seed: int, grid=(1, 1), host_stage: bool = False):
    """A page with text-like dark strokes. Returns a PIL image when PIL is
    installed and `host_stage` is false (the pipeline then decides the crop
    grid itself); otherwise the host-stage dict of the pipeline: the page
    drawn straight at its letterboxed size into a [1, 3, S, S] uint8 canvas
    of pad colour 127 and, for a crop grid (gw, gh), drawn at gw x gh crop
    sizes and cut into [gw * gh, 3, c, c] row-major tiles."""
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

    if Image is not None and not host_stage:
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
    from deepseek_ocr2_tpu_torch.ops.moe_decode import moe_ffn_decode_fused
    from deepseek_ocr2_tpu_torch.ops.moe_gmm import moe_gmm_down, moe_gmm_swiglu
    from deepseek_ocr2_tpu_torch.ops.paged_attention import paged_decode_attention_pool, paged_decode_attention_pool_q8
    from deepseek_ocr2_tpu_torch.ops.attn_fused import attn_decode_fused
    from deepseek_ocr2_tpu_torch.ops.linear_q8 import linear_q8
    from deepseek_ocr2_tpu_torch.ops.moe_decode import moe_ffn_decode_q8_fused
    from deepseek_ocr2_tpu_torch.ops.moe_q8 import moe_ffn_decode_q8
    from deepseek_ocr2_tpu_torch.ops.attn_fused import attn_decode_fused_q4
    from deepseek_ocr2_tpu_torch.ops.linear_q4 import linear_q4
    from deepseek_ocr2_tpu_torch.ops.moe_q4 import moe_ffn_decode_q4, moe_ffn_decode_q4_fused
    from deepseek_ocr2_tpu_torch.ops.paged_attention import (
        paged_decode_attention_pool_chunk,
        paged_decode_attention_pool_chunk_q8,
    )

    from deepseek_ocr2_tpu_torch.ops.moe_gmm import moe_gmm_dw, moe_gmm_dx
    from deepseek_ocr2_tpu_torch.ops.flash_attention import mha_win
    from deepseek_ocr2_tpu_torch.ops.moe_gmm import gmm_ffn_visit, gmm_swiglu_visit
    from deepseek_ocr2_tpu_torch.ops.paged_attention import decode_attention_stacked, paged_decode_attention

    return {"A": mha, "B": mha_relpos, "C": mlp_gelu, "D": moe_gmm_swiglu, "E": moe_gmm_down,
            "F": moe_ffn_decode_fused, "G": paged_decode_attention_pool, "H": linear_q8, "I": moe_ffn_decode_q8,
            "J": moe_ffn_decode_q8_fused, "K": attn_decode_fused, "L": linear_q4, "M": moe_ffn_decode_q4,
            "N": moe_ffn_decode_q4_fused, "O": attn_decode_fused_q4, "P": paged_decode_attention_pool_q8,
            "Q": paged_decode_attention_pool_chunk, "R": paged_decode_attention_pool_chunk_q8,
            "S": moe_gmm_dx, "T": moe_gmm_dw, "U": decode_attention_stacked, "V": mha_win,
            "W": LaunchSum(gmm_swiglu_visit, gmm_ffn_visit), "X": paged_decode_attention}


class LaunchSum:
    """The launch count of a kernel with two wrappers (W's two modes): reads
    their sum, and a write sets both."""

    def __init__(self, *fns):
        self.fns = fns

    @property
    def launches(self) -> int:
        return sum(fn.launches for fn in self.fns)

    @launches.setter
    def launches(self, value: int) -> None:
        for fn in self.fns:
            fn.launches = value


# The quantized tiers of the CLI: (flag, scope, bits).
INT8, MOE_INT8, INT4 = ("--int8", "full", 8), ("--moe-int8", "experts", 8), ("--int4", "full", 4)


def quant_launches_per_step(lm, scope: str, bits: int, rows: int, paged: bool, q8_pool: bool = False) -> dict:
    """The quantized kernels' launches in one decode step, derived from the
    code (models/deepseek_v2.py `lm_forward` / `ffn`, runtime/paged_kv.py);
    int8 names first, int4 ones after the slash:
    - K / O once a layer with quantized attention weights, on the contiguous
      cache (scope "full", not paged); paged decode runs G and H / L for qkv
      and wo;
    - the routed experts: I / M while rows * k <= E, J / N above, once a MoE
      layer;
    - H / L for the dense MLP's two linears and for lm_head, and in scope
      "full" for the shared MLP's two unless the pseudo-experts are folded
      in (always with J / N, at one row with I / M).
    The other tier's four kernels, F and the chunk kernels Q and R launch
    none; on a quantized pool (`q8_pool`) P takes G's place."""
    full = scope == "full"
    n_moe, n_dense = lm.num_moe_layers, lm.first_k_dense_replace
    j = rows * lm.num_experts_per_tok > lm.n_routed_experts
    shared_h = 0 if (j or rows == 1) else 2 * n_moe
    att, sel, distinct, lin = "KIJH" if bits == 8 else "OMNL"
    want = dict.fromkeys("FGHIJKLMNOPQRSTUVWX", 0)
    want.update({
        att: lm.num_hidden_layers if full and not paged else 0,
        "P" if q8_pool else "G": lm.num_hidden_layers if paged else 0,
        sel: 0 if j else n_moe,
        distinct: n_moe if j else 0,
        lin: (2 * n_dense + 1 + shared_h + (2 * lm.num_hidden_layers if paged else 0)) if full else 0,
    })
    return want


def phase_main_path(dev):
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
    results = {}
    for name, grid, page, _ in pages:
        before = {k: fn.launches for k, fn in kernels.items()}
        r = results[name] = pipe.generate_ocr(page, max_new_tokens=32, ngram_size=20)
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
    for k in "ABCDE":
        if launches[k] == 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    return launches, pipe, results


SWITCHES = {"DEEPSEEK_DECODE_ATTN": "stacked", "DEEPSEEK_SAM_WIN_KERNEL": "1"}


@contextlib.contextmanager
def switched(on: bool = True):
    """Both of the JAX package's switches set, as a user sets them (on), or
    both unset (the default paths); the environment restored after."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    for k in SWITCHES:
        os.environ.pop(k, None)
    if on:
        os.environ.update(SWITCHES)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def uncounted(kernels: dict):
    """A reference run inside a counted window: every count is restored on
    exit, so its launches do not count as the main path's."""
    saved = {k: fn.launches for k, fn in kernels.items()}
    try:
        yield
    finally:
        for k, fn in kernels.items():
            fn.launches = saved[k]


def _group_step_logits(pipe, pages, max_new_tokens: int, ngram_size: int):
    """The tokens [B, S + max_new_tokens] and every step's logits [B, V]
    (CPU f32) of the group engine's decode of `pages` (one chunk of no-crop
    pages) on the current paths: the engine's own batched vision prefill
    and greedy_generate, with the logits kept."""
    from deepseek_ocr2_tpu_torch.runtime.engine import batched_vision_prefill
    from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate
    from deepseek_ocr2_tpu_torch.runtime.kv_cache import bucket_capacity
    from deepseek_ocr2_tpu_torch.utils.tokenizer import tokenize_with_image

    cfg = pipe.cfg
    bases = torch.cat([pipe.preprocess_finish(p if isinstance(p, dict) else pipe.preprocess_host(p))[0]
                       for p in pages])
    ids, _, start = tokenize_with_image(pipe.tokenizer, cfg.default_ocr_prompt, cfg, (1, 1))
    ids_t, embeds = batched_vision_prefill(pipe, ids, bases, None, start)
    stats = {}
    tokens, _ = greedy_generate(pipe.params["lm"], cfg.lm, embeds, ids_t, max_new_tokens=max_new_tokens,
                                ngram_size=ngram_size, eos_id=cfg.eos_token_id, kv_dtype=pipe.kv_dtype, rope=pipe.rope,
                                capacity=bucket_capacity(len(ids) + max_new_tokens), stats=stats, keep_logits=True)
    return tokens.cpu(), stats["logits"]


def phase_switched_main_path(dev, pipe, main_results, group_ref, group_pages) -> dict:
    """Phase 4e (run after 6b, whose group run it compares with): the JAX
    package's two switches, DEEPSEEK_DECODE_ATTN=stacked (kernel U in every
    decode step on the contiguous cache) and DEEPSEEK_SAM_WIN_KERNEL=1
    (kernel V in SAM's 8 windowed blocks, B in the 4 global ones), set for
    this phase only, on phase 3's full-width model:
    - generate_ocr on the first no-crop page and the (2, 1) crop page at 32
      tokens (U 12 a decode step, V 8 and B 4 a SAM batch), vision ms and
      decode tok/s beside the same pages on the default paths (whose tokens
      must equal phase 4's);
    - OCR2Engine(batch_size=16) on phase 6b's 16 pages (U 12 a step at 16
      rows) against 6b's bf16 group run;
    - one --int8 no-crop page (K 0: the fused attention runs only under
      "pool"; U 12 a step) against the same page on the default paths (K).
    Tokens under phase 7's top-2 margin rule, at the bf16 LM's bound
    (`_first_difference`). Returns the launches of the switched runs alone:
    the reference runs on the default paths inside the phase are
    `uncounted`."""
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import quantize_lm_params
    from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine

    cfg, lm = pipe.cfg, pipe.cfg.lm
    lm_dtype = pipe.params["lm"]["embed"].dtype  # the LM's activations (bf16 here), int8 weights or not
    n_glob = len(cfg.sam.global_attn_indexes)
    n_win = cfg.sam.depth - n_glob
    kernels = counters()
    w, h, grid = CROP_PAGES[0]
    pages = [(f"{PAGES[0][0]}x{PAGES[0][1]}", (1, 1), synthetic_page(*PAGES[0], cfg, seed=0)[0]),
             (f"{w}x{h} crop", grid, synthetic_page(w, h, cfg, seed=10, grid=grid)[0])]
    gen = dict(max_new_tokens=32, ngram_size=20)
    defaults = {name: pipe.generate_ocr(page, keep_logits=True, **gen) for name, _, page in pages}
    for name, r in defaults.items():
        if r.token_ids != main_results[name].token_ids:
            raise AssertionError(f"page {name}: the default paths' tokens differ from phase 4's")

    def check(what, delta, want):
        bad = {k: (delta[k], n) for k, n in want.items() if delta[k] != n}
        if bad:
            raise AssertionError(f"{what}: launches (got, expected) {bad}")

    for fn in kernels.values():
        fn.launches = 0
    with switched():
        for name, _, page in pages:
            before = {k: fn.launches for k, fn in kernels.items()}
            r = pipe.generate_ocr(page, **gen)
            delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
            ref = defaults[name]
            n_sam = 1 if r.crop_ratio == (1, 1) else 2  # the global view, then the crops
            note = _first_difference(ref, r, lm_dtype)
            print(f"[switched] page {name}: vision {r.vision_seconds * 1e3:.1f} ms (default "
                  f"{ref.vision_seconds * 1e3:.1f}), decode {r.decode_tokens_per_sec:.1f} tok/s (default "
                  f"{ref.decode_tokens_per_sec:.1f}) for {r.new_tokens} tokens; tokens "
                  f"{note or 'equal to phase 4'}; launches {delta}")
            if not torch.isfinite(r.logits0).all():
                raise AssertionError(f"switched page {name}: non-finite step-0 logits")
            check(f"switched page {name}", delta, {"U": lm.num_hidden_layers * (r.new_tokens - 1),
                                                   "V": n_win * n_sam, "B": n_glob * n_sam, "G": 0, "K": 0})

        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        res = OCR2Engine(pipe, batch_size=16).run(group_pages, max_new_tokens=64, ngram_size=20)
        dt = time.perf_counter() - t0
        delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
        steps = max(r.new_tokens for r in res) - 1
        chunks = {}  # one chunk a crop grid (at full width: the 16 pages are one no-crop chunk)
        for r in res:
            chunks.setdefault(r.crop_ratio, []).append(r.new_tokens - 1)
        u_want = lm.num_hidden_layers * sum(max(c) for c in chunks.values())
        n_sam = sum(1 if g == (1, 1) else 2 for g in chunks)
        differ = [i for i, (a, b) in enumerate(zip(group_ref, res)) if a.token_ids != b.token_ids]
        notes = []
        if differ:  # the reference's own logits decide: 6b's group decode again, logits kept
            with switched(False), uncounted(kernels):
                tokens, logits = _group_step_logits(pipe, group_pages, 64, 20)
            for i in differ:
                ref_ids = group_ref[i].token_ids
                if tokens[i, : len(ref_ids)].tolist() != ref_ids:
                    raise AssertionError(f"page {i}: the default group decode did not repeat phase 6b's tokens")
                ref = dataclasses.replace(group_ref[i], step_logits=[step[i] for step in logits])
                notes.append(f"page {i}: {_first_difference(ref, res[i], lm_dtype)}")
        print(f"[switched] OCR2Engine(batch_size=16), 16 pages: {dt:.2f} s = {16 / dt:.2f} pages/s, "
              f"{16 * steps / res[0].decode_seconds:.1f} tok/s in decode; {16 - len(differ)} of 16 pages "
              f"token-equal to phase 6b's bf16 group run {notes}; launches {delta}")
        check("switched group engine", delta, {"U": u_want, "V": n_win * n_sam, "B": n_glob * n_sam, "K": 0})

        bf16_lm = pipe.params["lm"]
        pipe.params = {**pipe.params, "lm": quantize_lm_params(bf16_lm, scope="full", bits=8)}
        try:
            name, _, page = pages[0]
            before = {k: fn.launches for k, fn in kernels.items()}
            r = pipe.generate_ocr(page, **gen)
            delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
            with switched(False), uncounted(kernels):  # the reference: the default paths (K)
                ref = pipe.generate_ocr(page, keep_logits=True, **gen)
        finally:
            pipe.params = {**pipe.params, "lm": bf16_lm}
            torch.cuda.empty_cache()
        note = _first_difference(ref, r, lm_dtype)
        print(f"[switched] --int8 page {name}: decode {r.decode_tokens_per_sec:.1f} tok/s (default, kernel K: "
              f"{ref.decode_tokens_per_sec:.1f}); tokens {note or 'equal to the default paths'}; launches {delta}")
        check("switched --int8 page", delta, {"U": lm.num_hidden_layers * (r.new_tokens - 1), "K": 0})
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"[switched] launches over phase 4e {launches}")
    return launches


def phase_switched_card_vs_cpu(dev, card_pipe, cpu_params) -> None:
    """Phase 5d: phase 5's reduced-depth f32 model with both switches, card
    against CPU (U's and V's twins there): the no-crop and (2, 1) crop
    pages, every step's logits up to the first token difference within
    phase 5's tolerance, tokens under the margin rule on the CPU's logits,
    U and V launched on the card."""
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    cfg = card_pipe.cfg
    cpu_pipe = OCR2Pipeline(cpu_params, cfg, StubTokenizer(cfg.lm.vocab_size), device="cpu", kv_dtype="float32",
                            act_dtype="float32")
    w, h, grid = CROP_PAGES[0]
    pages = {"no-crop": synthetic_page(*PAGES[0], cfg, seed=99)[0],
             f"{grid} crop": synthetic_page(w, h, cfg, seed=98, grid=grid)[0]}
    kernels = counters()
    with switched():
        for name, page in pages.items():
            cpu = cpu_pipe.generate_ocr(page, max_new_tokens=8, ngram_size=20, keep_logits=True)
            before = {k: fn.launches for k, fn in kernels.items()}
            card = card_pipe.generate_ocr(page, max_new_tokens=8, ngram_size=20, keep_logits=True)
            delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
            note = _first_difference(cpu, card)
            # Every step up to the first token difference decodes the same
            # prefix on both sides: its logits are held to the CPU's (U in
            # each decode step, V and the prefill in step 0).
            a, b = cpu.token_ids[cpu.prompt_len:], card.token_ids[card.prompt_len:]
            same = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]), min(len(a), len(b)))
            steps = min(same + 1, len(cpu.step_logits), len(card.step_logits))
            errs = [(float((c - g.cpu()).abs().max()), LOGITS_RTOL * float(c.abs().max()))
                    for c, g in zip(cpu.step_logits[:steps], card.step_logits[:steps])]
            print(f"[cpu-vs-card] switched {name}: logits max_abs_err (tol) over {steps} steps "
                  f"{[f'{e:.3e} ({t:.3e})' for e, t in errs]}; tokens {note or 'equal'}; card launches "
                  f"U {delta['U']} V {delta['V']} B {delta['B']}")
            bad = [(i, e, t) for i, (e, t) in enumerate(errs) if not e <= t]
            if bad:
                raise AssertionError(f"switched {name}: logits differ above LOGITS_RTOL at (step, err, tol) {bad}")
            if delta["U"] != cfg.lm.num_hidden_layers * (card.new_tokens - 1) or delta["V"] == 0:
                raise AssertionError(f"switched {name}: the card did not run U / V as expected: {delta}")


def decode_per_token(pipe, page, n: int = 16) -> dict:
    """Device kernel time, device launches and wall time per decode token of
    one page, on the pipeline's current LM weights: greedy_generate with
    1 and with n + 1 new tokens (no EOS stop) under torch.profiler, the
    difference over n. Launches count every device activity the profiler
    records (kernels, copies, fills)."""
    from torch.profiler import ProfilerActivity, profile

    from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate
    from deepseek_ocr2_tpu_torch.runtime.kv_cache import bucket_capacity
    from deepseek_ocr2_tpu_torch.utils.tokenizer import tokenize_with_image

    cfg, dev = pipe.cfg, pipe.device
    pre = page if isinstance(page, dict) else pipe.preprocess_host(page)
    base, patches, ratio, _ = pipe.preprocess_finish(pre)
    ids, _, start = tokenize_with_image(pipe.tokenizer, cfg.default_ocr_prompt, cfg, ratio)
    embeds = pipe.build_ocr_embeds(ids, base, patches, start)

    def gen(m):
        return greedy_generate(pipe.params["lm"], cfg.lm, embeds, torch.tensor(ids), max_new_tokens=m,
                               ngram_size=20, eos_id=-1, capacity=bucket_capacity(len(ids) + m),
                               kv_dtype=pipe.kv_dtype, rope=pipe.rope)

    gen(n + 1)  # warm-up

    def measure(m):
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gen(m)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        return wall, sum(e.self_device_time_total for e in rows) / 1e3, sum(e.count for e in rows)

    w1, d1, c1 = measure(1)
    wn, dn, cn = measure(n + 1)
    return {"wall_ms": (wn - w1) * 1e3 / n, "device_ms": (dn - d1) / n, "launches": (cn - c1) / n}


def phase_quant_main_path(dev, pipe, tiers, tag: str) -> dict:
    """Phases 4b (`tiers` --int8, --moe-int8) and 4c (--int4): phase 3's LM
    quantized on the card for each tier, a no-crop page and the (2, 1) crop
    page through generate_ocr, each kernel's launches held to
    `quant_launches_per_step` times the decode steps (plus H or L once after
    prefill for a quantized lm_head, and D and E once a MoE layer in the
    crop page's prefill, on the dequantized experts). Returns the
    launches."""
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import quantize_lm_params

    cfg, lm = pipe.cfg, pipe.cfg.lm
    kernels = counters()
    bf16_lm = pipe.params["lm"]
    w, h, grid = CROP_PAGES[0]
    pages = [(f"{PAGES[0][0]}x{PAGES[0][1]}", (1, 1), synthetic_page(*PAGES[0], cfg, seed=0)[0]),
             (f"{w}x{h} crop", grid, synthetic_page(w, h, cfg, seed=10, grid=grid)[0])]
    launches = dict.fromkeys(kernels, 0)
    for fn in kernels.values():
        fn.launches = 0
    for flag, scope, bits in tiers:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        pipe.params = {**pipe.params, "lm": quantize_lm_params(bf16_lm, scope=scope, bits=bits)}
        torch.cuda.synchronize(dev)
        print(f"[{tag}] {flag}: LM quantized on the card in {time.perf_counter() - t0:.1f} s, "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB on the card")
        per_step = quant_launches_per_step(lm, scope, bits, rows=1, paged=False)
        for name, grid, page in pages:
            before = {k: fn.launches for k, fn in kernels.items()}
            r = pipe.generate_ocr(page, max_new_tokens=32, ngram_size=20)
            delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
            launches = {k: launches[k] + delta[k] for k in launches}
            steps = r.new_tokens - 1
            want = {k: n * steps for k, n in per_step.items()}
            want["H" if bits == 8 else "L"] += 1 if scope == "full" else 0  # the quantized lm_head after prefill
            moe_prefill = lm.num_moe_layers if grid != (1, 1) else 0
            want.update(D=moe_prefill, E=moe_prefill)
            finite = bool(torch.isfinite(r.logits0).all())
            print(f"[{tag}] {flag} page {name}: crop grid {r.crop_ratio}, prompt {r.prompt_len} tokens, "
                  f"vision {r.vision_seconds * 1e3:.1f} ms, prefill {r.prefill_seconds * 1e3:.1f} ms, "
                  f"decode {r.decode_seconds * 1e3:.1f} ms for {r.new_tokens} tokens "
                  f"({r.decode_tokens_per_sec:.1f} tok/s), launches {delta}, logits finite {finite}")
            print(f"[{tag}]   tokens {r.token_ids[r.prompt_len:]}")
            bad = {k: (delta[k], n) for k, n in want.items() if delta[k] != n}
            if not finite or r.crop_ratio != grid or bad or min(delta[k] for k in "ABC") == 0:
                raise AssertionError(f"{flag} page {name}: launches (got, derived) {bad}, finite {finite}")
        pipe.params = {**pipe.params, "lm": bf16_lm}  # one quantized copy on the card at a time
        torch.cuda.empty_cache()
    print(f"[{tag}] launches over the phase {launches}")
    return launches


def phase_lookup_main_path(dev, pipe) -> dict:
    """Phase 4d: prompt-lookup decoding (lookup_chunk 4) of one no-crop page
    through generate_ocr on phase 3's bf16 LM and f32 cache. The chunk
    forward attends with the plain sdpa on the contiguous cache (no G, P,
    K, O, Q or R) and its MoE takes the per-selection path (4 rows x 6 <= 64
    experts: no F), so only the prefill's kernels launch: A, B and C.
    Returns the launches."""
    cfg = pipe.cfg
    kernels = counters()
    page = synthetic_page(*PAGES[0], cfg, seed=0)[0]
    pipe.lookup_chunk = 4
    try:
        pipe.generate_ocr(page, max_new_tokens=8, ngram_size=20)  # the chunk shapes' first calls, not timed
        for fn in kernels.values():
            fn.launches = 0
        r = pipe.generate_ocr(page, max_new_tokens=64, ngram_size=20)
    finally:
        pipe.lookup_chunk = 0
    launches = {k: fn.launches for k, fn in kernels.items()}
    fw = r.lookup_forwards
    decode_fw = fw - 1  # the prefill counts as one
    print(f"[lookup] generate_ocr, lookup_chunk 4, no-crop page {PAGES[0][0]}x{PAGES[0][1]}: prompt {r.prompt_len}, "
          f"{r.new_tokens} tokens in {fw} forwards ({(r.new_tokens - 1) / max(decode_fw, 1):.2f} tokens a chunk "
          f"forward), prefill {r.prefill_seconds * 1e3:.1f} ms, decode {r.decode_seconds * 1e3:.1f} ms "
          f"({r.decode_tokens_per_sec:.1f} tok/s, {r.decode_seconds * 1e3 / max(decode_fw, 1):.2f} ms a forward); "
          f"launches {launches}, a chunk forward "
          f"{ {k: n / max(decode_fw, 1) for k, n in launches.items() if k not in 'ABC'} }")
    print(f"[lookup]   tokens {r.token_ids[r.prompt_len:]}")
    bad = {k: n for k, n in launches.items() if k not in "ABC" and n}
    if bad or min(launches[k] for k in "ABC") == 0 or r.new_tokens < 1 or decode_fw < 1:
        raise AssertionError(f"lookup generate_ocr: launches {launches}, expected A, B, C only")
    return launches


def phase_device_resize(dev, pipe, main_results) -> dict:
    """Phase 4f: the device resize (`--device-resize`,
    preprocess/device_resize.py) at full width on phase 3's model.
    - the (2, 3) crop page 1700 x 2200 and the no-crop page 700 x 500:
      `device_preprocess_page` on the card bit-equal to host PIL
      (`preprocess_base_u8` / `preprocess_tiles_u8`) and to its own CPU
      form; its time (CUDA events, median of 10: ship + resize, and the
      resize of an already shipped page) beside host PIL's (median of 10)
      and the bytes each path ships;
    - generate_ocr with device_resize=True on the crop page: phase 4's
      tokens (the same pixels, the same model);
    - phase 4's four pages (2 crop, 2 no-crop) through the continuous engine
      (4 slots) under DEEPSEEK_DEVICE_RESIZE=auto, the crop pages resized on
      the card by the prefetch worker: each page's tokens against its
      single-page run under the margin rule of phase 4e (bf16 LM).
    Counted: the device-resized generate_ocr (A-E as phase 4's crop page: D
    and E 11) and the engine (G 12 a decode step, no F at 4 x 6 <= 64
    selections); the single-page references are `uncounted`."""
    from PIL import Image  # PIL is the oracle of this phase

    from deepseek_ocr2_tpu_torch.preprocess.device_resize import (
        bucket_pad, device_letterbox_u8, device_preprocess_page, device_tiles_u8, ship_image)
    from deepseek_ocr2_tpu_torch.preprocess.image import preprocess_base_u8, preprocess_tiles_u8
    from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    t_phase = time.perf_counter()
    cfg, lm = pipe.cfg, pipe.cfg.lm
    lm_dtype = pipe.params["lm"]["embed"].dtype
    s, c, pad = cfg.base_image_size, cfg.crop_image_size, cfg.pad_color
    kernels = counters()
    w, h, grid = CROP_PAGES[1]
    crop_name = f"{w}x{h} crop"
    crop_page = synthetic_page(w, h, cfg, seed=11, grid=grid)[0]
    plain_page = synthetic_page(*PAGES[0], cfg, seed=0)[0]
    if not isinstance(crop_page, Image.Image):
        raise AssertionError("phase 4f needs PIL pages")
    for name, page, ratio in ((crop_name, crop_page, grid), (f"{PAGES[0][0]}x{PAGES[0][1]}", plain_page, None)):
        arr = np.asarray(page)
        base, tiles = device_preprocess_page(arr, s, c, ratio, pad, device=dev)
        cpu_base, cpu_tiles = device_preprocess_page(arr, s, c, ratio, pad, device="cpu")
        pil_base = preprocess_base_u8(page, s, pad)
        pil_tiles = preprocess_tiles_u8(page, c, ratio) if ratio else None
        same = [np.array_equal(base.cpu().numpy(), pil_base), np.array_equal(cpu_base.numpy(), pil_base)]
        if ratio:
            same += [np.array_equal(tiles.cpu().numpy(), pil_tiles), np.array_equal(cpu_tiles.numpy(), pil_tiles)]
        elif tiles is not None:
            raise AssertionError(f"page {name}: tiles without a crop grid")
        shipped = ship_image(arr, dev)
        whole_ms = median_ms(lambda: device_preprocess_page(arr, s, c, ratio, pad, device=dev))

        def resize_only():
            if ratio:
                device_tiles_u8(shipped, arr.shape[1], arr.shape[0], c, ratio)
            device_letterbox_u8(shipped, arr.shape[1], arr.shape[0], s, pad)

        resize_ms = median_ms(resize_only)
        host_times = []
        for _ in range(10):
            t0 = time.perf_counter()
            preprocess_base_u8(page, s, pad)
            if ratio:
                preprocess_tiles_u8(page, c, ratio)
            host_times.append((time.perf_counter() - t0) * 1e3)
        host_bytes = pil_base.nbytes + (pil_tiles.nbytes if ratio else 0)
        print(f"[resize] page {name}: device bit-equal to host PIL and to the CPU form: {all(same)}; device "
              f"{whole_ms:.3f} ms with the ship ({bucket_pad(arr).nbytes} bytes of the padded page), {resize_ms:.3f} "
              f"ms the resize alone; host PIL {float(np.median(host_times)):.3f} ms (median of 10; its views "
              f"{host_bytes} bytes to ship)")
        if not all(same):
            raise AssertionError(f"page {name}: the device resize differs from PIL or its CPU form: {same}")
        del base, tiles, shipped

    dpipe = OCR2Pipeline(pipe.params, cfg, pipe.tokenizer, device=dev, kv_dtype="float32", act_dtype="float32",
                         device_resize=True)
    gen = dict(max_new_tokens=32, ngram_size=20)
    for fn in kernels.values():
        fn.launches = 0
    r = dpipe.generate_ocr(crop_page, **gen)
    want = main_results[crop_name]
    print(f"[resize] generate_ocr(device_resize=True), page {crop_name}: vision {r.vision_seconds * 1e3:.1f} ms "
          f"(phase 4, host resize: {want.vision_seconds * 1e3:.1f}); tokens equal to phase 4's: "
          f"{r.token_ids == want.token_ids}; launches { {k: fn.launches for k, fn in kernels.items()} }")
    if r.token_ids != want.token_ids or r.crop_ratio != grid:
        raise AssertionError(f"page {crop_name}: device-resize tokens differ from phase 4's")
    if kernels["D"].launches != lm.num_moe_layers or kernels["E"].launches != lm.num_moe_layers:
        raise AssertionError("the device-resized crop page did not run D and E once a MoE layer")

    names = [f"{w}x{h} crop" for w, h, _ in CROP_PAGES] + [f"{w}x{h}" for w, h in PAGES[:2]]
    pages = [synthetic_page(w, h, cfg, seed=10 + i, grid=g)[0] for i, (w, h, g) in enumerate(CROP_PAGES)]
    pages += [synthetic_page(w, h, cfg, seed=i)[0] for i, (w, h) in enumerate(PAGES[:2])]
    with uncounted(kernels):
        singles = [pipe.generate_ocr(p, keep_logits=True, **gen) for p in pages]
    for name, single in zip(names, singles):
        if single.token_ids != main_results[name].token_ids:
            raise AssertionError(f"page {name}: the single-page reference did not repeat phase 4's tokens")
    saved = os.environ.get("DEEPSEEK_DEVICE_RESIZE")
    os.environ["DEEPSEEK_DEVICE_RESIZE"] = "auto"
    try:
        modes = [pipe.preprocess_host(p)["mode"] for p in pages]
        before = {k: fn.launches for k, fn in kernels.items()}
        engine = ContinuousOCREngine(pipe, slots=4, capacity=2048, chunk_steps=8)  # the (2, 3) prompt: 1124
        t0 = time.perf_counter()
        served = engine.run(pages, **gen)
        dt = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("DEEPSEEK_DEVICE_RESIZE", None)
        else:
            os.environ["DEEPSEEK_DEVICE_RESIZE"] = saved
    delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
    notes = [_first_difference(single, r, lm_dtype) for single, r in zip(singles, served)]
    steps = engine.last_decode_steps
    print(f"[resize] ContinuousOCREngine(slots=4), DEEPSEEK_DEVICE_RESIZE=auto: preprocess modes {modes}, 4 pages "
          f"in {dt:.2f} s, {steps} decode steps; {sum(not n for n in notes)} of 4 pages token-equal to their single "
          f"runs {[n for n in notes if n]}; launches {delta}")
    if modes != ["device", "device", "host", "host"]:
        raise AssertionError(f"DEEPSEEK_DEVICE_RESIZE=auto chose {modes}")
    if steps < 1 or delta["G"] != lm.num_hidden_layers * steps or delta["F"] != 0:
        raise AssertionError(f"device-resize continuous engine: G {delta['G']} / F {delta['F']} launches in {steps} "
                             f"steps, expected {lm.num_hidden_layers} / 0 a step")
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"[resize] launches over phase 4f {launches}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_validate(dev, pipe) -> dict:
    """Phase 4g: the validate-hf harness (runtime/validate.py) in-process on
    the (2, 1) crop page, phase 3's model (LM bf16, vision f32), 32 tokens:
    a transcript against a second one (PASS); the device-resize transcript
    against the host-resize one (PASS); a transcript with the projector's
    weights perturbed (FAIL, at the embedding fingerprints first); then one
    generate_ocr of the page under `device_trace` (`--profile-dir`), whose
    trace must name kernel B's (SAM attention, head dim 64) and C's device
    kernels. It runs after the timed phases (the profiler). Counted: each
    transcript runs two prefills of the 548-token prompt (the decode's and
    step0_top10's), so D and E 22 a transcript."""
    import glob
    import tempfile

    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline
    from deepseek_ocr2_tpu_torch.runtime.validate import collect_transcript, compare_transcripts
    from deepseek_ocr2_tpu_torch.utils.profiling import device_trace

    t_phase = time.perf_counter()
    cfg, lm = pipe.cfg, pipe.cfg.lm
    kernels = counters()
    w, h, grid = CROP_PAGES[0]
    page = synthetic_page(w, h, cfg, seed=10, grid=grid)[0]

    def collect(p):
        return collect_transcript(p, page, prompt=None, max_new_tokens=32, no_crop=False, rotate=0,
                                  auto_rotate=False, ngram_size=20, eos_token_id=None)

    for fn in kernels.values():
        fn.launches = 0
    host = collect(pipe)
    again = collect(pipe)
    dpipe = OCR2Pipeline(pipe.params, cfg, pipe.tokenizer, device=dev, kv_dtype="float32", act_dtype="float32",
                         device_resize=True)
    dev_t = collect(dpipe)
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    proj = pipe.params["projector_w"]
    noisy = proj + 0.5 * torch.randn(proj.shape, generator=g, device=dev, dtype=proj.dtype) * proj.std()
    bad = collect(OCR2Pipeline({**pipe.params, "projector_w": noisy}, cfg, pipe.tokenizer, device=dev,
                               kv_dtype="float32", act_dtype="float32"))
    n_transcripts = 4
    for name, got in (("again", again), ("device resize", dev_t), ("perturbed projector", bad)):
        ok, lines = compare_transcripts(got, host)
        print(f"[validate] {name} against the host-resize transcript: {'PASS' if ok else 'FAIL'} {lines[:3]}")
        if name == "perturbed projector" and (ok or not lines[0].startswith("FAIL inputs_embeds")):
            raise AssertionError(f"the perturbed projector was not caught at the embeddings first: {lines[:3]}")
        if name != "perturbed projector" and not ok:
            raise AssertionError(f"validate: {name} FAILED against the host-resize transcript: {lines}")
    d = {k: fn.launches for k, fn in kernels.items()}
    print(f"[validate] {len(host['generated_ids'])} tokens a transcript, crop grid {host['crop_ratio']}; launches {d}")
    if d["D"] != 2 * lm.num_moe_layers * n_transcripts or d["E"] != 2 * lm.num_moe_layers * n_transcripts:
        raise AssertionError(f"validate: D / E launched {d['D']} / {d['E']}, expected two prefills a transcript")

    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp):
            pipe.generate_ocr(page, max_new_tokens=4, ngram_size=20)
        traces = glob.glob(os.path.join(tmp, "*.pt.trace.json"))
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
    kernels_seen = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    b_names = sorted(n for n in kernels_seen if re.search(r"attn_tc_kernel<[^,]+, 64,", n))
    c_names = sorted(n for n in kernels_seen if "mlp_gemm_kernel" in n)
    print(f"[validate] --profile-dir trace ({len(traces)} file, {len(events)} events, {len(kernels_seen)} device "
          f"kernels by name): B {b_names[:2]}, C {c_names[:2]}")
    if len(traces) != 1 or not b_names or not c_names:
        raise AssertionError("the device_trace trace does not name kernel B's and C's device kernels")
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"[validate] launches over phase 4g {launches}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_decode_profile(pipe) -> None:
    """Device time and launches per decode token on a no-crop page at batch
    1, for the LM in bf16, --int8, --moe-int8 and --int4, and bf16 and
    --int8 again under DEEPSEEK_DECODE_ATTN=stacked (kernel U; K off), in
    this one call. It runs after the timed serving phases: the profiler's
    tracing can slow the launches of what runs after it."""
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import quantize_lm_params

    bf16_lm = pipe.params["lm"]
    page = synthetic_page(*PAGES[0], pipe.cfg, seed=0)[0]
    for tier, scope, bits in (("bf16", None, 8), INT8, MOE_INT8, INT4):
        pipe.params = {**pipe.params, "lm": bf16_lm}  # the last tier's copy freed before the next is made
        torch.cuda.empty_cache()
        pipe.params = {**pipe.params,
                       "lm": quantize_lm_params(bf16_lm, scope=scope, bits=bits) if scope else bf16_lm}
        for mode in ("pool", "stacked") if tier in ("bf16", "--int8") else ("pool",):
            with switched(mode == "stacked"):
                t = decode_per_token(pipe, page)
            print(f"[profile] decode per token, no-crop page, batch 1, LM {tier}"
                  f"{', DEEPSEEK_DECODE_ATTN=stacked' if mode == 'stacked' else ''}: device {t['device_ms']:.3f} "
                  f"ms, {t['launches']:.1f} device launches, wall {t['wall_ms']:.2f} ms (torch.profiler)")
    pipe.params = {**pipe.params, "lm": bf16_lm}
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5


def phase_card_vs_cpu(dev):
    """Phases 5, 5b and 5c: the card against the CPU at full widths and
    reduced depth in f32, with the LM's weights as loaded, then quantized
    with --int8 and with --int4 (on each device; the codes or levels and the
    scales must agree bit for bit). Returns the card's pipelines {"f32",
    "int8", "int4"} for phase 7 and the CPU's f32 weights for phase 7d."""
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import quantize_lm_params
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
    tiers = {"f32": None, "int8": 8, "int4": 4}
    results, pipes, codes = {}, {}, {}
    for device in ("cpu", dev):
        loaded = load_model(cfg, flat, device, lm_dtype="float32", vision_dtype="float32")
        for tier, bits in tiers.items():
            params = loaded
            if bits:
                params = {**loaded, "lm": quantize_lm_params(loaded["lm"], scope="full", bits=bits)}
                lm_q, key = params["lm"], f"q{bits}"
                codes[tier, str(device)] = [lm_q["lm_head"][key].cpu(), lm_q["layers"][1]["wqkv"][key].cpu(),
                                            lm_q["layers"][1]["experts_q8"]["pe_down_scale"].cpu()]
            pipe = OCR2Pipeline(params, cfg, StubTokenizer(cfg.lm.vocab_size), device=device, kv_dtype="float32",
                                act_dtype="float32")
            for name, page in pages.items():
                before = {k: fn.launches for k, fn in kernels.items()}
                t0 = time.perf_counter()
                r = results[tier, name, str(device)] = pipe.generate_ocr(page, max_new_tokens=8, ngram_size=20,
                                                                         keep_logits=True)
                delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
                print(f"[cpu-vs-card] {tier} {name} page on {device}: prompt {r.prompt_len} tokens, "
                      f"{time.perf_counter() - t0:.1f} s, launches {delta}")
                if device != "cpu" and name != "no-crop" and (delta["D"] == 0 or delta["E"] == 0):
                    raise AssertionError(f"{tier} {name} page: the card's MoE did not run D and E")
                need = {"f32": "", "int8": "HIK", "int4": "LMO"}[tier]
                if device != "cpu" and need and min(delta[k] for k in need) == 0:
                    raise AssertionError(f"{tier} {name} page: the card did not run {', '.join(need)}: {delta}")
            if device != "cpu":
                pipes[tier] = pipe
            del params, pipe
        if device == "cpu":
            cpu_params = loaded
        del loaded
    names = ("lm_head codes", "layer 1 wqkv codes", "layer 1 pseudo-expert down scales")
    for tier in ("int8", "int4"):
        diff = {n: int((a != b).sum()) for n, a, b in zip(names, codes[tier, "cpu"], codes[tier, str(dev)])}
        if any(diff.values()):
            raise AssertionError(f"the card's {tier} codes or scales differ from the CPU's: elements differing {diff}")
        print(f"[cpu-vs-card] {tier} codes and scales: card and CPU bit-identical")
    for tier in tiers:
        for name in pages:
            cpu, card = results[tier, name, "cpu"], results[tier, name, str(dev)]
            err = float((cpu.logits0 - card.logits0).abs().max())
            tol = LOGITS_RTOL * float(cpu.logits0.abs().max())
            print(f"[cpu-vs-card] {tier} {name}: step-0 logits max_abs_err {err:.3e} (tol {tol:.3e}, "
                  f"max |logit| {float(cpu.logits0.abs().max()):.3f})")
            if not err <= tol:
                raise AssertionError(f"{tier} {name}: step-0 logits differ by {err}, above {tol}")
            a, b = cpu.token_ids[cpu.prompt_len:], card.token_ids[card.prompt_len:]
            print(f"[cpu-vs-card] {tier} {name}: greedy tokens agree: {a == b} (cpu {a}, card {b})")
            if a != b:
                step = next(i for i in range(min(len(a), len(b))) if a[i] != b[i])
                top2 = torch.topk(cpu.step_logits[step], 2).values
                print(f"[cpu-vs-card] {tier} {name}: first difference at step {step}: cpu top-2 margin "
                      f"{float(top2[0] - top2[1]):.3e}")
    return pipes, cpu_params


# ---------------------------------------------------------------------------


def _post(port: int, path: str, body: bytes, timeout: float = 300.0):
    """POST to the local server; returns (status, parsed body or SSE events)."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 headers={"Content-Type": "image/png"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if r.headers["Content-Type"] == "text/event-stream":
            return r.status, [json.loads(line[6:]) for line in r if line.startswith(b"data: ")]
        return r.status, json.loads(r.read())


def _get(port: int, path: str):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
        return r.status, json.loads(r.read())


def _serve_pages(cfg, n_plain: int, n_crop: int, seed: int) -> list:
    """n_plain no-crop pages of varied sizes, then n_crop (2, 1) crop pages."""
    pages = [synthetic_page(*SERVE_PAGES[i % len(SERVE_PAGES)], cfg, seed=seed + i)[0] for i in range(n_plain)]
    w, h, grid = CROP_PAGES[0]
    return pages + [synthetic_page(w, h, cfg, seed=seed + 100 + i, grid=grid)[0] for i in range(n_crop)]


def phase_serving(dev, pipe) -> dict:
    """Phase 6: the serving path at full width, on phase 3's model."""
    import io

    from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
    from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine
    from deepseek_ocr2_tpu_torch.runtime.http_server import OCRHttpServer

    cfg, lm = pipe.cfg, pipe.cfg.lm
    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0

    def delta_since(before):
        return {k: fn.launches - before[k] for k, fn in kernels.items()}

    def check_results(results, what):
        for r in results:
            if r is None or r.new_tokens < 1 or r.prompt_len < cfg.image_token_count((1, 1)):
                raise AssertionError(f"{what}: a page came back without tokens: {r}")

    # Group engine: 16 no-crop pages in one chunk (B = 16: F in decode), 2 crop pages in another.
    pages = _serve_pages(cfg, 16, 2, seed=200)
    before = {k: fn.launches for k, fn in kernels.items()}
    t0 = time.perf_counter()
    res = OCR2Engine(pipe, batch_size=16).run(pages, max_new_tokens=32, ngram_size=20)
    dt = time.perf_counter() - t0
    check_results(res, "OCR2Engine")
    grids = sorted({r.crop_ratio for r in res})
    n_tok = sum(r.new_tokens for r in res)
    delta = delta_since(before)
    # A chunk's decode loop runs while a row is live, so it takes the
    # longest row's new tokens less one steps (the first comes from prefill).
    steps16 = max(r.new_tokens for r in res[:16]) - 1
    steps_crop = max(r.new_tokens for r in res[16:]) - 1
    print(f"[serve] OCR2Engine(batch_size=16): {len(pages)} pages (grids {grids}) in {dt:.2f} s = "
          f"{len(pages) / dt:.2f} pages/s; 16-page chunk: vision {res[0].prefill_seconds * 1e3:.1f} ms, "
          f"prefill + decode {res[0].decode_seconds * 1e3:.1f} ms for {res[0].new_tokens} tokens a page "
          f"({16 * (res[0].new_tokens - 1) / res[0].decode_seconds:.1f} tok/s over both); {n_tok} tokens; "
          f"decode steps: 16-page chunk {steps16}, 2-page crop chunk {steps_crop}; launches {delta}")
    if grids != [(1, 1), CROP_PAGES[0][2]]:
        raise AssertionError(f"OCR2Engine ran the crop grids {grids}")
    moe_layers = lm.num_moe_layers
    # The 16-page chunk decodes at B·k = 96 > E: F in every MoE layer of every
    # step. The 2-page crop chunk (B·k = 12 <= E) takes the per-selection
    # path, so it adds no F; the contiguous cache's attention is plain torch.
    if steps16 < 1 or steps_crop < 1 or delta["F"] != moe_layers * steps16 or delta["G"] != 0:
        raise AssertionError(f"OCR2Engine: F {delta['F']} / G {delta['G']} launches, expected F "
                             f"{moe_layers} x {steps16} steps of the 16-page chunk only, and no G")
    if min(delta[k] for k in "ABCDE") == 0:
        raise AssertionError(f"the group engine's batched admissions did not run every kernel of A-E: {delta}")

    # Continuous engine, 16 slots, a pool of 56 pages: admission takes 3 (no
    # crop) or 5 (crop) pages a slot, a full page 4 or 6, so slots grow.
    pages = _serve_pages(cfg, 20, 4, seed=300)
    engine = ContinuousOCREngine(pipe, slots=16, capacity=1024, chunk_steps=16, page_size=128,
                                 pool_tokens=56 * 128)
    before = {k: fn.launches for k, fn in kernels.items()}
    t0 = time.perf_counter()
    res = engine.run(pages, max_new_tokens=128, ngram_size=20)
    dt = time.perf_counter() - t0
    check_results(res, "ContinuousOCREngine")
    delta = delta_since(before)
    steps = engine.last_decode_steps
    decoded = sum(r.new_tokens - 1 for r in res)  # the first token of a page comes from its admission
    admit_ms = sorted({round(r.prefill_seconds * 1e3, 1) for r in res})
    print(f"[serve] ContinuousOCREngine(slots=16, page 128, pool 56 pages): {len(pages)} pages in {dt:.2f} s = "
          f"{len(pages) / dt:.2f} pages/s; {steps} decode steps in {engine.last_decode_seconds:.2f} s, "
          f"{decoded} tokens = {decoded / engine.last_decode_seconds:.1f} tok/s in total, "
          f"{decoded / engine.last_decode_seconds / 16:.1f} per slot; admissions (vision + prefill) "
          f"{admit_ms} ms; preempted {engine.last_preempted}; launches {delta}")
    if delta["F"] != moe_layers * steps or delta["G"] != lm.num_hidden_layers * steps:
        raise AssertionError(f"continuous decode: F {delta['F']} / G {delta['G']} launches in {steps} steps, "
                             f"expected {moe_layers} / {lm.num_hidden_layers} a step")
    if min(delta[k] for k in "ABCDE") == 0:
        raise AssertionError(f"the batched admissions did not run every kernel of A-E: {delta}")
    if engine.alloc.n_free != 56:
        raise AssertionError("the engine did not return every page to the pool")

    # The online engine behind the HTTP server: 4 concurrent POSTs and an SSE stream.
    from PIL import Image  # the request bodies are PNG bytes

    def png(page: Image.Image) -> bytes:
        buf = io.BytesIO()
        page.save(buf, format="PNG")
        return buf.getvalue()

    online = ContinuousOCREngine(pipe, slots=16, capacity=1024, chunk_steps=8)
    before = {k: fn.launches for k, fn in kernels.items()}
    online.start(ngram_size=20)
    server = OCRHttpServer(online, port=0).start_background()
    try:
        bodies = [png(p) for p in _serve_pages(cfg, 3, 1, seed=400)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(lambda body: _post(server.port, "/v1/ocr?max_new_tokens=16", body), bodies))
        t_post = time.perf_counter() - t0
        code, events = _post(server.port, "/v1/ocr?max_new_tokens=16&stream=1", bodies[0])
        health, stats = _get(server.port, "/healthz"), _get(server.port, "/v1/stats")
    finally:
        server.shutdown()
        online.stop(timeout=120)
    final = events[-1] if events else {}
    print(f"[serve] HTTP: 4 concurrent POSTs {[c for c, _ in outs]} in {t_post:.2f} s, new_tokens "
          f"{[o['new_tokens'] for _, o in outs]}; SSE {code}, {len(events)} events, new_tokens "
          f"{final.get('new_tokens')}; /healthz {health[0]}, /v1/stats {stats[0]} {stats[1]}")
    if any(c != 200 or o["new_tokens"] < 1 for c, o in outs) or code != 200 or not final.get("done") \
            or final.get("new_tokens", 0) < 1 or health[0] != 200 or stats[0] != 200 or stats[1]["requests"] < 5:
        raise AssertionError("the HTTP front end did not answer every request")
    delta, steps = delta_since(before), online.last_decode_steps
    print(f"[serve] HTTP: {steps} decode steps; launches {delta}")
    if steps < 1 or delta["F"] != moe_layers * steps or delta["G"] != lm.num_hidden_layers * steps:
        raise AssertionError(f"online engine: F {delta['F']} / G {delta['G']} launches in {steps} steps, "
                             f"expected {moe_layers} / {lm.num_hidden_layers} a step")
    # The main path's counts end here: the group, continuous and HTTP runs.
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"[serve] launches over the serving phase {launches}")
    _decode_chunk_sync_check(dev, pipe, kernels)
    return launches


def phase_serving_quant(dev, pipe) -> dict:
    """Phases 6b (--int8) and 6c (--int4): serving at full width on phase
    3's LM quantized on the card (scope "full"), one tier at a time: the
    group engine with one 16-page chunk and the continuous engine with 16
    slots, on the same 16 no-crop pages at 64 new tokens, beside the same
    runs on the bf16 LM. Each run's decode launches are held to
    `quant_launches_per_step` (group: K / O 12, J / N 11, H / L 3 a step,
    and H / L once after the chunk's prefill; continuous: J / N 11, G 12,
    H / L 27 a step, and H / L once an admission group). Returns the
    launches and the bf16 group engine's results (phase 4e's reference)."""
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import quantize_lm_params
    from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
    from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine

    cfg, lm = pipe.cfg, pipe.cfg.lm
    kernels = counters()
    bf16_lm = pipe.params["lm"]
    pages = _serve_pages(cfg, 16, 0, seed=600)
    # The same workload on the bf16 LM first, for the side-by-side rates.
    bf16_runs = {}
    for name, make in (("OCR2Engine(batch_size=16)", lambda: OCR2Engine(pipe, batch_size=16)),
                       ("ContinuousOCREngine(slots=16)",
                        lambda: ContinuousOCREngine(pipe, slots=16, capacity=1024, chunk_steps=16, page_size=128))):
        t0 = time.perf_counter()
        res = bf16_runs[name] = make().run(pages, max_new_tokens=64, ngram_size=20)
        dt = time.perf_counter() - t0
        print(f"[serve-quant] {name}, bf16 LM, the same 16 pages: {dt:.2f} s = {len(pages) / dt:.2f} pages/s, "
              f"{sum(r.new_tokens for r in res)} tokens")
    for fn in kernels.values():
        fn.launches = 0
    for flag, scope, bits in (INT8, INT4):
        pipe.params = {**pipe.params, "lm": quantize_lm_params(bf16_lm, scope=scope, bits=bits)}
        lin = "H" if bits == 8 else "L"
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        res = OCR2Engine(pipe, batch_size=16).run(pages, max_new_tokens=64, ngram_size=20)
        dt = time.perf_counter() - t0
        delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
        steps = max(r.new_tokens for r in res) - 1
        want = {k: n * steps for k, n in quant_launches_per_step(lm, scope, bits, rows=16, paged=False).items()}
        want[lin] += 1
        n_tok = sum(r.new_tokens for r in res)
        print(f"[serve-quant] OCR2Engine(batch_size=16), {flag}: {len(pages)} pages in {dt:.2f} s = "
              f"{len(pages) / dt:.2f} pages/s; vision {res[0].prefill_seconds * 1e3:.1f} ms, prefill + {steps} "
              f"decode steps {res[0].decode_seconds * 1e3:.1f} ms ({16 * steps / res[0].decode_seconds:.1f} tok/s); "
              f"{n_tok} tokens; launches {delta}")
        bad = {k: (delta[k], n) for k, n in want.items() if delta[k] != n}
        if bad or steps < 1 or any(r.new_tokens < 1 for r in res):
            raise AssertionError(f"{flag} group engine: launches (got, derived) {bad}")

        engine = ContinuousOCREngine(pipe, slots=16, capacity=1024, chunk_steps=16, page_size=128)
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        res = engine.run(pages, max_new_tokens=64, ngram_size=20)
        dt = time.perf_counter() - t0
        delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
        steps = engine.last_decode_steps
        decoded = sum(r.new_tokens - 1 for r in res)
        want = {k: n * steps for k, n in quant_launches_per_step(lm, scope, bits, rows=16, paged=True).items()}
        want[lin] += engine.last_admissions
        print(f"[serve-quant] ContinuousOCREngine(slots=16), {flag}: {len(pages)} pages in {dt:.2f} s = "
              f"{len(pages) / dt:.2f} pages/s; {steps} decode steps in {engine.last_decode_seconds:.2f} s, "
              f"{decoded} tokens = {decoded / engine.last_decode_seconds:.1f} tok/s in total; "
              f"{engine.last_admissions} admission groups; launches {delta}")
        bad = {k: (delta[k], n) for k, n in want.items() if delta[k] != n}
        if bad or steps < 1 or any(r is None or r.new_tokens < 1 for r in res):
            raise AssertionError(f"{flag} continuous engine: launches (got, derived) {bad}")
        pipe.params = {**pipe.params, "lm": bf16_lm}  # one quantized copy on the card at a time
        del engine, res
        torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"[serve-quant] launches over phases 6b and 6c {launches}")
    return launches, bf16_runs["OCR2Engine(batch_size=16)"]


def _decode_chunk_sync_check(dev, pipe, kernels, kv_dtype=None, sampling=None) -> None:
    """One decode_chunk with the host-sync check on: 16 rows at ragged
    lengths over a synthetic pool (the K/V contents do not matter here), of
    the pipeline's kv_dtype or `kv_dtype`, greedy or with `sampling`. It
    runs after its phase has read its counts, so it adds nothing to them."""
    from deepseek_ocr2_tpu_torch.runtime.continuous import DecodeState, decode_chunk
    from deepseek_ocr2_tpu_torch.runtime.paged_kv import make_paged_kv_cache

    cfg, lm = pipe.cfg, pipe.cfg.lm
    moe_layers = lm.num_moe_layers
    kv_dtype = kv_dtype or pipe.kv_dtype
    attention = "P" if isinstance(kv_dtype, str) else "G"
    pool = make_paged_kv_cache(lm.num_hidden_layers, 16 * 4 + 1, lm.num_attention_heads, 128, lm.head_dim,
                               dtype=kv_dtype, device=dev, slots=16)
    state = DecodeState.empty(16, 512, dev)
    state.tokens.random_(2, lm.vocab_size)
    state.cur_lens.copy_(torch.arange(120, 136, dtype=torch.int32, device=dev))  # across a page end
    state.done.zero_()
    state.limits.fill_(200)
    state.seeds.copy_(torch.arange(16, device=dev))
    tables = torch.arange(1, 65, dtype=torch.int32, device=dev).reshape(16, 4)
    chunk = dict(n_steps=2, ngram_size=20, eos_id=cfg.eos_token_id, rope=pipe.rope, **(sampling or {}))
    lm_params = pipe.params["lm"]
    decode_chunk(lm_params, lm, pool, state, tables, **chunk)  # warm-up
    torch.cuda.synchronize(dev)
    before = {k: fn.launches for k, fn in kernels.items()}
    what = f"decode_chunk(2 steps, 16 rows, {kv_dtype} pool{', sampled' if sampling else ''})"
    status = no_host_sync(dev, what, lambda: decode_chunk(lm_params, lm, pool, state, tables, **chunk))
    lens = status[:16].cpu()
    d = {k: fn.launches - before[k] for k, fn in kernels.items()}
    print(f"[serve] {what}: lengths {lens[0].item()}..{lens[-1].item()}, launches F {d['F']} "
          f"{attention} {d[attention]}")
    if d["F"] != 2 * moe_layers or d[attention] != 2 * lm.num_hidden_layers or not torch.equal(
            lens, torch.arange(124, 140, dtype=torch.int32)):
        raise AssertionError(f"decode_chunk: launches {d}, lengths {lens.tolist()}")
    del pool, state


def _pool_bytes(lm, num_pages: int, slots: int, kv_dtype) -> int:
    """The bytes of a paged pool, from its tensors' shapes (built on the meta
    device: nothing is allocated)."""
    from deepseek_ocr2_tpu_torch.runtime.paged_kv import make_paged_kv_cache

    pool = make_paged_kv_cache(lm.num_hidden_layers, num_pages, lm.num_attention_heads, 128, lm.head_dim,
                               dtype=kv_dtype, device="meta", slots=slots)
    return nbytes(*pool.values())


def phase_serving_kv(dev, pipe) -> dict:
    """Phase 6d: the continuous engine at 16 slots on phase 6b's 16 no-crop
    pages at 64 new tokens, on phase 3's bf16 LM with a bf16 pool, an int8
    pool and an int8tail pool, then with --int8 weights on an int8tail
    pool: pages/s, decode tok/s and the pool's bytes. Decode launches are
    held to G 12 a step on the bf16 pool and P 12, G 0 on the quantized
    ones (with the bf16 LM, F 11; with --int8, `quant_launches_per_step`).
    Then one sampled decode_chunk on an int8tail pool in sync-debug mode.
    Returns the launches of the four runs."""
    from deepseek_ocr2_tpu_torch.models.deepseek_v2 import quantize_lm_params
    from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    cfg, lm = pipe.cfg, pipe.cfg.lm
    kernels = counters()
    pages = _serve_pages(cfg, 16, 0, seed=600)
    bf16_lm = pipe.params["lm"]
    for fn in kernels.values():
        fn.launches = 0
    for tier, kv in (("bf16", "bfloat16"), ("bf16", "int8"), ("bf16", "int8tail"), ("--int8", "int8tail")):
        lm_params = bf16_lm if tier == "bf16" else quantize_lm_params(bf16_lm, scope="full", bits=8)
        kpipe = OCR2Pipeline({**pipe.params, "lm": lm_params}, cfg, pipe.tokenizer, device=dev, kv_dtype=kv,
                             act_dtype="float32")
        engine = ContinuousOCREngine(kpipe, slots=16, capacity=1024, chunk_steps=16, page_size=128)
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        res = engine.run(pages, max_new_tokens=64, ngram_size=20)
        dt = time.perf_counter() - t0
        delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
        steps = engine.last_decode_steps
        decoded = sum(r.new_tokens - 1 for r in res)
        attention = "G" if kv == "bfloat16" else "P"
        if tier == "bf16":
            want = dict.fromkeys("FGHIJKLMNOPQRSTUVWX", 0)
            want.update({"F": lm.num_moe_layers * steps, attention: lm.num_hidden_layers * steps})
        else:
            want = {k: n * steps for k, n in quant_launches_per_step(lm, "full", 8, rows=16, paged=True,
                                                                     q8_pool=attention == "P").items()}
            want["H"] += engine.last_admissions
        pool_mb = _pool_bytes(lm, engine.num_pages, 16, kv if kv != "bfloat16" else torch.bfloat16) / 2**20
        print(f"[serve-kv] ContinuousOCREngine(slots=16), {tier} LM, {kv} pool ({pool_mb:.1f} MiB for "
              f"{engine.num_pages} pages): {len(pages)} pages in {dt:.2f} s = {len(pages) / dt:.2f} pages/s; "
              f"{steps} decode steps in {engine.last_decode_seconds:.2f} s, {decoded} tokens = "
              f"{decoded / engine.last_decode_seconds:.1f} tok/s in total; launches {delta}")
        bad = {k: (delta[k], n) for k, n in want.items() if delta[k] != n}
        if bad or steps < 1 or any(r is None or r.new_tokens < 1 for r in res):
            raise AssertionError(f"{tier} LM on the {kv} pool: launches (got, derived) {bad}")
        del engine, res, kpipe, lm_params
        torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"[serve-kv] launches over phase 6d {launches}")
    _decode_chunk_sync_check(dev, pipe, kernels, kv_dtype="int8tail",
                             sampling=dict(temperature=0.7, top_k=50, top_p=0.9))
    return launches


CYCLE = 24  # the period of `cycle_lm`, over the ids 2 .. 25 (clear of BOS 0 and EOS 1)


def cycle_lm(lm_params, lm) -> dict:
    """A full-width LM that emits a cycle (the JAX package's
    tests/test_lookup_decode.py LM): attention, MLPs, experts and routers
    zero, so each position's hidden state is its own embedding; id 2 + i
    (i < CYCLE) embeds as the unit vector e_i and lm_head maps e_i to id 2 +
    (i + 1) mod CYCLE. Every other id embeds as e_(CYCLE - 1), so the prompt
    leads into the cycle at id 2. The norms keep phase 3's weights."""
    emb = lm_params["embed"]
    embed = torch.zeros(lm.vocab_size, lm.hidden_size, dtype=emb.dtype, device=emb.device)
    head = torch.zeros_like(embed)
    i = torch.arange(CYCLE, device=emb.device)
    embed[:, CYCLE - 1] = 1.0
    embed[2 + i] = 0.0
    embed[2 + i, i] = 1.0
    head[2 + (i + 1) % CYCLE, i] = 1.0
    layers = [{k: v if k in ("ln1", "ln2") else
               ({n: torch.zeros_like(w) for n, w in v.items()} if isinstance(v, dict) else torch.zeros_like(v))
               for k, v in layer.items()} for layer in lm_params["layers"]]
    return {"embed": embed, "layers": layers, "norm": lm_params["norm"], "lm_head": head}


def phase_serving_lookup(dev, pipe) -> dict:
    """Phase 6e: the continuous engine with lookup_chunk 4 at 16 slots on
    6d's 16 no-crop pages at 64 new tokens (chunk_steps 16: 4 chunk
    forwards a dispatch), on phase 3's bf16 LM with a bf16 pool and an
    int8tail pool, then on `cycle_lm` (bf16 pool, 128 new tokens, no n-gram
    ban), where the drafts accept. Each chunk forward launches Q (bf16 pool)
    or R (int8tail) once a layer and F once a MoE layer (64 rows x 6 > 64
    experts), and G, P none. Returns the launches."""
    from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    cfg, lm = pipe.cfg, pipe.cfg.lm
    kernels = counters()
    pages = _serve_pages(cfg, 16, 0, seed=600)
    for fn in kernels.values():
        fn.launches = 0
    runs = (("bf16", "bfloat16", 64, 20), ("bf16", "int8tail", 64, 20), ("cycle", "bfloat16", 128, 0))
    for tier, kv, max_new, ngram in runs:
        lm_params = pipe.params["lm"] if tier == "bf16" else cycle_lm(pipe.params["lm"], lm)
        kpipe = OCR2Pipeline({**pipe.params, "lm": lm_params}, cfg, pipe.tokenizer, device=dev, kv_dtype=kv,
                             act_dtype="float32")
        engine = ContinuousOCREngine(kpipe, slots=16, capacity=1024, chunk_steps=16, page_size=128, lookup_chunk=4)
        # The cycle's 16 pages admit as one group (prestaged), so their rows
        # run in step and a forward's count is each slot's.
        reqs = engine.prestage(pages, max_new_tokens=max_new) if tier == "cycle" else None
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        res = engine.run_requests(reqs, ngram_size=ngram) if reqs else \
            engine.run(pages, max_new_tokens=max_new, ngram_size=ngram)
        dt = time.perf_counter() - t0
        delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
        steps, fw = engine.last_decode_steps, engine.last_lookup_forwards
        decoded = sum(r.new_tokens - 1 for r in res)  # the first token of a page comes from its admission
        attention = "Q" if kv == "bfloat16" else "R"
        want = dict.fromkeys("FGHIJKLMNOPQRSTUVWX", 0)
        want.update({"F": lm.num_moe_layers * steps, attention: lm.num_hidden_layers * steps})
        print(f"[serve-lookup] ContinuousOCREngine(slots=16, lookup_chunk=4), {tier} LM, {kv} pool: "
              f"{len(pages)} pages in {dt:.2f} s = {len(pages) / dt:.2f} pages/s; {steps} chunk forwards "
              f"({fw} with an active slot) in {engine.last_decode_seconds:.2f} s, {decoded} tokens = "
              f"{decoded / engine.last_decode_seconds:.1f} tok/s in total, {decoded / 16 / max(fw, 1):.2f} "
              f"tokens a slot a forward; lookup_forwards {fw}; launches {delta}")
        bad = {k: (delta[k], n) for k, n in want.items() if delta[k] != n}
        if bad or fw < 1 or any(r is None or r.new_tokens < 1 for r in res):
            raise AssertionError(f"lookup engine, {tier} LM on the {kv} pool: launches (got, derived) {bad}")
        if tier == "cycle":
            first = res[0].token_ids[res[0].prompt_len:]
            cyc = all(2 <= a < 2 + CYCLE and b == 2 + (a - 1) % CYCLE for a, b in zip(first, first[1:]))
            print(f"[serve-lookup]   cycle LM: {res[0].new_tokens} tokens a page in {fw} forwards, a cycle of "
                  f"{CYCLE}: {cyc}; tokens {first[:30]}...")
            if not cyc or any(r.token_ids[r.prompt_len:] != first for r in res) or not fw < res[0].new_tokens / 2:
                raise AssertionError(f"cycle LM: {fw} forwards for {res[0].new_tokens} tokens a page, cycle {cyc}")
        del engine, res, kpipe, lm_params
        torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in kernels.items()}
    print(f"[serve-lookup] launches over phase 6e {launches}")
    return launches


def _first_difference(single, served, lm_dtype: torch.dtype = torch.float32) -> str:
    """'' when the tokens agree; otherwise a note on the first difference,
    or an AssertionError when the single run's choice there was not close:
    the top-2 margin among the tokens greedy could pick, those the 20-gram
    ban (every phase decodes with ngram_size 20) leaves at that step, as
    `_sampled_margin` masks them; a banned top-1 is no candidate. The bound
    is LOGITS_RTOL of the largest logit for an f32 LM; for a bf16 LM (phase
    4e) `bf16_tol`, 4 bf16 ulps of the largest logit: its hidden states
    are rounded to bf16 in every layer, so two sums taken in another order
    move the logits by ulps of that size, and one-ulp ties are common."""
    from deepseek_ocr2_tpu_torch.ops.sampling import ngram_ban_mask_batched

    a, b = single.token_ids[single.prompt_len:], served.token_ids[served.prompt_len:]
    if a == b:
        return ""
    step = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]), min(len(a), len(b)))
    logits = single.step_logits[min(step, len(single.step_logits) - 1)].float()
    n = single.prompt_len + step
    ban = ngram_ban_mask_batched(torch.tensor([single.token_ids[:n]]), torch.tensor([n]), 20, logits.shape[-1])[0]
    top2 = torch.topk(logits.masked_fill(ban, float("-inf")), 2).values
    margin = float(top2[0] - top2[1])
    tol = LOGITS_RTOL * float(logits.abs().max()) if lm_dtype == torch.float32 else bf16_tol(logits)
    picks = f"{a[step] if step < len(a) else 'end'} / {b[step] if step < len(b) else 'end'}"
    note = (f"first difference at step {step} ({picks}{', the top-1 banned' if ban[logits.argmax()] else ''}): "
            f"single-page top-2 margin {margin:.3e} (bound {tol:.3e})")
    if not margin < tol:
        raise AssertionError(f"served tokens differ from the single page's, {note}")
    return note


def phase_serving_exact(dev, pipe, tier: str = "f32") -> None:
    """Phase 7 (7b with int8 weights, 7c with int4): both engines
    token-exact against single-page generate_ocr, on phase 5's
    reduced-depth f32 model on the card."""
    from deepseek_ocr2_tpu_torch.runtime.continuous import ContinuousOCREngine
    from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine

    kernels = counters()
    # With quantized weights the shared MLP is folded into the expert kernels
    # as pseudo-experts at one row and above E / k rows, but runs as its own
    # stream in between (a 2-page crop chunk of the group engine), as in the
    # JAX package. With int8 its down scales are per channel over the whole
    # stream, not per half: not comparable with single pages, so 7b serves
    # 16 no-crop pages (one 16-row chunk, 16 slots). With int4 at I = 896 (a
    # multiple of 128) the pseudo-experts' levels and scales are the fused
    # stream's, so 7c serves phase 7's pages, the 2-page crop chunk (M
    # without the pseudo-experts, L for the shared MLP) included.
    pages = _serve_pages(pipe.cfg, 14, 2, seed=500) if tier != "int8" else _serve_pages(pipe.cfg, 16, 0, seed=700)
    gen = dict(max_new_tokens=16, ngram_size=20)
    singles = [pipe.generate_ocr(p, keep_logits=True, **gen) for p in pages]
    before = {k: fn.launches for k, fn in kernels.items()}
    served = {
        "OCR2Engine(batch_size=16)": OCR2Engine(pipe, batch_size=16).run(pages, **gen),
        "ContinuousOCREngine(slots=16)": ContinuousOCREngine(pipe, slots=16, capacity=1024, chunk_steps=8).run(
            pages, **gen),
    }
    d = {k: fn.launches - before[k] for k, fn in kernels.items()}
    for name, results in served.items():
        notes = [(i, _first_difference(s, r)) for i, (s, r) in enumerate(zip(singles, results))]
        exact = sum(1 for _, n in notes if not n)
        print(f"[serve-exact] {tier} {name}: {exact} of {len(pages)} pages token-exact against generate_ocr")
        for i, n in notes:
            if n:
                print(f"[serve-exact]   page {i}: {n}")
    print(f"[serve-exact] {tier} launches {d}")
    need = {"f32": "FG", "int8": "GHJK", "int4": "GLMNO"}[tier]
    if min(d[k] for k in need) == 0:
        raise AssertionError(f"the reduced-depth {tier} serving run did not reach {', '.join(need)}: {d}")


def _sampled_margin(r, step: int, sampling: dict) -> tuple:
    """(top-2 margin, bound) of the sampled choice at `step` of a CPU
    generate_ocr run with keep_logits: the candidates' logits / T (NaN and
    n-gram-banned ones -inf, the top-k, the nucleus) plus the Gumbel noise
    of that step's key, as `greedy_generate` and `sample_pick` draw it; the
    bound is LOGITS_RTOL of the largest |logit / T|."""
    from deepseek_ocr2_tpu_torch.ops import prng
    from deepseek_ocr2_tpu_torch.ops.sampling import ngram_ban_mask_batched

    logits = r.step_logits[step].float()[None]
    n = r.prompt_len + step
    ban = ngram_ban_mask_batched(torch.tensor([r.token_ids[:n]]), torch.tensor([n]), 20, logits.shape[-1])
    l32 = logits.masked_fill(torch.isnan(logits) | ban, float("-inf")) / sampling["temperature"]
    vals = torch.sort(l32, dim=-1, descending=True, stable=True).values[:, : sampling["top_k"]]
    e = torch.exp(vals - vals.max())
    probs = e / e.sum()
    vals = vals.masked_fill((torch.cumsum(probs, -1) - probs) >= sampling["top_p"], float("-inf"))
    key = prng.prng_key(sampling["seed"])
    for _ in range(step + 1):  # one split before the first pick and one a step
        key, sub = prng.split(key)
    scores = (vals + prng.gumbel(prng.split(sub, 1), (vals.shape[-1],)))[0]
    top2 = torch.topk(scores[torch.isfinite(scores)], 2).values
    finite = l32[torch.isfinite(l32)]
    return float(top2[0] - top2[1]), LOGITS_RTOL * float(finite.abs().max())


def phase_kv_card_vs_cpu(dev, card_params, cpu_params) -> None:
    """Phase 7d: phase 5's reduced-depth f32 model, card against CPU, with
    the quantized pools. For int8 and int8tail: two no-crop pages admitted
    as one group into a fresh pool on each device; the card's pool must
    equal, bit for bit, the CPU's quantization of the card's own prefill
    K/V (quantize_kv, the page scatter, the open-page staging), and the
    card's and the CPU's pools agree within the bounds printed (codes one
    apart at most, where the two devices' K/V straddle a rounding point).
    Then the continuous engine on both devices over the same pages at 16
    new tokens, tokens under phase 7's margin rule on the CPU engine's
    logits. Last, sampled generate_ocr (temperature 0.7, top-k 50, top-p
    0.9, seed 3) on both devices under the same rule on logits / T + noise,
    and at temperature 0 on the card, which must be greedy's tokens."""
    from types import SimpleNamespace

    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.runtime import continuous as cont
    from deepseek_ocr2_tpu_torch.runtime.engine import batched_vision_prefill
    from deepseek_ocr2_tpu_torch.runtime.paged_kv import make_paged_kv_cache, pages_for, write_prompt_pool_batched
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline
    from deepseek_ocr2_tpu_torch.utils.tokenizer import tokenize_with_image

    base = OCR2Config()
    cfg = dataclasses.replace(
        base,
        lm=dataclasses.replace(base.lm, num_hidden_layers=2),
        qwen2=dataclasses.replace(base.qwen2, num_hidden_layers=2),
        sam=dataclasses.replace(base.sam, depth=3, global_attn_indexes=(2,)),
    )
    lm, page = cfg.lm, 128
    tok = StubTokenizer(lm.vocab_size)
    pages = [synthetic_page(*PAGES[i], cfg, seed=90 + i)[0] for i in range(2)]
    roles = {"cpu": (torch.device("cpu"), cpu_params), "card": (dev, card_params)}
    kernels = counters()
    for kv in ("int8", "int8tail"):
        pipes = {role: OCR2Pipeline(p, cfg, tok, device=d, kv_dtype=kv, act_dtype="float32")
                 for role, (d, p) in roles.items()}
        pools, prefill = {}, {}
        for role, kp in pipes.items():
            d = kp.device
            bases = torch.cat([kp.preprocess_finish(p if isinstance(p, dict) else kp.preprocess_host(p))[0]
                               for p in pages])
            ids, _, start = tokenize_with_image(tok, cfg.default_ocr_prompt, cfg, (1, 1))
            ids_t, embeds = batched_vision_prefill(kp, ids, bases, None, start)
            n_prompt = pages_for(len(ids), page)
            k_new, v_new, _ = cont.admit_prefill(kp.params["lm"], lm, embeds, ids_t, capacity=n_prompt * page,
                                                 kv_dtype=torch.float32, ngram_size=20, rope=kp.rope)
            pool = make_paged_kv_cache(lm.num_hidden_layers, 2 * n_prompt + 1, lm.num_attention_heads, page,
                                       lm.head_dim, dtype=kv, device=d, slots=2)
            page_ids = torch.arange(1, 2 * n_prompt + 1, dtype=torch.int32, device=d).reshape(2, n_prompt)
            write_prompt_pool_batched(pool, k_new, v_new, page_ids, len(ids), slot_ids=torch.arange(2, device=d))
            pools[role] = {name: t.cpu() for name, t in pool.items()}
            prefill[role] = (k_new.cpu(), v_new.cpu(), page_ids.cpu(), len(ids))
        card, cpu = pools["card"], pools["cpu"]
        k_new, v_new, page_ids, n = prefill["card"]
        again = make_paged_kv_cache(lm.num_hidden_layers, page_ids.numel() + 1, lm.num_attention_heads, page,
                                    lm.head_dim, dtype=kv, slots=2)
        write_prompt_pool_batched(again, k_new, v_new, page_ids, n, slot_ids=torch.arange(2))
        same = {name: int((card[name].view(torch.uint8) != again[name].view(torch.uint8)).sum()) for name in card}
        if any(same.values()):
            raise AssertionError(f"{kv}: the card's pool differs from the CPU's quantization of the card's K/V: {same}")
        # Card vs CPU: the prefill K/V within LOGITS_RTOL of their largest
        # value (f32 sums in another order); a code may then differ by one
        # where the two devices' K/V straddle a rounding point, the scales
        # by the K/V's own relative difference, an open page by a bf16 ulp
        # (2^-7 of the largest value at most).
        kv_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(prefill["card"][:2], prefill["cpu"]))
        code_diff = max(int((card[name].int() - cpu[name].int()).abs().max()) for name in ("k", "v"))
        flips = sum(int((card[name] != cpu[name]).sum()) for name in ("k", "v"))
        rel = {name: float((card[name].float() - cpu[name].float()).abs().max() / cpu[name].float().abs().max())
               for name in card if name not in ("k", "v")}  # relative to the plane's largest value
        print(f"[kv-card-vs-cpu] {kv} pool after one admission: the card's pool bit-identical to the CPU's "
              f"quantization of the card's K/V; card vs CPU: prefill K/V max relative error {kv_err:.2e}, "
              f"{flips} of {2 * card['k'].numel()} codes differ, by at most {code_diff}; max relative "
              f"difference {rel}")
        if kv_err > LOGITS_RTOL or code_diff > 1 or max(v for n, v in rel.items() if n.endswith("scale")) > \
                LOGITS_RTOL or max((v for n, v in rel.items() if n.startswith("open")), default=0.0) > 2.0**-7:
            raise AssertionError(f"{kv}: card and CPU pools apart beyond the bounds")

        logits, orig = [], cont.logits_last
        served = {}
        for role, kp in pipes.items():
            engine = cont.ContinuousOCREngine(kp, slots=2, capacity=512, chunk_steps=8, page_size=page)
            reqs = engine.prestage(pages, max_new_tokens=16)  # both pages ready: one admission group
            before = {k: fn.launches for k, fn in kernels.items()}
            if role == "cpu":
                cont.logits_last = lambda params, hidden: logits.append(orig(params, hidden).float()) or logits[-1]
            try:
                served[role] = engine.run_requests(reqs, ngram_size=20)
            finally:
                cont.logits_last = orig
            delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
            if role == "card" and (delta["P"] != lm.num_hidden_layers * engine.last_decode_steps or delta["G"]):
                raise AssertionError(f"{kv} engine on the card: P {delta['P']}, G {delta['G']} launches")
        for i in range(2):
            single = SimpleNamespace(token_ids=served["cpu"][i].token_ids, prompt_len=served["cpu"][i].prompt_len,
                                     step_logits=[lg[i] for lg in logits])
            note = _first_difference(single, served["card"][i])
            print(f"[kv-card-vs-cpu] {kv} continuous engine page {i}: card "
                  f"{'= CPU' if not note else note} ({served['card'][i].new_tokens} tokens)")

    samp = dict(temperature=0.7, top_k=50, top_p=0.9, seed=3)
    f32 = {role: OCR2Pipeline(p, cfg, tok, device=d, kv_dtype="float32", act_dtype="float32")
           for role, (d, p) in roles.items()}
    gen = dict(max_new_tokens=16, ngram_size=20)
    cpu_r = f32["cpu"].generate_ocr(pages[0], keep_logits=True, sampling=samp, **gen)
    card_r = f32["card"].generate_ocr(pages[0], sampling=samp, **gen)
    a, b = cpu_r.token_ids[cpu_r.prompt_len:], card_r.token_ids[card_r.prompt_len:]
    note = "card = CPU"
    if a != b:
        step = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]), min(len(a), len(b)))
        margin, bound = _sampled_margin(cpu_r, min(step, len(cpu_r.step_logits) - 1), samp)
        note = f"first difference at step {step}: CPU margin of logits / T + noise {margin:.3e} (bound {bound:.3e})"
        if not margin < bound:
            raise AssertionError(f"sampled generate_ocr: card and CPU tokens differ, {note}")
    greedy = f32["card"].generate_ocr(pages[0], **gen)
    zero = f32["card"].generate_ocr(pages[0], sampling={**samp, "temperature": 0.0}, **gen)
    print(f"[kv-card-vs-cpu] sampled generate_ocr {samp}: {note} ({len(b)} tokens: {b}); temperature 0 = greedy: "
          f"{zero.token_ids == greedy.token_ids}")
    if zero.token_ids != greedy.token_ids:
        raise AssertionError("generate_ocr at temperature 0 is not greedy")


def phase_lookup_exact(dev, pipe, cpu_params) -> None:
    """Phase 7e: lookup decoding (lookup_chunk 4) on phase 5's reduced-depth
    f32 model on the card, under phase 7's margin rule: generate_ocr with
    lookup against plain greedy single pages; the group engine and the
    continuous engine (4 slots, one admission group) with lookup against
    them on the f32 cache and pool; on an int8tail pool, the continuous
    engine with lookup against the plain one (the margin from the plain
    engine's own logits); and the card's lookup tokens of page 0 against
    the CPU's."""
    from types import SimpleNamespace

    from deepseek_ocr2_tpu_torch.runtime import continuous as cont
    from deepseek_ocr2_tpu_torch.runtime.engine import OCR2Engine
    from deepseek_ocr2_tpu_torch.runtime.pipeline import OCR2Pipeline

    cfg = pipe.cfg
    kernels = counters()
    pages = _serve_pages(cfg, 4, 0, seed=800)
    gen = dict(max_new_tokens=32, ngram_size=20)
    singles = [pipe.generate_ocr(p, keep_logits=True, **gen) for p in pages]
    before = {k: fn.launches for k, fn in kernels.items()}
    pipe.lookup_chunk = 4
    try:
        served = {
            "generate_ocr": [pipe.generate_ocr(p, **gen) for p in pages],
            "OCR2Engine(batch_size=4)": OCR2Engine(pipe, batch_size=4).run(pages, **gen),
        }
    finally:
        pipe.lookup_chunk = 0
    engine = cont.ContinuousOCREngine(pipe, slots=4, capacity=512, chunk_steps=8, lookup_chunk=4)
    served["ContinuousOCREngine(slots=4), f32 pool"] = engine.run_requests(
        engine.prestage(pages, max_new_tokens=gen["max_new_tokens"]), ngram_size=20)
    for name, results in served.items():
        notes = [(i, _first_difference(s, r)) for i, (s, r) in enumerate(zip(singles, results))]
        print(f"[lookup-exact] {name} with lookup: {sum(1 for _, n in notes if not n)} of {len(pages)} pages "
              f"token-exact against plain greedy generate_ocr")
        for i, n in notes:
            if n:
                print(f"[lookup-exact]   page {i}: {n}")

    tpipe = OCR2Pipeline(pipe.params, cfg, pipe.tokenizer, device=dev, kv_dtype="int8tail", act_dtype="float32")
    logits, orig = [], cont.logits_last
    tail = {}
    for chunk in (0, 4):
        engine = cont.ContinuousOCREngine(tpipe, slots=4, capacity=512, chunk_steps=8, lookup_chunk=chunk)
        reqs = engine.prestage(pages, max_new_tokens=gen["max_new_tokens"])  # one admission group: slot i = page i
        if chunk == 0:
            cont.logits_last = lambda params, hidden: logits.append(orig(params, hidden).float()) or logits[-1]
        try:
            tail[chunk] = engine.run_requests(reqs, ngram_size=20)
        finally:
            cont.logits_last = orig
    for i in range(len(pages)):
        plain = SimpleNamespace(token_ids=tail[0][i].token_ids, prompt_len=tail[0][i].prompt_len,
                                step_logits=[lg[i].cpu() for lg in logits])
        note = _first_difference(plain, tail[4][i])
        print(f"[lookup-exact] int8tail pool, continuous engine page {i}: lookup "
              f"{'= plain' if not note else note} ({tail[4][i].new_tokens} tokens)")
    d = {k: fn.launches - before[k] for k, fn in kernels.items()}
    print(f"[lookup-exact] launches {d}")
    if min(d[k] for k in "PQR") == 0 or d["G"]:  # the plain runs: the contiguous cache and the int8tail pool
        raise AssertionError(f"the reduced-depth runs did not reach Q, R (lookup) and P (plain int8tail): {d}")

    # Card vs CPU at 16 new tokens (the CPU's full-width forwards are slow).
    gen16 = dict(gen, max_new_tokens=16)
    cpu = OCR2Pipeline(cpu_params, cfg, pipe.tokenizer, device="cpu", kv_dtype="float32", act_dtype="float32")
    cpu_single = cpu.generate_ocr(pages[0], keep_logits=True, **gen16)
    cpu.lookup_chunk = pipe.lookup_chunk = 4
    try:
        cpu_lookup, card_lookup = cpu.generate_ocr(pages[0], **gen16), pipe.generate_ocr(pages[0], **gen16)
    finally:
        pipe.lookup_chunk = 0
    note = _first_difference(SimpleNamespace(token_ids=cpu_lookup.token_ids, prompt_len=cpu_lookup.prompt_len,
                                             step_logits=cpu_single.step_logits), card_lookup)
    print(f"[lookup-exact] page 0 with lookup: card {'= CPU' if not note else note} "
          f"({cpu_lookup.new_tokens} tokens on the CPU in {cpu_lookup.lookup_forwards} forwards, "
          f"{card_lookup.new_tokens} on the card in {card_lookup.lookup_forwards}; CPU lookup = CPU greedy: "
          f"{cpu_lookup.token_ids == cpu_single.token_ids})")


# ---------------------------------------------------------------------------
# Phase 8


TRAIN_LR = 1e-3  # large enough that AdamW's first steps move bf16 weights (ulp 2^-8 relative)
TRAIN_STEPS = 5


def train_launches_per_step(lm, remat: bool) -> dict:
    """Kernel launches of one `adamw_train_step` at B * S > 512 rows, derived
    from the code (models/deepseek_v2.py `lm_forward(training=True)`,
    ops/moe_gmm.py `MoeFfnGmm`): each MoE layer's forward runs D and E
    once; its backward E three times (gate, up and y recomputed), S three
    times (dact, dx_gate, dx_up) and T three times (dW of gate, up, down);
    `remat` runs each MoE layer's forward once more in the backward. The
    attention is plain (no A), the dense and shared MLPs are F.linear."""
    n_moe = lm.num_moe_layers
    want = dict.fromkeys("ABCDEFGHIJKLMNOPQRSTUVWX", 0)
    want.update(D=n_moe * (1 + remat), E=n_moe * (4 + remat), S=3 * n_moe, T=3 * n_moe)
    return want


def _step_profile(dev, step) -> dict:
    """Wall time, device busy time (the sum of every device activity's time
    on the one stream) and device activities of one call of `step` under
    torch.profiler; idle share = 1 - busy / wall. User annotations (e.g.
    `Optimizer.step#AdamW.step`) span kernels already counted: left out."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:8]
    gmm = [e for e in rows if "gmm_" in e.key]  # kernels D, E, S, T
    by_kernel = {}
    for e in gmm:
        ms, n = by_kernel.get(_gmm_kernel_of(e.key), (0.0, 0))
        by_kernel[_gmm_kernel_of(e.key)] = (ms + e.self_device_time_total / 1e3, n + e.count)
    return {"wall_ms": wall * 1e3, "device_ms": busy, "launches": sum(e.count for e in rows),
            "gmm_ms": sum(e.self_device_time_total for e in gmm) / 1e3, "gmm_launches": sum(e.count for e in gmm),
            "gmm_by_kernel": by_kernel,
            "top": [(e.key[:100], round(e.self_device_time_total / 1e3, 3), e.count) for e in top]}


def _gmm_kernel_of(name: str) -> str:
    """Which of D, E, S, T a csrc/moe_gmm.cu kernel's profiler name is: in
    bf16 D, S and E share `gmm_rows_wgmma_kernel`, S with the weight
    N-major (`<1>`), E K-major (`<0>`), D with gate and up and the SwiGLU
    (`<2>`); T is `gmm_dw_*`; in f32 S is the f32 GEMM template with its
    weight-rows flag on, and D and E are told apart by the template's first
    argument (two weights: D; one: E), as in bf16 before D's redesign
    (`gmm_mma_kernel<2`)."""
    if "gmm_rows_wgmma_kernel<1>" in name or re.search(r"gmm_kernel<1, \d+, true", name):
        return "S"
    if "gmm_dw" in name:
        return "T"
    return "D" if re.search(r"gmm_(mma_)?kernel<2|gmm_rows_wgmma_kernel<2>", name) else "E"


def phase_train(dev) -> dict:
    """Phase 8, the slice's main path: LM fine-tuning at full width and
    depth (the default DeepseekV2Config: 12 layers, 11 of them MoE) in
    bf16, random weights from a seeded generator on the card, through
    `runtime.train.adamw_train_step` (the train CLI's step) at the CLI's
    B 4 x S 512 on one repeated batch: TRAIN_STEPS steps with the counts
    held to `train_launches_per_step`, the loss finite and falling, then
    one step with remat. Prints step time, tokens/s, peak memory and, for
    one more step under torch.profiler, the device's busy time and idle
    share. Returns the run's launches."""
    from deepseek_ocr2_tpu_torch.configs import DeepseekV2Config
    from deepseek_ocr2_tpu_torch.io import DtypePolicy
    from deepseek_ocr2_tpu_torch.models import deepseek_v2 as dsv2
    from deepseek_ocr2_tpu_torch.runtime import train

    lm = DeepseekV2Config()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    flat = random_lm_hf_flat(lm, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    params, report = dsv2.params_from_flat(flat, lm, device=dev, policy=DtypePolicy(default="bfloat16"))
    report.raise_on_errors()
    del flat
    tx = train.make_optimizer(lr=TRAIN_LR)
    state = tx.init(params)
    ids = torch.from_numpy(np.random.default_rng(SEED + 8).integers(2, lm.vocab_size, (TRAIN_B, TRAIN_S))).to(dev)
    n_params = sum(t.numel() for _, t in train.param_items(params))
    torch.cuda.synchronize(dev)
    print(f"[train] LM {lm.num_hidden_layers} layers ({lm.num_moe_layers} MoE), {n_params / 1e9:.3f} B parameters "
          f"bf16, AdamW moments bf16, made in {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB on the card; batch [{TRAIN_B}, {TRAIN_S}], "
          f"lr {TRAIN_LR}")

    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    for step, remat in [(i, False) for i in range(TRAIN_STEPS)] + [(TRAIN_STEPS, True)]:
        before = {k: fn.launches for k, fn in kernels.items()}
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        loss = float(train.adamw_train_step(params, state, lm, ids, tx, remat=remat))
        dt = time.perf_counter() - t
        delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
        want = train_launches_per_step(lm, remat)
        bad = {k: (delta[k], n) for k, n in want.items() if delta[k] != n}
        print(f"[train] step {step + 1}{' (remat)' if remat else ''}: loss {loss:.4f}, {dt * 1e3:.1f} ms "
              f"({TRAIN_B * TRAIN_S / dt:.0f} tokens/s), launches D {delta['D']} E {delta['E']} S {delta['S']} "
              f"T {delta['T']}")
        if bad or not math.isfinite(loss):
            raise AssertionError(f"train step {step + 1}: loss {loss}, launches (got, want) {bad}")
        losses.append(loss)
        if not remat:
            step_ms.append(dt * 1e3)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if not losses[TRAIN_STEPS - 1] < losses[0]:
        raise AssertionError(f"the training loss does not fall: {losses}")
    steady = float(np.median(step_ms[1:]))
    print(f"[train] losses {[round(v, 4) for v in losses]}; step {steady:.1f} ms (median of steps 2-{TRAIN_STEPS}), "
          f"{TRAIN_B * TRAIN_S / steady * 1e3:.0f} tokens/s, peak memory {peak:.1f} GiB; first step "
          f"{step_ms[0]:.1f} ms; launches over the phase {launches}")
    # Where a step's time goes: forward + backward and the optimizer update
    # timed apart (host clock to a synchronize), then one step under
    # torch.profiler. These run after the counts were read.
    torch.cuda.synchronize(dev)
    t = time.perf_counter()
    _, grads = train.value_and_grad(train.lm_loss, params, lm, ids)
    torch.cuda.synchronize(dev)
    t_grad = time.perf_counter() - t
    tx.update(grads, state, params)
    torch.cuda.synchronize(dev)
    t_update = time.perf_counter() - t - t_grad
    del grads
    print(f"[train] one step split: forward + backward {t_grad * 1e3:.1f} ms, AdamW update {t_update * 1e3:.1f} ms")
    prof = _step_profile(dev, lambda: train.adamw_train_step(params, state, lm, ids, tx))
    print(f"[train] one step under torch.profiler: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_ms']:.1f} ms, idle share {1 - prof['device_ms'] / prof['wall_ms']:.3f}, "
          f"{prof['launches']} device activities; kernels D, E, S, T {prof['gmm_ms']:.1f} ms in "
          f"{prof['gmm_launches']} launches; top (name, ms, count) {prof['top']}")
    print("[train] grouped-GEMM kernels a step (device ms, launches): " + ", ".join(
        f"{k} {ms:.3f} ms / {n}" for k, (ms, n) in sorted(prof["gmm_by_kernel"].items())))
    del params, state
    torch.cuda.empty_cache()
    return launches


def _lm2_flat(seed: int):
    """The default LM's widths at 2 layers (one dense, one MoE), numpy-seeded
    f32 weights in HF layout, and a [2, 300] batch (600 rows: above the
    512-row cut-over, so the MoE layer runs MoeFfnGmm)."""
    import dataclasses as dc

    from deepseek_ocr2_tpu_torch.configs import DeepseekV2Config

    lm = dc.replace(DeepseekV2Config(), num_hidden_layers=2)
    rng = np.random.default_rng(seed)
    flat = random_lm_hf_flat(
        lm, lambda shape, std: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(std)))
    return lm, flat, torch.from_numpy(rng.integers(2, lm.vocab_size, (2, 300)))


# Card vs CPU, f32: the loss within 1e-5 relative and each gradient leaf
# within 1e-4 of its largest entry (cuBLAS and the kernels sum in other
# orders than the CPU through two layers and the backward).
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4


def _grads_card_vs_cpu(dev, tag: str, lm, load, loss_fn, args) -> None:
    """The loss and every gradient leaf of `loss_fn(params, *args(device))`
    in f32, card (params `load(dev)`) against CPU (`load("cpu")`), the LM
    (config `lm`) above 512 rows: the card must launch what
    `train_launches_per_step` counts (D 1, E 4, S 3, T 3 a MoE layer) and no
    other kernel. The card routes first; the CPU run takes the card's
    expert selection (its routing weights gathered from its own
    probabilities, still differentiable), so that a near tie that rounds
    the other way on one device cannot move a token to another expert; the
    rows whose selection the CPU would have made otherwise are counted and
    printed. Held to TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL."""
    from deepseek_ocr2_tpu_torch.runtime import train

    kernels = counters()
    want = {k: n for k, n in train_launches_per_step(lm, remat=False).items() if n}
    card_idx = []
    out = {}
    for device, record in ((dev, True), ("cpu", False)):
        params = load(device)
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        with routing(card_idx, record) as flips:
            loss, grads = train.value_and_grad(loss_fn, params, *args(device))
        delta = {k: fn.launches - before[k] for k, fn in kernels.items() if fn.launches != before[k]}
        out[str(device)] = (float(loss), [g.cpu() for g in grads])
        print(f"[{tag}] {device}: loss {float(loss):.6f}, {time.perf_counter() - t0:.1f} s, launches {delta}")
        if device != "cpu" and delta != want:
            raise AssertionError(f"the card's training step launched {delta}, expected {want}")
        names = [n for n, _ in train.param_items(params)]
        del params, grads
    print(f"[{tag}] rows whose expert selection the CPU would have made otherwise: {flips}")
    (l_cpu, g_cpu), (l_card, g_card) = out["cpu"], out[str(dev)]
    if not abs(l_card - l_cpu) <= TRAIN_LOSS_RTOL * abs(l_cpu):
        raise AssertionError(f"loss: card {l_card}, CPU {l_cpu}")
    worst = (0.0, "")
    for name, a, b in zip(names, g_card, g_cpu):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        rel = err / max(scale, 1e-30)
        worst = max(worst, (rel, name))
        if not err <= TRAIN_GRAD_RTOL * scale:
            raise AssertionError(f"gradient {name}: card vs CPU max_abs_err {err}, above {TRAIN_GRAD_RTOL} x {scale}")
    print(f"[{tag}] loss card {l_card:.6f} CPU {l_cpu:.6f}; {len(names)} gradient leaves within "
          f"{TRAIN_GRAD_RTOL} of each leaf's largest entry, worst {worst[0]:.2e} ({worst[1]})")


def phase_train_card_vs_cpu(dev) -> None:
    """Phase 8b: the loss and every gradient leaf of `lm_loss` at full
    width, 2 layers, f32, card (D, E, S, T) against CPU (the twins), under
    `_grads_card_vs_cpu`'s rule."""
    from deepseek_ocr2_tpu_torch.io import DtypePolicy
    from deepseek_ocr2_tpu_torch.models import deepseek_v2 as dsv2
    from deepseek_ocr2_tpu_torch.runtime import train

    lm, flat, ids = _lm2_flat(SEED + 9)

    def load(device):
        params, report = dsv2.params_from_flat({k: v.clone() for k, v in flat.items()}, lm, device=device,
                                               policy=DtypePolicy(default="float32"))
        report.raise_on_errors()
        return params

    _grads_card_vs_cpu(dev, "train-cpu-vs-card", lm, load, train.lm_loss, lambda device: (lm, ids.to(device)))


def phase_train_resume(dev) -> None:
    """Phase 8c: on the card, 4 AdamW steps straight against 2 steps,
    `save_train_state`, `load_train_state` into fresh params and state, and
    2 more steps: every parameter bit-identical. The 2-layer full-width LM
    in bf16, B 4 x S 512; the file goes to the ignored build/ directory and
    is removed."""
    import os

    from deepseek_ocr2_tpu_torch.io import DtypePolicy
    from deepseek_ocr2_tpu_torch.models import deepseek_v2 as dsv2
    from deepseek_ocr2_tpu_torch.runtime import train

    lm, flat, _ = _lm2_flat(SEED + 10)
    batches = [torch.from_numpy(np.random.default_rng(SEED + 10 + s).integers(2, lm.vocab_size, (TRAIN_B, TRAIN_S)))
               .to(dev) for s in range(4)]
    tx = train.make_optimizer(lr=TRAIN_LR)

    def fresh():
        params, report = dsv2.params_from_flat(flat, lm, device=dev, policy=DtypePolicy(default="bfloat16"))
        report.raise_on_errors()
        return params, tx.init(params)

    t0 = time.perf_counter()
    straight, st = fresh()
    losses = [float(train.adamw_train_step(straight, st, lm, b, tx)) for b in batches]
    first, st = fresh()
    for b in batches[:2]:
        train.adamw_train_step(first, st, lm, b, tx)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_state_smoke.safetensors")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t1 = time.perf_counter()
    train.save_train_state(path, first, st, 2)
    size = os.path.getsize(path)
    del first, st
    resumed, st = fresh()
    step = train.load_train_state(path, resumed, st)
    t_io = time.perf_counter() - t1
    os.remove(path)
    resumed_losses = [float(train.adamw_train_step(resumed, st, lm, b, tx)) for b in batches[2:]]
    differ = [n for (n, a), (_, b) in zip(train.param_items(straight), train.param_items(resumed))
              if not torch.equal(a, b)]
    print(f"[train-resume] straight losses {losses}, resumed at step {step}: {resumed_losses}; state file "
          f"{size / 2**30:.2f} GiB saved and loaded in {t_io:.1f} s; {time.perf_counter() - t0:.1f} s in all")
    if step != 2 or resumed_losses != losses[2:] or differ:
        raise AssertionError(f"the resumed run differs from the straight one: step {step}, leaves {differ[:4]}")
    print("[train-resume] every parameter bit-identical to the straight run")
    del straight, resumed, st
    torch.cuda.empty_cache()


OCR_TRAIN_STEPS = 3


def ocr_train_batch(cfg, b: int, s: int, grid, seed: int, device):
    """One OCR fine-tuning batch for `train.ocr_loss`: b synthetic uint8
    pages (`synthetic_page`'s host-stage form: the letterboxed base view
    and, for a crop grid, its tiles), ids [b, s] of BOS, the placeholder
    block and transcript ids, the loss mask on the transcript. Returns
    (ids, image_base, patches or None, image_start, loss_mask)."""
    n_img = cfg.image_token_count(grid)
    w, h = PAGES[0] if grid == (1, 1) else next((w, h) for w, h, g in CROP_PAGES if g == grid)
    pages = [synthetic_page(w, h, cfg, seed=seed + i, grid=grid, host_stage=True)[0] for i in range(b)]
    base = torch.from_numpy(np.concatenate([p["base"] for p in pages])).to(device)
    patches = None if grid == (1, 1) else torch.from_numpy(np.stack([p["patches"] for p in pages])).to(device)
    ids = np.full((b, s), cfg.image_token_id, np.int64)
    ids[:, 0] = cfg.bos_token_id
    ids[:, 1 + n_img :] = np.random.default_rng(seed).integers(2, cfg.lm.vocab_size, (b, s - 1 - n_img))
    mask = np.zeros((b, s), np.float32)
    mask[:, 1 + n_img :] = 1.0
    return torch.from_numpy(ids).to(device), base, patches, 1, torch.from_numpy(mask).to(device)


def phase_train_ocr(dev, smi: str) -> dict:
    """Phase 8d: OCR fine-tuning through the vision towers at full width
    and depth (the default OCR2Config, 3.389 B parameters), fresh HF-layout
    random weights from a seeded generator on the card, loaded with the
    CLI's dtype policy (LM bf16, towers f32), through
    `runtime.train.adamw_ocr_train_step`: OCR_TRAIN_STEPS AdamW steps on one
    repeated batch of 2 no-crop uint8 pages at S 512, then as many on one
    (2, 1) crop page at S 768 (uint8 pixels: bf16 activations). Every step
    launches D, E, S and T as `train_launches_per_step` counts them (more
    than 512 rows) and no other kernel (SAM's training form: no B, C or V);
    the loss is finite and falls on each batch. Then, per batch, the
    forward + backward and the update timed apart, with every tower's
    gradient nonzero, and one profiled crop step. Returns the counted
    steps' launches."""
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.runtime import train

    cfg = OCR2Config()
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    flat = random_hf_flat(cfg, lambda shape, std: torch.randn(shape, generator=g, device=dev) * std)
    params = load_model(cfg, flat, dev, lm_dtype="bfloat16", vision_dtype="float32")
    del flat
    tx = train.make_optimizer(lr=TRAIN_LR)
    state = tx.init(params)
    groups = {"LM": ("lm.",), "SAM": ("sam.",), "Qwen2": ("qwen2.",), "projector": ("projector_",),
              "separator": ("view_seperator",)}
    names = [n for n, _ in train.param_items(params)]
    sizes = {k: sum(t.numel() for n, t in train.param_items(params) if n.startswith(p)) for k, p in groups.items()}
    torch.cuda.synchronize(dev)
    print(f"[train-ocr] {smi}; OCR2Config {sum(sizes.values()) / 1e9:.3f} B parameters (LM {sizes['LM'] / 1e9:.3f} B "
          f"bf16, towers {(sum(sizes.values()) - sizes['LM']) / 1e9:.3f} B f32), AdamW moments in each leaf's dtype, "
          f"made in {time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated(dev) / 2**30:.1f} GiB on the card")
    batches = {"no-crop": ocr_train_batch(cfg, 2, 512, (1, 1), SEED + 11, dev),
               "(2, 1) crop": ocr_train_batch(cfg, 1, 768, (2, 1), SEED + 12, dev)}

    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    want = train_launches_per_step(cfg.lm, remat=False)
    for name, batch in batches.items():
        b, s = batch[0].shape
        losses, step_ms = [], []
        for step in range(OCR_TRAIN_STEPS):
            before = {k: fn.launches for k, fn in kernels.items()}
            torch.cuda.synchronize(dev)
            t = time.perf_counter()
            loss = float(train.adamw_ocr_train_step(params, state, cfg, *batch, tx))
            dt = time.perf_counter() - t
            delta = {k: fn.launches - before[k] for k, fn in kernels.items()}
            bad = {k: (delta[k], n) for k, n in want.items() if delta[k] != n}
            print(f"[train-ocr] {name} B {b} x S {s}, step {step + 1}: loss {loss:.4f}, {dt * 1e3:.1f} ms "
                  f"({b * s / dt:.0f} tokens/s), launches D {delta['D']} E {delta['E']} S {delta['S']} T {delta['T']}")
            if bad or not math.isfinite(loss):
                raise AssertionError(f"OCR train step {step + 1} ({name}): loss {loss}, launches (got, want) {bad}")
            losses.append(loss)
            step_ms.append(dt * 1e3)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"the OCR training loss does not fall on the {name} batch: {losses}")
        steady = float(np.median(step_ms[1:]))
        print(f"[train-ocr] {name}: losses {[round(v, 4) for v in losses]}; step {steady:.1f} ms (median of steps "
              f"2-{OCR_TRAIN_STEPS}), {b * s / steady * 1e3:.0f} tokens/s; first step {step_ms[0]:.1f} ms")
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"[train-ocr] peak memory {peak:.1f} GiB over the {2 * OCR_TRAIN_STEPS} steps on {smi}; launches over "
          f"the steps {launches}")
    # Where a step's time goes, and where the gradients reach: forward +
    # backward and the update timed apart (host clock to a synchronize),
    # then one step under torch.profiler. These run after the counts were
    # read.
    for name, batch in batches.items():
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        _, grads = train.value_and_grad(train.ocr_loss, params, cfg, *batch)
        torch.cuda.synchronize(dev)
        t_grad = time.perf_counter() - t
        norms = {k: float(torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
            [gr for n, gr in zip(names, grads) if n.startswith(p)], 2, dtype=torch.float32)))) for k, p in groups.items()}
        t = time.perf_counter()
        tx.update(grads, state, params)
        torch.cuda.synchronize(dev)
        t_update = time.perf_counter() - t
        del grads
        print(f"[train-ocr] {name} one step split: forward + backward {t_grad * 1e3:.1f} ms, AdamW update "
              f"{t_update * 1e3:.1f} ms; gradient L2 norms " + ", ".join(f"{k} {v:.3e}" for k, v in norms.items()))
        if not all(v > 0 and math.isfinite(v) for v in norms.values()):
            raise AssertionError(f"a tower's gradient is zero or not finite on the {name} batch: {norms}")
    prof = _step_profile(dev, lambda: train.adamw_ocr_train_step(params, state, cfg, *batches["(2, 1) crop"], tx))
    print(f"[train-ocr] one (2, 1) crop step under torch.profiler: wall {prof['wall_ms']:.1f} ms, device busy "
          f"{prof['device_ms']:.1f} ms, idle share {1 - prof['device_ms'] / prof['wall_ms']:.3f}, "
          f"{prof['launches']} device activities; kernels D, E, S, T {prof['gmm_ms']:.1f} ms in "
          f"{prof['gmm_launches']} launches; top (name, ms, count) {prof['top']}")
    del params, state, batches
    torch.cuda.empty_cache()
    return launches


def phase_train_ocr_card_vs_cpu(dev) -> None:
    """Phase 8e: the loss and every gradient leaf of `ocr_loss`, card
    against CPU, under `_grads_card_vs_cpu`'s rule (phase 8b's): full
    widths at reduced depth (SAM 3 blocks, the last global, at 1024^2;
    Qwen2 2 layers; the LM 2 layers, dense then MoE), f32 weights and
    pixels ([-1, 1]), the same numpy-seeded weights on both; one no-crop
    page at S 600, so the card's MoE layer runs D, E, S, T and the CPU the
    twins; SAM's training form on both (no B, C or V on the card)."""
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.models.deepseek_ocr2 import normalize_pixels
    from deepseek_ocr2_tpu_torch.runtime import train

    base = OCR2Config()
    cfg = dataclasses.replace(
        base,
        lm=dataclasses.replace(base.lm, num_hidden_layers=2),
        qwen2=dataclasses.replace(base.qwen2, num_hidden_layers=2),
        sam=dataclasses.replace(base.sam, depth=3, global_attn_indexes=(2,)),
    )
    rng = np.random.default_rng(SEED + 12)
    flat = random_hf_flat(
        cfg, lambda shape, std: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(std))
    )
    ids, image, _, start, mask = ocr_train_batch(cfg, 1, 600, (1, 1), SEED + 13, "cpu")
    image = normalize_pixels(image, torch.float32)
    _grads_card_vs_cpu(dev, "train-ocr-cpu-vs-card", cfg.lm,
                       lambda device: load_model(cfg, flat, device, lm_dtype="float32", vision_dtype="float32"),
                       train.ocr_loss,
                       lambda device: (cfg, ids.to(device), image.to(device), None, start, mask.to(device)))


# ---------------------------------------------------------------------------
# Phase 9: multi-GPU training on the one card. `phase_multi_gpu` runs in the
# parent; `chip_nccl_loss` and `chip_phase9` are the entries of the worlds
# it starts (`parallel.launch` spawns the ranks, each of which imports this
# script again to find them).

# Phase 9b's bounds on the bf16 12-layer LM at (1, 2) against (1, 1) on the
# same weights and batch, the (1, 1) routing replayed: two paths that round
# the hidden states to bf16 at other points (the row-parallel products and
# the routed experts summed over mp in f32) through 12 layers. The loss
# within MESH_BF16_LOSS_RTOL; every gradient leaf within
# MESH_BF16_GRAD_RTOL of its largest entry, a bound set between the sound
# run's reading and that of a planted fault (`dropped_partial`), which
# every run measures again and must exceed it. On an H100 80GB HBM3 at
# 700 W the sound run read 4.07e-2 (layers.8.experts.gate) and the fault
# 1.03, its loss 1.6e-4 from (1, 1)'s, well inside the loss bound: the
# bound sits near their geometric mean (PERF.md, section 6).
MESH_BF16_LOSS_RTOL = 5e-3
MESH_BF16_GRAD_RTOL = 0.2
# The planted fault: the forward's reduction over mp number MESH_FAULT_CALL
# (each layer reduces wo's partials, then its MLP's: 3 is layer 1's MoE
# layer) sums rank 0's partial alone.
MESH_FAULT_CALL = 3
# 9d's OCR prefill logits at (2, 1) and (1, 2) against (1, 1)'s, f32, the
# routing replayed: within this share of the largest logit (read 7.8e-7).
MESH_LOGITS_RTOL = 1e-4


@contextlib.contextmanager
def routing(log: list, record: bool, mesh=None):
    """Record every MoE layer's expert selection (`log` gets each call's
    [N, k] ids of the whole batch, on the host), or replay a recorded one:
    each call takes its rows (the mesh's dp rows) of the next entry, its
    routing weights gathered from its own probabilities (still
    differentiable), so that a near tie rounded the other way in another
    summation order cannot move a row to another expert. Yields the list,
    per call, of the rows whose own selection differs."""
    from deepseek_ocr2_tpu_torch.models import deepseek_v2 as dsv2
    from deepseek_ocr2_tpu_torch.parallel.mesh import dp_rows

    orig, flips = dsv2.route, []

    def recording(x, w, k):
        weights, idx = orig(x, w, k)
        log.append(idx.cpu())
        return weights, idx

    def replaying(x, w, k):
        own = orig(x, w, k)[1]
        idx = dp_rows(log[len(flips)], mesh).to(x.device)
        flips.append(int((own.sort(1).values != idx.sort(1).values).any(1).sum()))
        probs = torch.softmax(F.linear(x.float(), w.float()), dim=-1)
        return probs.gather(1, idx), idx

    dsv2.route = recording if record else replaying
    try:
        yield flips
    finally:
        dsv2.route = orig


@contextlib.contextmanager
def dropped_partial(on: bool):
    """The planted fault, when `on`: the forward's reduction over mp number
    MESH_FAULT_CALL (`reduce_from_mp`) sums rank 0's partial alone, as if
    the other ranks' values were lost. Their gradient still flows (x -
    x.detach() is 0 with x's gradient), so every leaf keeps a gradient and
    every rank's backward runs the same collectives: the fault shows only
    through the hidden states it changes."""
    from deepseek_ocr2_tpu_torch.models import deepseek_v2 as dsv2

    orig, calls = dsv2.reduce_from_mp, []

    def faulty(x, mesh):
        calls.append(1)
        return orig(x - x.detach() if len(calls) - 1 == MESH_FAULT_CALL and mesh.mp_rank else x, mesh)

    dsv2.reduce_from_mp = faulty if on else orig
    try:
        yield
    finally:
        dsv2.reduce_from_mp = orig


@contextlib.contextmanager
def counted(out: dict):
    """Every kernel count (`counters`) set to 0 on entry; `out` holds the
    block's launches on exit."""
    kernels = counters()
    for fn in kernels.values():
        fn.launches = 0
    yield
    out.update({k: fn.launches for k, fn in kernels.items()})


def _launches(counts: dict, mesh) -> dict:
    """{letter: [the launches of each rank of the mesh]}, on every rank."""
    from deepseek_ocr2_tpu_torch.parallel.runs import every_rank

    keys = sorted(counts)
    per_rank = every_rank(torch.tensor([counts[k] for k in keys], device=mesh.device), mesh).cpu()
    return {k: per_rank[:, i].tolist() for i, k in enumerate(keys)}


def _worst_leaf(names, got, ref) -> list:
    """[the largest |got - ref| over its leaf's largest |ref|, that leaf]."""
    worst = [0.0, ""]
    for name, a, b in zip(names, got, ref):
        rel = float((a.float() - b.float()).abs().max()) / max(float(b.abs().max()), 1e-30)
        if rel > worst[0]:
            worst = [rel, name]
    return worst


def _broadcast_log(log: list, group=None) -> list:
    """The routing log of the first rank of `group` (default: the world) on
    every rank of it."""
    import torch.distributed as dist

    src = 0 if group is None else dist.get_global_rank(group, 0)
    box = [log if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def _ref_parts(names, ref, shards, mesh) -> list:
    """The whole gradient `ref` (on the mesh's first rank; None on the
    others) cut as the mesh cuts the leaves: each rank gets its part of
    every split leaf (the first rank sends the others theirs), and the whole
    leaves stay on the first rank (None on the others)."""
    import torch.distributed as dist

    from deepseek_ocr2_tpu_torch.parallel.collectives import broadcast_
    from deepseek_ocr2_tpu_torch.parallel.sharding import split_dim

    src, first = dist.get_global_rank(mesh.mp_group, 0), mesh.mp_rank == 0
    parts = []
    for i, name in enumerate(names):
        dim = split_dim(name)
        if dim is None:
            parts.append(ref[i] if first else None)
            continue
        n = shards[i].shape[dim]
        mine = ref[i].narrow(dim, 0, n).clone() if first else None
        for r in range(1, mesh.mp):
            buf = ref[i].narrow(dim, r * n, n).contiguous() if first else torch.empty_like(shards[i])
            broadcast_(buf, src, mesh.mp_group)
            mine = buf if mesh.mp_rank == r else mine
        parts.append(mine)
    return parts


def _leaf_gaps(grads, parts, mesh) -> torch.Tensor:
    """[leaves]: each leaf's largest |grad - part| over the mesh's ranks (a
    rank without a part adds 0), on every rank."""
    from deepseek_ocr2_tpu_torch.parallel.runs import every_rank

    zero = torch.zeros((), device=mesh.device)
    gaps = torch.stack([zero if r is None else (g.float() - r.float()).abs().max() for g, r in zip(grads, parts)])
    return every_rank(gaps, mesh).amax(0)


def _phase9a(device, spec, out) -> None:
    """Full width, reduced depth, f32: one forward and backward at each
    mesh, the losses and gathered gradients held to (1, 1)'s on rank 0, the
    routing of (1, 1) replayed."""
    import torch.distributed as dist

    from deepseek_ocr2_tpu_torch.parallel.mesh import dp_rows, make_mesh
    from deepseek_ocr2_tpu_torch.parallel.runs import shard_lm
    from deepseek_ocr2_tpu_torch.parallel.sharding import gather_leaves
    from deepseek_ocr2_tpu_torch.runtime import train

    cfg = spec["cfg_a"]
    ids = torch.as_tensor(spec["ids_a"])
    params = {"random": spec["seed"], "dtype": torch.float32}
    log, ref = [], None
    for i, (dp, mp) in enumerate(spec["meshes_a"]):
        log = _broadcast_log(log)
        mesh = make_mesh(dp, mp, ranks=range(dp * mp), device=device)
        if mesh is not None:
            p = shard_lm(params, cfg, mesh)
            counts = {}
            t0 = time.perf_counter()
            with counted(counts), routing(log, i == 0, mesh) as flips:
                loss, grads = train.value_and_grad(train.lm_loss, p, cfg, dp_rows(ids, mesh).to(device))
                torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
            names = [n for n, _ in train.param_items(p)]
            whole = gather_leaves(names, grads, mesh)
            launches = _launches(counts, mesh)
            if mesh.rank == 0:
                res = {"loss": float(loss), "seconds": seconds, "launches": launches, "flips": flips,
                       "backend": mesh.backend}
                if ref is None:
                    ref = (float(loss), [t.clone() for t in whole])
                else:
                    res["loss_rel"] = abs(float(loss) - ref[0]) / abs(ref[0])
                    res["worst"] = _worst_leaf(names, whole, ref[1])
                out[f"9a {dp}x{mp}"] = res
            del p, grads, whole
            torch.cuda.empty_cache()
        dist.barrier()


def _phase9bc(device, spec, out) -> None:
    """9b: the full-width, full-depth LM in bf16. The (1, 1) loss and
    gradients of the batch on rank 0 (its routing recorded); at (1, 2) the
    same with that routing replayed, sound and with the planted fault
    (`dropped_partial`): each leaf's gap to (1, 1)'s over the leaf's
    largest entry; then AdamW steps (their time, each rank's launches and
    peak memory, one profiled step with its collectives timed, whether the
    whole leaves stay equal on both ranks). 9c: `greedy_generate` on the
    trained shards against the whole params gathered to rank 0."""
    import torch.distributed as dist

    from deepseek_ocr2_tpu_torch.parallel.collectives import equal_across, timed
    from deepseek_ocr2_tpu_torch.parallel.mesh import make_mesh
    from deepseek_ocr2_tpu_torch.parallel.runs import every_rank, shard_lm
    from deepseek_ocr2_tpu_torch.parallel.sharding import gather_params, split_dim
    from deepseek_ocr2_tpu_torch.runtime import train
    from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate

    cfg, steps = spec["cfg_b"], spec["steps_b"]
    rows = torch.as_tensor(spec["ids_b"]).to(device)
    params = {"random": spec["seed"] + 1, "dtype": torch.bfloat16}
    single = make_mesh(1, 1, ranks=[0], device=device)
    mesh = make_mesh(1, 2, ranks=[0, 1], device=device)
    if mesh is not None:
        log, ref, ref_loss, scales = [], None, None, None
        if single is not None:
            p = shard_lm(params, cfg, single)
            with routing(log, True):
                loss, ref = train.value_and_grad(train.lm_loss, p, cfg, rows)
            ref_loss = float(loss)
            scales = torch.stack([g.abs().max().float() for g in ref]).clamp(min=1e-30)
            del p
            torch.cuda.empty_cache()
        log = _broadcast_log(log, mesh.mp_group)
        p = shard_lm(params, cfg, mesh)
        items = train.param_items(p)
        names = [n for n, _ in items]
        parts = _ref_parts(names, ref, [t for _, t in items], mesh)
        del ref
        torch.cuda.empty_cache()
        gaps = {}
        for fault in (False, True):
            with routing(log, False, mesh) as flips, dropped_partial(fault):
                loss, grads = train.value_and_grad(train.lm_loss, p, cfg, rows)
            worst = _leaf_gaps(grads, parts, mesh)
            del grads
            if mesh.rank == 0:
                rel = (worst / scales).cpu()
                j = int(rel.argmax())
                gaps["fault" if fault else "sound"] = {
                    "loss": float(loss), "loss_rel": abs(float(loss) - ref_loss) / abs(ref_loss),
                    "worst": [float(rel[j]), names[j]], "flips": flips}
        del parts
        torch.cuda.empty_cache()
        opt = train.make_optimizer(lr=spec["lr_b"])
        state = opt.init(p)
        torch.cuda.reset_peak_memory_stats(device)
        counts: dict = {}
        losses, step_ms = [], []
        with counted(counts):
            for _ in range(steps):
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                losses.append(float(train.adamw_train_step(p, state, cfg, rows, opt)))
                step_ms.append((time.perf_counter() - t0) * 1e3)
        peak = every_rank(torch.tensor([torch.cuda.max_memory_allocated(device) / 2**30], device=device), mesh)
        launches = _launches(counts, mesh)
        with timed() as times:
            prof = _step_profile(device, lambda: train.adamw_train_step(p, state, cfg, rows, opt))
        prof.update(collective_ms=times["seconds"] * 1e3, calls=times["calls"], mib=times["bytes"] / 2**20,
                    share=times["seconds"] * 1e3 / prof["wall_ms"])
        replicated_equal = equal_across([t for n, t in train.param_items(p) if split_dim(n) is None], mesh, "mp")
        del state, opt
        torch.cuda.empty_cache()
        ids_c = torch.as_tensor(spec["ids_c"]).to(device)
        kw = dict(max_new_tokens=spec["new_c"], ngram_size=20, eos_id=-1, capacity=ids_c.shape[1] + spec["new_c"],
                  kv_dtype=torch.bfloat16)
        counts_c: dict = {}
        with counted(counts_c):
            tokens, _ = greedy_generate(p, cfg, F.embedding(ids_c, p["embed"]), ids_c, **kw)
        launches_c = _launches(counts_c, mesh)
        same = equal_across([tokens], mesh, "mp")
        whole = gather_params(p)
        del p
        if mesh.rank == 0:
            stats: dict = {}
            ref_c, _ = greedy_generate(whole, cfg, F.embedding(ids_c, whole["embed"]), ids_c, stats=stats,
                                       keep_logits=True, **kw)
            s = ids_c.shape[1]
            rows_out = []
            for b in range(ids_c.shape[0]):
                a, c = ref_c[b].tolist(), tokens[b].tolist()
                step = next((i for i in range(s, len(a)) if a[i] != c[i]), None)
                rows_out.append({"single": a, "sharded": c, "step": None if step is None else step - s,
                                 "logits": None if step is None else stats["logits"][step - s][b]})
            out["9b"] = {"losses": losses, "ref_loss": ref_loss, "step_ms": step_ms,
                         "peak_gib": peak.reshape(-1).tolist(), "launches": launches, "profile": prof,
                         "replicated_equal": replicated_equal, **gaps}
            out["9c"] = {"rows": rows_out, "launches": launches_c, "same_on_every_rank": same, "prompt_len": s}
        del whole
        torch.cuda.empty_cache()
    dist.barrier()


def _phase9d(device, spec, out) -> None:
    """The OCR step's loss and gradients at reduced depth on each mesh of
    `meshes_d`, the towers' gradients equal on every rank and held, with
    the loss and the LM's gradients, to (1, 1)'s; then the OCR prefill's
    last logits on each mesh (at dp 2 a page a rank) against (1, 1)'s. The
    routing of (1, 1) replayed in both."""
    import torch.distributed as dist

    from deepseek_ocr2_tpu_torch.parallel.collectives import equal_across
    from deepseek_ocr2_tpu_torch.parallel.mesh import dp_rows, make_mesh
    from deepseek_ocr2_tpu_torch.parallel.runs import ocr_prefill, shard_ocr
    from deepseek_ocr2_tpu_torch.parallel.sharding import gather_leaves
    from deepseek_ocr2_tpu_torch.runtime import train

    cfg = spec["cfg_d"]
    params = dict(spec["towers_d"], lm={"random": spec["seed"] + 2, "dtype": torch.float32})
    ids, image, mask = (torch.as_tensor(spec[k]) for k in ("ids_d", "image_d", "mask_d"))
    log, ref = [], None
    for i, (dp, mp) in enumerate(spec["meshes_d"]):
        log = _broadcast_log(log)
        mesh = make_mesh(dp, mp, ranks=range(dp * mp), device=device)
        if mesh is not None:
            p = shard_ocr(params, cfg, mesh)
            local = [dp_rows(t, mesh).to(device) for t in (ids, image, mask)]
            counts: dict = {}
            with counted(counts), routing(log, i == 0, mesh) as flips:
                loss, grads = train.value_and_grad(train.ocr_loss, p, cfg, local[0], local[1], None,
                                                   spec["start_d"], local[2])
            names = [n for n, _ in train.param_items(p)]
            towers = [g for n, g in zip(names, grads) if not n.startswith("lm.")]
            equal = equal_across(towers, mesh, "mp") and equal_across(towers, mesh, "dp")
            whole = gather_leaves(names, grads, mesh)
            launches = _launches(counts, mesh)
            if mesh.rank == 0:
                res = {"loss": float(loss), "towers_equal": equal, "launches": launches, "flips": flips}
                if ref is None:
                    ref = (float(loss), [t.clone() for t in whole])
                else:
                    pick = [j for j, n in enumerate(names) if not n.startswith("lm.")]
                    res["loss_rel"] = abs(float(loss) - ref[0]) / abs(ref[0])
                    res["worst_tower"] = _worst_leaf([names[j] for j in pick], [whole[j] for j in pick],
                                                     [ref[1][j] for j in pick])
                    res["worst"] = _worst_leaf(names, whole, ref[1])
                out[f"9d {dp}x{mp}"] = res
            del p, grads, whole, towers
            torch.cuda.empty_cache()
        dist.barrier()
    log, ref = [], None
    for i, (dp, mp) in enumerate(spec["meshes_d"]):
        log = _broadcast_log(log)
        mesh = make_mesh(dp, mp, ranks=range(dp * mp), device=device)
        if mesh is not None:
            counts = {}
            with counted(counts), routing(log, i == 0, mesh) as flips:
                logits = ocr_prefill(mesh, cfg, params, ids[:, : spec["prefill_len_d"]], image,
                                     spec["start_d"])["logits"]
            launches = _launches(counts, mesh)
            if mesh.rank == 0:
                res = {"finite": bool(torch.isfinite(logits).all()), "shape": list(logits.shape),
                       "launches": launches, "flips": flips}
                if ref is None:
                    ref = logits
                else:
                    res["rel"] = float((logits - ref).abs().max() / ref.abs().max())
                out[f"9d prefill {dp}x{mp}"] = res
            torch.cuda.empty_cache()
        dist.barrier()


def chip_phase9(rank: int, world: int, device, spec: dict) -> dict:
    """Phase 9 in one world of ranks that share the card over gloo (a
    `parallel.launch` entry): 9a, 9b with 9c, 9d (see each part's
    docstring). Rank 0 returns the measurements and the checks' inputs;
    `phase_multi_gpu` holds them to their bounds."""
    out: dict = {}
    for part in (_phase9a, _phase9bc, _phase9d):
        t0 = time.perf_counter()
        part(device, spec, out)
        torch.cuda.empty_cache()
        out[part.__name__ + " seconds"] = time.perf_counter() - t0
    return out


def chip_nccl_loss(rank: int, world: int, device, spec: dict) -> dict:
    """9a's (1, 1) loss in a world of one rank over NCCL (`launch` picks
    NCCL where each rank has a card), with its launches."""
    from deepseek_ocr2_tpu_torch.parallel.mesh import make_mesh
    from deepseek_ocr2_tpu_torch.parallel.runs import shard_lm
    from deepseek_ocr2_tpu_torch.runtime import train

    mesh = make_mesh(1, 1, device=device)
    p = shard_lm({"random": spec["seed"], "dtype": torch.float32}, spec["cfg_a"], mesh)
    counts: dict = {}
    with counted(counts):
        loss, _ = train.value_and_grad(train.lm_loss, p, spec["cfg_a"], torch.as_tensor(spec["ids_a"]).to(device))
    return {"loss": float(loss), "backend": mesh.backend, "launches": counts}


def phase_multi_gpu(dev) -> dict:
    """Phase 9 (see the module docstring): builds the inputs here, runs
    `chip_nccl_loss` in a one-rank NCCL world and `chip_phase9` in a 4-rank
    gloo world on the card (the kernels built here first), holds the
    results to their bounds and returns the launches of every rank,
    summed."""
    from deepseek_ocr2_tpu_torch.configs import DeepseekV2Config, OCR2Config
    from deepseek_ocr2_tpu_torch.models.deepseek_ocr2 import normalize_pixels
    from deepseek_ocr2_tpu_torch.parallel.launch import launch

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    lm = DeepseekV2Config()
    rng = np.random.default_rng(SEED + 20)
    base = OCR2Config()
    cfg_d = dataclasses.replace(
        base, lm=dataclasses.replace(base.lm, num_hidden_layers=2),
        qwen2=dataclasses.replace(base.qwen2, num_hidden_layers=2),
        sam=dataclasses.replace(base.sam, depth=3, global_attn_indexes=(2,)))
    # The towers whole (made here once, f32); each rank makes the LM itself.
    small = dataclasses.replace(cfg_d, lm=dataclasses.replace(cfg_d.lm, num_hidden_layers=1, vocab_size=1024))
    flat = random_hf_flat(small, lambda shape, std: torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32) * np.float32(std)))
    towers = {k: v for k, v in load_model(small, flat, "cpu", "float32", "float32").items() if k != "lm"}
    del flat
    ids_d, image_d, _, start_d, mask_d = ocr_train_batch(cfg_d, 2, 300, (1, 1), SEED + 21, "cpu")
    spec = dict(
        seed=SEED + 20,
        cfg_a=dataclasses.replace(lm, num_hidden_layers=3), ids_a=rng.integers(2, lm.vocab_size, (4, 512)),
        meshes_a=[(1, 1), (2, 1), (4, 1), (1, 2), (2, 2)],
        cfg_b=lm, ids_b=rng.integers(2, lm.vocab_size, (4, 512)), steps_b=3, lr_b=TRAIN_LR,
        ids_c=rng.integers(2, lm.vocab_size, (16, 256)), new_c=32,
        cfg_d=cfg_d, towers_d=towers, ids_d=ids_d, image_d=normalize_pixels(image_d, torch.float32), mask_d=mask_d,
        start_d=start_d, meshes_d=[(1, 1), (2, 1), (1, 2)], prefill_len_d=300,
    )
    kernels = ("moe_gmm", "moe_decode", "flash_attention", "fused_mlp")
    t = time.perf_counter()
    nccl = launch(chip_nccl_loss, 1, (spec,), device_type="cuda", kernels=kernels)
    t_nccl = time.perf_counter() - t
    t = time.perf_counter()
    out = launch(chip_phase9, 4, (spec,), device_type="cuda", kernels=kernels)
    t_world = time.perf_counter() - t
    totals = dict.fromkeys("ABCDEFGHIJKLMNOPQRSTUVWX", 0)

    def add(launches: dict, want=None, what="") -> None:
        for k, per_rank in launches.items():
            totals[k] += sum(per_rank)
            if want is not None and any(n != want.get(k, 0) for n in per_rank):
                raise AssertionError(f"{what}: kernel {k} launched {per_rank} a rank, expected {want.get(k, 0)}")

    # 9a: every mesh against (1, 1), and (1, 1) over NCCL.
    want_a = train_launches_per_step(spec["cfg_a"], remat=False)
    ref = out["9a 1x1"]
    if nccl["backend"] != "nccl" or ref["backend"] != "gloo":
        raise AssertionError(f"backends: (1, 1) world {nccl['backend']}, shared-card world {ref['backend']}")
    if not abs(nccl["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"]):
        raise AssertionError(f"9a: the NCCL (1, 1) loss {nccl['loss']} differs from the gloo world's {ref['loss']}")
    add({k: [n] for k, n in nccl["launches"].items()}, want_a, "9a NCCL")
    print(f"[mesh] 9a (1, 1): loss {ref['loss']:.6f} (NCCL world {nccl['loss']:.6f}, "
          f"{'bit-equal' if nccl['loss'] == ref['loss'] else 'differs'}), {ref['seconds'] * 1e3:.0f} ms")
    add(ref["launches"], want_a, "9a 1x1")
    for dp, mp in spec["meshes_a"][1:]:
        r = out[f"9a {dp}x{mp}"]
        add(r["launches"], want_a, f"9a {dp}x{mp}")
        print(f"[mesh] 9a ({dp}, {mp}): loss {r['loss']:.6f}, rel err {r['loss_rel']:.2e}; gradients worst "
              f"{r['worst'][0]:.2e} of the leaf's largest ({r['worst'][1]}); rows whose own routing differs "
              f"{r['flips']}; {r['seconds'] * 1e3:.0f} ms; launches a rank D {r['launches']['D']} E "
              f"{r['launches']['E']} S {r['launches']['S']} T {r['launches']['T']}")
        if not (r["loss_rel"] <= TRAIN_LOSS_RTOL and r["worst"][0] <= TRAIN_GRAD_RTOL):
            raise AssertionError(f"9a ({dp}, {mp}) against (1, 1): loss {r['loss_rel']}, gradient {r['worst']}")
    # 9b: the 12-layer LM in bf16 at (1, 2): its gradients against (1, 1),
    # sound and with the planted fault, then the steps.
    b = out["9b"]
    sound, fault = b["sound"], b["fault"]
    print(f"[mesh] 9b gradients of the first batch at (1, 2) against (1, 1), same bf16 weights, routing replayed: "
          f"worst leaf {sound['worst'][0]:.3e} of its largest entry ({sound['worst'][1]}), loss rel "
          f"{sound['loss_rel']:.2e}, rows whose own routing differs {sound['flips']}; with the planted fault "
          f"(reduction {MESH_FAULT_CALL} sums rank 0's partial alone) {fault['worst'][0]:.3e} ({fault['worst'][1]}), "
          f"loss rel {fault['loss_rel']:.2e}; bound {MESH_BF16_GRAD_RTOL}")
    if not (sound["worst"][0] <= MESH_BF16_GRAD_RTOL < fault["worst"][0] and sound["loss_rel"] <= MESH_BF16_LOSS_RTOL):
        raise AssertionError(f"9b gradients against (1, 1): sound {sound}, planted fault {fault['worst']}, "
                             f"bound {MESH_BF16_GRAD_RTOL}")
    want_b = {k: n * spec["steps_b"] for k, n in train_launches_per_step(lm, remat=False).items()}
    add(b["launches"], want_b, "9b")
    gap = abs(b["losses"][0] - b["ref_loss"]) / abs(b["ref_loss"])
    prof = b["profile"]
    print(f"[mesh] 9b (1, 2) bf16 12 layers: losses {[round(v, 4) for v in b['losses']]}, first against the "
          f"(1, 1) forward {b['ref_loss']:.4f}: rel gap {gap:.2e} (bound {MESH_BF16_LOSS_RTOL}); step ms "
          f"{[round(v, 1) for v in b['step_ms']]}; peak memory a rank {[round(v, 2) for v in b['peak_gib']]} GiB; "
          f"launches a rank D {b['launches']['D']} E {b['launches']['E']} S {b['launches']['S']} "
          f"T {b['launches']['T']}")
    print(f"[mesh] 9b one profiled step on rank 0: wall {prof['wall_ms']:.1f} ms, collectives "
          f"{prof['collective_ms']:.1f} ms in {prof['calls']} calls, {prof['mib']:.0f} MiB ({prof['share']:.3f} of "
          f"the wall, each timed between two device synchronizations); device busy {prof['device_ms']:.1f} ms")
    print(f"[mesh] 9b whole leaves (embed, norms, routers) bit-equal on both ranks after 4 steps: "
          f"{b['replicated_equal']}")
    if not (all(math.isfinite(v) for v in b["losses"]) and b["losses"][-1] < b["losses"][0]
            and gap <= MESH_BF16_LOSS_RTOL and b["replicated_equal"]):
        raise AssertionError(f"9b: losses {b['losses']}, (1, 1) {b['ref_loss']}, gap {gap}")
    # 9c: greedy on 9b's trained shards against the gathered whole params.
    c = out["9c"]
    n_moe, steps_c = lm.num_moe_layers, spec["new_c"] - 1
    add(c["launches"], {"A": lm.num_hidden_layers, "D": n_moe, "E": n_moe, "F": n_moe * steps_c}, "9c")
    notes = []
    for row in c["rows"]:
        step = row["step"]
        logits = [None] * (step or 0) + [None if row["logits"] is None else torch.from_numpy(row["logits"])]
        single = types.SimpleNamespace(token_ids=row["single"], prompt_len=c["prompt_len"], step_logits=logits)
        served = types.SimpleNamespace(token_ids=row["sharded"], prompt_len=c["prompt_len"])
        notes.append(_first_difference(single, served, torch.bfloat16))
    if not c["same_on_every_rank"]:
        raise AssertionError("9c: the ranks' tokens differ")
    print(f"[mesh] 9c greedy 16 x 32 tokens at (1, 2) against (1, 1): {sum(not n for n in notes)} rows equal; "
          f"{[n for n in notes if n]}; launches a rank A {c['launches']['A']} D {c['launches']['D']} "
          f"E {c['launches']['E']} F {c['launches']['F']}")
    # 9d: the OCR loss's gradients, then the prefill.
    want_d = train_launches_per_step(cfg_d.lm, remat=False)
    add(out["9d 1x1"]["launches"], want_d, "9d 1x1")
    for dp, mp in spec["meshes_d"][1:]:
        r = out[f"9d {dp}x{mp}"]
        add(r["launches"], want_d, f"9d {dp}x{mp}")
        print(f"[mesh] 9d OCR ({dp}, {mp}): loss rel err {r['loss_rel']:.2e}; towers' gradients equal on every "
              f"rank {r['towers_equal']}, worst against (1, 1) {r['worst_tower'][0]:.2e} ({r['worst_tower'][1]}); "
              f"all leaves worst {r['worst'][0]:.2e} ({r['worst'][1]}); rows whose own routing differs {r['flips']}")
        if not (r["towers_equal"] and r["loss_rel"] <= TRAIN_LOSS_RTOL and r["worst"][0] <= TRAIN_GRAD_RTOL):
            raise AssertionError(f"9d ({dp}, {mp}): {r}")
    for dp, mp in spec["meshes_d"]:
        pre = out[f"9d prefill {dp}x{mp}"]
        add(pre["launches"])
        rel = pre.get("rel", 0.0)
        print(f"[mesh] 9d OCR prefill ({dp}, {mp}): last logits {pre['shape']} finite {pre['finite']}, against "
              f"(1, 1) {rel:.2e} of the largest (bound {MESH_LOGITS_RTOL}); rows whose own routing differs "
              f"{pre['flips']}; launches a rank { {k: v for k, v in pre['launches'].items() if any(v)} }")
        if not pre["finite"] or rel > MESH_LOGITS_RTOL or any(min(pre["launches"][k]) < 1 for k in "ABCDE"):
            raise AssertionError(f"9d prefill ({dp}, {mp}): {pre}")
    print(f"[mesh] phase 9: {time.perf_counter() - t0:.1f} s (NCCL world {t_nccl:.1f} s, 4-rank world "
          f"{t_world:.1f} s: 9a {out['_phase9a seconds']:.1f}, 9b+9c {out['_phase9bc seconds']:.1f}, 9d "
          f"{out['_phase9d seconds']:.1f})")
    return totals


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    import deepseek_ocr2_tpu_torch  # noqa: F401  (sets the f32 numerics flags)

    dev = torch.device("cuda", 0)
    smi = phase_device()
    results = phase_kernels(dev)
    main_launches, pipe, main_results = phase_main_path(dev)
    int8_launches = phase_quant_main_path(dev, pipe, (INT8, MOE_INT8), "int8")
    int4_launches = phase_quant_main_path(dev, pipe, (INT4,), "int4")
    lookup_launches = phase_lookup_main_path(dev, pipe)
    resize_launches = phase_device_resize(dev, pipe, main_results)
    serve_launches = phase_serving(dev, pipe)
    serve_quant_launches, group_ref = phase_serving_quant(dev, pipe)
    switched_launches = phase_switched_main_path(dev, pipe, main_results, group_ref,
                                                 _serve_pages(pipe.cfg, 16, 0, seed=600))
    serve_kv_launches = phase_serving_kv(dev, pipe)
    serve_lookup_launches = phase_serving_lookup(dev, pipe)
    phase_decode_profile(pipe)
    validate_launches = phase_validate(dev, pipe)
    del pipe
    torch.cuda.empty_cache()
    card_pipes, cpu_params = phase_card_vs_cpu(dev)
    phase_switched_card_vs_cpu(dev, card_pipes["f32"], cpu_params)
    phase_serving_exact(dev, card_pipes["f32"])
    phase_serving_exact(dev, card_pipes["int8"], tier="int8")
    phase_serving_exact(dev, card_pipes["int4"], tier="int4")
    phase_kv_card_vs_cpu(dev, card_pipes["f32"].params, cpu_params)
    phase_lookup_exact(dev, card_pipes["f32"], cpu_params)
    del card_pipes, cpu_params
    torch.cuda.empty_cache()
    train_launches = phase_train(dev)
    phase_train_card_vs_cpu(dev)
    phase_train_resume(dev)
    ocr_train_launches = phase_train_ocr(dev, smi)
    phase_train_ocr_card_vs_cpu(dev)
    mesh_launches = phase_multi_gpu(dev)
    if any(m == "jax" or m.startswith(("jax.", "deepseek_ocr2_tpu.")) or m == "deepseek_ocr2_tpu" for m in sys.modules):
        raise AssertionError("jax or the JAX package was imported")

    # The main path is one page through generate_ocr (phase 4, and with
    # quantized weights 4b and 4c, with lookup decoding 4d, with the device
    # resize 4f, under validate-hf's harness 4g), serving
    # (phase 6, and 6b, 6c and, on the quantized pools, 6d, with lookup
    # decoding 6e), the two switched paths (phase 4e) and fine-tuning
    # (phase 8) and through the vision towers (phase 8d), and on a mesh
    # (phase 9, every rank's launches summed); each was driven
    # with the counts at 0 and read after. W
    # and X run on no path (the JAX package calls neither): 0 launches.
    runs = (main_launches, int8_launches, int4_launches, lookup_launches, resize_launches, validate_launches,
            serve_launches, serve_quant_launches, switched_launches, serve_kv_launches, serve_lookup_launches,
            train_launches, ocr_train_launches, mesh_launches)
    launches = {k: sum(r[k] for r in runs) for k in main_launches}
    meta = {
        "A": ("flash_attention.mha causal (LM prefill)", "deepseek_ocr2_tpu/ops/flash_attention.py:54"),
        "B": ("flash_attention.mha_relpos (SAM attention)", "deepseek_ocr2_tpu/ops/flash_attention.py:101"),
        "C": ("fused_mlp.mlp_gelu (SAM MLP)", "deepseek_ocr2_tpu/ops/fused_mlp.py:66"),
        "D": ("moe_gmm.moe_gmm_swiglu (grouped-GEMM MoE prefill, gate/up + SwiGLU)",
              "deepseek_ocr2_tpu/ops/moe_gmm.py:223"),
        "E": ("moe_gmm.moe_gmm_down (grouped-GEMM MoE prefill, down)", "deepseek_ocr2_tpu/ops/moe_gmm.py:237"),
        "F": ("moe_decode.moe_ffn_decode_fused (batched-decode MoE, one visit per distinct expert)",
              "deepseek_ocr2_tpu/ops/moe_decode.py:85"),
        "G": ("paged_attention.paged_decode_attention_pool (paged decode attention)",
              "deepseek_ocr2_tpu/ops/paged_attention.py:158"),
        "H": ("linear_q8.linear_q8 (int8-weight skinny GEMM, w8a16)", "deepseek_ocr2_tpu/ops/linear_q8.py:78"),
        "I": ("moe_q8.moe_ffn_decode_q8 (int8 MoE decode, one visit per row and selection)",
              "deepseek_ocr2_tpu/ops/moe_q8.py:50"),
        "J": ("moe_decode.moe_ffn_decode_q8_fused (int8 batched-decode MoE, one visit per distinct expert)",
              "deepseek_ocr2_tpu/ops/moe_decode.py:220"),
        "K": ("attn_fused.attn_decode_fused (fused decode attention, int8 weights)",
              "deepseek_ocr2_tpu/ops/attn_fused.py:100"),
        "L": ("linear_q4.linear_q4 (int4-weight skinny GEMM, w4a16, group-128 scales)",
              "deepseek_ocr2_tpu/ops/linear_q4.py:181"),
        "M": ("moe_q4.moe_ffn_decode_q4 (int4 MoE decode, one visit per row and selection)",
              "deepseek_ocr2_tpu/ops/moe_q4.py:99"),
        "N": ("moe_q4.moe_ffn_decode_q4_fused (int4 batched-decode MoE, one visit per distinct expert)",
              "deepseek_ocr2_tpu/ops/moe_q4.py:280"),
        "O": ("attn_fused.attn_decode_fused_q4 (fused decode attention, int4 weights)",
              "deepseek_ocr2_tpu/ops/attn_fused.py:100"),
        "P": ("paged_attention.paged_decode_attention_pool_q8 (paged decode attention, int8 / int8tail pool)",
              "deepseek_ocr2_tpu/ops/paged_attention.py:629"),
        "Q": ("paged_attention.paged_decode_attention_pool_chunk (chunk paged attention of lookup decoding, "
              "f32 / bf16 pool)", "deepseek_ocr2_tpu/ops/paged_attention.py:304"),
        "R": ("paged_attention.paged_decode_attention_pool_chunk_q8 (chunk paged attention of lookup decoding, "
              "int8 / int8tail pool)", "deepseek_ocr2_tpu/ops/paged_attention.py:808"),
        "S": ("moe_gmm.moe_gmm_dx (grouped-GEMM MoE backward, a_t W_e: dact, dx_gate, dx_up)",
              "deepseek_ocr2_tpu/ops/moe_gmm.py:381"),
        "T": ("moe_gmm.moe_gmm_dw (grouped-GEMM MoE backward, per-expert dW = sum dy_t^T x_t, f32)",
              "deepseek_ocr2_tpu/ops/moe_gmm.py:440"),
        "U": ("paged_attention.decode_attention_stacked (decode attention on the layer-stacked contiguous "
              "cache, DEEPSEEK_DECODE_ATTN=stacked)", "deepseek_ocr2_tpu/ops/paged_attention.py:494"),
        "V": ("flash_attention.mha_win (SAM windowed attention, rel-pos bias built in the kernel, "
              "DEEPSEEK_SAM_WIN_KERNEL=1)", "deepseek_ocr2_tpu/ops/flash_attention.py:147"),
        "W": ("moe_gmm.gmm_ffn_visit / gmm_swiglu_visit (boundary-visit grouped GEMM: _gmm_ffn_kernel, and "
              "_gmm_swiglu_kernel at moe_gmm.py:184; on no path of either package)",
              "deepseek_ocr2_tpu/ops/moe_gmm.py:199"),
        "X": ("paged_attention.paged_decode_attention (per-sequence paged decode attention, G's device code; "
              "on no path of either package)", "deepseek_ocr2_tpu/ops/paged_attention.py:54"),
    }
    sources = {"A": "flash_attention.cu", "B": "flash_attention.cu", "C": "fused_mlp.cu",
               "D": "moe_gmm.cu", "E": "moe_gmm.cu", "F": "moe_decode.cu", "G": "paged_attention.cu",
               "H": "linear_q8.cu", "I": "moe_q8.cu", "J": "moe_q8.cu", "K": "attn_fused.cu",
               "L": "linear_q4.cu", "M": "moe_q4.cu", "N": "moe_q4.cu", "O": "attn_fused.cu",
               "P": "paged_attention.cu", "Q": "paged_attention.cu", "R": "paged_attention.cu",
               "S": "moe_gmm.cu", "T": "moe_gmm.cu", "U": "paged_attention.cu", "V": "flash_attention.cu",
               "W": "moe_gmm.cu", "X": "paged_attention.cu"}
    record = {"kernels": []}
    for k in "ABCDEFGHIJKLMNOPQRSTUVWX":
        # The first case is the main path's: f32 at the no-crop shapes for
        # A, B (SAM global) and C; bf16 at the 2-crop prompt for D and E;
        # bf16 at 16 slots for F; an f32 pool at 16 slots for G; lm_head at
        # one row for H and L; one row with the pseudo-experts for I and M;
        # 16 rows for J and N; one row at pos 300 on an f32 cache for K and
        # O; an int8 pool at 16 slots for P; a bf16 pool at 16 slots for Q
        # and an int8tail one for R (phase 6e's), S = 4; bf16 at a training
        # step's MoE layer (2048 tokens) for S (dact) and T (dW_gate); one
        # row on an f32 cache for U (phase 4e); the no-crop view's 14 x 14
        # windows in f32 for V; the swiglu mode at the (2, 1) crop page's
        # MoE layer in bf16 for W; an f32 pool at 16 rows for X.
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
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
        })
    print(f"[done] {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
