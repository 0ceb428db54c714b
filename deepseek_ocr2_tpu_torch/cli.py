"""CLI of the port: `inspect`, `generate-text`, `generate-ocr`, `debug-rope`,
`serve`, `convert`, `validate-hf` and `train`.

Same flags and defaults as the JAX package's commands of those names,
except `--backend`, which picks cuda (default) or cpu. Crop mode is on by
default: a page with a side above `--crop-image-size` (768) is read as 2-6
local crops plus the global view, unless `--no-crop` is given. `--moe-int8`
(routed experts) and `--int8` (every decode weight) quantize the LM to int8
after loading, `--int4` (every decode weight, group-128 scales) to int4, as
the JAX CLI does; `--int4` wins over the other two. `--temperature > 0`
samples (with `--top-k`, `--top-p`, `--seed`); `--kv-cache int8|int8tail`
selects the quantized paged pools of `serve --continuous` / `--http`
(elsewhere it fails as in the JAX CLI). `--lookup-decode CHUNK` decodes
greedy pages by prompt lookup (`generate-ocr` and every `serve` mode; with
`--temperature > 0` serve notes that it ignores it). `--device-resize
[auto|always|off]` resizes, letterboxes and tiles pages on the device,
bit-equal to PIL ("auto", the flag's bare form, only crop pages; unset, the
`DEEPSEEK_DEVICE_RESIZE` variable decides). `--trim-memory` drops the
weights file from the page cache and trims the heap after loading;
`generate-ocr --profile-dir DIR` writes a torch.profiler trace of the page
into DIR. `convert` rewrites a checkpoint under a dtype policy.
`validate-hf` records (`--emit`) or checks (`--expected`) a transcript of
one greedy page: token ids, embedding fingerprints and step-0 top-10, per
tier with `--tiers bf16,int8,int4`; transcripts of either package are
accepted. `train` fine-tunes the LM trunk with AdamW (packed text or
masked SFT JSONL, `--resume`, `--out`), as the JAX CLI's `train`; `--mesh
dp,mp` trains on dp * mp ranks that it starts itself (`parallel.launch`):
gloo on the CPU and where ranks share a card, NCCL with a GPU a rank.

    python -m deepseek_ocr2_tpu_torch.cli generate-ocr --weights W.safetensors \
        --tokenizer tokenizer.json --image page.png [--device-resize] [--profile-dir DIR]
    python -m deepseek_ocr2_tpu_torch.cli serve --weights W.safetensors \
        --tokenizer tokenizer.json --images p1.png p2.png [--continuous | --http]
    python -m deepseek_ocr2_tpu_torch.cli generate-text --weights W.safetensors \
        --tokenizer tokenizer.json --prompt "..."
    python -m deepseek_ocr2_tpu_torch.cli validate-hf --weights W.safetensors \
        --tokenizer tokenizer.json --image page.png --emit golden.json   # then --expected golden.json
    python -m deepseek_ocr2_tpu_torch.cli convert --weights W.safetensors --out W_bf16.safetensors
    python -m deepseek_ocr2_tpu_torch.cli inspect --weights W.safetensors
    python -m deepseek_ocr2_tpu_torch.cli debug-rope
    python -m deepseek_ocr2_tpu_torch.cli train --weights W.safetensors \
        --tokenizer tokenizer.json --data data.jsonl --steps 100 --out tuned.safetensors
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional, Tuple


def _dtype_arg(value: str) -> str:
    table = {
        "f32": "float32", "float32": "float32",
        "f16": "bfloat16", "float16": "bfloat16",
        "bf16": "bfloat16", "bfloat16": "bfloat16",
    }
    v = value.lower()
    if v not in table:
        raise argparse.ArgumentTypeError(f"invalid dtype {value!r} (f32|f16|bf16)")
    if v in ("f16", "float16"):
        print("note: f16 maps to bf16", file=sys.stderr)
    return table[v]


def _kv_dtype_arg(value: str) -> str:
    if value.lower() in ("int8", "int8tail"):
        return value.lower()
    return _dtype_arg(value)


def _common_gen(sp, vision_default: Optional[str]) -> None:
    """The flags the generation commands share (the JAX CLI's common_gen);
    `vision_default` None is `generate-text`, which has no image flags."""
    sp.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    sp.add_argument("--weights", required=True)
    sp.add_argument("--tokenizer", required=True)
    sp.add_argument("--config", default=None, help="JSON file overriding model config fields")
    sp.add_argument("--max-new-tokens", type=int, default=512 if vision_default else 128)
    sp.add_argument("--eos-token-id", type=int, default=1)
    sp.add_argument("--kv-cache", type=_kv_dtype_arg, default="float32",
                    help="KV cache dtype (f32|f16|bf16); 'int8' / 'int8tail' quantize the paged pool of "
                         "serve --continuous/--http ('int8tail' keeps each slot's newest page exact in bf16)")
    sp.add_argument("--trim-memory", action="store_true")
    sp.add_argument("--moe-int8", action="store_true")
    sp.add_argument("--int8", action="store_true")
    sp.add_argument("--int4", action="store_true")
    sp.add_argument("--lookup-decode", type=int, default=0, metavar="CHUNK",
                    help="prompt-lookup speculative greedy decoding with this chunk width "
                         "(verified drafts, greedy-exact output)")
    sp.add_argument("--device-resize", nargs="?", const="auto", default=None,
                    choices=["auto", "always", "off"],
                    help="resize / letterbox / tile on the device (PIL-bit-exact fixed-point GEMMs) instead of "
                         "host PIL: 'auto' (the bare flag) only crop pages, 'always' every page")
    sp.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    sp.add_argument("--top-k", type=int, default=0)
    sp.add_argument("--top-p", type=float, default=1.0)
    sp.add_argument("--seed", type=int, default=0)
    if vision_default is None:
        return
    sp.add_argument("--no-crop", action="store_true")
    sp.add_argument("--rotate", choices=["0", "90", "180", "270"], default="0")
    sp.add_argument("--auto-rotate", action="store_true")
    sp.add_argument("--no-repeat-ngram-size", type=int, default=20)
    sp.add_argument("--vision-dtype", type=_dtype_arg, default=vision_default)
    sp.add_argument("--lm-dtype", type=_dtype_arg, default="bfloat16")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deepseek-ocr2-torch", description="DeepSeek-OCR-2 on PyTorch + CUDA (Hopper)"
    )
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("inspect", help="List tensors in a .safetensors file")
    sp.add_argument("--weights", required=True)
    sp.add_argument("--take", type=int, default=50, help="entries to print (0 = all)")

    sp = sub.add_parser("generate-text", help="Text-only generation (LM backbone)")
    _common_gen(sp, vision_default=None)
    sp.add_argument("--prompt", required=True)
    sp.add_argument("--num-hidden-layers", type=int, default=12)
    sp.add_argument("--cast-f16", action="store_true", help="run weights in bf16")

    sp = sub.add_parser("debug-rope", help="RoPE numeric sanity check on this backend")
    sp.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    sp.add_argument("--max-seq-len", type=int, default=16)
    sp.add_argument("--head-dim", type=int, default=128)
    sp.add_argument("--seq-len", type=int, default=4)

    sp = sub.add_parser("generate-ocr", help="End-to-end OCR (image + language)")
    _common_gen(sp, vision_default="float32")
    sp.add_argument("--image", required=True)
    sp.add_argument("--prompt", default=None, help="override the OCR prompt")
    sp.add_argument("--image-token-id", type=int, default=128815)
    sp.add_argument("--image-size", type=int, default=1024)
    sp.add_argument("--crop-image-size", type=int, default=768)
    sp.add_argument("--profile-dir", default=None, help="write a torch.profiler trace of the run to this directory")
    sp.add_argument("--sam-dtype", type=_dtype_arg, default=None)
    sp.add_argument("--qwen2-dtype", type=_dtype_arg, default=None)
    sp.add_argument("--projector-dtype", type=_dtype_arg, default=None)
    sp.add_argument("--view-seperator-dtype", type=_dtype_arg, default=None)

    sp = sub.add_parser("serve", help="Batched multi-page OCR over a list of images, or an HTTP API")
    _common_gen(sp, vision_default="bfloat16")
    sp.add_argument("--images", nargs="+", default=[], help="image files")
    sp.add_argument("--http", action="store_true",
                    help="serve POST /v1/ocr over the online continuous engine instead of a fixed image list")
    sp.add_argument("--host", default="127.0.0.1", help="HTTP bind host")
    sp.add_argument("--port", type=int, default=8000, help="HTTP bind port")
    sp.add_argument("--include-token-ids", action="store_true", help="include token ids in HTTP responses")
    sp.add_argument("--batch-size", type=int, default=8)
    sp.add_argument("--continuous", action="store_true",
                    help="continuous batching (slots refill as pages finish; best for long outputs)")
    sp.add_argument("--capacity", type=int, default=2048, help="max tokens per page (continuous)")
    sp.add_argument("--page-size", type=int, default=128, help="KV page size (continuous)")
    sp.add_argument("--pool-tokens", type=int, default=None,
                    help="shared KV pool size in tokens (continuous; default slots * capacity)")
    sp.add_argument("--per-page-stats", action="store_true", help="print per-page phase timings")

    sp = sub.add_parser("convert", help="Re-write a checkpoint with a dtype policy (e.g. cast to bf16)")
    sp.add_argument("--weights", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--dtype", type=_dtype_arg, default="bfloat16")
    sp.add_argument("--keep-f32-prefix", action="append", default=[],
                    help="tensor-name prefix to keep in float32 (repeatable)")

    sp = sub.add_parser("validate-hf", help="Token-exact validation vs a recorded HF transcript (greedy OCR)")
    _common_gen(sp, vision_default="float32")
    sp.add_argument("--image", required=True)
    sp.add_argument("--prompt", default=None)
    sp.add_argument("--image-token-id", type=int, default=128815)
    sp.add_argument("--expected", default=None, help="transcript JSON to validate against (as written by --emit)")
    sp.add_argument("--emit", default=None,
                    help="write the transcript JSON (generated token ids + text + fingerprints) here")
    sp.add_argument("--tiers", default=None,
                    help="comma-separated quantization tiers to validate in one run (subset of bf16,int8,int4): "
                         "token ids, step-0 top-10 and embedding fingerprints per tier")
    sp.add_argument("--fp-rtol", type=float, default=5e-3,
                    help="relative tolerance for fingerprint channels (token ids are always exact)")
    sp.add_argument("--fp-atol", type=float, default=1e-4, help="absolute tolerance for fingerprint channels")

    sp = sub.add_parser("train", help="Fine-tune the LM trunk on a text dataset (AdamW + resume)")
    sp.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    sp.add_argument("--weights", required=True)
    sp.add_argument("--tokenizer", required=True)
    sp.add_argument("--config", default=None, help="JSON model-config overrides")
    sp.add_argument("--num-hidden-layers", type=int, default=None)
    sp.add_argument("--data", required=True,
                    help="JSONL per line: {'text': ...} packed LM loss, or {'prompt': ..., 'completion': ...} "
                         "masked SFT loss; plain text also works")
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--batch-size", type=int, default=4)
    sp.add_argument("--seq-len", type=int, default=512)
    sp.add_argument("--lr", type=float, default=1e-5)
    sp.add_argument("--weight-decay", type=float, default=0.01)
    sp.add_argument("--lr-schedule", choices=["constant", "cosine"], default="constant")
    sp.add_argument("--warmup-steps", type=int, default=0)
    sp.add_argument("--log-file", default=None, help="append per-step JSONL metrics here")
    sp.add_argument("--clip-norm", type=float, default=1.0)
    sp.add_argument("--remat", action="store_true",
                    help="rematerialize MoE layers in the backward (min activation memory; ~1 extra forward "
                         "of FLOPs)")
    sp.add_argument("--grad-accum", type=int, default=1, help="micro-batches per optimizer update")
    sp.add_argument("--eos-token-id", type=int, default=1)
    sp.add_argument("--mesh", default=None,
                    help="dp,mp: train on dp * mp ranks (data parallel over dp; heads, MLP columns, experts and "
                         "vocab split over mp), started by this command")
    sp.add_argument("--save-every", type=int, default=0, help="0 = only at the end")
    sp.add_argument("--state-out", default=None, help="train-state checkpoint path (params+opt+step)")
    sp.add_argument("--resume", default=None, help="train-state checkpoint to resume")
    sp.add_argument("--out", default=None, help="final params as a PyTorch-layout safetensors")
    return p


def _trim_memory(weights_path: str) -> None:
    """Best-effort host memory hygiene after loading (the JAX CLI's
    `_trim_memory`): drop the weights file's pages from the page cache
    (posix_fadvise DONTNEED on that file) and return freed heap to the OS
    (glibc malloc_trim); prints the resident set before and after."""
    import ctypes
    import ctypes.util

    def rss_kb():
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1])
        except OSError:
            pass
        return 0

    before = rss_kb()
    try:
        fd = os.open(weights_path, os.O_RDONLY)
        try:
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)
    except OSError as e:
        print(f"trim-memory: posix_fadvise failed: {e}", file=sys.stderr)
    ret = None
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c"))
        ret = libc.malloc_trim(0)
    except (OSError, AttributeError):
        pass
    after = rss_kb()
    print(f"trim-memory: rss_kb {before}->{after} (d={after - before}), malloc_trim={ret}", file=sys.stderr)


def _sampling_args(args) -> Optional[dict]:
    """The sampling keywords of the flags, None for greedy (the JAX CLI's
    `_sampling_args`, with its checks)."""
    if args.temperature < 0:
        raise SystemExit("error: --temperature must be >= 0 (0 = greedy)")
    if not 0.0 < args.top_p <= 1.0:
        raise SystemExit("error: --top-p must be in (0, 1]")
    if args.temperature == 0.0:
        return None
    return dict(temperature=args.temperature, top_k=args.top_k, top_p=args.top_p, seed=args.seed)


def _device(backend: str):
    """`--backend`'s device; cuda without a GPU exits (no CPU fallback)."""
    import torch

    device = torch.device(backend)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --backend cuda but no CUDA device is available")
    return device


def int8_scope(args) -> Tuple[Optional[str], int]:
    """(scope, bits) of the LM quantization the flags ask for (the JAX CLI's
    `_int8_scope`): ("full", 4) for --int4, ("full", 8) for --int8,
    ("experts", 8) for --moe-int8, else (None, 8)."""
    if args.int4:
        return "full", 4
    if args.int8:
        return "full", 8
    return ("experts" if args.moe_int8 else None), 8


def _load_pipeline(args):
    """Config, weights under the CLI's dtype policy, tokenizer -> OCR2Pipeline
    on `--backend` (cuda without a GPU exits; there is no CPU fallback)."""
    from .configs import OCR2Config, config_from_json
    from .io import DtypePolicy, load_flat
    from .models import deepseek_ocr2 as ocr2
    from .runtime.pipeline import OCR2Pipeline
    from .utils.tokenizer import load_tokenizer

    base_cfg = config_from_json(args.config) if args.config else OCR2Config()
    cfg = dataclasses.replace(
        base_cfg,
        image_token_id=getattr(args, "image_token_id", base_cfg.image_token_id),
        eos_token_id=args.eos_token_id,
    )
    if getattr(args, "image_size", 1024) != 1024:
        cfg = dataclasses.replace(cfg, base_image_size=args.image_size)
    if getattr(args, "crop_image_size", 768) != 768:
        cfg = dataclasses.replace(cfg, crop_image_size=args.crop_image_size)

    vision_default = args.vision_dtype
    policy = DtypePolicy(default=args.lm_dtype)
    for prefix, flag in (
        ("model.sam_model", "sam_dtype"),
        ("model.qwen2_model", "qwen2_dtype"),
        ("model.projector", "projector_dtype"),
        ("model.view_seperator", "view_seperator_dtype"),
    ):
        policy = policy.with_prefix(prefix, getattr(args, flag, None) or vision_default)

    device = _device(args.backend)
    flat = load_flat(args.weights, policy)
    params, report = ocr2.params_from_flat(flat, cfg, device=device)
    print(report.summary(), file=sys.stderr)
    report.raise_on_errors()
    if report.missing:
        raise SystemExit(f"error: {len(report.missing)} tensors missing, e.g. {report.missing[:4]}")
    del flat
    if args.trim_memory:
        _trim_memory(args.weights)
    scope, bits = int8_scope(args)
    if scope:
        from .models.deepseek_v2 import quantize_lm_params

        params = {**params, "lm": quantize_lm_params(params["lm"], scope=scope, bits=bits)}
        print(f"int{bits}: LM weights quantized (scope={scope})", file=sys.stderr)

    act = "float32" if vision_default == "float32" else "bfloat16"
    return OCR2Pipeline(params, cfg, load_tokenizer(args.tokenizer), device=device, kv_dtype=args.kv_cache,
                        act_dtype=act, lookup_chunk=args.lookup_decode,
                        device_resize={"auto": "auto", "always": True, "off": False}.get(args.device_resize))


def cmd_inspect(args) -> int:
    from .io import inspect_safetensors

    rows = inspect_safetensors(args.weights)
    take = args.take if args.take > 0 else len(rows)
    for name, shape, dtype in rows[:take]:
        print(f"{name}\t{list(shape)}\t{dtype}")
    if take < len(rows):
        print(f"... ({len(rows) - take} more)")
    return 0


def cmd_generate_text(args) -> int:
    """As the JAX CLI's generate-text: the LM trunk alone (include_regex),
    stored dtypes unless --cast-f16, activations in the embedding's dtype."""
    import torch

    from .configs import DeepseekV2Config, OCR2Config, config_from_json
    from .io import DtypePolicy, load_flat
    from .models import deepseek_v2 as dsv2
    from .runtime.pipeline import OCR2Pipeline
    from .utils.tokenizer import load_tokenizer

    sampling = _sampling_args(args)
    if args.config:
        lm_cfg = config_from_json(args.config).lm
        if args.num_hidden_layers != 12:
            lm_cfg = dataclasses.replace(lm_cfg, num_hidden_layers=args.num_hidden_layers)
    else:
        lm_cfg = DeepseekV2Config(num_hidden_layers=args.num_hidden_layers)
    device = _device(args.backend)
    policy = DtypePolicy(default="bfloat16" if args.cast_f16 else None)
    flat = load_flat(args.weights, policy, include_regex=[
        r"^model\.embed_tokens\.", r"^model\.layers\.", r"^model\.norm\.", r"^lm_head\.",
    ])
    params, report = dsv2.params_from_flat(flat, lm_cfg, device=device)
    print(report.summary(), file=sys.stderr)
    report.raise_on_errors()
    del flat
    if args.trim_memory:
        _trim_memory(args.weights)
    scope, bits = int8_scope(args)
    if scope:
        params = dsv2.quantize_lm_params(params, scope=scope, bits=bits)
        print(f"int{bits}: LM weights quantized (scope={scope})", file=sys.stderr)
    cfg = OCR2Config(lm=lm_cfg, eos_token_id=args.eos_token_id)
    act = "float32" if params["embed"].dtype == torch.float32 else "bfloat16"
    pipe = OCR2Pipeline({"lm": params}, cfg, load_tokenizer(args.tokenizer), device=device,
                        kv_dtype=args.kv_cache, act_dtype=act, lookup_chunk=args.lookup_decode)
    result = pipe.generate_text(args.prompt, max_new_tokens=args.max_new_tokens, eos_token_id=args.eos_token_id,
                                sampling=sampling)
    print(result.text)
    print(f"[{result.new_tokens} tokens, {result.decode_tokens_per_sec:.1f} tok/s]", file=sys.stderr)
    return 0


def cmd_debug_rope(args) -> int:
    """As the JAX CLI's debug-rope, on the port's ops/rope.py on --backend."""
    import numpy as np
    import torch

    from .ops.rope import apply_rope, rope_cache

    device = _device(args.backend)
    cos, sin = rope_cache(args.max_seq_len, args.head_dim, 10000.0, device=device)
    print(f"cos[0,:4]={cos[0, :4].cpu().numpy()} sin[1,:4]={sin[1, :4].cpu().numpy()}")
    for name, dtype in (("zeros", torch.float32), ("f32", torch.float32), ("bf16", torch.bfloat16)):
        shape = (1, 1, args.seq_len, args.head_dim)
        if name == "zeros":
            x = torch.zeros(shape, dtype=dtype, device=device)
        else:
            x = torch.arange(int(np.prod(shape)), dtype=torch.float32, device=device).reshape(shape).to(dtype) / 100.0
        q, k = apply_rope(x, x, cos, sin, 0)
        nan_q, nan_k = int(torch.isnan(q).sum()), int(torch.isnan(k).sum())
        print(f"{name}: nan_q={nan_q} nan_k={nan_k} q[0,0,0,:3]={q[0, 0, 0, :3].cpu().numpy()}")
    return 0


def cmd_generate_ocr(args) -> int:
    from .utils.profiling import device_trace

    sampling = _sampling_args(args)
    pipe = _load_pipeline(args)
    with device_trace(args.profile_dir):
        result = pipe.generate_ocr(
            args.image,
            prompt=args.prompt,
            max_new_tokens=args.max_new_tokens,
            no_crop=args.no_crop,
            rotate=int(args.rotate),
            auto_rotate=args.auto_rotate,
            ngram_size=args.no_repeat_ngram_size,
            eos_token_id=args.eos_token_id,
            sampling=sampling,
        )
    print(result.text)
    print(
        f"[vision {result.vision_seconds * 1e3:.0f} ms, prefill {result.prefill_seconds * 1e3:.0f} ms, "
        f"{result.new_tokens} tokens, {result.decode_tokens_per_sec:.1f} tok/s]",
        file=sys.stderr,
    )
    return 0


def cmd_serve(args) -> int:
    """As `deepseek_ocr2_tpu.cli serve`: the group engine over --images, the
    continuous engine with --continuous, or the HTTP front end over the
    online continuous engine with --http (slots = --batch-size)."""
    import time

    if not args.http and not args.images:
        print("error: --images is required unless --http is set", file=sys.stderr)
        return 2
    sampling = _sampling_args(args)
    pipe = _load_pipeline(args)
    lookup_chunk = args.lookup_decode
    if lookup_chunk and (sampling or {}).get("temperature", 0.0) != 0.0:
        print("note: --lookup-decode requires greedy decoding; ignoring it because --temperature > 0",
              file=sys.stderr)
        lookup_chunk = 0
    if args.http or args.continuous:
        from .runtime.continuous import ContinuousOCREngine

        engine = ContinuousOCREngine(pipe, slots=args.batch_size, capacity=args.capacity,
                                     page_size=args.page_size, pool_tokens=args.pool_tokens,
                                     lookup_chunk=lookup_chunk)
    else:
        from .runtime.engine import OCR2Engine

        engine = OCR2Engine(pipe, batch_size=args.batch_size)
    if args.http:
        from .runtime.http_server import OCRHttpServer

        engine.start(ngram_size=args.no_repeat_ngram_size, sampling=sampling)
        server = OCRHttpServer(engine, host=args.host, port=args.port, include_token_ids=args.include_token_ids)
        print(f"serving OCR at http://{args.host}:{server.port}/v1/ocr (slots={args.batch_size}, "
              f"lookup={lookup_chunk or 'off'}); Ctrl-C to stop", file=sys.stderr)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()
            engine.stop(timeout=120)
        return 0
    t0 = time.perf_counter()
    results = engine.run(
        args.images,
        max_new_tokens=args.max_new_tokens,
        no_crop=args.no_crop,
        rotate=int(args.rotate),
        auto_rotate=args.auto_rotate,
        ngram_size=args.no_repeat_ngram_size,
        sampling=sampling,
    )
    dt = time.perf_counter() - t0
    for path, res in zip(args.images, results):
        print(f"=== {path} ===")
        print(res.text)
        if args.per_page_stats:
            print(f"  [prefill {res.prefill_seconds * 1e3:.0f} ms, decode {res.decode_seconds * 1e3:.0f} ms, "
                  f"{res.new_tokens} tokens]", file=sys.stderr)
    print(f"[{len(args.images)} pages in {dt:.2f}s = {len(args.images) / dt:.2f} pages/s]", file=sys.stderr)
    if args.continuous and getattr(engine, "last_lookup_forwards", 0):
        # A page's first token comes from its admission's prefill, not a chunk forward.
        chunk_tokens = sum(r.new_tokens - 1 for r in results if r is not None)
        print(f"[lookup: {chunk_tokens} tokens / {engine.last_lookup_forwards} chunk forwards = "
              f"{chunk_tokens / engine.last_lookup_forwards:.2f} tok/forward]", file=sys.stderr)
    return 0


def cmd_validate_hf(args) -> int:
    """Golden-fingerprint harness for real-checkpoint bring-up (the JAX
    CLI's `validate-hf`). With --emit: one greedy OCR page recorded as a
    transcript (generated ids + text, the embedding slices at positions
    0/1/last/289/545, step-0 top-10; `runtime/validate.py`). With
    --expected: the page again, compared in causal order (embeddings ->
    step-0 logits -> token ids), so the first FAIL line names the earliest
    diverging stage. The golden transcript can come from either package's
    --emit or from a debug-channel log through
    tools/transcript_from_debug_log.py."""
    import json

    from .runtime.validate import collect_transcript, compare_transcripts

    if args.lookup_decode:
        # Validation runs the plain one-token greedy path: speculative chunks
        # round the GEMMs at another width.
        print("note: --lookup-decode is ignored for validate-hf", file=sys.stderr)
        args.lookup_decode = 0
    # The parity channels always print (the reference's fingerprint lines).
    os.environ.setdefault("DEEPSEEK_DEBUG_OCR", "1")

    def collect(pipe):
        return collect_transcript(pipe, args.image, prompt=args.prompt, max_new_tokens=args.max_new_tokens,
                                  no_crop=args.no_crop, rotate=int(args.rotate), auto_rotate=args.auto_rotate,
                                  ngram_size=args.no_repeat_ngram_size, eos_token_id=args.eos_token_id)

    if args.tiers:
        # Each tier reloads (and quantizes) the checkpoint and records its own
        # ids, step-0 top-10 and fingerprints.
        names = [t.strip() for t in args.tiers.split(",") if t.strip()]
        bad = [n for n in names if n not in ("bf16", "int8", "int4")]
        if bad:
            print(f"unknown tier(s) {bad}; valid: bf16,int8,int4", file=sys.stderr)
            return 2
        tiers = {}
        for name in names:
            targs = argparse.Namespace(**vars(args))
            targs.int8, targs.int4, targs.moe_int8 = name == "int8", name == "int4", False
            print(f"--- tier {name} ---", file=sys.stderr)
            tiers[name] = {**collect(_load_pipeline(targs)), "tier": name}
        transcript = {"version": 2, "tiers": tiers}
        n_tok = {n: len(t["generated_ids"]) for n, t in tiers.items()}
    else:
        transcript = collect(_load_pipeline(args))
        n_tok = len(transcript["generated_ids"])
    if args.emit:
        with open(args.emit, "w") as f:
            json.dump(transcript, f, indent=1)
        print(f"wrote transcript ({n_tok} tokens) to {args.emit}")
    if args.expected:
        with open(args.expected) as f:
            want = json.load(f)
        ok, lines = compare_transcripts(transcript, want, rtol=args.fp_rtol, atol=args.fp_atol)
        for line in lines:
            print(line)
        if ok:
            print(f"PASS: token-exact ({n_tok} tokens)")
            return 0
        print("hint: re-run with DEEPSEEK_DEBUG_TOPK=1 for per-step top-10 logits")
        return 1
    if not args.emit:
        if args.tiers:
            for name, t in transcript["tiers"].items():
                print(f"[{name}] {t['text']}")
        else:
            print(transcript["text"])
    return 0


def cmd_convert(args) -> int:
    """As the JAX CLI's `convert`: every tensor through the dtype policy
    (`--dtype`, `--keep-f32-prefix` kept in f32), written back."""
    from .io import DtypePolicy, load_flat, save_flat

    policy = DtypePolicy(default=args.dtype)
    for prefix in args.keep_f32_prefix:
        policy = policy.with_prefix(prefix, "float32")
    flat = load_flat(args.weights, policy)
    save_flat(flat, args.out)
    print(f"wrote {len(flat)} tensors to {args.out}", file=sys.stderr)
    return 0


def _train_data(args, tokenizer):
    """The JAX CLI's dataset: packed text (one token stream, EOS after each
    line) or prompt/completion pairs (loss on the completion and EOS),
    never both. Returns (batch_at(step) -> (ids [B, S], mask [B, S] or
    None) as numpy arrays, a description for the log)."""
    import json

    import numpy as np

    stream, sft_examples = [], []
    with open(args.data) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            sft = None
            text = line
            if line.startswith("{"):
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    obj = None
                if obj is not None:
                    if isinstance(obj.get("prompt"), str) and isinstance(obj.get("completion"), str):
                        sft = (obj["prompt"], obj["completion"])
                    else:
                        text = obj.get("text")
                        if not isinstance(text, str):
                            raise SystemExit(
                                f"error: {args.data}:{lineno}: JSONL line has neither a string \"text\" field "
                                f'nor "prompt"+"completion" fields (keys: {sorted(obj)})')
            if sft is None:
                stream.extend(tokenizer.encode(text, add_special_tokens=False).ids)
                stream.append(args.eos_token_id)
                continue
            p_ids = tokenizer.encode(sft[0], add_special_tokens=False).ids
            c_ids = tokenizer.encode(sft[1], add_special_tokens=False).ids
            if len(p_ids) >= args.seq_len:
                raise SystemExit(f"error: {args.data}:{lineno}: prompt alone is {len(p_ids)} tokens >= --seq-len "
                                 f"{args.seq_len}; no completion tokens would carry loss")
            ex = (p_ids + c_ids + [args.eos_token_id])[: args.seq_len]
            m = ([0] * len(p_ids) + [1] * (len(c_ids) + 1))[: args.seq_len]
            pad = args.seq_len - len(ex)
            sft_examples.append((np.asarray(ex + [0] * pad, np.int64), np.asarray(m + [0] * pad, np.float32)))
    if stream and sft_examples:
        raise SystemExit(f"error: {args.data} mixes 'text' and 'prompt'/'completion' lines")
    if sft_examples:
        ex_ids = np.stack([e[0] for e in sft_examples])
        ex_mask = np.stack([e[1] for e in sft_examples])
        n_ex = len(sft_examples)

        def batch_at(step: int):
            idx = (np.arange(args.batch_size) + step * args.batch_size) % n_ex
            return ex_ids[idx], ex_mask[idx]

        cycled = args.steps * args.batch_size > n_ex
        return batch_at, (f"{n_ex} prompt/completion examples -> {args.steps} steps of "
                          f"[{args.batch_size}, {args.seq_len}] (masked SFT loss)" + (" (cycled)" if cycled else ""))
    if not stream:
        raise SystemExit(f"error: no tokens in {args.data}")
    stream_np = np.asarray(stream, np.int64)
    bs = args.batch_size * args.seq_len

    def batch_at(step: int):
        idx = (np.arange(bs, dtype=np.int64) + step * bs) % len(stream_np)
        return stream_np[idx].reshape(args.batch_size, args.seq_len), None

    cycled = args.steps * bs > len(stream_np)
    return batch_at, (f"{len(stream_np)} tokens -> {args.steps} steps of [{args.batch_size}, {args.seq_len}]"
                      + (" (cycled)" if cycled else ""))


def cmd_train(args) -> int:
    """LM fine-tuning, as the JAX CLI's `train`: packed next-token CE or
    masked SFT, AdamW with global-norm clipping, full-state checkpoints.
    The step is `runtime/train.py`'s; on the card its MoE layers above 512
    rows run kernels D and E forward and E, S and T backward. `--mesh
    dp,mp` starts dp * mp ranks (`parallel.launch`), each running
    `_train_rank`; a failed rank fails the command."""
    from .configs import DeepseekV2Config, config_from_json

    lm_cfg = config_from_json(args.config).lm if args.config else DeepseekV2Config()
    if args.num_hidden_layers:
        lm_cfg = dataclasses.replace(lm_cfg, num_hidden_layers=args.num_hidden_layers)
    device = _device(args.backend)
    if not args.mesh:
        _train(args, lm_cfg, device, None)
        return 0
    from .parallel.launch import launch
    from .parallel.sharding import check_mp

    try:
        dp, mp = (int(v) for v in args.mesh.split(","))
    except ValueError:
        raise SystemExit(f"error: --mesh takes dp,mp (two integers), got {args.mesh!r}")
    if args.batch_size % dp:
        raise SystemExit(f"error: --batch-size must be divisible by dp={dp}")
    try:
        check_mp(lm_cfg, mp)
    except ValueError as e:
        raise SystemExit(f"error: --mesh {args.mesh}: {e}")
    if os.environ.get("RANK", "0") == "0":  # under torchrun every rank runs this
        print(f"mesh: dp={dp} mp={mp} ({dp * mp} devices)", file=sys.stderr)
    try:
        launch(_train_rank, dp * mp, (args, lm_cfg, dp, mp), device_type=device.type, kernels=("moe_gmm",))
    except RuntimeError as e:
        raise SystemExit(f"error: train --mesh {args.mesh}: {e}")
    return 0


def _train_rank(rank: int, world: int, device, args, lm_cfg, dp: int, mp: int) -> None:
    """One rank of `train --mesh dp,mp`: its mesh, then `_train`."""
    from .parallel.mesh import make_mesh

    _train(args, lm_cfg, device, make_mesh(dp, mp, device=device))


def _train(args, lm_cfg, device, mesh) -> None:
    """The train command's body on one process, or on one rank of a mesh:
    the rank's shards of the weights, its dp rows of every batch; only the
    mesh's first rank prints the step lines and writes the log, the state
    file (whole leaves, gathered) and `--out`."""
    import json
    import time

    import torch

    from .io import DtypePolicy, load_flat, save_flat
    from .models import deepseek_v2 as dsv2
    from .parallel.mesh import dp_rows
    from .parallel.sharding import gather_params, lm_param_specs, shard_params
    from .runtime.train import (adamw_sft_train_step, adamw_train_step, load_train_state, make_optimizer,
                                save_train_state)
    from .utils.tokenizer import load_tokenizer

    lead = mesh is None or mesh.rank == 0
    flat = load_flat(args.weights, DtypePolicy(default=None), include_regex=[
        r"^model\.embed_tokens\.", r"^model\.layers\.", r"^model\.norm\.", r"^lm_head\.",
    ])
    params, report = dsv2.params_from_flat(flat, lm_cfg, device="cpu" if mesh is not None else device)
    if lead:
        print(report.summary(), file=sys.stderr)
    report.raise_on_errors()
    if report.missing:
        raise SystemExit(f"error: {len(report.missing)} tensors missing, e.g. {report.missing[:4]}")
    del flat
    if mesh is not None:
        params = shard_params(params, mesh, lm_param_specs(lm_cfg))

    batch_at, described = _train_data(args, load_tokenizer(args.tokenizer))
    if lead:
        print(f"dataset: {described}", file=sys.stderr)
    tx = make_optimizer(lr=args.lr, weight_decay=args.weight_decay, clip_norm=args.clip_norm,
                        grad_accum=args.grad_accum, schedule=args.lr_schedule, warmup_steps=args.warmup_steps,
                        total_steps=args.steps)
    opt_state = tx.init(params)
    start_step = 0
    if args.resume:
        start_step = load_train_state(args.resume, params, opt_state)
        if lead:
            print(f"resumed from {args.resume} at step {start_step}", file=sys.stderr)

    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        ids_np, mask_np = batch_at(step)
        ids = dp_rows(torch.from_numpy(ids_np), mesh).to(device)
        if mask_np is not None:
            mask = dp_rows(torch.from_numpy(mask_np), mesh).to(device)
            loss = adamw_sft_train_step(params, opt_state, lm_cfg, ids, mask, tx, remat=args.remat)
        else:
            loss = adamw_train_step(params, opt_state, lm_cfg, ids, tx, remat=args.remat)
        loss_v = float(loss)  # also the step barrier
        dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        if lead:
            print(f"step {step + 1}/{args.steps}  loss {loss_v:.4f}  {dt * 1e3:.0f} ms", flush=True)
        if lead and args.log_file:
            with open(args.log_file, "a") as lf:
                lf.write(json.dumps({"step": step + 1, "loss": loss_v, "ms": round(dt * 1e3, 1)}) + "\n")
        if args.state_out and args.save_every and (step + 1) % args.save_every == 0:
            save_train_state(args.state_out, params, opt_state, step + 1)
            if lead:
                print(f"  saved {args.state_out}", file=sys.stderr)
    if args.state_out:
        save_train_state(args.state_out, params, opt_state, args.steps)
        if lead:
            print(f"saved train state: {args.state_out}", file=sys.stderr)
    if args.out:
        whole = gather_params(params)
        if lead:
            save_flat(dsv2.flat_from_params(whole, lm_cfg), args.out)
            print(f"saved params: {args.out}", file=sys.stderr)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "inspect":
        return cmd_inspect(args)
    if args.command == "generate-text":
        return cmd_generate_text(args)
    if args.command == "debug-rope":
        return cmd_debug_rope(args)
    if args.command == "generate-ocr":
        return cmd_generate_ocr(args)
    if args.command == "serve":
        return cmd_serve(args)
    if args.command == "convert":
        return cmd_convert(args)
    if args.command == "validate-hf":
        return cmd_validate_hf(args)
    if args.command == "train":
        return cmd_train(args)
    raise SystemExit(f"unknown command {args.command}")


if __name__ == "__main__":
    sys.exit(main())
