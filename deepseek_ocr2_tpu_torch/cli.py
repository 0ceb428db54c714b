"""CLI of the port: `generate-ocr` and `serve`.

Same flags and defaults as `deepseek_ocr2_tpu.cli generate-ocr` and
`serve`, except `--backend`, which picks cuda (default) or cpu. Crop mode is on by default:
a page with a side above `--crop-image-size` (768) is read as 2-6 local
crops plus the global view, unless `--no-crop` is given. `--moe-int8`
(routed experts) and `--int8` (every decode weight) quantize the LM to int8
after loading, `--int4` (every decode weight, group-128 scales) to int4, as
the JAX CLI does; `--int4` wins over the other two. Flags for features the
port does not have yet (the int8 KV pools, lookup decoding, device resize,
sampling, profiling) raise a clear error instead of being ignored.

    python -m deepseek_ocr2_tpu_torch.cli generate-ocr --weights W.safetensors \
        --tokenizer tokenizer.json --image page.png
    python -m deepseek_ocr2_tpu_torch.cli serve --weights W.safetensors \
        --tokenizer tokenizer.json --images p1.png p2.png [--continuous | --http]
"""

from __future__ import annotations

import argparse
import dataclasses
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


def _common_gen(sp, vision_default: str) -> None:
    """The flags `generate-ocr` and `serve` share (the JAX CLI's common_gen)."""
    sp.add_argument("--backend", choices=["cuda", "cpu"], default="cuda")
    sp.add_argument("--weights", required=True)
    sp.add_argument("--tokenizer", required=True)
    sp.add_argument("--config", default=None, help="JSON file overriding model config fields")
    sp.add_argument("--max-new-tokens", type=int, default=512)
    sp.add_argument("--eos-token-id", type=int, default=1)
    sp.add_argument("--kv-cache", default="float32", help="KV cache dtype (f32|f16|bf16)")
    sp.add_argument("--trim-memory", action="store_true")
    sp.add_argument("--moe-int8", action="store_true")
    sp.add_argument("--int8", action="store_true")
    sp.add_argument("--int4", action="store_true")
    sp.add_argument("--lookup-decode", type=int, default=0, metavar="CHUNK")
    sp.add_argument("--device-resize", nargs="?", const="auto", default=None,
                    choices=["auto", "always", "off"])
    sp.add_argument("--temperature", type=float, default=0.0, help="0 = greedy")
    sp.add_argument("--top-k", type=int, default=0)
    sp.add_argument("--top-p", type=float, default=1.0)
    sp.add_argument("--seed", type=int, default=0)
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
    sp = sub.add_parser("generate-ocr", help="End-to-end OCR (image + language)")
    _common_gen(sp, vision_default="float32")
    sp.add_argument("--image", required=True)
    sp.add_argument("--prompt", default=None, help="override the OCR prompt")
    sp.add_argument("--image-token-id", type=int, default=128815)
    sp.add_argument("--image-size", type=int, default=1024)
    sp.add_argument("--crop-image-size", type=int, default=768)
    sp.add_argument("--profile-dir", default=None)
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
    return p


_NEXT_SLICE = "it belongs to the next slice: the int8 / int8tail KV pools and sample_pick"


def _refuse_outside_slice(args) -> None:
    refused = [
        (args.kv_cache.lower() in ("int8", "int8tail"), "--kv-cache int8/int8tail", _NEXT_SLICE),
        (args.lookup_decode > 0, "--lookup-decode", "see ROADMAP.md"),
        (args.device_resize is not None, "--device-resize", "see ROADMAP.md"),
        (args.temperature != 0.0, "--temperature > 0 (sampling)", _NEXT_SLICE),
        (getattr(args, "profile_dir", None) is not None, "--profile-dir", "see ROADMAP.md"),
        (args.trim_memory, "--trim-memory", "see ROADMAP.md"),
    ]
    for hit, flag, where in refused:
        if hit:
            raise SystemExit(f"error: {flag} is not available in the PyTorch port yet ({where})")


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
    import torch

    from .configs import OCR2Config, config_from_json

    from .io import DtypePolicy, load_flat
    from .models import deepseek_ocr2 as ocr2
    from .runtime.pipeline import OCR2Pipeline
    from .utils.tokenizer import load_tokenizer

    _refuse_outside_slice(args)
    kv = _dtype_arg(args.kv_cache)
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

    device = torch.device(args.backend)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("error: --backend cuda but no CUDA device is available")
    flat = load_flat(args.weights, policy)
    params, report = ocr2.params_from_flat(flat, cfg, device=device)
    print(report.summary(), file=sys.stderr)
    report.raise_on_errors()
    if report.missing:
        raise SystemExit(f"error: {len(report.missing)} tensors missing, e.g. {report.missing[:4]}")
    del flat
    scope, bits = int8_scope(args)
    if scope:
        from .models.deepseek_v2 import quantize_lm_params

        params = {**params, "lm": quantize_lm_params(params["lm"], scope=scope, bits=bits)}
        print(f"int{bits}: LM weights quantized (scope={scope})", file=sys.stderr)

    act = "float32" if vision_default == "float32" else "bfloat16"
    return OCR2Pipeline(params, cfg, load_tokenizer(args.tokenizer), device=device, kv_dtype=kv, act_dtype=act)


def cmd_generate_ocr(args) -> int:
    pipe = _load_pipeline(args)
    result = pipe.generate_ocr(
        args.image,
        prompt=args.prompt,
        max_new_tokens=args.max_new_tokens,
        no_crop=args.no_crop,
        rotate=int(args.rotate),
        auto_rotate=args.auto_rotate,
        ngram_size=args.no_repeat_ngram_size,
        eos_token_id=args.eos_token_id,
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
    pipe = _load_pipeline(args)
    if args.http or args.continuous:
        from .runtime.continuous import ContinuousOCREngine

        engine = ContinuousOCREngine(pipe, slots=args.batch_size, capacity=args.capacity,
                                     page_size=args.page_size, pool_tokens=args.pool_tokens)
    else:
        from .runtime.engine import OCR2Engine

        engine = OCR2Engine(pipe, batch_size=args.batch_size)
    if args.http:
        from .runtime.http_server import OCRHttpServer

        engine.start(ngram_size=args.no_repeat_ngram_size)
        server = OCRHttpServer(engine, host=args.host, port=args.port, include_token_ids=args.include_token_ids)
        print(f"serving OCR at http://{args.host}:{server.port}/v1/ocr (slots={args.batch_size}); "
              "Ctrl-C to stop", file=sys.stderr)
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
    )
    dt = time.perf_counter() - t0
    for path, res in zip(args.images, results):
        print(f"=== {path} ===")
        print(res.text)
        if args.per_page_stats:
            print(f"  [prefill {res.prefill_seconds * 1e3:.0f} ms, decode {res.decode_seconds * 1e3:.0f} ms, "
                  f"{res.new_tokens} tokens]", file=sys.stderr)
    print(f"[{len(args.images)} pages in {dt:.2f}s = {len(args.images) / dt:.2f} pages/s]", file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "generate-ocr":
        return cmd_generate_ocr(args)
    if args.command == "serve":
        return cmd_serve(args)
    raise SystemExit(f"unknown command {args.command}")


if __name__ == "__main__":
    sys.exit(main())
