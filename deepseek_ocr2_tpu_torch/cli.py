"""CLI of the port: `generate-ocr`.

Same flags and defaults as `deepseek_ocr2_tpu.cli generate-ocr`, except
`--backend`, which picks cuda (default) or cpu. Crop mode is on by default:
a page with a side above `--crop-image-size` (768) is read as 2-6 local
crops plus the global view, unless `--no-crop` is given. Flags for features
the port does not have yet (quantized tiers, lookup decoding, device resize,
sampling, profiling) raise a clear error instead of being ignored.

    python -m deepseek_ocr2_tpu_torch.cli generate-ocr --weights W.safetensors \
        --tokenizer tokenizer.json --image page.png
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional


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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="deepseek-ocr2-torch", description="DeepSeek-OCR-2 on PyTorch + CUDA (Hopper)"
    )
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser("generate-ocr", help="End-to-end OCR (image + language)")
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
    sp.add_argument("--image", required=True)
    sp.add_argument("--prompt", default=None, help="override the OCR prompt")
    sp.add_argument("--image-token-id", type=int, default=128815)
    sp.add_argument("--image-size", type=int, default=1024)
    sp.add_argument("--no-crop", action="store_true")
    sp.add_argument("--rotate", choices=["0", "90", "180", "270"], default="0")
    sp.add_argument("--auto-rotate", action="store_true")
    sp.add_argument("--crop-image-size", type=int, default=768)
    sp.add_argument("--no-repeat-ngram-size", type=int, default=20)
    sp.add_argument("--profile-dir", default=None)
    sp.add_argument("--vision-dtype", type=_dtype_arg, default="float32")
    sp.add_argument("--sam-dtype", type=_dtype_arg, default=None)
    sp.add_argument("--qwen2-dtype", type=_dtype_arg, default=None)
    sp.add_argument("--projector-dtype", type=_dtype_arg, default=None)
    sp.add_argument("--view-seperator-dtype", type=_dtype_arg, default=None)
    sp.add_argument("--lm-dtype", type=_dtype_arg, default="bfloat16")
    return p


def _refuse_outside_slice(args) -> None:
    refused = [
        (args.int8 or args.int4 or args.moe_int8, "--int8/--int4/--moe-int8 (quantized tiers)"),
        (args.lookup_decode > 0, "--lookup-decode"),
        (args.device_resize is not None, "--device-resize"),
        (args.temperature != 0.0, "--temperature > 0 (sampling)"),
        (args.profile_dir is not None, "--profile-dir"),
        (args.trim_memory, "--trim-memory"),
    ]
    for hit, flag in refused:
        if hit:
            raise SystemExit(f"error: {flag} is not available in the PyTorch port yet (see ROADMAP.md)")


def cmd_generate_ocr(args) -> int:
    import torch

    from .configs import OCR2Config, config_from_json
    from deepseek_ocr2_tpu.utils.tokenizer import load_tokenizer

    from .io import DtypePolicy, load_flat
    from .models import deepseek_ocr2 as ocr2
    from .runtime.pipeline import OCR2Pipeline

    _refuse_outside_slice(args)
    kv = _dtype_arg(args.kv_cache)
    base_cfg = config_from_json(args.config) if args.config else OCR2Config()
    cfg = dataclasses.replace(
        base_cfg, image_token_id=args.image_token_id, eos_token_id=args.eos_token_id
    )
    if args.image_size != 1024:
        cfg = dataclasses.replace(cfg, base_image_size=args.image_size)
    if args.crop_image_size != 768:
        cfg = dataclasses.replace(cfg, crop_image_size=args.crop_image_size)

    vision_default = args.vision_dtype
    policy = DtypePolicy(default=args.lm_dtype)
    for prefix, dtype in (
        ("model.sam_model", args.sam_dtype or vision_default),
        ("model.qwen2_model", args.qwen2_dtype or vision_default),
        ("model.projector", args.projector_dtype or vision_default),
        ("model.view_seperator", args.view_seperator_dtype or vision_default),
    ):
        policy = policy.with_prefix(prefix, dtype)

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

    act = "float32" if vision_default == "float32" else "bfloat16"
    pipe = OCR2Pipeline(
        params, cfg, load_tokenizer(args.tokenizer), device=device, kv_dtype=kv, act_dtype=act
    )
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


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "generate-ocr":
        return cmd_generate_ocr(args)
    raise SystemExit(f"unknown command {args.command}")


if __name__ == "__main__":
    sys.exit(main())
