#!/usr/bin/env python3
"""Where the device resize's time goes (deepseek_ocr2_tpu_torch/preprocess/device_resize.py), on one GPU.

    python3 scripts/torch_resize_profile.py

For chip_smoke's two pages (the (2, 3) crop page 1700 x 2200 and the no-crop
page 700 x 500) it prints:
- `device_preprocess_page` under torch.profiler after a warm-up: host wall
  time, summed device kernel time, the device idle share and the kernels
  that take the most device time;
- the median of 10 CUDA-event timings of: the whole call (ship + resize),
  the resize of an already shipped page, the call's four f32 GEMMs alone at
  their shapes, and host PIL (median of 10 host timings);
- the same resize with the pass GEMM on bf16 operands and an f32 result
  (`torch.mm(..., out_dtype=torch.float32)`, where this torch build has it
  on CUDA), its time and whether it is bit-equal to PIL.
Numbers are the card's own; print them with its name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def gemm_shapes(w: int, h: int, base: int, crop: int, ratio):
    """(M, K, N) of each pass GEMM of `device_preprocess_page` on a w x h page."""
    from deepseek_ocr2_tpu_torch.preprocess.device_resize import BUCKET

    hb, wb = -(-h // BUCKET) * BUCKET, -(-w // BUCKET) * BUCKET
    outs = [(base, base)] + ([(crop * ratio[0], crop * ratio[1])] if ratio else [])
    return [shape for ow, oh in outs for shape in ((3 * hb, wb, 3 * ow), (3 * ow, hb, 3 * oh))]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_resize_profile: no CUDA device", file=sys.stderr)
        return 1
    from PIL import Image  # noqa: F401  (the pages and the oracle)
    from torch.profiler import ProfilerActivity, profile

    import deepseek_ocr2_tpu_torch  # noqa: F401  (TF32 off)
    from deepseek_ocr2_tpu_torch.configs import OCR2Config
    from deepseek_ocr2_tpu_torch.preprocess import device_resize as dr
    from deepseek_ocr2_tpu_torch.preprocess.image import preprocess_base_u8, preprocess_tiles_u8

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)
    cfg = OCR2Config()
    s, c, pad = cfg.base_image_size, cfg.crop_image_size, cfg.pad_color
    w, h, grid = cs.CROP_PAGES[1]
    pages = [(f"{w}x{h} crop", cs.synthetic_page(w, h, cfg, seed=11, grid=grid)[0], grid),
             (f"{cs.PAGES[0][0]}x{cs.PAGES[0][1]}", cs.synthetic_page(*cs.PAGES[0], cfg, seed=0)[0], None)]

    def fixed_pass_bf16(x_u8, m, out_size):
        p = torch.mm(x_u8.reshape(-1, x_u8.shape[-1]).to(torch.bfloat16), m.to(torch.bfloat16),
                     out_dtype=torch.float32)
        p = p.to(torch.int32).reshape(*x_u8.shape[:-1], 3, out_size)
        ss = (p[..., 0, :] << 16) + (p[..., 1, :] << 8) + p[..., 2, :] + dr._ROUND
        return (ss.clamp(0, dr._CLIP_HI) >> dr.PRECISION_BITS).to(torch.uint8)

    for name, page, ratio in pages:
        arr = np.asarray(page)
        run = lambda: dr.device_preprocess_page(arr, s, c, ratio, pad, device=dev)  # noqa: E731
        run()
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in rows) / 1e6
        print(f"[resize] {name}: profiled call wall {wall * 1e3:.3f} ms, device kernels {busy * 1e3:.3f} ms, "
              f"device idle share {max(0.0, 1 - busy / wall):.3f}")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"[resize]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:100]}")

        shipped = dr.ship_image(arr, dev)

        def resize_only():
            if ratio:
                dr.device_tiles_u8(shipped, arr.shape[1], arr.shape[0], c, ratio)
            dr.device_letterbox_u8(shipped, arr.shape[1], arr.shape[0], s, pad)

        shapes = gemm_shapes(arr.shape[1], arr.shape[0], s, c, ratio)
        mats = [(torch.randint(0, 256, (m, k), device=dev).float(), torch.randint(-128, 129, (k, n), device=dev).float())
                for m, k, n in shapes]
        flops = sum(2 * m * k * n for m, k, n in shapes)
        gemm_ms = cs.median_ms(lambda: [a @ b for a, b in mats])
        host = []
        for _ in range(10):
            t0 = time.perf_counter()
            preprocess_base_u8(page, s, pad)
            if ratio:
                preprocess_tiles_u8(page, c, ratio)
            host.append((time.perf_counter() - t0) * 1e3)
        print(f"[resize] {name}: whole call {cs.median_ms(run):.3f} ms, resize alone {cs.median_ms(resize_only):.3f} "
              f"ms, its {len(shapes)} f32 GEMMs {shapes} alone {gemm_ms:.3f} ms ({flops / gemm_ms / 1e9:.1f} "
              f"TFLOP/s over {flops / 1e9:.1f} GFLOP); host PIL {float(np.median(host)):.3f} ms")
        del mats

        want_base = preprocess_base_u8(page, s, pad)
        want_tiles = preprocess_tiles_u8(page, c, ratio) if ratio else None
        f32_pass = dr._fixed_pass
        try:
            dr._fixed_pass = fixed_pass_bf16
            base, tiles = run()
            same = np.array_equal(base.cpu().numpy(), want_base) and (
                ratio is None or np.array_equal(tiles.cpu().numpy(), want_tiles))
            print(f"[resize] {name}: bf16 operands, f32 result (torch.mm out_dtype): {cs.median_ms(run):.3f} ms, "
                  f"resize alone {cs.median_ms(resize_only):.3f} ms, bit-equal to PIL {same}")
        except (RuntimeError, TypeError, NotImplementedError) as exc:
            print(f"[resize] {name}: bf16 operands with an f32 result unavailable here: {str(exc).splitlines()[0][:160]}")
        finally:
            dr._fixed_pass = f32_pass
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
