"""Where kernels V and B (SAM's windowed and global rel-pos attention,
`csrc/flash_attention.cu` `attn_tc_kernel` in modes RELWIN and RELPOS)
spend their time: each variant changes one part of the source in a copy of
the package and times the kernels again through their wrappers in a CUDA
graph: V at SAM's window shapes ([25, 12, 196, 64] and [96, 12, 196, 64],
win = valid = 14) in bf16 and f32, and B in bf16 at SAM's four shapes (the
1024^2 view's global [1, 12, 4096, 64] and windows [25, 12, 196, 64], six
crops' global [6, 12, 2304, 64] and windows [96, 12, 196, 64]), with SDPA
given the bias beside each (variant `none`). Each line gives the error
against the plain twin beside the bf16 tolerance (4 ulps of max |ref|).

Variants (each a text patch of the source; the script stops if the source
no longer holds the text it patches):
- `none`: the kernels as they are;
- `no_relrows`: V's blocks build no rel rows (the win rel-h and rel-w dot
  products from the tables): the time of that prologue;
- `no_bias`: no score reads its bias from the staged rows (V and B);
- `no_qk`: bf16 only, no Q K^T product (the scores are the bias alone);
- `no_pv`: bf16 only, no P V product;
- `one_part_p`: bf16 only, P rounded to bf16 once and P V one product
  (what SDPA and the TPU kernel's single-pass dot do), in place of the two
  parts lo V + hi V: right within the bf16 tolerance or not, its error
  says;
- `one_block`: bf16 at one block an SM (no register cap) instead of two;
- `keys64`, `keys64_one_block`: 64 keys a warp a step (128 a block), in
  place of 32, at two and at one block an SM (f32 spills: only bf16's
  times mean anything);
- `three_blocks`: bf16 at three blocks an SM (at most 85 registers).
A patched kernel is wrong (all but `none`, `one_part_p`, `one_block`,
`three_blocks` and the `keys64` pair); only its time means anything. Each variant runs in its
own process on its own build (under `build/win_ablate/`).

    python3 scripts/torch_win_ablate.py [none no_relrows ...]   # on the card
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "deepseek_ocr2_tpu_torch/csrc/flash_attention.cu"
BLOCKS = "__launch_bounds__(TC_THREADS, sizeof(T) == 4 ? 1 : 2)"
VARIANTS = {
    "none": [],
    "no_relrows": [("  if constexpr (MODE == RELWIN) relwin_rows<T, D>(", "  if constexpr (false) relwin_rows<T, D>(")],
    "no_bias": [("      if constexpr (MODE == RELPOS || MODE == RELWIN)\n        add_rel_bias<NK, !F32>(",
                 "      if constexpr (false)\n        add_rel_bias<NK, !F32>(")],
    "no_qk": [("            sm90::mma_bf16_16816(s[2 * np], qa[kk], b[0], b[1]);\n"
               "            sm90::mma_bf16_16816(s[2 * np + 1], qa[kk], b[2], b[3]);", "")],
    "no_pv": [("            sm90::mma_bf16_16816(acc[2 * dp], pl, b[0], b[1]);\n"
               "            sm90::mma_bf16_16816(acc[2 * dp], ph, b[0], b[1]);\n"
               "            sm90::mma_bf16_16816(acc[2 * dp + 1], pl, b[2], b[3]);\n"
               "            sm90::mma_bf16_16816(acc[2 * dp + 1], ph, b[2], b[3]);", "")],
    "one_part_p": [("            sm90::mma_bf16_16816(acc[2 * dp], pl, b[0], b[1]);\n", ""),
                   ("            sm90::mma_bf16_16816(acc[2 * dp + 1], pl, b[2], b[3]);\n", "")],
    "one_block": [(BLOCKS, "__launch_bounds__(TC_THREADS, 1)")],
    "keys64": [("constexpr int TC_KW = 32;", "constexpr int TC_KW = 64;")],
    "keys64_one_block": [("constexpr int TC_KW = 32;", "constexpr int TC_KW = 64;"),
                         (BLOCKS, "__launch_bounds__(TC_THREADS, sizeof(T) == 4 ? 1 : 1)")],
    "three_blocks": [(BLOCKS, "__launch_bounds__(TC_THREADS, sizeof(T) == 4 ? 1 : 3)")],
}

CHILD = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(1, {repo!r})
import torch
import torch.nn.functional as F
import chip_smoke as cs
from deepseek_ocr2_tpu_torch.ops import cuda_build
from deepseek_ocr2_tpu_torch.ops.flash_attention import (mha_reference, mha_relpos, mha_win, mha_win_reference,
                                                          window_bias)

assert cuda_build.__file__.startswith({root!r}), cuda_build.__file__
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(cs.SEED)
cuda_build.load("flash_attention")
log = cuda_build.BUILD_LOG.get("flash_attention", "").split("Function properties for ")
regs = {{("V " if "Li64ELi4EE" in part[:300] else "B ") + ("bf16" if "bfloat16" in part[:300] else "f32"):
        part.split("Used ")[1].split(" registers")[0]
        for part in log if "Li64ELi4EE" in part[:300] or "Li64ELi3EE" in part[:300]}}
out = [f"registers {{regs}}"]
for b in (25, 96):
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = ((torch.randn(b, 12, 196, 64, generator=g, device=dev)).to(dt) for _ in range(3))
        rhf, rwf = (0.3 * torch.randn(64, 196, generator=g, device=dev) for _ in range(2))
        kw = dict(scale=0.125, win=14, valid=14)
        err = float((mha_win(q, k, v, rhf, rwf, **kw).float() - mha_win_reference(q, k, v, rhf, rwf, **kw).float())
                    .abs().max())
        graph = min(cs.graph_ms(lambda: mha_win(q, k, v, rhf, rwf, **kw)) for _ in range(3))
        line = f"V [{{b}}, 12, 196, 64] {{str(dt)[6:]}} graph {{graph:.4f}} ms (err {{err:.1e}})"
        if "{name}" == "none":
            bias = window_bias(q, rhf, rwf, 14, 14).to(dt)
            sdpa = min(cs.graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=0.125))
                       for _ in range(3))
            line += f", SDPA with the bias {{sdpa:.4f}}"
        out.append(line)
        del q, k, v
for b, side in ((1, 64), (25, 14), (6, 48), (96, 14)):
    l = side * side
    q, k, v = (torch.randn(b, 12, l, 64, generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    rh, rw = (0.3 * torch.randn(b, 12, l, side, generator=g, device=dev) for _ in range(2))
    ref = mha_reference(q, k, v, scale=0.125, rel_h=rh, rel_w=rw)
    err = float((mha_relpos(q, k, v, rh, rw, scale=0.125).float() - ref.float()).abs().max())
    graph = min(cs.graph_ms(lambda: mha_relpos(q, k, v, rh, rw, scale=0.125)) for _ in range(3))
    line = f"B [{{b}}, 12, {{l}}, 64] bf16 graph {{graph:.4f}} ms (err {{err:.1e}}, tol {{cs.bf16_tol(ref):.1e}})"
    if "{name}" == "none":
        bias = (rh[..., :, None] + rw[..., None, :]).reshape(b, 12, l, l).to(torch.bfloat16)
        sdpa = min(cs.graph_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=0.125))
                   for _ in range(3))
        line += f", SDPA with the bias {{sdpa:.4f}}"
        del bias
    out.append(line)
    del q, k, v, rh, rw, ref
    torch.cuda.empty_cache()
print("[ablate {name}] " + "; ".join(out), flush=True)
"""


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for name in names:
        tree = os.path.join(ROOT, "build", "win_ablate", name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "deepseek_ocr2_tpu_torch"), os.path.join(tree, "deepseek_ocr2_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(tree, SRC)
        text = open(path).read()
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {SRC} no longer holds the text this variant patches: {old[:60]}")
            text = text.replace(old, new)
        open(path, "w").write(text)
        child = CHILD.format(root=tree, repo=ROOT, name=name)
        rc = subprocess.run([sys.executable, "-c", child], cwd=tree).returncode
        if rc != 0:
            print(f"[ablate {name}] failed: rc {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
