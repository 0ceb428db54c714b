"""Where kernels P and Q (`csrc/paged_attention.cu` `paged_split_kernel`:
G's split-key walk over an int8 pool, and with S queries a row) spend
their time: each variant changes one part of the source in a copy of the
package and times chip_smoke's P, Q and R cases (`paged_q8_results`,
`chunk_results`: 16 rows of 260..2048 tokens and one of 1500 for P, int8
and int8tail; 16 rows at S = 4 for Q, bf16 and f32 pools, and R beside
them, whose device code no variant touches) through the wrapper in a CUDA
graph, beside the bound.

Variants (each a text patch of the source; the script stops if the source
no longer holds the text it patches):
- `none`: the kernels as they are;
- `warps1` / `warps4`: one warp (32-key chunks) or four (128-key chunks) a
  block in place of two (64 keys; the wrapper's workspace sized to match);
- `cvt`: P's codes widened by convert instructions in place of the byte
  permute into 2^23's mantissa;
- `no_scores`: no dot products (every live score 0; the K rows are still
  copied);
- `no_pv`: no weighted sum of V (the V rows are still copied);
- `merge_unroll`: the merge's loops unrolled 16 and 8 times in place of 8
  and 4 (more of its loads in flight at once);
- `no_merge`: the merging block returns before the fixed-order merge.
A patched kernel is wrong (`no_scores`, `no_pv`, `no_merge`); only its time means
anything, and its error is printed. Each variant runs in its own process on
its own build (under `build/paged_ablate/`).

    python3 scripts/torch_paged_ablate.py [none warps4 ...]   # on the card
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "deepseek_ocr2_tpu_torch/csrc/paged_attention.cu"
PY = "deepseek_ocr2_tpu_torch/ops/paged_attention.py"  # sizes the workspace by the chunk
VARIANTS = {
    "none": [],
    "warps1": [("constexpr int U_WARPS = 2;", "constexpr int U_WARPS = 1;"),
               (PY, "U_CHUNK, U_WARP_KEYS = 64, 32", "U_CHUNK, U_WARP_KEYS = 32, 32")],
    "warps4": [("constexpr int U_WARPS = 2;", "constexpr int U_WARPS = 4;"),
               (PY, "U_CHUNK, U_WARP_KEYS = 64, 32", "U_CHUNK, U_WARP_KEYS = 128, 32")],
    "cvt": [("  const uint32_t u = w ^ 0x80808080u;\n#pragma unroll\n"
             "  for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | i)) - "
             "8388736.f;",
             "#pragma unroll\n  for (int i = 0; i < 4; ++i) out[i] = (float)(signed char)(w >> (8 * i));")],
    "no_scores": [("      for (int e = 0; e < D; e += STEP) {", "      for (int e = 0; e < 0; e += STEP) {")],
    "no_pv": [("    for (int j = 0; j < nk; ++j) {\n      float w[S], vf[4];",
               "    for (int j = 0; j < 0; ++j) {\n      float w[S], vf[4];")],
    "merge_unroll": [("#pragma unroll 8\n  for (int c = 0; c < n; ++c) m = fmaxf(",
                      "#pragma unroll 16\n  for (int c = 0; c < n; ++c) m = fmaxf("),
                     ("#pragma unroll 4\n  for (int c = 0; c < n; ++c) {\n    const float* pc",
                      "#pragma unroll 8\n  for (int c = 0; c < n; ++c) {\n    const float* pc")],
    "no_merge": [("  if (!merger) return;\n  __threadfence();\n",
                  "  if (merger) counters[rh] = 0;\n  return;\n  __threadfence();\n")],
}

CHILD = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(1, {repo!r})
import torch
import chip_smoke as cs
from deepseek_ocr2_tpu_torch.ops import cuda_build

assert cuda_build.__file__.startswith({root!r}), cuda_build.__file__
dev = torch.device("cuda", 0)


def record(kernel, case, ref, got, tol, ms, plain_ms, bound=None, library=None, graph=None, library_graph=False):
    err = float((got.float() - ref.float()).abs().max())
    g = min(cs.graph_ms(graph) for _ in range(3))
    print(f"[ablate {name}] {{kernel}} {{case}}: graph {{g:.4f}} ms, bound {{bound[0]:.4f}} (err {{err:.1e}})",
          flush=True)


cs.paged_q8_results(dev, record)
cs.chunk_results(dev, record)
"""


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for name in names:
        tree = os.path.join(ROOT, "build", "paged_ablate", name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "deepseek_ocr2_tpu_torch"), os.path.join(tree, "deepseek_ocr2_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        for patch in VARIANTS[name]:
            src, old, new = patch if len(patch) == 3 else (SRC, *patch)
            path = os.path.join(tree, src)
            text = open(path).read()
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {src} no longer holds the text this variant patches: {old[:60]}")
            open(path, "w").write(text.replace(old, new))
        child = CHILD.format(root=tree, repo=ROOT, name=name)
        rc = subprocess.run([sys.executable, "-c", child], cwd=tree).returncode
        if rc != 0:
            print(f"[ablate {name}] failed: rc {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
