"""Where kernel C (SAM's MLP, `csrc/fused_mlp.cu` `mlp_gemm_kernel`: two
launches of a TMA + wgmma GEMM, up with the bias and GELU in its epilogue,
down with the bias) spends its time: each variant changes one part of the
source in a copy of the package and times C again through its wrapper in a
CUDA graph at SAM's three M (4096: one 1024^2 view; 2304: one 768^2 crop;
13 824: six crops), f32 and bf16, and each launch's device time at M 4096
under torch.profiler. Each line gives the error against the plain twin
beside C's tolerance (f32 1e-4, bf16 4 ulps of max |ref|) and the
registers and spills ptxas reports for each launch's kernel.

Variants (each a text patch of the source; the script stops if the source
no longer holds the text it patches):
- `none`: the kernel as it is;
- `down_wide`, `down_narrow`: the down product at its wider (bf16 192, f32
  128) or narrower (128, 96) column width whatever M (`narrow_down` picks
  one by the item-waves of the grid);
- `f32_up_bn96`, `bf16_up_bn192`: the up product at other column widths;
- `no_split`: f32, no stage split into tf32 parts (the split's time);
- `one_product`: f32, hi x hi alone (1xTF32: two thirds of the products);
- `no_mma`: no wgmma at all (the ring of TMA loads, the split and the
  epilogue without the products);
- `no_store`: the epilogue's math without its stores (the stores' time;
  the products stay: their results still feed the epilogue);
- `no_gelu`: the epilogue without the GELU; `as_erf`: erf by the TPU
  kernel's polynomial (Abramowitz & Stegun 7.1.26, a correctly rounded
  reciprocal and an exponential) in place of CUDA's erff.
A patched kernel is wrong (all but `none`, the widths and `as_erf`); only its
time means anything. Each variant runs in its own process on its own build
(under `build/mlp_ablate/`).

    python3 scripts/torch_mlp_ablate.py [none no_split ...]   # on the card
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "deepseek_ocr2_tpu_torch/csrc/fused_mlp.cu"
F32_CFG = "  static constexpr int BK = 32, K_STEP = 8, UP_BN = 128, DOWN_BN = 128, DOWN_BN_SMALL = 96;"
BF16_CFG = "  static constexpr int BK = 64, K_STEP = 16, UP_BN = 256, DOWN_BN = 192, DOWN_BN_SMALL = 128;"
PICK = "  return narrow_down<T>(m, e, sms) ? "
BF16_MMA = "          mma<T, BN>(acc, sm90::desc_add(da, 32 * kk), sm90::desc_add(db, 32 * kk));\n"
F32_MMA = "        mma<T, BN>(acc, sm90::desc_add(da, off), sm90::desc_add(db, off));\n"
GELU = "gelu_erf(float h) { return 0.5f * h * (1.f + erff(h * 0.70710678118654752f)); }"
LO_MMA = ("        mma<T, BN>(acc, sm90::desc_add(la, off), sm90::desc_add(db, off));\n"
          "        mma<T, BN>(acc, sm90::desc_add(da, off), sm90::desc_add(lb, off));\n")
VARIANTS = {
    "none": [],
    "down_wide": [(PICK, "  return false ? ")],
    "down_narrow": [(PICK, "  return true ? ")],
    "f32_up_bn96": [(F32_CFG, F32_CFG.replace("UP_BN = 128", "UP_BN = 96"))],
    "bf16_up_bn192": [(BF16_CFG, BF16_CFG.replace("UP_BN = 256", "UP_BN = 192"))],
    "no_split": [("  for (int i = threadIdx.x; i < STAGE / 16; i += CONSUMER_WARPS * 32) {",
                  "  for (int i = threadIdx.x; i < 0; i += CONSUMER_WARPS * 32) {")],
    "one_product": [(LO_MMA, "")],
    "no_mma": [(LO_MMA, ""), (F32_MMA, ""), (BF16_MMA, "")],
    "no_store": [("      *reinterpret_cast<float2*>(out + (size_t)row * n + col) = make_float2(v0, v1);",
                  "      if (m < 0) *reinterpret_cast<float2*>(out + (size_t)row * n + col) = make_float2(v0, v1);"),
                 ("        if (n0 + 64 * jb < n) sm90::tma_store_2d(", "        if (m < 0) sm90::tma_store_2d(")],
    "no_gelu": [(GELU, "gelu_erf(float h) { return h; }")],
    "as_erf": [(GELU, "gelu_erf(float h) {\n"
                      "  const float z = fabsf(h) * 0.70710678118654752f;\n"
                      "  const float t = __frcp_rn(fmaf(0.3275911f, z, 1.f));\n"
                      "  const float poly = t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), "
                      "1.421413741f), -0.284496736f), 0.254829592f);\n"
                      "  return 0.5f * h * (1.f + copysignf(1.f - poly * __expf(-z * z), h));\n}")],
}

CHILD = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(1, {repo!r})
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from deepseek_ocr2_tpu_torch.ops import cuda_build
from deepseek_ocr2_tpu_torch.ops.fused_mlp import mlp_gelu, mlp_gelu_reference

assert cuda_build.__file__.startswith({root!r}), cuda_build.__file__
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(cs.SEED)
cuda_build.load("fused_mlp")
regs = []
for part in cuda_build.BUILD_LOG.get("fused_mlp", "").split("Function properties for ")[1:]:
    if "mlp_gemm_kernel" not in part[:200]:
        continue
    name = "f32" if "IfLi" in part[:200] else "bf16"
    tail = part.split("Used ")[1]
    spill = part.split("bytes spill stores")[0].split(",")[-1].strip()
    regs.append(f"{{name}} {{part[:200].split('Li')[1].split('E')[0]}}/{{part[:200].split('Li')[2].split('E')[0]}}: "
                f"{{tail.split(' registers')[0]}} regs, {{spill}} B spilled")
out = [f"kernels {{regs}}"]
for dt in (torch.float32, torch.bfloat16):
    for m in (4096, 2304, 6 * 2304):
        x = torch.randn(m, 768, generator=g, device=dev).to(dt)
        w1 = (torch.randn(3072, 768, generator=g, device=dev) * 768**-0.5).to(dt)
        w2 = (torch.randn(768, 3072, generator=g, device=dev) * 3072**-0.5).to(dt)
        b1 = (0.02 * torch.randn(3072, generator=g, device=dev)).to(dt)
        b2 = (0.02 * torch.randn(768, generator=g, device=dev)).to(dt)
        ref = mlp_gelu_reference(x, w1, b1, w2, b2)
        err = float((mlp_gelu(x, w1, b1, w2, b2).float() - ref.float()).abs().max())
        graph = min(cs.graph_ms(lambda: mlp_gelu(x, w1, b1, w2, b2)) for _ in range(3))
        line = f"{{str(dt)[6:]}} M {{m}} graph {{graph:.4f}} ms (err {{err:.1e}}, tol {{cs.tolerance(ref, dt):.1e}})"
        if m == 4096:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    mlp_gelu(x, w1, b1, w2, b2)
                torch.cuda.synchronize()
            parts = {{}}
            for e in prof.key_averages():
                if "mlp_gemm_kernel<" in e.key:
                    which = "down" if e.key.split("mlp_gemm_kernel<")[1].split(">")[0].endswith("1") else "up"
                    parts[which] = parts.get(which, 0.0) + e.self_device_time_total / 1e3 / 5
            line += ", " + ", ".join(f"{{k}} {{v:.4f}} ms" for k, v in sorted(parts.items()))
        out.append(line)
        del x, w1, w2, b1, b2, ref
        torch.cuda.empty_cache()
print("[ablate {name}] " + "; ".join(out), flush=True)
"""


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for name in names:
        tree = os.path.join(ROOT, "build", "mlp_ablate", name)
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
