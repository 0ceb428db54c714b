"""Where kernel F in bf16 (the batched-decode MoE, `csrc/moe_decode.cu`
`gu_tc_kernel` then `down_tc_kernel`) spends its time: each variant changes
one part of the source in a copy of the package and times F again through
its wrapper in a CUDA graph at one MoE decode layer of the served LM (E 64,
k 6, H 1280, I 896, a random f32 router) at B 8, 16 and 32, beside its
bound (the selected experts' weights once, over 3.35 TB/s); at B 16 also
each of its three launches' device time (torch.profiler, 20 calls).

Variants (each a text patch of the source; the script stops if the source
no longer holds the text it patches):
- `none`: the kernel as it is (its error against the visit twin printed);
- `no_mma`: neither launch multiplies (the weight stream, the partials'
  exchange and the stores alone);
- `gu_only`: the down launch is not made (the schedule and gate/up);
- `down_only`: the gate/up launch is not made (the schedule and down);
- `gu_stages3`: gate/up's ring of 3 stages in place of 4;
- `count_block`: down's valid visits counted by the whole block in one
  barrier (`__syncthreads_count`) in place of its first thread's loop of
  E loads;
- `down_stages2`: down's ring of 2 stages at B <= 16 in place of 3.
A patched kernel is wrong (all but `none` and the stage counts); only its
time means anything. Each variant runs in its own process on its own build
(under `build/moe_decode_ablate/`).

    python3 scripts/torch_moe_decode_ablate.py [none no_mma ...]   # on the card
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "deepseek_ocr2_tpu_torch/csrc/moe_decode.cu"
VARIANTS = {
    "none": [],
    "no_mma": [("          sm90::mma_bf16_16816(cg[m], xa[m][jj], b[0], b[1]);\n"
                "          sm90::mma_bf16_16816(cu[m], xa[m][jj], b[2], b[3]);\n",
                "          cg[m][0] += __uint_as_float(b[0] & xa[m][jj][0]);\n"),
               ("        sm90::mma_bf16_16816(c[m][0], a, b[0], b[1]);\n"
                "        sm90::mma_bf16_16816(c[m][1], a, b[2], b[3]);\n",
                "        c[m][0][0] += __uint_as_float(a[0] & b[0]);\n")],
    "gu_only": [("  down_tc_kernel<MT><<<", "  if (false) down_tc_kernel<MT><<<")],
    "down_only": [("  gu_tc_kernel<MT><<<", "  if (false) gu_tc_kernel<MT><<<")],
    "gu_stages3": [("constexpr int GU_STAGES = 4;", "constexpr int GU_STAGES = 3;")],
    "count_block": [("    for (int v = 0; v < n_exp; ++v) n += valid[v];\n    n_valid = n;\n",
                     "    n_valid = 0;\n"),
                    ("  __syncthreads();\n  const int nv = n_valid;",
                     "  int nv = 0;\n  for (int v0 = 0; v0 < n_exp; v0 += blockDim.x)\n"
                     "    nv += __syncthreads_count(v0 + (int)threadIdx.x < n_exp && valid[v0 + threadIdx.x]);")],
    "down_stages2": [("    stages = MT == 1 ? 3 : 2;", "    stages = 2;")],
}

CHILD = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(1, {repo!r})
import torch
import chip_smoke as cs
from deepseek_ocr2_tpu_torch.ops import cuda_build, moe_decode
from deepseek_ocr2_tpu_torch.ops.moe import route

assert cuda_build.__file__.startswith({root!r}), cuda_build.__file__
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(cs.SEED)


def randn(*shape, std=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


e, k, h, i = 64, 6, 1280, 896
ex = {{"gate": randn(e, i, h, std=h**-0.5, dtype=torch.bfloat16), "up": randn(e, i, h, std=h**-0.5, dtype=torch.bfloat16),
       "down": randn(e, h, i, std=i**-0.5, dtype=torch.bfloat16)}}
router = randn(e, h, std=h**-0.5)
out = []
for b in (8, 16, 32):
    x = randn(b, h, dtype=torch.bfloat16)
    args = (x, ex, *route(x, router, k))
    n_visits = int(moe_decode.distinct_schedule(args[3], e)[1].sum())
    err = float((moe_decode.moe_ffn_decode_fused(*args).float()
                 - moe_decode.moe_ffn_decode_visits_reference(*args).float()).abs().max())
    graph = min(cs.graph_ms(lambda: moe_decode.moe_ffn_decode_fused(*args)) for _ in range(3))
    bound, _ = cs.bound_ms(cs.nbytes(x, x, *args[2:]) + n_visits * 3 * cs.nbytes(ex["gate"][0]),
                           2 * b * k * 3 * h * i, torch.bfloat16)
    line = f"B {{b}} ({{n_visits}} experts) graph {{graph:.4f}} ms, bound {{bound:.4f}} (err {{err:.1e}})"
    if b == 16:  # each launch's own device time, mean of 20 calls under torch.profiler
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                moe_decode.moe_ffn_decode_fused(*args)
            torch.cuda.synchronize()
        parts = {{}}
        for ev in prof.key_averages():
            for name in ("schedule_kernel", "gu_tc_kernel", "down_tc_kernel"):
                if name in ev.key:
                    parts[name] = parts.get(name, 0.0) + ev.self_device_time_total / 1e3 / 20
        line += " [" + ", ".join(f"{{n}} {{ms:.4f}} ms" for n, ms in parts.items()) + "]"
    out.append(line)
print("[ablate {name}] " + "; ".join(out), flush=True)
"""


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for name in names:
        tree = os.path.join(ROOT, "build", "moe_decode_ablate", name)
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
