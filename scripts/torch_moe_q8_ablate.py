"""Where kernel J's stream (the int8 batched-decode MoE with bf16 x,
`csrc/moe_q8.cu` `gu_q8_kernel` then `down_q8_kernel`) spends its time:
each variant changes one part of the source in a copy of the package and
times J again through its wrapper in a CUDA graph at one int8 MoE decode
layer of the served LM (E 64 + 2 pseudo-experts, k 6, H 1280, I 896, a
random f32 router) at B 8, 16 and 32, beside its bound (the experts read,
codes and scales, once, over 3.35 TB/s); at B 16 also each of its three
launches' device time (torch.profiler, 20 calls).

Variants (each a text patch of the source; the script stops if the source
no longer holds the text it patches):
- `none`: the kernels as they are (the error against the visit twin
  printed);
- `gu_nt1`: gate/up items of 8 columns of I (one n8 tile, 20 KB stages, up
  to 8 of them) in place of 16 (40 KB stages, 4);
- `gu_stages3` / `down_stages4`: rings of at most 3 stages for gate/up (in
  place of 4) / 4 for down (in place of 8);
- `no_gu_mma`: gate/up multiplies nothing (its codes still loaded and
  widened);
- `no_gu_epilogue`: gate/up writes no act (its partials still summed);
- `dense_down`: down copies and multiplies every decode row of a visit, the
  rows that did not select its expert with weight 0, in place of the rows
  with a nonzero weight only;
- `no_down_mma`: down multiplies nothing;
- `act_spread`: block b reads visit (v + b)'s act rows in place of visit
  v's (so that the blocks do not all read the same rows at once);
- `no_act_copy`: down copies no act row (its products read stale rows);
- `gu_only` / `down_only`: one of the two launches is not made.
A patched kernel is wrong (all but `none`, `gu_nt1`, the stage counts and
`dense_down`); only its time means anything. Each variant runs in its own
process on its own build (under `build/moe_q8_ablate/`).

    python3 scripts/torch_moe_q8_ablate.py [none gu_nt1 ...]   # on the card
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "deepseek_ocr2_tpu_torch/csrc/moe_q8.cu"
VARIANTS = {
    "none": [],
    "gu_nt1": [("constexpr int GU_NT = 2;", "constexpr int GU_NT = 1;"),
               ("constexpr int GU_MAX_STAGES = 4;", "constexpr int GU_MAX_STAGES = 8;")],
    "gu_stages3": [("constexpr int GU_MAX_STAGES = 4;", "constexpr int GU_MAX_STAGES = 3;")],
    "down_stages4": [("constexpr int DN_MAX_STAGES = 8;", "constexpr int DN_MAX_STAGES = 4;")],
    "no_gu_mma": [("              sm90::mma_bf16_16816(cg[m][n], a, bg[0], bg[1]);\n"
                   "              sm90::mma_bf16_16816(cu[m][n], a, bu[0], bu[1]);\n",
                   "              cg[m][n][0] += __uint_as_float(a[0] ^ bg[0] ^ bg[1] ^ bu[0] ^ bu[1]);\n")],
    "no_gu_epilogue": [("        if (row < nb) act[", "        if (row < 0) act[")],
    "dense_down": [("const unsigned mask = __ballot_sync(FULL, wv != 0.f);",
                    "const unsigned mask = __ballot_sync(FULL, lane < nb);"),
                   ("if (wv != 0.f && idx >= p0", "if (lane < nb && idx >= p0")],
    "no_down_mma": [("        sm90::mma_bf16_16816(c, a, word(xs, 2 * (s % 2)), word(xs, 2 * (s % 2) + 1));\n",
                     "        c[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ word(xs, s));\n")],
    "act_spread": [("act + ((size_t)v * nb + __ffs(rest) - 1) * i_dim",
                    "act + ((size_t)((v + blockIdx.x) % n_visits) * nb + __ffs(rest) - 1) * i_dim")],
    "no_act_copy": [("sm90::mbar_arrive_expect_tx(&full[slot], cnt * i_dim * 2 + DN_COLS * (i_dim + 4));",
                     "sm90::mbar_arrive_expect_tx(&full[slot], DN_COLS * (i_dim + 4));"),
                    ("for (int r = 0; r < cnt; ++r, rest &= rest - 1)", "for (int r = 0; r < 0; ++r, rest &= rest - 1)")],
    "gu_only": [("  down_q8_kernel<<<", "  if (false) down_q8_kernel<<<")],
    "down_only": [("  gu_q8_kernel<MT><<<", "  if (false) gu_q8_kernel<MT><<<")],
}

CHILD = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(1, {repo!r})
import torch
import chip_smoke as cs
from deepseek_ocr2_tpu_torch.ops import cuda_build, moe_decode, moe_q8
from deepseek_ocr2_tpu_torch.ops.moe import route

assert cuda_build.__file__.startswith({root!r}), cuda_build.__file__
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(cs.SEED)


def randn(*shape, std=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


e, k, h, i, n_sh = 64, 6, 1280, 896, 2


def experts(n):
    return moe_q8.quantize_experts({{"gate": randn(n, i, h, std=h**-0.5), "up": randn(n, i, h, std=h**-0.5),
                                     "down": randn(n, h, i, std=i**-0.5)}})


eq = experts(e)
eq.update({{f"pe_{{name}}": t for name, t in experts(n_sh).items()}})
e_bytes = cs.nbytes(*(eq[name][0] for name in ("gu_q8", "gu_scale", "down_q8", "down_scale")))
router = randn(e, h, std=h**-0.5)
out = []
for b in (8, 16, 32):
    x = randn(b, h, dtype=torch.bfloat16)
    args = (x, eq, *route(x, router, k))
    n_read = int(torch.unique(args[3]).numel()) + n_sh
    err = float((moe_decode.moe_ffn_decode_q8_fused(*args).float()
                 - moe_decode.moe_ffn_decode_q8_visits_reference(*args).float()).abs().max())
    graph = min(cs.graph_ms(lambda: moe_decode.moe_ffn_decode_q8_fused(*args)) for _ in range(3))
    bound, _ = cs.bound_ms(cs.nbytes(x, x, *args[2:]) + n_read * e_bytes, 2 * b * (k + n_sh) * 3 * h * i,
                           torch.bfloat16)
    line = f"B {{b}} ({{n_read}} experts) graph {{graph:.4f}} ms, bound {{bound:.4f}} (err {{err:.1e}})"
    if b == 16:  # each launch's own device time, mean of 20 calls under torch.profiler
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                moe_decode.moe_ffn_decode_q8_fused(*args)
            torch.cuda.synchronize()
        parts = {{}}
        for ev in prof.key_averages():
            for name in ("schedule_kernel", "gu_q8_kernel", "down_q8_kernel"):
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
        tree = os.path.join(ROOT, "build", "moe_q8_ablate", name)
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
