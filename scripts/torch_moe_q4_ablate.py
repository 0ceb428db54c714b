"""Where kernel N's stream (the int4 batched-decode MoE with bf16 x,
`csrc/moe_q4.cu` `gu_q4_kernel` then `down_q4_kernel`) and kernel M's
(the per-selection one, `sel_gu_q4_kernel` then `sel_down_q4_kernel`)
spend their time: each variant changes one part of the source in a copy
of the package and times the kernel again through its wrapper in a CUDA
graph at one int4 MoE decode layer of the served LM (E 64 + 2
pseudo-experts, k 6, H 1280, I 896, a random f32 router), beside its bound
(the experts read, codes and scales, once, over 3.35 TB/s): N at B 8, 16
and 32, at B 16 also each of its three launches' device time; M (the
variants named `m_...`) at one row with the pseudo-experts and at B 8 and
10 without, at one row also each of its two launches' device time and
the span of a call (torch.profiler, 20 calls).

Variants (each a text patch of the source; the script stops if the source
no longer holds the text it patches):
- `none`: the kernels as they are (the error against the visit twin
  printed);
- `gu_only` / `down_only`: one of the two launches is not made;
- `no_gu_mma`: gate/up multiplies nothing (its codes still loaded and
  decoded);
- `no_gu_reduce`: gate/up's reducer warps do not sum the tiles (nor write
  act);
- `gu_red2`: two reducer warps in place of four;
- `gu_no_copy`: gate/up's producer copies nothing (its consumers read
  stale stages): the consumers' time alone;
- `gu_nt2`: gate/up items of 16 columns of I (21 KB stages, up to 8 of
  them) in place of 32 (42.5 KB, 3-4);
- `gu_bufs1`: gate/up's compute warps hand their tiles over in one buffer
  in place of two at up to 16 rows;
- `dn_no_stages`: down's blocks walk no visit (the prologue, the parts'
  sums and their merge alone);
- `no_dn_decode`: down's codes go to the products undecoded;
- `dn_unroll2`: down's loop over the groups of I unrolled by two;
- `no_dn_mma`: down multiplies nothing;
- `dn_no_copy`: down's producer copies nothing: its consumers' time alone;
- `dn_no_act`: down copies no act rows (its products read stale rows).
M's variants:
- `m_none`: M as it is (the error against its twin printed);
- `m_no_pdl`: down launched in plain stream order, not as a programmatic
  dependent of gate/up (its weights no longer stream under gate/up);
- `m_gu_only` / `m_down_only`: one of the two launches is not made;
- `m_gu_no_copy` / `m_dn_no_copy`: gate/up's or down's producer copies no
  code rows (the consumers read stale stages);
- `m_gu_no_dots`: gate/up's consumers decode and multiply nothing (the
  stages still arrive and are waited on);
- `m_gu_no_x`: gate/up's consumers stage no x rows;
- `m_gu_no_idx`: gate/up's producer reads no expert ids (visit v takes
  expert v mod E);
- `m_gu_one_unit`: each gate/up block takes one unit: the launch, the
  staging, one unit's copies and dot and act's write alone.
A patched kernel is wrong (all but `none`, `gu_red2`, `gu_nt2`, `gu_bufs1`,
`dn_unroll2`, `m_none` and `m_no_pdl`); only its time means anything. Each variant runs in its own
process on its own build (under `build/moe_q4_ablate/`); the builds run
side by side first.

    python3 scripts/torch_moe_q4_ablate.py [none gu_only ...]   # on the card
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "deepseek_ocr2_tpu_torch/csrc/moe_q4.cu"
GU_COPY = ("      sm90::mbar_arrive_expect_tx(&full[slot], 2 * GU_COLS * (rb + ng * 4));\n"
           "      sm90::bulk_load(dst, codes + (size_t)i0 * rb, GU_COLS * rb, &full[slot]);\n")
DN_COPY = ("        sm90::mbar_arrive_expect_tx(&full[slot], nb * lay.as * 2 + cols * (lay.rb + lay.ng * 4));\n"
           "        sm90::bulk_load(dst, act + (size_t)a * ROWS * lay.as, nb * lay.as * 2, &full[slot]);\n")
SEL_GU_COPY = ("        sm90::mbar_arrive_expect_tx(&full[slot], 2 * SEL_COLS * (rb + ng * 4));\n"
               "        sm90::bulk_load(dst, codes + (row0 + i0) * rb, SEL_COLS * rb, &full[slot]);\n")
SEL_DN_COPY = ("        sm90::mbar_arrive_expect_tx(&full[slot], SD_ROWS * (rb + ng * 4));\n"
               "        sm90::bulk_load(dst, (pe ? w.pdown : w.down) + row0 * rb, SD_ROWS * rb, &full[slot]);\n"
               "        sm90::bulk_load(dst + SD_ROWS * rb, (pe ? w.pds : w.ds) + row0 * ng, SD_ROWS * ng * 4, &full[slot]);\n")
VARIANTS = {
    "none": [],
    "gu_only": [("  down_q4_kernel<MT><<<", "  if (false) down_q4_kernel<MT><<<")],
    "down_only": [("  gu_q4_kernel<MT><<<", "  if (false) gu_q4_kernel<MT><<<")],
    "no_gu_mma": [("          sm90::mma_bf16_16816(cg[m], a0, bg[0], bg[1]);\n"
                   "          sm90::mma_bf16_16816(cg[m], a1, bg[2], bg[3]);\n"
                   "          sm90::mma_bf16_16816(cu[m], a0, bu[0], bu[1]);\n"
                   "          sm90::mma_bf16_16816(cu[m], a1, bu[2], bu[3]);\n",
                   "          cg[m][0] += __uint_as_float(a0[0] ^ a1[1] ^ bg[0] ^ bg[1] ^ bg[2] ^ bg[3]);\n"
                   "          cu[m][0] += __uint_as_float(a0[2] ^ a1[3] ^ bu[0] ^ bu[1] ^ bu[2] ^ bu[3]);\n")],
    "no_gu_reduce": [("      for (int q = u; q < N_FRAG; q += 32 * GU_RED) {",
                      "      for (int q = u; q < 0; q += 32 * GU_RED) {")],
    "gu_red2": [("constexpr int GU_RED = 4;", "constexpr int GU_RED = 2;")],
    "gu_no_copy": [(GU_COPY, "      sm90::mbar_arrive(&full[slot]);\n      if (false) {\n" + GU_COPY.split("\n")[1] + "\n"),
                   ("                      GU_COLS * ng * 4, &full[slot]);\n",
                    "                      GU_COLS * ng * 4, &full[slot]);\n      }\n")],
    "gu_nt2": [("constexpr int GU_NT = 4;", "constexpr int GU_NT = 2;"),
               ("constexpr int GU_MAX_STAGES = 4;", "constexpr int GU_MAX_STAGES = 8;")],
    "gu_bufs1": [("bufs = fit_stages(2 * red_bytes, stage_bytes, GU_MAX_STAGES) >= 3 ? 2 : 1;", "bufs = 1;")],
    "no_dn_mma": [("          sm90::mma_bf16_16816(d[c % 2][m], a0, b[0], b[1]);\n"
                   "          sm90::mma_bf16_16816(d[c % 2][m], a1, b[2], b[3]);\n",
                   "          d[c % 2][m][0] += __uint_as_float(a0[0] ^ a1[1] ^ a0[2] ^ a1[3] ^ b[0] ^ b[1] ^ b[2] ^ b[3]);\n")],
    "dn_no_stages": [("  const int n_mine = n_r + n_p;", "  const int n_mine = 0;")],
    "no_dn_decode": [("        decode_pairs(word(cw, c), b);",
                      "        b[0] = word(cw, c), b[1] = b[0] ^ 1u, b[2] = b[0] ^ 2u, b[3] = b[0] ^ 3u;")],
    "dn_unroll2": [("    for (int grp = 0; grp < lay.ng; ++grp) {", "#pragma unroll 2\n    for (int grp = 0; grp < lay.ng; ++grp) {")],
    "dn_no_copy": [(DN_COPY, "        sm90::mbar_arrive(&full[slot]);\n        if (false) {\n" + DN_COPY.split("\n")[1] + "\n"),
                   ("(pe ? w.pds : w.ds) + row0 * lay.ng, cols * lay.ng * 4, &full[slot]);\n",
                    "(pe ? w.pds : w.ds) + row0 * lay.ng, cols * lay.ng * 4, &full[slot]);\n        }\n")],
    "dn_no_act": [(DN_COPY, "        sm90::mbar_arrive_expect_tx(&full[slot], cols * (lay.rb + lay.ng * 4));\n")],
    "m_none": [],
    "m_no_pdl": [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")],
    "m_gu_only": [("  err = cudaLaunchKernelEx(&cfg, sel_down_q4_kernel,", "  if (false) err = cudaLaunchKernelEx(&cfg, sel_down_q4_kernel,")],
    "m_down_only": [("  sel_gu_q4_kernel<<<", "  if (false) sel_gu_q4_kernel<<<")],
    "m_gu_no_copy": [(SEL_GU_COPY, "        sm90::mbar_arrive(&full[slot]);\n        if (false) {\n" + SEL_GU_COPY.split("\n")[1] + "\n"),
                     ("                        SEL_COLS * ng * 4, &full[slot]);\n",
                      "                        SEL_COLS * ng * 4, &full[slot]);\n        }\n")],
    "m_dn_no_copy": [(SEL_DN_COPY, "        sm90::mbar_arrive(&full[slot]);\n")],
    "m_gu_no_dots": [("      q4::stream_item_mma(st + GB * grp, rb, xrow ? xrow + GROUP * grp : nullptr, part);",
                      "      part[0] = part[2] = __int_as_float(grp);")],
    "m_gu_no_x": [("  for (int c = threadIdx.x; c < nb * h_dim / 8; c += 32 * SEL_WARPS)",
                   "  for (int c = threadIdx.x; c < 0; c += 32 * SEL_WARPS)")],
    "m_gu_no_idx": [("        e_l = ul < n_units ? sel_expert(idx, ul / n_ct, k, kv, ld, n_exp) : 0;",
                     "        e_l = (ul / n_ct) % n_exp;")],
    "m_gu_one_unit": [("  const int kv = k + n_sh, n_ct = i_dim / SEL_COLS, n_units = nb * kv * n_ct;",
                       "  const int kv = k + n_sh, n_ct = i_dim / SEL_COLS, n_units = min(nb * kv * n_ct, (int)gridDim.x);")],
}

CHILD = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(1, {repo!r})
import torch
import chip_smoke as cs
from deepseek_ocr2_tpu_torch.ops import cuda_build, moe_q4
from deepseek_ocr2_tpu_torch.ops.moe import route

assert cuda_build.__file__.startswith({root!r}), cuda_build.__file__
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(cs.SEED)


def randn(*shape, std=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


e, k, h, i, n_sh = 64, 6, 1280, 896, 2


def experts(n):
    return moe_q4.quantize_experts_q4({{"gate": randn(n, i, h, std=h**-0.5), "up": randn(n, i, h, std=h**-0.5),
                                       "down": randn(n, h, i, std=i**-0.5)}})


eq = experts(e)
eq.update({{f"pe_{{name}}": t for name, t in experts(n_sh).items()}})
e_bytes = cs.nbytes(*(eq[name][0] for name in ("gu_q4", "gu_scale", "down_q4", "down_scale")))
router = randn(e, h, std=h**-0.5)
out = []
for b in (8, 16, 32):
    x = randn(b, h, dtype=torch.bfloat16)
    args = (x, eq, *route(x, router, k))
    n_read = int(torch.unique(args[3]).numel()) + n_sh
    err = float((moe_q4.moe_ffn_decode_q4_fused(*args).float()
                 - moe_q4.moe_ffn_decode_q4_visits_reference(*args).float()).abs().max())
    graph = min(cs.graph_ms(lambda: moe_q4.moe_ffn_decode_q4_fused(*args)) for _ in range(3))
    bound, _ = cs.bound_ms(cs.nbytes(x, x, *args[2:]) + n_read * e_bytes, 2 * b * (k + n_sh) * 3 * h * i,
                           torch.bfloat16)
    line = f"B {{b}} ({{n_read}} experts) graph {{graph:.4f}} ms, bound {{bound:.4f}} (err {{err:.1e}})"
    if b == 16:  # each launch's own device time, mean of 20 calls under torch.profiler
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                moe_q4.moe_ffn_decode_q4_fused(*args)
            torch.cuda.synchronize()
        parts = {{}}
        for ev in prof.key_averages():
            for name in ("schedule_kernel", "gu_q4_kernel", "down_q4_kernel"):
                if name in ev.key:
                    parts[name] = parts.get(name, 0.0) + ev.self_device_time_total / 1e3 / 20
        line += " [" + ", ".join(f"{{n}} {{ms:.4f}} ms" for n, ms in parts.items()) + "]"
    out.append(line)
print("[ablate {name}] " + "; ".join(out), flush=True)
"""


CHILD_M = r"""
import sys
sys.path.insert(0, {root!r})
sys.path.insert(1, {repo!r})
import torch
import chip_smoke as cs
from deepseek_ocr2_tpu_torch.ops import cuda_build, moe_q4
from deepseek_ocr2_tpu_torch.ops.moe import route

assert cuda_build.__file__.startswith({root!r}), cuda_build.__file__
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(cs.SEED)


def randn(*shape, std=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


e, k, h, i, n_sh = 64, 6, 1280, 896, 2


def experts(n):
    return moe_q4.quantize_experts_q4({{"gate": randn(n, i, h, std=h**-0.5), "up": randn(n, i, h, std=h**-0.5),
                                       "down": randn(n, h, i, std=i**-0.5)}})


eq = experts(e)
eq.update({{f"pe_{{name}}": t for name, t in experts(n_sh).items()}})
e_bytes = cs.nbytes(*(eq[name][0] for name in ("gu_q4", "gu_scale", "down_q4", "down_scale")))
router = randn(e, h, std=h**-0.5)
out = []
for b, shared in ((1, True), (8, False), (10, False)):
    x = randn(b, h, dtype=torch.bfloat16)
    args = (x, eq, *route(x, router, k))
    n_read = int(torch.unique(args[3]).numel()) + (n_sh if shared else 0)
    err = float((moe_q4.moe_ffn_decode_q4(*args, with_shared=shared).float()
                 - moe_q4.moe_ffn_decode_q4_reference(*args, with_shared=shared).float()).abs().max())
    graph = min(cs.graph_ms(lambda: moe_q4.moe_ffn_decode_q4(*args, with_shared=shared)) for _ in range(3))
    bound, _ = cs.bound_ms(cs.nbytes(x, x, *args[2:]) + n_read * e_bytes,
                           2 * b * (k + (n_sh if shared else 0)) * 3 * h * i, torch.bfloat16)
    line = f"B {{b}}{{' + 2 pseudo-experts' if shared else ''}} ({{n_read}} experts) graph {{graph:.4f}} ms, bound {{bound:.4f}} (err {{err:.1e}})"
    if b == 1:  # each launch's device time and a call's span, mean of 20 calls under torch.profiler
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                moe_q4.moe_ffn_decode_q4(*args, with_shared=shared)
            torch.cuda.synchronize()
        parts = {{}}
        for ev in prof.key_averages():
            for name in ("sel_gu_q4_kernel", "sel_down_q4_kernel"):
                if name in ev.key:
                    parts[name] = parts.get(name, 0.0) + ev.self_device_time_total / 1e3 / 20
        try:  # a call's span: its gate/up's start to its down's end, the median over the 20 calls
            kern = sorted((ev for ev in prof.events()
                           if "sel_" in ev.name and ev.device_type == torch.autograd.DeviceType.CUDA),
                          key=lambda ev: ev.time_range.start)
            spans = [kern[j + 1].time_range.end - kern[j].time_range.start for j in range(0, len(kern) - 1, 2)]
            span = sorted(spans)[len(spans) // 2] / 1e3 if spans else float("nan")
        except (AttributeError, IndexError):
            span = float("nan")
        line += " [" + ", ".join(f"{{n}} {{ms:.4f}} ms" for n, ms in parts.items()) + f", span {{span:.4f}} ms]"
    out.append(line)
print("[ablate {name}] " + "; ".join(out), flush=True)
"""


def prepare(name: str) -> str:
    """The variant's copy of the package, patched and built."""
    tree = os.path.join(ROOT, "build", "moe_q4_ablate", name)
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
    build = ("import sys; sys.path.insert(0, {!r}); from deepseek_ocr2_tpu_torch.ops import cuda_build; "
             "[cuda_build.load(n) for n in ('moe_q4', 'moe_decode')]").format(tree)
    subprocess.run([sys.executable, "-c", build], cwd=tree, check=True)
    return tree


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(8) as pool:  # nvcc runs as a child process
        trees = list(pool.map(prepare, names))
    for name, tree in zip(names, trees):
        child = (CHILD_M if name.startswith("m_") else CHILD).format(root=tree, repo=ROOT, name=name)
        rc = subprocess.run([sys.executable, "-c", child], cwd=tree).returncode
        if rc != 0:
            print(f"[ablate {name}] failed: rc {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
