"""Where kernel L's streaming form (1-4 rows of x) spends its time: each
variant changes one part of `csrc/linear_q4.cuh` in a copy of the package
and times L again through its wrapper in a CUDA graph, at the int4 decode
shapes of the full-width LM (lm_head 129 280 x 1280 at B 1 and 4, the
dense gate||up 13 696 x 1280 and down 1280 x 6848 at B 1; bf16 x, f32
out), with `torch._weight_int4pack_mm` on the same levels beside lm_head.

Variants (each a text patch of the header; the script stops if the header
no longer holds the text it patches):
- `none`: the kernel as it is (its errors against the twin printed);
- `two_blocks`: at most two blocks an SM instead of three;
- `one_block16`: one block an SM with 16 consumer warps and stages of 40
  KB, up to 4 of them (the first design);
- `stage40`: stages of 40 KB of codes instead of 20 (so two blocks an SM);
- `no_compute`: the consumers take no item: every stage is still loaded,
  waited on, released and reduced (the time of the stream alone);
- `no_load`: the producer loads nothing and releases each stage at once:
  the consumers' work alone, on stale shared memory.
A patched kernel may be wrong (`no_compute` is); only its time means
anything. Each variant runs in its own process on its own build (under
`build/q4_ablate/`). The wrapper's host time per call is printed too (calls
enqueued behind a long sleep kernel, so the card's time does not count).

    python3 scripts/torch_q4_ablate.py [none warps8 ...]   # on the card
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "deepseek_ocr2_tpu_torch/csrc/linear_q4.cuh"
MAX_BLOCKS = "constexpr int s_max_blocks() { return sizeof(T) == 2 ? 3 : 2; }"
STAGE = "constexpr int S_STAGE_CODES = 20 * 1024;"
LOAD = """      sm90::mbar_arrive_expect_tx(&full[slot], rows * rb + 4 * n_bulk);
      sm90::bulk_load(dst, q + (size_t)o0 * rb, rows * rb, &full[slot]);
      if (n_bulk) sm90::bulk_load(sdst, ssrc, 4 * n_bulk, &full[slot]);"""
VARIANTS = {
    "none": [],
    "two_blocks": [(MAX_BLOCKS, "constexpr int s_max_blocks() { return 2; }")],
    "one_block16": [(MAX_BLOCKS, "constexpr int s_max_blocks() { return 1; }"),
                    ("constexpr int S_WARPS = 8;", "constexpr int S_WARPS = 16;"),
                    (STAGE, "constexpr int S_STAGE_CODES = 40 * 1024;")],
    "stage40": [(STAGE, "constexpr int S_STAGE_CODES = 40 * 1024;")],
    "no_compute": [("      if (tile >= lay.rt) continue;", "      if (tile >= 0) continue;")],
    "no_load": [(LOAD, "      sm90::mbar_arrive(&full[slot]);")],
}

CHILD = r"""
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(1, {repo!r})
import torch
import chip_smoke as cs
from deepseek_ocr2_tpu_torch.ops import linear_q4

assert linear_q4.__file__.startswith({root!r}), linear_q4.__file__
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(cs.SEED)
out = []
for name, b, out_dim, in_dim in (("lm_head", 1, 129280, 1280), ("lm_head", 4, 129280, 1280),
                                 ("dense gate||up", 1, 13696, 1280), ("dense down", 1, 1280, 6848)):
    w = linear_q4.quantize_linear_q4(torch.randn(out_dim, in_dim, generator=g, device=dev) * in_dim**-0.5)
    x = torch.randn(b, in_dim, generator=g, device=dev).to(torch.bfloat16)

    def fn():
        return linear_q4.linear_q4(x, w, out_dtype=torch.float32)

    err = float((fn() - linear_q4.linear_q4_reference(x, w, out_dtype=torch.float32)).abs().max())
    graph = min(cs.graph_ms(fn) for _ in range(3))
    line = f"{{name}} B {{b}} graph {{graph:.4f}} ms (err {{err:.1e}})"
    if name == "lm_head":
        u = linear_q4.unpack_q4(w["q4"]).to(torch.int32) + 8
        packed = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack([w["scale"].T, torch.zeros_like(w["scale"].T)], dim=-1).to(torch.bfloat16).contiguous()
        line += f", library {{min(cs.graph_ms(lambda: torch._weight_int4pack_mm(x, packed, 128, sz)) for _ in range(3)):.4f}}"
        torch.cuda._sleep(400_000_000)  # the card busy for a while: the calls below only enqueue
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        line += f", host {{(time.perf_counter() - t0) / 100 * 1e6:.1f}} us"
        torch.cuda.synchronize()
    out.append(line)
print("[ablate {name}] " + "; ".join(out), flush=True)
"""


def main() -> int:
    names = sys.argv[1:] or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for name in names:
        tree = os.path.join(ROOT, "build", "q4_ablate", name)
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
