"""Run chosen `chip_smoke.py` phases of two checkouts in turns on one card.

Each turn is its own process, rooted at one checkout (its `chip_smoke.py`
and `deepseek_ocr2_tpu_torch/` are the ones imported; each builds its own
kernels), and the turns go A, B, B, A, so that drift of the card's clocks
over the call falls on both. Compare two commits only inside one such run.

Phases:
- `gmm_backward`: phase 2's grouped-GEMM backward cases (S, T and E at a
  training step's MoE layer, bf16 and f32), every case's line as
  chip_smoke prints it;
- `train`: phase 8 (`phase_train`), the full-width LM's AdamW steps with
  the step time and the profiled step.

    git archive <commit> | tar -x -C build/parent   # a checkout git ignores
    python3 scripts/torch_ab_phases.py build/parent . --phases gmm_backward train
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

CHILD = r"""
import sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as cs
import deepseek_ocr2_tpu_torch  # noqa: F401  (the f32 numerics flags)

dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(cs.SEED)


def randn(*shape, std=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


def record(kernel, case, ref, got, tol, ms, plain_ms, bound=None, library=None, graph=None, library_graph=False):
    err = float((got.float() - ref.float()).abs().max())
    lib = cs.median_ms(library) if library is not None else None
    dev_ms = cs.graph_ms(graph) if graph is not None else None
    try:  # a library call that cannot be captured in a graph is left out
        lib_dev = cs.graph_ms(library) if library is not None else None
    except RuntimeError as exc:
        lib_dev = f"none ({{exc}})"[:80]
    print(f"[ab {{sys.argv[1]}}] {{kernel}} {{case}}: err {{err:.3e}} (tol {{tol:.1e}}) kernel {{ms:.4f}} ms, graph "
          f"{{dev_ms}}, plain {{plain_ms:.3f}}, bound {{bound}}, library {{lib}}, library graph {{lib_dev}}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{{kernel}} {{case}}: error {{err}} above {{tol}}")


for phase in {phases!r}:
    if phase == "gmm_backward":
        cs.gmm_backward_results(dev, randn, record)
    elif phase == "train":
        cs.phase_train(dev)
    else:
        raise SystemExit(f"unknown phase {{phase}}")
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="checkout A (e.g. the parent commit, unpacked)")
    ap.add_argument("b", help="checkout B (e.g. .)")
    ap.add_argument("--phases", nargs="+", default=["gmm_backward", "train"])
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for label, tree in (("A", args.a), ("B", args.b), ("B", args.b), ("A", args.a)):
        root = os.path.abspath(tree)
        print(f"[ab] turn {label}: {root}", flush=True)
        code = CHILD.format(root=root, phases=args.phases)
        rc = subprocess.run([sys.executable, "-c", code, label], cwd=root).returncode
        if rc != 0:
            print(f"[ab] turn {label} failed: rc {rc}", flush=True)
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
