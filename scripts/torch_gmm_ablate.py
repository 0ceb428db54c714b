"""Where kernels D, S and T (bf16) spend their time: each ablation removes
one part of `csrc/moe_gmm.cu` in a copy of the package and times the
kernels again, in a CUDA graph: D at the prompt of a 2-crop page (N 550)
and at a training step's MoE layer, D through its row map (the forward's
form) at N 550 and at a 6-crop page's 1124 tokens, the whole routed chain
(`moe_ffn_gmm`) and the layout kernel alone at N 550, S and T at the training step's (B 4 x S
512 tokens, k 6 of 64 experts, H 1280, I 896: 12 288 rows, chip_smoke's
phase 2 shapes).

Ablations (each a text patch of the source; the script stops if the source
no longer holds the text it patches):
- `none`: the kernels as they are (their errors against the twins printed),
  and D's yardstick, one `torch._grouped_mm` call over the gate||up weight
  (the products alone, no SwiGLU), in a CUDA graph;
- `rows_no_store`: D's, E's and S's epilogue (gmm_rows_wgmma_kernel)
  computes its tile but issues no TMA store;
- `rows_no_load`: D's, E's and S's producer loads nothing by TMA (the
  stages complete at once, stale): the consumers' time alone (D through
  its row map still copies its rows);
- `d_gather_one_warp`: D through its row map with one producer warp (32
  threads, 32 copies each a stage) in place of a producer warpgroup (128
  threads, 8 each);
- `d_gather_no_fence`: D through its row map without the consumers' proxy
  fence before wgmma;
- `d_gather_no_copy`: D through its row map issues no row copy (its A
  stale): the map's control flow and the weights' loads alone;
- `d_no_mma`: D loads every stage but runs no wgmma;
- `d_no_swiglu`: D's epilogue stores the gate sums, no SwiGLU;
- `d_stages3`: D on three stages of 48 KB, as E and S, in place of four;
- `s_no_mma`: S (and E) load every stage but run no wgmma;
- `t_no_store`: T issues no TMA store of its f32 sums;
- `t_no_mma`: T loads every stage but runs no wgmma.
An ablated kernel's output is wrong; only its time means anything. Each
ablation runs in its own process on its own build (under `build/gmm_ablate/`).
The wrapper's host time per call is printed too (calls enqueued behind a
long sleep kernel, so the card's time does not count).

    python3 scripts/torch_gmm_ablate.py [none rows_no_store ...]   # on the card
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "deepseek_ocr2_tpu_torch/csrc/moe_gmm.cu"
ROWS_STORE = ("if (n0 + 64 * j < n_dim) sm90::tma_store_2d(&map_out, ob + (rt * (BN / 64) + j) * SX_OUT_BOX, "
              "n0 + 64 * j, t * BM);")
ROWS_LOAD = ("            sm90::mbar_arrive_expect_tx(bar, GATHER ? SX_STAGE_BYTES - SX_A_BYTES : SX_STAGE_BYTES);\n"
             "            if (!GATHER) sm90::tma_load_2d(st, &map_a, bar, ks * SX_BK, t0 * BM);\n"
             "#pragma unroll\n"
             "            for (int j = 0; j < 4; ++j) {")
GATHER_COPY = ("cp_async16(st + r * 128 + ((c ^ (r % 8)) * 16), live ? a + (size_t)src * k_dim + k0 : a, live);")
GATHER_FENCE = "if (GATHER) sm90::fence_proxy_async();"
D_MMA = ("            sm90::wgmma_m64n128k16<0>(acc, dak, sm90::desc_add(db, 32 * kk));\n"
         "            sm90::wgmma_m64n128k16<64>(acc, dak, sm90::desc_add(db, 2 * SX_B_BOX + 32 * kk));")
D_SWIGLU = "v = __floats2bfloat162_rn(swiglu(acc[a], acc[64 + a]), swiglu(acc[a + 1], acc[65 + a]));"
S_MMA = ("sm90::wgmma_m64n256k16<0, KIND>(acc, dak, sm90::desc_add(db, (KIND == ROWS_N_MAJOR ? 16 * 128 : 32) * kk));")
T_STORE = "sm90::tma_store_3d(&map_dw, ob + box * (64 * 128), c0 + 32 * box, o0 + 64 * wg, e);"
T_MMA = ("sm90::wgmma_m64n256k16<1, 1>(acc, da, db);\n"
         "      sm90::wgmma_m64n256k16<1, 1>(acc, sm90::desc_add(da, 16 * 128), sm90::desc_add(db, 16 * 128));")
ABLATIONS = {
    "none": [],
    "rows_no_store": [(ROWS_STORE, ";")],
    "rows_no_load": [(ROWS_LOAD, "            sm90::mbar_arrive(bar);\n            for (int j = 0; j < 0; ++j) {")],
    "d_gather_one_warp": [("constexpr int GATHER_BLOCK = 384;", "constexpr int GATHER_BLOCK = 288;"),
                          ("const int r = 16 * q + p / 8, src = prow[r];", "const int r = 4 * q + p / 8, src = prow[r];"),
                          ("for (int q = 0; q < SX_ROWS / 16; ++q) {", "for (int q = 0; q < SX_ROWS / 4; ++q) {"),
                          ("prow[p] = t0 + p / BM < t_end ? a_rows[(size_t)t0 * BM + p] : -1;",
                           "for (int r = p; r < SX_ROWS; r += 32) prow[r] = t0 + r / BM < t_end ? "
                           "a_rows[(size_t)t0 * BM + r] : -1;")],
    "d_gather_no_fence": [(GATHER_FENCE, ";")],
    "d_gather_no_copy": [(GATHER_COPY, ";")],
    "d_no_mma": [(D_MMA, "            ;")],
    "d_no_swiglu": [(D_SWIGLU, "v = __floats2bfloat162_rn(acc[a], acc[a + 1]);")],
    "d_stages3": [("constexpr int ROWS_STAGES = KIND == ROWS_SWIGLU ? 4 : SX_STAGES;",
                   "constexpr int ROWS_STAGES = SX_STAGES;")],
    "s_no_mma": [(S_MMA, ";")],
    "t_no_store": [(T_STORE, ";")],
    "t_no_mma": [(T_MMA, ";")],
}

CHILD = r"""
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(1, {repo!r})
import torch
import chip_smoke as cs
from deepseek_ocr2_tpu_torch.ops import moe_gmm
from deepseek_ocr2_tpu_torch.ops.moe import route

assert moe_gmm.__file__.startswith({root!r}), moe_gmm.__file__
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(cs.SEED)


def randn(*shape, std=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)


e, k, h, i, n, dt = 64, 6, 1280, 896, cs.TRAIN_B * cs.TRAIN_S, torch.bfloat16
x = randn(n, h, dtype=dt)
wd, wg = randn(e, h, i, std=i**-0.5, dtype=dt), randn(e, i, h, std=h**-0.5, dtype=dt)
_, idx = route(x, randn(e, h, std=h**-0.5), k)
x_al, e_tile, tile_valid, _ = moe_gmm.align_rows(x, idx, e)
dy, act = randn(x_al.shape[0], h, dtype=dt), randn(x_al.shape[0], i, dtype=dt)
tile_lo = moe_gmm.expert_tile_ranges(e_tile, tile_valid, e)
blk_lo = moe_gmm.row_block_lo(tile_lo)
# D at N 550 (a 2-crop prompt) on its own layout, and at the training rows.
x5 = randn(550, h, dtype=dt)
_, idx5 = route(x5, randn(e, h, std=h**-0.5), k)
x5_al, e_tile5, tile_valid5, _ = moe_gmm.align_rows(x5, idx5, e)
sched5 = moe_gmm.row_schedule(e_tile5, tile_valid5, e)
wu = randn(e, i, h, std=h**-0.5, dtype=dt)
cases = [
    ("D N 550", (x5_al, wg, wu), lambda a, w, u: moe_gmm.moe_gmm_swiglu(a, w, u, e_tile5, tile_valid5, *sched5),
     lambda a, w, u: moe_gmm.gmm_swiglu_reference(a, w, u, e_tile5, tile_valid5)),
    ("D N 2048", (x_al, wg, wu), lambda a, w, u: moe_gmm.moe_gmm_swiglu(a, w, u, e_tile, tile_valid, tile_lo, blk_lo),
     lambda a, w, u: moe_gmm.gmm_swiglu_reference(a, w, u, e_tile, tile_valid)),
    ("S dact", (dy, wd), lambda a, w: moe_gmm.moe_gmm_dx(a, w, e_tile, tile_valid, tile_lo, blk_lo),
     lambda a, w: moe_gmm.gmm_dx_reference(a, w, e_tile, tile_valid)),
    ("S dx_gate", (act, wg), lambda a, w: moe_gmm.moe_gmm_dx(a, w, e_tile, tile_valid, tile_lo, blk_lo),
     lambda a, w: moe_gmm.gmm_dx_reference(a, w, e_tile, tile_valid)),
    ("T dW_gate", (x_al, act), lambda a, b: moe_gmm.moe_gmm_dw(a, b, e_tile, tile_valid, e, tile_lo),
     lambda a, b: moe_gmm.gmm_dw_reference(a, b, e_tile, tile_valid, e)),
    ("T dW_down", (act, dy), lambda a, b: moe_gmm.moe_gmm_dw(a, b, e_tile, tile_valid, e, tile_lo),
     lambda a, b: moe_gmm.gmm_dw_reference(a, b, e_tile, tile_valid, e)),
]
# D through its row map, as the forward calls it, and the whole chain.
for n_tok in (550, 1124):
    xm = randn(n_tok, h, dtype=dt)
    wts, idm = route(xm, randn(e, h, std=h**-0.5), k)
    lay = moe_gmm.routed_layout(idm, e)
    xm_al, et_m, tv_m, _ = moe_gmm.align_rows(xm, idm, e)
    sched_m = (lay.e_tile, lay.tile_valid, lay.tile_lo, lay.blk_lo)
    cases.append((f"Dmap N {{n_tok}}", (xm, wg, wu),
                  lambda a, w, u, sched_m=sched_m, lay=lay: moe_gmm.moe_gmm_swiglu(a, w, u, *sched_m,
                                                                                    x_rows=lay.x_rows),
                  lambda a, w, u, xm_al=xm_al, et_m=et_m, tv_m=tv_m: moe_gmm.gmm_swiglu_reference(
                      xm_al, w, u, et_m, tv_m)))
    if n_tok == 550:
        ex5 = {{"gate": wg, "up": wu, "down": wd}}
        cases.append(("Y N 550", (xm, ex5, wts, idm), moe_gmm.moe_ffn_gmm, moe_gmm.moe_ffn_gmm_reference))
        cases.append(("layout N 550", (idm,), lambda i: moe_gmm.routed_layout(i, e).rows,
                      lambda i: moe_gmm.routed_layout_reference(i, e).rows))
out = []
for name, args, fn, twin in cases:
    err = float((fn(*args).float() - twin(*args).float()).abs().max())
    graph = min(cs.graph_ms(lambda: fn(*args)) for _ in range(3))
    torch.cuda._sleep(400_000_000)  # the card busy for a while: the calls below only enqueue
    t0 = time.perf_counter()
    for _ in range(100):
        fn(*args)
    host_us = (time.perf_counter() - t0) / 100 * 1e6
    torch.cuda.synchronize()
    out.append(f"{{name}} graph {{graph:.4f}} ms (err {{err:.1e}}), host {{host_us:.1f}} us")
if {name!r} == "none":  # D's yardstick: one torch._grouped_mm call over gate||up, the products alone
    for label, a, et, tv in (("D N 550", x5_al, e_tile5, tile_valid5), ("D N 2048", x_al, e_tile, tile_valid)):
        lib = cs.grouped_mm_library("D", a, torch.cat([wg, wu], 1), et, tv)
        if lib is not None:
            out.append(f"{{label}} library graph {{cs.graph_ms(lib):.4f}} ms")
print("[ablate {name}] " + "; ".join(out), flush=True)
"""


def main() -> int:
    names = sys.argv[1:] or list(ABLATIONS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for name in names:
        tree = os.path.join(ROOT, "build", "gmm_ablate", name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "deepseek_ocr2_tpu_torch"), os.path.join(tree, "deepseek_ocr2_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(tree, SRC)
        text = open(path).read()
        for old, new in ABLATIONS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {SRC} no longer holds the text this ablation patches: {old[:60]}")
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
