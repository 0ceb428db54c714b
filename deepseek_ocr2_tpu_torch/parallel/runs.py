"""What a rank runs under a mesh, for callers that start a world with
`launch.launch` and hold the result to an unsharded run: the tests, against
the JAX package under its own mesh (`chip_smoke.py` phase 9 builds on the
same helpers). The counterpart of the JAX package's
`__graft_entry__._dryrun_multichip_impl`.

`run_cases(rank, world, device, cases)` runs a list of cases in one world;
each case names its kind, its (dp, mp) and its arguments, and runs on a
mesh over the world's first dp * mp ranks (the others wait). Rank 0 is
always the mesh's first rank and returns {case name: result}. The kinds:
- "lm_steps": the LM's loss and gathered gradients (`value_and_grad`),
  then AdamW steps; whether the replicated leaves stayed equal over mp;
  how many grouped-GEMM MoE forms each rank's forward built;
- "greedy": `greedy_generate` on the sharded LM;
- "ocr_prefill": the OCR prefill's last logits on each dp rank's pages;
- "ocr_steps": `ocr_loss`'s gathered gradients, whether the vision
  towers' gradients are equal on every rank, then AdamW OCR steps.
Params arrive whole (a CPU tree, e.g. from `params_from_jax`) or as a
recipe for random ones made on the rank's device ({"random": seed,
"dtype": ...}); every rank cuts its own shards.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models import deepseek_v2 as dsv2
from ..models.deepseek_ocr2 import ocr_prefill_embeds_batched
from ..runtime import train
from ..runtime.generate import greedy_generate
from ..runtime.kv_cache import make_kv_cache
from .collectives import _all_gather, all_gather_dp, equal_across
from .mesh import Mesh, dp_rows, make_mesh
from .sharding import gather_leaves, lm_param_specs, shard_params, split_dim


def random_lm_params(cfg, seed: int, device, dtype=torch.float32) -> Dict[str, Any]:
    """Random LM params in the port's layout from a seeded generator on
    `device` (the same tree on every rank that asks with the same seed):
    embeddings N(0, 1), norms 1 + N(0, 0.02^2), each [out, in] matrix
    N(0, 1 / in)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(shape, std):
        return (torch.randn(shape, generator=g, device=device) * std).to(dtype)

    def lin(out_f, in_f, lead=()):
        return randn((*lead, out_f, in_f), in_f**-0.5)

    h = cfg.hidden_size
    params = {"embed": randn((cfg.vocab_size, h), 1.0), "norm": 1.0 + randn((h,), 0.02),
              "lm_head": lin(cfg.vocab_size, h), "layers": []}
    for i in range(cfg.num_hidden_layers):
        layer = {"ln1": 1.0 + randn((h,), 0.02), "ln2": 1.0 + randn((h,), 0.02),
                 **{f"w{n}": lin(h, h) for n in "qkvo"}}
        if i < cfg.first_k_dense_replace:
            im = cfg.intermediate_size
            layer["mlp"] = {"gate": lin(im, h), "up": lin(im, h), "down": lin(h, im)}
        else:
            im, e = cfg.moe_intermediate_size, cfg.n_routed_experts
            ish = im * cfg.n_shared_experts
            layer["router"] = lin(e, h)
            layer["experts"] = {"gate": lin(im, h, (e,)), "up": lin(im, h, (e,)), "down": lin(h, im, (e,))}
            layer["shared"] = {"gate": lin(ish, h), "up": lin(ish, h), "down": lin(h, ish)}
        params["layers"].append(layer)
    return params


def replicate(tree, device):
    """A copy of every tensor of `tree` on `device` (whole on every rank)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: replicate(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [replicate(v, device) for v in tree]
    return tree


def shard_lm(spec, cfg, mesh: Mesh):
    """This rank's shards of the LM `spec`: a whole tree, or a recipe for
    random params made on the rank's device ({"random": seed, "dtype"})."""
    if isinstance(spec, dict) and "random" in spec:
        full = random_lm_params(cfg, spec["random"], mesh.device, spec.get("dtype", torch.float32))
    else:
        full = spec
    out = shard_params(full, mesh, lm_param_specs(cfg))
    del full
    return out


def every_rank(value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[dp * mp, ...]: `value` of every rank of the mesh, in mesh order, on
    every rank."""
    row = torch.stack(_all_gather(value, mesh.mp_group, mesh.mp)) if mesh.mp > 1 else value[None]
    return torch.cat(_all_gather(row, mesh.dp_group, mesh.dp)) if mesh.dp > 1 else row


def _grouped_forms(fn) -> int:
    """How many grouped-GEMM MoE forms (`MoeFfnGmm`) the autograd graph of
    fn()'s output holds."""
    with torch.enable_grad():
        out = fn()
    seen, stack, n = set(), [out.grad_fn], 0
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        n += "MoeFfnGmm" in type(node).__name__
        stack.extend(nxt for nxt, _ in node.next_functions)
    return n


def _gathered(names: List[str], tensors, mesh: Mesh) -> Dict[str, torch.Tensor]:
    return dict(zip(names, (t.float().cpu() for t in gather_leaves(names, tensors, mesh))))


def lm_steps(mesh: Mesh, cfg, params, ids, mask=None, steps: int = 0, tx=None, grads: bool = True,
             count_grouped: bool = False) -> Dict[str, Any]:
    p = shard_lm(params, cfg, mesh)
    rows = dp_rows(torch.as_tensor(ids), mesh).to(mesh.device)
    extra = () if mask is None else (dp_rows(torch.as_tensor(mask), mesh).to(mesh.device),)
    loss_fn = train.lm_loss if mask is None else train.lm_loss_masked
    items = train.param_items(p)
    names = [n for n, _ in items]
    res: Dict[str, Any] = {}
    if count_grouped:
        leaves = [t for _, t in items]
        for t in leaves:
            t.requires_grad_(True)
        n = _grouped_forms(lambda: loss_fn(p, cfg, rows, *extra))
        for t in leaves:
            t.requires_grad_(False)
        res["grouped_forms"] = every_rank(torch.tensor([n], device=mesh.device), mesh).cpu()
    if grads:
        loss, g = train.value_and_grad(loss_fn, p, cfg, rows, *extra)
        res["loss"] = float(loss)
        res["grads"] = _gathered(names, g, mesh)
        del g
    if steps:
        opt = train.make_optimizer(**(tx or {}))
        state = opt.init(p)
        step = train.adamw_train_step if mask is None else train.adamw_sft_train_step
        res["losses"] = [float(step(p, state, cfg, rows, *extra, opt)) for _ in range(steps)]
        res["params"] = _gathered(names, [t for _, t in items], mesh)
    res["replicated_equal"] = equal_across([t for n, t in items if split_dim(n) is None], mesh, "mp")
    return res


def greedy(mesh: Mesh, cfg, params, ids, **kw) -> Dict[str, Any]:
    p = shard_lm(params, cfg, mesh)
    ids = torch.as_tensor(ids).to(mesh.device)
    tokens, n_gen = greedy_generate(p, cfg, F.embedding(ids, p["embed"]), ids, **kw)
    return {"tokens": tokens.cpu(), "n_gen": n_gen.cpu(),
            "same_on_every_rank": equal_across([tokens, n_gen], mesh, "mp") and
            equal_across([tokens, n_gen], mesh, "dp")}


def shard_ocr(params, cfg, mesh: Mesh):
    """A composite OCR tree on this rank: the vision towers whole, the LM
    `shard_lm`'s."""
    out = {k: replicate(v, mesh.device) for k, v in params.items() if k != "lm"}
    out["lm"] = shard_lm(params["lm"], cfg.lm, mesh)
    return out


def ocr_prefill(mesh: Mesh, cfg, params, ids, images, image_start: int = 1) -> Dict[str, Any]:
    p = shard_ocr(params, cfg, mesh)
    ids_l = dp_rows(torch.as_tensor(ids), mesh).to(mesh.device)
    imgs = dp_rows(torch.as_tensor(images), mesh).to(mesh.device)
    with torch.no_grad():
        embeds = ocr_prefill_embeds_batched(p, cfg, ids_l, imgs, None, image_start)
        lm, b, s = cfg.lm, ids_l.shape[0], ids_l.shape[1]
        cache = make_kv_cache(lm.num_hidden_layers, b, dsv2.n_heads(p["lm"]["layers"][0], lm), s, lm.head_dim,
                              dtype=torch.float32, device=mesh.device)
        hidden = dsv2.lm_forward(p["lm"], lm, embeds, cache, pos=0, is_prefill=True)
        logits = all_gather_dp(dsv2.logits_last(p["lm"], hidden), mesh)
    return {"logits": logits.float().cpu()}


def ocr_steps(mesh: Mesh, cfg, params, ids, images, patches, image_start: int, mask, steps: int = 0,
              tx=None) -> Dict[str, Any]:
    p = shard_ocr(params, cfg, mesh)

    def local(t):
        return None if t is None else dp_rows(torch.as_tensor(t), mesh).to(mesh.device)

    args = (cfg, local(ids), local(images), local(patches), image_start, local(mask))
    items = train.param_items(p)
    names = [n for n, _ in items]
    loss, g = train.value_and_grad(train.ocr_loss, p, *args)
    towers = [t for n, t in zip(names, g) if not n.startswith("lm.")]
    res = {"loss": float(loss), "grads": _gathered(names, g, mesh),
           "towers_equal": equal_across(towers, mesh, "mp") and equal_across(towers, mesh, "dp")}
    del g
    if steps:
        opt = train.make_optimizer(**(tx or {}))
        state = opt.init(p)
        res["losses"] = [float(train.adamw_ocr_train_step(p, state, *args, opt)) for _ in range(steps)]
    return res


KINDS = {"lm_steps": lm_steps, "greedy": greedy, "ocr_prefill": ocr_prefill, "ocr_steps": ocr_steps}


def run_cases(rank: int, world: int, device, cases: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Each case {"name", "kind", "dp", "mp", "args"} on a mesh over ranks
    0 .. dp * mp - 1 (`launch` entry; see the module docstring). Rank 0
    returns {name: result, name + ".seconds": wall time}."""
    out: Dict[str, Any] = {}
    for case in cases:
        t0 = time.perf_counter()
        mesh = make_mesh(case["dp"], case["mp"], ranks=range(case["dp"] * case["mp"]), device=device)
        res = KINDS[case["kind"]](mesh, **case["args"]) if mesh is not None else None
        dist.barrier()
        if rank == 0:
            out[case["name"]] = res
            out[case["name"] + ".seconds"] = time.perf_counter() - t0
    return out
