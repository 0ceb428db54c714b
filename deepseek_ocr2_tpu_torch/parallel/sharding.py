"""How the LM's parameters split over the mesh's `mp` axis (port of
deepseek_ocr2_tpu.parallel.sharding, Megatron-style TP and EP), stated on
the port's HF-layout [out, in] weights:
- wq / wk / wv and the dense and shared MLPs' gate / up split their output
  rows (dim 0): whole heads, whole intermediate columns;
- wo and the MLPs' down split their input columns (dim 1): each rank's
  product is a partial sum, reduced over mp (`collectives.reduce_from_mp`);
- the routed experts split their expert axis (dim 0, EP);
- lm_head splits the vocab rows (dim 0);
- embed, the norms and the router stay whole on every rank.
The JAX package's `P(None, None, "mp")` on its [L, in, out] stacks is the
port's dim 0: each rule reads the JAX file's meaning, not its axis index.
Every dp rank holds the same shards.

Quantized trees (`models.deepseek_v2.quantize_lm_params`) follow the JAX
package's `lm_param_specs_q8`, leaf by leaf (`lm_param_specs_q8` here):
- int8 linears {"q8" [Out, In], "scale" [Out]} of scope "full" (wqkv, wo,
  the dense and shared MLPs' gu and down) split their contraction columns
  (dim 1; the JAX "row-sharded" P("mp", None) on [In, Out]): a q||k||v or
  gate||up boundary need not fall on an mp cut of the output, and each
  rank's product is a partial sum, reduced over mp; the per-output scales
  stay whole;
- int4 linears {"q4" [Out, In_p / 2], "scale" [Out, In_p / 128]} split
  their output rows (dim 0) in both leaves: a cut of the packed input need
  not land on a packed block, so the JAX package shards the output axis,
  and each rank's rows are the unsharded product's rows bit for bit;
- the routed experts (int8 or int4: gu_*, down_* and their scales) split
  their expert axis (dim 0, EP); the shared pseudo-experts `pe_*` stay
  whole on every rank;
- lm_head (int8 or int4) splits its vocab rows, the scale with them;
- under scope "experts" the attention, the dense and shared MLPs and
  lm_head are unquantized and keep the rules above.
An int8 linear's scale is 1-D and an int4 one's 2-D, so the rule of a
".scale" leaf reads its rank (`split_dim(path, ndim)`).

`shard_params` cuts a whole tree into this rank's shards and records the
mesh in it ("mesh"), where the forward, the loss and the optimizer read
it; `gather_params` and `gather_leaves` put whole leaves back together
(checkpoints, `--out`, tests)."""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch

from ..configs import DeepseekV2Config
from .collectives import _all_gather
from .mesh import Mesh


class Split(NamedTuple):
    """A leaf cut over mp along `dim` in whole units of `unit` elements,
    `name` counting the units (for the error an mp that does not divide
    them raises)."""

    dim: int
    unit: int
    name: str


# Per-layer leaves below "layers.<i>." -> (dim, the config dimension it
# counts, whether a unit is one head).
_LAYER_RULES = {
    "wq": (0, "num_attention_heads", True), "wk": (0, "num_attention_heads", True),
    "wv": (0, "num_attention_heads", True), "wo": (1, "num_attention_heads", True),
    "mlp.gate": (0, "intermediate_size", False), "mlp.up": (0, "intermediate_size", False),
    "mlp.down": (1, "intermediate_size", False),
    "shared.gate": (0, "n_shared_experts * moe_intermediate_size", False),
    "shared.up": (0, "n_shared_experts * moe_intermediate_size", False),
    "shared.down": (1, "n_shared_experts * moe_intermediate_size", False),
    "experts.gate": (0, "n_routed_experts", False), "experts.up": (0, "n_routed_experts", False),
    "experts.down": (0, "n_routed_experts", False),
}


# Quantized linears of scope "full" below "layers.<i>." -> (the config
# dimension an int8 linear's contraction counts, whether a unit is one head;
# the dimension an int4 linear's output rows count).
_QLINEAR_RULES = {
    "wqkv": (("hidden_size", False), "3 * hidden_size"),
    "wo": (("num_attention_heads", True), "hidden_size"),
    "mlp.gu": (("hidden_size", False), "2 * intermediate_size"),
    "mlp.down": (("intermediate_size", False), "hidden_size"),
    "shared.gu": (("hidden_size", False), "2 * n_shared_experts * moe_intermediate_size"),
    "shared.down": (("n_shared_experts * moe_intermediate_size", False), "hidden_size"),
}


def _rule(path: str, ndim: Optional[int] = None):
    """(dim, name, per_head) of an LM leaf named by its `param_items` path
    in an LM tree or a composite OCR tree ("lm." first), None for a
    replicated leaf (and for every leaf of the vision towers). A quantized
    linear's ".scale" leaf needs its `ndim` (1: int8, 2: int4)."""
    if path.startswith("lm."):
        path = path[3:]
    if path == "lm_head" or path.startswith("lm_head."):
        return 0, "vocab_size", False
    parts = path.split(".")
    if len(parts) < 3 or parts[0] != "layers":
        return None
    name = ".".join(parts[2:])
    if parts[2] == "experts_q8":
        return None if parts[3].startswith("pe_") else (0, "n_routed_experts", False)
    owner, leaf = ".".join(parts[2:-1]), parts[-1]
    if owner in _QLINEAR_RULES and leaf in ("q8", "q4", "scale"):
        (contraction, per_head), rows = _QLINEAR_RULES[owner]
        if leaf == "q8":
            return 1, contraction, per_head
        if leaf == "scale" and ndim is None:
            raise ValueError(f"the rule of {path} needs the scale's rank (int8 1, int4 2)")
        return None if leaf == "scale" and ndim == 1 else (0, rows, False)
    return _LAYER_RULES.get(name)


def split_dim(path: str, ndim: Optional[int] = None) -> Optional[int]:
    """The dim of the leaf `path` (of rank `ndim`, which a quantized
    linear's scale needs) that splits over mp, None if it is whole on
    every rank."""
    rule = _rule(path, ndim)
    return None if rule is None else rule[0]


def lm_param_specs(cfg: DeepseekV2Config) -> Dict[str, Any]:
    """The port's LM tree (`models.deepseek_v2.params_from_flat`) with a
    `Split` or None at each leaf."""

    def spec(path):
        rule = _rule(path)
        if rule is None:
            return None
        dim, name, per_head = rule
        return Split(dim, cfg.head_dim if per_head else 1, name)

    layers = []
    for i in range(cfg.num_hidden_layers):
        names = ["ln1", "ln2", "wq", "wk", "wv", "wo"]
        if i < cfg.first_k_dense_replace:
            names += ["mlp.gate", "mlp.up", "mlp.down"]
        else:
            names += ["router"] + [f"{g}.{n}" for g in ("experts", "shared") for n in ("gate", "up", "down")]
        layer: Dict[str, Any] = {}
        for n in names:
            node = layer
            *outer, leaf = n.split(".")
            for o in outer:
                node = node.setdefault(o, {})
            node[leaf] = spec(f"layers.{i}.{n}")
        layers.append(layer)
    return {"embed": None, "layers": layers, "norm": None, "lm_head": spec("lm_head")}


def lm_param_specs_q8(cfg: DeepseekV2Config, params) -> Dict[str, Any]:
    """The quantized LM tree `params` (`quantize_lm_params`, int8 or int4,
    either scope) with a `Split` or None at each leaf (the JAX package's
    `lm_param_specs_q8`; see the module docstring)."""
    from ..runtime.train import param_items, tree_like

    def spec(path, t):
        rule = _rule(path, t.dim())
        if rule is None:
            return None
        dim, name, per_head = rule
        return Split(dim, cfg.head_dim if per_head else 1, name)

    return tree_like(params, [spec(n, t) for n, t in param_items(params)])


def _cut(t: torch.Tensor, split: Optional[Split], mesh: Mesh, where: str) -> torch.Tensor:
    if split is None:
        return t.to(mesh.device, copy=True)
    count = t.shape[split.dim] // split.unit
    if count * split.unit != t.shape[split.dim] or count % mesh.mp:
        raise ValueError(f"mp={mesh.mp} does not divide {split.name}={count} ({where}: dim {split.dim} of "
                         f"{tuple(t.shape)})")
    n = t.shape[split.dim] // mesh.mp
    return t.narrow(split.dim, mesh.mp_rank * n, n).to(mesh.device, copy=True).contiguous()


def shard_params(params, mesh: Mesh, specs) -> Dict[str, Any]:
    """This rank's shards of a whole LM tree, plain or quantized (each leaf
    copied to the mesh's device), with the mesh recorded under "mesh".
    `specs`: `lm_param_specs`, or `lm_param_specs_q8` for a quantized tree.
    Raises ValueError naming the dimension when mp does not divide a split
    one."""

    def walk(node, spec, path):
        if isinstance(node, torch.Tensor):
            return _cut(node, spec, mesh, path)
        if isinstance(node, dict):
            return {k: walk(v, spec[k], f"{path}.{k}" if path else k) for k, v in node.items() if k != "mesh"}
        return [walk(v, s, f"{path}.{i}") for i, (v, s) in enumerate(zip(node, spec))]

    out = walk(params, specs, "")
    out["mesh"] = mesh
    return out


def local_slice(path: str, t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's part of the whole leaf `path` (a view), e.g. of a
    checkpoint's tensor."""
    dim = split_dim(path, t.dim())
    if mesh is None or mesh.mp == 1 or dim is None:
        return t
    n = t.shape[dim] // mesh.mp
    return t.narrow(dim, mesh.mp_rank * n, n)


def gather_leaves(paths: Sequence[str], tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """Whole leaves from this rank's shards (`param_items` paths beside the
    tensors: params, gradients or moments), on every rank of the mp group
    (all-gather, so the same call serves any rank)."""
    if mesh is None or mesh.mp == 1:
        return list(tensors)
    out = []
    for path, t in zip(paths, tensors):
        dim = split_dim(path, t.dim())
        out.append(t if dim is None else torch.cat(_all_gather(t, mesh.mp_group, mesh.mp), dim=dim))
    return out


def gather_params(params, mesh: Optional[Mesh] = None):
    """The whole tree (without "mesh") from a sharded one, on every rank
    of its mp group; an unsharded tree is returned as it is."""
    from ..runtime.train import param_items, tree_like

    mesh = mesh or params.get("mesh")
    if mesh is None:
        return params
    items = param_items(params)
    return tree_like(params, gather_leaves([n for n, _ in items], [t for _, t in items], mesh))


def check_mp(cfg: DeepseekV2Config, mp: int, scope: Optional[str] = None, bits: int = 8) -> None:
    """Raise ValueError naming the first of the LM's split dimensions that
    `mp` does not divide (what `shard_params` would refuse), before any
    weight is read: of the unquantized LM, or (`scope` "experts" or "full",
    `bits` 8 or 4) of `quantize_lm_params`'s tree, whose linears' dimensions
    come from `_QLINEAR_RULES`, the table `lm_param_specs_q8` splits by."""
    names = ["num_attention_heads", "vocab_size"]
    if cfg.first_k_dense_replace:
        names.append("intermediate_size")
    if cfg.num_moe_layers:
        names += ["n_routed_experts", "n_shared_experts * moe_intermediate_size"]
    if scope == "full":
        owners = ["wqkv", "wo"] + ["mlp.gu", "mlp.down"] * bool(cfg.first_k_dense_replace) \
            + ["shared.gu", "shared.down"] * bool(cfg.num_moe_layers)
        # int8: the contraction's dimension; int4: the output rows'.
        names += [_QLINEAR_RULES[o][0][0] if bits == 8 else _QLINEAR_RULES[o][1] for o in owners]
    for name in names:
        count = math.prod(int(f) if f.isdigit() else getattr(cfg, f) for f in name.split(" * "))
        if mp < 1 or count % mp:
            raise ValueError(f"mp={mp} does not divide {name}={count}")
