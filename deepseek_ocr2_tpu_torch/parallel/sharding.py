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

`shard_params` cuts a whole tree into this rank's shards and records the
mesh in it ("mesh"), where the forward, the loss and the optimizer read
it; `gather_params` and `gather_leaves` put whole leaves back together
(checkpoints, `--out`, tests)."""

from __future__ import annotations

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


def _rule(path: str):
    """(dim, name, per_head) of an LM leaf named by its `param_items` path
    in an LM tree or a composite OCR tree ("lm." first), None for a
    replicated leaf (and for every leaf of the vision towers)."""
    if path.startswith("lm."):
        path = path[3:]
    if path == "lm_head":
        return 0, "vocab_size", False
    parts = path.split(".")
    if len(parts) >= 3 and parts[0] == "layers":
        return _LAYER_RULES.get(".".join(parts[2:]))
    return None


def split_dim(path: str) -> Optional[int]:
    """The dim of the leaf `path` that splits over mp, None if it is whole
    on every rank."""
    rule = _rule(path)
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
    """This rank's shards of a whole LM tree (each leaf copied to the mesh's
    device), with the mesh recorded under "mesh". Raises ValueError naming
    the dimension when mp does not divide a split one. Quantized LM params
    are refused (their layout under a mesh is not ported)."""
    if isinstance(params["lm_head"], dict) or any("wqkv" in l or "experts_q8" in l for l in params["layers"]):
        raise ValueError("shard_params takes unquantized LM params")

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
    dim = split_dim(path)
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
        dim = split_dim(path)
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


def check_mp(cfg: DeepseekV2Config, mp: int) -> None:
    """Raise ValueError naming the first of the LM's split dimensions that
    `mp` does not divide (what `shard_params` would refuse), before any
    weight is read."""
    dims = [("num_attention_heads", cfg.num_attention_heads), ("vocab_size", cfg.vocab_size)]
    if cfg.first_k_dense_replace:
        dims.append(("intermediate_size", cfg.intermediate_size))
    if cfg.num_moe_layers:
        dims += [("n_routed_experts", cfg.n_routed_experts),
                 ("n_shared_experts * moe_intermediate_size", cfg.n_shared_experts * cfg.moe_intermediate_size)]
    for name, count in dims:
        if mp < 1 or count % mp:
            raise ValueError(f"mp={mp} does not divide {name}={count}")
