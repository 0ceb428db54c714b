"""DeepSeek-V2 language backbone (port of deepseek_ocr2_tpu.models.deepseek_v2).

Dense layer(s) first (`first_k_dense_replace`), then MoE layers with
`n_routed_experts` routed experts (top `num_experts_per_tok`) plus
`n_shared_experts` shared ones. RMSNorm, RoPE, attention and the MoE gate
in f32; GEMMs in the model dtype. Weights keep HF's [out, in] layout; the
routed experts of a layer are stacked [E, I, H] / [E, H, I].

Prefill attention runs kernel A (`ops.flash_attention.mha`, causal) on f32
q/k/v after RoPE, at every prompt length. Training (`lm_forward(...,
training=True)`) takes no cache and the plain causal `sdpa` instead, the
JAX package's XLA prefill branch: kernel A is forward-only in both
packages. Its MoE layers above 512 rows run the differentiable grouped
GEMM (`ops.moe_gmm.MoeFfnGmm`: D and E forward, E, S and T backward), and
`remat=True` recomputes each MoE layer in the backward
(`torch.utils.checkpoint`, as `jax.checkpoint(moe_layer_body)`). Decode attends over the
preallocated contiguous cache with the plain `sdpa`, as the JAX package's
default "pool" strategy does: one token a row, or a chunk of S tokens
(lookup decoding) at a shared or per-row position, each query masked to
its own causal prefix. The cache is updated in place. Under
`DEEPSEEK_DECODE_ATTN=stacked` (`decode_attn_mode`) a one-token decode
step attends through kernel U (`ops.paged_attention.decode_attention_stacked`)
on the layer-stacked cache instead, in the JAX package's
`_attention_decode_stacked` order.

Int8 and int4 weights (`quantize_lm_params`, the CLI's `--moe-int8`,
`--int8` and `--int4`):
- scope "experts": each MoE layer's routed experts become `experts_q8`
  (`ops.moe_q8.quantize_experts`, or `ops.moe_q4.quantize_experts_q4` at
  bits 4);
- scope "full": also the attention (q, k, v fused into one [3H, H] stream
  `wqkv`, and `wo`), the dense MLP and the shared MLP (gate||up fused into
  `gu`, and `down`), each an int8 linear (`ops.linear_q8`) or int4 linear
  (`ops.linear_q4`), and `lm_head`; the shared MLP is also split along its
  intermediate dim into n_shared expert-shaped pseudo-experts (`pe_*` keys
  of `experts_q8`) that the decode kernels fold in as always-on visits.
As in the JAX package, int4 weights keep the containers' names and
describe themselves by their leaves ("q4", "gu_q4"), on which every
dispatch keys.
Routers, norms and the embedding stay in the model dtype. The port's layers
are unstacked already, so the JAX package's unrolled `_lm_forward_q8` has no
counterpart: its branches sit in the one layer loop. Decode: kernel H (L
for int4) for the linears, I or M (B * k <= E) or J or N for the experts
with the JAX package's dispatch, K or O for the attention block on the
contiguous cache. Prefill: the linears through `linear_q8_plain` or
`linear_q4_plain` and each layer's experts dequantized (scale folded before
the dtype cast, as the JAX package does) into the unquantized MoE forms.

Under a mesh with mp > 1 (`parallel.shard_params`; the layout is
`parallel.sharding`'s) a layer runs its rank's shards; every partial sum
stays in f32 until it has been summed over mp (`reduce_from_mp`) and is
rounded once, as the unsharded product rounds its f32 accumulator once:
- plain weights: the rank's heads (wq, wk, wv rows), wo's and the MLPs'
  down partials over the rank's columns (`row_parallel`);
- int8 linears split their contraction: the rank's columns of x through H
  (decode) or the prefill form into an f32 partial, summed over mp. After
  wqkv's sum every rank holds the whole q, k and v and keeps its heads, the
  ones wo's columns take; a SwiGLU's gu partial is summed before the
  nonlinearity and the rank's slice of I feeds down's partial: one sum a
  projection, as the JAX package's GSPMD inserts one psum a projection;
- int4 linears split their output rows: L (decode) or the prefill form on
  the rank's rows, gathered over mp (`gather_from_mp`) into the whole
  output, bit for bit the unsharded product's. wqkv's and gu's cuts need
  not fall on a q / k / v or gate / up boundary, so the whole output is
  gathered first and split after; wo takes the whole context, gathered
  from the ranks' heads; the cache holds the rank's heads in every scope;
- the routed experts (EP, plain, int8 or int4) run on `local_routing`'s
  ids, each rank's partial in f32, summed over mp together with a plain or
  int8 shared MLP's partial in one all-reduce; the shared pseudo-experts
  are never folded in (they are whole on every rank: the sum over mp would
  count them once a rank), the shared MLP runs as its split stream;
- the fused attention kernels K and O are off: before wqkv's sum a rank
  holds only a partial of q, k and v, and K's in-kernel GEMV has no whole
  input to take (the JAX package's `fused_attn_enabled` turns them off in
  any multi-device process). A mesh with mp = 1 (dp only) holds whole
  weights, so its rows take K and O as the unsharded model does;
- lm_head's rank rows (plain, or int8 / int4 through H / L in f32) give
  the rank's slice of the vocabulary, gathered over mp.
A layer whose weights are in a layout this module was not written for
raises; no rank ever gathers whole weights.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs import DeepseekV2Config
from ..io.safetensors_torch import DtypePolicy, FlatSource, LoadReport, as_tensor
from ..ops.attention import causal_mask, sdpa
from ..ops.attn_fused import attn_decode_fused, fused_attn_enabled
from ..ops.flash_attention import mha
from ..ops.linear_q4 import from_jax_q4, quantize_linear_q4
from ..ops.linear_q8 import is_qlinear, qmm, quantize_linear, swiglu_q8
from ..ops.moe import local_routing, moe_ffn_decode, moe_ffn_prefill, route, swiglu
from ..ops.moe_decode import moe_ffn_decode_q8_fused
from ..ops.moe_q4 import dequantize_experts_q4, moe_ffn_decode_q4, moe_ffn_decode_q4_fused, quantize_experts_q4
from ..ops.moe_q8 import moe_ffn_decode_q8, quantize_experts, routed_only
from ..ops.norms import rms_norm
from ..ops.paged_attention import decode_attention_stacked
from ..ops.rope import apply_rope, apply_rope_rows, rope_cache, rope_rows
from ..parallel.collectives import copy_to_mp, gather_from_mp, mp_on, reduce_from_mp

Params = Dict[str, Any]


def params_from_source(
    src: FlatSource, cfg: DeepseekV2Config, prefix: str = "model.", lm_head_key: str = "lm_head.weight"
) -> Params:
    def stack(names):
        parts = [src.take(n) for n in names]
        return None if any(p is None for p in parts) else torch.stack(parts)

    layers: List[Params] = []
    for i in range(cfg.num_hidden_layers):
        lp = f"{prefix}layers.{i}."
        layer = {
            "ln1": src.take(lp + "input_layernorm.weight"),
            "ln2": src.take(lp + "post_attention_layernorm.weight"),
        }
        for name in ("q", "k", "v", "o"):
            layer["w" + name] = src.take(f"{lp}self_attn.{name}_proj.weight")
        if i < cfg.first_k_dense_replace:
            layer["mlp"] = {n: src.take(f"{lp}mlp.{n}_proj.weight") for n in ("gate", "up", "down")}
        else:
            layer["router"] = src.take(lp + "mlp.gate.weight")
            layer["experts"] = {
                n: stack([f"{lp}mlp.experts.{e}.{n}_proj.weight" for e in range(cfg.n_routed_experts)])
                for n in ("gate", "up", "down")
            }
            layer["shared"] = {
                n: src.take(f"{lp}mlp.shared_experts.{n}_proj.weight") for n in ("gate", "up", "down")
            }
        layers.append(layer)
    return {
        "embed": src.take(prefix + "embed_tokens.weight"),
        "layers": layers,
        "norm": src.take(prefix + "norm.weight"),
        "lm_head": src.take(lm_head_key),
    }


def params_from_flat(flat, cfg: DeepseekV2Config, device="cpu", policy=None) -> Tuple[Params, LoadReport]:
    src = FlatSource(flat, torch.device(device), policy or DtypePolicy(default=None))
    return params_from_source(src, cfg), src.report


def flat_from_params(
    params: Params, cfg: DeepseekV2Config, prefix: str = "model.", lm_head_key: str = "lm_head.weight"
) -> Dict[str, torch.Tensor]:
    """Inverse of `params_from_source`: HF names and layout, each routed
    expert's matrices unstacked, so the file loads in either package (the
    JAX package's `flat_from_params` writes the same names)."""
    flat: Dict[str, torch.Tensor] = {
        prefix + "embed_tokens.weight": params["embed"],
        prefix + "norm.weight": params["norm"],
    }
    if is_quantized(params):
        raise ValueError("flat_from_params takes unquantized LM params")
    if lm_head_key:
        flat[lm_head_key] = params["lm_head"]
    for i, layer in enumerate(params["layers"]):
        lp = f"{prefix}layers.{i}."
        flat[lp + "input_layernorm.weight"] = layer["ln1"]
        flat[lp + "post_attention_layernorm.weight"] = layer["ln2"]
        for name in ("q", "k", "v", "o"):
            flat[f"{lp}self_attn.{name}_proj.weight"] = layer["w" + name]
        if "mlp" in layer:
            for n in ("gate", "up", "down"):
                flat[f"{lp}mlp.{n}_proj.weight"] = layer["mlp"][n]
            continue
        flat[lp + "mlp.gate.weight"] = layer["router"]
        for n in ("gate", "up", "down"):
            for e in range(cfg.n_routed_experts):
                flat[f"{lp}mlp.experts.{e}.{n}_proj.weight"] = layer["experts"][n][e]
            flat[f"{lp}mlp.shared_experts.{n}_proj.weight"] = layer["shared"][n]
    return flat


def params_from_jax(tree: Params, cfg: DeepseekV2Config, device="cpu") -> Params:
    """From the JAX pytree: dense and MoE layers stacked separately,
    linears [in, out], experts [L, E, H, I] / [L, E, I, H]. A tree from the
    JAX package's `quantize_lm_params` (int8 or int4, either scope) comes
    over with its codes and scales in the port's layout (int8 transposed,
    its In-padding to a multiple of 128 dropped; int4 unpacked, its padding
    to 256 cut to 128 and repacked by `from_jax_q4`), so both packages
    compute from the same levels and scales."""

    def t(a, transpose=False):
        x = as_tensor(np.asarray(a))
        return (x.transpose(-1, -2) if transpose else x).contiguous().to(device)

    def q4(packed, scale, in_dim):
        codes, s = from_jax_q4(packed, scale, in_dim)
        return codes.to(device), s.to(device)

    def qlin(qd, in_dim):  # {"q8": [In_pad, Out], "scale": [1, Out]} or {"q4", "scale"} -> the port's
        if "q4" in qd:
            return dict(zip(("q4", "scale"), q4(qd["q4"], qd["scale"], in_dim)))
        return {"q8": t(np.asarray(qd["q8"])[:in_dim], True), "scale": t(np.asarray(qd["scale"])[0])}

    def qexperts(qd):  # gu_q8 [E, H, 2I], gu_scale [E, 1, 2I], ... (+ pe_*), or the int4 keys
        if "gu_q4" not in qd:
            return {k: t(v, True) if k.endswith("q8") else t(np.asarray(v)[..., 0, :]) for k, v in qd.items()}
        h, i = qd["down_q4"].shape[-1], qd["gu_q4"].shape[-1] // 2
        out = {}
        for pre in ("", "pe_") if "pe_gu_q4" in qd else ("",):
            for n, in_dim in (("gu", h), ("down", i)):
                out[f"{pre}{n}_q4"], out[f"{pre}{n}_scale"] = q4(qd[f"{pre}{n}_q4"], qd[f"{pre}{n}_scale"], in_dim)
        return out

    h, q8l = cfg.hidden_size, tree.get("q8_layers")

    def attn(group, j, which):
        if q8l is not None:
            q = q8l[which][j]
            return {"wqkv": qlin(q["wqkv"], h), "wo": qlin(q["wo"], h)}
        return {"w" + n: t(group["attn"]["w" + n][j], True) for n in ("q", "k", "v", "o")}

    def mlp(group, j, name, qnames, inter):
        if q8l is not None:
            q = q8l["dense" if name == "mlp" else "moe"][j]
            return {"gu": qlin(q[qnames[0]], h), "down": qlin(q[qnames[1]], inter)}
        return {n: t(group[name][n][j], True) for n in ("gate", "up", "down")}

    dense, moe = tree["layers_dense"], tree["layers_moe"]
    layers = []
    for j in range(cfg.first_k_dense_replace):
        layers.append({
            "ln1": t(dense["ln1"][j]), "ln2": t(dense["ln2"][j]), **attn(dense, j, "dense"),
            "mlp": mlp(dense, j, "mlp", ("gu", "down"), cfg.intermediate_size),
        })
    for j in range(cfg.num_moe_layers):
        layer = {
            "ln1": t(moe["ln1"][j]), "ln2": t(moe["ln2"][j]), **attn(moe, j, "moe"),
            "router": t(moe["router"][j], True),
            "shared": mlp(moe, j, "shared", ("shared_gu", "shared_down"),
                          cfg.moe_intermediate_size * cfg.n_shared_experts),
        }
        if "moe_q8" in tree:
            layer["experts_q8"] = qexperts(tree["moe_q8"][j])
        else:
            layer["experts"] = {n: t(moe["experts"][n][j], True) for n in ("gate", "up", "down")}
        layers.append(layer)
    head = qlin(tree["q8_lm_head"], h) if "q8_lm_head" in tree else t(tree["lm_head"], True)
    return {"embed": t(tree["embed"]), "layers": layers, "norm": t(tree["norm"]), "lm_head": head}


def is_quantized(params: Params) -> bool:
    """Whether an LM tree holds int8 or int4 weights (`quantize_lm_params`,
    either scope)."""
    return is_qlinear(params["lm_head"]) or any("wqkv" in l or "experts_q8" in l for l in params["layers"])


def quantize_lm_params(params: Params, scope: str = "experts", bits: int = 8) -> Params:
    """Weight-only int8 or int4 quantization (port of the JAX function; see
    the module docstring for the two scopes). Returns new params; the
    input's tensors are not changed."""
    if bits not in (4, 8) or scope not in ("experts", "full"):
        raise ValueError(f"quantize_lm_params takes scope 'experts' or 'full' and bits 4 or 8, "
                         f"got {scope!r}, {bits}")
    qlinear, qexperts = (quantize_linear_q4, quantize_experts_q4) if bits == 4 else (quantize_linear, quantize_experts)
    layers = []
    for layer in params["layers"]:
        q = dict(layer)
        if "experts" in q:
            q["experts_q8"] = qexperts(q.pop("experts"))
        if scope == "full":
            q["wqkv"] = qlinear(torch.cat([q.pop("wq"), q.pop("wk"), q.pop("wv")]))
            q["wo"] = qlinear(q["wo"])
            name = "mlp" if "mlp" in q else "shared"
            m = q[name]
            q[name] = {"gu": qlinear(torch.cat([m["gate"], m["up"]])), "down": qlinear(m["down"])}
            if name == "shared":
                q["experts_q8"] = {**q["experts_q8"], **_pseudo_experts(m, q["experts_q8"], qexperts)}
        layers.append(q)
    new = {**params, "layers": layers}
    if scope == "full":
        new["lm_head"] = qlinear(params["lm_head"])
    return new


def _pseudo_experts(shared: Dict[str, torch.Tensor], eq, qexperts) -> Dict[str, torch.Tensor]:
    """The shared MLP (intermediate n_shared * I) split along its
    intermediate dim into n_shared expert-shaped SwiGLUs whose down
    products sum, quantized as experts by `qexperts`: `pe_*` keys. Int8
    scales are per channel over the halves, so the down scales differ from
    the fused stream's; int4 scales are per group of 128, so where I is a
    multiple of 128 (the full width: 896) the levels and scales are the
    fused stream's."""
    i_e = eq["gu_q4" if "gu_q4" in eq else "gu_q8"].shape[1] // 2
    i_tot = shared["gate"].shape[0]
    if i_tot % i_e:
        return {}
    n_sh = i_tot // i_e
    pe = qexperts({
        "gate": torch.stack([shared["gate"][t * i_e : (t + 1) * i_e] for t in range(n_sh)]),
        "up": torch.stack([shared["up"][t * i_e : (t + 1) * i_e] for t in range(n_sh)]),
        "down": torch.stack([shared["down"][:, t * i_e : (t + 1) * i_e] for t in range(n_sh)]),
    })
    return {f"pe_{k}": v for k, v in pe.items()}


def dequantize_experts(eq, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Int8 or int4 experts back to {gate, up: [E, I, H], down: [E, H, I]}
    in `dtype`, the scale folded in f32 before the cast (the JAX package's
    `_dequantize_experts`), for the prefill MoE forms."""
    if "gu_q4" in eq:
        return dequantize_experts_q4(eq, dtype)
    i = eq["gu_q8"].shape[1] // 2

    def deq(q, s):  # contiguous, as kernels D and E take them
        return (q.float() * s[..., None]).to(dtype)

    return {"gate": deq(eq["gu_q8"][:, :i], eq["gu_scale"][:, :i]),
            "up": deq(eq["gu_q8"][:, i:], eq["gu_scale"][:, i:]),
            "down": deq(eq["down_q8"], eq["down_scale"])}


def vocab_size_of(params: Params) -> int:
    """The whole vocabulary (lm_head's rows times mp under a mesh)."""
    head = params["lm_head"]
    mesh = params.get("mesh")
    return (head.get("q8", head.get("q4")) if is_qlinear(head) else head).shape[0] * (mesh.mp if mesh else 1)


def _sharded_logits(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """Under a mesh: the rank's vocab slice of the logits, gathered over mp
    into the whole [..., V] (every mp rank the same values): in the model
    dtype, or in f32 through kernel H (L) when lm_head is int8 (int4)."""
    mesh, head = params["mesh"], params["lm_head"]
    if is_qlinear(head):
        h2 = hidden.reshape(-1, hidden.shape[-1])
        part = qmm(h2, head, decode=True, out_dtype=torch.float32)
        return gather_from_mp(part, mesh).reshape(*hidden.shape[:-1], -1)
    return gather_from_mp(F.linear(copy_to_mp(hidden, mesh), head), mesh)


def rope_consts(cfg: DeepseekV2Config, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return rope_cache(cfg.max_position_embeddings, cfg.head_dim, cfg.rope_theta, device=device)


def _rank_cols(t: torch.Tensor, mesh, n: int) -> torch.Tensor:
    """The rank's n columns of the whole t [N, mp n]."""
    return t.narrow(-1, mesh.mp_rank * n, n)


def _contraction_partial(x: torch.Tensor, w, mesh, decode: bool) -> torch.Tensor:
    """x [N, In] (whole) times an int8 linear split on its contraction: the
    rank's columns of x through H (decode) or the prefill form, its f32
    partial [N, Out], not yet summed over mp."""
    cols = w["q8"].shape[1]
    return qmm(_rank_cols(x, mesh, cols).contiguous(), w, decode=decode, out_dtype=torch.float32)


def _qlinear_mp(x: torch.Tensor, w, mesh, decode: bool, out_dtype=None) -> torch.Tensor:
    """The whole x W^T [N, Out] of a quantized linear under mp > 1, in
    `out_dtype` (x's by default): an int8 one's partials summed over mp in
    f32 and rounded once, an int4 one's rows gathered over mp."""
    if "q4" in w:
        return gather_from_mp(qmm(x, w, decode=decode, out_dtype=out_dtype), mesh)
    if "q8" not in w:
        raise ValueError(f"a quantized linear under a mesh holds q8 or q4 codes, not {sorted(w)}")
    return reduce_from_mp(_contraction_partial(x, w, mesh, decode), mesh).to(out_dtype or x.dtype)


def qkv_proj(x2: torch.Tensor, layer, decode: bool, cfg: DeepseekV2Config = None, mesh=None):
    """q, k, v [N, Hh D] each: three linears, or the fused int8 or int4 [3H,
    H] stream split after the product. Under a mesh with mp > 1 the rank's
    heads (its Hh of them): its rows of wq / wk / wv, or the whole fused
    output (`_qlinear_mp`) cut to its heads."""
    if "wqkv" in layer:
        if not mp_on(mesh):
            return qmm(x2, layer["wqkv"], decode=decode).chunk(3, dim=-1)
        whole = _qlinear_mp(x2, layer["wqkv"], mesh, decode).chunk(3, dim=-1)
        return tuple(_rank_cols(t, mesh, n_heads(cfg, mesh) * cfg.head_dim) for t in whole)
    return F.linear(x2, layer["wq"]), F.linear(x2, layer["wk"]), F.linear(x2, layer["wv"])


def decode_attn_mode() -> str:
    """`DEEPSEEK_DECODE_ATTN`, read at each call as the JAX package's
    `_decode_attn_mode` does (default "pool"):
    - "pool": the new token's K/V written into the cache in place, then the
      plain `sdpa` over the layer's view;
    - "stacked": the same write, then kernel U on the layer-stacked cache
      (one-token steps; a chunk of S > 1 tokens takes "pool");
    - "slice" (or any other value): the JAX package copies the layer out of
      the cache and writes it back, a copy the port has no counterpart of
      (a layer is a view), so it computes what "pool" computes.
    Kernels K and O (quantized attention weights) run only under "pool", as
    the JAX package's `_decode_attention` gates them. Unlike the JAX
    package, "stacked" needs no Pallas: on CPU tensors U is its plain twin.
    The paged engines never read it."""
    return os.environ.get("DEEPSEEK_DECODE_ATTN", "pool")


def n_heads(cfg: DeepseekV2Config, mesh=None) -> int:
    """The attention heads a rank computes and caches: all of them
    unsharded, num_attention_heads / mp under a mesh."""
    return cfg.num_attention_heads // (mesh.mp if mesh is not None else 1)


def row_parallel(x: torch.Tensor, w: torch.Tensor, mesh) -> torch.Tensor:
    """x W^T for a weight whose input columns split over mp (wo, down): each
    rank's partial product in f32, summed over mp in f32 and rounded once
    to x's dtype, as the unsharded product rounds its f32 accumulator."""
    return reduce_from_mp(F.linear(x.float(), w.float()), mesh).to(x.dtype)


def out_proj(ctx: torch.Tensor, wo, mesh, decode: bool) -> torch.Tensor:
    """The attention's wo on ctx [N, Hh D] (the rank's heads), `qmm`
    (plain, int8 or int4) unsharded. Under a mesh with mp > 1: plain and
    int8 wo hold the rank's heads' columns, a partial summed over mp
    (`row_parallel`, or H / the prefill form in f32); an int4 wo holds
    output rows and takes the whole context, gathered from the ranks'
    heads."""
    if not mp_on(mesh):
        return qmm(ctx, wo, decode=decode)
    if not is_qlinear(wo):
        return row_parallel(ctx, wo, mesh)
    if "q4" in wo:
        return _qlinear_mp(gather_from_mp(ctx, mesh), wo, mesh, decode)
    return reduce_from_mp(qmm(ctx, wo, decode=decode, out_dtype=torch.float32), mesh).to(ctx.dtype)


def _attention(x, layer, cfg: DeepseekV2Config, rope, cache, li: int, pos, is_prefill: bool, stacked_lens=None,
               mesh=None):
    """`pos`: an int shared by the rows, or (decode) per-row positions [B]
    of x[:, 0]. Decode query j of row b sits at posq[b, j] = pos[b] + j and
    sees the keys at positions <= posq[b, j]. `stacked_lens` ([B] int32,
    pos + 1; one-token decode under "stacked"): attend through kernel U
    after the cache write. Under a `mesh` with mp > 1 the layer holds the
    rank's heads (and the cache their K/V) and wo's partial products are
    reduced over mp."""
    b, s, h = x.shape
    nh, d = n_heads(cfg, mesh), cfg.head_dim
    x = copy_to_mp(x, mesh)
    q, k, v = (t.reshape(b, s, nh, d).transpose(1, 2)
               for t in qkv_proj(x.reshape(b * s, h), layer, not is_prefill, cfg, mesh))
    v32 = v.float()
    ck, cv = cache["k"][li], cache["v"][li]  # [B, Hh, cap, D] views
    steps = torch.arange(s, device=x.device)
    if torch.is_tensor(pos):  # per-row RoPE and a per-(row, step) cache write
        posq = pos.long()[:, None] + steps  # [B, S]
        q32, k32 = apply_rope_rows(q, k, *rope_rows(rope[0], rope[1], pos, s))
        rows = torch.arange(b, device=x.device)[:, None]
        ck[rows, :, posq] = k32.transpose(1, 2).to(ck.dtype)  # values [B, S, Hh, D]
        cv[rows, :, posq] = v32.transpose(1, 2).to(cv.dtype)
    else:
        posq = (pos + steps)[None]  # [1, S]: the rows share it
        q32, k32 = apply_rope(q, k, rope[0], rope[1], start=pos)
        ck[:, :, pos : pos + s] = k32.to(ck.dtype)
        cv[:, :, pos : pos + s] = v32.to(cv.dtype)

    scale = 1.0 / math.sqrt(d)
    if is_prefill:
        # Fresh f32 K/V for the prompt pass, through kernel A.
        ctx = mha(q32, k32, v32, scale=scale, mode="causal")  # f32 in, f32 out
    elif stacked_lens is not None:
        ctx = decode_attention_stacked(q32[:, :, 0], cache["k"], cache["v"], li, stacked_lens, scale=scale)[:, :, None]
    else:
        mask = torch.arange(ck.shape[2], device=x.device) > posq[:, None, :, None]  # [B or 1, 1, S, cap]
        ctx = sdpa(q32, ck, cv, scale=scale, mask=mask, out_dtype=torch.float32)
    ctx = ctx.transpose(1, 2).reshape(b * s, nh * d).to(x.dtype)
    return out_proj(ctx, layer["wo"], mesh, not is_prefill).reshape(b, s, h)


def _train_attention(x, layer, cfg: DeepseekV2Config, rope, mesh=None):
    """Training attention over the whole sequence, differentiable: RoPE and
    the plain causal `sdpa` in f32 (the JAX package's XLA prefill branch),
    no cache. Under a mesh as `_attention`."""
    b, s, h = x.shape
    nh, d = n_heads(cfg, mesh), cfg.head_dim
    x = copy_to_mp(x, mesh)
    q, k, v = (t.reshape(b, s, nh, d).transpose(1, 2) for t in qkv_proj(x.reshape(b * s, h), layer, False, cfg, mesh))
    q32, k32 = apply_rope(q, k, rope[0], rope[1], start=0)
    mask = causal_mask(s, s, device=x.device)[None, None]
    ctx = sdpa(q32, k32, v.float(), scale=1.0 / math.sqrt(d), mask=mask, out_dtype=torch.float32)
    ctx = ctx.transpose(1, 2).reshape(b * s, nh * d).to(x.dtype)
    return out_proj(ctx, layer["wo"], mesh, False).reshape(b, s, h)


def _train_layer(x, layer, cfg: DeepseekV2Config, rope, mesh=None):
    b, s, h = x.shape
    x = x + _train_attention(rms_norm(x, layer["ln1"], cfg.rms_norm_eps), layer, cfg, rope, mesh)
    xn = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
    return x + ffn(xn.reshape(b * s, h), layer, cfg, decode=False, mesh=mesh).reshape(b, s, h)


def _fused_attention(xn, layer, cfg: DeepseekV2Config, rope, cache, li: int, pos, pos_b: torch.Tensor):
    """Kernel K (O for int4) for one decode step of a layer with quantized
    attention weights at `pos`, an int or per-row positions [B] (pos_b:
    the same as int32 [B] on the device); the new token's K/V go into the
    cache there."""
    out, k_new, v_new = attn_decode_fused(xn, layer, cfg, rope[0], rope[1], cache["k"], cache["v"], li, pos_b)
    if torch.is_tensor(pos):
        rows = torch.arange(pos_b.shape[0], device=pos_b.device)
        cache["k"][li][rows, :, pos.long()] = k_new  # values [B, Hh, D]
        cache["v"][li][rows, :, pos.long()] = v_new
    else:
        cache["k"][li][:, :, pos] = k_new
        cache["v"][li][:, :, pos] = v_new
    return out


def _mlp_whole(m) -> bool:
    """Whether `_mlp_mp` gives the MLP m's whole output (an int4 down,
    split on its output rows) rather than the rank's partial."""
    return is_qlinear(m["down"]) and "q4" in m["down"]


def _mlp_mp(xc: torch.Tensor, m, mesh, decode: bool) -> torch.Tensor:
    """A dense or shared SwiGLU MLP under mp > 1: the rank's f32 down
    partial, to be summed over mp, for plain weights (the rank's gate / up
    rows, down columns) and int8 ones (gu's partials summed over mp before
    the nonlinearity, then the rank's slice of I through down); for int4
    ones (`_mlp_whole`) the whole output in x's dtype (gu's rows gathered,
    then down's), the unsharded `swiglu_q8` bit for bit."""
    if "gate" in m:
        gate, up = F.linear(xc, m["gate"]), F.linear(xc, m["up"])
        act = F.silu(gate.float()).to(gate.dtype) * up
        return F.linear(act.float(), m["down"].float())
    h2 = _qlinear_mp(xc, m["gu"], mesh, decode, out_dtype=torch.float32)
    i = h2.shape[-1] // 2
    act = (F.silu(h2[:, :i]) * h2[:, i:]).to(xc.dtype)
    if _mlp_whole(m):
        return _qlinear_mp(act, m["down"], mesh, decode)
    return _contraction_partial(act, m["down"], mesh, decode)


def _ffn_mp(x_flat: torch.Tensor, layer, cfg: DeepseekV2Config, decode: bool, mesh) -> torch.Tensor:
    """`ffn` under a mesh with mp > 1: the dense or shared MLP as `_mlp_mp`;
    the routed experts (EP, plain, int8 or int4) on the replicated routing,
    whose weights enter through `copy_to_mp` (each rank's d_weights holds
    its selections only; the sum is the whole), selections of other ranks'
    experts taking no work, the rank's partial in f32; the partials summed
    over mp in f32 (one all-reduce for the routed experts and a plain or
    int8 shared MLP together) and each rounded once. Quantized experts
    decode through J / N (N k > E) or I / M without the pseudo-experts, and
    prefill dequantized into the plain forms. The MoE cut-overs read the
    global row count (rows times dp) and expert count."""
    xc = copy_to_mp(x_flat, mesh)
    dt = x_flat.dtype
    m = layer.get("mlp")
    if m is not None:
        out = _mlp_mp(xc, m, mesh, decode)
        return out if _mlp_whole(m) else reduce_from_mp(out, mesh).to(dt)
    eq = layer.get("experts_q8")
    e_local = (layer["experts"]["gate"] if eq is None else eq["gu_q4" if "gu_q4" in eq else "gu_q8"]).shape[0]
    weights, idx = route(x_flat, layer["router"], cfg.num_experts_per_tok)
    weights, idx = local_routing(copy_to_mp(weights, mesh), idx, e_local, mesh.mp_rank)
    n_rows = x_flat.shape[0] * mesh.dp
    f32 = torch.float32
    if eq is None:
        if decode:
            routed = moe_ffn_decode(xc, layer["experts"], weights, idx, n_rows=n_rows,
                                    n_experts=cfg.n_routed_experts, out_dtype=f32)
        else:
            routed = moe_ffn_prefill(xc, layer["experts"], weights, idx, n_rows=n_rows, out_dtype=f32)
    elif not decode:
        routed = moe_ffn_prefill(xc, dequantize_experts(routed_only(eq), dt), weights, idx, n_rows=n_rows,
                                 out_dtype=f32)
    else:
        eq, q4 = routed_only(eq), "gu_q4" in eq
        if n_rows * cfg.num_experts_per_tok > cfg.n_routed_experts:
            routed = (moe_ffn_decode_q4_fused if q4 else moe_ffn_decode_q8_fused)(xc, eq, weights, idx, f32)
        else:
            routed = (moe_ffn_decode_q4 if q4 else moe_ffn_decode_q8)(xc, eq, weights, idx, out_dtype=f32)
    shared = _mlp_mp(xc, layer["shared"], mesh, decode)
    if _mlp_whole(layer["shared"]):
        return reduce_from_mp(routed, mesh).to(dt) + shared
    both = reduce_from_mp(torch.stack([routed, shared]), mesh)
    return both[0].to(dt) + both[1].to(dt)


def ffn(x_flat: torch.Tensor, layer, cfg: DeepseekV2Config, *, decode: bool, mesh=None) -> torch.Tensor:
    """A layer's MLP on [N, H] rows: the dense SwiGLU, or the routed experts
    plus the shared MLP, each weight plain, int8 or int4. Quantized experts
    in decode follow the JAX package's `_q8_ffn`, keyed on `gu_q4`: kernel J
    (N for int4) once N * k > E, kernel I (M) otherwise; the shared
    pseudo-experts, when present, are folded into J / N always and into
    I / M at N = 1, and the shared MLP is then not added again. Prefill
    dequantizes the experts into the unquantized forms. Under a `mesh`
    with mp > 1: `_ffn_mp`."""
    if mesh is not None and mesh.mp > 1:
        return _ffn_mp(x_flat, layer, cfg, decode, mesh)
    n_rows = x_flat.shape[0] * (mesh.dp if mesh is not None else 1)
    m = layer.get("mlp")
    if m is not None:
        return swiglu_q8(x_flat, m["gu"], m["down"], decode=decode) if "gu" in m else \
            swiglu(x_flat, m["gate"], m["up"], m["down"])
    weights, idx = route(x_flat, layer["router"], cfg.num_experts_per_tok)
    eq = layer.get("experts_q8")
    merged = False
    if eq is None:
        routed = (moe_ffn_decode if decode else moe_ffn_prefill)(x_flat, layer["experts"], weights, idx,
                                                                 n_rows=n_rows)
    elif not decode:
        routed = moe_ffn_prefill(x_flat, dequantize_experts(eq, x_flat.dtype), weights, idx, n_rows=n_rows)
    else:
        q4 = "gu_q4" in eq
        pe_key = "pe_gu_q4" if q4 else "pe_gu_q8"
        if n_rows * cfg.num_experts_per_tok > cfg.n_routed_experts:
            merged = pe_key in eq
            routed = (moe_ffn_decode_q4_fused if q4 else moe_ffn_decode_q8_fused)(x_flat, eq, weights, idx)
        else:
            merged = pe_key in eq and n_rows == 1
            routed = (moe_ffn_decode_q4 if q4 else moe_ffn_decode_q8)(x_flat, eq, weights, idx,
                                                                       with_shared=merged)
    if merged:
        return routed
    sh = layer["shared"]
    shared = swiglu_q8(x_flat, sh["gu"], sh["down"], decode=decode) if "gu" in sh else \
        swiglu(x_flat, sh["gate"], sh["up"], sh["down"])
    return routed + shared


def lm_forward(
    params: Params,
    cfg: DeepseekV2Config,
    embeds: torch.Tensor,  # [B, S, H]
    cache: Dict[str, torch.Tensor],  # k/v [L, B, Hh, cap, D], updated in place; None in training
    pos=0,
    is_prefill: bool = True,
    rope=None,
    training: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """Run the decoder stack; returns the final-normed hidden [B, S, H].

    `training`: a differentiable pass over the whole sequence (no cache;
    plain causal attention, see the module docstring); `remat` recomputes
    each MoE layer in the backward, trading one more forward of those
    layers for their activations' memory.

    Prefill (S tokens at pos 0) or decode: S >= 1 tokens at the int `pos`,
    at a device position shared by the rows (a 0-d tensor, as a captured
    decode step passes it: no Python int is baked into the graph), or at
    per-row positions `pos` [B] (lookup decoding's ragged chunks), each
    query attending to its own causal prefix. An int and a tensor position
    give the same bits. A decode step of one token, in a layer with int8
    (int4) attention weights, runs kernel K (O) unless
    DEEPSEEK_FUSED_ATTN=0, the decode mode is not "pool" or the params are
    split over mp > 1; a chunk takes the linears and the plain attention,
    as in the JAX package. Under `DEEPSEEK_DECODE_ATTN=stacked` a one-token
    step attends through kernel U (`decode_attn_mode`).

    Params sharded onto a mesh (`parallel.shard_params`) run the rank's
    heads, columns and experts, with the mesh's collectives (`_attention`,
    `_ffn_mp`); the rows are the rank's dp rows."""
    rope = rope if rope is not None else rope_consts(cfg, embeds.device)
    mesh = params.get("mesh")
    if training:
        if is_quantized(params):
            raise ValueError("training takes unquantized LM params")
        x = embeds
        for layer in params["layers"]:
            if remat and "experts" in layer:
                x = checkpoint(_train_layer, x, layer, cfg, rope, mesh, use_reentrant=False)
            else:
                x = _train_layer(x, layer, cfg, rope, mesh)
        return rms_norm(x, params["norm"], cfg.rms_norm_eps)
    b, s, h = embeds.shape
    if torch.is_tensor(pos) and pos.dim() == 0:  # shared by the rows
        pos = pos.expand(b)
    mode = None if is_prefill else decode_attn_mode()
    fused = (mode == "pool" and s == 1 and fused_attn_enabled() and not mp_on(mesh)
             and any("wqkv" in layer for layer in params["layers"]))
    pos_b = stacked_lens = None  # one fill a step, shared by the layers
    if fused:
        pos_b = (pos.to(torch.int32) if torch.is_tensor(pos)
                 else torch.full((b,), pos, dtype=torch.int32, device=embeds.device))
    if mode == "stacked" and s == 1:
        stacked_lens = (pos.to(torch.int32) + 1 if torch.is_tensor(pos)
                        else torch.full((b,), pos + 1, dtype=torch.int32, device=embeds.device))
    x = embeds
    for li, layer in enumerate(params["layers"]):
        res = x
        xn = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        if fused and "wqkv" in layer:
            x = res + _fused_attention(xn, layer, cfg, rope, cache, li, pos, pos_b)
        else:
            x = res + _attention(xn, layer, cfg, rope, cache, li, pos, is_prefill, stacked_lens, mesh)
        res = x
        xn = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
        x = res + ffn(xn.reshape(b * s, h), layer, cfg, decode=not is_prefill, mesh=mesh).reshape(b, s, h)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)


@torch.no_grad()
def lm_forward_debug(params: Params, cfg: DeepseekV2Config, embeds: torch.Tensor, rope=None) -> torch.Tensor:
    """A prefill of `embeds` [B, S, H] layer by layer with the JAX package's
    debug stat dumps (its `lm_forward_debug`): DEEPSEEK_DEBUG_ATTN (each
    attention's input and output), DEEPSEEK_DEBUG_MOE (each MoE layer's
    routing counts, its first four rows' picks and the layer's output) and
    DEEPSEEK_DEBUG_LAYER0 (layer 0 after attention and at its end). The K/V
    go to a throwaway f32 cache of S positions. Returns the final-normed
    hidden [B, S, H]; debugging only.

    Params sharded onto a mesh run the sharded layer forward (`_attention`,
    `ffn`) on the rank's dp rows, as `lm_forward` does. What the lines read
    is whole on every rank of a dp row: the norms' outputs and the router's
    picks are computed on replicated rows, and the attention's and MLP's
    outputs come after their reduction over mp. Each is gathered over dp,
    so a line covers the global batch as the JAX package's global arrays
    do, and only global rank 0 prints (every rank takes part in the
    gathers)."""
    from ..parallel.collectives import all_gather_dp
    from ..runtime.kv_cache import make_kv_cache
    from ..utils.debug import dbg_print, dbg_stats, enabled

    mesh = params.get("mesh")
    printer = mesh is None or torch.distributed.get_rank() == 0

    def stats(channel, name, t):
        if enabled(channel):
            t = all_gather_dp(t, mesh)
            if printer:
                dbg_stats(channel, name, t)

    rope = rope if rope is not None else rope_consts(cfg, embeds.device)
    b, s, h = embeds.shape
    cache = make_kv_cache(cfg.num_hidden_layers, b, n_heads(cfg, mesh), s, cfg.head_dim,
                          dtype=torch.float32, device=embeds.device)
    x = embeds
    for i, layer in enumerate(params["layers"]):
        res = x
        xn = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        stats("DEEPSEEK_DEBUG_ATTN", f"layer{i}.attn.in_x", xn)
        attn_out = _attention(xn, layer, cfg, rope, cache, i, 0, True, mesh=mesh)
        stats("DEEPSEEK_DEBUG_ATTN", f"layer{i}.attn.out", attn_out)
        x = res + attn_out
        if i == 0:
            stats("DEEPSEEK_DEBUG_LAYER0", "layer0.after_attn", x)
        res = x
        x_flat = rms_norm(x, layer["ln2"], cfg.rms_norm_eps).reshape(b * s, h)
        moe = "mlp" not in layer
        if moe and enabled("DEEPSEEK_DEBUG_MOE"):
            weights, idx = route(x_flat, layer["router"], cfg.num_experts_per_tok)
            weights, idx = all_gather_dp(weights, mesh), all_gather_dp(idx, mesh)
            if printer:
                idx_h = idx.cpu().numpy()
                counts = np.bincount(idx_h.reshape(-1), minlength=cfg.n_routed_experts)
                dbg_print("DEEPSEEK_DEBUG_MOE", f"layer{i} moe counts={counts.tolist()}")
                dbg_print("DEEPSEEK_DEBUG_MOE", f"layer{i} moe topk_idx[:4]={idx_h[:4].tolist()} "
                                                f"topk_weight[:4]={weights.float().cpu().numpy()[:4].round(5).tolist()}")
        mlp_out = ffn(x_flat, layer, cfg, decode=False, mesh=mesh)
        if moe:
            stats("DEEPSEEK_DEBUG_MOE", f"layer{i}.moe.out_total", mlp_out)
        x = res + mlp_out.reshape(b, s, h)
        if i == 0:
            stats("DEEPSEEK_DEBUG_LAYER0", "layer0.out", x)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)


def logits_all(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """lm_head on every position [B, S, V] (lookup decoding's verification):
    in the model dtype, or in f32 through kernel H (L) over the B * S rows
    when lm_head is int8 (int4)."""
    head = params["lm_head"]
    b, s, h = hidden.shape
    if mp_on(params.get("mesh")):
        return _sharded_logits(params, hidden)
    if is_qlinear(head):
        return qmm(hidden.reshape(b * s, h), head, decode=True, out_dtype=torch.float32).reshape(b, s, -1)
    return F.linear(hidden, head)


def logits_last(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """lm_head on the last position only: [B, V], in the model dtype, or in
    f32 through kernel H (L) when lm_head is int8 (int4) (rows here are at
    most the decode batch)."""
    head = params["lm_head"]
    if mp_on(params.get("mesh")):
        return _sharded_logits(params, hidden[:, -1, :])
    if is_qlinear(head):
        return qmm(hidden[:, -1, :], head, decode=True, out_dtype=torch.float32)
    return F.linear(hidden[:, -1, :], head)
