"""DeepSeek-V2 language backbone (port of deepseek_ocr2_tpu.models.deepseek_v2).

Dense layer(s) first (`first_k_dense_replace`), then MoE layers with
`n_routed_experts` routed experts (top `num_experts_per_tok`) plus
`n_shared_experts` shared ones. RMSNorm, RoPE, attention and the MoE gate
in f32; GEMMs in the model dtype. Weights keep HF's [out, in] layout; the
routed experts of a layer are stacked [E, I, H] / [E, H, I].

Prefill attention runs kernel A (`ops.flash_attention.mha`, causal) on f32
q/k/v after RoPE, at every prompt length. Decode attends over the
preallocated contiguous cache with the plain `sdpa`, as the JAX package's
default "pool" strategy does. The cache is updated in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import DeepseekV2Config

from ..io.safetensors_torch import DtypePolicy, FlatSource, LoadReport, as_tensor
from ..ops.attention import decode_mask, sdpa
from ..ops.flash_attention import mha
from ..ops.moe import moe_ffn_decode, moe_ffn_prefill, route, swiglu
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_cache

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


def params_from_jax(tree: Params, cfg: DeepseekV2Config, device="cpu") -> Params:
    """From the JAX pytree: dense and MoE layers stacked separately,
    linears [in, out], experts [L, E, H, I] / [L, E, I, H]."""

    def t(a, transpose=False):
        x = as_tensor(np.asarray(a))
        return (x.transpose(-1, -2) if transpose else x).contiguous().to(device)

    def attn(group, j):
        return {"w" + n: t(group["attn"]["w" + n][j], True) for n in ("q", "k", "v", "o")}

    dense, moe = tree["layers_dense"], tree["layers_moe"]
    layers = []
    for j in range(cfg.first_k_dense_replace):
        layers.append({
            "ln1": t(dense["ln1"][j]), "ln2": t(dense["ln2"][j]), **attn(dense, j),
            "mlp": {n: t(dense["mlp"][n][j], True) for n in ("gate", "up", "down")},
        })
    for j in range(cfg.num_moe_layers):
        layers.append({
            "ln1": t(moe["ln1"][j]), "ln2": t(moe["ln2"][j]), **attn(moe, j),
            "router": t(moe["router"][j], True),
            "experts": {n: t(moe["experts"][n][j], True) for n in ("gate", "up", "down")},
            "shared": {n: t(moe["shared"][n][j], True) for n in ("gate", "up", "down")},
        })
    return {
        "embed": t(tree["embed"]),
        "layers": layers,
        "norm": t(tree["norm"]),
        "lm_head": t(tree["lm_head"], True),
    }


def rope_consts(cfg: DeepseekV2Config, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return rope_cache(cfg.max_position_embeddings, cfg.head_dim, cfg.rope_theta, device=device)


def _attention(x, layer, cfg: DeepseekV2Config, rope, cache, li: int, pos: int, is_prefill: bool):
    b, s, h = x.shape
    nh, d = cfg.num_attention_heads, cfg.head_dim

    def heads(w):
        return F.linear(x, w).reshape(b, s, nh, d).transpose(1, 2)

    q, k, v = heads(layer["wq"]), heads(layer["wk"]), heads(layer["wv"])
    q32, k32 = apply_rope(q, k, rope[0], rope[1], start=pos)
    v32 = v.float()
    ck, cv = cache["k"][li], cache["v"][li]  # [B, Hh, cap, D] views
    ck[:, :, pos : pos + s] = k32.to(ck.dtype)
    cv[:, :, pos : pos + s] = v32.to(cv.dtype)

    scale = 1.0 / math.sqrt(d)
    if is_prefill:
        # Fresh f32 K/V for the prompt pass, through kernel A.
        ctx = mha(q32, k32, v32, scale=scale, mode="causal")  # f32 in, f32 out
    else:
        mask = decode_mask(ck.shape[2], pos + s - 1, device=x.device)[None, None]
        ctx = sdpa(q32, ck, cv, scale=scale, mask=mask, out_dtype=torch.float32)
    ctx = ctx.transpose(1, 2).reshape(b, s, h).to(x.dtype)
    return F.linear(ctx, layer["wo"])


def lm_forward(
    params: Params,
    cfg: DeepseekV2Config,
    embeds: torch.Tensor,  # [B, S, H]
    cache: Dict[str, torch.Tensor],  # k/v [L, B, Hh, cap, D], updated in place
    pos: int = 0,
    is_prefill: bool = True,
    rope=None,
) -> torch.Tensor:
    """Run the decoder stack; returns the final-normed hidden [B, S, H].

    Prefill (S tokens at pos 0) or decode (S == 1 at `pos`)."""
    rope = rope if rope is not None else rope_consts(cfg, embeds.device)
    x = embeds
    for li, layer in enumerate(params["layers"]):
        res = x
        xn = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        x = res + _attention(xn, layer, cfg, rope, cache, li, pos, is_prefill)
        res = x
        xn = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
        b, s, h = xn.shape
        x_flat = xn.reshape(b * s, h)
        if "mlp" in layer:
            m = layer["mlp"]
            out = swiglu(x_flat, m["gate"], m["up"], m["down"])
        else:
            weights, idx = route(x_flat, layer["router"], cfg.num_experts_per_tok)
            ffn = moe_ffn_prefill if is_prefill else moe_ffn_decode
            routed = ffn(x_flat, layer["experts"], weights, idx)
            sh = layer["shared"]
            out = routed + swiglu(x_flat, sh["gate"], sh["up"], sh["down"])
        x = res + out.reshape(b, s, h)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)


def logits_last(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """lm_head on the last position only: [B, V] in the model dtype."""
    return F.linear(hidden[:, -1, :], params["lm_head"])
