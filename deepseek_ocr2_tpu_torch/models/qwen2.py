"""Qwen2 decoder-as-encoder, the vision token compressor
(port of deepseek_ocr2_tpu.models.qwen2).

SAM features [B, C, h, w] are flattened to h*w tokens and followed by the
learned query table for that count (144 for 768^2 crops, 256 for the 1024^2
view); GQA layers with a prefix-LM mask (prefix attends within the prefix,
queries attend to the prefix plus causally to themselves), RoPE and
attention in f32; the output is the query half.

Attention is the plain `sdpa`, as the JAX package's default is
(its flash kernel is off for Qwen2 there). q/k/v and gate/up are fused per
layer along the output axis in HF [out, in] layout: [H + 2 KVH, H] and
[2 I, H] (output columns are independent, so this is exact);
`flat_from_params` splits them back into HF's names. Weights are cast to
the activation dtype, as SAM and the projector cast theirs: bf16
activations (uint8 pixels in fine-tuning) run on f32 weights too.
Everything here is plain PyTorch, so `qwen2_encode` is differentiable as
it stands.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import Qwen2Config

from ..io.safetensors_torch import DtypePolicy, FlatSource, LoadReport, as_tensor
from ..ops.attention import prefix_lm_mask, repeat_kv, sdpa
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_cache

Params = Dict[str, Any]


def params_from_source(src: FlatSource, cfg: Qwen2Config, prefix: str = "model.qwen2_model.") -> Params:
    mp = prefix + "model.model."

    def cat(names):
        parts = [src.take(n) for n in names]
        return None if any(p is None for p in parts) else torch.cat(parts, dim=0)

    layers = []
    for i in range(cfg.num_hidden_layers):
        lp = f"{mp}layers.{i}."
        layers.append({
            "ln1": src.take(lp + "input_layernorm.weight"),
            "ln2": src.take(lp + "post_attention_layernorm.weight"),
            "wqkv": cat([lp + f"self_attn.{n}_proj.weight" for n in "qkv"]),
            "bqkv": cat([lp + f"self_attn.{n}_proj.bias" for n in "qkv"]),
            "wo": src.take(lp + "self_attn.o_proj.weight"),
            "gateup": cat([lp + "mlp.gate_proj.weight", lp + "mlp.up_proj.weight"]),
            "down": src.take(lp + "mlp.down_proj.weight"),
        })
    return {
        "layers": layers,
        "norm": src.take(mp + "norm.weight"),
        "query_768": src.take(prefix + "query_768.weight"),
        "query_1024": src.take(prefix + "query_1024.weight"),
    }


def params_from_flat(flat, cfg: Qwen2Config, device="cpu", policy=None) -> Tuple[Params, LoadReport]:
    src = FlatSource(flat, torch.device(device), policy or DtypePolicy(default=None))
    return params_from_source(src, cfg), src.report


def flat_from_params(params: Params, cfg: Qwen2Config, prefix: str = "model.qwen2_model.") -> Dict[str, torch.Tensor]:
    """Inverse of `params_from_source`: HF names and layout, the fused
    q||k||v and gate||up split back (the JAX package's `flat_from_params`
    writes the same names and arrays)."""
    mp = prefix + "model.model."
    h, kvh, i_dim = cfg.hidden_size, cfg.num_key_value_heads * cfg.head_dim, cfg.intermediate_size
    flat = {}
    for i, lp in enumerate(params["layers"]):
        p = f"{mp}layers.{i}."
        flat[p + "input_layernorm.weight"] = lp["ln1"]
        flat[p + "post_attention_layernorm.weight"] = lp["ln2"]
        for n, (a, b) in zip("qkv", ((0, h), (h, h + kvh), (h + kvh, h + 2 * kvh))):
            flat[f"{p}self_attn.{n}_proj.weight"] = lp["wqkv"][a:b]
            flat[f"{p}self_attn.{n}_proj.bias"] = lp["bqkv"][a:b]
        flat[p + "self_attn.o_proj.weight"] = lp["wo"]
        flat[p + "mlp.gate_proj.weight"] = lp["gateup"][:i_dim]
        flat[p + "mlp.up_proj.weight"] = lp["gateup"][i_dim:]
        flat[p + "mlp.down_proj.weight"] = lp["down"]
    flat[mp + "norm.weight"] = params["norm"]
    flat[prefix + "query_768.weight"] = params["query_768"]
    flat[prefix + "query_1024.weight"] = params["query_1024"]
    return flat


def params_from_jax(tree: Params, cfg: Qwen2Config, device="cpu") -> Params:
    """From the JAX pytree: stacked [L, ...] layers, linears [in, out]."""

    def t(a, transpose=False):
        x = as_tensor(np.asarray(a))
        return (x.t() if transpose else x).contiguous().to(device)

    lay = tree["layers"]
    layers = [
        {
            "ln1": t(lay["ln1"][i]), "ln2": t(lay["ln2"][i]),
            "wqkv": t(lay["wqkv"][i], True), "bqkv": t(lay["bqkv"][i]),
            "wo": t(lay["wo"][i], True),
            "gateup": t(lay["gateup"][i], True), "down": t(lay["down"][i], True),
        }
        for i in range(cfg.num_hidden_layers)
    ]
    return {
        "layers": layers,
        "norm": t(tree["norm"]),
        "query_768": t(tree["query_768"]),
        "query_1024": t(tree["query_1024"]),
    }


def _layer(x, lp, cfg: Qwen2Config, mask, cos, sin) -> torch.Tensor:
    b, s, h = x.shape
    nh, nkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    dt = x.dtype
    kvh = nkv * d

    res = x
    xn = rms_norm(x, lp["ln1"], cfg.rms_norm_eps)
    qkv = F.linear(xn, lp["wqkv"].to(dt)) + lp["bqkv"].to(dt)
    q = qkv[..., :h].reshape(b, s, nh, d).transpose(1, 2)
    k = qkv[..., h : h + kvh].reshape(b, s, nkv, d).transpose(1, 2)
    v = qkv[..., h + kvh :].reshape(b, s, nkv, d).transpose(1, 2)

    q32, k32 = apply_rope(q, k, cos, sin, start=0)
    k32 = repeat_kv(k32, cfg.gqa_groups)
    v32 = repeat_kv(v.float(), cfg.gqa_groups)
    ctx = sdpa(q32, k32, v32, scale=1.0 / math.sqrt(d), mask=mask, out_dtype=dt)
    x = res + F.linear(ctx.transpose(1, 2).reshape(b, s, h), lp["wo"].to(dt))

    res = x
    xn = rms_norm(x, lp["ln2"], cfg.rms_norm_eps)
    gu = F.linear(xn, lp["gateup"].to(dt))
    i_dim = gu.shape[-1] // 2
    act = F.silu(gu[..., :i_dim].float()).to(dt) * gu[..., i_dim:]
    return res + F.linear(act, lp["down"].to(dt))


def qwen2_encode(params: Params, cfg: Qwen2Config, feats: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] SAM features -> [B, n_query, C] compressed tokens."""
    b, hidden, h, w = feats.shape
    if hidden != cfg.hidden_size:
        raise ValueError(f"features have {hidden} channels, Qwen2 expects {cfg.hidden_size}")
    n_query = h * w
    x = feats.reshape(b, hidden, n_query).transpose(1, 2)
    if n_query == cfg.n_query_768:
        query = params["query_768"]
    elif n_query == cfg.n_query_1024:
        query = params["query_1024"]
    else:
        raise ValueError(f"unsupported n_query={n_query}")
    x = torch.cat([x, query[None].to(x.dtype).expand(b, n_query, hidden)], dim=1)

    seq = 2 * n_query
    mask = prefix_lm_mask(seq, n_query, device=x.device)[None, None]
    cos, sin = rope_cache(seq, cfg.head_dim, cfg.rope_theta, device=x.device)
    for lp in params["layers"]:
        x = _layer(x, lp, cfg, mask, cos, sin)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps)
    return x[:, n_query:, :]
