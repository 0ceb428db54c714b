"""SAM ViT-B image encoder (port of deepseek_ocr2_tpu.models.sam).

NHWC tokens through the transformer, windowed blocks with true 14x14
windows (196 keys; the TPU's 16x16 padding was a lane workaround), the
64 -> 70 zero padding of `window_partition` kept (those tokens are real keys
in HF semantics), decomposed relative-position attention through kernel B
(`ops.flash_attention.mha_relpos`) and every block MLP through kernel C
(`ops.fused_mlp.mlp_gelu`). The rel_h / rel_w einsums stay outside the
kernel, as in the JAX package. Under `DEEPSEEK_SAM_WIN_KERNEL=1` (read at
each call, as the JAX package reads it) the windowed blocks run kernel V
(`ops.flash_attention.mha_win`) instead, which builds the bias inside the
kernel from the flattened rel-pos tables; the global blocks stay on B. The
JAX package takes that path only for windows padded 14 -> 16 (a TPU lane
rule); the port runs V on its true 14 x 14 windows (win = valid = 14).
Weights keep HF layout ([out, in] linears, OIHW convs).

At the 768^2 crop views the absolute pos-embed (64 x 64) is resized to the
48 x 48 patch grid (bicubic with antialias) and the global blocks' rel-pos
tables (127 rows) to 95 (linear), both in f32 with `F.interpolate`, as the
JAX package does with `jax.image.resize` (the same HF contract).
`DEEPSEEK_SAM_POS_RESIZE` selects the reference binary's pos-embed filters
instead (`resize_pos_embed`).

`sam_forward(..., training=True)` is the differentiable form for
fine-tuning: every block's attention (global and windowed) is the plain
rel-pos attention `mha_reference` and every MLP `mlp_gelu_reference`, the
arithmetic of the JAX package's XLA path. Kernels B, C and V have no
backward (nor do their Pallas originals), and their wrappers refuse an
input that requires grad, so a training forward without the flag raises.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import SamConfig

from ..io.safetensors_torch import DtypePolicy, FlatSource, LoadReport, as_tensor
from ..ops.flash_attention import mha_reference, mha_relpos, mha_win
from ..ops.fused_mlp import mlp_gelu, mlp_gelu_reference
from ..ops.norms import layer_norm

Params = Dict[str, Any]

_BLOCK_KEYS = {
    "ln1_w": "norm1.weight", "ln1_b": "norm1.bias",
    "ln2_w": "norm2.weight", "ln2_b": "norm2.bias",
    "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
    "proj_w": "attn.proj.weight", "proj_b": "attn.proj.bias",
    "rel_h": "attn.rel_pos_h", "rel_w": "attn.rel_pos_w",
    "w1": "mlp.lin1.weight", "b1": "mlp.lin1.bias",
    "w2": "mlp.lin2.weight", "b2": "mlp.lin2.bias",
}
_TOP_KEYS = {
    "patch_w": "patch_embed.proj.weight", "patch_b": "patch_embed.proj.bias",
    "pos_embed": "pos_embed",
    "neck_conv1": "neck.0.weight", "neck_ln1_w": "neck.1.weight", "neck_ln1_b": "neck.1.bias",
    "neck_conv2": "neck.2.weight", "neck_ln2_w": "neck.3.weight", "neck_ln2_b": "neck.3.bias",
    "net_2": "net_2.weight", "net_3": "net_3.weight",
}


def params_from_source(src: FlatSource, cfg: SamConfig, prefix: str = "model.sam_model.") -> Params:
    params = {k: src.take(prefix + hf) for k, hf in _TOP_KEYS.items()}
    params["blocks"] = [
        {k: src.take(f"{prefix}blocks.{i}.{hf}") for k, hf in _BLOCK_KEYS.items()}
        for i in range(cfg.depth)
    ]
    return params


def params_from_flat(flat, cfg: SamConfig, device="cpu", policy=None) -> Tuple[Params, LoadReport]:
    src = FlatSource(flat, torch.device(device), policy or DtypePolicy(default=None))
    return params_from_source(src, cfg), src.report


def flat_from_params(params: Params, cfg: SamConfig, prefix: str = "model.sam_model.") -> Dict[str, torch.Tensor]:
    """Inverse of `params_from_source`: HF names and layout (the JAX
    package's `flat_from_params` writes the same names and arrays)."""
    flat = {prefix + hf: params[k] for k, hf in _TOP_KEYS.items()}
    for i, blk in enumerate(params["blocks"]):
        flat.update({f"{prefix}blocks.{i}.{hf}": blk[k] for k, hf in _BLOCK_KEYS.items()})
    return flat


def params_from_jax(tree: Params, cfg: SamConfig, device="cpu") -> Params:
    """From the JAX package's SAM pytree (numpy leaves; linears [in, out])."""

    def t(a, transpose=False):
        x = as_tensor(np.asarray(a))
        return (x.t() if transpose else x).contiguous().to(device)

    blocks = []
    for blk in tree["blocks"]:
        a, m = blk["attn"], blk["mlp"]
        blocks.append({
            "ln1_w": t(blk["ln1"]["w"]), "ln1_b": t(blk["ln1"]["b"]),
            "ln2_w": t(blk["ln2"]["w"]), "ln2_b": t(blk["ln2"]["b"]),
            "qkv_w": t(a["qkv_w"], True), "qkv_b": t(a["qkv_b"]),
            "proj_w": t(a["proj_w"], True), "proj_b": t(a["proj_b"]),
            "rel_h": t(a["rel_h"]), "rel_w": t(a["rel_w"]),
            "w1": t(m["w1"], True), "b1": t(m["b1"]),
            "w2": t(m["w2"], True), "b2": t(m["b2"]),
        })
    neck = tree["neck"]
    return {
        "patch_w": t(tree["patch_embed"]["w"]), "patch_b": t(tree["patch_embed"]["b"]),
        "pos_embed": t(tree["pos_embed"]),
        "neck_conv1": t(neck["conv1"]),
        "neck_ln1_w": t(neck["ln1"]["w"]), "neck_ln1_b": t(neck["ln1"]["b"]),
        "neck_conv2": t(neck["conv2"]),
        "neck_ln2_w": t(neck["ln2"]["w"]), "neck_ln2_b": t(neck["ln2"]["b"]),
        "net_2": t(tree["net_2"]), "net_3": t(tree["net_3"]),
        "blocks": blocks,
    }


def _patch_embed(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, 3, S, S] -> [B, S/p, S/p, E]: a stride == kernel conv is a reshape
    plus one GEMM, written as the JAX package writes it."""
    b_, c, hh, ww = x.shape
    h, w_ = hh // patch, ww // patch
    xp = x.reshape(b_, c, h, patch, w_, patch).permute(0, 2, 4, 3, 5, 1)
    xp = xp.reshape(b_, h, w_, patch * patch * c)
    wm = w.to(x.dtype).permute(2, 3, 1, 0).reshape(patch * patch * c, -1)
    return torch.matmul(xp, wm) + b.to(x.dtype)


def window_partition(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> [B*nW, win, win, C], zero-padded to whole windows."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(windows, window: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    c = windows.shape[-1]
    b = windows.shape[0] // ((hp // window) * (wp // window))
    x = windows.reshape(b, hp // window, wp // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)[:, :h, :w, :]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """[q_size, k_size, head_dim] f32 table lookup; a table of another
    length is first resized linearly (align_corners=False, no antialias)."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    rel = rel_pos.float()
    if rel.shape[0] != max_rel_dist:
        rel = F.interpolate(rel.t()[None], size=max_rel_dist, mode="linear", align_corners=False)[0].t()
    idx = torch.arange(q_size)[:, None] - torch.arange(k_size)[None, :] + (k_size - 1)
    return rel[idx.to(rel.device)]


def _keys_cubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out, in] weights of `jax.image.resize(..., "bicubic",
    antialias=False)` along one axis, in its f32 operation order
    (`jax.image.scale.compute_weight_mat`): the Keys cubic (a = -0.5) at the
    half-pixel sample points, each row normalized over the taps inside the
    input. `F.interpolate`'s bicubic uses a = -0.75 and clamps at the edges
    instead."""
    f = np.float32
    sample = (np.arange(out_size, dtype=f) + f(0.5)) * f(1.0 / (out_size / in_size)) - f(0.5)
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=f)[None, :])
    near = ((f(1.5) * x - f(2.5)) * x) * x + f(1.0)
    far = ((f(-0.5) * x + f(2.5)) * x - f(4.0)) * x + f(2.0)
    w = np.where(x >= 2.0, f(0.0), np.where(x >= 1.0, far, near)).astype(f)
    total = w.sum(axis=1, keepdims=True, dtype=f)
    keep = np.abs(total) > 1000.0 * np.finfo(f).eps
    return np.where(keep, w / np.where(total != 0, total, f(1.0)), f(0.0)).astype(f)


def resize_pos_embed(pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[1, ph, pw, C] -> [1, h, w, C]: bicubic with antialias,
    align_corners=False, in f32, cast back (HF's `F.interpolate` contract).

    DEEPSEEK_SAM_POS_RESIZE (read at each call, as the JAX package reads it)
    selects the reference binary's approximations, for numeric-diff
    debugging: "interp_bilinear" is bilinear without antialias (the
    reference's default), "interp_bicubic" bicubic without antialias, each
    as `jax.image.resize` computes it.
    """
    if tuple(pos.shape[1:3]) == (h, w):
        return pos
    mode = os.environ.get("DEEPSEEK_SAM_POS_RESIZE", "")
    x = pos.float().permute(0, 3, 1, 2)  # [1, C, ph, pw]
    if mode == "interp_bicubic":
        wh = torch.from_numpy(_keys_cubic_weights(pos.shape[1], h)).to(x.device)
        ww = torch.from_numpy(_keys_cubic_weights(pos.shape[2], w)).to(x.device)
        out = torch.einsum("yp,ncpq,xq->ncyx", wh, x, ww)
    elif mode == "interp_bilinear":
        out = F.interpolate(x, size=(h, w), mode="bilinear", antialias=False, align_corners=False)
    else:
        out = F.interpolate(x, size=(h, w), mode="bicubic", antialias=True, align_corners=False)
    return out.permute(0, 2, 3, 1).to(pos.dtype)


def _attention(x: torch.Tensor, blk: Params, num_heads: int, win_kernel: bool = False,
               training: bool = False) -> torch.Tensor:
    """Decomposed rel-pos attention on [B, H, W, C] through kernel B, or
    with `win_kernel` (square windows) through kernel V on the flattened
    tables, or with `training` through the plain differentiable form."""
    b, h, w, dim = x.shape
    hd = dim // num_heads
    l = h * w
    qkv = (F.linear(x, blk["qkv_w"].to(x.dtype)) + blk["qkv_b"].to(x.dtype)).reshape(
        b, l, 3, num_heads, hd
    )
    q = qkv[:, :, 0].transpose(1, 2)  # [B, heads, L, hd]
    k = qkv[:, :, 1].transpose(1, 2)
    v = qkv[:, :, 2].transpose(1, 2)

    rh = get_rel_pos(h, h, blk["rel_h"])
    rw = get_rel_pos(w, w, blk["rel_w"])
    if win_kernel and not training:  # rhf[c, i * win + j] = rh[i, j, c]
        rhf, rwf = (t.permute(2, 0, 1).reshape(hd, l) for t in (rh, rw))
        ctx = mha_win(q, k, v, rhf, rwf, scale=1.0 / math.sqrt(hd), win=h, valid=h)
    else:
        # Bias terms from the unscaled q, in f32.
        r_q = q.float().reshape(b * num_heads, h, w, hd)
        rel_h = torch.einsum("nhwc,hkc->nhwk", r_q, rh).reshape(b, num_heads, l, h)
        rel_w = torch.einsum("nhwc,wkc->nhwk", r_q, rw).reshape(b, num_heads, l, w)
        attend = mha_reference if training else mha_relpos
        ctx = attend(q, k, v, rel_h=rel_h, rel_w=rel_w, scale=1.0 / math.sqrt(hd))
    ctx = ctx.transpose(1, 2).reshape(b, h, w, dim)
    return F.linear(ctx, blk["proj_w"].to(x.dtype)) + blk["proj_b"].to(x.dtype)


def _block(x: torch.Tensor, blk: Params, cfg: SamConfig, window: int, training: bool = False) -> torch.Tensor:
    shortcut = x
    x = layer_norm(x, blk["ln1_w"], blk["ln1_b"], cfg.layer_norm_eps)
    if window > 0:
        _, h, w, _ = x.shape
        wins, pad_hw = window_partition(x, window)
        win_kernel = os.environ.get("DEEPSEEK_SAM_WIN_KERNEL", "") == "1"
        x = window_unpartition(_attention(wins, blk, cfg.num_heads, win_kernel, training), window, pad_hw, (h, w))
    else:
        x = _attention(x, blk, cfg.num_heads, training=training)
    x = shortcut + x
    xn = layer_norm(x, blk["ln2_w"], blk["ln2_b"], cfg.layer_norm_eps)
    bb, hh, ww, cc = xn.shape
    mlp = (mlp_gelu_reference if training else mlp_gelu)(
        xn.reshape(bb * hh * ww, cc), blk["w1"], blk["b1"], blk["w2"], blk["b2"])
    return x + mlp.reshape(bb, hh, ww, cc)


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """3x3 / padding-1 conv on NHWC tokens with an OIHW weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), stride=stride, padding=1)
    return y.permute(0, 2, 3, 1)


def sam_forward(params: Params, cfg: SamConfig, x: torch.Tensor, training: bool = False) -> torch.Tensor:
    """[B, 3, S, S] image -> [B, net_3_chans, S/64, S/64] features.
    `training`: the differentiable form (see the module docstring)."""
    x = _patch_embed(x, params["patch_w"], params["patch_b"], cfg.patch_size)
    _, h, w, _ = x.shape
    x = x + resize_pos_embed(params["pos_embed"], h, w).to(x.dtype)
    for i, blk in enumerate(params["blocks"]):
        window = 0 if i in cfg.global_attn_indexes else cfg.window_size
        x = _block(x, blk, cfg, window, training)

    eps = cfg.layer_norm_eps
    x = torch.matmul(x, params["neck_conv1"][:, :, 0, 0].t().to(x.dtype))  # 1x1 conv
    x = layer_norm(x, params["neck_ln1_w"], params["neck_ln1_b"], eps)
    x = _conv_nhwc(x, params["neck_conv2"])
    x = layer_norm(x, params["neck_ln2_w"], params["neck_ln2_b"], eps)
    x = _conv_nhwc(x, params["net_2"], stride=2)
    x = _conv_nhwc(x, params["net_3"], stride=2)
    return x.permute(0, 3, 1, 2)
