"""DeepSeek-OCR-2 composite (port of deepseek_ocr2_tpu.models.deepseek_ocr2).

SAM -> Qwen2 compressor -> linear projector (896 -> 1280) plus the learned
`view_seperator`; the vision tokens replace the `<image>` placeholder block
of the prompt, in the order local (the crops, row-major) -> global ->
view_seperator.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import OCR2Config

from ..io.safetensors_torch import DtypePolicy, FlatSource, LoadReport, as_tensor
from . import deepseek_v2 as dsv2
from . import qwen2 as qwen2_mod
from . import sam as sam_mod

Params = Dict[str, Any]


def normalize_pixels(x: torch.Tensor, act_dtype: torch.dtype) -> torch.Tensor:
    """uint8 pixels -> [-1, 1] in act_dtype, with the f32 op sequence of the
    host path (u8 -> f32, / 255, * 2, - 1); float inputs are only cast."""
    if x.dtype == torch.uint8:
        x = x.float() / 255.0
        x = x * 2.0 - 1.0
    return x.to(act_dtype)


def params_from_flat(
    flat: Dict[str, Any], cfg: OCR2Config, device="cpu", policy: Optional[DtypePolicy] = None
) -> Tuple[Params, LoadReport]:
    """HF-layout flat dict (torch tensors or numpy arrays) -> port params on
    `device`, with `policy` applied per tensor name as the CLI does."""
    src = FlatSource(flat, torch.device(device), policy or DtypePolicy(default=None))
    params = {
        "lm": dsv2.params_from_source(src, cfg.lm),
        "sam": sam_mod.params_from_source(src, cfg.sam),
        "qwen2": qwen2_mod.params_from_source(src, cfg.qwen2),
        "projector_w": src.take("model.projector.layers.weight"),
        "projector_b": src.take("model.projector.layers.bias"),
        "view_seperator": src.take("model.view_seperator"),
    }
    return params, src.finish()


def params_from_jax(tree: Params, cfg: OCR2Config, device="cpu") -> Params:
    """From the JAX package's parameter pytree given as numpy arrays
    (bf16 leaves as ml_dtypes arrays)."""

    def t(a):
        return as_tensor(np.asarray(a)).contiguous().to(device)

    return {
        "lm": dsv2.params_from_jax(tree["lm"], cfg.lm, device),
        "sam": sam_mod.params_from_jax(tree["sam"], cfg.sam, device),
        "qwen2": qwen2_mod.params_from_jax(tree["qwen2"], cfg.qwen2, device),
        "projector_w": t(np.asarray(tree["projector"]["w"]).T),
        "projector_b": t(tree["projector"]["b"]),
        "view_seperator": t(tree["view_seperator"]),
    }


def encode_views(
    params: Params, cfg: OCR2Config, image_base: torch.Tensor, patches: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """[1, 3, S, S] normalized global view and, in crop mode, the [P, 3, c, c]
    crops (one SAM batch) -> injected token rows [n_img, lm_hidden]."""
    h = cfg.lm.hidden_size

    def tower(imgs):
        feats = sam_mod.sam_forward(params["sam"], cfg.sam, imgs)
        feats = qwen2_mod.qwen2_encode(params["qwen2"], cfg.qwen2, feats)
        dt = feats.dtype
        return (F.linear(feats, params["projector_w"].to(dt)) + params["projector_b"].to(dt)).reshape(-1, h)

    g = tower(image_base)
    views = [g] if patches is None else [tower(patches), g]
    return torch.cat([*views, params["view_seperator"].reshape(1, h).to(g.dtype)], dim=0)


def encode_views_batched(
    params: Params, cfg: OCR2Config, image_base: torch.Tensor, patches: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Batched vision for multi-page serving: [B, 3, S, S] global views and,
    in crop mode, [B, P, 3, c, c] crops (pages of a batch share the crop
    grid) -> [B, n_img, lm_hidden]. The crops flatten into one SAM batch of
    B * P tiles; each page's tokens go local -> global -> separator."""
    h = cfg.lm.hidden_size
    b = image_base.shape[0]

    def tower(imgs):
        feats = sam_mod.sam_forward(params["sam"], cfg.sam, imgs)
        feats = qwen2_mod.qwen2_encode(params["qwen2"], cfg.qwen2, feats)
        dt = feats.dtype
        return F.linear(feats, params["projector_w"].to(dt)) + params["projector_b"].to(dt)

    g = tower(image_base)  # [B, nq_base, H]
    sep = params["view_seperator"].to(g.dtype).reshape(1, 1, h).expand(b, 1, h)
    if patches is None:
        return torch.cat([g, sep], dim=1)
    p = patches.shape[1]
    loc = tower(patches.reshape(b * p, *patches.shape[2:]))  # [B * P, nq_crop, H]
    return torch.cat([loc.reshape(b, -1, h), g, sep], dim=1)


def ocr_prefill_embeds_batched(
    params: Params,
    cfg: OCR2Config,
    input_ids: torch.Tensor,  # [B, S]
    image_base: torch.Tensor,  # [B, 3, S, S] normalized
    patches: Optional[torch.Tensor],  # [B, P, 3, c, c] normalized, or None
    image_start: int,
) -> torch.Tensor:
    """[B, S, H] prompt embeddings of a batch of pages sharing one prompt:
    the placeholder block of every row replaced by that page's tokens."""
    vision = encode_views_batched(params, cfg, image_base, patches)
    n = vision.shape[1]
    input_ids = input_ids.clone()
    input_ids[:, image_start : image_start + n] = 0  # placeholder ids are never looked up
    base = F.embedding(input_ids, params["lm"]["embed"])
    base[:, image_start : image_start + n] = vision.to(base.dtype)
    return base


def build_inputs_embeds(
    params: Params, input_ids: torch.Tensor, vision_tokens: torch.Tensor, image_start: int
) -> torch.Tensor:
    """Token embeddings [1, S, H] with the contiguous placeholder block
    replaced by the vision tokens (cast to the embedding dtype). The
    placeholder id itself is never looked up: a test config's vocabulary
    may not hold it."""
    n = vision_tokens.shape[0]
    input_ids = input_ids.clone()
    input_ids[:, image_start : image_start + n] = 0
    base = F.embedding(input_ids, params["lm"]["embed"])
    base[:, image_start : image_start + n] = vision_tokens.to(base.dtype)[None]
    return base
