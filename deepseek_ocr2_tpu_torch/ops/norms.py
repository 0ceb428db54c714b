"""Normalization ops with f32 inner math (port of deepseek_ocr2_tpu.ops.norms).

- RMSNorm: variance/normalize in f32, cast back, weight applied in the model
  dtype (HF DeepSeek-V2 / Qwen2 semantics).
- LayerNorm over the last axis: biased variance, eps inside the sqrt, f32
  interior, affine in the model dtype. SAM's channel LayerNorm2d runs on
  NHWC tokens, where it is this same op.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    rms = torch.sqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return weight.to(dtype) * (x32 / rms).to(dtype)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = ((x32 - mean) / torch.sqrt(var + eps)).to(dtype)
    return y * weight.to(dtype) + bias.to(dtype)
