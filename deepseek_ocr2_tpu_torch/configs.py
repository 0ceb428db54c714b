"""Model configurations (the port's own copy of deepseek_ocr2_tpu/configs.py:
the same dataclasses, defaults, `config_from_json` and `tiny_*` factories;
a test holds the two equal field by field).

Defaults mirror the reference implementation exactly:
- DeepseekV2Config: reference deepseek_v2.rs:118-137
- Qwen2Config:      reference qwen2.rs:30-43
- SamConfig:        reference sam.rs:482-493
- OCR constants (BOS/EOS/image token, prompt): reference main.rs:18, 158-217
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """DeepSeek-V2 language backbone config (reference deepseek_v2.rs:118-137)."""

    vocab_size: int = 129_280
    hidden_size: int = 1280
    intermediate_size: int = 6848
    max_position_embeddings: int = 8192
    num_hidden_layers: int = 12
    num_attention_heads: int = 10
    num_key_value_heads: int = 10
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    # MoE
    first_k_dense_replace: int = 1
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    moe_intermediate_size: int = 896
    num_experts_per_tok: int = 6

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    """Qwen2 decoder-as-encoder config (reference qwen2.rs:30-43)."""

    hidden_size: int = 896
    intermediate_size: int = 4864
    num_hidden_layers: int = 24
    num_attention_heads: int = 14
    num_key_value_heads: int = 2
    max_position_embeddings: int = 131_072
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    # Learned query tables (reference qwen2.rs:358-365).
    n_query_768: int = 144
    n_query_1024: int = 256

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def gqa_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


@dataclasses.dataclass(frozen=True)
class SamConfig:
    """SAM ViT-B image encoder config (reference sam.rs:482-493)."""

    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    # Extra downsample stack producing the 896-channel feature map
    # (reference sam.rs:529-540).
    net_2_chans: int = 512
    net_3_chans: int = 896
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def tokens_per_side(self) -> int:
        return self.img_size // self.patch_size


@dataclasses.dataclass(frozen=True)
class OCR2Config:
    """Composite DeepSeek-OCR-2 model config.

    Ties the three towers together, mirroring the composite module in
    reference deepseek_ocr2.rs:62-99.
    """

    lm: DeepseekV2Config = dataclasses.field(default_factory=DeepseekV2Config)
    qwen2: Qwen2Config = dataclasses.field(default_factory=Qwen2Config)
    sam: SamConfig = dataclasses.field(default_factory=SamConfig)

    projector_in: int = 896
    # projector_out == lm.hidden_size

    # Tokenizer / prompt constants (reference main.rs:18, 158-217, 854, 1016).
    bos_token_id: int = 0
    eos_token_id: int = 1
    image_token_id: int = 128_815
    stop_string: str = "<｜end▁of▁sentence｜>"
    default_ocr_prompt: str = "<image>\nFree OCR."

    # Image preprocessing defaults (reference main.rs:196-217).
    base_image_size: int = 1024
    crop_image_size: int = 768
    min_crop_tiles: int = 2
    max_crop_tiles: int = 6
    pad_color: int = 127
    # Token-grid geometry (reference main.rs:1206-1218).
    downsample_ratio: int = 4

    def num_queries(self, image_size: int) -> int:
        """Vision tokens per side for a square view of `image_size`.

        reference main.rs:1210: ceil((size/patch)/downsample) per side.
        """
        patches = image_size // self.sam.patch_size
        return -(-patches // self.downsample_ratio)

    def image_token_count(self, crop_ratio: Tuple[int, int]) -> int:
        """Total `<image>` placeholder tokens (reference main.rs:1206-1218)."""
        nb = self.num_queries(self.base_image_size)
        n = nb * nb + 1  # +1 view separator
        tw, th = crop_ratio
        if tw > 1 or th > 1:
            nq = self.num_queries(self.crop_image_size)
            n += (nq * tw) * (nq * th)
        return n


def config_from_json(path: str) -> OCR2Config:
    """Build an OCR2Config from a JSON file of (nested) field overrides.

    Example: {"lm": {"num_hidden_layers": 3}, "base_image_size": 256}.
    Fields not present keep the reference defaults.
    """
    import json

    with open(path) as f:
        data = json.load(f)
    lm = DeepseekV2Config(**data.pop("lm", {}))
    qwen2 = Qwen2Config(**data.pop("qwen2", {}))
    sam = SamConfig(
        **{k: tuple(v) if k == "global_attn_indexes" else v for k, v in data.pop("sam", {}).items()}
    )
    return OCR2Config(lm=lm, qwen2=qwen2, sam=sam, **data)


def tiny_lm_config(**overrides) -> DeepseekV2Config:
    """Small DeepSeek-V2 config for tests (same structure, tiny dims)."""
    base = dict(
        vocab_size=512,
        hidden_size=64,
        intermediate_size=128,
        max_position_embeddings=256,
        num_hidden_layers=3,
        num_attention_heads=4,
        num_key_value_heads=4,
        first_k_dense_replace=1,
        n_routed_experts=8,
        n_shared_experts=2,
        moe_intermediate_size=32,
        num_experts_per_tok=2,
    )
    base.update(overrides)
    return DeepseekV2Config(**base)


def tiny_qwen2_config(**overrides) -> Qwen2Config:
    base = dict(
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        n_query_768=9,
        n_query_1024=16,
    )
    base.update(overrides)
    return Qwen2Config(**base)


def tiny_sam_config(**overrides) -> SamConfig:
    base = dict(
        img_size=256,
        patch_size=16,
        embed_dim=32,
        depth=3,
        num_heads=2,
        mlp_ratio=2.0,
        out_chans=16,
        window_size=3,
        global_attn_indexes=(2,),
        net_2_chans=24,
        net_3_chans=40,
    )
    base.update(overrides)
    return SamConfig(**base)


def tiny_ocr2_config(**overrides) -> OCR2Config:
    """Tiny composite config for tests; geometry kept self-consistent."""
    lm = overrides.pop("lm", tiny_lm_config())
    qwen2 = overrides.pop(
        "qwen2",
        tiny_qwen2_config(hidden_size=40, num_attention_heads=4, num_key_value_heads=2),
    )
    sam = overrides.pop("sam", tiny_sam_config())
    # Geometry: base 256 -> 16x16 patch grid -> SAM output 4x4 -> n_query 16
    # (matches qwen2.n_query_1024); crop 192 -> 12x12 -> 3x3 -> n_query 9
    # (matches qwen2.n_query_768). Mirrors the real 1024/768 relationship.
    base = dict(
        lm=lm,
        qwen2=qwen2,
        sam=sam,
        projector_in=qwen2.hidden_size,
        base_image_size=256,
        crop_image_size=192,
    )
    base.update(overrides)
    return OCR2Config(**base)
