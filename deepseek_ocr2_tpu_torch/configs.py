"""Model configurations: the JAX package's dataclasses, imported, not copied.

`deepseek_ocr2_tpu.configs` holds plain dataclasses and imports no jax, so
both packages read one definition of every width and default.
"""

from deepseek_ocr2_tpu.configs import (  # noqa: F401
    DeepseekV2Config,
    OCR2Config,
    Qwen2Config,
    SamConfig,
    config_from_json,
    tiny_lm_config,
    tiny_ocr2_config,
    tiny_qwen2_config,
    tiny_sam_config,
)
