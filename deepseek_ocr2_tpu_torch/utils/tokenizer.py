"""Prompt tokenization with image placeholder expansion (the port's copy of
deepseek_ocr2_tpu/utils/tokenizer.py; `tokenizers` is imported only by
`load_tokenizer`).

Parity with reference main.rs:1173-1226 (tokenize_with_image) and
main.rs:853-856 (text path): BOS id 0 prepended, `<image>` expanded into
N placeholder tokens (id 128815) where
N = (base/16 ceil/4)^2 + 1 + (crop/16 ceil/4)^2 * tiles_w * tiles_h.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..configs import OCR2Config


def load_tokenizer(path: str):
    from tokenizers import Tokenizer

    return Tokenizer.from_file(str(path))


def tokenize_text(tokenizer, prompt: str, bos_id: int = 0) -> List[int]:
    enc = tokenizer.encode(prompt, add_special_tokens=False)
    return [bos_id] + list(enc.ids)


def tokenize_with_image(
    tokenizer,
    prompt: str,
    cfg: OCR2Config,
    crop_ratio: Tuple[int, int] = (1, 1),
) -> Tuple[List[int], List[bool], int]:
    """Returns (ids, image_mask, image_start).

    The placeholder block is always contiguous; `image_start` is its index.
    """
    if prompt.count("<image>") != 1:
        raise ValueError("prompt must contain exactly one '<image>' placeholder")
    ids, mask, starts = tokenize_with_images(tokenizer, prompt, cfg, [crop_ratio])
    return ids, mask, starts[0]


def tokenize_with_images(
    tokenizer,
    prompt: str,
    cfg: OCR2Config,
    crop_ratios: List[Tuple[int, int]],
) -> Tuple[List[int], List[bool], List[int]]:
    """Multi-image variant: every `<image>` in the prompt expands into its
    own placeholder block (one crop ratio per image, in order). Returns
    (ids, image_mask, image_starts). Non-contiguous masks are injected via
    the scatter path (models.deepseek_ocr2.build_inputs_embeds_masked,
    reference deepseek_ocr2.rs:273-297)."""
    parts = prompt.split("<image>")
    n_images = len(parts) - 1
    if n_images < 1:
        raise ValueError("prompt must contain at least one '<image>' placeholder")
    if len(crop_ratios) != n_images:
        raise ValueError(
            f"prompt has {n_images} '<image>' placeholders but "
            f"{len(crop_ratios)} crop ratios were given"
        )

    ids: List[int] = [cfg.bos_token_id]
    mask: List[bool] = [False]
    starts: List[int] = []

    for pi, part in enumerate(parts):
        if part:
            enc = tokenizer.encode(part, add_special_tokens=False)
            ids.extend(enc.ids)
            mask.extend([False] * len(enc.ids))
        if pi < n_images:
            n_img = cfg.image_token_count(crop_ratios[pi])
            starts.append(len(ids))
            ids.extend([cfg.image_token_id] * n_img)
            mask.extend([True] * n_img)

    return ids, mask, starts


def decode_output(
    tokenizer, ids: List[int], stop_string: Optional[str] = None
) -> str:
    """Detokenize generated ids, strip the stop string, trim
    (reference main.rs:1616-1631)."""
    text = tokenizer.decode([int(i) for i in ids], skip_special_tokens=False)
    if stop_string and text.endswith(stop_string):
        text = text[: -len(stop_string)]
    return text.strip()
