"""End-to-end OCR pipeline (port of deepseek_ocr2_tpu.runtime.pipeline).

Host stage (`preprocess_host`): decode, rotate, the crop decision (a side
above `crop_image_size`, unless `no_crop`), the crop grid, the letterbox to
the base size and the crop tiles, with PIL imported only there. Device stage
(`preprocess_finish` and `build_ocr_embeds`): ship the uint8 views,
normalize on the device, vision towers, injection. Then generation, greedy
or sampled (`sampling`); with `lookup_chunk` > 1 a greedy page decodes
by prompt lookup (`lookup_greedy_generate`). `generate_text` runs the LM
alone on a text prompt.

`kv_dtype` "int8" / "int8tail" selects the quantized paged pools, which
only the continuous engine has; `generate_ocr` and the group engine refuse
them through `make_kv_cache`, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import OCR2Config
from ..models import deepseek_ocr2 as ocr2
from ..models.deepseek_v2 import rope_consts
from ..utils.tokenizer import decode_output, tokenize_text, tokenize_with_image
from .generate import greedy_generate, lookup_greedy_generate
from .kv_cache import bucket_capacity

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_QUANTIZED_KV = ("int8", "int8tail")  # paged pools only: kept as the string


@dataclasses.dataclass
class GenerationResult:
    text: str
    token_ids: List[int]
    prompt_len: int
    prefill_seconds: float  # LM prefill (vision excluded; see vision_seconds)
    decode_seconds: float
    new_tokens: int
    vision_seconds: float = 0.0  # upload + normalize + towers + injection
    crop_ratio: Tuple[int, int] = (1, 1)  # the (w, h) crop grid; (1, 1) without crops
    logits0: Optional[torch.Tensor] = None  # step-0 logits [V] f32, CPU
    step_logits: Optional[List[torch.Tensor]] = None  # every step's [V], with keep_logits
    lookup_forwards: Optional[int] = None  # decode forwards of lookup decoding (prefill included)

    @property
    def decode_tokens_per_sec(self) -> float:
        return self.new_tokens / self.decode_seconds if self.decode_seconds > 0 else 0.0


class OCR2Pipeline:
    """Single-page pipeline on `device` ("cuda" or "cpu"; no silent fallback)."""

    def __init__(
        self,
        params: Dict[str, Any],
        cfg: OCR2Config,
        tokenizer,
        device: Union[str, torch.device] = "cuda",
        kv_dtype: str = "float32",
        act_dtype: str = "float32",
        lookup_chunk: int = 0,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but no CUDA device is available")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.kv_dtype = kv_dtype if kv_dtype in _QUANTIZED_KV else _DTYPES[kv_dtype]
        self.act_dtype = _DTYPES[act_dtype]
        # > 1: prompt-lookup greedy decoding with this chunk width (greedy
        # pages of generate_ocr and the engines; 1 is plain greedy).
        self.lookup_chunk = lookup_chunk
        self.rope = rope_consts(cfg.lm, self.device)  # host-built once, not per page

    def preprocess_host(
        self, image, no_crop: bool = False, rotate: Optional[int] = 0, auto_rotate: bool = False
    ) -> Dict[str, Any]:
        """Decode + rotate + crop decision + letterbox and tiles on the host.
        `image` is a path or a PIL image. Returns {"base": u8 [1, 3, S, S],
        "patches": u8 [P, 3, c, c] or None, "ratio": the (w, h) crop grid,
        (1, 1) without crops, "rot": degrees}."""
        from PIL import Image

        from ..preprocess.image import (
            auto_rotate_choice,
            candidate_ratios,
            find_closest_aspect_ratio,
            preprocess_base_u8,
            preprocess_tiles_u8,
            rotate_image,
            should_crop,
        )

        cfg = self.cfg
        img = Image.open(image).convert("RGB") if isinstance(image, str) else image.convert("RGB")
        rot = rotate if rotate else 0
        if rot == 0 and auto_rotate:
            rot = auto_rotate_choice(img)
        img = rotate_image(img, rot)
        patches, ratio = None, (1, 1)
        if should_crop(img, not no_crop, cfg.crop_image_size):
            w, h = img.size
            ratios = candidate_ratios(cfg.min_crop_tiles, cfg.max_crop_tiles)
            ratio = find_closest_aspect_ratio(w / h, ratios, w, h, cfg.crop_image_size)
            patches = preprocess_tiles_u8(img, cfg.crop_image_size, ratio)
        base = preprocess_base_u8(img, cfg.base_image_size, cfg.pad_color)
        return {"base": base, "patches": patches, "ratio": ratio, "rot": rot}

    def preprocess_finish(
        self, pre: Dict[str, Any]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Tuple[int, int], int]:
        """Ship the host-stage views to the device: (base, patches or None,
        crop_ratio, rotation). `patches` and `ratio` may be left out of
        `pre` for a page without crops."""
        def ship(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

        base = ship(pre["base"])
        s, c = self.cfg.base_image_size, self.cfg.crop_image_size
        if tuple(base.shape) != (1, 3, s, s):
            raise ValueError(f"base view must be [1, 3, {s}, {s}], got {tuple(base.shape)}")
        ratio = tuple(pre.get("ratio", (1, 1)))
        patches = pre.get("patches")
        n_tiles = ratio[0] * ratio[1] if ratio != (1, 1) else 0
        if n_tiles == 0 and patches is not None:
            raise ValueError(f"patches were given with the crop grid {ratio}")
        if n_tiles:
            patches = ship(patches)
            if tuple(patches.shape) != (n_tiles, 3, c, c):
                raise ValueError(f"crop grid {ratio} needs patches [{n_tiles}, 3, {c}, {c}], "
                                 f"got {tuple(patches.shape)}")
        return base, patches, ratio, pre.get("rot", 0)

    @torch.no_grad()
    def build_ocr_embeds(
        self, ids: List[int], image_base: torch.Tensor, patches: Optional[torch.Tensor], image_start: int
    ) -> torch.Tensor:
        ids_t = torch.tensor([ids], dtype=torch.long, device=self.device)
        pixels = ocr2.normalize_pixels(image_base, self.act_dtype)
        crops = None if patches is None else ocr2.normalize_pixels(patches, self.act_dtype)
        vision = ocr2.encode_views(self.params, self.cfg, pixels, crops)
        return ocr2.build_inputs_embeds(self.params, ids_t, vision, image_start)

    def generate_ocr(
        self,
        image,
        prompt: Optional[str] = None,
        max_new_tokens: int = 512,
        no_crop: bool = False,
        rotate: Optional[int] = 0,
        auto_rotate: bool = False,
        ngram_size: int = 20,
        eos_token_id: Optional[int] = None,
        keep_logits: bool = False,
        sampling: Optional[dict] = None,
    ) -> GenerationResult:
        """OCR one page. `image` is a path, a PIL image, or the dict that
        `preprocess_host` returns (for callers that letterbox and tile
        themselves; `result.crop_ratio` is the grid that ran).
        `keep_logits` copies every step's logits to the host (debugging).
        `sampling` takes the keys temperature, top_k, top_p and seed of
        `greedy_generate`; None is greedy, by prompt lookup when the
        pipeline's `lookup_chunk` > 1 (stderr gets the JAX package's
        `[lookup-decode: ...]` line; `keep_logits` keeps step 0's only)."""
        cfg = self.cfg
        eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
        prompt = prompt or cfg.default_ocr_prompt

        t0 = time.perf_counter()
        pre = image if isinstance(image, dict) else self.preprocess_host(
            image, no_crop=no_crop, rotate=rotate, auto_rotate=auto_rotate
        )
        image_base, patches, crop_ratio, _ = self.preprocess_finish(pre)
        ids, _, image_start = tokenize_with_image(self.tokenizer, prompt, cfg, crop_ratio)
        embeds = self.build_ocr_embeds(ids, image_base, patches, image_start)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        vision_seconds = time.perf_counter() - t0

        stats: Dict[str, Any] = {}
        gen = dict(max_new_tokens=max_new_tokens, ngram_size=ngram_size, eos_id=eos, kv_dtype=self.kv_dtype,
                   stats=stats, rope=self.rope)
        forwards = None
        if self.lookup_chunk > 1 and not sampling:  # chunk 1 is plain greedy
            tokens, n_gen, forwards = lookup_greedy_generate(
                self.params["lm"], cfg.lm, embeds, torch.tensor(ids), chunk=self.lookup_chunk, return_steps=True,
                capacity=bucket_capacity(len(ids) + max_new_tokens + self.lookup_chunk - 1), **gen)
            n = int(n_gen[0])
            print(f"[lookup-decode: {n} tokens in {forwards} forwards = {n / forwards:.2f} tok/forward]",
                  file=sys.stderr)
        else:
            tokens, n_gen = greedy_generate(
                self.params["lm"], cfg.lm, embeds, torch.tensor(ids),
                capacity=bucket_capacity(len(ids) + max_new_tokens), keep_logits=keep_logits, **gen,
                **(sampling or {}),
            )
        total = len(ids) + int(n_gen[0])
        all_ids = tokens[0, :total].tolist()
        gen_ids = all_ids[len(ids):]
        return GenerationResult(
            text=decode_output(self.tokenizer, gen_ids, cfg.stop_string),
            token_ids=all_ids,
            prompt_len=len(ids),
            prefill_seconds=stats["prefill_s"],
            decode_seconds=stats["decode_s"],
            new_tokens=len(gen_ids),
            vision_seconds=vision_seconds,
            crop_ratio=crop_ratio,
            logits0=stats["logits0"][0],
            step_logits=[lg[0] for lg in stats["logits"]] if keep_logits and forwards is None else None,
            lookup_forwards=forwards,
        )

    def generate_text(
        self,
        prompt: str,
        max_new_tokens: int = 128,
        eos_token_id: Optional[int] = None,
        ngram_size: int = 0,
        sampling: Optional[dict] = None,
    ) -> GenerationResult:
        """Text-only generation on the LM: BOS + the prompt's ids, their
        embeddings in the activation dtype (the JAX package's
        `generate_text`)."""
        cfg = self.cfg
        eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
        ids = tokenize_text(self.tokenizer, prompt, bos_id=cfg.bos_token_id)
        ids_t = torch.tensor(ids, dtype=torch.long, device=self.device)
        embeds = self.params["lm"]["embed"][ids_t][None].to(self.act_dtype)
        stats: Dict[str, Any] = {}
        tokens, n_gen = greedy_generate(
            self.params["lm"], cfg.lm, embeds, ids_t,
            max_new_tokens=max_new_tokens, ngram_size=ngram_size, eos_id=eos,
            capacity=bucket_capacity(len(ids) + max_new_tokens), kv_dtype=self.kv_dtype,
            stats=stats, rope=self.rope, **(sampling or {}),
        )
        all_ids = tokens[0, : len(ids) + int(n_gen[0])].tolist()
        gen_ids = all_ids[len(ids):]
        return GenerationResult(
            text=decode_output(self.tokenizer, gen_ids, cfg.stop_string),
            token_ids=all_ids,
            prompt_len=len(ids),
            prefill_seconds=stats["prefill_s"],
            decode_seconds=stats["decode_s"],
            new_tokens=len(gen_ids),
            logits0=stats["logits0"][0],
        )
