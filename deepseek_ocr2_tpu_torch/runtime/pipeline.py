"""End-to-end OCR pipeline (port of deepseek_ocr2_tpu.runtime.pipeline).

Host stage (`preprocess_host`): decode, rotate, the crop decision (a side
above `crop_image_size`, unless `no_crop`), the crop grid, and on the host
path the letterbox to the base size and the crop tiles, with PIL imported
only there. Device stage (`preprocess_finish` and `build_ocr_embeds`): ship
the uint8 views (or, on the device-resize path, the raw page, resized,
letterboxed and tiled on the device bit-equal to PIL by
`preprocess.device_resize`), normalize on the device, vision towers,
injection. Then generation, greedy or sampled (`sampling`); with
`lookup_chunk` > 1 a greedy page decodes by prompt lookup
(`lookup_greedy_generate`). `generate_text` runs the LM alone on a text
prompt.

`device_resize`: True (always), False (never), "auto" (exactly when the page
is cropped) or None, which reads `DEEPSEEK_DEVICE_RESIZE` ("auto", "1", "0")
at each page, as the JAX package does. On a CUDA pipeline the device path
runs on the card or raises; it never falls back to PIL.

The JAX package's debug channels print the same lines here, to stderr:
DEEPSEEK_DEBUG_OCR (the rotation, the embedding fingerprints, the prompt
length), DEEPSEEK_DEBUG_VISION (stats of each tower stage),
DEEPSEEK_DEBUG_TOPK (top-10 logits of every greedy step),
DEEPSEEK_DEBUG_TOKENS (each generated id), and through
`models.deepseek_v2.lm_forward_debug` DEEPSEEK_DEBUG_ATTN, _MOE and _LAYER0;
`tools/transcript_from_debug_log.py` reads them into a transcript.

`kv_dtype` "int8" / "int8tail" selects the quantized paged pools, which
only the continuous engine has; `generate_ocr` and the group engine refuse
them through `make_kv_cache`, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..configs import OCR2Config
from ..models import deepseek_ocr2 as ocr2
from ..models.deepseek_v2 import rope_consts
from ..utils.debug import dbg_print, dbg_stats, enabled
from ..utils.tokenizer import decode_output, tokenize_text, tokenize_with_image
from .generate import greedy_generate, lookup_greedy_generate
from .kv_cache import bucket_capacity

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_QUANTIZED_KV = ("int8", "int8tail")  # paged pools only: kept as the string
_PREFILL_DEBUG = ("DEEPSEEK_DEBUG_TOPK", "DEEPSEEK_DEBUG_ATTN", "DEEPSEEK_DEBUG_MOE", "DEEPSEEK_DEBUG_LAYER0")


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
        device_resize: Union[bool, str, None] = None,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' was asked for but no CUDA device is available")
        if isinstance(params.get("lm"), dict) and "mesh" in params["lm"]:
            raise ValueError("the OCR pipeline and the serving engines take unsharded params")
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.kv_dtype = kv_dtype if kv_dtype in _QUANTIZED_KV else _DTYPES[kv_dtype]
        self.act_dtype = _DTYPES[act_dtype]
        # > 1: prompt-lookup greedy decoding with this chunk width (greedy
        # pages of generate_ocr and the engines; 1 is plain greedy).
        self.lookup_chunk = lookup_chunk
        self.device_resize = device_resize
        self.rope = rope_consts(cfg.lm, self.device)  # host-built once, not per page

    def _use_device_resize(self, cropping: bool) -> bool:
        device = self.device_resize
        if device is None:
            env = os.environ.get("DEEPSEEK_DEVICE_RESIZE", "")
            device = "auto" if env == "auto" else env not in ("", "0")
        if device == "auto":
            device = cropping  # the JAX package measured the device path ahead only on crop pages
        return bool(device)

    def preprocess_host(
        self, image, no_crop: bool = False, rotate: Optional[int] = 0, auto_rotate: bool = False
    ) -> Dict[str, Any]:
        """Decode + rotate + crop decision, and on the host path the
        letterbox and tiles. `image` is a path or a PIL image. Returns
        - host path: {"mode": "host", "base": u8 [1, 3, S, S], "patches":
          u8 [P, 3, c, c] or None, "ratio": the (w, h) crop grid, (1, 1)
          without crops, "rot": degrees};
        - device path: {"mode": "device", "arr": the rotated page as HWC
          uint8, "ratio", "cropping", "rot"}: `preprocess_finish` ships it
          and resizes it on the device."""
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
        dbg_print("DEEPSEEK_DEBUG_OCR", f"rotate_used={rot}")
        img = rotate_image(img, rot)
        patches, ratio = None, (1, 1)
        cropping = should_crop(img, not no_crop, cfg.crop_image_size)
        if cropping:
            w, h = img.size
            ratios = candidate_ratios(cfg.min_crop_tiles, cfg.max_crop_tiles)
            ratio = find_closest_aspect_ratio(w / h, ratios, w, h, cfg.crop_image_size)
        if self._use_device_resize(cropping):
            return {"mode": "device", "arr": np.asarray(img), "ratio": ratio, "cropping": cropping, "rot": rot}
        if cropping:
            patches = preprocess_tiles_u8(img, cfg.crop_image_size, ratio)
        base = preprocess_base_u8(img, cfg.base_image_size, cfg.pad_color)
        return {"mode": "host", "base": base, "patches": patches, "ratio": ratio, "rot": rot}

    def preprocess_finish(
        self, pre: Dict[str, Any]
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Tuple[int, int], int]:
        """The device stage of preprocessing: (base, patches or None,
        crop_ratio, rotation) on the device. A host-path dict ships its
        views (`patches` and `ratio` may be left out for a page without
        crops); a device-path dict ships the raw page and resizes it there."""
        s, c = self.cfg.base_image_size, self.cfg.crop_image_size
        if pre.get("mode") == "device":
            from ..preprocess.device_resize import device_preprocess_page

            base, patches = device_preprocess_page(
                pre["arr"], s, c, pre["ratio"] if pre["cropping"] else None, self.cfg.pad_color, device=self.device
            )
            return base, patches, tuple(pre["ratio"]), pre["rot"]

        def ship(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

        base = ship(pre["base"])
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

    def preprocess_image(
        self, image, no_crop: bool = False, rotate: Optional[int] = 0, auto_rotate: bool = False
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor], Tuple[int, int], int]:
        """(image_base [1, 3, S, S], patches [P, 3, c, c] or None, crop_ratio,
        rotate_used), uint8 on the device: both stages of preprocessing."""
        return self.preprocess_finish(
            self.preprocess_host(image, no_crop=no_crop, rotate=rotate, auto_rotate=auto_rotate)
        )

    @torch.no_grad()
    def build_ocr_embeds(
        self, ids: List[int], image_base: torch.Tensor, patches: Optional[torch.Tensor], image_start: int
    ) -> torch.Tensor:
        ids_t = torch.tensor([ids], dtype=torch.long, device=self.device)
        if enabled("DEEPSEEK_DEBUG_VISION"):
            return self._debug_vision_embeds(ids_t, image_base, patches, image_start)
        pixels = ocr2.normalize_pixels(image_base, self.act_dtype)
        crops = None if patches is None else ocr2.normalize_pixels(patches, self.act_dtype)
        vision = ocr2.encode_views(self.params, self.cfg, pixels, crops)
        return ocr2.build_inputs_embeds(self.params, ids_t, vision, image_start)

    def _debug_vision_embeds(self, ids_t, image_base, patches, image_start) -> torch.Tensor:
        """DEEPSEEK_DEBUG_VISION: the towers stage by stage with stat dumps,
        pixels normalized in f32 and the embeddings cast to the activation
        dtype, as the JAX package's eager path."""
        from ..models import qwen2 as qwen2_mod
        from ..models import sam as sam_mod

        cfg, params = self.cfg, self.params
        h = cfg.lm.hidden_size

        def tower(imgs, tag):
            feats = sam_mod.sam_forward(params["sam"], cfg.sam, ocr2.normalize_pixels(imgs, torch.float32))
            dbg_stats("DEEPSEEK_DEBUG_VISION", f"vision.{tag}.sam", feats)
            feats = qwen2_mod.qwen2_encode(params["qwen2"], cfg.qwen2, feats)
            dbg_stats("DEEPSEEK_DEBUG_VISION", f"vision.{tag}.qwen2", feats)
            dt = feats.dtype
            out = torch.nn.functional.linear(feats, params["projector_w"].to(dt)) + params["projector_b"].to(dt)
            dbg_stats("DEEPSEEK_DEBUG_VISION", f"vision.{tag}.proj", out)
            return out

        g = tower(image_base, "global").reshape(-1, h)
        sep = params["view_seperator"].reshape(1, h).to(g.dtype)
        views = [g, sep] if patches is None else [tower(patches, "local").reshape(-1, h), g, sep]
        vision = torch.cat(views, dim=0)
        dbg_stats("DEEPSEEK_DEBUG_VISION", "vision.tokens", vision)
        embeds = ocr2.build_inputs_embeds(params, ids_t, vision, image_start)
        dbg_stats("DEEPSEEK_DEBUG_VISION", "mm.merged", embeds)
        return embeds.to(self.act_dtype)

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
        if enabled("DEEPSEEK_DEBUG_OCR"):
            self._debug_embeds_fingerprints(embeds)
        vision_seconds = time.perf_counter() - t0
        result = self._generate(embeds, ids, max_new_tokens, ngram_size, eos, sampling, keep_logits)
        result.vision_seconds = vision_seconds
        result.crop_ratio = crop_ratio
        return result

    # -- debug channels (the JAX package's lines) ------------------------------

    def _debug_embeds_fingerprints(self, embeds) -> None:
        """DEEPSEEK_DEBUG_OCR embedding fingerprints: global stats, the first
        16 values, and 16-value slices at positions 0/1/last/289/545 (289 =
        after the 288 local tokens of a 2-tile crop; 545 = after local +
        global)."""
        data = embeds.float().cpu().numpy() if torch.is_tensor(embeds) else np.asarray(embeds, np.float32)
        flat = data.reshape(-1)
        nan = int(np.isnan(flat).sum())
        finite = flat[~np.isnan(flat)]
        mn = float(finite.min()) if finite.size else float("nan")
        mx = float(finite.max()) if finite.size else float("nan")
        mean = float(finite.mean()) if finite.size else float("nan")
        dbg_print("DEEPSEEK_DEBUG_OCR", f"inputs_embeds nan={nan} min={mn} max={mx} mean={mean}")
        dbg_print("DEEPSEEK_DEBUG_OCR", f"inputs_embeds fingerprint={flat[:16].tolist()}")
        s = data.shape[1]

        def fp(pos):
            return data[0, pos, :16].tolist()

        if s >= 2:
            dbg_print("DEEPSEEK_DEBUG_OCR", f"inputs_embeds[pos0]={fp(0)}")
            dbg_print("DEEPSEEK_DEBUG_OCR", f"inputs_embeds[pos1]={fp(1)}")
            dbg_print("DEEPSEEK_DEBUG_OCR", f"inputs_embeds[pos_last]={fp(s - 1)}")
            if s > 289:
                dbg_print("DEEPSEEK_DEBUG_OCR", f"inputs_embeds[pos289]={fp(289)}")
            if s > 545:
                dbg_print("DEEPSEEK_DEBUG_OCR", f"inputs_embeds[pos545]={fp(545)}")

    def _dump_top10(self, logits_row: np.ndarray, label: str) -> None:
        order = np.argsort(-np.nan_to_num(logits_row, nan=-np.inf))[:10]
        toks = [self.tokenizer.decode([int(i)], skip_special_tokens=False) for i in order]
        dbg_print("DEEPSEEK_DEBUG_TOPK", f"{label} top10 ids={order.tolist()}")
        dbg_print("DEEPSEEK_DEBUG_TOPK", f"{label} top10 tok={toks}")
        dbg_print("DEEPSEEK_DEBUG_TOPK", f"{label} top10 logit={[round(float(logits_row[i]), 4) for i in order]}")

    @torch.no_grad()
    def _debug_prefill_dumps(self, embeds) -> None:
        """Step-0 top-10 logits (DEEPSEEK_DEBUG_TOPK) and the eager per-layer
        dumps (ATTN / MOE / LAYER0) of one extra prefill."""
        from ..models.deepseek_v2 import lm_forward_debug, logits_last

        lm = self.params["lm"]
        hidden = lm_forward_debug(lm, self.cfg.lm, embeds, rope=self.rope)
        if enabled("DEEPSEEK_DEBUG_TOPK"):
            self._dump_top10(logits_last(lm, hidden)[0].float().cpu().numpy(), "step0")

    # -- shared decode ---------------------------------------------------------

    def _generate(
        self, embeds, ids, max_new_tokens, ngram_size, eos, sampling=None, keep_logits: bool = False
    ) -> GenerationResult:
        """The LM part of a page: prefill of `embeds` [1, S, H] and decode.
        Under DEEPSEEK_DEBUG_TOPK a greedy page decodes plainly (no lookup)
        and dumps every step's top-10, token for token the same ids."""
        cfg = self.cfg
        if any(enabled(c) for c in _PREFILL_DEBUG):
            self._debug_prefill_dumps(embeds)
        debug_topk = enabled("DEEPSEEK_DEBUG_TOPK") and not sampling
        capacity = bucket_capacity(len(ids) + max_new_tokens)
        stats: Dict[str, Any] = {}
        gen = dict(max_new_tokens=max_new_tokens, ngram_size=ngram_size, eos_id=eos, kv_dtype=self.kv_dtype,
                   stats=stats, rope=self.rope)
        forwards = None
        if self.lookup_chunk > 1 and not sampling and not debug_topk:  # chunk 1 is plain greedy
            tokens, n_gen, forwards = lookup_greedy_generate(
                self.params["lm"], cfg.lm, embeds, torch.tensor(ids), chunk=self.lookup_chunk, return_steps=True,
                capacity=bucket_capacity(len(ids) + max_new_tokens + self.lookup_chunk - 1), **gen)
            n = int(n_gen[0])
            print(f"[lookup-decode: {n} tokens in {forwards} forwards = {n / forwards:.2f} tok/forward]",
                  file=sys.stderr)
        else:
            tokens, n_gen = greedy_generate(
                self.params["lm"], cfg.lm, embeds, torch.tensor(ids), capacity=capacity,
                keep_logits=keep_logits or debug_topk, **gen, **(sampling or {}),
            )
        total = len(ids) + int(n_gen[0])
        all_ids = tokens[0, :total].tolist()
        gen_ids = all_ids[len(ids):]
        if debug_topk:
            for step, tid in enumerate(gen_ids):
                self._dump_top10(stats["logits"][step][0].numpy(), f"step{step}")
                self._debug_token(step, tid)
        else:
            for step, tid in enumerate(gen_ids):
                self._debug_token(step, tid)
            dbg_print("DEEPSEEK_DEBUG_OCR", f"prompt_len={len(ids)} new_tokens={len(gen_ids)} capacity={capacity}")
        return GenerationResult(
            text=decode_output(self.tokenizer, gen_ids, cfg.stop_string),
            token_ids=all_ids,
            prompt_len=len(ids),
            prefill_seconds=stats["prefill_s"],
            decode_seconds=stats["decode_s"],
            new_tokens=len(gen_ids),
            logits0=stats["logits0"][0],
            step_logits=[lg[0] for lg in stats["logits"]] if keep_logits and forwards is None else None,
            lookup_forwards=forwards,
        )

    def _debug_token(self, step: int, tid: int) -> None:
        if enabled("DEEPSEEK_DEBUG_TOKENS"):
            piece = self.tokenizer.decode([int(tid)], skip_special_tokens=False)
            dbg_print("DEEPSEEK_DEBUG_TOKENS", f"step{step} next_id={tid} tok={piece!r}")

    def generate_text(
        self,
        prompt: str,
        max_new_tokens: int = 128,
        eos_token_id: Optional[int] = None,
        ngram_size: int = 0,
        sampling: Optional[dict] = None,
    ) -> GenerationResult:
        """Text-only generation on the LM: BOS + the prompt's ids, their
        embeddings in the activation dtype, then `_generate` (the JAX
        package's `generate_text`)."""
        cfg = self.cfg
        eos = cfg.eos_token_id if eos_token_id is None else eos_token_id
        ids = tokenize_text(self.tokenizer, prompt, bos_id=cfg.bos_token_id)
        ids_t = torch.tensor(ids, dtype=torch.long, device=self.device)
        embeds = self.params["lm"]["embed"][ids_t][None].to(self.act_dtype)
        return self._generate(embeds, ids, max_new_tokens, ngram_size, eos, sampling)
