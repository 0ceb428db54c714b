"""Group-batched multi-page OCR engine (port of deepseek_ocr2_tpu.runtime.engine).

Pages are preprocessed (on the host, or on the device where the pipeline's
`device_resize` says so) and grouped by crop grid (pages of a
group share the prompt length and the vision shapes); each group is cut into
chunks of `batch_size` pages, and each chunk runs one batched vision pass
(the crops of all its pages flatten into one SAM batch), one batched LM
prefill and the batched decode, greedy or sampled. With sampling, chunk i
(counted over the crop-grid groups in order) draws with seed + i, so the
chunks' streams differ, as in the JAX package. With the pipeline's
`lookup_chunk` > 1 a greedy chunk decodes by prompt lookup
(`lookup_greedy_generate_batched`). On the card a chunk's decode replays
the captured step of its function (`runtime.decode_graph`), one graph per
batch size and capacity bucket (and, for lookup, token budget); the
buffers and graphs of the last chunk's key are kept until a chunk of
another key needs its own.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..models import deepseek_ocr2 as ocr2
from ..utils.tokenizer import decode_output, tokenize_with_image
from .generate import greedy_generate, lookup_greedy_generate_batched
from .kv_cache import bucket_capacity
from .pipeline import GenerationResult, OCR2Pipeline


@torch.no_grad()
def batched_vision_prefill(
    pipe: OCR2Pipeline,
    ids: List[int],
    bases: torch.Tensor,  # [G, 3, S, S] uint8 (or float) on the device
    patches: Optional[torch.Tensor],  # [G, P, 3, c, c] or None
    image_start: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(input ids [G, S], prompt embeddings [G, S, H]) of a group of pages
    sharing one prompt: normalize on the device, batched vision, injection."""
    g = bases.shape[0]
    ids_t = torch.tensor([ids], dtype=torch.long, device=pipe.device).expand(g, -1).contiguous()
    pixels = ocr2.normalize_pixels(bases, pipe.act_dtype)
    crops = None if patches is None else ocr2.normalize_pixels(patches, pipe.act_dtype)
    return ids_t, ocr2.ocr_prefill_embeds_batched(pipe.params, pipe.cfg, ids_t, pixels, crops, image_start)


class OCR2Engine:
    def __init__(self, pipeline: OCR2Pipeline, batch_size: int = 8):
        self.pipe = pipeline
        self.batch_size = batch_size

    def run(
        self,
        images: Sequence,
        prompt: Optional[str] = None,
        max_new_tokens: int = 512,
        no_crop: bool = False,
        ngram_size: int = 20,
        rotate: int = 0,
        auto_rotate: bool = False,
        sampling: Optional[dict] = None,
    ) -> List[GenerationResult]:
        """OCR every page (a path, a PIL image or a `preprocess_host` dict);
        results come back in the order of `images`. `sampling` takes the
        keys temperature, top_k, top_p and seed of `greedy_generate`."""
        pipe = self.pipe
        prompt = prompt or pipe.cfg.default_ocr_prompt
        groups: Dict[Tuple[int, int], list] = defaultdict(list)
        for idx, image in enumerate(images):
            pre = image if isinstance(image, dict) else pipe.preprocess_host(
                image, no_crop=no_crop, rotate=rotate, auto_rotate=auto_rotate
            )
            base, patches, ratio, _ = pipe.preprocess_finish(pre)
            groups[ratio].append((idx, base, patches))

        results: List[Optional[GenerationResult]] = [None] * len(images)
        chunk_index = 0
        for ratio, items in groups.items():
            ids, _, image_start = tokenize_with_image(pipe.tokenizer, prompt, pipe.cfg, ratio)
            for start in range(0, len(items), self.batch_size):
                chunk_sampling = {**sampling, "seed": sampling.get("seed", 0) + chunk_index} if sampling else {}
                self._run_chunk(items[start : start + self.batch_size], ids, image_start, ratio,
                                max_new_tokens, ngram_size, results, chunk_sampling)
                chunk_index += 1
        return results  # type: ignore[return-value]

    def _run_chunk(self, chunk, ids, image_start, ratio, max_new_tokens, ngram_size, results, sampling) -> None:
        pipe, cfg = self.pipe, self.pipe.cfg
        t0 = time.perf_counter()
        bases = torch.cat([base for _, base, _ in chunk])  # [B, 3, S, S]
        patches = None if chunk[0][2] is None else torch.stack([p for _, _, p in chunk])  # [B, P, 3, c, c]
        ids_t, embeds = batched_vision_prefill(pipe, ids, bases, patches, image_start)
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)
        t1 = time.perf_counter()

        s = len(ids)
        gen = dict(max_new_tokens=max_new_tokens, ngram_size=ngram_size, eos_id=cfg.eos_token_id,
                   kv_dtype=pipe.kv_dtype, rope=pipe.rope)
        lookup = pipe.lookup_chunk
        if lookup > 1 and not sampling:
            tokens, n_gen = lookup_greedy_generate_batched(
                pipe.params["lm"], cfg.lm, embeds, ids_t, capacity=bucket_capacity(s + max_new_tokens + lookup - 1),
                chunk=lookup, **gen)
        else:
            tokens, n_gen = greedy_generate(pipe.params["lm"], cfg.lm, embeds, ids_t,
                                            capacity=bucket_capacity(s + max_new_tokens), **gen, **sampling)
        tokens, n_gen = tokens.cpu(), n_gen.cpu()
        t2 = time.perf_counter()
        # Chunk-level phase walls: the pages of a chunk run together.
        for row, (idx, _, _) in enumerate(chunk):
            all_ids = tokens[row, : s + int(n_gen[row])].tolist()
            gen_ids = all_ids[s:]
            results[idx] = GenerationResult(
                text=decode_output(pipe.tokenizer, gen_ids, cfg.stop_string),
                token_ids=all_ids,
                prompt_len=s,
                prefill_seconds=t1 - t0,
                decode_seconds=t2 - t1,
                new_tokens=len(gen_ids),
                crop_ratio=ratio,
            )
