"""Greedy or sampled generation (port of deepseek_ocr2_tpu.runtime.generate).

Prefill, then an eager decode loop of one forward per token: on-device
n-gram ban and argmax, EOS handling as in the JAX loop (the EOS id is kept
in the output; finished rows freeze). With temperature > 0 each step draws
from JAX's threefry stream as the JAX loop does: the key is PRNGKey(seed),
split once before the first pick and once a step, and the step's subkey
split into one key a row. The host reads the done flags once a step to
leave the loop early. Capturing the step in a CUDA graph is later work.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import DeepseekV2Config

from ..models.deepseek_v2 import lm_forward, logits_last, rope_consts, vocab_size_of
from ..ops import prng
from ..ops.sampling import ngram_ban_mask_batched, sample_pick
from .kv_cache import make_kv_cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def greedy_generate(
    params,
    cfg: DeepseekV2Config,
    inputs_embeds: torch.Tensor,  # [B, S, H]
    prompt_ids: torch.Tensor,  # [B, S] or [S]
    *,
    max_new_tokens: int,
    ngram_size: int = 0,
    eos_id: int = 1,
    capacity: int = 2048,
    kv_dtype: torch.dtype = torch.bfloat16,
    stats: Optional[Dict[str, object]] = None,
    keep_logits: bool = False,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    seed: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens [B, S + max_new] int64, n_generated [B]).
    Greedy at temperature 0; otherwise `sample_pick` with top_k / top_p.

    `tokens[b, :S + n_generated[b]]` is the prompt plus the generated ids.
    If `stats` is a dict it receives `prefill_s`, `decode_s` (host clock,
    each ending in a device sync) and `logits0`, the step-0 logits [B, V]
    as f32 on the CPU; with `keep_logits` also `logits`, every step's.
    `rope` takes the (cos, sin) tables of `rope_consts` when the caller
    keeps them across calls (they are built on the host).
    """
    device = inputs_embeds.device
    b, s, _ = inputs_embeds.shape
    if s + max_new_tokens > capacity:
        raise ValueError(f"capacity {capacity} < prompt {s} + max_new_tokens {max_new_tokens}")
    if prompt_ids.ndim == 1:
        prompt_ids = prompt_ids[None]
    vocab = vocab_size_of(params)  # lm_head may be int8 or int4
    t_buf = s + max_new_tokens
    rope = rope if rope is not None else rope_consts(cfg, device)
    cache = make_kv_cache(
        cfg.num_hidden_layers, b, cfg.num_attention_heads, capacity, cfg.head_dim,
        dtype=kv_dtype, device=device,
    )

    t0 = time.perf_counter()
    hidden = lm_forward(params, cfg, inputs_embeds, cache, pos=0, is_prefill=True, rope=rope)
    logits = logits_last(params, hidden)

    tokens = torch.zeros(b, t_buf, dtype=torch.long, device=device)
    tokens[:, :s] = prompt_ids.to(device)

    key = prng.prng_key(seed, device)

    def pick(logits, cur_len):
        nonlocal key
        lens = torch.full((b,), cur_len, dtype=torch.long, device=device)
        ban = ngram_ban_mask_batched(tokens, lens, ngram_size, vocab)
        keys = None
        if temperature != 0.0:
            key, sub = prng.split(key)
            keys = prng.split(sub, b)
        return sample_pick(logits, keys, ban, temperature=temperature, top_k=top_k, top_p=top_p)

    tok = pick(logits, s)
    if stats is not None:
        stats["logits0"] = logits.float().cpu()
        stats["logits"] = [stats["logits0"]]
        _sync(device)
        stats["prefill_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    done = tok == eos_id
    tokens[:, s] = tok
    n_gen = torch.ones(b, dtype=torch.long, device=device)
    cur_len = s + 1
    for _ in range(1, max_new_tokens):
        if bool(done.all()):
            break
        emb = F.embedding(tok[:, None], params["embed"]).to(inputs_embeds.dtype)
        hidden = lm_forward(params, cfg, emb, cache, pos=cur_len - 1, is_prefill=False, rope=rope)
        logits = logits_last(params, hidden)
        if keep_logits and stats is not None:
            stats["logits"].append(logits.float().cpu())
        nxt = pick(logits, cur_len)
        nxt = torch.where(done, tok, nxt)
        tokens[:, cur_len] = torch.where(done, tokens[:, cur_len], nxt)
        n_gen = torch.where(done, n_gen, n_gen + 1)
        done = done | (nxt == eos_id)
        tok = nxt
        cur_len += 1
    if stats is not None:
        _sync(device)
        stats["decode_s"] = time.perf_counter() - t1
    return tokens, n_gen
