"""Greedy or sampled generation (port of deepseek_ocr2_tpu.runtime.generate).

Prefill, then an eager decode loop of one forward per token: on-device
n-gram ban and argmax, EOS handling as in the JAX loop (the EOS id is kept
in the output; finished rows freeze). With temperature > 0 each step draws
from JAX's threefry stream as the JAX loop does: the key is PRNGKey(seed),
split once before the first pick and once a step, and the step's subkey
split into one key a row. The host reads the done flags once a step to
leave the loop early. Capturing the step in a CUDA graph is later work.

Prompt-lookup decoding (`lookup_greedy_generate`, `_batched`): each forward
takes a chunk of tokens a row, the last one and `chunk - 1` drafts copied
from after the latest earlier occurrence of the row's longest matching
suffix (`_lookup_draft`), and keeps the longest run of drafts that the
model's own greedy picks (ban included) confirm, plus the first pick that
differs: 1..chunk tokens a forward, the tokens of plain greedy decoding up
to chunk-width rounding. Greedy only; eager and on the device, one flag
read back a forward.

On params sharded onto a mesh (`parallel.shard_params`), `greedy_generate`
takes the whole batch on every rank, decodes the rank's dp rows with the
rank's heads (its cache holds their K/V) and experts, and gathers the
tokens over dp: every rank returns the same tokens.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import DeepseekV2Config

from ..models.deepseek_v2 import lm_forward, logits_all, logits_last, n_heads, rope_consts, vocab_size_of
from ..ops import prng
from ..ops.sampling import greedy_pick, ngram_ban_mask_batched, sample_pick
from ..parallel.collectives import all_gather_dp
from ..parallel.mesh import dp_rows
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
    keeps them across calls (they are built on the host). Sharded params:
    see the module docstring (`stats` then hold the rank's rows).
    """
    device = inputs_embeds.device
    mesh = params.get("mesh")
    b_all, s, _ = inputs_embeds.shape
    if s + max_new_tokens > capacity:
        raise ValueError(f"capacity {capacity} < prompt {s} + max_new_tokens {max_new_tokens}")
    if prompt_ids.ndim == 1:
        prompt_ids = prompt_ids[None]
    inputs_embeds = dp_rows(inputs_embeds, mesh)
    if prompt_ids.shape[0] == b_all > 1:
        prompt_ids = dp_rows(prompt_ids, mesh)
    b = inputs_embeds.shape[0]
    vocab = vocab_size_of(params)  # lm_head may be int8 or int4
    t_buf = s + max_new_tokens
    rope = rope if rope is not None else rope_consts(cfg, device)
    cache = make_kv_cache(
        cfg.num_hidden_layers, b, n_heads(params["layers"][0], cfg), capacity, cfg.head_dim,
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
            keys = dp_rows(prng.split(sub, b_all), mesh)
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
    return all_gather_dp(tokens, mesh), all_gather_dp(n_gen, mesh)


def _lookup_draft_n(hist: torch.Tensor, cur_len: torch.Tensor, n: int, draft_k: int):
    """For each row of hist [B, T] (valid up to cur_len [B]): the latest
    earlier occurrence of its last n tokens, wholly before that suffix;
    returns (found [B] bool, the draft_k tokens that followed it [B,
    draft_k]). Slices are clamped into the buffer as JAX's dynamic_slice
    clamps them."""
    b, t_buf = hist.shape
    cur = cur_len.long()
    start = (cur - n).clamp(0, t_buf - n)
    last = hist.gather(1, start[:, None] + torch.arange(n, device=hist.device))  # [B, n]
    n_win = t_buf - n
    eq = torch.ones(b, n_win, dtype=torch.bool, device=hist.device)
    for j in range(n):
        eq &= hist[:, j : j + n_win] == last[:, j : j + 1]
    idx = torch.arange(n_win, device=hist.device)
    score = torch.where(eq & (idx < (cur - n)[:, None]), idx, -1)
    j_star = score.amax(dim=1)
    at = (j_star.clamp(min=0) + n).clamp(max=t_buf - draft_k)
    return j_star >= 0, hist.gather(1, at[:, None] + torch.arange(draft_k, device=hist.device))


def _lookup_draft(hist: torch.Tensor, cur_len: torch.Tensor, match_n: int, draft_k: int) -> torch.Tensor:
    """The drafts [B, draft_k] of prompt lookup, longest suffix first: n =
    match_n down to 1, the longest n with an earlier occurrence wins. A row
    with no match at any n drafts whatever follows its 1-gram search (the
    verification makes that one token a forward, never a wrong one)."""
    _, draft = _lookup_draft_n(hist, cur_len, 1, draft_k)
    for n in range(2, match_n + 1):  # longer matches override
        found, draft_n = _lookup_draft_n(hist, cur_len, n, draft_k)
        draft = torch.where(found[:, None], draft_n, draft)
    return draft


@torch.no_grad()
def lookup_greedy_generate_batched(
    params,
    cfg: DeepseekV2Config,
    inputs_embeds: torch.Tensor,  # [B, S, H]: the rows share the prompt length
    prompt_ids: torch.Tensor,  # [B, S] or [S]
    *,
    max_new_tokens: int,
    ngram_size: int = 0,
    eos_id: int = 1,
    capacity: int = 2048,
    kv_dtype: torch.dtype = torch.bfloat16,
    chunk: int = 4,
    match_n: int = 3,
    return_steps: bool = False,
    stats: Optional[Dict[str, object]] = None,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """Prompt-lookup greedy decoding of B rows (the JAX package's function
    of this name): the rows accept independently, so each keeps its own
    length and the chunk forward runs at per-row positions. Returns (tokens
    [B, S + max_new] int64, n_generated [B]) as `greedy_generate` does, and
    with return_steps the forwards run (the prefill counts as one) as a
    third element. `stats` and `rope` as in `greedy_generate` (no
    per-step logits)."""
    device = inputs_embeds.device
    b, s, _ = inputs_embeds.shape
    if s + max_new_tokens + chunk - 1 > capacity:
        raise ValueError(f"capacity {capacity} < prompt {s} + max_new_tokens {max_new_tokens} + chunk {chunk} - 1")
    if chunk < 2 or match_n < 1:
        raise ValueError(f"lookup decoding takes chunk >= 2 and match_n >= 1, got {chunk}, {match_n}")
    if params.get("mesh") is not None:
        raise ValueError("lookup decoding takes unsharded params")
    if prompt_ids.ndim == 1:
        prompt_ids = prompt_ids[None]
    vocab = vocab_size_of(params)
    t_buf = s + max_new_tokens
    rope = rope if rope is not None else rope_consts(cfg, device)
    cache = make_kv_cache(cfg.num_hidden_layers, b, n_heads(params["layers"][0], cfg), capacity, cfg.head_dim,
                          dtype=kv_dtype, device=device)
    rows = torch.arange(b, device=device)

    t0 = time.perf_counter()
    hidden = lm_forward(params, cfg, inputs_embeds, cache, pos=0, is_prefill=True, rope=rope)
    logits = logits_last(params, hidden)
    tokens = torch.zeros(b, t_buf, dtype=torch.long, device=device)
    tokens[:, :s] = prompt_ids.to(device)
    cur_len = torch.full((b,), s, dtype=torch.long, device=device)
    tok = greedy_pick(logits, ngram_ban_mask_batched(tokens, cur_len, ngram_size, vocab))
    if stats is not None:
        stats["logits0"] = logits.float().cpu()
        _sync(device)
        stats["prefill_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    done = tok == eos_id
    tokens[:, s] = tok
    cur_len += 1
    n_gen = torch.ones(b, dtype=torch.long, device=device)
    steps = 1
    while bool((~done & (n_gen < max_new_tokens)).any()):  # the one readback a forward
        draft = _lookup_draft(tokens, cur_len, match_n, chunk - 1)  # [B, chunk - 1]
        emb = F.embedding(torch.cat([tok[:, None], draft], dim=1), params["embed"]).to(inputs_embeds.dtype)
        hidden = lm_forward(params, cfg, emb, cache, pos=cur_len - 1, is_prefill=False, rope=rope)
        logits = logits_all(params, hidden)  # [B, chunk, V]
        accepting = ~done
        add = torch.zeros_like(n_gen)
        for i in range(chunk):
            t_i = greedy_pick(logits[:, i], ngram_ban_mask_batched(tokens, cur_len + i, ngram_size, vocab))
            emit = accepting & (n_gen + add < max_new_tokens)
            wpos = (cur_len + i).clamp(max=t_buf - 1)  # in the buffer wherever emit (the budget)
            tokens[rows, wpos] = torch.where(emit, t_i, tokens[rows, wpos])
            tok = torch.where(emit, t_i, tok)
            add += emit.long()
            hit_eos = emit & (t_i == eos_id)
            done = done | hit_eos
            if i < chunk - 1:
                accepting = emit & ~hit_eos & (t_i == draft[:, i])
        cur_len += add
        n_gen += add
        steps += 1
    if stats is not None:
        _sync(device)
        stats["decode_s"] = time.perf_counter() - t1
    return (tokens, n_gen, steps) if return_steps else (tokens, n_gen)


def lookup_greedy_generate(params, cfg: DeepseekV2Config, inputs_embeds: torch.Tensor, prompt_ids: torch.Tensor,
                           **kw):
    """Prompt-lookup greedy decoding of one sequence (the JAX package's
    function of this name): `lookup_greedy_generate_batched` at B = 1, with
    the same keywords and returns."""
    if inputs_embeds.shape[0] != 1:
        raise ValueError("lookup_greedy_generate decodes one sequence; use lookup_greedy_generate_batched")
    return lookup_greedy_generate_batched(params, cfg, inputs_embeds, prompt_ids, **kw)
