"""Greedy or sampled generation (port of deepseek_ocr2_tpu.runtime.generate).

Prefill, then a decode loop of one forward per token: on-device n-gram ban
and argmax, EOS handling as in the JAX loop (the EOS id is kept in the
output; finished rows freeze). With temperature > 0 each step draws from
JAX's threefry stream as the JAX loop does: the key is PRNGKey(seed), split
once before the first pick and once a step, and the step's subkey split
into one key a row.

The JAX package runs the loop as one device program (`lax.while_loop`).
Here the decode state lives in static device tensors (token buffer, each
row's last token, length, count and done flag, the PRNG key, split in
place, and the contiguous cache), and the loop is one step callable that
`runtime.decode_graph` runs: on the card, with params on no mesh, it is
captured once a key into a CUDA graph and replayed, and the host reads the
done flags back every `decode_graph.SYNC_EVERY` steps (1: after every
replay), never running more than max_new_tokens - 1 steps (a row that
finished while others decode is stepped frozen, which changes nothing). The cache and the state are the
runner's static buffers for the batch and capacity (the token buffer is
as wide as the cache, and the loop's own length a device scalar), so every
prompt length of a capacity bucket shares them and the prefill writes into
them: a graph is captured once a key, not once a call, and the runner
keeps the last decode's buffers only until another key needs its own. On
CPU tensors the same step is called, through the same loop (the tests'
path). Params sharded onto a mesh
stay eager: their collectives run through `torch.distributed` process
groups, which a CUDA graph cannot capture.

Prompt-lookup decoding (`lookup_greedy_generate`, `_batched`): each forward
takes a chunk of tokens a row, the last one and `chunk - 1` drafts copied
from after the latest earlier occurrence of the row's longest matching
suffix (`_lookup_draft`), and keeps the longest run of drafts that the
model's own greedy picks (ban included) confirm, plus the first pick that
differs: 1..chunk tokens a forward, the tokens of plain greedy decoding up
to chunk-width rounding. Greedy only; the forward is the step `decode_graph`
runs, and a device counter of the forwards with a live row gives the JAX
package's step count.

On params sharded onto a mesh (`parallel.shard_params`, plain, int8 or
int4), `greedy_generate` and `lookup_greedy_generate_batched` take the
whole batch on every rank, decode the rank's dp rows with the rank's heads
(its cache holds their K/V) and experts, and gather the tokens over dp:
every rank returns the same tokens. The mp ranks of a dp row hold the same
rows and the same logits, so they leave their loops together; the dp rows
meet only in the final gather.
"""

from __future__ import annotations

import contextlib
import functools
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
from . import decode_graph
from .kv_cache import make_kv_cache


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _state_buffers(b: int, width: int, device) -> dict:
    """The decode state of `greedy_generate` and the lookup loops: the token
    buffer (`width` wide, the cache's capacity; the loop's own length
    `t_len` = prompt + max_new_tokens, a 0-d tensor, bounds what it reads),
    each row's last token, done flag, generated count and length (`cur`),
    the row indices, the PRNG key (int64 [2], split in place) and a counter
    of forwards (the lookup loops')."""
    z = functools.partial(torch.zeros, device=device)
    return {"tokens": z(b, width, dtype=torch.long), "tok": z(b, dtype=torch.long), "done": z(b, dtype=torch.bool),
            "n_gen": z(b, dtype=torch.long), "cur": z(b, dtype=torch.long), "rows": torch.arange(b, device=device),
            "key": z(2, dtype=torch.long), "forwards": z((), dtype=torch.long), "t_len": z((), dtype=torch.long),
            "rope": None}


@contextlib.contextmanager
def _decode_buffers(params, cfg: DeepseekV2Config, b: int, capacity: int, kv_dtype, device, rope, graph: bool):
    """(cache, state, rope): the contiguous cache and the decode state a
    loop runs on, both sized by the capacity (so prompts of every length in
    a capacity bucket share them), and the RoPE tables (`rope`, or the
    state's own, made once: a captured step keeps the address it read). A
    decode that replays graphs (`graph`) takes the runner's static buffers
    for the shape, ready as fresh ones are (a zeroed cache and token
    buffer); otherwise fresh buffers."""
    mesh = params.get("mesh")

    def make():
        return (make_kv_cache(cfg.num_hidden_layers, b, n_heads(cfg, mesh), capacity, cfg.head_dim, dtype=kv_dtype,
                              device=device), _state_buffers(b, capacity, device))

    with decode_graph.RUNNER.buffers(("decode", b, capacity, kv_dtype, device), params, make, graph) as (cache, st):
        if graph:
            for t in (*cache.values(), st["tokens"]):
                t.zero_()
        if rope is None and st["rope"] is None:
            st["rope"] = rope_consts(cfg, device)
        yield cache, st, rope if rope is not None else st["rope"]


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
    as f32 on the CPU; with `keep_logits` also `logits`, every step's (one
    copy to the host a step). `rope` takes the (cos, sin) tables of
    `rope_consts` when the caller keeps them across calls (they are built
    on the host). Sharded params: see the module docstring (`stats` then
    hold the rank's rows).
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
    act = inputs_embeds.dtype
    graph = decode_graph.graphed(device, params)
    with _decode_buffers(params, cfg, b, capacity, kv_dtype, device, rope, graph) as (cache, st, rope):
        tokens, tok, done, n_gen, cur, rows, key = (st[k] for k in ("tokens", "tok", "done", "n_gen", "cur", "rows",
                                                                     "key"))

        def pick(logits):
            """The next token of every row at length `cur`; a sampled pick
            splits the key in place first."""
            ban = ngram_ban_mask_batched(tokens, cur, ngram_size, vocab)
            keys = None
            if temperature != 0.0:
                nxt_key, sub = prng.split(key)
                key.copy_(nxt_key)
                keys = dp_rows(prng.split(sub, b_all), mesh)
            return sample_pick(logits, keys, ban, temperature=temperature, top_k=top_k, top_p=top_p)

        def step():
            """One token a row at the shared position cur - 1; finished rows
            freeze (their token, count and buffer). Returns the logits."""
            emb = F.embedding(tok[:, None], params["embed"]).to(act)
            hidden = lm_forward(params, cfg, emb, cache, pos=cur - 1, is_prefill=False, rope=rope)
            logits = logits_last(params, hidden)
            nxt = torch.where(done, tok, pick(logits))
            tokens[rows, cur] = torch.where(done, tokens[rows, cur], nxt)
            n_gen.copy_(torch.where(done, n_gen, n_gen + 1))
            done.logical_or_(nxt == eos_id)
            tok.copy_(nxt)
            cur.add_(1)
            return logits

        t0 = time.perf_counter()
        hidden = lm_forward(params, cfg, inputs_embeds, cache, pos=0, is_prefill=True, rope=rope)
        logits = logits_last(params, hidden)
        tokens[:, :s] = prompt_ids.to(device)
        key.copy_(prng.prng_key(seed, device))
        cur.fill_(s)
        tok.copy_(pick(logits))
        if stats is not None:
            stats["logits0"] = logits.float().cpu()
            stats["logits"] = [stats["logits0"]]
            _sync(device)
            stats["prefill_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        done.copy_(tok == eos_id)
        tokens[:, s] = tok
        n_gen.fill_(1)
        cur.fill_(s + 1)
        label = f"greedy_generate B={b} cap={capacity} {str(kv_dtype).replace('torch.', '')}"
        run = decode_graph.RUNNER.steps(("greedy", vocab, act, ngram_size, eos_id, temperature, top_k, top_p), label,
                                        params, (cache, st, rope), step, device, graph)
        kept = []

        def run_n(n: int) -> None:
            if not (keep_logits and stats is not None):
                run(n)
                return
            for _ in range(n):
                kept.append(run(1).float().cpu())

        decode_graph.decode_loop(run_n, max_new_tokens - 1, lambda: not bool(done.all()))
        if kept:  # the steps an eager loop runs: until the last row finished
            stats["logits"] += kept[: int(n_gen.max()) - 1]
        out = tokens[:, :t_buf].clone(), n_gen.clone()  # the buffers are the next call's
    if stats is not None:
        _sync(device)
        stats["decode_s"] = time.perf_counter() - t1
    return all_gather_dp(out[0], mesh), all_gather_dp(out[1], mesh)


def _at_most(x: torch.Tensor, limit) -> torch.Tensor:
    """x clamped from above by an int or a 0-d tensor; one clamp with an
    int bound and a tensor bound would copy the int to the device, which a
    capture refuses."""
    return torch.minimum(x, limit) if torch.is_tensor(limit) else x.clamp(max=limit)


def _lookup_draft_n(hist: torch.Tensor, cur_len: torch.Tensor, n: int, draft_k: int, t_len=None):
    """For each row of hist [B, W] (valid up to cur_len [B]): the latest
    earlier occurrence of its last n tokens, wholly before that suffix;
    returns (found [B] bool, the draft_k tokens that followed it [B,
    draft_k]). Slices are clamped into the buffer's first `t_len` tokens
    (an int or a 0-d tensor; W by default), as JAX's dynamic_slice clamps
    them in a buffer of that length."""
    b, width = hist.shape
    t_len = width if t_len is None else t_len
    cur = cur_len.long()
    start = _at_most((cur - n).clamp(min=0), t_len - n)
    last = hist.gather(1, start[:, None] + torch.arange(n, device=hist.device))  # [B, n]
    n_win = width - n
    eq = torch.ones(b, n_win, dtype=torch.bool, device=hist.device)
    for j in range(n):
        eq &= hist[:, j : j + n_win] == last[:, j : j + 1]
    idx = torch.arange(n_win, device=hist.device)
    score = torch.where(eq & (idx < (cur - n)[:, None]), idx, -1)
    j_star = score.amax(dim=1)
    at = _at_most(j_star.clamp(min=0) + n, t_len - draft_k)
    return j_star >= 0, hist.gather(1, at[:, None] + torch.arange(draft_k, device=hist.device))


def _lookup_draft(hist: torch.Tensor, cur_len: torch.Tensor, match_n: int, draft_k: int, t_len=None) -> torch.Tensor:
    """The drafts [B, draft_k] of prompt lookup, longest suffix first: n =
    match_n down to 1, the longest n with an earlier occurrence wins. A row
    with no match at any n drafts whatever follows its 1-gram search (the
    verification makes that one token a forward, never a wrong one).
    `t_len`: as in `_lookup_draft_n`."""
    _, draft = _lookup_draft_n(hist, cur_len, 1, draft_k, t_len)
    for n in range(2, match_n + 1):  # longer matches override
        found, draft_n = _lookup_draft_n(hist, cur_len, n, draft_k, t_len)
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
    per-step logits). Sharded params: see the module docstring (the
    forwards are the rank's rows')."""
    device = inputs_embeds.device
    mesh = params.get("mesh")
    b_all, s, _ = inputs_embeds.shape
    if s + max_new_tokens + chunk - 1 > capacity:
        raise ValueError(f"capacity {capacity} < prompt {s} + max_new_tokens {max_new_tokens} + chunk {chunk} - 1")
    if chunk < 2 or match_n < 1:
        raise ValueError(f"lookup decoding takes chunk >= 2 and match_n >= 1, got {chunk}, {match_n}")
    if prompt_ids.ndim == 1:
        prompt_ids = prompt_ids[None]
    inputs_embeds = dp_rows(inputs_embeds, mesh)
    if prompt_ids.shape[0] == b_all > 1:
        prompt_ids = dp_rows(prompt_ids, mesh)
    b = inputs_embeds.shape[0]
    vocab = vocab_size_of(params)
    t_buf = s + max_new_tokens
    act = inputs_embeds.dtype
    graph = decode_graph.graphed(device, params)
    with _decode_buffers(params, cfg, b, capacity, kv_dtype, device, rope, graph) as (cache, st, rope):
        tokens, tok, done, n_gen, cur_len, rows, forwards, t_len = (
            st[k] for k in ("tokens", "tok", "done", "n_gen", "cur", "rows", "forwards", "t_len"))

        def live() -> torch.Tensor:
            return ~done & (n_gen < max_new_tokens)

        def step():
            """One chunk forward a row at its own position; a row accepts
            1..chunk tokens while it is live, none after. Counts the forward
            where a row was live, as the eager loop counts its forwards."""
            forwards.add_(live().any().long())
            draft = _lookup_draft(tokens, cur_len, match_n, chunk - 1, t_len)  # [B, chunk - 1]
            emb = F.embedding(torch.cat([tok[:, None], draft], dim=1), params["embed"]).to(act)
            hidden = lm_forward(params, cfg, emb, cache, pos=cur_len - 1, is_prefill=False, rope=rope)
            logits = logits_all(params, hidden)  # [B, chunk, V]
            accepting = ~done
            add = torch.zeros_like(n_gen)
            for i in range(chunk):
                t_i = greedy_pick(logits[:, i], ngram_ban_mask_batched(tokens, cur_len + i, ngram_size, vocab))
                emit = accepting & (n_gen + add < max_new_tokens)
                wpos = (cur_len + i).clamp(max=capacity - 1)  # below t_len wherever emit (the budget)
                tokens[rows, wpos] = torch.where(emit, t_i, tokens[rows, wpos])
                tok.copy_(torch.where(emit, t_i, tok))
                add += emit.long()
                hit_eos = emit & (t_i == eos_id)
                done.logical_or_(hit_eos)
                if i < chunk - 1:
                    accepting = emit & ~hit_eos & (t_i == draft[:, i])
            cur_len.add_(add)
            n_gen.add_(add)

        t0 = time.perf_counter()
        hidden = lm_forward(params, cfg, inputs_embeds, cache, pos=0, is_prefill=True, rope=rope)
        logits = logits_last(params, hidden)
        tokens[:, :s] = prompt_ids.to(device)
        t_len.fill_(t_buf)
        cur_len.fill_(s)
        tok.copy_(greedy_pick(logits, ngram_ban_mask_batched(tokens, cur_len, ngram_size, vocab)))
        if stats is not None:
            stats["logits0"] = logits.float().cpu()
            _sync(device)
            stats["prefill_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        done.copy_(tok == eos_id)
        tokens[:, s] = tok
        cur_len.add_(1)
        n_gen.fill_(1)
        forwards.zero_()
        run = decode_graph.RUNNER.steps(
            ("lookup", vocab, act, ngram_size, eos_id, max_new_tokens, chunk, match_n),
            f"lookup_greedy_generate_batched B={b} cap={capacity} chunk={chunk} "
            f"{str(kv_dtype).replace('torch.', '')}", params, (cache, st, rope), step, device, graph)
        # A live forward emits a token of its longest-lived row: at most
        # max_new_tokens - 1 of them after the prefill's.
        decode_graph.decode_loop(run, max_new_tokens - 1, lambda: bool(live().any()))
        out = tokens[:, :t_buf].clone(), n_gen.clone(), 1 + int(forwards)  # the prefill counts as one forward
    if stats is not None:
        _sync(device)
        stats["decode_s"] = time.perf_counter() - t1
    tokens, n_gen = all_gather_dp(out[0], mesh), all_gather_dp(out[1], mesh)
    return (tokens, n_gen, out[2]) if return_steps else (tokens, n_gen)


def lookup_greedy_generate(params, cfg: DeepseekV2Config, inputs_embeds: torch.Tensor, prompt_ids: torch.Tensor,
                           **kw):
    """Prompt-lookup greedy decoding of one sequence (the JAX package's
    function of this name): `lookup_greedy_generate_batched` at B = 1, with
    the same keywords and returns."""
    if inputs_embeds.shape[0] != 1:
        raise ValueError("lookup_greedy_generate decodes one sequence; use lookup_greedy_generate_batched")
    return lookup_greedy_generate_batched(params, cfg, inputs_embeds, prompt_ids, **kw)
