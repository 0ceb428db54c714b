"""Greedy and stochastic token choice with the no-repeat-ngram ban, on
the device (port of deepseek_ocr2_tpu.ops.sampling).

`sample_pick` draws from JAX's threefry stream (`ops.prng`), so a row's
key gives the JAX package's token; every function works on a batch of rows
and reads nothing back to the host."""

from __future__ import annotations

from typing import Optional

import torch

from . import prng


def ngram_ban_mask_batched(
    tokens: torch.Tensor,  # [B, T] token buffers (prompt + generated, padded)
    cur_lens: torch.Tensor,  # [B] int tensor: valid tokens per row
    ngram_size: int,
    vocab_size: int,
) -> torch.Tensor:
    """Bool [B, vocab], True = banned next token, each row at its own
    length: for every window tokens[r, i : i+n-1] equal to the row's suffix
    tokens[r, len-n+1 : len] with i + n <= len, the continuation
    tokens[r, i+n-1] is banned. As `jax.vmap(ngram_ban_mask, in_axes=(0, 0,
    None, None))`; the lengths stay on the device, nothing is read back."""
    b, t = tokens.shape
    device = tokens.device
    if ngram_size == 0 or t < ngram_size:
        return torch.zeros(b, vocab_size, dtype=torch.bool, device=device)
    tokens = tokens.long()
    lens = cur_lens.long()[:, None]  # [B, 1]
    prefix_len = ngram_size - 1
    start = (lens - prefix_len).clamp(min=0)
    idx = (start + torch.arange(prefix_len, device=device)).clamp(max=t - 1)
    prefix = tokens.gather(1, idx)  # [B, prefix_len]
    n_win = t - prefix_len
    matches = torch.ones(b, n_win, dtype=torch.bool, device=device)
    for j in range(prefix_len):
        matches &= tokens[:, j : j + n_win] == prefix[:, j : j + 1]
    valid = (torch.arange(n_win, device=device)[None, :] + ngram_size) <= lens
    valid &= matches & (lens >= prefix_len)
    nxt = tokens[:, prefix_len:]
    valid &= nxt < vocab_size  # ids outside the vocabulary ban nothing (JAX drops them)
    mask = torch.zeros(b, vocab_size, dtype=torch.int32, device=device)
    mask.scatter_reduce_(1, nxt.clamp(max=vocab_size - 1), valid.int(), reduce="amax")
    return mask.bool()


def greedy_pick(logits: torch.Tensor, ban_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Argmax over the last axis; NaNs never win; the first maximal index
    wins (torch.argmax's documented tie rule, as jnp.argmax's)."""
    l32 = logits.float()
    l32 = l32.masked_fill(torch.isnan(l32), float("-inf"))
    if ban_mask is not None:
        l32 = l32.masked_fill(ban_mask, float("-inf"))
    return torch.argmax(l32, dim=-1)


def sample_pick(
    logits: torch.Tensor,  # [B, V]
    keys: torch.Tensor,  # [B, 2] threefry keys, one a row
    ban_mask: Optional[torch.Tensor] = None,  # [B, V] bool
    *,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 1.0,
    nucleus_candidates: int = 1024,
) -> torch.Tensor:
    """`jax.vmap(sample_pick)` of the JAX package, row by row:
    - temperature 0: exactly `greedy_pick`;
    - NaN and banned logits become -inf, then all are divided by the
      temperature;
    - top_k <= 0 and top_p >= 1: categorical over the whole vocabulary;
    - otherwise categorical over the top_k (or `nucleus_candidates`) largest,
      sorted descending with ties to the lower index as `lax.top_k` sorts
      (a stable descending sort; `torch.topk` makes no promise on ties),
      with top_p < 1 keeping the candidates whose preceding mass
      (cum - probs) is below top_p; a row whose candidates are all banned
      takes greedy over the masked row."""
    if temperature == 0.0:
        return greedy_pick(logits, ban_mask)
    l32 = logits.float()
    l32 = l32.masked_fill(torch.isnan(l32), float("-inf"))
    if ban_mask is not None:
        l32 = l32.masked_fill(ban_mask, float("-inf"))
    l32 = l32 / torch.full((), temperature, dtype=torch.float32, device=l32.device)
    if top_k <= 0 and top_p >= 1.0:
        return prng.categorical(keys, l32)
    k = min(top_k if top_k > 0 else nucleus_candidates, l32.shape[-1])
    vals, idx = torch.sort(l32, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    if top_p < 1.0:
        # jax.nn.softmax's form: exp(x - max) / sum.
        e = torch.exp(vals - vals.max(dim=-1, keepdim=True).values)
        probs = e / e.sum(dim=-1, keepdim=True)
        keep = (torch.cumsum(probs, dim=-1) - probs) < torch.full((), top_p, dtype=torch.float32, device=l32.device)
        vals = vals.masked_fill(~keep, float("-inf"))
    choice = prng.categorical(keys, vals)
    picked = idx.gather(1, choice[:, None])[:, 0]
    return torch.where(torch.isfinite(vals).any(dim=-1), picked, torch.argmax(l32, dim=-1))
