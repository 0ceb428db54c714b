"""Greedy sampling with the no-repeat-ngram ban, on device
(port of deepseek_ocr2_tpu.ops.sampling; greedy only in this slice)."""

from __future__ import annotations

from typing import Optional

import torch


def ngram_ban_mask(
    tokens: torch.Tensor,  # [T] token buffer (prompt + generated, padded)
    cur_len: int,  # number of valid tokens
    ngram_size: int,
    vocab_size: int,
) -> torch.Tensor:
    """Bool [vocab], True = banned next token: for every window
    tokens[i : i+n-1] equal to the current suffix tokens[cur_len-n+1 : cur_len]
    with i + n <= cur_len, the continuation tokens[i+n-1] is banned."""
    device = tokens.device
    t = tokens.shape[0]
    if ngram_size == 0 or t < ngram_size:
        return torch.zeros(vocab_size, dtype=torch.bool, device=device)
    tokens = tokens.long()
    prefix_len = ngram_size - 1
    start = max(cur_len - prefix_len, 0)
    idx = (start + torch.arange(prefix_len, device=device)).clamp(max=t - 1)
    prefix = tokens[idx]
    n_win = t - prefix_len
    matches = torch.ones(n_win, dtype=torch.bool, device=device)
    for j in range(prefix_len):
        matches &= tokens[j : j + n_win] == prefix[j]
    valid = (torch.arange(n_win, device=device) + ngram_size) <= cur_len
    valid &= matches & (cur_len >= prefix_len)
    nxt = tokens[prefix_len:]
    valid &= nxt < vocab_size  # ids outside the vocabulary ban nothing (JAX drops them)
    mask = torch.zeros(vocab_size, dtype=torch.int32, device=device)
    mask.scatter_reduce_(0, nxt.clamp(max=vocab_size - 1), valid.int(), reduce="amax")
    return mask.bool()


def greedy_pick(logits: torch.Tensor, ban_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Argmax over the last axis; NaNs never win; the first maximal index
    wins (torch.argmax's documented tie rule, as jnp.argmax's)."""
    l32 = logits.float()
    l32 = l32.masked_fill(torch.isnan(l32), float("-inf"))
    if ban_mask is not None:
        l32 = l32.masked_fill(ban_mask, float("-inf"))
    return torch.argmax(l32, dim=-1)
