"""Greedy sampling with the no-repeat-ngram ban, on device
(port of deepseek_ocr2_tpu.ops.sampling; greedy only: `sample_pick` is not
ported yet)."""

from __future__ import annotations

from typing import Optional

import torch


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
