"""Continuous-batching OCR engine on the paged KV cache (port of
deepseek_ocr2_tpu.runtime.continuous; greedy or sampled decoding).

A fixed set of decode slots shares one paged K/V pool (runtime/paged_kv.py);
pending pages are admitted into free slots as others finish, so vision,
prefill and decode of different pages interleave and the decoder never idles
on stragglers.

Memory: admission claims only the pages that the prompt, the first token and
the first decode chunk need; before every chunk each active slot is topped up
to cover the next chunk (`grow_pages`, bounded by the slot's own prompt +
max_new budget), and pages return to the pool at harvest. If growth finds
the pool empty, a strictly younger slot is preempted: its pages are freed and
its page re-queued. Greedy decode is deterministic, a sampled row draws
with the key fold_in(fold_in(PRNGKey(0), seed), position), and a row's
result does not depend on the other rows of the batch (kernel F sums in a
fixed order), so a re-admitted page reproduces its tokens. The first token
of a page comes from its admission and stays greedy, as in the JAX package.

Pools: f32 / bf16 (attention kernel G), or with the pipeline's kv_dtype
"int8" / "int8tail" the quantized pools (kernel P); the transient prefill
cache then keeps the activation dtype and admission quantizes the prompt
into the pool (and stages its last page into the slot's open page).

Device and host:
- admission, per group of pending pages that share a crop grid and prompt
  (power-of-two sizes): one batched vision pass, one batched LM prefill
  (`admit_prefill`) and one scatter of the prompts' K/V into their pages
  (`insert_group`, in place);
- decoding: `decode_chunk` advances every slot `chunk_steps` steps over
  the pool (per-slot positions, n-gram ban, EOS and budget; finished rows
  frozen and pointed at the scratch page). All decode state stays on the
  device (`DecodeState`, updated in place) and no step reads a value
  back; the host reads one packed status tensor per chunk. On the card,
  with an LM on no mesh, the whole chunk is one CUDA graph, the JAX
  package's `scan` (`runtime.decode_graph`): captured once for the
  engine's pool and state, the runner's static buffers for the pool's
  shape (kept across serve loops until a decode of another key needs its
  own), and replayed after the block tables are copied into the state's
  static `tables`. On
  CPU tensors, and on a sharded LM (whose collectives a CUDA graph cannot
  capture), the same chunk runs eagerly;
- prompt-lookup decoding (`lookup_chunk` >= 2, greedy only):
  `decode_chunk_lookup` replaces the steps with `lookup_steps` chunk
  forwards of `lookup_chunk` tokens a slot (the last token and its drafts,
  attention kernel Q or R; one graph too), 1..lookup_chunk accepted tokens
  each; pages
  grow and admissions reserve `dispatch_tokens` (lookup_steps x
  lookup_chunk), the most a dispatch can write;
- preprocessing: a worker thread runs the host stage of the next pending
  pages and ships them, or on the device-resize path resizes them on the
  card, enqueued on the serve thread's stream, so admission reads complete
  pixels. Pages ship one at a time: the JAX package's stacked ship of
  bucket-padded pages paid a per-transfer fee the card does not have.

On a pipeline whose LM is sharded onto a mesh (`OCR2Pipeline` takes one)
every rank runs this same scheduler on the same pages, its host and
device state replicated (the JAX engine's uncommitted state is), the
vision towers whole; the pool holds the rank's heads, and the LM's
collectives run over mp alone (the pipeline's view of the mesh has dp 1:
each rank holds every slot). The ranks' schedules stay equal because
nothing in them reads a clock or another thread's progress there: an
admission waits for the head of the queue to be preprocessed (no grace
for pages still in flight), and preemption picks its victims by admission
order. Online serving (`start`) is refused on such a pipeline: each rank's
submissions would arrive at its own times.

`DEEPSEEK_DEBUG_SERVE` (any value) prints a wall-clock trace of the serve
loop to stderr: admission, decode chunk, harvest and preprocess waits.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import DeepseekV2Config
from ..models.deepseek_v2 import lm_forward, logits_all, logits_last, n_heads, vocab_size_of
from ..ops import prng
from ..ops.sampling import greedy_pick, ngram_ban_mask_batched, sample_pick
from ..parallel.mesh import mesh_of
from ..utils.debug import dbg_print, enabled
from ..utils.tokenizer import decode_output, tokenize_with_image
from . import decode_graph
from .engine import batched_vision_prefill
from .generate import _lookup_draft
from .kv_cache import make_kv_cache
from .paged_kv import PageAllocator, lm_decode_step_paged, make_paged_kv_cache, pages_for, write_prompt_pool_batched
from .pipeline import GenerationResult, OCR2Pipeline


@dataclasses.dataclass
class DecodeState:
    """Per-slot decode state, on the device, updated in place."""

    tokens: torch.Tensor  # [B, tok_cap] int64: prompt + generated ids
    cur_lens: torch.Tensor  # [B] int32: valid tokens
    done: torch.Tensor  # [B] bool: finished or empty
    limits: torch.Tensor  # [B] int32: stop length (prompt + max_new)
    seeds: torch.Tensor  # [B] int64: sampling seed of the slot's page
    # [B, max_pages] int32: the block tables a captured chunk reads, copied in before each replay
    tables: Optional[torch.Tensor] = None

    @classmethod
    def empty(cls, slots: int, tok_cap: int, device) -> "DecodeState":
        return cls(
            tokens=torch.zeros(slots, tok_cap, dtype=torch.long, device=device),
            cur_lens=torch.zeros(slots, dtype=torch.int32, device=device),
            done=torch.ones(slots, dtype=torch.bool, device=device),  # empty slots count as done
            limits=torch.zeros(slots, dtype=torch.int32, device=device),
            seeds=torch.zeros(slots, dtype=torch.long, device=device),
        )

    def reset(self) -> None:
        """Back to `empty`'s values, in place."""
        for t in (self.tokens, self.cur_lens, self.limits, self.seeds):
            t.zero_()
        self.done.fill_(True)


@torch.no_grad()
def admit_prefill(
    lm_params,
    cfg: DeepseekV2Config,
    embeds: torch.Tensor,  # [G, S, H]
    prompt_ids: torch.Tensor,  # [G, S]
    *,
    capacity: int,
    kv_dtype: torch.dtype,
    ngram_size: int,
    rope,
):
    """Batched LM prefill of an admission group sharing one prompt length,
    into a contiguous cache of `kv_dtype` (f32 or bf16). Returns (k [L, G,
    Hh, cap, D], v, first token [G]); the first token is greedy, also when
    the engine samples."""
    g, s, _ = embeds.shape
    cache = make_kv_cache(cfg.num_hidden_layers, g, n_heads(cfg, lm_params.get("mesh")), capacity, cfg.head_dim,
                          dtype=kv_dtype, device=embeds.device)
    hidden = lm_forward(lm_params, cfg, embeds, cache, pos=0, is_prefill=True, rope=rope)
    logits = logits_last(lm_params, hidden)  # [G, V]
    buf = torch.zeros(g, capacity, dtype=torch.long, device=embeds.device)
    buf[:, :s] = prompt_ids
    lens = torch.full((g,), s, dtype=torch.long, device=embeds.device)
    tok = greedy_pick(logits, ngram_ban_mask_batched(buf, lens, ngram_size, logits.shape[-1]))
    return cache["k"], cache["v"], tok


@torch.no_grad()
def insert_group(
    cache,  # paged pool, updated in place
    state: DecodeState,  # updated in place
    k_new: torch.Tensor,  # [L, G, Hh, cap, D]
    v_new: torch.Tensor,
    page_ids: torch.Tensor,  # [G, n_prompt_pages] int
    slot_ids: torch.Tensor,  # [G] int64
    group_tokens: torch.Tensor,  # [G, tok_cap] int64: prompt + first token
    done0: torch.Tensor,  # [G] bool
    group_limits: torch.Tensor,  # [G] int32
    group_seeds: torch.Tensor,  # [G] int64
    prompt_len: int,
) -> None:
    """Scatter an admission group's prompt K/V into its pages (quantized,
    and its last page staged into the slots' open pages, as the pool asks)
    and its decode state into the slot arrays."""
    write_prompt_pool_batched(cache, k_new, v_new, page_ids, prompt_len, slot_ids=slot_ids)
    state.tokens.index_copy_(0, slot_ids, group_tokens)
    state.cur_lens.index_fill_(0, slot_ids, prompt_len + 1)
    state.limits.index_copy_(0, slot_ids, group_limits)
    state.done.index_copy_(0, slot_ids, done0)
    state.seeds.index_copy_(0, slot_ids, group_seeds)


def _chunk_runner(kind: tuple, label: str, lm_params, cache, state: "DecodeState", block_tables: torch.Tensor,
                  rope, step_of) -> torch.Tensor:
    """Run one chunk `step_of(bt)` over the state, the pool and the block
    tables: eagerly, or as the replay of its graph (`runtime.decode_graph`),
    which reads the tables from the state's static `tables`, copied into
    first. Returns the chunk's packed status."""
    device = state.tokens.device
    if not decode_graph.graphed(device, lm_params):
        return step_of(block_tables)
    if state.tables is None or state.tables.shape != block_tables.shape:
        state.tables = torch.empty_like(block_tables)
    state.tables.copy_(block_tables)
    return decode_graph.RUNNER.steps(kind, label, lm_params, (cache, list(vars(state).values()), rope),
                                     lambda: step_of(state.tables), device, True)(1)


@torch.no_grad()
def decode_chunk(
    lm_params,
    cfg: DeepseekV2Config,
    cache,  # paged pool {"k", "v"} [L, P, Hh, page, D] (+ scales, open pages), updated in place
    state: DecodeState,  # updated in place
    block_tables: torch.Tensor,  # [B, max_pages] int32, on the device
    *,
    n_steps: int,
    ngram_size: int,
    eos_id: int,
    rope,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Advance every active slot by up to `n_steps` steps, greedy at
    temperature 0, else sampled with the row key fold_in(fold_in(
    PRNGKey(0), seed), cur_len). Finished rows are frozen (their K/V goes
    to the scratch page 0). No step reads a value back to the host; on the
    card the chunk is one captured graph, the JAX package's `scan`
    (`_chunk_runner`). Returns the packed status [cur_lens, done] (int32
    [2B]) on the device, for the caller's one readback."""
    tokens, cur_lens, done, limits = state.tokens, state.cur_lens, state.done, state.limits
    b, tok_cap = tokens.shape
    vocab = vocab_size_of(lm_params)  # lm_head may be int8 or int4

    def chunk(bt_live: torch.Tensor) -> torch.Tensor:
        rows = torch.arange(b, device=tokens.device)
        scratch = torch.zeros_like(bt_live)
        base_keys = prng.fold_in(prng.prng_key(0, tokens.device), state.seeds) if temperature != 0.0 else None
        for _ in range(n_steps):
            active = ~done
            pos = (cur_lens - 1).clamp(0, tok_cap - 1)
            last = tokens[rows, pos.long()]
            emb = F.embedding(last, lm_params["embed"])[:, None, :]
            bt = torch.where(done[:, None], scratch, bt_live)
            hidden = lm_decode_step_paged(lm_params, cfg, emb, cache, bt, pos, rope=rope)
            logits = logits_last(lm_params, hidden)  # [B, V]
            ban = ngram_ban_mask_batched(tokens, cur_lens, ngram_size, vocab)
            if base_keys is None:
                nxt = greedy_pick(logits, ban)
            else:
                nxt = sample_pick(logits, prng.fold_in(base_keys, cur_lens), ban, temperature=temperature,
                                  top_k=top_k, top_p=top_p)
            nxt = torch.where(active, nxt, last)
            widx = cur_lens.long().clamp(0, tok_cap - 1)
            tokens[rows, widx] = torch.where(active, nxt, tokens[rows, widx])
            newly_done = active & ((nxt == eos_id) | (cur_lens + 1 >= limits))
            cur_lens.add_(active.to(torch.int32))
            done.logical_or_(newly_done)
        return torch.cat([cur_lens, done.to(torch.int32)])

    return _chunk_runner(("chunk", vocab, n_steps, ngram_size, eos_id, temperature, top_k, top_p),
                         f"decode_chunk B={b} steps={n_steps}{' sampled' if temperature else ''} "
                         f"pool={_pool_kind(cache)}", lm_params, cache, state, block_tables, rope, chunk)


@torch.no_grad()
def decode_chunk_lookup(
    lm_params,
    cfg: DeepseekV2Config,
    cache,  # paged pool, updated in place
    state: DecodeState,  # updated in place
    block_tables: torch.Tensor,  # [B, max_pages] int32, on the device
    *,
    n_steps: int,
    chunk: int,
    match_n: int,
    ngram_size: int,
    eos_id: int,
    rope,
) -> torch.Tensor:
    """Advance every active slot by `n_steps` prompt-lookup forwards (the
    JAX package's function of this name): each feeds a slot its last token
    and `chunk - 1` drafts (`_lookup_draft`) through one chunk decode over
    the pool at per-row positions, then accepts the longest prefix that the
    model's greedy picks (ban included) confirm, plus the first pick that
    differs. The same ban positions and EOS / limit rule as `decode_chunk`,
    so the tokens are the plain engine's up to chunk-width rounding. No
    step reads a value back; on the card the n_steps forwards are one
    captured graph. Returns the packed status [cur_lens, done, forwards]
    (int32 [2B + 1]) on the device; forwards counts the steps with an
    active slot."""
    tokens, cur_lens, done, limits = state.tokens, state.cur_lens, state.done, state.limits
    b, tok_cap = tokens.shape
    vocab = vocab_size_of(lm_params)

    def forwards_of(bt_live: torch.Tensor) -> torch.Tensor:
        rows = torch.arange(b, device=tokens.device)
        scratch = torch.zeros_like(bt_live)
        forwards = torch.zeros((), dtype=torch.int32, device=tokens.device)
        for _ in range(n_steps):
            active = ~done
            forwards += active.any().to(torch.int32)
            pos = (cur_lens - 1).clamp(0, tok_cap - 1)
            last = tokens[rows, pos.long()]
            draft = _lookup_draft(tokens, cur_lens, match_n, chunk - 1)  # [B, chunk - 1]
            emb = F.embedding(torch.cat([last[:, None], draft], dim=1), lm_params["embed"])  # [B, chunk, H]
            bt = torch.where(done[:, None], scratch, bt_live)
            hidden = lm_decode_step_paged(lm_params, cfg, emb, cache, bt, pos, rope=rope)
            logits = logits_all(lm_params, hidden)  # [B, chunk, V]
            accepting = active
            add = torch.zeros_like(cur_lens)
            for i in range(chunk):
                t_i = greedy_pick(logits[:, i], ngram_ban_mask_batched(tokens, cur_lens + i, ngram_size, vocab))
                emit = accepting
                wpos = (cur_lens + i).long().clamp(0, tok_cap - 1)
                tokens[rows, wpos] = torch.where(emit, t_i, tokens[rows, wpos])
                add += emit.to(torch.int32)
                newly_done = emit & ((t_i == eos_id) | (cur_lens + i + 1 >= limits))
                done.logical_or_(newly_done)
                if i < chunk - 1:
                    accepting = emit & ~newly_done & (t_i == draft[:, i])
            cur_lens.add_(add)
        return torch.cat([cur_lens, done.to(torch.int32), forwards.reshape(1)])

    return _chunk_runner(("lookup", vocab, n_steps, chunk, match_n, ngram_size, eos_id),
                         f"decode_chunk_lookup B={b} forwards={n_steps} chunk={chunk} pool={_pool_kind(cache)}",
                         lm_params, cache, state, block_tables, rope, forwards_of)


def _pool_kind(cache) -> str:
    if "open_k" in cache:
        return "int8tail"
    return str(cache["k"].dtype).replace("torch.", "")


def _pow2_at_most(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class OCRRequest:
    """One OCR request flowing through the continuous engine.

    Returned by `ContinuousOCREngine.submit` (online serving); also the
    unit of the batch `run` path. `result(timeout)` blocks until the page
    finishes and returns its GenerationResult (re-raising a per-request
    failure, e.g. an unreadable image).

    With `stream=True` (submit only), generated ids are also pushed chunk by
    chunk; consume them with `stream_token_ids()` / `stream_text()` (one
    consumer). Preemption is invisible to the stream: the engine counts the
    generated tokens already emitted and the deterministic re-decode emits
    only past that mark, so the stream never repeats or drops a token.
    """

    __slots__ = (
        "image", "prompt", "max_new_tokens", "no_crop", "rotate",
        "auto_rotate", "seq", "pre", "_result", "error", "_event",
        "stream", "_stream_q", "_n_streamed",
    )

    def __init__(self, image, prompt: str, max_new_tokens: int, no_crop: bool,
                 rotate: int, auto_rotate: bool, seq: int, stream: bool = False):
        self.image = image
        self.prompt = prompt
        self.max_new_tokens = max_new_tokens
        self.no_crop = no_crop
        self.rotate = rotate
        self.auto_rotate = auto_rotate
        self.seq = seq
        self.pre = None  # (base, patches, ratio, rot) on the device once preprocessed
        self._result: Optional[GenerationResult] = None
        self.error: Optional[Exception] = None
        self._event = threading.Event()
        self.stream = stream
        self._stream_q = queue.Queue() if stream else None
        self._n_streamed = 0  # generated tokens already emitted (survives preemption)

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> GenerationResult:
        if not self._event.wait(timeout):
            raise TimeoutError("OCR request still in flight")
        if self.error is not None:
            raise self.error
        return self._result  # type: ignore[return-value]

    def stream_token_ids(self, timeout: Optional[float] = None):
        """Yield lists of generated ids as decode chunks land; return when
        the request finishes (re-raising its error). `timeout` bounds the
        wait for each chunk."""
        if self._stream_q is None:
            raise RuntimeError("request was not submitted with stream=True")
        while True:
            try:
                item = self._stream_q.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError("OCR stream stalled") from None
            if item is None:
                break
            yield item
        if self.error is not None:
            raise self.error

    def stream_text(self, tokenizer, stop_string: Optional[str] = None, timeout: Optional[float] = None):
        """Yield text deltas (see `_TextStream`); their concatenation is the
        final text up to its trailing strip()."""
        ts = _TextStream(tokenizer, stop_string)
        for ids in self.stream_token_ids(timeout=timeout):
            delta = ts.push(ids)
            if delta:
                yield delta
            if ts.stopped:
                return

    def _finish(self, result=None, error=None):
        self._result = result
        self.error = error
        if self._stream_q is not None:
            self._stream_q.put(None)  # sentinel: stream consumers unblock
        self._event.set()


class _TextStream:
    """Incremental detokenizer for streamed ids.

    Decodes the whole generated prefix on every push and emits only the new
    suffix, holding back text that ends in U+FFFD (a UTF-8 sequence split
    across chunks) and any trailing run that is a prefix of `stop_string`;
    once the full stop string appears it cuts there and sets `stopped`.
    """

    def __init__(self, tokenizer, stop_string: Optional[str] = None):
        self.tokenizer = tokenizer
        self.stop_string = stop_string
        self.ids: List[int] = []
        self.sent = ""
        self.stopped = False

    def push(self, ids) -> str:
        if self.stopped:
            return ""
        self.ids.extend(int(i) for i in ids)
        text = self.tokenizer.decode(self.ids, skip_special_tokens=False)
        if text.endswith("�"):
            return ""
        if self.stop_string:
            cut = text.find(self.stop_string)
            if cut != -1:
                text = text[:cut]
                self.stopped = True
            else:
                for k in range(min(len(self.stop_string) - 1, len(text)), 0, -1):
                    if text.endswith(self.stop_string[:k]):
                        text = text[: len(text) - k]
                        break
        # Decoders are monotone in practice; resync on the common prefix if not.
        n = 0
        m = min(len(self.sent), len(text))
        while n < m and self.sent[n] == text[n]:
            n += 1
        delta = text[n:]
        if delta:
            self.sent = text
        return delta


class ContinuousOCREngine:
    """Continuous batching over the OCR pipeline, paged KV, batched admissions.

    `pool_tokens` sizes the shared pool (default slots * capacity); pass less
    for memory-elastic serving: a page only ever holds
    ceil((prompt + max_new) / page_size) pages, and pages recycle at harvest.

    Two entry points share one serve loop:
    - `run(images, ...)`: batch mode, returns when every page is done;
    - `start()` / `submit(image, ...)` / `stop()`: online mode, a worker
      thread runs the loop; requests join the running batch at any time and
      resolve through their `OCRRequest`. Admission groups key on (crop
      grid, prompt); max_new_tokens may differ within a group.
    """

    def __init__(
        self,
        pipe: OCR2Pipeline,
        slots: int = 8,
        capacity: int = 2048,
        chunk_steps: int = 32,
        page_size: int = 128,
        pool_tokens: Optional[int] = None,
        lookup_chunk: int = 0,
        lookup_match_n: int = 3,
    ):
        self.pipe = pipe
        self.slots = slots
        self.capacity = capacity
        self.chunk_steps = chunk_steps
        self.page_size = page_size
        self.pool_tokens = pool_tokens or slots * capacity
        # Prompt-lookup decoding (greedy only): a dispatch runs lookup_steps
        # chunk forwards of lookup_chunk tokens, so that it writes at most
        # about the tokens a plain dispatch of chunk_steps does.
        self.lookup_chunk = lookup_chunk
        self.lookup_match_n = lookup_match_n
        if lookup_chunk >= 2:
            self.lookup_steps = max(1, chunk_steps // lookup_chunk)
            self.dispatch_tokens = self.lookup_steps * lookup_chunk
        else:
            self.lookup_steps = 0
            self.dispatch_tokens = chunk_steps
        self.max_pages_per_slot = pages_for(capacity, page_size)
        self.num_pages = pages_for(self.pool_tokens, page_size) + 1  # +1: page 0 is the scratch page
        if self.num_pages - 1 < self.max_pages_per_slot:
            raise ValueError(
                f"pool_tokens={self.pool_tokens} cannot hold even one slot at capacity {capacity} "
                f"(page_size {page_size}); preemption could not guarantee progress"
            )
        self._cv = threading.Condition()
        self._pending: List[OCRRequest] = []
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        # Counters of the latest serve loop: preemptions, decode steps run
        # (chunks x chunk_steps, or x lookup_steps forwards with lookup),
        # the wall time of the decode chunks, each ending in its status
        # readback, and the lookup forwards that had an active slot.
        self.last_preempted = 0
        self.last_lookup_forwards = 0
        self.last_decode_steps = 0
        self.last_decode_seconds = 0.0
        self.last_admissions = 0  # admission groups (one batched prefill each), re-admissions included
        self.alloc: Optional[PageAllocator] = None

    # ---- public API -----------------------------------------------------

    def run(self, images: Sequence, prompt: Optional[str] = None, max_new_tokens: int = 512,
            no_crop: bool = False, ngram_size: int = 20, rotate: int = 0, auto_rotate: bool = False,
            sampling: Optional[dict] = None) -> List[GenerationResult]:
        """Batch mode: OCR every image; results come back positionally."""
        if self._thread is not None:
            raise RuntimeError("engine is running online; use submit()")
        reqs = [self._make_request(img, prompt, max_new_tokens, no_crop, rotate, auto_rotate, seq=i)
                for i, img in enumerate(images)]
        return self.run_requests(reqs, ngram_size=ngram_size, sampling=sampling)

    def run_requests(self, reqs: List[OCRRequest], ngram_size: int = 20,
                     sampling: Optional[dict] = None) -> List[GenerationResult]:
        """Batch-serve already-built requests (see `prestage`). `sampling`
        takes the keys temperature, top_k, top_p and seed; page i samples
        with seed + its request's seq."""
        if self._thread is not None:
            raise RuntimeError("engine is running online; use submit()")
        with self._cv:
            self._pending.extend(reqs)
        self._serve(ngram_size=ngram_size, sampling=sampling, online=False)
        for r in reqs:
            if r.error is not None:
                raise r.error
        return [r.result(timeout=0) for r in reqs]

    def prestage(self, images: Sequence, prompt: Optional[str] = None, max_new_tokens: int = 512,
                 no_crop: bool = False, rotate: int = 0, auto_rotate: bool = False) -> List[OCRRequest]:
        """Preprocess every page and ship its pixels to the device BEFORE
        serving, so that `run_requests` times serving alone. A preempted
        page is preprocessed again inside the serve loop."""
        reqs = [self._make_request(img, prompt, max_new_tokens, no_crop, rotate, auto_rotate, seq=i)
                for i, img in enumerate(images)]
        for r in reqs:
            r.pre = self._preprocess(r)
        if self.pipe.device.type == "cuda":
            torch.cuda.synchronize(self.pipe.device)  # staging ends here
        return reqs

    def start(self, ngram_size: int = 20, sampling: Optional[dict] = None):
        """Online mode: spawn the serve loop; `submit` feeds it."""
        if self._thread is not None:
            raise RuntimeError("engine already started")
        if mesh_of(self.pipe.params) is not None:
            raise ValueError("online serving takes an unsharded LM: on a sharded one every rank must admit the "
                             "same pages at the same step, which its own arrival times cannot promise; use run()")
        self._check_lookup(sampling)
        self._stop = False
        self._thread = threading.Thread(target=self._serve,
                                        kwargs=dict(ngram_size=ngram_size, sampling=sampling, online=True),
                                        daemon=True)
        self._thread.start()
        return self

    def submit(self, image, prompt: Optional[str] = None, max_new_tokens: int = 512, no_crop: bool = False,
               rotate: int = 0, auto_rotate: bool = False, stream: bool = False) -> OCRRequest:
        """Enqueue one page; returns its OCRRequest. With `stream=True` the
        generated ids are also pushed as they land."""
        if self._thread is None:
            raise RuntimeError("engine not started; call start() first")
        req = self._make_request(image, prompt, max_new_tokens, no_crop, rotate, auto_rotate, stream=stream)
        with self._cv:
            if self._stop:
                raise RuntimeError("engine is stopping")
            self._pending.append(req)
            self._cv.notify_all()
        return req

    def stop(self, timeout: Optional[float] = None):
        """Drain in-flight work and stop the online serve loop."""
        if self._thread is None:
            return
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout)
        self._thread = None

    # ---- internals --------------------------------------------------------

    def _check_lookup(self, sampling: Optional[dict]) -> None:
        if self.lookup_chunk >= 2 and (sampling or {}).get("temperature", 0.0) != 0.0:
            raise ValueError("lookup_chunk requires greedy decoding (temperature 0): the speculative accept test "
                             "compares deterministic picks")

    def _make_request(self, image, prompt, max_new_tokens, no_crop, rotate, auto_rotate,
                      seq: Optional[int] = None, stream: bool = False) -> OCRRequest:
        prompt = prompt or self.pipe.cfg.default_ocr_prompt
        if seq is None:
            with self._cv:
                seq = self._seq
                self._seq += 1
        return OCRRequest(image, prompt, max_new_tokens, no_crop, int(rotate), auto_rotate, seq, stream=stream)

    def _preprocess(self, req: OCRRequest):
        """Host stage (PIL) and the ship of the uint8 views to the device. A
        page given as the dict `preprocess_host` returns skips the host stage."""
        pre = req.image if isinstance(req.image, dict) else self.pipe.preprocess_host(
            req.image, no_crop=req.no_crop, rotate=req.rotate, auto_rotate=req.auto_rotate)
        return self.pipe.preprocess_finish(pre)

    def _serve(self, ngram_size: int, sampling: Optional[dict], online: bool):
        """The serve loop on its pool and decode state: made for the loop,
        or, where the chunks replay captured graphs, the runner's static
        ones for the pool's shape (`decode_graph.DecodeGraphs.buffers`),
        kept across serve loops, the pool zeroed and the state emptied
        again, so that a chunk's graph is captured once, not once a loop."""
        pipe, lm_cfg, dev = self.pipe, self.pipe.cfg.lm, self.pipe.device
        lm = pipe.params["lm"]
        b, heads = self.slots, n_heads(lm_cfg, lm.get("mesh"))
        graph = decode_graph.graphed(dev, lm)

        def make():
            return (make_paged_kv_cache(lm_cfg.num_hidden_layers, self.num_pages, heads, self.page_size,
                                        lm_cfg.head_dim, dtype=pipe.kv_dtype, device=dev, slots=b),
                    DecodeState.empty(b, self.capacity, dev))

        key = ("engine", pipe.kv_dtype, self.num_pages, self.page_size, b, self.capacity, dev)
        with decode_graph.RUNNER.buffers(key, lm, make, graph) as (cache, state):
            if graph:
                for t in cache.values():
                    t.zero_()
                state.reset()
            self._serve_loop(cache, state, ngram_size, sampling, online)

    def _serve_loop(self, cache, state: DecodeState, ngram_size: int, sampling: Optional[dict], online: bool):
        pipe = self.pipe
        cfg, lm, lm_cfg, dev = pipe.cfg, pipe.params["lm"], pipe.cfg.lm, pipe.device
        b, tok_cap, page = self.slots, self.capacity, self.page_size
        eos = cfg.eos_token_id
        trace = enabled("DEEPSEEK_DEBUG_SERVE")
        sampling = sampling or {}
        samp = dict(temperature=sampling.get("temperature", 0.0), top_k=sampling.get("top_k", 0),
                    top_p=sampling.get("top_p", 1.0))
        base_seed = sampling.get("seed", 0)
        self._check_lookup(sampling)
        use_lookup = self.lookup_chunk >= 2
        sharded = mesh_of(pipe.params) is not None  # every rank must schedule alike: see the module docstring

        # The quantized pools quantize at the pool boundary; the transient
        # contiguous prefill cache keeps the activation dtype.
        quantized = isinstance(pipe.kv_dtype, str)
        prefill_kv = pipe.act_dtype if quantized else pipe.kv_dtype
        alloc = PageAllocator(self.num_pages)
        self.alloc = alloc  # monitors read n_free while the loop runs
        self.last_decode_steps, self.last_decode_seconds, self.last_admissions = 0, 0.0, 0
        self.last_lookup_forwards = 0
        block_tables_np = np.zeros((b, self.max_pages_per_slot), np.int32)
        done_np = np.ones((b,), bool)
        lens_np = np.zeros((b,), np.int32)

        cv = self._cv
        pending = self._pending  # guarded by cv
        slot_req: Dict[int, OCRRequest] = {}
        slot_pages: Dict[int, List[int]] = {}
        prompt_lens: Dict[int, int] = {}
        slot_limits: Dict[int, int] = {}
        admit_t: Dict[int, float] = {}
        admit_no: Dict[int, int] = {}  # admission order, which preemption reads (equal on every rank)
        prefill_t: Dict[int, float] = {}
        n_preempted = 0
        n_admitted = 0

        def group_key(req: OCRRequest):
            return (req.pre[2], req.prompt)

        def admit_group(slot_ids: List[int], reqs: List[OCRRequest]):
            """One batched vision pass + LM prefill + pool scatter for pages
            sharing a crop grid and prompt (max_new may vary)."""
            nonlocal n_admitted
            t0 = time.perf_counter()
            g = len(reqs)
            pre = [r.pre for r in reqs]
            for r in reqs:
                r.pre = None  # free the pixels; a preempted page is preprocessed again
            crop_ratio = pre[0][2]
            ids, _, image_start = tokenize_with_image(pipe.tokenizer, reqs[0].prompt, cfg, crop_ratio)
            s = len(ids)
            if any(s + r.max_new_tokens > tok_cap for r in reqs):
                raise RuntimeError("admission group over the engine capacity (validated in admit_pending)")
            n_prompt_pages = pages_for(s, page)
            bases = torch.cat([p[0] for p in pre])  # [G, 3, S, S]
            patches = None if pre[0][1] is None else torch.stack([p[1] for p in pre])  # [G, P, 3, c, c]
            ids_t, embeds = batched_vision_prefill(pipe, ids, bases, patches, image_start)
            k_new, v_new, first = admit_prefill(lm, lm_cfg, embeds, ids_t, capacity=n_prompt_pages * page,
                                                kv_dtype=prefill_kv, ngram_size=ngram_size, rope=pipe.rope)
            self.last_admissions += 1
            # Lazy allocation: prompt + first token + first chunk; grow_pages tops up.
            page_ids = np.zeros((g, n_prompt_pages), np.int32)
            for row, (slot, req) in enumerate(zip(slot_ids, reqs)):
                pages = alloc.allocate(pages_for(min(s + 1 + self.dispatch_tokens, s + req.max_new_tokens), page))
                slot_pages[slot] = pages
                block_tables_np[slot] = 0
                block_tables_np[slot, : len(pages)] = pages
                page_ids[row] = pages[:n_prompt_pages]
                slot_req[slot] = req
                prompt_lens[slot] = s
                slot_limits[slot] = s + req.max_new_tokens
            group_tokens = torch.zeros(g, tok_cap, dtype=torch.long, device=dev)
            group_tokens[:, :s] = ids_t
            group_tokens[:, s] = first
            max_new = torch.tensor([r.max_new_tokens for r in reqs], dtype=torch.int32, device=dev)
            done0 = (first == eos) | (max_new <= 1)
            seeds = torch.tensor([base_seed + r.seq for r in reqs], dtype=torch.long, device=dev)
            insert_group(cache, state, k_new, v_new, torch.from_numpy(page_ids).to(dev),
                         torch.tensor(slot_ids, dtype=torch.long, device=dev), group_tokens, done0,
                         max_new + s, seeds, prompt_len=s)
            done0_h = done0.cpu().numpy()  # the admission's one readback, and its barrier
            dt = time.perf_counter() - t0
            if trace:
                dbg_print("DEEPSEEK_DEBUG_SERVE", f"serve.admit g={g} prompt_len={s} {dt * 1e3:.1f} ms")
            for row, slot in enumerate(slot_ids):
                done_np[slot] = bool(done0_h[row])
                lens_np[slot] = s + 1
                admit_t[slot] = time.perf_counter()
                admit_no[slot] = n_admitted
                n_admitted += 1
                prefill_t[slot] = dt

        # Host preprocessing overlaps decode: a worker thread preprocesses
        # and ships the next pending pages (and on the device-resize path
        # resizes them on the card) while the serve thread launches the
        # decode chunks. The worker enqueues on the serve thread's stream, so
        # an admission's kernels run after the page's pixels are complete.
        pre_in_flight: set = set()
        serve_done = False
        pre_ahead = max(2 * b, 8)
        serve_stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        def drop_failed(req: OCRRequest, e: Exception):
            # Fail this request and drop it; retrying would starve the serve
            # thread's wait on it.
            with cv:
                pre_in_flight.discard(req)
                if req in pending:
                    pending.remove(req)
                cv.notify_all()
            req._finish(error=e)

        def prefetch_worker():
            while True:
                with cv:
                    if serve_done:
                        return
                    k = 1 if not slot_req else 4  # cold engine: don't hold the first page behind others
                    targets = [r for r in pending[:pre_ahead] if r.pre is None and r not in pre_in_flight][:k]
                    if not targets:
                        cv.wait(timeout=0.02)
                        continue
                    pre_in_flight.update(targets)
                for t in targets:
                    try:
                        with torch.cuda.stream(serve_stream):  # None (CPU): no stream change
                            out = self._preprocess(t)
                    except Exception as e:  # an unreadable image fails its request only
                        drop_failed(t, e)
                        continue
                    with cv:
                        t.pre = out
                        pre_in_flight.discard(t)
                        cv.notify_all()

        prefetch_thread = threading.Thread(target=prefetch_worker, daemon=True)

        def ensure_preprocessed(reqs: List[OCRRequest]) -> List[OCRRequest]:
            """Preprocess here what the worker has not; failed requests
            resolve with their error and leave the queue."""
            ok = []
            t_pre0 = time.perf_counter()
            n_sync = 0
            for r in reqs:
                with cv:
                    while r in pre_in_flight:  # the worker is on it
                        cv.wait()
                    if r.done():  # the worker failed it
                        continue
                    if r.pre is not None:
                        ok.append(r)
                        continue
                    pre_in_flight.add(r)
                n_sync += 1
                try:
                    out = self._preprocess(r)
                except Exception as e:  # an unreadable image fails its request only
                    drop_failed(r, e)
                    continue
                with cv:
                    r.pre = out
                    pre_in_flight.discard(r)
                    cv.notify_all()
                ok.append(r)
            if trace:
                dbg_print("DEEPSEEK_DEBUG_SERVE", f"serve.preprocess n={len(reqs)} sync={n_sync} "
                          f"{(time.perf_counter() - t_pre0) * 1e3:.1f} ms")
            return ok

        def fail_requests(reqs: List[OCRRequest], err: Exception):
            with cv:
                for r in reqs:
                    if r in pending:
                        pending.remove(r)
            for r in reqs:
                r._finish(error=err)

        def admit_pending():
            """Admit pending pages into free slots in power-of-two groups that
            share (crop grid, prompt). With the decoder idle, admit as soon as
            some pages are ready (after a short grace for the rest) instead
            of waiting for the whole head of the queue; on a sharded LM it
            waits, so that every rank admits the same pages."""
            free = [s for s in range(b) if s not in slot_req]
            while free:
                with cv:
                    take = list(pending[: len(free)])
                if not take:
                    return
                if not slot_req and not sharded:
                    grace = 0.25
                    t_first = None
                    with cv:
                        while True:
                            take = list(pending[: len(free)])
                            if not take:
                                return
                            ready = [r for r in take if r.pre is not None]
                            in_flight = any(r in pre_in_flight or (r.pre is None and not r.done()) for r in take)
                            if ready and t_first is None:
                                t_first = time.perf_counter()
                            if ready and (not in_flight or time.perf_counter() - t_first >= grace):
                                break
                            if not ready and not in_flight:
                                break  # only failures left
                            cv.wait(timeout=0.05)
                    take = ready if ready else ensure_preprocessed(take)
                else:
                    n_take = len(take)
                    take = ensure_preprocessed(take)
                    if len(take) < n_take:
                        continue  # failures left the queue: look again, so that every rank takes the same pages
                if not take:
                    continue  # failures dropped; look again
                key0 = group_key(take[0])
                group = [r for r in take if group_key(r) == key0]
                # A bad prompt or an over-capacity budget fails its request,
                # never the serve loop.
                try:
                    ids, _, _ = tokenize_with_image(pipe.tokenizer, group[0].prompt, cfg, key0[0])
                except Exception as e:
                    fail_requests(group, e)
                    continue
                s0 = len(ids)
                over = [r for r in group if s0 + r.max_new_tokens > tok_cap]
                if over:
                    fail_requests(over, ValueError(
                        f"prompt ({s0} tokens) + max_new_tokens exceeds engine capacity {tok_cap}"))
                    group = [r for r in group if r not in over]
                    if not group:
                        continue
                g = _pow2_at_most(len(group))
                needs = [pages_for(min(s0 + 1 + self.dispatch_tokens, s0 + r.max_new_tokens), page)
                         for r in group[:g]]
                # Halve the group while the pool is tight: one slot always fits.
                while g > 1 and sum(needs[:g]) > alloc.n_free:
                    g //= 2
                group = group[:g]
                need = sum(needs[:g])
                if need > alloc.n_free:
                    if not slot_req:
                        raise RuntimeError(
                            f"KV page pool too small: an admission group needs {need} pages, the pool has "
                            f"{alloc.n_free} free (pool_tokens={self.pool_tokens}, page_size={page})")
                    return  # wait for completions to free pages
                slot_ids = free[:g]
                admit_group(slot_ids, group)
                with cv:
                    for r in group:
                        pending.remove(r)
                free = free[g:]

        def preempt(slot: int):
            """Evict an active slot: free its pages and re-queue its request
            (the deterministic re-decode reproduces its tokens; re-admission
            stages its open page again)."""
            nonlocal n_preempted
            req = slot_req.pop(slot)
            alloc.release(slot_pages.pop(slot))
            block_tables_np[slot] = 0
            for d in (prompt_lens, slot_limits, admit_t, admit_no, prefill_t):
                d.pop(slot)
            done_np[slot] = True
            state.done[slot] = True
            with cv:
                pending.insert(0, req)
                cv.notify_all()
            n_preempted += 1
            self.last_preempted = n_preempted

        def grow_pages():
            """Top every active slot up to the pages the next chunk writes.
            On pool exhaustion, preempt the youngest slot admitted AFTER the
            growing one. Evicting an older slot would let two slots preempt
            each other forever (A grows and evicts B, B is re-admitted, grows
            and evicts A, ...). With strictly younger victims the oldest
            sequence always finishes and the pool drains. A slot that finds
            no younger victim gives its own pages back and waits."""
            for slot in sorted(slot_req, key=lambda s2: admit_no[s2]):
                if slot not in slot_req or done_np[slot]:
                    continue
                needed = pages_for(min(int(lens_np[slot]) + self.dispatch_tokens, slot_limits[slot]), page)
                have = len(slot_pages[slot])
                if needed <= have:
                    continue
                preempted_self = False
                while alloc.n_free < needed - have:
                    victims = [s2 for s2 in slot_req
                               if s2 != slot and not done_np[s2] and admit_no[s2] > admit_no[slot]]
                    if victims:
                        preempt(max(victims, key=lambda s2: admit_no[s2]))
                        continue
                    if not any(s2 != slot and not done_np[s2] for s2 in slot_req):
                        raise RuntimeError("KV page pool exhausted with one active slot; "
                                           "pool_tokens is below a single sequence's budget")
                    preempt(slot)
                    preempted_self = True
                    break
                if preempted_self:
                    continue
                extra = alloc.allocate(needed - have)
                slot_pages[slot].extend(extra)
                block_tables_np[slot, have:needed] = extra

        def gather_rows(slots: List[int]) -> np.ndarray:
            """One row-gather and one transfer for several slots' tokens."""
            idx = torch.tensor(slots, dtype=torch.long, device=dev)
            return state.tokens.index_select(0, idx).cpu().numpy()

        def emit_stream():
            """Push newly generated ids to streaming requests; the
            per-request mark makes emission preemption-safe."""
            rows = [s for s in slot_req
                    if slot_req[s].stream and int(lens_np[s]) - prompt_lens[s] > slot_req[s]._n_streamed]
            if not rows:
                return
            toks_h = gather_rows(rows)
            for i, s in enumerate(rows):
                req = slot_req[s]
                new_ids = toks_h[i, prompt_lens[s] + req._n_streamed : int(lens_np[s])].tolist()
                req._n_streamed += len(new_ids)
                req._stream_q.put(new_ids)

        def harvest():
            """Finalize finished slots, free their pages, resolve futures."""
            now = time.perf_counter()
            fin = [slot for slot in list(slot_req) if done_np[slot]]
            if not fin:
                return
            toks_h = gather_rows(fin)
            for row, slot in enumerate(fin):
                req = slot_req.pop(slot)
                all_ids = toks_h[row, : int(lens_np[slot])].tolist()
                p_len = prompt_lens.pop(slot)
                slot_limits.pop(slot)
                admit_no.pop(slot)
                gen_ids = all_ids[p_len:]
                alloc.release(slot_pages.pop(slot))
                block_tables_np[slot] = 0
                if req.stream and len(gen_ids) > req._n_streamed:
                    req._stream_q.put(gen_ids[req._n_streamed :])
                    req._n_streamed = len(gen_ids)
                req._finish(result=GenerationResult(
                    text=decode_output(pipe.tokenizer, gen_ids, cfg.stop_string),
                    token_ids=all_ids,
                    prompt_len=p_len,
                    prefill_seconds=prefill_t.pop(slot),
                    decode_seconds=now - admit_t.pop(slot),
                    new_tokens=len(gen_ids),
                ))

        def has_work():
            with cv:
                return bool(pending) or bool(slot_req)

        def should_run():
            if slot_req:
                return True
            with cv:
                if pending:
                    return True
                return online and not self._stop

        prefetch_thread.start()
        try:
            while should_run():
                if online and not has_work():
                    with cv:  # idle: block until a submission (or stop) arrives
                        if not pending and not self._stop:
                            cv.wait(timeout=0.05)
                    continue
                # Live slots get pages first; admission takes what is left.
                t_it0 = time.perf_counter()
                grow_pages()
                admit_pending()
                t_it1 = time.perf_counter()
                did_decode = bool(slot_req) and not all(done_np[s] for s in slot_req)
                if did_decode:
                    bt_dev = torch.from_numpy(block_tables_np).to(dev)
                    if use_lookup:
                        status = decode_chunk_lookup(
                            lm, lm_cfg, cache, state, bt_dev, n_steps=self.lookup_steps, chunk=self.lookup_chunk,
                            match_n=self.lookup_match_n, ngram_size=ngram_size, eos_id=eos, rope=pipe.rope,
                        )
                    else:
                        status = decode_chunk(
                            lm, lm_cfg, cache, state, bt_dev,
                            n_steps=self.chunk_steps, ngram_size=ngram_size, eos_id=eos, rope=pipe.rope, **samp,
                        )
                    status_h = status.cpu().numpy()  # the chunk's one readback
                    self.last_decode_steps += self.lookup_steps if use_lookup else self.chunk_steps
                    self.last_decode_seconds += time.perf_counter() - t_it1
                    lens_np[:] = status_h[:b]
                    done_np[:] = status_h[b : 2 * b].astype(bool)
                    if use_lookup:
                        self.last_lookup_forwards += int(status_h[2 * b])
                    emit_stream()
                t_it2 = time.perf_counter()
                harvest()
                if trace:
                    n_act = sum(1 for s2 in slot_req if not done_np[s2])
                    dbg_print("DEEPSEEK_DEBUG_SERVE",
                              f"serve.iter grow+admit={(t_it1 - t_it0) * 1e3:.1f} ms "
                              f"decode={(t_it2 - t_it1) * 1e3:.1f} ms{'' if did_decode else ' (skipped)'} "
                              f"harvest={(time.perf_counter() - t_it2) * 1e3:.1f} ms active={n_act}")
        finally:
            with cv:
                serve_done = True
                cv.notify_all()
            prefetch_thread.join(timeout=10.0)
            # Resolve anything left (stop() with work queued, or the loop
            # died): futures must never hang.
            with cv:
                leftovers = list(pending)
                pending.clear()
            leftovers.extend(slot_req.values())
            for r in leftovers:
                if not r.done():
                    r._finish(error=RuntimeError("engine stopped"))
        self.last_preempted = n_preempted
