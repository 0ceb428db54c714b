"""The port's decode loops as `runtime/decode_graph.py` runs them, on the
CPU at tiny widths, against the JAX package on the same numpy-seeded
weights and inputs.

On the CPU the runner calls the very step callable that the card captures
into a CUDA graph, through the same loop logic: the host reads the done
flags every SYNC_EVERY steps (1), never runs more steps than the budget,
and the lookup loops count their forwards on the device. Held here:
- `decode_loop`'s readbacks and budget, on a counting step;
- `lm_forward` at an int position and at a device position (a 0-d tensor
  shared by the rows, and per-row [B]) gives equal bits: the plain "pool"
  attention, kernel U's twin (stacked), and K's and O's twins (int8 and
  int4 attention weights);
- `greedy_generate`: tokens and n_generated equal the JAX package's in
  f32 (also under DEEPSEEK_DECODE_ATTN=stacked), in bf16, sampled (top-k
  and top-p), and with --int8 and --int4 weights at batch 1 (K and O at a
  tensor position); in the f32 case the rows stop on EOS at different
  steps, all before the first readback of a loop that reads back every 8
  steps, so steps run after every row is done;
- `lookup_greedy_generate_batched`: tokens, n_generated and the forwards
  (`return_steps`, counted on the device) equal the JAX package's, rows
  stopping at different forwards;
- `decode_chunk` and `decode_chunk_lookup` on f32 and int8tail pools:
  tokens and the packed status equal the JAX package's over two chunks,
  rows stopping at their limits mid-chunk and an empty slot frozen;
- the static buffers a captured decode reuses give a later call the tokens
  of a fresh one, serve prompts of every length at their capacity, are
  dropped for another key's when idle, and go when their params are freed.
The captures themselves (replay against eager, one capture a key, launch
counts) need the card: tests/test_torch_decode_graph_gpu.py.
Tokens are compared exactly.
"""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.configs import tiny_lm_config
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
from deepseek_ocr2_tpu.runtime import continuous as jcont
from deepseek_ocr2_tpu.runtime import generate as jgen
from deepseek_ocr2_tpu.runtime import paged_kv as jpaged
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.runtime import continuous as tcont
from deepseek_ocr2_tpu_torch.runtime import decode_graph
from deepseek_ocr2_tpu_torch.runtime import generate as tgen
from deepseek_ocr2_tpu_torch.runtime import paged_kv as tpaged
from deepseek_ocr2_tpu_torch.runtime.kv_cache import make_kv_cache

from reference_torch import random_lm_flat


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).long()


@pytest.fixture(scope="module")
def lm():
    cfg = tiny_lm_config(num_hidden_layers=2)  # a dense and a MoE layer
    flat = random_lm_flat(cfg, seed=9)
    jp, _ = jdsv2.params_from_flat(flat, cfg)
    tp, _ = tdsv2.params_from_flat(flat, cfg)
    return cfg, jax.tree_util.tree_map(jnp.asarray, jp), tp


@pytest.fixture(scope="module")
def quantized():
    """bits -> (cfg, JAX params, port params): scope "full", quantized once
    by the JAX package and carried over (I = 128 for int4's groups)."""
    cfg = tiny_lm_config(num_hidden_layers=2, moe_intermediate_size=128)
    jp, _ = jdsv2.params_from_flat(random_lm_flat(cfg, seed=11), cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    out = {}
    for bits in (8, 4):
        jq = jax.jit(functools.partial(jdsv2.quantize_lm_params, scope="full", bits=bits))(jp)
        out[bits] = cfg, jq, tdsv2.params_from_jax(jq, cfg)
    return out


# ---------------------------------------------------------------------------
# The loop logic and the position forms


def test_decode_loop_reads_back_every_sync_every_and_keeps_the_budget(monkeypatch):
    """The loop runs SYNC_EVERY steps between two readbacks (1, and the
    rule at 8) and never more steps than its budget."""
    for every, budget, live_for, want_runs, want_reads in (
            (8, 19, 99, [8, 8, 3], 3), (8, 19, 3, [8], 2), (8, 0, 99, [], 0), (8, 5, 0, [], 1),
            (1, 7, 99, [1] * 7, 7), (1, 7, 3, [1] * 3, 4), (1, 0, 99, [], 0), (1, 5, 0, [], 1)):
        monkeypatch.setattr(decode_graph, "SYNC_EVERY", every)
        runs, reads, steps = [], [0], [0]

        def run(n):
            runs.append(n)
            steps[0] += n

        def alive():
            reads[0] += 1
            return steps[0] < live_for

        decode_graph.decode_loop(run, budget, alive)
        assert runs == want_runs and reads[0] == want_reads, (every, budget, live_for, runs, reads)


@pytest.mark.parametrize("form", ["pool", "stacked", "int8", "int4"])
def test_int_and_tensor_positions_give_equal_bits(lm, quantized, form, monkeypatch):
    """A decode step after a 9-token prefill of 2 rows at the int position 9,
    at a 0-d tensor and at [9, 9]: the hidden states and the caches equal."""
    if form in ("int8", "int4"):
        cfg, _, tp = quantized[8 if form == "int8" else 4]
    else:
        cfg, _, tp = lm
    if form == "stacked":
        monkeypatch.setenv("DEEPSEEK_DECODE_ATTN", "stacked")
    rng = np.random.default_rng(4)
    emb = torch.nn.functional.embedding(_t(rng.integers(2, cfg.vocab_size, (2, 10))), tp["embed"])
    cache = make_kv_cache(cfg.num_hidden_layers, 2, cfg.num_attention_heads, 32, cfg.head_dim, dtype=torch.float32)
    tdsv2.lm_forward(tp, cfg, emb[:, :9], cache, pos=0, is_prefill=True)
    outs = []
    for pos in (9, torch.tensor(9), torch.tensor([9, 9])):
        c = {k: v.clone() for k, v in cache.items()}
        outs.append((tdsv2.lm_forward(tp, cfg, emb[:, 9:], c, pos=pos, is_prefill=False), c))
    for hidden, c in outs[1:]:
        assert torch.equal(hidden, outs[0][0])
        assert all(torch.equal(c[k], outs[0][1][k]) for k in c)


# ---------------------------------------------------------------------------
# greedy_generate and lookup_greedy_generate_batched


def _check_rows(tt, tn, jt, jn, s: int) -> None:
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for r in range(tt.shape[0]):
        n = int(tn[r])
        np.testing.assert_array_equal(tt[r, : s + n].numpy(), np.asarray(jt)[r, : s + n], err_msg=f"row {r}")


def _greedy_both(cfg, jp, tp, ids, kv=("float32", torch.float32), **kw):
    kw = {"capacity": 64, "max_new_tokens": 16, "ngram_size": 3, **kw}
    jt, jn = jgen.greedy_generate(jp, cfg, jnp.take(jp["embed"], jnp.asarray(ids), axis=0),
                                  jnp.asarray(ids, jnp.int32), kv_dtype=kv[0], **kw)
    tt, tn = tgen.greedy_generate(tp, cfg, tp["embed"][_t(ids)], _t(ids), kv_dtype=kv[1], **kw)
    _check_rows(tt, tn, jt, jn, ids.shape[1])
    return tt, tn


def test_greedy_generate_rows_stop_at_different_steps(lm, monkeypatch):
    """3 rows (one prompt, each row with its own first token) and an EOS
    that each row reaches at its own step, all within the first 8 steps of
    15, read back every 8 steps (SYNC_EVERY's rule at 8): the steps after
    the last stop run on frozen rows, as a chunk of the continuous engine
    runs them, and change nothing. The same under
    DEEPSEEK_DECODE_ATTN=stacked. (The seed is the first whose greedy
    tokens give such an EOS.)"""
    cfg, jp, tp = lm
    every = 8
    monkeypatch.setattr(decode_graph, "SYNC_EVERY", every)
    eos = None
    for seed in range(50):
        rng = np.random.default_rng(seed)
        ids = np.repeat(rng.integers(2, cfg.vocab_size, (1, 10)), 3, axis=0)
        ids[:, 0] = rng.integers(2, cfg.vocab_size, 3)
        probe, _ = tgen.greedy_generate(tp, cfg, tp["embed"][_t(ids)], _t(ids), max_new_tokens=16, ngram_size=3,
                                        eos_id=-1, capacity=64, kv_dtype=torch.float32)
        gen = [row[: every - 1] for row in probe[:, 10:].tolist()]
        for t in sorted({t for row in gen for t in row}):
            first = [row.index(t) if t in row else every for row in gen]
            if max(first) < every - 1 and len(set(first)) > 1:
                eos = t
                break
        if eos is not None:
            break
    _, tn = _greedy_both(cfg, jp, tp, ids, eos_id=eos)
    assert int(tn.max()) < every and len(set(tn.tolist())) > 1, tn
    monkeypatch.setenv("DEEPSEEK_DECODE_ATTN", "stacked")
    _, tn_stacked = _greedy_both(cfg, jp, tp, ids, eos_id=eos)
    assert torch.equal(tn, tn_stacked)


@pytest.mark.parametrize("case", ["bf16", "sampled"])
def test_greedy_generate_bf16_and_sampled_match_jax(lm, case):
    cfg, jp, tp = lm
    ids = np.random.default_rng(6).integers(2, cfg.vocab_size, (2, 10))
    if case == "bf16":
        jb = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
        _greedy_both(cfg, jb, tdsv2.params_from_jax(jb, cfg), ids, kv=("bfloat16", torch.bfloat16), eos_id=1)
    else:
        _greedy_both(cfg, jp, tp, ids, eos_id=1, temperature=0.8, top_k=6, top_p=0.9, seed=3)


@pytest.mark.parametrize("bits", [8, 4])
def test_greedy_generate_quantized_matches_jax(quantized, bits):
    """--int8 / --int4 weights at batch 1: every decode step's attention
    takes K's / O's twin at a tensor position."""
    cfg, jq, tq = quantized[bits]
    ids = np.random.default_rng(7 + bits).integers(2, cfg.vocab_size, (1, 10))
    _greedy_both(cfg, jq, tq, ids, eos_id=1)


def test_lookup_batched_matches_jax_with_forwards(lm):
    """3 rows (one repetitive prompt, so its drafts accept), EOS a token
    that row 0 reaches early: tokens, n_generated and the forwards the
    device counted equal the JAX package's."""
    cfg, jp, tp = lm
    rng = np.random.default_rng(8)
    ids = rng.integers(2, cfg.vocab_size, (3, 10))
    ids[1] = np.tile(ids[1, :4], 3)[:10]
    probe, _ = tgen.greedy_generate(tp, cfg, tp["embed"][_t(ids)], _t(ids), max_new_tokens=20, ngram_size=3,
                                    eos_id=-1, capacity=64, kv_dtype=torch.float32)
    kw = dict(max_new_tokens=20, ngram_size=3, eos_id=int(probe[0, 15]), capacity=64, chunk=4, return_steps=True)
    jt, jn, js = jgen.lookup_greedy_generate_batched(jp, cfg, jnp.take(jp["embed"], jnp.asarray(ids), axis=0),
                                                     jnp.asarray(ids, jnp.int32), kv_dtype="float32", **kw)
    tt, tn, ts = tgen.lookup_greedy_generate_batched(tp, cfg, tp["embed"][_t(ids)], _t(ids),
                                                     kv_dtype=torch.float32, **kw)
    _check_rows(tt, tn, jt, jn, 10)
    assert ts == int(np.asarray(js)) and len(set(tn.tolist())) > 1, (ts, js, tn)


# ---------------------------------------------------------------------------
# The continuous engine's chunks


def _chunk_state(cfg, kv: str):
    """Both packages' pools and decode state: 4 slots of 8-token pages,
    prompts of 13, 13 and 5 tokens (random K/V) with their tokens, limits
    that stop slots 1 and 2 inside the first chunk and at its end, slot 3
    empty (done, on the scratch page)."""
    b, page, n_pool, max_pages, tok_cap = 4, 8, 24, 5, 40
    l, hh, d = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    rng = np.random.default_rng(12)
    jkind = {"float32": jnp.float32}.get(kv, kv)
    tkind = {"float32": torch.float32}.get(kv, kv)
    jpool = jpaged.make_paged_kv_cache(l, n_pool, hh, page, d, jkind, slots=b)
    tpool = tpaged.make_paged_kv_cache(l, n_pool, hh, page, d, tkind, slots=b)
    tables = np.zeros((b, max_pages), np.int32)
    tokens = np.zeros((b, tok_cap), np.int32)
    lens = np.array([14, 14, 6, 0], np.int32)
    for rows, plen, pages in (([0, 1], 13, [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]]), ([2], 5, [[11, 12, 13, 14, 15]])):
        n_prompt = tpaged.pages_for(plen, page)
        k_new, v_new = (rng.standard_normal((l, len(rows), hh, n_prompt * page, d)).astype(np.float32)
                        for _ in range(2))
        k_new[:, :, :, plen:] = 0
        v_new[:, :, :, plen:] = 0
        pid = np.array([p[:n_prompt] for p in pages], np.int32)
        jpool = jpaged.write_prompt_pool_batched(jpool, jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(pid),
                                                 plen, slot_ids=jnp.asarray(rows, jnp.int32))
        tpaged.write_prompt_pool_batched(tpool, torch.from_numpy(k_new), torch.from_numpy(v_new),
                                         torch.from_numpy(pid), plen, slot_ids=torch.tensor(rows))
        for r, p in zip(rows, pages):
            tables[r] = p
            tokens[r, : plen + 1] = rng.integers(2, cfg.vocab_size, plen + 1)
    tokens[1, :14] = np.tile(tokens[1, :4], 4)[:14]  # a repetitive row: its lookup drafts accept
    limits = np.array([38, 17, 6 + 8, 0], np.int32)
    done = np.array([False, False, False, True])
    jstate = dict(tokens=jnp.asarray(tokens), cur_lens=jnp.asarray(lens), done=jnp.asarray(done),
                  limits=jnp.asarray(limits))
    tstate = tcont.DecodeState.empty(b, tok_cap, "cpu")
    tstate.tokens.copy_(torch.from_numpy(tokens))
    tstate.cur_lens.copy_(torch.from_numpy(lens))
    tstate.done.copy_(torch.from_numpy(done))
    tstate.limits.copy_(torch.from_numpy(limits))
    return jpool, jstate, tpool, tstate, tables


@pytest.mark.parametrize("lookup", [False, True], ids=["decode_chunk", "decode_chunk_lookup"])
@pytest.mark.parametrize("kv", ["float32", "int8tail"])
def test_chunks_match_jax(lm, kv, lookup):
    cfg, jp, tp = lm
    jpool, js, tpool, ts, tables = _chunk_state(cfg, kv)
    rope = tdsv2.rope_consts(cfg, "cpu")
    kw = dict(n_steps=3, chunk=3, match_n=2) if lookup else dict(n_steps=6)
    kw.update(ngram_size=3, eos_id=1)
    for _ in range(2):
        if lookup:
            jpool, jtok, jlen, jdone, jstatus = jcont.decode_chunk_lookup(
                jp, jpool, js["tokens"], js["cur_lens"], js["done"], js["limits"], jnp.asarray(tables), cfg, **kw)
            tstatus = tcont.decode_chunk_lookup(tp, cfg, tpool, ts, torch.from_numpy(tables), rope=rope, **kw)
        else:
            seeds = jnp.zeros(4, jnp.int32)
            jpool, jtok, jlen, jdone, jstatus = jcont.decode_chunk(
                jp, jpool, js["tokens"], js["cur_lens"], js["done"], js["limits"], jnp.asarray(tables), seeds, cfg,
                **kw)
            tstatus = tcont.decode_chunk(tp, cfg, tpool, ts, torch.from_numpy(tables), rope=rope, **kw)
        js.update(tokens=jtok, cur_lens=jlen, done=jdone)
        np.testing.assert_array_equal(tstatus.numpy(), np.asarray(jstatus))
        np.testing.assert_array_equal(ts.tokens.numpy(), np.asarray(jtok))
    lens, done = np.asarray(jlen), np.asarray(jdone)
    assert lens[1] == 17 and lens[3] == 0 and done[1] and not done[0], (lens, done)


# ---------------------------------------------------------------------------
# The static buffers of a captured decode


def _static_runner(monkeypatch):
    """A runner of its own whose decodes take its static buffers, with
    every step called (the CPU has no graphs)."""
    runner = decode_graph.DecodeGraphs()
    monkeypatch.setattr(decode_graph, "RUNNER", runner)
    monkeypatch.setattr(decode_graph, "graphed", lambda device, params: True)
    steps = runner.steps
    monkeypatch.setattr(runner, "steps", lambda *a: steps(*a[:-1], False))
    return runner


def test_static_buffers_give_fresh_results_and_go_with_their_params(lm, monkeypatch):
    """The captured path's buffers (a cache and a state a key, reused and
    reset by every call), with each step called: a call after another at
    the same key gives the tokens of a fresh call; the set is dropped when
    the params it was keyed on are freed."""
    cfg, _, tp = lm
    runner = _static_runner(monkeypatch)
    rng = np.random.default_rng(13)
    a, b = (rng.integers(2, cfg.vocab_size, (2, 10)) for _ in range(2))
    kw = dict(max_new_tokens=12, ngram_size=3, eos_id=1, capacity=64, kv_dtype=torch.float32)
    params = {**tp, "norm": tp["norm"].clone()}
    got = [tgen.greedy_generate(params, cfg, tp["embed"][_t(x)], _t(x), **kw) for x in (a, b, a)]
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "graphed", lambda device, params: False)
        fresh = tgen.greedy_generate(params, cfg, tp["embed"][_t(a)], _t(a), **kw)
    assert len(runner._buffers) == 1  # the cache and the state of the shape, one set
    for g in (got[0], got[2]):
        assert torch.equal(g[0], fresh[0]) and torch.equal(g[1], fresh[1])
    params["norm"] = tp["norm"]  # a leaf the buffers were keyed on is freed
    gc.collect()
    assert len(runner._buffers) == 0


def test_static_buffers_keep_one_idle_set_and_serve_every_prompt_length(lm, monkeypatch):
    """Prompts of 10 and 7 tokens at one capacity share a set, each call
    giving the JAX package's tokens (the lookup loop's forwards too, its
    draft slices clamped at the call's own length, not the buffer's); a
    decode of another capacity drops the idle set before it makes its own,
    and a set in use stays."""
    cfg, jp, tp = lm
    runner = _static_runner(monkeypatch)
    rng = np.random.default_rng(14)
    ids10, ids7 = rng.integers(2, cfg.vocab_size, (2, 10)), rng.integers(2, cfg.vocab_size, (2, 7))
    ids7[1] = np.tile(ids7[1, :3], 3)[:7]  # a repetitive row: its drafts accept
    _greedy_both(cfg, jp, tp, ids10, eos_id=1)
    (key, held), = runner._buffers.items()
    _greedy_both(cfg, jp, tp, ids7, eos_id=1)
    kw = dict(max_new_tokens=16, ngram_size=3, eos_id=1, capacity=64, chunk=3, return_steps=True)
    jt, jn, js = jgen.lookup_greedy_generate_batched(jp, cfg, jnp.take(jp["embed"], jnp.asarray(ids7), axis=0),
                                                     jnp.asarray(ids7, jnp.int32), kv_dtype="float32", **kw)
    tt, tn, ts = tgen.lookup_greedy_generate_batched(tp, cfg, tp["embed"][_t(ids7)], _t(ids7),
                                                     kv_dtype=torch.float32, **kw)
    _check_rows(tt, tn, jt, jn, 7)
    assert ts == int(np.asarray(js)), (ts, js)
    assert list(runner._buffers.items()) == [(key, held)]
    with runner.buffers(key[0], tp, None, True):  # the capacity-64 set in use
        _greedy_both(cfg, jp, tp, ids10, eos_id=1, capacity=96)
        assert len(runner._buffers) == 2
    _greedy_both(cfg, jp, tp, ids7, eos_id=1, capacity=80)
    (key80, _), = runner._buffers.items()
    assert key80[0][2] == 80
