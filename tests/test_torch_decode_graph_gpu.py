"""The port's captured decode on the card (`runtime/decode_graph.py`): each
decode loop replays its CUDA graphs to the bits of the same loop with every
step called eagerly (`decode_graph._eager`), captures once a key, and keeps
the kernels' launch counts equal to the eager loop's. A small LM whose
widths the kernels take (head dim 128, H = 256, I = 128): kernels F (5
rows, 5 x 2 > 8 experts), K and O, H and L, I and M (batch 1), U
(stacked), G, P, Q and R (the pools). Every test needs a CUDA device and
skips without one; the CPU side of these loops is held to the JAX package
in tests/test_torch_decode_graph.py. Run on the card:
`python -m pytest -q -m gpu tests/test_torch_decode_graph_gpu.py`.
"""

import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu_torch.configs import tiny_lm_config
from deepseek_ocr2_tpu_torch.io import DtypePolicy
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.runtime import continuous as tcont
from deepseek_ocr2_tpu_torch.runtime import decode_graph
from deepseek_ocr2_tpu_torch.runtime import generate as tgen
from deepseek_ocr2_tpu_torch.runtime import paged_kv as tpaged

from reference_torch import random_lm_flat


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs and kernels have no CPU mode)")
    import deepseek_ocr2_tpu_torch  # noqa: F401  (f32 numerics flags)

    monkeypatch.setattr(decode_graph, "RUNNER", decode_graph.DecodeGraphs())  # this test's graphs only
    return torch.device("cuda")


def _lm(cuda, tier: str = "f32"):
    cfg = tiny_lm_config(num_hidden_layers=2, hidden_size=256, num_attention_heads=2, num_key_value_heads=2,
                         intermediate_size=512, moe_intermediate_size=128, vocab_size=1024,
                         max_position_embeddings=512)
    policy = DtypePolicy(default="bfloat16" if tier == "bf16" else None)
    tp, _ = tdsv2.params_from_flat(random_lm_flat(cfg, seed=3), cfg, device=cuda, policy=policy)
    if tier in ("int8", "int4"):
        tp = tdsv2.quantize_lm_params(tp, scope="full", bits=8 if tier == "int8" else 4)
    return cfg, tp


def _launches() -> dict:
    return {fn.__name__: fn.launches for fn in decode_graph.counted_wrappers()}


def _counted(fn):
    before = _launches()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: n - before[k] for k, n in _launches().items() if n != before[k]}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f32", "stacked", "sampled", "bf16", "int8", "int4"])
def test_cuda_greedy_replay_equals_eager(cuda, case, monkeypatch):
    """greedy_generate captured against eager: tokens, n_generated and
    every step's logits bit for bit, the same launches; a second call at
    the key replays without a capture."""
    cfg, tp = _lm(cuda, {"stacked": "f32", "sampled": "f32"}.get(case, case))
    if case == "stacked":
        monkeypatch.setenv("DEEPSEEK_DECODE_ATTN", "stacked")
    b = 1 if case in ("int8", "int4") else 5
    ids = torch.from_numpy(np.random.default_rng(1).integers(2, cfg.vocab_size, (b, 12))).to(cuda)
    emb = torch.nn.functional.embedding(ids, tp["embed"])  # in the LM's dtype
    kw = dict(max_new_tokens=20, ngram_size=3, eos_id=1, capacity=64,
              kv_dtype=torch.bfloat16 if case == "bf16" else torch.float32)
    if case == "sampled":
        kw.update(temperature=0.8, top_k=8, top_p=0.9, seed=5)

    def gen(stats):
        return tgen.greedy_generate(tp, cfg, emb, ids, stats=stats, keep_logits=True, **kw)

    se, sc = {}, {}
    with decode_graph._eager():
        (te, ne), le = _counted(lambda: gen(se))
    (tc, nc), lc = _counted(lambda: gen(sc))
    assert torch.equal(te, tc) and torch.equal(ne, nc)
    assert len(se["logits"]) == len(sc["logits"]) and all(torch.equal(a, c) for a, c in zip(se["logits"], sc["logits"]))
    assert le == lc, (le, lc)
    (t2, n2), l2 = _counted(lambda: tgen.greedy_generate(tp, cfg, emb, ids, **kw))
    assert torch.equal(t2, tc) and torch.equal(n2, nc) and l2 == lc
    runner = decode_graph.RUNNER
    assert len(runner.log) == 1 and set(runner.captures.values()) == {1}
    assert runner.report()[0]["replays"] > 0


@pytest.mark.gpu
def test_cuda_lookup_replay_equals_eager(cuda):
    cfg, tp = _lm(cuda)
    rng = np.random.default_rng(2)
    ids = rng.integers(2, cfg.vocab_size, (3, 12))
    ids[1] = np.tile(ids[1, :4], 3)  # a repetitive row: its drafts accept
    ids = torch.from_numpy(ids).to(cuda)
    emb = torch.nn.functional.embedding(ids, tp["embed"])
    kw = dict(max_new_tokens=24, ngram_size=3, eos_id=1, capacity=64, kv_dtype=torch.float32, chunk=4,
              return_steps=True)
    with decode_graph._eager():
        eager, le = _counted(lambda: tgen.lookup_greedy_generate_batched(tp, cfg, emb, ids, **kw))
    for _ in range(2):
        got, lc = _counted(lambda: tgen.lookup_greedy_generate_batched(tp, cfg, emb, ids, **kw))
        assert torch.equal(got[0], eager[0]) and torch.equal(got[1], eager[1]) and got[2] == eager[2]
        assert lc == le, (le, lc)
    assert len(decode_graph.RUNNER.log) == 1


def _pool_and_state(cfg, kv, cuda):
    """4 slots over 16-token pages: random prompt K/V and tokens at lengths
    (40, 33, 17), limits that stop slot 1 inside the first chunk, slot 3
    empty."""
    b, page, max_pages, tok_cap = 4, 16, 5, 80
    g = torch.Generator(device=cuda).manual_seed(7)
    pool = tpaged.make_paged_kv_cache(cfg.num_hidden_layers, b * max_pages + 1, cfg.num_attention_heads, page,
                                      cfg.head_dim, dtype=kv, device=cuda, slots=b)
    n_prompt = tpaged.pages_for(40, page)
    shape = (cfg.num_hidden_layers, 3, cfg.num_attention_heads, n_prompt * page, cfg.head_dim)
    k_new, v_new = (torch.randn(shape, generator=g, device=cuda) for _ in range(2))
    tables = torch.arange(1, b * max_pages + 1, dtype=torch.int32, device=cuda).reshape(b, max_pages)
    tpaged.write_prompt_pool_batched(pool, k_new, v_new, tables[:3, :n_prompt].contiguous(), 40,
                                     slot_ids=torch.arange(3, device=cuda))
    state = tcont.DecodeState.empty(b, tok_cap, cuda)
    state.tokens.random_(2, cfg.vocab_size, generator=g)
    state.cur_lens.copy_(torch.tensor([40, 33, 17, 0], dtype=torch.int32))
    state.done.copy_(torch.tensor([False, False, False, True]))
    state.limits.copy_(torch.tensor([78, 36, 60, 0], dtype=torch.int32))
    state.seeds.copy_(torch.arange(b))
    return pool, state, tables


@pytest.mark.gpu
@pytest.mark.parametrize("lookup", [False, True], ids=["decode_chunk", "decode_chunk_lookup"])
@pytest.mark.parametrize("kv", [torch.float32, "int8tail"], ids=["f32", "int8tail"])
def test_cuda_chunks_replay_equal_eager(cuda, kv, lookup):
    """Two chunks of the continuous engine, eager and captured from equal
    pools and states: equal status, tokens and pool bits, the same
    launches, one capture."""
    cfg, tp = _lm(cuda)
    rope = tdsv2.rope_consts(cfg, cuda)
    kw = dict(ngram_size=3, eos_id=1, rope=rope)
    kw.update(dict(n_steps=3, chunk=4, match_n=2) if lookup else dict(n_steps=8))
    fn = tcont.decode_chunk_lookup if lookup else tcont.decode_chunk
    sides = []
    for eager in (True, False):
        pool, state, tables = _pool_and_state(cfg, kv, cuda)
        statuses, launches = [], {}
        for _ in range(2):
            if eager:
                with decode_graph._eager():
                    status, d = _counted(lambda: fn(tp, cfg, pool, state, tables, **kw).clone())
            else:
                status, d = _counted(lambda: fn(tp, cfg, pool, state, tables, **kw).clone())
            statuses.append(status)
            launches = {k: launches.get(k, 0) + d.get(k, 0) for k in {*launches, *d}}
        sides.append((statuses, state, pool, launches))
    (se, ste, pe, le), (sc, stc, pc, lc) = sides
    assert all(torch.equal(a, c) for a, c in zip(se, sc))
    assert torch.equal(ste.tokens, stc.tokens) and all(torch.equal(pe[k], pc[k]) for k in pe)
    assert le == lc, (le, lc)
    assert int(sc[-1][1]) == 36 and len(decode_graph.RUNNER.log) == 1
