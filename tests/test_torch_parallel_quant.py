"""The port's quantized LM under a (dp, mp) mesh against the JAX package on
the CPU: `lm_param_specs_q8`, int8 and int4 greedy decode in both scopes
(the JAX package's tests/test_sharding_q8.py and test_sharding_q4.py, and
its dryrun's steps 5 and 6b), and the decode MoE kernels' twins on one
rank's experts.

The port's cases run in one 8-rank gloo world on 127.0.0.1 started once for
the module (`launch.launch(runs.run_cases, ...)`: no rank imports JAX); the
JAX side runs unsharded in this process (its CPU paths: the experts
dequantized, the shared MLP as its own stream). The JAX package's own tests
hold its sharded decode token-exact to its unsharded decode, so the port's
sharded tokens are held to the JAX package's unsharded ones.

- Greedy tokens and `n_gen` equal the JAX package's: int8 and int4, scopes
  "experts" and "full", at (4, 2); int8 "full" at (2, 4) and at (1, 4)
  with one row (latency mode). Each run's prefill logits (every rank's
  rows gathered) within 1e-5 of the largest of the port's unsharded ones,
  on the same params (f32 partials summed in another order).
- An int4 linear split on its output rows, gathered, is bit-equal to the
  unsharded product (decode and prefill forms), and so is an int4 SwiGLU
  MLP; an int8 linear split on its contraction is within f32 rounding.
- One MoE layer's decode FFN at (1, 2), int8 and int4 "full", at 1 row
  (the per-selection kernels) and 8 rows (the distinct-expert ones):
  within 1e-5 of the unsharded FFN whose shared MLP runs as its own
  stream, which it would miss by the shared MLP's size if each rank folded
  the pseudo-experts in.
- The specs mirror the quantized tree; a shard / gather round trip is bit
  for bit; an mp that does not divide a split dimension is refused naming
  it, by `check_mp` before any weight is read and by `shard_params`.
- Kernels I, J, M and N's twins on `local_routing` ids with f32 out: each
  rank's partial sums to the whole, a batch with no local selection gives
  exact zeros.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

sys.path.insert(0, str(Path(__file__).resolve().parent))

from deepseek_ocr2_tpu.configs import tiny_lm_config  # noqa: E402
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2  # noqa: E402
from deepseek_ocr2_tpu.runtime.generate import greedy_generate as jax_greedy  # noqa: E402
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2  # noqa: E402
from deepseek_ocr2_tpu_torch.ops import moe_decode, moe_q4, moe_q8  # noqa: E402
from deepseek_ocr2_tpu_torch.ops.linear_q4 import quantize_linear_q4  # noqa: E402
from deepseek_ocr2_tpu_torch.ops.linear_q8 import qmm, quantize_linear, swiglu_q8  # noqa: E402
from deepseek_ocr2_tpu_torch.ops.moe import local_routing, route  # noqa: E402
from deepseek_ocr2_tpu_torch.parallel import sharding  # noqa: E402
from deepseek_ocr2_tpu_torch.parallel.launch import launch  # noqa: E402
from deepseek_ocr2_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from deepseek_ocr2_tpu_torch.parallel.runs import run_cases  # noqa: E402
from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate  # noqa: E402
from deepseek_ocr2_tpu_torch.runtime.train import param_items  # noqa: E402

LOGITS_RTOL = 1e-5
FFN_RTOL = 1e-5
GEN = dict(max_new_tokens=6, ngram_size=3, eos_id=1, capacity=32)
# (scope, bits) -> the JAX tests' PRNG key and ids seed.
TIERS = {("experts", 8): 0, ("full", 8): 0, ("experts", 4): 3, ("full", 4): 3}
MESHES = {"4x2": (4, 2), "2x4": (2, 4), "1x4": (1, 4)}


def _tier(scope, bits):
    """(JAX quantized params, the port's copy, ids [4, 12]) of the JAX
    tests' tiny LM."""
    cfg = tiny_lm_config()
    seed = TIERS[(scope, bits)]
    jp = jdsv2.quantize_lm_params(jdsv2.init_params(cfg, jax.random.PRNGKey(seed), dtype=jnp.float32),
                                  scope=scope, bits=bits)
    ids = np.random.default_rng(seed).integers(2, cfg.vocab_size, (4, 12))
    return jp, tdsv2.params_from_jax(jp, cfg), ids


def _cases(cfg):
    cases, inputs = [], {}
    for (scope, bits) in TIERS:
        jp, tp, ids = _tier(scope, bits)
        inputs[(scope, bits)] = (jp, tp, ids)
        meshes = ["4x2"] + (["2x4", "1x4"] if (scope, bits) == ("full", 8) else [])
        for m in meshes:
            dp, mp = MESHES[m]
            rows = ids[:1] if m == "1x4" else ids
            cases.append(dict(name=f"greedy {scope}{bits} {m}", kind="greedy", dp=dp, mp=mp,
                              args=dict(cfg=cfg, params=tp, ids=rows, kv_dtype=torch.float32, **GEN)))
    g = torch.Generator().manual_seed(5)
    w = torch.randn(3 * 64, 64, generator=g) / 8
    mlp = {"gu": quantize_linear_q4(torch.randn(256, 64, generator=g) / 8),
           "down": quantize_linear_q4(torch.randn(64, 128, generator=g) / 12)}
    x = torch.randn(5, 64, generator=g)
    inputs["qlinear"] = (w, mlp, x)
    cases.append(dict(name="qlinear", kind="qlinear", dp=1, mp=2,
                      args=dict(linears={"q4": quantize_linear_q4(w), "q8": quantize_linear(w)}, x=x, mlp=mlp)))
    for bits in (8, 4):
        tp = inputs[("full", bits)][1]
        for n in (1, 8):
            xn = torch.randn(n, cfg.hidden_size, generator=g)
            inputs[("ffn", bits, n)] = xn
            cases.append(dict(name=f"ffn {bits} {n}", kind="ffn", dp=1, mp=2,
                              args=dict(cfg=cfg, params=tp, layer=1, x=xn, decode=True)))
    return cases, inputs


@pytest.fixture(scope="module")
def world():
    cfg = tiny_lm_config()
    cases, inputs = _cases(cfg)
    return cfg, inputs, launch(run_cases, 8, (cases,))


def _jax_tokens(cfg, jp, ids):
    ids_j = jnp.asarray(ids, jnp.int32)
    tokens, n_gen = jax_greedy(jp, cfg, jnp.take(jp["embed"], ids_j, axis=0), ids_j, kv_dtype="float32", **GEN)
    return np.asarray(tokens), np.asarray(n_gen)


def _port_logits0(cfg, tp, ids):
    ids_t = torch.as_tensor(ids)
    stats = {}
    greedy_generate(tp, cfg, F.embedding(ids_t, tp["embed"]), ids_t, stats=stats, kv_dtype=torch.float32, **GEN)
    return stats["logits0"].numpy()


@pytest.mark.parametrize("scope,bits,mesh", [("experts", 8, "4x2"), ("full", 8, "4x2"), ("experts", 4, "4x2"),
                                             ("full", 4, "4x2"), ("full", 8, "2x4"), ("full", 8, "1x4")])
def test_sharded_quantized_greedy_matches_jax(world, scope, bits, mesh):
    cfg, inputs, results = world
    jp, tp, ids = inputs[(scope, bits)]
    rows = ids[:1] if mesh == "1x4" else ids
    got = results[f"greedy {scope}{bits} {mesh}"]
    want_tok, want_n = _jax_tokens(cfg, jp, rows)
    assert got["same_on_every_rank"]
    np.testing.assert_array_equal(np.asarray(got["n_gen"]).reshape(-1), want_n.reshape(-1))
    np.testing.assert_array_equal(got["tokens"], want_tok)
    ref = _port_logits0(cfg, tp, rows)
    assert float(np.abs(got["logits0"] - ref).max()) <= LOGITS_RTOL * float(np.abs(ref).max())


def test_int4_output_split_is_bit_equal(world):
    """The gathered rows of an int4 linear are the unsharded product's bit
    for bit (L's twin at decode, the prefill form), and so is an int4
    SwiGLU MLP; the int8 contraction split sums f32 partials."""
    _, inputs, results = world
    w, mlp, x = inputs["qlinear"]
    got = results["qlinear"]
    q4, q8 = quantize_linear_q4(w), quantize_linear(w)
    for decode in (True, False):
        tag = "decode" if decode else "prefill"
        assert torch.equal(torch.as_tensor(got[f"q4.{tag}"]), qmm(x, q4, decode=decode)), tag
        want = qmm(x, q8, decode=decode)
        torch.testing.assert_close(torch.as_tensor(got[f"q8.{tag}"]), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(torch.as_tensor(got["mlp"]), swiglu_q8(x, mlp["gu"], mlp["down"], decode=True))


@pytest.mark.parametrize("bits,n", [(8, 1), (8, 8), (4, 1), (4, 8)])
def test_pseudo_experts_counted_once(world, bits, n):
    """At 1 row the unsharded FFN would take I / M with the pseudo-experts
    folded in, at 8 rows (8 k > E) J / N with them: each rank's partial must
    leave them out, or the sum over mp counts the shared MLP twice."""
    cfg, inputs, results = world
    tp = inputs[("full", bits)][1]
    x = inputs[("ffn", bits, n)]
    layer = tp["layers"][1]
    plain = {**layer, "experts_q8": moe_q8.routed_only(layer["experts_q8"])}
    want = tdsv2.ffn(x, plain, cfg, decode=True)
    got = torch.as_tensor(results[f"ffn {bits} {n}"]["out"])
    scale = float(want.abs().max())
    assert results[f"ffn {bits} {n}"]["same_on_every_rank"]
    assert float((got - want).abs().max()) <= FFN_RTOL * scale
    sh = layer["shared"]
    twice = want + swiglu_q8(x, sh["gu"], sh["down"], decode=True)  # what a fold on both ranks would add
    assert float((twice - want).abs().max()) > 100 * FFN_RTOL * scale


@pytest.mark.parametrize("scope,bits", list(TIERS))
def test_specs_follow_the_jax_q8_layout_and_round_trip(scope, bits):
    """Every leaf's split: int8 linears on the contraction (scale whole),
    int4 ones on the output rows (scale too), experts on E, pe_* whole, the
    head on the vocab; two ranks' shards concatenate to the whole."""
    cfg = tiny_lm_config()
    tp = _tier(scope, bits)[1]
    specs = sharding.lm_param_specs_q8(cfg, tp)
    moe, head = specs["layers"][1], specs["lm_head"]
    code = "q8" if bits == 8 else "q4"
    assert all(s.dim == 0 for k, s in moe["experts_q8"].items() if not k.startswith("pe_"))
    assert all(s is None for k, s in moe["experts_q8"].items() if k.startswith("pe_"))
    assert moe["router"] is None and moe["ln1"] is None and specs["embed"] is None
    if scope == "experts":
        assert head.dim == 0 and moe["wo"].dim == 1 and moe["shared"]["down"].dim == 1
    else:
        assert head[code].dim == 0 and head["scale"].dim == 0
        for name in ("wqkv", "wo"):
            lin = moe[name]
            assert (lin[code].dim, lin["scale"] and lin["scale"].dim) == ((1, None) if bits == 8 else (0, 0)), name
        assert specs["layers"][0]["mlp"]["down"][code].dim == (1 if bits == 8 else 0)
    meshes = [Mesh(1, 2, 0, r, torch.device("cpu"), None, None, "gloo") for r in range(2)]
    shards = [sharding.shard_params(tp, m, specs) for m in meshes]
    for (name, whole), (_, a), (_, b) in zip(param_items(tp), param_items(shards[0]), param_items(shards[1])):
        dim = sharding.split_dim(name, whole.dim())
        if dim is None:
            assert torch.equal(a, whole) and torch.equal(b, whole), name
        else:
            assert torch.equal(torch.cat([a, b], dim), whole), name


def test_quantized_mp_that_does_not_divide_is_refused():
    cfg = tiny_lm_config()
    tp = _tier("full", 8)[1]
    with pytest.raises(ValueError, match="mp=8 does not divide num_attention_heads=4"):
        sharding.check_mp(cfg, 8, "full", 8)
    bad = Mesh(1, 8, 0, 0, torch.device("cpu"), None, None, "gloo")
    with pytest.raises(ValueError, match="mp=8 does not divide num_attention_heads=4"):
        sharding.shard_params(tp, bad, sharding.lm_param_specs_q8(cfg, tp))
    wide = dataclasses.replace(cfg, num_attention_heads=2, num_key_value_heads=2, hidden_size=48)
    with pytest.raises(ValueError, match="mp=3 does not divide num_attention_heads=2"):
        sharding.check_mp(wide, 3, "full", 4)


def _twins(bits):
    """(per-selection twin, visits twin, the quantized experts) at E 8, H
    128, I 128 (whole int4 groups)."""
    g = torch.Generator().manual_seed(bits)
    e, h, i = 8, 128, 128
    experts = {"gate": torch.randn(e, i, h, generator=g) / 11, "up": torch.randn(e, i, h, generator=g) / 11,
               "down": torch.randn(e, h, i, generator=g) / 11}
    if bits == 8:
        return moe_q8.moe_ffn_decode_q8_reference, moe_decode.moe_ffn_decode_q8_visits_reference, \
            moe_q8.quantize_experts(experts)
    return moe_q4.moe_ffn_decode_q4_reference, moe_q4.moe_ffn_decode_q4_visits_reference, \
        moe_q4.quantize_experts_q4(experts)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("form", ["per-selection", "visits"])
def test_decode_twins_on_local_ids_in_f32(bits, form):
    """I / M (per selection) and J / N (visits) twins on rank-local ids
    (another rank's selection: id E_local, weight 0), f32 out: the two
    ranks' partials sum to the whole twin's f32 output; bf16 x rounds once;
    a batch with no local selection gives exact zeros."""
    per_sel, visits, eq = _twins(bits)
    twin = per_sel if form == "per-selection" else visits
    g = torch.Generator().manual_seed(7)
    e, k = 8, 2
    x = torch.randn(6, 128, generator=g).to(torch.bfloat16)
    weights, idx = route(x, torch.randn(e, 128, generator=g), k)
    whole = twin(x, eq, weights, idx, out_dtype=torch.float32)
    assert whole.dtype == torch.float32 and torch.equal(twin(x, eq, weights, idx), whole.to(torch.bfloat16))
    parts = []
    code = f"gu_q{bits}"
    for rank in range(2):
        w_l, idx_l = local_routing(weights, idx, e // 2, rank)
        local = {n: t[rank * 4:(rank + 1) * 4] for n, t in eq.items()}
        part = twin(x, local, w_l, idx_l, out_dtype=torch.float32)
        assert part.dtype == torch.float32 and local[code].shape[0] == 4
        parts.append(part)
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-5, atol=1e-6)
    none = torch.full_like(idx, 4)  # every selection another rank's
    local = {n: t[:4] for n, t in eq.items()}
    out = twin(x, local, torch.zeros_like(weights), none, out_dtype=torch.float32)
    assert torch.equal(out, torch.zeros_like(out))
