"""The port against two of the JAX package's switches, on the CPU. The port
reads neither switch: it keeps the JAX package's default paths, and
chip_smoke phase 2 runs each switch's other side as an ablation, calling
the port's functions directly. These tests hold both sides of each
ablation to the JAX package under the switch's values:

- DEEPSEEK_QWEN2_SDPA=0: the JAX `qwen2_encode` with its Pallas prefix
  kernel (interpret mode) once the sequence reaches 256
  (`tiny_qwen2_config(n_query_1024=128)`: 128 feature tokens + 128
  queries) against the port's `qwen2_encode` (`sdpa`), within the f32
  tolerance; and the port's kernel A in prefix mode (`mha`, its plain twin
  here) at Qwen2's attention against the port's `sdpa` with the prefix-LM
  mask and the JAX `mha_pallas` in interpret mode.
- DEEPSEEK_MOE_PREFILL=gmm|dense (and unset): the port's `moe_ffn_gmm`,
  `moe_ffn_dense` and `moe_ffn_prefill` at 40 and 520 rows (both sides of
  the 512-row cut-over) against the JAX `moe_ffn_prefill` under the
  matching value (its grouped GEMM in interpret mode), f32 within 1e-5 of
  the largest output; the tiny LM's greedy tokens on the port's default
  paths equal to the JAX package's under each value.
- Neither switch, nor `ragged`, moves the port off its default forms.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
from deepseek_ocr2_tpu.models import qwen2 as jqwen2
from deepseek_ocr2_tpu.ops import moe as jmoe
from deepseek_ocr2_tpu.ops import moe_gmm as jgmm
from deepseek_ocr2_tpu.ops.flash_attention import mha_pallas
from deepseek_ocr2_tpu.runtime.generate import greedy_generate as jax_generate
from deepseek_ocr2_tpu_torch.configs import tiny_lm_config, tiny_qwen2_config
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.models import qwen2 as tqwen2
from deepseek_ocr2_tpu_torch.ops import moe as tmoe
from deepseek_ocr2_tpu_torch.ops.attention import prefix_lm_mask, sdpa
from deepseek_ocr2_tpu_torch.ops.flash_attention import mha
from deepseek_ocr2_tpu_torch.runtime.generate import greedy_generate

import reference_torch_vision as refv
from reference_torch import random_lm_flat

F32 = dict(rtol=1e-4, atol=1e-4)  # the towers' f32 tolerance (tests/test_torch_models.py)


# ---------------------------------------------------------------------------
# DEEPSEEK_QWEN2_SDPA


@pytest.fixture(scope="module")
def qwen2():
    cfg = tiny_qwen2_config(n_query_1024=128)
    flat = refv.random_qwen2_flat(cfg, seed=4)
    jp, rep = jqwen2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    tp, rep = tqwen2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    feats = np.random.default_rng(6).standard_normal((2, cfg.hidden_size, 8, 16)).astype(np.float32)
    return cfg, jax.tree_util.tree_map(jnp.asarray, jp), tp, feats


@pytest.fixture
def sdpa_calls(monkeypatch):
    """The port's Qwen2 attention calls, as the masks they were given."""
    calls = []

    def spy(*args, **kw):
        calls.append(kw.get("mask"))
        return sdpa(*args, **kw)

    monkeypatch.setattr(tqwen2, "sdpa", spy)
    return calls


def test_qwen2_matches_jax_prefix_kernel_path(qwen2, monkeypatch):
    cfg, jp, tp, feats = qwen2
    with torch.no_grad():
        got = tqwen2.qwen2_encode(tp, cfg, torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, np.asarray(jqwen2.qwen2_encode(jp, cfg, jnp.asarray(feats))), **F32)
    # The JAX package's switched path: its Pallas prefix kernel, interpreted.
    monkeypatch.setenv("DEEPSEEK_QWEN2_SDPA", "0")
    monkeypatch.setattr(jqwen2, "pallas_enabled", lambda: True)
    monkeypatch.setattr(jqwen2, "mha_pallas", functools.partial(mha_pallas, interpret=True))
    np.testing.assert_allclose(got, np.asarray(jqwen2.qwen2_encode(jp, cfg, jnp.asarray(feats))), **F32)


@pytest.mark.parametrize("b,n_prefix", [(1, 128), (3, 144)])
def test_prefix_attention_matches_sdpa_and_jax(b, n_prefix):
    """The two sides of chip_smoke's Qwen2 ablation at Qwen2's attention
    (f32 after RoPE and repeat_kv, heads of 64, 2 n_prefix tokens)."""
    rng = np.random.default_rng(n_prefix)
    q, k, v = (rng.standard_normal((b, 2, 2 * n_prefix, 64)).astype(np.float32) for _ in range(3))
    scale = 1.0 / 8.0
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = mha(qt, kt, vt, scale=scale, mode="prefix", n_prefix=n_prefix).numpy()
    mask = prefix_lm_mask(2 * n_prefix, n_prefix)[None, None]
    np.testing.assert_allclose(got, sdpa(qt, kt, vt, scale=scale, mask=mask).numpy(), **F32)
    want = mha_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=scale, mode="prefix",
                      n_prefix=n_prefix, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


# ---------------------------------------------------------------------------
# DEEPSEEK_MOE_PREFILL

MOE_VALUES = ["gmm", "dense", None]  # the JAX package's value; None: its cut-over
PORT_FORM = {"gmm": "moe_ffn_gmm", "dense": "moe_ffn_dense", None: "moe_ffn_prefill"}


@pytest.fixture(scope="module")
def experts():
    rng = np.random.default_rng(8)
    e, h, i = 8, 64, 64
    ws = {n: (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(np.float32)
          for n, shape in (("gate", (e, h, i)), ("up", (e, h, i)), ("down", (e, i, h)))}  # the JAX layout
    router = (rng.standard_normal((h, e)) * 0.1).astype(np.float32)
    return ws, router


@pytest.fixture
def jax_gmm_interpreted(monkeypatch):
    """The JAX package's grouped GEMM in interpret mode (its Pallas kernels
    on the CPU), as tests/test_moe_gmm.py runs it; fresh traces, since the
    JAX package reads the switch while tracing."""
    monkeypatch.setattr(jgmm, "moe_ffn_gmm", functools.partial(jgmm.moe_ffn_gmm, interpret=True))
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def forms(monkeypatch):
    """The prefill forms the port's `moe_ffn_prefill` took, by name."""
    taken = []
    for name in ("moe_ffn_gmm", "moe_ffn_dense"):
        orig = getattr(tmoe, name)

        def spy(*args, _orig=orig, _name=name, **kw):
            taken.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(tmoe, name, spy)
    return taken


def _set(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("DEEPSEEK_MOE_PREFILL", raising=False)
    else:
        monkeypatch.setenv("DEEPSEEK_MOE_PREFILL", value)


@pytest.mark.parametrize("n", [40, 520])
@pytest.mark.parametrize("value", MOE_VALUES, ids=[str(v) for v in MOE_VALUES])
def test_moe_prefill_forms_match_jax(experts, jax_gmm_interpreted, monkeypatch, value, n):
    ws, router = experts
    x = np.random.default_rng(n).standard_normal((n, ws["gate"].shape[1])).astype(np.float32)
    _set(monkeypatch, value)
    jw, jidx = jmoe.route(jnp.asarray(x), jnp.asarray(router), 2)
    want = np.asarray(jmoe.moe_ffn_prefill(jnp.asarray(x), {k: jnp.asarray(v) for k, v in ws.items()}, jw, jidx))
    monkeypatch.delenv("DEEPSEEK_MOE_PREFILL", raising=False)
    tws = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 2, 1))) for k, v in ws.items()}  # HF [out, in]
    xt = torch.from_numpy(x)
    weights, idx = tmoe.route(xt, torch.from_numpy(np.ascontiguousarray(router.T)), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    got = getattr(tmoe, PORT_FORM[value])(xt, tws, weights, idx).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def lm():
    cfg = tiny_lm_config()
    flat = random_lm_flat(cfg, seed=11)
    jp, _ = jdsv2.params_from_flat(flat, cfg)
    tp, _ = tdsv2.params_from_flat(flat, cfg)
    return cfg, jax.tree_util.tree_map(jnp.asarray, jp), tp


@pytest.mark.parametrize("value", MOE_VALUES, ids=[str(v) for v in MOE_VALUES])
def test_greedy_tokens_match_jax_under_each_moe_prefill_value(lm, jax_gmm_interpreted, monkeypatch, value):
    cfg, jp, tp = lm
    for b, s in ((2, 12), (3, 200)):  # 24 and 600 prompt rows
        ids = np.random.default_rng(s).integers(2, cfg.vocab_size, (b, s))
        kw = dict(max_new_tokens=4, ngram_size=3, eos_id=1, capacity=256)
        _set(monkeypatch, value)
        tokens, n_gen = jax_generate(jp, cfg, jnp.take(jp["embed"], jnp.asarray(ids), axis=0), jnp.asarray(ids),
                                     kv_dtype="float32", **kw)
        monkeypatch.delenv("DEEPSEEK_MOE_PREFILL", raising=False)
        got, got_n = greedy_generate(tp, cfg, tp["embed"][torch.from_numpy(ids)], torch.from_numpy(ids),
                                     kv_dtype=torch.float32, **kw)
        np.testing.assert_array_equal(got_n.numpy(), np.asarray(n_gen))
        np.testing.assert_array_equal(got.numpy()[:, : s + 4], np.asarray(tokens)[:, : s + 4])


# ---------------------------------------------------------------------------
# The port reads neither switch


@pytest.mark.parametrize("name,value", [("DEEPSEEK_QWEN2_SDPA", "0"), ("DEEPSEEK_MOE_PREFILL", "gmm"),
                                        ("DEEPSEEK_MOE_PREFILL", "dense"), ("DEEPSEEK_MOE_PREFILL", "ragged")])
def test_port_keeps_its_default_forms_under_the_switches(qwen2, experts, sdpa_calls, forms, monkeypatch,
                                                         name, value):
    monkeypatch.setenv(name, value)
    cfg, _, tp, feats = qwen2
    with torch.no_grad():
        tqwen2.qwen2_encode(tp, cfg, torch.from_numpy(feats))  # 256 tokens: still sdpa, a layer
    assert len(sdpa_calls) == cfg.num_hidden_layers and all(m is not None for m in sdpa_calls)
    ws, router = experts
    tws = {k: torch.from_numpy(np.ascontiguousarray(v.transpose(0, 2, 1))) for k, v in ws.items()}
    for n in (40, 520):
        xt = torch.from_numpy(np.random.default_rng(n).standard_normal((n, 64)).astype(np.float32))
        tmoe.moe_ffn_prefill(xt, tws, *tmoe.route(xt, torch.from_numpy(np.ascontiguousarray(router.T)), 2))
    assert forms == ["moe_ffn_dense", "moe_ffn_gmm"]  # the 512-row cut-over
