"""Model-level parity of the PyTorch port against the JAX package, on the
CPU at tiny widths, plus weight loading and safetensors I/O.

Tolerances: towers in f32 agree to 1e-4 (a dozen f32 ops deep, other
summation orders); weight loading and file I/O are bit-exact.
"""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.configs import tiny_ocr2_config
from deepseek_ocr2_tpu.io import DtypePolicy as JaxPolicy
from deepseek_ocr2_tpu.io import load_flat as jax_load_flat
from deepseek_ocr2_tpu.io import save_flat as jax_save_flat
from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
from deepseek_ocr2_tpu.models import qwen2 as jqwen2
from deepseek_ocr2_tpu.models import sam as jsam
from deepseek_ocr2_tpu.runtime.kv_cache import make_kv_cache as jax_make_kv_cache
from deepseek_ocr2_tpu_torch.io import DtypePolicy, load_flat, save_flat
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.models import qwen2 as tqwen2
from deepseek_ocr2_tpu_torch.models import sam as tsam
from deepseek_ocr2_tpu_torch.runtime.kv_cache import bucket_capacity, make_kv_cache

import reference_torch_vision as refv

TOWER = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    cfg = tiny_ocr2_config()
    flat = refv.random_ocr2_flat(cfg, seed=5)
    jp, rep = jocr2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    tp, rep = tocr2.params_from_flat(flat, cfg, policy=DtypePolicy(default="float32"))
    rep.raise_on_errors()
    assert not rep.missing and not rep.skipped
    return cfg, flat, jp, tp


def test_sam_tower_matches_jax(models):
    cfg, _, jp, tp = models
    x = np.random.default_rng(0).uniform(-1, 1, (1, 3, cfg.sam.img_size, cfg.sam.img_size)).astype(np.float32)
    want = np.asarray(jsam.sam_forward(jp["sam"], cfg.sam, jnp.asarray(x)))
    with torch.no_grad():
        got = tsam.sam_forward(tp["sam"], cfg.sam, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOWER)


def test_qwen2_encode_matches_jax(models):
    cfg, _, jp, tp = models
    feats = np.random.default_rng(1).standard_normal((1, cfg.qwen2.hidden_size, 4, 4)).astype(np.float32)
    want = np.asarray(jqwen2.qwen2_encode(jp["qwen2"], cfg.qwen2, jnp.asarray(feats)))
    with torch.no_grad():
        got = tqwen2.qwen2_encode(tp["qwen2"], cfg.qwen2, torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, **TOWER)


def test_lm_prefill_logits_and_decode_equal_prefill(models):
    cfg, _, jp, tp = models
    lm = cfg.lm
    ids = np.random.default_rng(2).integers(2, lm.vocab_size, 12)
    embeds = np.asarray(jp["lm"]["embed"])[ids][None]
    cache = jax_make_kv_cache(lm.num_hidden_layers, 1, lm.num_attention_heads, 32, lm.head_dim, jnp.float32)
    hidden, _ = jdsv2.lm_forward(jp["lm"], lm, jnp.asarray(embeds), cache, pos=0, is_prefill=True)
    want = np.asarray(jdsv2.logits_last(jp["lm"], hidden))

    with torch.no_grad():
        cache = make_kv_cache(lm.num_hidden_layers, 1, lm.num_attention_heads, 32, lm.head_dim, torch.float32)
        hidden = tdsv2.lm_forward(tp["lm"], lm, torch.from_numpy(embeds), cache, pos=0)
        full = tdsv2.logits_last(tp["lm"], hidden).numpy()
        np.testing.assert_allclose(full, want, **TOWER)

        # Prefill 11 tokens, then decode the 12th against the cache.
        cache = make_kv_cache(lm.num_hidden_layers, 1, lm.num_attention_heads, 32, lm.head_dim, torch.float32)
        tdsv2.lm_forward(tp["lm"], lm, torch.from_numpy(embeds[:, :11]), cache, pos=0)
        hidden = tdsv2.lm_forward(tp["lm"], lm, torch.from_numpy(embeds[:, 11:]), cache, pos=11, is_prefill=False)
        np.testing.assert_allclose(tdsv2.logits_last(tp["lm"], hidden).numpy(), full, **TOWER)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_equals_params_from_flat(models, dtype):
    cfg, flat, jp, _ = models
    from_flat, _ = tocr2.params_from_flat(flat, cfg, policy=DtypePolicy(default=dtype))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.dtype(dtype))), jp)
    from_jax = tocr2.params_from_jax(tree, cfg)
    a, b = list(_leaves(from_flat)), list(_leaves(from_jax))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype == getattr(torch, dtype) and x.shape == y.shape, path
        assert torch.equal(x, y), path


def test_reads_jax_safetensors_bit_identically(tmp_path):
    import ml_dtypes

    rng = np.random.default_rng(3)
    arrays = {
        "model.a.weight": rng.standard_normal((5, 7)).astype(np.float32),
        "model.b.weight": rng.standard_normal((3, 4)).astype(ml_dtypes.bfloat16),
        "model.c.ids": rng.integers(-5, 5, (6,)).astype(np.int32),
        "lm_head.weight": rng.standard_normal((2, 3)).astype(np.float32),
    }
    path = str(tmp_path / "jax.safetensors")
    jax_save_flat(arrays, path)
    got = load_flat(path)
    assert sorted(got) == sorted(arrays)
    for name, want in arrays.items():
        t = got[name]
        if want.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)

    # Dtype policy (longest prefix wins, floats only) and include_regex, as in the JAX loader.
    policy = DtypePolicy(default="bfloat16").with_prefix("model.a", "float32")
    sub = load_flat(path, policy, include_regex=[r"^model\."])
    assert sorted(sub) == ["model.a.weight", "model.b.weight", "model.c.ids"]
    assert sub["model.a.weight"].dtype == torch.float32
    assert sub["model.c.ids"].dtype == torch.int32
    want = jax_load_flat(path, JaxPolicy(default="bfloat16").with_prefix("model.a", "float32"))
    np.testing.assert_array_equal(sub["model.b.weight"].float().numpy(), want["model.b.weight"].astype(np.float32))

    # And the port's writer is read back by the JAX loader.
    path2 = str(tmp_path / "torch.safetensors")
    save_flat(got, path2)
    back = jax_load_flat(path2)
    for name, want in arrays.items():
        np.testing.assert_array_equal(np.asarray(back[name]).view(np.uint8), want.view(np.uint8))


def test_bucket_capacity_matches_jax():
    from deepseek_ocr2_tpu.runtime.kv_cache import bucket_capacity as jax_bucket

    for n in (1, 300, 1024, 1025, 2049):
        assert bucket_capacity(n) == jax_bucket(n)


@pytest.mark.parametrize("name", ["DeepseekV2Config", "Qwen2Config", "SamConfig", "OCR2Config", "tiny_lm_config",
                                  "tiny_qwen2_config", "tiny_sam_config", "tiny_ocr2_config"])
def test_copied_configs_equal_the_jax_packages(name):
    """The port keeps its own copy of the config module: every default and
    tiny config equals the JAX package's field by field."""
    import dataclasses

    from deepseek_ocr2_tpu import configs as jcfg
    from deepseek_ocr2_tpu_torch import configs as tcfg

    got, want = getattr(tcfg, name)(), getattr(jcfg, name)()
    assert type(got).__module__ == "deepseek_ocr2_tpu_torch.configs"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert sorted(f.name for f in dataclasses.fields(got)) == sorted(f.name for f in dataclasses.fields(want))


def test_copied_config_from_json_equals_the_jax_packages(tmp_path):
    import dataclasses
    import json

    from deepseek_ocr2_tpu import configs as jcfg
    from deepseek_ocr2_tpu_torch import configs as tcfg

    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"lm": {"num_hidden_layers": 3, "vocab_size": 1000},
                                "sam": {"depth": 4, "global_attn_indexes": [1, 3]},
                                "qwen2": {"num_hidden_layers": 2}, "base_image_size": 512}))
    got, want = tcfg.config_from_json(str(path)), jcfg.config_from_json(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.image_token_count((2, 3)) == want.image_token_count((2, 3))
