"""The OCR composite on a (2, 2) mesh in the port against the JAX package's
under its own mesh, on the CPU (the JAX dryrun's steps 3 and 3b): the LM
sharded (TP / EP over mp), the vision towers whole on every rank, the
pages split over dp.

The port's cases run in one 4-rank gloo world started once for the module
(`launch.launch(runs.run_cases, ...)`); the JAX side in this process on
conftest's virtual CPU devices. Weights: tests/test_torch_train_ocr.py's
tiny composite (SAM 3 blocks, Qwen2 2 layers, the LM 2 layers), f32, the
same numpy-seeded flat on both sides.

- The OCR prefill's last logits of 4 no-crop pages (each dp rank's 2
  pages through the towers, the sharded LM prefill, the logits gathered
  over mp and dp) within 1e-5 of the largest logit of the JAX package's.
- `ocr_loss`'s loss (rtol 1e-5) and every gathered gradient leaf (within
  1e-5 of its largest entry) on B 4 x S 200 (800 rows: the grouped MoE
  form), against the JAX package's gradient; the towers' gradients equal
  on every rank; one `adamw_ocr_train_step`'s loss against the JAX
  package's step under its mesh.
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

sys.path.insert(0, str(Path(__file__).resolve().parent))

import reference_torch_vision as refv  # noqa: E402
from deepseek_ocr2_tpu import parallel as jpar  # noqa: E402
from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2  # noqa: E402
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2  # noqa: E402
from deepseek_ocr2_tpu.runtime import train as jtrain  # noqa: E402
from deepseek_ocr2_tpu.runtime.kv_cache import make_kv_cache as jmake_kv_cache  # noqa: E402
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2  # noqa: E402
from deepseek_ocr2_tpu_torch.parallel.launch import launch  # noqa: E402
from deepseek_ocr2_tpu_torch.parallel.runs import run_cases  # noqa: E402
from deepseek_ocr2_tpu_torch.runtime.train import param_items, tree_like  # noqa: E402
from test_torch_train_ocr import PLACEHOLDER, START, _batch, _configs, _torch_params  # noqa: E402

LEAF_RTOL = 1e-5
DP, MP = 2, 2
B, S = 4, 200
LR = 1e-3


@pytest.fixture(scope="module")
def world():
    cfg, tcfg = _configs(image_token_id=PLACEHOLDER)
    flat = refv.random_ocr2_flat(cfg, seed=7)
    jp = jax.tree_util.tree_map(jnp.asarray, jocr2.params_from_flat(flat, cfg)[0])
    params = _torch_params(flat, tcfg)
    ids, base, _, mask = _batch(cfg, B, S, seed=4)
    n_img = cfg.image_token_count((1, 1))
    ids_pre = ids[:, : START + n_img + 3]
    cases = [
        dict(name="prefill", kind="ocr_prefill", dp=DP, mp=MP,
             args=dict(cfg=tcfg, params=params, ids=ids_pre, images=base, image_start=START)),
        dict(name="step", kind="ocr_steps", dp=DP, mp=MP,
             args=dict(cfg=tcfg, params=params, ids=ids, images=base, patches=None, image_start=START, mask=mask,
                       steps=1, tx=dict(lr=LR))),
    ]
    results = launch(run_cases, DP * MP, (cases,))
    return cfg, tcfg, params, jp, (ids, base, mask, ids_pre), results


def _mesh():
    return jpar.make_mesh(dp=DP, mp=MP, devices=jax.devices()[: DP * MP])


def _sharded(jp, cfg, mesh):
    out = dict(jp)
    out["lm"] = jpar.shard_params(jax.tree_util.tree_map(jnp.array, jp["lm"]), mesh, jpar.lm_param_specs(cfg.lm))
    return out


def test_ocr_prefill_logits_match_jax_mesh(world):
    cfg, _, _, jp, (_, base, _, ids_pre), results = world
    mesh = _mesh()
    rows = NamedSharding(mesh, P("dp", None))

    @jax.jit
    def prefill(p, ids, imgs):
        embeds = jocr2.ocr_prefill_embeds_batched(p, cfg, ids, imgs, None, START)
        cache = make_cache(ids.shape)
        hidden, _ = jdsv2.lm_forward(p["lm"], cfg.lm, embeds, cache, pos=0, is_prefill=True)
        return jdsv2.logits_last(p["lm"], hidden)

    def make_cache(shape):
        lm = cfg.lm
        return jmake_kv_cache(lm.num_hidden_layers, shape[0], lm.num_attention_heads, shape[1], lm.head_dim,
                              jnp.float32)

    with mesh:
        want = np.asarray(prefill(_sharded(jp, cfg, mesh), jax.device_put(jnp.asarray(ids_pre, jnp.int32), rows),
                                  jax.device_put(jnp.asarray(base), NamedSharding(mesh, P("dp", None, None, None)))))
    got = results["prefill"]["logits"]
    assert got.shape == want.shape == (B, cfg.lm.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=LEAF_RTOL * float(np.abs(want).max()))


def test_ocr_step_matches_jax_mesh(world):
    cfg, tcfg, params, jp, (ids, base, mask, _), results = world
    got = results["step"]
    args = (jnp.asarray(ids, jnp.int32), jnp.asarray(base), None, START, jnp.asarray(mask))
    loss, grads = jax.jit(jax.value_and_grad(jtrain.ocr_loss), static_argnums=(1, 5))(jp, cfg, *args)
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    want = {k: np.asarray(v, np.float32) for k, v in jocr2.flat_from_params(grads, cfg).items()}
    names = [n for n, _ in param_items(params)]
    flat = tocr2.flat_from_params(tree_like(params, [torch.from_numpy(np.asarray(got["grads"][n])) for n in names]),
                                  tcfg)
    assert sorted(flat) == sorted(want)
    for name, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(flat[name].numpy(), w, rtol=0, atol=LEAF_RTOL * max(scale, 1e-12), err_msg=name)
    mesh = _mesh()
    rows = NamedSharding(mesh, P("dp", None))
    with mesh:
        p = _sharded(jp, cfg, mesh)
        tx = jtrain.make_optimizer(lr=LR)
        state = jtrain.init_opt_state(tx, p)
        _, _, step_loss = jtrain.adamw_ocr_train_step(
            p, state, cfg, jax.device_put(args[0], rows),
            jax.device_put(args[1], NamedSharding(mesh, P("dp", None, None, None))), None, START,
            jax.device_put(args[4], rows), tx)
    np.testing.assert_allclose(got["losses"], [float(step_loss)], rtol=1e-5)


def test_tower_gradients_equal_on_every_rank(world):
    """The towers are whole on every rank; their gradients (through the
    injected embeddings, whose gradient the mp all-reduce makes whole,
    then the dp mean) are bit-equal across mp and dp."""
    assert world[-1]["step"]["towers_equal"]
