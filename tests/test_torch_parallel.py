"""The port's (dp, mp) mesh (`deepseek_ocr2_tpu_torch.parallel`) against
the JAX package's `parallel/` under its own mesh, on the CPU.

The JAX side runs in this process on conftest's 8 virtual CPU devices; the
port's cases run in one 8-rank gloo world on 127.0.0.1, started once for
the module (`launch.launch(runs.run_cases, ...)`, a function of the
package, so no rank imports JAX). The weights are the JAX dryrun's tiny LM
(`tiny_lm_config(num_attention_heads=4, n_routed_experts=8,
vocab_size=512, hidden_size=64)`: one dense and two MoE layers, f32),
carried across by `params_from_jax` and cut by each rank's
`shard_params`.

- One AdamW step's loss (rtol 1e-5) and every gathered gradient leaf
  (within 1e-5 of its largest entry) at (dp, mp) = (4, 2) and (2, 2) here,
  (1, 2) and (2, 1) in tests/test_torch_parallel_steps.py, B 4 x S 160 (640 rows, above the 512-row cut-over: both
  packages take the grouped MoE form), then three steps' losses (rtol
  1e-5), against the JAX package's jitted step under the same mesh; every
  replicated leaf equal across the mp ranks after the steps.
- The masked SFT loss with unequal mask counts on the dp ranks (each mean
  over the whole batch's targets).
- At (4, 1) and B 4 x S 512 each rank holds 512 rows, yet every rank's
  forward takes the grouped form (the cut-over reads the global 2048).
- Unit cases: the specs, the divisibility refusal, a shard / gather round
  trip, EP's local routing (other ranks' selections take no slot of the
  aligned layout), F's schedule on local ids, and each rank's decode MoE
  partial returned in f32 unrounded (both decode forms).
"""

import dataclasses
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

from reference_torch import random_lm_flat  # noqa: E402

from deepseek_ocr2_tpu import parallel as jpar  # noqa: E402
from deepseek_ocr2_tpu.configs import tiny_lm_config  # noqa: E402
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2  # noqa: E402
from deepseek_ocr2_tpu.runtime import train as jtrain  # noqa: E402
from deepseek_ocr2_tpu_torch.configs import tiny_lm_config as t_tiny_lm_config  # noqa: E402
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2  # noqa: E402
from deepseek_ocr2_tpu_torch.ops import moe_decode, moe_gmm  # noqa: E402
from deepseek_ocr2_tpu_torch.ops.moe import local_routing, moe_ffn_decode  # noqa: E402
from deepseek_ocr2_tpu_torch.parallel import sharding  # noqa: E402
from deepseek_ocr2_tpu_torch.parallel.launch import launch  # noqa: E402
from deepseek_ocr2_tpu_torch.parallel.runs import run_cases  # noqa: E402

LEAF_RTOL = 1e-5
MESHES = [(4, 2), (2, 2)]
DIMS = dict(num_attention_heads=4, n_routed_experts=8, vocab_size=512, hidden_size=64, max_position_embeddings=640)
B, S = 4, 160
STEPS = 3
LR = 5e-3


def _ids(b, s, seed):
    return np.random.default_rng(seed).integers(0, DIMS["vocab_size"], (b, s))


def _sft_mask():
    """Unequal targets on the dp ranks at dp 2 (rows 0-1 hold 60, rows 2-3
    hold 151) and at dp 4."""
    mask = np.zeros((B, S), np.float32)
    mask[0, 10:40] = 1.0
    mask[1, 120:150] = 1.0
    mask[2, 5:7] = 1.0
    mask[3, 11:] = 1.0
    return mask


def build_world(meshes, extra):
    """The JAX params and config, the batch, and the results of one
    8-rank world that runs a step case for each (dp, mp) of `meshes` and
    the cases extra(tcfg, params) returns."""
    cfg, tcfg = tiny_lm_config(**DIMS), t_tiny_lm_config(**DIMS)
    jp = jax.tree_util.tree_map(jnp.asarray, jdsv2.params_from_flat(random_lm_flat(cfg, seed=11), cfg)[0])
    params = tdsv2.params_from_jax(jp, tcfg)
    ids = _ids(B, S, 1)
    cases = [dict(name=f"steps{dp}{mp}", kind="lm_steps", dp=dp, mp=mp,
                  args=dict(cfg=tcfg, params=params, ids=ids, steps=STEPS, tx=dict(lr=LR)))
             for dp, mp in meshes]
    results = launch(run_cases, 8, (cases + extra(tcfg, params),))
    return cfg, tcfg, jp, ids, results


def _extra_cases(tcfg, params):
    ids = _ids(B, S, 1)
    return [
        dict(name="sft", kind="lm_steps", dp=2, mp=2, args=dict(cfg=tcfg, params=params, ids=ids, mask=_sft_mask())),
        dict(name="sft4", kind="lm_steps", dp=4, mp=1, args=dict(cfg=tcfg, params=params, ids=ids, mask=_sft_mask())),
        dict(name="grouped", kind="lm_steps", dp=4, mp=1,
             args=dict(cfg=dataclasses.replace(tcfg, max_position_embeddings=512), params=params,
                       ids=_ids(4, 512, 3), grads=False, count_grouped=True)),
    ]


@pytest.fixture(scope="module")
def world():
    return build_world(MESHES, _extra_cases)


def _jax_mesh(dp, mp):
    return jpar.make_mesh(dp=dp, mp=mp, devices=jax.devices()[: dp * mp])


def jax_grads_of(world):
    """The JAX package's loss and gradient of the batch, unsharded (its
    mesh computes the same sums in another order)."""
    cfg, _, jp, ids, _ = world
    loss, grads = jax.jit(jax.value_and_grad(jtrain.lm_loss), static_argnums=(1,))(
        jp, cfg, jnp.asarray(ids, jnp.int32))
    return float(loss), {k: np.asarray(v) for k, v in jdsv2.flat_from_params(grads, cfg).items()}


@pytest.fixture(scope="module")
def jax_grads(world):
    return jax_grads_of(world)


@pytest.mark.parametrize("dp,mp", MESHES, ids=[f"{dp}x{mp}" for dp, mp in MESHES])
def test_adamw_step_matches_jax_mesh(world, jax_grads, dp, mp):
    check_adamw_step(world, jax_grads, dp, mp)


def check_adamw_step(world, jax_grads, dp, mp):
    """The port's gathered gradient against the JAX package's; its loss and
    three AdamW steps' losses against the JAX package's `adamw_train_step`
    under the same (dp, mp) mesh (whose first loss is the batch's loss at
    the initial params)."""
    cfg, tcfg, jp, ids, results = world
    got = results[f"steps{dp}{mp}"]
    mesh = _jax_mesh(dp, mp)
    with mesh:
        params = jpar.shard_params(jax.tree_util.tree_map(jnp.array, jp), mesh, jpar.lm_param_specs(cfg))
        ids_j = jax.device_put(jnp.asarray(ids, jnp.int32), NamedSharding(mesh, P("dp", None)))
        tx = jtrain.make_optimizer(lr=LR)
        state = jtrain.init_opt_state(tx, params)
        losses = []
        for _ in range(STEPS):
            params, state, step_loss = jtrain.adamw_train_step(params, state, cfg, ids_j, tx)
            losses.append(float(step_loss))
    loss, want = jax_grads
    np.testing.assert_allclose(losses[0], loss, rtol=1e-6)
    np.testing.assert_allclose(got["loss"], losses[0], rtol=1e-5)
    flat = tdsv2.flat_from_params(_tree(tcfg, got["grads"]), tcfg)
    assert sorted(flat) == sorted(want)
    for name, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(flat[name], w, rtol=0, atol=LEAF_RTOL * max(scale, 1e-12), err_msg=name)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    assert got["replicated_equal"]


def _tree(tcfg, named):
    """A port LM tree from {param_items path: array} (gathered leaves)."""
    from deepseek_ocr2_tpu_torch.runtime.train import param_items, tree_like

    skeleton = _skeleton(sharding.lm_param_specs(tcfg))
    names = [n for n, _ in param_items(skeleton)]
    return tree_like(skeleton, [torch.from_numpy(np.asarray(named[n])) for n in names])


def _skeleton(spec):
    """The specs' tree with a placeholder tensor at every leaf."""
    if isinstance(spec, dict):
        return {k: _skeleton(v) for k, v in spec.items()}
    if isinstance(spec, list):
        return [_skeleton(v) for v in spec]
    return torch.zeros(())


def test_masked_sft_loss_with_unequal_counts_matches_jax(world):
    cfg, _, jp, ids, results = world
    want = float(jax.jit(jtrain.lm_loss_masked, static_argnums=(1,))(
        jp, cfg, jnp.asarray(ids, jnp.int32), jnp.asarray(_sft_mask())))
    # Not a mean of the ranks' own means: at dp 2, 30 + 30 targets on dp
    # rank 0, 2 + 149 on rank 1.
    for name in ("sft", "sft4"):
        np.testing.assert_allclose(results[name]["loss"], want, rtol=1e-5)


def test_ep_cut_over_reads_global_rows(world):
    """(4, 1) at B 4 x S 512: 512 rows a rank, 2048 in all; both MoE layers
    of every rank's forward take the grouped form (`MoeFfnGmm`), as the
    JAX package's logical shapes do."""
    got = world[4]["grouped"]["grouped_forms"]
    assert np.asarray(got).reshape(-1).tolist() == [2, 2, 2, 2]


def test_specs_follow_the_jax_layout():
    tcfg = t_tiny_lm_config(**DIMS)
    specs = sharding.lm_param_specs(tcfg)
    dense, moe = specs["layers"][0], specs["layers"][1]
    assert specs["embed"] is None and specs["norm"] is None and specs["lm_head"].dim == 0
    assert [dense[n].dim for n in ("wq", "wk", "wv", "wo")] == [0, 0, 0, 1]
    assert dense["wq"].unit == tcfg.head_dim and dense["ln1"] is None
    assert [dense["mlp"][n].dim for n in ("gate", "up", "down")] == [0, 0, 1]
    assert [moe["shared"][n].dim for n in ("gate", "up", "down")] == [0, 0, 1]
    assert [moe["experts"][n].dim for n in ("gate", "up", "down")] == [0, 0, 0]
    assert moe["router"] is None and "mlp" not in moe
    assert sharding.split_dim("lm.layers.1.experts.down") == 0 and sharding.split_dim("qwen2.layers.0.wq") is None


def test_mp_that_does_not_divide_is_refused():
    from deepseek_ocr2_tpu_torch.configs import DeepseekV2Config

    sharding.check_mp(DeepseekV2Config(), 2)
    with pytest.raises(ValueError, match="mp=4 does not divide num_attention_heads=10"):
        sharding.check_mp(DeepseekV2Config(), 4)
    with pytest.raises(ValueError, match="n_routed_experts=8"):
        sharding.check_mp(t_tiny_lm_config(num_attention_heads=6, vocab_size=513, intermediate_size=129), 3)


def test_shard_gather_round_trip_and_refusal():
    """Two ranks' shards (faked meshes, no world) concatenate to the whole
    leaf along each spec's dim; a split that is not whole heads raises."""
    from deepseek_ocr2_tpu_torch.parallel.mesh import Mesh
    from deepseek_ocr2_tpu_torch.parallel.runs import random_lm_params
    from deepseek_ocr2_tpu_torch.runtime.train import param_items

    tcfg = t_tiny_lm_config(**DIMS)
    full = random_lm_params(tcfg, 0, "cpu")
    specs = sharding.lm_param_specs(tcfg)
    meshes = [Mesh(1, 2, 0, r, torch.device("cpu"), None, None, "gloo") for r in range(2)]
    shards = [sharding.shard_params(full, m, specs) for m in meshes]
    assert shards[1]["mesh"] is meshes[1]
    for (name, whole), (_, a), (_, b) in zip(param_items(full), param_items(shards[0]), param_items(shards[1])):
        dim = sharding.split_dim(name)
        if dim is None:
            assert torch.equal(a, whole) and torch.equal(b, whole), name
        else:
            assert a.shape[dim] * 2 == whole.shape[dim] and torch.equal(torch.cat([a, b], dim), whole), name
    assert shards[0]["layers"][1]["experts"]["gate"].shape[0] == 4
    bad = Mesh(1, 8, 0, 0, torch.device("cpu"), None, None, "gloo")
    with pytest.raises(ValueError, match="mp=8 does not divide num_attention_heads=4"):
        sharding.shard_params(full, bad, specs)


def test_other_ranks_selections_take_no_slot():
    """EP: on rank 1 of mp 2 (experts 4-7 of 8), the aligned layout lays
    out only this rank's selections; the grouped twin and its backward
    give other ranks' selections exact zeros (output and d_weights) and
    the sum of both ranks' outputs is the whole MoE."""
    g = torch.Generator().manual_seed(0)
    n, k, e, h, i = 40, 2, 8, 16, 8
    x = torch.randn(n, h, generator=g)
    experts = {"gate": torch.randn(e, i, h, generator=g), "up": torch.randn(e, i, h, generator=g),
               "down": torch.randn(e, h, i, generator=g)}
    probs = torch.softmax(torch.randn(n, e, generator=g), -1)
    weights, idx = torch.sort(probs, -1, descending=True)
    weights, idx = weights[:, :k], idx[:, :k]
    whole = moe_gmm.moe_ffn_gmm_reference(x, experts, weights, idx)
    parts = []
    for rank in range(2):
        w_l, idx_l = local_routing(weights, idx, e // 2, rank)
        local = {nm: t[rank * 4:(rank + 1) * 4] for nm, t in experts.items()}
        mine = int((idx // 4 == rank).sum())
        assign, slot_valid, e_tile, tile_valid, rows = moe_gmm.aligned_assignments(idx_l, 4)
        assert int(slot_valid.sum()) == mine  # slots only for this rank's selections
        xr = x.clone().requires_grad_(True)
        wr = w_l.clone().requires_grad_(True)
        out = moe_gmm.moe_ffn_gmm(xr, {nm: t.clone().requires_grad_(True) for nm, t in local.items()}, wr,
                                  idx_l, torch.float32)
        out.sum().backward()
        assert torch.equal(wr.grad[idx_l == 4], torch.zeros(int((idx_l == 4).sum())))
        parts.append(out.detach())
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-5, atol=1e-5)


def test_decode_schedule_on_local_ids():
    """F's schedule twin on rank-local ids: id E (another rank's expert) is
    no visit and no weight; with no local selection every visit is a pad
    of expert 0 with weight 0, and the twin adds zeros."""
    idx = torch.tensor([[0, 4], [4, 2], [4, 4]])
    w = torch.tensor([[0.5, 0.0], [0.0, 0.25], [0.0, 0.0]])
    ve, valid = moe_decode.distinct_schedule(idx, 4)
    assert ve.tolist() == [0, 2, 2, 2] and valid.tolist() == [1, 1, 0, 0]
    table = moe_decode.combine_table(idx, w, ve, valid, 4)
    assert table.tolist() == [[0.5, 0.0, 0.0], [0.0, 0.25, 0.0], [0.0] * 3, [0.0] * 3]
    none = torch.full((2, 2), 4)
    ve, valid = moe_decode.distinct_schedule(none, 4)
    assert ve.tolist() == [0, 0, 0, 0] and valid.tolist() == [0, 0, 0, 0]
    experts = {"gate": torch.randn(4, 8, 16), "up": torch.randn(4, 8, 16), "down": torch.randn(4, 16, 8)}
    out = moe_decode.moe_ffn_decode_visits_reference(torch.randn(2, 16), experts, torch.zeros(2, 2), none)
    assert torch.equal(out, torch.zeros(2, 16))


@pytest.mark.parametrize("n", [2, 16])  # N k <= E: the per-selection form; above: F's twin
def test_decode_partial_in_f32(n):
    """Under EP a rank's decode MoE partial comes back in f32, not rounded
    (`moe_ffn_decode(..., out_dtype=torch.float32)`, as `_ffn_mp` asks): the
    two ranks' bf16-expert partials sum to the unsharded f32 result, and
    the default (x's dtype) is that result rounded once."""
    g = torch.Generator().manual_seed(3)
    e, k, h, i = 8, 2, 16, 8
    x = torch.randn(n, h, generator=g).to(torch.bfloat16)
    experts = {nm: (torch.randn(e, *shape, generator=g) * 0.3).to(torch.bfloat16)
               for nm, shape in (("gate", (i, h)), ("up", (i, h)), ("down", (h, i)))}
    weights, idx = torch.sort(torch.softmax(torch.randn(n, e, generator=g), -1), -1, descending=True)
    weights, idx = weights[:, :k], idx[:, :k]
    whole = moe_ffn_decode(x, experts, weights, idx, out_dtype=torch.float32)
    assert whole.dtype == torch.float32
    assert torch.equal(moe_ffn_decode(x, experts, weights, idx), whole.to(torch.bfloat16))
    parts = []
    for rank in range(2):
        w_l, idx_l = local_routing(weights, idx, e // 2, rank)
        local = {nm: t[rank * 4:(rank + 1) * 4] for nm, t in experts.items()}
        part = moe_ffn_decode(x, local, w_l, idx_l, n_rows=n, n_experts=e, out_dtype=torch.float32)
        assert part.dtype == torch.float32
        parts.append(part)
    torch.testing.assert_close(parts[0] + parts[1], whole, rtol=1e-6, atol=1e-6)
