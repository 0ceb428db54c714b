"""The port's sharded AdamW step at (dp, mp) = (1, 2) and (2, 1) against
the JAX package's under its own mesh, and `greedy_generate` on sharded
params at (2, 2), on the CPU: the second half of
tests/test_torch_parallel.py (whose helpers and tiny LM it shares), in a
module of its own so that each module's 8-rank world and JAX compiles stay
near a minute in one process.

- The step as in tests/test_torch_parallel.py: loss and three steps'
  losses rtol 1e-5, every gathered gradient leaf within 1e-5 of its
  largest entry, the replicated leaves equal across mp.
- Greedy decoding of 6 rows at (2, 2) (N k 12 > E 8, so the
  distinct-expert path, F's twin, runs on each rank's 4 experts): tokens
  equal to the JAX package's under its mesh, and the same on every rank.
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

from deepseek_ocr2_tpu import parallel as jpar  # noqa: E402
from deepseek_ocr2_tpu.runtime.generate import greedy_generate as jgreedy  # noqa: E402
from test_torch_parallel import _ids, _jax_mesh, build_world, check_adamw_step, jax_grads_of  # noqa: E402

MESHES = [(1, 2), (2, 1)]


def _greedy_case(tcfg, params):
    return [dict(name="greedy", kind="greedy", dp=2, mp=2,
                 args=dict(cfg=tcfg, params=params, ids=_ids(6, 12, 2), max_new_tokens=6, ngram_size=3, eos_id=1,
                           capacity=32, kv_dtype=torch.float32))]


@pytest.fixture(scope="module")
def world():
    return build_world(MESHES, _greedy_case)


@pytest.fixture(scope="module")
def jax_grads(world):
    return jax_grads_of(world)


@pytest.mark.parametrize("dp,mp", MESHES, ids=[f"{dp}x{mp}" for dp, mp in MESHES])
def test_adamw_step_matches_jax_mesh(world, jax_grads, dp, mp):
    check_adamw_step(world, jax_grads, dp, mp)


def test_greedy_on_sharded_params_gives_jax_tokens(world):
    cfg, _, jp, _, results = world
    ids = _ids(6, 12, 2)
    mesh = _jax_mesh(2, 2)
    with mesh:
        params = jpar.shard_params(jax.tree_util.tree_map(jnp.array, jp), mesh, jpar.lm_param_specs(cfg))
        ids_j = jax.device_put(jnp.asarray(ids, jnp.int32), NamedSharding(mesh, P("dp", None)))
        tokens, n_gen = jgreedy(params, cfg, jnp.take(params["embed"], ids_j, axis=0), ids_j, max_new_tokens=6,
                                ngram_size=3, eos_id=1, capacity=32, kv_dtype="float32")
    got = results["greedy"]
    np.testing.assert_array_equal(got["tokens"], np.asarray(tokens))
    np.testing.assert_array_equal(got["n_gen"], np.asarray(n_gen))
    assert got["same_on_every_rank"]
