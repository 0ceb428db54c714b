"""The debug prefill (`models.deepseek_v2.lm_forward_debug`: the
DEEPSEEK_DEBUG_ATTN / _MOE / _LAYER0 stat lines) on a sharded LM, on the
CPU: one 2-rank gloo world (`launch.launch(runs.run_cases, ...)`) runs it
at (dp, mp) = (1, 1), (1, 2) and (2, 1) on the JAX dryrun's tiny LM (f32,
one dense and two MoE layers of 8 experts, top-2), at B 2 x S 12 (24 rows:
the dense MoE form) and B 2 x S 300 (600 rows: the grouped form, the
cut-over reading the global rows under dp 2).

Every mesh prints the lines of the unsharded run and of the JAX package's
`lm_forward_debug` on the same embeddings, in the same order: the same
names, nan counts, shapes and dtypes, the same routing counts and top-k
ids, and min / max / top-k weights within 1e-5 of the line's largest
(`utils.debug.debug_line_gap`, which chip_smoke phase 10d applies on the
card; the sums over mp are taken in another order). Only rank 0 prints;
the final hidden is bit-equal on the mp ranks and within 1e-5 of the
unsharded run's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from reference_torch import random_lm_flat

from deepseek_ocr2_tpu.configs import tiny_lm_config
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
from deepseek_ocr2_tpu_torch.configs import tiny_lm_config as t_tiny_lm_config
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
from deepseek_ocr2_tpu_torch.parallel.launch import launch
from deepseek_ocr2_tpu_torch.parallel.runs import DEBUG_CHANNELS, run_cases
from deepseek_ocr2_tpu_torch.utils.debug import debug_line_gap

DIMS = dict(num_attention_heads=4, n_routed_experts=8, vocab_size=512, hidden_size=64, max_position_embeddings=320)
MESHES = [(1, 1), (1, 2), (2, 1)]
SHAPES = [(2, 12), (2, 300)]
TOL = 1e-5


def _ids(b, s):
    return np.random.default_rng(s).integers(0, DIMS["vocab_size"], (b, s))


@pytest.fixture(scope="module")
def world():
    cfg, tcfg = tiny_lm_config(**DIMS), t_tiny_lm_config(**DIMS)
    jp = jax.tree_util.tree_map(jnp.asarray, jdsv2.params_from_flat(random_lm_flat(cfg, seed=11), cfg)[0])
    params = tdsv2.params_from_jax(jp, tcfg)
    cases = [dict(name=f"{dp}x{mp} {s}", kind="debug", dp=dp, mp=mp, args=dict(cfg=tcfg, params=params, ids=_ids(b, s)))
             for dp, mp in MESHES for b, s in SHAPES]
    return cfg, jp, launch(run_cases, 2, (cases,))


@pytest.fixture(scope="module")
def jax_lines(world):
    """The JAX package's lines, unsharded, for each shape."""
    import contextlib
    import io
    import os

    cfg, jp, _ = world
    out = {}
    os.environ.update(dict.fromkeys(DEBUG_CHANNELS, "1"))
    try:
        for b, s in SHAPES:
            buf = io.StringIO()
            with contextlib.redirect_stderr(buf):
                jdsv2.lm_forward_debug(jp, cfg, jnp.take(jp["embed"], jnp.asarray(_ids(b, s)), axis=0))
            out[s] = [line for line in buf.getvalue().splitlines() if line.startswith("debug: ")]
    finally:
        for k in DEBUG_CHANNELS:
            os.environ.pop(k, None)
    return out


@pytest.mark.parametrize("s", [s for _, s in SHAPES])
@pytest.mark.parametrize("dp,mp", MESHES, ids=[f"{dp}x{mp}" for dp, mp in MESHES])
def test_sharded_debug_lines_equal_unsharded_and_jax(world, jax_lines, dp, mp, s):
    cfg, _, res = world
    got, ref = res[f"{dp}x{mp} {s}"], res[f"1x1 {s}"]
    n_layers = cfg.num_hidden_layers
    assert len(got["lines"]) == 2 * n_layers + 2 + 3 * (n_layers - 1)  # ATTN 2, LAYER0 2, MOE 3 a MoE layer
    assert debug_line_gap(got["lines"], jax_lines[s]) <= TOL  # raises on a name, shape, count or id apart
    assert debug_line_gap(got["lines"], ref["lines"]) <= TOL
    printed = np.asarray(got["printed"]).reshape(-1).tolist()
    assert printed == [len(got["lines"])] + [0] * (dp * mp - 1)  # once, by rank 0
    assert got["same_over_mp"]
    np.testing.assert_allclose(np.asarray(got["hidden"]), np.asarray(ref["hidden"]), rtol=TOL, atol=TOL)
