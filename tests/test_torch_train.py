"""LM fine-tuning in the PyTorch port (`runtime/train.py`, `train` CLI)
against the JAX package's `runtime/train.py` and optax, on the CPU at tiny
widths (`tiny_lm_config`, 2 layers: one dense, one MoE).

- Loss and every gradient leaf against `jax.value_and_grad(lm_loss)` above
  512 rows (B 3, S 200: the port's MoE runs `MoeFfnGmm` with the twins, the
  JAX package its XLA grouped form, as its CPU path does) and at or below
  (B 2, S 100: the dense form on both), f32: each leaf within 1e-5 of its
  largest entry (sums in another order through two layers and the
  backward; measured 1.3e-6). Leaves are compared by HF name through each
  package's `flat_from_params`.
- The optimizer fed the JAX package's gradients against optax
  (`make_optimizer` of the JAX package: clip, AdamW, schedules,
  MultiSteps) within 1e-6: the same f32 operations in the same order.
- Three AdamW steps' losses against the jitted `adamw_train_step`; `remat`
  and a resumed run are bit-identical to a plain, straight run; SFT
  masking; the CLI's loss lines, resume and `--out`, loaded by the JAX
  package, and its `--mesh` shape refusals.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

sys.path.insert(0, str(Path(__file__).resolve().parent))

from reference_torch import random_lm_flat  # noqa: E402

from deepseek_ocr2_tpu.configs import tiny_lm_config  # noqa: E402
from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2  # noqa: E402
from deepseek_ocr2_tpu.runtime import train as jtrain  # noqa: E402
from deepseek_ocr2_tpu_torch.configs import tiny_lm_config as t_tiny_lm_config  # noqa: E402
from deepseek_ocr2_tpu_torch.io import DtypePolicy  # noqa: E402
from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2  # noqa: E402
from deepseek_ocr2_tpu_torch.ops import moe_gmm  # noqa: E402
from deepseek_ocr2_tpu_torch.runtime import train as ttrain  # noqa: E402

LEAF_RTOL = 1e-5


@pytest.fixture(scope="module")
def lm():
    cfg, tcfg = tiny_lm_config(num_hidden_layers=2), t_tiny_lm_config(num_hidden_layers=2)
    flat = random_lm_flat(cfg, seed=3)
    jp, rep = jdsv2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    return cfg, tcfg, flat, jax.tree_util.tree_map(jnp.asarray, jp)


def _torch_params(flat, tcfg):
    """Fresh port params (CPU tensors made from numpy arrays share their
    memory, and the train steps update in place)."""
    flat = {k: np.array(v) for k, v in flat.items()}
    params, rep = tdsv2.params_from_flat(flat, tcfg, policy=DtypePolicy(default="float32"))
    rep.raise_on_errors()
    assert not rep.missing
    return params


def _tree_like(params, tensors):
    """The tensors (in `param_items` order) in the params' tree."""
    it = iter(tensors)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return [build(v) for v in node]

    return build(params)


def _ids(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


@pytest.fixture(scope="module")
def jax_value_and_grad():
    return jax.jit(jax.value_and_grad(jtrain.lm_loss), static_argnums=(1,))


@pytest.mark.parametrize("b,s", [(3, 200), (2, 100)])
def test_loss_and_grads_match_jax(lm, jax_value_and_grad, b, s):
    cfg, tcfg, flat, jp = lm
    ids = _ids(b, s, cfg.vocab_size)
    loss, grads = jax_value_and_grad(jp, cfg, jnp.asarray(ids, jnp.int32))
    want = {k: np.asarray(v) for k, v in jdsv2.flat_from_params(grads, cfg).items()}
    params = _torch_params(flat, tcfg)
    before = moe_gmm.moe_gmm_dx.launches
    t_loss, t_grads = ttrain.value_and_grad(ttrain.lm_loss, params, tcfg, torch.from_numpy(ids))
    assert moe_gmm.moe_gmm_dx.launches == before  # CPU: the twins
    assert not any(t.requires_grad for _, t in ttrain.param_items(params))
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-6)
    got = tdsv2.flat_from_params(_tree_like(params, t_grads), tcfg)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0 or name.startswith("model.layers.1.mlp.experts."), name
        np.testing.assert_allclose(g, w, rtol=0, atol=LEAF_RTOL * max(scale, 1e-12), err_msg=name)


def _opt_cases():
    return [
        dict(lr=1e-3),
        dict(lr=1e-3, warmup_steps=3),
        dict(lr=1e-3, schedule="cosine", warmup_steps=2, total_steps=6),
        dict(lr=1e-3, schedule="cosine", total_steps=6, grad_accum=2, warmup_steps=2),
        dict(lr=2e-3, grad_accum=3, weight_decay=0.1, clip_norm=0.5),
    ]


@pytest.mark.parametrize("kw", _opt_cases(), ids=["constant", "warmup", "cosine", "cosine-accum", "accum"])
def test_optimizer_matches_optax(lm, jax_value_and_grad, kw):
    """Params after each of 6 steps, fed the JAX package's gradients of the
    tiny LM (scaled per step so the global norm falls on both sides of the
    clip), against optax through the JAX package's `make_optimizer`."""
    cfg, _, flat, jp = lm
    _, grads = jax_value_and_grad(jp, cfg, jnp.asarray(_ids(2, 24, cfg.vocab_size), jnp.int32))
    g_flat = {k: np.asarray(v) for k, v in jdsv2.flat_from_params(grads, cfg).items()}
    p_np = {k: np.asarray(flat[k], np.float32) for k in g_flat}
    tx_j = jtrain.make_optimizer(**kw)
    p_j = {k: jnp.asarray(v) for k, v in p_np.items()}
    st_j = tx_j.init(p_j)
    tx_t = ttrain.make_optimizer(**kw)
    p_t = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    st_t = tx_t.init(p_t)
    names = [n for n, _ in ttrain.param_items(p_t)]

    @jax.jit
    def step_j(g, st, p):
        upd, st = tx_j.update(g, st, p)
        return jax.tree_util.tree_map(lambda a, u: a + u, p, upd), st

    for step, scale in enumerate((0.3, 3.0, 0.05, 8.0, 1.0, 0.5)):
        g = {k: v * np.float32(scale * (-1) ** step) for k, v in g_flat.items()}
        p_j, st_j = step_j({k: jnp.asarray(v) for k, v in g.items()}, st_j, p_j)
        tx_t.update([torch.from_numpy(g[n]) for n in names], st_t, p_t)
        for n in names:
            np.testing.assert_allclose(p_t[n].numpy(), np.asarray(p_j[n]), rtol=0, atol=1e-6,
                                       err_msg=f"step {step} {n}")


def test_adamw_steps_match_jax(lm):
    cfg, tcfg, flat, jp = lm
    ids = _ids(2, 24, cfg.vocab_size, seed=1)
    tx_j = jtrain.make_optimizer(lr=5e-3)
    st_j = jtrain.init_opt_state(tx_j, jp)
    jp = jax.tree_util.tree_map(jnp.array, jp)  # adamw_train_step donates its params
    params = _torch_params(flat, tcfg)
    tx_t = ttrain.make_optimizer(lr=5e-3)
    st_t = tx_t.init(params)
    want, got = [], []
    for _ in range(3):
        jp, st_j, loss = jtrain.adamw_train_step(jp, st_j, cfg, jnp.asarray(ids, jnp.int32), tx_j)
        want.append(float(loss))
        got.append(float(ttrain.adamw_train_step(params, st_t, tcfg, torch.from_numpy(ids), tx_t)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_remat_matches_plain_and_resume_is_bit_identical(lm, tmp_path):
    """remat (each MoE layer recomputed in the backward) gives the same
    bits; 4 AdamW steps (grad_accum 2, cosine) straight equal 2 steps, a
    save, a load into fresh params and state, and 2 more."""
    _, tcfg, flat, _ = lm
    ids = [torch.from_numpy(_ids(3, 200, tcfg.vocab_size, seed=s)) for s in range(4)]
    params = _torch_params(flat, tcfg)
    _, plain = ttrain.value_and_grad(ttrain.lm_loss, params, tcfg, ids[0])
    _, remat = ttrain.value_and_grad(ttrain.lm_loss, params, tcfg, ids[0], True)
    for a, b in zip(plain, remat):
        assert torch.equal(a, b)

    kw = dict(lr=1e-3, grad_accum=2, schedule="cosine", total_steps=4)
    tx = ttrain.make_optimizer(**kw)
    straight = _torch_params(flat, tcfg)
    st = tx.init(straight)
    for step in range(4):
        ttrain.adamw_train_step(straight, st, tcfg, ids[step], tx)
    first = _torch_params(flat, tcfg)
    st = tx.init(first)
    for step in range(2):
        ttrain.adamw_train_step(first, st, tcfg, ids[step], tx)
    ttrain.save_train_state(str(tmp_path / "state.safetensors"), first, st, 2)
    resumed = _torch_params(flat, tcfg)
    st2 = tx.init(resumed)
    assert ttrain.load_train_state(str(tmp_path / "state.safetensors"), resumed, st2) == 2
    assert st2["count"] == st["count"] == 1 and st2["mini_step"] == 0
    for step in range(2, 4):
        ttrain.adamw_train_step(resumed, st2, tcfg, ids[step], tx)
    for (name, a), (_, b) in zip(ttrain.param_items(straight), ttrain.param_items(resumed)):
        assert torch.equal(a, b), name


def test_sft_masked_loss_matches_jax(lm):
    cfg, tcfg, flat, jp = lm
    ids = _ids(2, 40, cfg.vocab_size, seed=5)
    mask = np.zeros((2, 40), np.float32)
    mask[0, 10:30] = 1.0
    mask[1, 25:] = 1.0
    ids[0, 30:] = 10**6  # pad ids out of vocab where the mask is 0
    ids_safe = np.where(ids >= cfg.vocab_size, 0, ids)  # the embedding lookup needs in-range ids
    want = float(jax.jit(jtrain.lm_loss_masked, static_argnums=(1,))(
        jp, cfg, jnp.asarray(ids_safe, jnp.int32), jnp.asarray(mask)))
    params = _torch_params(flat, tcfg)
    with torch.no_grad():
        got = float(ttrain.lm_loss_masked(params, tcfg, torch.from_numpy(ids_safe), torch.from_numpy(mask)))
        full = float(ttrain.lm_loss_masked(params, tcfg, torch.from_numpy(ids_safe), torch.ones(2, 40)))
        plain = float(ttrain.lm_loss(params, tcfg, torch.from_numpy(ids_safe)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(full, plain, rtol=1e-6)


@pytest.fixture(scope="module")
def cli_assets(tmp_path_factory, lm):
    from tokenizers import Tokenizer, models, pre_tokenizers

    from deepseek_ocr2_tpu_torch.io import save_flat

    cfg, _, flat, _ = lm
    d = tmp_path_factory.mktemp("torch_train_cli")
    save_flat(flat, str(d / "tiny.safetensors"))
    json.dump({"lm": dataclasses.asdict(cfg)}, open(d / "config.json", "w"))
    tok = Tokenizer(models.WordLevel({"<unk>": 2, "Free": 10, "OCR.": 11, "hello": 13}, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(d / "tokenizer.json"))
    with open(d / "data.jsonl", "w") as f:
        for _ in range(8):
            f.write('{"text": "hello Free OCR. hello hello Free"}\n')
    with open(d / "sft.jsonl", "w") as f:
        for _ in range(3):
            f.write('{"prompt": "hello Free", "completion": "OCR. hello"}\n')
    with open(d / "mixed.jsonl", "w") as f:
        f.write('{"text": "hello"}\n{"prompt": "hello", "completion": "Free"}\n')
    return d


def _train(d, capsys, *extra, data="data.jsonl"):
    from deepseek_ocr2_tpu_torch import cli

    argv = ["train", "--backend", "cpu", "--weights", str(d / "tiny.safetensors"), "--tokenizer",
            str(d / "tokenizer.json"), "--config", str(d / "config.json"), "--data", str(d / data),
            "--batch-size", "2", "--seq-len", "16", "--lr", "1e-3", *extra]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    return [float(line.split("loss")[1].split()[0]) for line in out.splitlines() if line.startswith("step ")]


def test_cli_train_resume_sft_and_export_loads_in_jax(cli_assets, capsys, lm):
    from deepseek_ocr2_tpu.io import DtypePolicy as JaxPolicy
    from deepseek_ocr2_tpu.io import load_flat as jax_load_flat

    from deepseek_ocr2_tpu_torch import cli

    cfg = lm[0]
    d = cli_assets
    losses = _train(d, capsys, "--steps", "4", "--out", str(d / "straight.safetensors"),
                    "--log-file", str(d / "log.jsonl"))
    assert len(losses) == 4 and all(np.isfinite(losses)) and losses[-1] < losses[0]
    log = [json.loads(line) for line in open(d / "log.jsonl")]
    assert [r["step"] for r in log] == [1, 2, 3, 4] and [r["loss"] for r in log] == pytest.approx(losses, abs=1e-4)
    _train(d, capsys, "--steps", "4", "--save-every", "2", "--state-out", str(d / "state.safetensors"))
    # The state file now holds step 4; resuming at 4 of 4 runs no step: a
    # second run saves at step 2 only, then resumes from it.
    _train(d, capsys, "--steps", "2", "--state-out", str(d / "state2.safetensors"))
    resumed = _train(d, capsys, "--steps", "4", "--resume", str(d / "state2.safetensors"),
                     "--out", str(d / "resumed.safetensors"))
    assert resumed == losses[2:]
    a = jax_load_flat(str(d / "straight.safetensors"), JaxPolicy(default=None))
    b = jax_load_flat(str(d / "resumed.safetensors"), JaxPolicy(default=None))
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)
    params, report = jdsv2.params_from_flat(a, cfg)
    report.raise_on_errors()
    assert not report.missing and not report.skipped
    sft = _train(d, capsys, "--steps", "2", data="sft.jsonl")
    assert len(sft) == 2 and all(np.isfinite(sft))
    with pytest.raises(SystemExit, match="mixes"):
        _train(d, capsys, "--steps", "1", data="mixed.jsonl")
    # --mesh checks its shape before it reads a file: dp must divide the
    # batch, mp the default config's 10 heads.
    with pytest.raises(SystemExit, match="divisible by dp=3"):
        cli.main(["train", "--backend", "cpu", "--weights", "w", "--tokenizer", "t", "--data", "d",
                  "--mesh", "3,1"])
    with pytest.raises(SystemExit, match="mp=4 does not divide num_attention_heads=10"):
        cli.main(["train", "--backend", "cpu", "--weights", "w", "--tokenizer", "t", "--data", "d",
                  "--mesh", "1,4"])
