"""OCR fine-tuning through the vision towers in the PyTorch port
(`runtime/train.ocr_loss`, `adamw_ocr_train_step`, the towers'
`flat_from_params`) against the JAX package's, on the CPU at tiny widths
(`tiny_ocr2_config`: SAM 3 blocks, the last global; Qwen2 2 layers; the LM
2 layers, one dense and one MoE), the same numpy-seeded weights on both
sides.

- Each `flat_from_params` (SAM, Qwen2, the composite) gives the JAX
  package's names and bit-equal arrays, and round-trips through
  `params_from_flat`.
- The loss and every gradient leaf against `jax.value_and_grad(ocr_loss)`
  in f32, leaves compared by HF name through both composite
  `flat_from_params`: each leaf within 1e-5 of its largest entry (sums in
  another order through the towers, the LM and the backward; measured
  2.1e-6). No-crop above 512 rows (the port's MoE runs `MoeFfnGmm` with
  the twins, the JAX package its XLA grouped form) and at or below (the
  dense form on both), and a (2, 1) crop batch.
- uint8 pages (bf16 activations, bf16 towers): the loss within 2e-4
  relative and the gradient within 3e-2 relative L2 error, whole and the
  towers' part (see `test_uint8_pages_match_jax_in_bf16`).
- Three `adamw_ocr_train_step` losses against the JAX package's jitted
  step (rtol 1e-5); a resumed run bit-identical to a straight one; SAM's
  training form never reaches kernels B, C or V.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

import reference_torch_vision as refv
from deepseek_ocr2_tpu.configs import tiny_lm_config, tiny_ocr2_config
from deepseek_ocr2_tpu.models import deepseek_ocr2 as jocr2
from deepseek_ocr2_tpu.models import qwen2 as jqwen2
from deepseek_ocr2_tpu.models import sam as jsam
from deepseek_ocr2_tpu.runtime import train as jtrain
from deepseek_ocr2_tpu_torch.configs import tiny_lm_config as t_tiny_lm_config
from deepseek_ocr2_tpu_torch.configs import tiny_ocr2_config as t_tiny_ocr2_config
from deepseek_ocr2_tpu_torch.io import DtypePolicy
from deepseek_ocr2_tpu_torch.models import deepseek_ocr2 as tocr2
from deepseek_ocr2_tpu_torch.models import qwen2 as tqwen2
from deepseek_ocr2_tpu_torch.models import sam as tsam
from deepseek_ocr2_tpu_torch.ops import moe_gmm
from deepseek_ocr2_tpu_torch.runtime import train as ttrain

LEAF_RTOL = 1e-5
PLACEHOLDER = 500  # in the tiny vocabulary: its embedding row must get no gradient
START = 1  # BOS, then the placeholder block


def _configs(**kw):
    """The JAX and port configs (positions up to 320 for S 300)."""
    lm = dict(num_hidden_layers=2, max_position_embeddings=320)
    return (tiny_ocr2_config(lm=tiny_lm_config(**lm), **kw),
            t_tiny_ocr2_config(lm=t_tiny_lm_config(**lm), **kw))


@pytest.fixture(scope="module")
def model():
    cfg, tcfg = _configs(image_token_id=PLACEHOLDER)
    flat = refv.random_ocr2_flat(cfg, seed=5)
    jp, rep = jocr2.params_from_flat(flat, cfg)
    rep.raise_on_errors()
    return cfg, tcfg, flat, jax.tree_util.tree_map(jnp.asarray, jp)


def _torch_params(flat, tcfg, vision_dtype="float32"):
    """Fresh port params in f32 (the towers in `vision_dtype`): CPU tensors
    made from numpy arrays share their memory, and the steps update in
    place."""
    policy = DtypePolicy(default="float32")
    for prefix in ("model.sam_model", "model.qwen2_model", "model.projector", "model.view_seperator"):
        policy = policy.with_prefix(prefix, vision_dtype)
    params, rep = tocr2.params_from_flat({k: np.array(v) for k, v in flat.items()}, tcfg, policy=policy)
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


def _batch(cfg, b, s, crop=False, uint8=False, seed=0, placeholder=PLACEHOLDER):
    """ids [B, S]: BOS, the placeholder block, a transcript and 4 pad
    tokens; the loss mask on the transcript; images [-1, 1] f32 or raw
    uint8."""
    rng = np.random.default_rng(seed)
    n_img = cfg.image_token_count((2, 1) if crop else (1, 1))
    ids = np.full((b, s), placeholder, np.int64)
    ids[:, 0] = cfg.bos_token_id
    ids[:, START + n_img:] = rng.integers(2, PLACEHOLDER, (b, s - START - n_img))
    ids[:, -4:] = cfg.eos_token_id
    mask = np.zeros((b, s), np.float32)
    mask[:, START + n_img : s - 4] = 1.0

    def image(*shape):
        if uint8:
            return rng.integers(0, 256, shape).astype(np.uint8)
        return rng.uniform(-1, 1, shape).astype(np.float32)

    base = image(b, 3, cfg.base_image_size, cfg.base_image_size)
    patches = image(b, 2, 3, cfg.crop_image_size, cfg.crop_image_size) if crop else None
    return ids, base, patches, mask


def _jax_args(ids, base, patches, mask):
    return (jnp.asarray(ids, jnp.int32), jnp.asarray(base), None if patches is None else jnp.asarray(patches),
            START, jnp.asarray(mask))


def _torch_args(ids, base, patches, mask):
    return (torch.from_numpy(ids), torch.from_numpy(base), None if patches is None else torch.from_numpy(patches),
            START, torch.from_numpy(mask))


@pytest.fixture(scope="module")
def jax_value_and_grad():
    return jax.jit(jax.value_and_grad(jtrain.ocr_loss), static_argnums=(1, 5))


def _port_grads(params, tcfg, batch):
    loss, grads = ttrain.value_and_grad(ttrain.ocr_loss, params, tcfg, *_torch_args(*batch))
    assert not any(t.requires_grad for _, t in ttrain.param_items(params))
    return loss, {k: v.float().numpy() for k, v in tocr2.flat_from_params(_tree_like(params, grads), tcfg).items()}


def _jax_grads(jvg, jp, cfg, batch):
    loss, grads = jvg(jp, cfg, *_jax_args(*batch))
    return loss, {k: np.asarray(v, np.float32) for k, v in jocr2.flat_from_params(grads, cfg).items()}


def test_flat_from_params_bit_equal_to_jax_and_round_trips(model):
    cfg, tcfg, flat, jp = model
    params = _torch_params(flat, tcfg)
    pairs = [
        (jsam.flat_from_params(jp["sam"], cfg.sam), tsam.flat_from_params(params["sam"], tcfg.sam)),
        (jqwen2.flat_from_params(jp["qwen2"], cfg.qwen2), tqwen2.flat_from_params(params["qwen2"], tcfg.qwen2)),
        (jocr2.flat_from_params(jp, cfg), tocr2.flat_from_params(params, tcfg)),
    ]
    for want, got in pairs:
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            w = np.asarray(w)
            g = got[name].numpy()
            assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w), name
    composite = pairs[2][1]
    assert sorted(composite) == sorted(flat)
    again, rep = tocr2.params_from_flat({k: v.clone() for k, v in composite.items()}, tcfg)
    rep.raise_on_errors()
    assert not rep.missing
    for (n, a), (_, b) in zip(ttrain.param_items(params), ttrain.param_items(again)):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("b,s,crop", [(2, 300, False), (2, 100, False), (2, 100, True)],
                         ids=["no-crop-600-rows", "no-crop-200-rows", "crop-2x1"])
def test_loss_and_grads_match_jax(model, jax_value_and_grad, b, s, crop):
    cfg, tcfg, flat, jp = model
    if crop:  # the default placeholder id, out of the tiny vocabulary
        cfg, tcfg = _configs()
    batch = _batch(cfg, b, s, crop=crop, placeholder=cfg.image_token_id)
    loss, want = _jax_grads(jax_value_and_grad, jp, cfg, batch)
    params = _torch_params(flat, tcfg)
    before = moe_gmm.moe_gmm_dx.launches
    t_loss, got = _port_grads(params, tcfg, batch)
    assert moe_gmm.moe_gmm_dx.launches == before  # CPU: the twins
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=1e-6)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        scale = float(np.abs(w).max())
        if scale == 0:  # unused: the other query table, experts no row selected
            assert name.endswith("query_768.weight") or ".mlp.experts." in name, name
        np.testing.assert_allclose(got[name], w, rtol=0, atol=LEAF_RTOL * max(scale, 1e-12), err_msg=name)
    if not crop:  # the placeholder's embedding row: overwritten by the vision tokens
        assert not got["model.embed_tokens.weight"][PLACEHOLDER].any()
        assert not want["model.embed_tokens.weight"][PLACEHOLDER].any()
    for prefix in ("model.sam_model.", "model.qwen2_model.", "model.projector.", "model.view_seperator"):
        assert any(np.abs(g).sum() > 0 for n, g in got.items() if n.startswith(prefix)), f"no gradient reached {prefix}"


def test_uint8_pages_match_jax_in_bf16(model, jax_value_and_grad):
    """uint8 pages normalize with bf16 activations. The JAX package's
    Qwen2 scan takes one carry dtype, so its towers must be bf16 here (f32
    Qwen2 weights under bf16 activations raise there; the port casts the
    weights, as SAM does): towers bf16, LM f32. Both round to bf16 at the
    same points but sum in other orders, and one rounding that lands on
    the other side moves a value by a bf16 ulp (2^-8). A leaf's largest
    entry is no scale here: the global block's key bias gets only rounding
    noise (softmax ignores a shift of every key), and a near-tie can route
    a token to another expert. The bound is on the gradient as one vector
    and on the towers' part of it: relative L2 error within 3e-2 (measured
    0.0066-0.0166 whole and 0.0078-0.0183 towers over seeds 1-4); the loss
    within 2e-4 relative (measured 1.2e-5 - 6.1e-5)."""
    cfg, tcfg, flat, jp = model
    jp16 = {k: (v if k == "lm" else jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), v))
            for k, v in jp.items()}
    batch = _batch(cfg, 2, 100, uint8=True, seed=1)
    assert batch[1].dtype == np.uint8
    loss, want = _jax_grads(jax_value_and_grad, jp16, cfg, batch)
    params = _torch_params(flat, tcfg, vision_dtype="bfloat16")
    t_loss, got = _port_grads(params, tcfg, batch)
    np.testing.assert_allclose(float(t_loss), float(loss), rtol=2e-4)
    assert sorted(got) == sorted(want)
    towers = [n for n in want if n.startswith(("model.sam_model.", "model.qwen2_model.", "model.projector.",
                                               "model.view_seperator"))]
    for names in (list(want), towers):
        err = np.sqrt(sum(np.sum((got[n] - want[n]) ** 2) for n in names))
        ref = np.sqrt(sum(np.sum(want[n] ** 2) for n in names))
        assert err <= 3e-2 * ref, (len(names), err / ref)
    # The CLI's policy (f32 towers) with uint8 pages, which the JAX package
    # cannot run: finite, and near the bf16 towers' loss (measured 2e-5 -
    # 7.2e-5 relative over seeds 1-3).
    f32_loss, _ = ttrain.value_and_grad(ttrain.ocr_loss, _torch_params(flat, tcfg), tcfg, *_torch_args(*batch))
    assert abs(float(f32_loss) - float(loss)) <= 1e-3 * abs(float(loss))


def test_adamw_ocr_steps_match_jax(model):
    cfg, tcfg, flat, jp = model
    batch = _batch(cfg, 2, 100, seed=2)
    tx_j = jtrain.make_optimizer(lr=3e-3)
    p_j = jax.tree_util.tree_map(jnp.array, jp)  # the jitted step donates its params
    st_j = jtrain.init_opt_state(tx_j, p_j)
    want = []
    for _ in range(3):
        p_j, st_j, loss = jtrain.adamw_ocr_train_step(p_j, st_j, cfg, *_jax_args(*batch), tx_j)
        want.append(float(loss))
    tx = ttrain.make_optimizer(lr=3e-3)
    params = _torch_params(flat, tcfg)
    state = tx.init(params)
    got = [float(ttrain.adamw_ocr_train_step(params, state, tcfg, *_torch_args(*batch), tx)) for _ in range(3)]
    assert got[2] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_resumed_ocr_run_is_bit_identical(model, tmp_path):
    cfg, tcfg, flat, _ = model
    batches = [_torch_args(*_batch(cfg, 2, 60, crop=s % 2 == 1, seed=10 + s)) for s in range(4)]
    tx = ttrain.make_optimizer(lr=3e-3, grad_accum=2)

    def fresh():
        params = _torch_params(flat, tcfg)
        return params, tx.init(params)

    straight, st = fresh()
    losses = [float(ttrain.adamw_ocr_train_step(straight, st, tcfg, *b, tx)) for b in batches]
    first, st = fresh()
    for b in batches[:3]:
        ttrain.adamw_ocr_train_step(first, st, tcfg, *b, tx)
    path = str(tmp_path / "state.safetensors")
    ttrain.save_train_state(path, first, st, 3)
    resumed, st = fresh()
    assert ttrain.load_train_state(path, resumed, st) == 3 and st["mini_step"] == 1 and st["count"] == 1
    assert float(ttrain.adamw_ocr_train_step(resumed, st, tcfg, *batches[3], tx)) == losses[3]
    for (n, a), (_, b) in zip(ttrain.param_items(straight), ttrain.param_items(resumed)):
        assert torch.equal(a, b), n
    assert any(n.startswith("sam.") for n, _ in ttrain.param_items(resumed))


@pytest.mark.parametrize("win_kernel", ["", "1"])
def test_sam_training_form_never_reaches_kernels(model, monkeypatch, win_kernel):
    """training=True never calls the wrappers of B, V or C (patched to
    raise), whatever DEEPSEEK_SAM_WIN_KERNEL says; the default form still
    goes through them (on the CPU they run their twins) and gives the
    same features."""
    cfg, tcfg, flat, _ = model
    params = _torch_params(flat, tcfg)
    x = torch.from_numpy(_batch(cfg, 2, 40)[1])
    monkeypatch.setenv("DEEPSEEK_SAM_WIN_KERNEL", win_kernel)
    calls = []
    for name in ("mha_relpos", "mha_win", "mlp_gelu"):
        wrapped = getattr(tsam, name)
        monkeypatch.setattr(tsam, name, lambda *a, _w=wrapped, _n=name, **k: (calls.append(_n), _w(*a, **k))[1])
    want = tsam.sam_forward(params["sam"], tcfg.sam, x)
    assert set(calls) == {"mha_win" if win_kernel else "mha_relpos", "mlp_gelu"} | ({"mha_relpos"} if win_kernel else set())

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called by the training form")

    for name in ("mha_relpos", "mha_win", "mlp_gelu"):
        monkeypatch.setattr(tsam, name, refuse)
    with torch.enable_grad():
        got = tsam.sam_forward(params["sam"], tcfg.sam, x.requires_grad_(True), training=True)
        got.sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    torch.testing.assert_close(got.detach(), want, rtol=1e-5, atol=1e-5)
