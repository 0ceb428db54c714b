"""Fine-tuning (port of deepseek_ocr2_tpu.runtime.train, without optax).

- `lm_loss` / `lm_loss_masked`: next-token cross-entropy in f32 over the
  training forward (`lm_forward(..., training=True)`: plain causal
  attention, the differentiable grouped-GEMM MoE above 512 rows); masked
  targets are made safe (0) before the CE, as in the JAX package.
- `ocr_loss`: the masked CE through the whole composite on (image,
  transcript) pairs: SAM's training form (plain rel-pos attention and MLP,
  `models.sam`), Qwen2, the projector and separator, the injection into
  the placeholder block, then the LM's training forward.
- `make_optimizer` -> `AdamW`: optax's `chain(clip_by_global_norm,
  adamw)` (b1 0.9, b2 0.95, eps 1e-8, decay on every leaf), its constant,
  linear-warmup and `warmup_cosine_decay_schedule` (to lr / 10) learning
  rates, and `MultiSteps` for `grad_accum` > 1 (the running mean of the
  micro-batch gradients, one update every k-th step, schedules counted in
  updates), the step itself `torch.optim.AdamW(fused=True)`. Moments and
  the accumulator are stored in the params' dtype, as optax makes them;
  the arithmetic is f32.
- `sgd_train_step`, `adamw_train_step`, `adamw_sft_train_step`,
  `adamw_ocr_train_step`: one step;
  the JAX functions return new params, these update the params (and the
  optimizer state) in place and return the loss, a 0-d tensor on the
  params' device (no host sync inside a step).
- `save_train_state` / `load_train_state`: params, moments, accumulator and
  counts in one safetensors file, written to a temporary file and moved
  into place; a resumed run is bit-identical to a straight one.

The params are the port's LM tree (`models.deepseek_v2.params_from_flat`)
or, for the OCR step, its composite tree (`models.deepseek_ocr2`: "lm",
"sam", "qwen2", "projector_w", "projector_b", "view_seperator"): nested
dicts and lists of tensors, whose leaves `param_items` names by path
("layers.3.experts.gate", "sam.blocks.2.qkv_w"). The optimizer state holds
one tensor per leaf, in that order.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..configs import DeepseekV2Config
from ..io.safetensors_torch import load_flat, save_flat
from ..models.deepseek_ocr2 import normalize_pixels, ocr_prefill_embeds_batched
from ..models.deepseek_v2 import lm_forward, logits_all


def param_items(params) -> List[Tuple[str, torch.Tensor]]:
    """The tensor leaves of a param tree with dotted paths, in a fixed
    order (dict keys sorted, lists in order)."""
    out: List[Tuple[str, torch.Tensor]] = []

    def walk(node, path):
        if isinstance(node, torch.Tensor):
            out.append((path, node))
        elif isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{path}.{key}" if path else key)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}" if path else str(i))

    walk(params, "")
    return out


def _logits(params, cfg: DeepseekV2Config, ids: torch.Tensor, remat: bool) -> torch.Tensor:
    embeds = F.embedding(ids, params["embed"])
    hidden = lm_forward(params, cfg, embeds, None, training=True, remat=remat)
    return logits_all(params, hidden).float()  # [B, S, V]


def lm_loss(params, cfg: DeepseekV2Config, ids: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy over [B, S] token ids (f32 loss math)."""
    logits = _logits(params, cfg, ids, remat)
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), ids[:, 1:].reshape(-1))


def lm_loss_masked(params, cfg: DeepseekV2Config, ids: torch.Tensor, loss_mask: torch.Tensor,
                   remat: bool = False) -> torch.Tensor:
    """Next-token CE restricted to positions where loss_mask is 1 (SFT:
    train on the completion, not the prompt or padding)."""
    return _masked_ce(_logits(params, cfg, ids, remat), ids, loss_mask)


def _masked_ce(logits: torch.Tensor, ids: torch.Tensor, loss_mask: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE of f32 logits [B, S, V] over the targets where
    loss_mask[:, 1:] is 1; the other targets are made safe (0) first, since
    pad and placeholder ids may be out of vocab."""
    m = loss_mask[:, 1:].float()
    targets = torch.where(m > 0, ids[:, 1:], 0)
    per_tok = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]), targets.reshape(-1),
                              reduction="none").reshape(m.shape)
    return (per_tok * m).sum() / m.sum().clamp(min=1.0)


def ocr_loss(params, cfg, ids: torch.Tensor, image_base: torch.Tensor, patches, image_start: int,
             loss_mask: torch.Tensor) -> torch.Tensor:
    """Masked next-token CE through the whole composite (an OCR2Config and
    its params tree): `ids` [B, S] with the placeholder block at
    `image_start`, `image_base` [B, 3, S_img, S_img] and `patches` [B, P,
    3, c, c] or None, each [-1, 1] floats (kept in their dtype) or raw
    uint8 (normalized with bf16 activations), `loss_mask` [B, S] 1.0 where
    the token is a training target. Gradients reach SAM, Qwen2, the
    projector and the separator as well as the LM."""
    act = torch.bfloat16 if image_base.dtype == torch.uint8 else image_base.dtype
    image_base = normalize_pixels(image_base, act)
    if patches is not None:
        patches = normalize_pixels(patches, act)
    embeds = ocr_prefill_embeds_batched(params, cfg, ids, image_base, patches, image_start, training=True)
    hidden = lm_forward(params["lm"], cfg.lm, embeds, None, training=True)
    return _masked_ce(logits_all(params["lm"], hidden).float(), ids, loss_mask)


def value_and_grad(loss_fn: Callable, params, *args, **kwargs) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, grads) of loss_fn(params, *args) with respect to every leaf of
    `params`, grads in `param_items` order (zeros for a leaf the loss does
    not reach). The leaves require grad only during the call."""
    leaves = [t for _, t in param_items(params)]
    try:
        with torch.enable_grad():
            for t in leaves:
                t.requires_grad_(True)
            loss = loss_fn(params, *args, **kwargs)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), grads


@torch.no_grad()
def sgd_train_step(params, cfg: DeepseekV2Config, ids: torch.Tensor, lr: float = 1e-4) -> torch.Tensor:
    """One SGD step (p - lr g in f32, cast back); returns the loss."""
    loss, grads = value_and_grad(lm_loss, params, cfg, ids)
    for (_, p), g in zip(param_items(params), grads):
        p.copy_((p.float() - lr * g.float()).to(p.dtype))
    return loss


# ---------------------------------------------------------------------------
# The optimizer


def _linear(init: float, end: float, steps: int, count: int) -> float:
    """optax.linear_schedule(init, end, steps)(count)."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


@dataclasses.dataclass(frozen=True)
class AdamW:
    """clip_by_global_norm(clip_norm) then adamw(lr schedule, b1, b2, eps,
    weight_decay), wrapped in MultiSteps when grad_accum > 1. Build it with
    `make_optimizer`; `warmup_steps` and `total_steps` count updates."""

    lr: float = 1e-4
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    clip_norm: float = 1.0
    grad_accum: int = 1
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0

    def learning_rate(self, count: int) -> float:
        """The schedule at `count` updates already made (optax's count)."""
        lr, warm = self.lr, self.warmup_steps
        if self.schedule == "cosine":
            # warmup_cosine_decay_schedule(init, peak lr, warm, decay, end lr / 10)
            decay = max(self.total_steps, warm + 1)
            init = 0.0 if warm else lr
            if count < warm:
                return _linear(init, lr, warm, count)
            alpha = 0.1
            c = min(count - warm, decay - warm)
            cosine = 0.5 * (1.0 + math.cos(math.pi * c / (decay - warm)))
            return lr * ((1.0 - alpha) * cosine + alpha)
        if warm:
            return _linear(0.0, lr, warm, count)
        return lr

    def init(self, params) -> dict:
        """Zero moments (and accumulator) in each leaf's dtype and device."""
        leaves = [t for _, t in param_items(params)]
        state = {"count": 0, "mu": [torch.zeros_like(t) for t in leaves],
                 "nu": [torch.zeros_like(t) for t in leaves]}
        if self.grad_accum > 1:
            state["acc"] = [torch.zeros_like(t) for t in leaves]
            state["mini_step"] = 0
        return state

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: dict, params) -> None:
        """Apply one step's gradients (`param_items` order) to params and
        state in place. With grad_accum k, the gradients join the running
        mean and the params change on every k-th call only.

        The whole step is a few multi-tensor kernels: the global norm, the
        clip scale, and `torch.optim.AdamW(fused=True)` over every leaf, its
        moments the state's tensors (f32 arithmetic, stored in the leaves'
        dtypes). Its decoupled decay p (1 - lr wd) and step p - (lr / bc1)
        mu / (sqrt(nu) / sqrt(bc2) + eps) are optax's p - lr (mu_hat /
        (sqrt(nu_hat) + eps) + wd p) with other rounding."""
        leaves = [t for _, t in param_items(params)]
        if len(grads) != len(leaves):
            raise ValueError(f"{len(grads)} gradients for {len(leaves)} parameters")
        # The multi-tensor kernels walk each tensor's memory flat: a gradient
        # autograd laid out otherwise (e.g. from an einsum) is copied into
        # its leaf's layout.
        grads = [g if g.stride() == p.stride() else torch.empty_like(p).copy_(g) for p, g in zip(leaves, grads)]
        if self.grad_accum > 1:
            n = state["mini_step"]
            torch._foreach_lerp_(state["acc"], grads, 1.0 / (n + 1))  # acc + (g - acc) / (n + 1), as MultiSteps
            if n + 1 < self.grad_accum:
                state["mini_step"] = n + 1
                return
            state["mini_step"] = 0
            grads = state["acc"]
        # clip_by_global_norm: kept below clip_norm, else scaled to it; the
        # norm stays on the device.
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32)))
        scale = torch.where(norm < self.clip_norm, torch.ones_like(norm), self.clip_norm / norm)
        grads = torch._foreach_mul(grads, scale)
        opt = torch.optim.AdamW(leaves, lr=self.learning_rate(state["count"]), betas=(self.b1, self.b2),
                                eps=self.eps, weight_decay=self.weight_decay, fused=True)
        for p, g, mu, nu in zip(leaves, grads, state["mu"], state["nu"]):
            p.grad = g
            opt.state[p] = {"step": torch.full((), float(state["count"]), dtype=torch.float32, device=p.device),
                            "exp_avg": mu, "exp_avg_sq": nu}
        opt.step()
        for p in leaves:
            p.grad = None
        state["count"] += 1
        if self.grad_accum > 1:
            for a in state["acc"]:
                a.zero_()


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.95,
                   clip_norm: float = 1.0, grad_accum: int = 1, schedule: str = "constant",
                   warmup_steps: int = 0, total_steps: int = 0) -> AdamW:
    """AdamW with global-norm clipping (the fine-tuning default), as the
    JAX package's `make_optimizer`: with grad_accum > 1 the warmup and
    total train steps are converted to optimizer updates (ceil division);
    "cosine" needs total_steps."""
    if schedule not in ("constant", "cosine"):
        raise ValueError(f"schedule is 'constant' or 'cosine', got {schedule!r}")
    if grad_accum > 1:
        warmup_steps = -(-warmup_steps // grad_accum) if warmup_steps else 0
        total_steps = -(-total_steps // grad_accum) if total_steps else 0
    if schedule == "cosine" and total_steps <= 0:
        raise ValueError("cosine schedule needs total_steps")
    return AdamW(lr=lr, weight_decay=weight_decay, b1=b1, b2=b2, clip_norm=clip_norm, grad_accum=grad_accum,
                 schedule=schedule, warmup_steps=warmup_steps, total_steps=total_steps)


def adamw_train_step(params, opt_state: dict, cfg: DeepseekV2Config, ids: torch.Tensor, tx: AdamW,
                     remat: bool = False) -> torch.Tensor:
    """One AdamW step on packed text; params and opt_state change in
    place. Returns the loss."""
    loss, grads = value_and_grad(lm_loss, params, cfg, ids, remat)
    tx.update(grads, opt_state, params)
    return loss


def adamw_sft_train_step(params, opt_state: dict, cfg: DeepseekV2Config, ids: torch.Tensor,
                         loss_mask: torch.Tensor, tx: AdamW, remat: bool = False) -> torch.Tensor:
    """One AdamW step on (prompt, completion) pairs with the masked loss."""
    loss, grads = value_and_grad(lm_loss_masked, params, cfg, ids, loss_mask, remat)
    tx.update(grads, opt_state, params)
    return loss


def adamw_ocr_train_step(params, opt_state: dict, cfg, ids: torch.Tensor, image_base: torch.Tensor, patches,
                         image_start: int, loss_mask: torch.Tensor, tx: AdamW) -> torch.Tensor:
    """One AdamW step on (image, transcript) pairs over every leaf of the
    composite tree (`ocr_loss`); params and opt_state change in place.
    Returns the loss."""
    loss, grads = value_and_grad(ocr_loss, params, cfg, ids, image_base, patches, image_start, loss_mask)
    tx.update(grads, opt_state, params)
    return loss


# ---------------------------------------------------------------------------
# Train-state checkpoints

_COUNTS = ("count", "mini_step")


def save_train_state(path: str, params, opt_state: dict, step: int) -> None:
    """Params, moments, accumulator, counts and the train step in one
    safetensors file ("params/<path>", "mu/<path>", "nu/<path>",
    "acc/<path>", "count", "mini_step", "step"), written to `path`.tmp and
    moved into place, so a crash mid-save leaves the previous file."""
    flat: Dict[str, torch.Tensor] = {}
    items = param_items(params)
    names = [n for n, _ in items]
    for name, t in items:
        flat["params/" + name] = t
    for key in ("mu", "nu", "acc"):
        for name, t in zip(names, opt_state.get(key, ())):
            flat[f"{key}/{name}"] = t
    for key in _COUNTS:
        if key in opt_state:
            flat[key] = torch.tensor([opt_state[key]], dtype=torch.int64)
    flat["step"] = torch.tensor([step], dtype=torch.int64)
    tmp = path + ".tmp"
    save_flat(flat, tmp)
    os.replace(tmp, path)


@torch.no_grad()
def load_train_state(path: str, params, opt_state: dict) -> int:
    """Restore a `save_train_state` file into `params` and `opt_state` (as
    made by `AdamW.init` for these params) in place, each tensor cast to
    its template's dtype; returns the saved train step."""
    flat = load_flat(path)
    names = [n for n, _ in param_items(params)]
    targets = [("params", [t for _, t in param_items(params)])]
    targets += [(key, opt_state[key]) for key in ("mu", "nu", "acc") if key in opt_state]
    for prefix, tensors in targets:
        for name, t in zip(names, tensors):
            key = f"{prefix}/{name}"
            if key not in flat:
                raise KeyError(f"checkpoint {path} is missing {key!r}")
            if tuple(flat[key].shape) != tuple(t.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(flat[key].shape)}, model {tuple(t.shape)}")
            t.copy_(flat[key].to(t.dtype))
    for key in _COUNTS:
        if key in opt_state:
            opt_state[key] = int(flat[key].reshape(()))
    return int(flat["step"].reshape(()))
