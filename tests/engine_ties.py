"""Tie-aware comparison of the port's continuous engine with the JAX package's,
for the tests that run both engines on the same pages with a bf16 LM (or
int8 weights quantized from one).

In bf16 the two engines' logits differ by bf16 ulps, and where the JAX
engine's top two logits lie closer than that the engines can pick different
tokens and then decode different prefixes. Two checks replace exact token
equality:

- `assert_steps_match_dispatch` (teacher forcing): every decode step the
  JAX engine took is run again on that step's own inputs (embeddings, pool,
  block tables, positions) through the port's `lm_decode_step_paged` and
  through the JAX package's with its TPU dispatch (the Pallas kernels in
  interpret mode, as tests/test_torch_q8_e2e.py runs them), compiled with
  `xla_allow_excess_precision=false`. That XLA option, on by default, lets
  the compiler keep a value it should round to bf16 in f32 inside a fusion;
  off, XLA rounds where the JAX source does, as the port does. On the four
  cases of tests/test_torch_kvq8.py the port's logits then lie within
  `STEP_RTOL` (tests/test_torch_q8_e2e.py's bound) of the largest logit at
  84 to 87 steps of 88 (median 0 to 3.6e-8), and within 8.3e-3 at the
  others, where one f32 sum taken in another order rounds to the other bf16
  neighbour. Against the same steps compiled by default they lie up to
  8.5e-2 apart (median 6.6e-3 to 7.7e-3): the engines' bf16 gap is XLA's excess
  precision, not the port.
- `assert_tokens_match`: each page's tokens equal, up to a first
  difference that is a near-tie: there each engine's pick beats the other
  engine's by less than `INT8_BF16_GAP`, the two rows of logits agree
  within it, and the port's logits on the JAX engine's inputs of that step
  lie within `STEP_RTOL` of the TPU dispatch's. Nothing after the
  difference is compared end to end (the engines then decode different
  prefixes); the teacher-forced check covers every step of every page.

`python tests/engine_ties.py` prints these measurements.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# max |logits_cpu - logits_tpu| of the JAX package's two paths (its CPU
# path folds the shared MLP in as a plain int8 SwiGLU where the TPU dispatch
# takes the pseudo-experts): int8 weights (scope full) quantized from the
# bf16 LM of tests/test_torch_kvq8.py, int8 and int8tail pools, 88 decode
# steps each, the two engines run end to end (1.079e-2 and 9.85e-3). On the
# same inputs (`python tests/engine_ties.py`) the paths lie up to 8.64e-3
# and 1.146e-2 apart; the constant takes the end-to-end figure, the
# stricter of the two where the test holds the engines within it.
INT8_BF16_GAP = 1.1e-2
STEP_RTOL = 1e-4  # of the largest logit (tests/test_torch_q8_e2e.py)
STEP_BF16_RTOL = 4 * 2.0**-8  # of the largest logit (tests/test_torch_e2e.py's bf16 bound)
MIN_STEPS_WITHIN = 0.9  # share of steps within STEP_RTOL (measured: 84 to 87 of 88)


class Step(dict):
    """One decode step: pos [B], logits [B, V] f32, pick [B] (the token the
    step wrote at pos + 1 of each row; a finished row's is not its pick),
    and for the JAX engine its inputs emb, cache, bt."""


def _fill_picks(steps: List[Step], tokens: np.ndarray) -> None:
    rows = np.arange(tokens.shape[0])
    for st in steps:
        st["pick"] = tokens[rows, np.minimum(st["pos"] + 1, tokens.shape[1] - 1)]


@contextlib.contextmanager
def record_steps():
    """Record every decode step of the JAX package's and the port's
    continuous engines while the block runs: yields (jax_steps, port_steps).
    The JAX engine's jitted chunk is traced anew on entry and on exit, so no
    cached trace without the recording is reused, and none with it outlives
    the block."""
    from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
    from deepseek_ocr2_tpu.runtime import continuous as jcont
    from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
    from deepseek_ocr2_tpu_torch.runtime import continuous as tcont

    jax_steps: List[Step] = []
    port_steps: List[Step] = []
    jstep, tstep = jcont.lm_decode_step_paged, tcont.lm_decode_step_paged
    jchunk, tchunk = jcont.decode_chunk, tcont.decode_chunk

    def keep(emb, cache, bt, pos, logits):
        jax_steps.append(Step(emb=np.asarray(emb), cache={k: np.asarray(v) for k, v in cache.items()},
                              bt=np.asarray(bt), pos=np.asarray(pos), logits=np.asarray(logits, np.float32)))

    def jax_recording(params, cfg, emb, cache, bt, pos, **kw):
        hidden, out = jstep(params, cfg, emb, cache, bt, pos, **kw)
        jax.debug.callback(keep, emb, cache, bt, pos, jdsv2.logits_last(params, hidden), ordered=True)
        return hidden, out

    def port_recording(params, cfg, emb, cache, bt, pos, **kw):
        hidden = tstep(params, cfg, emb, cache, bt, pos, **kw)
        port_steps.append(Step(pos=pos.cpu().numpy().copy(),
                               logits=tdsv2.logits_last(params, hidden).float().cpu().numpy()))
        return hidden

    def jax_chunk(*args, **kw):
        n = len(jax_steps)
        out = jchunk(*args, **kw)
        jax.effects_barrier()
        _fill_picks(jax_steps[n:], np.asarray(out[1]))
        return out

    def port_chunk(lm_params, cfg, cache, state, *args, **kw):
        n = len(port_steps)
        out = tchunk(lm_params, cfg, cache, state, *args, **kw)
        _fill_picks(port_steps[n:], state.tokens.cpu().numpy())
        return out

    jcont.lm_decode_step_paged, tcont.lm_decode_step_paged = jax_recording, port_recording
    jcont.decode_chunk, tcont.decode_chunk = jax_chunk, port_chunk
    jchunk.clear_cache()
    try:
        yield jax_steps, port_steps
    finally:
        jcont.lm_decode_step_paged, tcont.lm_decode_step_paged = jstep, tstep
        jcont.decode_chunk, tcont.decode_chunk = jchunk, tchunk
        jchunk.clear_cache()


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def dispatch_step_logits(jax_steps: List[Step], jax_lm, cfg, *, excess_precision: bool) -> List[np.ndarray]:
    """Each recorded JAX step's logits [B, V] again, on its own inputs,
    through the JAX package's TPU dispatch (its int8 linears and MoE kernels
    in interpret mode), compiled with XLA's excess precision on or off."""
    from deepseek_ocr2_tpu.models import deepseek_v2 as jdsv2
    from deepseek_ocr2_tpu.ops import flash_attention, linear_q8, moe_decode, moe_q8
    from deepseek_ocr2_tpu.runtime import paged_kv as jpaged

    def ref_step(params, emb, cache, bt, pos):
        hidden, _ = jpaged.lm_decode_step_paged(params, cfg, emb, cache, bt, pos)
        return jdsv2.logits_last(params, hidden)

    def jargs(st):
        return (jax_lm, jnp.asarray(st["emb"]), {k: jnp.asarray(v) for k, v in st["cache"].items()},
                jnp.asarray(st["bt"]), jnp.asarray(st["pos"]))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flash_attention, "pallas_enabled", lambda: True)
        for mod, name in ((linear_q8, "linear_q8"), (moe_q8, "moe_ffn_decode_q8"),
                          (moe_decode, "moe_ffn_decode_q8_fused")):
            mp.setattr(mod, name, functools.partial(getattr(mod, name), interpret=True))
        ref = jax.jit(ref_step).lower(*jargs(jax_steps[0])).compile(
            compiler_options={"xla_allow_excess_precision": excess_precision})
        return [np.asarray(ref(*jargs(st)), np.float32) for st in jax_steps]


def port_step_logits(jax_steps: List[Step], port_lm, cfg) -> List[np.ndarray]:
    """Each recorded JAX step's logits [B, V] through the port's
    `lm_decode_step_paged`, on that step's own inputs."""
    from deepseek_ocr2_tpu_torch.models import deepseek_v2 as tdsv2
    from deepseek_ocr2_tpu_torch.runtime import paged_kv as tpaged

    rope = tdsv2.rope_consts(cfg, "cpu")
    out = []
    for st in jax_steps:
        cache = {k: _torch(v) for k, v in st["cache"].items()}
        hidden = tpaged.lm_decode_step_paged(port_lm, cfg, _torch(st["emb"]), cache, _torch(st["bt"]),
                                             _torch(st["pos"]), rope=rope)
        out.append(tdsv2.logits_last(port_lm, hidden).float().numpy())
    return out


def row_errors(got: List[np.ndarray], want: List[np.ndarray]) -> np.ndarray:
    """max |got - want| of each step's rows [steps, B], relative to the
    step's largest |want|."""
    return np.stack([np.abs(g - w).max(axis=-1) / np.abs(w).max() for g, w in zip(got, want)])


def assert_steps_match_dispatch(jax_steps: List[Step], jax_lm, port_lm, cfg) -> np.ndarray:
    """Teacher forcing (module docstring): each recorded JAX step's inputs
    through the port and through the JAX package's TPU dispatch compiled
    without excess precision. Every row's logits (finished and empty rows
    too: both sides get the same inputs) lie within STEP_BF16_RTOL of the
    step's largest logit, at least MIN_STEPS_WITHIN of the steps within
    STEP_RTOL, and every row's argmax is the dispatch's unless the
    dispatch's top two lie within twice the row's error. Returns the errors
    [steps, B], relative to each step's largest logit."""
    want = dispatch_step_logits(jax_steps, jax_lm, cfg, excess_precision=False)
    got = port_step_logits(jax_steps, port_lm, cfg)
    errs = row_errors(got, want)
    for s, (g, w) in enumerate(zip(got, want)):
        top2 = np.sort(w, axis=-1)[:, -2:]
        for r in np.flatnonzero(g.argmax(-1) != w.argmax(-1)):
            assert top2[r, 1] - top2[r, 0] <= 2 * errs[s, r] * np.abs(w).max(), (s, r)
    assert errs.max() <= STEP_BF16_RTOL, errs.max()
    within = float(np.mean(errs.max(axis=1) <= STEP_RTOL))
    assert within >= MIN_STEPS_WITHIN, (within, np.sort(errs.max(axis=1))[-8:])
    return errs


def _first_difference_step(steps: List[Step], d: int, pick: int) -> set:
    """(step, row) pairs whose row sat at position d - 1 and wrote `pick`."""
    return {(s, int(r)) for s, st in enumerate(steps) for r in np.flatnonzero((st["pos"] == d - 1)
                                                                                 & (st["pick"] == pick))}


def assert_tokens_match(want, got, jax_steps: List[Step], port_steps: List[Step], step_errs: np.ndarray,
                        *, gap: float) -> None:
    """Each page's tokens (JAX engine `want`, port `got`) equal, or equal up
    to a first difference at index d that is a near-tie (module docstring).
    The step of the difference is the one (step, row) at which the JAX
    engine wrote want[d] and the port got[d] at position d - 1: up to it the
    two engines ran the same schedule. `step_errs` is what
    assert_steps_match_dispatch returned."""
    for i, (w, g) in enumerate(zip(want, got)):
        pl, wt, gt = w.prompt_len, list(w.token_ids), list(g.token_ids)
        assert g.prompt_len == pl, i
        d = next((j for j in range(min(len(wt), len(gt))) if wt[j] != gt[j]), None)
        if d is None:
            assert len(gt) == len(wt), (i, wt[pl:], gt[pl:])
            continue
        at = _first_difference_step(jax_steps, d, wt[d]) & _first_difference_step(port_steps, d, gt[d])
        assert len(at) == 1, (i, f"tokens differ at new token {d - pl}, at steps {sorted(at)}", wt[pl:], gt[pl:])
        s, r = at.pop()
        jrow, prow = jax_steps[s]["logits"][r], port_steps[s]["logits"][r]
        a, b = wt[d], gt[d]
        assert jrow[a] - jrow[b] < gap and prow[b] - prow[a] < gap, (
            i, d, float(jrow[a] - jrow[b]), float(prow[b] - prow[a]))
        fin = np.isfinite(jrow)
        assert np.array_equal(fin, np.isfinite(prow)), i
        assert float(np.abs(prow[fin] - jrow[fin]).max()) <= gap, (i, d)
        assert step_errs[s, r] <= STEP_RTOL, (i, d, step_errs[s, r])


def _report() -> None:
    """The measurements the module docstring and tests/test_torch_kvq8.py
    quote, on that test's four cases: the port against the TPU dispatch on
    the JAX engine's inputs (excess precision off and on), the JAX package's
    two paths on the same inputs, the engines end to end before their first
    difference, and each first difference."""
    import test_torch_kvq8 as kvq8

    torch.set_num_threads(1)
    params = kvq8.build_ocr_params()
    cfg = params[0].lm
    for weights in ("bf16", "int8"):
        for kv in ("int8", "int8tail"):
            jp, tp = params[1][weights]
            _, _, want, got, js, ps = kvq8.run_engines(params, weights, kv)
            port = port_step_logits(js, tp["lm"], cfg)
            off_rows = row_errors(port, dispatch_step_logits(js, jp["lm"], cfg, excess_precision=False))
            off = off_rows.max(axis=1)
            on_logits = dispatch_step_logits(js, jp["lm"], cfg, excess_precision=True)
            on = row_errors(port, on_logits).max(axis=1)
            two_path = max(float(np.abs(st["logits"] - w).max()) for st, w in zip(js, on_logits))
            print(f"{weights} weights, {kv} pool, {len(js)} steps: port vs dispatch (excess precision off) "
                  f"within {STEP_RTOL:g} at {int((off <= STEP_RTOL).sum())}, max {off.max():.3e}, median "
                  f"{np.median(off):.3e}; (on) max {on.max():.3e}, median {np.median(on):.3e}; JAX CPU path "
                  f"vs dispatch max abs {two_path:.4e}")
            firsts = []
            for i, (w, g) in enumerate(zip(want, got)):
                d = next((j for j in range(min(len(w.token_ids), len(g.token_ids)))
                          if w.token_ids[j] != g.token_ids[j]), None)
                if d is None:
                    continue
                (s, r), = _first_difference_step(js, d, w.token_ids[d]) & _first_difference_step(ps, d, g.token_ids[d])
                jrow, prow = js[s]["logits"][r], ps[s]["logits"][r]
                a, b = w.token_ids[d], g.token_ids[d]
                firsts.append(s)
                print(f"  page {i}: new token {d - w.prompt_len} at step {s} row {r}: JAX {a} by "
                      f"{jrow[a] - jrow[b]:.3e}, port {b} by {prow[b] - prow[a]:.3e}, rows "
                      f"{np.abs(prow - jrow).max():.3e} apart (largest {np.abs(jrow).max():.3f}); port vs "
                      f"dispatch there {off_rows[s, r]:.3e}")
            n = min(firsts, default=len(js))
            e2e = [np.abs(p["logits"] - j["logits"]) for p, j in zip(ps[:n], js[:n])]
            print(f"  end to end, {n} steps before the first difference: max abs {max(e.max() for e in e2e):.3e}, "
                  f"max of the largest logit {max(e.max() / np.abs(j['logits']).max() for e, j in zip(e2e, js)):.3e}")


if __name__ == "__main__":  # python tests/engine_ties.py (CPU, about a minute)
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    _report()
