"""Kernel J's stream (int8 distinct-expert batched-decode MoE, bf16 x),
emulated in torch on the CPU.

csrc/moe_q8.cu runs J with bf16 x on kernel F's bulk-copy tensor-core
design over int8 codes (`moe_q8_stream_bf16`):
- the visits are the valid routed ones in ascending expert id, then the
  n_sh pseudo-experts;
- gate/up: 8 consumer warps, warp w over the 64-wide chunks w, w + 8, ...
  of H, codes widened to bf16 (exact), products on mma.sync with f32 sums;
  the warps' partials summed in warp order, then gate = dot * scale and up
  = dot * scale in f32 and act = bf16(silu(gate) * up);
- down: the same split of I (the codes as A, the act rows as B, in parts
  of at most 8 rows), y = dot * scale, y * w_visit added over the valid
  visits in order (only the rows whose weight is not zero: the others would
  add y * 0), then y for each pseudo-expert, out = bf16(sum).
The emulation takes each warp's partial dot in f32 (the order inside an
mma step is the hardware's; each product of a bf16 and a code is exact in
f32) and keeps the rest of the arithmetic in the kernel's order. It is held
to the plain twin `moe_ffn_decode_q8_visits_reference` and to the JAX
package's `moe_ffn_decode_q8_fused` in interpret mode at B 11, 16 and 40
(the kernel's groups of 32 rows compute each row alike), with and without
the pseudo-experts, and to itself: a row's bits do not depend on the other
rows. Also exact, exhaustively: the kernel's widening of a code to bf16 (a
byte permute into the mantissa of 2^23, one f32 subtraction, the high
half), and its k order inside a chunk (step j's logical pairs (2t, 2t + 1)
and (2t + 8, 2t + 9) at the physical 16 t + 4 j + (0, 1) and (2, 3)) is a
permutation.
Tolerance: 4 bf16 ulps of the largest output (tests/test_torch_q8.py's
bf16 bound; an f32 sum on the other side of a rounding boundary moves act
by an ulp). The kernel itself runs on the card (tests/test_torch_kernels.py,
-m gpu).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture: one intra-op thread)

from deepseek_ocr2_tpu.ops import moe as jmoe
from deepseek_ocr2_tpu.ops import moe_decode as jmoe_decode
from deepseek_ocr2_tpu.ops import moe_q8 as jmoe_q8
from deepseek_ocr2_tpu_torch.ops import moe_decode

WARPS = 8  # consumer warps of each launch
CHUNK = 64  # the contraction's chunks, w, w + 8, ... warp w's
BF16_RTOL = 4 * 2.0**-8


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _case(b, *, n_sh, e=8, h=256, i=128, k=2, seed=4):
    """JAX int8 experts ([E, H, 2I] codes) and the port's ([E, 2I, H]), the
    same codes and scales; bf16 x and routing from a random f32 router."""
    rng = np.random.default_rng(seed)

    def experts(n):
        return jmoe_q8.quantize_experts({
            "gate": jnp.asarray(rng.standard_normal((n, h, i)).astype(np.float32) * h**-0.5),
            "up": jnp.asarray(rng.standard_normal((n, h, i)).astype(np.float32) * h**-0.5),
            "down": jnp.asarray(rng.standard_normal((n, i, h)).astype(np.float32) * i**-0.5)})

    jeq = experts(e)
    if n_sh:
        jeq.update({f"pe_{name}": v for name, v in experts(n_sh).items()})
    x = jnp.asarray(rng.standard_normal((b, h)).astype(np.float32)).astype(jnp.bfloat16)
    w, idx = jmoe.route(x.astype(jnp.float32), jnp.asarray(rng.standard_normal((h, e)).astype(np.float32)), k)
    teq = {name: _t(np.swapaxes(np.asarray(v), -1, -2)) if name.endswith("q8") else _t(np.asarray(v)[..., 0, :])
           for name, v in jeq.items()}
    return (x, jeq, w, idx), (_t(np.asarray(x)), teq, _t(np.asarray(w)), _t(np.asarray(idx)).long())


def warp_dots(a32: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """[B, K] f32 rows against [N, K] int8 codes as the kernel's 8 warps
    take them: warp w's 64-wide chunks w, w + 8, ... give its partial [B,
    N] f32 (each row's dot a sum of exact products), the partials summed in
    warp order from 0. Row by row, so that a row's bits depend on its own
    values alone."""
    n_ch = a32.shape[1] // CHUNK
    c32 = codes.float()
    total = torch.zeros(a32.shape[0], codes.shape[0])
    for w in range(WARPS):
        ks = torch.cat([torch.arange(CHUNK * c, CHUNK * c + CHUNK) for c in range(w, n_ch, WARPS)] or
                       [torch.zeros(0, dtype=torch.long)])
        part = (a32[:, None, ks] * c32[None, :, ks]).sum(-1)
        total = total + part
    return total


def silu(v: torch.Tensor) -> torch.Tensor:
    return v / (1.0 + torch.exp(-v))  # the kernel's form


def stream_emulation(x: torch.Tensor, eq, weights: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """J's stream on the CPU. x [B, H] bf16; returns [B, H] bf16."""
    e, i2, _ = eq["gu_q8"].shape
    i = i2 // 2
    ve, valid = moe_decode.distinct_schedule(idx, e)
    w_visit = moe_decode.combine_table(idx, weights, ve, valid, e)
    visits = [(eq["gu_q8"][ex], eq["gu_scale"][ex], eq["down_q8"][ex], eq["down_scale"][ex], w_visit[v])
              for v, ex in enumerate(ve.tolist()) if valid[v]]
    if "pe_gu_q8" in eq:
        visits += [(eq["pe_gu_q8"][t], eq["pe_gu_scale"][t], eq["pe_down_q8"][t], eq["pe_down_scale"][t], None)
                   for t in range(eq["pe_gu_q8"].shape[0])]
    x32 = x.float()
    out = torch.zeros(x.shape[0], eq["down_q8"].shape[1])
    for gu, gus, down, ds, wv in visits:
        h2 = warp_dots(x32, gu) * gus
        act = (silu(h2[:, :i]) * h2[:, i:]).to(torch.bfloat16).float()
        y = warp_dots(act, down) * ds
        if wv is not None:
            y = y * wv[:, None]
        out = out + y
    return out.to(torch.bfloat16)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32)) if not isinstance(want, torch.Tensor) else want.float().numpy()
    tol = BF16_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= tol, f"max abs err {err} above {tol}"


@pytest.mark.parametrize("n_sh", [0, 2])
@pytest.mark.parametrize("b", [11, 16, 40])
def test_stream_matches_twin_and_jax(b, n_sh):
    (jx, jeq, jw, jidx), (x, eq, w, idx) = _case(b, n_sh=n_sh)
    assert b * idx.shape[1] > eq["gu_q8"].shape[0]  # J's side of the cut-over
    got = stream_emulation(x, eq, w, idx)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _close(got, moe_decode.moe_ffn_decode_q8_visits_reference(x, eq, w, idx))
    _close(got, jmoe_decode.moe_ffn_decode_q8_fused(jx, jeq, jw, jidx, interpret=True))


def test_stream_row_does_not_depend_on_the_other_rows():
    """Row 0 beside other rows of other values and routing (other visits,
    where row 0 adds y * 0), and alone, bit-equal."""
    _, (x, eq, w, idx) = _case(16, n_sh=2)
    first = stream_emulation(x, eq, w, idx)
    x2, w2, idx2 = x.clone(), w.clone(), idx.clone()
    x2[1:] = x[1:].flip(0)
    idx2[1:] = (idx[1:] + 3) % eq["gu_q8"].shape[0]
    w2[1:] = w[1:].flip(1)
    assert torch.equal(stream_emulation(x2, eq, w2, idx2)[0], first[0])
    assert torch.equal(stream_emulation(x[:1], eq, w[:1], idx[:1])[0], first[0])


def test_code_widening_is_exact_for_every_code():
    """codes_bf16x2: c ^ 0x80 in the low mantissa byte of 2^23, minus 2^23 +
    128, is c in f32, whose low 16 bits are zero: its high half is bf16(c)."""
    c = np.arange(-128, 128, dtype=np.int32)
    bits = (np.uint32(0x4B000000) | ((c & 0xFF) ^ 0x80).astype(np.uint32)).astype(np.uint32)
    f = bits.view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, c.astype(np.float32))
    fb = f.view(np.uint32)
    assert not (fb & 0xFFFF).any()
    want = c.astype(np.float32).astype(ml_dtypes.bfloat16).view(np.uint16)
    assert np.array_equal((fb >> 16).astype(np.uint16), want)


def test_chunk_k_order_is_a_permutation():
    """Lane t of a quad feeds step j's logical k (2t, 2t + 1) and (2t + 8, 2t +
    9) with the physical k 16 t + 4 j + (0, 1) and (2, 3) of a 64-wide
    chunk, for both operands: within each step a permutation of its 16
    logical k, and every k of the chunk once over its 4 steps."""
    for j in range(4):
        logical = [k for t in range(4) for k in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)]
        assert sorted(logical) == list(range(16))
    physical = [16 * t + 4 * j + d for j in range(4) for t in range(4) for d in range(4)]
    assert sorted(physical) == list(range(64))
