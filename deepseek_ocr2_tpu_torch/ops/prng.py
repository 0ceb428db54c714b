"""JAX's default random stream (threefry2x32) in torch integer ops.

Sampled tokens of the port equal the JAX package's only if both draw the
same bits, so this module reproduces `jax.random` as it runs with its
defaults (`jax_default_prng_impl = threefry2x32`,
`jax_threefry_partitionable = True`): `PRNGKey`, `split`, `fold_in`,
32-bit `random_bits`, f32 `uniform`, the "low" mode of `gumbel` (its
default) and `categorical` by Gumbel-max.

A key is an int64 tensor [..., 2] holding two uint32 words; every uint32
operation is done in int64 and masked to 32 bits (torch has no full uint32
arithmetic on the card). Keys may be batched over leading axes, as
`jax.vmap` over keys does. Everything stays on the tensors' device: no
value is read back, no host generator is used, and Python scalars become
device tensors through `torch.full` (a fill kernel), never a host copy,
which would synchronise.

Under the partitionable layout a key's bits at flat index i are
threefry2x32(key, (i >> 32, i & 0xffffffff)); `split(key, n)[i]` is the
pair of words at (0, i), `fold_in(key, d)` the pair at (0, d), and
`random_bits` the xor of the two words (jax/_src/prng.py).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = 1.1754943508222875e-38  # np.finfo(np.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the count words (x1, x2) under the key
    words (k1, k2), 20 rounds, all broadcast together (int64 holding
    uint32). As `_threefry2x32_lowering` in jax/_src/prng.py."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def _device_int(x: Union[int, torch.Tensor], device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.full((), int(x), dtype=torch.int64, device=device)


def prng_key(seed: Union[int, torch.Tensor], device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: the words (0, seed mod
    2^32). A tensor of seeds gives a batch of keys."""
    s = _device_int(seed, device)
    return torch.stack([torch.zeros_like(s), s & _MASK], dim=-1)


def _hash_at(key: torch.Tensor, counts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both hash words of `key` [..., 2] at the 64-bit flat indices
    `counts` (int64, non-negative), broadcast over the key's batch axes."""
    k1, k2 = key[..., 0], key[..., 1]
    shape = k1.shape + (1,) * counts.dim()
    return threefry2x32(k1.reshape(shape), k2.reshape(shape), counts >> 32, counts & _MASK)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: [..., num, 2]."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    return torch.stack(_hash_at(key, counts), dim=-1)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for 32-bit data; `data` broadcasts
    against the key's batch axes ([...] with key [..., 2])."""
    d = _device_int(data, key.device) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """32-bit `jax.random.bits`: [..., *shape] int64 in [0, 2^32)."""
    n = 1
    for s in shape:
        n *= s
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    y1, y2 = _hash_at(key, counts)
    return (y1 ^ y2).reshape(*key.shape[:-1], *shape)


def uniform(key: torch.Tensor, shape: Tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 `jax.random.uniform`: 23 random mantissa bits under the exponent
    of 1.0, minus 1, scaled to [minval, maxval) and floored at minval."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    span = torch.full((), maxval, dtype=torch.float32, device=key.device) - lo
    return torch.maximum(lo, floats * span + lo)


# XLA's f32 log on the CPU, the Cephes form its CPU backend emits (vectorised;
# torch's and libm's log differ from it in the last bit for about one input
# in five): x = 2^e m with m in [sqrt(1/2), sqrt(2)), a degree-8 polynomial
# in m - 1 evaluated with fused multiply-adds, and log(2) e added in two
# parts. Its nine coefficients, the two parts of log(2) and sqrt(1/2) are
# Cephes' constants, rounded to f32 as XLA holds them.
def _f32(x: float) -> float:
    return torch.tensor(x, dtype=torch.float32).item()


_LOG_P = tuple(_f32(c) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
                                 1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
                                 3.3333331174e-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRT_HALF = _f32(0.707106781186547524)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """XLA's f32 fused multiply-add a b + c, emulated (b, c f32 values, as
    tensors or floats): the product of two f32 values is exact in f64, and
    the f64 sum is then rounded to f32, so the result is rounded twice, not
    once as a true fused multiply-add rounds it. The two can differ; over
    the inputs `xla_log` takes from `gumbel` (every value `uniform` returns,
    and their first logs) it was checked bit for bit against XLA's log, and
    is not known to be exact outside them."""
    return (a.double() * (b.double() if isinstance(b, torch.Tensor) else b) + c).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 log for finite x > 0 (no zero, infinity or NaN), bit for
    bit over the inputs `gumbel` gives it (see `_fma`)."""
    bits = torch.clamp(x, min=_F32_TINY).view(torch.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    small = m < _SQRT_HALF
    z = torch.where(small, (m - 1.0) + m, m - 1.0)
    e = torch.where(small, e - 1.0, e)
    z2 = z * z
    z3 = z2 * z
    p = _LOG_P
    y = _fma(_fma(z, p[0], p[1]), z, p[2])
    y1 = _fma(_fma(z, p[3], p[4]), z, p[5])
    y2 = _fma(_fma(z, p[6], p[7]), z, p[8])
    y = _fma(_fma(y, z3, y1.double()), z3, y2.double())
    y = _fma(y, z3, (_LOG_Q1 * e).double())
    return ((z - 0.5 * z2) + y) + _LOG_Q2 * e


def gumbel(key: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """f32 `jax.random.gumbel` in its default "low" mode:
    -log(-log(uniform(tiny, 1))). On the CPU the log is XLA's (`xla_log`),
    so that the noise equals JAX's there bit for bit; on the card it is
    torch's, one launch where `xla_log` dispatches 67 elementwise
    operations (a sampled decode step draws the noise once)."""
    u = uniform(key, shape, minval=_F32_TINY)
    log = xla_log if u.device.type == "cpu" else torch.log
    return -log(-log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` over the last axis, one key a
    row: argmax(gumbel + logits), the first maximal index winning."""
    g = gumbel(key, (logits.shape[-1],))
    return torch.argmax(g + logits, dim=-1)
