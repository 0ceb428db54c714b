"""PIL-exact bicubic resize, letterbox and crop tiling on the device (port of
deepseek_ocr2_tpu/preprocess/device_resize.py).

Pillow resamples an 8-bit image in two separable passes, horizontal first
(Resample.c): each output pixel reads the taps ``x in [xmin, xmin + xmax)``
with Catmull-Rom (a = -0.5) weights normalized to sum 1 and rounded to
fixed point, ``kk = trunc(w * 2^22 +- 0.5)``; the pass computes
``ss = 2^21 + sum(pixel * kk)`` in int32 and writes ``clip8(ss)`` (0 if
ss <= 0, 255 if ss >= 2^30, else ss >> 22), so the image between the passes
is uint8.

This module gives the same bytes from one GEMM a pass:
- the planner (numpy, a copy of the JAX package's: `pil_coeffs`,
  `_digits3`, `_plain_plan`, `_placed_plan`, `bucket_pad`) turns the taps
  into three balanced base-256 digit planes, ``kk = d2 * 2^16 + d1 * 2^8 +
  d0`` with ``|di| <= 128``;
- `_expand_dense` scatters them on the device into a dense [W, 3 * O]
  matrix (each column at most `ksize` nonzeros);
- `_fixed_pass` multiplies the uint8 pixels by it in f32 and recombines the
  planes in int32 with shifts. Every product is at most 255 * 128 and
  every partial sum under 2^24, so the f32 GEMM is exact integer
  arithmetic (TF32 stays off, see the package's __init__). The JAX package
  runs it on bf16 operands with an f32 result; torch.matmul of bf16
  tensors returns bf16, which rounds sums above 256, so the operands here
  are f32.

A letterbox folds the paste offset into the coefficients (columns outside
the pasted box get none) and fills the outside with the pad colour. The
image ships once, zero-padded to a multiple of 256 on each side
(`bucket_pad`; the padded rows and columns carry zero coefficients): the
JAX package bounds its jit variants so, and the contract that the padding
changes nothing is kept and tested.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

PRECISION_BITS = 22  # Pillow Resample.c: 32 - 8 - 2
_ROUND = 1 << (PRECISION_BITS - 1)
_CLIP_HI = (1 << (PRECISION_BITS + 8)) - 1
BUCKET = 256  # input images pad up to multiples of this


def _cubic(x: np.ndarray) -> np.ndarray:
    """Catmull-Rom (a=-0.5), same expression order as Pillow's bicubic_filter."""
    a = -0.5
    x = np.abs(x)
    in1 = ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    in2 = (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return np.where(x < 1.0, in1, np.where(x < 2.0, in2, 0.0))


@functools.lru_cache(maxsize=256)
def pil_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL precompute_coeffs + normalize_coeffs_8bpc, bit-exact.

    Returns (xmin int32 [out], kk int32 [out, ksize]); taps for output pixel
    ``o`` read input pixels ``xmin[o] + k`` with fixed-point weight
    ``kk[o, k]`` (zero-padded beyond the valid tap count).
    """
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1

    xx = np.arange(out_size, dtype=np.float64)
    center = (xx + 0.5) * scale
    # C int casts truncate toward zero.
    xmin = np.trunc(center - support + 0.5).astype(np.int64)
    xmin = np.maximum(xmin, 0)
    xmax = np.trunc(center + support + 0.5).astype(np.int64)
    xmax = np.minimum(xmax, in_size) - xmin

    ss = 1.0 / filterscale
    k_idx = np.arange(ksize, dtype=np.int64)
    # Same fp-op order as Pillow: ((x + xmin) - center + 0.5) * ss.
    pos = ((k_idx[None, :] + xmin[:, None]).astype(np.float64) - center[:, None] + 0.5) * ss
    w = _cubic(pos)
    w = np.where(k_idx[None, :] < xmax[:, None], w, 0.0)
    # Sequential tap-order accumulation (vectorized over outputs) matches
    # Pillow's `ww += w` loop rounding exactly; adding exact 0.0 is identity.
    ww = np.zeros(out_size, dtype=np.float64)
    for k in range(ksize):
        ww += w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)

    scaled = w * float(1 << PRECISION_BITS)
    kk = np.where(scaled < 0.0, np.trunc(scaled - 0.5), np.trunc(scaled + 0.5))
    return xmin.astype(np.int32), kk.astype(np.int32)


def _digits3(kk: np.ndarray) -> np.ndarray:
    """Balanced base-256 split: kk == d2*2^16 + d1*2^8 + d0, |di| <= 128."""
    k = kk.astype(np.int64)
    d0 = ((k + 128) % 256) - 128
    r = (k - d0) >> 8
    d1 = ((r + 128) % 256) - 128
    d2 = (r - d1) >> 8
    out = np.stack([d2, d1, d0]).astype(np.int32)
    assert np.abs(out).max(initial=0) <= 128
    return out


@functools.lru_cache(maxsize=256)
def _plain_plan(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    xmin, kk = pil_coeffs(in_size, out_size)
    return xmin, _digits3(kk)


@functools.lru_cache(maxsize=256)
def _placed_plan(
    in_size: int, canvas: int, valid: int, offset: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Coefficients for `resize to `valid` then paste at `offset` on `canvas``:
    output pixels inside [offset, offset+valid) carry the (in_size -> valid)
    taps; the rest have zero coefficients (masked to pad color on device)."""
    xmin, digs = _plain_plan(in_size, valid)
    K = digs.shape[-1]
    xmin_f = np.zeros(canvas, np.int32)
    digs_f = np.zeros((3, canvas, K), np.int32)
    xmin_f[offset : offset + valid] = xmin
    digs_f[:, offset : offset + valid] = digs
    return xmin_f, digs_f


def _expand_dense(xmin: np.ndarray, digs: np.ndarray, in_size: int, device) -> torch.Tensor:
    """[W, 3*O] f32 dense digit-coefficient matrix on `device` from the
    compact taps: entry (xmin[o] + k, d * O + o) = digs[d, o, k]. Each
    (w, o) holds at most one tap, so the scatter writes each entry once;
    taps past the (padded) input carry zero weight and are left out."""
    out_size, n_taps = digs.shape[1], digs.shape[2]
    rows = xmin[:, None].astype(np.int64) + np.arange(n_taps)  # [O, K]
    keep = rows < in_size
    o_idx = np.broadcast_to(np.arange(out_size)[:, None], rows.shape)[keep]
    rows = rows[keep]
    vals = digs[:, keep]  # [3, n]
    m = torch.zeros(in_size, 3, out_size, dtype=torch.float32, device=device)
    r = torch.from_numpy(rows).to(device)
    o = torch.from_numpy(np.ascontiguousarray(o_idx)).to(device)
    v = torch.from_numpy(vals.astype(np.float32)).to(device)
    for d in range(3):
        m[r, d, o] = v[d]
    return m.reshape(in_size, 3 * out_size)


def _fixed_pass(x_u8: torch.Tensor, m: torch.Tensor, out_size: int) -> torch.Tensor:
    """One PIL resample pass along the LAST axis: uint8 [..., W] -> [..., O].
    The rows are flattened into one GEMM (a uint8 copy where the view is
    not contiguous): torch.matmul would otherwise run a strided 3-D input
    as a batch of 3-row products."""
    p = torch.mm(x_u8.reshape(-1, x_u8.shape[-1]).float(), m)  # exact: integers under 2^24
    p = p.to(torch.int32).reshape(*x_u8.shape[:-1], 3, out_size)
    ss = (p[..., 0, :] << 16) + (p[..., 1, :] << 8) + p[..., 2, :] + _ROUND
    return (ss.clamp(0, _CLIP_HI) >> PRECISION_BITS).to(torch.uint8)


def _resize_chw(img: torch.Tensor, hx, hd, vx, vd, box: Tuple[int, int, int, int], pad: int) -> torch.Tensor:
    """Two fixed-point passes (horizontal then vertical, like PIL) + pad mask.

    img: uint8 [H, W, 3] (zero-padded to its bucket; padded rows/cols have
    zero coefficients). Returns uint8 [3, OH, OW]; pixels outside
    ``box = (x0, x1, y0, y1)`` become ``pad``.
    """
    H, W, _ = img.shape
    OW, OH = hx.shape[0], vx.shape[0]
    h = _fixed_pass(img.permute(0, 2, 1), _expand_dense(hx, hd, W, img.device), OW)  # [H, 3, OW]
    v = _fixed_pass(h.permute(1, 2, 0), _expand_dense(vx, vd, H, img.device), OH)  # [3, OW, OH]
    out = v.permute(0, 2, 1)  # [3, OH, OW]
    x0, x1, y0, y1 = box
    if (x0, x1, y0, y1) == (0, OW, 0, OH):
        return out.contiguous()
    res = torch.full_like(out, pad)
    res[:, y0:y1, x0:x1] = out[:, y0:y1, x0:x1]
    return res


def bucket_pad(arr: np.ndarray, bucket: int = BUCKET) -> np.ndarray:
    """Zero-pad HWC uint8 up to shape-bucket multiples."""
    h, w = arr.shape[:2]
    hb = max(-(-h // bucket) * bucket, bucket)
    wb = max(-(-w // bucket) * bucket, bucket)
    if (hb, wb) == (h, w):
        return arr
    out = np.zeros((hb, wb, 3), np.uint8)
    out[:h, :w] = arr
    return out


def ship_image(arr: np.ndarray, device) -> torch.Tensor:
    """Pad to the shape bucket and copy once to `device`; the letterbox and
    the tiles both read this buffer."""
    return torch.from_numpy(bucket_pad(np.ascontiguousarray(arr))).to(device)


def device_resize_u8(img_dev: torch.Tensor, true_w: int, true_h: int, out_w: int, out_h: int) -> torch.Tensor:
    """Plain PIL-bit-exact resize: [3, out_h, out_w] uint8."""
    hx, hd = _plain_plan(true_w, out_w)
    vx, vd = _plain_plan(true_h, out_h)
    return _resize_chw(img_dev, hx, hd, vx, vd, (0, out_w, 0, out_h), 0)


def device_letterbox_u8(
    img_dev: torch.Tensor, true_w: int, true_h: int, size: int, pad_color: int = 127
) -> torch.Tensor:
    """pad_to_square on device: [1, 3, size, size] uint8, PIL-bit-exact.

    ``img_dev`` from ship_image; (true_w, true_h) are the pre-padding dims.
    Mirrors preprocess.image.pad_to_square: aspect-fit resize + centered
    paste on a pad_color canvas.
    """
    scale = min(size / true_w, size / true_h)
    nw = max(int(round(true_w * scale)), 1)
    nh = max(int(round(true_h * scale)), 1)
    ox, oy = (size - nw) // 2, (size - nh) // 2
    hx, hd = _placed_plan(true_w, size, nw, ox)
    vx, vd = _placed_plan(true_h, size, nh, oy)
    return _resize_chw(img_dev, hx, hd, vx, vd, (ox, ox + nw, oy, oy + nh), pad_color)[None]


def device_tiles_u8(
    img_dev: torch.Tensor, true_w: int, true_h: int, size: int, ratio: Tuple[int, int]
) -> torch.Tensor:
    """dynamic_preprocess tiling on device: [tw*th, 3, size, size] uint8,
    PIL-bit-exact (resize to (size*tw, size*th), then row-major crops)."""
    tw, th = ratio
    hx, hd = _plain_plan(true_w, size * tw)
    vx, vd = _plain_plan(true_h, size * th)
    out = _resize_chw(img_dev, hx, hd, vx, vd, (0, size * tw, 0, size * th), 0)  # [3, th*S, tw*S]
    t = out.reshape(3, th, size, tw, size)
    return t.permute(1, 3, 0, 2, 4).reshape(tw * th, 3, size, size)


def device_preprocess_page(
    img_arr: np.ndarray,
    base_size: int,
    crop_size: int,
    crop_ratio: Optional[Tuple[int, int]],
    pad_color: int = 127,
    device="cuda",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The OCR pixel front end on `device` from one ship of the raw HWC
    uint8 page. Returns (base [1, 3, S, S] uint8, tiles [P, 3, c, c] uint8
    or None), the contract of preprocess_base_u8 / preprocess_tiles_u8.
    """
    h, w = img_arr.shape[:2]
    shipped = ship_image(img_arr, device)
    tiles = device_tiles_u8(shipped, w, h, crop_size, crop_ratio) if crop_ratio is not None else None
    base = device_letterbox_u8(shipped, w, h, base_size, pad_color)
    return base, tiles
