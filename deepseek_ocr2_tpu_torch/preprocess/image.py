"""Host-side image preprocessing (the port's copy of
deepseek_ocr2_tpu/preprocess/image.py, the half it calls).

Parity with the reference pipeline (its src/main.rs):
- clockwise rotation 0/90/180/270 (main.rs:331-338),
- auto-rotate heuristic: grayscale downsample to 256px, dx/dy edge-energy
  ratio with threshold 1.35, dark-top-vs-bottom tie-break (main.rs:348-460),
- letterbox pad-to-square with bicubic (Catmull-Rom) resize, pad color 127
  (main.rs:462-481, 1450),
- dynamic tiling: enumerate (i,j) grids with min<=i*j<=max, closest aspect
  ratio with area tie-break, resize then crop image_size tiles
  (main.rs:1228-1298).

The port ships uint8 views and normalizes them on the device
(`models.deepseek_ocr2.normalize_pixels`), so only the uint8 entry points
are kept; the host f32 forms and the optional native C++ path stay in the
JAX package. PIL is imported inside the functions that use it, so importing
this module needs only numpy.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

ROTATIONS = (0, 90, 180, 270)


def rotate_image(img, degrees_cw: int):
    """Rotate clockwise by 0/90/180/270 degrees (main.rs:331-338)."""
    from PIL import Image

    if degrees_cw % 360 == 0:
        return img
    # PIL's transpose constants rotate counterclockwise.
    table = {90: Image.ROTATE_270, 180: Image.ROTATE_180, 270: Image.ROTATE_90}
    return img.transpose(table[degrees_cw % 360])


def _gray_u8(rgb: np.ndarray) -> np.ndarray:
    """Integer BT.601 luma, identical to reference main.rs:340-346."""
    r = rgb[..., 0].astype(np.uint32)
    g = rgb[..., 1].astype(np.uint32)
    b = rgb[..., 2].astype(np.uint32)
    return ((77 * r + 150 * g + 29 * b) >> 8).astype(np.uint8)


def _downsample_for_heuristic(img, max_side: int = 256):
    from PIL import Image

    w, h = img.size
    m = max(w, h, 1)
    if m <= max_side:
        return img
    scale = max_side / m
    nw = max(int(round(w * scale)), 1)
    nh = max(int(round(h * scale)), 1)
    return img.resize((nw, nh), Image.BILINEAR)  # Triangle filter (main.rs:357)


def _edge_ratio_dx_dy(gray: np.ndarray) -> float:
    """dx/dy edge-energy ratio with the reference's striding (main.rs:360-387)."""
    h, w = gray.shape
    if w < 2 or h < 2:
        return 1.0
    step = max(max(w, h) // 256, 1)
    ys = np.arange(0, h, step)
    xs = np.arange(0, w, step)
    sub = gray[np.ix_(ys, xs)].astype(np.int64)
    # dx: difference with the pixel `step` to the right, where it exists.
    xs_ok = xs + step < w
    dx = np.abs(sub[:, xs_ok] - gray[np.ix_(ys, xs[xs_ok] + step)].astype(np.int64)).sum()
    ys_ok = ys + step < h
    dy = np.abs(sub[ys_ok, :] - gray[np.ix_(ys[ys_ok] + step, xs)].astype(np.int64)).sum()
    return float(dx) / (float(dy) + 1e-9)


def _dark_top_minus_bottom(gray: np.ndarray, thr: int = 100) -> float:
    """Fraction of dark pixels, top half minus bottom half (main.rs:389-423)."""
    h, w = gray.shape
    if h == 0 or w == 0:
        return 0.0
    step = max(max(w, h) // 256, 1)
    sub = gray[::step, ::step]
    mid_row = (h // 2 - 1) // step + 1 if h // 2 > 0 else 0  # rows with y < h//2
    dark = sub < thr
    top = dark[:mid_row]
    bot = dark[mid_row:]
    top_frac = top.sum() / (top.size + 1e-9)
    bot_frac = bot.sum() / (bot.size + 1e-9)
    return float(top_frac - bot_frac)


def auto_rotate_choice(img) -> int:
    """Pick 0/90/270 via the edge-energy heuristic (main.rs:425-460)."""
    small = _downsample_for_heuristic(img, 256)
    arr = np.asarray(small.convert("RGB"))
    g0 = _gray_u8(arr)
    r0 = _edge_ratio_dx_dy(g0)
    if r0 <= 1.35:
        return 0
    g90 = _gray_u8(np.asarray(rotate_image(small, 90).convert("RGB")))
    g270 = _gray_u8(np.asarray(rotate_image(small, 270).convert("RGB")))
    r90 = _edge_ratio_dx_dy(g90)
    r270 = _edge_ratio_dx_dy(g270)
    best = 90 if r90 <= r270 else 270
    if abs(r90 - r270) < 0.05:
        d90 = _dark_top_minus_bottom(g90)
        d270 = _dark_top_minus_bottom(g270)
        best = 90 if d90 >= d270 else 270
    return best


def pad_to_square(img, size: int, pad_color: int = 127):
    """Letterbox to size x size with centered paste (main.rs:462-481)."""
    from PIL import Image

    w, h = img.size
    scale = min(size / w, size / h)
    nw = max(int(round(w * scale)), 1)
    nh = max(int(round(h * scale)), 1)
    resized = img.resize((nw, nh), Image.BICUBIC)  # Catmull-Rom class filter
    canvas = Image.new("RGB", (size, size), (pad_color, pad_color, pad_color))
    canvas.paste(resized, ((size - nw) // 2, (size - nh) // 2))
    return canvas


def find_closest_aspect_ratio(
    aspect_ratio: float,
    target_ratios: Sequence[Tuple[int, int]],
    width: int,
    height: int,
    image_size: int,
) -> Tuple[int, int]:
    """Pick the tiling grid closest in aspect ratio (main.rs:1228-1256)."""
    best_diff = float("inf")
    best = (1, 1)
    area = float(width) * float(height)
    for rw, rh in target_ratios:
        target_ar = rw / rh
        diff = abs(aspect_ratio - target_ar)
        if diff < best_diff:
            best_diff = diff
            best = (rw, rh)
        elif abs(diff - best_diff) < np.finfo(np.float32).eps:
            if area > 0.5 * image_size * image_size * rw * rh:
                best = (rw, rh)
    return best


def candidate_ratios(min_num: int, max_num: int) -> List[Tuple[int, int]]:
    ratios = set()
    for n in range(min_num, max_num + 1):
        for i in range(1, n + 1):
            for j in range(1, n + 1):
                if min_num <= i * j <= max_num:
                    ratios.add((i, j))
    return sorted(ratios, key=lambda r: r[0] * r[1])


def images_to_u8_nchw(imgs: Sequence) -> np.ndarray:
    """Stack to [N,3,H,W] uint8: raw pixels, normalization deferred to the
    device (models.deepseek_ocr2.normalize_pixels)."""
    w, h = imgs[0].size
    out = np.empty((len(imgs), 3, h, w), np.uint8)
    for i, im in enumerate(imgs):
        a = np.asarray(im if im.mode == "RGB" else im.convert("RGB"))
        out[i] = a.transpose(2, 0, 1)
    return out


def preprocess_base_u8(img, size: int, pad_color: int = 127) -> np.ndarray:
    """Letterbox only -> [1, 3, size, size] uint8 (device normalizes)."""
    return images_to_u8_nchw([pad_to_square(img, size, pad_color)])


def preprocess_tiles_u8(img, size: int, ratio: Tuple[int, int]) -> np.ndarray:
    """Dynamic-tiling crops -> [P, 3, size, size] uint8 (device normalizes)."""
    from PIL import Image

    resized = img.resize((size * ratio[0], size * ratio[1]), Image.BICUBIC)
    crops = []
    for i in range(ratio[0] * ratio[1]):
        x = (i % ratio[0]) * size
        y = (i // ratio[0]) * size
        crops.append(resized.crop((x, y, x + size, y + size)))
    return images_to_u8_nchw(crops)


def should_crop(img, crop_mode: bool, crop_image_size: int) -> bool:
    """Dynamic tiling triggers only for large images (main.rs:1430-1436)."""
    w, h = img.size
    return crop_mode and (w > crop_image_size or h > crop_image_size)
