"""Crops dataset: CSS training crops with synchronized augmentation.

Counterpart of sdflabel_tpu/data/crops.py (reference datasets/crops.py):
reads ``crops.json`` and the ``{idx:05d}_rgb.png`` / ``_uvw.png`` pairs,
jitters the RGB colours, applies one random rotation + random resized crop
to both images (bilinear for RGB, nearest for UVW), derives the mask as
uvw.sum(0) > 0 and normalizes RGB by the ImageNet statistics.

The host decodes the PNGs (utils/png.py) and draws every augmentation
parameter from ``random.Random(f"{seed}/{epoch}/{idx}")`` in the JAX
package's order; the pixel work runs on the device, batched
(:meth:`Crops.to_device`). Neither PIL nor cv2 is taken here; each of the
JAX package's two chains is written out, selected by ``fast`` as there:

- ``fast=False`` (the default, ``[train] fast_input = False``): the PIL
  chain (crops.py:297-336). ImageEnhance's blends truncate to uint8; the
  hue is PIL's own float HSV round trip; ``rotate(expand=True)`` samples
  at pixel centres in float64 (bilinear, truncated) or on PIL's 16.16
  fixed-point grid (nearest); the bilinear resizes are Pillow's
  separable resampling with its 22-bit integer coefficients (antialiased
  when shrinking), tabulated on the host per (in, out) size; the nearest
  resizes take PIL's accumulated pixel-centre positions. Each rule equals
  Pillow 12 bit for bit (tests/test_torch_crops_pil.py).
- ``fast=True``: the device form of the fast path (crops.py:80-164). The
  colour ops are ImageEnhance's blends, rounded, and OpenCV's 8-bit
  HSV_FULL round trip for the hue; the geometry is one composed affine
  per sample with its pixel-centre convention (crops.py:155) kept as it
  is. Each output pixel samples the source at the inverse map, bilinear
  (RGB) or nearest (UVW), with zeros outside, as cv2.warpAffine with
  BORDER_CONSTANT; the port samples at exact coordinates where OpenCV
  rounds them to 1/32 px. Without augmentation crops of other sizes are
  resized with the pixel-centre bilinear and floor-nearest rules of
  cv2.resize.

Without augmentation a 128-px crop passes through unchanged on both
chains, as PIL's resize to its own size does.
"""

from __future__ import annotations

import functools
import json
import math
import os
import random

import numpy as np
import torch

from sdflabel_tpu_torch.utils import png

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
SIZE = 128  # the network's input crop

COLOR_OPS = ("brightness", "contrast", "color", "hue")
# host -> device augmentation record per sample: op ids in application
# order (-1: none), their factors, the inverse sampling maps of RGB and
# UVW (2x3 each, output pixel -> source pixel) and a clamp flag (resize)
AUG_LEN = 4 + 4 + 6 + 6 + 1


def _color_jitter_params(rng: random.Random, brightness=0.4, contrast=0.4,
                         saturation=0.4, hue=0.2):
    """torchvision-ColorJitter factors and order: 4 uniforms, then one
    shuffle of a 4-list, the JAX package's rng call sequence."""
    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    h = rng.uniform(-hue, hue)
    order = [("brightness", b), ("contrast", c), ("color", s), ("hue", h)]
    rng.shuffle(order)
    return order


def _random_resized_crop_params(rng: random.Random, w: int, h: int,
                                scale=(0.5, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop.get_params logic."""
    area = w * h
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.randint(0, h - ch)
            j = rng.randint(0, w - cw)
            return i, j, ch, cw
    return 0, 0, h, w  # fallback: full image


def geom_matrix(w: int, h: int, angle: float, i: int, j: int, ch: int,
                cw: int, size: int = SIZE) -> np.ndarray:
    """The fast path's composed rotate-expand -> resize -> crop -> resize
    affine (crops.py:136-164), source -> output, float64 (2, 3).
    cv2.getRotationMatrix2D written out."""
    a = angle * (math.pi / 180)
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = w / 2.0, h / 2.0
    rot = np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                    [-beta, alpha, beta * cx + (1 - alpha) * cy]])
    cos, sin = abs(rot[0, 0]), abs(rot[0, 1])
    nw = int(np.ceil(h * sin + w * cos))
    nh = int(np.ceil(h * cos + w * sin))
    rot[0, 2] += (nw - w) / 2.0
    rot[1, 2] += (nh - h) / 2.0
    r3 = np.vstack([rot, [0.0, 0.0, 1.0]])
    s3 = np.diag([size / nw, size / nh, 1.0])
    c3 = np.array([[size / cw, 0.0, -j * size / cw],
                   [0.0, size / ch, -i * size / ch],
                   [0.0, 0.0, 1.0]])
    return (c3 @ s3 @ r3)[:2]


def invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform, written out."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a00, a11 = m[1, 1] * d, m[0, 0] * d
    a01, a10 = -m[0, 1] * d, -m[1, 0] * d
    b0 = -a00 * m[0, 2] - a01 * m[1, 2]
    b1 = -a10 * m[0, 2] - a11 * m[1, 2]
    return np.array([[a00, a01, b0], [a10, a11, b1]])


def _resize_maps(w: int, h: int, size: int = SIZE):
    """Inverse maps of cv2.resize to (size, size): pixel centres for
    bilinear, floor(x * scale) for nearest."""
    sx, sy = w / size, h / size
    lin = np.array([[sx, 0.0, 0.5 * sx - 0.5], [0.0, sy, 0.5 * sy - 0.5]])
    near = np.array([[sx, 0.0, -0.5], [0.0, sy, -0.5]])
    return lin, near


def aug_record(rng: random.Random | None, w: int, h: int) -> np.ndarray:
    """The (AUG_LEN,) record of one sample: rng draws in the JAX package's
    order (colour jitter, angle, crop), or a plain resize without rng."""
    rec = np.zeros(AUG_LEN, np.float64)
    rec[0:4] = -1
    if rng is None:  # identity at 128 px: an exact copy
        lin, near = _resize_maps(w, h)
        rec[8:14], rec[14:20], rec[20] = lin.ravel(), near.ravel(), 1
        return rec
    order = _color_jitter_params(rng)
    rec[0:4] = [COLOR_OPS.index(name) for name, _ in order]
    rec[4:8] = [f for _, f in order]
    angle = rng.uniform(-10, 10)
    i, j, ch, cw = _random_resized_crop_params(rng, 128, 128)
    inv = invert_affine(geom_matrix(w, h, angle, i, j, ch, cw)).ravel()
    rec[8:14] = rec[14:20] = inv
    return rec


# ------------------------------------------------ PIL chain, host side

def pil_rotate_matrix(w: int, h: int, angle: float):
    """PIL Image.rotate(angle, expand=True)'s inverse affine (output pixel
    -> source pixel, 6 floats) and expanded size (nw, nh), in PIL's own
    float order."""
    angle = -math.radians(angle % 360.0)
    cx, cy = w / 2, h / 2
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]

    def tr(x, y):
        return m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]

    m[2], m[5] = tr(-cx, -cy)
    m[2] += cx
    m[5] += cy
    corners = [tr(x, y) for x, y in ((0, 0), (w, 0), (w, h), (0, h))]
    xs, ys = [c[0] for c in corners], [c[1] for c in corners]
    nw = math.ceil(max(xs)) - math.floor(min(xs))
    nh = math.ceil(max(ys)) - math.floor(min(ys))
    m[2], m[5] = tr(-(nw - w) / 2.0, -(nh - h) / 2.0)
    return m, nw, nh


def _fix16(v: float) -> int:
    """Pillow's 16.16 fixed point, floor(v * 65536 + 0.5)."""
    return math.floor(v * 65536.0 + 0.5)


def pil_rotate_record(w: int, h: int, angle: float) -> np.ndarray:
    """(14,) float64: the inverse affine, its fixed-point form (PIL's
    nearest-neighbour affine_fixed: a0, a1, a3, a4 and the pixel-centre
    offsets) and the expanded size."""
    m, nw, nh = pil_rotate_matrix(w, h, angle)
    fix = [_fix16(m[0]), _fix16(m[1]), _fix16(m[2] + m[0] * 0.5 + m[1] * 0.5),
           _fix16(m[3]), _fix16(m[4]), _fix16(m[5] + m[3] * 0.5 + m[4] * 0.5)]
    return np.array(m + fix + [nw, nh], np.float64)


PIL_PRECISION = 22  # Pillow Resample.c PRECISION_BITS (8-bit images)


@functools.lru_cache(maxsize=None)
def pil_bilinear_table(in_size: int, out_size: int):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for the bilinear
    filter over box (0, in_size): per output pixel its first source index
    and its integer weights (22 fractional bits). The support scales with
    the ratio when shrinking (antialiasing). Returns int32 (out, K)
    indices and weights, K = 2 ceil(support) + 1, unused taps weight 0."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # bilinear support 1.0
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int32)
    wts = np.zeros((out_size, ksize), np.int32)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k, ww = [], 0.0
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            k.append(1.0 - t if t < 1.0 else 0.0)
            ww += k[-1]
        for x in range(xmax):
            kv = k[x] / ww if ww != 0.0 else k[x]
            wts[xx, x] = int(0.5 + kv * (1 << PIL_PRECISION))
            idx[xx, x] = xmin + x
    idx.flags.writeable = wts.flags.writeable = False
    return idx, wts


@functools.lru_cache(maxsize=None)
def pil_nearest_table(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's nearest resize (ImagingScaleAffine): the source index of
    each output pixel from the accumulated centre position, -1 outside."""
    a0 = float(in_size) / out_size
    xo = a0 * 0.5
    tab = np.full(out_size, -1, np.int32)
    for x in range(out_size):
        xin = -1 if xo < 0 else int(xo)
        if 0 <= xin < in_size:
            tab[x] = xin
        xo += a0
    tab.flags.writeable = False
    return tab


def pil_record(rng: random.Random | None, w: int, h: int) -> dict:
    """The PIL chain's host record of one sample: 'aug' (the colour ops as
    in :func:`aug_record`), 'rot' (:func:`pil_rotate_record`), and the
    resize tables of its two resizes (after the rotation, and of the crop
    box; without augmentation only the first): 'tab_idx'/'tab_w'
    (4 or 2, SIZE, K) bilinear x1, y1, x2, y2 (the crop's offsets added)
    and 'tab_nn' (4 or 2, SIZE) nearest, -1 outside."""
    rec = np.zeros(AUG_LEN, np.float64)
    rec[0:4] = -1
    tabs_b, tabs_n = [], []
    if rng is None:
        rot = np.zeros(14, np.float64)
        sizes = [(w, 0), (h, 0)]
    else:
        order = _color_jitter_params(rng)
        rec[0:4] = [COLOR_OPS.index(name) for name, _ in order]
        rec[4:8] = [f for _, f in order]
        rot = pil_rotate_record(w, h, rng.uniform(-10, 10))
        i, j, ch, cw = _random_resized_crop_params(rng, SIZE, SIZE)
        sizes = [(int(rot[12]), 0), (int(rot[13]), 0), (cw, j), (ch, i)]
    for n, off in sizes:
        idx, wts = pil_bilinear_table(n, SIZE)
        tabs_b.append((idx + off, wts))
        nn = pil_nearest_table(n, SIZE)
        tabs_n.append(np.where(nn >= 0, nn + off, -1))
    k = max(t[0].shape[1] for t in tabs_b)

    def pad(a):
        return np.pad(a, ((0, 0), (0, k - a.shape[1])))

    return {"aug": rec, "rot": rot,
            "tab_idx": np.stack([pad(t[0]) for t in tabs_b]),
            "tab_w": np.stack([pad(t[1]) for t in tabs_b]),
            "tab_nn": np.stack(tabs_n).astype(np.int32)}


# ------------------------------------------------------------ device side

def _luma(img: torch.Tensor) -> torch.Tensor:
    """PIL convert('L'): (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    x = img.to(torch.int32)
    return ((x[:, 0] * 19595 + x[:, 1] * 38470 + x[:, 2] * 7471 + 0x8000)
            >> 16)


def _blend(low: torch.Tensor, img: torch.Tensor, f: torch.Tensor,
           pil: bool = False):
    """ImageEnhance's blend low + f (img - low) in float32, clipped to
    uint8: truncated as PIL's Image.blend does (``pil``), or rounded as
    the JAX fast path does (crops.py:89-93)."""
    lo = low.float()
    out = lo + f * (img.float() - lo)
    out = out.clamp(0.0, 255.0) if pil else (out + 0.5).clamp(0.0, 255.0)
    return out.to(torch.uint8)


def _cv_round_table(num: float, den: float) -> np.ndarray:
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        t = np.rint(num / (den * i))
    t[0] = 0
    return t.astype(np.int32)


_HSV_SHIFT = 12
_SDIV = _cv_round_table(255 << _HSV_SHIFT, 1.0)
_HDIV = _cv_round_table(256 << _HSV_SHIFT, 6.0)
# OpenCV's HSV sector -> (b, g, r) rows of [v, v(1-s), v(1-sh), v(1-s(1-h))]
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def rgb_to_hsv_full(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) uint8 RGB -> HSV with H in [0, 255], OpenCV's 8-bit
    integer RGB2HSV_FULL."""
    dev = img.device
    x = img.to(torch.int32)
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    sdiv = torch.as_tensor(_SDIV, device=dev)
    hdiv = torch.as_tensor(_HDIV, device=dev)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> _HSV_SHIFT
    h = torch.where(v == r, g - b,
                    torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + half) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 256, h).clamp(0, 255)
    return torch.stack([h, s, v], 1).to(torch.uint8)


def hsv_full_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """OpenCV's 8-bit HSV2RGB_FULL, float32 as it computes it. Its hue
    range here is 255 (RGB2HSV_FULL's is 256), as in OpenCV."""
    x = hsv.float()
    h = x[:, 0] * torch.tensor(6.0 / 255, dtype=torch.float32)
    s = x[:, 1] * (1.0 / 255.0)
    v = x[:, 2] * (1.0 / 255.0)
    h = torch.fmod(h, 6.0)
    sector = torch.floor(h)
    h = h - sector
    sector = sector.to(torch.int64).clamp(0, 5)
    tab = torch.stack([v, v * (1.0 - s), v * (1.0 - s * h),
                       v * (1.0 - s * (1.0 - h))], 1)  # (B, 4, H, W)
    rows = torch.as_tensor(_SECTORS, device=hsv.device)[sector]  # B,H,W,3
    bgr = torch.gather(tab, 1, rows.permute(0, 3, 1, 2))
    bgr = torch.where((s == 0)[:, None], v[:, None].expand_as(bgr), bgr)
    out = torch.round(bgr * 255.0).clamp(0, 255).to(torch.uint8)
    return out.flip(1)  # (b, g, r) -> (r, g, b)


def rgb_to_hsv_pil(img: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) uint8 RGB -> PIL's convert("HSV"), its float32 and
    float64 steps as Pillow's rgb2hsv_row takes them."""
    f32, f64 = torch.float32, torch.float64
    x = img.to(torch.int32)
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    cr = (maxc - minc).to(f32)
    crs = torch.where(cr == 0, torch.ones_like(cr), cr)
    s = cr / maxc.to(f32).clamp(min=1)
    rc, gc, bc = ((maxc - c).to(f32) / crs for c in (r, g, b))
    h = torch.where(r == maxc, (bc - gc).to(f64),
                    torch.where(g == maxc, (2.0 + rc.to(f64)) - bc.to(f64),
                                (4.0 + gc.to(f64)) - rc.to(f64))).to(f32)
    h = torch.fmod(h.to(f64) / 6.0 + 1.0, 1.0).to(f32)
    grey = minc == maxc
    uh = torch.where(grey, 0.0, torch.trunc(h.to(f64) * 255.0).clamp(0, 255))
    us = torch.where(grey, 0.0, torch.trunc(s.to(f64) * 255.0).clamp(0, 255))
    return torch.stack([uh, us, maxc.to(f64)], 1).to(torch.uint8)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """C's round() for x >= 0."""
    f = torch.floor(x)
    return f + (x - f >= 0.5).to(x.dtype)


# PIL's hsv2rgb sector -> (r, g, b) rows of [v, p, q, t]
_PIL_SECTORS = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0],
                         [3, 1, 0], [0, 1, 2]])


def hsv_pil_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """PIL's HSV -> RGB (Pillow's hsv2rgb), float32 and float64 as it
    computes them, rounded half away from zero."""
    f32, f64 = torch.float32, torch.float64
    h, s, v = (hsv[:, k].to(f64) for k in range(3))
    hh = h * 6.0 / 255.0
    i = torch.floor(hh)
    f = (hh - i).to(f32)
    fs = (s / 255.0).to(f32)
    p = _round_half_away(v * (1.0 - fs.to(f64)))
    q = _round_half_away(v * (1.0 - (fs * f).to(f64)))
    t = _round_half_away(v * (1.0 - fs.to(f64) * (1.0 - f.to(f64))))
    tab = torch.stack([v, p.clamp(0, 255), q.clamp(0, 255),
                       t.clamp(0, 255)], 1)
    rows = torch.as_tensor(_PIL_SECTORS, device=hsv.device)[
        i.to(torch.int64) % 6]
    rgb = torch.gather(tab, 1, rows.permute(0, 3, 1, 2))
    rgb = torch.where((hsv[:, 1] == 0)[:, None], v[:, None].expand_as(rgb),
                      rgb)
    return rgb.to(torch.uint8)


def color_jitter(img: torch.Tensor, ops: torch.Tensor, factors: torch.Tensor,
                 valid: torch.Tensor, pil: bool = False) -> torch.Tensor:
    """Each sample's colour ops in its own order (crops.py:45-61 with
    ``pil``, else the fast path's crops.py:96-115). img (B, 3, H, W)
    uint8; ops (B, 4) op ids (-1 none); factors (B, 4) float64 (the blends
    take them as float32, as PIL and numpy do); valid (B, H, W) bool marks
    each sample's own pixels (the contrast mean is taken over them)."""
    to_hsv, from_hsv = ((rgb_to_hsv_pil, hsv_pil_to_rgb) if pil
                        else (rgb_to_hsv_full, hsv_full_to_rgb))
    n_valid = valid.sum((1, 2)).double()
    for k in range(ops.shape[1]):
        f = factors[:, k].float().reshape(-1, 1, 1, 1)
        op = ops[:, k].reshape(-1, 1, 1, 1)
        luma = _luma(img)
        mean = (luma * valid).sum((1, 2)).double() / n_valid
        mean = torch.floor(mean + 0.5).to(torch.uint8).reshape(-1, 1, 1, 1)
        shift = torch.trunc(factors[:, k] * 255).to(torch.int64)
        hsv = to_hsv(img)
        hue = ((hsv[:, 0].to(torch.int64) + (shift % 256)[:, None, None])
               % 256).to(torch.uint8)
        cand = (_blend(torch.zeros_like(img), img, f, pil),
                _blend(mean.expand_as(img), img, f, pil),
                _blend(luma.to(torch.uint8)[:, None].expand_as(img), img, f,
                       pil),
                from_hsv(torch.stack([hue, hsv[:, 1], hsv[:, 2]], 1)))
        out = img
        for i, c in enumerate(cand):
            out = torch.where(op == i, c, out)
        img = out
    return img


def warp(img: torch.Tensor, amap: torch.Tensor, src_wh: torch.Tensor,
         nearest: bool, clamp: torch.Tensor, size: int = SIZE):
    """Sample (B, C, H, W) uint8 at amap (B, 2, 3) float64 (output pixel ->
    source pixel) into (B, C, size, size). Outside the source: 0, unless
    the sample's clamp flag holds the coordinates inside (resize)."""
    b, c, hmax, wmax = img.shape
    dev = img.device
    ys, xs = torch.meshgrid(torch.arange(size, device=dev, dtype=torch.float64),
                            torch.arange(size, device=dev, dtype=torch.float64),
                            indexing="ij")
    a = amap[:, :, :, None, None]
    sx = a[:, 0, 0] * xs + a[:, 0, 1] * ys + a[:, 0, 2]  # (B, size, size)
    sy = a[:, 1, 0] * xs + a[:, 1, 1] * ys + a[:, 1, 2]
    w = src_wh[:, 0].reshape(-1, 1, 1).double()
    h = src_wh[:, 1].reshape(-1, 1, 1).double()
    cl = clamp.reshape(-1, 1, 1)
    sx = torch.where(cl, torch.minimum(sx.clamp(min=0), w - 1), sx)
    sy = torch.where(cl, torch.minimum(sy.clamp(min=0), h - 1), sy)
    flat = img.reshape(b, c, hmax * wmax)

    def tap(ix, iy):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        idx = (iy.clamp(0, hmax - 1) * wmax + ix.clamp(0, wmax - 1)).long()
        val = torch.gather(flat, 2, idx.reshape(b, 1, -1).expand(b, c, -1))
        return val.reshape(b, c, size, size), inside[:, None]

    if nearest:
        v, inside = tap(torch.floor(sx + 0.5), torch.floor(sy + 0.5))
        return torch.where(inside, v, torch.zeros_like(v))
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[:, None], (sy - y0)[:, None]
    acc = torch.zeros(b, c, size, size, device=dev, dtype=torch.float64)
    for dx, dy, wt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                       (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        v, inside = tap(x0 + dx, y0 + dy)
        acc = acc + torch.where(inside, v.double(), 0.0) * wt
    return torch.floor(acc + 0.5).clamp(0, 255).to(torch.uint8)


def _gather_pixels(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                   ok: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W) at integer (B, h, w) coordinates, 0 where not
    `ok` (coordinates there are clamped for the read)."""
    b, c, hmax, wmax = img.shape
    idx = (iy.clamp(0, hmax - 1) * wmax + ix.clamp(0, wmax - 1)).reshape(
        b, 1, -1).expand(b, c, -1)
    v = torch.gather(img.reshape(b, c, hmax * wmax), 2, idx).reshape(
        b, c, *iy.shape[1:])
    return torch.where(ok[:, None], v, torch.zeros_like(v))


def pil_rotate(img: torch.Tensor, rot: torch.Tensor, src_wh: torch.Tensor,
               nearest: bool) -> torch.Tensor:
    """PIL's rotate(angle, BILINEAR | NEAREST, expand=True) of each sample
    (B, C, H, W) uint8 by its :func:`pil_rotate_record` `rot` (B, 14)
    float64, into (B, C, max nh, max nw), zero outside each sample's own
    expanded size. Bilinear (Pillow's generic transform): the source
    point of output pixel (x, y) is A (x + 0.5, y + 0.5) in float64; 0
    outside the source; else the taps around it, clamped to the edge,
    blended in float64 and truncated. Nearest (affine_fixed): the 16.16
    fixed-point position, floored."""
    dev = img.device
    nwh = rot[:, 12:14].long()
    nh, nw = int(nwh[:, 1].max()), int(nwh[:, 0].max())
    w = src_wh[:, 0].reshape(-1, 1, 1)
    h = src_wh[:, 1].reshape(-1, 1, 1)
    ys = torch.arange(nh, device=dev)[None, :, None]
    xs = torch.arange(nw, device=dev)[None, None, :]
    own = (xs < nwh[:, 0, None, None]) & (ys < nwh[:, 1, None, None])
    if nearest:
        a = rot[:, 6:12].long().reshape(-1, 6, 1, 1)
        fx = a[:, 2] + ys * a[:, 1] + xs * a[:, 0]
        fy = a[:, 5] + ys * a[:, 4] + xs * a[:, 3]
        ix = torch.div(fx, 65536, rounding_mode="floor")
        iy = torch.div(fy, 65536, rounding_mode="floor")
        ok = own & (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        return _gather_pixels(img, iy, ix, ok)
    m = rot[:, 0:6].reshape(-1, 6, 1, 1)
    xc = xs.double() + 0.5
    yc = ys.double() + 0.5
    sx = m[:, 0] * xc + m[:, 1] * yc + m[:, 2]
    sy = m[:, 3] * xc + m[:, 4] * yc + m[:, 5]
    ok = own & (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    sx, sy = sx - 0.5, sy - 0.5
    x0, y0 = torch.floor(sx), torch.floor(sy)
    dx, dy = (sx - x0)[:, None], (sy - y0)[:, None]
    x0, y0 = x0.long(), y0.long()
    xa = torch.minimum(x0.clamp(min=0), w - 1)
    xb = torch.minimum((x0 + 1).clamp(min=0), w - 1)
    every = torch.ones_like(ok)

    def row(yy):
        yy = torch.minimum(yy.clamp(min=0), h - 1)
        lo = _gather_pixels(img, yy, xa, every).long()
        hi = _gather_pixels(img, yy, xb, every).long()
        return lo.double() + (hi - lo).double() * dx

    v1 = row(y0)
    below = ((y0 + 1 >= 0) & (y0 + 1 < h))[:, None]
    v2 = torch.where(below, row(y0 + 1), v1)
    v = torch.trunc(v1 + (v2 - v1) * dy).clamp(0, 255).to(torch.uint8)
    return torch.where(ok[:, None], v, torch.zeros_like(v))


def pil_resample(img: torch.Tensor, idx: torch.Tensor,
                 wts: torch.Tensor) -> torch.Tensor:
    """Pillow's bilinear resize of each sample (B, C, H, W) uint8 to
    (B, C, SIZE, SIZE) by its :func:`pil_bilinear_table` rows: `idx`,
    `wts` (B, 2, SIZE, K) int32 for x then y. The horizontal pass runs
    first, each pass rounds ((sum + 2^21) >> 22) and clips to uint8."""
    half = 1 << (PIL_PRECISION - 1)

    def clip8(acc):
        return torch.div(acc + half, 1 << PIL_PRECISION,
                         rounding_mode="floor").clamp(0, 255).to(torch.uint8)

    b, c, h, w = img.shape
    out, k = idx.shape[2], idx.shape[3]
    ix = idx[:, 0].long().reshape(b, 1, 1, out * k).expand(b, c, h, -1)
    taps = torch.gather(img, 3, ix).to(torch.int32).reshape(b, c, h, out, k)
    acc = (taps * wts[:, 0].reshape(b, 1, 1, out, k)).sum(-1)
    tmp = clip8(acc)  # (B, C, H, SIZE)
    iy = idx[:, 1].long().reshape(b, 1, out * k, 1).expand(b, c, -1, out)
    taps = torch.gather(tmp, 2, iy).to(torch.int32).reshape(b, c, out, k, out)
    acc = (taps * wts[:, 1].reshape(b, 1, out, k, 1)).sum(3)
    return clip8(acc)


def pil_nearest(img: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """Pillow's nearest resize of each sample by its
    :func:`pil_nearest_table` rows `tab` (B, 2, SIZE) int32 (x then y, -1
    outside: 0)."""
    tx = tab[:, 0].long()[:, None, :]
    ty = tab[:, 1].long()[:, :, None]
    return _gather_pixels(img, ty.expand(-1, -1, tx.shape[2]),
                          tx.expand(-1, ty.shape[1], -1),
                          (tx >= 0) & (ty >= 0))


def normalize_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 (B, 3, H, W) -> (x / 255 - mean) / std in float32."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=rgb.device).reshape(3, 1, 1)
    std = torch.as_tensor(IMAGENET_STD, device=rgb.device).reshape(3, 1, 1)
    return (rgb.float() / 255.0 - mean) / std


def collate(samples: list[dict]) -> dict:
    """Stack host samples; images of other sizes are zero-padded to the
    largest (their own size rides in crop_size), and the PIL chain's
    resize tables to the most taps (weight 0)."""
    hmax = max(s["rgb"].shape[1] for s in samples)
    wmax = max(s["rgb"].shape[2] for s in samples)
    out = {}
    for k in samples[0]:
        if k in ("rgb", "uvw"):
            arr = np.zeros((len(samples), 3, hmax, wmax), np.uint8)
            for i, s in enumerate(samples):
                _, h, w = s[k].shape
                arr[i, :, :h, :w] = s[k]
            out[k] = arr
        elif k in ("tab_idx", "tab_w"):
            taps = max(s[k].shape[-1] for s in samples)
            out[k] = np.stack([np.pad(s[k], ((0, 0), (0, 0),
                                             (0, taps - s[k].shape[-1])))
                               for s in samples])
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


class Crops:
    """Training crops dataset; ``augment=False`` resizes only.

    ``fast`` selects the chain as the JAX package's ``Crops(fast=)`` does:
    the PIL chain (False, the default) or the fast path's (True); see the
    module docstring. With ``seed`` set, the draws come from a
    per-(seed, epoch, idx) RNG, independent of the order samples are
    visited in; ``set_epoch(e)`` advances the stream. With ``seed=None`` a
    process-local RNG is used (the reference's behaviour). ``stage``
    'f32' gives normalized float32 RGB from :meth:`to_device`, 'uint8'
    the jittered pixels (the train step normalizes them on the device).

    ``self[idx]`` is the host side of a sample: raw decoded (3, H, W) uint8
    images, the supervision and its augmentation record (``aug``, and on
    the PIL chain ``rot`` and the resize tables, :func:`pil_record`).
    """

    def __init__(self, path: str, augment: bool = True,
                 seed: int | None = None, fast: bool = False,
                 stage: str = "f32"):
        if stage not in ("f32", "uint8"):
            raise ValueError(f"stage must be 'f32' or 'uint8', got {stage!r}")
        self.path = path
        self.augment = augment
        self.seed = seed
        self.fast = fast
        self.stage = stage
        self._epoch = 0
        self._rng = random.Random(seed)
        self._cache: dict[int, tuple] = {}
        with open(os.path.join(path, "crops.json")) as f:
            self.gt = json.load(f)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self):
        return len(self.gt)

    def _decode(self, idx: int):
        cached = self._cache.get(idx)
        if cached is not None:
            return cached
        return tuple(png.read(os.path.join(self.path, f"{idx:05d}_{k}.png"))
                     for k in ("rgb", "uvw"))

    def preload(self, num_threads: int = 4) -> None:
        """Decode every pair once into an in-memory uint8 cache."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=max(num_threads, 1)) as pool:
            for idx, pair in enumerate(pool.map(self._decode,
                                                range(len(self)))):
                self._cache[idx] = pair

    def __getitem__(self, idx: int) -> dict:
        gt = self.gt[str(idx)][0]
        rgb, uvw = self._decode(idx)
        h, w = rgb.shape[:2]
        rng = None
        if self.augment:
            rng = (random.Random(f"{self.seed}/{self._epoch}/{idx}")
                   if self.seed is not None else self._rng)
        sample = {
            "rgb": np.ascontiguousarray(rgb.transpose(2, 0, 1)),
            "uvw": np.ascontiguousarray(uvw.transpose(2, 0, 1)),
            "latent": np.array(gt["latent"], np.float32),
            "crop_size": np.asarray((w, h), np.int64),
            "intrinsics": np.array(gt["intrinsics"], np.float32).reshape(3, 3),
            "pose": np.array(gt["extrinsics"], np.float32).reshape(4, 4),
        }
        if self.fast:
            sample["aug"] = aug_record(rng, w, h)
        else:
            sample.update(pil_record(rng, w, h))
        return sample

    def to_device(self, batch: dict, device) -> dict:
        """The pixel work of a collated host batch, on `device`: colour
        jitter, geometry, mask, normalization. Returns rgb (B, 3, 128,
        128) float32 or uint8 (``stage``), uvw (B, 3, 128, 128) uint8,
        mask (B, 128, 128) uint8 and latent (B, L) float32."""
        dev = torch.device(device)

        def put(k):
            return torch.as_tensor(batch[k]).to(dev, non_blocking=True)

        rgb, uvw, aug, wh = put("rgb"), put("uvw"), put("aug"), \
            put("crop_size")
        if not self.augment and (np.asarray(batch["crop_size"]) == SIZE).all():
            pass  # 128-px crops without augmentation pass through
        elif self.fast:
            rgb = self._jitter(rgb, aug, wh, pil=False)
            clamp = aug[:, 20] > 0
            rgb = warp(rgb, aug[:, 8:14].reshape(-1, 2, 3), wh, False, clamp)
            uvw = warp(uvw, aug[:, 14:20].reshape(-1, 2, 3), wh, True, clamp)
        else:
            tab_idx, tab_w, tab_nn = put("tab_idx"), put("tab_w"), \
                put("tab_nn")
            if self.augment:
                rgb = self._jitter(rgb, aug, wh, pil=True)
                rot = put("rot")
                rgb = pil_rotate(rgb, rot, wh, nearest=False)
                uvw = pil_rotate(uvw, rot, wh, nearest=True)
            rgb = pil_resample(rgb, tab_idx[:, 0:2], tab_w[:, 0:2])
            uvw = pil_nearest(uvw, tab_nn[:, 0:2])
            if self.augment:  # the crop box, resized
                rgb = pil_resample(rgb, tab_idx[:, 2:4], tab_w[:, 2:4])
                uvw = pil_nearest(uvw, tab_nn[:, 2:4])
        mask = (uvw.to(torch.int32).sum(1) > 0).to(torch.uint8)
        if self.stage == "f32":
            rgb = normalize_rgb(rgb)
        return {"rgb": rgb.contiguous(), "uvw": uvw.contiguous(),
                "mask": mask,
                "latent": torch.as_tensor(batch["latent"]).to(dev)}

    @staticmethod
    def _jitter(rgb, aug, wh, pil: bool):
        ys = torch.arange(rgb.shape[2], device=rgb.device)[None, :, None]
        xs = torch.arange(rgb.shape[3], device=rgb.device)[None, None, :]
        valid = (ys < wh[:, 1, None, None]) & (xs < wh[:, 0, None, None])
        return color_jitter(rgb, aug[:, 0:4].long(), aug[:, 4:8], valid, pil)


def batch_iterator(dataset, batch_size: int, shuffle: bool = True,
                   seed: int = 0, drop_last: bool = False):
    """Epoch iterator yielding collated host batches."""
    order = np.arange(len(dataset))
    rng = np.random.RandomState(seed)
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        sel = order[start:start + batch_size]
        if drop_last and len(sel) < batch_size:
            continue
        yield collate([dataset[int(i)] for i in sel])


def prefetch_iterator(dataset, batch_size: int, num_threads: int = 2,
                      queue_size: int = 10, shuffle: bool = True,
                      seed: int = 0, drop_last: bool = False):
    """batch_iterator with the samples read by `num_threads` threads ahead
    of the consumer (up to `queue_size` batches); the batches and their
    order are the same. num_threads <= 0 is the synchronous iterator."""
    if num_threads <= 0:
        yield from batch_iterator(dataset, batch_size, shuffle, seed,
                                  drop_last)
        return

    import queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    order = np.arange(len(dataset))
    rng = np.random.RandomState(seed)
    if shuffle:
        rng.shuffle(order)
    batches = [order[s:s + batch_size]
               for s in range(0, len(order), batch_size)
               if not (drop_last and s + batch_size > len(order))]
    q: queue.Queue = queue.Queue(maxsize=max(queue_size, 1))
    stop = threading.Event()
    pool = ThreadPoolExecutor(max_workers=num_threads)

    def produce():
        try:
            for sel in batches:
                if stop.is_set():
                    break
                q.put(collate(list(pool.map(dataset.__getitem__,
                                            [int(i) for i in sel]))))
        finally:
            q.put(None)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while (batch := q.get()) is not None:
            yield batch
    finally:
        stop.set()
        while t.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                t.join(0.01)
        pool.shutdown(wait=True)
