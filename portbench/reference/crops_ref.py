"""Plain reference of the CSS training input chain, run by Pillow itself:
the crops database's PNG pairs opened, each sample's augmentation drawn
and applied, the batch stacked, as sdflabel's datasets/crops.py does with
torchvision's PIL backend (the stock ``[train] fast_input = False``).

Per sample, from ``random.Random(f"{seed}/{epoch}/{idx}")`` in
torchvision's order: ColorJitter's four factors (brightness, contrast,
saturation 0.4, hue 0.2) and a shuffle of their order, applied with
ImageEnhance and, for the hue, PIL's HSV; a rotation of U(-10, 10)
degrees with ``expand=True`` (bilinear for RGB, nearest for UVW); a
resize to 128 px; RandomResizedCrop's box (scale 0.5-1, ratio 3/4-4/3)
cut and resized to 128 px again. The mask is uvw.sum > 0. An epoch's
batches follow np.random.RandomState(epoch)'s shuffle of the indices.
"""

from __future__ import annotations

import json
import math
import os
import random

import numpy as np
from PIL import Image, ImageEnhance

SIZE = 128  # the network's input crop


def jitter_params(rng: random.Random, brightness=0.4, contrast=0.4,
                  saturation=0.4, hue=0.2) -> list:
    """ColorJitter's factors, then one shuffle of their order."""
    b = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
    s = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
    h = rng.uniform(-hue, hue)
    order = [("brightness", b), ("contrast", c), ("color", s), ("hue", h)]
    rng.shuffle(order)
    return order


def crop_box(rng: random.Random, w: int, h: int, scale=(0.5, 1.0),
             ratio=(3 / 4, 4 / 3)) -> tuple[int, int, int, int]:
    """RandomResizedCrop's box (top, left, height, width): ten tries, then
    the whole image."""
    area = w * h
    for _ in range(10):
        target = rng.uniform(*scale) * area
        aspect = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target * aspect)))
        ch = int(round(math.sqrt(target / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            return rng.randint(0, h - ch), rng.randint(0, w - cw), ch, cw
    return 0, 0, h, w


def jitter(img: Image.Image, order: list) -> Image.Image:
    for name, f in order:
        if name == "brightness":
            img = ImageEnhance.Brightness(img).enhance(f)
        elif name == "contrast":
            img = ImageEnhance.Contrast(img).enhance(f)
        elif name == "color":
            img = ImageEnhance.Color(img).enhance(f)
        else:
            hsv = np.array(img.convert("HSV"), dtype=np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(f * 255)) % 256
            img = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    return img


def sample(path: str, idx: int, seed: int, epoch: int) -> tuple:
    """(rgb (3, 128, 128) uint8, uvw (3, 128, 128) uint8) of one sample."""
    rgb = Image.open(os.path.join(path, f"{idx:05d}_rgb.png")).convert("RGB")
    uvw = Image.open(os.path.join(path, f"{idx:05d}_uvw.png")).convert("RGB")
    rng = random.Random(f"{seed}/{epoch}/{idx}")
    rgb = jitter(rgb, jitter_params(rng))
    angle = rng.uniform(-10, 10)
    rgb = rgb.rotate(angle, Image.BILINEAR, expand=True)
    uvw = uvw.rotate(angle, Image.NEAREST, expand=True)
    rgb = rgb.resize((SIZE, SIZE), Image.BILINEAR)
    uvw = uvw.resize((SIZE, SIZE), Image.NEAREST)
    i, j, ch, cw = crop_box(rng, SIZE, SIZE)
    rgb = rgb.crop((j, i, j + cw, i + ch)).resize((SIZE, SIZE),
                                                  Image.BILINEAR)
    uvw = uvw.crop((j, i, j + cw, i + ch)).resize((SIZE, SIZE),
                                                  Image.NEAREST)
    return (np.ascontiguousarray(np.asarray(rgb, np.uint8).transpose(2, 0, 1)),
            np.ascontiguousarray(np.asarray(uvw, np.uint8).transpose(2, 0, 1)))


def batch(path: str, gt: dict, idx, seed: int, epoch: int) -> dict:
    """The batch of samples `idx`: rgb, uvw, mask (uint8) and latent."""
    pairs = [sample(path, int(i), seed, epoch) for i in idx]
    uvw = np.stack([p[1] for p in pairs])
    return {"rgb": np.stack([p[0] for p in pairs]), "uvw": uvw,
            "mask": (uvw.astype(np.int32).sum(1) > 0).astype(np.uint8),
            "latent": np.array([gt[str(int(i))][0]["latent"] for i in idx],
                               np.float32)}


def epoch_batches(n: int, batch_size: int, epoch: int) -> list:
    """The sample indices of each batch of an epoch."""
    order = np.arange(n)
    np.random.RandomState(epoch).shuffle(order)
    return [order[s:s + batch_size] for s in range(0, n, batch_size)]


def load_gt(path: str) -> dict:
    with open(os.path.join(path, "crops.json")) as f:
        return json.load(f)
