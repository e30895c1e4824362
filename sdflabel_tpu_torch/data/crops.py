"""Crops dataset: CSS training crops with synchronized augmentation.

Counterpart of sdflabel_tpu/data/crops.py (reference datasets/crops.py):
reads ``crops.json`` and the ``{idx:05d}_rgb.png`` / ``_uvw.png`` pairs,
jitters the RGB colours, applies one random rotation + random resized crop
to both images (bilinear for RGB, nearest for UVW), derives the mask as
uvw.sum(0) > 0 and normalizes RGB by the ImageNet statistics.

The host decodes the PNGs (utils/png.py) and draws every augmentation
parameter from ``random.Random(f"{seed}/{epoch}/{idx}")`` in the JAX
package's order; the pixel work runs on the device, batched
(:meth:`Crops.to_device`). It follows the JAX package's fast path
(crops.py:80-164), since neither PIL nor cv2 is taken here:

- the colour ops are PIL ImageEnhance's blends on uint8 and OpenCV's
  8-bit HSV_FULL round trip for the hue, written out;
- the geometry is the fast path's one composed affine per sample, with
  its pixel-centre convention (crops.py:155) kept as it is. Each output
  pixel samples the source at the inverse map, bilinear (RGB) or nearest
  (UVW), with zeros outside, as cv2.warpAffine with BORDER_CONSTANT; the
  port samples at exact coordinates where OpenCV rounds them to 1/32 px.

Without augmentation a 128-px crop passes through unchanged, as PIL's
resize to its own size does. Other sizes are resized with the pixel-centre
bilinear and the floor-nearest rules of cv2.resize.
"""

from __future__ import annotations

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


# ------------------------------------------------------------ device side

def _luma(img: torch.Tensor) -> torch.Tensor:
    """PIL convert('L'): (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    x = img.to(torch.int32)
    return ((x[:, 0] * 19595 + x[:, 1] * 38470 + x[:, 2] * 7471 + 0x8000)
            >> 16)


def _blend(low: torch.Tensor, img: torch.Tensor, f: torch.Tensor):
    """PIL ImageEnhance blend low + f (img - low), rounded and clipped to
    uint8, in float32 (crops.py:89-93)."""
    lo = low.float()
    out = lo + f * (img.float() - lo)
    return (out + 0.5).clamp(0.0, 255.0).to(torch.uint8)


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


def color_jitter(img: torch.Tensor, ops: torch.Tensor, factors: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Each sample's colour ops in its own order (crops.py:96-115).
    img (B, 3, H, W) uint8; ops (B, 4) op ids (-1 none); factors (B, 4)
    float64 (the blends take them as float32, as numpy does); valid (B, H, W) bool marks each sample's own pixels (the
    contrast mean is taken over them)."""
    n_valid = valid.sum((1, 2)).double()
    for k in range(ops.shape[1]):
        f = factors[:, k].float().reshape(-1, 1, 1, 1)
        op = ops[:, k].reshape(-1, 1, 1, 1)
        luma = _luma(img)
        mean = (luma * valid).sum((1, 2)).double() / n_valid
        mean = torch.floor(mean + 0.5).to(torch.uint8).reshape(-1, 1, 1, 1)
        shift = torch.trunc(factors[:, k] * 255).to(torch.int64)
        hsv = rgb_to_hsv_full(img)
        hue = ((hsv[:, 0].to(torch.int64) + (shift % 256)[:, None, None])
               % 256).to(torch.uint8)
        cand = (_blend(torch.zeros_like(img), img, f),
                _blend(mean.expand_as(img), img, f),
                _blend(luma.to(torch.uint8)[:, None].expand_as(img), img, f),
                hsv_full_to_rgb(torch.stack([hue, hsv[:, 1], hsv[:, 2]], 1)))
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


def normalize_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 (B, 3, H, W) -> (x / 255 - mean) / std in float32."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=rgb.device).reshape(3, 1, 1)
    std = torch.as_tensor(IMAGENET_STD, device=rgb.device).reshape(3, 1, 1)
    return (rgb.float() / 255.0 - mean) / std


def collate(samples: list[dict]) -> dict:
    """Stack host samples; images of other sizes are zero-padded to the
    largest (their own size rides in crop_size)."""
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
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


class Crops:
    """Training crops dataset; ``augment=False`` resizes only.

    With ``seed`` set, the draws come from a per-(seed, epoch, idx) RNG,
    independent of the order samples are visited in; ``set_epoch(e)``
    advances the stream. With ``seed=None`` a process-local RNG is used
    (the reference's behaviour). ``stage`` 'f32' gives normalized float32
    RGB from :meth:`to_device`, 'uint8' the jittered pixels (the train step
    normalizes them on the device).

    ``self[idx]`` is the host side of a sample: raw decoded (3, H, W) uint8
    images, the supervision and its (AUG_LEN,) augmentation record.
    """

    def __init__(self, path: str, augment: bool = True,
                 seed: int | None = None, stage: str = "f32"):
        if stage not in ("f32", "uint8"):
            raise ValueError(f"stage must be 'f32' or 'uint8', got {stage!r}")
        self.path = path
        self.augment = augment
        self.seed = seed
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
        return {
            "rgb": np.ascontiguousarray(rgb.transpose(2, 0, 1)),
            "uvw": np.ascontiguousarray(uvw.transpose(2, 0, 1)),
            "aug": aug_record(rng, w, h),
            "latent": np.array(gt["latent"], np.float32),
            "crop_size": np.asarray((w, h), np.int64),
            "intrinsics": np.array(gt["intrinsics"], np.float32).reshape(3, 3),
            "pose": np.array(gt["extrinsics"], np.float32).reshape(4, 4),
        }

    def to_device(self, batch: dict, device) -> dict:
        """The pixel work of a collated host batch, on `device`: colour
        jitter, geometry, mask, normalization. Returns rgb (B, 3, 128,
        128) float32 or uint8 (``stage``), uvw (B, 3, 128, 128) uint8,
        mask (B, 128, 128) uint8 and latent (B, L) float32."""
        dev = torch.device(device)
        rgb = torch.as_tensor(batch["rgb"]).to(dev, non_blocking=True)
        uvw = torch.as_tensor(batch["uvw"]).to(dev, non_blocking=True)
        aug = torch.as_tensor(batch["aug"]).to(dev, non_blocking=True)
        wh = torch.as_tensor(batch["crop_size"]).to(dev, non_blocking=True)
        if not self.augment and (np.asarray(batch["crop_size"]) == SIZE).all():
            pass  # 128-px crops without augmentation pass through
        else:
            ys = torch.arange(rgb.shape[2], device=dev)[None, :, None]
            xs = torch.arange(rgb.shape[3], device=dev)[None, None, :]
            valid = (ys < wh[:, 1, None, None]) & (xs < wh[:, 0, None, None])
            rgb = color_jitter(rgb, aug[:, 0:4].long(), aug[:, 4:8], valid)
            clamp = aug[:, 20] > 0
            rgb = warp(rgb, aug[:, 8:14].reshape(-1, 2, 3), wh, False, clamp)
            uvw = warp(uvw, aug[:, 14:20].reshape(-1, 2, 3), wh, True, clamp)
        mask = (uvw.to(torch.int32).sum(1) > 0).to(torch.uint8)
        if self.stage == "f32":
            rgb = normalize_rgb(rgb)
        return {"rgb": rgb.contiguous(), "uvw": uvw.contiguous(),
                "mask": mask,
                "latent": torch.as_tensor(batch["latent"]).to(dev)}


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
