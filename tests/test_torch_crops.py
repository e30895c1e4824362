"""The port's crops input (utils/png.py, data/crops.py) against PIL and
sdflabel_tpu/data/crops.py.

Tolerances: PNG bytes and pixels are exact. The augmentation parameters
are the same draws, exactly. Without augmentation a 128-px crop equals
the PIL path exactly. With augmentation the port follows the JAX fast
path (cv2): OpenCV rounds sampling coordinates to 1/32 px and bilinear
weights to 15 bits where the port samples exactly, and its HSV round trip
rounds in its own order, so an RGB value may differ by 1 LSB (2 allowed,
>= 99.9% of values equal) and a nearest-sampled UVW pixel may take its
neighbour at a pixel boundary (>= 99.5% of values equal).
"""

import json
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from sdflabel_tpu.data import crops as jcrops
from sdflabel_tpu_torch.data import crops as tcrops
from sdflabel_tpu_torch.utils import png


@pytest.fixture(scope="module")
def smooth_db(tmp_path_factory):
    """Smooth gradients with a disc of UVW labels, as
    tests/test_crops_fast.py builds them; even crops at 128 px, odd ones
    at 96 px."""
    root = tmp_path_factory.mktemp("torch_crops")
    rng = np.random.RandomState(3)
    gt = {}
    for i in range(6):
        px = 128 if i % 2 == 0 else 96
        yy, xx = np.mgrid[0:px, 0:px].astype(np.float32) / px
        phase = rng.rand() * 2 * np.pi
        rgb = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * xx + phase), yy,
                        0.5 + 0.5 * np.cos(3 * np.pi * yy)], -1)
        disc = ((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.12
        uvw = np.stack([xx * 200 + 30, yy * 200 + 30,
                        np.full_like(xx, 128.0)], -1) * disc[..., None]
        Image.fromarray((rgb * 255).astype(np.uint8)).save(
            os.path.join(root, f"{i:05d}_rgb.png"))
        Image.fromarray(uvw.astype(np.uint8)).save(
            os.path.join(root, f"{i:05d}_uvw.png"))
        lat = rng.randn(3)
        gt[str(i)] = [{"latent": (lat / np.linalg.norm(lat)).tolist(),
                       "extrinsics": rng.randn(16).tolist(),
                       "intrinsics": rng.randn(9).tolist()}]
    with open(os.path.join(root, "crops.json"), "w") as f:
        json.dump(gt, f)
    return str(root)


def _images():
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = np.stack([xx * 4, yy * 6, (xx + yy) * 3], -1) % 256
    return [rng.randint(0, 256, (29, 31, 3)), smooth,
            np.full((5, 7, 3), 200), rng.randint(0, 3, (40, 40, 3)) * 120]


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
def test_png_reads_pil_files_exactly(tmp_path, mode):
    for k, img in enumerate(_images()):
        pil = Image.fromarray(img.astype(np.uint8)).convert(mode)
        path = os.path.join(tmp_path, f"{k}.png")
        pil.save(path)
        want = np.asarray(Image.open(path).convert("RGB"))
        np.testing.assert_array_equal(png.read(path), want)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_writes_what_pil_reads(tmp_path, filter_type):
    # each row filter once, so the reader is held on all five
    for k, img in enumerate(_images()):
        img = img.astype(np.uint8)
        data = png.encode(img, filter_type=filter_type)
        path = os.path.join(tmp_path, f"{k}.png")
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
        np.testing.assert_array_equal(png.decode(data), img)


def test_augmentation_parameters_equal_jax():
    for key in ("1/0/0", "1/3/17", "-1/2/5", "7/0/999"):
        a, b = random.Random(key), random.Random(key)
        assert (tcrops._color_jitter_params(a)
                == jcrops._color_jitter_params(b))
        assert a.uniform(-10, 10) == b.uniform(-10, 10)
        assert (tcrops._random_resized_crop_params(a, 128, 128)
                == jcrops._random_resized_crop_params(b, 128, 128))
        assert a.random() == b.random()  # same number of draws


def test_geometry_equals_cv2_composition():
    import cv2

    for w, h, angle, (i, j, ch, cw) in ((128, 128, 7.3, (3, 10, 90, 100)),
                                        (96, 80, -9.9, (0, 0, 128, 128)),
                                        (140, 128, 0.0, (20, 5, 64, 70))):
        rot = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), angle, 1.0)
        cos, sin = abs(rot[0, 0]), abs(rot[0, 1])
        nw = int(np.ceil(h * sin + w * cos))
        nh = int(np.ceil(h * cos + w * sin))
        rot[0, 2] += (nw - w) / 2.0
        rot[1, 2] += (nh - h) / 2.0
        m = (np.array([[128 / cw, 0, -j * 128 / cw],
                       [0, 128 / ch, -i * 128 / ch], [0, 0, 1]])
             @ np.diag([128 / nw, 128 / nh, 1.0])
             @ np.vstack([rot, [0, 0, 1]]))[:2]
        got = tcrops.geom_matrix(w, h, angle, i, j, ch, cw)
        np.testing.assert_allclose(got, m, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tcrops.invert_affine(got),
                                   cv2.invertAffineTransform(m), rtol=0,
                                   atol=1e-12)


def _port_batch(ds, idx):
    return ds.to_device(tcrops.collate([ds[i] for i in idx]), "cpu")


def test_no_augmentation_equals_pil_path(smooth_db):
    jds = jcrops.Crops(smooth_db, augment=False)
    tds = tcrops.Crops(smooth_db, augment=False)
    idx = [0, 2, 4]  # the 128-px crops: PIL's resize to 128 is a copy
    out = _port_batch(tds, idx)
    for n, i in enumerate(idx):
        want = jds[i]
        np.testing.assert_array_equal(out["rgb"][n].numpy(), want["rgb"])
        np.testing.assert_array_equal(out["uvw"][n].numpy(), want["uvw"])
        np.testing.assert_array_equal(out["mask"][n].numpy(), want["mask"])
        np.testing.assert_array_equal(out["latent"][n].numpy(),
                                      want["latent"])
    host = tds[0]
    for k in ("crop_size", "intrinsics", "pose"):
        np.testing.assert_array_equal(host[k], jds[0][k])


@pytest.mark.parametrize("epoch", [0, 1])
def test_augmented_pixels_match_jax_fast_path(smooth_db, epoch):
    jds = jcrops.Crops(smooth_db, augment=True, seed=5, fast=True,
                       stage="uint8")
    tds = tcrops.Crops(smooth_db, augment=True, seed=5, fast=True,
                       stage="uint8")
    jds.set_epoch(epoch)
    tds.set_epoch(epoch)
    idx = list(range(len(tds)))  # 128- and 96-px crops in one batch
    out = _port_batch(tds, idx)
    rgb_eq, uvw_eq, mask_eq = [], [], []
    for n, i in enumerate(idx):
        want = jds[i]
        d = np.abs(out["rgb"][n].numpy().astype(int)
                   - want["rgb"].astype(int))
        assert d.max() <= 2, (i, d.max())
        rgb_eq.append((d == 0).mean())
        uvw_eq.append((out["uvw"][n].numpy() == want["uvw"]).mean())
        mask_eq.append((out["mask"][n].numpy() == want["mask"]).mean())
    assert min(rgb_eq) >= 0.999, rgb_eq
    assert min(uvw_eq) >= 0.995 and min(mask_eq) >= 0.995, (uvw_eq, mask_eq)
    # a float32 batch is the uint8 one normalized
    f32 = tcrops.Crops(smooth_db, augment=True, seed=5, fast=True)
    f32.set_epoch(epoch)
    np.testing.assert_array_equal(_port_batch(f32, idx)["rgb"].numpy(),
                                  tcrops.normalize_rgb(out["rgb"]).numpy())


def test_prefetch_iterator_matches_sync(smooth_db):
    ds = tcrops.Crops(smooth_db, augment=True, seed=2, stage="uint8")
    sync = list(tcrops.batch_iterator(ds, 4, seed=3))
    pre = list(tcrops.prefetch_iterator(ds, 4, num_threads=3, queue_size=1,
                                        seed=3))
    assert len(sync) == len(pre) == 2
    for a, b in zip(sync, pre):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # a consumer that stops early leaves no producer behind
    it = tcrops.prefetch_iterator(ds, 1, num_threads=2, queue_size=1)
    next(it)
    it.close()


def test_mask_and_device_batch_types(smooth_db):
    ds = tcrops.Crops(smooth_db, augment=True, seed=1, stage="uint8")
    out = _port_batch(ds, [1, 2])
    assert out["rgb"].dtype == out["uvw"].dtype == torch.uint8
    assert out["rgb"].shape == out["uvw"].shape == (2, 3, 128, 128)
    np.testing.assert_array_equal(
        out["mask"].numpy(), (out["uvw"].numpy().astype(int).sum(1) > 0))
    with pytest.raises(ValueError):
        tcrops.Crops(smooth_db, stage="f16")
