"""The port's PIL chain (data/crops.py, ``fast=False``, the stock
``[train] fast_input = False``) against sdflabel_tpu/data/crops.py's
``Crops(fast=False)``, which runs Pillow.

Each rule of the chain is held against Pillow alone too: the HSV round
trip over every 8-bit colour, the three ImageEnhance blends, rotate with
expand=True (bilinear and nearest, both signs), and the bilinear and
nearest resizes, shrinking and growing. All of them are bit-equal. The
whole chain against JAX over seeds and epochs is then asked for: RGB
within 1 LSB with >= 99.5% equal, UVW and mask >= 99.5% equal; what it
reaches is bit-equality, which the tests also assert.
"""

import json
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance

from sdflabel_tpu.data import crops as jcrops
from sdflabel_tpu_torch.data import crops as tcrops


def _chw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)
                                                 .transpose(2, 0, 1)))[None]


def _hwc(t):
    return t[0].numpy().transpose(1, 2, 0)


@pytest.fixture(scope="module")
def pil_db(tmp_path_factory):
    """Smooth and noisy crops at sizes that shrink (150-230 px) and grow
    (60-100 px) in the chain's first resize, with a disc of UVW labels."""
    root = tmp_path_factory.mktemp("torch_crops_pil")
    rng = np.random.RandomState(11)
    gt = {}
    sizes = [(230, 180), (64, 60), (128, 128), (97, 150), (200, 90),
             (100, 100), (150, 170), (75, 128)]
    for i, (w, h) in enumerate(sizes):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        yy, xx = yy / h, xx / w
        phase = rng.rand() * 2 * np.pi
        rgb = np.stack([0.5 + 0.5 * np.sin(2 * np.pi * xx + phase), yy,
                        0.5 + 0.5 * np.cos(3 * np.pi * yy)], -1) * 255
        if i % 2:
            rgb = rgb * 0.7 + rng.randint(0, 77, rgb.shape)
        disc = ((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.12
        uvw = np.stack([xx * 200 + 30, yy * 200 + 30,
                        np.full_like(xx, 128.0)], -1) * disc[..., None]
        Image.fromarray(rgb.astype(np.uint8)).save(
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


def test_hsv_round_trip_equals_pil_on_every_colour():
    c = np.arange(1 << 24, dtype=np.uint32)[::7]
    rgb = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255],
                   -1).astype(np.uint8).reshape(1, -1, 3)
    want = np.asarray(Image.fromarray(rgb, "RGB").convert("HSV"))
    np.testing.assert_array_equal(_hwc(tcrops.rgb_to_hsv_pil(_chw(rgb))),
                                  want)
    want = np.asarray(Image.fromarray(rgb, "HSV").convert("RGB"))
    np.testing.assert_array_equal(_hwc(tcrops.hsv_pil_to_rgb(_chw(rgb))),
                                  want)


@pytest.mark.parametrize("factor", [0.6, 0.93, 1.0, 1.17, 1.4])
def test_blends_equal_image_enhance(factor):
    rng = np.random.RandomState(int(factor * 100))
    img = rng.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    pil = Image.fromarray(img)
    ones = torch.ones(1, 37, 53, dtype=torch.bool)
    for op, enh in enumerate((ImageEnhance.Brightness, ImageEnhance.Contrast,
                              ImageEnhance.Color)):
        got = tcrops.color_jitter(
            _chw(img), torch.tensor([[op, -1, -1, -1]]),
            torch.tensor([[factor, 0, 0, 0]], dtype=torch.float64), ones,
            pil=True)
        np.testing.assert_array_equal(_hwc(got),
                                      np.asarray(enh(pil).enhance(factor)))


@pytest.mark.parametrize("angle", [-9.73, -0.41, 3.2, 9.99])
def test_rotate_expand_equals_pil(angle):
    rng = np.random.RandomState(1)
    for h, w in ((45, 70), (128, 128), (201, 163)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        rot = torch.as_tensor(tcrops.pil_rotate_record(w, h, angle))[None]
        wh = torch.tensor([[w, h]])
        for nearest, resample in ((False, Image.BILINEAR),
                                  (True, Image.NEAREST)):
            want = np.asarray(Image.fromarray(img).rotate(angle, resample,
                                                          expand=True))
            got = _hwc(tcrops.pil_rotate(_chw(img), rot, wh, nearest))
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(230, 180), (60, 64), (128, 97), (31, 300)])
def test_resizes_equal_pil(size):
    w, h = size
    rng = np.random.RandomState(w)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    ix, wx = tcrops.pil_bilinear_table(w, tcrops.SIZE)
    iy, wy = tcrops.pil_bilinear_table(h, tcrops.SIZE)
    k = max(ix.shape[1], iy.shape[1])

    def pad(a):
        return np.pad(a, ((0, 0), (0, k - a.shape[1])))

    idx = torch.as_tensor(np.stack([pad(ix), pad(iy)]))[None]
    wts = torch.as_tensor(np.stack([pad(wx), pad(wy)]))[None]
    want = np.asarray(Image.fromarray(img).resize((128, 128), Image.BILINEAR))
    np.testing.assert_array_equal(
        _hwc(tcrops.pil_resample(_chw(img), idx, wts)), want)
    tab = torch.as_tensor(np.stack([tcrops.pil_nearest_table(w, 128),
                                    tcrops.pil_nearest_table(h, 128)]))[None]
    want = np.asarray(Image.fromarray(img).resize((128, 128), Image.NEAREST))
    np.testing.assert_array_equal(_hwc(tcrops.pil_nearest(_chw(img), tab)),
                                  want)


def _compare(jds, tds, idx):
    out = tds.to_device(tcrops.collate([tds[i] for i in idx]), "cpu")
    for n, i in enumerate(idx):
        want = jds[i]
        got_rgb = out["rgb"][n].numpy()
        if got_rgb.dtype == np.uint8:
            got_rgb = tcrops.normalize_rgb(out["rgb"][n:n + 1])[0].numpy()
        # JAX's float RGB back to its uint8 levels: (x * std + mean) * 255
        lv = np.rint((want["rgb"] * tcrops.IMAGENET_STD[:, None, None]
                      + tcrops.IMAGENET_MEAN[:, None, None]) * 255)
        lg = np.rint((got_rgb * tcrops.IMAGENET_STD[:, None, None]
                      + tcrops.IMAGENET_MEAN[:, None, None]) * 255)
        d = np.abs(lv - lg)
        assert d.max() <= 1 and (d == 0).mean() >= 0.995, (i, d.max())
        assert (out["uvw"][n].numpy() == want["uvw"]).mean() >= 0.995
        assert (out["mask"][n].numpy() == want["mask"]).mean() >= 0.995
        # what is reached: bit-equality
        np.testing.assert_array_equal(got_rgb, want["rgb"])
        np.testing.assert_array_equal(out["uvw"][n].numpy(), want["uvw"])
        np.testing.assert_array_equal(out["mask"][n].numpy(), want["mask"])
        np.testing.assert_array_equal(out["latent"][n].numpy(),
                                      want["latent"])


@pytest.mark.parametrize("seed,epoch", [(5, 0), (5, 1), (17, 3)])
def test_augmented_chain_equals_jax_pil_chain(pil_db, seed, epoch):
    jds = jcrops.Crops(pil_db, augment=True, seed=seed)
    tds = tcrops.Crops(pil_db, augment=True, seed=seed, stage="uint8")
    jds.set_epoch(epoch)
    tds.set_epoch(epoch)
    _compare(jds, tds, list(range(len(tds))))


def test_angles_cover_both_signs(pil_db):
    signs = set()
    for seed, epoch in ((5, 0), (5, 1), (17, 3)):
        for i in range(8):
            rng = random.Random(f"{seed}/{epoch}/{i}")
            jcrops._color_jitter_params(rng)
            signs.add(np.sign(rng.uniform(-10, 10)))
    assert signs == {-1.0, 1.0}


def test_no_augmentation_equals_jax_pil_chain(pil_db):
    jds = jcrops.Crops(pil_db, augment=False)
    tds = tcrops.Crops(pil_db, augment=False)  # float32 RGB on the host side
    _compare(jds, tds, list(range(len(tds))))


def test_fast_flag_selects_the_chain(pil_db):
    rec = tcrops.Crops(pil_db, seed=1)[0]
    assert {"rot", "tab_idx", "tab_w", "tab_nn"} <= set(rec)
    rec = tcrops.Crops(pil_db, seed=1, fast=True)[0]
    assert "rot" not in rec and rec["aug"].shape == (tcrops.AUG_LEN,)
