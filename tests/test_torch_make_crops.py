"""The port's crops generator (pipelines/make_crops.py) against
sdflabel_tpu/pipelines/make_crops.py, both driven by the analytic sphere
decoder of tests/test_make_crops.py with the same latents and seed.

64x64 crops have 4096 pixels, so the port renders them through the
row-binned path (on the CPU its windowed plain version) and the JAX
package through its dense oracle.

Tolerances: the host draws are the same numbers, so latents and
intrinsics are equal; the render poses agree to 1e-6 (float32 sin/cos of
two libraries). A footprint bit may flip at a disc edge between the two
renderers' fp32 sums, so the masks and the UVW bins agree on >= 99.5% of
pixels, and RGB, where the masks agree, to 1 LSB of the 8-bit value.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdflabel_tpu.pipelines import make_crops as jmc
from sdflabel_tpu_torch.pipelines import make_crops as tmc
from sdflabel_tpu_torch.utils import png

N_CROPS = 4
KW = dict(crop_px=64, grid_density=24, capacity=1024, seed=0,
          latent_jitter=0.05)


def jax_sphere(latent, points):
    return jnp.linalg.norm(points, axis=-1) - (0.75 + 0.1 * latent[0])


def torch_sphere(latent, points):
    return torch.linalg.norm(points, dim=-1) - (0.75 + 0.1 * latent[0])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    latents = jmc.sample_unit_latents(3, 3, np.random.RandomState(1))
    np.testing.assert_array_equal(
        latents, tmc.sample_unit_latents(3, 3, np.random.RandomState(1)))
    jdir = str(tmp_path_factory.mktemp("jax_crops"))
    tdir = str(tmp_path_factory.mktemp("torch_crops"))
    jdb = jmc.make_crops(jdir, jax_sphere, latents, N_CROPS, **KW)
    tdb = tmc.make_crops(tdir, torch_sphere, latents, N_CROPS, device="cpu",
                         **KW)
    return jdir, tdir, jdb, tdb


def test_crops_json_matches_jax(both):
    jdir, tdir, jdb, tdb = both
    with open(os.path.join(tdir, "crops.json")) as f:
        assert json.load(f) == tdb
    assert jdb.keys() == tdb.keys() == {str(i) for i in range(N_CROPS)}
    for k in jdb:
        (a,), (b,) = jdb[k], tdb[k]
        assert a.keys() == b.keys()
        assert a["latent"] == b["latent"]
        assert a["intrinsics"] == b["intrinsics"]
        np.testing.assert_allclose(b["extrinsics"], a["extrinsics"],
                                   rtol=0, atol=1e-6)


def test_images_match_jax(both):
    jdir, tdir, _, _ = both
    for i in range(N_CROPS):
        names = (f"{i:05d}_uvw.png", f"{i:05d}_rgb.png")
        (ju, jr), (tu, tr) = (
            [np.asarray(Image.open(os.path.join(d, n))) for n in names]
            for d in (jdir, tdir))
        # the port's files read the same through PIL and its own reader
        np.testing.assert_array_equal(png.read(os.path.join(tdir, names[0])),
                                      tu)
        assert tu.shape == tr.shape == (64, 64, 3)
        jm, tm = ju.sum(-1) > 0, tu.sum(-1) > 0
        assert tm.any() and (jm == tm).mean() >= 0.995
        assert (ju == tu).all(-1).mean() >= 0.995
        both_in = jm == tm
        assert np.abs(jr.astype(int) - tr.astype(int))[both_in].max() <= 1


def test_quantize_and_jitter_match_jax():
    rng = np.random.RandomState(4)
    nocs = rng.uniform(-0.1, 1.1, (3, 9, 11)).astype(np.float32)
    nocs[:, 0, 0] = 0.0  # a hole the mask plug fills
    mask = rng.uniform(size=(9, 11)) > 0.3
    mask[0, 0] = True
    np.testing.assert_array_equal(tmc._quantize_uvw(nocs, mask),
                                  jmc._quantize_uvw(nocs, mask))
    lat = rng.randn(3).astype(np.float32)
    np.testing.assert_array_equal(
        tmc._jitter_latent(lat, np.random.RandomState(5), 0.1),
        jmc._jitter_latent(lat, np.random.RandomState(5), 0.1))
