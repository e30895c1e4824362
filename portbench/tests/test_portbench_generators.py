"""Each generator gives the same inputs for the same seed, and every seed
the same set of sizes."""

from __future__ import annotations

import os

import numpy as np
import torch

from portbench.jobs import dsdf_train, refine
from portbench.reference import refine_ref
from portbench import weights


def _pool(files, seed):
    _, _, config, traffic = files
    params = weights.geometric(config, seed, "cpu")
    dec = refine_ref.Decoder(params, config["NetworkSpecs"]["latent_in"])
    grid = refine_ref.grid_points(config["refine"]["grid_density"], "cpu")
    return refine.make_pool(traffic, config["refine"], dec, grid, seed,
                            "cpu")


def test_refine_pool_is_the_seeds(refine_files):
    seed = 2 ** 33 + 5  # wider than 32 bits, as a run's seed may be
    (fa, oa), (fb, ob) = _pool(refine_files, seed), _pool(refine_files, seed)
    assert oa == ob
    for ca, cb in zip(sum(fa, []), sum(fb, [])):
        for k in ("intrinsics", "nocs_target", "frustum", "fmask"):
            np.testing.assert_array_equal(ca[k], cb[k])
        for a, b in zip(ca["start"], cb["start"]):
            np.testing.assert_array_equal(a, b)
    fc, _ = _pool(refine_files, seed + 1)
    assert any(not np.array_equal(a["frustum"], c["frustum"])
               for a, c in zip(sum(fa, []), sum(fc, [])))
    # the sizes come from the design alone
    assert [c["crop_hw"] for c in sum(fa, [])] == \
        [c["crop_hw"] for c in sum(fc, [])]


def test_refine_pool_is_sound(refine_files):
    _, _, config, traffic = refine_files
    frames, order = _pool(refine_files, 3)
    assert sorted(order) == list(range(traffic["frames"]))
    for c in sum(frames, []):
        h, w = c["crop_hw"]
        assert h * w <= 32 ** 2 and c["nocs_target"].shape == (3, h, w)
        assert c["nocs_target"].max() > 0  # the car shows in its crop
        assert c["frustum"].shape == (traffic["lidar_points"], 3)
        l, t, r, b = c["anno"]["bbox"]
        assert b - t >= traffic["min_box_height_px"]


def test_design_ignores_the_run_seed(refine_files):
    _, _, _, traffic = refine_files
    a, b = refine.design(traffic), refine.design(traffic)
    assert [s["bbox"] for s in a] == [s["bbox"] for s in b]


def test_geometric_decoder_has_a_surface(refine_files):
    _, _, config, _ = refine_files
    params = weights.geometric(config, 11, "cpu")
    dec = refine_ref.Decoder(params, config["NetworkSpecs"]["latent_in"],
                             "fp32")
    grid = refine_ref.grid_points(24, "cpu")
    lat = torch.nn.functional.normalize(torch.randn(4, 3), dim=1)
    sdf = dec(lat, grid)
    for s in sdf:
        assert (s < 0).any() and (s > 0).any()  # a closed zero set


def test_dsdf_pack_is_the_seeds(dsdf_files):
    _, _, _, traffic = dsdf_files
    a = dsdf_train.make_pack(traffic, 2 ** 40 + 1, "cpu")
    b = dsdf_train.make_pack(traffic, 2 ** 40 + 1, "cpu")
    c = dsdf_train.make_pack(traffic, 2 ** 40 + 2, "cpu")
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (traffic["scenes"], traffic["rows_per_scene"] // 2,
                          4)


def test_dsdf_pack_rows_carry_their_sdf(dsdf_files):
    """Positive rows are outside (sdf >= 0), negative rows inside, and each
    row's sdf is the analytic distance of its point (the half extents are
    drawn first from the same generator)."""
    _, _, _, traffic = dsdf_files
    seed = 7
    pos, neg, pc, nc = dsdf_train.make_pack(traffic, seed, "cpu")
    assert (pos[..., 3] >= 0).all() and (neg[..., 3] < 0).all()
    gen = torch.Generator().manual_seed(seed)
    S = traffic["scenes"]
    lo = torch.tensor(traffic["half_extent_lo"])
    hi = torch.tensor(traffic["half_extent_hi"])
    h = lo + (hi - lo) * torch.rand(S, 3, generator=gen)
    r = traffic["rounding"][0] + (traffic["rounding"][1] - traffic[
        "rounding"][0]) * torch.rand(S, generator=gen)
    for rows in (pos, neg):
        want = dsdf_train._box_sdf(rows[..., :3], h, r)
        torch.testing.assert_close(want, rows[..., 3], rtol=0, atol=2e-6)


def test_css_database_is_the_seeds(tmp_path, css_files):
    from portbench.jobs import css_train

    _, _, _, traffic = css_files
    traffic = dict(traffic, crops=3)
    for name in ("a", "b"):
        css_train.make_database(traffic, 2 ** 40 + 9, "cpu",
                                str(tmp_path / name))
    css_train.make_database(traffic, 2 ** 40 + 10, "cpu",
                            str(tmp_path / "c"))
    files = sorted(os.listdir(tmp_path / "a"))
    assert files == ["00000_rgb.png", "00000_uvw.png", "00001_rgb.png",
                     "00001_uvw.png", "00002_rgb.png", "00002_uvw.png",
                     "crops.json"]
    for f in files:
        assert (tmp_path / "a" / f).read_bytes() == \
            (tmp_path / "b" / f).read_bytes()
    assert (tmp_path / "a" / "00000_rgb.png").read_bytes() != \
        (tmp_path / "c" / "00000_rgb.png").read_bytes()


def test_css_database_reads_back(tmp_path, css_files):
    """The PNGs decode (by Pillow) to car-on-background crops: a mask of
    some of the pixels, NOCS in (0, 255]."""
    import numpy as np
    from PIL import Image

    from portbench.jobs import css_train

    _, _, _, traffic = css_files
    css_train.make_database(dict(traffic, crops=2), 1, "cpu", str(tmp_path))
    uvw = np.asarray(Image.open(tmp_path / "00001_uvw.png"))
    rgb = np.asarray(Image.open(tmp_path / "00001_rgb.png"))
    assert uvw.shape == rgb.shape == (128, 128, 3)
    share = (uvw.sum(-1) > 0).mean()
    assert 0.05 < share < 0.9


def test_pillow_reference_batch_is_deterministic(tmp_path, css_files):
    """The reference's Pillow batch is the same for a seed, and another
    epoch draws other augmentations."""
    import numpy as np

    from portbench.jobs import css_train
    from portbench.reference import crops_ref

    _, _, _, traffic = css_files
    css_train.make_database(dict(traffic, crops=4), 1, "cpu", str(tmp_path))
    gt = crops_ref.load_gt(str(tmp_path))
    a, b, c = (crops_ref.batch(str(tmp_path), gt, [0, 2, 3], 1, e)
               for e in (0, 0, 1))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert (a["rgb"] != c["rgb"]).any()
    assert a["rgb"].shape == (3, 3, 128, 128) and a["rgb"].flags.c_contiguous
