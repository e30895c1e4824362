"""The demo-asset tool's scene (tools/demo_assets.py: render_gt,
build_sample, gt_label, maskrcnn_labels) on the CPU against the committed
data/optimization/kitti_sample.npz and maskrcnn.npz, which
scripts/make_demo_assets.py builds from the committed deepsdf_demo.pt: the
JAX script rebuilds them bit for bit, so they are JAX's output.

- The crop box, the visible point count and the LIDAR draws are equal.
- The image and the NOCS texture under the mask: >= 99.5% of pixels
  within 2e-4 (the splat bound), the mask >= 99.5% equal.
- The LIDAR: the ground and the clutter within 1e-5 m; the car's points,
  which follow the surface's top-k order, within 1e-5 m on >= 99.5% of
  them, and the rest a swapped pair each. Two grid points whose |sdf|
  agree to 1e-8 (fp32 sums in other orders through the decoder) may take
  each other's rank in the selection (4 such adjacent pairs in the 4096
  selected points; one pair among the visible points, which lands on two
  of the car's LIDAR points).
- The depth within 1e-5 where both are non-zero (the swapped points move
  a few pixels' depth).
- The label's location, dimensions and yaw within 1e-5, the MaskRCNN box
  bit-equal and its mask >= 99.5% equal."""

import json
import os

import numpy as np
import pytest

from sdflabel_tpu_torch.models import deepsdf as tdsdf
from sdflabel_tpu_torch.tools import demo_assets as da
from sdflabel_tpu_torch.tools import quality_suite as qs
from torch_parity_util import few_threads  # noqa: F401 (autouse)
from torch_parity_util import DEMO, committed_demo_scene

N_VIS = 1353  # the committed scene's visible surface points


@pytest.fixture(scope="module")
def scene():
    cfg, params = tdsdf.load_torch_checkpoint(
        os.path.join(DEMO, "deepsdf_demo.pt"), device="cpu")
    rend = qs.Renderer(tdsdf.sdf_fn(cfg, params), "cpu", da.CAPACITY)
    crop_box, nocs, mask, vis_cam = da.render_gt(rend)
    sample = da.build_sample(crop_box, nocs, mask, vis_cam)
    anno = da.gt_label(rend, crop_box, sample)
    ref = np.load(os.path.join(DEMO, "kitti_sample.npz"))
    return dict(crop_box=crop_box, nocs=nocs, mask=mask, vis_cam=vis_cam,
                sample=sample, anno=anno, ref=ref,
                ref_anno=json.loads(str(ref["annos_json"]))["gt"][0],
                committed=committed_demo_scene())


def test_crop_box_and_visible_points(scene):
    assert tuple(scene["crop_box"]) == tuple(scene["ref_anno"]["bbox"])
    assert len(scene["vis_cam"]) == N_VIS
    l, t_, r, b = scene["crop_box"]
    assert scene["nocs"].shape == (3, b - t_, r - l)
    assert scene["mask"].shape == (b - t_, r - l)
    assert scene["sample"]["lidar"].shape == scene["ref"]["lidar"].shape
    for k in ("orig_cam", "world_to_cam"):
        assert np.array_equal(scene["sample"][k], scene["ref"][k])


def test_image_texture_and_mask(scene):
    img, ref = scene["sample"]["image"], scene["ref"]["image"]
    assert img.dtype == ref.dtype and img.shape == ref.shape
    close = (np.abs(img - ref) <= 2e-4).all(-1)
    assert close.mean() >= 0.995, close.mean()
    _, _, nocs_ref, mask_ref = scene["committed"]
    assert (scene["mask"] == mask_ref).mean() >= 0.995
    both = scene["mask"] & mask_ref
    assert both.sum() > 0.9 * mask_ref.sum() > 1000
    tex = (np.abs(scene["nocs"] - nocs_ref) <= 2e-4).all(0)[both]
    assert tex.mean() >= 0.995, tex.mean()


def test_lidar_and_depth(scene):
    got, want = scene["sample"]["lidar"], scene["ref"]["lidar"]
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got[N_VIS:], want[N_VIS:], rtol=0, atol=1e-5)
    d = np.abs(got[:N_VIS] - want[:N_VIS]).max(1)
    off = np.nonzero(d > 1e-5)[0]
    assert len(off) <= 0.005 * N_VIS, off
    # the car's points with their draws' noise taken out are JAX's set:
    # each point off in place is another visible point's
    rng = np.random.RandomState(da.SEED)
    rng.uniform(size=(da.IMG_H, da.IMG_W, 3))
    keep = rng.permutation(N_VIS)
    noise = rng.randn(N_VIS, 3) * 0.008
    vis_ref = (want[:N_VIS] - noise)[np.argsort(keep)]
    vis = scene["vis_cam"]
    in_place = np.abs(vis - vis_ref).max(1) <= 1e-5
    assert in_place.mean() >= 0.995
    for p in vis[~in_place]:
        assert np.abs(vis_ref - p).max(1).min() <= 1e-5
    dg, dw = scene["sample"]["depth"], scene["ref"]["depth"]
    both = (dg > 0) & (dw > 0)
    assert both.sum() > 1000 and ((dg > 0) != (dw > 0)).mean() <= 1e-3
    np.testing.assert_allclose(dg[both], dw[both], rtol=0, atol=1e-5)


def test_label_matches_committed(scene):
    got, want = scene["anno"], scene["ref_anno"]
    assert set(got) == set(want)
    assert got["bbox"] == want["bbox"]
    for k in ("location", "dimensions"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)
    for k in ("rotation_y", "alpha"):
        assert abs(got[k] - want[k]) <= 1e-5
    for k in ("name", "score", "truncated", "occluded", "ignore"):
        assert got[k] == want[k]


def test_maskrcnn_labels_match_committed(scene):
    got = da.maskrcnn_labels(scene["anno"], scene["mask"])
    want = np.load(os.path.join(DEMO, "maskrcnn.npz"))
    assert sorted(got) == sorted(want.files)
    assert got["bboxes"].dtype == want["bboxes"].dtype
    assert np.array_equal(got["bboxes"], want["bboxes"])
    assert got["mask_0"].dtype == want["mask_0"].dtype
    assert got["mask_0"].shape == want["mask_0"].shape
    assert (got["mask_0"] == want["mask_0"]).mean() >= 0.995
