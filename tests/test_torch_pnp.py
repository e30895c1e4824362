"""The port's PnP pose init (ops/pnp.py, torch, no OpenCV) against
sdflabel_tpu's cv2.solvePnPRansac path: tests/test_pnp.py's synthetic NOCS
images (pixel positions rounded, so each RANSAC keeps its own inliers: the
rotation within 1e-3, the translation within 5e-3 m of cv2's), exact
sub-pixel correspondences (within 1e-6 of cv2's and 1e-9 of the truth),
identity with fewer than 4 points, the same pose from the same generator
seed; and the demo driven with pose_estimator = pnp against the JAX demo
(on the CSS net's noisy NOCS, to RANSAC's spread: see that test)."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from sdflabel_tpu import config as jcfg
from sdflabel_tpu.ops import pnp as jpnp
from sdflabel_tpu.pipelines import refine_css as jpipe
from sdflabel_tpu_torch import config as tcfg
from sdflabel_tpu_torch.ops import pnp as tpnp
from sdflabel_tpu_torch.pipelines import refine_css as tpipe
from test_pnp import _synthetic_nocs
from test_torch_pipeline import ASSETS, _demo_cfg

cv2 = pytest.importorskip("cv2")


@pytest.mark.parametrize("yaw,trans", [(0.4, (0.1, -0.2, 6.0)),
                                       (-0.3, (0.1, -0.2, 6.0)),
                                       (1.2, (-0.4, 0.3, 7.5))])
def test_nocs_pose_matches_cv2(yaw, trans):
    K, nocs, rot_gt, tra_gt = _synthetic_nocs(yaw=yaw, trans=trans)
    want = jpnp.init_pose_2d(K, nocs, scale_model=2.0)
    got = tpnp.init_pose_2d(K, nocs, scale_model=2.0)
    assert got["scale"] == want["scale"] == 2.0
    assert np.abs(got["rot"] - want["rot"]).max() < 1e-3
    assert np.abs(got["tra"] - want["tra"]).max() < 5e-3
    assert np.abs(got["quat"] - want["quat"]).max() < 1e-3
    np.testing.assert_allclose(got["rot"] @ got["rot"].T, np.eye(3),
                               atol=1e-12)
    # as close to the truth as cv2 comes (test_pnp.py's bounds)
    assert np.linalg.norm(got["rot"] - rot_gt) < 0.15
    assert np.linalg.norm(got["tra"] - tra_gt) < 0.3


def test_exact_correspondences():
    rng = np.random.RandomState(1)
    K = np.array([[300.0, 0, 80], [0, 300.0, 60], [0, 0, 1]])
    R = Rotation.from_rotvec([0.2, -0.5, 0.1]).as_matrix()
    t = np.array([0.3, -0.1, 7.0])
    obj = rng.uniform(-1, 1, (300, 3))
    uv = (obj @ R.T + t) @ K.T
    rowcol = (uv[:, :2] / uv[:, 2:])[:, [1, 0]]
    got, inliers = tpnp.solve_pnp(K, rowcol, obj, return_inliers=True)
    want = jpnp.solve_pnp(K, rowcol, obj)
    assert inliers == 300
    np.testing.assert_allclose(got[:3, :3], R, atol=1e-9)
    np.testing.assert_allclose(got[:3, 3], t, atol=1e-9)
    np.testing.assert_allclose(got, want, atol=1e-6)
    # as many points as a minimal set: one solve of all of them
    five = tpnp.solve_pnp(K, rowcol[:5], obj[:5])
    np.testing.assert_allclose(five[:3, 3], t, atol=1e-6)


def test_fewer_than_four_points_is_identity():
    K = np.eye(3) * 100
    K[2, 2] = 1
    nocs = np.zeros((3, 10, 10), np.float32)
    nocs[:, 5, 5] = 0.5
    nocs[:, 2, 7] = 0.7
    got, want = tpnp.init_pose_2d(K, nocs), jpnp.init_pose_2d(K, nocs)
    for k in ("rot", "quat", "tra"):
        assert np.array_equal(got[k], want[k]), k
    assert np.array_equal(got["rot"], np.eye(3))


def test_same_seed_same_pose():
    K, nocs, _, _ = _synthetic_nocs(yaw=0.7)
    a, b = (tpnp.init_pose_2d(K, nocs, 2.0,
                              generator=torch.Generator().manual_seed(5))
            for _ in range(2))
    for k in ("rot", "tra", "quat"):
        assert np.array_equal(a[k], b[k]), k


def _reprojection(K, nocs, pose, scale=2.0):
    """(1-px inliers, median reprojection error) of a pose on the
    correspondences init_pose_2d takes from a NOCS image."""
    mask = nocs[0] > 0
    obj = (np.transpose(nocs, (1, 2, 0))[mask] * 2 - 1) * scale
    rows, cols = np.nonzero(mask)
    cam = obj @ pose["rot"].T + pose["tra"]
    uv = cam @ np.asarray(K).T
    err = np.linalg.norm(uv[:, :2] / uv[:, 2:] - np.stack([cols, rows], 1),
                         axis=1)
    return int((err <= 1.0).sum()), float(np.median(err))


def test_demo_with_pnp_matches_jax(monkeypatch):
    # the demo crop's CSS NOCS: ~5000 noisy correspondences, ~40% within
    # 1 px of the best pose. The two RANSACs draw other minimal sets and
    # keep other inliers, so their poses differ by RANSAC's own spread
    # (the port's seeds 0-2 land 0.03-0.10 m from cv2's pose). Held: the
    # port's pose reprojects as many points within 1 px as cv2's (within
    # 3%) with as small a median error (within 5%), its translation within
    # 0.15 m and rotation within 0.03; the labels of 3 refine steps in fp32
    # from each within 0.2 m and 0.05 rad
    seen = {}
    port_init = tpnp.init_pose_2d

    def spy(cam, nocs, *args, **kw):
        seen.update(K=np.asarray(cam), nocs=np.asarray(nocs))
        return port_init(cam, nocs, *args, **kw)

    monkeypatch.setattr(tpnp, "init_pose_2d", spy)
    kw = dict(_demo_cfg(3), pose_estimator="pnp")
    sample = jpipe.load_demo_sample(ASSETS)
    _, jests = jpipe.refine_css_demo(jcfg.RefineCfg(**kw), sample=sample)
    _, tests_ = tpipe.refine_css_demo(tcfg.RefineCfg(**kw),
                                      sample=tpipe.load_demo_sample(ASSETS),
                                      device="cpu")
    got = port_init(seen["K"], seen["nocs"], 2.0,
                    generator=torch.Generator().manual_seed(1))
    want = jpnp.init_pose_2d(seen["K"], seen["nocs"], 2.0)
    (gn, ge), (wn, we) = (_reprojection(seen["K"], seen["nocs"], p)
                          for p in (got, want))
    assert gn >= 0.97 * wn and ge <= 1.05 * we, (gn, wn, ge, we)
    assert np.abs(got["tra"] - want["tra"]).max() < 0.15
    assert np.abs(got["rot"] - want["rot"]).max() < 0.03
    assert len(tests_["location"]) == len(jests["location"]) == 1
    np.testing.assert_allclose(np.asarray(tests_["location"], np.float64),
                               np.asarray(jests["location"], np.float64),
                               atol=0.2)
    for k in ("rotation_y", "alpha"):
        np.testing.assert_allclose(np.asarray(tests_[k], np.float64),
                                   np.asarray(jests[k], np.float64),
                                   atol=0.05, err_msg=k)
