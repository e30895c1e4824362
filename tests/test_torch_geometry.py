"""The port's geometry helpers (ops/geometry.py) against sdflabel_tpu's, on
the same numpy inputs."""

import numpy as np
import pytest
import torch

from sdflabel_tpu.ops import geometry as jgeo
from sdflabel_tpu_torch.ops import geometry as tgeo


@pytest.mark.parametrize("yaw", [0.0, 0.7, -2.9, 3.14159])
def test_rotations_and_angles_match_jax(yaw):
    # fp32 trigonometry on both sides: 1e-6; the numpy forms exactly
    np.testing.assert_allclose(
        tgeo.rot_from_yaw(torch.tensor([yaw])).numpy(),
        np.asarray(jgeo.rot_from_yaw(np.float32(yaw))), atol=1e-6)
    np.testing.assert_array_equal(tgeo.rot_from_yaw_np(yaw),
                                  jgeo.rot_from_yaw_np(yaw))
    pose = np.eye(4)
    pose[:3, :3] = jgeo.rot_from_yaw_np(yaw)
    pose[:3, 3] = [1.5, -0.3, 12.0]
    assert tgeo.roty_in_bev(pose) == jgeo.roty_in_bev(pose)
    assert tgeo.alpha_in_bev(pose, yaw) == jgeo.alpha_in_bev(pose, yaw)


def test_boxes_projection_and_crop_intrinsics_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(50):
        a = np.sort(rng.uniform(0, 100, (2, 2)), 0).T.reshape(-1)[[0, 2, 1, 3]]
        b = np.sort(rng.uniform(0, 100, (2, 2)), 0).T.reshape(-1)[[0, 2, 1, 3]]
        assert tgeo.get_iou(a, b) == jgeo.get_iou(a, b)
        assert tgeo.compute_iou(a, b) == jgeo.compute_iou(a, b)
    K = np.array([[721.5, 0, 609.6], [0, 721.5, 172.9], [0, 0, 1]])
    p3d = rng.uniform(-5, 5, (40, 3)) + [0, 0, 15]
    np.testing.assert_array_equal(tgeo.project_np(K, p3d),
                                  jgeo.project_np(K, p3d))
    for got, want in zip(
            tgeo.adjust_intrinsics_crop(K, (74, 102), (300, 150, 402, 224),
                                        32 ** 2),
            jgeo.adjust_intrinsics_crop(K, (74, 102), (300, 150, 402, 224),
                                        32 ** 2)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("filter_nocs", [False, True])
def test_reproject_matches_jax(filter_nocs):
    rng = np.random.RandomState(1)
    depth = rng.uniform(5, 30, (20, 30)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.4] = 0
    color = rng.uniform(0, 1, (3, 20, 30)).astype(np.float32)
    color[:, rng.uniform(size=(20, 30)) < 0.3] = 0
    K = np.array([[50.0, 0, 15], [0, 50.0, 10], [0, 0, 1]], np.float32)
    got = tgeo.reproject_np(color, depth[None], K, filter_nocs=filter_nocs)
    want = jgeo.reproject_np(color, depth[None], K, filter_nocs=filter_nocs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
