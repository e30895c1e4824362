"""The port's KITTI loader against sdflabel_tpu.data.kitti on the
synthetic KITTI tree of tests/test_kitti.py (written with cv2), and its
cv2-free pieces (PNG in BGR order, the projection-matrix decomposition)
against cv2 itself."""

import os
import threading
import time

import cv2
import numpy as np
import pytest

from sdflabel_tpu.data import kitti as jkitti
from sdflabel_tpu_torch.data import kitti as tkitti
from test_kitti import make_kitti_tree


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return make_kitti_tree(tmp_path_factory.mktemp("kitti_torch"))


@pytest.mark.parametrize("index", [0, 1])
def test_samples_match_jax(kitti_root, index):
    want = jkitti.KITTI3D(kitti_root)[index]
    got = tkitti.KITTI3D(kitti_root)[index]
    assert list(got.keys()) == list(want.keys())
    # the image decodes to cv2's BGR bytes exactly; lidar, depth and the
    # labels are the same host arithmetic
    for key in ("image", "lidar", "depth", "orig_hw"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    # calib through numpy's RQ in place of cv2's: last-ulp differences
    for key in ("orig_cam", "world_to_cam"):
        np.testing.assert_allclose(got[key], want[key], atol=1e-9,
                                   err_msg=key)
    for a, b in zip(got["pcd"], want["pcd"]):
        np.testing.assert_array_equal(a, b)
    assert got["gt"] == want["gt"]
    assert got["annos"] == want["annos"]
    for diff in ("easy", "medium", "hard"):
        assert tkitti.get_annos(diff, got) == jkitti.get_annos(diff, want)


def test_normals_match_jax():
    rng = np.random.RandomState(0)
    pts = np.concatenate([
        np.stack([rng.uniform(-5, 5, 800), 1.6 + rng.randn(800) * 0.01,
                  rng.uniform(5, 15, 800)], 1),
        rng.uniform(-3, 3, (400, 3)) + [0, 0, 10]])
    np.testing.assert_allclose(tkitti.estimate_normals(pts),
                               jkitti.estimate_normals(pts), atol=1e-5)


def test_png_reads_and_writes_as_cv2(tmp_path):
    rng = np.random.RandomState(1)
    img = (rng.rand(37, 53, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), img)  # adaptive row filters
    np.testing.assert_array_equal(tkitti.read_bgr(str(tmp_path / "a.png")),
                                  img)
    tkitti.write_bgr(str(tmp_path / "b.png"), img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "b.png"), -1),
                                  img)


def test_projection_decomposition_matches_cv2():
    rng = np.random.RandomState(2)
    mats = [np.array([[721.5377, 0, 609.5593, 44.85728],
                      [0, 721.5377, 172.854, 0.2163791],
                      [0, 0, 1, 0.002745884]])]
    mats += [rng.randn(3, 4) for _ in range(40)]
    for p in mats:
        k, r, t = cv2.decomposeProjectionMatrix(p)[:3]
        k2, r2, t2 = tkitti.decompose_projection(p)
        np.testing.assert_allclose(k2, k, atol=1e-10 * np.abs(k).max())
        np.testing.assert_allclose(r2, r, atol=1e-10)
        np.testing.assert_allclose(t2[:3, 0] / t2[3, 0], t[:3, 0] / t[3, 0],
                                   rtol=1e-9, atol=1e-12)


def test_prefetch_frames_order_skip_and_overlap():
    loads, threads = [], set()

    class FakeDataset:
        def __getitem__(self, i):
            threads.add(threading.get_ident())
            loads.append(i)
            time.sleep(0.01)
            return {"idx": i}

    skipped = {2, 3}
    out = list(tkitti.prefetch_frames(FakeDataset(), range(6),
                                      skip_fn=lambda i: i in skipped))
    assert [i for i, _ in out] == list(range(6))
    for i, s in out:
        assert s is None if i in skipped else s == {"idx": i}
    assert sorted(loads) == [0, 1, 4, 5]  # skipped frames never load
    assert threading.get_ident() not in threads  # loaded off the caller
    jout = list(jkitti.prefetch_frames(FakeDataset(), range(6),
                                       skip_fn=lambda i: i in skipped))
    assert [i for i, _ in jout] == [i for i, _ in out]


def test_split_and_label_parsing_match_jax(kitti_root):
    jd, td = jkitti.KITTI3D(kitti_root), tkitti.KITTI3D(kitti_root)
    assert td.names == jd.names and len(td) == len(jd) == 2
    label = os.path.join(kitti_root, "training", "label_2", "000000.txt")
    assert tkitti.KITTI3D._parse_labels(label) == \
        jkitti.KITTI3D._parse_labels(label)
