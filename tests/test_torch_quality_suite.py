"""The port's quality-suite builder (tools/quality_suite.py) against
scripts/make_quality_suite.py on the first two frames of each profile
(v2: the clean and the occluded condition; v1: two frames of 1-3 disjoint
cars), both from the committed quality DeepSDF (``--skip-fit
--skip-css``, so that neither writes a net): the written labels to the
1e-4 their four decimals carry (the boxes exactly), >= 99.5% of image
bytes equal (a footprint bit may flip at a disc's edge), the same LIDAR
point counts and the same suite_meta.json."""

import json
import os
import pathlib

import numpy as np
import pytest

from sdflabel_tpu_torch.data import kitti as tkitti
from sdflabel_tpu_torch.tools import quality_suite
from torch_parity_util import few_threads  # noqa: F401 (autouse)
from torch_parity_util import jax_quality_suite, shared_jax_quality_suite

N_FRAMES = 2


def _jax_suite(tmp_path_factory, profile):
    if profile == "v1":  # shared with test_torch_quality_css.py
        root, _ = shared_jax_quality_suite(tmp_path_factory, profile,
                                           N_FRAMES)
    else:
        root, _ = jax_quality_suite(
            tmp_path_factory.mktemp(f"jax_{profile}"), profile, N_FRAMES)
    return pathlib.Path(root)


def _torch_suite(tmp_path_factory, profile):
    troot = tmp_path_factory.mktemp(f"torch_suite_{profile}") / "suite"
    quality_suite.main(["--profile", profile, "--frames", str(N_FRAMES),
                        "--skip-fit", "--skip-css", "--out", str(troot),
                        "--device", "cpu"])
    return troot


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    """(JAX's v2 suite dir, the port's v2 suite dir)."""
    return (_jax_suite(tmp_path_factory, "v2"),
            _torch_suite(tmp_path_factory, "v2"))


@pytest.fixture(scope="module")
def suites_v1(tmp_path_factory):
    """(JAX's v1 suite dir, the port's v1 suite dir)."""
    return (_jax_suite(tmp_path_factory, "v1"),
            _torch_suite(tmp_path_factory, "v1"))


def _labels(root, name):
    with open(os.path.join(root, "training", "label_2",
                           f"{name}.txt")) as f:
        return [line.split() for line in f.read().splitlines()]


def _check_frame(jroot, troot, frame):
    name = f"{frame:06d}"
    jl, tl = _labels(jroot, name), _labels(troot, name)
    assert len(tl) == len(jl) > 0
    for j, t in zip(jl, tl):
        assert t[0] == j[0] == "Car" and t[2] == j[2]  # occlusion
        assert t[4:8] == j[4:8]  # the 2D box, whole pixels
        assert abs(float(t[1]) - float(j[1])) <= 0.01 + 1e-9  # truncation
        np.testing.assert_allclose([float(v) for v in t[3:4] + t[8:]],
                                   [float(v) for v in j[3:4] + j[8:]],
                                   atol=1e-4 + 1e-9)
    ji = tkitti.read_bgr(os.path.join(jroot, "training", "image_2",
                                      f"{name}.png"))
    ti = tkitti.read_bgr(os.path.join(troot, "training", "image_2",
                                      f"{name}.png"))
    assert ti.shape == ji.shape == (256, 832, 3)
    assert (ti == ji).mean() >= 0.995
    jv, tv = (np.fromfile(os.path.join(r, "training", "velodyne",
                                       f"{name}.bin"), np.float32)
              for r in (jroot, troot))
    assert tv.shape == jv.shape
    with open(os.path.join(jroot, "training", "calib", f"{name}.txt")) as f:
        jc = f.read()
    with open(os.path.join(troot, "training", "calib", f"{name}.txt")) as f:
        assert f.read() == jc


def _check_split_and_meta(jroot, troot):
    rel = ("mv3d_kitti_split", "trainval.txt")
    with open(os.path.join(jroot, *rel)) as f, \
            open(os.path.join(troot, *rel)) as g:
        assert g.read() == f.read()
    with open(jroot / "suite_meta.json") as f, \
            open(troot / "suite_meta.json") as g:
        jm, tm = json.load(f), json.load(g)
    assert tm == jm
    return tm


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_frames_match_jax(suites, frame):
    _check_frame(*suites, frame)


def test_split_and_meta_match_jax(suites):
    tm = _check_split_and_meta(*suites)
    assert tm["conditions"] == {"000000": "clean", "000001": "occluded"}


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_v1_frames_match_jax(suites_v1, frame):
    _check_frame(*suites_v1, frame)


def test_v1_split_and_meta_match_jax(suites_v1):
    tm = _check_split_and_meta(*suites_v1)
    assert tm["profile"] == "v1" and tm["css_width"] == 16
    assert tm["conditions"] == {"000000": "clean", "000001": "clean"}
    assert tm["weak_css"] is None
