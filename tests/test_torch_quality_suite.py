"""The port's quality-suite builder (tools/quality_suite.py) against
scripts/make_quality_suite.py --profile v2 on its first two frames (the
clean and the occluded condition), both from the committed quality
DeepSDF: the written labels to the 1e-4 their four decimals carry (the
boxes exactly), >= 99.5% of image bytes equal (a footprint bit may flip at
a disc's edge), the same LIDAR point counts and the same suite_meta.json."""

import json
import os
import sys

import numpy as np
import pytest

from sdflabel_tpu_torch.data import kitti as tkitti
from sdflabel_tpu_torch.tools import quality_suite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 2


@pytest.fixture(scope="module")
def suites(tmp_path_factory):
    """(JAX's suite dir, the port's suite dir)."""
    jroot = tmp_path_factory.mktemp("jax_suite")
    os.makedirs(jroot / "data")
    os.symlink(os.path.join(REPO, "data", "quality_nets"),
               jroot / "data" / "quality_nets")
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_quality_suite as mqs
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    cwd, argv = os.getcwd(), sys.argv
    try:
        os.chdir(jroot)
        sys.argv = ["make_quality_suite.py", "--profile", "v2", "--frames",
                    str(N_FRAMES), "--skip-fit", "--skip-css"]
        mqs.main()
    finally:
        os.chdir(cwd)
        sys.argv = argv
    troot = tmp_path_factory.mktemp("torch_suite") / "suite"
    quality_suite.main(["--frames", str(N_FRAMES), "--out", str(troot),
                        "--device", "cpu"])
    return jroot / "data" / "quality_suite_v2", troot


def _labels(root, name):
    with open(os.path.join(root, "training", "label_2",
                           f"{name}.txt")) as f:
        return [line.split() for line in f.read().splitlines()]


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_frames_match_jax(suites, frame):
    jroot, troot = suites
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


def test_split_and_meta_match_jax(suites):
    jroot, troot = suites
    for rel in (("mv3d_kitti_split", "trainval.txt"),):
        with open(os.path.join(jroot, *rel)) as f, \
                open(os.path.join(troot, *rel)) as g:
            assert g.read() == f.read()
    with open(jroot / "suite_meta.json") as f, \
            open(troot / "suite_meta.json") as g:
        jm, tm = json.load(f), json.load(g)
    assert tm == jm
    assert tm["conditions"] == {"000000": "clean", "000001": "occluded"}
