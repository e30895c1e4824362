"""The KITTI driver as a whole: the port's refine_css against sdflabel_tpu's
on two frames of the v2 quality suite written by the JAX package's own
builder (scripts/make_quality_suite.py), with the committed quality nets,
3 iterations, fp32 and the same RANSAC ranks, both one crop after
another and batched (JAX's default: all of a frame's crops in one refine
with a crop axis); each package's evaluation of the other's dumps; the
MaskRCNN demo branch; and the main CLI's --evaluate."""

import configparser
import os
import pickle
import sys

import numpy as np
import pytest

from sdflabel_tpu import config as jcfg
from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.pipelines import evaluate_dump as jeval
from sdflabel_tpu.pipelines import refine_css as jpipe
from sdflabel_tpu_torch import config as tcfg
from sdflabel_tpu_torch import main as tmain
from sdflabel_tpu_torch.pipelines import evaluate_dump as teval
from sdflabel_tpu_torch.pipelines import refine_css as tpipe
from torch_parity_util import JaxRankSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = os.path.join(REPO, "data", "quality_nets")
ASSETS = os.path.join(REPO, "data", "optimization")
LABEL_KEYS = ("location", "dimensions", "rotation_y", "alpha", "bbox")


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """Two frames (a distant and a truncated scene) written by JAX's
    build_frame_v2 / write_kitti_frame."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_quality_suite as mqs
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    root = tmp_path_factory.mktemp("suite")
    for sub in ("image_2", "label_2", "calib", "velodyne"):
        os.makedirs(root / "training" / sub)
    os.makedirs(root / "mv3d_kitti_split")
    dcfg, dparams = jds.load_torch_checkpoint(
        os.path.join(NETS, "deepsdf_quality.pt"))
    decoder = jds.sdf_fn(dcfg, dparams)
    render_fns = mqs.make_render_fns(decoder)
    rng = np.random.RandomState(mqs.SEED + 2)
    names = []
    for condition in ("distant", "truncated"):
        out = None
        while out is None:
            out = mqs.build_frame_v2(decoder, render_fns, rng, condition)
        name = f"{len(names):06d}"
        mqs.write_kitti_frame(str(root), name, out[0], out[1], out[2])
        names.append(name)
    (root / "mv3d_kitti_split" / "trainval.txt").write_text(
        "\n".join(names) + "\n")
    return str(root)


def _cfgp(suite, labels, iters=3):
    cfgp = configparser.ConfigParser()
    cfgp.read_dict({
        "input": {"kitti_path": suite,
                  "css_path": os.path.join(NETS, "css_quality_v2.msgpack"),
                  "css_width": "24",
                  "deepsdf_path": os.path.join(NETS, "deepsdf_quality.pt"),
                  "label_type": "gt", "diff_annos": "hard",
                  "grid_density": "40", "rendering_area": "32"},
        "optimization": {"iters": str(iters), "pose_estimator": "kabsch",
                         "precision": "float32", "warm_band": "0"},
        "visualization": {"viz_type": "none"},
        "output": {"labels": labels}})
    return cfgp


def _both_drivers(suite, tmp_path_factory, batched):
    """Both drivers over the suite: {package: (cfgp, annos, estimations)}."""
    out = {}
    tag = "batched" if batched else "sequential"
    jdir = str(tmp_path_factory.mktemp(f"labels_jax_{tag}"))
    cfgp = _cfgp(suite, jdir)
    out["jax"] = (cfgp, *jpipe.refine_css(cfgp, batched=batched))
    tdir = str(tmp_path_factory.mktemp(f"labels_torch_{tag}"))
    cfgp = _cfgp(suite, tdir)
    real_setup = tpipe.setup_runtime

    def setup_with_jax_ranks(*a, **kw):
        rt = real_setup(*a, **kw)
        rt.ransac_ranks = JaxRankSource(rng_seed=1)
        return rt

    mp = pytest.MonkeyPatch()
    mp.setattr(tpipe, "setup_runtime", setup_with_jax_ranks)
    try:
        out["torch"] = (cfgp, *tpipe.refine_css(cfgp, batched=batched,
                                                device="cpu"))
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def runs(suite, tmp_path_factory):
    """Both drivers, one crop after another."""
    return _both_drivers(suite, tmp_path_factory, batched=False)


@pytest.fixture(scope="module")
def batched_runs(suite, tmp_path_factory):
    """Both drivers with their default, the batched crops."""
    return _both_drivers(suite, tmp_path_factory, batched=True)


def _assert_labels_match(runs):
    _, jannos, jests = runs["jax"]
    _, tannos, tests_ = runs["torch"]
    assert list(tannos) == list(jannos) == [0, 1]
    n = 0
    for frame in jannos:
        for k in ("location", "dimensions", "rotation_y", "bbox"):
            np.testing.assert_array_equal(np.asarray(tannos[frame][k]),
                                          np.asarray(jannos[frame][k]))
        assert len(tests_[frame]["location"]) == \
            len(jests[frame]["location"])
        n += len(jests[frame]["location"])
        # slice 1's tolerance after 3 coupled fp32 steps: 1e-4 (m, rad);
        # the location 1e-3 m, slice 1's tolerance after 60 steps: the
        # distant car (24 m) starts from inits equal to 1e-6 and ends
        # 4.9e-4 m apart, its scale 2e-5 relative
        for k in LABEL_KEYS:
            np.testing.assert_allclose(
                np.asarray(tests_[frame][k], np.float64),
                np.asarray(jests[frame][k], np.float64),
                atol=1e-3 if k == "location" else 1e-4,
                err_msg=f"frame {frame} {k}")
    assert n >= 2  # labels were made


def test_driver_labels_match_jax(runs):
    _assert_labels_match(runs)


def test_batched_driver_labels_match_jax(batched_runs):
    _assert_labels_match(batched_runs)


def test_batched_driver_labels_match_sequential(runs, batched_runs):
    # the same crops, letterboxed into one bucket per frame in place of
    # each crop's own: the labels within the tolerances above
    seq, bat = runs["torch"][2], batched_runs["torch"][2]
    assert list(seq) == list(bat)
    for frame in seq:
        for k in LABEL_KEYS:
            np.testing.assert_allclose(
                np.asarray(bat[frame][k], np.float64),
                np.asarray(seq[frame][k], np.float64),
                atol=1e-3 if k == "location" else 1e-4,
                err_msg=f"frame {frame} {k}")


def test_dumps_and_idempotent_rerun(runs):
    cfgp, tannos, tests_ = runs["torch"]
    labels = cfgp.get("output", "labels")
    assert sorted(f for f in os.listdir(labels) if f.endswith(".pkl")) \
        == ["0.pkl", "1.pkl"]
    with open(os.path.join(labels, "1.pkl"), "rb") as f:
        gt, est = pickle.load(f)
    for k in ("location", "dimensions", "rotation_y", "bbox", "alpha"):
        np.testing.assert_array_equal(np.asarray(est[k]),
                                      np.asarray(tests_[1][k]))
    # a frame whose dump exists is skipped: nothing runs, nothing is
    # evaluated, and no runtime needs a card
    annos, ests = tpipe.refine_css(cfgp, device="cpu")
    assert not annos and not ests


def test_each_evaluation_reads_the_other_packages_dumps(runs):
    for pkg in ("jax", "torch"):
        cfgp = runs[pkg][0]
        want = jeval.evaluate(cfgp, difficulties=(0, 1, 2))
        got = teval.evaluate(cfgp, difficulties=(0, 1, 2), device="cpu")
        for w, g in zip(want, got):
            for key in ("Box2DAP", "BevAP", "Box3DAP", "Box3DAP_Nu",
                        "AosAP_iou", "AoeAP_dist"):
                if key in w:
                    np.testing.assert_allclose(np.asarray(g[key]),
                                               np.asarray(w[key]),
                                               atol=1e-6, err_msg=key)
        assert os.path.exists(os.path.join(cfgp.get("output", "labels"),
                                           "eval_results.npz"))


def test_main_evaluate_runs(runs, tmp_path, monkeypatch):
    labels = runs["torch"][0].get("output", "labels")
    ini = tmp_path / "eval.ini"
    ini.write_text(f"[output]\nlabels = {labels}\n[log]\n"
                   f"dir = {tmp_path / 'log'}\n")
    results = os.path.join(labels, "eval_results.npz")
    if os.path.exists(results):
        os.remove(results)
    tmain.main([str(ini), "--evaluate", "--device", "cpu"])
    res = np.load(results)
    assert "kitti/Box3DAP" in res and "nuscenes/Box3DAP_Nu" in res
    assert os.path.exists(tmp_path / "log" / "log.ini")


def test_maskrcnn_demo_matches_jax(monkeypatch):
    monkeypatch.chdir(REPO)  # the demo loads data/optimization/*.npz
    kw = dict(css_path=os.path.join(ASSETS, "css_demo.msgpack"),
              css_width=8, deepsdf_path=os.path.join(ASSETS,
                                                     "deepsdf_demo.pt"),
              label_type="maskrcnn", diff_annos="easy", grid_density=40,
              rendering_area=32, iters=3, pose_estimator="kabsch",
              precision="float32", warm_band=0, viz_type="none")
    jannos, jests = jpipe.refine_css_demo(jcfg.RefineCfg(**kw))
    rt = tpipe.setup_runtime(tcfg.RefineCfg(**kw), device="cpu")
    rt.ransac_ranks = JaxRankSource(rng_seed=1)
    tannos, tests_ = tpipe.refine_css_demo(tcfg.RefineCfg(**kw),
                                           device="cpu", rt=rt)
    assert len(tests_["location"]) == len(jests["location"]) == 1
    for k in LABEL_KEYS:
        np.testing.assert_allclose(np.asarray(tests_[k], np.float64),
                                   np.asarray(jests[k], np.float64),
                                   atol=1e-4, err_msg=k)
    # the MaskRCNN box, not the annotation's, is the label's 2D box
    mrcnn = tpipe.load_demo_maskrcnn(ASSETS)
    assert any(np.array_equal(tests_["bbox"][0], np.asarray(b).astype(int))
               for b in mrcnn["bboxes"])
