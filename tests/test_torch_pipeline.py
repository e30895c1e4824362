"""The slice as a whole: the port's refine_css_demo against the JAX
driver on the bundled demo frame, given the same RANSAC ranks, plus the
host-side pieces of the driver (crop transform, config, labels)."""

import configparser
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdflabel_tpu import config as jcfg
from sdflabel_tpu.data import kitti as jkitti
from sdflabel_tpu.engine import labels as jlabels
from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.ops import grid as jgrid
from sdflabel_tpu.pipelines import refine_css as jpipe
from sdflabel_tpu_torch import config as tcfg
from sdflabel_tpu_torch.data import kitti as tkitti
from sdflabel_tpu_torch.engine import labels as tlabels
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.ops import grid as tgrid
from sdflabel_tpu_torch.pipelines import refine_css as tpipe
from torch_parity_util import JaxRankSource

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "data", "optimization")


def _demo_cfg(iters):
    return dict(css_path=os.path.join(ASSETS, "css_demo.msgpack"),
                css_width=8,
                deepsdf_path=os.path.join(ASSETS, "deepsdf_demo.pt"),
                label_type="gt", diff_annos="easy", grid_density=40,
                rendering_area=32, iters=iters, pose_estimator="kabsch",
                precision="float32", warm_band=0, viz_type="none")


def _compare_demo(iters, tol):
    kw = _demo_cfg(iters)
    sample = jpipe.load_demo_sample(ASSETS)
    jannos, jests = jpipe.refine_css_demo(jcfg.RefineCfg(**kw),
                                          sample=sample)
    rt = tpipe.setup_runtime(tcfg.RefineCfg(**kw), device="cpu")
    rt.ransac_ranks = JaxRankSource(rng_seed=1)
    tannos, tests_ = tpipe.refine_css_demo(tcfg.RefineCfg(**kw),
                                           sample=tpipe.load_demo_sample(
                                               ASSETS), device="cpu", rt=rt)
    assert len(tests_["location"]) == len(jests["location"]) == 1
    for k in ("location", "dimensions", "rotation_y", "alpha", "bbox"):
        np.testing.assert_allclose(np.asarray(tests_[k], np.float64),
                                   np.asarray(jests[k], np.float64),
                                   atol=tol, err_msg=k)
        np.testing.assert_array_equal(np.asarray(tannos[k]),
                                      np.asarray(jannos[k]))
    assert list(tests_["score"]) == list(jests["score"])


def test_demo_labels_match_jax_driver():
    # the same crop, CSS, surface, RANSAC draw and 3 refine steps in fp32:
    # the KITTI fields agree to 1e-4 (m, rad)
    _compare_demo(iters=3, tol=1e-4)


@pytest.mark.slow
def test_demo_labels_match_jax_driver_60_iterations():
    # 60 coupled steps let fp32 differences grow: 1e-3 (m, rad)
    _compare_demo(iters=60, tol=1e-3)


@pytest.mark.parametrize("hw", [(74, 102), (150, 140), (20, 33), (128, 128),
                                (3, 300), (401, 9)])
def test_crop_transform_matches_pil(hw):
    rng = np.random.RandomState(hw[0])
    crop = rng.uniform(-0.1, 1.1, (*hw, 3)).astype(np.float32)
    jn, ja = jpipe.transform_bgr_crop(crop)
    tn, ta = tpipe.transform_bgr_crop(crop)
    # Pillow's integer tables rebuilt: bit-equal to PIL
    np.testing.assert_array_equal(ta.numpy(), ja)
    np.testing.assert_array_equal(tn.numpy(), jn)
    ref = np.asarray(Image.fromarray(
        (np.clip(crop[..., ::-1], 0, 1) * 255).astype(np.uint8)).resize(
            (128, 128), Image.BILINEAR), np.float32) / 255
    np.testing.assert_array_equal(ta.numpy().transpose(1, 2, 0), ref)


def test_config_reads_every_ini_as_jax_does():
    for name in ("config_demo.ini", "config_refine.ini",
                 "config_refine_fast.ini", "config_refine_parity.ini"):
        cfgp = configparser.ConfigParser()
        cfgp.read(os.path.join(REPO, "configs", name))
        j = jcfg.RefineCfg.from_ini(cfgp)
        t = tcfg.RefineCfg.from_ini(cfgp)
        assert vars(t) == vars(j), name
        jd = jcfg.read_cfg_precision(cfgp, "optimization", "precision", None)
        td = tcfg.read_cfg_precision(cfgp, "optimization", "precision", None)
        assert str(td) == "torch." + jnp.dtype(jd).name, name
    assert tcfg.precision_dtype("float16") == torch.bfloat16
    assert tcfg.precision_dtype("float32") == torch.float32


def test_annotation_filters_match_jax():
    sample = jpipe.load_demo_sample(ASSETS)
    for diff in ("easy", "medium", "hard"):
        assert tkitti.get_annos(diff, sample) == jkitti.get_annos(diff,
                                                                  sample)
    rng = np.random.RandomState(0)
    for _ in range(50):
        anno = {"bbox": [0, 0, 10, rng.uniform(10, 60)],
                "occluded": rng.randint(0, 4),
                "truncated": rng.uniform(0, 0.6)}
        for f in ("is_anno_easy", "is_anno_moderate", "is_anno_hard"):
            assert getattr(tkitti, f)(anno) == getattr(jkitti, f)(anno)


def test_surface_extents_and_label_match_jax():
    jc, jp = jds.load_torch_checkpoint(os.path.join(ASSETS,
                                                    "deepsdf_demo.pt"))
    tc, tp = tds.load_torch_checkpoint(os.path.join(ASSETS,
                                                    "deepsdf_demo.pt"),
                                       device="cpu")
    latent = np.array([0.9, -0.1, 0.3], np.float32)
    je = jlabels.surface_extents(jds.sdf_fn(jc, jp),
                                 jgrid.generate_point_grid(24),
                                 jnp.asarray(latent), capacity=2048)
    te = tlabels.surface_extents(tds.sdf_fn(tc, tp),
                                 tgrid.generate_point_grid(24),
                                 torch.as_tensor(latent), capacity=2048)
    assert bool(te.valid) and bool(je.valid)
    np.testing.assert_allclose(te.mn.numpy(), np.asarray(je.mn), atol=1e-5)
    np.testing.assert_allclose(te.mx.numpy(), np.asarray(je.mx), atol=1e-5)
    sample = jpipe.load_demo_sample(ASSETS)
    args = (0.4, 2.1, [0.1, 0.8, 4.5], np.asarray(je.mn), np.asarray(je.mx),
            sample["world_to_cam"], [10, 20, 50, 60])
    jl = jlabels.kitti_label_from_extents(*args)
    tl = tlabels.kitti_label_from_extents(*args)
    assert tl.keys() == jl.keys() and tl["name"] == jl["name"] == "Car"
    for k in ("bbox", "location", "dimensions", "rotation_y", "alpha",
              "score"):
        np.testing.assert_allclose(np.asarray(tl[k]), np.asarray(jl[k]),
                                   atol=1e-12, err_msg=k)


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.setup_runtime(tcfg.RefineCfg(**_demo_cfg(1)))
    # the stock demo config (viz_type 3d, ported) asks for the card too
    kw = dict(_demo_cfg(1), viz_type="3d")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.refine_css_demo(tcfg.RefineCfg(**kw))
