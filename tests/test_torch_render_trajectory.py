"""The stock viz_type = 3d path: pipelines/refine_css.py::render_trajectory,
its callers and the demo's final views, against sdflabel_tpu's on the demo
crop after 3 fp32 iterations: JAX's refine_css_demo against the port's
refine, trajectory and demo views of JAX's prepared crop, and both
packages' refine_crops_batched of two crops. The same files; every PNG's
decoded pixels >= 99.5% equal to JAX's and within 2 levels in 255 (the
splat's fp32 sums round at the 8-bit step here and there); the HTML
scenes' point sets within 2e-3 (labels and rendered points within 1e-4,
written rounded to 1e-3; as sets, since two decodes may rank equal |sdf|
in another order); the correspondence indices equal to the dense
float64 argmin wherever the two nearest distances do not tie; and
[visualization] live publication."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdflabel_tpu import config as jcfg
from sdflabel_tpu.pipelines import refine_css as jpipe
from sdflabel_tpu_torch import config as tcfg
from sdflabel_tpu_torch.engine import refine as tref
from sdflabel_tpu_torch.pipelines import refine_css as tpipe
from sdflabel_tpu_torch.utils import png
from test_torch_pipeline import ASSETS, _demo_cfg
from test_torch_viz import assert_scenes_close, scene_json

ITERS = 3


def _kw(out):
    return dict(_demo_cfg(ITERS), viz_type="3d", labels_out=str(out))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_pngs_close(tpath, jpath, css_cols=0):
    """>= 99.5% of the pixels equal, none more than 2 levels apart. The
    last `css_cols` columns (a patches image's CSS half) hold the CSS
    net's NOCS, whose own parity with JAX (8e-6) flips a level here and
    there: within 1 level."""
    got = png.read(tpath).astype(int)
    want = np.asarray(Image.open(jpath).convert("RGB")).astype(int)
    assert got.shape == want.shape, tpath
    diff = np.abs(got - want)
    w = got.shape[1] - css_cols
    equal = (diff[:, :w].max(-1) == 0).mean()
    assert equal >= 0.995 and diff[:, :w].max() <= 2, (tpath, equal)
    assert diff[:, w:].max(initial=0) <= 1, tpath


def _assert_dirs_match(tdir, jdir, css_cols=0):
    names = _files(jdir)
    assert names == _files(tdir)
    assert any(n.endswith("_corr.png") for n in names)
    for name in names:
        if name.endswith(".png"):
            _assert_pngs_close(os.path.join(tdir, name),
                               os.path.join(jdir, name),
                               css_cols if name.endswith("_patches.png")
                               else 0)
        else:
            assert name.endswith(".html")
            assert_scenes_close(scene_json(os.path.join(tdir, name)),
                                scene_json(os.path.join(jdir, name)),
                                atol=2e-3, as_sets=True)


def _port_prep(jprep):
    """JAX's prepared crop as the port takes it."""
    return dict(jprep, params0=tref.RefineParams(*(
        torch.as_tensor(np.asarray(x)) for x in jprep["params0"])))


@pytest.fixture(scope="module")
def jax_demo(tmp_path_factory):
    """JAX's demo with viz_type 3d, the crop it prepared and its
    runtime."""
    out = tmp_path_factory.mktemp("jax_demo")
    cfg = jcfg.RefineCfg(**_kw(out))
    sample = jpipe.load_demo_sample(ASSETS)
    preps, prepare = [], jpipe.prepare_crop

    def keep(*args, **kw):
        preps.append(prepare(*args, **kw))
        return preps[-1]

    jpipe.prepare_crop = keep
    try:
        annos, ests = jpipe.refine_css_demo(cfg, sample=sample)
    finally:
        jpipe.prepare_crop = prepare
    assert len(preps) == 1
    return dict(out=str(out), sample=sample, annos=annos, ests=ests,
                jrt=jpipe.setup_runtime(cfg), jprep=preps[0])


@pytest.fixture(scope="module")
def port_rt(tmp_path_factory):
    return tpipe.setup_runtime(
        tcfg.RefineCfg(**_kw(tmp_path_factory.mktemp("port"))),
        device="cpu")


def test_demo_views_match_jax(jax_demo, port_rt, tmp_path):
    # JAX's demo against the port's refine of the same prepared crop, its
    # trajectory and the demo's final views
    sample = jax_demo["sample"]
    prep = _port_prep(jax_demo["jprep"])
    final, hist, ext = port_rt.run_refine(prep)
    written = tpipe.render_trajectory(port_rt, prep, sample, hist,
                                      str(tmp_path / "viz"), tag="demo_a00_")
    label = tpipe.finish_label(final, ext, sample, prep["anno"])
    ests = {k: np.asarray([label[k]]) for k in label}
    for k in ("location", "dimensions", "rotation_y"):
        np.testing.assert_allclose(ests[k], jax_demo["ests"][k], atol=1e-4)
    written += tpipe.demo_views(str(tmp_path), sample, jax_demo["annos"],
                                ests, [0])
    assert sorted(os.path.relpath(w, tmp_path) for w in written) == \
        _files(tmp_path)
    assert len(written) == 3 * ITERS + 1 + 2
    h, w = prep["crop_hw"]
    _assert_dirs_match(str(tmp_path), jax_demo["out"], css_cols=w)


SMALL = 2048  # the batched test's surface and frustum capacities


def test_batched_trajectories_match_jax(jax_demo, port_rt, tmp_path):
    # two crops (the demo's, and the same with its start yawed by 0.2 rad)
    # in one batch, each drawn at its own size from its history's slice;
    # both runtimes at capacities of 2048 (the frustum cut to its first
    # 2048 points), since JAX pairs every rendered point with every
    # frustum point in one float64 matrix
    jrt = jax_demo["jrt"]
    jrt = jpipe.RefineRuntime(jrt.cfg, jrt.css_variables, jrt.dsdf_cfg,
                              jrt.dsdf_params, surface_capacity=SMALL,
                              frustum_capacity=SMALL)
    trt = tpipe.RefineRuntime(port_rt.cfg, port_rt.css, port_rt.dsdf_cfg,
                              port_rt.dsdf_params, surface_capacity=SMALL,
                              frustum_capacity=SMALL, device="cpu")
    jp = dict(jax_demo["jprep"], frustum=jax_demo["jprep"]["frustum"][:SMALL],
              fmask=jax_demo["jprep"]["fmask"][:SMALL])
    jpreps = [jp, dict(jp, params0=jp["params0"]._replace(
        yaw=jp["params0"].yaw + jnp.float32(0.2)))]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    sample = jax_demo["sample"]
    jlabels = jpipe.refine_crops_batched(jrt, sample, jpreps,
                                         viz_dir=str(jdir), viz_tag="f7_")
    tlabels = tpipe.refine_crops_batched(trt, sample,
                                         [_port_prep(p) for p in jpreps],
                                         viz_dir=str(tdir), viz_tag="f7_")
    assert len(tlabels) == len(jlabels) == 2
    assert {n[:6] for n in _files(tdir)} == {"f7_c00", "f7_c01"}
    _assert_dirs_match(str(tdir), str(jdir))


def test_correspondence_indices_match_dense():
    rng = np.random.RandomState(4)
    xyz = rng.normal(0, 1, (700, 3))
    frustum = rng.normal(0, 2, (900, 3)).astype(np.float32)
    fmask = rng.uniform(size=900) > 0.3
    front = rng.uniform(size=700) > 0.1
    scene, idx, dmin, ok = tpipe.correspondences(xyz, front, frustum, fmask,
                                                 2.0, "cpu")
    # JAX's dense float64 pairing (refine_css.py:682-688)
    want_scene = np.asarray(frustum, np.float64) / 2.0
    d = np.linalg.norm(xyz[:, None] - want_scene[None], axis=-1)
    d[:, ~fmask] = np.inf
    want_idx = d.argmin(1)
    two = np.sort(d, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > 1e-5 * two[:, 1]
    assert clear.mean() > 0.99
    assert np.array_equal(scene, want_scene)
    assert np.array_equal(idx[clear], want_idx[clear])
    np.testing.assert_allclose(dmin, d[np.arange(700), idx], rtol=1e-12)
    assert np.array_equal(ok, front)
    # no valid scene point: nothing pairs
    _, _, dmin0, ok0 = tpipe.correspondences(xyz, front, frustum,
                                             np.zeros(900, bool), 2.0,
                                             "cpu")
    assert not ok0.any() and np.isinf(dmin0).all()


def test_live_publication(jax_demo, port_rt, tmp_path):
    sample = jax_demo["sample"]
    prep = _port_prep(jax_demo["jprep"])
    _, hist, _ = port_rt.run_refine(prep)
    cfg = port_rt.cfg
    port_rt.cfg = dataclasses.replace(cfg, viz_live=True)
    try:
        written = tpipe.render_trajectory(port_rt, prep, sample, hist,
                                          str(tmp_path / "viz"), tag="t_")
    finally:
        port_rt.cfg = cfg
    live = tmp_path / "viz" / "live"
    assert sorted(os.listdir(live)) == ["latest_corr.png",
                                        "latest_frame.png",
                                        "latest_patches.png"]
    last = f"t_iter{ITERS - 1:04d}"
    for kind in ("corr", "frame", "patches"):
        with open(live / f"latest_{kind}.png", "rb") as a, \
                open(tmp_path / "viz" / f"{last}_{kind}.png", "rb") as b:
            assert a.read() == b.read()
    assert written[-1].endswith("t_scene3d.html")
    assert len(written) == 3 * ITERS + 1
    # viz_type none draws nothing
    port_rt.cfg = dataclasses.replace(cfg, viz_type="none")
    try:
        assert tpipe.render_trajectory(port_rt, prep, sample, hist,
                                       str(tmp_path / "none")) == []
    finally:
        port_rt.cfg = cfg
    assert not (tmp_path / "none").exists()
