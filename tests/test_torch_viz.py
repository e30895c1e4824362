"""The port's headless visualization (utils/viz.py, utils/viz3d.py,
ops/geometry.py::transform_kitti_to_cuboid) against sdflabel_tpu's on the
same seeded numpy inputs: every image array equal (tolerance: none, the
same float64 numpy arithmetic), the PNG the port writes through
utils/png.py decoding to the pixels PIL reads from JAX's, and the point
sets embedded in export_scene_html's file within 1e-6."""

import json
import re

import numpy as np
import pytest
from PIL import Image

from sdflabel_tpu.ops import geometry as jgeo
from sdflabel_tpu.utils import viz as jviz
from sdflabel_tpu.utils import viz3d as jviz3d
from sdflabel_tpu_torch.ops import geometry as tgeo
from sdflabel_tpu_torch.utils import png
from sdflabel_tpu_torch.utils import viz as tviz
from sdflabel_tpu_torch.utils import viz3d as tviz3d


def _boxes(rng, n):
    return [{"dimensions": rng.uniform(1.3, 4.5, 3),
             "location": rng.uniform([-8, 0.5, 5], [8, 2, 35]),
             "rotation_y": float(rng.uniform(-np.pi, np.pi))}
            for _ in range(n)]


def _cases(rng):
    """(name, args, kwargs) of every plotting function."""
    nocs_r = rng.uniform(0, 1, (3, 20, 27)).astype(np.float32)
    nocs_r[:, :5] = 0
    nocs_c = rng.uniform(0, 1.2, (3, 24, 27)).astype(np.float32)
    frame = rng.uniform(0, 1, (60, 90, 3)).astype(np.float32)
    normals = rng.uniform(0, 1, (3, 17, 23)).astype(np.float32)
    normals[:, :, :4] = 0
    lidar = rng.uniform([-30, -2, 0], [30, 2, 45], (3000, 3))
    est, gt = _boxes(rng, 2)
    a = rng.normal(0, 1, (300, 3))
    b = rng.normal(0, 1, (500, 3))
    idx = rng.randint(-2, 510, 300)
    return [
        ("plot_patches", (nocs_r, nocs_c), {}),
        ("plot_full_frame", (frame, normals, [10, 5, 70, 50]), {}),
        ("plot_bev", (lidar,), {"label": est, "gt_anno": gt}),
        ("plot_bev", (np.zeros((0, 3)),), {"label": est}),
        ("plot_correspondences_bev", (a, b, idx),
         {"dists": rng.uniform(0, 2, 300),
          "mask_a": rng.uniform(size=300) > 0.2,
          "mask_b": rng.uniform(size=500) > 0.3}),
        ("plot_correspondences_bev", (a, b, np.clip(idx, 0, 499)), {}),
        ("plot_correspondences_bev", (a, b, idx),
         {"mask_a": np.zeros(300, bool), "mask_b": np.zeros(500, bool)}),
        ("plot_loss_curves", ({"loss": rng.uniform(0, 1, 60),
                               "loss_3d": np.r_[rng.uniform(0, 1, 59),
                                                np.nan]},), {}),
        ("plot_loss_curves", ({"other": np.ones(4)},), {}),
    ]


@pytest.mark.parametrize("case", range(9))
def test_plots_match_jax(case, tmp_path):
    name, args, kw = _cases(np.random.RandomState(7))[case]
    jpath, tpath = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    want = getattr(jviz, name)(*args, **kw, path=jpath)
    got = getattr(tviz, name)(*args, **kw, path=tpath)
    assert got.dtype == want.dtype and np.array_equal(got, want), name
    # the port's PNG writer against PIL's reader of JAX's file
    assert np.array_equal(png.read(tpath),
                          np.asarray(Image.open(jpath).convert("RGB")))


def test_heatmap_and_cuboids_match_jax():
    rng = np.random.RandomState(3)
    v = rng.normal(0, 1, 200)
    assert np.array_equal(tviz.build_heatmap(v), jviz.build_heatmap(v))
    assert np.array_equal(tviz.build_heatmap(v, lo=0.0, hi=0.5),
                          jviz.build_heatmap(v, lo=0.0, hi=0.5))
    for box in _boxes(rng, 4):
        h, w, l = box["dimensions"]
        args = (w, h, l, box["location"], box["rotation_y"])
        assert np.array_equal(tgeo.transform_kitti_to_cuboid(*args),
                              jgeo.transform_kitti_to_cuboid(*args))
        keys = (box["dimensions"], box["location"], box["rotation_y"])
        assert tviz3d.cuboid_edges(*keys) == jviz3d.cuboid_edges(*keys)


def scene_json(path: str) -> dict:
    """The scene export_scene_html embeds in its file."""
    with open(path) as f:
        return json.loads(re.search(r"const SCENE = (\{.*?\});\n",
                                    f.read()).group(1))


def _rows(layer: dict, key: str) -> np.ndarray:
    """A layer's points, or its segments with their heat, one per row."""
    if key == "pts":
        return np.asarray(layer["pts"], np.float64).reshape(-1, 3)
    segs = np.asarray(layer["segs"], np.float64).reshape(-1, 6)
    if "heat" in layer:
        segs = np.concatenate([segs, np.asarray(layer["heat"])[:, None]], 1)
    return segs


def assert_scenes_close(got: dict, want: dict, atol: float,
                        as_sets: bool = False):
    """The same layers, each point or segment within `atol` (max norm) of
    its counterpart: in order, or, `as_sets`, of the nearest one of the
    other scene's layer, both ways (two decodes may rank equal |sdf| in
    another order when they differ by an ulp)."""
    from scipy.spatial import cKDTree

    assert got["title"] == want["title"]
    assert [(g["kind"], g["name"]) for g in got["layers"]] == \
        [(w["kind"], w["name"]) for w in want["layers"]]
    for g, w in zip(got["layers"], want["layers"]):
        key = "pts" if "pts" in w else "segs"
        a, b = _rows(g, key), _rows(w, key)
        assert a.shape == b.shape, w["name"]
        if not as_sets:
            np.testing.assert_allclose(a, b, atol=atol, err_msg=w["name"])
            continue
        for x, y in ((a, b), (b, a)):
            dist, _ = cKDTree(y).query(x, p=np.inf)
            assert dist.max(initial=0) <= atol, (w["name"], dist.max())


def test_scene_html_matches_jax(tmp_path):
    rng = np.random.RandomState(11)
    a = rng.normal(0, 2, (5000, 3))
    b = rng.normal(0, 2, (5000, 3))
    kw = dict(lidar=rng.uniform(-40, 40, (70000, 3)), model_points=a[:900],
              scene_points=b,
              correspondences={"a": a, "b": b[rng.randint(0, 5000, 5000)],
                               "heat": rng.uniform(0, 3, 5000)},
              est_boxes=_boxes(rng, 2), gt_boxes=_boxes(rng, 1),
              title="parity")
    jpath, tpath = str(tmp_path / "j.html"), str(tmp_path / "t.html")
    jviz3d.export_scene_html(jpath, **kw)
    assert tviz3d.export_scene_html(tpath, **kw) == tpath
    want, got = scene_json(jpath), scene_json(tpath)
    assert len(got["layers"]) == 6
    # tolerance 1e-6: the same numpy rounding of the same float64 inputs
    assert_scenes_close(got, want, atol=1e-6)
    assert len(got["layers"][0]["pts"]) == 60000  # the lidar, decimated
