"""The last modules of the port against the JAX package: the circle and
stamped-circle primitives and background compositing of the rasterer
(renderer/rasterer.py, ops/splat.py), the renderer demo
(pipelines/render_demo.py), the mesh loader (utils/meshio.py) and the
profiler trace of utils/profiling.py.

Tolerances: each render's images to 1e-5 of JAX's rasterer.render (fp32
dense matrices on both sides), and the pose gradient of a loss over
color and depth to 1e-4 of its largest element (the port's render
gradient bound, test_torch_splat.py); the demo's images to the splat
tolerance: >= 99.5% of pixels within 2e-4 (a footprint bit may flip for
a pair within rounding of the disc's edge), the rest within 1; the OBJ
loader exactly.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.pipelines import render_demo as jdemo
from sdflabel_tpu.renderer import rasterer as jrast
from sdflabel_tpu.utils import meshio as jmeshio
from sdflabel_tpu_torch.pipelines import render_demo as tdemo
from sdflabel_tpu_torch.renderer import rasterer as trast
from sdflabel_tpu_torch.utils import meshio as tmeshio
from sdflabel_tpu_torch.utils import png, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DSDF = os.path.join(REPO, "data", "optimization", "deepsdf_demo.pt")
RES = (24, 16)


def _scene(n=64, seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0, 0, 5]
    mask = np.ones(n, bool)
    mask[::5] = False
    return dict(K=jrast.calibration_matrix(RES), pts=pts, normals=normals,
                colors=rng.rand(n, 3).astype(np.float32), pose=pose,
                mask=mask, bg=rng.rand(3, RES[1], RES[0]).astype(np.float32))


@pytest.mark.parametrize("background", ["none", "use_bg", "image"])
@pytest.mark.parametrize("primitives", ["disc", "circle", "circle_opt"])
def test_render_primitives_and_background_match_jax(primitives,
                                                    background):
    s = _scene()
    kw = dict(rot="dcm", primitives=primitives,
              use_bg=background == "use_bg")

    def jloss(pose):
        r, _ = jrast.render(
            jnp.asarray(s["K"]), RES, jnp.asarray(s["pts"]),
            jnp.asarray(s["normals"]), jnp.asarray(s["colors"]), pose,
            point_mask=jnp.asarray(s["mask"]),
            bg=jnp.asarray(s["bg"]) if background == "image" else None, **kw)
        return jnp.sum(r.color ** 2) + jnp.sum(r.depth), r

    (_, jr), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(s["pose"]))
    pose = torch.tensor(s["pose"], requires_grad=True)
    tr, _ = trast.render(
        torch.tensor(s["K"]), RES, torch.tensor(s["pts"]),
        torch.tensor(s["normals"]), torch.tensor(s["colors"]), pose,
        point_mask=torch.tensor(s["mask"]),
        bg=torch.tensor(s["bg"]) if background == "image" else None, **kw)
    (tr.color.square().sum() + tr.depth.sum()).backward()
    for name, a, b in zip(tr._fields, jr, tr):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-5, err_msg=name)
    assert np.asarray(jr.color).max() > 0.1
    scale = np.abs(np.asarray(jg)).max()
    np.testing.assert_allclose(pose.grad.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-4 * scale)


def _splat_close(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want)).max(0)
    assert (d < 2e-4).mean() >= 0.995, (d >= 2e-4).mean()
    assert d.max() <= 1.0


@pytest.mark.parametrize("primitives", ["disc", "circle", "circle_opt"])
def test_render_sdf_matches_jax(primitives, tmp_path):
    # 100x50 px: 5000 pixels take the port's binned route (on the CPU its
    # windowed plain version); a cut grid keeps it quick
    kw = dict(grid_density=16, crop_size=(100, 50))
    jr, _ = jdemo.render_sdf(DSDF, primitives, output_dir=str(tmp_path / "j"),
                             **kw)
    tr, out = tdemo.render_sdf(DSDF, primitives,
                               output_dir=str(tmp_path / "t"), device="cpu",
                               **kw)
    _splat_close(tr.color.numpy(), jr.color)
    assert np.asarray(jr.color).max() > 0.1
    img = png.read(out)
    assert img.shape == (50, 100, 3) and img.any()


def test_render_model_and_cli_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    v = rng.randn(400, 3).astype(np.float32)
    v = 0.8 * v / np.linalg.norm(v, axis=1, keepdims=True)
    path = str(tmp_path / "ball.npz")
    np.savez(path, vertices=v, normals=v / 0.8,
             colors=rng.rand(400, 3).astype(np.float32))
    jr, _ = jdemo.render_model(path, output_dir=str(tmp_path / "j"),
                               crop_size=(64, 48))
    tr, _ = tdemo.render_model(path, output_dir=str(tmp_path / "t"),
                               crop_size=(64, 48), device="cpu")
    _splat_close(tr.color.numpy(), jr.color)
    assert np.asarray(jr.color).max() > 0.1
    tdemo.main(["--model", path, "--out", str(tmp_path / "cli"),
                "--device", "cpu"])
    assert png.read(str(tmp_path / "cli" / "demo_cad.png")).any()


def test_load_obj_matches_jax(tmp_path):
    """The cases of tests/test_demo_apps.py::test_obj_loader_cube: a quad
    with RGB vertices and face-derived normals, explicit vn through v//vn
    with negative indices; and vn lines paired by position, and no faces
    at all."""
    cases = {
        "quad.obj": "# comment\nv 0 0 0 1 0 0\nv 1 0 0 0 1 0\nv 1 1 0 0 0 1\n"
                    "v 0 1 0 0.5 0.5 0.5\nf 1/1/1 2/2/2 3/3/3 4/4/4\n",
        "tri.obj": "v 0 0 0\nv 2 0 0\nv 0 2 0\nvn 0 1 0\nvn 0 1 0\n"
                   "vn 0 1 0\nf -3//-3 -2//-2 -1//-1\n",
        "paired.obj": "v 0 0 0\nv 1 0 0\nvn 1 0 0\nvn 0 0 2\nf 1 2 1\n",
        "points.obj": "v 0 0 0 0.2 0.4 0.6\nv 3 1 0 1 1 1\n",
    }
    for name, text in cases.items():
        path = tmp_path / name
        path.write_text(text)
        for want, got in zip(jmeshio.load_obj(str(path)),
                             tmeshio.load_obj(str(path))):
            assert want.dtype == got.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)
        for want, got in zip(jmeshio.load_mesh(str(path)),
                             tmeshio.load_mesh(str(path))):
            np.testing.assert_array_equal(got, want, err_msg=name)
    with pytest.raises(ValueError, match="no vertices"):
        (tmp_path / "empty.obj").write_text("# nothing\n")
        tmeshio.load_obj(str(tmp_path / "empty.obj"))


def test_trace_exports_ops_and_spans(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.span("demo.block", rows=64):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    block = [e for e in events if e.get("cat") == "program_span"]
    assert mm and [e["name"] for e in block] == ["demo.block"]
    assert block[0]["args"]["rows"] == 64
    # the span holds the operator on the file's clock and thread
    b, m = block[0], mm[0]
    assert b["tid"] == m["tid"]
    assert b["ts"] <= m["ts"] and m["ts"] + m["dur"] <= b["ts"] + b["dur"]
