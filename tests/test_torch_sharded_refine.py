"""The port's grid- and pixel-sharded refine
(parallel/sharded_refine.py) on 2 gloo ranks against JAX's
make_sharded_refine_fn on a 2-device mesh and against the port's own
single-device loop (engine/refine.py::make_refine_fn).

Every configuration runs in one spawn of two ranks (the module fixture),
each job twice: 3 iterations and 10. Tolerances:
- against JAX's sharded refine after 3 iterations, the port's standing
  bound for 3 coupled steps in fp32 (test_torch_batched_refine.py): the
  losses to rtol 1e-4, the parameters to 1e-4;
- against the port's single-device loop over 10 iterations, JAX's own
  bounds for its sharded refine against its single-device one
  (tests/test_sharded_refine.py): the first two losses to rtol 1e-4, all
  to rtol 2e-2 + atol 1e-3, yaw, translation and scale to 1e-2, the
  latent's direction to 1e-3;
- one SGD step on each loss path alone (weight_2d = 0, then
  weight_3d = 0) against the single-device step, every parameter's
  update to rtol 2e-3 (JAX's bound): scale and latent step by SGD, so a
  gradient counted n times, or once on one rank only, misses by far.
The two ranks must end bit-equal, as the same full gradient on each
gives.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.engine import refine as jref
from sdflabel_tpu.ops import grid as jgrid
from sdflabel_tpu.parallel import mesh as jmesh
from sdflabel_tpu.parallel import sharded_refine as jshard
from sdflabel_tpu.renderer import rasterer as jrast
from sdflabel_tpu_torch.engine import refine as tref
from sdflabel_tpu_torch.parallel import mesh as mesh_mod
from sdflabel_tpu_torch.parallel import sharded_refine as tshard
import torch_dp_worker as dpw
import torch_sharded_worker as worker

FIELDS = ("yaw", "trans", "scale", "latent")


def _jax_sphere(radius=0.45):
    def fn(latent, pts):
        return jnp.linalg.norm(pts, axis=-1) - (radius + 0.1 * latent[0])
    return fn


def _jax_sphere2(latent, p):
    r = 0.45 + 0.1 * latent[0] + 0.05 * latent[1]
    return jnp.linalg.norm(p, axis=-1) - r


def _jax_bf16(latent, p):
    return _jax_sphere()(latent.astype(jnp.bfloat16),
                         p.astype(jnp.bfloat16)).astype(jnp.float32)


JAX_DECODERS = {"sphere": _jax_sphere(), "sphere2": _jax_sphere2,
                "bf16": _jax_bf16}


def _crop(crop_hw, density, cap):
    """JAX's test problem: the sphere rendered at a known pose as the NOCS
    target, its front points (x2) as the frustum, a start nearby."""
    h, w = crop_hw
    K = jrast.calibration_matrix((w, h))
    grid = jgrid.generate_point_grid(density)
    dec = JAX_DECODERS["sphere"]
    gt = jref.init_refine_params(0.4, [0.05, -0.02, 4.0], 2.0, [0., 0., 0.])
    surf, _ = jgrid.surface_from_decoder(dec, gt.latent, grid, capacity=cap)
    rendering, points = jrast.render(
        jnp.asarray(K), (w, h), surf.points, surf.normals, surf.normals,
        jref.build_render_pose(gt.yaw, gt.trans), point_mask=surf.mask,
        rot="dcm", primitives="disc", output_nocs=True)
    xyz = np.asarray(points.xyz)[np.asarray(points.front_mask)]
    frustum = np.zeros((2048, 3), np.float32)
    frustum[:len(xyz)] = xyz[:2048] * 2.0
    fmask = np.arange(2048) < len(xyz)
    return dict(grid=np.asarray(grid), K=K, crop_hw=crop_hw,
                nocs=np.asarray(rendering.color), frustum=frustum,
                fmask=fmask, init=[[0.45], [0.05, -0.02, 4.05], [2.08],
                                   [0.0, 0.0, 0.0]])


def _random_crop():
    """test_sharded_gradient_parity_per_loss_path's inputs."""
    rng = np.random.RandomState(0)
    return dict(grid=np.asarray(jgrid.generate_point_grid(16)),
                K=jrast.calibration_matrix((16, 16)), crop_hw=(16, 16),
                nocs=rng.rand(3, 16, 16).astype(np.float32) * 0.5,
                frustum=(rng.randn(512, 3) * 0.4 + [0, 0, 8.0]).astype(
                    np.float32),
                fmask=np.ones(512, bool),
                init=[[0.45], [0.05, -0.02, 4.05], [2.08],
                      [0.2, -0.1, 0.05]])


# name -> (problem, RefineConfig fields, make_sharded_refine_fn options)
CONFIGS = {
    "exact": ("main", {}, {}),
    "warm_band": ("main", dict(warm_band=1024, warm_refresh=2), {}),
    "coarse_cells": ("main", dict(coarse_cells=600), {}),
    "warm_refresh_cells": ("main", dict(warm_band=1024, warm_refresh=2,
                                        warm_refresh_cells=600), {}),
    "select_decoder": ("main", {}, dict(select="bf16")),
    "windowed_2d": ("main", {}, dict(windowed_2d=True)),
    # 99 px and a capacity of 511: the pixel and the stage-2 pads
    "odd_sizes": ("odd", dict(surface_capacity=511), {}),
}
LOSS_PATHS = {"loss_3d_only": dict(weight_2d=0.0, weight_3d=0.5),
              "loss_2d_only": dict(weight_2d=0.3, weight_3d=0.0)}


@pytest.fixture(scope="module")
def problems():
    return {"main": _crop((24, 24), 24, 1024), "odd": _crop((11, 9), 15, 511),
            "random": _random_crop()}


def _jobs(problems):
    jobs = []
    for name, (prob, cfg_kw, opts) in CONFIGS.items():
        cfg = {"surface_capacity": 1024, **cfg_kw}
        for iters in (3, 10):
            jobs.append(dict(problems[prob], name=f"{name}/{iters}",
                             decoder="sphere", cfg=dict(cfg, iters=iters),
                             **opts))
    for name, kw in LOSS_PATHS.items():
        jobs.append(dict(problems["random"], name=name, decoder="sphere2",
                         cfg=dict(surface_capacity=500, iters=1, **kw)))
    return jobs


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sharded"))
    mesh_mod.spawn_ranks(worker.sharded_rank, 2, (out, _jobs(problems)),
                         backend="gloo")
    return dpw.same_on_every_rank(dpw.load(out, "sharded", 2))


def _jax_sharded(job):
    mesh = jmesh.make_mesh(n_data=1, n_rays=2, devices=jax.devices()[:2])
    opts = {k: job[k] for k in ("windowed_2d",) if k in job}
    if "select" in job:
        opts["select_decoder"] = JAX_DECODERS[job["select"]]
    fn = jshard.make_sharded_refine_fn(
        JAX_DECODERS[job["decoder"]], jref.RefineConfig(**job["cfg"]),
        job["grid"], job["K"], job["crop_hw"], mesh, axis="rays", **opts)
    final, hist = fn(jref.init_refine_params(*job["init"]),
                     jnp.asarray(job["nocs"]), jnp.asarray(job["frustum"]),
                     jnp.asarray(job["fmask"]))
    return [np.asarray(p) for p in final], np.asarray(hist)


def _single(job):
    fn = tref.make_refine_fn(
        worker.DECODERS[job["decoder"]], tref.RefineConfig(**job["cfg"]),
        torch.as_tensor(job["grid"]), torch.as_tensor(job["K"]),
        job["crop_hw"], device="cpu")
    final, hist = fn(worker._params(job["init"]),
                     *(torch.as_tensor(job[k]) for k in ("nocs", "frustum",
                                                         "fmask")))
    return [p.numpy() for p in final], hist.loss.numpy()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_refine_matches_jax_and_single_device(name, problems,
                                                      ranks):
    jobs = {j["name"]: j for j in _jobs(problems)}
    # 3 iterations against JAX's sharded refine
    got = ranks[f"{name}/3"]
    jfinal, jhist = _jax_sharded(jobs[f"{name}/3"])
    assert np.isfinite(got["hist"]).all() and got["hist"][0] > 0
    np.testing.assert_allclose(got["hist"], jhist, rtol=1e-4, atol=1e-7)
    for f, a, b in zip(FIELDS, got["final"], jfinal):
        # the latent from 0 steps to ~1e6 (the sphere's normalization):
        # its digits are relative
        np.testing.assert_allclose(a, b, rtol=1e-4 if f == "latent" else 0,
                                   atol=1e-4, err_msg=f)
    # 10 iterations against the port's own single-device loop
    got = ranks[f"{name}/10"]
    sfinal, shist = _single(jobs[f"{name}/10"])
    np.testing.assert_allclose(got["hist"][:2], shist[:2], rtol=1e-4)
    np.testing.assert_allclose(got["hist"], shist, rtol=2e-2, atol=1e-3)
    for f, a, b in list(zip(FIELDS, got["final"], sfinal))[:3]:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2, err_msg=f)
    la, lb = got["final"][3], sfinal[3]
    np.testing.assert_allclose(la / max(np.linalg.norm(la), 1e-9),
                               lb / max(np.linalg.norm(lb), 1e-9), atol=1e-3)


@pytest.mark.parametrize("name", list(LOSS_PATHS))
def test_one_step_per_loss_path_matches_single_device(name, problems,
                                                      ranks):
    job = next(j for j in _jobs(problems) if j["name"] == name)
    sfinal, _ = _single(job)
    init = job["init"]
    for f, got, want, p0 in zip(FIELDS, ranks[name]["final"], sfinal, init):
        step, want_step = got - np.float32(p0), want - np.float32(p0)
        # the SGD leaves that move on this path (the 2D loss does not
        # reach the scale)
        if f == "latent" or (f == "scale" and name == "loss_3d_only"):
            assert np.abs(want_step).max() > 0, f
        np.testing.assert_allclose(step, want_step, rtol=2e-3, atol=1e-12,
                                   err_msg=f"{name} {f}")


def test_sharded_refine_refusals(problems):
    prob = problems["main"]
    mesh = mesh_mod.Mesh({"data": 1, "rays": 8}, 0, 0, 0)
    base = tref.RefineConfig(iters=5, surface_capacity=1024)

    def make(**kw):
        tshard.make_sharded_refine_fn(
            worker.sphere_decoder, dataclasses.replace(base, **kw),
            torch.as_tensor(prob["grid"]), prob["K"], prob["crop_hw"], mesh,
            device="cpu")

    with pytest.raises(ValueError, match="pool == "):
        make(warm_band=123)
    with pytest.raises(ValueError, match="at most one"):
        make(warm_band=1024, coarse_cells=600)
    with pytest.raises(ValueError, match="warm_refresh must be"):
        make(warm_band=1024, warm_refresh=0)
    with pytest.raises(ValueError, match="raise coarse_cells"):
        make(coarse_cells=8)
    with pytest.raises(ValueError, match="raise warm_refresh_cells"):
        make(warm_band=1024, warm_refresh_cells=8)
