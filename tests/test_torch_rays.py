"""The port's pixel-sharded render (parallel/rays.py) on 2 gloo ranks
against JAX's make_rays_sharded_render on a 2-device mesh and against the
port's unsharded render.

At 32x16 px each rank's block is dense; at 96x96 px (4608 px a block)
it takes the row-binned route, on the CPU the windowed plain version of
the bins and the binned kernels, while JAX's CPU render is dense.

Tolerances, at both sizes: the image to 1e-5 against both, JAX's own bound for its
sharded render against its dense one (fp32 on both sides; each block is
the dense plain splat of its pixels). The gradients of sum(image^2) in
the pose and in the points, the same on both ranks: to 1e-5 of the
largest element against the port's unsharded render, and to 1e-4 of it
against JAX's sharded render, the bound of the port's render gradients
against JAX (test_torch_splat.py): the port's unsharded pose gradient
itself is 3.7e-5 of the largest from JAX's, while JAX's sharded and
dense ones agree to 1e-7. Each rank's gradient is the sum over the
blocks, as JAX's shard_map transpose gives it, so a block counted twice
or left out would miss by far more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.parallel import mesh as jmesh
from sdflabel_tpu.parallel import rays as jrays
from sdflabel_tpu.renderer import rasterer as jrast
from sdflabel_tpu_torch.ops import splat_cuda
from sdflabel_tpu_torch.parallel import mesh as mesh_mod
from sdflabel_tpu_torch.parallel import rays as trays
from sdflabel_tpu_torch.renderer import rasterer as trast
import torch_dp_worker as dpw
import torch_sharded_worker as worker

RES = (32, 16)
BINNED_RES = (96, 96)  # 4608 px a block on 2 ranks: the row-binned route


def _job(res, n):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0, 0, 5]
    mask = np.ones(n, bool)
    mask[::7] = False
    return dict(K=jrast.calibration_matrix(res), res=res, pts=pts,
                normals=normals, pose=pose, mask=mask)


@pytest.fixture(scope="module")
def job():
    return _job(RES, 384)


@pytest.fixture(scope="module")
def binned_job():
    return _job(BINNED_RES, 2048)


@pytest.fixture(scope="module")
def spawned(job, binned_job, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("rays"))
    mesh_mod.spawn_ranks(worker.rays_rank, 2, (out, [job, binned_job]),
                         backend="gloo")
    return dpw.same_on_every_rank(dpw.load(out, "rays", 2))


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned[0]


@pytest.fixture(scope="module")
def binned_ranks(spawned):
    return spawned[1]


def _jax(job):
    mesh = jmesh.make_mesh(n_data=1, n_rays=2, devices=jax.devices()[:2])
    render = jrays.make_rays_sharded_render(mesh, jnp.asarray(job["K"]),
                                            job["res"])
    args = [jnp.asarray(job[k]) for k in ("pts", "normals", "pose", "mask")]

    def loss(pose, pts):
        img = render(pts, args[1], pose, args[3])
        return jnp.sum(img ** 2), img

    (_, img), (g_pose, g_pts) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(args[2], args[0])
    return np.asarray(img), np.asarray(g_pose), np.asarray(g_pts)


def _check(job, ranks):
    """The ranks' image and gradients against JAX's sharded render and the
    port's unsharded one."""
    img, g_pose, g_pts = _jax(job)
    np.testing.assert_allclose(ranks["img"], img, rtol=0, atol=1e-5)
    t = {k: torch.as_tensor(job[k]) for k in ("pts", "normals", "pose",
                                               "mask")}
    t["pose"].requires_grad_(True)
    t["pts"].requires_grad_(True)
    rendering, _ = trast.render(torch.as_tensor(job["K"]), job["res"],
                                t["pts"], t["normals"], t["normals"],
                                t["pose"], point_mask=t["mask"], rot="dcm",
                                output_nocs=True)
    np.testing.assert_allclose(ranks["img"], rendering.color.detach()
                               .numpy(), rtol=0, atol=1e-5)
    assert (ranks["img"] > 0).mean() > 0.1  # a render, not a blank
    rendering.color.square().sum().backward()
    for name, want, rel in (("g_pose", t["pose"].grad.numpy(), 1e-5),
                            ("g_pts", t["pts"].grad.numpy(), 1e-5),
                            ("g_pose", g_pose, 1e-4), ("g_pts", g_pts, 1e-4)):
        scale = np.abs(want).max()
        assert scale > 0
        np.testing.assert_allclose(ranks[name], want, rtol=0,
                                   atol=rel * scale, err_msg=name)


def test_rays_render_matches_jax_and_unsharded(job, ranks):
    _check(job, ranks)


def test_rays_binned_blocks_match_jax_and_unsharded(binned_job,
                                                    binned_ranks):
    # each rank's block, and the unsharded render, take the row-binned
    # route (the windowed plain version here, the bins, 1c and 1d on the
    # card); JAX renders dense on the CPU
    w, h = BINNED_RES
    assert splat_cuda.bin_policy(w * h // 2) == splat_cuda.BIN_AUTO_PX
    assert splat_cuda.bin_policy(w * h) == splat_cuda.BIN_AUTO_PX
    _check(binned_job, binned_ranks)


def test_rays_one_rank_is_the_unsharded_render(job):
    # a one-rank layout without a process group: no collective at all
    render = trays.make_rays_sharded_render(mesh_mod.make_mesh(), job["K"],
                                            RES)
    t = {k: torch.as_tensor(job[k]) for k in ("pts", "normals", "pose",
                                               "mask")}
    img = render(t["pts"], t["normals"], t["pose"], t["mask"])
    rendering, _ = trast.render(torch.as_tensor(job["K"]), RES, t["pts"],
                                t["normals"], t["normals"], t["pose"],
                                point_mask=t["mask"], rot="dcm",
                                output_nocs=True)
    np.testing.assert_allclose(img.numpy(), rendering.color.numpy(),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="do not divide"):
        trays.make_rays_sharded_render(
            mesh_mod.Mesh({"data": 1, "rays": 3}, 0, 0, 0), job["K"], RES)
