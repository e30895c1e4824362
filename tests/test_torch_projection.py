"""The port's point projection (ops/projection.py) against sdflabel_tpu's,
DCM and quaternion poses, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.ops import projection as jproj
from sdflabel_tpu_torch.ops import projection as tproj


def _scene(seed):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    nrm = rng.randn(300, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    clr = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    K = np.array([[60.0, 0, 16], [0, 60.0, 12], [0, 0, 1]], np.float32)
    return rng, pts, nrm, clr, K


@pytest.mark.parametrize("output_nocs", [False, True])
@pytest.mark.parametrize("rot", ["dcm", "quat"])
def test_projection_matches_jax(rot, output_nocs):
    rng, pts, nrm, clr, K = _scene(0)
    if rot == "dcm":
        a = 0.6
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]]
        pose[:3, 3] = [0.2, -0.1, 4.0]
        jfn, tfn = jproj.project_dcm, tproj.project_dcm
    else:
        q = rng.randn(4).astype(np.float32)
        pose = np.concatenate([q / np.linalg.norm(q),
                               [0.2, -0.1, 4.0]]).astype(np.float32)
        jfn, tfn = jproj.project_quat, tproj.project_quat
    want = jfn(jnp.asarray(K), jnp.asarray(pose), jnp.asarray(pts),
               jnp.asarray(nrm), jnp.asarray(clr), (32, 24),
               output_nocs=output_nocs)
    got = tfn(torch.as_tensor(K), torch.as_tensor(pose), torch.as_tensor(pts),
              torch.as_tensor(nrm), torch.as_tensor(clr), (32, 24),
              output_nocs=output_nocs)
    # fp32 products summed in another order: 1e-5 in camera space, 1e-4 px
    for f, tol in (("points_3d", 1e-5), ("normals_3d", 1e-5),
                   ("colors_3d", 1e-6), ("points_2d", 1e-4)):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), atol=tol,
                                   err_msg=f)
    assert np.array_equal(got.front_mask.numpy(), np.asarray(want.front_mask))


def test_batched_pose_gradient_matches_vmapped_jax_and_each_crop():
    # a crop axis: each crop's pose, points and normals gradients equal
    # its own call's bit for bit, and jax.vmap of JAX's gradient within
    # fp32 reassociation
    import jax

    b = 3
    rng = np.random.RandomState(3)
    pts = rng.uniform(-1, 1, (b, 200, 3)).astype(np.float32)
    nrm = rng.randn(b, 200, 3).astype(np.float32)
    K = np.array([[60.0, 0, 16], [0, 60.0, 12], [0, 0, 1]], np.float32)
    Ks = np.stack([K] * b)
    poses = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    for i in range(b):
        a = 0.3 + 0.2 * i
        poses[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]
        poses[i, :3, 3] = [0.1 * i, -0.1, 4.0 + i]
    w = rng.randn(b, 200, 8).astype(np.float32)

    def tloss(k, pose, p, n, wt):
        out = tproj.project_dcm(k, pose, p, n, p, (32, 24))
        return ((out.points_3d * wt[..., :3]).sum()
                + (out.normals_3d * wt[..., 3:6]).sum()
                + (out.points_2d * wt[..., 6:]).sum())

    def jloss(k, pose, p, n, wt):
        out = jproj.project_dcm(k, pose, p, n, p, (32, 24))
        return ((out.points_3d * wt[..., :3]).sum()
                + (out.normals_3d * wt[..., 3:6]).sum()
                + (out.points_2d * wt[..., 6:]).sum())

    args = [torch.tensor(a, requires_grad=True) for a in (poses, pts, nrm)]
    got = torch.autograd.grad(tloss(torch.as_tensor(Ks), *args,
                                    torch.as_tensor(w)), args)
    want = jax.vmap(jax.grad(jloss, argnums=(1, 2, 3)))(
        *map(jnp.asarray, (Ks, poses, pts, nrm, w)))
    for g, jg in zip(got, want):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg,
                                   atol=1e-5 * np.abs(jg).max())
    for i in range(b):
        one = [torch.tensor(a[i], requires_grad=True)
               for a in (poses, pts, nrm)]
        g1 = torch.autograd.grad(tloss(torch.as_tensor(K), *one,
                                       torch.as_tensor(w[i])), one)
        for g, gi in zip(got, g1):
            assert torch.equal(g[i], gi)
