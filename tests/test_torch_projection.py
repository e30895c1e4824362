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
