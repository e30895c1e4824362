"""The port's RANSAC against sdflabel_tpu.ops.ransac, fed the ranks the JAX
package draws for the same key (jax.random has no torch counterpart)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.ops import ransac as jr
from sdflabel_tpu_torch.ops import ransac as tr
from torch_parity_util import jax_ransac_ranks


def _rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _problem(seed=0, m=300, n=256, n_valid=200):
    """Model points with NOCS colours; a scene that is the model moved by
    a similarity, with noise and outliers, at fixed capacity."""
    rng = np.random.RandomState(seed)
    model = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    cls = (model + 0.5).astype(np.float32)
    mmask = np.ones(m, bool)
    mmask[-20:] = False
    pick = rng.randint(0, m - 20, n)
    scene = (2.0 * model[pick] @ _rot(0.7).T
             + np.array([0.5, 1.0, 9.0], np.float32))
    scene += rng.randn(n, 3).astype(np.float32) * 0.01
    scls = cls[pick] + rng.randn(n, 3).astype(np.float32) * 0.01
    out = rng.uniform(size=n) < 0.3
    scene[out] += rng.randn(out.sum(), 3).astype(np.float32)
    smask = np.zeros(n, bool)
    smask[:n_valid] = True
    return model, cls, mmask, scene, scls.astype(np.float32), smask


@pytest.mark.parametrize("method", ["kabsch", "procrustes"])
def test_ransac_pose_matches_jax_given_its_ranks(method):
    arrays = _problem()
    key = jax.random.PRNGKey(3)
    cfg = jr.RansacConfig(num_hypotheses=64)
    scale_model = 2.0 if method == "kabsch" else 1.0
    jp = jr.ransac_pose(*map(jnp.asarray, arrays), key, method=method,
                        scale_model=scale_model, cfg=cfg)
    ranks = jax_ransac_ranks(key, int(arrays[-1].sum()), 64)
    tp = tr.ransac_pose(*map(torch.as_tensor, arrays),
                        ranks=torch.as_tensor(ranks), method=method,
                        scale_model=scale_model,
                        cfg=tr.RansacConfig(num_hypotheses=64))
    assert int(tp.num_inliers) == int(jp.num_inliers) > 100
    assert np.array_equal(tp.inlier_mask.numpy(),
                          np.asarray(jp.inlier_mask))
    # fp32 3x3 SVDs on both sides: 1e-5
    for f in ("scale", "rot", "tra"):
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), atol=1e-5,
                                   err_msg=f)
    np.testing.assert_allclose(tp.rot.numpy(), _rot(0.7), atol=0.02)


def test_kabsch_and_procrustes_batched_match_jax():
    rng = np.random.RandomState(1)
    a = rng.randn(10, 4, 3).astype(np.float32)
    b = (1.5 * a @ _rot(0.3).T + 0.2
         + rng.randn(10, 4, 3).astype(np.float32) * 0.01)
    jrot, jt = jr.kabsch(jnp.asarray(a), jnp.asarray(b))
    trot, tt = tr.kabsch(torch.as_tensor(a), torch.as_tensor(b))
    np.testing.assert_allclose(trot.numpy(), np.asarray(jrot), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    jres = jr.procrustes(jnp.asarray(a), jnp.asarray(b))
    tres = tr.procrustes(torch.as_tensor(a), torch.as_tensor(b))
    for t, j in zip(tres, jres):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5)


def test_drawn_ranks_are_distinct_and_in_range():
    cfg = tr.RansacConfig(num_hypotheses=500)
    for v in (4, 6, 200):
        r = tr.draw_ranks(v, cfg, torch.Generator().manual_seed(v))
        assert r.shape == (500, 4) and int(r.min()) >= 0
        assert int(r.max()) < v
        s = torch.sort(r, 1).values
        assert (s[:, 1:] != s[:, :-1]).all()
    # the JAX draw obeys the same contract
    j = jax_ransac_ranks(jax.random.PRNGKey(0), 6, 500)
    assert j.max() < 6 and (np.diff(np.sort(j, 1), axis=1) != 0).all()
