"""The port's row binning (ops/splat_cuda.py) against the JAX package's
(sdflabel_tpu/ops/splat_pallas.py), with the Pallas kernels in interpret
mode as tests/test_splat_pallas.py runs them.

Tolerances: the bins are integers and must be equal. The windowed plain
version sums in sorted point order, the binned Pallas kernels in sorted
chunks and the dense versions in point order, all fp32; each also splits
the footprint test differently (explicit distance in the plain versions,
the expanded form in the kernels), so a footprint bit may flip at a disc
edge: >= 99.5% of pixels within 2e-4, as slice 1 holds the dense kernel.
Against the dense plain version, which takes the same explicit footprint
test, every pixel agrees to 2e-5.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.ops import splat as jsplat
from sdflabel_tpu.ops import splat_pallas
from sdflabel_tpu.renderer.rasterer import calibration_matrix
from sdflabel_tpu_torch.ops import splat as tsplat
from sdflabel_tpu_torch.ops import splat_cuda


def _interpret_ctx():
    if jax.default_backend() == "tpu":
        return contextlib.nullcontext()
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


def _scene(n, res, seed):
    """Points in front of the camera, a few masked, and the pathological
    ones of test_splat_pallas.py: behind the camera and on its plane."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    pts[:4, 2] = np.array([-3.0, -0.01, 0.02, 0.0], np.float32)
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    feats = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    K = calibration_matrix(res).astype(np.float32)
    grid = np.asarray(jsplat.pixel_grid(*res))
    kg = (np.concatenate([grid, np.ones((grid.shape[0], 1), np.float32)], 1)
          @ np.linalg.inv(K).T).astype(np.float32)
    return pts, normals, feats, mask, kg


@pytest.mark.parametrize("n,res,bin_px,chunk", [
    (512, (64, 64), 512, 128),   # no point padding
    (300, (200, 100), 512, 128),  # padded points, ragged last row block
    (700, (64, 64), 1024, 256),
])
def test_bins_equal_jax(n, res, bin_px, chunk):
    pts, normals, feats, mask, kg = _scene(n, res, seed=n)
    jpts, _, jkg, n_pad, _ = splat_pallas._pack(
        jnp.asarray(pts), jnp.asarray(normals), jnp.asarray(mask),
        jnp.asarray(feats), jnp.asarray(kg), chunk, bin_px)
    order, sc, nc = (np.asarray(a) for a in splat_pallas._compute_bins(
        jpts, jkg, 0.04, bin_px, chunk))
    tp = splat_cuda._pack_points(torch.as_tensor(pts),
                                 torch.as_tensor(normals),
                                 torch.as_tensor(mask))
    bins = splat_cuda.compute_bins(tp, splat_cuda._pack_rays(
        torch.as_tensor(kg)), 0.04, bin_px, chunk)
    # JAX pads the points to a chunk multiple; the padding is masked, so it
    # sorts last and leaves the real points' order and windows as they are
    assert np.all(order[n:] >= n)
    np.testing.assert_array_equal(bins.order.numpy(), order[:n])
    np.testing.assert_array_equal(bins.start.numpy(), sc)
    np.testing.assert_array_equal(bins.count.numpy(), nc)
    # masked and behind-camera points are binned as JAX bins them
    assert int(bins.smax) >= 0 and bins.key.max() <= -(-kg.shape[0] // bin_px)


def test_bin_policy_matches_jax_wrapper():
    # splat_pallas.py:682-688
    cases = [(1024, None, 0), (4095, None, 0), (4096, None, 512),
             (20000, None, 512), (20000, -1, 512), (4096, 0, 0),
             (1024, 256, 256), (1024, 512, 512), (1023, 512, 0),
             (64, 128, 0)]
    for p, req, want in cases:
        assert splat_cuda.bin_policy(p, req) == want, (p, req)


@pytest.mark.parametrize("n,res", [(420, (64, 64)), (380, (200, 100))])
def test_windowed_matches_binned_pallas_and_dense(n, res):
    pts, normals, feats, mask, kg = _scene(n, res, seed=7)
    g = np.random.RandomState(8).randn(kg.shape[0], 8).astype(np.float32)

    def jax_loss(bin_px):
        def f(p, nr, ft):
            img = splat_pallas.surfel_composite(
                p, nr, ft, jnp.asarray(kg), point_mask=jnp.asarray(mask),
                diam=0.04, bin_px=bin_px)
            return jnp.sum(img * g), img
        return f

    args = (jnp.asarray(pts), jnp.asarray(normals), jnp.asarray(feats))
    with _interpret_ctx():
        (_, img_b), gb = jax.value_and_grad(jax_loss(512), (0, 1, 2),
                                            has_aux=True)(*args)

    def torch_run(fn):
        ts = [torch.tensor(a, requires_grad=True)
              for a in (pts, normals, feats)]
        img = fn(*ts, torch.as_tensor(kg), torch.as_tensor(mask), 0.04)
        grads = torch.autograd.grad((img * torch.as_tensor(g)).sum(), ts)
        return img.detach().numpy(), [x.numpy() for x in grads]

    img_w, gw = torch_run(splat_cuda.surfel_composite_windowed)
    img_d, gd = torch_run(tsplat.surfel_composite_dense)
    # the CPU wrapper picks the windowed version for these renders
    img_auto, _ = torch_run(splat_cuda.surfel_composite)
    np.testing.assert_array_equal(img_auto, img_w)

    # same explicit footprint test: every pixel and gradient agrees
    np.testing.assert_allclose(img_w, img_d, atol=2e-5)
    for a, b in zip(gw, gd):
        scale = max(np.abs(b).max(), 1e-6)
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-5)

    # against the binned Pallas kernels: boundary bits may flip
    px = np.abs(img_w - np.asarray(img_b)).max(-1)
    assert (px < 2e-4).mean() >= 0.995, (px < 2e-4).mean()
    for a, b in zip(gw, gb):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1e-6)
        rows = (np.abs(a - b).max(-1) / scale) < 1e-3
        assert rows.mean() >= 0.99, rows.mean()
