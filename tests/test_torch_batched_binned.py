"""The row-binned splat path with a crop axis, as the batched driver
renders a bucket of >= 4096 px, against jax.vmap of the JAX package's
binning and binned Pallas kernels in interpret mode (the way
tests/test_torch_splat_binned.py runs them on the CPU): three crops with
their own rays, one with every point masked (a padded lane).

Tolerances, as for one crop: the bins are integers and must be equal; the
windowed plain version sums in sorted point order and takes the explicit
footprint test, the Pallas kernels the expanded one, so a footprint bit
may flip at a disc edge: >= 99.5% of pixels within 2e-4 and >= 99% of
gradient rows within 1e-3 of the largest, per crop. Each crop of the plain
batched route also equals its single-crop call bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdflabel_tpu.ops import splat as jsplat
from sdflabel_tpu.ops import splat_pallas
from sdflabel_tpu.renderer.rasterer import calibration_matrix
from sdflabel_tpu_torch.ops import splat_cuda

B = 3
RES = (64, 64)  # 4096 px: the auto policy bins by 512-px row blocks
MASKED = 1  # the crop whose points are all masked


def _scene(n, seed):
    """B crops of n points, a few masked, with the degenerate points of
    tests/test_torch_splat_binned.py (behind the camera, on its plane) in
    crop 0; each crop its own intrinsics; crop MASKED all masked."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    pts[..., 2] += 4.0 + 0.5 * np.arange(B)[:, None]
    pts[0, :4, 2] = np.array([-3.0, -0.01, 0.02, 0.0], np.float32)
    nrm = rng.randn(B, n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    feats = rng.uniform(0, 1, (B, n, 8)).astype(np.float32)
    mask = rng.uniform(size=(B, n)) > 0.1
    mask[MASKED] = False
    grid = np.asarray(jsplat.pixel_grid(*RES))
    kg = []
    for b in range(B):
        K = calibration_matrix(RES).astype(np.float32)
        K[0, 0] *= 1.0 + 0.1 * b
        K[1, 2] += 3.0 * b
        kg.append(np.concatenate([grid, np.ones((grid.shape[0], 1),
                                                np.float32)], 1)
                  @ np.linalg.inv(K).T)
    return pts, nrm, feats, mask, np.stack(kg).astype(np.float32)


@pytest.mark.parametrize("chunk", [1, 128])
def test_batched_bins_equal_vmapped_jax(chunk):
    n, bin_px = 256, 512
    pts, nrm, feats, mask, kg = _scene(n, 0)
    packed = [splat_pallas._pack(*map(jnp.asarray, (pts[b], nrm[b], mask[b],
                                                    feats[b], kg[b])),
                                 chunk, bin_px) for b in range(B)]
    jpts = jnp.stack([pk[0] for pk in packed])
    jkg = jnp.stack([pk[2] for pk in packed])
    order, sc, nc = (np.asarray(a) for a in jax.vmap(
        lambda p, k: splat_pallas._compute_bins(p, k, 0.04, bin_px, chunk))(
            jpts, jkg))
    tp = splat_cuda._pack_points(*map(torch.as_tensor, (pts, nrm, mask)))
    tkg = splat_cuda._pack_rays(torch.as_tensor(kg))
    bins = splat_cuda.compute_bins(tp, tkg, 0.04, bin_px, chunk)
    nb = RES[0] * RES[1] // bin_px
    assert bins.order.shape == (B, n) and bins.start.shape == (B, nb)
    assert bins.smax.shape == (B,)
    np.testing.assert_array_equal(bins.order.numpy(), order[:, :n])
    np.testing.assert_array_equal(bins.start.numpy(), sc)
    np.testing.assert_array_equal(bins.count.numpy(), nc)
    # each crop's own widest span, not the batch's: crop 0's degenerate
    # points touch every row block
    assert int(bins.smax[0]) == nb - 1 and int(bins.smax[2]) < nb - 1
    # the all-masked lane: every key past every window, empty windows
    assert int(bins.smax[MASKED]) == 0
    assert (bins.key[MASKED] == nb).all() and not bins.count[MASKED].any()
    for b in range(B):
        one = splat_cuda.compute_bins(tp[b], tkg[b], 0.04, bin_px, chunk)
        for f in one._fields:
            assert torch.equal(getattr(bins, f)[b], getattr(one, f)), f


def test_batched_windowed_matches_vmapped_binned_pallas():
    n = 256
    pts, nrm, feats, mask, kg = _scene(n, 1)
    g = np.random.RandomState(2).randn(B, kg.shape[1], 8).astype(np.float32)

    def jax_loss(p, nr, ft):
        img = jax.vmap(lambda a, b_, c, k, m: splat_pallas.surfel_composite(
            a, b_, c, k, point_mask=m, diam=0.04, bin_px=512))(
                p, nr, ft, jnp.asarray(kg), jnp.asarray(mask))
        return jnp.sum(img * g), img

    with pltpu.force_tpu_interpret_mode():
        (_, jimg), jgrads = jax.value_and_grad(
            jax_loss, (0, 1, 2), has_aux=True)(
                *map(jnp.asarray, (pts, nrm, feats)))
    ts = [torch.tensor(a, requires_grad=True) for a in (pts, nrm, feats)]
    img = splat_cuda.surfel_composite(*ts, torch.as_tensor(kg),
                                      torch.as_tensor(mask), 0.04)
    assert splat_cuda.bin_policy(kg.shape[1]) == 512
    assert img.shape == (B, kg.shape[1], 8)
    grads = torch.autograd.grad((img * torch.as_tensor(g)).sum(), ts)
    for b in range(B):
        px = np.abs(img[b].detach().numpy() - np.asarray(jimg[b])).max(-1)
        assert (px < 2e-4).mean() >= 0.995, (b, (px < 2e-4).mean())
        for t, j in zip(grads, jgrads):
            j = np.asarray(j[b])
            scale = max(np.abs(j).max(), 1e-6)
            rows = (np.abs(t[b].numpy() - j).max(-1) / scale) < 1e-3
            assert rows.mean() >= 0.99, (b, rows.mean())
    # the all-masked lane renders nothing and passes no gradient, as JAX's
    assert not img[MASKED].any() and not np.asarray(jimg[MASKED]).any()
    assert all(not t[MASKED].any() for t in grads)
    # each crop as the single-crop call gives it
    for b in range(B):
        one = [torch.tensor(a[b], requires_grad=True)
               for a in (pts, nrm, feats)]
        img_b = splat_cuda.surfel_composite(*one, torch.as_tensor(kg[b]),
                                            torch.as_tensor(mask[b]), 0.04)
        assert torch.equal(img[b], img_b)
        for t, t1 in zip(grads, torch.autograd.grad(
                (img_b * torch.as_tensor(g[b])).sum(), one)):
            assert torch.equal(t[b], t1)
