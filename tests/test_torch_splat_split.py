"""A plain PyTorch model of the split dense splat forward (csrc/splat.cu,
splat_fwd_split_kernel) against the port's dense plain version and the
JAX package's dense splat.

The kernel splits the points into S contiguous slices of ceil(n / S)
points, one CTA each; in a CTA, thread k of a pixel takes the slice's
points k, k + T, ... Each thread's sum of squared footprint depths and its
online-softmax partial (m, d, acc) are merged over the threads in order,
then over the slices in rank order:
  zn = sqrt(sum_s ssq_s), m = max_s m_s, d = sum_s d_s e^(m_s - m),
  acc = sum_s acc_s e^(m_s - m), img = acc / d.
The model takes each subset's ssq and (m, d, acc) from the plain version's
formulas (ops/splat.py::surfel_prob) and merges them as the kernel does.
Only the order of the sums differs from the plain version, so the
tolerance is fp32 reassociation: the image to 1e-5, as the plain version
is held against JAX's dense splat (tests/test_torch_splat.py), and the
saved statistics m, d, zn to 1e-5 relative. The binned split forward
(splat_fwd_binned_split_kernel) runs the same tile over each row block's
window: its model is held against the windowed plain version at the same
tolerances and against JAX's binned Pallas kernels in interpret mode at
tests/test_torch_splat_binned.py's (>= 99.5% of pixels within 2e-4).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.ops import splat as jsplat
from sdflabel_tpu.ops import splat_pallas
from sdflabel_tpu.renderer import rasterer as jrast
from sdflabel_tpu_torch.ops import splat as tsplat
from sdflabel_tpu_torch.ops import splat_cuda

NEG_BIG = -1e30
EPS = torch.finfo(torch.float32).eps


def _pairs(points, normals, kg, mask, diam):
    """(z, footprint) of every (point, pixel) pair: the plain version's
    formulas (ops/splat.py::surfel_prob)."""
    n_kinv = normals @ kg.T
    n_kinv = torch.where(n_kinv.abs() < 0.01, torch.full_like(n_kinv, EPS),
                         n_kinv)
    z = (normals * points).sum(-1)[:, None] / n_kinv
    vec = points[:, None, :] - kg[None, :, :] * z[:, :, None]
    fp = (torch.sqrt((vec * vec).sum(-1)) < diam) & mask[:, None]
    return z, fp


def _merge(parts):
    """Online-softmax partials [(m, d, acc)] merged in order."""
    m = parts[0][0]
    for p in parts[1:]:
        m = torch.maximum(m, p[0])
    d = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for pm, pd, pacc in parts:
        w = torch.exp(pm - m)
        d = d + pd * w
        acc = acc + pacc * w[:, None]
    return m, d, acc


def _subsets(n, slices, threads):
    """Point indices of each slice's threads, as the kernel splits them."""
    per = -(-n // slices)
    out = []
    for s in range(slices):
        lo = min(n, s * per)
        hi = min(n, lo + per)
        out.append([torch.arange(min(lo + k, hi), hi, threads)
                    for k in range(threads)])
    return out


def split_composite(points, normals, feats, kg, mask, slices, threads=8,
                    diam=0.04, depth_constant=150.0):
    """The split forward's img (P, 8), m, d, zn (P,)."""
    z, fp = _pairs(points, normals, kg, mask, diam)
    groups = _subsets(points.shape[0], slices, threads)
    zz = torch.where(fp, z * z, torch.zeros_like(z))
    ssq = torch.zeros(kg.shape[0])
    for slice_ in groups:
        part = zz[slice_[0]].sum(0)
        for idx in slice_[1:]:
            part = part + zz[idx].sum(0)
        ssq = ssq + part
    zn = torch.sqrt(ssq)
    s = torch.clamp(-z / (zn + EPS) + 1.0, min=0.0) * depth_constant
    s = torch.where(fp, s, torch.full_like(s, NEG_BIG))

    def partial(idx):
        m = torch.full((kg.shape[0],), NEG_BIG)
        if len(idx):
            m = torch.maximum(m, s[idx].max(0).values)
        w = torch.where(fp[idx], torch.exp(s[idx] - m), torch.zeros(()))
        return m, w.sum(0), w.T @ feats[idx]

    m, d, acc = _merge([_merge([partial(i) for i in slice_])
                        for slice_ in groups])
    inv_d = torch.where(d > 0, 1.0 / d.clamp(min=1e-30), torch.zeros(()))
    return acc * inv_d[:, None], m, d, zn


def _scene(n, res=(24, 20), seed=0):
    """Seeded points in front of the camera, a few masked, and the
    pathological ones of tests/test_torch_splat_binned.py: behind the
    camera and on its plane."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    pts[:4, 2] = np.array([-3.0, -0.01, 0.02, 0.0], np.float32)[:n]
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    feats = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.15
    return pts, normals, feats, mask, jrast.calibration_matrix(res), res


def _statistics(points, normals, kg, mask, diam=0.04, dc=150.0):
    """The plain version's m, d, zn (the z-norm, max score and softmax
    denominator per pixel) from the same formulas, summed in point order."""
    z, fp = _pairs(points, normals, kg, mask, diam)
    zn = torch.linalg.norm(torch.where(fp, -z, torch.zeros_like(z)), dim=0)
    s = torch.where(fp, torch.clamp(-z / (zn + EPS) + 1.0, min=0.0) * dc,
                    torch.full_like(z, NEG_BIG))
    m = s.max(0).values
    d = torch.where(fp, torch.exp(s - m), torch.zeros(())).sum(0)
    return m, d, zn


@pytest.mark.parametrize("n,slices,empty_slice", [
    (301, 1, None),  # one CTA per tile: the threads' merge alone
    (301, 3, 1),     # 101 points a slice; slice 1 has no footprint pair
    (301, 8, 2),     # 38 points a slice, the last one 35
    (10, 8, None),   # 2 points a slice: slices 5 to 7 have none
])
def test_split_merge_matches_plain_and_jax(n, slices, empty_slice):
    pts, normals, feats, mask, K, res = _scene(n, seed=n + slices)
    if empty_slice is not None:
        per = -(-n // slices)
        mask[empty_slice * per:(empty_slice + 1) * per] = False
    t = [torch.as_tensor(a) for a in (pts, normals, feats, mask)]
    kg = tsplat.kinv_pixel_rays(torch.as_tensor(K), tsplat.pixel_grid(*res))
    img, m, d, zn = split_composite(*t[:3], kg, t[3], slices)
    plain = tsplat.surfel_composite_dense(*t[:3], kg, t[3])
    prob = jsplat.splat_surfel(
        jnp.asarray(K), jsplat.pixel_grid(*res), pts, normals,
        point_mask=jnp.asarray(mask), diam=0.04, softclamp=False,
        add_bg=False)
    want = np.asarray(prob.T @ feats)
    assert bool((plain != 0).any())  # some pixels are covered
    torch.testing.assert_close(img, plain, atol=1e-5, rtol=0)
    np.testing.assert_allclose(img.numpy(), want, atol=1e-5)
    # what the backward reads keeps its meaning
    for got, ref in zip((m, d, zn), _statistics(*t[:2], kg, t[3])):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("slices", [1, 8])
def test_split_merge_of_no_footprint_pair_is_zero(slices):
    # every slice empty: m = NEG_BIG, d = 0 merge to the zero image
    pts, normals, feats, mask, K, res = _scene(200, seed=4)
    kg = tsplat.kinv_pixel_rays(torch.as_tensor(K), tsplat.pixel_grid(*res))
    img, m, d, zn = split_composite(
        torch.as_tensor(pts), torch.as_tensor(normals),
        torch.as_tensor(feats), kg, torch.zeros(200, dtype=torch.bool),
        slices)
    assert torch.all(img == 0) and torch.all(d == 0) and torch.all(zn == 0)
    assert torch.all(m == NEG_BIG)


# The binned split forward (splat_fwd_binned_split_kernel): the same tile
# over each row block's window of the points sorted by row block
# (ops/splat_cuda.py::compute_bins, which the bins kernel equals), the
# window split into S contiguous slices of ceil(len / S) points.

def binned_split_composite(points, normals, feats, kg, mask, bin_px,
                           slices, diam=0.04):
    """The binned split forward's img (P, 8), m, d, zn (P,), each row block
    from split_composite over its window, and the plain windowed version's
    statistics (_statistics over each window)."""
    bins = splat_cuda.compute_bins(
        splat_cuda._pack_points(points, normals, mask),
        splat_cuda._pack_rays(kg), diam, bin_px)
    o = bins.order
    v, nrm, f, msk = points[o], normals[o], feats[o], mask[o]
    out, stats = [], []
    for b, (s, c) in enumerate(zip(bins.start.tolist(),
                                   bins.count.tolist())):
        rays = kg[b * bin_px:(b + 1) * bin_px]
        win = slice(s, s + c)
        out.append(split_composite(v[win], nrm[win], f[win], rays, msk[win],
                                   slices, diam=diam))
        stats.append(_statistics(v[win], nrm[win], rays, msk[win], diam))
    return ([torch.cat(t) for t in zip(*out)],
            [torch.cat(t) for t in zip(*stats)])


def _jax_binned_image(pts, normals, feats, mask, kg, bin_px):
    with _interpret_ctx():
        return np.asarray(splat_pallas.surfel_composite(
            jnp.asarray(pts), jnp.asarray(normals), jnp.asarray(feats),
            jnp.asarray(kg), point_mask=jnp.asarray(mask), diam=0.04,
            bin_px=bin_px))


def _interpret_ctx():
    if jax.default_backend() == "tpu":
        return contextlib.nullcontext()
    from jax.experimental.pallas import tpu as pltpu

    return pltpu.force_tpu_interpret_mode()


@pytest.mark.parametrize("n,res,slices,degenerate", [
    (420, (64, 64), 1, False),    # one CTA a tile: the threads' merge alone
    (420, (64, 64), 3, False),
    (420, (64, 64), 8, True),     # a degenerate point stretches every window
    (380, (200, 100), 2, True),   # ragged last row block
])
def test_binned_split_merge_matches_windowed_plain_and_jax(n, res, slices,
                                                           degenerate):
    pts, normals, feats, mask, K, _ = _scene(n, res, seed=n + slices)
    if not degenerate:
        pts[:4, 2] = np.float32(4.0)
    t = [torch.as_tensor(a) for a in (pts, normals, feats, mask)]
    kg = tsplat.kinv_pixel_rays(torch.as_tensor(K), tsplat.pixel_grid(*res))
    (img, m, d, zn), stats = binned_split_composite(*t[:3], kg, t[3], 512,
                                                    slices)
    bins = splat_cuda.compute_bins(splat_cuda._pack_points(*t[:2], t[3]),
                                   splat_cuda._pack_rays(kg), 0.04, 512)
    nb = bins.count.shape[0]
    assert (int(bins.smax) == nb - 1) == degenerate
    plain = splat_cuda.surfel_composite_windowed(*t[:3], kg, t[3],
                                                 bin_px=512)
    assert bool((plain != 0).any())  # some pixels are covered
    torch.testing.assert_close(img, plain, atol=1e-5, rtol=0)
    for got, ref in zip((m, d, zn), stats):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    # against JAX's binned kernels: their expanded footprint test may flip
    # a pair at a disc edge
    want = _jax_binned_image(pts, normals, feats, mask, kg.numpy(), 512)
    px = np.abs(img.numpy() - want).max(-1)
    assert (px < 2e-4).mean() >= 0.995, (px < 2e-4).mean()
