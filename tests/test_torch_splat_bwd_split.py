"""A plain PyTorch model of the split dense splat backward (csrc/splat.cu,
splat_bwd_split_kernel) against the port's plain autograd and the JAX
package's dense splat VJP.

The kernel splits the pixels into S contiguous slices of ceil(P / S) rows,
one CTA each, for a block of points. A CTA stages its slice in chunks of
BSPLIT_CAP rows; group g of its T warp groups takes the g-th contiguous
part, ceil(cn / T) rows, of each chunk of cn rows. Each thread sums its
point's per-pair terms (PointGrads: dnv_sum, dnk . g, and the feature
gradient) over its rows; the T partials are added in warp order, then the
S ranks' sums in rank order. The model takes every pair's terms from the
kernel's formulas (PointGrads::add, the same as the chain rule of
ops/splat.py::surfel_prob) and sums them in that order. Only the order of
the sums over pixels differs from the plain version, so the tolerance is
fp32 reassociation: each gradient within 1e-4 of its largest magnitude,
the tolerance at which tests/test_torch_splat.py holds the plain version
against JAX's dense splat. Against JAX's VJP itself the rule of the
interpret-mode test there: > 99% of gradient rows within 1e-3 of the
largest, because XLA may round a score at its clamp to x = 0 where the
plain version gets a last-ulp x > 0, or the other way, and so pass or
stop one pair's gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.ops import splat as jsplat
from sdflabel_tpu.renderer import rasterer as jrast
from sdflabel_tpu_torch.ops import splat as tsplat

EPS = torch.finfo(torch.float32).eps
NEG_BIG = -1e30
CAP = 256  # BSPLIT_CAP: pixel rows staged at once


def pair_terms(points, normals, feats, kg, mask, g, diam=0.04, dc=150.0):
    """Every (point, pixel) pair's PointGrads terms, (N, P) each: dnv, the
    three dnk * g_ray, and the eight prob * g_img, by PointGrads::add's
    chain rule from the plain version's forward: its statistics m, d, zn,
    its softmax correction and its score x. A guarded pair (|n . g| < 0.01) passes
    no gradient, as in the kernel."""
    n_kinv_raw = normals @ kg.T
    guard = n_kinv_raw.abs() < 0.01
    nk = torch.where(guard, torch.full_like(n_kinv_raw, EPS), n_kinv_raw)
    z = (normals * points).sum(-1)[:, None] / nk
    vec = points[:, None, :] - kg[None, :, :] * z[:, :, None]
    fp = (torch.sqrt((vec * vec).sum(-1)) < diam) & mask[:, None]
    zn = torch.linalg.norm(torch.where(fp, -z, torch.zeros_like(z)), dim=0)
    inv_zn = 1.0 / (zn + EPS)
    # the plain version's rounding of the score: at a pixel with a single
    # footprint point it gives x = 0 exactly, and no gradient
    x = -z / (zn + EPS) + 1.0
    s = torch.clamp(x, min=0.0) * dc
    m = torch.where(fp, s, torch.full_like(s, NEG_BIG)).max(0).values
    e = torch.where(fp, torch.exp(s - m), torch.zeros(()))
    d = e.sum(0)
    inv_d = torch.where(d > 0, 1.0 / d.clamp(min=1e-30), torch.zeros(()))
    prob = e * inv_d
    u = feats @ g.T  # (N, P): f_i . g_p
    # the softmax correction as the plain backward sums it; the kernel
    # reads g . img, equal but for rounding, which at a pixel of a single
    # footprint point (prob 1) leaves a last-ulp ds that the card tests'
    # share tolerance covers
    corr = (prob * u).sum(0)
    live = fp & (x > 0) & ~guard
    ds = torch.where(live, prob * (u - corr), torch.zeros(()))
    dz = -(ds * dc) * inv_zn
    dnv = dz / nk
    dnk = -dnv * z
    return [dnv] + [dnk * kg[:, c] for c in range(3)] + [
        prob * g[:, f] for f in range(8)]


def _rows(p, slices, groups):
    """Each rank's groups' pixel rows, in the kernel's order."""
    per = -(-p // slices)
    out = []
    for r in range(slices):
        lo = min(p, r * per)
        hi = min(p, lo + per)
        parts = [[] for _ in range(groups)]
        for c0 in range(lo, hi, CAP):
            cn = min(CAP, hi - c0)
            sub = -(-cn // groups)
            for g in range(groups):
                parts[g].extend(range(c0 + min(cn, g * sub),
                                      c0 + min(cn, g * sub + sub)))
        out.append(parts)
    return out


def split_backward(points, normals, feats, kg, mask, g, slices, groups=4):
    """The split backward's d_points, d_normals, d_features."""
    terms = pair_terms(points, normals, feats, kg, mask, g)
    total = None
    for parts in _rows(kg.shape[0], slices, groups):
        cta = None
        for rows in parts:
            idx = torch.as_tensor(rows, dtype=torch.long)
            part = [t[:, idx].sum(1) for t in terms]
            cta = part if cta is None else [a + b for a, b in zip(cta, part)]
        total = cta if total is None else [a + b
                                           for a, b in zip(total, cta)]
    dnv, dnk = total[0], torch.stack(total[1:4], 1)
    return (dnv[:, None] * normals, dnv[:, None] * points + dnk,
            torch.stack(total[4:], 1))


def _scene(n, res, seed, spread=1.0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    pts[:3, 2] = np.array([-3.0, 0.0, 0.02], np.float32)[:min(n, 3)]
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    feats = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.15
    g = rng.randn(res[0] * res[1], 8).astype(np.float32)
    return pts, normals, feats, mask, g, jrast.calibration_matrix(res)


def _jax_vjp(K, res, pts, normals, feats, mask, g):
    def img(a, b, c):
        prob = jsplat.splat_surfel(
            jnp.asarray(K), jsplat.pixel_grid(*res), a, b,
            point_mask=jnp.asarray(mask), diam=0.04, softclamp=False,
            add_bg=False)
        return prob.T @ c

    _, vjp = jax.vjp(img, *map(jnp.asarray, (pts, normals, feats)))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("n,res,slices,empty,spread", [
    (301, (24, 20), 1, None, 1.0),  # one CTA a point block: the groups
    (301, (24, 20), 2, None, 1.0),  # 240 rows a slice
    (301, (24, 20), 3, 2, 1.0),     # 160 rows a slice; slice 2 meets none
    (301, (30, 27), 8, None, 1.0),  # ragged: 102 rows a slice, the last 96
    (40, (24, 20), 8, None, 0.1),   # fewer points than a block of 64
    (120, (32, 33), 1, None, 1.0),  # 1056 rows: chunks of 256, the last 32
])
def test_split_backward_matches_plain_and_jax(n, res, slices, empty, spread):
    # 40 points spread over +-0.1 overlap: a pixel of one footprint point
    # alone passes no gradient to its geometry
    pts, normals, feats, mask, g, K = _scene(n, res, seed=n + slices,
                                            spread=spread)
    t = [torch.as_tensor(a) for a in (pts, normals, feats, mask, g)]
    kg = tsplat.kinv_pixel_rays(torch.as_tensor(K), tsplat.pixel_grid(*res))
    if empty is not None:  # the slice's rows see no footprint
        per = -(-kg.shape[0] // slices)
        kg[empty * per:(empty + 1) * per, :2] += 10.0
    got = split_backward(*t[:3], kg, t[3], t[4], slices)
    args = [a.clone().requires_grad_(True) for a in t[:3]]
    img = tsplat.surfel_composite_dense(*args, kg, t[3])
    assert float(img[:, 3].detach().sum()) > 1.0  # some pixels are covered
    plain = torch.autograd.grad(img, args, t[4])
    if empty is None:
        want_jax = _jax_vjp(K, res, pts, normals, feats, mask, g)
    else:  # JAX's rays are the camera's: hold the plain version only
        want_jax = [w.numpy() for w in plain]
    for a, b, c in zip(got, plain, want_jax):
        scale = float(b.abs().max())
        assert scale > 0
        torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=0)
        rows = np.abs(a.numpy() - c).max(-1) / scale
        assert (rows < 1e-3).mean() > 0.99, rows.max()


def test_split_rows_cover_every_pixel_once():
    # the rank and group partition of the kernel: every row exactly once
    for p, slices in ((1024, 8), (1056, 1), (810, 8), (10, 8), (540, 3)):
        rows = [r for parts in _rows(p, slices, 4) for grp in parts
                for r in grp]
        assert sorted(rows) == list(range(p))
