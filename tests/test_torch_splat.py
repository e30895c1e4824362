"""The port's splat (kernel 1's plain version) and renderer against
sdflabel_tpu's dense splat_surfel composite and its Pallas kernel in
interpret mode, forward and VJP to points, normals and features."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdflabel_tpu.ops import splat as jsplat
from sdflabel_tpu.ops import splat_pallas
from sdflabel_tpu.renderer import rasterer as jrast
from sdflabel_tpu_torch.ops import splat as tsplat
from sdflabel_tpu_torch.ops import splat_cuda
from sdflabel_tpu_torch.renderer import rasterer as trast


def _scene(n=300, seed=0, res=(24, 20)):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    feats = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.15
    K = jrast.calibration_matrix(res)
    return pts, normals, feats, mask, K, res


def _jax_dense(K, res, pts, normals, feats, mask):
    prob = jsplat.splat_surfel(
        jnp.asarray(K), jsplat.pixel_grid(*res), pts, normals,
        point_mask=jnp.asarray(mask), diam=0.04, softclamp=False,
        add_bg=False)
    return prob.T @ feats


def _loss(img, w):
    return (img * w).sum() + (img * img).sum()


def test_pixel_rays_match_jax():
    _, _, _, _, K, res = _scene()
    jg = np.asarray(jsplat.kinv_pixel_rays(jnp.asarray(K),
                                           jsplat.pixel_grid(*res)))
    tg = tsplat.kinv_pixel_rays(torch.as_tensor(K),
                                tsplat.pixel_grid(*res)).numpy()
    np.testing.assert_allclose(tg, jg, atol=1e-7)
    assert np.array_equal(tsplat.pixel_grid(*res).numpy(),
                          np.asarray(jsplat.pixel_grid(*res)))


def test_plain_composite_matches_jax_dense_forward_and_vjp():
    # same explicit footprint form on both sides: fp32 reassociation only,
    # atol 1e-5 on the image, 1e-4 relative on the gradients
    pts, normals, feats, mask, K, res = _scene()
    w = np.random.RandomState(5).randn(res[0] * res[1], 8).astype(np.float32)
    jl, jgrads = jax.value_and_grad(
        lambda a, b, c: _loss(_jax_dense(K, res, a, b, c, mask), w),
        argnums=(0, 1, 2))(*map(jnp.asarray, (pts, normals, feats)))
    args = [torch.as_tensor(a).requires_grad_(True)
            for a in (pts, normals, feats)]
    kg = tsplat.kinv_pixel_rays(torch.as_tensor(K), tsplat.pixel_grid(*res))
    img = splat_cuda.surfel_composite(*args, kg, torch.as_tensor(mask))
    want = np.asarray(_jax_dense(K, res, *map(jnp.asarray,
                                              (pts, normals, feats)), mask))
    np.testing.assert_allclose(img.detach().numpy(), want, atol=1e-5)
    tl = _loss(img, torch.as_tensor(w))
    tgrads = torch.autograd.grad(tl, args)
    for g, jg in zip(tgrads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg,
                                   atol=1e-4 * np.abs(jg).max())


def test_plain_composite_matches_interpret_mode_kernel():
    # the TPU kernel's expanded distance may flip a footprint bit at the
    # disc boundary: >= 99.5% of pixels within 2e-4 (its own test's rule)
    pts, normals, feats, mask, K, res = _scene(n=260, seed=3)
    kg = tsplat.kinv_pixel_rays(torch.as_tensor(K), tsplat.pixel_grid(*res))
    w = np.random.RandomState(6).randn(res[0] * res[1], 8).astype(np.float32)

    def jax_loss(a, b, c):
        img = splat_pallas.surfel_composite(
            a, b, c, jnp.asarray(kg.numpy()), point_mask=jnp.asarray(mask),
            diam=0.04, block_px=256)
        return _loss(img, w), img

    with pltpu.force_tpu_interpret_mode():
        (_, jimg), jgrads = jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2), has_aux=True)(
                *map(jnp.asarray, (pts, normals, feats)))
    args = [torch.as_tensor(a).requires_grad_(True)
            for a in (pts, normals, feats)]
    img = tsplat.surfel_composite_dense(*args, kg, torch.as_tensor(mask))
    err = np.abs(img.detach().numpy() - np.asarray(jimg)).max(-1)
    assert (err < 2e-4).mean() > 0.995, err.max()
    tgrads = torch.autograd.grad(_loss(img, torch.as_tensor(w)), args)
    for g, jg in zip(tgrads, jgrads):
        jg = np.asarray(jg)
        rows = np.abs(g.numpy() - jg).max(-1) / np.abs(jg).max()
        assert (rows < 1e-3).mean() > 0.99


def test_render_matches_jax_dense():
    rng = np.random.RandomState(1)
    n, res = 400, (20, 16)
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    nrm = rng.randn(n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mask = rng.uniform(size=n) > 0.2
    K = jrast.calibration_matrix(res)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.1, -0.05, 3.0]
    jr, jp = jrast.render(jnp.asarray(K), res, jnp.asarray(pts),
                          jnp.asarray(nrm), jnp.asarray(nrm),
                          jnp.asarray(pose), point_mask=jnp.asarray(mask),
                          rot="dcm", primitives="disc", output_nocs=True)
    tr, tp = trast.render(torch.as_tensor(K), res, torch.as_tensor(pts),
                          torch.as_tensor(nrm), torch.as_tensor(nrm),
                          torch.as_tensor(pose),
                          point_mask=torch.as_tensor(mask), rot="dcm",
                          primitives="disc", output_nocs=True)
    assert float(tr.mask.sum()) > 10  # something is on screen
    for f in jr._fields:
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), atol=1e-5)
    for f in jp._fields:
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), atol=1e-6)
    # the circle primitive, once refused, renders as JAX's does
    # (tests/test_torch_render_demo.py holds every primitive)
    jc, _ = jrast.render(jnp.asarray(K), res, jnp.asarray(pts),
                         jnp.asarray(nrm), jnp.asarray(nrm),
                         jnp.asarray(pose), rot="dcm", primitives="circle")
    tc, _ = trast.render(torch.as_tensor(K), res, torch.as_tensor(pts),
                         torch.as_tensor(nrm), torch.as_tensor(nrm),
                         torch.as_tensor(pose), rot="dcm",
                         primitives="circle")
    np.testing.assert_allclose(tc.color.numpy(), np.asarray(jc.color),
                               atol=1e-5)
    with pytest.raises(ValueError, match="unknown primitives"):
        trast.render(torch.as_tensor(K), res, torch.as_tensor(pts),
                     torch.as_tensor(nrm), torch.as_tensor(nrm),
                     torch.as_tensor(pose), primitives="square")
