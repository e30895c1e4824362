"""The port's kernels with a crop axis, as the batched driver calls them,
against jax.vmap of the JAX kernels in interpret mode (the way their own
tests run on the CPU): the splat composite forward and VJP (kernels 1a,
1b), the nearest neighbour (2) and the selection MLP with a latent per
crop (3); each plain batched version also equals its single-crop plain
version crop by crop, bit for bit. Then the batched render and losses the
loop builds on, against jax.vmap of the JAX functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdflabel_tpu.engine import losses as jlosses
from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.ops import mlp_pallas, nn_pallas
from sdflabel_tpu.ops import splat as jsplat
from sdflabel_tpu.ops import splat_pallas
from sdflabel_tpu.renderer import rasterer as jrast
from sdflabel_tpu_torch.engine import losses as tlosses
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.ops import knn as tknn
from sdflabel_tpu_torch.ops import mlp_cuda
from sdflabel_tpu_torch.ops import splat as tsplat
from sdflabel_tpu_torch.ops import splat_cuda
from sdflabel_tpu_torch.renderer import rasterer as trast
from torch_parity_util import jax_tree_to_numpy

B = 3
RES = (24, 16)  # (x, y): 16 x 24 px


def _splat_batch(n=260, seed=0):
    """B crops of n surfels, each with its own intrinsics and rays."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    pts[..., 2] += 4.0 + np.arange(B)[:, None]
    nrm = rng.randn(B, n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    feats = rng.uniform(0, 1, (B, n, 8)).astype(np.float32)
    mask = rng.uniform(size=(B, n)) > 0.15
    Ks = []
    for b in range(B):
        K = jrast.calibration_matrix(RES)
        K[0, 0] *= 1.0 + 0.1 * b
        K[0, 2] += 0.5 * b
        Ks.append(K)
    kg = tsplat.kinv_pixel_rays(torch.as_tensor(np.stack(Ks)),
                                tsplat.pixel_grid(*RES)).numpy()
    return pts, nrm, feats, mask, kg


def _loss(img, w):
    return (img * w).sum() + (img * img).sum()


def test_batched_rays_are_each_crops_rays():
    _, _, _, _, kg = _splat_batch()
    Ks = [jrast.calibration_matrix(RES) for _ in range(B)]
    one = tsplat.kinv_pixel_rays(torch.as_tensor(Ks[0]),
                                 tsplat.pixel_grid(*RES)).numpy()
    np.testing.assert_allclose(kg[0], one, atol=1e-7)
    assert kg.shape == (B, RES[0] * RES[1], 3)


def test_batched_splat_matches_vmapped_interpret_mode_kernel():
    # the TPU kernel's expanded distance may flip a footprint bit at the
    # disc boundary: >= 99.5% of pixels within 2e-4 and >= 99% of gradient
    # rows within 1e-3 of the largest, per crop (the single-crop tests'
    # rules)
    pts, nrm, feats, mask, kg = _splat_batch()
    w = np.random.RandomState(6).randn(B, kg.shape[1], 8).astype(np.float32)

    def jax_loss(a, b, c):
        img = jax.vmap(lambda a, b, c, k, m: splat_pallas.surfel_composite(
            a, b, c, k, point_mask=m, diam=0.04, block_px=256))(
                a, b, c, jnp.asarray(kg), jnp.asarray(mask))
        return _loss(img, w), img

    with pltpu.force_tpu_interpret_mode():
        (_, jimg), jgrads = jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2), has_aux=True)(
                *map(jnp.asarray, (pts, nrm, feats)))
    args = [torch.as_tensor(a).requires_grad_(True)
            for a in (pts, nrm, feats)]
    img = splat_cuda.surfel_composite(*args, torch.as_tensor(kg),
                                      torch.as_tensor(mask))
    assert img.shape == (B, kg.shape[1], 8)
    tgrads = torch.autograd.grad(_loss(img, torch.as_tensor(w)), args)
    for b in range(B):
        err = np.abs(img[b].detach().numpy() - np.asarray(jimg[b])).max(-1)
        assert (err < 2e-4).mean() > 0.995, (b, err.max())
        for g, jg in zip(tgrads, jgrads):
            jg = np.asarray(jg[b])
            rows = np.abs(g[b].numpy() - jg).max(-1) / np.abs(jg).max()
            assert (rows < 1e-3).mean() > 0.99, b


def test_batched_splat_plain_equals_single_crop_calls():
    pts, nrm, feats, mask, kg = _splat_batch(seed=1)
    args = [torch.as_tensor(a).requires_grad_(True)
            for a in (pts, nrm, feats)]
    img = splat_cuda.surfel_composite(*args, torch.as_tensor(kg),
                                      torch.as_tensor(mask))
    g = torch.randn_like(img)
    grads = torch.autograd.grad(img, args, g)
    for b in range(B):
        one = [torch.as_tensor(a[b]).requires_grad_(True)
               for a in (pts, nrm, feats)]
        img_b = splat_cuda.surfel_composite(*one, torch.as_tensor(kg[b]),
                                            torch.as_tensor(mask[b]))
        assert torch.equal(img[b], img_b)
        for gb, g1 in zip(grads, torch.autograd.grad(img_b, one, g[b])):
            assert torch.equal(gb[b], g1)


def _tied(seed, n=300, m=400):
    # coordinates on a 0.25 lattice: many exactly equal distances
    rng = np.random.RandomState(seed)
    q = rng.randint(-3, 4, (B, n, 3)).astype(np.float32) * 0.25
    d = rng.randint(-3, 4, (B, m, 3)).astype(np.float32) * 0.25
    mask = rng.uniform(size=(B, m)) > 0.3
    mask[1] = False  # a crop with no valid data point
    return q, d, mask


def test_batched_nn_matches_vmapped_interpret_mode_kernel_bitwise():
    q, d, mask = _tied(3)
    with pltpu.force_tpu_interpret_mode():
        jd, ji = jax.vmap(lambda a, b, c: nn_pallas.nearest_neighbor_fused(
            a, b, c, qb=256, mb=256))(*map(jnp.asarray, (q, d, mask)))
    td, ti = tknn.nearest_neighbor(*map(torch.as_tensor, (q, d, mask)))
    assert ti.shape == (B, q.shape[1])
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    live = np.asarray(jd) < 1e14  # JAX's masked sentinel; the port's inf
    assert np.array_equal(td.numpy()[live], np.asarray(jd)[live])
    assert np.isinf(td.numpy()[~live]).all() and (~live[1]).all()
    for b in range(B):
        db, ib = tknn.nearest_neighbor(*(torch.as_tensor(a[b])
                                         for a in (q, d, mask)))
        assert torch.equal(ti[b], ib) and torch.equal(td[b], db)


@pytest.fixture(scope="module")
def select_net():
    spec = dict(latent_size=3, dims=(128,) * 8, norm_layers=tuple(range(8)),
                latent_in=(4,), weight_norm=True)
    jcfg = jds.DeepSDFConfig(**spec)
    jparams = jds.init_params(jcfg, jax.random.PRNGKey(128))
    jp = mlp_pallas.pack_select_mlp(jcfg, jparams)
    # the arithmetic on one pack: the JAX package's, carried across
    tp = mlp_cuda.PackedSelectMLP(
        *(torch.as_tensor(np.asarray(getattr(jp, f), np.float32)).to(
            torch.bfloat16 if f == "ws" else torch.float32)
          for f in ("ws", "wx", "wlat", "bias", "wlast", "scal")),
        width=jp.width, n_hidden=jp.n_hidden, use_tanh=jp.use_tanh)
    return jp, tp


@pytest.mark.parametrize("shared", [True, False])
def test_batched_select_matches_vmapped_jax(select_net, shared):
    # a latent per crop, the points shared by every crop (the refresh's
    # grid) or each crop's own; same bf16 operands and fp32 accumulation,
    # sums in another order: max 1e-3 and median 1e-5 (the single-crop
    # test's rule)
    jp, tp = select_net
    rng = np.random.RandomState(2)
    pts = rng.uniform(-1, 1, (500, 3) if shared else (B, 500, 3)).astype(
        np.float32)
    lat = rng.randn(B, 3).astype(np.float32)
    lat /= np.linalg.norm(lat, axis=-1, keepdims=True)
    axes = (0, None) if shared else (0, 0)
    want = np.asarray(jax.vmap(lambda la, p: mlp_pallas.emulate_select_mlp(
        jp, la, p), in_axes=axes)(jnp.asarray(lat), jnp.asarray(pts)))
    with pltpu.force_tpu_interpret_mode():
        kern = np.asarray(jax.vmap(lambda la, p: mlp_pallas.select_mlp_apply(
            jp, la, p, block=256), in_axes=axes)(jnp.asarray(lat),
                                                 jnp.asarray(pts)))
    got = mlp_cuda.select_mlp_apply(tp, torch.as_tensor(lat),
                                    torch.as_tensor(pts))
    assert got.shape == (B, 500)
    for ref in (want, kern):
        err = np.abs(got.numpy() - ref)
        assert err.max() < 1e-3 and np.median(err) < 1e-5, (err.max(),
                                                             np.median(err))
    cvec = mlp_cuda._cvec(tp, torch.as_tensor(lat))
    for b in range(B):
        one = mlp_cuda.select_mlp_apply(
            tp, torch.as_tensor(lat[b]),
            torch.as_tensor(pts if shared else pts[b]))
        assert torch.equal(got[b], one)
        assert torch.equal(cvec[b], mlp_cuda._cvec(tp,
                                                   torch.as_tensor(lat[b])))


def test_batched_render_matches_vmapped_jax():
    rng = np.random.RandomState(4)
    n = 300
    pts = rng.uniform(-0.5, 0.5, (B, n, 3)).astype(np.float32)
    nrm = rng.randn(B, n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    mask = rng.uniform(size=(B, n)) > 0.2
    Ks = np.stack([jrast.calibration_matrix(RES) * np.array(
        [[1 + 0.05 * b], [1], [1]], np.float32) for b in range(B)])
    Ks[:, 2] = [0, 0, 1]
    pose = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    pose[:, :3, 3] = [[0.1, -0.05, 3.0], [0.0, 0.05, 3.5], [-0.1, 0.0, 2.8]]
    jr, jp = jax.vmap(lambda k, p, nn, ps, m: jrast.render(
        k, RES, p, nn, nn, ps, point_mask=m, rot="dcm", primitives="disc",
        output_nocs=True))(*map(jnp.asarray, (Ks, pts, nrm, pose, mask)))
    tr, tp = trast.render(*map(torch.as_tensor, (Ks,)), RES,
                          torch.as_tensor(pts), torch.as_tensor(nrm),
                          torch.as_tensor(nrm), torch.as_tensor(pose),
                          point_mask=torch.as_tensor(mask), rot="dcm",
                          primitives="disc", output_nocs=True)
    assert tr.color.shape == (B, 3, RES[1], RES[0])
    assert (tr.mask.sum((1, 2, 3)) > 10).all()  # every crop has an image
    for f in jr._fields:
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   np.asarray(getattr(jr, f)), atol=1e-5,
                                   err_msg=f)
    for f in jp._fields:
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), atol=1e-6,
                                   err_msg=f)


@pytest.mark.parametrize("windowed", [False, True])
def test_batched_losses_match_vmapped_jax(windowed):
    # each crop its own pixel mask (one letterboxed, one empty: loss 0, one
    # whose target no minimum reaches: NaN, QUIRKS #6) and its own frustum
    rng = np.random.RandomState(5)
    h, w = 12, 10
    rend = rng.uniform(0, 1, (B, 3, h, w)).astype(np.float32)
    rend[:, :, :3] = 0.0  # rows with nothing rendered
    css = rng.uniform(0, 1, (B, 3, h, w)).astype(np.float32)
    css[2] = 40.0
    pm = np.ones((B, h, w), bool)
    pm[0, :, 7:] = False
    pm[1] = False
    pm[2] = False
    pm[2, 5:8, 4:7] = True
    jl2 = jax.vmap(lambda r, c, m: jlosses.loss_2d(
        r, c, pixel_mask=m, windowed=windowed))(
            *map(jnp.asarray, (rend, css, pm)))
    tl2 = tlosses.loss_2d(*map(torch.as_tensor, (rend, css)),
                          pixel_mask=torch.as_tensor(pm), windowed=windowed)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-5)
    assert tl2[1] == 0 and torch.isnan(tl2[2]) and torch.isfinite(tl2[0])
    for b in range(B):
        one = tlosses.loss_2d(torch.as_tensor(rend[b]),
                              torch.as_tensor(css[b]),
                              pixel_mask=torch.as_tensor(pm[b]),
                              windowed=windowed)
        np.testing.assert_allclose(float(one), float(tl2[b]), rtol=1e-6)

    n, m = 200, 300
    rp = rng.randn(B, n, 3).astype(np.float32)
    rm = rng.uniform(size=(B, n)) > 0.3
    fr = rng.randn(B, m, 3).astype(np.float32)
    fm = rng.uniform(size=(B, m)) > 0.2
    scale = np.array([[1.5], [2.0], [0.5]], np.float32)
    jl3, jg = jax.vmap(jax.value_and_grad(
        lambda p, f, fmk, s, r: jlosses.loss_3d(p, r, f / s.reshape(()),
                                                fmk, s)[()],
        argnums=(0, 3)))(*map(jnp.asarray, (rp, fr, fm, scale, rm)))
    tp_, ts = (torch.as_tensor(a).requires_grad_(True) for a in (rp, scale))
    tl3 = tlosses.loss_3d(tp_, torch.as_tensor(rm),
                          torch.as_tensor(fr) / ts[:, None, :],
                          torch.as_tensor(fm), ts)
    np.testing.assert_allclose(tl3.detach().numpy(), np.asarray(jl3),
                               rtol=1e-5)
    for g, want in zip(torch.autograd.grad(tl3.sum(), (tp_, ts)), jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
