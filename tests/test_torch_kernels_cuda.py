"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs an NVIDIA card and nvcc and skips elsewhere. On a machine
with the card and without JAX, run them as
  python -m pytest tests/test_torch_kernels_cuda.py --noconftest \
      -o addopts="" -p no:cacheprovider
"""

import os

import numpy as np
import pytest
import torch

from sdflabel_tpu_torch.engine import refine
from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import (ce_cuda, grid, knn, mlp2_cuda, mlp_cuda,
                                    nn_cuda, splat, splat_cuda)
from sdflabel_tpu_torch.renderer import rasterer
from sdflabel_tpu_torch.renderer.rasterer import calibration_matrix

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _splat_scene(dev, n=3000, res=(32, 32), seed=0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    feats = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.2
    K = torch.as_tensor(calibration_matrix(res), device=dev)
    kg = splat.kinv_pixel_rays(K, splat.pixel_grid(*res, device=dev))
    t = [torch.as_tensor(a, device=dev) for a in (pts, normals, feats, mask)]
    return (*t, kg)


def test_splat_forward_and_backward_match_plain(dev):
    # footprint bits may flip at the disc boundary between the two
    # roundings (ops/splat_cuda.py): allow 0.5% of pixels / 1% of points
    pts, nrm, feats, mask, kg = _splat_scene(dev)
    args = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_k = splat_cuda.surfel_composite(*args, kg, mask)
    g = torch.randn_like(img_k)
    gk = torch.autograd.grad((img_k * g).sum(), args)
    args_p = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_p = splat.surfel_composite_dense(*args_p, kg, mask)
    gp = torch.autograd.grad((img_p * g).sum(), args_p)
    torch.cuda.synchronize()
    assert splat_cuda.SPLAT_FWD.launches > 0
    assert splat_cuda.SPLAT_BWD.launches > 0
    err = (img_k - img_p).abs().max(-1).values
    assert (err < 1e-4).float().mean() > 0.995, err.max()
    for a, b in zip(gk, gp):
        scale = b.abs().max().clamp(min=1e-6)
        close = ((a - b).abs().max(-1).values / scale) < 1e-3
        assert close.float().mean() > 0.99


def test_splat_empty_mask_is_zero(dev):
    pts, nrm, feats, mask, kg = _splat_scene(dev, n=500)
    img = splat_cuda.surfel_composite(pts, nrm, feats, kg,
                                      torch.zeros_like(mask))
    assert torch.all(img == 0)


def test_nn_matches_plain_bitwise_with_ties_and_masks(dev):
    rng = np.random.RandomState(1)
    q = rng.randint(-4, 5, (3000, 3)).astype(np.float32) * 0.25
    d = rng.randint(-4, 5, (2500, 3)).astype(np.float32) * 0.25  # many ties
    m = rng.uniform(size=2500) > 0.3
    q, d, m = (torch.as_tensor(a, device=dev) for a in (q, d, m))
    dk, ik = nn_cuda.nearest_neighbor_fused(q, d, m)
    dp, ip = knn.nearest_neighbor_plain(q, d, m)
    assert torch.equal(ik, ip)
    assert torch.equal(dk, dp)
    # fully masked data: index 0, public distance inf
    dist, idx = knn.nearest_neighbor(q, d, torch.zeros_like(m))
    assert torch.all(idx == 0) and torch.all(torch.isinf(dist))


@pytest.mark.parametrize("width,n", [(128, 5000), (512, 20000)])
def test_select_mlp_matches_plain(dev, width, n):
    cfg = deepsdf.DeepSDFConfig(
        latent_size=3, dims=(width,) * 8, norm_layers=tuple(range(8)),
        latent_in=(4,), weight_norm=True)
    gen = torch.Generator().manual_seed(0)
    params = deepsdf.init_params(cfg, gen, device=dev)
    packed = mlp_cuda.pack_select_mlp(cfg, deepsdf.cast_params(
        params, torch.bfloat16))
    pts = (torch.rand(n, 3, generator=gen) * 2 - 1).to(dev)
    lat = torch.tensor([0.3, -0.5, 0.8], device=dev)
    out_k = mlp_cuda.select_mlp_apply(packed, lat, pts)
    out_p = mlp_cuda.emulate_select_mlp(packed, lat, pts)
    torch.cuda.synchronize()
    # same bf16 operands, fp32 accumulation in another order; a last-ulp
    # difference can flip one activation's bf16 rounding (2^-8 relative)
    err = (out_k - out_p).abs()
    assert err.max() < 1e-3 and err.median() < 1e-5, (err.max(),
                                                       err.median())


@pytest.mark.parametrize("res,n", [((64, 64), 3000), ((200, 100), 2000),
                                   ((128, 128), 4096)])
def test_binned_splat_matches_windowed_plain(dev, res, n):
    # same tolerance as the dense kernel: boundary bits may flip between
    # the expanded and the explicit distance; sums run in sorted order
    pts, nrm, feats, mask, kg = _splat_scene(dev, n=n, res=res)
    pts[:3, 2] = torch.tensor([-3.0, 0.0, 0.02], device=dev)  # degenerate
    assert splat_cuda.bin_policy(kg.shape[0]) == 512
    fwd0 = splat_cuda.SPLAT_FWD_BINNED.launches
    bwd0 = splat_cuda.SPLAT_BWD_BINNED.launches
    args = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_k = splat_cuda.surfel_composite(*args, kg, mask)
    g = torch.randn_like(img_k)
    gk = torch.autograd.grad((img_k * g).sum(), args)
    args_p = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_p = splat_cuda.surfel_composite_windowed(*args_p, kg, mask)
    gp = torch.autograd.grad((img_p * g).sum(), args_p)
    torch.cuda.synchronize()
    assert splat_cuda.SPLAT_FWD_BINNED.launches == fwd0 + 1
    assert splat_cuda.SPLAT_BWD_BINNED.launches == bwd0 + 1
    err = (img_k - img_p).abs().max(-1).values
    assert (err < 2e-4).float().mean() >= 0.995, err.max()
    for a, b in zip(gk, gp):
        scale = b.abs().max().clamp(min=1e-6)
        close = ((a - b).abs().max(-1).values / scale) < 1e-3
        assert close.float().mean() >= 0.99


def test_binned_splat_matches_dense_kernel(dev):
    # both kernels take the same expanded footprint test: only the order
    # of the sums differs (fp32 reassociation)
    pts, nrm, feats, mask, kg = _splat_scene(dev, n=4096, res=(128, 128))
    args = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_b = splat_cuda.surfel_composite(*args, kg, mask, bin_px=512)
    g = torch.randn_like(img_b)
    gb = torch.autograd.grad((img_b * g).sum(), args)
    img_d = splat_cuda.surfel_composite(*args, kg, mask, bin_px=0)
    gd = torch.autograd.grad((img_d * g).sum(), args)
    torch.cuda.synchronize()
    assert (img_b - img_d).abs().max() < 2e-5
    for a, b in zip(gb, gd):
        scale = b.abs().max().clamp(min=1e-6)
        assert ((a - b).abs() / scale).max() < 2e-4


@pytest.mark.parametrize("c", [2, 256])
def test_ce_matches_plain(dev, c):
    # fp32 sums in other orders: loss to 1e-5 relative, gradient to 1e-5
    # relative plus 1e-6 of its largest element
    gen = torch.Generator().manual_seed(c)
    x = (torch.randn(3, c, 40, 56, generator=gen) * 3).to(dev)
    t = torch.randint(0, c, (3, 40, 56), generator=gen).to(dev)
    f0, b0 = ce_cuda.CE_FWD.launches, ce_cuda.CE_BWD.launches
    xk = x.clone().requires_grad_(True)
    lk = ce_cuda.fused_cross_entropy(xk, t)
    (gk,) = torch.autograd.grad(lk * 2.5, xk)
    xp = x.clone().requires_grad_(True)
    lp = ce_cuda.cross_entropy_with_internal_softmax(xp, t)
    (gp,) = torch.autograd.grad(lp * 2.5, xp)
    torch.cuda.synchronize()
    assert ce_cuda.CE_FWD.launches == f0 + 1
    assert ce_cuda.CE_BWD.launches == b0 + 1
    assert abs(lk.item() - lp.item()) <= 1e-5 * abs(lp.item())
    assert torch.allclose(gk, gp, rtol=1e-5,
                          atol=1e-6 * float(gp.abs().max()))


def _decoded_scene(dev, px, dist=18.0):
    """The quality DeepSDF's 4096-surfel surface seen from `dist`, filling
    80% of a px x px crop: silhouette pairs at the distance where the
    sqrt-free expanded footprint test loses ~6% of diam^2 to rounding."""
    cfg, params = deepsdf.load_torch_checkpoint(
        os.path.join(REPO, "data", "quality_nets", "deepsdf_quality.pt"),
        device=dev)
    focal = 0.8 * px * dist / 2.2
    K = torch.tensor([[focal, 0.0, px / 2], [0.0, focal, px / 2],
                      [0.0, 0.0, 1.0]], device=dev)
    with torch.no_grad():
        surf, _ = grid.surface_from_decoder(
            deepsdf.sdf_fn(cfg, params),
            torch.tensor([0.6, -0.48, 0.64], device=dev),
            grid.generate_point_grid(40, device=dev), capacity=4096)
        pose = refine.build_render_pose(torch.tensor([0.7], device=dev),
                                        torch.tensor([0.0, 1.0, dist],
                                                     device=dev))
        proj, feats, kg = rasterer.splat_inputs(
            K, (px, px), surf.points, surf.normals, surf.normals, pose,
            rot="dcm", output_nocs=True)
    return proj.points_3d, proj.normals_3d, feats, surf.mask, kg


@pytest.mark.parametrize("px,counter", [(32, "SPLAT_FWD"),
                                        (128, "SPLAT_FWD_BINNED")])
def test_splat_on_a_decoded_surface_matches_plain(dev, px, counter):
    # the dense tolerance: footprint bits flip only within fp32 rounding
    # of the disc edge, so >= 99.5% of pixels within 2e-4 and >= 99% of
    # gradient rows within 1e-3 of the largest gradient
    v, nrm, feats, mask, kg = _decoded_scene(dev, px)
    launches = getattr(splat_cuda, counter).launches
    args = [t.clone().requires_grad_(True) for t in (v, nrm, feats)]
    img_k = splat_cuda.surfel_composite(*args, kg, mask)
    g = torch.randn_like(img_k)
    gk = torch.autograd.grad((img_k * g).sum(), args)
    args_p = [t.clone().requires_grad_(True) for t in (v, nrm, feats)]
    img_p = splat.surfel_composite_dense(*args_p, kg, mask)
    gp = torch.autograd.grad((img_p * g).sum(), args_p)
    torch.cuda.synchronize()
    assert getattr(splat_cuda, counter).launches == launches + 1
    assert img_p[:, 3].sum().item() > 50  # the car covers pixels
    err = (img_k - img_p).abs().max(-1).values
    assert (err < 2e-4).float().mean() >= 0.995, err.max()
    for a, b in zip(gk, gp):
        scale = b.abs().max().clamp(min=1e-6)
        close = ((a - b).abs().max(-1).values / scale) < 1e-3
        assert close.float().mean() >= 0.99


@pytest.mark.parametrize("width,n", [(128, 1000), (512, 8192)])
def test_stage2_matches_plain(dev, width, n):
    # kernels 4a and 4b against the plain version: shares within the
    # tolerances of tests/test_mlp2_pallas.py and medians
    # (mlp2_cuda.stage2_agreement says why), the sdf's maximum as the
    # selection kernel's
    cfg = deepsdf.DeepSDFConfig(
        latent_size=3, dims=(width,) * 8, norm_layers=tuple(range(8)),
        latent_in=(4,), weight_norm=True)
    gen = torch.Generator().manual_seed(1)
    params = deepsdf.init_params(cfg, gen, device=dev)
    packed = mlp_cuda.pack_select_mlp(cfg, deepsdf.cast_params(
        params, torch.bfloat16))
    pts = (torch.rand(n, 3, generator=gen) * 2 - 1).to(dev)
    ct = torch.randn(n, generator=gen).to(dev)
    lat = torch.tensor([0.3, -0.5, 0.8], device=dev)
    cvec = mlp_cuda._cvec(packed, lat)
    f0 = mlp2_cuda.STAGE2_FWD.launches
    b0 = mlp2_cuda.STAGE2_BWD.launches
    out = mlp2_cuda.stage2_fwd(packed, cvec, pts)
    dcvec, dpts = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct)
    cv = cvec.clone().requires_grad_(True)
    p = pts.clone().requires_grad_(True)
    sdf = mlp2_cuda.stage2_plain(packed, cv, p)
    (g,) = torch.autograd.grad(sdf.sum(), p, retain_graph=True)
    dcv_p, dp_p = torch.autograd.grad(sdf, (cv, p), ct)
    torch.cuda.synchronize()
    assert mlp2_cuda.STAGE2_FWD.launches == f0 + 1
    assert mlp2_cuda.STAGE2_BWD.launches == b0 + 1
    shares, medians = mlp2_cuda.stage2_agreement(out[:, 0], sdf.detach(), (
        ("normals", out[:, 1:], g), ("d_points", dpts, dp_p),
        ("d_cvec", dcvec.reshape(-1, 1), dcv_p.reshape(-1, 1))))
    assert (out[:, 0] - sdf).abs().max() < 1e-3 and shares["sdf"] >= 0.995
    assert medians.pop("sdf") <= 1e-6 and max(medians.values()) <= 1e-4
    assert min(shares.values()) >= 0.98, shares


def test_stage2_autograd_reaches_latent_and_points(dev):
    cfg = deepsdf.DeepSDFConfig(
        latent_size=3, dims=(128,) * 6, norm_layers=tuple(range(6)),
        latent_in=(3,), weight_norm=True, xyz_in_all=False)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(2),
                                 device=dev)
    fn = mlp2_cuda.stage2_fn(cfg, params)
    pts = (torch.rand(700, 3, generator=torch.Generator().manual_seed(3))
           * 2 - 1).to(dev).requires_grad_(True)
    lat = torch.tensor([0.7, -0.2, 0.4], device=dev, requires_grad=True)
    w = torch.randn(700, generator=torch.Generator().manual_seed(4)).to(dev)
    sdf, g = fn(lat, pts)
    assert not g.requires_grad
    gl, gp = torch.autograd.grad((w * sdf).sum(), (lat, pts))
    sdf_p, _ = mlp2_cuda.emulate_stage2(
        mlp_cuda.pack_select_mlp(cfg, params), lat, pts)
    gl_p, gp_p = torch.autograd.grad((w * sdf_p).sum(), (lat, pts))
    for got, want in ((gl, gl_p), (gp, gp_p)):
        assert ((got - want).abs().max() / want.abs().max()) < 5e-3
