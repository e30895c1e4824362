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
from sdflabel_tpu_torch.ops import (_cuda, ce_cuda, grid, knn, mlp2_cuda,
                                    mlp_cuda, nn_cuda, splat, splat_cuda)
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


def _splat_scene(dev, n=3000, res=(32, 32), seed=0, spread=1.0):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
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


def _packed_splat(pts, nrm, feats, mask, kg):
    return (splat_cuda._pack_points(pts, nrm, mask), feats.contiguous(),
            splat_cuda._pack_rays(kg))


@pytest.mark.parametrize("n,res", [(8192, (32, 32)), (3000, (32, 32)),
                                   (3000, (30, 27))])
def test_split_splat_forward_matches_plain_and_first_design(dev, n, res):
    # the split dense forward (points over a cluster of CTAs, partials
    # merged in rank order): the dense tolerance against the plain version
    # (>= 99.5% of pixels within 2e-4), and the first design's per-pair
    # arithmetic in another order of sums: within 2e-5 of it
    pts, nrm, feats, mask, kg = _splat_scene(dev, n=n, res=res)
    pts[:3, 2] = torch.tensor([-3.0, 0.0, 0.02], device=dev)  # degenerate
    p = kg.shape[0]
    assert splat_cuda.split_slices(n, p) == 8  # 810 or 1024 px: 13-16 tiles
    f0 = splat_cuda.SPLAT_FWD.launches
    pk, fk, kg4 = _packed_splat(pts, nrm, feats, mask, kg)
    img, m, d, zn = splat_cuda._fwd(pk, fk, kg4, 0.04, 150.0)
    first = splat_cuda._fwd(pk, fk, kg4, 0.04, 150.0,
                            splat_cuda.SPLAT_FWD_FIRST)
    img_p = splat.surfel_composite_dense(pts, nrm, feats, kg, mask)
    torch.cuda.synchronize()
    assert splat_cuda.SPLAT_FWD.launches == f0 + 1
    err = (img - img_p).abs().max(-1).values
    assert (err < 2e-4).float().mean() >= 0.995, err.max()
    assert (img - first[0]).abs().max() <= 2e-5
    # the saved m, d, zn keep their meaning for the backward
    for got, want in zip((m, d, zn), first[1:]):
        assert torch.allclose(got, want, rtol=2e-5, atol=1e-6)


def test_split_splat_forward_is_deterministic(dev):
    # no atomics: two launches are bit-equal
    pk, fk, kg4 = _packed_splat(*_splat_scene(dev, n=8192))
    a = splat_cuda._fwd(pk, fk, kg4, 0.04, 150.0)
    b = splat_cuda._fwd(pk, fk, kg4, 0.04, 150.0)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def _bwd_inputs(dev, n, res, seed=0):
    """The packed backward inputs (points, features, pixel rows) of a
    forward through the split design, and the plain version's gradients of
    the same cotangent."""
    pts, nrm, feats, mask, kg = _splat_scene(dev, n=n, res=res, seed=seed)
    pts[:3, 2] = torch.tensor([-3.0, 0.0, 0.02], device=dev)[:n]
    pk, fk, kg4 = _packed_splat(pts, nrm, feats, mask, kg)
    img, m, d, zn = splat_cuda._fwd(pk, fk, kg4, 0.04, 150.0)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(n)
                    ).to(dev)
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[:, None], d[:, None], zn[:, None], corr, g],
                    1).contiguous()
    args = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_p = splat.surfel_composite_dense(*args, kg, mask)
    plain = torch.autograd.grad(img_p, args, g)
    return pk, fk, pix, plain


@pytest.mark.parametrize("n,res,slices", [
    *[(8192, (32, 32), s) for s in range(1, 9)],  # every cluster size
    (8192, (32, 32), 0),   # the wrapper's rule
    (3000, (30, 27), 0),   # ragged n and 810 px
    (3001, (30, 27), 3),   # 270 px a slice
])
def test_split_splat_backward_matches_plain_and_first_design(dev, n, res,
                                                             slices):
    # the split dense backward (pixels over a cluster of CTAs, per-point
    # partials added in warp, then rank order): the dense limits against
    # the plain version (>= 99% of gradient rows within 1e-3 of the
    # largest), the first design's per-pair arithmetic in another order of
    # sums, and two launches bit-equal. Against the first design d_points
    # and d_features lie within 1e-5 of their largest magnitude; d_normals
    # = dnv_sum * v + sum(dnk * g) cancels ~100x on the footprint, so a
    # last-ulp change of dnv_sum moves it by up to ~2e-5, as far as the
    # first design itself lies from the fp64 sum
    # (scripts/splat_bwd_sum_order.py): 5e-5 for it
    pk, fk, pix, plain = _bwd_inputs(dev, n, res)
    b0 = splat_cuda.SPLAT_BWD.launches
    got = splat_cuda._bwd(pk, fk, pix, 0.04, 150.0, slices=slices)
    again = splat_cuda._bwd(pk, fk, pix, 0.04, 150.0, slices=slices)
    first = splat_cuda._bwd(pk, fk, pix, 0.04, 150.0,
                            splat_cuda.SPLAT_BWD_FIRST)
    torch.cuda.synchronize()
    assert splat_cuda.SPLAT_BWD.launches == b0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    shares = [float((((a - b).abs().max(-1).values
                      / b.abs().max().clamp(min=1e-6)) < 1e-3).float().mean())
              for a, b in zip(got, plain)]
    rel = [float((a - c).abs().max() / c.abs().max())
           for a, c in zip(got, first)]
    assert min(shares) >= 0.99, shares
    assert rel[0] <= 1e-5 and rel[1] <= 5e-5 and rel[2] <= 1e-5, rel


@pytest.mark.parametrize("n", [1, 40, 3000, 8191])
@pytest.mark.parametrize("slices", [3, 8])
def test_split_splat_backward_ragged_n(dev, n, slices):
    # a point's sums meet no other point's: n points (fewer than one block
    # of 64, or not a multiple of it) give, bit for bit, the first n rows of
    # a launch over 8192 at the same cluster size
    pk, fk, pix, _ = _bwd_inputs(dev, 8192, (32, 32))
    full = splat_cuda._bwd(pk, fk, pix, 0.04, 150.0, slices=slices)
    head = splat_cuda._bwd(pk[:n].contiguous(), fk[:n].contiguous(), pix,
                           0.04, 150.0, slices=slices)
    torch.cuda.synchronize()
    assert all(h.shape[0] == n for h in head)
    assert all(torch.equal(h, f[:n]) for h, f in zip(head, full))


def test_split_splat_backward_slices_rule(dev):
    # the main path's 8192 points onto 32 x 32 px take a cluster; so many
    # points that their blocks alone fill the card take none
    assert splat_cuda.bwd_split_slices(8192, 1024) > 1
    assert splat_cuda.bwd_split_slices(200000, 1024) == 1
    assert splat_cuda.bwd_split_slices(8192, 100) <= 2  # >= 64 px a slice


def _nn_case(dev, n, m, seed, lattice=8):
    # coordinates on a 0.25 lattice: many exactly equal distances
    rng = np.random.RandomState(seed)
    q = rng.randint(-lattice, lattice + 1, (n, 3)).astype(np.float32) * 0.25
    d = rng.randint(-lattice, lattice + 1, (m, 3)).astype(np.float32) * 0.25
    mask = rng.uniform(size=m) > 0.3
    return tuple(torch.as_tensor(a, device=dev) for a in (q, d, mask))


@pytest.mark.parametrize("n,m,slices", [
    (8192, 8192, 0),         # the 3D loss: a cluster of 7
    *[(8192, 8192, s) for s in (1, 2, 3, 5, 8)],
    (567 * 300, 2048, 0),    # RANSAC: 567 hypotheses x 300 scene points
    (3000, 2500, 0),
    (100, 10, 0),            # fewer data points than one slice
])
def test_split_nn_matches_plain_and_first_design_bitwise(dev, n, m, slices):
    q, d, mask = _nn_case(dev, n, m, seed=n + m + slices)
    mask[m // 3: m // 2] = False  # a run of masked points across slices
    f0 = nn_cuda.NN_FWD.launches
    dk, ik = nn_cuda.nearest_neighbor_fused(q, d, mask, slices=slices)
    df, if_ = nn_cuda.nearest_neighbor_fused(q, d, mask, nn_cuda.NN_FIRST)
    dp, ip = knn.nearest_neighbor_plain(q, d, mask)
    torch.cuda.synchronize()
    assert nn_cuda.NN_FWD.launches == f0 + 1
    assert ik.dtype == torch.int64
    assert torch.equal(ik, ip) and torch.equal(dk, dp)
    assert torch.equal(ik, if_) and torch.equal(dk, df)


def test_split_nn_slices_rule(dev):
    assert nn_cuda.split_slices(8192, 8192) == 7
    assert nn_cuda.split_slices(567 * 2048, 2048) == 1


def test_split_nn_fully_masked_and_no_mask(dev):
    q, d, mask = _nn_case(dev, 3000, 2500, seed=5)
    dk, ik = nn_cuda.nearest_neighbor_fused(q, d, torch.zeros_like(mask))
    df, if_ = nn_cuda.nearest_neighbor_fused(q, d, torch.zeros_like(mask),
                                             nn_cuda.NN_FIRST)
    assert torch.all(ik == 0) and torch.all(dk == nn_cuda.BIG)
    assert torch.equal(ik, if_) and torch.equal(dk, df)
    dk, ik = nn_cuda.nearest_neighbor_fused(q, d)
    dp, ip = knn.nearest_neighbor_plain(q, d)
    assert torch.equal(ik, ip) and torch.equal(dk, dp)


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
    w0 = mlp_cuda.SELECT_MLP_WGMMA.launches
    out_k = mlp_cuda.select_mlp_apply(packed, lat, pts)
    out_p = mlp_cuda.emulate_select_mlp(packed, lat, pts)
    torch.cuda.synchronize()
    assert mlp_cuda.SELECT_MLP_WGMMA.launches == w0 + 1
    # same bf16 operands, fp32 accumulation in another order; a last-ulp
    # difference can flip one activation's bf16 rounding (2^-8 relative)
    err = (out_k - out_p).abs()
    assert err.max() < 1e-3 and err.median() < 1e-5, (err.max(),
                                                       err.median())


def _packed(dev, width, layers=8, seed=0):
    cfg = deepsdf.DeepSDFConfig(
        latent_size=3, dims=(width,) * layers,
        norm_layers=tuple(range(layers)), latent_in=(layers // 2,),
        weight_norm=True)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(seed),
                                 device=dev)
    return mlp_cuda.pack_select_mlp(cfg, deepsdf.cast_params(
        params, torch.bfloat16))


def _inputs(dev, packed, n):
    gen = torch.Generator().manual_seed(n)
    pts = (torch.rand(n, 3, generator=gen) * 2 - 1).to(dev)
    lat = torch.tensor([0.3, -0.5, 0.8], device=dev)
    return pts, lat, mlp_cuda._cvec(packed, lat).contiguous()


def _wrappers(packed, cvec, pts):
    return (mlp_cuda.select_fwd(packed, cvec, pts),
            mlp2_cuda.stage2_fwd(packed, cvec, pts))


def _wgmma_entry_points(cluster):
    """Kernels 3 and 4a launched through their wgmma C entry points with
    `cluster` CTAs to a cluster (the wrappers take mlp_cuda.CLUSTER)."""
    def launch(packed, cvec, pts):
        n, dev = pts.shape[0], pts.device
        sel = torch.empty(n, device=dev)
        fwd = torch.empty(n, 4, device=dev)
        args = (_cuda.ptr(packed.wx), _cuda.ptr(cvec),
                _cuda.ptr(packed.wlast), _cuda.ptr(packed.scal), n,
                packed.width, packed.n_hidden, int(packed.use_tanh), cluster)
        mlp_cuda.SELECT_MLP_WGMMA(_cuda.ptr(pts), _cuda.ptr(packed.ws_tiles),
                                  *args, _cuda.ptr(sel), _cuda.stream(pts))
        mlp2_cuda.STAGE2_FWD_WGMMA(
            _cuda.ptr(pts), _cuda.ptr(packed.ws_tiles),
            _cuda.ptr(packed.ws_tiles_t), *args, _cuda.ptr(fwd),
            _cuda.stream(pts))
        return sel, fwd
    return launch


def _check_designs(dev, packed, n, design, launch=_wrappers):
    """Kernel 3 and kernel 4a on n seeded points against their plain
    versions, each through `design` by `launch`, and that design's counter
    moves by one."""
    pts, lat, cvec = _inputs(dev, packed, n)
    sel = mlp_cuda.SELECT_MLP.designs[design]
    fwd = mlp2_cuda.STAGE2_FWD.designs[design]
    s0, f0 = sel.launches, fwd.launches
    assert mlp_cuda.select_design(packed) == design
    assert mlp2_cuda.stage2_fwd_design(packed) == design
    out_k, out = launch(packed, cvec, pts)
    out_p = mlp_cuda.emulate_select_mlp(packed, lat, pts)
    p = pts.clone().requires_grad_(True)
    sdf = mlp2_cuda.stage2_plain(packed, cvec, p)
    (g,) = torch.autograd.grad(sdf.sum(), p)
    torch.cuda.synchronize()
    assert (sel.launches, fwd.launches) == (s0 + 1, f0 + 1)
    # kernel 3: the tolerance of test_select_mlp_matches_plain
    err = (out_k - out_p).abs()
    assert err.max() < 1e-3 and err.median() < 1e-5, (err.max(),
                                                       err.median())
    # kernel 4a: mlp2_cuda.stage2_agreement's shares and medians
    shares, medians = mlp2_cuda.stage2_agreement(
        out[:, 0], sdf.detach(), (("normals", out[:, 1:], g),))
    assert (out[:, 0] - sdf).abs().max() < 1e-3 and shares["sdf"] >= 0.995
    assert medians["sdf"] <= 1e-6 and medians["normals"] <= 1e-4
    assert shares["normals"] >= 0.98, shares


@pytest.mark.parametrize("width", [128, 256, 384, 512])
def test_wgmma_designs_match_plain(dev, width):
    # 1000 points: 16 CTAs, the last one ragged
    _check_designs(dev, _packed(dev, width), 1000, "wgmma")


@pytest.mark.parametrize("width", [128, 256, 384, 512])
@pytest.mark.parametrize("n", [1, 200, 1000])
def test_wgmma_designs_ragged_n(dev, width, n):
    # n = 1, fewer points than one cluster of CTAs, not a multiple of 64:
    # a point's row does not depend on the others, so each output equals
    # the same point's in a launch over more points, bit for bit
    packed = _packed(dev, width)
    pts, lat, cvec = _inputs(dev, packed, 1100)
    sel = mlp_cuda.select_mlp_apply(packed, lat, pts)
    fwd = mlp2_cuda.stage2_fwd(packed, cvec, pts)
    head = pts[:n].contiguous()
    sel_n = mlp_cuda.select_mlp_apply(packed, lat, head)
    fwd_n = mlp2_cuda.stage2_fwd(packed, cvec, head)
    torch.cuda.synchronize()
    assert sel_n.shape == (n,) and fwd_n.shape == (n, 4)
    assert torch.equal(sel_n, sel[:n]) and torch.equal(fwd_n, fwd[:n])
    assert torch.isfinite(sel).all() and torch.isfinite(fwd).all()


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_wgmma_designs_any_cluster(dev, cluster):
    # the ring's barrier protocol at every cluster size the kernels take
    _check_designs(dev, _packed(dev, 512), 700, "wgmma",
                   _wgmma_entry_points(cluster))


def test_wide_layers_take_the_wmma_designs(dev):
    # H = 1024 is above the wgmma design's width: the kept wmma kernels
    packed = _packed(dev, 1024, layers=3)
    assert packed.n_hidden == 2 and packed.ws_tiles is None
    _check_designs(dev, packed, 1500, "wmma")
    _check_bwd(dev, packed, 1500, "wmma")


def _check_bwd(dev, packed, n, design, cluster=mlp_cuda.CLUSTER,
               sum_dtype=torch.float32):
    """Kernel 4b on n seeded points and cotangents against the plain
    version's autograd (its hidden products summed in `sum_dtype`), through
    `design` at `cluster` (the wgmma design's C entry point takes it), with
    mlp2_cuda.stage2_agreement's limits; that design's counter moves by
    one."""
    pts, lat, cvec = _inputs(dev, packed, n)
    ct = torch.randn(n, generator=torch.Generator().manual_seed(7)).to(dev)
    if packed.ws_tiles is not None:
        assert mlp2_cuda.stage2_bwd_design(packed) == "wgmma"
    kernel = mlp2_cuda.STAGE2_BWD.designs[design]
    b0 = kernel.launches
    dcvec, dpts = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct, design,
                                       cluster)
    cv = cvec.clone().requires_grad_(True)
    p = pts.clone().requires_grad_(True)
    sdf = mlp2_cuda.stage2_plain(packed, cv, p, sum_dtype)
    dcv_p, dp_p = torch.autograd.grad(sdf, (cv, p), ct)
    torch.cuda.synchronize()
    assert kernel.launches == b0 + 1
    shares, medians = mlp2_cuda.stage2_agreement(sdf.detach(), sdf.detach(), (
        ("d_points", dpts, dp_p),
        ("d_cvec", dcvec.reshape(-1, 1), dcv_p.reshape(-1, 1))))
    medians.pop("sdf")
    assert max(medians.values()) <= 1e-4, medians
    assert min(shares.values()) >= 0.98, shares


@pytest.mark.parametrize("width", [128, 256, 384, 512])
def test_wgmma_bwd_matches_plain(dev, width):
    # 1000 points: 16 CTAs, the last one ragged
    _check_bwd(dev, _packed(dev, width), 1000, "wgmma")


@pytest.mark.parametrize("width", [128, 512])
def test_wmma_bwd_matches_plain(dev, width):
    # the first design stays live for wider layers: checked at these too
    _check_bwd(dev, _packed(dev, width), 1000, "wmma")


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_wgmma_bwd_any_cluster(dev, cluster):
    # the ring's barrier protocol and the partials' count at every cluster
    # size the C entry point takes: the plain version's limits at the
    # width tests' 1000 points, and the cluster size changes no sum, so
    # the outputs equal the wrapper's (cluster mlp_cuda.CLUSTER) bit for bit
    packed = _packed(dev, 512)
    _check_bwd(dev, packed, 1000, "wgmma", cluster)
    pts, _, cvec = _inputs(dev, packed, 1000)
    ct = torch.randn(1000, generator=torch.Generator().manual_seed(7)).to(dev)
    got = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct, "wgmma", cluster)
    want = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("design,cluster", [("wgmma", 1), ("wgmma", 2),
                                            ("wgmma", 4), ("wmma", 2)])
def test_bwd_n700_matches_fp64_plain(dev, design, cluster):
    # n = 700 at H = 512, the sample whose d_cvec share against the fp32
    # plain version is 0.97998 for both designs: against the plain version
    # summed in fp64 the same limits hold (scripts/stage2_bwd_shares.py
    # lists the rows the fp32 sums move)
    _check_bwd(dev, _packed(dev, 512), 700, design, cluster, torch.float64)


@pytest.mark.parametrize("width", [128, 256, 384, 512])
@pytest.mark.parametrize("n", [1, 200, 1000])
def test_wgmma_bwd_ragged_n(dev, width, n):
    # rows do not meet but in the column sums, and a row whose cotangent is
    # 0 adds 0 to them: n points give, bit for bit, the d_xyz of the first
    # n rows and the d_cvec of 1100 points whose cotangent is 0 past n
    packed = _packed(dev, width)
    pts, _, cvec = _inputs(dev, packed, 1100)
    ct = torch.randn(1100, generator=torch.Generator().manual_seed(8))
    ct[n:] = 0.0
    ct = ct.to(dev)
    dcvec, dpts = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct)
    dcvec_n, dpts_n = mlp2_cuda.stage2_bwd(packed, cvec, pts[:n].contiguous(),
                                           ct[:n].contiguous())
    torch.cuda.synchronize()
    assert mlp2_cuda.stage2_bwd_design(packed) == "wgmma"
    assert dpts_n.shape == (n, 3)
    assert torch.equal(dpts_n, dpts[:n]) and torch.equal(dcvec_n, dcvec)
    assert torch.isfinite(dpts).all() and torch.isfinite(dcvec).all()


def _bins_scene(dev, res, n, case):
    """A binned render's packed points, features and rays: the splat scene,
    with degenerate points (behind the camera, on its plane: every row
    block), every point masked, or neither."""
    pts, nrm, feats, mask, kg = _splat_scene(dev, n=n, res=res, seed=n)
    if case == "degenerate":
        pts[:3, 2] = torch.tensor([-3.0, 0.0, 0.02], device=dev)
        mask[:3] = True
    elif case == "masked":
        mask = torch.zeros_like(mask)
    return _packed_splat(pts, nrm, feats, mask, kg)


BINS_CASES = [((64, 64), 3000, "plain"), ((64, 64), 3000, "degenerate"),
              ((200, 100), 2000, "degenerate"), ((128, 128), 4096, "plain"),
              ((128, 128), 4096, "degenerate"), ((320, 320), 8192, "plain"),
              ((320, 320), 8192, "degenerate"), ((128, 128), 1, "plain"),
              ((128, 128), 4096, "masked")]


@pytest.mark.parametrize("res,n,case", BINS_CASES)
def test_bins_kernel_equals_compute_bins(dev, res, n, case):
    # integers and copies: bit for bit, the windows at point granularity
    pk, fk, kg4 = _bins_scene(dev, res, n, case)
    bin_px = splat_cuda.bin_policy(kg4.shape[0])
    assert bin_px == 512
    b0 = splat_cuda.SPLAT_BINS.launches
    got = splat_cuda._sort_bins(pk, fk, kg4, 0.04, bin_px)
    again = splat_cuda._sort_bins(pk, fk, kg4, 0.04, bin_px)
    want = splat_cuda.compute_bins(pk, kg4, 0.04, bin_px)
    torch.cuda.synchronize()
    assert splat_cuda.SPLAT_BINS.launches == b0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got.order.long(), want.order)
    assert torch.equal(got.key.long(), want.key)
    assert int(got.smax) == int(want.smax)
    assert torch.equal(got.win[:, 0].long(), want.start)
    assert torch.equal(got.win[:, 1].long(), want.start + want.count)
    assert torch.equal(got.pts, pk[want.order])
    assert torch.equal(got.feats, fk[want.order])
    if case == "degenerate":  # a point on the camera plane: every block
        assert int(got.smax) == -(-kg4.shape[0] // bin_px) - 1
    if case == "masked":
        assert int(got.smax) == 0 and bool((got.win == 0).all())


def test_bins_kernel_without_points(dev):
    kg4 = _bins_scene(dev, (64, 64), 10, "plain")[2]
    empty = torch.empty(0, 8, device=dev)
    got = splat_cuda._sort_bins(empty, empty, kg4, 0.04, 512)
    torch.cuda.synchronize()
    assert got.order.shape == (0,) and int(got.smax) == 0
    assert got.win.shape == (8, 2) and bool((got.win == 0).all())


def _binned_inputs(dev, res, n, seed=0, spread=1.0):
    """The binned kernels' own inputs on the splat scene, with degenerate
    points where the points spread over +-1: the sorted bins, the
    forward's saved statistics (through the split design) and a
    cotangent's pixel rows; and the plain windowed version's image and
    gradients of the same cotangent."""
    pts, nrm, feats, mask, kg = _splat_scene(dev, n=n, res=res, seed=seed,
                                             spread=spread)
    if spread == 1.0:
        pts[:3, 2] = torch.tensor([-3.0, 0.0, 0.02], device=dev)
    pk, fk, kg4 = _packed_splat(pts, nrm, feats, mask, kg)
    bin_px = splat_cuda.bin_policy(kg4.shape[0])
    sb = splat_cuda._sort_bins(pk, fk, kg4, 0.04, bin_px)
    img, m, d, zn = splat_cuda._fwd_binned(sb.pts, sb.feats, kg4, sb.win,
                                           bin_px, 0.04, 150.0)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(n)
                    ).to(dev)
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[:, None], d[:, None], zn[:, None], corr, g],
                    1).contiguous()
    args = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_p = splat_cuda.surfel_composite_windowed(*args, kg, mask,
                                                 bin_px=bin_px)
    plain = torch.autograd.grad(img_p, args, g)
    return sb, kg4, bin_px, pix, img_p.detach(), plain


@pytest.mark.parametrize("res,n,slices", [
    ((128, 128), 4096, 0), ((64, 64), 3000, 0), ((200, 100), 2000, 0),
    *[((64, 64), 3000, s) for s in (1, 2, 3, 8)]])
def test_binned_split_forward_matches_first_design(dev, res, n, slices):
    # the split tile over each row block's window: the dense tolerance
    # against the windowed plain version, within 2e-5 of the first design
    # (the same pairs, other orders of sums), two launches bit-equal
    sb, kg4, bin_px, _, img_p, _ = _binned_inputs(dev, res, n)
    f0 = splat_cuda.SPLAT_FWD_BINNED.launches
    got = splat_cuda._fwd_binned(sb.pts, sb.feats, kg4, sb.win, bin_px, 0.04,
                                 150.0, slices=slices)
    again = splat_cuda._fwd_binned(sb.pts, sb.feats, kg4, sb.win, bin_px,
                                   0.04, 150.0, slices=slices)
    first = splat_cuda._fwd_binned(sb.pts, sb.feats, kg4, sb.win, bin_px,
                                   0.04, 150.0, design="first")
    torch.cuda.synchronize()
    assert splat_cuda.SPLAT_FWD_BINNED.launches == f0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    err = (got[0] - img_p).abs().max(-1).values
    assert (err < 2e-4).float().mean() >= 0.995, err.max()
    assert (got[0] - first[0]).abs().max() <= 2e-5
    for a, b in zip(got[1:], first[1:]):  # m, d, zn for the backward
        assert torch.allclose(a, b, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("res,n,slices,spread", [
    ((128, 128), 4096, 0, 1.0), ((64, 64), 3000, 0, 1.0),
    ((200, 100), 2000, 0, 1.0),
    # fewer points than a block of 64, spread over +-0.1 so that they
    # overlap, as in the dense split backward's test: a pixel of one
    # footprint point alone passes its geometry only a last-ulp gradient,
    # and 40 isolated points would be all such rows
    ((128, 128), 40, 0, 0.1),
    *[((128, 128), 4096, s, 1.0) for s in (1, 2, 3, 8)]])
def test_binned_split_backward_matches_first_design(dev, res, n, slices,
                                                    spread):
    # the split blocks over their union of rows, each point on its own
    # blocks, rows written to the points' slots: the dense limits against
    # the windowed plain version, the first design's limits of the dense
    # split backward (d_normals cancels ~100x, so 5e-5 for it), two
    # launches bit-equal
    sb, kg4, bin_px, pix, _, plain = _binned_inputs(dev, res, n,
                                                    spread=spread)
    args = (sb.pts, sb.feats, pix, sb.key, sb.smax, sb.order, bin_px, 0.04,
            150.0)
    b0 = splat_cuda.SPLAT_BWD_BINNED.launches
    got = splat_cuda._bwd_binned(*args, slices=slices)
    again = splat_cuda._bwd_binned(*args, slices=slices)
    first = splat_cuda._bwd_binned(*args, design="first")
    torch.cuda.synchronize()
    assert splat_cuda.SPLAT_BWD_BINNED.launches == b0 + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    shares = [float((((a - b).abs().max(-1).values
                      / b.abs().max().clamp(min=1e-6)) < 1e-3).float().mean())
              for a, b in zip(got, plain)]
    rel = [float((a - c).abs().max() / c.abs().max().clamp(min=1e-30))
           for a, c in zip(got, first)]
    assert min(shares) >= 0.99, shares
    assert rel[0] <= 1e-5 and rel[1] <= 5e-5 and rel[2] <= 1e-5, rel


def test_binned_slices_rules(dev):
    # the tiles of 128x128, 81x112 and 320x320 px fill the card alone;
    # 4096 points' 64 blocks take a cluster of 5
    for n, p in ((4096, 16384), (4096, 9072), (8192, 102400)):
        assert splat_cuda.binned_slices(n, p, 512) == 1
    assert splat_cuda.binned_slices(3000, 4096, 512) == 2
    assert splat_cuda.bwd_binned_slices(4096, 16384, 512) == 5


@pytest.mark.parametrize("res,n", [((64, 64), 3000), ((200, 100), 2000),
                                   ((128, 128), 4096)])
def test_binned_splat_matches_windowed_plain(dev, res, n):
    # same tolerance as the dense kernel: boundary bits may flip between
    # the expanded and the explicit distance; sums run in sorted order
    pts, nrm, feats, mask, kg = _splat_scene(dev, n=n, res=res)
    pts[:3, 2] = torch.tensor([-3.0, 0.0, 0.02], device=dev)  # degenerate
    assert splat_cuda.bin_policy(kg.shape[0]) == 512
    bins0 = splat_cuda.SPLAT_BINS.launches
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
    # one bins call, one forward and one backward launch a render
    assert splat_cuda.SPLAT_BINS.launches == bins0 + 1
    assert splat_cuda.SPLAT_FWD_BINNED.launches == fwd0 + 1
    assert splat_cuda.SPLAT_BWD_BINNED.launches == bwd0 + 1
    err = (img_k - img_p).abs().max(-1).values
    assert (err < 2e-4).float().mean() >= 0.995, err.max()
    for a, b in zip(gk, gp):
        scale = b.abs().max().clamp(min=1e-6)
        close = ((a - b).abs().max(-1).values / scale) < 1e-3
        assert close.float().mean() >= 0.99


def test_binned_render_launches_no_sort_gather_or_scatter(dev):
    # a binned render's device work: the bins kernel's two launches, the
    # forward and the backward, around the packing and the pixel rows;
    # no torch sort, searchsorted, gather or scatter
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pts, nrm, feats, mask, kg = _splat_scene(dev, n=4096, res=(128, 128))
    args = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]

    def render():
        img = splat_cuda.surfel_composite(*args, kg, mask.float())
        torch.autograd.grad(img, args, torch.ones_like(img))

    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA]
    assert any("splat_bins_keys_kernel" in k for k in names), names
    assert any("splat_bwd_binned_split_kernel" in k for k in names), names
    torch_ops = [k for k in names if "splat_" not in k]
    for word in ("sort", "index", "scatter", "gather", "radix"):
        assert not any(word in k.lower() for k in torch_ops), (word, names)


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


def _ce_onehot(x, t, cot):
    """The fused kernels' function for any target, in float64: lse - x[t]
    averaged, a target outside [0, C) picking nothing; its gradient
    (softmax - one_hot) * cot / n."""
    x = x.double()
    c = x.shape[1]
    valid = (t >= 0) & (t < c)
    one_hot = (torch.arange(c, device=x.device)[None, :, None, None]
               == t[:, None]) & valid[:, None]
    lse = torch.logsumexp(x, 1)
    loss = (lse - (x * one_hot).sum(1)).mean()
    grad = (torch.softmax(x, 1) - one_hot.double()) * cot / t.numel()
    return loss.float(), grad.float()


CE_SHAPES = [(c, shape) for c in (1, 2, 3, 256, 257)
             for shape in ((3, 40, 56), (1, 7, 9))] + [(256, (13, 128, 128))]


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("tdtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("c,shape", CE_SHAPES)
def test_ce_matches_plain(dev, c, shape, tdtype, out_of_range):
    # the class-split forward and the saved-lse backward against the plain
    # version (targets in range; the plain gather takes no other) or the
    # float64 one-hot function, and against the first designs: fp32 sums in
    # other orders, so the loss to 1e-5 relative of the reference and 1e-6
    # of the first design, the gradient to 1e-5 relative plus 1e-6 of its
    # largest element; two launches bit-equal; one launch of each new
    # design per call
    b, h, w = shape
    gen = torch.Generator().manual_seed(c * 100 + h)
    x = (torch.randn(b, c, h, w, generator=gen) * 3).to(dev)
    t = torch.randint(0, c, shape, generator=gen)
    if out_of_range:
        bad = torch.rand(shape, generator=gen) < 0.2
        wild = [-1, c, c + 5, 2 ** 31 - 1] + (
            [2 ** 32 + 1] if tdtype == torch.int64 else [])
        pick = torch.randint(0, len(wild), (int(bad.sum()),), generator=gen)
        t[bad] = torch.tensor(wild)[pick]
    t = t.to(tdtype).to(dev)
    cot = torch.tensor(2.5, device=dev)
    n = b * h * w

    f0, b0 = ce_cuda.CE_FWD.launches, ce_cuda.CE_BWD.launches
    xk = x.clone().requires_grad_(True)
    lk = ce_cuda.fused_cross_entropy(xk, t)
    (gk,) = torch.autograd.grad(lk, xk, cot)
    torch.cuda.synchronize()
    assert ce_cuda.CE_FWD.launches == f0 + 1
    assert ce_cuda.CE_BWD.launches == b0 + 1
    if out_of_range:
        lr, gr = _ce_onehot(x, t, cot)
    else:
        xp = x.clone().requires_grad_(True)
        lr = ce_cuda.cross_entropy_with_internal_softmax(xp, t)
        (gr,) = torch.autograd.grad(lr, xp, cot)
    assert abs(lk.item() - lr.item()) <= 1e-5 * abs(lr.item())
    assert torch.allclose(gk, gr, rtol=1e-5,
                          atol=1e-6 * float(gr.abs().max()))

    xc, tc = x.reshape(b, c, h * w), t.reshape(b, h * w)
    loss_first = ce_cuda._fwd(xc, tc, "first")[0].sum() / n
    dx_first = ce_cuda._bwd(xc, tc, None, cot, n, "first").reshape(x.shape)
    assert abs(lk.item() - loss_first.item()) <= 1e-6 * abs(
        loss_first.item())
    assert torch.allclose(gk, dx_first, rtol=1e-5,
                          atol=1e-6 * float(dx_first.abs().max()))

    p1, lse1 = ce_cuda._fwd(xc, tc)
    p2, lse2 = ce_cuda._fwd(xc, tc)
    d1 = ce_cuda._bwd(xc, tc, lse1, cot, n)
    d2 = ce_cuda._bwd(xc, tc, lse2, cot, n)
    assert torch.equal(p1, p2) and torch.equal(lse1, lse2)
    assert torch.equal(d1, d2) and torch.equal(d1.reshape(x.shape), gk)


@pytest.mark.parametrize("c", [2, 256])
def test_ce_split_unaligned_logits(dev, c):
    # logits 4 bytes off a 16-byte boundary take one pixel a lane: the same
    # class order per pixel, so lse and the gradient are bit-equal to the
    # float4 launch; only the tiles of the partial sums differ
    gen = torch.Generator().manual_seed(c)
    b, hw = 2, 40 * 56
    x = (torch.randn(b, c, hw, generator=gen) * 3).to(dev)
    t = torch.randint(0, c, (b, hw), generator=gen).to(dev)
    buf = torch.empty(x.numel() + 1, device=dev)
    xu = buf[1:].view(b, c, hw)
    xu.copy_(x)
    assert xu.data_ptr() % 16 == 4
    assert ce_cuda.fwd_plan(c, hw, aligned=False)["vec"] == 1
    cot = torch.tensor(2.5, device=dev)
    p4, lse4 = ce_cuda._fwd(x, t)
    p1, lse1 = ce_cuda._fwd(xu, t)
    assert torch.equal(lse4, lse1)
    assert abs(p4.sum().item() - p1.sum().item()) <= 1e-6 * abs(
        p4.sum().item())
    assert torch.equal(ce_cuda._bwd(x, t, lse4, cot, b * hw),
                       ce_cuda._bwd(xu, t, lse1, cot, b * hw))


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
    f0 = mlp2_cuda.STAGE2_FWD_WGMMA.launches
    b0 = mlp2_cuda.STAGE2_BWD_WGMMA.launches
    assert mlp2_cuda.stage2_fwd_design(packed) == "wgmma"
    assert mlp2_cuda.stage2_bwd_design(packed) == "wgmma"
    out = mlp2_cuda.stage2_fwd(packed, cvec, pts)
    dcvec, dpts = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct)
    cv = cvec.clone().requires_grad_(True)
    p = pts.clone().requires_grad_(True)
    sdf = mlp2_cuda.stage2_plain(packed, cv, p)
    (g,) = torch.autograd.grad(sdf.sum(), p, retain_graph=True)
    dcv_p, dp_p = torch.autograd.grad(sdf, (cv, p), ct)
    torch.cuda.synchronize()
    assert mlp2_cuda.STAGE2_FWD_WGMMA.launches == f0 + 1
    assert mlp2_cuda.STAGE2_BWD_WGMMA.launches == b0 + 1
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
