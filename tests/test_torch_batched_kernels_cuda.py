"""The crop axis of the port's CUDA kernels, on the card: a launch of B
crops against B launches of one crop each, bit for bit (the dense splat
forward and backward, kernels 1a and 1b; the nearest neighbour, 2; the
selection MLP, 3, both designs), the batched composite against its
plain version, and the stage-2 kernels (4a, 4b) and the binned splat,
which a batch launches once for all crops
(tests/test_torch_batched_stage2_binned_cuda.py holds them crop by crop).

Every test needs an NVIDIA card and nvcc and skips elsewhere. On a machine
with the card and without JAX, run them as
  python -m pytest tests/test_torch_batched_kernels_cuda.py --noconftest \
      -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import (_cuda, grid, knn, mlp2_cuda, mlp_cuda,
                                    nn_cuda, splat, splat_cuda)
from sdflabel_tpu_torch.renderer.rasterer import calibration_matrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _splat_batch(dev, b, n, res, seed=0):
    """B crops: their own surfels, masks and intrinsics."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    pts[..., 2] += 4.0 + 0.5 * np.arange(b)[:, None]
    nrm = rng.randn(b, n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    feats = rng.uniform(0, 1, (b, n, 8)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.4
    Ks = np.stack([calibration_matrix(res) for _ in range(b)])
    Ks[:, 0, 2] += 0.3 * np.arange(b)
    kg = splat.kinv_pixel_rays(torch.as_tensor(Ks, device=dev),
                               splat.pixel_grid(*res, device=dev))
    return (*(torch.as_tensor(a, device=dev)
              for a in (pts, nrm, feats, mask)), kg)


@pytest.mark.parametrize("b,n,res", [(4, 8192, (32, 32)), (3, 700, (24, 16)),
                                     (2, 100, (8, 8))])
def test_batched_splat_kernels_equal_single_crop_launches(dev, b, n, res):
    pts, nrm, feats, mask, kg = _splat_batch(dev, b, n, res)
    pk = splat_cuda._pack_points(pts, nrm, mask)
    fk = feats.contiguous()
    kg4 = splat_cuda._pack_rays(kg)
    before = splat_cuda.SPLAT_FWD.launches
    img, m, d, zn = splat_cuda._fwd(pk, fk, kg4, 0.04, 150.0)
    assert splat_cuda.SPLAT_FWD.launches == before + 1
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(1)
                    ).to(dev)
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[..., None], d[..., None], zn[..., None], corr, g],
                    -1).contiguous()
    grads = splat_cuda._bwd(pk, fk, pix, 0.04, 150.0)
    torch.cuda.synchronize()
    for i in range(b):
        one = splat_cuda._fwd(pk[i].contiguous(), fk[i].contiguous(),
                              kg4[i].contiguous(), 0.04, 150.0)
        for a, c in zip((img, m, d, zn), one):
            assert torch.equal(a[i], c)
        one_g = splat_cuda._bwd(pk[i].contiguous(), fk[i].contiguous(),
                                pix[i].contiguous(), 0.04, 150.0)
        for a, c in zip(grads, one_g):
            assert torch.equal(a[i], c)


def test_batched_composite_matches_plain(dev):
    # the single-crop kernel tests' tolerance, per crop: footprint bits may
    # flip at the disc boundary
    pts, nrm, feats, mask, kg = _splat_batch(dev, 4, 3000, (32, 32), seed=2)
    args = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_k = splat_cuda.surfel_composite(*args, kg, mask)
    g = torch.randn_like(img_k)
    gk = torch.autograd.grad((img_k * g).sum(), args)
    args_p = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_p = torch.stack([splat.surfel_composite_dense(
        *(a[i] for a in args_p), kg[i], mask[i]) for i in range(4)])
    gp = torch.autograd.grad((img_p * g).sum(), args_p)
    for i in range(4):
        err = (img_k[i] - img_p[i]).abs().max(-1).values
        assert (err < 1e-4).float().mean() > 0.995, err.max()
        for a, c in zip(gk, gp):
            scale = c[i].abs().max().clamp(min=1e-6)
            close = ((a[i] - c[i]).abs().max(-1).values / scale) < 1e-3
            assert close.float().mean() > 0.99


def test_batched_binned_composite_runs_crop_by_crop(dev):
    # renders of >= 4096 px take the binned kernels once for all crops,
    # each crop as its render alone
    pts, nrm, feats, mask, kg = _splat_batch(dev, 2, 2000, (64, 64), seed=3)
    before = splat_cuda.SPLAT_FWD_BINNED.launches
    img = splat_cuda.surfel_composite(pts, nrm, feats, kg, mask)
    assert splat_cuda.SPLAT_FWD_BINNED.launches == before + 1
    for i in range(2):
        assert torch.equal(img[i], splat_cuda.surfel_composite(
            pts[i], nrm[i], feats[i], kg[i], mask[i]))


@pytest.mark.parametrize("b,n,m", [(4, 8192, 8192), (3, 1000, 300)])
def test_batched_nn_equals_single_crop_launches_and_plain(dev, b, n, m):
    rng = np.random.RandomState(b)
    q = torch.as_tensor(rng.randint(-8, 9, (b, n, 3)).astype(np.float32)
                        * 0.25, device=dev)
    d = torch.as_tensor(rng.randint(-8, 9, (b, m, 3)).astype(np.float32)
                        * 0.25, device=dev)
    mask = torch.as_tensor(rng.uniform(size=(b, m)) > 0.3, device=dev)
    mask[1] = False  # a crop with no valid data point
    before = nn_cuda.NN_FWD.launches
    d2, idx = nn_cuda.nearest_neighbor_fused(q, d, mask)
    assert nn_cuda.NN_FWD.launches == before + 1
    for i in range(b):
        d2_i, idx_i = nn_cuda.nearest_neighbor_fused(q[i], d[i], mask[i])
        assert torch.equal(d2[i], d2_i) and torch.equal(idx[i], idx_i)
        if i != 1:
            dp, ip = knn.nearest_neighbor_plain(q[i], d[i], mask[i])
            assert torch.equal(d2[i], dp) and torch.equal(idx[i], ip)
    assert (idx[1] == 0).all() and (d2[1] == nn_cuda.BIG).all()


def _packed(dev, width):
    cfg = deepsdf.DeepSDFConfig(latent_size=3, dims=(width,) * 8,
                                norm_layers=tuple(range(8)), latent_in=(4,),
                                weight_norm=True)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    return mlp_cuda.pack_select_mlp(cfg, deepsdf.cast_params(
        params, torch.bfloat16))


@pytest.mark.parametrize("width", [512, 128])
@pytest.mark.parametrize("shared", [True, False])
def test_batched_select_equals_single_crop_launches(dev, width, shared):
    packed = _packed(dev, width)
    b = 4
    pts = grid.generate_point_grid(20, device=dev)
    if not shared:
        pts = (pts[None] * torch.linspace(0.6, 1.0, b, device=dev)[:, None,
                                                                   None])
    lat = torch.nn.functional.normalize(
        torch.randn(b, 3, generator=torch.Generator().manual_seed(4)), dim=-1
    ).to(dev)
    before = mlp_cuda.SELECT_MLP.launches
    out = mlp_cuda.select_mlp_apply(packed, lat, pts)
    assert mlp_cuda.SELECT_MLP.launches == before + 1
    plain = mlp_cuda.emulate_select_mlp(packed, lat, pts)
    for i in range(b):
        one = mlp_cuda.select_mlp_apply(packed, lat[i],
                                        pts if shared else pts[i])
        assert torch.equal(out[i], one)
        err = (out[i] - plain[i]).abs()
        assert float(err.max()) < 1e-3 and float(err.median()) < 1e-5


def test_batched_select_wmma_design_equals_single_crop_launches(dev):
    packed = _packed(dev, 256)
    pts = grid.generate_point_grid(16, device=dev)
    lat = torch.tensor([[0.6, -0.48, 0.64], [0.0, 0.6, 0.8]], device=dev)
    cvec = mlp_cuda._cvec(packed, lat).contiguous()
    n, H, nh = pts.shape[0], packed.width, packed.n_hidden

    def wmma(cv, b):
        out = torch.empty(b, n, device=dev)
        mlp_cuda.SELECT_MLP_WMMA(
            _cuda.ptr(pts), _cuda.ptr(packed.ws), _cuda.ptr(packed.wx),
            _cuda.ptr(cv), _cuda.ptr(packed.wlast), _cuda.ptr(packed.scal),
            b, 0, n, H, nh, int(packed.use_tanh), _cuda.ptr(out),
            _cuda.stream(pts))
        return out

    both = wmma(cvec, 2)
    plain = mlp_cuda.emulate_select_mlp(packed, lat, pts)
    for i in range(2):
        assert torch.equal(both[i], wmma(cvec[i].contiguous(), 1)[0])
        assert float((both[i] - plain[i]).abs().max()) < 1e-3


def test_batched_stage2_surface_launches_per_crop(dev):
    # kernels 4a and 4b take the crop axis: a batch of B launches each
    # once, each crop as its call alone
    cfg = deepsdf.DeepSDFConfig(latent_size=3, dims=(128,) * 6,
                                norm_layers=tuple(range(6)), latent_in=(3,),
                                weight_norm=True)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(1),
                                 device=dev)
    stage2 = mlp2_cuda.stage2_fn(cfg, params)
    dec = deepsdf.sdf_fn(cfg, params)
    pts = (torch.rand(3, 700, 3, generator=torch.Generator().manual_seed(2))
           * 2 - 1).to(dev)
    lat = torch.tensor([[0.7, -0.2, 0.4], [0.0, 0.6, 0.8], [0.6, 0.0, 0.8]],
                       device=dev, requires_grad=True)
    f0, b0 = mlp2_cuda.STAGE2_FWD.launches, mlp2_cuda.STAGE2_BWD.launches
    surf = grid._stage2_surface(dec, lat, pts, 0.03, stage2)
    surf.points.sum().backward()
    assert mlp2_cuda.STAGE2_FWD.launches == f0 + 1
    assert mlp2_cuda.STAGE2_BWD.launches == b0 + 1
    for i in range(3):
        one = grid._stage2_surface(dec, lat[i].detach(), pts[i], 0.03,
                                   stage2)
        for a, c in zip(surf, one):
            assert torch.equal(a[i].detach(), c.detach())
