"""The crop axis of the stage-2 kernels (4a, 4b) and of the binned splat
path (the bins, 1c, 1d) on the card: a launch of B crops against B
launches of one crop each, bit for bit, at B in {1, 2, 4}; an all-masked
lane (a padded lane of the batched driver); two launches bit-equal; and
the batched results against their plain versions crop by crop.

Every test needs an NVIDIA card and nvcc and skips elsewhere. On a machine
with the card and without JAX, run them as
  python -m pytest tests/test_torch_batched_stage2_binned_cuda.py \
      --noconftest -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import mlp2_cuda, mlp_cuda, splat, splat_cuda
from sdflabel_tpu_torch.renderer.rasterer import calibration_matrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed(dev, width, layers=8):
    cfg = deepsdf.DeepSDFConfig(latent_size=3, dims=(width,) * layers,
                                norm_layers=tuple(range(layers)),
                                latent_in=(4,), weight_norm=True)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    return mlp_cuda.pack_select_mlp(cfg, deepsdf.cast_params(
        params, torch.bfloat16))


def _stage2_inputs(dev, packed, b, n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    pts = (torch.rand(b, n, 3, generator=gen) * 2 - 1).to(dev)
    lat = torch.nn.functional.normalize(torch.randn(b, 3, generator=gen),
                                        dim=-1).to(dev)
    ct = torch.randn(b, n, generator=gen).to(dev)
    return mlp_cuda._cvec(packed, lat).contiguous(), pts, ct


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("width,n", [(512, 8192), (128, 1000), (256, 200)])
def test_batched_stage2_equals_single_crop_launches(dev, b, width, n):
    packed = _packed(dev, width)
    cvec, pts, ct = _stage2_inputs(dev, packed, b, n)
    f0 = mlp2_cuda.STAGE2_FWD_WGMMA.launches
    b0 = mlp2_cuda.STAGE2_BWD_WGMMA.launches
    out = mlp2_cuda.stage2_fwd(packed, cvec, pts)
    dcvec, dpts = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct)
    assert mlp2_cuda.STAGE2_FWD_WGMMA.launches == f0 + 1
    assert mlp2_cuda.STAGE2_BWD_WGMMA.launches == b0 + 1
    assert out.shape == (b, n, 4) and dcvec.shape == cvec.shape
    again = (mlp2_cuda.stage2_fwd(packed, cvec, pts),
             *mlp2_cuda.stage2_bwd(packed, cvec, pts, ct))
    for a, c in zip((out, dcvec, dpts), again):
        assert torch.equal(a, c)
    for i in range(b):
        one = mlp2_cuda.stage2_fwd(packed, cvec[i], pts[i].contiguous())
        assert torch.equal(out[i], one)
        dc1, dp1 = mlp2_cuda.stage2_bwd(packed, cvec[i], pts[i].contiguous(),
                                        ct[i].contiguous())
        assert torch.equal(dcvec[i], dc1) and torch.equal(dpts[i], dp1)


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_batched_stage2_bwd_wmma_and_clusters_equal_single_launches(dev,
                                                                    cluster):
    packed = _packed(dev, 256)
    cvec, pts, ct = _stage2_inputs(dev, packed, 3, 700, seed=1)
    for design in ("wgmma", "wmma"):
        dcvec, dpts = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct, design,
                                           cluster)
        for i in range(3):
            dc1, dp1 = mlp2_cuda.stage2_bwd(
                packed, cvec[i], pts[i].contiguous(), ct[i].contiguous(),
                design, cluster)
            assert torch.equal(dcvec[i], dc1) and torch.equal(dpts[i], dp1)


def test_batched_stage2_wmma_forward_equals_single_launches(dev):
    # the first design (wider layers) takes the crop axis too
    from sdflabel_tpu_torch.ops import _cuda

    packed = _packed(dev, 256)
    cvec, pts, _ = _stage2_inputs(dev, packed, 2, 500, seed=2)
    n, H, nh = 500, packed.width, packed.n_hidden

    def wmma(cv, p, b):
        out = torch.empty(b, n, 4, device=dev)
        mlp2_cuda.STAGE2_FWD_WMMA(
            _cuda.ptr(p), _cuda.ptr(packed.ws), _cuda.ptr(packed.wx),
            _cuda.ptr(cv), _cuda.ptr(packed.wlast), _cuda.ptr(packed.scal),
            b, n, H, nh, int(packed.use_tanh), _cuda.ptr(out),
            _cuda.stream(p))
        return out

    both = wmma(cvec, pts, 2)
    for i in range(2):
        assert torch.equal(both[i], wmma(cvec[i].contiguous(),
                                         pts[i].contiguous(), 1)[0])


def test_batched_stage2_matches_plain_per_crop(dev):
    # mlp2_cuda.stage2_agreement's limits, crop by crop
    packed = _packed(dev, 512)
    cvec, pts, ct = _stage2_inputs(dev, packed, 4, 2048, seed=3)
    out = mlp2_cuda.stage2_fwd(packed, cvec, pts)
    dcvec, dpts = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct)
    for i in range(4):
        cv = cvec[i].clone().requires_grad_(True)
        p = pts[i].clone().requires_grad_(True)
        sdf = mlp2_cuda.stage2_plain(packed, cv, p)
        (g,) = torch.autograd.grad(sdf.sum(), p, retain_graph=True)
        dcv_p, dp_p = torch.autograd.grad(sdf, (cv, p), ct[i])
        shares, medians = mlp2_cuda.stage2_agreement(
            out[i, :, 0], sdf.detach(), (
                ("normals", out[i, :, 1:], g), ("d_points", dpts[i], dp_p),
                ("d_cvec", dcvec[i].reshape(-1, 1), dcv_p.reshape(-1, 1))))
        assert shares["sdf"] >= 0.995 and medians.pop("sdf") <= 1e-6
        assert min(shares.values()) >= 0.98
        assert max(medians.values()) <= 1e-4


def _binned_batch(dev, b, n, res, seed=0, masked=()):
    """B crops of n surfels with their own intrinsics; crops in `masked`
    have every point masked, as a padded lane."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    pts[..., 2] += 4.0 + 0.5 * np.arange(b)[:, None]
    nrm = rng.randn(b, n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    feats = rng.uniform(0, 1, (b, n, 8)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.2
    for i in masked:
        mask[i] = False
    Ks = np.stack([calibration_matrix(res) for _ in range(b)])
    Ks[:, 1, 2] += 2.0 * np.arange(b)
    kg = splat.kinv_pixel_rays(torch.as_tensor(Ks, device=dev),
                               splat.pixel_grid(*res, device=dev))
    pk = splat_cuda._pack_points(*(torch.as_tensor(a, device=dev)
                                   for a in (pts, nrm, mask)))
    return pk, torch.as_tensor(feats, device=dev), splat_cuda._pack_rays(kg)


@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("n,res", [(4096, (128, 128)), (700, (64, 64)),
                                   (1000, (200, 100))])
def test_batched_binned_kernels_equal_single_crop_launches(dev, b, n, res):
    masked = (b - 1,) if b > 1 else ()
    pk, fk, kg4 = _binned_batch(dev, b, n, res, masked=masked)
    p = kg4.shape[1]
    bin_px = splat_cuda.bin_policy(p)
    assert bin_px == 512
    nb = -(-p // bin_px)
    l0 = (splat_cuda.SPLAT_BINS.launches, splat_cuda.SPLAT_FWD_BINNED.launches,
          splat_cuda.SPLAT_BWD_BINNED.launches)
    sb = splat_cuda._sort_bins(pk, fk, kg4, 0.04, bin_px)
    img, m, d, zn = splat_cuda._fwd_binned(sb.pts, sb.feats, kg4, sb.win,
                                           bin_px, 0.04, 150.0)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(5)
                    ).to(dev)
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[..., None], d[..., None], zn[..., None], corr, g],
                    -1).contiguous()
    grads = splat_cuda._bwd_binned(sb.pts, sb.feats, pix, sb.key, sb.smax,
                                   sb.order, bin_px, 0.04, 150.0)
    assert (splat_cuda.SPLAT_BINS.launches,
            splat_cuda.SPLAT_FWD_BINNED.launches,
            splat_cuda.SPLAT_BWD_BINNED.launches) == (l0[0] + 1, l0[1] + 1,
                                                      l0[2] + 1)
    assert sb.smax.shape == (b,) and sb.win.shape == (b, nb, 2)
    # two launches bit-equal
    sb2 = splat_cuda._sort_bins(pk, fk, kg4, 0.04, bin_px)
    assert all(torch.equal(a, c) for a, c in zip(sb, sb2))
    assert all(torch.equal(a, c) for a, c in zip(
        (img, m, d, zn), splat_cuda._fwd_binned(sb.pts, sb.feats, kg4, sb.win,
                                                bin_px, 0.04, 150.0)))
    assert all(torch.equal(a, c) for a, c in zip(grads, splat_cuda._bwd_binned(
        sb.pts, sb.feats, pix, sb.key, sb.smax, sb.order, bin_px, 0.04,
        150.0)))
    # the bins against compute_bins with a crop axis, bit for bit
    want = splat_cuda.compute_bins(pk, kg4, 0.04, bin_px)
    assert torch.equal(sb.order.long(), want.order)
    assert torch.equal(sb.key.long(), want.key)
    assert torch.equal(sb.smax.long(), want.smax)
    assert torch.equal(sb.win[..., 0].long(), want.start)
    assert torch.equal((sb.win[..., 1] - sb.win[..., 0]).long(), want.count)
    for i in range(b):
        one = [t[i].contiguous() for t in (pk, fk, kg4, pix)]
        sb1 = splat_cuda._sort_bins(one[0], one[1], one[2], 0.04, bin_px)
        for f in sb1._fields:
            a = getattr(sb, f)
            assert torch.equal(a[i] if f != "smax" else a[i:i + 1],
                               getattr(sb1, f)), f
        out1 = splat_cuda._fwd_binned(sb1.pts, sb1.feats, one[2], sb1.win,
                                      bin_px, 0.04, 150.0)
        for a, c in zip((img, m, d, zn), out1):
            assert torch.equal(a[i], c)
        g1 = splat_cuda._bwd_binned(sb1.pts, sb1.feats, one[3], sb1.key,
                                    sb1.smax, sb1.order, bin_px, 0.04, 150.0)
        for a, c in zip(grads, g1):
            assert torch.equal(a[i], c)
    for i in masked:  # a padded lane: empty bins, no image, no gradient
        assert int(sb.smax[i]) == 0 and (sb.key[i] == nb).all()
        assert (sb.win[i, :, 1] == sb.win[i, :, 0]).all()
        assert not img[i].any() and all(not t[i].any() for t in grads)


def test_batched_binned_composite_matches_windowed_plain(dev):
    # the single-crop limits, crop by crop: >= 99.5% of pixels within
    # 2e-4, >= 99% of gradient rows within 1e-3 of the largest
    pk, fk, kg4 = _binned_batch(dev, 4, 4096, (128, 128), seed=7,
                                masked=(3,))
    v, nrm, mask = pk[..., :3], pk[..., 3:6], pk[..., 6]
    kg = kg4[..., :3]
    args = [t.clone().requires_grad_(True) for t in (v, nrm, fk)]
    img = splat_cuda.surfel_composite(*args, kg, mask)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(8)
                    ).to(dev)
    grads = torch.autograd.grad((img * g).sum(), args)
    for i in range(4):
        one = [t[i].clone().requires_grad_(True) for t in (v, nrm, fk)]
        img_p = splat_cuda.surfel_composite_windowed(*one, kg[i], mask[i],
                                                     bin_px=512)
        gp = torch.autograd.grad((img_p * g[i]).sum(), one)
        err = (img[i] - img_p).abs().max(-1).values
        assert (err < 2e-4).float().mean() >= 0.995
        for a, c in zip(grads, gp):
            scale = c.abs().max().clamp(min=1e-6)
            rows = ((a[i] - c).abs().max(-1).values / scale) < 1e-3
            assert rows.float().mean() >= 0.99


@pytest.mark.parametrize("b", [2, 4])
def test_batched_pose_gradient_equals_single_crop(dev, b):
    # the pose gradient of a crop with the crop axis equals its own call's
    # bit for bit at the refine's 8192 points (cuBLAS and the reduction
    # kernels sum a batch of another size in another order; the
    # projection's backward sums each crop alone)
    from sdflabel_tpu_torch.ops import projection

    gen = torch.Generator().manual_seed(9)
    pts = (torch.rand(b, 8192, 3, generator=gen) * 2 - 1).to(dev)
    nrm = torch.randn(b, 8192, 3, generator=gen).to(dev)
    w = torch.randn(b, 8192, 8, generator=gen).to(dev)
    K = torch.as_tensor(calibration_matrix((32, 32)), device=dev)
    poses = torch.eye(4).repeat(b, 1, 1)
    poses[:, :3, :3] += 0.1 * torch.randn(b, 3, 3, generator=gen)
    poses[:, :3, 3] = torch.tensor([0.1, -0.2, 5.0])
    poses = poses.to(dev)

    def loss(k, pose, p, n, wt):
        out = projection.project_dcm(k, pose, p, n, p, (32, 32))
        return ((out.points_3d * wt[..., :3]).sum()
                + (out.normals_3d * wt[..., 3:6]).sum()
                + (out.points_2d * wt[..., 6:]).sum())

    args = [t.clone().requires_grad_(True) for t in (poses, pts, nrm)]
    got = torch.autograd.grad(loss(K.expand(b, 3, 3), *args, w), args)
    for i in range(b):
        one = [t[i].clone().requires_grad_(True) for t in (poses, pts, nrm)]
        for g, gi in zip(got, torch.autograd.grad(loss(K, *one, w[i]), one)):
            assert torch.equal(g[i], gi)
