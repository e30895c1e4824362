"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test needs an NVIDIA card and nvcc and skips elsewhere. On a machine
with the card and without JAX, run them as
  python -m pytest tests/test_torch_kernels_cuda.py --noconftest \
      -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import knn, mlp_cuda, nn_cuda, splat, splat_cuda
from sdflabel_tpu_torch.renderer.rasterer import calibration_matrix

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
