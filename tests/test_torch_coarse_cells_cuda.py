"""Coarse-to-fine cells on the card: the selection MLP (kernel 3) at the
cell pass's shapes against its plain version (the corner lattice, (d/2+1)^3
= 9261 points at grid 40 shared by every crop; the candidates, 16384 points
of 2048 cells per crop; one crop and four), and the cell ranking's tie
order: every cell the surface crosses scores exactly 0, and the card's
stable sort must keep them in index order, as jax.lax.top_k does and as the
CPU does.

Every test needs an NVIDIA card and nvcc and skips elsewhere. On a machine
with the card and without JAX, run them as
  python -m pytest tests/test_torch_coarse_cells_cuda.py --noconftest \
      -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from sdflabel_tpu_torch.models import deepsdf
from sdflabel_tpu_torch.ops import grid, mlp_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _packed(dev):
    """The 8x512 reference architecture, seeded, cast to bf16 and packed
    as the runtime packs it under float16."""
    cfg = deepsdf.DeepSDFConfig(latent_size=3, dims=(512,) * 8,
                                norm_layers=tuple(range(8)), latent_in=(4,),
                                weight_norm=True)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=dev)
    return mlp_cuda.pack_select_mlp(
        cfg, deepsdf.cast_params(params, torch.bfloat16))


def _latents(dev, b):
    rng = np.random.RandomState(b)
    return torch.nn.functional.normalize(torch.as_tensor(
        rng.randn(b, 3).astype(np.float32), device=dev), dim=-1)


def _assert_select_close(out_k, out_p):
    # the limits kernel 3 already has: the same bf16 operands, fp32 sums
    # in another order
    err = (out_k - out_p).abs()
    assert float(err.max()) < 1e-3 and float(err.median()) < 1e-5


@pytest.mark.parametrize("b", [1, 4])
def test_select_at_the_corner_lattice(dev, b):
    packed = _packed(dev)
    pts = grid.generate_point_grid(40, device=dev)
    lattice_np, _ = grid._cell_corner_lattice_np(40, 2)
    lattice = pts[torch.as_tensor(lattice_np, device=dev, dtype=torch.long)]
    assert lattice.shape == (9261, 3)
    lat = _latents(dev, b)
    out = mlp_cuda.select_mlp_apply(packed, lat, lattice)
    assert out.shape == (b, 9261)
    _assert_select_close(out, mlp_cuda.emulate_select_mlp(packed, lat,
                                                          lattice))


@pytest.mark.parametrize("b", [1, 4])
def test_select_at_the_cell_candidates(dev, b):
    packed = _packed(dev)
    pts = grid.generate_point_grid(40, device=dev)
    lat = _latents(dev, b)

    def plain(latent, p):
        return mlp_cuda.emulate_select_mlp(packed, latent, p)

    cand = grid._coarse_cell_candidates(plain, lat, pts, 2, 2048, 8192)
    assert cand.shape == (b, 16384)
    cpts = pts[cand]
    out = mlp_cuda.select_mlp_apply(packed, lat, cpts.contiguous())
    assert out.shape == (b, 16384)
    _assert_select_close(out, plain(lat, cpts))


def test_cell_ranking_keeps_the_index_order_of_ties(dev):
    # 20^3 cells, a third of them tied at 0 and the rest on a coarse
    # lattice of values, so that ties abound: the card's order equals the
    # CPU's, the lower index first among equals
    rng = np.random.RandomState(3)
    score = rng.randint(1, 40, (4, 8000)).astype(np.float32) * 0.01
    score[rng.uniform(size=score.shape) < 0.33] = 0.0
    for k in (100, 2048, 8000):
        vals, idx = grid._smallest(torch.as_tensor(score, device=dev), k)
        want_v, want_i = grid._smallest(torch.as_tensor(score), k)
        assert torch.equal(idx.cpu(), want_i) and torch.equal(vals.cpu(),
                                                              want_v)
        stable = np.argsort(score, axis=1, kind="stable")[:, :k]
        assert np.array_equal(idx.cpu().numpy(), stable)


def test_cell_candidates_equal_the_cpu(dev):
    # an exact decoder (an L-inf cube offset by the latent), so that every
    # corner value is the same on both: the candidates equal the CPU's
    def cube(lat, p):
        return (p - lat[..., None, :]).abs().amax(-1) - 0.5

    lat = np.array([[0.0, 0.0, 0.0], [0.13, -0.21, 0.05]], np.float32)
    pts = grid.generate_point_grid(40)
    for cells in (300, 2048):
        got = grid._coarse_cell_candidates(
            cube, torch.as_tensor(lat, device=dev), pts.to(dev), 2, cells, 8)
        want = grid._coarse_cell_candidates(cube, torch.as_tensor(lat), pts,
                                            2, cells, 8)
        assert torch.equal(got.cpu(), want)
