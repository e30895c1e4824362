"""A plain PyTorch model of the bins kernel's stable counting sort
(csrc/splat_bins.cu) against the JAX package's row bins
(sdflabel_tpu/ops/splat_pallas.py::_compute_bins) and the port's plain
version (ops/splat_cuda.py::compute_bins).

The kernel takes each point's first row block (key, nb for a point that
touches nothing) and span from compute_bins' overlap test, then sorts
without a sort: each tile of 128 points counts its keys (a histogram over
the nb + 1 keys), the per-key totals are scanned (prefix[k] = #points of
key < k), and point i of tile t with key k goes to prefix[k] + (points of
key k in tiles before t) + (points of key k before i in its tile). The
windows are read off the scan: [prefix[max(b - smax, 0)], prefix[b + 1]).
The model does the same in torch. Integers, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.ops import splat as jsplat
from sdflabel_tpu.ops import splat_pallas
from sdflabel_tpu.renderer.rasterer import calibration_matrix
from sdflabel_tpu_torch.ops import splat_cuda

TILE = 128  # BINS_PTS: points a tile


def counting_sort_bins(key, span, nb, chunk=1):
    """(order, key_sorted, smax, start, count) of the kernel's counting
    sort of `key` (N,) in [0, nb], windows in chunks of `chunk` points."""
    n = key.shape[0]
    tiles = max(-(-n // TILE), 1)
    tile_of = torch.arange(n) // TILE
    hist = torch.zeros(tiles, nb + 1, dtype=torch.int64)
    hist.index_put_((tile_of, key), torch.ones(n, dtype=torch.int64),
                    accumulate=True)
    total = hist.sum(0)
    prefix = torch.cat([torch.zeros(1, dtype=torch.int64), total.cumsum(0)])
    before = hist.cumsum(0) - hist  # key k's points in the tiles before
    # each point's rank among the points of its key before it in its tile
    same = (key[:, None] == key[None, :]) & (tile_of[:, None]
                                              == tile_of[None, :])
    rank = torch.tril(same, diagonal=-1).sum(1)
    pos = prefix[key] + before[tile_of, key] + rank
    order = torch.empty(n, dtype=torch.int64)
    order[pos] = torch.arange(n)
    smax = int(span.max()) if n else 0
    blocks = torch.arange(nb)
    starts = prefix[(blocks - smax).clamp(min=0)]
    ends = prefix[blocks + 1]
    start_chunk = starts // chunk
    end_chunk = (ends + chunk - 1) // chunk
    return (order, key[order], smax, start_chunk,
            (end_chunk - start_chunk).clamp(min=0))


def _scene(n, res, seed, case):
    """Points in front of the camera, a few masked; with the degenerate
    points of tests/test_torch_splat_binned.py (behind the camera, on its
    plane: every row block), or every point masked."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    feats = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.1
    if case == "degenerate":
        pts[:4, 2] = np.array([-3.0, -0.01, 0.02, 0.0], np.float32)[:n]
        mask[:4] = True
    elif case == "masked":
        mask[:] = False
    K = calibration_matrix(res).astype(np.float32)
    grid = np.asarray(jsplat.pixel_grid(*res))
    kg = (np.concatenate([grid, np.ones((grid.shape[0], 1), np.float32)], 1)
          @ np.linalg.inv(K).T).astype(np.float32)
    return pts, normals, feats, mask, kg


CASES = [
    (700, (64, 64), "degenerate"),   # 6 tiles, every window stretched
    (700, (64, 64), "plain"),
    (300, (64, 64), "masked"),       # every key nb: empty windows
    (1, (64, 64), "plain"),
    (1, (64, 64), "degenerate"),
    (500, (200, 100), "degenerate"),  # ragged last row block (32 rays)
    (2000, (320, 320), "plain"),     # nb = 200
    (2000, (320, 320), "degenerate"),
]


@pytest.mark.parametrize("n,res,case", CASES)
@pytest.mark.parametrize("chunk", [1, 128, 256])
def test_counting_sort_equals_jax_bins(n, res, case, chunk):
    bin_px = 512
    pts, normals, feats, mask, kg = _scene(n, res, seed=n, case=case)
    jpts, _, jkg, _, _ = splat_pallas._pack(
        jnp.asarray(pts), jnp.asarray(normals), jnp.asarray(mask),
        jnp.asarray(feats), jnp.asarray(kg), chunk, bin_px)
    order, sc, nc = (np.asarray(a) for a in splat_pallas._compute_bins(
        jpts, jkg, 0.04, bin_px, chunk))
    tp = splat_cuda._pack_points(torch.as_tensor(pts),
                                 torch.as_tensor(normals),
                                 torch.as_tensor(mask))
    key, span = splat_cuda.bin_keys(tp, splat_cuda._pack_rays(
        torch.as_tensor(kg)), 0.04, bin_px)
    nb = -(-kg.shape[0] // bin_px)
    got = counting_sort_bins(key, span, nb, chunk)
    # JAX pads the points to a chunk multiple; the padding is masked, so it
    # sorts last and leaves the real points' order and windows as they are
    assert np.all(order[n:] >= n)
    np.testing.assert_array_equal(got[0].numpy(), order[:n])
    np.testing.assert_array_equal(got[3].numpy(), sc)
    np.testing.assert_array_equal(got[4].numpy(), nc)
    if case == "degenerate":  # a point on the camera plane: every block
        assert got[2] == nb - 1
    if case == "masked":
        assert got[2] == 0 and not got[4].any()


@pytest.mark.parametrize("n,res,case", CASES)
def test_counting_sort_equals_compute_bins(n, res, case):
    pts, normals, feats, mask, kg = _scene(n, res, seed=n + 1, case=case)
    tp = splat_cuda._pack_points(torch.as_tensor(pts),
                                 torch.as_tensor(normals),
                                 torch.as_tensor(mask))
    tkg = splat_cuda._pack_rays(torch.as_tensor(kg))
    key, span = splat_cuda.bin_keys(tp, tkg, 0.04, 512)
    order, key_sorted, smax, start, count = counting_sort_bins(
        key, span, -(-kg.shape[0] // 512))
    want = splat_cuda.compute_bins(tp, tkg, 0.04, 512)
    assert torch.equal(order, want.order)
    assert torch.equal(key_sorted, want.key)
    assert smax == int(want.smax)
    assert torch.equal(start, want.start)
    assert torch.equal(count, want.count)


def test_counting_sort_of_no_point():
    # the kernel bins 0 points too: smax 0 and empty windows
    order, key, smax, start, count = counting_sort_bins(
        torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64),
        8)
    assert order.numel() == key.numel() == 0 and smax == 0
    assert not start.any() and not count.any()
