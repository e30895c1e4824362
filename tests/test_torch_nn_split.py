"""A plain PyTorch model of the split nearest neighbour (csrc/nn.cu,
nn_split_kernel) against the port's plain version and the JAX package's
Pallas kernel in interpret mode.

The kernel splits the data points into S contiguous slices of ceil(m / S)
points, one CTA each. Within a slice a query keeps the first minimum: it
scans in index order and updates only on a strictly smaller squared
distance, a masked point scoring 1e30. The slices' (d2, index)
pairs then merge in rank order with a strict <, so the lower index wins a
tie. Each pair's d2 is the plain version's (t0*t0 + t1*t1) + t2*t2, so
the model is held bit-equal (no tolerance) to
ops/knn.py::nearest_neighbor_plain and to sdflabel_tpu/ops/nn_pallas.py, on
a 0.25 lattice where exact ties abound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdflabel_tpu.ops import nn_pallas
from sdflabel_tpu_torch.ops import knn as tknn

BIG = 1e30  # the kernel's masked-point score


def slice_first_min(query, data, mask, lo, hi):
    """One slice's (d2, index): the first minimum over data[lo:hi], masked
    points at BIG; an empty slice gives (inf, 0)."""
    n = query.shape[0]
    if hi <= lo:
        return torch.full((n,), float("inf")), torch.zeros(n, dtype=torch.long)
    d = data[lo:hi]
    d2 = (query[:, None, 0] - d[None, :, 0]).square()
    d2 = d2 + (query[:, None, 1] - d[None, :, 1]).square()
    d2 = d2 + (query[:, None, 2] - d[None, :, 2]).square()
    d2 = torch.where(mask[None, lo:hi], d2, torch.full_like(d2, BIG))
    best, idx = torch.min(d2, dim=1)  # the first minimal index
    return best, idx + lo


def split_nearest(query, data, mask, slices):
    """The split kernel's (d2, index): the slices' first minima merged in
    rank order with a strict <."""
    m = data.shape[0]
    per = -(-m // slices)
    best, idx = slice_first_min(query, data, mask, 0, min(m, per))
    for r in range(1, slices):
        lo = min(m, r * per)
        b, i = slice_first_min(query, data, mask, lo, min(m, lo + per))
        better = b < best
        best = torch.where(better, b, best)
        idx = torch.where(better, i, idx)
    return best, idx


def _tied(n, m, seed):
    # coordinates on a 0.25 lattice: many exactly equal distances
    rng = np.random.RandomState(seed)
    q = rng.randint(-3, 4, (n, 3)).astype(np.float32) * 0.25
    d = rng.randint(-3, 4, (m, 3)).astype(np.float32) * 0.25
    mask = rng.uniform(size=m) > 0.3
    return q, d, mask


@pytest.mark.parametrize("n,m,slices,masked", [
    (300, 700, 1, None),        # one CTA per query block
    (300, 700, 2, (350, 700)),  # slice 1 fully masked
    (300, 700, 3, (0, 234)),    # slice 0 fully masked: a later rank wins
    (300, 701, 8, None),        # ragged m: 88 points a slice, the last 85
    (77, 10, 8, None),          # 2 points a slice: slices 5 to 7 empty
    (33, 500, 8, (0, 500)),     # every point masked: index 0
])
def test_split_merge_matches_plain_and_jax_bitwise(n, m, slices, masked):
    q, d, mask = _tied(n, m, seed=n + m + slices)
    if masked is not None:
        mask[masked[0]:masked[1]] = False
    tq, td, tm = (torch.as_tensor(a) for a in (q, d, mask))
    got_d2, got_i = split_nearest(tq, td, tm, slices)
    want_d2, want_i = tknn.nearest_neighbor_plain(tq, td, tm)
    with pltpu.force_tpu_interpret_mode():
        jd, ji = nn_pallas.nearest_neighbor_fused(
            jnp.asarray(q), jnp.asarray(d), jnp.asarray(mask), qb=256,
            mb=256)
    assert torch.equal(got_i, want_i)
    assert np.array_equal(got_i.numpy(), np.asarray(ji))
    if mask.any():
        # ties: many rows have several points at their minimum
        assert torch.equal(got_d2, want_d2)
        assert np.array_equal(torch.sqrt(got_d2).numpy(), np.asarray(jd))
    else:
        # the kernel's sentinel, the plain version's inf, index 0
        assert torch.all(got_d2 == BIG) and torch.all(got_i == 0)
        assert torch.all(torch.isinf(want_d2))
