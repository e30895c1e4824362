"""The port's nearest neighbour (kernel 2's plain version) against
sdflabel_tpu's: the index must be exactly equal, ties and a fully masked
row included."""

import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from sdflabel_tpu.ops import knn as jknn
from sdflabel_tpu.ops import nn_pallas
from sdflabel_tpu_torch.ops import knn as tknn


def _tied(n, m, seed):
    # coordinates on a 0.25 lattice: many exactly equal distances
    rng = np.random.RandomState(seed)
    q = rng.randint(-3, 4, (n, 3)).astype(np.float32) * 0.25
    d = rng.randint(-3, 4, (m, 3)).astype(np.float32) * 0.25
    mask = rng.uniform(size=m) > 0.3
    return q, d, mask


def test_nearest_neighbor_matches_jax_exactly():
    q, d, mask = _tied(700, 500, 0)
    jd, ji = jknn.nearest_neighbor(jnp.asarray(q), jnp.asarray(d),
                                   jnp.asarray(mask))
    td, ti = tknn.nearest_neighbor(torch.as_tensor(q), torch.as_tensor(d),
                                   torch.as_tensor(mask))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    # random coordinates, no mask; XLA on the CPU may fuse a square and
    # its sum into one fma, so the distances agree to 1 ulp (rtol 2e-7)
    rng = np.random.RandomState(1)
    q = rng.randn(300, 3).astype(np.float32)
    d = rng.randn(5000, 3).astype(np.float32)
    jd, ji = jknn.nearest_neighbor(jnp.asarray(q), jnp.asarray(d))
    td, ti = tknn.nearest_neighbor(torch.as_tensor(q), torch.as_tensor(d))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=2e-7)


def test_fully_masked_row_gives_index_zero_and_inf():
    q, d, _ = _tied(50, 40, 2)
    none = np.zeros(40, bool)
    jd, ji = jknn.nearest_neighbor(jnp.asarray(q), jnp.asarray(d),
                                   jnp.asarray(none))
    td, ti = tknn.nearest_neighbor(torch.as_tensor(q), torch.as_tensor(d),
                                   torch.as_tensor(none))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert (ti == 0).all() and torch.isinf(td).all()


def test_plain_matches_interpret_mode_kernel_bitwise():
    q, d, mask = _tied(600, 700, 3)
    with pltpu.force_tpu_interpret_mode():
        jd, ji = nn_pallas.nearest_neighbor_fused(
            jnp.asarray(q), jnp.asarray(d), jnp.asarray(mask), qb=256,
            mb=256)
    td2, ti = tknn.nearest_neighbor_plain(torch.as_tensor(q),
                                          torch.as_tensor(d),
                                          torch.as_tensor(mask))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(torch.sqrt(td2).numpy(), np.asarray(jd))


def test_pairwise_sq_dists_matches_jax():
    rng = np.random.RandomState(4)
    a = rng.randn(50, 2).astype(np.float32)
    b = rng.randn(60, 2).astype(np.float32)
    np.testing.assert_allclose(
        tknn.pairwise_sq_dists(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(jknn.pairwise_sq_dists(jnp.asarray(a), jnp.asarray(b))),
        atol=1e-5)
