"""The sequential refine steps with optax's arithmetic, as the batched
refine and JAX do (engine/refine.py::make_refine_fn through batch_step).
With torch.optim.Adam it rounded each update another way: over 6 steps
its parameters left JAX's by 4.8e-7 and the batched loop's lane of the
same crop by as much, and on the seeded 8x512 decoder such an ulp grows to
centimetres in 60 steps (scripts/batched_lanes_jax.py). Now the
sequential loop equals the batched loop at B = 1 bit for bit and stays
within 1e-7 of JAX's make_refine_fn over 6 steps in fp32, with the warm
band on and off."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.engine import refine as jref
from sdflabel_tpu.ops import grid as jgrid
from sdflabel_tpu_torch.engine import refine as tref
from sdflabel_tpu_torch.ops import grid as tgrid
from test_torch_batched_refine import (BUCKET, CAP, GRID, _batch, _crops,
                                       _decoders)

ITERS = 6


@pytest.mark.parametrize("warm", [0, 1024])
def test_sequential_refine_steps_as_jax_and_the_batched_lane(warm):
    kw = dict(iters=ITERS, surface_capacity=CAP, warm_band=warm,
              warm_refresh=2)
    jdec, tdec = _decoders()
    lanes = _crops()
    p0, *rest = _batch(lanes)
    K, nocs, frustum, fmask, pmask, _ = lanes[0]
    start = {f: v[0] for f, v in p0.items()}
    _, seq = tref.make_refine_fn(
        tdec, tref.RefineConfig(**kw), tgrid.generate_point_grid(GRID),
        torch.as_tensor(K), BUCKET, device="cpu")(
            tref.RefineParams(**{f: torch.as_tensor(v)
                                 for f, v in start.items()}),
            *map(torch.as_tensor, (nocs, frustum, fmask, pmask)))
    _, lane = tref.make_refine_batch_fn(
        tdec, tref.RefineConfig(**kw), tgrid.generate_point_grid(GRID),
        BUCKET, device="cpu")(
            tref.RefineParams(**{f: torch.as_tensor(v[:1])
                                 for f, v in p0.items()}),
            *(torch.as_tensor(r[:1]) for r in rest))
    _, jax_hist = jref.make_refine_fn(
        jdec, jref.RefineConfig(**kw), jgrid.generate_point_grid(GRID),
        jnp.asarray(K), BUCKET)(
            jref.RefineParams(**{f: jnp.asarray(v)
                                 for f, v in start.items()}),
            *map(jnp.asarray, (nocs, frustum, fmask, pmask)))
    assert seq.applied.all() and torch.equal(seq.applied, lane.applied[0])
    for a, b, j in zip(seq.params, lane.params, jax_hist.params):
        assert torch.equal(a, b[0])
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-7)
