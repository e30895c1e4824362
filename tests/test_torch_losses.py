"""sdflabel_tpu_torch.engine.losses against sdflabel_tpu.engine.losses:
the 3D NN loss and both forms of the 2D NOCS loss, values and gradients,
including the NaN of an empty 2D mean (QUIRKS #6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.engine import losses as jl
from sdflabel_tpu_torch.engine import losses as tl


def _clouds(seed=0, n=400, m=600):
    rng = np.random.RandomState(seed)
    rend = rng.randn(n, 3).astype(np.float32) * 0.5
    rmask = rng.uniform(size=n) > 0.2
    scene = (rend[rng.randint(0, n, m)]
             + rng.randn(m, 3).astype(np.float32) * 0.05)
    fmask = rng.uniform(size=m) > 0.1
    return rend, rmask, scene, fmask


def test_loss_3d_and_gradient_match_jax():
    rend, rmask, scene, fmask = _clouds()
    scale = np.array([1.7], np.float32)

    def jfn(r, s, sc):
        return jl.loss_3d(r, jnp.asarray(rmask), s / sc.reshape(()),
                          jnp.asarray(fmask), sc)

    jv, jg = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        *map(jnp.asarray, (rend, scene, scale)))
    args = [torch.as_tensor(a).requires_grad_(True)
            for a in (rend, scene, scale)]
    tv = tl.loss_3d(args[0], torch.as_tensor(rmask),
                    args[1] / args[2].reshape(()), torch.as_tensor(fmask),
                    args[2])
    tg = torch.autograd.grad(tv, args)
    # fp32 sums in another order: rtol 1e-5
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    total, cnt = tl.loss_3d_terms(args[0], torch.as_tensor(rmask),
                                  args[1], torch.as_tensor(fmask), args[2])
    jt, jc = jl.loss_3d_terms(jnp.asarray(rend), jnp.asarray(rmask),
                              jnp.asarray(scene), jnp.asarray(fmask),
                              jnp.asarray(scale))
    assert int(cnt) == int(jc)
    np.testing.assert_allclose(float(total), float(jt), rtol=1e-5)


def _images(seed, h, w, empty_frac=0.5):
    rng = np.random.RandomState(seed)
    rend = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    rend[:, rng.uniform(size=(h, w)) < empty_frac] = 0.0
    css = np.clip(rend + rng.randn(3, h, w).astype(np.float32) * 0.05, 0, 1)
    pmask = np.ones((h, w), bool)
    pmask[:, w - 3:] = False
    return rend, css.astype(np.float32), pmask


@pytest.mark.parametrize("windowed", [False, True])
def test_loss_2d_forms_match_jax(windowed):
    rend, css, pmask = _images(1, 14, 18)
    for pm in (None, pmask):
        def jfn(r):
            return jl.loss_2d(r, jnp.asarray(css),
                              pixel_mask=None if pm is None
                              else jnp.asarray(pm), windowed=windowed)

        jv, jg = jax.value_and_grad(jfn)(jnp.asarray(rend))
        r = torch.as_tensor(rend).requires_grad_(True)
        tv = tl.loss_2d(r, torch.as_tensor(css),
                        pixel_mask=None if pm is None
                        else torch.as_tensor(pm), windowed=windowed)
        (tg,) = torch.autograd.grad(tv, r)
        np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6)
    # the two forms compute one function
    np.testing.assert_allclose(
        float(tl.loss_2d(torch.as_tensor(rend), torch.as_tensor(css),
                         windowed=windowed)),
        float(tl.loss_2d(torch.as_tensor(rend), torch.as_tensor(css),
                         windowed=not windowed)), rtol=1e-5)


def test_loss_2d_empty_cases():
    rend, css, _ = _images(2, 8, 8)
    zero = np.zeros_like(rend)
    for windowed in (False, True):
        # nothing rendered: 0 (no mean taken)
        assert float(tl.loss_2d(torch.as_tensor(zero), torch.as_tensor(css),
                                windowed=windowed)) == 0.0
        # rendered, but no minimum clears the threshold: the reference's
        # NaN mean of nothing (QUIRKS #6), as in JAX
        tv = tl.loss_2d(torch.as_tensor(rend), torch.as_tensor(css),
                        threshold_nocs=0.0, windowed=windowed)
        jv = jl.loss_2d(jnp.asarray(rend), jnp.asarray(css),
                        threshold_nocs=0.0, windowed=windowed)
        assert np.isnan(float(tv)) and np.isnan(float(jv))


def test_disc_offsets_match_jax():
    for diam in (1.5, 5.0, 6.3):
        assert tl.disc_offsets(diam) == jl.disc_offsets(diam)
