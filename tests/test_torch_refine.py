"""make_refine_fn of the port against sdflabel_tpu.engine.refine: the
per-iteration history and the final parameters, with the warm band on and
off, a NaN loss that the guard skips, and a non-finite leaf gradient that
is zeroed while its Adam moments decay."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.engine import refine as jref
from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.ops import grid as jgrid
from sdflabel_tpu.renderer import rasterer as jrast
from sdflabel_tpu_torch.engine import refine as tref
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.ops import grid as tgrid
from torch_parity_util import jax_tree_to_numpy

CROP = (16, 16)
GRID = 16
CAP = 512


def _decoders():
    """A sphere of radius .45 bent by a small DeepSDF MLP of the latent."""
    spec = dict(latent_size=3, dims=(32, 32, 32), latent_in=(2,))
    jcfg = jds.DeepSDFConfig(**spec)
    jparams = jds.init_params(jcfg, jax.random.PRNGKey(7))
    jmlp = jds.sdf_fn(jcfg, jparams)
    tmlp = tds.sdf_fn(tds.DeepSDFConfig(**spec),
                      tds.params_from_jax(jax_tree_to_numpy(jparams)))

    def jdec(lat, p):
        return jnp.linalg.norm(p, axis=-1) - 0.45 + 0.1 * jmlp(lat, p)

    def tdec(lat, p):
        return torch.linalg.norm(p, dim=-1) - 0.45 + 0.1 * tmlp(lat, p)

    return jdec, tdec


def _crop(jdec):
    """NOCS target and frustum rendered by the JAX package at a ground
    truth pose; the refinement starts from a perturbed one."""
    K = jrast.calibration_matrix(CROP)
    grid_pts = jgrid.generate_point_grid(GRID)
    gt = jref.init_refine_params(0.4, [0.05, -0.02, 4.0], 2.0,
                                 [0.6, 0.0, 0.8])
    surf, _ = jgrid.surface_from_decoder(jdec, gt.latent, grid_pts,
                                         capacity=CAP)
    rendering, points = jrast.render(
        jnp.asarray(K), CROP, surf.points, surf.normals, surf.normals,
        jref.build_render_pose(gt.yaw, gt.trans), point_mask=surf.mask,
        rot="dcm", primitives="disc", output_nocs=True)
    scene = np.asarray(points.xyz)[np.asarray(points.front_mask)] * 2.0
    frustum = np.zeros((1024, 3), np.float32)
    frustum[:len(scene)] = scene[:1024]
    fmask = np.zeros(1024, bool)
    fmask[:min(len(scene), 1024)] = True
    params0 = dict(yaw=0.55, trans=[0.12, 0.03, 4.2], scale=1.8,
                   latent=[0.5, 0.1, 0.85])
    return K, np.asarray(rendering.color), frustum, fmask, params0


def _run_both(cfg_kw, jdec, tdec):
    K, nocs, frustum, fmask, p0 = _crop(jdec)
    jcfg = jref.RefineConfig(surface_capacity=CAP, **cfg_kw)
    tcfg = tref.RefineConfig(surface_capacity=CAP, **cfg_kw)
    jfinal, jhist = jax.jit(jref.make_refine_fn(
        jdec, jcfg, jgrid.generate_point_grid(GRID), jnp.asarray(K), CROP))(
            jref.init_refine_params(**p0), jnp.asarray(nocs),
            jnp.asarray(frustum), jnp.asarray(fmask))
    tfinal, thist = tref.make_refine_fn(
        tdec, tcfg, tgrid.generate_point_grid(GRID), torch.as_tensor(K), CROP,
        device="cpu")(tref.init_refine_params(**p0), torch.as_tensor(nocs),
                      torch.as_tensor(frustum), torch.as_tensor(fmask))
    return jfinal, jhist, tfinal, thist


def _assert_same_run(jfinal, jhist, tfinal, thist):
    # fp32 on both sides, sums in other orders, 5 coupled steps: the
    # losses to rtol 1e-4, the parameters to 1e-5
    assert np.array_equal(thist.applied.numpy(), np.asarray(jhist.applied))
    for f in ("loss", "loss_2d", "loss_3d"):
        np.testing.assert_allclose(getattr(thist, f).numpy(),
                                   np.asarray(getattr(jhist, f)),
                                   rtol=1e-4, atol=1e-7, err_msg=f)
    for f in tref.RefineParams._fields:
        np.testing.assert_allclose(getattr(thist.params, f).numpy(),
                                   np.asarray(getattr(jhist.params, f)),
                                   atol=1e-5, err_msg=f)
        np.testing.assert_allclose(getattr(tfinal, f).numpy(),
                                   np.asarray(getattr(jfinal, f)),
                                   atol=1e-5, err_msg=f)


@pytest.mark.parametrize("warm", [0, 1024])
def test_refine_history_matches_jax(warm):
    jdec, tdec = _decoders()
    out = _run_both(dict(iters=5, warm_band=warm, warm_refresh=2), jdec,
                    tdec)
    _assert_same_run(*out)
    assert out[3].applied.all()


def test_nan_loss_skips_every_step():
    # no 2D minimum clears a zero threshold: the reference's NaN mean
    # (QUIRKS #6); the guard then leaves parameters and optimizer alone
    jdec, tdec = _decoders()
    jfinal, jhist, tfinal, thist = _run_both(
        dict(iters=3, loss2d_threshold=0.0), jdec, tdec)
    _assert_same_run(jfinal, jhist, tfinal, thist)
    assert not thist.applied.any() and torch.isnan(thist.loss).all()
    p0 = tref.init_refine_params(**_crop(jdec)[4])
    for f in tref.RefineParams._fields:
        assert torch.equal(getattr(tfinal, f), getattr(p0, f))


def test_nonfinite_leaf_gradient_is_zeroed_and_adam_decays(monkeypatch):
    # once |trans_x - trans_x0| passes 0.015 the translation's gradient
    # turns NaN: the loss stays finite, so the step is taken with that
    # leaf's gradient zeroed, and its Adam moments keep it moving
    t0 = 0.12

    @jax.custom_vjp
    def jpoison(t):
        return t

    jpoison.defvjp(lambda t: (t, t), lambda t, g: (
        jnp.where(jnp.abs(t[0] - t0) > 0.015, jnp.nan, 1.0) * g,))

    class TPoison(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            ctx.save_for_backward(t)
            return t.clone()

        @staticmethod
        def backward(ctx, g):
            (t,) = ctx.saved_tensors
            bad = (t[0] - t0).abs() > 0.015
            return torch.where(bad, torch.full_like(g, float("nan")), g)

    jbuild, tbuild = jref.build_render_pose, tref.build_render_pose
    monkeypatch.setattr(jref, "build_render_pose",
                        lambda y, t: jbuild(y, jpoison(t)))
    monkeypatch.setattr(tref, "build_render_pose",
                        lambda y, t: tbuild(y, TPoison.apply(t)))
    jdec, tdec = _decoders()
    jfinal, jhist, tfinal, thist = _run_both(dict(iters=6), jdec, tdec)
    _assert_same_run(jfinal, jhist, tfinal, thist)
    assert thist.applied.all()
    tx = thist.params.trans[:, 0].numpy()
    steps = np.abs(np.diff(np.append(tx, tfinal.trans[0].item())))
    poisoned = np.abs(tx - t0) > 0.015
    assert poisoned.any() and not poisoned.all()
    assert (steps[poisoned] > 0).all()  # still moving on decayed moments
