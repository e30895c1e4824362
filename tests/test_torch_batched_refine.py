"""The port's batched refine (parallel/batched_refine.py, the loop of
engine/refine.py::make_refine_batch_fn) against sdflabel_tpu's
make_batched_refine (jax.vmap of the refine scan): three crops with their
own intrinsics, letterboxed into one bucket with pixel masks and padded to
four lanes, with the warm band on and off; a crop whose 2D loss is NaN at
every step, which the per-crop guard must freeze (parameters and Adam's
count) while the others step; the optimizer step alone against optax
under jnp.where; and each crop against the port's sequential loop, also
with the selection and stage-2 MLPs' plain versions on the loop."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdflabel_tpu.engine import refine as jref
from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.ops import grid as jgrid
from sdflabel_tpu.parallel import batched_refine as jbr
from sdflabel_tpu.renderer import rasterer as jrast
from sdflabel_tpu_torch.engine import refine as tref
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.ops import grid as tgrid, mlp2_cuda, mlp_cuda
from sdflabel_tpu_torch.parallel import batched_refine as tbr
from torch_parity_util import jax_tree_to_numpy

BUCKET = (16, 16)
SIZES = ((16, 16), (12, 16), (16, 10))  # (h, w) of each real crop
GRID = 16
CAP = 512
LANES = 4  # three crops padded to the next power of two
FIELDS = tref.RefineParams._fields


def _decoders():
    """A 3x64 DeepSDF MLP of the latent bending a sphere of radius .45."""
    spec = dict(latent_size=3, dims=(64, 64, 64), latent_in=(2,))
    jcfg = jds.DeepSDFConfig(**spec)
    jparams = jds.init_params(jcfg, jax.random.PRNGKey(3))
    jmlp = jds.sdf_fn(jcfg, jparams)
    tmlp = tds.sdf_fn(tds.DeepSDFConfig(**spec),
                      tds.params_from_jax(jax_tree_to_numpy(jparams)))

    def jdec(lat, p):
        return jnp.linalg.norm(p, axis=-1) - 0.45 + 0.1 * jmlp(lat, p)

    def tdec(lat, p):
        return torch.linalg.norm(p, dim=-1) - 0.45 + 0.1 * tmlp(lat, p)

    return jdec, tdec


@functools.lru_cache(maxsize=None)
def _crops():
    """Per lane: K (its own principal point), the NOCS target rendered by
    the JAX package at a ground-truth pose and letterboxed into the bucket
    with its pixel mask, the frustum and a perturbed start; the last crop
    is repeated into the fourth lane."""
    jdec, _ = _decoders()
    grid_pts = jgrid.generate_point_grid(GRID)
    lanes = []
    for i, (h, w) in enumerate(SIZES):
        K = jrast.calibration_matrix((w, h))
        K[0, 2] += 0.7 * i
        K[1, 2] -= 0.4 * i
        gt = jref.init_refine_params(0.4 + 0.2 * i, [0.05, -0.02, 4.0 + i],
                                     2.0, [0.6, 0.0, 0.8])
        surf, _ = jgrid.surface_from_decoder(jdec, gt.latent, grid_pts,
                                             capacity=CAP)
        rendering, points = jrast.render(
            jnp.asarray(K), (w, h), surf.points, surf.normals, surf.normals,
            jref.build_render_pose(gt.yaw, gt.trans), point_mask=surf.mask,
            rot="dcm", primitives="disc", output_nocs=True)
        nocs = np.zeros((3,) + BUCKET, np.float32)
        nocs[:, :h, :w] = np.asarray(rendering.color)
        pmask = np.zeros(BUCKET, bool)
        pmask[:h, :w] = True
        scene = np.asarray(points.xyz)[np.asarray(points.front_mask)] * 2.0
        frustum = np.zeros((1024, 3), np.float32)
        frustum[:len(scene)] = scene[:1024]
        fmask = np.zeros(1024, bool)
        fmask[:min(len(scene), 1024)] = True
        p0 = dict(yaw=0.55 + 0.2 * i, trans=[0.12, 0.03 - 0.02 * i, 4.2 + i],
                  scale=1.8 + 0.1 * i, latent=[0.5, 0.1 * (i + 1), 0.85])
        lanes.append((K.astype(np.float32), nocs, frustum, fmask, pmask, p0))
    lanes.append(lanes[-1])
    return lanes


def _batch(lanes):
    """The six stacked arguments, as numpy: params0 fields, K, nocs,
    frustum, fmask, pixel mask."""
    p0 = {f: np.stack([np.asarray(jref.init_refine_params(**ln[5])[k])
                       for ln in lanes]) for k, f in enumerate(FIELDS)}
    return (p0, *(np.stack([ln[k] for ln in lanes]) for k in range(5)))


def _cfg_kw(warm):
    return dict(iters=3, surface_capacity=CAP, warm_band=warm,
                warm_refresh=2)


@functools.lru_cache(maxsize=None)
def _jax_fn(warm):
    jdec, _ = _decoders()
    return jbr.make_batched_refine(
        jdec, jref.RefineConfig(**_cfg_kw(warm)),
        jgrid.generate_point_grid(GRID), BUCKET, with_extents=True)


def _run_jax(warm, batch):
    p0, *rest = batch
    return _jax_fn(warm)(jref.RefineParams(**{f: jnp.asarray(v) for f, v in
                                              p0.items()}),
                         *map(jnp.asarray, rest))


def _run_torch(warm, batch):
    _, tdec = _decoders()
    p0, *rest = batch
    fn = tbr.make_batched_refine(
        tdec, tref.RefineConfig(**_cfg_kw(warm)),
        tgrid.generate_point_grid(GRID), BUCKET, with_extents=True,
        device="cpu")
    return fn(tref.RefineParams(**{f: torch.as_tensor(v) for f, v in
                                   p0.items()}),
              *map(torch.as_tensor, rest))


def _assert_same(jout, tout, atol=1e-4):
    (jfinal, jhist, jext), (tfinal, thist, text) = jout, tout
    assert np.array_equal(thist.applied.numpy(), np.asarray(jhist.applied))
    for f in ("loss", "loss_2d", "loss_3d"):
        np.testing.assert_allclose(getattr(thist, f).numpy(),
                                   np.asarray(getattr(jhist, f)),
                                   rtol=1e-4, atol=1e-7, err_msg=f)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(thist.params, f).numpy(),
                                   np.asarray(getattr(jhist.params, f)),
                                   atol=atol, err_msg=f)
        np.testing.assert_allclose(getattr(tfinal, f).numpy(),
                                   np.asarray(getattr(jfinal, f)),
                                   atol=atol, err_msg=f)
    assert np.array_equal(text.valid.numpy(), np.asarray(jext.valid))
    for f in ("mn", "mx"):
        np.testing.assert_allclose(getattr(text, f).numpy(),
                                   np.asarray(getattr(jext, f)), atol=1e-4,
                                   err_msg=f)


@pytest.mark.parametrize("warm", [0, 1024])
def test_batched_refine_matches_jax(warm):
    # fp32 on both sides, sums in other orders, 3 coupled steps: 1e-4
    batch = _batch(_crops())
    tout = _run_torch(warm, batch)
    _assert_same(_run_jax(warm, batch), tout)
    assert tout[1].applied.all()
    assert tout[1].loss.shape == (LANES, 3)
    # the padded lane repeats the last crop exactly
    for f in FIELDS:
        assert torch.equal(getattr(tout[0], f)[3], getattr(tout[0], f)[2])


def test_guarded_crop_keeps_parameters_and_adam_count():
    # crop 1 sees its NOCS target only on a 3x3 patch of rendered pixels,
    # at 50: every in-disc minimum stays above the 1.0 threshold and no
    # zero-weight pixel exists, so its 2D mean is empty (NaN, QUIRKS #6)
    # at every step; the guard skips each of its steps, the other crops
    # step as before
    lanes = list(_crops())
    K, nocs, frustum, fmask, pmask, p0 = lanes[1]
    patch = np.zeros_like(pmask)
    patch[6:9, 6:9] = True
    nocs = np.where(patch[None], 50.0, nocs).astype(np.float32)
    lanes[1] = (K, nocs, frustum, fmask, patch, p0)
    batch = _batch(lanes)
    jout, tout = _run_jax(0, batch), _run_torch(0, batch)
    _assert_same(jout, tout)
    applied = tout[1].applied.numpy()
    assert not applied[1].any() and applied[[0, 2, 3]].all()
    assert np.isnan(tout[1].loss_2d[1].numpy()).all()
    for f in FIELDS:
        assert np.array_equal(getattr(tout[0], f)[1].numpy(), batch[0][f][1])
        assert np.array_equal(np.asarray(getattr(jout[0], f))[1],
                              batch[0][f][1])
        # the other crops match the unguarded run: no NaN crossed crops
    clean = _run_torch(0, _batch(_crops()))
    for f in FIELDS:
        for i in (0, 2, 3):
            assert torch.equal(getattr(tout[0], f)[i],
                               getattr(clean[0], f)[i])


def test_batch_step_matches_optax_under_the_guard():
    # five steps of make_optimizer under jnp.where(ok, new, old), with ok
    # toggling per crop and a non-finite leaf gradient: parameters, Adam's
    # count (a lane per crop) and moments agree
    cfg = tref.RefineConfig()
    jopt = jref.make_optimizer(jref.RefineConfig())
    rng = np.random.RandomState(0)
    b = 3
    p = {"yaw": rng.randn(b, 1), "trans": rng.randn(b, 3),
         "scale": rng.rand(b, 1) + 1, "latent": rng.randn(b, 3)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    jp = jref.RefineParams(**{k: jnp.asarray(v) for k, v in p.items()})
    jstate = jax.vmap(jopt.init)(jp)
    tp = tref.RefineParams(**{k: torch.as_tensor(v) for k, v in p.items()})
    tstate = tref.init_batch_opt_state(tp)
    oks = np.array([[1, 0, 1], [0, 0, 1], [1, 1, 1], [1, 0, 0], [1, 1, 1]],
                   bool)

    def jstep(params, state, grads, ok):
        grads = jax.tree.map(
            lambda g: jnp.where(ok & jnp.isfinite(g).all(), g, 0.0), grads)
        upd, new_state = jopt.update(grads, state, params)
        new = optax.apply_updates(params, upd)
        return (jax.tree.map(lambda n, o: jnp.where(ok, n, o), new, params),
                jax.tree.map(lambda n, o: jnp.where(ok, n, o), new_state,
                             state))

    for step, ok in enumerate(oks):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
        if step == 3:
            g["trans"][0, 1] = np.nan  # crop 0's trans steps on zero
        jp, jstate = jax.vmap(jstep)(
            jp, jstate, jref.RefineParams(**{k: jnp.asarray(v)
                                             for k, v in g.items()}),
            jnp.asarray(ok))
        tp, tstate = tref.batch_step(
            cfg, tp, [torch.as_tensor(g[f]) for f in FIELDS],
            torch.as_tensor(ok), tstate)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    adam_yaw, adam_trans = jstate.inner_states["adam_yaw"].inner_state[0], \
        jstate.inner_states["adam_trans"].inner_state[0]
    want_count = oks.sum(0)
    for adam, k, f in ((adam_yaw, 0, "yaw"), (adam_trans, 1, "trans")):
        assert np.array_equal(np.asarray(adam.count), want_count)
        np.testing.assert_allclose(tstate.mu[k].numpy(),
                                   np.asarray(getattr(adam.mu, f)),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(tstate.nu[k].numpy(),
                                   np.asarray(getattr(adam.nu, f)),
                                   rtol=1e-6, atol=1e-8)
    assert np.array_equal(tstate.count.numpy(), want_count)


@pytest.mark.parametrize("warm", [0, 1024])
def test_batched_refine_matches_sequential_port_per_crop(warm):
    # each lane as the sequential loop refines it alone in the same bucket
    # with the same pixel mask: 1e-5
    lanes = _crops()
    batch = _batch(lanes)
    tfinal, thist, _ = _run_torch(warm, batch)
    _, tdec = _decoders()
    for i, (K, nocs, frustum, fmask, pmask, p0) in enumerate(lanes[:3]):
        final, hist = tref.make_refine_fn(
            tdec, tref.RefineConfig(**_cfg_kw(warm)),
            tgrid.generate_point_grid(GRID), torch.as_tensor(K), BUCKET,
            device="cpu")(tref.init_refine_params(**p0),
                          *map(torch.as_tensor, (nocs, frustum, fmask,
                                                 pmask)))
        assert torch.equal(hist.applied, thist.applied[i])
        np.testing.assert_allclose(thist.loss[i].numpy(), hist.loss.numpy(),
                                   rtol=1e-5)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(tfinal, f)[i].numpy(),
                                       getattr(final, f).numpy(), atol=1e-5,
                                       err_msg=f"crop {i} {f}")


@pytest.mark.parametrize("warm", [0, 512])
def test_batched_refine_with_mlp_kernels_matches_sequential_port(warm):
    # the selection MLP (kernel 3, a latent per crop) and the stage-2
    # decode (kernels 4a and 4b, once per crop) in their plain versions, on
    # tests/test_torch_stage2.py's 6x128 net and scene: each lane as the
    # sequential loop refines it alone, 1e-5
    spec = dict(latent_size=3, dims=(128,) * 6, norm_layers=tuple(range(6)),
                latent_in=(3,), weight_norm=True)
    cfg = tds.DeepSDFConfig(**spec)
    params = tds.params_from_jax(jax_tree_to_numpy(jds.init_params(
        jds.DeepSDFConfig(**spec), jax.random.PRNGKey(7))))
    kw = dict(select_decoder=mlp_cuda.select_fn(cfg, params),
              stage2_fn=mlp2_cuda.stage2_fn(cfg, params))
    assert None not in kw.values()
    dec = tds.sdf_fn(cfg, params)
    rcfg = tref.RefineConfig(iters=2, surface_capacity=256, warm_band=warm,
                             warm_refresh=2)
    rng = np.random.RandomState(2)
    lanes = []
    for i in range(2):
        K = jrast.calibration_matrix(BUCKET[::-1])
        K[0, 2] += i
        lanes.append((K, rng.rand(3, *BUCKET).astype(np.float32),
                      (rng.randn(512, 3) + [0, 0, 4.0]).astype(np.float32),
                      np.ones(512, bool), np.ones(BUCKET, bool),
                      dict(yaw=0.3 + 0.1 * i, trans=[0, 0, 4.0], scale=2.0,
                           latent=[0.7, -0.2, 0.4 + 0.1 * i])))
    p0, *rest = _batch(lanes)
    tfinal, thist = tbr.make_batched_refine(
        dec, rcfg, tgrid.generate_point_grid(GRID), BUCKET, device="cpu",
        **kw)(tref.RefineParams(**{f: torch.as_tensor(v)
                                   for f, v in p0.items()}),
              *map(torch.as_tensor, rest))
    assert thist.applied.all()
    for i, (K, nocs, frustum, fmask, pmask, p0_i) in enumerate(lanes):
        final, hist = tref.make_refine_fn(
            dec, rcfg, tgrid.generate_point_grid(GRID), torch.as_tensor(K),
            BUCKET, device="cpu", **kw)(
                tref.init_refine_params(**p0_i),
                *map(torch.as_tensor, (nocs, frustum, fmask, pmask)))
        np.testing.assert_allclose(thist.loss[i].numpy(), hist.loss.numpy(),
                                   rtol=1e-5)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(tfinal, f)[i].numpy(),
                                       getattr(final, f).numpy(), atol=1e-5,
                                       err_msg=f"crop {i} {f}")
