"""The stage-2 decode (kernels 4a, 4b: packing, plain version, the refine
seam) against sdflabel_tpu.ops.mlp2_pallas: its emulate_stage2 and its
Pallas kernels in interpret mode, on the 6x128 net of
tests/test_mlp2_pallas.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdflabel_tpu.engine import refine as jref
from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.ops import grid as jgrid, mlp2_pallas, mlp_pallas
from sdflabel_tpu.renderer import rasterer as jrast
from sdflabel_tpu_torch.engine import refine as tref
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.ops import grid as tgrid, mlp2_cuda, mlp_cuda
from torch_parity_util import jax_tree_to_numpy

SPEC = dict(latent_size=3, dims=(128,) * 6, norm_layers=tuple(range(6)),
            latent_in=(3,), weight_norm=True, xyz_in_all=False)
LATENT = np.array([0.7, -0.2, 0.4], np.float32)


@pytest.fixture(scope="module")
def arch():
    jcfg = jds.DeepSDFConfig(**SPEC)
    jparams = jds.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = tds.DeepSDFConfig(**SPEC)
    tparams = tds.params_from_jax(jax_tree_to_numpy(jparams))
    jpack = mlp_pallas.pack_select_mlp(jcfg, jparams)
    # the JAX pack carried across, so that the arithmetic is compared on
    # identical weights
    tpack = mlp_cuda.PackedSelectMLP(
        *(torch.as_tensor(np.asarray(getattr(jpack, f), np.float32)).to(
            torch.bfloat16 if f == "ws" else torch.float32)
          for f in ("ws", "wx", "wlat", "bias", "wlast", "scal")),
        width=jpack.width, n_hidden=jpack.n_hidden,
        use_tanh=jpack.use_tanh)
    jstage2 = mlp2_pallas.pallas_stage2_fn(jcfg, jparams, block=256)
    return jcfg, jparams, tcfg, tparams, jpack, tpack, jstage2


def test_pack_matches_jax(arch):
    _, _, tcfg, tparams, jpack, _, _ = arch
    tp = mlp_cuda.pack_select_mlp(tcfg, tparams)
    # weight-norm folds with last-ulp differences that may round a bf16
    # weight the other way: one bf16 ulp (2^-7 relative); fp32 to 1e-6
    for f in ("ws", "wx", "wlat", "bias", "wlast", "scal"):
        tol = 2.0 ** -7 if f == "ws" else 1e-6
        np.testing.assert_allclose(getattr(tp, f).float().numpy(),
                                   np.asarray(getattr(jpack, f), np.float32),
                                   rtol=tol, atol=1e-7, err_msg=f)
    assert (tp.width, tp.n_hidden, tp.use_tanh) == (
        jpack.width, jpack.n_hidden, jpack.use_tanh) == (128, 5, False)


def test_plain_forward_matches_jax_emulation_and_kernel(arch):
    *_, jpack, tpack, jstage2 = arch
    pts = np.random.RandomState(0).uniform(-1, 1, (500, 3)).astype(
        np.float32)
    sdf, g = mlp2_cuda.emulate_stage2(tpack, torch.as_tensor(LATENT),
                                      torch.as_tensor(pts))
    sdf, g = sdf.detach().numpy(), g.numpy()
    sdf_e, g_e = mlp2_pallas.emulate_stage2(jpack, jnp.asarray(LATENT),
                                            jnp.asarray(pts))
    with pltpu.force_tpu_interpret_mode():
        sdf_k, g_k = jstage2(jnp.asarray(LATENT), jnp.asarray(pts))
    # tests/test_mlp2_pallas.py:40-45: sdf atol 2e-5 / rtol 1e-4, normals
    # 5e-3 of their largest element (JAX's emulation rounds the product's
    # result to bf16 in its backward, the kernels and the port's plain
    # version round the cotangent before the product)
    for ref_sdf, ref_g in ((sdf_e, g_e), (sdf_k, g_k)):
        np.testing.assert_allclose(sdf, np.asarray(ref_sdf), atol=2e-5,
                                   rtol=1e-4)
        scale = np.abs(np.asarray(ref_g)).max()
        np.testing.assert_allclose(g / scale, np.asarray(ref_g) / scale,
                                   atol=5e-3)
    # the same casts in the same places as JAX's emulation forward and the
    # kernel's sweep: sums in other orders only
    np.testing.assert_allclose(sdf, np.asarray(sdf_e), atol=1e-6)
    np.testing.assert_allclose(g, np.asarray(g_k),
                               atol=1e-4 * np.abs(np.asarray(g_k)).max())


def test_plain_backward_matches_jax(arch):
    *_, jpack, tpack, jstage2 = arch
    rng = np.random.RandomState(1)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    w = rng.randn(300).astype(np.float32)

    def jloss(stage2):
        def f(lat, p):
            sdf, g = stage2(lat, p)
            return jnp.sum(w * sdf) + 0.0 * jnp.sum(jax.lax.stop_gradient(g))
        return f

    with pltpu.force_tpu_interpret_mode():
        val_k, (gl_k, gp_k) = jax.value_and_grad(
            jloss(jstage2), argnums=(0, 1))(jnp.asarray(LATENT),
                                            jnp.asarray(pts))
    val_e, (gl_e, gp_e) = jax.value_and_grad(
        jloss(lambda lat, p: mlp2_pallas.emulate_stage2(jpack, lat, p)),
        argnums=(0, 1))(jnp.asarray(LATENT), jnp.asarray(pts))

    lat = torch.tensor(LATENT, requires_grad=True)
    p = torch.tensor(pts, requires_grad=True)
    sdf, _ = mlp2_cuda.stage2_apply(tpack, lat, p)
    val = (torch.as_tensor(w) * sdf).sum()
    gl, gp = torch.autograd.grad(val, (lat, p))
    # tests/test_mlp2_pallas.py:90-102: the value to rtol 5e-5, d_latent
    # and d_points within 5e-3 of their largest element
    for v, l_ref, p_ref in ((val_k, gl_k, gp_k), (val_e, gl_e, gp_e)):
        np.testing.assert_allclose(val.item(), float(v), rtol=5e-5)
        for got, ref in ((gl, l_ref), (gp, p_ref)):
            s = max(float(np.abs(np.asarray(ref)).max()), 1e-20)
            np.testing.assert_allclose(got.numpy() / s, np.asarray(ref) / s,
                                       atol=5e-3)


def test_refine_with_plain_stage2_tracks_jax_kernel(arch):
    jcfg, jparams, tcfg, tparams, _, _, jstage2 = arch
    grid_n, cap, crop = 16, 256, (16, 16)
    K = jrast.calibration_matrix(crop)
    rng = np.random.RandomState(2)
    nocs = rng.rand(3, *crop).astype(np.float32)
    fr = (rng.randn(512, 3) + [0, 0, 4.0]).astype(np.float32)
    fm = np.ones(512, bool)
    p0 = dict(yaw=0.3, trans=[0, 0, 4.0], scale=2.0, latent=[0.7, -0.2, 0.4])

    jfn = jref.make_refine_fn(
        jds.sdf_fn(jcfg, jparams), jref.RefineConfig(
            iters=3, surface_capacity=cap), jgrid.generate_point_grid(grid_n),
        jnp.asarray(K), crop, stage2_fn=jstage2)
    with pltpu.force_tpu_interpret_mode():
        jfinal, jhist = jfn(jref.init_refine_params(**p0), jnp.asarray(nocs),
                            jnp.asarray(fr), jnp.asarray(fm))
    stage2 = mlp2_cuda.stage2_fn(tcfg, tparams)
    tfn = tref.make_refine_fn(
        tds.sdf_fn(tcfg, tparams), tref.RefineConfig(
            iters=3, surface_capacity=cap), tgrid.generate_point_grid(grid_n),
        torch.as_tensor(K), crop, stage2_fn=stage2, device="cpu")
    tfinal, thist = tfn(tref.init_refine_params(**p0), torch.as_tensor(nocs),
                        torch.as_tensor(fr), torch.as_tensor(fm))
    # tests/test_mlp2_pallas.py:133-139
    loss = thist.loss.numpy()
    assert np.isfinite(loss).all() and thist.applied.all()
    np.testing.assert_allclose(loss, np.asarray(jhist.loss), rtol=5e-3,
                               atol=1e-4)
    np.testing.assert_allclose(tfinal.trans.numpy(), np.asarray(jfinal.trans),
                               atol=5e-3)
    np.testing.assert_allclose(tfinal.latent.numpy(),
                               np.asarray(jfinal.latent), atol=1e-3)


@pytest.mark.parametrize("width", [64, 96])
def test_stage2_fn_refuses_what_the_packer_refuses(width):
    spec = dict(SPEC, dims=(width,) * 6)
    jcfg = jds.DeepSDFConfig(**spec)
    jparams = jds.init_params(jcfg, jax.random.PRNGKey(0))
    assert mlp2_pallas.pallas_stage2_fn(jcfg, jparams) is None
    tparams = tds.params_from_jax(jax_tree_to_numpy(jparams))
    assert mlp2_cuda.stage2_fn(tds.DeepSDFConfig(**spec), tparams) is None
