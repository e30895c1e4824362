"""The stage-2 decode (kernels 4a, 4b) with a crop axis, as the batched
driver calls it, against jax.vmap of the JAX kernels in interpret mode
(the way tests/test_torch_stage2.py runs them on the CPU), on that file's
6x128 net: the plain version's forward and loss backward for a latent and
points per crop, ops/grid.py::_stage2_surface with a crop axis, and three
iterations of the batched refine with the stage-2 seam against JAX's
make_batched_refine with its Pallas stage 2. Each crop of the plain
batched route also equals its single-crop call bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sdflabel_tpu.engine import refine as jref
from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.ops import grid as jgrid, mlp2_pallas, mlp_pallas
from sdflabel_tpu.parallel import batched_refine as jbr
from sdflabel_tpu.renderer import rasterer as jrast
from sdflabel_tpu_torch.engine import refine as tref
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.ops import grid as tgrid, mlp2_cuda, mlp_cuda
from sdflabel_tpu_torch.parallel import batched_refine as tbr
from torch_parity_util import jax_tree_to_numpy

SPEC = dict(latent_size=3, dims=(128,) * 6, norm_layers=tuple(range(6)),
            latent_in=(3,), weight_norm=True, xyz_in_all=False)
B = 3
FIELDS = tref.RefineParams._fields


@pytest.fixture(scope="module")
def arch():
    jcfg = jds.DeepSDFConfig(**SPEC)
    jparams = jds.init_params(jcfg, jax.random.PRNGKey(7))
    tcfg = tds.DeepSDFConfig(**SPEC)
    tparams = tds.params_from_jax(jax_tree_to_numpy(jparams))
    jpack = mlp_pallas.pack_select_mlp(jcfg, jparams)
    # the JAX pack carried across: the arithmetic compared on identical
    # weights
    tpack = mlp_cuda.PackedSelectMLP(
        *(torch.as_tensor(np.asarray(getattr(jpack, f), np.float32)).to(
            torch.bfloat16 if f == "ws" else torch.float32)
          for f in ("ws", "wx", "wlat", "bias", "wlast", "scal")),
        width=jpack.width, n_hidden=jpack.n_hidden,
        use_tanh=jpack.use_tanh)
    return jcfg, jparams, tcfg, tparams, jpack, tpack


def _inputs(seed, n=128):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-1, 1, (B, n, 3)).astype(np.float32)
    lat = rng.randn(B, 3).astype(np.float32)
    lat /= np.linalg.norm(lat, axis=-1, keepdims=True)
    return lat, pts, rng.randn(B, n).astype(np.float32)


def _jcvec(jpack, lat):
    return jpack.bias + jnp.einsum("l,jlh->jh", lat, jpack.wlat)


def test_batched_forward_matches_vmapped_interpret_mode_kernel(arch):
    # tests/test_mlp2_pallas.py:40-45, per crop: sdf atol 2e-5 / rtol
    # 1e-4, raw normals within 5e-3 of their largest element
    *_, jpack, tpack = arch
    lat, pts, _ = _inputs(0)
    with pltpu.force_tpu_interpret_mode():
        jsdf, jg = jax.vmap(lambda la, p: mlp2_pallas.stage2_fwd_apply(
            jpack, _jcvec(jpack, la), p, block=128))(jnp.asarray(lat),
                                                     jnp.asarray(pts))
    sdf, g = mlp2_cuda.stage2_apply(tpack, torch.as_tensor(lat),
                                    torch.as_tensor(pts))
    assert sdf.shape == (B, pts.shape[1]) and g.shape == pts.shape
    for b in range(B):
        np.testing.assert_allclose(sdf[b].detach().numpy(),
                                   np.asarray(jsdf[b]), atol=2e-5, rtol=1e-4)
        scale = np.abs(np.asarray(jg[b])).max()
        np.testing.assert_allclose(g[b].numpy() / scale,
                                   np.asarray(jg[b]) / scale, atol=5e-3)
        one_sdf, one_g = mlp2_cuda.stage2_apply(
            tpack, torch.as_tensor(lat[b]), torch.as_tensor(pts[b]))
        assert torch.equal(sdf[b], one_sdf) and torch.equal(g[b], one_g)


def test_batched_backward_matches_vmapped_interpret_mode_kernel(arch):
    # tests/test_mlp2_pallas.py:90-102, per crop: d_cvec and d_points
    # within 5e-3 of their largest element; each crop's d_cvec from its
    # own points only
    *_, jpack, tpack = arch
    lat, pts, ct = _inputs(1)
    jcv = jax.vmap(lambda la: _jcvec(jpack, la))(jnp.asarray(lat))
    with pltpu.force_tpu_interpret_mode():
        jdcv, jdp = jax.vmap(lambda c, p, t: mlp2_pallas.stage2_bwd_apply(
            jpack, c, p, t, block=128))(jcv, jnp.asarray(pts),
                                        jnp.asarray(ct))
    cvec = mlp_cuda._cvec(tpack, torch.as_tensor(lat)).requires_grad_(True)
    p = torch.tensor(pts, requires_grad=True)
    sdf = torch.stack([mlp2_cuda.stage2_plain(tpack, cvec[b], p[b])
                       for b in range(B)])
    dcv, dp = torch.autograd.grad(sdf, (cvec, p), torch.as_tensor(ct))
    assert dcv.shape == jdcv.shape and dp.shape == jdp.shape
    for b in range(B):
        for got, ref in ((dcv[b], jdcv[b]), (dp[b], jdp[b])):
            s = float(np.abs(np.asarray(ref)).max())
            np.testing.assert_allclose(got.numpy() / s, np.asarray(ref) / s,
                                       atol=5e-3)
    # the latent's gradient through the batched seam equals each crop's
    tl = torch.tensor(lat, requires_grad=True)
    tp = torch.tensor(pts, requires_grad=True)
    s_b, _ = mlp2_cuda.stage2_apply(tpack, tl, tp)
    gl, gp = torch.autograd.grad(s_b, (tl, tp), torch.as_tensor(ct))
    for b in range(B):
        l1 = torch.tensor(lat[b], requires_grad=True)
        p1 = torch.tensor(pts[b], requires_grad=True)
        s1, _ = mlp2_cuda.stage2_apply(tpack, l1, p1)
        g1l, g1p = torch.autograd.grad(s1, (l1, p1), torch.as_tensor(ct[b]))
        assert torch.equal(gl[b], g1l) and torch.equal(gp[b], g1p)


def test_batched_stage2_surface_matches_vmapped_jax(arch):
    # the surface built on the seam with a crop axis: the sdf's limits
    # carry to the projected points (their sdf * unit normal), the mask
    # may flip only within the sdf's limit of the threshold
    jcfg, jparams, tcfg, tparams, jpack, tpack = arch
    lat, pts, _ = _inputs(2)
    pts *= 0.6
    jstage2 = mlp2_pallas.pallas_stage2_fn(jcfg, jparams, block=128)
    with pltpu.force_tpu_interpret_mode():
        js = jax.vmap(lambda la, p: jgrid._stage2_surface(
            None, la, p, 0.03, stage2_fn=jstage2))(jnp.asarray(lat),
                                                   jnp.asarray(pts))
    tstage2 = mlp2_cuda.stage2_fn(tcfg, tparams)
    ts = tgrid._stage2_surface(None, torch.as_tensor(lat),
                               torch.as_tensor(pts), 0.03, stage2_fn=tstage2)
    assert ts.points.shape == (B, 128, 3) and ts.mask.shape == (B, 128)
    np.testing.assert_allclose(ts.points.detach().numpy(),
                               np.asarray(js.points), atol=1e-4)
    np.testing.assert_allclose(ts.nocs.detach().numpy(), np.asarray(js.nocs),
                               atol=5e-5)
    sdf, _ = mlp2_pallas.emulate_stage2(jpack, jnp.asarray(lat[0]),
                                        jnp.asarray(pts[0]))
    near = np.abs(np.abs(np.asarray(sdf)) - 0.03) < 1e-4
    assert np.array_equal(ts.mask[0].numpy()[~near],
                          np.asarray(js.mask[0])[~near])
    assert (ts.mask.numpy() == np.asarray(js.mask)).mean() > 0.99
    for b in range(B):
        one = tgrid._stage2_surface(None, torch.as_tensor(lat[b]),
                                    torch.as_tensor(pts[b]), 0.03,
                                    stage2_fn=tstage2)
        for f in one._fields:
            assert torch.equal(getattr(ts, f)[b], getattr(one, f)), f


def test_batched_refine_with_stage2_matches_jax(arch):
    # three iterations of the batched loop with the stage-2 seam (its plain
    # version on the CPU) against JAX's make_batched_refine with its Pallas
    # stage 2 in interpret mode; two crops of the 6x128 net, a letterboxed
    # one, padded lanes repeating the last crop
    jcfg, jparams, tcfg, tparams, _, _ = arch
    bucket, grid_n, cap = (16, 16), 16, 128
    rng = np.random.RandomState(3)
    lanes = []
    for i, (h, w) in enumerate(((16, 16), (12, 16))):
        K = jrast.calibration_matrix((w, h))
        K[0, 2] += i
        pm = np.zeros(bucket, bool)
        pm[:h, :w] = True
        lanes.append((K.astype(np.float32),
                      rng.rand(3, *bucket).astype(np.float32),
                      (rng.randn(512, 3) + [0, 0, 4.0]).astype(np.float32),
                      np.ones(512, bool), pm,
                      dict(yaw=0.3 + 0.1 * i, trans=[0, 0, 4.0], scale=2.0,
                           latent=[0.7, -0.2, 0.4 + 0.1 * i])))
    p0 = {f: np.stack([np.asarray(jref.init_refine_params(**ln[5])[k])
                       for ln in lanes]) for k, f in enumerate(FIELDS)}
    rest = [np.stack([ln[k] for ln in lanes]) for k in range(5)]
    kw = dict(iters=3, surface_capacity=cap)
    jfn = jbr.make_batched_refine(
        jds.sdf_fn(jcfg, jparams), jref.RefineConfig(**kw),
        jgrid.generate_point_grid(grid_n), bucket,
        stage2_fn=mlp2_pallas.pallas_stage2_fn(jcfg, jparams, block=128))
    with pltpu.force_tpu_interpret_mode():
        jfinal, jhist = jfn(jref.RefineParams(**{
            f: jnp.asarray(v) for f, v in p0.items()}),
            *map(jnp.asarray, rest))
    tfinal, thist = tbr.make_batched_refine(
        tds.sdf_fn(tcfg, tparams), tref.RefineConfig(**kw),
        tgrid.generate_point_grid(grid_n), bucket,
        stage2_fn=mlp2_cuda.stage2_fn(tcfg, tparams), device="cpu")(
            tref.RefineParams(**{f: torch.as_tensor(v)
                                 for f, v in p0.items()}),
            *map(torch.as_tensor, rest))
    assert thist.applied.all() and np.asarray(jhist.applied).all()
    np.testing.assert_allclose(thist.loss.numpy(), np.asarray(jhist.loss),
                               rtol=1e-4, atol=1e-7)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tfinal, f).numpy(),
                                   np.asarray(getattr(jfinal, f)), atol=1e-4,
                                   err_msg=f)
