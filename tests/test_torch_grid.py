"""sdflabel_tpu_torch.ops.grid against sdflabel_tpu.ops.grid: stage 2, the
normals and the band, compared as sets (the order of ties in top-k is not
specified)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.ops import grid as jgrid
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.ops import grid as tgrid
from torch_parity_util import jax_tree_to_numpy


def _decoders(width=32):
    jcfg = jds.DeepSDFConfig(latent_size=3, dims=(width,) * 4,
                             latent_in=(2,))
    jparams = jds.init_params(jcfg, jax.random.PRNGKey(1))
    tcfg = tds.DeepSDFConfig(latent_size=3, dims=(width,) * 4,
                             latent_in=(2,))
    tparams = tds.params_from_jax(jax_tree_to_numpy(jparams))
    return jds.sdf_fn(jcfg, jparams), tds.sdf_fn(tcfg, tparams)


def _rows(*arrays):
    """Rows of the concatenated arrays, lexicographically sorted: a set."""
    a = np.concatenate([np.asarray(x, np.float64).reshape(len(x), -1)
                        for x in arrays], 1)
    return a[np.lexsort(a.T[::-1])]


def test_point_grid_matches_jax():
    for d in (16, 40):
        assert np.array_equal(tgrid.generate_point_grid(d).numpy(),
                              np.asarray(jgrid.generate_point_grid(d)))


def test_two_stage_surface_matches_jax_as_set():
    jdec, tdec = _decoders()
    latent = np.array([0.6, -0.48, 0.64], np.float32)
    pts = np.asarray(jgrid.generate_point_grid(16))
    js, jsdf = jgrid.surface_from_decoder(jdec, jnp.asarray(latent),
                                          jnp.asarray(pts), capacity=512)
    ts, tsdf = tgrid.surface_from_decoder(tdec, torch.as_tensor(latent),
                                          torch.as_tensor(pts), capacity=512)
    np.testing.assert_allclose(tsdf.numpy(), np.asarray(jsdf), atol=1e-6)
    # stage 2: points, normals (unit autograd gradients), nocs and mask
    # agree to fp32 reassociation (1e-5) as a set of rows
    np.testing.assert_allclose(
        _rows(ts.points.detach(), ts.normals, ts.nocs.detach(), ts.mask),
        _rows(js.points, js.normals, js.nocs, js.mask), atol=1e-5)
    assert not ts.normals.requires_grad  # QUIRKS #5: normals are leaves
    # the projected points keep their graph to the latent
    lat = torch.as_tensor(latent).requires_grad_(True)
    surf, _ = tgrid.surface_from_decoder(tdec, lat, torch.as_tensor(pts),
                                         capacity=512)
    (g,) = torch.autograd.grad(surf.points.sum(), lat)
    jg = jax.grad(lambda l: jnp.sum(jgrid.surface_from_decoder(
        jdec, l, jnp.asarray(pts), capacity=512)[0].points))(
            jnp.asarray(latent))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4)


def test_band_candidates_and_warm_surface_match_jax():
    jdec, tdec = _decoders()
    latent = np.array([0.0, 0.8, -0.6], np.float32)
    pts = np.asarray(jgrid.generate_point_grid(16))
    jc = np.asarray(jgrid.band_candidates(jdec, jnp.asarray(latent),
                                          jnp.asarray(pts), 1024))
    tc = tgrid.band_candidates(tdec, torch.as_tensor(latent),
                               torch.as_tensor(pts), 1024)
    assert set(tc.tolist()) == set(jc.tolist())
    # candidates == capacity: stage 1 is skipped, all candidates kept
    js = jgrid.surface_from_candidates(jdec, jnp.asarray(latent),
                                       jnp.asarray(pts), jnp.asarray(jc),
                                       capacity=1024)
    ts = tgrid.surface_from_candidates(tdec, torch.as_tensor(latent),
                                       torch.as_tensor(pts), tc,
                                       capacity=1024)
    np.testing.assert_allclose(
        _rows(ts.points.detach(), ts.normals, ts.mask),
        _rows(js.points, js.normals, js.mask), atol=1e-5)
    # a wider pool: stage 1 ranks the candidates down to the capacity
    js = jgrid.surface_from_candidates(jdec, jnp.asarray(latent),
                                       jnp.asarray(pts), jnp.asarray(jc),
                                       capacity=256)
    ts = tgrid.surface_from_candidates(tdec, torch.as_tensor(latent),
                                       torch.as_tensor(pts), tc,
                                       capacity=256)
    np.testing.assert_allclose(_rows(ts.points.detach(), ts.mask),
                               _rows(js.points, js.mask), atol=1e-5)


def test_isosurface_project_matches_jax():
    rng = np.random.RandomState(2)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    sdf = rng.uniform(-0.1, 0.1, 300).astype(np.float32)
    nrm = rng.randn(300, 3).astype(np.float32)
    j = jgrid.isosurface_project(jnp.asarray(pts), jnp.asarray(sdf),
                                 jnp.asarray(nrm), 100)
    t = tgrid.isosurface_project(torch.as_tensor(pts), torch.as_tensor(sdf),
                                 torch.as_tensor(nrm), 100)
    np.testing.assert_allclose(_rows(t.points, t.normals, t.mask),
                               _rows(j.points, j.normals, j.mask), atol=1e-6)
