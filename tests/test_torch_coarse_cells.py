"""Coarse-to-fine cells (ops/grid.py, engine/refine.py, the runtime's
clamps) against sdflabel_tpu: the cell children and the corner lattice
equal as integers; the candidate sets equal as ordered arrays, ties
included, on a decoder both packages evaluate bit for bit (an L-inf cube
offset by the latent: every cell the surface crosses scores exactly 0,
and there are more of them than cells asked for); with and without the
crop axis (against jax.vmap); surface_from_decoder and band_candidates
with coarse cells; 3 refine iterations with coarse_cells and with
warm_refresh_cells, single and batched, within 1e-4; JAX's ValueErrors
raised alike."""

import configparser
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu import config as jcfg_mod
from sdflabel_tpu.engine import refine as jref
from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.ops import grid as jgrid
from sdflabel_tpu.parallel import batched_refine as jbr
from sdflabel_tpu.pipelines import refine_css as jpipe
from sdflabel_tpu_torch import config as tcfg_mod
from sdflabel_tpu_torch.engine import refine as tref
from sdflabel_tpu_torch.models import css as tcss
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.ops import grid as tgrid
from sdflabel_tpu_torch.parallel import batched_refine as tbr
from sdflabel_tpu_torch.pipelines import refine_css as tpipe
from test_torch_batched_refine import (BUCKET, CAP, FIELDS, GRID, _batch,
                                       _crops, _decoders)


def _jcube(lat, p):
    return jnp.max(jnp.abs(p - lat), axis=-1) - 0.5


def _tcube(lat, p):
    return (p - lat[..., None, :]).abs().amax(-1) - 0.5


LATENTS = np.array([[0.0, 0.0, 0.0], [0.13, -0.21, 0.05],
                    [-0.3, 0.1, 0.22]], np.float32)


@pytest.mark.parametrize("d,factor", [(40, 2), (20, 2), (12, 3), (16, 4)])
def test_children_and_lattice_equal(d, factor):
    assert np.array_equal(tgrid._cell_children_np(d, factor),
                          jgrid._cell_children_np(d, factor))
    for t, j in zip(tgrid._cell_corner_lattice_np(d, factor),
                    jgrid._cell_corner_lattice_np(d, factor)):
        assert t.dtype == j.dtype and np.array_equal(t, j)


@pytest.mark.parametrize("cells", [40, 200, 1000])
def test_cell_candidates_equal_ties_included(cells):
    d, factor = 20, 2
    pts_np = jgrid._generate_point_grid_np(d)
    children = jnp.asarray(jgrid._cell_children_np(d, factor))
    tpts = torch.as_tensor(pts_np)
    for lat in LATENTS:
        jlat = jnp.asarray(lat)
        cs = np.asarray(jgrid._cell_corner_lattice_np(d, factor)[1])
        corner = np.asarray(_jcube(jlat, jnp.asarray(pts_np)[
            jgrid._cell_corner_lattice_np(d, factor)[0]]))[cs]
        crossing = int(((corner.min(1) < 0) & (corner.max(1) > 0)).sum())
        want = np.asarray(jgrid._coarse_cell_candidates(
            _jcube, jlat, jnp.asarray(pts_np), d, factor, cells, children))
        got = tgrid._coarse_cell_candidates(
            _tcube, torch.as_tensor(lat), tpts, factor, cells, 8).numpy()
        assert np.array_equal(got, want), (lat, cells)
        if cells == 40:  # more crossing cells than kept: the ties decide
            assert crossing > cells
    # the crop axis: one lattice decode for every crop, against jax.vmap
    want = np.asarray(jax.vmap(lambda lat: jgrid._coarse_cell_candidates(
        _jcube, lat, jnp.asarray(pts_np), d, factor, cells, children))(
            jnp.asarray(LATENTS)))
    got = tgrid._coarse_cell_candidates(_tcube, torch.as_tensor(LATENTS),
                                        tpts, factor, cells, 8).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("batched", [False, True])
def test_surface_and_band_candidates_with_cells(batched):
    d, cells, cap, n_cand = 20, 60, 256, 400
    pts_np = jgrid._generate_point_grid_np(d)
    jpts, tpts = jnp.asarray(pts_np), torch.as_tensor(pts_np)
    lats = LATENTS if batched else LATENTS[1]

    def jsurf(lat):
        return jgrid.surface_from_decoder(_jcube, lat, jpts, capacity=cap,
                                          coarse_cells=cells)

    def jband(lat):
        return jgrid.band_candidates(_jcube, lat, jpts, n_cand,
                                     coarse_cells=cells)

    if batched:
        jsurf, jband = jax.vmap(jsurf), jax.vmap(jband)
    (js, jsdf), jb = jsurf(jnp.asarray(lats)), jband(jnp.asarray(lats))
    ts, tsdf = tgrid.surface_from_decoder(_tcube, torch.as_tensor(lats),
                                          tpts, capacity=cap,
                                          coarse_cells=cells)
    tb = tgrid.band_candidates(_tcube, torch.as_tensor(lats), tpts, n_cand,
                               coarse_cells=cells)
    # the decoder is exact in both: the same indices in the same order,
    # the sdf of the candidates equal; the stage-2 points to autograd's
    # rounding of the normals
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(tsdf.numpy(), np.asarray(jsdf))
    assert np.array_equal(ts.mask.numpy(), np.asarray(js.mask))
    for f in ("points", "nocs", "normals"):
        np.testing.assert_allclose(getattr(ts, f).detach().numpy(),
                                   np.asarray(getattr(js, f)), atol=1e-6,
                                   err_msg=f)
    # a budget of every cell ranks every point: the full-grid selection
    full, _ = tgrid.surface_from_decoder(_tcube, torch.as_tensor(lats), tpts,
                                         capacity=cap)
    every, _ = tgrid.surface_from_decoder(_tcube, torch.as_tensor(lats), tpts,
                                          capacity=cap, coarse_cells=10 ** 6)
    assert torch.equal(full.mask, every.mask)


def test_value_errors_alike():
    jpts = jgrid.generate_point_grid(10)
    tpts = tgrid.generate_point_grid(10)
    lat = np.zeros(3, np.float32)
    cases = [dict(capacity=64, coarse_cells=8, coarse_factor=3),  # 10 % 3
             dict(capacity=512, coarse_cells=8, coarse_factor=2)]  # pool
    for kw in cases:
        with pytest.raises(ValueError):
            jgrid.surface_from_decoder(_jcube, jnp.asarray(lat), jpts, **kw)
        with pytest.raises(ValueError):
            tgrid.surface_from_decoder(_tcube, torch.as_tensor(lat), tpts,
                                       **kw)
    with pytest.raises(ValueError):
        jgrid.band_candidates(_jcube, jnp.asarray(lat), jpts, 600,
                              coarse_cells=8)
    with pytest.raises(ValueError):
        tgrid.band_candidates(_tcube, torch.as_tensor(lat), tpts, 600,
                              coarse_cells=8)
    with pytest.raises(ValueError):  # not a cube grid
        jgrid.surface_from_decoder(_jcube, jnp.asarray(lat), jpts[:999],
                                   capacity=8, coarse_cells=4)
    with pytest.raises(ValueError):
        tgrid.surface_from_decoder(_tcube, torch.as_tensor(lat), tpts[:999],
                                   capacity=8, coarse_cells=4)
    # the warm band and per-iteration cells exclude each other
    kw = dict(surface_capacity=64, warm_band=128, coarse_cells=32)
    with pytest.raises(ValueError):
        jref.make_refine_fn(_jcube, jref.RefineConfig(**kw), jpts,
                            np.eye(3, dtype=np.float32), (8, 8))
    with pytest.raises(ValueError):
        tref.make_refine_fn(_tcube, tref.RefineConfig(**kw), tpts,
                            np.eye(3, dtype=np.float32), (8, 8),
                            device="cpu")


CELL_CFGS = {"coarse_cells": dict(coarse_cells=128),
             "warm_refresh_cells": dict(warm_band=1024, warm_refresh=2,
                                        warm_refresh_cells=128)}


@pytest.mark.parametrize("mode", sorted(CELL_CFGS))
def test_refine_with_cells_matches_jax(mode):
    # 3 iterations of the batched refine test's crops, fp32: within 1e-4
    kw = dict(iters=3, surface_capacity=CAP, **CELL_CFGS[mode])
    jdec, tdec = _decoders()
    lanes = _crops()
    p0, *rest = _batch(lanes)
    jfinal, jhist = jbr.make_batched_refine(
        jdec, jref.RefineConfig(**kw), jgrid.generate_point_grid(GRID),
        BUCKET)(jref.RefineParams(**{f: jnp.asarray(v) for f, v in
                                     p0.items()}), *map(jnp.asarray, rest))
    tfinal, thist = tbr.make_batched_refine(
        tdec, tref.RefineConfig(**kw), tgrid.generate_point_grid(GRID),
        BUCKET, device="cpu")(
            tref.RefineParams(**{f: torch.as_tensor(v) for f, v in
                                 p0.items()}), *map(torch.as_tensor, rest))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(thist.params, f).numpy(),
                                   np.asarray(getattr(jhist.params, f)),
                                   atol=1e-4, err_msg=f)
        np.testing.assert_allclose(getattr(tfinal, f).numpy(),
                                   np.asarray(getattr(jfinal, f)),
                                   atol=1e-4, err_msg=f)
    np.testing.assert_allclose(thist.loss.numpy(), np.asarray(jhist.loss),
                               rtol=1e-4, atol=1e-7)
    assert thist.applied.all()
    # the sequential loop, crop 0 alone, against JAX's
    K, nocs, frustum, fmask, pmask, _ = lanes[0]
    start = {f: v[0] for f, v in p0.items()}
    jf, jh = jref.make_refine_fn(jdec, jref.RefineConfig(**kw),
                                 jgrid.generate_point_grid(GRID),
                                 jnp.asarray(K), BUCKET)(
        jref.RefineParams(**{f: jnp.asarray(v) for f, v in start.items()}),
        jnp.asarray(nocs), jnp.asarray(frustum), jnp.asarray(fmask),
        jnp.asarray(pmask))
    tf, th = tref.make_refine_fn(tdec, tref.RefineConfig(**kw),
                                 tgrid.generate_point_grid(GRID),
                                 torch.as_tensor(K), BUCKET, device="cpu")(
        tref.RefineParams(**{f: torch.as_tensor(v) for f, v in
                             start.items()}),
        torch.as_tensor(nocs), torch.as_tensor(frustum),
        torch.as_tensor(fmask), torch.as_tensor(pmask))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tf, f).numpy(),
                                   np.asarray(getattr(jf, f)), atol=1e-4,
                                   err_msg=f)


@pytest.mark.parametrize("opt", [
    {}, {"coarse_cells": "500"}, {"warm_refresh_cells": "2048"},
    {"warm_refresh_cells": "100000"}, {"warm_refresh_cells": "512"},
    {"warm_refresh_cells": "2048", "grid_density": "41"},
    {"warm_refresh_cells": "2048", "warm_band": "0"},
    {"coarse_cells": "500", "warm_refresh_cells": "2048"}])
def test_runtime_clamps_match_jax(opt):
    cfgp = configparser.ConfigParser()
    cfgp.read_dict({"input": {k: v for k, v in opt.items()
                              if k == "grid_density"},
                    "optimization": {"precision": "float32",
                                     **{k: v for k, v in opt.items()
                                        if k != "grid_density"}}})
    spec = dict(latent_size=3, dims=(64, 64, 64), latent_in=(2,))
    jparams = jds.init_params(jds.DeepSDFConfig(**spec),
                              jax.random.PRNGKey(0))
    jcfg = jcfg_mod.RefineCfg.from_ini(cfgp)
    jrt = jpipe.RefineRuntime(jcfg, None, jds.DeepSDFConfig(**spec), jparams,
                              coarse_cells=jcfg.coarse_cells or None)
    trt = tpipe.RefineRuntime(
        tcfg_mod.RefineCfg.from_ini(cfgp), tcss.CSSNet(width=8),
        tds.DeepSDFConfig(**spec),
        tds.params_from_jax(jax.tree.map(np.asarray, jparams)),
        device="cpu")
    got = (trt.coarse_cells, trt.warm_band, trt.warm_refresh_cells)
    assert got == (jrt.coarse_cells, jrt.warm_band, jrt.warm_refresh_cells)
    rcfg = trt.refine_config()
    assert (rcfg.coarse_cells, rcfg.warm_band, rcfg.warm_refresh_cells) == got
    assert dataclasses.asdict(rcfg)["coarse_factor"] == 2
