"""[optimization] select_bf16: the port's models/deepsdf.py::select_sdf_fn
against sdflabel_tpu's, by rank set, and the runtime's choice of the
selection decoder against the JAX runtime's rule (select_bf16 only over an
fp32 decoder; the selection kernel wins where its packer takes the net)."""

import configparser
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.ops import grid as jgrid
from sdflabel_tpu_torch import config as tcfg_mod
from sdflabel_tpu_torch.models import css as tcss
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.pipelines import refine_css as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_DSDF = os.path.join(REPO, "data", "optimization", "deepsdf_demo.pt")
LATENT = np.array([0.6, -0.48, 0.64], np.float32)


def _smallest(v, k):
    return set(np.argsort(np.abs(v), kind="stable")[:k].tolist())


def test_demo_net_ranks_equal_jax():
    # the 3x64 demo net: bf16 products of three layers round alike in
    # both packages; tolerance none, every value and so every rank set
    jc, jp = jds.load_torch_checkpoint(DEMO_DSDF)
    tc, tp = tds.load_torch_checkpoint(DEMO_DSDF, device="cpu")
    pts = jgrid._generate_point_grid_np(40)
    want = np.asarray(jds.select_sdf_fn(jc, jp)(jnp.asarray(LATENT),
                                                jnp.asarray(pts)))
    got = tds.select_sdf_fn(tc, tp)(torch.as_tensor(LATENT),
                                    torch.as_tensor(pts))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
    for k in (2048, 8192):
        assert _smallest(got.numpy(), k) == _smallest(want, k)


def test_weight_norm_net_ranks_match_jax():
    # the reference 8x512 architecture under weight-norm, folded in fp32
    # then cast: a bf16 rounding may land the other way in a long chain
    # (values within 1e-3); the 2048 smallest |sdf| share >= 97% of their
    # points
    spec = dict(latent_size=3, dims=(512,) * 8, norm_layers=tuple(range(8)),
                latent_in=(4,), weight_norm=True)
    jparams = jds.init_params(jds.DeepSDFConfig(**spec),
                              jax.random.PRNGKey(0))
    tparams = tds.params_from_jax(jax.tree.map(np.asarray, jparams))
    pts = jgrid._generate_point_grid_np(20)
    want = np.asarray(jds.select_sdf_fn(jds.DeepSDFConfig(**spec), jparams)(
        jnp.asarray(LATENT), jnp.asarray(pts)))
    got = tds.select_sdf_fn(tds.DeepSDFConfig(**spec), tparams)(
        torch.as_tensor(LATENT), torch.as_tensor(pts)).numpy()
    assert np.abs(got - want).max() <= 1e-3
    assert len(_smallest(got, 2048) & _smallest(want, 2048)) >= 0.97 * 2048


@pytest.mark.parametrize("precision,select_bf16,routed", [
    ("float32", "True", True), ("float32", "False", False),
    ("float16", "True", False)])
def test_runtime_routes_select_bf16_as_jax(precision, select_bf16, routed):
    cfgp = configparser.ConfigParser()
    cfgp.read_dict({"optimization": {"precision": precision,
                                     "select_bf16": select_bf16}})
    tc, tp = tds.load_torch_checkpoint(DEMO_DSDF, device="cpu")
    rt = tpipe.RefineRuntime(tcfg_mod.RefineCfg.from_ini(cfgp),
                             tcss.CSSNet(width=8), tc, tp, device="cpu")
    # the demo net is outside the selection kernel's packer
    assert (rt.select_decoder is not None) == routed
    if routed:
        pts = torch.as_tensor(jgrid._generate_point_grid_np(12))
        assert torch.equal(rt.select_decoder(torch.as_tensor(LATENT), pts),
                           tds.select_sdf_fn(tc, tp)(torch.as_tensor(LATENT),
                                                     pts))
