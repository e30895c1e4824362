"""sdflabel_tpu_torch.models.deepsdf against sdflabel_tpu.models.deepsdf."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu_torch.models import deepsdf as tds
from torch_parity_util import jax_tree_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {
    "demo_3x64": os.path.join(REPO, "data", "optimization",
                              "deepsdf_demo.pt"),
    "quality_3x96": os.path.join(REPO, "data", "quality_nets",
                                 "deepsdf_quality.pt"),
}


def _ref_8x512():
    cfg = jds.DeepSDFConfig(latent_size=3, dims=(512,) * 8,
                            norm_layers=tuple(range(8)), latent_in=(4,),
                            weight_norm=True)
    return cfg, jds.init_params(cfg, jax.random.PRNGKey(0))


def _nets(name):
    if name == "ref_8x512":
        jcfg, jparams = _ref_8x512()
        tcfg = tds.DeepSDFConfig(**{f: getattr(jcfg, f) for f in
                                    jcfg.__dataclass_fields__})
        return jcfg, jparams, tcfg, tds.params_from_jax(
            jax_tree_to_numpy(jparams))
    jcfg, jparams = jds.load_torch_checkpoint(CKPTS[name])
    tcfg, tparams = tds.load_torch_checkpoint(CKPTS[name], device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("name", ["demo_3x64", "quality_3x96", "ref_8x512"])
def test_apply_sdf_and_scale_match_jax(name):
    # fp32 on both sides; sums in another order: atol 1e-5
    jcfg, jparams, tcfg, tparams = _nets(name)
    assert tcfg == tds.DeepSDFConfig(**{f: getattr(jcfg, f) for f in
                                        jcfg.__dataclass_fields__})
    assert all(tcfg.layer_io(l) == jcfg.layer_io(l)
               for l in range(tcfg.num_layers - 1))
    rng = np.random.RandomState(0)
    latent = rng.randn(3).astype(np.float32)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    inputs = np.concatenate([np.broadcast_to(latent, (500, 3)), pts], 1)
    want = np.asarray(jds.apply_sdf(jcfg, jparams, jnp.asarray(inputs)))
    got = tds.apply_sdf(tcfg, tparams, torch.as_tensor(inputs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    got_fn = tds.sdf_fn(tcfg, tparams)(torch.as_tensor(latent),
                                      torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(got_fn, want, atol=1e-5)
    np.testing.assert_allclose(
        tds.apply_scale(tcfg, tparams, torch.as_tensor(latent)).numpy(),
        np.asarray(jds.apply_scale(jcfg, jparams, jnp.asarray(latent))),
        atol=1e-5)


def test_fold_weight_norm_matches_jax():
    jcfg, jparams, tcfg, tparams = _nets("ref_8x512")
    want = jax_tree_to_numpy(jds.fold_weight_norm(jparams))
    got = tds.fold_weight_norm(tparams)
    for k in ("lin0", "lin4", "lin8"):
        np.testing.assert_allclose(got[k]["w"].numpy(), want[k]["w"],
                                   atol=1e-6)
        assert "v" not in got[k]


def test_from_specs_and_seeded_init():
    specs = {"CodeLength": 3, "NetworkSpecs": {
        "dims": [128] * 8, "norm_layers": list(range(8)),
        "latent_in": [4], "weight_norm": True, "samples_per_scene": 7}}
    cfg = tds.DeepSDFConfig.from_specs(specs)
    assert cfg == tds.DeepSDFConfig(
        latent_size=3, dims=(128,) * 8, norm_layers=tuple(range(8)),
        latent_in=(4,), weight_norm=True)
    a = tds.init_params(cfg, torch.Generator().manual_seed(3))
    b = tds.init_params(cfg, torch.Generator().manual_seed(3))
    ja = jds.init_params(jds.DeepSDFConfig.from_specs(specs),
                         jax.random.PRNGKey(0))
    for l in range(cfg.num_layers - 1):
        assert set(a[f"lin{l}"]) == set(ja[f"lin{l}"])
        for k, v in a[f"lin{l}"].items():
            assert v.shape == ja[f"lin{l}"][k].shape
            assert torch.equal(v, b[f"lin{l}"][k])
    out = tds.apply_sdf(cfg, a, torch.zeros(4, 6))
    assert out.shape == (4,) and torch.isfinite(out).all()
