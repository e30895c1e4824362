"""The demo-asset tool's DeepSDF fit (tools/demo_assets.py::
fit_deepsdf) against scripts/make_demo_assets.py::fit_deepsdf on the CPU.

jax.random's draws cannot be made by torch, so the JAX step is rebuilt
here from the script's own box_sdf, HALF and LATENT_GT with the JAX
package's sdf_fn and optax.adam(1e-3), and both steps take the same numpy
draws (uniform points, noise) from JAX's initial weights. Tolerances (the
quality fit's): after three steps the parameters within 1e-6 (fp32 sums
in other orders through a 3x64 decoder; Adam's first steps are ~lr in
size) and each step's L1 within 1e-6. The export reloads in JAX's
load_torch_checkpoint equal to the fitted parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from sdflabel_tpu.models import deepsdf as jdsdf
from sdflabel_tpu_torch.models import deepsdf as tdsdf
from sdflabel_tpu_torch.tools import demo_assets as da
from sdflabel_tpu_torch.tools import quality_suite as qs
from torch_parity_util import few_threads  # noqa: F401 (autouse)
from torch_parity_util import script_module

mda = script_module("make_demo_assets")


def test_constants_match_script():
    assert da.SEED == mda.SEED
    for name in ("YAW_GT", "SCALE_GT", "IMG_H", "IMG_W", "FOCAL", "CX",
                 "CY"):
        assert getattr(da, name) == getattr(mda, name), name
    for name in ("TRANS_CAM", "HALF", "LATENT_GT"):
        got, want = getattr(da, name), getattr(mda, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert tuple(da.fit_config().dims) == (64, 64, 64)
    assert da.fit_config().latent_size == 3


def test_box_sdf_matches_script():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1.3, 1.3, (4096, 3)).astype(np.float32)
    want = np.asarray(mda.box_sdf(jnp.asarray(pts)))
    got = qs.box_sdf(torch.as_tensor(pts),
                     torch.as_tensor(da.HALF, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def _jax_step(cfg):
    """The script's step (make_demo_assets.py:78-92) on given draws."""
    opt = optax.adam(1e-3)
    lat = jnp.asarray(mda.LATENT_GT)

    @jax.jit
    def step(params, opt_state, pu, noise):
        ps = pu * (mda.HALF / jnp.max(mda.HALF))
        pts = jnp.concatenate([pu, ps + 0.05 * noise])
        target = jnp.clip(mda.box_sdf(pts), -0.1, 0.1)

        def loss_fn(p):
            pred = jnp.clip(jdsdf.sdf_fn(cfg, p)(lat, pts), -0.1, 0.1)
            return jnp.mean(jnp.abs(pred - target))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    return opt, step


def test_fit_steps_match_jax():
    cfg = jdsdf.DeepSDFConfig(latent_size=3, dims=(64, 64, 64))
    opt, step = _jax_step(cfg)
    params = jdsdf.init_params(cfg, jax.random.PRNGKey(mda.SEED))
    opt_state = opt.init(params)
    state = qs.fit_state(tdsdf.params_from_jax(
        jax.tree.map(np.asarray, params)))
    rng = np.random.RandomState(5)
    for _ in range(3):
        pu = rng.uniform(-1.05, 1.05, (qs.FIT_POINTS, 3)).astype(np.float32)
        noise = rng.randn(qs.FIT_POINTS, 3).astype(np.float32)
        params, opt_state, jloss = step(params, opt_state, pu, noise)
        state, tloss = qs.fit_step(state, torch.tensor(0),
                                   torch.as_tensor(pu),
                                   torch.as_tensor(noise), da.fit_config(),
                                   da.SHAPES)
        assert abs(float(tloss) - float(jloss)) <= 1e-6
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), state.params))
    want = jax.tree.leaves(jax.tree.map(np.asarray, params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert state.step == 3 and int(state.opt.count) == 3


def test_own_fit_lowers_l1(capsys):
    cfg, params, losses = da.fit_deepsdf(40, device="cpu", log_every=20)
    assert tuple(cfg.dims) == (64, 64, 64)
    assert losses.shape == (40,) and torch.isfinite(losses).all()
    assert losses[-8:].mean() < losses[:8].mean()
    out = capsys.readouterr().out
    assert "deepsdf fit step 0:" in out and "deepsdf fit step 20:" in out


def test_fit_checkpoint_loads_in_jax(tmp_path):
    cfg, params, _ = da.fit_deepsdf(2, device="cpu")
    path = str(tmp_path / "deepsdf_demo.pt")
    tdsdf.save_torch_checkpoint(path, cfg, params)
    jcfg, jparams = jdsdf.load_torch_checkpoint(path)
    assert tuple(jcfg.dims) == (64, 64, 64) and jcfg.latent_size == 3
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), params))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
