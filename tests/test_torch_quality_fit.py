"""The quality suite's DeepSDF fit (tools/quality_suite.py::fit_deepsdf)
against scripts/make_quality_suite.py::fit_deepsdf, on the CPU.

jax.random's draws cannot be made by torch, so the JAX step is rebuilt
here from the script's own box_sdf, SHAPES and SEED with the JAX
package's sdf_fn and optax.adam(1e-3), and both steps take the same
numpy draws (shape index, uniform points, noise) from JAX's initial
weights. Tolerances: box_sdf 1e-7; after three steps the parameters
within 1e-6 (fp32 sums in other orders through a 3x96 decoder; Adam's
first steps are ~lr in size) and each step's L1 within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from sdflabel_tpu.models import deepsdf as jdsdf
from sdflabel_tpu_torch.models import deepsdf as tdsdf
from sdflabel_tpu_torch.tools import quality_suite as qs
from torch_parity_util import few_threads  # noqa: F401 (autouse)
from torch_parity_util import make_quality_suite_module

mqs = make_quality_suite_module()


def test_constants_match_script():
    assert qs.SEED == mqs.SEED
    assert len(qs.SHAPES) == len(mqs.SHAPES)
    for (tl, th), (jl, jh) in zip(qs.SHAPES, mqs.SHAPES):
        assert tl.dtype == jl.dtype and np.array_equal(tl, jl)
        assert th.dtype == jh.dtype and np.array_equal(th, jh)


def test_box_sdf_matches_script():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1.3, 1.3, (4096, 3)).astype(np.float32)
    pts[:8] = 0.0  # the centre, deep inside
    for _lat, half in mqs.SHAPES:
        want = np.asarray(mqs.box_sdf(jnp.asarray(pts), half))
        got = qs.box_sdf(torch.as_tensor(pts),
                         torch.as_tensor(half, dtype=torch.float32)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def _jax_step():
    """The script's step (make_quality_suite.py:100-116) on given draws."""
    cfg = jdsdf.DeepSDFConfig(latent_size=3, dims=(96, 96, 96))
    opt = optax.adam(1e-3)
    lats = jnp.asarray(np.stack([s[0] for s in mqs.SHAPES]))
    halves = jnp.asarray(np.stack([s[1] for s in mqs.SHAPES]))

    @jax.jit
    def step(params, opt_state, shape_idx, pu, noise):
        lat, half = lats[shape_idx], halves[shape_idx]
        ps = pu * (half / jnp.max(half))
        pts = jnp.concatenate([pu, ps + 0.05 * noise])
        target = jnp.clip(mqs.box_sdf(pts, half), -0.1, 0.1)

        def loss_fn(p):
            pred = jnp.clip(jdsdf.sdf_fn(cfg, p)(lat, pts), -0.1, 0.1)
            return jnp.mean(jnp.abs(pred - target))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    return cfg, opt, step


def test_fit_steps_match_jax():
    cfg, opt, step = _jax_step()
    params = jdsdf.init_params(cfg, jax.random.PRNGKey(mqs.SEED))
    opt_state = opt.init(params)
    state = qs.fit_state(tdsdf.params_from_jax(
        jax.tree.map(np.asarray, params)))
    rng = np.random.RandomState(5)
    for _ in range(3):
        idx = rng.randint(len(mqs.SHAPES))
        pu = rng.uniform(-1.05, 1.05, (qs.FIT_POINTS, 3)).astype(np.float32)
        noise = rng.randn(qs.FIT_POINTS, 3).astype(np.float32)
        params, opt_state, jloss = step(params, opt_state, idx, pu, noise)
        state, tloss = qs.fit_step(state, torch.tensor(idx),
                                   torch.as_tensor(pu),
                                   torch.as_tensor(noise))
        assert abs(float(tloss) - float(jloss)) <= 1e-6
    got = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), state.params))
    want = jax.tree.leaves(jax.tree.map(np.asarray, params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    assert state.step == 3 and int(state.opt.count) == 3


def test_own_fit_lowers_l1(capsys):
    cfg, params0 = qs.fit_config(), qs.init_fit("cpu").params
    cfg, params, losses = qs.fit_deepsdf(50, device="cpu", log_every=25)
    assert losses.shape == (50,) and torch.isfinite(losses).all()
    assert losses[-10:].mean() < losses[:10].mean()
    assert qs.fit_eval_l1(cfg, params) < qs.fit_eval_l1(cfg, params0)
    out = capsys.readouterr().out
    assert "deepsdf fit step 0:" in out and "deepsdf fit step 25:" in out


def test_fit_checkpoint_loads_in_jax(tmp_path):
    cfg, params, _ = qs.fit_deepsdf(2, device="cpu")
    path = str(tmp_path / "deepsdf_quality.pt")
    tdsdf.save_torch_checkpoint(path, cfg, params)
    jcfg, jparams = jdsdf.load_torch_checkpoint(path)
    assert tuple(jcfg.dims) == (96, 96, 96) and jcfg.latent_size == 3
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), params))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
