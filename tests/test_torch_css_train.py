"""The port's CSS training (models/css.py train mode,
engine/css_train.py) against sdflabel_tpu's flax module and jitted train
step, on the same carried weights and numpy batches, width 8.

Tolerances: convolutions and batch statistics sum in other orders in the
two frameworks (fp32), so outputs agree to ~1e-4 of their scale. Adam's
first step is m / sqrt(v) ~ sign(g): a gradient element near 0 may get
the opposite sign in the two runs, and its parameter then moves 2 lr the
other way (0.1% of them here). After one step >= 99.5% of the trainable
parameters agree to 1e-5 and all to 2 lr. Those flips change the next
gradients, and Adam's later steps amplify small gradient differences, so
after three steps the parameters agree to a median of 1e-4 (a twentieth
of their move) and all to 3 x 2 lr, the batch statistics to 1e-2 of each
leaf's largest element (median 1e-4), and the losses to 1e-3 relative;
the first step's losses agree to 1e-5 and its statistics to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.engine import css_train as jtrain
from sdflabel_tpu.models import css as jcss
from sdflabel_tpu.pipelines.train_css import setup_css
from sdflabel_tpu_torch.engine import css_train as ttrain
from sdflabel_tpu_torch.models import css as tcss
from torch_parity_util import jax_tree_to_numpy

WIDTH = 8
LR = 1e-3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _param_diffs(got, want, init):
    """|port - JAX| over the trainable parameters; the frozen ones must
    equal their initial values in both packages."""
    diffs = []
    for k in want:
        if k.split("/")[0] in tcss.FROZEN_PREFIXES:
            assert np.array_equal(got[k], init[k]), k
            assert np.array_equal(want[k], init[k]), k
        else:
            diffs.append(np.abs(got[k] - want[k]).ravel())
    return np.concatenate(diffs)


@pytest.fixture(scope="module")
def variables():
    return jax_tree_to_numpy(setup_css(None, width=WIDTH, latent_size=3))


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    mask = (rng.uniform(size=(b, 128, 128)) > 0.4).astype(np.uint8)
    uvw = (rng.randint(1, 256, (b, 3, 128, 128)) * mask[:, None]).astype(
        np.uint8)
    lat = rng.randn(b, 3).astype(np.float32)
    return {"rgb": rng.randint(0, 256, (b, 3, 128, 128)).astype(np.uint8),
            "uvw": uvw, "mask": mask,
            "latent": lat / np.linalg.norm(lat, axis=1, keepdims=True)}


def test_flax_layout_round_trip(variables):
    model = tcss.params_from_jax(variables, width=WIDTH)
    back = tcss.state_to_flax(model)
    a, b = _flat(variables), _flat(back)
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # BatchNorm scale and bias are parameters, the statistics buffers
    names = dict(model.named_parameters())
    assert "bn1.scale" in names and "bn1.bias" in names
    assert "bn1.mean" in dict(model.named_buffers())


def test_msgpack_writer_matches_flax(variables):
    from flax import serialization

    from sdflabel_tpu_torch.utils import flax_msgpack

    # flax's own variable tree: the same bytes
    assert (flax_msgpack.msgpack_serialize(variables)
            == serialization.to_bytes(variables))
    # every value type the writer knows reads back through flax
    tree = {"b": {"z": np.arange(3, dtype=np.float32), "a": np.float32(2.5)},
            "i": np.ones((2, 70000), np.int32), "s": "x" * 40, "n": -7,
            "big": 1 << 40, "f": 1.5, "t": True, "none": None,
            "list": [1, 2.0, "three"]}
    data = flax_msgpack.msgpack_serialize(tree)
    back = serialization.msgpack_restore(data)
    assert back.keys() == tree.keys() and back["list"] == [1, 2.0, "three"]
    for k in ("s", "n", "big", "f", "t", "none"):
        assert back[k] == tree[k], k
    np.testing.assert_array_equal(back["i"], tree["i"])
    assert back["b"]["a"] == tree["b"]["a"]
    assert back["b"]["a"].dtype == np.float32
    assert flax_msgpack.msgpack_restore(data).keys() == tree.keys()


def test_train_mode_matches_flax(variables):
    x = np.random.RandomState(0).randn(3, 3, 128, 128).astype(np.float32)
    jout, upd = jcss.CSSNet(use_running_average=False, width=WIDTH).apply(
        variables, jnp.asarray(x), mutable=["batch_stats"])
    model = tcss.params_from_jax(variables, width=WIDTH).train()
    with torch.no_grad():
        tout = model(torch.as_tensor(x))
    for k in ("u_raw", "v_raw", "w_raw", "u", "mask", "latent"):
        want = np.asarray(jout[k])
        scale = max(np.abs(want).max(), 1.0)
        np.testing.assert_allclose(tout[k].numpy(), want,
                                   atol=1e-4 * scale, err_msg=k)
    # running statistics: 0.9 old + 0.1 batch, biased variance
    want = _flat(jax_tree_to_numpy(upd["batch_stats"]))
    got = _flat(tcss.state_to_flax(model)["batch_stats"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert not np.allclose(got["bn1/BatchNorm_0/var"],
                           _flat(variables["batch_stats"])[
                               "bn1/BatchNorm_0/var"])


@pytest.mark.parametrize("direct_ce", [False, True])
def test_css_losses_match_jax(variables, direct_ce):
    b = _batch(1)
    x = (b["rgb"] / 255.0).astype(np.float32)
    jmodel = jcss.CSSNet(use_running_average=True, width=WIDTH)
    jpred = jmodel.apply(variables, jnp.asarray(x))
    jl = jtrain.css_losses(jpred, {k: jnp.asarray(v) for k, v in b.items()},
                           direct_ce=direct_ce)
    model = tcss.params_from_jax(variables, width=WIDTH)
    with torch.no_grad():
        tpred = model(torch.as_tensor(x))
    tl = ttrain.css_losses(tpred, {k: torch.as_tensor(v)
                                   for k, v in b.items()},
                           direct_ce=direct_ce)
    for k in ("loss", "loss_uvw", "loss_mask", "loss_latent"):
        assert float(tl[k]) == pytest.approx(float(jl[k]), rel=1e-5), k


@pytest.mark.parametrize("direct_ce", [True])
def test_three_train_steps_match_jax(variables, direct_ce):
    # the port's default objective (config_train.ini: direct_ce = True); the
    # other one is held by test_css_losses_match_jax
    batches = [_batch(10 + i) for i in range(3)]
    jstate = jtrain.init_train_state(
        jax.tree.map(jnp.asarray, variables), LR)
    jstep = jax.jit(jtrain.make_train_step(
        LR, model=jcss.CSSNet(use_running_average=False, width=WIDTH),
        direct_ce=direct_ce))
    model = tcss.params_from_jax(variables, width=WIDTH)
    state = ttrain.init_train_state(model, LR)
    tstep = ttrain.make_train_step(direct_ce=direct_ce)
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tm = tstep(state, {k: torch.as_tensor(v) for k, v in b.items()})
        for k in ("loss", "loss_uvw", "loss_mask", "loss_latent"):
            assert float(tm[k]) == pytest.approx(
                float(jm[k]), rel=1e-5 if i == 0 else 1e-3), (i, k)
        if i == 0:
            d = _param_diffs(
                _flat(tcss.state_to_flax(state.model)["params"]),
                _flat(jax_tree_to_numpy(jstate.variables)["params"]),
                _flat(variables["params"]))
            assert (d <= 1e-5).mean() >= 0.995, (d <= 1e-5).mean()
            assert d.max() <= 2 * LR * 1.01
            # the first step's statistics come from the same weights
            gs = _flat(tcss.state_to_flax(state.model)["batch_stats"])
            ws = _flat(jax_tree_to_numpy(jstate.variables)["batch_stats"])
            for k in ws:
                np.testing.assert_allclose(gs[k], ws[k], rtol=1e-4,
                                           atol=1e-5, err_msg=k)
    assert state.step == int(jstate.step) == 3 == state.opt.count

    got = tcss.state_to_flax(state.model)
    want = jax_tree_to_numpy(jstate.variables)
    gp, wp = _flat(got["params"]), _flat(want["params"])
    d = _param_diffs(gp, wp, _flat(variables["params"]))
    assert np.median(d) <= 1e-4 and d.max() <= 3 * 2 * LR * 1.01, (
        np.median(d), d.max())
    # later statistics come from weights that the sign flips moved apart
    # (~4e-3 of a leaf's largest element at most, 3e-5 in the median):
    # every element within 1e-2 of its leaf's largest, the median within
    # 1e-4
    gs, ws = _flat(got["batch_stats"]), _flat(want["batch_stats"])
    rel = np.concatenate([np.abs(gs[k] - ws[k]) / np.abs(ws[k]).max()
                          for k in ws])  # frozen layers' statistics too
    assert rel.max() <= 1e-2 and np.median(rel) <= 1e-4, (
        rel.max(), np.median(rel))
    assert not np.allclose(gs["layer1_0/TorchBatchNorm_0/BatchNorm_0/mean"],
                           _flat(variables["batch_stats"])[
                               "layer1_0/TorchBatchNorm_0/BatchNorm_0/mean"])
