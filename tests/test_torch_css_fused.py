"""The port's fused-head CSS network (models/css_fused.py) against
sdflabel_tpu/models/css_fused.py, at the JAX test's own sizes: width 64
and latent 3 (the fused net's fixed reference width), batch 2 at 64 px.

Tolerances: the fused net is a rearrangement of CSSNet, so the port's
fused and unfused nets agree to 2e-4 (JAX's tests/test_css_fused.py
bound; on the CPU they agree exactly). Against JAX's fused net on carried
variables every output agrees to 2e-4 of its scale (max(|output|, 1)):
the hardness-100 colour decode turns a 1e-6 logit difference into ~5e-3
of its 0-255 range. One train step follows ROADMAP §3's CSS-step
tolerances (tests/test_torch_css_train.py): the losses to 1e-5 relative,
>= 99.5% of the trainable parameters to 1e-5 and all to 2 lr (Adam's
first step is ~ lr sign(g)), the batch statistics to 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.engine import css_train as jtrain
from sdflabel_tpu.models import css_fused as jfused
from sdflabel_tpu_torch.engine import css_train as ttrain
from sdflabel_tpu_torch.models import css as tcss
from sdflabel_tpu_torch.models import css_fused as tfused
from torch_parity_util import jax_tree_to_numpy

LR = 1e-3
KEYS = ("u", "v", "w", "u_raw", "mask", "latent", "uvw_sm", "mask_sm",
        "uvw_sm_masked")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def variables():
    """CSSNet variables in the flax layout (the port's lecun-normal draws;
    a JAX init at width 64 only costs time), with running statistics
    away from (0, 1), so that eval mode uses them."""
    model = tcss.init_params(tcss.CSSNet(width=64),
                             torch.Generator().manual_seed(0))
    v = tcss.state_to_flax(model)
    rng = np.random.RandomState(4)
    for leaf in _flat(v["batch_stats"]):
        node = v["batch_stats"]
        *path, last = leaf.split("/")
        for p in path:
            node = node[p]
        node[last] = (node[last] + rng.uniform(0, 0.2, node[last].shape)
                      ).astype(np.float32)
    return v


def _x(seed=0):
    return np.random.RandomState(seed).randn(2, 3, 64, 64).astype(np.float32)


def test_fused_equals_unfused_port(variables):
    model = tcss.params_from_jax(variables, width=64)
    fused = tfused.fused_from_css(model)
    x = torch.as_tensor(_x())
    with torch.no_grad():
        a, b = model(x), fused(x)
    assert a.keys() == b.keys()
    for k in KEYS:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=2e-4,
                                   rtol=0, err_msg=k)
    # the fused layout: one dense 384 -> 512 conv, then grouped convs
    assert fused.up1.Conv_0.weight.shape == (512, 384, 3, 3)
    assert fused.up2.Conv_0.weight.shape == (256, 192, 3, 3)
    assert fused.up2.Conv_0.groups == 4


def test_fused_matches_jax_fused(variables):
    fvars = jax_tree_to_numpy(jfused.fuse_css_variables(variables))
    jout = jfused.CSSNetFused(use_running_average=True).apply(
        fvars, jnp.asarray(_x()))
    # the carry-across of JAX's fused variables and the port's own fusing
    # of the carried unfused ones give the same weights
    carried = tfused.params_from_jax(fvars)
    fused = tfused.fused_from_css(tcss.params_from_jax(variables, width=64))
    a, b = carried.state_dict(), fused.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    with torch.no_grad():
        tout = carried(torch.as_tensor(_x()))
    for k in KEYS:
        want = np.asarray(jout[k])
        np.testing.assert_allclose(
            tout[k].numpy(), want, rtol=0,
            atol=2e-4 * max(np.abs(want).max(), 1.0), err_msg=k)
    # and back: the port's fused state in the flax layout is JAX's
    back = _flat(tcss.state_to_flax(carried))
    want = _flat(fvars)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def _batch(seed, b=2, px=64):
    rng = np.random.RandomState(seed)
    mask = (rng.uniform(size=(b, px, px)) > 0.4).astype(np.uint8)
    uvw = (rng.randint(1, 256, (b, 3, px, px)) * mask[:, None]).astype(
        np.uint8)
    lat = rng.randn(b, 3).astype(np.float32)
    return {"rgb": rng.randint(0, 256, (b, 3, px, px)).astype(np.uint8),
            "uvw": uvw, "mask": mask,
            "latent": lat / np.linalg.norm(lat, axis=1, keepdims=True)}


def test_fused_train_step_matches_jax(variables):
    fvars = jax_tree_to_numpy(jfused.fuse_css_variables(variables))
    b = _batch(3)
    jstate = jtrain.init_train_state(jax.tree.map(jnp.asarray, fvars), LR)
    jstep = jax.jit(jtrain.make_train_step(
        LR, model=jfused.CSSNetFused(use_running_average=False),
        direct_ce=True))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})

    state = ttrain.init_train_state(tfused.params_from_jax(fvars), LR)
    tm = ttrain.make_train_step(direct_ce=True)(
        state, {k: torch.as_tensor(v) for k, v in b.items()})
    for k in ("loss", "loss_uvw", "loss_mask", "loss_latent"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    got = tcss.state_to_flax(state.model)
    want = jax_tree_to_numpy(jstate.variables)
    gp, wp, init = (_flat(got["params"]), _flat(want["params"]),
                    _flat(fvars["params"]))
    diffs = []
    for k in wp:
        if k.split("/")[0] in tcss.FROZEN_PREFIXES:
            assert np.array_equal(gp[k], init[k]), k
            assert np.array_equal(wp[k], init[k]), k
        else:
            diffs.append(np.abs(gp[k] - wp[k]).ravel())
    d = np.concatenate(diffs)
    assert (d <= 1e-5).mean() >= 0.995, (d <= 1e-5).mean()
    assert d.max() <= 2 * LR * 1.01
    gs, ws = _flat(got["batch_stats"]), _flat(want["batch_stats"])
    for k in ws:
        np.testing.assert_allclose(gs[k], ws[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
