"""The quality suite's CSS training (tools/quality_suite.py::
train_suite_css) against scripts/make_quality_suite.py::train_css on the
CPU: the JAX function runs on two frames that the JAX script wrote
(``--profile v1 --frames 2 --skip-fit --skip-css``), with its TREE
pointed at them; the port's runs on the same frames from the initial
variables JAX builds (``CSSNet(use_running_average=False, width=16)
.init(PRNGKey(SEED), zeros((2, 3, 128, 128)))``), width 16, batch 2.

- The crops (the jitter draws, the PNG read and the driver's crop
  transform) are bit-equal to JAX's.
- After one step >= 99.5% of the parameters agree to 1e-5 and all to
  2 lr, the batch statistics to 1e-4 relative and 1e-5 absolute (the
  three-step CSS test's first-step criterion): the parameters apart are
  the biases of the convolutions that a BatchNorm follows, whose true
  gradient is 0, so that Adam's first step turns each framework's fp32
  noise into +-lr of its own sign.
- Those biases then move the next gradients: flax's BatchNorm variance
  E[x^2] - E[x]^2 keeps their rounding, so that moving them by +-2e-3
  changes the second step's gradients by a median 1.4% relative in the
  port alone. After two steps the parameters therefore agree to a median
  of 1e-5 and all within 2 x 2 lr, and the statistics to a median of
  1e-5 and each within 1e-2 of its leaf's largest element; >= 99.5% of
  them within 1e-5 does not hold there (75% and 60% in this run). The
  losses agree to 1e-4 at the first step and 1e-3 relative at the
  second.
- The port's export loads in JAX (pipelines/train_css.py::
  load_checkpoint) equal to the trained net."""

import contextlib
import copy
import io
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdflabel_tpu.pipelines.refine_css as jpipe
from sdflabel_tpu.models import css as jcss
from sdflabel_tpu.pipelines import train_css as jtrain_pipe
from sdflabel_tpu_torch.models import css as tcss
from sdflabel_tpu_torch.tools import quality_suite as qs
from torch_parity_util import few_threads  # noqa: F401 (autouse)
from torch_parity_util import (jax_tree_to_numpy, make_quality_suite_module,
                               shared_jax_quality_suite)

WIDTH, BATCH, LR = 16, 2, 1e-3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _diffs(got, want):
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    return np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree, frames = shared_jax_quality_suite(tmp_path_factory, "v1", 2)
    mqs = make_quality_suite_module()
    # JAX's initial variables (jitted: the same draws, built sooner)
    init = jax_tree_to_numpy(jax.jit(lambda key: jcss.CSSNet(
        use_running_average=False, width=WIDTH).init(
            key, jnp.zeros((BATCH, 3, 128, 128))))(
                jax.random.PRNGKey(qs.SEED)))
    crops, after_one = [], {}
    original = jpipe.transform_bgr_crop

    def spy(crop_bgr):
        if len(crops) == BATCH:  # the second step's first crop: read the
            # variables the first step left in train_css's frame
            f = sys._getframe(1)
            while f.f_code is not mqs.train_css.__code__:
                f = f.f_back
            after_one.update(jax_tree_to_numpy(
                {k: f.f_locals[k] for k in ("params", "batch_stats")}))
        out = original(crop_bgr)
        crops.append(out[0])
        return out

    printed = io.StringIO()
    tree_before = mqs.TREE
    try:
        jpipe.transform_bgr_crop = spy
        mqs.TREE = tree
        with contextlib.redirect_stdout(printed):
            final = jax_tree_to_numpy(mqs.train_css(
                frames, width=WIDTH, steps=2, batch=BATCH))
    finally:
        jpipe.transform_bgr_crop = original
        mqs.TREE = tree_before
    jax_losses = [float(v) for v in re.findall(r"loss (\S+)",
                                               printed.getvalue())]
    port = {n: qs.train_suite_css(frames, tree, width=WIDTH, steps=n,
                                  batch=BATCH, init=init, device="cpu")
            for n in (1, 2)}
    return dict(tree=tree, frames=frames, init=init, crops=crops,
                after_one=after_one, final=final, jax_losses=jax_losses,
                port=port)


def test_crops_bit_equal_jax(runs):
    sample = qs.crop_sampler(runs["frames"], runs["tree"], device="cpu")
    assert len(runs["crops"]) == 2 * BATCH
    for want in runs["crops"]:
        crop, bins, mask, latent = sample()
        np.testing.assert_array_equal(crop.numpy(),
                                      np.asarray(want, np.float32))
        assert bins.shape == (3, 128, 128) and mask.shape == (128, 128)
        assert (bins * (1 - mask)).max() == 0 and mask.max() == 1
        assert latent.shape == (3,)


def test_first_step_matches_jax(runs):
    got = tcss.state_to_flax(runs["port"][1][0])
    d = _diffs(got["params"], runs["after_one"]["params"])
    assert (d <= 1e-5).mean() >= 0.995, (d <= 1e-5).mean()
    assert d.max() <= 2 * LR * 1.01
    gs = _flat(got["batch_stats"])
    ws = _flat(runs["after_one"]["batch_stats"])
    for k in ws:
        np.testing.assert_allclose(gs[k], ws[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_two_steps_match_jax(runs):
    model, losses = runs["port"][2]
    got = tcss.state_to_flax(model)
    d = _diffs(got["params"], runs["final"]["params"])
    assert np.median(d) <= 1e-5 and d.max() <= 2 * 2 * LR * 1.01, (
        np.median(d), d.max())
    gs, ws = _flat(got["batch_stats"]), _flat(runs["final"]["batch_stats"])
    rel = np.concatenate([np.abs(gs[k] - ws[k]) / np.abs(ws[k]).max()
                          for k in ws])
    absd = np.concatenate([np.abs(gs[k] - ws[k]).ravel() for k in ws])
    assert rel.max() <= 1e-2 and np.median(absd) <= 1e-5, (
        rel.max(), np.median(absd))
    j0, j1 = runs["jax_losses"]
    assert abs(float(losses[0]) - j0) <= 1e-4
    assert float(losses[1]) == pytest.approx(j1, rel=1e-3)
    assert float(losses[1]) < float(losses[0])


def test_export_loads_in_jax(runs, tmp_path):
    model, _ = runs["port"][2]
    path = str(tmp_path / "css_quality.msgpack")
    qs.save_css(path, model)
    back = jax_tree_to_numpy(jtrain_pipe.load_checkpoint(path, runs["init"]))
    want = _flat(tcss.state_to_flax(model))
    got = _flat(back)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    # and the port's own loader, as the driver reads it
    again = tcss.load_css(path, WIDTH, device="cpu")
    for k, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


def test_seeded_init_trains(runs):
    frames, tree = runs["frames"], runs["tree"]
    sample = qs.crop_sampler(frames, tree, device="cpu")
    xs, tbs, tms, tls = zip(*(sample() for _ in range(BATCH)))
    fixed = (torch.stack(xs), torch.as_tensor(np.stack(tbs)),
             torch.as_tensor(np.stack(tms)),
             torch.as_tensor(np.stack(tls), dtype=torch.float32))

    def fixed_loss(model):  # on a copy: the statistics stay as trained
        model = copy.deepcopy(model)
        with torch.no_grad():
            return float(qs.suite_css_loss(model(fixed[0], decode=False),
                                           *fixed[1:]))

    start = tcss.init_params(tcss.CSSNet(width=8),
                             torch.Generator().manual_seed(qs.SEED)).train()
    model, losses = qs.train_suite_css(frames, tree, width=8, steps=4,
                                       batch=BATCH, device="cpu")
    assert losses.shape == (4,) and torch.isfinite(losses).all()
    assert model.training
    # the seeded start, and its first batch (the fixed one) learnt
    assert float(losses[0]) == pytest.approx(fixed_loss(start), rel=1e-6)
    assert fixed_loss(model) < fixed_loss(start)
