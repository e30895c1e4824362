"""The demo-asset tool's CSS training (tools/demo_assets.py::train_css)
against scripts/make_demo_assets.py::train_css on the CPU, both on the
committed scene (torch_parity_util.committed_demo_scene: the image, the
annotation, and the NOCS and mask read back from the image), width 8,
batch 2, from the initial variables JAX's train_css builds
(``CSSNet(use_running_average=False, width=8).init(PRNGKey(0),
zeros((2, 3, 128, 128)))``, read from its frame).

- The crops (the jitter and branch draws, the background zeroed or not,
  the in-memory float image through the driver's crop transform) are
  bit-equal to JAX's.
- After one step >= 99.5% of the parameters agree to 1e-5 and all to
  2 lr, the batch statistics to 1e-4 relative and 1e-5 absolute; after
  two steps the parameters to a median of 1e-5 and all within 2 x 2 lr,
  the statistics to a median of 1e-5 and each within 1e-2 of its leaf's
  largest element; the losses to 1e-4 at the first step and 1e-3
  relative at the second: the criteria of test_torch_quality_css.py and
  their reasons (the biases a BatchNorm follows have no true gradient,
  so that Adam's first step turns each framework's fp32 noise there
  into +-lr, and those biases then move the next gradients).
- The port's export loads in JAX (pipelines/train_css.py::
  load_checkpoint) and in the port's load_css equal to the trained
  net."""

import contextlib
import io
import re
import sys

import numpy as np
import pytest
import torch

import sdflabel_tpu.pipelines.refine_css as jpipe
from sdflabel_tpu.pipelines import train_css as jtrain_pipe
from sdflabel_tpu_torch.models import css as tcss
from sdflabel_tpu_torch.tools import demo_assets as da
from sdflabel_tpu_torch.tools import quality_suite as qs
from test_torch_quality_css import _diffs, _flat
from torch_parity_util import few_threads  # noqa: F401 (autouse)
from torch_parity_util import (committed_demo_scene, jax_tree_to_numpy,
                               script_module)

WIDTH, BATCH, LR = 8, 2, 1e-3


@pytest.fixture(scope="module")
def runs():
    mda = script_module("make_demo_assets")
    sample, anno, nocs, mask = committed_demo_scene()
    crops, init, after_one = [], {}, {}
    original = jpipe.transform_bgr_crop

    def spy(crop_bgr):
        if len(crops) in (0, BATCH):  # each step's first crop: read the
            # variables in train_css's frame (its init, then the first
            # step's)
            f = sys._getframe(1)
            while f.f_code is not mda.train_css.__code__:
                f = f.f_back
            (after_one if crops else init).update(jax_tree_to_numpy(
                {k: f.f_locals[k] for k in ("params", "batch_stats")}))
        out = original(crop_bgr)
        crops.append(out[0])
        return out

    printed = io.StringIO()
    try:
        jpipe.transform_bgr_crop = spy
        with contextlib.redirect_stdout(printed):
            final = jax_tree_to_numpy(mda.train_css(
                sample, anno, nocs, mask, width=WIDTH, steps=2,
                batch=BATCH))
    finally:
        jpipe.transform_bgr_crop = original
    jax_losses = [float(v) for v in re.findall(r"loss (\S+)",
                                               printed.getvalue())]
    port = {n: da.train_css(sample, anno, nocs, mask, width=WIDTH, steps=n,
                            batch=BATCH, init=init, device="cpu")
            for n in (1, 2)}
    return dict(scene=(sample, anno, nocs, mask), init=init, crops=crops,
                after_one=after_one, final=final, jax_losses=jax_losses,
                port=port)


def test_crops_bit_equal_jax(runs):
    sample, anno, nocs, mask = runs["scene"]
    draw = da.crop_sampler(sample, anno, nocs, mask, device="cpu")
    assert len(runs["crops"]) == 2 * BATCH
    for want in runs["crops"]:
        crop, bins, m, latent = draw()
        np.testing.assert_array_equal(crop.numpy(),
                                      np.asarray(want, np.float32))
        assert bins.shape == (3, 128, 128) and m.shape == (128, 128)
        assert (bins * (1 - m)).max() == 0 and m.max() == 1
        assert np.array_equal(latent, da.LATENT_GT)


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


def test_export_loads_in_jax_and_port(runs, tmp_path):
    model, _ = runs["port"][2]
    path = str(tmp_path / "css_demo.msgpack")
    qs.save_css(path, model)
    back = jax_tree_to_numpy(jtrain_pipe.load_checkpoint(path, runs["init"]))
    want = _flat(tcss.state_to_flax(model))
    got = _flat(back)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    again = tcss.load_css(path, WIDTH, device="cpu")
    for k, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
