"""The port's CSS training pipeline (pipelines/train_css.py) end to end on
the CPU: a small crops database from its own make_crops, two epochs at
width 8, a resume from the epoch checkpoint, and the exported
css.msgpack read by the JAX package.

Tolerances: a resumed run repeats the same fp32 operations on the same
data, so it is bit-identical; the exported leaves are the model's exact
float32 values. JAX's eval forward on them agrees with the port's to
1e-4 of each output's scale (fp32 convolutions summed in other orders).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdflabel_tpu.models import css as jcss
from sdflabel_tpu.pipelines import train_css as jpipe
from sdflabel_tpu_torch import config as cfg_mod
from sdflabel_tpu_torch.models import css as tcss
from sdflabel_tpu_torch.pipelines import make_crops as tmc
from sdflabel_tpu_torch.pipelines import train_css as tpipe
from torch_parity_util import jax_tree_to_numpy

WIDTH = 8


def _sphere(latent, points):
    return torch.linalg.norm(points, dim=-1) - (0.75 + 0.1 * latent[0])


@pytest.fixture(scope="module")
def crops_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_crops"))
    tmc.make_crops(out, _sphere,
                   tmc.sample_unit_latents(3, 3, np.random.RandomState(1)),
                   n_crops=6, crop_px=64, grid_density=20, capacity=512,
                   seed=2, device="cpu")
    return out


def _config(crops_dir, log_dir, **kw):
    return tpipe.make_config(crops_dir, log_dir, batch_size=3, **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def two_epochs(crops_dir, tmp_path_factory):
    log = str(tmp_path_factory.mktemp("log_full"))
    losses = []

    def record(step_fn):
        def step(state, batch):
            m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            return m
        return step

    state = tpipe.train_css(_config(crops_dir, log, plot=True),
                            max_epochs=2, device="cpu", width=WIDTH,
                            step_wrapper=record)
    return log, state, losses


def test_two_epochs_train_and_export(two_epochs):
    log, state, losses = two_epochs
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert state.step == state.opt.count == 4 and state.model.training
    assert sorted(os.listdir(os.path.join(log, "ckpt"))) == [
        "step_00000001.pt", "step_00000002.pt"]
    # the epoch's images, readable by PIL
    for name in ("uvw_predsm_1.png", "uvw_gt1.png", "uvw_gt_rgb1.png"):
        img = np.asarray(Image.open(os.path.join(log, "vis", name)))
        assert img.shape == (128, 3 * 128, 3)
    # frozen layers kept their initial weights
    init = tpipe.setup_css(None, width=WIDTH, device="cpu")
    for name, p in state.model.named_parameters():
        frozen = name.split(".")[0] in tcss.FROZEN_PREFIXES
        assert frozen == (not p.requires_grad)
        assert torch.equal(p, dict(init.named_parameters())[name]) == frozen


def test_resume_is_bit_identical(crops_dir, two_epochs, tmp_path):
    _, full, full_losses = two_epochs
    log = str(tmp_path)
    tpipe.train_css(_config(crops_dir, log), max_epochs=1, device="cpu",
                    width=WIDTH)
    losses = []

    def record(step_fn):
        def step(state, batch):
            m = step_fn(state, batch)
            losses.append(float(m["loss"]))
            return m
        return step

    resumed = tpipe.train_css(_config(crops_dir, log), max_epochs=2,
                              device="cpu", width=WIDTH, step_wrapper=record)
    assert losses == full_losses[2:]
    assert resumed.step == full.step and resumed.opt.count == full.opt.count
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for sa, sb in ((full.opt.mu, resumed.opt.mu),
                   (full.opt.nu, resumed.opt.nu)):
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def test_exported_network_loads_in_jax(two_epochs):
    log, state, _ = two_epochs
    path = os.path.join(log, "net", "css.msgpack")
    template = jpipe.setup_css(None, width=WIDTH, latent_size=3)
    variables = jax_tree_to_numpy(jpipe.load_checkpoint(path, template))
    want = _flat(tcss.state_to_flax(state.model))
    got = _flat(variables)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    x = np.random.RandomState(0).randn(2, 3, 128, 128).astype(np.float32)
    jout = jcss.CSSNet(use_running_average=True, width=WIDTH).apply(
        variables, jnp.asarray(x))
    model = tcss.load_css(path, WIDTH, 3, device="cpu")
    with torch.no_grad():
        tout = model(torch.as_tensor(x))
    for k in ("u_raw", "mask", "latent", "uvw_sm"):
        w = np.asarray(jout[k])
        np.testing.assert_allclose(tout[k].numpy(), w,
                                   atol=1e-4 * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


def test_unported_precision_is_refused(crops_dir, tmp_path):
    for value, err in (("bfloat16", NotImplementedError),
                       ("float64", ValueError)):
        cfgp = _config(crops_dir, str(tmp_path), precision=value)
        with pytest.raises(err):
            tpipe.train_css(cfgp, max_epochs=1, device="cpu", width=WIDTH)
    assert not os.path.exists(os.path.join(tmp_path, "ckpt"))
    cfg = cfg_mod.TrainCfg.from_ini(_config(crops_dir, str(tmp_path)))
    assert (cfg.direct_ce, cfg.fused_ce, cfg.batch_size) == (True, False, 3)
