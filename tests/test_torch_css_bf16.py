"""bf16 CSS training in the port (models/css.py ``compute_dtype``,
pipelines/train_css.py ``[train] precision``) against sdflabel_tpu's
``CSSNet(dtype=bfloat16)`` and its train step, width 8.

XLA on the CPU, oneDNN (the port on the CPU) and cuDNN (the card) each
round a bf16 convolution's output their own way, so the yardstick is
JAX's own gap between its bf16 and fp32 runs on the same inputs: the
port's bf16 run must lie within twice that gap of JAX's bf16 run. A
port that computed in fp32 would land at once that gap and pass this
rule, so two more checks tell bf16 from fp32: the forward's outputs lie
nearer JAX's bf16 ones than an fp32 run does (RMS at most 0.8 of JAX's
bf16-vs-fp32 RMS, which the port's fp32 run exceeds), and the step's
BatchNorm statistics differ from the port's own fp32 step's by at least
half of JAX's gap. As measured on these inputs (width 8, 64 px, on the
CPU):
- forward, train mode, batch 4, max |difference| (JAX's bf16 against
  its fp32, then the port's bf16 against JAX's bf16): u_raw 0.396 /
  0.228; v_raw 0.349 / 0.300; w_raw 0.713 / 0.286; mask 0.435 / 0.157;
  latent 0.0375 / 0.0263. RMS (JAX's gap, the port's bf16, the port's
  fp32, each against JAX's bf16): u_raw 0.0249 / 0.0159 / 0.0249; v_raw
  0.0244 / 0.0168 / 0.0244; w_raw 0.0318 / 0.0184 / 0.0318; mask 0.0294
  / 0.0175 / 0.0294; latent 0.0172 / 0.0111 / 0.0172;
- one train step, batch 2, the larger over two batches: loss 5.65e-3 /
  8.77e-3; parameters (L2 over the trainable ones) 0.189 / 0.200;
  BatchNorm statistics (the largest difference over its leaf's largest
  element) 8.66e-3 / 1.10e-2; the port's bf16 step against its own fp32
  step: statistics 1.26e-2. Adam's first step moves each parameter by
  about lr whatever the precision, so the parameters' L2 cannot tell
  bf16 from fp32.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdflabel_tpu.engine import css_train as jtrain
from sdflabel_tpu.models import css as jcss
from sdflabel_tpu_torch.engine import css_train as ttrain
from sdflabel_tpu_torch.models import css as tcss
from sdflabel_tpu_torch.pipelines import train_css as tpipe

WIDTH = 8
PX = 64
LR = 1e-3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # oneDNN's bf16 convolutions slow down many times over when parallel
    # test workers oversubscribe the cores
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def variables():
    return tcss.state_to_flax(tcss.init_params(
        tcss.CSSNet(width=WIDTH), torch.Generator().manual_seed(0)))


def test_forward_within_twice_jax_bf16_gap(variables):
    x = np.random.RandomState(0).randn(4, 3, PX, PX).astype(np.float32)
    jout = {}
    for dt in (jnp.float32, jnp.bfloat16):
        out, _ = jcss.CSSNet(use_running_average=False, width=WIDTH,
                             dtype=dt).apply(variables, jnp.asarray(x),
                                             mutable=["batch_stats"])
        jout[dt] = {k: np.asarray(v) for k, v in out.items()}
    tout = {}
    for dt in (torch.float32, torch.bfloat16):
        model = tcss.params_from_jax(variables, WIDTH).train()
        model.compute_dtype = dt
        with torch.no_grad():
            tout[dt] = {k: v.numpy() for k, v in
                        model(torch.as_tensor(x)).items()}
    assert model.conv1.dtype == model.up2_u.DoubleConv_0.Conv_1.dtype \
        == torch.bfloat16
    assert model.out_u.dtype == model.out_lat.dtype == torch.float32

    def rms(a, b):
        return float(np.sqrt(((a - b) ** 2).mean()))

    for k in ("u_raw", "v_raw", "w_raw", "mask", "latent"):
        got, want = tout[torch.bfloat16][k], jout[jnp.bfloat16][k]
        assert got.dtype == np.float32, k  # fp32 heads
        jax_gap = np.abs(want - jout[jnp.float32][k]).max()
        gap = np.abs(got - want).max()
        assert 0 < gap <= 2 * jax_gap, (k, gap, jax_gap)
        # nearer JAX's bf16 than an fp32 run: the port's fp32 run fails
        jax_rms = rms(want, jout[jnp.float32][k])
        assert rms(got, want) <= 0.8 * jax_rms, (k, rms(got, want), jax_rms)
        assert rms(tout[torch.float32][k], want) > 0.8 * jax_rms, k


def _batch(seed, b=2):
    rng = np.random.RandomState(seed)
    mask = (rng.uniform(size=(b, PX, PX)) > 0.4).astype(np.uint8)
    uvw = (rng.randint(1, 256, (b, 3, PX, PX)) * mask[:, None]).astype(
        np.uint8)
    lat = rng.randn(b, 3).astype(np.float32)
    return {"rgb": rng.randint(0, 256, (b, 3, PX, PX)).astype(np.uint8),
            "uvw": uvw, "mask": mask,
            "latent": lat / np.linalg.norm(lat, axis=1, keepdims=True)}


def _gaps(a, b):
    """(|loss difference|, L2 over the parameters, largest statistics
    difference over its leaf's largest element)."""
    (la, va), (lb, vb) = a, b
    d = np.concatenate([np.abs(va[k] - vb[k]).ravel() for k in va
                        if k.startswith("params")])
    rel = max(np.abs(va[k] - vb[k]).max() / np.abs(vb[k]).max() for k in va
              if k.startswith("batch_stats"))
    return abs(la - lb), float(np.sqrt((d ** 2).sum())), rel


def test_train_step_within_twice_jax_bf16_gap(variables):
    # two batches: a scalar loss can land near its fp32 value by chance,
    # so each gap is the larger over the two
    jsteps = {dt: jax.jit(jtrain.make_train_step(
        LR, model=jcss.CSSNet(use_running_average=False, width=WIDTH,
                              dtype=dt), direct_ce=True))
              for dt in (jnp.float32, jnp.bfloat16)}
    jax_gap, gap, own = np.zeros(3), np.zeros(3), np.zeros(3)
    for seed in (10, 11):
        b = _batch(seed)
        res = {}
        for dt, step in jsteps.items():
            js = jtrain.init_train_state(jax.tree.map(jnp.asarray, variables),
                                         LR)
            js, jm = step(js, {k: jnp.asarray(v) for k, v in b.items()})
            res[dt] = (float(jm["loss"]),
                       _flat(jax.tree.map(np.asarray, js.variables)))
        for dt in (torch.float32, torch.bfloat16):
            model = tcss.params_from_jax(variables, WIDTH)
            model.compute_dtype = dt
            state = ttrain.init_train_state(model, LR)
            m = ttrain.make_train_step(direct_ce=True)(
                state, {k: torch.as_tensor(v) for k, v in b.items()})
            res[dt] = (float(m["loss"]),
                       _flat(tcss.state_to_flax(state.model)))
            # the parameters stay fp32
            assert all(p.dtype == torch.float32
                       for p in state.model.parameters())
        jax_gap = np.maximum(jax_gap, _gaps(res[jnp.bfloat16],
                                            res[jnp.float32]))
        gap = np.maximum(gap, _gaps(res[torch.bfloat16], res[jnp.bfloat16]))
        own = np.maximum(own, _gaps(res[torch.bfloat16], res[torch.float32]))
    for name, g, j in zip(("loss", "params", "stats"), gap, jax_gap):
        assert g <= 2 * j, (name, g, j)
    # the step ran in bf16: its statistics part from the port's fp32 step
    assert own[2] >= 0.5 * jax_gap[2], (own, jax_gap)


@pytest.fixture(scope="module")
def crops_dir(tmp_path_factory):
    """Six 96-px crops with a disc of UVW labels."""
    root = tmp_path_factory.mktemp("bf16_crops")
    rng = np.random.RandomState(2)
    gt = {}
    for i in range(6):
        yy, xx = np.mgrid[0:96, 0:96].astype(np.float32) / 96
        rgb = np.stack([xx, yy, 0.5 + 0.5 * np.sin(6 * xx + i)], -1) * 255
        disc = ((xx - 0.5) ** 2 + (yy - 0.5) ** 2) < 0.1
        uvw = np.stack([xx * 200 + 30, yy * 200 + 30,
                        np.full_like(xx, 90.0 + i)], -1) * disc[..., None]
        Image.fromarray(rgb.astype(np.uint8)).save(
            os.path.join(root, f"{i:05d}_rgb.png"))
        Image.fromarray(uvw.astype(np.uint8)).save(
            os.path.join(root, f"{i:05d}_uvw.png"))
        lat = rng.randn(3)
        gt[str(i)] = [{"latent": (lat / np.linalg.norm(lat)).tolist(),
                       "extrinsics": np.eye(4).ravel().tolist(),
                       "intrinsics": np.eye(3).ravel().tolist()}]
    with open(os.path.join(root, "crops.json"), "w") as f:
        json.dump(gt, f)
    return str(root)


@pytest.mark.parametrize("precision", ["bfloat16", "float16"])
def test_pipeline_trains_in_bf16(crops_dir, tmp_path, precision):
    # float16 maps to bf16, as in the JAX pipeline
    assert tpipe.compute_dtype(precision) == torch.bfloat16
    assert tpipe.compute_dtype("float32") == torch.float32
    losses = []

    def record(step_fn):
        def step(state, batch):
            losses.append(float(step_fn(state, batch)["loss"]))
            return {"loss": torch.tensor(losses[-1])}
        return step

    cfgp = tpipe.make_config(crops_dir, str(tmp_path), batch_size=3,
                             precision=precision, plot=True)
    cfgp.set("log", "log_every", "1000")
    state = tpipe.train_css(cfgp, max_epochs=1, device="cpu", width=WIDTH,
                            step_wrapper=record)
    assert state.model.compute_dtype == torch.bfloat16
    assert len(losses) == 2 and np.isfinite(losses).all()
    # the exported network and the PNGs come from the fp32 model
    assert os.path.exists(os.path.join(tmp_path, "net", "css.msgpack"))
    assert os.path.exists(os.path.join(tmp_path, "vis", "uvw_predsm_0.png"))
