"""The port's data-parallel DeepSDF step
(engine/deepsdf_train.py::shard_train_step) and ``train_deepsdf
--devices N``, on gloo ranks on the CPU, in the setup of JAX's
test_sharded_step_matches_single (tests/test_deepsdf_train.py:184-213):
the tiny decoder, four scenes of 256 rows, 128 samples a scene, the scale
term on, one step.

Tolerances: two ranks each computing two of the four scenes against the
port's one-rank step on the same draw, with JAX's sharded-vs-single
bounds: the loss within 1e-6 relative, the parameters and codes within
rtol 2e-5 / atol 1e-7, without and with dropout (the ranks draw the
global rows and masks and keep their share). On JAX's own drawn rows the
two-rank step holds the standing DeepSDF-trainer tolerance against JAX's
single-device step (ROADMAP §3): losses 1e-5 relative, parameters and
codes 1e-5. The ranks end bit-equal.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.data import sdf_samples as jsamples
from sdflabel_tpu.engine import deepsdf_train as jtrain
from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu_torch.data import sdf_samples as tsamples
from sdflabel_tpu_torch.engine import deepsdf_train as ttrain
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.parallel import mesh as mesh_mod
from torch_parity_util import jax_tree_to_numpy
import torch_dp_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(latent_size=2, dims=(32, 32, 32), norm_layers=(0, 1, 2),
            latent_in=(2,), weight_norm=True)
TCFG = dict(samples_per_scene=128, scenes_per_batch=4, scale_weight=0.25,
            lr_interval=10_000)


def _sphere(radius):
    return lambda p: np.linalg.norm(np.asarray(p), axis=-1) - radius


def _pack(mod, radii=(0.3, 0.4, 0.5, 0.6), n=256, seed=5):
    rng = np.random.RandomState(seed)
    scenes = [mod.sample_analytic_sdf(_sphere(r), rng, n) for r in radii]
    return mod.pack_scenes(scenes, names=[f"sphere{r}" for r in radii],
                           scales=[2.0 * r for r in radii])


def _jax_state():
    return jtrain.init_train_state(jds.DeepSDFConfig(**SPEC),
                                   jtrain.DeepSDFTrainConfig(**TCFG), 4, 1,
                                   jax.random.PRNGKey(7))


def _run_ranks(tmp_path, spec, state, rows, seed=11):
    mesh_mod.spawn_ranks(
        worker.deepsdf_rank, 2,
        (str(tmp_path), spec, TCFG, state, _pack(tsamples),
         np.arange(4), seed, rows), backend="gloo")
    return worker.same_on_every_rank(worker.load(str(tmp_path), "deepsdf",
                                                 2))


@pytest.mark.parametrize("dropout", [False, True])
def test_two_ranks_equal_one_rank(tmp_path, dropout):
    spec = dict(SPEC, dropout=(0, 1), dropout_prob=0.2) if dropout else SPEC
    state = ttrain.train_state_from_jax(jax_tree_to_numpy(_jax_state()))
    dp = _run_ranks(tmp_path, spec, state, None)
    cfg = tds.DeepSDFConfig(**spec)
    one, m = ttrain.train_step(
        cfg, ttrain.DeepSDFTrainConfig(**TCFG), 1, state,
        ttrain.TrainTensors(_pack(tsamples), "cpu"),
        torch.arange(4), torch.Generator().manual_seed(11))
    np.testing.assert_allclose(dp["metrics"]["loss"], float(m["loss"]),
                               rtol=1e-6)
    for k in ("loss_l1", "loss_reg", "loss_scale", "code_norm"):
        np.testing.assert_allclose(dp["metrics"][k], float(m[k]), rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    for a, b in zip(dp["params"], ttrain._leaves(one.params)):
        np.testing.assert_allclose(a, b.numpy(), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(dp["codes"], one.codes.numpy(), rtol=2e-5,
                               atol=1e-7)
    assert float(m["loss_scale"]) > 0


def test_two_ranks_on_jax_rows_match_jax(tmp_path):
    jstate = _jax_state()
    pack = _pack(jsamples)
    idx = jnp.arange(4, dtype=jnp.int32)
    key = jax.random.PRNGKey(11)
    k_pos, k_neg, _ = jax.random.split(key, 3)

    def draw(rows, counts, k, n):
        cnt = jnp.take(jnp.asarray(counts), idx, axis=0)
        i = jax.random.randint(k, (4, n), 0, cnt[:, None])
        return jnp.take_along_axis(jnp.take(jnp.asarray(rows), idx, axis=0),
                                   i[:, :, None], axis=1)

    rows = np.asarray(jnp.concatenate(
        [draw(pack.pos, pack.pos_count, k_pos, 64),
         draw(pack.neg, pack.neg_count, k_neg, 64)], axis=1))
    step = jax.jit(jtrain.make_train_step(jds.DeepSDFConfig(**SPEC),
                                          jtrain.DeepSDFTrainConfig(**TCFG),
                                          1))
    args = tuple(jnp.asarray(a) for a in (pack.pos, pack.neg, pack.pos_count,
                                          pack.neg_count, pack.scales))
    state = ttrain.train_state_from_jax(jax_tree_to_numpy(jstate))
    jnew, jm = step(jstate, *args, idx, key)
    dp = _run_ranks(tmp_path, SPEC, state, rows)
    for k in ("loss", "loss_l1", "loss_reg", "loss_scale", "code_norm"):
        np.testing.assert_allclose(dp["metrics"][k], float(jm[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    for a, b in zip(dp["params"],
                    ttrain._leaves(jax_tree_to_numpy(jnew.params))):
        np.testing.assert_allclose(a, b, atol=1e-5)
    np.testing.assert_allclose(dp["codes"], np.asarray(jnew.codes),
                               atol=1e-5)


NAMES = ["s03", "s04", "s05", "s06"]


def _experiment(root, name, scenes_per_batch=4):
    """An experiment dir over four sphere scenes in root/SdfSamples."""
    if not os.path.exists(root / "SdfSamples"):
        rng = np.random.RandomState(0)
        for inst, r in zip(NAMES, (0.3, 0.4, 0.5, 0.6)):
            pos, neg = tsamples.sample_analytic_sdf(_sphere(r), rng, 300)
            tsamples.write_sdf_samples(
                str(root / "SdfSamples" / "ds" / "car" / f"{inst}.npz"),
                pos, neg)
    specs = tds.specs_from_config(tds.DeepSDFConfig(**SPEC))
    specs.update({"DataSource": str(root), "TrainSplit": "split.json",
                  "SamplesPerScene": 64, "ScenesPerBatch": scenes_per_batch,
                  "NumEpochs": 1})
    d = root / name
    os.makedirs(d)
    with open(d / "specs.json", "w") as f:
        json.dump(specs, f)
    with open(d / "split.json", "w") as f:
        json.dump({"ds": {"car": NAMES}}, f)
    return d


def test_devices_cli_on_the_cpu(tmp_path):
    """``train_deepsdf --devices 2 --device cpu`` for one epoch: rank 0
    writes the reference checkpoints and the resume state, which hold
    what one process trains from the same seed (within the DP
    tolerances)."""
    for name, world in (("two", 2), ("one", 1)):
        cmd = [sys.executable, "-m",
               "sdflabel_tpu_torch.pipelines.train_deepsdf",
               str(_experiment(tmp_path, name)), "--device", "cpu",
               "--epochs", "1"]
        if world > 1:
            cmd += ["--devices", str(world)]
        out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=120,
                             env=dict(os.environ, OMP_NUM_THREADS="2"))
        assert out.returncode == 0, out.stderr[-3000:]
        assert out.stdout.count("epoch 1/1") == 1, out.stdout
    a = torch.load(tmp_path / "two" / "LatentCodes" / "latest.pth")
    b = torch.load(tmp_path / "one" / "LatentCodes" / "latest.pth")
    assert a["instance_names"] == b["instance_names"] == NAMES
    np.testing.assert_allclose(a["latent_codes"].numpy(),
                               b["latent_codes"].numpy(), rtol=2e-5,
                               atol=1e-7)
    assert os.path.exists(tmp_path / "two" / "deepsdf.pt")
    assert len(os.listdir(tmp_path / "two" / "Checkpoints")) == 1


def test_indivisible_batch_is_refused(tmp_path):
    # JAX's check (train_deepsdf.py:118-123), before any collective
    from sdflabel_tpu_torch.pipelines import train_deepsdf as tpipe

    mesh2 = mesh_mod.Mesh({"data": 2, "rays": 1}, 0, 0, 0)
    with pytest.raises(ValueError, match="must divide over the mesh"):
        tpipe.train_deepsdf(str(_experiment(tmp_path, "odd", 3)),
                            mesh=mesh2, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        mesh_mod.data_slice(3, mesh2)
