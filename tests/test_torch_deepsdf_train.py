"""The port's DeepSDF trainer (data/sdf_samples.py, engine/deepsdf_train.py,
models/deepsdf_workspace.py, pipelines/train_deepsdf.py) against the JAX
package's, at tests/test_deepsdf_train.py's small widths, on the CPU.

jax.random and torch's generators never draw the same rows, so the steps
are held on JAX's drawn rows (the port's step takes them through
step_on_samples) from JAX's initial state carried across
(train_state_from_jax). Both sides are fp32 and sum in other orders:
parameters and codes within 1e-5 after 3 steps; checkpoints decode to
within 1e-6."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sdflabel_tpu.data import sdf_samples as jsamples
from sdflabel_tpu.engine import deepsdf_train as jtrain
from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.models import deepsdf_workspace as jws
from sdflabel_tpu.pipelines import train_deepsdf as jpipe
from sdflabel_tpu_torch.data import sdf_samples as tsamples
from sdflabel_tpu_torch.engine import deepsdf_train as ttrain
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.models import deepsdf_workspace as tws
from sdflabel_tpu_torch.parallel import mesh as mesh_mod
from sdflabel_tpu_torch.pipelines import train_deepsdf as tpipe
from torch_parity_util import jax_tree_to_numpy

SPEC = dict(latent_size=2, dims=(32, 32, 32, 32), norm_layers=(0, 1, 2, 3),
            latent_in=(2,), weight_norm=True)
JCFG = jds.DeepSDFConfig(**SPEC)
TCFG = tds.DeepSDFConfig(**SPEC)
RADII = (0.3, 0.4, 0.5, 0.6)


def _sphere(radius):
    return lambda p: np.linalg.norm(np.asarray(p), axis=-1) - radius


def _scenes(mod, n=400, seed=0):
    rng = np.random.RandomState(seed)
    return [mod.sample_analytic_sdf(_sphere(r), rng, n) for r in RADII]


def _pack(mod, scales=(0.6, np.nan, 1.0, 1.2)):
    return mod.pack_scenes(_scenes(mod), names=[f"s{r}" for r in RADII],
                           scales=list(scales))


def test_samples_pack_and_split_equal_jax(tmp_path):
    for a, b in zip(_scenes(jsamples), _scenes(tsamples)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    jp, tp = _pack(jsamples), _pack(tsamples)
    for f in ("pos", "neg", "pos_count", "neg_count", "scales"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
    assert tp.names == jp.names and tp.num_scenes == 4
    rows = np.arange(10, dtype=np.float32).reshape(5, 2)
    np.testing.assert_array_equal(tsamples._pad_cyclic(rows, 12),
                                  jsamples._pad_cyclic(rows, 12))
    # the split resolves to the same files in the same order
    split = {"ds": {"car": ["b", "a"]}}
    rng = np.random.RandomState(1)
    for inst in ("a", "b"):
        pos, neg = tsamples.sample_analytic_sdf(_sphere(0.4), rng, 200)
        tsamples.write_sdf_samples(
            str(tmp_path / "SdfSamples" / "ds" / "car" / f"{inst}.npz"),
            pos, neg)
    assert (tsamples.split_instance_paths(str(tmp_path), split)
            == jsamples.split_instance_paths(str(tmp_path), split))
    tl = tsamples.load_scene_pack(str(tmp_path), split, scales={"a": 1.5})
    jl = jsamples.load_scene_pack(str(tmp_path), split, scales={"a": 1.5})
    assert tl.names == jl.names == ("a", "b")
    np.testing.assert_array_equal(tl.pos, jl.pos)
    np.testing.assert_array_equal(tl.scales, jl.scales)


def test_from_specs_equals_jax():
    specs = jds.specs_from_config(JCFG)
    specs.update({
        "SamplesPerScene": 256, "ScenesPerBatch": 4, "ClampingDistance": 0.2,
        "CodeRegularizationLambda": 1e-3, "CodeInitStdDev": 0.5,
        "CodeBound": 1.0, "GradientNormClipping": 1.5,
        "ScaleSupervisionWeight": 0.25,
        "LearningRateSchedule": [
            {"Type": "Step", "Initial": 5e-4, "Interval": 500,
             "Factor": 0.5},
            {"Type": "Step", "Initial": 1e-3, "Interval": 250,
             "Factor": 0.25}]})
    for s in (specs, jds.specs_from_config(JCFG)):
        assert (dataclasses.asdict(ttrain.DeepSDFTrainConfig.from_specs(s))
                == dataclasses.asdict(jtrain.DeepSDFTrainConfig.from_specs(s)))
    # the port's export of the config reads back as JAX reads it
    assert tds.specs_from_config(TCFG) == jds.specs_from_config(JCFG)
    assert (jds.DeepSDFConfig.from_specs(tds.specs_from_config(TCFG))
            == JCFG)


def test_lr_staircase_and_adam_equal_optax():
    # tests/test_deepsdf_train.py's probe: the decoder group decays at
    # 1-based epoch 5 (count 8), the codes group at epoch 3 (count 4); the
    # port's updates equal optax's for a varying gradient at every count
    tcfg = dict(lr_decoder=1.0, lr_interval=5, lr_factor=0.5, lr_codes=1.0,
                lr_interval_codes=3, lr_factor_codes=0.1)
    spe = 2
    opt = jtrain.make_optimizer(jtrain.DeepSDFTrainConfig(**tcfg), spe)
    params = ({"lin0": {"w": jnp.zeros((3,))}}, jnp.zeros((2, 1)))
    st = opt.init(params)
    state = ttrain.init_opt({"lin0": {"w": torch.zeros(3)}}, torch.zeros(2, 1))
    rng = np.random.RandomState(0)
    for count in range(19):
        g_w = rng.randn(3).astype(np.float32)
        g_c = rng.randn(2, 1).astype(np.float32)
        upd, st = opt.update(({"lin0": {"w": jnp.asarray(g_w)}},
                              jnp.asarray(g_c)), st, params)
        lr_d, lr_c = ttrain.learning_rates(
            ttrain.DeepSDFTrainConfig(**tcfg), count, spe)
        want_d = 0.5 ** ((count // spe + 1) // 5)
        want_c = 0.1 ** ((count // spe + 1) // 3)
        np.testing.assert_allclose((lr_d, lr_c), (want_d, want_c),
                                   rtol=1e-6)
        (u_w,), state["dec"] = ttrain.adam_update(
            state["dec"], [torch.as_tensor(g_w)], lr_d)
        (u_c,), state["codes"] = ttrain.adam_update(
            state["codes"], [torch.as_tensor(g_c)], lr_c)
        np.testing.assert_allclose(u_w.numpy(),
                                   np.asarray(upd[0]["lin0"]["w"]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(u_c.numpy(), np.asarray(upd[1]),
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("max_norm", [1e-3, 10.0])
def test_clip_equals_optax(max_norm):
    rng = np.random.RandomState(2)
    grads = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(
        np.float32)]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], None)
    got = ttrain.clip_by_global_norm([torch.as_tensor(g) for g in grads],
                                     max_norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _jax_rows(pack, scene_idx, rng, s):
    """The rows JAX's train step draws (deepsdf_train.py:199-213)."""
    b = scene_idx.shape[0]
    k_pos, k_neg, _ = jax.random.split(rng, 3)

    def draw(rows, counts, key, n_draw):
        cnt = jnp.take(jnp.asarray(counts), scene_idx, axis=0)
        idx = jax.random.randint(key, (b, n_draw), 0, cnt[:, None])
        scene_rows = jnp.take(jnp.asarray(rows), scene_idx, axis=0)
        return jnp.take_along_axis(scene_rows, idx[:, :, None], axis=1)

    return np.asarray(jnp.concatenate(
        [draw(pack.pos, pack.pos_count, k_pos, s // 2),
         draw(pack.neg, pack.neg_count, k_neg, s - s // 2)], axis=1))


VARIANTS = {
    "plain": dict(samples_per_scene=256, scenes_per_batch=4),
    # the clip (small enough to act), the code bound (inside the codes'
    # norms) and the scale head with a NaN target
    "clip_bound_scale": dict(samples_per_scene=256, scenes_per_batch=4,
                             grad_clip=0.05, code_bound=0.3,
                             scale_weight=0.5, code_init_std=1.0),
}


def _leaves(tree):
    return [x for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_three_steps_on_jax_rows_match_jax(variant):
    tcfg_kw = VARIANTS[variant]
    jt = jtrain.DeepSDFTrainConfig(**tcfg_kw)
    tt = ttrain.DeepSDFTrainConfig(**tcfg_kw)
    pack = _pack(jsamples)
    spe = 1
    jstate = jtrain.init_train_state(JCFG, jt, 4, spe, jax.random.PRNGKey(0))
    tstate = ttrain.train_state_from_jax(jax_tree_to_numpy(jstate))
    step = jax.jit(jtrain.make_train_step(JCFG, jt, spe))
    args = tuple(jnp.asarray(a) for a in (pack.pos, pack.neg, pack.pos_count,
                                          pack.neg_count, pack.scales))
    scales = torch.as_tensor(pack.scales)
    for s in range(3):
        idx = np.array([(s + k) % 4 for k in range(4)], np.int32)
        rng = jax.random.fold_in(jax.random.PRNGKey(1), s)
        rows = _jax_rows(pack, jnp.asarray(idx), rng, 256)
        jstate, jm = step(jstate, *args, jnp.asarray(idx), rng)
        tstate, tm = ttrain.step_on_samples(
            TCFG, tt, spe, tstate, torch.as_tensor(rows.copy()),
            torch.as_tensor(idx).long(), scales)
        for k in ("loss", "loss_l1", "loss_reg", "loss_scale", "code_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-8, err_msg=k)
    assert tstate.step == int(jstate.step) == 3
    for a, b in zip(ttrain._leaves(tstate.params),
                    ttrain._leaves(jax_tree_to_numpy(jstate.params))):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)
    np.testing.assert_allclose(tstate.codes.numpy(),
                               np.asarray(jstate.codes), atol=1e-5)
    if variant == "clip_bound_scale":
        assert float(tm["loss_scale"]) > 0
        norms = np.linalg.norm(tstate.codes.numpy(), axis=-1)
        assert norms.max() <= 0.3 + 1e-6
    # the state carried across after the steps: moments and counts
    carried = ttrain.train_state_from_jax(jax_tree_to_numpy(jstate))
    for g in ("dec", "codes"):
        assert int(carried.opt[g].count) == int(tstate.opt[g].count) == 3
        for a, b in zip(ttrain._leaves(tstate.opt[g].mu),
                        ttrain._leaves(carried.opt[g].mu)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
        for a, b in zip(ttrain._leaves(tstate.opt[g].nu),
                        ttrain._leaves(carried.opt[g].nu)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-9,
                                       rtol=1e-4)


def test_code_reg_form_equals_jax():
    # lambda * min(1, (epoch + 1) / 100) * mean ||z||, at epoch 0 and 250
    kw = dict(samples_per_scene=64, scenes_per_batch=2, code_reg_lambda=1e-2,
              code_init_std=4.0)
    jt, tt = (m.DeepSDFTrainConfig(**kw) for m in (jtrain, ttrain))
    pack = _pack(jsamples)
    jstate = jtrain.init_train_state(JCFG, jt, 4, 1, jax.random.PRNGKey(0))
    tstate = ttrain.train_state_from_jax(jax_tree_to_numpy(jstate))
    idx = np.array([0, 2], np.int32)
    rows = _jax_rows(pack, jnp.asarray(idx), jax.random.PRNGKey(1), 64)
    for epoch in (0, 250):
        m = ttrain.losses(TCFG, tt, tstate.params, tstate.codes,
                          torch.as_tensor(rows), torch.as_tensor(idx).long(),
                          torch.as_tensor(pack.scales), epoch)
        z = np.asarray(jstate.codes)[idx]
        want = 1e-2 * min(1.0, (epoch + 1) / 100) * np.mean(
            np.linalg.norm(z, axis=1))
        np.testing.assert_allclose(float(m["loss_reg"]), want, rtol=1e-5)
    step = jax.jit(jtrain.make_train_step(JCFG, jt, 1))
    _, jm = step(jstate, *(jnp.asarray(a) for a in (
        pack.pos, pack.neg, pack.pos_count, pack.neg_count, pack.scales)),
        jnp.asarray(idx), jax.random.PRNGKey(1))
    m0 = ttrain.losses(TCFG, tt, tstate.params, tstate.codes,
                       torch.as_tensor(rows), torch.as_tensor(idx).long(),
                       torch.as_tensor(pack.scales), 0)
    np.testing.assert_allclose(float(m0["loss_reg"]), float(jm["loss_reg"]),
                               rtol=1e-6)


def test_dropout_train_mode():
    # eval mode equals JAX's apply_sdf; train mode keeps ~80% of the
    # activations at dropout_prob 0.2, a generator's draw fixes the masks
    spec = dict(SPEC, dropout=(0, 1, 2, 3), dropout_prob=0.2)
    jcfg, tcfg = jds.DeepSDFConfig(**spec), tds.DeepSDFConfig(**spec)
    jparams = jds.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = tds.params_from_jax(jax_tree_to_numpy(jparams))
    x = np.random.RandomState(4).randn(500, 5).astype(np.float32)
    want = np.asarray(jds.apply_sdf(jcfg, jparams, jnp.asarray(x)))
    got = tds.apply_sdf(tcfg, tparams, torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    a = tds.apply_sdf(tcfg, tparams, torch.as_tensor(x),
                      torch.Generator().manual_seed(5))
    b = tds.apply_sdf(tcfg, tparams, torch.as_tensor(x),
                      torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, got)
    keep = tds._dropout(torch.ones(100000), 0.8,
                        torch.Generator().manual_seed(6))
    assert abs(float((keep > 0).float().mean()) - 0.8) < 0.01
    assert torch.allclose(keep[keep > 0], torch.tensor(1.25))


def _jax_state_after_steps(n):
    jt = jtrain.DeepSDFTrainConfig(samples_per_scene=128, scenes_per_batch=4)
    pack = _pack(jsamples)
    state = jtrain.init_train_state(JCFG, jt, 4, 1, jax.random.PRNGKey(2))
    step = jax.jit(jtrain.make_train_step(JCFG, jt, 1))
    args = tuple(jnp.asarray(a) for a in (pack.pos, pack.neg, pack.pos_count,
                                          pack.neg_count, pack.scales))
    for s in range(n):
        state, _ = step(state, *args, jnp.arange(4, dtype=jnp.int32),
                        jax.random.PRNGKey(s))
    return pack, state


def test_checkpoints_cross_between_the_packages(tmp_path):
    # the port's deepsdf.pt (and ModelParameters/, LatentCodes/) loaded by
    # JAX's loaders, and JAX's loaded by the port: SDFs within 1e-6
    pack, jstate = _jax_state_after_steps(2)
    tstate = ttrain.train_state_from_jax(jax_tree_to_numpy(jstate))
    texp, jexp = str(tmp_path / "t"), str(tmp_path / "j")
    for d in (texp, jexp):
        os.makedirs(d)
        with open(os.path.join(d, "specs.json"), "w") as f:
            json.dump(jds.specs_from_config(JCFG), f)
    tpipe.save_reference_checkpoints(texp, TCFG, tstate, pack.names,
                                     epoch=3)
    jpipe.save_reference_checkpoints(jexp, JCFG, jstate, pack.names,
                                     epoch=3)
    pts = np.random.RandomState(5).randn(64, 3).astype(np.float32) * 0.4
    code = np.asarray(jstate.codes[1])
    want = np.asarray(jds.decode(JCFG, jstate.params, jnp.asarray(code),
                                 jnp.asarray(pts))[0])
    cfg_j, params_j, _ = jws.setup_dsdf(os.path.join(texp, "deepsdf.pt"))
    cfg_j2, params_j2, epoch = jws.load_decoder(texp, "latest")
    assert cfg_j == cfg_j2 == JCFG and epoch == 3
    np.testing.assert_allclose(jws.load_latent_vectors(texp, "latest"),
                               np.asarray(jstate.codes), atol=1e-7)
    for p in (params_j, params_j2):
        got = np.asarray(jds.decode(JCFG, p, jnp.asarray(code),
                                    jnp.asarray(pts))[0])
        np.testing.assert_allclose(got, want, atol=1e-6)
    cfg_t, params_t, latent = tws.setup_dsdf(
        os.path.join(jexp, "deepsdf.pt"), device="cpu")
    cfg_t2, params_t2, epoch = tws.load_decoder(jexp, "latest", device="cpu")
    assert cfg_t == cfg_t2 == TCFG and latent == 2 and epoch == 3
    np.testing.assert_allclose(tws.load_latent_vectors(jexp, "latest"),
                               np.asarray(jstate.codes), atol=1e-7)
    for p in (params_t, params_t2, tds.load_torch_checkpoint(
            os.path.join(texp, "deepsdf.pt"), device="cpu")[1]):
        got = tds.sdf_fn(TCFG, p)(torch.as_tensor(code), torch.as_tensor(pts))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    names = torch.load(os.path.join(texp, "LatentCodes", "latest.pth"),
                       weights_only=False)["instance_names"]
    assert tuple(names) == pack.names


def test_resume_bit_identical(tmp_path):
    tt = ttrain.DeepSDFTrainConfig(samples_per_scene=128, scenes_per_batch=2)
    tensors = ttrain.TrainTensors(_pack(tsamples), "cpu")

    def run(state, start, stop):
        for s in range(start, stop):
            state, _ = ttrain.train_step(
                TCFG, tt, 2, state, tensors, torch.tensor([s % 4, 3]),
                tpipe.step_generator(3, state.step, "cpu"))
        return state

    def fresh():
        return ttrain.init_train_state(TCFG, tt, 4,
                                       torch.Generator().manual_seed(3))

    full = run(fresh(), 0, 6)
    half = run(fresh(), 0, 3)
    exp = str(tmp_path / "exp")
    path = tpipe.save_resume_state(exp, half)
    assert tpipe.latest_resume_state(exp) == path
    restored = tpipe.restore_resume_state(path, "cpu")
    assert restored.step == 3
    resumed = run(restored, 3, 6)
    for a, b in zip(ttrain._leaves(ttrain.state_tree(full)),
                    ttrain._leaves(ttrain.state_tree(resumed))):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
        else:
            assert a == b


def _experiment(tmp_path):
    exp = str(tmp_path / "exp")
    os.makedirs(exp)
    rng = np.random.RandomState(0)
    names = [f"s{i}" for i in range(4)]
    for name, r in zip(names, RADII):
        pos, neg = tsamples.sample_analytic_sdf(_sphere(r), rng, 300)
        tsamples.write_sdf_samples(
            str(tmp_path / "SdfSamples" / "ds" / "car" / f"{name}.npz"),
            pos, neg)
    with open(os.path.join(exp, "split.json"), "w") as f:
        json.dump({"ds": {"car": names}}, f)
    specs = jds.specs_from_config(JCFG)
    specs.update({"TrainSplit": "split.json", "DataSource": str(tmp_path),
                  "NumEpochs": 2, "SnapshotFrequency": 1,
                  "SamplesPerScene": 128, "ScenesPerBatch": 2})
    with open(os.path.join(exp, "specs.json"), "w") as f:
        json.dump(specs, f)
    return exp


def test_train_deepsdf_end_to_end_on_the_cpu(tmp_path, capsys):
    exp = _experiment(tmp_path)
    state = tpipe.train_deepsdf(exp, device="cpu", log_every=1)
    assert state.step == 4  # 4 scenes / batch 2 = 2 steps x 2 epochs
    assert "epoch 2/2" in capsys.readouterr().out
    for f in ("deepsdf.pt", "deepsdf.json",
              os.path.join("ModelParameters", "latest.pth"),
              os.path.join("LatentCodes", "latest.pth")):
        assert os.path.exists(os.path.join(exp, f)), f
    # JAX's loaders read what the port wrote
    cfg, params, epoch = jws.load_decoder(exp, "latest")
    assert cfg == JCFG and epoch == 2
    pts = np.random.RandomState(1).randn(32, 3).astype(np.float32) * 0.4
    code = state.codes[0]
    want = tds.sdf_fn(TCFG, state.params)(code, torch.as_tensor(pts))
    got = jds.decode(JCFG, params, jnp.asarray(code.numpy()),
                     jnp.asarray(pts))[0]
    np.testing.assert_allclose(np.asarray(got), want.numpy(), atol=1e-6)
    # a third epoch resumes from Checkpoints/ through the CLI
    tpipe.main([exp, "--epochs", "3", "--device", "cpu"])
    assert tpipe.restore_resume_state(tpipe.latest_resume_state(exp),
                                      "cpu").step == 6


def test_entry_point_needs_a_card_unless_asked(tmp_path):
    exp = _experiment(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpipe.train_deepsdf(exp)
        # nor does a data-parallel mesh take the card's place (its CPU run,
        # --devices 2 --device cpu, is tests/test_torch_deepsdf_dp.py's)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpipe.train_deepsdf(exp, mesh=mesh_mod.Mesh(
                {"data": 2, "rays": 1}, 0, 0, 0))


def test_draw_takes_true_rows_half_positive_half_negative():
    # the port's own draw (JAX's jax.random rows differ): every row of a
    # scene's positive half is one of its true positive rows, every row of
    # its negative half one of its true negative rows; a generator's seed
    # fixes the draw
    pack = _pack(tsamples)
    tensors = ttrain.TrainTensors(pack, "cpu")
    idx = torch.tensor([2, 0, 3])
    rows = ttrain.draw(tensors, idx, 101, torch.Generator().manual_seed(4))
    again = ttrain.draw(tensors, idx, 101, torch.Generator().manual_seed(4))
    assert rows.shape == (3, 101, 4) and torch.equal(rows, again)
    for k, i in enumerate(idx.tolist()):
        pos = pack.pos[i, :pack.pos_count[i]]
        neg = pack.neg[i, :pack.neg_count[i]]
        for half, true in ((rows[k, :50].numpy(), pos),
                           (rows[k, 50:].numpy(), neg)):
            assert (half[:, None, :] == true[None]).all(-1).any(1).all()
        assert (rows[k, :50, 3] >= 0).all() and (rows[k, 50:, 3] < 0).all()
