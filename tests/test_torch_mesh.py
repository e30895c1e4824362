"""The port's (data, rays) mesh over torch.distributed
(parallel/mesh.py) and its data-parallel CSS step
(engine/css_train.py::shard_train_step) against sdflabel_tpu's mesh and
single-device step, on gloo ranks on the CPU (tests/torch_dp_worker.py).

Tolerances: the layout and the frame partition are exact. Two ranks each
stepping on half of a global batch of 4 (width 8, 64 px) are held:
- against JAX's single-device step on the same global batch: the loss to
  2e-4 relative, as JAX's own test_data_parallel_train_step_matches_single
  holds its sharded step;
- against the port's one-rank step: the loss to 1e-5 relative, every
  summed gradient within 1e-5 of the largest gradient element (measured:
  5.4e-7) and every BatchNorm running statistic within 1e-5. The two sum the batch statistics and the gradients in
  other orders (fp32), so they differ by rounding only; without the
  backward all-reduce of the statistics the gradients would part by far
  more (the forward, and so the loss, would not show it). The parameters
  after the step agree to 1e-5 wherever |g| >= 1e-5; Adam's first step
  is ~ lr sign(g), so where g is rounding noise (the conv biases ahead of
  a BatchNorm, whose exact gradient is 0) each order steps its own way,
  within 2 lr. The two ranks end bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.engine import css_train as jtrain
from sdflabel_tpu.models import css as jcss
from sdflabel_tpu.parallel import mesh as jmesh
from sdflabel_tpu_torch.engine import css_train as ttrain
from sdflabel_tpu_torch.models import css as tcss
from sdflabel_tpu_torch.parallel import mesh as mesh_mod
import torch_dp_worker as worker

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


def _batch(seed, b=4, px=64):
    rng = np.random.RandomState(seed)
    mask = (rng.uniform(size=(b, px, px)) > 0.4).astype(np.uint8)
    uvw = (rng.randint(1, 256, (b, 3, px, px)) * mask[:, None]).astype(
        np.uint8)
    lat = rng.randn(b, 3).astype(np.float32)
    return {"rgb": rng.randint(0, 256, (b, 3, px, px)).astype(np.uint8),
            "uvw": uvw, "mask": mask,
            "latent": lat / np.linalg.norm(lat, axis=1, keepdims=True)}


@pytest.fixture(scope="module")
def variables():
    model = tcss.init_params(tcss.CSSNet(width=WIDTH),
                             torch.Generator().manual_seed(3))
    return tcss.state_to_flax(model)


def test_make_mesh_single_process_and_errors():
    mesh = mesh_mod.make_mesh()
    assert mesh.shape == {"data": 1, "rays": 1} and mesh.size == 1
    assert (mesh.rank, mesh.data_index, mesh.rays_index) == (0, 0, 0)
    assert mesh.data_group is None
    # JAX's error for a layout that is not the world
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        mesh_mod.make_mesh(n_data=2)
    with pytest.raises(ValueError, match=r"mesh 1x3 != 1 devices"):
        mesh_mod.make_mesh(n_data=1, n_rays=3)
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        jmesh.make_mesh(n_data=2, devices=jax.devices()[:1])
    assert list(mesh_mod.process_frame_subset(7)) == list(range(7))
    # no coordinator: one process, as the JAX package's
    mesh_mod.initialize_distributed()
    assert not torch.distributed.is_initialized()


def test_four_rank_layout_and_frames(tmp_path):
    mesh_mod.spawn_ranks(worker.layout_rank, 4, (str(tmp_path), 2, 2),
                         backend="gloo")
    res = worker.load(str(tmp_path), "layout", 4)
    jax_layout = np.asarray(jmesh.make_mesh(2, 2, devices=jax.devices()[:4])
                            .devices)
    ids = [d.id for d in jax.devices()[:4]]
    for rank, r in enumerate(res):
        i, j = r["index"]
        assert ids[rank] == jax_layout[i, j].id  # JAX's reshape
        assert r["size"] == 4
        # data group: the ranks with this rays index; rays group: with
        # this data index
        assert r["sums"] == [float(j + (2 + j)), float(2 * i + 2 * i + 1)]
    frames = [f for r in res for f in r["frames"]]
    assert frames == list(range(11))  # disjoint, complete, in rank order
    assert [len(r["frames"]) for r in res] == [3, 3, 3, 2]


def test_refusals(variables):
    mesh2 = mesh_mod.Mesh({"data": 2, "rays": 1}, 0, 0, 0)
    with pytest.raises(ValueError, match="fused_ce"):
        ttrain.shard_train_step(ttrain.make_train_step(fused_ce=True), mesh2)
    # one device: the fused CE is allowed, as in JAX
    ttrain.shard_train_step(ttrain.make_train_step(fused_ce=True),
                            mesh_mod.make_mesh())
    step = ttrain.shard_train_step(ttrain.make_train_step(), mesh2)
    state = ttrain.init_train_state(
        tcss.params_from_jax(variables, WIDTH), LR)
    b = {k: torch.as_tensor(v) for k, v in _batch(1, b=3).items()}
    with pytest.raises(ValueError, match="does not divide"):
        step(state, b)
    assert state.step == 0


def test_two_rank_step_matches_one_rank_and_jax(variables, tmp_path):
    b = _batch(20)
    mesh_mod.spawn_ranks(worker.css_rank, 2,
                         (str(tmp_path), variables, WIDTH, LR, [b]),
                         backend="gloo")
    dp = worker.same_on_every_rank(worker.load(str(tmp_path), "css", 2))[0]

    jstate = jtrain.init_train_state(jax.tree.map(jnp.asarray, variables),
                                     LR)
    jstep = jax.jit(jtrain.make_train_step(
        LR, model=jcss.CSSNet(use_running_average=False, width=WIDTH),
        direct_ce=True))
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
    assert dp["metrics"]["loss"] == pytest.approx(float(jm["loss"]),
                                                  rel=2e-4)

    state = ttrain.init_train_state(tcss.params_from_jax(variables, WIDTH),
                                    LR)
    m = ttrain.make_train_step(direct_ce=True)(
        state, {k: torch.as_tensor(v) for k, v in b.items()})
    for k, v in m.items():
        assert dp["metrics"][k] == pytest.approx(float(v), rel=1e-5), k
    # the summed gradients, the BatchNorm statistics' cotangents included
    grads = {n: p.grad.numpy() for n, p in state.model.named_parameters()
             if p.grad is not None}
    assert grads.keys() == dp["grads"].keys()
    largest = max(np.abs(g).max() for g in grads.values())
    for n, g in grads.items():
        np.testing.assert_allclose(dp["grads"][n], g, rtol=0,
                                   atol=1e-5 * largest, err_msg=n)
    want = _flat(tcss.state_to_flax(state.model))
    got = _flat(dp["vars"])
    init = _flat(variables)
    assert want.keys() == got.keys()
    for k in want:
        if k.startswith("batch_stats"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
    # Adam's first step is ~ lr sign(g): where |g| is at the rounding
    # level (the conv biases ahead of a BatchNorm, whose exact gradient
    # is 0) either sum order may step either way; elsewhere the
    # parameters agree to 1e-5
    for name, g in grads.items():
        mod, leaf = name.rsplit(".", 1)
        key = "params/" + mod.replace(".", "/") + "/" + {
            "weight": "kernel"}.get(leaf, leaf)
        if key not in want:
            key = "params/" + mod.replace(".", "/") + "/BatchNorm_0/" + leaf
        gf = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
        d = np.abs(got[key] - want[key])
        assert d.max() <= 2 * LR * 1.01, key
        assert d[np.abs(gf) >= 1e-5].max(initial=0) <= 1e-5, key
        assert np.abs(want[key] - init[key]).max() > 0 or not g.any(), key
