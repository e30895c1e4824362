"""Rank bodies for the port's data-parallel tests on gloo
(tests/test_torch_mesh.py, tests/test_torch_deepsdf_dp.py).

Each function runs as one rank of parallel/mesh.py::spawn_ranks (a fresh
process in a gloo process group; it imports torch and the port only) and
pickles what it saw to ``<out>/<name>_<rank>.pkl`` for the parent test.
"""

import os
import pickle

import torch

from sdflabel_tpu_torch.engine import css_train as ttrain
from sdflabel_tpu_torch.engine import deepsdf_train as dtrain
from sdflabel_tpu_torch.models import css as tcss
from sdflabel_tpu_torch.models import deepsdf as tds
from sdflabel_tpu_torch.parallel import mesh as mesh_mod


def _share_cores(world):
    # the ranks share the host's cores; oversubscribed threads spin in
    # each collective
    torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // world)))


def _dump(out, name, rank, obj):
    with open(os.path.join(out, f"{name}_{rank}.pkl"), "wb") as f:
        pickle.dump(obj, f)


def layout_rank(rank, out, n_data, n_rays):
    """The rank's mesh place and the sums of the ranks over each axis."""
    mesh = mesh_mod.make_mesh(n_data, n_rays)
    sums = []
    for group in (mesh.data_group, mesh.rays_group):
        t = torch.tensor([float(rank)])
        torch.distributed.all_reduce(t, group=group)
        sums.append(float(t))
    _dump(out, "layout", rank, {
        "index": (mesh.data_index, mesh.rays_index), "size": mesh.size,
        "sums": sums, "frames": list(mesh_mod.process_frame_subset(11))})


def css_rank(rank, out, variables, width, lr, batches):
    """Data-parallel CSS steps on the global `batches` from carried flax
    `variables`: the metrics, the variables after each step."""
    mesh = mesh_mod.make_mesh()
    _share_cores(mesh.size)
    state = ttrain.init_train_state(tcss.params_from_jax(variables, width),
                                    lr)
    step = ttrain.shard_train_step(ttrain.make_train_step(direct_ce=True),
                                   mesh)
    res = []
    for b in batches:
        m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        res.append({"metrics": {k: float(v) for k, v in m.items()},
                    "vars": tcss.state_to_flax(state.model),
                    "grads": {n: p.grad.numpy().copy() for n, p in
                              state.model.named_parameters()
                              if p.grad is not None}})
    _dump(out, "css", rank, res)


def deepsdf_rank(rank, out, spec, tcfg_kw, state, pack, scene_idx, seed,
                 rows):
    """One data-parallel DeepSDF step: on the port's own draw from a
    generator seeded `seed` (rows None), or on the given global `rows`."""
    mesh = mesh_mod.make_mesh()
    _share_cores(mesh.size)
    cfg = tds.DeepSDFConfig(**spec)
    tcfg = dtrain.DeepSDFTrainConfig(**tcfg_kw)
    idx = torch.as_tensor(scene_idx).long()
    if rows is None:
        step = dtrain.shard_train_step(dtrain.train_step, mesh)
        new, m = step(cfg, tcfg, 1, state, dtrain.TrainTensors(pack, "cpu"),
                      idx, torch.Generator().manual_seed(seed))
    else:
        cut = mesh_mod.data_slice(len(scene_idx), mesh)
        scales = torch.as_tensor(pack.scales)
        shard = dtrain.Shard(cut.start, len(scene_idx),
                             torch.isfinite(scales[idx]).sum())
        new, m = dtrain.step_on_samples(
            cfg, tcfg, 1, state, torch.as_tensor(rows)[cut], idx[cut],
            scales, None, shard, mesh.data_group)
    _dump(out, "deepsdf", rank, {
        "metrics": {k: float(v) for k, v in m.items()},
        "params": [x.numpy() for x in dtrain._leaves(new.params)],
        "codes": new.codes.numpy()})


def load(out, name, world):
    res = []
    for r in range(world):
        with open(os.path.join(out, f"{name}_{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res


def same_on_every_rank(res):
    """The ranks' results as one (they must agree bit for bit)."""
    first = pickle.dumps(res[0])
    assert all(pickle.dumps(r) == first for r in res[1:])
    return res[0]

