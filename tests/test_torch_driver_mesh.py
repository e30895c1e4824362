"""The data axis of the batched driver over torch.distributed: the port's
refine_css(mesh=) and make_batched_refine(mesh=) on 2 gloo ranks
(tests/torch_sharded_worker.py::driver_mesh_rank, one spawn).

- refine_css on a (data=2, rays=1) mesh, two frames of
  test_kitti.make_kitti_tree, 2 iterations, every pose stubbed as
  tests/test_driver_mesh.py stubs it: each frame's crops split over the
  two ranks. The labels on both ranks and the dumps (written by the first
  rank alone) must equal the port's single-rank batched run bit for bit:
  on the CPU each crop's result does not depend on the other crops of its
  batch (the plain versions run crop by crop), and that run is held
  against JAX by test_torch_driver.py.
- make_batched_refine(mesh=) against JAX's on a (2, 1) mesh: the four
  lanes of test_torch_batched_refine.py, 3 iterations, to its bounds
  (losses rtol 1e-4, parameters and extents 1e-4).
"""

import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdflabel_tpu.engine import refine as jref
from sdflabel_tpu.models import deepsdf as jds
from sdflabel_tpu.ops import grid as jgrid
from sdflabel_tpu.parallel import batched_refine as jbr
from sdflabel_tpu.parallel import mesh as jmesh
from sdflabel_tpu_torch.parallel import mesh as mesh_mod
from sdflabel_tpu_torch.pipelines import refine_css as tpipe
import test_torch_batched_refine as tbatch
import torch_dp_worker as dpw
import torch_sharded_worker as worker
from test_kitti import make_kitti_tree, write_refine_cfg
from torch_parity_util import jax_tree_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSS = os.path.join(REPO, "data", "optimization", "css_demo.msgpack")
LABEL_KEYS = ("location", "dimensions", "rotation_y", "alpha", "bbox",
              "score")
SPEC = dict(latent_size=3, dims=(64, 64, 64), latent_in=(2,))


def _batch_job():
    """test_torch_batched_refine.py's decoder and four lanes, as numpy."""
    jparams = jds.init_params(jds.DeepSDFConfig(**SPEC),
                              jax.random.PRNGKey(3))
    return dict(spec=SPEC, params=jax_tree_to_numpy(jparams),
                cfg=tbatch._cfg_kw(0),
                grid=np.asarray(jgrid.generate_point_grid(tbatch.GRID)),
                bucket=tbatch.BUCKET, batch=tbatch._batch(tbatch._crops()))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_driver")
    kitti = make_kitti_tree(root / "kitti", n_frames=2)
    cfgp = write_refine_cfg(root, kitti)
    cfgp.set("input", "css_path", CSS)
    cfgp.set("input", "css_width", "8")
    ini = {s: dict(cfgp[s]) for s in cfgp.sections()}
    out = str(root / "out")
    os.makedirs(out)
    mesh_mod.spawn_ranks(worker.driver_mesh_rank, 2,
                         (out, ini, _batch_job()), backend="gloo")
    return out, dpw.load(out, "driver_mesh", 2)


def _same(a, b):
    return pickle.dumps(a) == pickle.dumps(b)


def test_refine_css_on_a_data_mesh_equals_one_rank(run):
    out, res = run
    annos, ests = res[0]["lab_mesh"]
    single_annos, single_ests = res[0]["lab_single"]
    assert _same(res[1]["lab_mesh"], res[0]["lab_mesh"])  # every rank
    assert sorted(ests) == sorted(single_ests) == [0, 1]
    n_labels = 0
    for f in single_ests:
        for k in LABEL_KEYS:
            assert np.array_equal(np.asarray(ests[f][k]),
                                  np.asarray(single_ests[f][k])), (f, k)
        assert _same(annos[f], single_annos[f])
        n_labels += len(np.atleast_1d(single_ests[f]["rotation_y"]))
    assert n_labels >= 2, "no labels: the comparison would be vacuous"
    # the dumps: written once, by the first rank, and the same bytes
    names = sorted(os.listdir(os.path.join(out, "lab_single")))
    assert names == sorted(os.listdir(os.path.join(out, "lab_mesh"))) \
        == ["0.pkl", "1.pkl"]
    for name in names:
        with open(os.path.join(out, "lab_mesh", name), "rb") as f:
            got = f.read()
        with open(os.path.join(out, "lab_single", name), "rb") as f:
            assert got == f.read(), name


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for t in tree for x in _leaves(t)]


def test_batched_refine_on_a_data_mesh_matches_jax(run):
    _, res = run
    # every rank ends with the whole batch, bit for bit
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(res[0]["batched"]), _leaves(res[1]["batched"])))
    mesh = jmesh.make_mesh(n_data=2, n_rays=1, devices=jax.devices()[:2])
    jdec, _ = tbatch._decoders()
    fn = jbr.make_batched_refine(
        jdec, jref.RefineConfig(**tbatch._cfg_kw(0)),
        jgrid.generate_point_grid(tbatch.GRID), tbatch.BUCKET, mesh=mesh,
        with_extents=True)
    p0, *rest = tbatch._batch(tbatch._crops())
    jout = fn(jref.RefineParams(**{f: jnp.asarray(v) for f, v in
                                   p0.items()}), *map(jnp.asarray, rest))
    tbatch._assert_same(jout, res[0]["batched"])
    assert res[0]["batched"][1].loss.shape == (tbatch.LANES, 3)


def test_batch_pads_to_the_data_axis():
    """One crop on a 2-way data axis pads to 2 lanes, 3 crops to 4; a
    4-way axis takes at least 4."""
    prep = dict(crop_hw=(8, 6), nocs_target=np.ones((3, 8, 6), np.float32),
                params0=[torch.zeros(1), torch.zeros(3), torch.ones(1),
                         torch.ones(3)],
                intrinsics=np.eye(3, dtype=np.float32),
                frustum=np.zeros((4, 3), np.float32), fmask=np.ones(4, bool))
    for n_data, n_crops, lanes in ((2, 1, 2), (2, 3, 4), (4, 1, 4),
                                   (1, 3, 4)):
        rt = types.SimpleNamespace(
            cfg=types.SimpleNamespace(render_bucket=8), device="cpu",
            mesh=mesh_mod.Mesh({"data": n_data, "rays": 1}, 0, 0, 0))
        bucket, args = tpipe.batch_inputs(rt, [prep] * n_crops)
        assert bucket == (8, 8)
        assert args[1].shape[0] == lanes, (n_data, n_crops)
        assert args[5][:, :, 6:].sum() == 0  # the letterbox's pad
