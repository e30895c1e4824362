"""The rays axis on the card: two gloo ranks sharing the one card, the
rays render and one step of the sharded refine on the card against the
same on the CPU (the CPU tests hold the CPU side against JAX), and the
kernels, not their plain versions, on each rank's share: the splat pair
on its pixel block (the dense pair at 64x32 px and a 32x32 crop, the
bins, 1c and 1d at 128x96 px and a 96x96 crop, whose blocks of 4096 px
and more take the row-binned route), the NN kernel in its 3D loss, the
selection kernel on its grid block.

Tolerances: the image to the splat tolerance (>= 99.5% of pixels within
2e-4: a footprint bit may flip within rounding of the disc's edge), the
point gradients on >= 99% of points within 1e-3 of the largest, the pose
gradient (a sum over every pixel) within 1e-2 of its largest element;
the step's loss within 1e-3 relative and every parameter after it within
1e-3 + 1e-2 relative of the CPU's (the selection kernel ranks as its
plain version does; stage 2 is fp32 on both).

Every test needs an NVIDIA card and nvcc and skips elsewhere. On a machine
with the card and without JAX, run them as
  python -m pytest tests/test_torch_sharded_cuda.py --noconftest \\
      -o addopts="" -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from sdflabel_tpu_torch.ops import _cuda, splat_cuda
from sdflabel_tpu_torch.parallel import mesh as mesh_mod
from sdflabel_tpu_torch.renderer.rasterer import calibration_matrix
import torch_dp_worker as dpw
import torch_sharded_worker as worker

pytestmark = pytest.mark.cuda


# (render, refine crop) sizes: dense blocks (1024 px a rank for the render,
# 512 for the refine), then row-binned ones (6144 and 4608 px)
SIZES = {"dense": ((64, 32), (32, 32)), "binned": ((128, 96), (96, 96))}
# the kernels each rank must launch at each size
KERNELS = {"dense": ("splat_fwd", "splat_bwd", "nn", "select_mlp"),
           "binned": ("splat_bins", "splat_fwd_binned", "splat_bwd_binned",
                      "nn", "select_mlp")}


def _job(size):
    res, crop_hw = SIZES[size]
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (2048, 3)).astype(np.float32)
    normals = rng.randn(2048, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0, 0, 5]
    frustum = (rng.randn(2048, 3) * 0.4 + [0, 0, 8.0]).astype(np.float32)
    return dict(K=calibration_matrix(res), res=res, pts=pts,
                normals=normals, pose=pose, mask=rng.uniform(size=2048) > 0.2,
                spec=dict(latent_size=3, dims=(128,) * 8,
                          norm_layers=tuple(range(8)), latent_in=(4,),
                          weight_norm=True),
                cfg=dict(iters=1, surface_capacity=2048), density=24,
                crop_K=calibration_matrix(crop_hw), crop_hw=crop_hw,
                nocs=rng.rand(3, *crop_hw).astype(np.float32) * 0.5,
                frustum=frustum, fmask=np.ones(2048, bool),
                init=[[0.45], [0.05, -0.02, 4.05], [2.08], [0.6, 0.0, 0.8]])


@pytest.fixture(scope="module", params=sorted(SIZES))
def size(request):
    return request.param


@pytest.fixture(scope="module")
def ranks(size, tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _cuda.build_all()  # the ranks only load the built libraries
    out = str(tmp_path_factory.mktemp("card"))
    mesh_mod.spawn_ranks(worker.card_rank, 2, (out, _job(size)),
                         backend="gloo")
    return dpw.load(out, "card", 2)


def test_kernels_run_on_each_ranks_share(size, ranks):
    res, crop_hw = SIZES[size]
    binned = splat_cuda.bin_policy(res[0] * res[1] // 2) > 0
    assert binned == (splat_cuda.bin_policy(crop_hw[0] * crop_hw[1] // 2)
                      > 0) == (size == "binned")
    for r in ranks:
        launched = r["cuda"]["launches"]
        assert all(launched[k] > 0 for k in KERNELS[size]), launched
        assert not any(r["cpu"]["launches"].values())


def test_rays_render_on_the_card_matches_the_cpu(ranks):
    for r in ranks:
        card, cpu = r["cuda"], r["cpu"]
        err = np.abs(card["img"] - cpu["img"]).max(0)
        assert (err < 2e-4).mean() >= 0.995, err.max()
        assert (cpu["img"] > 0).mean() > 0.1
        scale = np.abs(cpu["g_pts"]).max()
        close = np.abs(card["g_pts"] - cpu["g_pts"]).max(-1) / scale < 1e-3
        assert close.mean() >= 0.99
        np.testing.assert_allclose(card["g_pose"], cpu["g_pose"], rtol=0,
                                   atol=1e-2 * np.abs(cpu["g_pose"]).max())
    # every rank holds the whole image and the whole gradient
    for k in ("img", "g_pose", "g_pts"):
        assert np.array_equal(ranks[0]["cuda"][k], ranks[1]["cuda"][k])


def test_sharded_step_on_the_card_matches_the_cpu(ranks):
    for r in ranks:
        card, cpu = r["cuda"], r["cpu"]
        assert np.isfinite(cpu["hist"]).all() and cpu["hist"][0] != 0
        np.testing.assert_allclose(card["hist"], cpu["hist"], rtol=1e-3)
        for a, b in zip(card["final"], cpu["final"]):
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-3)
    for a, b in zip(ranks[0]["cuda"]["final"], ranks[1]["cuda"]["final"]):
        assert np.array_equal(a, b)
