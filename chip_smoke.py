"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Six phases; any failure exits non-zero and no phase's error is caught.

1. Build the port's CUDA kernels from ``sdflabel_tpu_torch/csrc`` (one
   nvcc per source, started together) and print the card's name and
   power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time kernel, plain version and (where one
   exists) a PyTorch library call with CUDA events.
3. The demo driver: ``refine_css_demo`` on the bundled data/optimization
   assets with configs/config_demo.ini (viz off); the labels must land on
   the ground-truth annotation, the splat and NN kernels must have run,
   and no computation on the path may take CPU tensors.
4. Full width: phase 3's prepared crop refined under the stock
   configs/config_refine.ini settings (60 iterations, float16 -> bf16,
   warm band 8192 refreshed every 10, the selection kernel, grid 40)
   through the reference 8x512 DeepSDF architecture (latent_in 4,
   weight-norm, latent 3) with seeded random weights; then (4b) phase 3's
   crop prepared and refined at ``rendering_area = 96``, whose renders of
   >= 4096 pixels take the row-binned splat kernels, forward and
   backward.
5. Crops: ``make_crops`` renders 26 crops of 128x128 px (grid 40,
   capacity 4096) from data/quality_nets/deepsdf_quality.pt, each through
   the row-binned splat kernel.
6. Training: ``train_css`` trains the width-64 CSS network on those crops
   under configs/config_train.ini with fused_ce and direct_ce on, batch
   13, float32, from a seeded init, for 2 epochs (4 steps): every CE tower
   goes through the CE kernels, no CPU operator runs in the step, the
   written css.msgpack reloads to the same network, and 3 steps on one
   fixed batch lower its loss.

Each kernel's launches are counted on the path that runs it (set to 0
just before the path, read just after): the dense splat, NN and selection
kernels in phase 4, the binned backward in 4b, the binned forward in 5 and
the CE kernels in 6. The line before the last is a JSON ``kernels``
record; the last line is ``{"ok": true, "device": {...}}``. Without a card
the script exits 2 and prints no result. ``--profile DIR`` adds one more
full-width crop and two train steps under torch.profiler: device time by
kernel group, the device's busy share of the wall time, and
DIR/profile.json and DIR/profile_train.json with every kernel; then the
train step timed with cuDNN's autotuner on. ``--rehearse-cpu`` runs phases 3 to 6 on the CPU at a tiny size
with the kernels' plain versions, then exits 3 without a result: a dry
run of the control flow for machines without a card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from sdflabel_tpu_torch import config as cfg_mod  # noqa: E402
from sdflabel_tpu_torch.data import crops as crops_data  # noqa: E402
from sdflabel_tpu_torch.engine import css_train  # noqa: E402
from sdflabel_tpu_torch.engine import refine as refine_mod  # noqa: E402
from sdflabel_tpu_torch.models import css as css_mod  # noqa: E402
from sdflabel_tpu_torch.models import deepsdf  # noqa: E402
from sdflabel_tpu_torch.ops import (  # noqa: E402
    _cuda, ce_cuda, grid as grid_ops, knn, mlp_cuda, nn_cuda, splat,
    splat_cuda)
from sdflabel_tpu_torch.pipelines import make_crops as crops_pipe  # noqa: E402
from sdflabel_tpu_torch.pipelines import refine_css as pipe  # noqa: E402
from sdflabel_tpu_torch.pipelines import train_css as train_pipe  # noqa: E402
from sdflabel_tpu_torch.renderer import rasterer  # noqa: E402
from sdflabel_tpu_torch.utils import png  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores
BF16_TENSOR_FLOPS = 989e12

KERNELS = {  # wrapper counter, source, the TPU kernel it replaces
    "splat_fwd": (splat_cuda.SPLAT_FWD, "sdflabel_tpu_torch/csrc/splat.cu",
                  "sdflabel_tpu/ops/splat_pallas.py:436"),
    "splat_bwd": (splat_cuda.SPLAT_BWD, "sdflabel_tpu_torch/csrc/splat.cu",
                  "sdflabel_tpu/ops/splat_pallas.py:561"),
    "nn": (nn_cuda.NN_FWD, "sdflabel_tpu_torch/csrc/nn.cu",
           "sdflabel_tpu/ops/nn_pallas.py:77"),
    "select_mlp": (mlp_cuda.SELECT_MLP, "sdflabel_tpu_torch/csrc/select_mlp.cu",
                   "sdflabel_tpu/ops/mlp_pallas.py:200"),
    "splat_fwd_binned": (splat_cuda.SPLAT_FWD_BINNED,
                         "sdflabel_tpu_torch/csrc/splat.cu",
                         "sdflabel_tpu/ops/splat_pallas.py:467"),
    "splat_bwd_binned": (splat_cuda.SPLAT_BWD_BINNED,
                         "sdflabel_tpu_torch/csrc/splat.cu",
                         "sdflabel_tpu/ops/splat_pallas.py:589"),
    "ce_fwd": (ce_cuda.CE_FWD, "sdflabel_tpu_torch/csrc/ce.cu",
               "sdflabel_tpu/ops/ce_pallas.py:54"),
    "ce_bwd": (ce_cuda.CE_BWD, "sdflabel_tpu_torch/csrc/ce.cu",
               "sdflabel_tpu/ops/ce_pallas.py:79"),
}
# the path whose run gives each kernel's launches
PATHS = {"splat_fwd": "full_width", "splat_bwd": "full_width",
         "nn": "full_width", "select_mlp": "full_width",
         "splat_bwd_binned": "binned_refine", "splat_fwd_binned": "crops",
         "ce_fwd": "train", "ce_bwd": "train"}
QUALITY_DSDF = os.path.join(ROOT, "data", "quality_nets",
                            "deepsdf_quality.pt")


def reset_counts():
    for counter, _, _ in KERNELS.values():
        counter.launches = 0


def counts() -> dict:
    return {name: k[0].launches for name, k in KERNELS.items()}


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of `reps` single-call CUDA-event times (L2 stays warm, as
    it does between the refine loop's calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, peak_flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decoder_8x512(device):
    """The reference DeepSDF architecture (bench.py:109-120), seeded."""
    cfg = deepsdf.DeepSDFConfig(latent_size=3, dims=(512,) * 8,
                                norm_layers=tuple(range(8)), latent_in=(4,),
                                weight_norm=True)
    params = deepsdf.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=device)
    return cfg, params


# ---------------------------------------------------------------- phase 2

def splat_agreement(name, img_k, img_p, grads_k, grads_p):
    """Tolerance of a splat kernel against its plain version: a footprint
    bit may flip at the disc boundary between the kernel's expanded
    distance and the plain version's explicit one, so >= 99.5% of pixels
    within 2e-4 and >= 99% of points' gradient rows within 1e-3 of the
    largest gradient. Returns the forward and backward max_abs_err."""
    px_err = (img_k - img_p).detach().abs().max(-1).values
    px_ok = float((px_err < 2e-4).float().mean())
    row_ok = []
    for a, b in zip(grads_k, grads_p):
        scale = b.abs().max().clamp(min=1e-6)
        row_ok.append(float(((a - b).abs().max(-1).values / scale < 1e-3)
                            .float().mean()))
    fwd_err = float(px_err.max())
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(grads_k,
                                                              grads_p))
    print(f"{name} fwd: max_abs_err {fwd_err:.3g}, pixels within 2e-4: "
          f"{px_ok:.4f} (need >= 0.995)")
    print(f"{name} bwd: max_abs_err {bwd_err:.3g}, gradient rows within "
          f"1e-3 relative: {[round(r, 4) for r in row_ok]} (need >= 0.99)")
    assert px_ok >= 0.995 and min(row_ok) >= 0.99
    return fwd_err, bwd_err


def check_splat(dev) -> list[dict]:
    """N = 8192 surfels (the stock surface capacity, 40% masked out as the
    band mask does) onto a 32x32 crop."""
    n, res = 8192, (32, 32)
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    nrm = rng.randn(n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    feats = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.4
    pts, nrm, feats, mask = (torch.as_tensor(a, device=dev)
                             for a in (pts, nrm, feats, mask))
    K = torch.as_tensor(rasterer.calibration_matrix(res), device=dev)
    kg = splat.kinv_pixel_rays(K, splat.pixel_grid(*res, device=dev))
    p = kg.shape[0]

    args_k = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_k = splat_cuda.surfel_composite(*args_k, kg, mask)
    g = torch.randn_like(img_k)
    grads_k = torch.autograd.grad(img_k, args_k, g)
    args_p = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_p = splat.surfel_composite_dense(*args_p, kg, mask)
    grads_p = torch.autograd.grad(img_p, args_p, g, retain_graph=True)
    torch.cuda.synchronize()
    fwd_err, bwd_err = splat_agreement("splat", img_k, img_p, grads_k,
                                       grads_p)

    # work this data needs: ray-plane geometry for every (point, pixel)
    # pair (~18 flops), plus per footprint pair the z-norm and softmax /
    # feature composite (~27) forward, the chain rule (~51) backward
    with torch.no_grad():
        fp_pairs = float((splat.surfel_prob(kg, pts, nrm, mask, 0.04) > 0)
                         .sum())
    io_bytes = 4 * (n * 16 + p * 4 + p * 11)
    fwd_bound = bound(io_bytes, 18 * n * p + 27 * fp_pairs, FP32_FLOPS)
    bwd_bound = bound(io_bytes + 4 * (p * 12 + n * 14),
                      18 * n * p + 51 * fp_pairs, FP32_FLOPS)

    # the kernels' own packed inputs, as the autograd Function builds them
    pk = torch.cat([pts, nrm, mask.float()[:, None],
                    torch.zeros(n, 1, device=dev)], 1).contiguous()
    kg4 = splat_cuda._pack_rays(kg)
    img, m, d, zn = splat_cuda._fwd(pk, feats, kg4, 0.04, 150.0)
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[:, None], d[:, None], zn[:, None], corr, g],
                    1).contiguous()
    fwd_ms = time_ms(lambda: splat_cuda._fwd(pk, feats, kg4, 0.04,
                                             150.0))
    bwd_ms = time_ms(lambda: splat_cuda._bwd(pk, feats, pix, 0.04,
                                             150.0))
    with torch.no_grad():
        fwd_plain = time_ms(lambda: splat.surfel_composite_dense(
            pts, nrm, feats, kg, mask))
    bwd_plain = time_ms(lambda: torch.autograd.grad(
        img_p, args_p, g, retain_graph=True))
    return [
        dict(name="splat_fwd", max_abs_err=fwd_err, ms=fwd_ms,
             plain_ms=fwd_plain, bound_ms=fwd_bound[0],
             bound_by=fwd_bound[1], library_ms=None),
        dict(name="splat_bwd", max_abs_err=bwd_err, ms=bwd_ms,
             plain_ms=bwd_plain, bound_ms=bwd_bound[0],
             bound_by=bwd_bound[1], library_ms=None),
    ]


def check_nn(dev) -> dict:
    """8192 queries x 8192 data (the frustum capacity), a partial mask, and
    coordinates on a 0.25 lattice so that exact distance ties abound."""
    n = m = 8192
    rng = np.random.RandomState(1)
    q = rng.randint(-8, 9, (n, 3)).astype(np.float32) * 0.25
    d = rng.randint(-8, 9, (m, 3)).astype(np.float32) * 0.25
    mask = rng.uniform(size=m) > 0.3
    q, d, mask = (torch.as_tensor(a, device=dev) for a in (q, d, mask))
    dk, ik = nn_cuda.nearest_neighbor_fused(q, d, mask)
    dp, ip = knn.nearest_neighbor_plain(q, d, mask)
    torch.cuda.synchronize()
    # tolerance: none; the index and the squared distance are equal
    err = float((dk - dp).abs().max())
    same_idx = bool(torch.equal(ik, ip))
    print(f"nn: max_abs_err {err} (need 0), indices equal: {same_idx}")
    assert err == 0.0 and same_idx
    b = bound(4 * (3 * n + 4 * m + 2 * n), 9 * n * m, FP32_FLOPS)
    return dict(name="nn", max_abs_err=err,
                ms=time_ms(lambda: nn_cuda.nearest_neighbor_fused(q, d,
                                                                  mask)),
                plain_ms=time_ms(lambda: knn.nearest_neighbor_plain(q, d,
                                                                    mask)),
                bound_ms=b[0], bound_by=b[1], library_ms=None)


def check_select(dev) -> dict:
    """The 64000-point grid-40 selection decode through the 8x512
    decoder, packed after the float16 -> bf16 cast."""
    cfg, params = decoder_8x512(dev)
    packed = mlp_cuda.pack_select_mlp(
        cfg, deepsdf.cast_params(params, torch.bfloat16))
    assert packed is not None
    pts = grid_ops.generate_point_grid(40, device=dev)
    lat = torch.tensor([0.6, -0.48, 0.64], device=dev)
    out_k = mlp_cuda.select_mlp_apply(packed, lat, pts)
    out_p = mlp_cuda.emulate_select_mlp(packed, lat, pts)
    torch.cuda.synchronize()
    # tolerance: the same bf16 operands, fp32 sums in another order; a
    # last-ulp difference can flip one activation's bf16 rounding
    err = (out_k - out_p).abs()
    print(f"select_mlp: max_abs_err {float(err.max()):.3g} (need < 1e-3), "
          f"median {float(err.median()):.3g} (need < 1e-5)")
    assert float(err.max()) < 1e-3 and float(err.median()) < 1e-5
    n, H, nh = pts.shape[0], packed.width, packed.n_hidden
    b = bound(n * 12 + nh * H * H * 2 + n * 4, 2 * n * nh * H * H,
              BF16_TENSOR_FLOPS)
    # yardstick: the same hidden-layer products as a torch.matmul chain
    h0 = torch.relu(torch.randn(n, H, device=dev)).to(torch.bfloat16)

    def chain():
        h = h0
        for j in range(nh):
            h = torch.relu(h @ packed.ws[j])
        return h

    return dict(name="select_mlp", max_abs_err=float(err.max()),
                ms=time_ms(lambda: mlp_cuda.select_mlp_apply(packed, lat,
                                                             pts)),
                plain_ms=time_ms(lambda: mlp_cuda.emulate_select_mlp(
                    packed, lat, pts)),
                bound_ms=b[0], bound_by=b[1], library_ms=time_ms(chain))


def crop_scene(dev):
    """What one make_crops render composites: the quality DeepSDF's
    surface (grid 40, capacity 4096) posed into a 128x128 crop. Returns
    (points, normals, features, point mask, pixel rays)."""
    cfg, params = deepsdf.load_torch_checkpoint(QUALITY_DSDF, device=dev)
    lat = crops_pipe.sample_unit_latents(1, cfg.latent_size,
                                         np.random.RandomState(3))[0]
    yaw, trans, K = crops_pipe._sample_view(np.random.RandomState(4), 128)
    with torch.no_grad():
        surf, _ = grid_ops.surface_from_decoder(
            deepsdf.sdf_fn(cfg, params), torch.as_tensor(lat, device=dev),
            grid_ops.generate_point_grid(40, device=dev), capacity=4096)
        pose = refine_mod.build_render_pose(
            torch.tensor([yaw], dtype=torch.float32, device=dev),
            torch.as_tensor(trans, device=dev))
        proj, feats, kg = rasterer.splat_inputs(
            torch.as_tensor(K, device=dev), (128, 128), surf.points,
            surf.normals, surf.normals, pose, rot="dcm", output_nocs=True)
    return proj.points_3d, proj.normals_3d, feats, surf.mask, kg


def check_splat_binned(dev) -> list[dict]:
    """The row-binned kernels on a make_crops render (16384 px, 4096
    surfels) against the windowed plain version, with the dense kernel's
    tolerance."""
    v, nrm, feats, mask, kg = crop_scene(dev)
    n, p = v.shape[0], kg.shape[0]
    bin_px = splat_cuda.bin_policy(p)
    assert bin_px == 512, bin_px
    args_k = [t.clone().requires_grad_(True) for t in (v, nrm, feats)]
    img_k = splat_cuda.surfel_composite(*args_k, kg, mask)
    g = torch.randn(img_k.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    grads_k = torch.autograd.grad(img_k, args_k, g)
    args_p = [t.clone().requires_grad_(True) for t in (v, nrm, feats)]
    img_p = splat_cuda.surfel_composite_windowed(*args_p, kg, mask,
                                                 bin_px=bin_px)
    grads_p = torch.autograd.grad(img_p, args_p, g, retain_graph=True)
    torch.cuda.synchronize()
    fwd_err, bwd_err = splat_agreement("splat binned", img_k, img_p,
                                       grads_k, grads_p)

    # the kernels' own inputs, as the autograd Function builds them
    pk = splat_cuda._pack_points(v, nrm, mask)
    kg4 = splat_cuda._pack_rays(kg)

    def binned_inputs():
        bins = splat_cuda.compute_bins(pk, kg4, 0.04, bin_px)
        win = torch.stack([bins.start, bins.start + bins.count],
                          1).to(torch.int32).contiguous()
        return (bins, pk[bins.order].contiguous(),
                feats[bins.order].contiguous(), win)

    bins, pks, fs, win = binned_inputs()
    img, m, d, zn = splat_cuda._fwd_binned(pks, fs, kg4, win, bin_px, 0.04,
                                           150.0)
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[:, None], d[:, None], zn[:, None], corr, g],
                    1).contiguous()
    key, smax = bins.key.to(torch.int32), bins.smax.reshape(1).to(torch.int32)
    fwd_ms = time_ms(lambda: splat_cuda._fwd_binned(pks, fs, kg4, win, bin_px,
                                                    0.04, 150.0))
    bwd_ms = time_ms(lambda: splat_cuda._bwd_binned(pks, fs, pix, key, smax,
                                                    bin_px, 0.04, 150.0))
    bins_ms = time_ms(binned_inputs)
    with torch.no_grad():
        fwd_plain = time_ms(lambda: splat_cuda.surfel_composite_windowed(
            v, nrm, feats, kg, mask, bin_px=bin_px))
    bwd_plain = time_ms(lambda: torch.autograd.grad(
        img_p, args_p, g, retain_graph=True))

    # work this data needs: ray-plane geometry (~18 flops) for every pair
    # the bins leave, plus per footprint pair ~27 flops forward and ~51
    # backward (as the dense rows count them)
    rows_in = torch.tensor([min(bin_px, p - b * bin_px)
                            for b in range(bins.count.shape[0])], device=dev)
    pairs = float((bins.count * rows_in).sum())
    with torch.no_grad():
        fp_pairs = float((splat.surfel_prob(kg, v, nrm, mask, 0.04) > 0)
                         .sum())
    nb = bins.count.shape[0]
    io_bytes = 4 * (n * 16 + p * 4 + p * 11 + 2 * nb)
    fwd_bound = bound(io_bytes, 18 * pairs + 27 * fp_pairs, FP32_FLOPS)
    bwd_bound = bound(io_bytes + 4 * (p * 12 + n * 14), 18 * pairs
                      + 51 * fp_pairs, FP32_FLOPS)
    print(f"splat binned: {n} points x {p} px, {pairs:.0f} pairs in the "
          f"windows ({pairs / (n * p):.3f} of all), {fp_pairs:.0f} "
          f"footprint pairs; bins + sort {bins_ms:.4f} ms")
    return [
        dict(name="splat_fwd_binned", max_abs_err=fwd_err, ms=fwd_ms,
             plain_ms=fwd_plain, bound_ms=fwd_bound[0],
             bound_by=fwd_bound[1], library_ms=None, bins_ms=bins_ms),
        dict(name="splat_bwd_binned", max_abs_err=bwd_err, ms=bwd_ms,
             plain_ms=bwd_plain, bound_ms=bwd_bound[0],
             bound_by=bwd_bound[1], library_ms=None),
    ]


def check_ce(dev) -> list[dict]:
    """The CE kernels on the train step's towers: (13, 256, 128, 128)
    logits for u, v and w, (13, 2, 128, 128) for the mask, with an upstream
    cotangent of 2.5. The rows give the 256-class numbers."""
    F = torch.nn.functional
    rows = {}
    for c in (256, 2):
        gen = torch.Generator(device=dev).manual_seed(c)
        x = torch.randn(13, c, 128, 128, device=dev, generator=gen) * 3
        t = torch.randint(0, c, (13, 128, 128), device=dev, generator=gen)
        cot = torch.tensor(2.5, device=dev)
        xk = x.clone().requires_grad_(True)
        lk = ce_cuda.fused_cross_entropy(xk, t)
        (gk,) = torch.autograd.grad(lk, xk, cot)
        xp = x.clone().requires_grad_(True)
        lp = ce_cuda.cross_entropy_with_internal_softmax(xp, t)
        (gp,) = torch.autograd.grad(lp, xp, cot, retain_graph=True)
        torch.cuda.synchronize()
        # tolerance: fp32 sums in other orders; the loss to 1e-5 relative,
        # each gradient element to 1e-5 relative plus 1e-6 of the largest
        loss_err = abs(float(lk.detach()) - float(lp.detach()))
        g_err = float((gk - gp).abs().max())
        g_ok = bool(torch.allclose(gk, gp, rtol=1e-5,
                                   atol=1e-6 * float(gp.abs().max())))
        print(f"ce C={c}: loss {float(lk.detach()):.6f}, max_abs_err loss "
              f"{loss_err:.3g} (need <= 1e-5 relative), gradient "
              f"{g_err:.3g}, within tolerance: {g_ok}")
        assert loss_err <= 1e-5 * abs(float(lp.detach())) and g_ok

        b, hw = 13, 128 * 128
        xc = x.reshape(b, c, hw).contiguous()
        tc = t.reshape(b, hw).to(torch.int32).contiguous()
        scale = (cot / (b * hw)).reshape(1).contiguous()
        xl = x.clone().requires_grad_(True)
        with torch.no_grad():
            plain_fwd = time_ms(
                lambda: ce_cuda.cross_entropy_with_internal_softmax(x, t))
            lib_fwd = time_ms(lambda: F.cross_entropy(x, t))
        logit_bytes, t_bytes = 4 * b * c * hw, 4 * b * hw
        fwd_b = bound(logit_bytes + t_bytes, 6 * b * c * hw, FP32_FLOPS)
        bwd_b = bound(2 * logit_bytes + t_bytes, 10 * b * c * hw, FP32_FLOPS)
        rows[c] = [
            dict(name="ce_fwd", max_abs_err=loss_err,
                 ms=time_ms(lambda: ce_cuda._fwd(xc, tc)),
                 plain_ms=plain_fwd, bound_ms=fwd_b[0], bound_by=fwd_b[1],
                 library_ms=lib_fwd),
            dict(name="ce_bwd", max_abs_err=g_err,
                 ms=time_ms(lambda: ce_cuda._bwd(xc, tc, scale)),
                 plain_ms=time_ms(lambda: torch.autograd.grad(
                     lp, xp, cot, retain_graph=True)),
                 bound_ms=bwd_b[0], bound_by=bwd_b[1],
                 # yardstick: F.cross_entropy forward and backward together
                 library_ms=time_ms(lambda: torch.autograd.grad(
                     F.cross_entropy(xl, t), xl, cot))),
        ]
        for r in rows[c]:
            print(f"ce C={c} {r['name']}: {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, F.cross_entropy "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
        del x, xk, xp, xl, gk, gp, lp, xc
    for r256, r2 in zip(rows[256], rows[2]):
        r256["max_abs_err"] = max(r256["max_abs_err"], r2["max_abs_err"])
        r256["c2"] = {k: r2[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "library_ms")}
    return rows[256]


# ---------------------------------------------------------------- phase 3

_TRANSFERS = {"aten.lift_fresh", "aten.lift_fresh_copy", "aten._to_copy",
              "aten.copy_", "aten.detach", "aten._local_scalar_dense",
              "aten.alias"}


def _cpu_op_watch():
    """A dispatch mode that counts operators other than host<->device
    transfers that take or give a CPU tensor of more than one element."""
    from torch.utils import _pytree as pytree
    from torch.utils._python_dispatch import TorchDispatchMode

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.cpu_ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func).rsplit(".", 1)[0]
            if name not in _TRANSFERS and any(
                    isinstance(t, torch.Tensor) and t.device.type == "cpu"
                    and t.numel() > 1
                    for t in pytree.tree_leaves((args, kwargs, out))):
                self.cpu_ops[name] += 1
            return out

    return Watch()


def demo_phase(dev, iters: int | None = None):
    cfg = cfg_mod.RefineCfg.from_ini(cfg_mod.load_ini(
        os.path.join(ROOT, "configs", "config_demo.ini")))
    cfg = dataclasses.replace(cfg, viz_type="none",
                              **({"iters": iters} if iters else {}))
    rt = pipe.setup_runtime(cfg, device=dev)
    sample = pipe.load_demo_sample(os.path.join(ROOT, "data",
                                                "optimization"))
    # a first run warms caches and lazy imports; the second is measured
    pipe.refine_css_demo(cfg, sample=sample, device=dev, rt=rt)
    rt.reset_rng(1)
    watch = _cpu_op_watch()
    reset_counts()
    t0 = time.perf_counter()
    with watch:
        annos, ests = pipe.refine_css_demo(cfg, sample=sample, device=dev,
                                           rt=rt)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    print(f"demo: {cfg.iters} iterations, {wall:.3f} s wall, launches "
          f"{launched}")
    for k in ("location", "dimensions", "rotation_y", "alpha"):
        print(f"demo label {k}: est {np.asarray(ests[k]).tolist()} "
              f"gt {np.asarray(annos[k]).tolist()}")
    assert len(ests["location"]) == len(annos["location"]) == 1
    loc_err = float(np.linalg.norm(np.asarray(ests["location"][0], float)
                                   - np.asarray(annos["location"][0], float)))
    dyaw = abs(float(ests["rotation_y"][0]) - float(annos["rotation_y"][0]))
    dyaw = min(dyaw, abs(dyaw - 2 * np.pi))
    print(f"demo: location error {loc_err:.4f} m, yaw error {dyaw:.4f} rad")
    if iters is None:  # the full 60 iterations land on the annotation
        assert loc_err < 0.1 and dyaw < 0.05
    if dev.type == "cuda":
        print(f"demo: CPU operators on the path: {dict(watch.cpu_ops)}")
        assert not watch.cpu_ops
        assert launched["splat_fwd"] == launched["splat_bwd"] == cfg.iters
        assert launched["nn"] >= cfg.iters
        assert launched["splat_fwd_binned"] == launched["splat_bwd_binned"] \
            == 0
    anno =pipe.kitti_mod.get_annos(cfg.diff_annos, sample)[0]
    rt.reset_rng(1)
    t0 = time.perf_counter()
    prep = pipe.prepare_crop(rt, sample, anno)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    assert prep is not None
    print(f"demo: prepare_crop (crop, CSS, surface, RANSAC) {prep_s:.3f} s")
    return rt, sample, prep, dict(wall_s=wall, iters=cfg.iters,
                                  prepare_crop_s=prep_s)


# ---------------------------------------------------------------- phase 4

def full_width_phase(dev, rt_demo, sample, prep, iters: int | None = None):
    stock = cfg_mod.RefineCfg.from_ini(cfg_mod.load_ini(
        os.path.join(ROOT, "configs", "config_refine.ini")))
    if iters:
        stock = dataclasses.replace(stock, iters=iters)
    assert (stock.precision, stock.warm_band, stock.warm_refresh,
            stock.select_pallas, stock.grid_density) == (
                "float16", 8192, 10, True, 40)
    cfg512, params512 = decoder_8x512(dev)
    rt = pipe.RefineRuntime(stock, rt_demo.css, cfg512, params512,
                            device=dev)
    assert rt.select_decoder is not None and rt.warm_band == 8192
    reset_counts()
    t0 = time.perf_counter()
    final, hist, ext = rt.run_refine(prep)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    label = pipe.finish_label(final, ext, sample, prep["anno"])
    applied = hist.applied.cpu().numpy()
    loss = hist.loss.cpu().numpy()
    print(f"full width: {stock.iters} iterations, {wall:.3f} s wall, "
          f"{wall / stock.iters * 1e3:.3f} ms/iteration, applied "
          f"{int(applied.sum())}/{len(applied)}, loss {loss[0]:.5f} -> "
          f"{loss[-1]:.5f}, launches {launched}")
    assert np.isfinite(loss[applied]).all()
    assert all(torch.isfinite(t).all() for t in final)
    assert label is not None and np.isfinite(label["location"]).all()
    print(f"full width label: location {np.asarray(label['location'])}, "
          f"dimensions {label['dimensions']}")
    if dev.type == "cuda":
        refreshes = -(-stock.iters // stock.warm_refresh)
        assert launched["select_mlp"] == refreshes
        assert launched["splat_fwd"] == launched["splat_bwd"] == stock.iters
        assert launched["nn"] >= stock.iters
        # 32x32 crops stay on the dense kernels
        assert launched["splat_fwd_binned"] == launched["splat_bwd_binned"] \
            == 0
    return rt, launched, dict(wall_s=wall, iters=stock.iters)


def binned_refine_phase(dev, rt_demo, sample, anno, iters: int = 10):
    """Phase 3's crop prepared and refined at rendering_area = 96: it
    renders at about 96 x 96 pixels, so every iteration's splat takes the
    row-binned kernels, forward and backward."""
    cfg = dataclasses.replace(rt_demo.cfg, rendering_area=96, iters=iters)
    rt = pipe.RefineRuntime(cfg, rt_demo.css, rt_demo.dsdf_cfg,
                            rt_demo.dsdf_params, device=dev)
    prep = pipe.prepare_crop(rt, sample, anno)
    assert prep is not None
    h, w = prep["crop_hw"]
    assert splat_cuda.bin_policy(h * w) == 512, (h, w)
    reset_counts()
    t0 = time.perf_counter()
    final, hist, _ = rt.run_refine(prep)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    loss = hist.loss.cpu().numpy()
    applied = hist.applied.cpu().numpy()
    print(f"binned refine: {h}x{w} px, {iters} iterations, {wall:.3f} s "
          f"wall, {wall / iters * 1e3:.3f} ms/iteration, loss "
          f"{loss[0]:.5f} -> {loss[-1]:.5f}, launches {launched}")
    assert np.isfinite(loss[applied]).all()
    assert all(torch.isfinite(t).all() for t in final)
    if dev.type == "cuda":
        assert launched["splat_fwd_binned"] == launched["splat_bwd_binned"] \
            == iters
        assert launched["splat_fwd"] == launched["splat_bwd"] == 0
    return launched, dict(wall_s=wall, iters=iters, px=h * w)


# ---------------------------------------------------------------- phase 5

def crops_phase(dev, out_dir, n_crops: int = 26, grid: int = 40,
                capacity: int = 4096):
    """make_crops from the quality DeepSDF: 128x128 crops, one binned
    splat forward each."""
    cfg, params = deepsdf.load_torch_checkpoint(QUALITY_DSDF, device=dev)
    decoder = deepsdf.sdf_fn(cfg, params)
    latents = crops_pipe.sample_unit_latents(16, cfg.latent_size,
                                             np.random.RandomState(1))
    kw = dict(crop_px=128, grid_density=grid, capacity=capacity, device=dev)
    # one crop first, elsewhere, so that lazy set-up is not timed
    crops_pipe.make_crops(os.path.join(out_dir, "warmup"), decoder, latents,
                          1, seed=99, **kw)
    crops_dir = os.path.join(out_dir, "crops")
    reset_counts()
    t0 = time.perf_counter()
    db = crops_pipe.make_crops(crops_dir, decoder, latents, n_crops, seed=0,
                               **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    assert sorted(db, key=int) == [str(i) for i in range(n_crops)]
    on_object = [int((png.read(os.path.join(crops_dir, f"{i:05d}_uvw.png"))
                      .astype(np.int32).sum(-1) > 0).sum())
                 for i in range(n_crops)]
    print(f"crops: {n_crops} crops of 128x128 px in {wall:.3f} s, "
          f"{wall / n_crops * 1e3:.3f} ms/crop, mask pixels min "
          f"{min(on_object)} max {max(on_object)}, launches {launched}")
    assert min(on_object) > 0
    if dev.type == "cuda":
        assert launched["splat_fwd_binned"] == n_crops
        assert launched["splat_fwd"] == launched["splat_bwd_binned"] == 0
    return crops_dir, launched, dict(wall_s=wall, crops=n_crops,
                                     ms_per_crop=wall / n_crops * 1e3)


# ---------------------------------------------------------------- phase 6

def train_phase(dev, crops_dir, log_dir, width: int = 64, batch: int = 13,
                epochs: int = 2):
    """train_css on the phase-5 crops with the CE kernels on every tower."""
    cfgp = train_pipe.make_config(crops_dir, log_dir, fused_ce=True,
                                  direct_ce=True, batch_size=batch,
                                  precision="float32", plot=False)
    cfg = cfg_mod.TrainCfg.from_ini(cfgp)
    assert (cfg.fused_ce, cfg.direct_ce, cfg.precision, cfg.batch_size,
            cfg.plot, cfg.css_path) == (True, True, "float32", batch, False,
                                        "")
    watch = _cpu_op_watch()
    steps = []

    def timed(step_fn):
        # the watch costs Python time per operator: it sees the first two
        # steps, the later ones are timed without it
        def step(state, b):
            t0 = time.perf_counter()
            if len(steps) < 2:
                with watch:
                    metrics = step_fn(state, b)
            else:
                metrics = step_fn(state, b)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0,
                          {k: float(v) for k, v in metrics.items()}))
            return metrics
        return step

    reset_counts()
    t0 = time.perf_counter()
    state = train_pipe.train_css(cfgp, max_epochs=epochs, device=dev,
                                 width=width, step_wrapper=timed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    n_crops = len(crops_data.Crops(crops_dir).gt)
    assert len(steps) == epochs * -(-n_crops // batch), len(steps)
    losses = [m["loss"] for _, m in steps]
    step_ms = [s * 1e3 for s, _ in steps]
    steady = statistics.median(step_ms[2:] or step_ms)
    print(f"train: {len(steps)} steps of batch {batch} at width {width}, "
          f"{wall:.3f} s wall (data, steps, checkpoints), step ms "
          f"{[round(t, 3) for t in step_ms]} (the first two watched), "
          f"steady {steady:.3f} ms/step = "
          f"{batch / steady * 1e3:.1f} images/s, losses "
          f"{[round(x, 5) for x in losses]}, launches {launched}")
    assert np.isfinite(losses).all()
    if dev.type == "cuda":
        print(f"train: CPU operators in the step: {dict(watch.cpu_ops)}")
        assert not watch.cpu_ops
        # u, v, w and mask: one forward and one backward each per step
        assert launched["ce_fwd"] == launched["ce_bwd"] == 4 * len(steps)

    # the exported network reloads to the same one
    model = state.model.eval()
    again = css_mod.load_css(os.path.join(log_dir, "net", "css.msgpack"),
                             width, model.latent_size, dev)
    want, got = model.state_dict(), again.state_dict()
    assert want.keys() == got.keys()
    assert all(torch.equal(want[k], got[k]) for k in want)
    ds = crops_data.Crops(crops_dir, augment=False, stage="uint8")
    fixed = ds.to_device(crops_data.collate([ds[i] for i in range(batch)]),
                         dev)
    with torch.no_grad():
        x = crops_data.normalize_rgb(fixed["rgb"])
        out_a, out_b = model(x), again(x)
    reload_err = max(float((out_a[k] - out_b[k]).abs().max())
                     for k in out_a)
    print(f"train: css.msgpack reloaded, outputs max_abs_err {reload_err}")
    assert reload_err <= 1e-5

    # three steps on one fixed batch lower its loss
    model.train()
    step = css_train.make_train_step(fused_ce=True, direct_ce=True)
    fixed_losses, fixed_ms = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        fixed_losses.append(float(step(state, fixed)["loss"]))
        fixed_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"train: one fixed batch, losses before each of 4 steps "
          f"{[round(x, 5) for x in fixed_losses]}, step ms "
          f"{[round(t, 3) for t in fixed_ms]}")
    assert fixed_losses[3] < fixed_losses[0]
    return state, fixed, launched, dict(
        wall_s=wall, steps=len(steps), batch=batch, width=width,
        step_ms=step_ms, steady_ms_per_step=steady,
        images_per_s=batch / steady * 1e3, losses=losses,
        fixed_batch_step_ms=fixed_ms)


# ------------------------------------------------------- --profile (option)

def _kernel_group(name: str) -> str:
    for key, group in (("splat_fwd_kernel", "splat_fwd"),
                       ("splat_bwd_kernel", "splat_bwd"),
                       ("nn_kernel", "nn"), ("select_mlp_kernel", "select_mlp"),
                       ("ce_fwd_kernel", "ce_fwd"), ("ce_bwd_kernel", "ce_bwd"),
                       ("fprop", "convolution"), ("dgrad", "convolution"),
                       ("wgrad", "convolution"), ("conv", "convolution"),
                       ("cudnn", "convolution"),
                       ("gemm", "matmul"), ("xmma", "matmul"),
                       ("cutlass", "matmul"), ("nvjet", "matmul"),
                       ("index", "indexing"), ("topk", "top-k"),
                       ("sort", "top-k"), ("radix", "top-k"),
                       ("reduce", "reductions"), ("Memcpy", "copies"),
                       ("Memset", "copies"), ("lementwise", "elementwise"),
                       ("vectorized", "elementwise")):
        if key in name:
            return group
    return "other"


def profile_phase(label: str, run, wall_unprofiled: float, units: int,
                  unit: str, path: str) -> None:
    """`run` once more under torch.profiler: device time by kernel group,
    and the device's busy share of its wall time, with and without the
    profiler (kernels on one stream do not overlap, so their sum is the
    busy time; user annotations such as Optimizer.step span kernels and
    are left out of it). Writes every kernel to `path`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [dict(name=e.key, count=e.count,
                    ms=e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    busy = sum(k["ms"] for k in kernels)
    launches = sum(k["count"] for k in kernels)
    groups = collections.defaultdict(lambda: [0, 0.0])
    for k in kernels:
        g = groups[_kernel_group(k["name"])]
        g[0] += k["count"]
        g[1] += k["ms"]
    print(f"profile: {label} {wall * 1e3:.3f} ms wall under the "
          f"profiler ({wall_unprofiled * 1e3:.3f} ms without), device busy "
          f"{busy:.3f} ms ({busy / wall / 10:.1f}% of the one, "
          f"{busy / wall_unprofiled / 10:.1f}% of the other), {launches} "
          f"device launches ({launches / units:.1f} per {unit})")
    for name, (count, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"profile: {label}: {name:12s} {count:6d} launches "
              f"{ms:9.3f} ms ({100 * ms / busy:.1f}% of busy)")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"card": gpu_line(), "label": label, "wall_ms": wall * 1e3,
                   "wall_unprofiled_ms": wall_unprofiled * 1e3,
                   "busy_ms": busy, unit + "s": units,
                   "kernels": sorted(kernels, key=lambda k: -k["ms"])}, f,
                  indent=1)


def profile_all(out_dir: str, rt512, prep, state, fixed, summary) -> None:
    """--profile: the full-width crop and two train steps on one fixed
    batch under the profiler; then the same steps timed with cuDNN's
    autotuner on (set for this measurement only; the port leaves it off)."""
    profile_phase("full-width crop", lambda: rt512.run_refine(prep),
                  summary["full_width_crop"]["wall_s"], rt512.cfg.iters,
                  "iteration", os.path.join(out_dir, "profile.json"))
    step = css_train.make_train_step(fused_ce=True, direct_ce=True)

    def two_steps():
        for _ in range(2):
            step(state, fixed)

    profile_phase("train, 2 steps", two_steps,
                  2e-3 * summary["train"]["steady_ms_per_step"], 2, "step",
                  os.path.join(out_dir, "profile_train.json"))
    torch.backends.cudnn.benchmark = True
    try:
        two_steps()  # the autotuner tries its algorithms here
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            step(state, fixed)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        torch.backends.cudnn.benchmark = False
    print(f"profile: train step with cudnn.benchmark on: "
          f"{[round(t, 3) for t in times]} ms (off: "
          f"{summary['train']['steady_ms_per_step']:.3f} ms)")


def run_paths(dev, out_dir: str, small: bool = False):
    """Phases 3 to 6; `small` cuts them to a CPU rehearsal's size. Returns
    what --profile drives again, the launches of each path and its
    summary."""
    tiny = dict(iters=2) if small else {}
    rt, sample, prep, demo = demo_phase(dev, **tiny)
    rt512, full_launched, full = full_width_phase(dev, rt, sample, prep,
                                                  **tiny)
    binned_launched, binned = binned_refine_phase(
        dev, rt, sample, prep["anno"], iters=1 if small else 10)
    crops_dir, crops_launched, crops = crops_phase(
        dev, out_dir, **(dict(n_crops=4, grid=16, capacity=512) if small
                         else {}))
    state, fixed, train_launched, train = train_phase(
        dev, crops_dir, os.path.join(out_dir, "log"),
        **(dict(width=8, batch=2, epochs=1) if small else {}))
    launched = {"full_width": full_launched, "binned_refine": binned_launched,
                "crops": crops_launched, "train": train_launched}
    summary = {"demo_crop": demo, "full_width_crop": full,
               "binned_refine": binned, "crops": crops, "train": train}
    handles = dict(rt512=rt512, prep=prep, state=state, fixed=fixed)
    return handles, launched, summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse-cpu", action="store_true")
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the full-width crop and two train "
                         "steps; write DIR/profile.json and "
                         "DIR/profile_train.json")
    args = ap.parse_args()
    if args.rehearse_cpu:
        with tempfile.TemporaryDirectory() as out_dir:
            run_paths(torch.device("cpu"), out_dir, small=True)
        print("CPU rehearsal finished; no result without a card",
              file=sys.stderr)
        return 3
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = _cuda.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log.strip()}")
    card = gpu_line()
    print(f"card: {card}")

    rows = (check_splat(dev) + [check_nn(dev), check_select(dev)]
            + check_splat_binned(dev) + check_ce(dev))
    with tempfile.TemporaryDirectory() as out_dir:
        handles, launched, summary = run_paths(dev, out_dir)
    missing = [k for k, path in PATHS.items() if launched[path][k] == 0]
    assert not missing, f"kernels not launched on their path: {missing}"
    if args.profile:
        profile_all(args.profile, summary=summary, **handles)
    for row in rows:
        _, source, replaces = KERNELS[row["name"]]
        path = PATHS[row["name"]]
        row.update(route="cuda", source=source, replaces=replaces,
                   path=path, launches=launched[path][row["name"]])
    print(json.dumps({"card": card, **summary}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
