"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Seven phases; any failure exits non-zero and no phase's error is caught.

1. Build the port's CUDA kernels from ``sdflabel_tpu_torch/csrc`` (one
   nvcc per source, started together), print the registers, spills and
   shared memory of the wgmma kernels, the split splat forward and
   backward (dense and binned), the bins kernels, the split nearest
   neighbour and the CE kernels, and the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time kernel, plain version and (where one
   exists) a PyTorch library call with CUDA events. The selection kernel
   and kernels 4a and 4b also give the design that ran, its cluster size,
   its roofline share and its ratio to the bf16 matmul chain of the same
   run; their wmma designs (wider layers) are checked against the same
   plain versions and timed beside them. The dense splat forward's split
   design is held against its first design (one thread per pixel, the
   binned forward's kernel), which is checked and timed beside it, and
   two of its launches must be bit-equal; so is the dense backward's split
   design against its first design (one thread per point), and the split
   nearest neighbour must equal its first design and the plain version bit
   for bit, at the 3D loss's shape and at RANSAC's. Both new designs are
   also timed alone on the device (the profiler's kernel time, without
   the wrapper), beside their first designs. The cross-entropy's
   class-split forward and its backward from the saved log-sum-exp are
   held against the plain version and against their first designs, two
   launches bit-equal, and timed a call and alone beside the first
   designs. The row-binned path on a make_crops render: the bins kernel
   must equal compute_bins and the torch gathers bit for bit, the binned
   split forward and backward must hold the first designs' limits (those
   of the dense split designs) and give two bit-equal launches; each is
   timed a call and alone beside its first design, with the window pairs
   and footprint pairs. Every row prints its share of its bound.
3. The demo driver: ``refine_css_demo`` on the bundled data/optimization
   assets with configs/config_demo.ini (viz off); the labels must land on
   the ground-truth annotation, the splat and NN kernels must have run,
   and no computation on the path may take CPU tensors.
4. Full width: phase 3's prepared crop refined under the stock
   configs/config_refine.ini settings (60 iterations, float16 -> bf16,
   warm band 8192 refreshed every 10, the selection kernel, grid 40)
   through the reference 8x512 DeepSDF architecture (latent_in 4,
   weight-norm, latent 3) with seeded random weights; (4c) the same crop
   and runtime with ``stage2_pallas = True``, whose stage-2 decode and its
   backward take kernels 4a and 4b; then (4b) phase 3's crop prepared and
   refined at ``rendering_area = 96``, whose renders of >= 4096 pixels
   take the row-binned splat kernels (the bins, the forward and the
   backward), with the device launches of one such render beside those of
   the first designs' chain.
5. Crops: ``make_crops`` renders 26 crops of 128x128 px (grid 40,
   capacity 4096) from data/quality_nets/deepsdf_quality.pt, each through
   the bins kernel and the binned splat forward; the device launches of
   one such render beside those of the first designs' chain.
6. Training: ``train_css`` trains the width-64 CSS network on those crops
   under configs/config_train.ini with fused_ce and direct_ce on, batch
   13, float32, from a seeded init, for 2 epochs (4 steps): every CE tower
   goes through the CE kernels, no CPU operator runs in the step, the
   written css.msgpack reloads to the same network, and 3 steps on one
   fixed batch lower its loss. The device launches of one
   fused_cross_entropy forward and backward are counted beside those of
   the first designs' wrapper chain.
7. The KITTI driver: ``tools/quality_suite.py`` builds the first 24 frames
   of the v2 quality suite (``--quality-frames 72``: all of it) through
   the binned splat kernel; ``refine_css`` labels them as ``main.py
   --refine`` does (the settings of scripts/run_quality_benchmark.py, 60
   iterations, float16, the stock warm band, the committed quality nets),
   and ``evaluate_dump.evaluate`` scores the dumps: KITTI and nuScenes AP
   per difficulty. Every car must get a label, and the BEV and 3D AP must
   lie within 2 and 5 points of the JAX driver's on the same frames
   (QUALITY_jax_cpu_v2.json, written by scripts/quality_jax_cpu.py).

Each kernel's launches are counted on the path that runs it (set to 0
just before the path, read just after): the dense splat, NN and selection
kernels in phase 4, the stage-2 kernels in 4c, the binned backward in 4b,
the bins and the binned forward in 5 and the CE kernels in 6. The line
before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without a card
the script exits 2 and prints no result. ``--profile DIR`` adds one more
full-width crop and two train steps under torch.profiler: device time by
kernel group, the device busy time and its share of the wall time, and
DIR/profile.json and DIR/profile_train.json with every kernel; the same
crop once more with the first dense splat forward, once with the first
designs of the dense splat backward and the nearest neighbour, and phase
4c's crop
with the new designs and with the first splat forward and the wmma 4b,
for comparison; then the train step timed with cuDNN's autotuner on. ``--rehearse-cpu`` runs phases
3 to 7 on the CPU at a tiny size (2 iterations, 2 suite frames) with the
kernels' plain versions, then exits 3 without a result: a dry run of the
control flow for machines without a card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import os
import re
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
    _cuda, ce_cuda, grid as grid_ops, knn, mlp2_cuda, mlp_cuda, nn_cuda,
    splat, splat_cuda)
from sdflabel_tpu_torch.pipelines import evaluate_dump  # noqa: E402
from sdflabel_tpu_torch.pipelines import make_crops as crops_pipe  # noqa: E402
from sdflabel_tpu_torch.pipelines import refine_css as pipe  # noqa: E402
from sdflabel_tpu_torch.pipelines import train_css as train_pipe  # noqa: E402
from sdflabel_tpu_torch.renderer import rasterer  # noqa: E402
from sdflabel_tpu_torch.tools import quality_suite  # noqa: E402
from sdflabel_tpu_torch.utils import png  # noqa: E402

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # outside the tensor cores
BF16_TENSOR_FLOPS = 989e12
# sqrt, reciprocal / divide and exp each take one special-function (MUFU)
# op: 16 per clock per SM, 132 SMs at the 1.98 GHz behind the fp32 peak
SFU_OPS = 132 * 16 * 1.98e9

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
    # the port's own kernel: JAX bins in XLA (_compute_bins) before its
    # binned kernels
    "splat_bins": (splat_cuda.SPLAT_BINS,
                   "sdflabel_tpu_torch/csrc/splat_bins.cu",
                   "sdflabel_tpu/ops/splat_pallas.py:242"),
    "splat_bwd_binned": (splat_cuda.SPLAT_BWD_BINNED,
                         "sdflabel_tpu_torch/csrc/splat.cu",
                         "sdflabel_tpu/ops/splat_pallas.py:589"),
    "ce_fwd": (ce_cuda.CE_FWD, "sdflabel_tpu_torch/csrc/ce.cu",
               "sdflabel_tpu/ops/ce_pallas.py:54"),
    "ce_bwd": (ce_cuda.CE_BWD, "sdflabel_tpu_torch/csrc/ce.cu",
               "sdflabel_tpu/ops/ce_pallas.py:79"),
    "stage2_fwd": (mlp2_cuda.STAGE2_FWD,
                   "sdflabel_tpu_torch/csrc/stage2_mlp.cu",
                   "sdflabel_tpu/ops/mlp2_pallas.py:174"),
    "stage2_bwd": (mlp2_cuda.STAGE2_BWD,
                   "sdflabel_tpu_torch/csrc/stage2_mlp.cu",
                   "sdflabel_tpu/ops/mlp2_pallas.py:197"),
}
# the path whose run gives each kernel's launches
PATHS = {"splat_fwd": "full_width", "splat_bwd": "full_width",
         "nn": "full_width", "select_mlp": "full_width",
         "splat_bwd_binned": "binned_refine", "splat_fwd_binned": "crops",
         "splat_bins": "crops",
         "ce_fwd": "train", "ce_bwd": "train",
         "stage2_fwd": "full_width_stage2", "stage2_bwd": "full_width_stage2"}
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


def ptxas_report(logs: dict) -> list[str]:
    """Registers, spills and stack of each wgmma kernel from nvcc's
    -Xptxas=-v log, with the dynamic shared memory its launcher asks for
    at the 8x512 decoder's width."""
    smem = {"select": _cuda.query("select_mlp", "select_mlp_wgmma_smem",
                                  512),
            "stage2_fwd": _cuda.query("stage2_mlp", "stage2_fwd_wgmma_smem",
                                      512, 7),
            "stage2_bwd": _cuda.query("stage2_mlp", "stage2_bwd_wgmma_smem",
                                      512, 7)}
    lines, name = [], None
    for log in logs.values():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"(select|stage2_fwd|stage2_bwd)_wgmma_kernel"
                              r"ILi(\d+)E", line)
                name = m and f"{m.group(1)}_wgmma_kernel<{m.group(2)}>"
                key = m and m.group(1)
                for plain_name in ("splat_fwd_split_kernel",
                                   "splat_bwd_split_kernel",
                                   "splat_fwd_binned_split_kernel",
                                   "splat_bwd_binned_split_kernel",
                                   "splat_bins_keys_kernel",
                                   "splat_bins_scatter_kernel",
                                   "nn_split_kernel"):
                    if plain_name in line:
                        name, key = plain_name, None
                # the CE kernels as the train towers launch them (int64
                # targets, float4 lanes; the forward's 8 class groups)
                for mangled, plain_name in (
                        ("ce_fwd_split_kernelIxLi4ELi8E",
                         "ce_fwd_split_kernel<int64, 4, 8>"),
                        ("ce_bwd_lse_kernelIxLi4E",
                         "ce_bwd_lse_kernel<int64, 4>")):
                    if mangled in line:
                        name, key = plain_name, None
            elif name and "spill" in line:
                spill = line.strip()
            elif name and "Used" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                extra = (f", {smem[key]} bytes of dynamic shared memory at "
                         f"H = 512" if name.endswith("<512>") else "")
                note = (" (setmaxnreg then gives the consumers 232)" if key
                        else "")
                lines.append(f"ptxas: {name}: {regs} registers at launch"
                             f"{note}, {spill}{extra}")
                name = None
    return lines


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


def kernel_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device time of one launch of the kernel whose name contains
    `kernel`, without the wrapper's host work: the mean of the profiler's
    kernel times over `reps` calls of `fn` (the profiler may drop a few
    of the launches; the mean is over those it recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    count = sum(e.count for e in hits)
    assert count > 0, f"the profiler recorded no launch of {kernel}"
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def chain_ms(fn, reps: int = 20) -> float:
    """Device time of one call of `fn`, every kernel, copy and fill it
    launches, without the host's work: the profiler's device times summed
    over `reps` calls, over `reps`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA)
    assert total > 0, "the profiler recorded no device time"
    return total / reps / 1e3


def device_launches(fn, reps: int = 10) -> dict:
    """Device launches (kernels, copies, fills) of one call of `fn` by
    kernel name, by the profiler over `reps` calls (it may drop a launch or
    two; round the total)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler run now and then records nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_call = {e.key: e.count / reps for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA}
        if per_call:
            return per_call
    raise AssertionError("the profiler recorded no launch")


def bound(bytes_moved: float, flops: float, peak_flops: float,
          sfu_ops: float = 0.0):
    """(ms, "bytes" or "operations", what bounds it: "bytes", "flops" or
    "special-function ops"): the larger of the bytes over the memory rate,
    the flops over `peak_flops` and the special-function ops over their
    rate."""
    times = {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
             "flops": flops / peak_flops * 1e3,
             "special-function ops": sfu_ops / SFU_OPS * 1e3}
    what = max(times, key=times.get)
    return times[what], "bytes" if what == "bytes" else "operations", what


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

    with torch.no_grad():
        fp_pairs = float((splat.surfel_prob(kg, pts, nrm, mask, 0.04) > 0)
                         .sum())
    io_bytes = 4 * (n * 16 + p * 4 + p * 11)
    fwd_bound, bwd_bound = splat_bounds(n * p, fp_pairs, io_bytes,
                                        io_bytes + 4 * (p * 12 + n * 14))

    # the kernels' own packed inputs, as the autograd Function builds them
    pk = torch.cat([pts, nrm, mask.float()[:, None],
                    torch.zeros(n, 1, device=dev)], 1).contiguous()
    kg4 = splat_cuda._pack_rays(kg)
    img, m, d, zn = splat_cuda._fwd(pk, feats, kg4, 0.04, 150.0)
    # the first design (one thread per pixel over all points; the binned
    # forward's kernel) at the same inputs: the dense tolerance against
    # the plain version, within 2e-5 of the split design, and two launches
    # of the split design bit-equal
    first = splat_cuda._fwd(pk, feats, kg4, 0.04, 150.0,
                            splat_cuda.SPLAT_FWD_FIRST)
    again = splat_cuda._fwd(pk, feats, kg4, 0.04, 150.0)
    torch.cuda.synchronize()
    first_err = (first[0] - img_p.detach()).abs().max(-1).values
    first_ok = float((first_err < 2e-4).float().mean())
    split_vs_first = float((img - first[0]).abs().max())
    same = all(torch.equal(a, b) for a, b in zip((img, m, d, zn), again))
    slices = splat_cuda.split_slices(n, p)
    print(f"splat fwd, split design: {-(-p // 64)} tiles x {slices} slices; "
          f"max |split - first design| {split_vs_first:.3g} (need <= 2e-5), "
          f"two launches bit-equal: {same}; first design max_abs_err "
          f"{float(first_err.max()):.3g}, pixels within 2e-4: {first_ok:.4f} "
          f"(need >= 0.995)")
    assert split_vs_first <= 2e-5 and same and first_ok >= 0.995
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[:, None], d[:, None], zn[:, None], corr, g],
                    1).contiguous()
    fwd_ms = time_ms(lambda: splat_cuda._fwd(pk, feats, kg4, 0.04,
                                             150.0))
    first_ms = time_ms(lambda: splat_cuda._fwd(
        pk, feats, kg4, 0.04, 150.0, splat_cuda.SPLAT_FWD_FIRST))
    # the backward's split design against its first design (one thread
    # per point over all pixels) at the same inputs: d_points and
    # d_features within 1e-5 of their largest magnitude, d_normals within
    # 5e-5 (a difference of two sums that cancel ~100x: see
    # tests/test_torch_kernels_cuda.py), and two launches of the split
    # design bit-equal
    bwd = splat_cuda._bwd(pk, feats, pix, 0.04, 150.0)
    bwd_again = splat_cuda._bwd(pk, feats, pix, 0.04, 150.0)
    bwd_first = splat_cuda._bwd(pk, feats, pix, 0.04, 150.0,
                                splat_cuda.SPLAT_BWD_FIRST)
    torch.cuda.synchronize()
    bwd_vs_first = [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(bwd, bwd_first)]
    bwd_same = all(torch.equal(a, b) for a, b in zip(bwd, bwd_again))
    first_bwd_err = max(float((a - b).abs().max())
                        for a, b in zip(bwd_first, grads_p))
    bwd_slices = splat_cuda.bwd_split_slices(n, p)
    print(f"splat bwd, split design: {-(-n // 64)} point blocks x "
          f"{bwd_slices} slices; max |split - first design| over the "
          f"largest (d_points, d_normals, d_features) "
          f"{[f'{x:.3g}' for x in bwd_vs_first]} (need <= 1e-5, 5e-5, "
          f"1e-5), two launches bit-equal: {bwd_same}; first design "
          f"max_abs_err {first_bwd_err:.3g}")
    assert bwd_same and bwd_vs_first[1] <= 5e-5
    assert bwd_vs_first[0] <= 1e-5 and bwd_vs_first[2] <= 1e-5
    bwd_ms = time_ms(lambda: splat_cuda._bwd(pk, feats, pix, 0.04,
                                             150.0))
    bwd_first_ms = time_ms(lambda: splat_cuda._bwd(
        pk, feats, pix, 0.04, 150.0, splat_cuda.SPLAT_BWD_FIRST))
    bwd_kernel = kernel_ms(lambda: splat_cuda._bwd(pk, feats, pix, 0.04,
                                                   150.0),
                           "splat_bwd_split_kernel")
    bwd_first_kernel = kernel_ms(lambda: splat_cuda._bwd(
        pk, feats, pix, 0.04, 150.0, splat_cuda.SPLAT_BWD_FIRST),
        "splat_bwd_kernel")
    with torch.no_grad():
        fwd_plain = time_ms(lambda: splat.surfel_composite_dense(
            pts, nrm, feats, kg, mask))
    bwd_plain = time_ms(lambda: torch.autograd.grad(
        img_p, args_p, g, retain_graph=True))
    print(f"splat fwd: split design {fwd_ms:.4f} ms, first design "
          f"{first_ms:.4f} ms ({first_ms / fwd_ms:.1f}x), bound "
          f"{fwd_bound[0]:.5f} ms ({fwd_bound[2]})")
    print(f"splat bwd: split design {bwd_ms:.4f} ms a call "
          f"({bwd_kernel:.4f} ms the kernel alone), first design "
          f"{bwd_first_ms:.4f} ms ({bwd_first_kernel:.4f}), "
          f"{bwd_first_ms / bwd_ms:.1f}x a call, "
          f"{bwd_first_kernel / bwd_kernel:.1f}x the kernel; bound "
          f"{bwd_bound[0]:.5f} ms ({bwd_bound[2]})")
    return [
        dict(name="splat_fwd", max_abs_err=fwd_err, ms=fwd_ms,
             plain_ms=fwd_plain, bound_ms=fwd_bound[0],
             bound_by=fwd_bound[1], bound_what=fwd_bound[2],
             library_ms=None, design="split", slices=slices,
             first_ms=first_ms, first_max_abs_err=float(first_err.max()),
             max_abs_vs_first=split_vs_first),
        dict(name="splat_bwd", max_abs_err=bwd_err, ms=bwd_ms,
             plain_ms=bwd_plain, bound_ms=bwd_bound[0],
             bound_by=bwd_bound[1], bound_what=bwd_bound[2],
             library_ms=None, design="split", slices=bwd_slices,
             kernel_ms=bwd_kernel, first_ms=bwd_first_ms,
             first_kernel_ms=bwd_first_kernel,
             first_max_abs_err=first_bwd_err,
             rel_vs_first=bwd_vs_first),
    ]


def splat_bounds(pairs: float, fp_pairs: float, fwd_bytes: float,
                 bwd_bytes: float):
    """Bounds of a splat forward and backward that meet `pairs` (point,
    pixel) pairs, `fp_pairs` of them in a footprint. Work this data needs:
    every pair's ray-plane geometry, ~18 flops and 2 special-function ops
    (the division z = n.v / n.g and the distance's sqrt); per footprint
    pair the z-norm and softmax / feature composite forward (~27 flops and
    an exp), the chain rule backward (~51 flops, an exp and a division)."""
    return (bound(fwd_bytes, 18 * pairs + 27 * fp_pairs, FP32_FLOPS,
                  2 * pairs + fp_pairs),
            bound(bwd_bytes, 18 * pairs + 51 * fp_pairs, FP32_FLOPS,
                  2 * pairs + 2 * fp_pairs))


def check_nn(dev) -> dict:
    """8192 queries x 8192 data (the frustum capacity), a partial mask, and
    coordinates on a 0.25 lattice so that exact distance ties abound; then
    RANSAC's shape, 567 hypotheses x 2048 scene points against 2048 model
    points. The split design must equal the plain version and the first
    design bit for bit at both."""
    def case(n, m, seed):
        rng = np.random.RandomState(seed)
        q = rng.randint(-8, 9, (n, 3)).astype(np.float32) * 0.25
        d = rng.randint(-8, 9, (m, 3)).astype(np.float32) * 0.25
        mask = rng.uniform(size=m) > 0.3
        return tuple(torch.as_tensor(a, device=dev) for a in (q, d, mask))

    first = functools.partial(nn_cuda.nearest_neighbor_fused,
                              kernel=nn_cuda.NN_FIRST)
    rows = {}
    for label, (n, m, seed) in (("loss", (8192, 8192, 1)),
                                ("ransac", (567 * 2048, 2048, 2))):
        q, d, mask = case(n, m, seed)
        dk, ik = nn_cuda.nearest_neighbor_fused(q, d, mask)
        df, if_ = first(q, d, mask)
        dp, ip = knn.nearest_neighbor_plain(q, d, mask)
        torch.cuda.synchronize()
        # tolerance: none; the index and the squared distance are equal
        err = float((dk - dp).abs().max())
        first_err = float((df - dp).abs().max())
        same = (bool(torch.equal(ik, ip)) and bool(torch.equal(ik, if_))
                and bool(torch.equal(dk, df)))
        slices = nn_cuda.split_slices(n, m)
        print(f"nn {label} ({n} x {m}): split design, {slices} slices; "
              f"max_abs_err {err} (need 0), indices and distances equal to "
              f"the plain version's and the first design's: {same}")
        assert err == 0.0 and same
        rows[label] = (q, d, mask, err, first_err, slices)
    q, d, mask, err, first_err, slices = rows["loss"]
    n = m = 8192
    b = bound(4 * 3 * n + 13 * m + 12 * n, 9 * n * m, FP32_FLOPS)
    ms = time_ms(lambda: nn_cuda.nearest_neighbor_fused(q, d, mask))
    first_ms = time_ms(lambda: first(q, d, mask))
    kernel = kernel_ms(lambda: nn_cuda.nearest_neighbor_fused(q, d, mask),
                       "nn_split_kernel")
    first_kernel = kernel_ms(lambda: first(q, d, mask), "nn_kernel")
    qr, dr, mr = rows["ransac"][:3]
    ransac_kernel = kernel_ms(lambda: nn_cuda.nearest_neighbor_fused(
        qr, dr, mr), "nn_split_kernel", reps=5)
    ransac_first = kernel_ms(lambda: first(qr, dr, mr), "nn_kernel", reps=5)
    print(f"nn: split design {ms:.4f} ms a call ({kernel:.4f} ms the "
          f"kernel alone), first design {first_ms:.4f} ms "
          f"({first_kernel:.4f}), {first_kernel / kernel:.1f}x the kernel; "
          f"bound {b[0]:.5f} ms; RANSAC shape: the kernel alone "
          f"{ransac_kernel:.4f} ms, first design {ransac_first:.4f} ms")
    return dict(name="nn", max_abs_err=err, ms=ms,
                plain_ms=time_ms(lambda: knn.nearest_neighbor_plain(q, d,
                                                                    mask)),
                bound_ms=b[0], bound_by=b[1], library_ms=None,
                design="split", slices=slices, kernel_ms=kernel,
                first_ms=first_ms, first_kernel_ms=first_kernel,
                first_max_abs_err=first_err, ransac_kernel_ms=ransac_kernel,
                ransac_first_kernel_ms=ransac_first,
                ransac_slices=rows["ransac"][5])


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

    design = mlp_cuda.select_design(packed)
    assert design == "wgmma"
    cvec = mlp_cuda._cvec(packed, lat).contiguous()
    out = torch.empty(n, device=dev)

    def wmma():  # the first design (wider layers) at the same shapes
        mlp_cuda.SELECT_MLP_WMMA(
            _cuda.ptr(pts), _cuda.ptr(packed.ws), _cuda.ptr(packed.wx),
            _cuda.ptr(cvec), _cuda.ptr(packed.wlast), _cuda.ptr(packed.scal),
            n, H, nh, int(packed.use_tanh), _cuda.ptr(out), _cuda.stream(pts))

    wmma()
    torch.cuda.synchronize()
    wmma_err = (out - out_p).abs()
    print(f"select_mlp, wmma design: max_abs_err {float(wmma_err.max()):.3g} "
          f"(need < 1e-3), median {float(wmma_err.median()):.3g} "
          f"(need < 1e-5)")
    assert float(wmma_err.max()) < 1e-3 and float(wmma_err.median()) < 1e-5
    # the kernel's launch (as stage2_fwd below), the latent absorbed
    row = dict(name="select_mlp", max_abs_err=float(err.max()),
               ms=time_ms(lambda: mlp_cuda.select_fwd(packed, cvec, pts)),
               plain_ms=time_ms(lambda: mlp_cuda.emulate_select_mlp(
                   packed, lat, pts)),
               bound_ms=b[0], bound_by=b[1], library_ms=time_ms(chain))
    return design_report(row, design, time_ms(wmma), float(wmma_err.max()))


def design_report(row: dict, design: str, wmma_ms: float,
                  wmma_err: float) -> dict:
    """Add to a wgmma kernel's phase-2 row: the design and cluster size
    that ran, its roofline share and ratio to the chain, and the wmma
    design's time and max_abs_err at the same shapes."""
    row.update(design=design, cluster=mlp_cuda.CLUSTER,
               roofline_share=row["bound_ms"] / row["ms"],
               chain_ratio=row["ms"] / row["library_ms"],
               wmma_ms=wmma_ms, wmma_max_abs_err=wmma_err)
    print(f"{row['name']}: design {design}, cluster {row['cluster']}, "
          f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}), roofline share "
          f"{100 * row['roofline_share']:.1f}%, {row['chain_ratio']:.3f}x "
          f"the bf16 matmul chain ({row['library_ms']:.4f} ms); the wmma "
          f"design {wmma_ms:.4f} ms")
    return row


def check_stage2(dev) -> list[dict]:
    """Kernels 4a and 4b on K = 8192 seeded points in [-1, 1]^3 through the
    8x512 decoder, cast to bf16 and packed, against the plain version
    (ops/mlp2_cuda.py::stage2_plain and its autograd), with the tolerance
    of mlp2_cuda.stage2_agreement."""
    cfg, params = decoder_8x512(dev)
    packed = mlp_cuda.pack_select_mlp(
        cfg, deepsdf.cast_params(params, torch.bfloat16))
    assert packed is not None
    n, H, nh = 8192, packed.width, packed.n_hidden
    rng = np.random.RandomState(6)
    pts = torch.as_tensor(rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                          device=dev)
    ct = torch.as_tensor(rng.randn(n).astype(np.float32), device=dev)
    lat = torch.tensor([0.6, -0.48, 0.64], device=dev)
    cvec = mlp_cuda._cvec(packed, lat).contiguous()
    out = mlp2_cuda.stage2_fwd(packed, cvec, pts)
    dcvec, dpts = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct)
    cv = cvec.clone().requires_grad_(True)
    p = pts.clone().requires_grad_(True)
    sdf = mlp2_cuda.stage2_plain(packed, cv, p)
    (g,) = torch.autograd.grad(sdf.sum(), p, retain_graph=True)
    dcv_p, dp_p = torch.autograd.grad(sdf, (cv, p), ct, retain_graph=True)
    torch.cuda.synchronize()
    # the yardstick of the tolerance: the plain version summed in fp64
    cv64 = cvec.clone().requires_grad_(True)
    p64 = pts.clone().requires_grad_(True)
    sdf64 = mlp2_cuda.stage2_plain(packed, cv64, p64, torch.float64)
    (g64,) = torch.autograd.grad(sdf64.sum(), p64, retain_graph=True)
    dcv64, dp64 = torch.autograd.grad(sdf64, (cv64, p64), ct)

    def agreement(s, n, dp, dcv, s_ref, n_ref, dp_ref, dcv_ref):
        return mlp2_cuda.stage2_agreement(s, s_ref, (
            ("normals", n, n_ref), ("d_points", dp, dp_ref),
            ("d_cvec", dcv.reshape(-1, 1), dcv_ref.reshape(-1, 1))))

    shares, medians = agreement(out[:, 0], out[:, 1:], dpts, dcvec,
                                sdf.detach(), g, dp_p, dcv_p)
    spread = agreement(sdf.detach(), g, dp_p, dcv_p, sdf64.detach(), g64,
                       dp64, dcv64)
    sdf_err = float((out[:, 0] - sdf.detach()).abs().max())
    print(f"stage2: sdf max_abs_err {sdf_err:.3g} (need < 1e-3); shares "
          f"within tolerance {shares} (need >= 0.995 for the sdf, 0.98 "
          f"else); medians {medians} (need <= 1e-6 for the sdf, 1e-4 else); "
          f"the plain version summed in fp32 against fp64: sdf max "
          f"{float((sdf - sdf64).abs().max()):.3g}, shares {spread[0]}, "
          f"medians {spread[1]}")
    assert sdf_err < 1e-3 and shares["sdf"] >= 0.995
    assert medians.pop("sdf") <= 1e-6 and max(medians.values()) <= 1e-4
    assert min(shares.values()) >= 0.98
    rel = {k: float((a - b).abs().max() / b.abs().max()) for k, a, b in (
        ("normals", out[:, 1:], g), ("d_points", dpts, dp_p),
        ("d_cvec", dcvec, dcv_p))}
    fwd_err = max(sdf_err, float((out[:, 1:] - g).abs().max()))
    bwd_err = max(float((dpts - dp_p).abs().max()),
                  float((dcvec - dcv_p).abs().max()))

    # work of one launch (mlp2_pallas.py:189): two chains of nh H x H
    # products, 4 * K * (nh * H^2 + 8 * H) flops; bytes: points, stack,
    # outputs (4b also reads the cotangent and writes d_cvec)
    flops = 4 * n * (nh * H * H + 8 * H)
    fwd_b = bound(n * 12 + nh * H * H * 2 + n * 16, flops, BF16_TENSOR_FLOPS)
    bwd_b = bound(n * 16 + nh * H * H * 2 + n * 12 + (nh + 1) * H * 4, flops,
                  BF16_TENSOR_FLOPS)
    # yardstick: the same products as a bf16 torch.matmul chain, nh
    # forward and nh transposed, for 4a and for 4b alike: 4b recomputes the
    # forward and sweeps back once, and its normals take no cotangent, so
    # its work is 4a's (mlp2_pallas.py:189 and :229 give both the same
    # flops)
    h0 = torch.relu(torch.randn(n, H, device=dev)).to(torch.bfloat16)
    wt = [packed.ws[j].t() for j in range(nh)]

    def chain():
        h = h0
        for j in range(nh):
            h = torch.relu(h @ packed.ws[j])
        for j in reversed(range(nh)):
            h = h @ wt[j]
        return h

    def plain_fwd():
        return mlp2_cuda.emulate_stage2(packed, lat, pts)

    def plain_bwd():
        return torch.autograd.grad(sdf, (cv, p), ct, retain_graph=True)

    design = mlp2_cuda.stage2_fwd_design(packed)
    assert design == "wgmma"
    out4 = torch.empty(n, 4, device=dev)

    def wmma():  # the first design (wider layers, 4b's) at the same shapes
        mlp2_cuda.STAGE2_FWD_WMMA(
            _cuda.ptr(pts), _cuda.ptr(packed.ws), _cuda.ptr(packed.wx),
            _cuda.ptr(cvec), _cuda.ptr(packed.wlast), _cuda.ptr(packed.scal),
            n, H, nh, int(packed.use_tanh), _cuda.ptr(out4),
            _cuda.stream(pts))

    wmma()
    torch.cuda.synchronize()
    w_shares, w_medians = mlp2_cuda.stage2_agreement(
        out4[:, 0], sdf.detach(), (("normals", out4[:, 1:], g),))
    w_sdf_err = float((out4[:, 0] - sdf.detach()).abs().max())
    print(f"stage2_fwd, wmma design: sdf max_abs_err {w_sdf_err:.3g} (need "
          f"< 1e-3); shares {w_shares}, medians {w_medians}, the same "
          f"limits")
    assert w_sdf_err < 1e-3 and w_shares["sdf"] >= 0.995
    assert w_medians["sdf"] <= 1e-6 and w_medians["normals"] <= 1e-4
    assert w_shares["normals"] >= 0.98
    # 4b's first design (wider layers) at the same shapes, same limits
    bwd_design = mlp2_cuda.stage2_bwd_design(packed)
    assert bwd_design == "wgmma"
    dcvec_w, dpts_w = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct, "wmma")
    torch.cuda.synchronize()
    wb_shares, wb_medians = agreement(out[:, 0], out[:, 1:], dpts_w, dcvec_w,
                                      sdf.detach(), g, dp_p, dcv_p)
    for d in (wb_shares, wb_medians):
        d.pop("sdf")
        d.pop("normals")
    print(f"stage2_bwd, wmma design: shares {wb_shares}, medians "
          f"{wb_medians}, the same limits")
    assert max(wb_medians.values()) <= 1e-4
    assert min(wb_shares.values()) >= 0.98
    chain_ms = time_ms(chain)
    fwd_row = design_report(
        dict(name="stage2_fwd", max_abs_err=fwd_err,
             ms=time_ms(lambda: mlp2_cuda.stage2_fwd(packed, cvec, pts)),
             plain_ms=time_ms(plain_fwd), bound_ms=fwd_b[0],
             bound_by=fwd_b[1], library_ms=chain_ms,
             max_rel_err=rel, shares=shares, plain_fp64_shares=spread[0]),
        design, time_ms(wmma),
        max(w_sdf_err, float((out4[:, 1:] - g).abs().max())))
    fwd_row["wmma_shares"] = w_shares
    bwd_row = design_report(
        dict(name="stage2_bwd", max_abs_err=bwd_err,
             ms=time_ms(lambda: mlp2_cuda.stage2_bwd(packed, cvec, pts, ct)),
             plain_ms=time_ms(plain_bwd), bound_ms=bwd_b[0],
             bound_by=bwd_b[1], library_ms=chain_ms),
        bwd_design, time_ms(lambda: mlp2_cuda.stage2_bwd(
            packed, cvec, pts, ct, "wmma")),
        max(float((dpts_w - dp_p).abs().max()),
            float((dcvec_w - dcv_p).abs().max())))
    bwd_row.update(wmma_shares=wb_shares, wmma_medians=wb_medians)
    return [fwd_row, bwd_row]


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
    """The row-binned path on a make_crops render (16384 px, 4096 surfels):
    the autograd path against the windowed plain version with the dense
    kernel's tolerance; the bins kernel against compute_bins and the torch
    gathers, bit for bit; the split forward against its first design
    within 2e-5 (statistics 2e-5 relative), the split backward against its
    first design within 1e-5 of the largest d_points and d_features and
    5e-5 of the largest d_normals (a difference of two sums that cancel
    ~100x: see tests/test_torch_kernels_cuda.py); two launches of each new
    kernel bit-equal. Each is timed a call and alone on the device beside
    its first design."""
    v, nrm, feats, mask, kg = crop_scene(dev)
    n, p = v.shape[0], kg.shape[0]
    bin_px = splat_cuda.bin_policy(p)
    assert bin_px == 512, bin_px
    nb = -(-p // bin_px)
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
    fk = feats.float().contiguous()
    kg4 = splat_cuda._pack_rays(kg)

    def bins():
        return splat_cuda._sort_bins(pk, fk, kg4, 0.04, bin_px)

    def bins_first():
        return splat_cuda._sort_bins(pk, fk, kg4, 0.04, bin_px,
                                     design="first")

    sb, sb2, sf = bins(), bins(), bins_first()
    torch.cuda.synchronize()
    bins_same = all(torch.equal(a, b) for a, b in zip(sb, sb2))
    bins_equal = (torch.equal(sb.order.long(), sf.order)
                  and all(torch.equal(a, b) for a, b in zip(sb[1:], sf[1:])))
    bins_err = max(float((a - b).abs().max())
                   for a, b in zip(sb[4:], sf[4:]))
    print(f"splat bins: {nb} row blocks, smax {int(sb.smax)}; equal to "
          f"compute_bins + gathers bit for bit: {bins_equal}; two launches "
          f"bit-equal: {bins_same}")
    assert bins_equal and bins_same

    def fwd(design="split"):
        return splat_cuda._fwd_binned(sb.pts, sb.feats, kg4, sb.win, bin_px,
                                      0.04, 150.0, design=design)

    out, out2, out_first = fwd(), fwd(), fwd("first")
    torch.cuda.synchronize()
    fwd_same = all(torch.equal(a, b) for a, b in zip(out, out2))
    fwd_vs_first = float((out[0] - out_first[0]).abs().max())
    stats_ok = all(torch.allclose(a, b, rtol=2e-5, atol=1e-6)
                   for a, b in zip(out[1:], out_first[1:]))
    first_px = (out_first[0] - img_p.detach()).abs().max(-1).values
    slices = splat_cuda.binned_slices(n, p, bin_px)
    print(f"splat fwd binned, split design: {-(-p // 64)} tiles x {slices} "
          f"slices; max |split - first design| {fwd_vs_first:.3g} (need <= "
          f"2e-5), statistics within 2e-5: {stats_ok}, two launches "
          f"bit-equal: {fwd_same}; first design max_abs_err "
          f"{float(first_px.max()):.3g}")
    assert fwd_vs_first <= 2e-5 and stats_ok and fwd_same
    img, m, d, zn = out
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[:, None], d[:, None], zn[:, None], corr, g],
                    1).contiguous()

    def bwd(design="split"):
        return splat_cuda._bwd_binned(sb.pts, sb.feats, pix, sb.key, sb.smax,
                                      sb.order, bin_px, 0.04, 150.0,
                                      design=design)

    grads, grads2, grads_first = bwd(), bwd(), bwd("first")
    torch.cuda.synchronize()
    bwd_same = all(torch.equal(a, b) for a, b in zip(grads, grads2))
    bwd_vs_first = [float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(grads, grads_first)]
    bwd_slices = splat_cuda.bwd_binned_slices(n, p, bin_px)
    print(f"splat bwd binned, split design: {-(-n // 64)} point blocks x "
          f"{bwd_slices} slices; max |split - first design| over the "
          f"largest (d_points, d_normals, d_features) "
          f"{[f'{x:.3g}' for x in bwd_vs_first]} (need <= 1e-5, 5e-5, "
          f"1e-5), two launches bit-equal: {bwd_same}")
    assert bwd_same and bwd_vs_first[1] <= 5e-5
    assert bwd_vs_first[0] <= 1e-5 and bwd_vs_first[2] <= 1e-5

    # a call (host enqueue included) and alone on the device; the first
    # bins design is compute_bins + the torch gathers, casts and stack
    times = dict(
        bins_ms=time_ms(bins), bins_first_ms=time_ms(bins_first),
        bins_kernel_ms=(kernel_ms(bins, "splat_bins_keys_kernel")
                        + kernel_ms(bins, "splat_bins_scatter_kernel")),
        bins_first_kernel_ms=chain_ms(bins_first),
        fwd_ms=time_ms(fwd), fwd_first_ms=time_ms(lambda: fwd("first")),
        fwd_kernel_ms=kernel_ms(fwd, "splat_fwd_binned_split_kernel"),
        fwd_first_kernel_ms=kernel_ms(lambda: fwd("first"),
                                      "splat_fwd_kernel"),
        bwd_ms=time_ms(bwd), bwd_first_ms=time_ms(lambda: bwd("first")),
        bwd_kernel_ms=kernel_ms(bwd, "splat_bwd_binned_split_kernel"),
        bwd_first_kernel_ms=kernel_ms(lambda: bwd("first"),
                                      "splat_bwd_binned_kernel"),
        bwd_first_chain_ms=chain_ms(lambda: bwd("first")))
    with torch.no_grad():
        fwd_plain = time_ms(lambda: splat_cuda.surfel_composite_windowed(
            v, nrm, feats, kg, mask, bin_px=bin_px))
    bwd_plain = time_ms(lambda: torch.autograd.grad(
        img_p, args_p, g, retain_graph=True))

    # work this data needs (splat_bounds) over the pairs the windows hold
    win_len = (sb.win[:, 1] - sb.win[:, 0]).long()
    rows_in = torch.tensor([min(bin_px, p - b * bin_px) for b in range(nb)],
                           device=dev)
    pairs = float((win_len * rows_in).sum())
    with torch.no_grad():
        fp_pairs = float((splat.surfel_prob(kg, v, nrm, mask, 0.04) > 0)
                         .sum())
    io_bytes = 4 * (n * 16 + p * 4 + p * 11 + 2 * nb)
    fwd_bound, bwd_bound = splat_bounds(pairs, fp_pairs, io_bytes,
                                        io_bytes + 4 * (p * 12 + n * 14 + n))
    # the bins: points and features read and written once, the rays read
    # once, order, keys, smax and windows written; the overlap test's ~10
    # flops and 6 divisions for each (point, row block) of a point in the
    # mask and in front of the camera (the others skip the test)
    tested = float(((pk[:, 6] > 0.5) & (pk[:, 2] - 0.04 > 0)).sum()) * nb
    bins_bound = bound(4 * (n * 16 * 2 + p * 4 + n * 2 + 1 + 2 * nb),
                       10 * tested, FP32_FLOPS, 6 * tested)
    t = times
    print(f"splat binned: {n} points x {p} px, {pairs:.0f} pairs in the "
          f"windows ({pairs / (n * p):.3f} of all), {fp_pairs:.0f} "
          f"footprint pairs, {tested:.0f} (point, row block) tests")
    for name, new, first, alone, first_alone, bnd in (
            ("bins", t["bins_ms"], t["bins_first_ms"], t["bins_kernel_ms"],
             t["bins_first_kernel_ms"], bins_bound),
            ("forward", t["fwd_ms"], t["fwd_first_ms"], t["fwd_kernel_ms"],
             t["fwd_first_kernel_ms"], fwd_bound),
            ("backward", t["bwd_ms"], t["bwd_first_ms"], t["bwd_kernel_ms"],
             t["bwd_first_kernel_ms"], bwd_bound)):
        print(f"splat binned {name}: new {new:.4f} ms a call, {alone:.4f} ms "
              f"alone ({bnd[0] / alone:.1%} of the bound); first design "
              f"{first:.4f} ms a call ({first / new:.1f}x), {first_alone:.4f} "
              f"ms alone ({first_alone / alone:.1f}x); bound {bnd[0]:.5f} ms "
              f"({bnd[2]})")
    render = t["bins_kernel_ms"] + t["fwd_kernel_ms"] + t["bwd_kernel_ms"]
    render_first = (t["bins_first_kernel_ms"] + t["fwd_first_kernel_ms"]
                    + t["bwd_first_chain_ms"])
    print(f"splat binned: first backward with its scatters "
          f"{t['bwd_first_chain_ms']:.4f} ms alone; a render's bins, "
          f"forward and backward alone {render:.4f} ms (first designs "
          f"{render_first:.4f} ms, {render_first / render:.1f}x)")
    return [
        dict(name="splat_bins", max_abs_err=bins_err, ms=t["bins_ms"],
             kernel_ms=t["bins_kernel_ms"], plain_ms=t["bins_first_ms"],
             bound_ms=bins_bound[0], bound_by=bins_bound[1],
             bound_what=bins_bound[2], library_ms=None,
             first_kernel_ms=t["bins_first_kernel_ms"], row_blocks=nb,
             smax=int(sb.smax), tests=tested),
        dict(name="splat_fwd_binned", max_abs_err=fwd_err, ms=t["fwd_ms"],
             kernel_ms=t["fwd_kernel_ms"], plain_ms=fwd_plain,
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
             bound_what=fwd_bound[2], library_ms=None, design="split",
             slices=slices, first_ms=t["fwd_first_ms"],
             first_kernel_ms=t["fwd_first_kernel_ms"],
             max_abs_vs_first=fwd_vs_first, window_pairs=pairs,
             footprint_pairs=fp_pairs),
        dict(name="splat_bwd_binned", max_abs_err=bwd_err, ms=t["bwd_ms"],
             kernel_ms=t["bwd_kernel_ms"], plain_ms=bwd_plain,
             bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
             bound_what=bwd_bound[2], library_ms=None, design="split",
             slices=bwd_slices, first_ms=t["bwd_first_ms"],
             first_kernel_ms=t["bwd_first_kernel_ms"],
             first_chain_ms=t["bwd_first_chain_ms"],
             rel_vs_first=bwd_vs_first),
    ]


def binned_render_launches(dev, n: int, res: tuple, backward: bool) -> dict:
    """Device launches (kernels, copies, fills) of one binned render of n
    seeded points onto res pixels, from the packing to the image and, with
    `backward`, from the cotangent to the three gradients in the points'
    own order: through the new designs (the autograd Function's chain:
    the bins kernel, the split forward and backward) and through the first
    designs' (compute_bins, the torch gathers, casts and stack, the first
    forward, the first backward and the torch scatters)."""
    rng = np.random.RandomState(12)
    v = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    v[:, 2] += 4.0
    nrm = rng.randn(n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    feats = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    v, nrm, feats, mask = (torch.as_tensor(a, device=dev)
                           for a in (v, nrm, feats, mask))
    K = torch.as_tensor(rasterer.calibration_matrix(res), device=dev)
    kg = splat.kinv_pixel_rays(K, splat.pixel_grid(*res, device=dev))
    bin_px = splat_cuda.bin_policy(kg.shape[0])
    g = torch.ones(kg.shape[0], 8, device=dev)

    def chain(new):
        pts = splat_cuda._pack_points(v, nrm, mask)
        f = feats.float().contiguous()
        kg4 = splat_cuda._pack_rays(kg)
        sb = splat_cuda._sort_bins(pts, f, kg4, 0.04, bin_px,
                                   design="kernel" if new else "first")
        design = "split" if new else "first"
        img, m, d, zn = splat_cuda._fwd_binned(
            sb.pts, sb.feats, kg4, sb.win, bin_px, 0.04, 150.0,
            design=design)
        if backward:
            corr = (g * img).sum(-1, keepdim=True)
            pix = torch.cat([kg4, m[:, None], d[:, None], zn[:, None], corr,
                             g], 1).contiguous()
            splat_cuda._bwd_binned(sb.pts, sb.feats, pix, sb.key, sb.smax,
                                   sb.order, bin_px, 0.04, 150.0,
                                   design=design)

    by_kernel = device_launches(lambda: chain(True))
    first = device_launches(lambda: chain(False))
    return dict(new=round(sum(by_kernel.values())),
                first=round(sum(first.values())), by_kernel=by_kernel)


def check_ce(dev) -> list[dict]:
    """The CE kernels on the train step's towers: (13, 256, 128, 128) logits
    for u, v and w, (13, 2, 128, 128) for the mask, int64 targets as the
    train step gives them, an upstream cotangent of 2.5. The class-split
    forward and the backward from its saved lse against the plain version,
    against the first designs (one thread per pixel) and against a second
    launch of themselves (bit-equal); each timed a call and alone on the
    device beside the first designs. The rows give the 256-class numbers."""
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

        # the first designs and a second launch, on the wrapper's inputs
        b, hw = 13, 128 * 128
        n = b * hw
        xc, tc = x.reshape(b, c, hw), t.reshape(b, hw)
        loss_first = ce_cuda._fwd(xc, tc, "first")[0].sum() / n
        dx_first = ce_cuda._bwd(xc, tc, None, cot, n, "first")
        partial, lse = ce_cuda._fwd(xc, tc)
        partial2, lse2 = ce_cuda._fwd(xc, tc)
        dx = ce_cuda._bwd(xc, tc, lse, cot, n)
        dx2 = ce_cuda._bwd(xc, tc, lse2, cot, n)
        torch.cuda.synchronize()
        first_rel = abs(float(lk.detach()) - float(loss_first)) / abs(
            float(loss_first))
        first_g_ok = bool(torch.allclose(
            dx, dx_first, rtol=1e-5, atol=1e-6 * float(dx_first.abs().max())))
        first_g_err = float((dx - dx_first).abs().max())
        same = (torch.equal(partial, partial2) and torch.equal(lse, lse2)
                and torch.equal(dx, dx2))
        plan = ce_cuda.fwd_plan(c, hw)
        print(f"ce C={c}: split forward {plan['groups']} class groups of "
              f"{plan['per_group']}, tiles of {plan['tile']} px x "
              f"{b * plan['tiles']}; against the first designs: loss "
              f"{first_rel:.3g} relative (need <= 1e-6), gradient "
              f"{first_g_err:.3g}, within tolerance: {first_g_ok}; two "
              f"launches bit-equal: {same}")
        assert first_rel <= 1e-6 and first_g_ok and same

        def fwd():
            return ce_cuda._fwd(xc, tc)

        def bwd():
            return ce_cuda._bwd(xc, tc, lse, cot, n)

        def fwd_first():
            return ce_cuda._fwd(xc, tc, "first")

        def bwd_first():
            return ce_cuda._bwd(xc, tc, None, cot, n, "first")

        xl = x.clone().requires_grad_(True)
        with torch.no_grad():
            plain_fwd = time_ms(
                lambda: ce_cuda.cross_entropy_with_internal_softmax(x, t))
            lib_fwd = time_ms(lambda: F.cross_entropy(x, t))
        # bytes the function needs: the logits and the targets read once
        # (and the gradient written once); one exp per logit
        logit_bytes, t_bytes = 4 * b * c * hw, t.element_size() * n
        fwd_b = bound(logit_bytes + t_bytes, 6 * b * c * hw, FP32_FLOPS,
                      b * c * hw)
        bwd_b = bound(2 * logit_bytes + t_bytes, 10 * b * c * hw, FP32_FLOPS,
                      b * c * hw)
        rows[c] = [
            dict(name="ce_fwd", max_abs_err=loss_err, ms=time_ms(fwd),
                 kernel_ms=kernel_ms(fwd, "ce_fwd_split_kernel"),
                 plain_ms=plain_fwd, bound_ms=fwd_b[0], bound_by=fwd_b[1],
                 library_ms=lib_fwd, design="split",
                 first_ms=time_ms(fwd_first),
                 first_kernel_ms=kernel_ms(fwd_first, "ce_fwd_kernel"),
                 rel_vs_first=first_rel),
            dict(name="ce_bwd", max_abs_err=g_err, ms=time_ms(bwd),
                 kernel_ms=kernel_ms(bwd, "ce_bwd_lse_kernel"),
                 plain_ms=time_ms(lambda: torch.autograd.grad(
                     lp, xp, cot, retain_graph=True)),
                 bound_ms=bwd_b[0], bound_by=bwd_b[1],
                 # yardstick: F.cross_entropy forward and backward together
                 library_ms=time_ms(lambda: torch.autograd.grad(
                     F.cross_entropy(xl, t), xl, cot)),
                 design="saved_lse", first_ms=time_ms(bwd_first),
                 first_kernel_ms=kernel_ms(bwd_first, "ce_bwd_kernel"),
                 max_abs_vs_first=first_g_err),
        ]
        for r in rows[c]:
            share = r["bound_ms"] / r["kernel_ms"]
            print(f"ce C={c} {r['name']}: {r['ms']:.4f} ms a call, "
                  f"{r['kernel_ms']:.4f} ms alone ({share:.1%} of the "
                  f"bound); first design "
                  f"{r['first_ms']:.4f} ms a call, {r['first_kernel_ms']:.4f} "
                  f"ms alone ({r['first_kernel_ms'] / r['kernel_ms']:.2f}x); "
                  f"plain {r['plain_ms']:.4f} ms, F.cross_entropy "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
        del x, xk, xp, xl, gk, gp, lp, dx, dx2, dx_first, lse, lse2
    for r256, r2 in zip(rows[256], rows[2]):
        r256["max_abs_err"] = max(r256["max_abs_err"], r2["max_abs_err"])
        r256["c2"] = {k: r2[k] for k in ("ms", "kernel_ms", "plain_ms",
                                         "bound_ms", "library_ms",
                                         "first_ms", "first_kernel_ms")}
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
            == launched["splat_bins"] == 0
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
        assert mlp_cuda.SELECT_MLP_WGMMA.launches == refreshes
        assert launched["splat_fwd"] == launched["splat_bwd"] == stock.iters
        assert launched["nn"] >= stock.iters
        # 32x32 crops stay on the dense kernels
        assert launched["splat_fwd_binned"] == launched["splat_bwd_binned"] \
            == launched["splat_bins"] == 0
        assert launched["stage2_fwd"] == launched["stage2_bwd"] == 0
    return rt, launched, dict(wall_s=wall, iters=stock.iters,
                              loss0=float(loss[0]),
                              location=np.asarray(label["location"]).tolist())


def full_width_stage2_phase(dev, rt512, prep, sample, full: dict):
    """Phase 4's crop and runtime settings with stage2_pallas = True: each
    iteration's stage-2 decode is one launch of kernel 4a and its backward
    one of 4b."""
    cfg = dataclasses.replace(rt512.cfg, stage2_pallas=True)
    rt = pipe.RefineRuntime(cfg, rt512.css, rt512.dsdf_cfg,
                            rt512.dsdf_params, device=dev)
    print(f"full width, stage 2: route {rt.stage2_route}")
    assert rt.stage2_route == "kernel"
    reset_counts()
    t0 = time.perf_counter()
    final, hist, ext = rt.run_refine(prep)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    label = pipe.finish_label(final, ext, sample, prep["anno"])
    loss = hist.loss.cpu().numpy()
    applied = hist.applied.cpu().numpy()
    iters = cfg.iters
    assert np.isfinite(loss[applied]).all() and applied.any()
    assert label is not None and np.isfinite(label["location"]).all()
    # the same first iteration as phase 4 but for stage 2's numerics (fp32
    # activations between layers in place of the bf16 decoder's)
    loss0_rel = abs(float(loss[0]) - full["loss0"]) / abs(full["loss0"])
    dist = float(np.linalg.norm(np.asarray(label["location"])
                                - np.asarray(full["location"])))
    print(f"full width, stage 2: {iters} iterations, {wall:.3f} s wall, "
          f"{wall / iters * 1e3:.3f} ms/iteration (phase 4: "
          f"{full['wall_s'] / full['iters'] * 1e3:.3f}), first loss "
          f"{loss[0]:.6f} vs {full['loss0']:.6f} (relative {loss0_rel:.3g}, "
          f"need <= 5e-3), label {dist:.4f} m from phase 4's, launches "
          f"{launched}")
    assert loss0_rel <= 5e-3
    if dev.type == "cuda":
        designs = {f"{k}_{d}": c.launches for k, group in (
            ("stage2_fwd", mlp2_cuda.STAGE2_FWD),
            ("stage2_bwd", mlp2_cuda.STAGE2_BWD))
            for d, c in group.designs.items()}
        print(f"full width, stage 2: launches by design {designs}")
        # one 4a and one 4b per iteration, all of the wgmma designs
        assert launched["stage2_fwd"] == launched["stage2_bwd"] == iters
        assert designs["stage2_fwd_wgmma"] == iters
        assert designs["stage2_bwd_wgmma"] == iters
        assert launched["splat_fwd"] == launched["splat_bwd"] == iters
    return rt, launched, dict(wall_s=wall, iters=iters, loss0=float(loss[0]),
                              loss0_rel=loss0_rel, label_dist_m=dist)


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
    summary = dict(wall_s=wall, iters=iters, px=h * w)
    if dev.type == "cuda":
        assert launched["splat_fwd_binned"] == launched["splat_bwd_binned"] \
            == launched["splat_bins"] == iters
        assert launched["splat_fwd"] == launched["splat_bwd"] == 0
        summary["render_launches"] = binned_render_launches(
            dev, rt.surface_capacity, (h, w), backward=True)
        print_render_launches("binned refine", rt.surface_capacity, (h, w),
                              summary["render_launches"])
    return launched, summary


def print_render_launches(label: str, n: int, res: tuple,
                          launches: dict) -> None:
    print(f"{label}: device launches a binned render of {n} points onto "
          f"{res[0]}x{res[1]} px: {launches['new']} (the first designs' "
          f"chain: {launches['first']}); by kernel "
          f"{json.dumps(launches['by_kernel'])}")


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
    summary = dict(wall_s=wall, crops=n_crops,
                   ms_per_crop=wall / n_crops * 1e3)
    if dev.type == "cuda":
        assert launched["splat_fwd_binned"] == launched["splat_bins"] \
            == n_crops
        assert launched["splat_fwd"] == launched["splat_bwd_binned"] == 0
        summary["render_launches"] = binned_render_launches(
            dev, capacity, (128, 128), backward=False)
        print_render_launches("crops", capacity, (128, 128),
                              summary["render_launches"])
    return crops_dir, launched, summary


# ---------------------------------------------------------------- phase 6

def ce_call_launches(dev, reps: int = 10) -> dict:
    """Device launches (kernels, copies, fills) of one fused_cross_entropy
    forward and backward on a u-tower's (13, 256, 128, 128) logits with the
    train step's int64 targets (device_launches); beside them the
    launches of the first designs' wrapper chain (the targets cast to
    int32, the forward, the partials' sum and division, the scale, the
    backward)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(13, 256, 128, 128, device=dev,
                    generator=gen).requires_grad_(True)
    t = torch.randint(0, 256, (13, 128, 128), device=dev, generator=gen)
    cot = torch.tensor(2.5, device=dev)
    n = t.numel()

    def split():
        torch.autograd.grad(ce_cuda.fused_cross_entropy(x, t), x, cot)

    def first():
        xc = x.detach().reshape(13, 256, n // 13)
        t32 = t.reshape(13, n // 13).to(torch.int32)
        ce_cuda._fwd(xc, t32, "first")[0].sum() / n
        scale = cot.float() / n
        ce_cuda._bwd(xc, t32, None, scale, 1, "first")

    launches = {}
    for name, fn in (("split", split), ("first", first)):
        per_call = device_launches(fn, reps)
        launches[name] = round(sum(per_call.values()))
        launches[f"{name}_by_kernel"] = per_call
    print(f"train: device launches per fused_cross_entropy forward + "
          f"backward: {launches['split']} (the first designs' chain: "
          f"{launches['first']}); by kernel "
          f"{json.dumps(launches['split_by_kernel'])}")
    return launches


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
        ce_launches = ce_call_launches(dev)

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
        ce_call_launches=ce_launches if dev.type == "cuda" else None,
        step_ms=step_ms, steady_ms_per_step=steady,
        images_per_s=batch / steady * 1e3, losses=losses,
        fixed_batch_step_ms=fixed_ms)


# ---------------------------------------------------------------- phase 7

QUALITY_NETS = os.path.join(ROOT, "data", "quality_nets")


def quality_cfgp(suite: str, labels: str, iters: int = 60):
    """scripts/run_quality_benchmark.py::build_cfgp's settings, with the
    stock warm band and both MLP kernels asked for."""
    import configparser

    cfgp = configparser.ConfigParser()
    cfgp.read_dict({
        "input": {"kitti_path": suite,
                  "css_path": os.path.join(QUALITY_NETS,
                                           "css_quality_v2.msgpack"),
                  "css_width": str(quality_suite.CSS_WIDTH),
                  "deepsdf_path": os.path.join(QUALITY_NETS,
                                               "deepsdf_quality.pt"),
                  "label_type": "gt", "diff_annos": "hard",
                  "grid_density": "40", "rendering_area": "32"},
        "optimization": {"iters": str(iters), "pose_estimator": "kabsch",
                         "precision": "float16", "warm_band": "8192",
                         "warm_refresh": "10", "select_pallas": "True",
                         "stage2_pallas": "True"},
        "visualization": {"viz_type": "none"},
        "losses": {"2d_weight": "0.3", "3d_weight": "0.5"},
        "output": {"labels": labels}})
    return cfgp


# the JAX driver's AP on the same suite on the CPU
# (scripts/quality_jax_cpu.py), one row per frame count
QUALITY_JAX = os.path.join(ROOT, "QUALITY_jax_cpu_v2.json")
AP_BANDS = {"bev_ap": 2.0, "kitti_3d_ap": 5.0}  # points, PERF.md section 2


def hold_against_jax(ap: dict, n_frames: int) -> None:
    """KITTI BEV AP within 2 points and 3D AP within 5 of the JAX driver's
    row with the same frame count, at each difficulty and threshold: the
    bands of PERF.md section 2, a few objects crossing IoU 0.7 on a suite
    of 50 to 150 cars."""
    with open(QUALITY_JAX) as f:
        row = json.load(f)["rows"].get(str(n_frames))
    if row is None:
        print(f"quality: no JAX row for {n_frames} frames in "
              f"{os.path.basename(QUALITY_JAX)}; not held")
        return
    worst = {}
    for key, band in AP_BANDS.items():
        gaps = [abs(a - b) for d in ap[key]
                for a, b in zip(ap[key][d], row[key][d])]
        worst[key] = max(gaps)
        print(f"quality: {key} against the JAX driver on the CPU "
              f"({row['gt_boxes']} cars): port {ap[key]}, JAX {row[key]}, "
              f"largest gap {worst[key]:.4f} points (band {band})")
    assert all(worst[k] <= b for k, b in AP_BANDS.items()), worst


def kitti_phase(dev, out_dir, n_frames: int = 24, iters: int = 60):
    """Build the suite, run the driver over it, evaluate the dumps."""
    suite = os.path.join(out_dir, "quality_suite")
    reset_counts()
    t0 = time.perf_counter()
    meta = quality_suite.build_suite(suite, n_frames, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    built = counts()
    print(f"suite: {meta['frames']} frames, {meta['objects']} cars, tiers "
          f"{meta['difficulty_tiers']}, built in {build_s:.3f} s "
          f"({build_s / n_frames:.3f} s/frame), launches {built}")
    assert meta["frames"] == n_frames
    if dev.type == "cuda":
        assert built["splat_fwd_binned"] > 0

    labels = os.path.join(out_dir, "labels")
    cfgp = quality_cfgp(suite, labels, iters)
    route = pipe.setup_runtime(cfgp, device=dev).stage2_route
    reset_counts()
    t0 = time.perf_counter()
    annos, ests = pipe.refine_css(cfgp, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    dumps = sorted(f for f in os.listdir(labels) if f.endswith(".pkl"))
    n_gt = sum(len(a["location"]) for a in annos.values())
    n_est = sum(len(e["location"]) for e in ests.values())
    print(f"driver: stage 2 {route} (the 3x96 quality decoder is outside "
          f"the packer), {len(dumps)} dumps, {n_gt} crops, {n_est} labels, "
          f"{wall:.3f} s wall (in-process evaluation included), "
          f"{wall / max(n_gt, 1):.3f} s/crop, {n_frames / wall:.4f} "
          f"frames/s, launches {launched}")
    assert len(dumps) == n_frames == len(annos)
    assert n_est >= 0.9 * n_gt
    if dev.type == "cuda":
        assert launched["splat_fwd"] > 0 and launched["nn"] > 0
        assert n_est == n_gt, "every car gets a label"

    t0 = time.perf_counter()
    results = evaluate_dump.evaluate(cfgp, (0, 1, 2), device=dev)
    eval_s = time.perf_counter() - t0
    names = ("easy", "moderate", "hard")

    def per_diff(arr):
        a = np.asarray(arr)
        return {names[d]: [float(v) for v in a[0, d]] for d in range(3)}

    ap = {"kitti_3d_ap": per_diff(results[0]["Box3DAP"]),
          "bev_ap": per_diff(results[0]["BevAP"]),
          "aos_iou": per_diff(results[0]["AosAP_iou"]),
          "nuscenes_3d_ap": per_diff(results[1]["Box3DAP_Nu"])}
    print(f"evaluation: {eval_s:.3f} s; AP per difficulty (at the two "
          f"thresholds) {json.dumps(ap)}")
    if dev.type == "cuda":
        hold_against_jax(ap, n_frames)
    return launched, dict(frames=n_frames, cars=meta["objects"],
                          tiers=meta["difficulty_tiers"], build_s=build_s,
                          driver_s=wall, crops=n_gt, labels=n_est,
                          s_per_crop=wall / max(n_gt, 1),
                          frames_per_s=n_frames / wall, eval_s=eval_s,
                          stage2_route=route, **ap)


# ------------------------------------------------------- --profile (option)

def _kernel_group(name: str) -> str:
    # the port's kernels first; a CUTLASS- or CuTe-built kernel of the
    # port would be named here, and cuBLAS's name a gemm
    for key, group in (("splat_fwd_split_kernel", "splat_fwd"),
                       ("splat_fwd_binned_split_kernel", "splat_fwd"),
                       ("splat_bwd_binned_split_kernel", "splat_bwd"),
                       ("splat_bwd_binned_kernel", "splat_bwd"),
                       ("splat_bins", "splat_bins"),
                       ("splat_fwd_kernel", "splat_fwd"),
                       ("splat_bwd_split_kernel", "splat_bwd"),
                       ("splat_bwd_kernel", "splat_bwd"),
                       ("nn_split_kernel", "nn"),
                       ("nn_kernel", "nn"), ("select_mlp_kernel", "select_mlp"),
                       ("select_wgmma_kernel", "select_mlp"),
                       ("stage2_fwd_wgmma_kernel", "stage2_fwd"),
                       ("stage2_bwd_wgmma_kernel", "stage2_bwd"),
                       ("stage2_kernel", "stage2"),
                       ("dcvec_reduce_kernel", "dcvec_reduce"),
                       ("ce_fwd_split_kernel", "ce_fwd"),
                       ("ce_fwd_kernel", "ce_fwd"),
                       ("ce_bwd_lse_kernel", "ce_bwd"),
                       ("ce_bwd_kernel", "ce_bwd"),
                       ("fprop", "convolution"), ("dgrad", "convolution"),
                       ("wgrad", "convolution"), ("conv", "convolution"),
                       ("cudnn", "convolution"),
                       ("gemm", "matmul"), ("xmma", "matmul"),
                       ("nvjet", "matmul"),
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


def profile_design(rt, prep, label: str, path: str, patches=()) -> None:
    """Profile one more crop of `rt`, with each (module, name, value) of
    `patches` set for it: a wrapper's design choice forced to another
    design."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, value in patches:
        setattr(mod, name, value)
    try:
        rt.run_refine(prep)  # warm-up
        t0 = time.perf_counter()
        rt.run_refine(prep)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        profile_phase(label, lambda: rt.run_refine(prep), wall, rt.cfg.iters,
                      "iteration", path)
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)


def profile_all(out_dir: str, rt512, rt_stage2, prep, state, fixed,
                summary) -> None:
    """--profile: the full-width crop and two train steps on one fixed
    batch under the profiler, the device busy time of each; the full-width
    crop again with the first dense splat forward, and phase 4c's crop with
    the new designs and again with the first designs of the dense splat
    forward and kernel 4b; then the same steps timed with cuDNN's autotuner
    on (set for this measurement only; the port leaves it off)."""
    profile_phase("full-width crop", lambda: rt512.run_refine(prep),
                  summary["full_width_crop"]["wall_s"], rt512.cfg.iters,
                  "iteration", os.path.join(out_dir, "profile.json"))
    first_fwd = (splat_cuda, "_fwd", functools.partial(
        splat_cuda._fwd, kernel=splat_cuda.SPLAT_FWD_FIRST))
    wmma_bwd = (mlp2_cuda, "stage2_bwd_design", lambda packed: "wmma")
    profile_design(rt512, prep, "full-width crop, first splat_fwd",
                   os.path.join(out_dir, "profile_first_splat.json"),
                   [first_fwd])
    first_bwd = (splat_cuda, "_bwd", functools.partial(
        splat_cuda._bwd, kernel=splat_cuda.SPLAT_BWD_FIRST))
    first_nn = (nn_cuda, "nearest_neighbor_fused", functools.partial(
        nn_cuda.nearest_neighbor_fused, kernel=nn_cuda.NN_FIRST))
    profile_design(rt512, prep, "full-width crop, first splat_bwd and nn",
                   os.path.join(out_dir, "profile_first_bwd_nn.json"),
                   [first_bwd, first_nn])
    profile_design(rt_stage2, prep, "4c crop",
                   os.path.join(out_dir, "profile_4c.json"))
    profile_design(rt_stage2, prep, "4c crop, first splat_fwd and wmma 4b",
                   os.path.join(out_dir, "profile_4c_first.json"),
                   [first_fwd, wmma_bwd])
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


def run_paths(dev, out_dir: str, small: bool = False,
              quality_frames: int = 24):
    """Phases 3 to 7, each timed; `small` cuts them to a CPU rehearsal's
    size. Returns what --profile drives again, the launches of each path
    and its summary."""
    tiny = dict(iters=2) if small else {}
    seconds = {}
    t0 = time.perf_counter()
    rt, sample, prep, demo = demo_phase(dev, **tiny)
    seconds["3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt512, full_launched, full = full_width_phase(dev, rt, sample, prep,
                                                  **tiny)
    seconds["4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt_stage2, stage2_launched, stage2 = full_width_stage2_phase(
        dev, rt512, prep, sample, full)
    seconds["4c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    binned_launched, binned = binned_refine_phase(
        dev, rt, sample, prep["anno"], iters=1 if small else 10)
    seconds["4b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    crops_dir, crops_launched, crops = crops_phase(
        dev, out_dir, **(dict(n_crops=4, grid=16, capacity=512) if small
                         else {}))
    seconds["5"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, fixed, train_launched, train = train_phase(
        dev, crops_dir, os.path.join(out_dir, "log"),
        **(dict(width=8, batch=2, epochs=1) if small else {}))
    seconds["6"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kitti_launched, kitti = kitti_phase(
        dev, out_dir, **(dict(n_frames=2, iters=2) if small
                         else dict(n_frames=quality_frames)))
    seconds["7"] = time.perf_counter() - t0
    print(f"phase seconds: {json.dumps(seconds)}")
    launched = {"full_width": full_launched, "binned_refine": binned_launched,
                "crops": crops_launched, "train": train_launched,
                "full_width_stage2": stage2_launched, "kitti": kitti_launched}
    summary = {"demo_crop": demo, "full_width_crop": full,
               "full_width_stage2": stage2, "binned_refine": binned,
               "crops": crops, "train": train, "kitti_driver": kitti,
               "phase_seconds": seconds}
    handles = dict(rt512=rt512, rt_stage2=rt_stage2, prep=prep, state=state,
                   fixed=fixed)
    return handles, launched, summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse-cpu", action="store_true")
    ap.add_argument("--quality-frames", type=int, default=24,
                    help="frames of the v2 quality suite phase 7 builds and "
                         "labels (72: all of them)")
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
    for line in ptxas_report(logs):
        print(line)
    card = gpu_line()
    print(f"card: {card}")

    t0 = time.perf_counter()
    rows = (check_splat(dev) + [check_nn(dev), check_select(dev)]
            + check_splat_binned(dev) + check_ce(dev) + check_stage2(dev))
    print(f"phase 2: {time.perf_counter() - t0:.1f} s")
    for row in rows:
        alone = row.get("kernel_ms")
        print(f"bound share {row['name']}: bound {row['bound_ms']:.5f} ms, "
              f"{row['ms']:.4f} ms a call ({row['bound_ms'] / row['ms']:.1%})"
              + (f", {alone:.4f} ms alone ({row['bound_ms'] / alone:.1%})"
                 if alone else ""))
    with tempfile.TemporaryDirectory() as out_dir:
        handles, launched, summary = run_paths(
            dev, out_dir, quality_frames=args.quality_frames)
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
