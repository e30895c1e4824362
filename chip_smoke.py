"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Eleven phases and their parts; any failure exits non-zero and no phase's
error is caught
(phase 8 alone halves its batch on running out of card memory, and says
so).

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
   and footprint pairs. The DeepSDF trainer's bias, ReLU and dropout
   kernels at 1,048,576 rows of 512 and of 506 columns: y and the
   gradient of z bit-equal to PyTorch's chain on the same masks (and, at
   512, to the plain version on the same uniforms), the
   bias's gradient within its order's fp32 round-off, two launches
   bit-equal; each direction timed a call and alone beside the plain
   version and the chain. Every row prints its share of its bound. Then
   the crop axis: kernels 1a, 1b, 2 and 3 each launched once for 4 crops of
   the main path's shapes, held against their plain versions crop by crop
   and bit-equal to 4 single-crop launches, timed alone beside those 4
   launches and beside one crop's; the same for kernels 4a and 4b (8192
   points a crop through the 8x512 stack) and the binned trio (the bins,
   1c, 1d: 4096 surfels a crop on 128x128 px, the last crop all masked as
   a padded lane, whose bins, image and gradients must be empty), the
   batched bins also equal to compute_bins with a crop axis. Kernel 3 at
   the coarse cells' shapes:
   the 9261-point corner lattice and 16384 cell points a crop, one crop
   and four, against the plain version; the cells the card ranks, ties in
   index order, equal to the CPU's ranking.
3. The demo driver: ``refine_css_demo`` on the bundled data/optimization
   assets with configs/config_demo.ini (viz off); the labels must land on
   the ground-truth annotation, the splat and NN kernels must have run,
   and no computation on the path may take CPU tensors. (3b) The stock
   demo command as written (viz_type 3d, the output directory moved to a
   temporary one): every PNG must decode and hold nonzero pixels, every
   HTML scene its point sets, kernels 1a and 2 must launch inside
   ``render_trajectory`` once per drawn iteration, and the labels must
   equal phase 3's to 1e-6; the viz wall is printed apart. (3c) The demo
   crop with ``pose_estimator = pnp`` (ops/pnp.py on the card, no CPU
   operator; its reprojection RMS) and with ``select_bf16``, labels beside
   phase 3's.
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
   the first designs' chain; (4d) the batched driver's refine of four
   crops at once (``refine_crops_batched``): phase 3's crop and three made
   from it (yaw +-0.2 rad, translation +0.3 m, one NOCS target cut smaller
   so that it letterboxes) under phase 4's runtime; each crop's
   parameters must track that crop refined alone within 1e-3 at every
   iteration and its label land within 1e-3 of the crop alone's (printed
   beside the crop alone from a start moved by 1e-6), and kernels 1a, 1b,
   2 and 3 must launch for the batch exactly as often as for phase 4's one
   crop; ms/iteration, s/crop and device launches per iteration beside
   phase 4's; (4e) phase 4's crop with ``warm_refresh_cells = 2048``, then
   with ``coarse_cells = 2048`` (the warm band off), and 4d's four crops
   with ``warm_refresh_cells``: kernel 3 launches twice a refresh (or an
   iteration), on the shared corner lattice and on the cells' points,
   once for all four crops; ms/iteration and labels beside phase 4's;
   (4f) 4d's four crops with ``stage2_pallas = True``: kernels 4a and 4b
   launch 60 times for the four crops, each crop tracks itself refined
   alone with the stage-2 kernels within 1e-3 at every iteration and in
   the label, s/crop beside 4c's; (4g) the same four crops prepared at
   ``rendering_area = 96``, whose bucket takes the binned route, for 10
   iterations: the bins, 1c and 1d launch once an iteration for the four,
   and each crop tracks itself alone within 1e-3. (4h) The rays axis
   (parallel/sharded_refine.py over parallel/mesh.py): phase 4's crop and
   runtime, every kernel built before the ranks are spawned; one NCCL
   rank (rays = 1) must give phase 4's first loss within 1e-5 relative,
   and two gloo ranks sharing the card (rays = 2: each decodes half the
   grid through kernel 3, a slice of the band, and renders half the
   pixel rows through 1a and 1b) the first two losses of the one rank
   within 1e-4 relative, kernels 1a, 1b, 2 and 3 launched on each rank;
   the label gap beside 4d's lanes'. 4h, binned, in the same spawns: the
   rays render of 4096 seeded surfels at 128x96 px (6144 px a block on
   two ranks, the row-binned route) with the gradients of sum(image^2),
   against the unsharded render on the card (the image within 1e-5, the
   gradients within 1e-4 of their largest element), and phase 4b's crop
   (rendering area 96, the demo decoder) refined for 10 iterations over
   the rays axis: the first loss on one rank within 1e-5 relative of
   phase 4b's, the first two on two ranks within 1e-4 of one rank's; the
   bins, 1c and 1d launched on every rank. (4i, in the same spawn) 4d's four
   crops through ``make_batched_refine(mesh=)`` with data = 2, two lanes
   a rank: labels within 1e-3 of 4d's (bit-equality expected and
   printed).
9. The renderer demo (run after 4i): ``render_sdf`` of
   data/optimization/deepsdf_demo.pt at 200x100 px with the disc (the
   bins kernel and 1c), circle and stamped-circle primitives, each
   without and with a background image, and ``render_model`` of a seeded
   ball: every image on the card within the splat tolerance of the
   CPU's.
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
   the first designs' wrapper chain. The stock ``fast_input = False``:
   the batches take the PIL augmentation chain on the card. (6b) The same
   at ``precision = bfloat16`` (bf16 convolutions on fp32 parameters):
   finite losses, 3 fixed-batch steps lower the loss, the CE kernels on
   every tower; one bf16 step on the card (two batches of 2 crops, seeded
   init) within twice the CPU's own bf16-vs-fp32 gap of the same step on
   the CPU, and its forward nearer the CPU's bf16 forward than its fp32
   one (bf16_card_vs_cpu); ms/step beside phase 6's. (6c) The fused-head net
   (``css_fused.fused_from_css`` of phase 6's network): eval outputs
   within 2e-4 of each output's scale of the unfused net's, then 2 train
   steps with the CE kernels, ms/step. (6d, after phase 8) The
   data-parallel CSS step (``parallel/mesh.py``, spawned ranks): one rank
   on NCCL equal to the plain step bit for bit; two ranks sharing the card
   over gloo, 6 crops each, against one rank's step on the 12: loss,
   statistics and the parameters where |g| >= 1e-5 within 1e-5 (all
   parameters within 2 lr), gradients within 1e-3 relative in L2
   (with two or more cards, also two NCCL ranks, one card each). (6e)
   ``fast_input = True``: one epoch of ``train_css`` through the fast
   augmentation chain, and both chains on the card against the CPU.
7. The KITTI driver: ``tools/quality_suite.py`` builds the first 24 frames
   of the v2 quality suite (``--quality-frames 72``: all of it) through
   the binned splat kernel; ``refine_css`` labels them as ``main.py
   --refine`` does, batched (the settings of
   scripts/run_quality_benchmark.py, 60 iterations, float16, the stock
   warm band, the committed quality nets), then once more one crop after
   another (``batched=False``), and ``evaluate_dump.evaluate`` scores each
   run's dumps: KITTI and nuScenes AP per difficulty. In both runs every
   car must get a label, and the BEV and 3D AP must lie within 2 and 5
   points of the JAX driver's on the same frames
   (QUALITY_jax_cpu_v2.json, written by scripts/quality_jax_cpu.py).
8. DeepSDF training (run after phase 6): ``train_deepsdf`` on an
   experiment of 128 analytic scenes (sample_analytic_sdf) through the
   reference 8x512 decoder with dropout 0.2 on every layer, at the
   reference batch of 64 scenes x 16384 samples (1,048,576 rows a step),
   2 epochs of 2 steps: ms/step, rows/s and peak memory; the loss finite
   and lower at the last step than at the first; no
   CPU operator in the first two steps; one step on the card against the
   same step on the CPU (the same state and drawn rows of 8 scenes,
   dropout off) within 1e-5; the exported deepsdf.pt reloaded by
   load_torch_checkpoint to SDFs within 1e-6. (8b) ``train_deepsdf(mesh=)``
   on a one-rank NCCL mesh equal to phase 8's run bit for bit; two gloo
   ranks on the card, each 8 of a cut batch of 16 scenes x 16384 rows
   (two full-batch ranks would need ~77 GiB), from phase 8's state,
   against one rank's step: loss within 1e-6 relative, state within rtol
   2e-5 / atol 1e-7.
10. The quality suite's nets remade (run after phase 7):
   ``tools/quality_suite.py`` fits its 4-shape 3x96 DeepSDF for 300
   steps, builds 4 v1 frames from the fitted decoder (each car's 320^2
   render through the bins kernel and 1c) and trains the suite CSS net
   for 20 steps at width 16, batch 8 (the script's own loss: four
   cross-entropies through kernel 5, forward and backward, and 10 x the
   latent MSE), everything under the run's temporary directory. Every
   number finite, the L1 and the loss falling, the fitted decoder's L1
   on a fixed point set below its initial one; one fit step card against
   CPU (parameters within 1e-5, the L1 within 1e-6 relative) and one CSS
   step from the seeded init (loss within 1e-4 relative, >= 99.5% of the
   parameters within 1e-5 and all within 2 lr, the statistics within
   1e-4 / 1e-5); the written nets read back by the driver's loaders
   equal to the trained ones.
11. The demo's assets remade (run after phase 10): ``tools/demo_assets.py``
   at JAX's defaults but for the CSS steps (2500 fit steps of the 3x64
   decoder, the scene rendered through the bins kernel and 1c, 500 of
   JAX's 800 CSS steps at width 8, batch 4 through kernel 5) under the
   run's temporary directory. The
   scene's crop box, visible points, NOCS image and label against the same
   scene on the CPU from the fitted decoder; one fit step and one CSS
   step card against CPU (phase 10's criteria); the assets read back by
   the driver's loaders equal to what was made; ``refine_css_demo`` on
   them for 60 iterations: the label within phase 3's criterion of the
   remade ground truth (location < 0.1 m, yaw < 0.05 rad).

Each kernel's launches are counted on the path that runs it (set to 0
just before the path, read just after): the dense splat, NN and selection
kernels in phase 4, the stage-2 kernels in 4c, the binned backward in 4b,
the bins and the binned forward in 5, the bias, ReLU and dropout kernels
in 8 and the CE kernels in 6 (and in
6b and 6c, given under ``launches_by_path``, with the bins and 1c on
phase 10's v1 frames, ``suite_v1``, and the CE kernels on its CSS
training, ``suite_css``; the bins, 1c and the CE kernels on phase 11's
remake, ``demo_assets``); the
record of each crop-axis kernel also gives its launches in 4d (4f for
4a and 4b, 4g for the binned trio), and
``launches_by_path`` those on the paths of 3b (the viz), 4e and 9, and
by rank those of the rays axis (4h, the binned trio included) and the
data axis (4i). The line
before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without a card
the script exits 2 and prints no result. ``--profile DIR`` adds one more
full-width crop, phase 4d's four crops and two train steps under
torch.profiler: device time by
kernel group, the device busy time and its share of the wall time, and
DIR/profile.json and DIR/profile_train.json with every kernel; the same
crop once more with the first dense splat forward, once with the first
designs of the dense splat backward and the nearest neighbour, and phase
4c's crop
with the new designs and with the first splat forward and the wmma 4b,
for comparison; then the train step timed with cuDNN's autotuner on. ``--rehearse-cpu`` runs phases
3 to 11 on the CPU at a tiny size (2 iterations, 2 suite frames) with the
kernels' plain versions, then exits 3 without a result: a dry run of the
control flow for machines without a card (4d, 4h and 4i included).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import os
import re
import shutil
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
from sdflabel_tpu_torch.data import sdf_samples  # noqa: E402
from sdflabel_tpu_torch.engine import css_train  # noqa: E402
from sdflabel_tpu_torch.engine import deepsdf_train  # noqa: E402
from sdflabel_tpu_torch.engine import labels as labels_mod  # noqa: E402
from sdflabel_tpu_torch.engine import refine as refine_mod  # noqa: E402
from sdflabel_tpu_torch.models import css as css_mod  # noqa: E402
from sdflabel_tpu_torch.models import css_fused  # noqa: E402
from sdflabel_tpu_torch.models import deepsdf  # noqa: E402
from sdflabel_tpu_torch.ops import (  # noqa: E402
    _cuda, ce_cuda, dropout_cuda, grid as grid_ops, knn, mlp2_cuda,
    mlp_cuda, nn_cuda, splat, splat_cuda)
from sdflabel_tpu_torch.parallel import batched_refine  # noqa: E402
from sdflabel_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from sdflabel_tpu_torch.parallel import rays as rays_mod  # noqa: E402
from sdflabel_tpu_torch.parallel import sharded_refine  # noqa: E402
from sdflabel_tpu_torch.pipelines import evaluate_dump  # noqa: E402
from sdflabel_tpu_torch.pipelines import make_crops as crops_pipe  # noqa: E402
from sdflabel_tpu_torch.pipelines import refine_css as pipe  # noqa: E402
from sdflabel_tpu_torch.pipelines import render_demo  # noqa: E402
from sdflabel_tpu_torch.pipelines import train_css as train_pipe  # noqa: E402
from sdflabel_tpu_torch.pipelines import train_deepsdf as dsdf_pipe  # noqa: E402
from sdflabel_tpu_torch.renderer import rasterer  # noqa: E402
from sdflabel_tpu_torch.tools import demo_assets  # noqa: E402
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
    # the port's own kernels: JAX computes the train-mode layer's bias,
    # ReLU and dropout in XLA (sdflabel_tpu/models/deepsdf.py)
    "brd_fwd": (dropout_cuda.BRD_FWD,
                "sdflabel_tpu_torch/csrc/bias_relu_dropout.cu",
                "sdflabel_tpu/models/deepsdf.py:apply_sdf"),
    "brd_bwd": (_cuda.KernelGroup(bwd=dropout_cuda.BRD_BWD,
                                  reduce=dropout_cuda.BRD_REDUCE),
                "sdflabel_tpu_torch/csrc/bias_relu_dropout.cu",
                "sdflabel_tpu/models/deepsdf.py:apply_sdf"),
}
# the path whose run gives each kernel's launches
PATHS = {"splat_fwd": "full_width", "splat_bwd": "full_width",
         "nn": "full_width", "select_mlp": "full_width",
         "splat_bwd_binned": "binned_refine", "splat_fwd_binned": "crops",
         "splat_bins": "crops",
         "ce_fwd": "train", "ce_bwd": "train",
         "stage2_fwd": "full_width_stage2", "stage2_bwd": "full_width_stage2",
         "brd_fwd": "deepsdf_train", "brd_bwd": "deepsdf_train"}
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
                                   "nn_split_kernel", "brd_fwd_kernel",
                                   "brd_bwd_kernel", "brd_reduce_kernel"):
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


# kernel name -> profiler captures kernel_ms needed, where more than one
EMPTY_CAPTURES: dict = {}


def kernel_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device time of one launch of the kernel whose name contains
    `kernel`, without the wrapper's host work: the mean of the profiler's
    kernel times over `reps` calls of `fn` (the profiler may drop a few
    of the launches; the mean is over those it recorded; a capture that
    recorded none is taken again, up to three times, printed and kept in
    EMPTY_CAPTURES)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for capture in range(1, 4):  # CUPTI has dropped every record of one
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        count = sum(e.count for e in hits)
        if count:
            break
    if capture > 1:
        EMPTY_CAPTURES[kernel] = capture
        print(f"kernel_ms {kernel}: {capture} profiler captures, the first "
              f"{capture - 1} with no launch recorded")
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
            1, 0, n, H, nh, int(packed.use_tanh), _cuda.ptr(out),
            _cuda.stream(pts))

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


def check_select_cells(dev) -> dict:
    """Kernel 3 at the coarse cells' shapes through the 8x512 decoder: the
    corner lattice of grid 40 ((40/2+1)^3 = 9261 points shared by every
    crop) and the points of CELLS cells (16384 a crop), for one crop and
    four, against the plain version with kernel 3's limits. The cells
    ranked on the card from the plain version's scores must equal the
    CPU's ranking, ties (every crossed cell scores 0) in index order; the
    candidates from the kernel's corner values must equal those from the
    plain version's, but for cells whose plain score lies within the
    kernel's largest error of the cut-off (or of a sign change). One launch
    at each shape timed (the latent absorbed) beside its bound."""
    cfg, params = decoder_8x512(dev)
    packed = mlp_cuda.pack_select_mlp(
        cfg, deepsdf.cast_params(params, torch.bfloat16))
    pts = grid_ops.generate_point_grid(40, device=dev)
    lattice = pts[torch.as_tensor(grid_ops._cell_corner_lattice_np(40, 2)[0],
                                  device=dev, dtype=torch.long)].contiguous()

    def kernel(lat, p):
        return mlp_cuda.select_mlp_apply(packed, lat, p)

    def plain(lat, p):
        return mlp_cuda.emulate_select_mlp(packed, lat, p)

    rng = np.random.RandomState(12)
    H, nh = packed.width, packed.n_hidden
    out = {"cells": CELLS, "lattice_points": lattice.shape[0]}
    for b in (1, 4):
        lat = torch.nn.functional.normalize(torch.as_tensor(
            rng.randn(b, 3).astype(np.float32), device=dev), dim=-1)
        cand = grid_ops._coarse_cell_candidates(plain, lat, pts, 2, CELLS,
                                                8192)
        cpts = pts[cand].contiguous()
        assert cpts.shape == (b, 8 * CELLS, 3)
        worst = 0.0
        for shape, p in (("lattice", lattice), ("cells", cpts)):
            got, want = kernel(lat, p), plain(lat, p)
            err = (got - want).abs()
            print(f"select_mlp, {shape} ({b} crops x {p.shape[-2]} "
                  f"points): max_abs_err {float(err.max()):.3g} (need < "
                  f"1e-3), median {float(err.median()):.3g} (need < 1e-5)")
            assert float(err.max()) < 1e-3 and float(err.median()) < 1e-5
            worst = max(worst, float(err.max()))
            cvec = mlp_cuda._cvec(packed, lat).contiguous()
            n = p.shape[-2]
            own = b if p.dim() == 3 else 1
            bnd = bound(own * n * 12 + nh * H * H * 2 + b * n * 4,
                        2 * b * n * nh * H * H, BF16_TENSOR_FLOPS)
            out[f"{shape}_b{b}"] = dict(
                points=n, crops=b, max_abs_err=float(err.max()),
                ms=time_ms(lambda: mlp_cuda.select_fwd(packed, cvec, p)),
                kernel_ms=kernel_ms(lambda: mlp_cuda.select_fwd(
                    packed, cvec, p), "select_wgmma_kernel"),
                plain_ms=time_ms(lambda: plain(lat, p), reps=5),
                bound_ms=bnd[0], bound_by=bnd[1])
            row = out[f"{shape}_b{b}"]
            print(f"select_mlp, {shape} ({b} x {n}): {row['ms']:.4f} ms a "
                  f"call, {row['kernel_ms']:.4f} ms alone, bound "
                  f"{row['bound_ms']:.4f} ms ({bnd[2]}), plain "
                  f"{row['plain_ms']:.3f} ms")
        # the ranking on the card against the CPU's, from the same scores
        score = grid_ops.cell_scores(plain, lat, pts, 2)
        got_rank = grid_ops._smallest(score, CELLS)[1]
        want_rank = grid_ops._smallest(score.cpu(), CELLS)[1]
        zeros = int((score == 0).sum())
        assert torch.equal(got_rank.cpu(), want_rank), "tie order"
        # the cells the kernel's corner values keep
        kept = grid_ops._smallest(grid_ops.cell_scores(kernel, lat, pts, 2),
                                  CELLS)[1]
        cut = torch.sort(score, -1).values[:, CELLS - 1]
        differ = [(i, c) for i in range(b) for c in set(
            got_rank[i].tolist()) ^ set(kept[i].tolist())]
        borderline = all(abs(float(score[i, c] - cut[i])) <= 2 * worst
                         or float(score[i, c]) <= worst for i, c in differ)
        out[f"candidates_b{b}"] = dict(crossed_cells=zeros,
                                       differing_cells=len(differ),
                                       tie_order_equal=True)
        print(f"select_mlp, cells ({b} crops): {zeros} cells crossed (score "
              f"0); the card's ranking of the plain scores equals the "
              f"CPU's, ties included; the kernel's candidates differ from "
              f"the plain version's in {len(differ)} cells (each within "
              f"the kernel's error of the cut-off: {borderline})")
        assert borderline
    return out


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


# ------------------------------------------------- phase 2, the crop axis

CROPS = 4  # crops of the batched checks and of phase 4d


def crop_axis_record(name, b, batched, singles, one, err, same, kernel,
                     **extra) -> dict:
    """Time `batched` (one launch of all b crops), `singles` (a launch per
    crop) and `one` (crop 0 alone) by the device time of the kernels whose
    names contain each of `kernel` (a name or a tuple of names, summed),
    and a call of each; print the record and fail unless `same` (each crop
    bit-equal to its single launch)."""
    names = (kernel,) if isinstance(kernel, str) else kernel

    def alone(fn):
        return sum(kernel_ms(fn, k) for k in names)

    b_ms, one_ms, singles_ms = alone(batched), alone(one), alone(singles) * b
    rec = dict(crops=b, max_abs_err=err, bit_equal=same, kernel_ms=b_ms,
               singles_kernel_ms=singles_ms, b1_kernel_ms=one_ms,
               ms=time_ms(batched), singles_ms=time_ms(singles), **extra)
    print(f"crop axis {name}: B = {b} in one launch {b_ms:.4f} ms alone "
          f"({rec['ms']:.4f} a call), {b} single launches "
          f"{singles_ms:.4f} ms alone ({rec['singles_ms']:.4f} a call), "
          f"B = 1 {one_ms:.4f} ms alone; max_abs_err {err:.3g} against the "
          f"plain version, bit-equal to single launches: {same}")
    assert same
    return rec


def check_crop_axis(dev) -> dict:
    """Kernels 1a, 1b, 2 and 3 at B = 4 crops of the main path's shapes
    (8192 surfels onto 32x32 px with each crop's own intrinsics; 8192 x
    8192 NN; the 64000-point grid ranked for four latents): each launch of
    four crops held against its plain version crop by crop (the
    single-crop tolerances) and bit-equal to four single-crop launches;
    timed alone (`kernel_ms`, the profiler's device time) beside the four
    single launches and the B = 1 launch. Returns {kernel: record}."""
    b, n, res = CROPS, 8192, (32, 32)
    rng = np.random.RandomState(10)
    pts = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    pts[..., 2] += 4.0 + 0.5 * np.arange(b)[:, None]
    nrm = rng.randn(b, n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    feats = rng.uniform(0, 1, (b, n, 8)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.4
    Ks = np.stack([rasterer.calibration_matrix(res) for _ in range(b)])
    Ks[:, 0, 2] += 0.5 * np.arange(b)
    pts, nrm, feats, mask = (torch.as_tensor(a, device=dev)
                             for a in (pts, nrm, feats, mask))
    kg = splat.kinv_pixel_rays(torch.as_tensor(Ks, device=dev),
                               splat.pixel_grid(*res, device=dev))
    out = {}

    def record(name, *args, **kw):
        out[name] = crop_axis_record(name, b, *args, **kw)

    # 1a and 1b: the packed inputs, as the autograd Function builds them
    pk = splat_cuda._pack_points(pts, nrm, mask)
    fk = feats.contiguous()
    kg4 = splat_cuda._pack_rays(kg)
    img, m, d, zn = splat_cuda._fwd(pk, fk, kg4, 0.04, 150.0)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(3)
                    ).to(dev)
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[..., None], d[..., None], zn[..., None], corr, g],
                    -1).contiguous()
    grads = splat_cuda._bwd(pk, fk, pix, 0.04, 150.0)
    crops = [[t[i].contiguous() for t in (pk, fk, kg4, pix)]
             for i in range(b)]
    fwd_same = bwd_same = True
    for i, (p_i, f_i, k_i, x_i) in enumerate(crops):
        fwd_same &= all(torch.equal(a[i], c) for a, c in zip(
            (img, m, d, zn), splat_cuda._fwd(p_i, f_i, k_i, 0.04, 150.0)))
        bwd_same &= all(torch.equal(a[i], c) for a, c in zip(
            grads, splat_cuda._bwd(p_i, f_i, x_i, 0.04, 150.0)))
    # against the plain version through autograd, crop by crop
    args_k = [t.clone().requires_grad_(True) for t in (pts, nrm, feats)]
    img_k = splat_cuda.surfel_composite(*args_k, kg, mask)
    gk = torch.autograd.grad(img_k, args_k, g)
    fwd_err = bwd_err = 0.0
    for i in range(b):
        args_p = [t[i].clone().requires_grad_(True)
                  for t in (pts, nrm, feats)]
        img_p = splat.surfel_composite_dense(*args_p, kg[i], mask[i])
        gp = torch.autograd.grad(img_p, args_p, g[i])
        e_f, e_b = splat_agreement(f"crop axis splat, crop {i}", img_k[i],
                                   img_p, [t[i] for t in gk], gp)
        fwd_err, bwd_err = max(fwd_err, e_f), max(bwd_err, e_b)
    record("splat_fwd", lambda: splat_cuda._fwd(pk, fk, kg4, 0.04, 150.0),
           lambda: [splat_cuda._fwd(*c[:3], 0.04, 150.0) for c in crops],
           lambda: splat_cuda._fwd(*crops[0][:3], 0.04, 150.0), fwd_err,
           fwd_same, kernel="splat_fwd_split_kernel")
    record("splat_bwd", lambda: splat_cuda._bwd(pk, fk, pix, 0.04, 150.0),
           lambda: [splat_cuda._bwd(c[0], c[1], c[3], 0.04, 150.0)
                    for c in crops],
           lambda: splat_cuda._bwd(crops[0][0], crops[0][1], crops[0][3],
                                   0.04, 150.0), bwd_err, bwd_same,
           kernel="splat_bwd_split_kernel")

    # 2: 8192 rendered x 8192 frustum points a crop, ties on a lattice
    q = torch.as_tensor(rng.randint(-8, 9, (b, n, 3)).astype(np.float32)
                        * 0.25, device=dev)
    dd = torch.as_tensor(rng.randint(-8, 9, (b, n, 3)).astype(np.float32)
                         * 0.25, device=dev)
    dm = torch.as_tensor(rng.uniform(size=(b, n)) > 0.3, device=dev)
    d2, idx = nn_cuda.nearest_neighbor_fused(q, dd, dm)
    same, err = True, 0.0
    for i in range(b):
        d2_i, idx_i = nn_cuda.nearest_neighbor_fused(q[i], dd[i], dm[i])
        dp, ip = knn.nearest_neighbor_plain(q[i], dd[i], dm[i])
        same &= (torch.equal(d2[i], d2_i) and torch.equal(idx[i], idx_i)
                 and torch.equal(idx[i], ip))
        err = max(err, float((d2[i] - dp).abs().max()))
    assert err == 0.0  # tolerance: none
    record("nn", lambda: nn_cuda.nearest_neighbor_fused(q, dd, dm),
           lambda: [nn_cuda.nearest_neighbor_fused(q[i], dd[i], dm[i])
                    for i in range(b)],
           lambda: nn_cuda.nearest_neighbor_fused(q[0], dd[0], dm[0]), err,
           same, kernel="nn_split_kernel")

    # 3: the refresh ranks the same grid for every crop's latent
    cfg, params = decoder_8x512(dev)
    packed = mlp_cuda.pack_select_mlp(
        cfg, deepsdf.cast_params(params, torch.bfloat16))
    grid_pts = grid_ops.generate_point_grid(40, device=dev)
    lat = torch.nn.functional.normalize(torch.as_tensor(
        rng.randn(b, 3).astype(np.float32), device=dev), dim=-1)
    cvec = mlp_cuda._cvec(packed, lat).contiguous()
    sel = mlp_cuda.select_fwd(packed, cvec, grid_pts)
    plain = mlp_cuda.emulate_select_mlp(packed, lat, grid_pts)
    cvecs = [cvec[i].contiguous() for i in range(b)]
    same = all(torch.equal(sel[i], mlp_cuda.select_fwd(packed, c, grid_pts))
               for i, c in enumerate(cvecs))
    errs = (sel - plain).abs()
    print(f"crop axis select_mlp: max_abs_err {float(errs.max()):.3g} (need "
          f"< 1e-3), median {float(errs.median()):.3g} (need < 1e-5)")
    assert float(errs.max()) < 1e-3 and float(errs.median()) < 1e-5
    record("select_mlp", lambda: mlp_cuda.select_fwd(packed, cvec, grid_pts),
           lambda: [mlp_cuda.select_fwd(packed, c, grid_pts) for c in cvecs],
           lambda: mlp_cuda.select_fwd(packed, cvecs[0], grid_pts),
           float(errs.max()), same, kernel="select_wgmma_kernel")
    return out


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
            1, n, H, nh, int(packed.use_tanh), _cuda.ptr(out4),
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


def check_crop_axis_stage2_binned(dev) -> dict:
    """The crop axis of kernels 4a and 4b (8192 points a crop through the
    8x512 stack, a latent a crop) and of the binned trio (the bins, 1c,
    1d: crop_scene's 4096 surfels on 128x128 px, each crop's surface moved
    by its own offset, the last crop all masked as a padded lane) at B =
    4: one launch of all crops bit-equal to four single-crop launches and
    each crop within the standing tolerances of its plain version
    (mlp2_cuda.stage2_agreement; the windowed plain composite), the
    batched bins equal to compute_bins with a crop axis; timed alone
    beside the four single launches and one crop's. Returns {kernel:
    record}."""
    b, out = CROPS, {}
    cfg, params = decoder_8x512(dev)
    packed = mlp_cuda.pack_select_mlp(
        cfg, deepsdf.cast_params(params, torch.bfloat16))
    n = 8192
    rng = np.random.RandomState(13)
    pts = torch.as_tensor(rng.uniform(-1, 1, (b, n, 3)).astype(np.float32),
                          device=dev)
    ct = torch.as_tensor(rng.randn(b, n).astype(np.float32), device=dev)
    lat = torch.nn.functional.normalize(torch.as_tensor(
        rng.randn(b, 3).astype(np.float32), device=dev), dim=-1)
    cvec = mlp_cuda._cvec(packed, lat).contiguous()
    fwd = mlp2_cuda.stage2_fwd(packed, cvec, pts)
    dcvec, dpts = mlp2_cuda.stage2_bwd(packed, cvec, pts, ct)
    singles = [(cvec[i].contiguous(), pts[i].contiguous(),
                ct[i].contiguous()) for i in range(b)]
    fwd_same = all(torch.equal(fwd[i], mlp2_cuda.stage2_fwd(packed, c, p))
                   for i, (c, p, _) in enumerate(singles))
    bwd_same = True
    fwd_err = bwd_err = 0.0
    for i, (c, p, t) in enumerate(singles):
        dc1, dp1 = mlp2_cuda.stage2_bwd(packed, c, p, t)
        bwd_same &= torch.equal(dcvec[i], dc1) and torch.equal(dpts[i], dp1)
        cv = c.clone().requires_grad_(True)
        pp = p.clone().requires_grad_(True)
        sdf = mlp2_cuda.stage2_plain(packed, cv, pp)
        (g,) = torch.autograd.grad(sdf.sum(), pp, retain_graph=True)
        dcv_p, dp_p = torch.autograd.grad(sdf, (cv, pp), t)
        shares, medians = mlp2_cuda.stage2_agreement(
            fwd[i, :, 0], sdf.detach(), (
                ("normals", fwd[i, :, 1:], g), ("d_points", dpts[i], dp_p),
                ("d_cvec", dcvec[i].reshape(-1, 1), dcv_p.reshape(-1, 1))))
        print(f"crop axis stage2, crop {i}: shares {shares}, medians "
              f"{medians} (mlp2_cuda.stage2_agreement's limits)")
        assert shares["sdf"] >= 0.995 and medians.pop("sdf") <= 1e-6
        assert min(shares.values()) >= 0.98 and max(medians.values()) <= 1e-4
        fwd_err = max(fwd_err, float((fwd[i, :, 0] - sdf.detach()).abs()
                                     .max()),
                      float((fwd[i, :, 1:] - g).abs().max()))
        bwd_err = max(bwd_err, float((dpts[i] - dp_p).abs().max()),
                      float((dcvec[i] - dcv_p).abs().max()))
    out["stage2_fwd"] = crop_axis_record(
        "stage2_fwd", b, lambda: mlp2_cuda.stage2_fwd(packed, cvec, pts),
        lambda: [mlp2_cuda.stage2_fwd(packed, c, p) for c, p, _ in singles],
        lambda: mlp2_cuda.stage2_fwd(packed, *singles[0][:2]), fwd_err,
        fwd_same, "stage2_fwd_wgmma_kernel")
    out["stage2_bwd"] = crop_axis_record(
        "stage2_bwd", b, lambda: mlp2_cuda.stage2_bwd(packed, cvec, pts, ct),
        lambda: [mlp2_cuda.stage2_bwd(packed, *c) for c in singles],
        lambda: mlp2_cuda.stage2_bwd(packed, *singles[0]), bwd_err,
        bwd_same, ("stage2_bwd_wgmma_kernel", "dcvec_reduce_kernel"))

    # the binned trio: 4096 surfels a crop onto 128x128 px
    v, nrm, feats, mask, kg = crop_scene(dev)
    shift = torch.tensor([[0.0, 0.0, 0.0], [0.02, 0.0, 0.0],
                          [0.0, -0.03, 0.0], [0.0, 0.0, 0.05]], device=dev)
    vb = (v[None] + shift[:, None]).contiguous()
    nb_, fb = (t[None].expand(b, *t.shape).contiguous() for t in (nrm, feats))
    mb = mask[None].expand(b, -1).clone()
    mb[b - 1] = False  # a padded lane
    kgb = kg[None].expand(b, *kg.shape).contiguous()
    p = kg.shape[0]
    bin_px = splat_cuda.bin_policy(p)
    assert bin_px == 512
    n_rows = -(-p // bin_px)
    pk = splat_cuda._pack_points(vb, nb_, mb)
    kg4 = splat_cuda._pack_rays(kgb)
    sb = splat_cuda._sort_bins(pk, fb, kg4, 0.04, bin_px)
    img, m, d, zn = splat_cuda._fwd_binned(sb.pts, sb.feats, kg4, sb.win,
                                           bin_px, 0.04, 150.0)
    g = torch.randn(img.shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(14))
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[..., None], d[..., None], zn[..., None], corr, g],
                    -1).contiguous()
    grads = splat_cuda._bwd_binned(sb.pts, sb.feats, pix, sb.key, sb.smax,
                                   sb.order, bin_px, 0.04, 150.0)
    want = splat_cuda.compute_bins(pk, kg4, 0.04, bin_px)
    bins_plain = (torch.equal(sb.order.long(), want.order)
                  and torch.equal(sb.key.long(), want.key)
                  and torch.equal(sb.smax.long(), want.smax)
                  and torch.equal(sb.win[..., 0].long(), want.start)
                  and torch.equal((sb.win[..., 1] - sb.win[..., 0]).long(),
                                  want.count))
    one = [[t[i].contiguous() for t in (pk, fb, kg4, pix)] for i in range(b)]
    sbs = [splat_cuda._sort_bins(o[0], o[1], o[2], 0.04, bin_px) for o in one]
    bins_same = all(
        torch.equal(getattr(sb, f)[i] if f != "smax" else sb.smax[i:i + 1],
                    getattr(s1, f))
        for i, s1 in enumerate(sbs) for f in s1._fields)
    fwd_same = all(torch.equal(a[i], c) for i, (o, s1) in enumerate(
        zip(one, sbs)) for a, c in zip((img, m, d, zn), splat_cuda._fwd_binned(
            s1.pts, s1.feats, o[2], s1.win, bin_px, 0.04, 150.0)))
    bwd_same = all(torch.equal(a[i], c) for i, (o, s1) in enumerate(
        zip(one, sbs)) for a, c in zip(grads, splat_cuda._bwd_binned(
            s1.pts, s1.feats, o[3], s1.key, s1.smax, s1.order, bin_px, 0.04,
            150.0)))
    lane = b - 1
    lane_empty = (int(sb.smax[lane]) == 0 and bool((sb.key[lane] == n_rows)
                                                   .all())
                  and not img[lane].any()
                  and all(not t[lane].any() for t in grads))
    print(f"crop axis binned: bins equal to compute_bins with a crop axis: "
          f"{bins_plain}; smax per crop {sb.smax.tolist()}; the all-masked "
          f"lane empty (no window, image or gradient): {lane_empty}")
    assert bins_plain and lane_empty
    # against the windowed plain version through autograd, crop by crop
    args_k = [t.clone().requires_grad_(True) for t in (vb, nb_, fb)]
    img_k = splat_cuda.surfel_composite(*args_k, kgb, mb)
    gk = torch.autograd.grad(img_k, args_k, g)
    bfwd_err = bbwd_err = 0.0
    for i in range(b):
        args_p = [t[i].clone().requires_grad_(True) for t in (vb, nb_, fb)]
        img_p = splat_cuda.surfel_composite_windowed(*args_p, kg, mb[i],
                                                     bin_px=bin_px)
        gp = torch.autograd.grad(img_p, args_p, g[i])
        if i == lane:
            assert not img_k[i].any() and not img_p.any()
            continue
        e_f, e_b = splat_agreement(f"crop axis splat binned, crop {i}",
                                   img_k[i], img_p, [t[i] for t in gk], gp)
        bfwd_err, bbwd_err = max(bfwd_err, e_f), max(bbwd_err, e_b)
    out["splat_bins"] = crop_axis_record(
        "splat_bins", b,
        lambda: splat_cuda._sort_bins(pk, fb, kg4, 0.04, bin_px),
        lambda: [splat_cuda._sort_bins(o[0], o[1], o[2], 0.04, bin_px)
                 for o in one],
        lambda: splat_cuda._sort_bins(*one[0][:3], 0.04, bin_px), 0.0,
        bins_same, ("splat_bins_keys_kernel", "splat_bins_scatter_kernel"))
    out["splat_fwd_binned"] = crop_axis_record(
        "splat_fwd_binned", b,
        lambda: splat_cuda._fwd_binned(sb.pts, sb.feats, kg4, sb.win, bin_px,
                                       0.04, 150.0),
        lambda: [splat_cuda._fwd_binned(s1.pts, s1.feats, o[2], s1.win,
                                        bin_px, 0.04, 150.0)
                 for o, s1 in zip(one, sbs)],
        lambda: splat_cuda._fwd_binned(sbs[0].pts, sbs[0].feats, one[0][2],
                                       sbs[0].win, bin_px, 0.04, 150.0),
        bfwd_err, fwd_same, "splat_fwd_binned_split_kernel")
    out["splat_bwd_binned"] = crop_axis_record(
        "splat_bwd_binned", b,
        lambda: splat_cuda._bwd_binned(sb.pts, sb.feats, pix, sb.key,
                                       sb.smax, sb.order, bin_px, 0.04,
                                       150.0),
        lambda: [splat_cuda._bwd_binned(s1.pts, s1.feats, o[3], s1.key,
                                        s1.smax, s1.order, bin_px, 0.04,
                                        150.0) for o, s1 in zip(one, sbs)],
        lambda: splat_cuda._bwd_binned(sbs[0].pts, sbs[0].feats, one[0][3],
                                       sbs[0].key, sbs[0].smax, sbs[0].order,
                                       bin_px, 0.04, 150.0),
        bbwd_err, bwd_same, "splat_bwd_binned_split_kernel")
    return out


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


def check_bias_relu_dropout(dev, rows: int = 1 << 20,
                            widths: tuple = (512, 506)) -> list[dict]:
    """The train-mode hidden layer's bias, ReLU and dropout kernels at
    DeepSDF's training shape (64 scenes x 16384 rows; 512 columns, and
    506 before latent_in): y and the gradient of z against PyTorch's chain
    (relu(z + b), then models/deepsdf.py::_dropout, and autograd's
    backward) on the same generator's masks, bit for bit, and at the
    first width against the plain version on the same uniforms; the bias's
    gradient within its order's fp32 round-off of the float64 column sum;
    two launches bit-equal. Each direction timed a call and alone at 512
    columns, beside the plain version on the same uniforms and the chain
    (its draw included) as the library time. The rows give the 512-column
    numbers."""
    keep = 0.8
    rows_out = {}
    for cols in widths:
        gen = torch.Generator(device=dev).manual_seed(cols)
        z = torch.randn(rows, cols, generator=gen, device=dev)
        b = torch.randn(cols, generator=gen, device=dev) * 0.3
        g = torch.randn(rows, cols, generator=gen, device=dev)

        def fused(zz, bb):
            return dropout_cuda.bias_relu_dropout(
                zz, bb, keep, torch.Generator(device=dev).manual_seed(1))

        def chain(zz, bb):
            return deepsdf._dropout(torch.relu(zz + bb), keep,
                                    torch.Generator(device=dev).manual_seed(1))

        outs = []
        for fn in (fused, chain, fused):
            zz = z.clone().requires_grad_(True)
            bb = b.clone().requires_grad_(True)
            y = fn(zz, bb)
            gz, gb = torch.autograd.grad(y, (zz, bb), g)
            outs.append((y.detach(), gz, gb))
            del zz, bb, y
        torch.cuda.synchronize()
        (y_k, gz_k, gb_k), (y_c, gz_c, gb_c), again = outs
        del outs

        def bits(t):
            return t.view(torch.int32)

        def gap(a, w):  # in fp32: exact for close values (Sterbenz)
            return float((a - w).abs().max())

        y_same = torch.equal(bits(y_k), bits(y_c))
        gz_same = torch.equal(bits(gz_k), bits(gz_c))
        # the largest gaps to the chain: y and gz (0 where bit-equal), and
        # the bias's gradient (its sum runs in another order)
        fwd_gap, bwd_gap = gap(y_k, y_c), max(gap(gz_k, gz_c),
                                              gap(gb_k, gb_c))
        twice = all(torch.equal(bits(a), bits(w))
                    for a, w in zip((y_k, gz_k, gb_k), again))
        depth = dropout_cuda.sum_depth(dropout_cuda.plan(rows, cols))
        exact = gz_k.double().sum(0)
        allowed = depth * 2.0 ** -24 * gz_k.double().abs().sum(0)
        gb_err = float(((gb_k.double() - exact).abs() / allowed).max())
        gb_abs_err = float((gb_k.double() - exact).abs().max())
        chain_err = float(((gb_c.double() - exact).abs() / allowed).max())
        kept = float((y_k != 0).float().mean())
        print(f"bias_relu_dropout C={cols}: y bit-equal to the chain "
              f"{y_same}, gz {gz_same}; gb at {gb_err:.3g} of its round-off "
              f"bound (depth {depth}; PyTorch's sum at {chain_err:.3g}; "
              f"{gb_abs_err:.3g} from the float64 sum, {gap(gb_k, gb_c):.3g} "
              f"from PyTorch's); two launches bit-equal {twice}; nonzero "
              f"share {kept:.4f}")
        assert y_same and gz_same and twice and gb_err <= 1.0
        del gz_c, gb_c, y_c, again
        if cols != widths[0]:
            del z, b, g, y_k, gz_k, gb_k
            continue

        u = torch.rand(rows, cols, generator=gen, device=dev)
        y = y_k
        fwd_b = bound(3 * 4 * rows * cols + 4 * cols, 2 * rows * cols,
                      FP32_FLOPS)
        bwd_b = bound(3 * 4 * rows * cols + 4 * cols, 2 * rows * cols,
                      FP32_FLOPS)
        zl = z.clone().requires_grad_(True)
        bl = b.clone().requires_grad_(True)
        y_chain = chain(zl, bl)
        zp = z.clone().requires_grad_(True)
        bp = b.clone().requires_grad_(True)
        y_plain = dropout_cuda.bias_relu_dropout_plain(zp, bp, u, keep)

        def fwd():
            return dropout_cuda._fwd(z, b, u, keep)

        def bwd():
            return dropout_cuda._bwd(g, y, keep)

        # the kernels against the plain version on the same uniforms
        y_u = fwd()
        gz_u, _ = dropout_cuda._bwd(g, y_u, keep)
        gz_plain, _ = torch.autograd.grad(y_plain, (zp, bp), g,
                                          retain_graph=True)
        plain_same = (torch.equal(bits(y_u), bits(y_plain.detach()))
                      and torch.equal(bits(gz_u), bits(gz_plain)))
        fwd_gap = max(fwd_gap, gap(y_u, y_plain.detach()))
        bwd_gap = max(bwd_gap, gap(gz_u, gz_plain))
        print(f"bias_relu_dropout C={cols}: y and gz bit-equal to the plain "
              f"version on the same uniforms {plain_same}; the largest gaps "
              f"to the chain and the plain version: forward {fwd_gap:.3g}, "
              f"backward (gz, gb) {bwd_gap:.3g}")
        assert plain_same
        del y_u, gz_u, gz_plain

        with torch.no_grad():
            r_fwd = dict(
                name="brd_fwd", ms=time_ms(fwd),
                kernel_ms=kernel_ms(fwd, "brd_fwd_kernel"),
                call_with_draw_ms=time_ms(lambda: fused(z, b)),
                plain_ms=time_ms(lambda: dropout_cuda.bias_relu_dropout_plain(
                    z, b, u, keep)),
                library_ms=time_ms(lambda: chain(z, b)),
                bound_ms=fwd_b[0], bound_by=fwd_b[1], max_abs_err=fwd_gap)
        r_bwd = dict(
            name="brd_bwd", ms=time_ms(bwd),
            kernel_ms=kernel_ms(bwd, "brd_bwd_kernel"),
            reduce_kernel_ms=kernel_ms(bwd, "brd_reduce_kernel"),
            plain_ms=time_ms(lambda: torch.autograd.grad(
                y_plain, (zp, bp), g, retain_graph=True)),
            library_ms=time_ms(lambda: torch.autograd.grad(
                y_chain, (zl, bl), g, retain_graph=True)),
            bound_ms=bwd_b[0], bound_by=bwd_b[1], max_abs_err=bwd_gap,
            gb_abs_err=gb_abs_err, gb_err_of_bound=gb_err)
        for r in (r_fwd, r_bwd):
            r["shape"] = [rows, cols]
            share = r["bound_ms"] / r["kernel_ms"]
            print(f"{r['name']} ({rows} x {cols}): {r['ms']:.4f} ms a call, "
                  f"{r['kernel_ms']:.4f} ms alone ({share:.1%} of the "
                  f"bound); plain "
                  f"{r['plain_ms']:.4f} ms, the PyTorch chain "
                  f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})"
                  + (f"; with the draw {r['call_with_draw_ms']:.4f} ms"
                     if "call_with_draw_ms" in r else
                     f"; the reduction alone {r['reduce_kernel_ms']:.4f} ms"))
        rows_out[cols] = [r_fwd, r_bwd]
        del z, b, g, u, y, y_k, gz_k, gb_k, zl, bl, y_chain, zp, bp, y_plain
        torch.cuda.empty_cache()
    return rows_out[widths[0]]


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
                                  prepare_crop_s=prep_s,
                                  labels=_label_fields(ests))


def _label_fields(ests) -> dict:
    return {k: np.asarray(ests[k], np.float64).tolist()
            for k in ("location", "dimensions", "rotation_y", "alpha")}


def _label_gap(a: dict, b: dict) -> float:
    """The largest difference between two label_fields."""
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
               for k in a)


def scene_layers(path: str) -> dict:
    """{layer name: point or segment count} of an export_scene_html file."""
    with open(path) as f:
        scene = json.loads(re.search(r"const SCENE = (\{.*?\});\n",
                                     f.read()).group(1))
    return {layer["name"]: len(layer.get("pts", layer.get("segs", [])))
            for layer in scene["layers"]}


def demo_viz_phase(dev, out_dir: str, demo: dict, iters: int | None = None):
    """Phase 3b: the stock demo command as written: refine_css_demo on
    configs/config_demo.ini unchanged (viz_type 3d) but for the output
    directory, on the card. Every PNG it writes must decode with
    utils/png.py and hold nonzero pixels, every HTML scene its point sets;
    the splat forward (1a) and the NN (2) must launch inside
    render_trajectory, once per drawn iteration; the labels must equal
    phase 3's (viz off) to 1e-6. The viz wall is timed apart."""
    cfg = cfg_mod.RefineCfg.from_ini(cfg_mod.load_ini(
        os.path.join(ROOT, "configs", "config_demo.ini")))
    assert cfg.viz_type == "3d"
    labels_out = os.path.join(out_dir, "demo_out")
    cfg = dataclasses.replace(cfg, labels_out=labels_out,
                              **({"iters": iters} if iters else {}))
    rt = pipe.setup_runtime(cfg, device=dev)
    sample = pipe.load_demo_sample(os.path.join(ROOT, "data",
                                                "optimization"))
    viz_s, viz_launched = [], collections.Counter()
    originals = {name: getattr(pipe, name)
                 for name in ("render_trajectory", "demo_views")}

    def timed(fn):
        def run(*args, **kw):
            before = counts()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            viz_s.append(time.perf_counter() - t0)
            viz_launched.update({k: v - before[k]
                                 for k, v in counts().items()})
            return out
        return run

    for name, fn in originals.items():
        setattr(pipe, name, timed(fn))
    reset_counts()
    t0 = time.perf_counter()
    try:
        annos, ests = pipe.refine_css_demo(cfg, sample=sample, device=dev,
                                           rt=rt)
    finally:
        for name, fn in originals.items():
            setattr(pipe, name, fn)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    files = sorted(os.path.relpath(os.path.join(d, f), labels_out)
                   for d, _, fs in os.walk(labels_out) for f in fs)
    pngs = [f for f in files if f.endswith(".png")]
    htmls = [f for f in files if f.endswith(".html")]
    frames = len([f for f in pngs if f.endswith("_patches.png")])
    for f in pngs:
        img = png.read(os.path.join(labels_out, f))
        assert img.ndim == 3 and img.shape[2] == 3 and img.any(), f
    scenes = {f: scene_layers(os.path.join(labels_out, f)) for f in htmls}
    assert scenes["demo_scene3d.html"]["lidar"] > 0
    assert scenes["demo_scene3d.html"]["est cuboids"] == 12
    assert scenes["demo_scene3d.html"]["gt cuboids"] == 12
    trajectory = [f for f in htmls if f.startswith("viz/")]
    assert len(trajectory) == 1
    assert all(scenes[trajectory[0]][k] > 0
               for k in ("scene", "model", "correspondences"))
    gap = _label_gap(_label_fields(ests), demo["labels"])
    viz_wall = sum(viz_s)
    print(f"demo as written (viz_type 3d): {cfg.iters} iterations, "
          f"{wall:.3f} s wall: refine {wall - viz_wall:.3f} s, viz "
          f"{viz_wall:.3f} s ({frames} drawn iterations, "
          f"{len(pngs)} PNG, {len(htmls)} HTML); labels within {gap:.3g} "
          f"of phase 3's (need <= 1e-6); launches inside the viz "
          f"{dict(viz_launched)}, in all {launched}; scenes {scenes}")
    assert len(annos["location"]) == len(ests["location"]) == 1
    assert frames == min(8, cfg.iters) and len(pngs) == 3 * frames + 1
    assert gap <= 1e-6
    if dev.type == "cuda":
        # every drawn iteration: one render (1a) and one NN (2), no
        # backward
        assert viz_launched["splat_fwd"] == viz_launched["nn"] == frames
        assert viz_launched["splat_bwd"] == 0
        assert launched["splat_fwd"] == cfg.iters + frames
    return dict(viz_launched), dict(
        wall_s=wall, viz_s=viz_wall, refine_s=wall - viz_wall,
        drawn_iterations=frames, pngs=len(pngs), htmls=len(htmls),
        label_gap=gap)


def pnp_bf16_phase(dev, demo: dict, iters: int | None = None):
    """Phase 3c: the demo crop initialized by pose_estimator = pnp
    (ops/pnp.py on the card's tensors; its reprojection RMS over every
    correspondence and over those within 1 px), then refined with
    select_bf16 (precision float32; the demo's 3x64 net is outside the
    selection kernel's packer, so the bf16 twin ranks the band). Both
    labels beside phase 3's."""
    base = cfg_mod.RefineCfg.from_ini(cfg_mod.load_ini(
        os.path.join(ROOT, "configs", "config_demo.ini")))
    base = dataclasses.replace(base, viz_type="none",
                               **({"iters": iters} if iters else {}))
    sample = pipe.load_demo_sample(os.path.join(ROOT, "data",
                                                "optimization"))
    seen = {}
    inner = pipe.pnp.init_pose_2d

    def spy(cam, nocs, *args, **kw):
        t0 = time.perf_counter()
        pose = inner(cam, nocs, *args, **kw)
        # a copy: prepare_crop constrains the rotation in place
        seen.update(K=np.asarray(cam), nocs=np.asarray(nocs),
                    pose={k: np.array(v) for k, v in pose.items()},
                    s=time.perf_counter() - t0, device=str(kw["device"]))
        return pose

    out = {}
    cfg = dataclasses.replace(base, pose_estimator="pnp")
    rt = pipe.setup_runtime(cfg, device=dev)
    watch = _cpu_op_watch()
    pipe.pnp.init_pose_2d = spy
    reset_counts()
    try:
        with watch:
            _, ests = pipe.refine_css_demo(cfg, sample=sample, device=dev,
                                           rt=rt)
    finally:
        pipe.pnp.init_pose_2d = inner
    # once more on the same inputs: the first call also loads the card's
    # linear-algebra libraries
    t0 = time.perf_counter()
    inner(seen["K"], seen["nocs"], 2.0, device=dev,
          generator=torch.Generator(device=dev).manual_seed(1))
    warm_s = time.perf_counter() - t0
    mask = seen["nocs"][0] > 0
    obj = (np.transpose(seen["nocs"], (1, 2, 0))[mask] * 2 - 1) * 2.0
    rows, cols = np.nonzero(mask)
    cam = obj @ seen["pose"]["rot"].T + seen["pose"]["tra"]
    uv = cam @ seen["K"].T
    err = np.linalg.norm(uv[:, :2] / uv[:, 2:] - np.stack([cols, rows], 1),
                         axis=1)
    inl = err <= 1.0
    out["pnp"] = dict(
        correspondences=int(mask.sum()), inliers_1px=int(inl.sum()),
        rms_px=float(np.sqrt(np.mean(err ** 2))),
        inlier_rms_px=float(np.sqrt(np.mean(err[inl] ** 2))),
        pnp_s=seen["s"], pnp_warm_s=warm_s, labels=_label_fields(ests),
        label_gap=_label_gap(_label_fields(ests), demo["labels"]))
    print(f"demo, pose_estimator pnp on {seen['device']}: "
          f"{out['pnp']['correspondences']} correspondences, "
          f"{out['pnp']['inliers_1px']} within 1 px, reprojection RMS "
          f"{out['pnp']['rms_px']:.4f} px ({out['pnp']['inlier_rms_px']:.4f}"
          f" px within 1 px), {seen['s']:.3f} s (again on the same inputs "
          f"{warm_s:.3f} s); label location "
          f"{out['pnp']['labels']['location']}, phase 3's "
          f"{demo['labels']['location']}")
    assert seen["device"] == str(dev) and len(ests["location"]) == 1
    assert np.isfinite(out["pnp"]["labels"]["location"]).all()
    if dev.type == "cuda":
        print(f"demo, pnp: CPU operators on the path: {dict(watch.cpu_ops)}")
        assert not watch.cpu_ops

    cfg = dataclasses.replace(base, precision="float32", select_bf16=True)
    rt = pipe.setup_runtime(cfg, device=dev)
    assert rt.select_decoder is not None and mlp_cuda.select_fn(
        rt.dsdf_cfg, rt.dsdf_params) is None
    reset_counts()
    _, ests = pipe.refine_css_demo(cfg, sample=sample, device=dev, rt=rt)
    launched = counts()
    out["select_bf16"] = dict(labels=_label_fields(ests),
                              label_gap=_label_gap(_label_fields(ests),
                                                   demo["labels"]))
    print(f"demo, select_bf16: label location "
          f"{out['select_bf16']['labels']['location']}, "
          f"{out['select_bf16']['label_gap']:.4g} from phase 3's; launches "
          f"{launched}")
    assert len(ests["location"]) == 1 and launched["select_mlp"] == 0
    return out


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
                              location=np.asarray(label["location"]).tolist(),
                              rotation_y=float(label["rotation_y"]))


def _loc_yaw_gap(a: dict, b: dict) -> tuple[float, float]:
    """(|d location| max over axes, |d rotation_y| mod 2 pi) of two
    labels."""
    dyaw = abs(float(a["rotation_y"]) - float(b["rotation_y"]))
    return (float(np.abs(np.asarray(a["location"], float)
                         - np.asarray(b["location"], float)).max()),
            min(dyaw, 2 * np.pi - dyaw))


def shifted_crops(prep: dict) -> list[dict]:
    """Phase 3's prepared crop and three made from it: the initial yaw
    moved by +0.2 and -0.2 rad, the translation by 0.3 m (x, then z), and
    the last one's NOCS target cut to a smaller (h, w), so that the batch
    letterboxes it."""
    p0 = prep["params0"]
    scale = float(p0.scale[0])

    def moved(dyaw=0.0, dtrans=(0.0, 0.0, 0.0), cut=None):
        shift = torch.tensor(dtrans, device=p0.trans.device) / scale
        crop = dict(prep, params0=refine_mod.RefineParams(
            p0.yaw + dyaw, p0.trans + shift, p0.scale, p0.latent))
        if cut:
            h, w = crop["crop_hw"]
            crop.update(crop_hw=(h - cut[0], w - cut[1]),
                        nocs_target=np.ascontiguousarray(
                            prep["nocs_target"][:, :h - cut[0], :w - cut[1]]))
        return crop

    return [prep, moved(dyaw=0.2), moved(dyaw=-0.2, dtrans=(0.3, 0, 0)),
            moved(dtrans=(0, 0, 0.3), cut=(6, 8))]


def batched_full_width_phase(dev, rt512, sample, prep, full: dict,
                             full_launched: dict, expect=None,
                             label_: str = "batched full width"):
    """Phase 4d: four crops of phase 4's runtime (shifted_crops) refined at
    once by the batched driver's refine_crops_batched, timed and counted:
    each of the crop-axis kernels must launch as often for the batch as for
    phase 4's one crop. Each crop's parameters must track that crop refined
    alone through run_refine within 1e-3 at every iteration, and its label
    land within 1e-3 (m, rad) of the crop alone's: both loops step with
    the same arithmetic (engine/refine.py::batch_step). Printed beside: the
    crop alone from a start moved by 1e-6, which the refine on the seeded
    random decoder may carry to centimetres (scripts/batched_vs_alone.py,
    scripts/batched_lanes_jax.py). Phases 4f and 4g run the same with
    another runtime, `prep` and `expect`: {kernel: launches the batch must
    make}; `full` is then the single-crop run it is timed beside."""
    crops = shifted_crops(prep)
    iters = rt512.cfg.iters
    if expect is None:
        expect = {k: full_launched[k] for k in ("splat_fwd", "splat_bwd",
                                                "nn", "select_mlp")}
    alone, moved, alone_s = [], [], []
    for crop in crops:
        t0 = time.perf_counter()
        final, hist, ext = rt512.run_refine(crop)
        label = pipe.finish_label(final, ext, sample, crop["anno"])
        alone_s.append(time.perf_counter() - t0)  # warm, label read back
        alone.append((hist.params, label))
        p0 = crop["params0"]
        final, _, ext = rt512.run_refine(dict(crop, params0=p0._replace(
            trans=p0.trans + 1e-6)))
        moved.append(pipe.finish_label(final, ext, sample, crop["anno"]))
    bucket, inputs = pipe.batch_inputs(rt512, crops)
    _, hist = batched_refine.make_batched_refine(
        rt512.decoder, rt512.refine_config(), rt512.grid_points, bucket,
        select_decoder=rt512.select_decoder, stage2_fn=rt512.stage2_fn,
        device=dev)(*inputs)
    if dev.type == "cuda":
        pipe.refine_crops_batched(rt512, sample, crops)  # warm-up
    reset_counts()
    t0 = time.perf_counter()
    labels = pipe.refine_crops_batched(rt512, sample, crops)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = counts()
    assert len(labels) == len(crops)

    track, gaps, parting = [], [], []
    for i, (got, (params, want), nudged) in enumerate(zip(labels, alone,
                                                          moved)):
        per_iter = torch.stack([(a - b[i]).abs().amax(-1) for a, b in zip(
            params, hist.params)]).amax(0)
        track.append(float(per_iter.max()))
        off = (per_iter > 1e-6).nonzero()
        parting.append(int(off[0]) if len(off) else None)
        gaps.append((_loc_yaw_gap(got, want), _loc_yaw_gap(nudged, want)))
        print(f"{label_}: crop {i}: parameters within "
              f"{track[-1]:.3g} of the crop alone over all {iters} "
              f"iterations (need <= 1e-3; first iteration over 1e-6: "
              f"{parting[-1]}); label location "
              f"{np.asarray(got['location'])}, alone "
              f"{np.asarray(want['location'])}, |d location| "
              f"{gaps[-1][0][0]:.3g} m, |d rotation_y| {gaps[-1][0][1]:.3g} "
              f"rad (need <= 1e-3); alone from a start moved by 1e-6: "
              f"{gaps[-1][1][0]:.3g} m, {gaps[-1][1][1]:.3g} rad")
    alone_mean = statistics.mean(alone_s)
    summary = dict(crops=len(crops), iters=iters, wall_s=wall,
                   ms_per_iteration=wall / iters * 1e3,
                   s_per_crop=wall / len(crops),
                   s_per_crop_ratio=wall / len(crops) / full["wall_s"],
                   alone_s_per_crop=alone_mean,
                   s_per_crop_ratio_alone=wall / len(crops) / alone_mean,
                   max_track_gap=max(track), first_parting=parting,
                   label_gaps=[g[0] for g in gaps],
                   moved_start_label_gaps=[g[1] for g in gaps],
                   labels=[{"location": np.asarray(g["location"],
                                                   np.float64).tolist(),
                            "rotation_y": float(g["rotation_y"])}
                           for g in labels])
    line = (f"{label_}: {len(crops)} crops, {iters} iterations, "
            f"{wall:.3f} s wall, {summary['ms_per_iteration']:.3f} "
            f"ms/iteration, {summary['s_per_crop']:.4f} s/crop (one crop: "
            f"{full['wall_s'] / iters * 1e3:.3f} ms/iteration, "
            f"{full['wall_s']:.4f} s/crop, ratio "
            f"{summary['s_per_crop_ratio']:.3f}; each crop alone, warm: "
            f"{alone_mean:.4f} s/crop, ratio "
            f"{summary['s_per_crop_ratio_alone']:.3f}), launches {launched}")
    if dev.type == "cuda":
        per_iter = {}
        for label, fn in (("batched", lambda: pipe.refine_crops_batched(
                rt512, sample, crops)), ("one crop", lambda: rt512.run_refine(
                    prep))):
            per_iter[label] = sum(device_launches(fn, reps=1).values()) / iters
        summary["device_launches_per_iteration"] = per_iter["batched"]
        summary["phase4_device_launches_per_iteration"] = per_iter["one crop"]
        line += (f"; device launches per iteration {per_iter['batched']:.1f} "
                 f"(one crop: {per_iter['one crop']:.1f})")
    print(line)
    assert max(track) <= 1e-3, track
    assert max(max(g[0]) for g in gaps) <= 1e-3, gaps
    assert all(np.isfinite(g["location"]).all() for g in labels)
    if dev.type == "cuda":
        # one launch per iteration (select: per refresh) for the whole batch
        for name, n in expect.items():
            assert launched[name] == n > 0, (name, launched[name], n)
    return launched, summary


def batched_stage2_phase(dev, rt_stage2, sample, prep, stage2: dict,
                         stage2_launched: dict):
    """Phase 4f: phase 4d's four crops with stage2_pallas = True (phase
    4c's runtime): kernels 4a and 4b launch once per iteration for the
    four crops, as 4c's one crop does, beside the crop-axis kernels of 4d;
    each crop tracks itself refined alone with the stage-2 kernels within
    1e-3 at every iteration and in the label. s/crop beside 4c's."""
    expect = {k: stage2_launched[k] for k in (
        "splat_fwd", "splat_bwd", "nn", "select_mlp", "stage2_fwd",
        "stage2_bwd")}
    if dev.type == "cuda":
        assert expect["stage2_fwd"] == expect["stage2_bwd"] == \
            rt_stage2.cfg.iters
    return batched_full_width_phase(dev, rt_stage2, sample, prep, stage2,
                                    stage2_launched, expect,
                                    "batched full width, stage 2")


def batched_binned_phase(dev, rt_demo, rt512, sample, prep,
                         iters: int = 10):
    """Phase 4g: phase 4d's four crops at rendering_area = 96 (phase 3's
    crop prepared again at that area, as phase 4 refines phase 3's
    preparation), whose bucket of >= 4096 px takes the binned route, for
    `iters` iterations of phase 4's runtime: the bins, 1c and 1d launch
    once per iteration for the four crops, and each crop tracks itself
    refined alone within 1e-3. Timed beside the first crop refined alone
    at the same settings."""
    prep96 = pipe.prepare_crop(pipe.RefineRuntime(
        dataclasses.replace(rt_demo.cfg, rendering_area=96), rt_demo.css,
        rt_demo.dsdf_cfg, rt_demo.dsdf_params, device=dev), sample,
        prep["anno"])
    cfg = dataclasses.replace(rt512.cfg, rendering_area=96, iters=iters)
    rt = pipe.RefineRuntime(cfg, rt512.css, rt512.dsdf_cfg,
                            rt512.dsdf_params, device=dev)
    assert prep96 is not None
    h, w = prep96["crop_hw"]
    assert splat_cuda.bin_policy(h * w) == 512, (h, w)
    rt.run_refine(prep96)  # warm-up
    t0 = time.perf_counter()
    rt.run_refine(prep96)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    one = dict(wall_s=time.perf_counter() - t0)
    expect = {k: iters for k in ("splat_bins", "splat_fwd_binned",
                                 "splat_bwd_binned")}
    launched, summary = batched_full_width_phase(
        dev, rt, sample, prep96, one, {}, expect if dev.type == "cuda" else
        {}, "batched binned")
    summary["px"] = h * w
    if dev.type == "cuda":
        assert launched["splat_fwd"] == launched["splat_bwd"] == 0
    return launched, summary


CELLS = 2048  # the cells of JAX's warm_c2f_refresh bench cell (bench.py:256)


def coarse_full_width_phase(dev, rt512, sample, prep, full: dict):
    """Phase 4e: phase 4's runtime and crop with the coarse cells: the warm
    refresh through CELLS cells (warm_refresh_cells), then CELLS cells
    ranked every iteration on the exact path (coarse_cells: the warm band
    off). Each refresh or iteration launches kernel 3 twice, once on the
    shared corner lattice and once on the cells' points. Then phase 4d's
    four crops at once with warm_refresh_cells: the lattice pass launches
    kernel 3 once for all four. ms/iteration and labels beside phase 4's."""
    iters = rt512.cfg.iters
    refreshes = -(-iters // rt512.cfg.warm_refresh)
    out, launches = {}, {}
    for mode, change, selects in (
            ("warm_refresh_cells", dict(warm_refresh_cells=CELLS),
             2 * refreshes),
            ("coarse_cells", dict(coarse_cells=CELLS), 2 * iters)):
        rt = pipe.RefineRuntime(dataclasses.replace(rt512.cfg, **change),
                                rt512.css, rt512.dsdf_cfg, rt512.dsdf_params,
                                device=dev)
        if mode == "coarse_cells":
            assert rt.warm_band == 0 and rt.coarse_cells == CELLS
        else:
            assert rt.warm_band == 8192 and rt.warm_refresh_cells == CELLS
        rt.run_refine(prep)  # warm-up
        reset_counts()
        t0 = time.perf_counter()
        final, hist, ext = rt.run_refine(prep)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[mode] = counts()
        label = pipe.finish_label(final, ext, sample, prep["anno"])
        loss = hist.loss.cpu().numpy()
        applied = hist.applied.cpu().numpy()
        assert np.isfinite(loss[applied]).all() and applied.any()
        assert label is not None and np.isfinite(label["location"]).all()
        dist = float(np.linalg.norm(np.asarray(label["location"])
                                    - np.asarray(full["location"])))
        out[mode] = dict(wall_s=wall, ms_per_iteration=wall / iters * 1e3,
                         location=np.asarray(label["location"]).tolist(),
                         label_dist_m=dist,
                         select_launches=launches[mode]["select_mlp"])
        print(f"full width, {mode} = {CELLS}: {iters} iterations, "
              f"{wall:.3f} s wall, {wall / iters * 1e3:.3f} ms/iteration "
              f"(phase 4: {full['wall_s'] / iters * 1e3:.3f}, cold), "
              f"kernel 3 launches {launches[mode]['select_mlp']} (phase 4: "
              f"{refreshes}), label location {out[mode]['location']}, "
              f"{dist:.4f} m from phase 4's")
        if dev.type == "cuda":
            assert launches[mode]["select_mlp"] == selects
            assert launches[mode]["splat_fwd"] == iters
        if mode == "warm_refresh_cells":
            rt_wrc = rt
    crops = shifted_crops(prep)
    pipe.refine_crops_batched(rt_wrc, sample, crops)  # warm-up
    reset_counts()
    t0 = time.perf_counter()
    labels = pipe.refine_crops_batched(rt_wrc, sample, crops)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["batched_warm_refresh_cells"] = counts()
    n_sel = launches["batched_warm_refresh_cells"]["select_mlp"]
    out["batched_warm_refresh_cells"] = dict(
        crops=len(crops), wall_s=wall, s_per_crop=wall / len(crops),
        ms_per_iteration=wall / iters * 1e3, select_launches=n_sel)
    print(f"batched full width, warm_refresh_cells = {CELLS}: "
          f"{len(crops)} crops, {wall:.3f} s wall, "
          f"{wall / iters * 1e3:.3f} ms/iteration, "
          f"{wall / len(crops):.4f} s/crop, kernel 3 launches {n_sel}")
    assert len(labels) == len(crops)
    assert all(np.isfinite(g["location"]).all() for g in labels)
    if dev.type == "cuda":
        assert n_sel == 2 * refreshes
    return launches, out


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
    summary = dict(wall_s=wall, iters=iters, px=h * w, loss0=float(loss[0]),
                   loss1=float(loss[1]) if iters > 1 else None)
    if dev.type == "cuda":
        assert launched["splat_fwd_binned"] == launched["splat_bwd_binned"] \
            == launched["splat_bins"] == iters
        assert launched["splat_fwd"] == launched["splat_bwd"] == 0
        summary["render_launches"] = binned_render_launches(
            dev, rt.surface_capacity, (h, w), backward=True)
        print_render_launches("binned refine", rt.surface_capacity, (h, w),
                              summary["render_launches"])
    return launched, summary, prep


def print_render_launches(label: str, n: int, res: tuple,
                          launches: dict) -> None:
    print(f"{label}: device launches a binned render of {n} points onto "
          f"{res[0]}x{res[1]} px: {launches['new']} (the first designs' "
          f"chain: {launches['first']}); by kernel "
          f"{json.dumps(launches['by_kernel'])}")



# ------------------------------------------------------ phases 4h and 4i

RAYS_KERNELS = ("splat_fwd", "splat_bwd", "nn", "select_mlp")
BINNED_KERNELS = ("splat_bins", "splat_fwd_binned", "splat_bwd_binned")
BINNED_OUT = ("img", "g_pose", "g_pts")
RAYS_BINNED_RES = (128, 96)  # 6144 px a block on two ranks


def _cpu_prep(prep: dict) -> dict:
    """A prepared crop with its tensors on the CPU (to pickle to a rank)."""
    return dict(prep, params0=refine_mod.RefineParams(
        *(p.detach().cpu() for p in prep["params0"])))


def rays_rank(rank: int, out_dir: str, job: dict) -> None:
    """One rank of phases 4h and 4i (a process of mesh.spawn_ranks, which
    loads the kernels the parent built): phase 4's runtime rebuilt from
    its config and seeded decoder; the crop refined by
    make_sharded_refine_fn over a rays axis of every rank; then, with
    job['crops'], those crops through make_batched_refine(mesh=) over a
    data axis of every rank. Each with its wall time and this rank's
    launches; out_dir/rays_<rank>.pt."""
    dev = torch.device(job["devices"][rank])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = torch.distributed.get_world_size()
    cfg512, params512 = decoder_8x512(dev)
    rt = pipe.RefineRuntime(job["stock"], css_mod.CSSNet(width=8), cfg512,
                            params512, device=dev)
    rays = mesh_mod.make_mesh(1, world)
    data = mesh_mod.make_mesh(world, 1)
    prep = job["prep"]
    args = (prep["params0"], prep["nocs_target"], prep["frustum"],
            prep["fmask"])

    def sharded(iters):
        return sharded_refine.make_sharded_refine_fn(
            rt.decoder, dataclasses.replace(rt.refine_config(), iters=iters),
            rt.grid_points, prep["intrinsics"], prep["crop_hw"], rays,
            select_decoder=rt.select_decoder, device=dev)

    def timed(fn, *a):
        reset_counts()
        t0 = time.perf_counter()
        res = fn(*a)
        if cuda:
            torch.cuda.synchronize()
        return res, time.perf_counter() - t0, counts()

    sharded(1)(*args)  # warm-up: lazy loads and the first launches
    (final, hist), wall, launched = timed(sharded(rt.cfg.iters), *args)
    out = {"rays": dict(final=[p.cpu() for p in final], hist=hist.cpu(),
                        wall_s=wall, launches=launched)}
    if job["crops"] is not None:
        rt.mesh = data
        bucket, inputs = pipe.batch_inputs(rt, job["crops"])
        fn = batched_refine.make_batched_refine(
            rt.decoder, rt.refine_config(), rt.grid_points, bucket,
            select_decoder=rt.select_decoder, stage2_fn=rt.stage2_fn,
            with_extents=True, mesh=data, device=dev)
        (final, _, ext), wall, launched = timed(fn, *inputs)
        out["data"] = dict(final=[p.cpu() for p in final],
                           ext=[t.cpu() for t in ext], wall_s=wall,
                           launches=launched)
    if job.get("binned") is not None:
        out["binned"] = binned_rays_work(dev, rays, job["binned"], timed)
    torch.save(out, os.path.join(out_dir, f"rays_{rank}.pt"))


def binned_rays_work(dev, rays, job: dict, timed) -> dict:
    """The binned part of a rays_rank (4h, binned): the rays render of
    job['render'] at a size whose blocks take the row-binned route, with
    the gradients of sum(image^2) in the pose and the points; then phase
    4b's crop (job['prep'], the demo runtime at rendering_area = 96)
    refined over the rays axis. Each with its wall time and launches."""
    r = job["render"]
    render = rays_mod.make_rays_sharded_render(rays, r["K"], r["res"])
    pose = torch.as_tensor(r["pose"], device=dev).requires_grad_(True)
    pts = torch.as_tensor(r["pts"], device=dev).requires_grad_(True)

    def draw():
        img = render(pts, torch.as_tensor(r["normals"], device=dev), pose,
                     torch.as_tensor(r["mask"], device=dev))
        img.square().sum().backward()
        return img

    draw()  # warm-up
    pose.grad = pts.grad = None
    img, wall, launched = timed(draw)
    out = {"render": dict(img=img.detach().cpu(), g_pose=pose.grad.cpu(),
                          g_pts=pts.grad.cpu(), wall_s=wall,
                          launches=launched)}
    dcfg, dparams = deepsdf.load_torch_checkpoint(job["dsdf"], device=dev)
    rt = pipe.RefineRuntime(job["cfg"], css_mod.CSSNet(width=8), dcfg,
                            dparams, device=dev)
    prep = job["prep"]

    def sharded(iters):
        return sharded_refine.make_sharded_refine_fn(
            rt.decoder, dataclasses.replace(rt.refine_config(), iters=iters),
            rt.grid_points, prep["intrinsics"], prep["crop_hw"], rays,
            select_decoder=rt.select_decoder, device=dev)

    args = (prep["params0"], prep["nocs_target"], prep["frustum"],
            prep["fmask"])
    sharded(1)(*args)  # warm-up
    (final, hist), wall, launched = timed(sharded(rt.cfg.iters), *args)
    out["refine"] = dict(final=[p.cpu() for p in final], hist=hist.cpu(),
                         wall_s=wall, launches=launched)
    return out


def _run_rays(out_dir: str, job: dict, world: int, backend: str):
    """Spawn `world` ranks of rays_rank: (rank 0's results, every rank's,
    the spawn's seconds); the ranks' refines must agree bit for bit."""
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    t0 = time.perf_counter()
    mesh_mod.spawn_ranks(rays_rank, world, (out_dir, job), backend=backend)
    res = [torch.load(os.path.join(out_dir, f"rays_{r}.pt"),
                      weights_only=False) for r in range(world)]
    for r in res[1:]:
        tensors = [(r["rays"]["final"] + [r["rays"]["hist"]],
                    res[0]["rays"]["final"] + [res[0]["rays"]["hist"]])]
        if "data" in r:
            tensors.append((r["data"]["final"] + r["data"]["ext"],
                            res[0]["data"]["final"] + res[0]["data"]["ext"]))
        if "binned" in r:
            got, want = r["binned"], res[0]["binned"]
            tensors.append(([got["render"][k] for k in BINNED_OUT]
                            + got["refine"]["final"]
                            + [got["refine"]["hist"]],
                            [want["render"][k] for k in BINNED_OUT]
                            + want["refine"]["final"]
                            + [want["refine"]["hist"]]))
        for got, want in tensors:
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    return res[0], res, time.perf_counter() - t0


def _sharded_label(rt512, final, sample, anno):
    ext = labels_mod.surface_extents(
        rt512.decoder, rt512.grid_points,
        final[3].to(rt512.grid_points.device),
        capacity=rt512.surface_capacity,
        threshold=rt512.refine_config().surface_threshold)
    return pipe.finish_label(refine_mod.RefineParams(*final), ext, sample,
                             anno)


def binned_rays_job(rt_demo, prep: dict, iters: int) -> dict:
    """4h's binned inputs: a render of 4096 seeded surfels at
    RAYS_BINNED_RES, and phase 4b's prepared crop with its runtime's
    config (the demo's at rendering_area = 96) and decoder."""
    rng = np.random.RandomState(0)
    n = 4096
    normals = rng.randn(n, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0, 0, 5]
    render = dict(K=rasterer.calibration_matrix(RAYS_BINNED_RES),
                  res=RAYS_BINNED_RES,
                  pts=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                  normals=normals, pose=pose,
                  mask=rng.uniform(size=n) > 0.2)
    return dict(render=render, prep=_cpu_prep(prep),
                cfg=dataclasses.replace(rt_demo.cfg, rendering_area=96,
                                        iters=iters),
                dsdf=os.path.join(ROOT, "data", "optimization",
                                  "deepsdf_demo.pt"))


def _unsharded_render(dev, r: dict) -> tuple[dict, dict]:
    """The rays job's render unsharded on `dev` (rasterer.render), with the
    gradients of sum(image^2) and its launches."""
    pose = torch.as_tensor(r["pose"], device=dev).requires_grad_(True)
    pts = torch.as_tensor(r["pts"], device=dev).requires_grad_(True)
    normals = torch.as_tensor(r["normals"], device=dev)
    reset_counts()
    rendering, _ = rasterer.render(
        torch.as_tensor(r["K"], device=dev), r["res"], pts, normals, normals,
        pose, point_mask=torch.as_tensor(r["mask"], device=dev), rot="dcm",
        output_nocs=True)
    rendering.color.square().sum().backward()
    launched = counts()
    return dict(img=rendering.color.detach().cpu(), g_pose=pose.grad.cpu(),
                g_pts=pts.grad.cpu()), launched


def _binned_rays_checks(dev, runs: dict, binned: dict, job: dict) -> dict:
    """4h, binned: the rays render of each run (1 rank, 2 ranks) against
    the unsharded render on the same device (the image within 1e-5, the
    gradients within 1e-4 of their largest element), the sharded refine's
    first loss on 1 rank within 1e-5 relative of phase 4b's and the first
    two on 2 ranks within 1e-4 of 1 rank's; the bins, 1c and 1d launched
    on every rank for both."""
    ref, ref_launched = _unsharded_render(dev, job["render"])
    w, h = RAYS_BINNED_RES
    out = dict(res=[w, h], unsharded_launches=ref_launched)
    for name, ranks in runs.items():
        first = ranks[0]["binned"]
        gaps = {k: float((first["render"][k] - ref[k]).abs().max()
                         / (1.0 if k == "img" else ref[k].abs().max()))
                for k in BINNED_OUT}
        hist = first["refine"]["hist"].numpy()
        by_rank = {f"{part}:{k}": [r["binned"][part]["launches"][k]
                                   for r in ranks]
                   for part in ("render", "refine") for k in BINNED_KERNELS}
        out[name] = dict(
            block_px=w * h // len(ranks), render_gaps=gaps,
            render_ms=first["render"]["wall_s"] * 1e3,
            losses=hist[:2].tolist(),
            refine_ms_per_iteration=first["refine"]["wall_s"] / len(hist)
            * 1e3, launches_by_rank=by_rank)
        assert gaps["img"] <= 1e-5 and max(gaps["g_pose"],
                                           gaps["g_pts"]) <= 1e-4, gaps
        assert all(torch.isfinite(t).all() for t in first["refine"]["final"])
        if dev.type == "cuda":
            for k, n in by_rank.items():
                assert all(x > 0 for x in n), (name, k, n)
    loss1, loss2 = out["1 rank"]["losses"], out["2 ranks"]["losses"]
    out["rel_first_loss_1rank_vs_4b"] = abs(loss1[0] - binned["loss0"]) \
        / abs(binned["loss0"])
    out["rel_first_losses_2ranks"] = [abs(a - b) / abs(b)
                                      for a, b in zip(loss2, loss1)]
    print(f"4h, binned: {json.dumps(out)}")
    assert out["rel_first_loss_1rank_vs_4b"] <= 1e-5, out
    assert max(out["rel_first_losses_2ranks"]) <= 1e-4, out
    return out


def rays_data_phases(dev, out_dir: str, rt512, sample, prep, full: dict,
                     batched: dict, binned_job: dict, binned: dict
                     ) -> tuple[dict, dict]:
    """Phases 4h and 4i: phase 4's crop and runtime (the 8x512 decoder, the
    stock config, the selection kernel, the float16 -> bf16 decode) over
    the ranks of parallel/mesh.py, the parent having built every kernel.

    4h, the rays axis (parallel/sharded_refine.py): (a) one rank on NCCL
    (gloo without a card), rays = 1: its first loss within 1e-5 relative
    of phase 4's single-device run; (b) two gloo ranks sharing the card,
    rays = 2, each decoding its half of the grid with the selection
    kernel, its slice of the band and rendering its block of pixel rows
    with the splat kernels: the first two losses within 1e-4 relative of
    (a)'s, and kernels 1a, 1b, 2 and 3 launched on each rank; the label
    after all the iterations printed beside (a)'s and beside phase 4d's
    lanes' gaps. 4i, the data axis, in the same spawn: phase 4d's four
    crops through make_batched_refine(mesh=) with data = 2, two lanes a
    rank: the labels beside 4d's (bit-equal expected: every kernel's crop
    axis is bit-equal to its launch alone; within 1e-3 m and rad
    required)."""
    cuda = dev.type == "cuda"
    here = f"cuda:{torch.cuda.current_device()}" if cuda else "cpu"
    anno = prep["anno"]
    rays_dir = os.path.join(out_dir, "rays")
    os.makedirs(rays_dir, exist_ok=True)
    job = dict(devices=[here], stock=rt512.cfg, prep=_cpu_prep(prep),
               crops=None, binned=binned_job)
    backend1 = "nccl" if cuda else "gloo"
    one, every1, secs1 = _run_rays(rays_dir, job, 1, backend1)
    loss1 = one["rays"]["hist"].numpy()
    rel0 = abs(float(loss1[0]) - full["loss0"]) / abs(full["loss0"])
    label1 = _sharded_label(rt512, one["rays"]["final"], sample, anno)
    iters = len(loss1)
    gap4 = _loc_yaw_gap(label1, {"location": full["location"],
                                 "rotation_y": full["rotation_y"]})
    print(f"4h: (a) 1 rank ({backend1}), rays = 1: first loss "
          f"{loss1[0]:.7f}, phase 4's {full['loss0']:.7f}, relative "
          f"{rel0:.3g} (need <= 1e-5); {iters} iterations "
          f"{one['rays']['wall_s']:.3f} s ({one['rays']['wall_s'] / iters * 1e3:.3f}"
          f" ms/iteration; phase 4: {full['wall_s'] / iters * 1e3:.3f}); "
          f"label {np.asarray(label1['location'])}, |d location| "
          f"{gap4[0]:.3g} m, |d rotation_y| {gap4[1]:.3g} rad from phase "
          f"4's; launches {one['rays']['launches']} ({secs1:.1f} s with "
          f"the spawn)")
    assert rel0 <= 1e-5, rel0

    job = dict(devices=[here] * 2, stock=rt512.cfg, prep=_cpu_prep(prep),
               crops=[_cpu_prep(c) for c in shifted_crops(prep)],
               binned=binned_job)
    two, every, secs2 = _run_rays(rays_dir, job, 2, "gloo")
    loss2 = two["rays"]["hist"].numpy()
    rel = [abs(float(a) - float(b)) / abs(float(b))
           for a, b in zip(loss2[:2], loss1[:2])]
    label2 = _sharded_label(rt512, two["rays"]["final"], sample, anno)
    gap = _loc_yaw_gap(label2, label1)
    lanes = batched["label_gaps"]
    by_rank = {k: [r["rays"]["launches"][k] for r in every]
               for k in RAYS_KERNELS}
    print(f"4h: (b) 2 gloo ranks on {here}, rays = 2: losses "
          f"{loss2[:2].tolist()} against (a)'s {loss1[:2].tolist()}, "
          f"relative {rel} (need <= 1e-4 each); {iters} iterations "
          f"{two['rays']['wall_s']:.3f} s ({two['rays']['wall_s'] / iters * 1e3:.3f}"
          f" ms/iteration); label {np.asarray(label2['location'])}, from "
          f"(a)'s: |d location| {gap[0]:.3g} m, |d rotation_y| {gap[1]:.3g} "
          f"rad (phase 4d's lanes from each crop alone: "
          f"{[round(g[0], 6) for g in lanes]} m, "
          f"{[round(g[1], 6) for g in lanes]} rad); launches by rank "
          f"{json.dumps(by_rank)}")
    assert max(rel) <= 1e-4, rel
    assert all(torch.isfinite(t).all() for t in two["rays"]["final"])
    if cuda:
        for k, n in by_rank.items():
            assert all(x > 0 for x in n), (k, n)
    rays_binned = _binned_rays_checks(
        dev, {"1 rank": every1, "2 ranks": every}, binned, binned_job)
    rays = dict(rel_first_loss_1rank=rel0, rel_first_losses_2ranks=rel,
                wall_s_1rank=one["rays"]["wall_s"],
                wall_s_2ranks=two["rays"]["wall_s"], iters=iters,
                label_gap_1rank_vs_phase4=gap4, label_gap_2ranks=gap,
                phase4d_lane_gaps=lanes, launches_by_rank=by_rank,
                launches_1rank=one["rays"]["launches"],
                spawn_s=[secs1, secs2], binned=rays_binned)

    final, ext = two["data"]["final"], two["data"]["ext"]
    got = [pipe.finish_label(
        refine_mod.RefineParams(*(p[i] for p in final)),
        labels_mod.SurfaceExtents(*(t[i] for t in ext)), sample, c["anno"])
        for i, c in enumerate(job["crops"])]
    gaps = [_loc_yaw_gap(g, w) for g, w in zip(got, batched["labels"])]
    bit_equal = all(
        np.asarray(g["location"], np.float64).tolist() == w["location"]
        and float(g["rotation_y"]) == w["rotation_y"]
        for g, w in zip(got, batched["labels"]))
    data_by_rank = {k: [r["data"]["launches"][k] for r in every]
                    for k in RAYS_KERNELS}
    print(f"4i: 4d's {len(got)} crops through make_batched_refine(mesh=), "
          f"data = 2 on 2 gloo ranks, 2 lanes each: {two['data']['wall_s']:.3f}"
          f" s; labels bit-equal to 4d's: {bit_equal}; |d location|, "
          f"|d rotation_y| by crop {gaps} (need <= 1e-3); launches by "
          f"rank {json.dumps(data_by_rank)}")
    assert max(max(g) for g in gaps) <= 1e-3, gaps
    if cuda:
        for k, n in data_by_rank.items():
            assert all(x > 0 for x in n), (k, n)
    data = dict(bit_equal=bit_equal, label_gaps=gaps,
                wall_s=two["data"]["wall_s"], launches_by_rank=data_by_rank)
    binned_by_rank = {k: [r["binned"]["render"]["launches"][k]
                          + r["binned"]["refine"]["launches"][k]
                          for r in every] for k in BINNED_KERNELS}
    launched = {"rays_sharded": {**by_rank, **binned_by_rank},
                "data_mesh": data_by_rank}
    return launched, dict(rays=rays, data_mesh=data)


# ---------------------------------------------------------------- phase 9

def render_demo_phase(dev, out_dir: str, small: bool = False):
    """Phase 9: pipelines/render_demo.py on the card against the CPU.
    render_sdf of data/optimization/deepsdf_demo.pt (grid 40, 200x100 px:
    the disc render takes the bins kernel and the binned forward, 1c) with
    each primitive, without and with a background image; render_model on
    a seeded npz ball. Each image within the splat tolerance of the CPU's
    (>= 99.5% of pixels within 2e-4, all within 1); the launches of the
    card's renders. The circles and a background render are plain torch
    on every device, as JAX renders them in plain XLA."""
    path = os.path.join(ROOT, "data", "optimization", "deepsdf_demo.pt")
    kw = dict(grid_density=16, crop_size=(100, 50)) if small else {}
    w, h = kw.get("crop_size", (200, 100))
    bg = np.random.RandomState(9).rand(3, h, w).astype(np.float32)
    demo_dir = os.path.join(out_dir, "render_demo")
    devices = [dev, torch.device("cpu")] if dev.type == "cuda" else [dev]
    images, walls, launched = {}, {}, {}
    for d in devices:
        reset_counts()
        for prim in ("disc", "circle", "circle_opt"):
            for use_bg in (False, True):
                t0 = time.perf_counter()
                r, out = render_demo.render_sdf(
                    path, prim, output_dir=demo_dir,
                    bg=bg if use_bg else None, device=d, **kw)
                img = r.color.cpu().numpy()
                walls[(d.type, prim, use_bg)] = time.perf_counter() - t0
                images.setdefault((prim, use_bg), []).append(img)
                assert img.shape == (3, h, w) and np.isfinite(img).all()
                assert png.read(out).any()
        if d.type == dev.type:
            launched = counts()
    rng = np.random.RandomState(4)
    v = rng.randn(2048, 3).astype(np.float32)
    v = 0.8 * v / np.linalg.norm(v, axis=1, keepdims=True)
    ball = os.path.join(out_dir, "ball.npz")
    np.savez(ball, vertices=v, normals=v / 0.8,
             colors=rng.rand(2048, 3).astype(np.float32))
    for d in devices:
        r, _ = render_demo.render_model(ball, output_dir=demo_dir, device=d)
        images.setdefault(("model", False), []).append(r.color.cpu().numpy())
    shares = {}
    for key, imgs in images.items():
        assert imgs[0].max() > 0.1, key
        if len(imgs) == 2:
            err = np.abs(imgs[0] - imgs[1]).max(0)
            shares[f"{key[0]}{'+bg' if key[1] else ''}"] = float(
                (err < 2e-4).mean())
            assert (err < 2e-4).mean() >= 0.995 and err.max() <= 1.0, \
                (key, (err >= 2e-4).mean(), err.max())
    print(f"9: render_demo at {w}x{h} px, share of pixels within 2e-4 of "
          f"the CPU's: {json.dumps(shares)}; seconds "
          f"{json.dumps({'/'.join(map(str, k)): round(v, 3) for k, v in walls.items()})}"
          f"; launches {launched}")
    if dev.type == "cuda":
        # the disc render without a background: the bins and 1c, once
        assert launched["splat_bins"] > 0 and launched["splat_fwd_binned"] > 0
        assert launched["splat_fwd"] == 0 and launched["splat_bwd_binned"] == 0
    return launched, dict(px=h * w, shares=shares,
                          seconds={"/".join(map(str, k)): v
                                   for k, v in walls.items()})


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
                epochs: int = 2, precision: str = "float32",
                fast_input: bool = False):
    """train_css on the phase-5 crops with the CE kernels on every tower
    (phase 6; 6b with precision bfloat16; 6e with fast_input = True, the
    fast augmentation chain). The stock fast_input = False: the PIL
    augmentation chain."""
    cfgp = train_pipe.make_config(crops_dir, log_dir, fused_ce=True,
                                  direct_ce=True, batch_size=batch,
                                  precision=precision, plot=False,
                                  fast_input=fast_input)
    cfg = cfg_mod.TrainCfg.from_ini(cfgp)
    assert (cfg.fused_ce, cfg.direct_ce, cfg.precision, cfg.batch_size,
            cfg.plot, cfg.css_path, cfg.fast_input) == (
                True, True, precision, batch, False, "", fast_input)
    tag = ("train" + (" bf16" if precision != "float32" else "")
           + (" fast" if fast_input else ""))
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
    print(f"{tag}: {len(steps)} steps of batch {batch} at width {width}, "
          f"{precision}, {wall:.3f} s wall (data, steps, checkpoints), "
          f"step ms "
          f"{[round(t, 3) for t in step_ms]} (the first two watched), "
          f"steady {steady:.3f} ms/step = "
          f"{batch / steady * 1e3:.1f} images/s, losses "
          f"{[round(x, 5) for x in losses]}, launches {launched}")
    assert np.isfinite(losses).all()
    ce_launches = None
    if dev.type == "cuda":
        print(f"{tag}: CPU operators in the step: {dict(watch.cpu_ops)}")
        assert not watch.cpu_ops
        # u, v, w and mask: one forward and one backward each per step
        assert launched["ce_fwd"] == launched["ce_bwd"] == 4 * len(steps)
        if precision == "float32" and not fast_input:
            ce_launches = ce_call_launches(dev)

    # the exported network reloads to the same one (both in fp32)
    model = state.model.eval()
    model.compute_dtype = torch.float32
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
    print(f"{tag}: css.msgpack reloaded, outputs max_abs_err {reload_err}")
    assert reload_err <= 1e-5

    # three steps on one fixed batch lower its loss
    model.train()
    model.compute_dtype = train_pipe.compute_dtype(precision)
    step = css_train.make_train_step(fused_ce=True, direct_ce=True)
    fixed_losses, fixed_ms = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        fixed_losses.append(float(step(state, fixed)["loss"]))
        fixed_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"{tag}: one fixed batch, losses before each of 4 steps "
          f"{[round(x, 5) for x in fixed_losses]}, step ms "
          f"{[round(t, 3) for t in fixed_ms]}")
    assert fixed_losses[3] < fixed_losses[0]
    return state, fixed, launched, dict(
        wall_s=wall, steps=len(steps), batch=batch, width=width,
        precision=precision, fast_input=fast_input,
        ce_call_launches=ce_launches,
        step_ms=step_ms, steady_ms_per_step=steady,
        images_per_s=batch / steady * 1e3, losses=losses,
        fixed_batch_step_ms=fixed_ms)


def _to(tree, dev):
    """A tree of dicts and lists with its tensors moved to `dev`."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev) if torch.is_tensor(tree) else tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _step_gaps(a, b) -> np.ndarray:
    """(|loss difference|, L2 over the parameters, the largest statistics
    difference over its leaf's largest element) of two CSS steps'
    (loss, flat variables)."""
    (la, va), (lb, vb) = a, b
    d = np.concatenate([np.abs(va[k] - vb[k]).ravel() for k in va
                        if k.startswith("params")])
    rel = max(float(np.abs(va[k] - vb[k]).max() / np.abs(vb[k]).max())
              for k in va if k.startswith("batch_stats"))
    return np.array([abs(la - lb), float(np.sqrt((d ** 2).sum())), rel])


HEADS = ("u_raw", "v_raw", "w_raw", "mask", "latent")


def _rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float().cpu() - b.float().cpu()).pow(2).mean().sqrt())


def bf16_card_vs_cpu(dev, crops_dir, width: int = 64) -> dict:
    """Phase 6b's checks of bf16 on the card against the CPU: a seeded
    init at width 64 on two batches of 2 phase-5 crops, run in fp32 and in
    bf16 on each device (the card: cuDNN convolutions and the CE kernels;
    the CPU: oneDNN and the plain CE).
    - The train-mode forward: on every head, the card's bf16 outputs lie
      nearer (RMS) the CPU's bf16 outputs than the CPU's fp32 ones, and
      they differ from the card's own fp32 outputs by at least half the
      CPU's bf16-vs-fp32 gap. A card run that computed in fp32 fails
      both.
    - One train step: loss, parameter L2 and BatchNorm statistics within
      twice the CPU's own bf16-vs-fp32 gap (tests/test_torch_css_bf16.py's
      rule, with the port's CPU gap where JAX's stands there; each gap the
      larger over the two batches); and the statistics of the card's bf16
      step differ from its fp32 step's by at least half the CPU's gap.
      The parameters after Adam's first step move by about lr in each
      element whatever the precision, so their L2 cannot tell bf16 from
      fp32: the forward checks do."""
    ds = crops_data.Crops(crops_dir, augment=False, stage="uint8")
    latent = len(ds.gt["0"][0]["latent"])
    cpu = torch.device("cpu")
    runs = (("cpu_f32", cpu, torch.float32), ("cpu_bf16", cpu, torch.bfloat16),
            ("card_f32", dev, torch.float32), ("card_bf16", dev, torch.bfloat16))
    gap, ref, own = np.zeros(3), np.zeros(3), np.zeros(3)
    fwd = {k: dict(to_bf16=0.0, to_f32=0.0, own=0.0, ref=0.0) for k in HEADS}
    for idx in ([0, 1], [2, 3]):
        host = crops_data.collate([ds[i] for i in idx])
        res, outs = {}, {}
        for name, d, dtype in runs:
            batch = ds.to_device(host, d)
            model = train_pipe.setup_css(None, width=width,
                                         latent_size=latent, device=d)
            model.compute_dtype = dtype
            # the forward on a copy: train mode moves the statistics
            probe = train_pipe.setup_css(None, width=width,
                                         latent_size=latent, device=d)
            probe.compute_dtype = dtype
            with torch.no_grad():
                outs[name] = probe.train()(crops_data.normalize_rgb(
                    batch["rgb"]))
            state = css_train.init_train_state(model, 1e-3)
            step = css_train.make_train_step(fused_ce=d.type == "cuda",
                                             direct_ce=True)
            m = step(state, batch)
            res[name] = (float(m["loss"]),
                         _flat(css_mod.state_to_flax(state.model)))
        for k in HEADS:
            o = {n: outs[n][k] for n in outs}
            for key, val in (("to_bf16", _rms(o["card_bf16"], o["cpu_bf16"])),
                             ("to_f32", _rms(o["card_bf16"], o["cpu_f32"])),
                             ("own", _rms(o["card_bf16"], o["card_f32"])),
                             ("ref", _rms(o["cpu_bf16"], o["cpu_f32"]))):
                fwd[k][key] = max(fwd[k][key], val)
        ref = np.maximum(ref, _step_gaps(res["cpu_bf16"], res["cpu_f32"]))
        gap = np.maximum(gap, _step_gaps(res["card_bf16"], res["cpu_bf16"]))
        own = np.maximum(own, _step_gaps(res["card_bf16"], res["card_f32"]))
    print("train bf16: train-mode forward on the card against the CPU "
          f"(width {width}, 2 x 2 crops), RMS by head: "
          + "; ".join(f"{k} to CPU bf16 {v['to_bf16']:.4g}, to CPU fp32 "
                      f"{v['to_f32']:.4g}, to the card's fp32 {v['own']:.4g} "
                      f"(the CPU's bf16-vs-fp32 {v['ref']:.4g})"
                      for k, v in fwd.items())
          + "; need to CPU bf16 < to CPU fp32 and to the card's fp32 >= "
            "0.5x the CPU's")
    names = ("loss", "params_l2", "stats_rel")
    print("train bf16: one step on the card against the CPU: "
          + ", ".join(f"{n} {g:.4g} (the CPU's bf16-vs-fp32 gap {r:.4g}, "
                      f"the card's {o:.4g})"
                      for n, g, r, o in zip(names, gap, ref, own))
          + "; need <= 2x each, and the card's stats gap >= 0.5x the CPU's")
    for k, v in fwd.items():
        assert v["to_bf16"] < v["to_f32"], (k, v)
        assert v["own"] >= 0.5 * v["ref"], (k, v)
    assert (gap <= 2 * ref).all(), (gap, ref)
    assert own[2] >= 0.5 * ref[2], (own, ref)
    return {"forward_rms": fwd,
            "card_vs_cpu": dict(zip(names, gap.tolist())),
            "cpu_bf16_vs_fp32": dict(zip(names, ref.tolist())),
            "card_bf16_vs_fp32": dict(zip(names, own.tolist()))}


def input_chains_card_vs_cpu(dev, crops_dir, epochs: int = 2) -> dict:
    """Phase 6e's check of both augmentation chains (data/crops.py) on the
    card against the same chain on the CPU: every phase-5 crop, augmented
    from seed 3 over `epochs` epochs, through ``Crops.to_device`` on each.
    Each chain is held to the tolerance its CPU test holds it to against
    the JAX package: the fast chain (tests/test_torch_crops.py) RGB within
    2 LSB with >= 99.9% of values equal, UVW and mask >= 99.5% equal; the
    PIL chain (tests/test_torch_crops_pil.py) RGB within 1 LSB with >=
    99.5% equal, UVW and mask >= 99.5% equal."""
    cpu = torch.device("cpu")
    tol = {True: (2, 0.999), False: (1, 0.995)}
    out = {}
    for fast in (True, False):
        ds = crops_data.Crops(crops_dir, seed=3, fast=fast, stage="uint8")
        rgb_diff, shares = 0, {"rgb": 1.0, "uvw": 1.0, "mask": 1.0}
        for epoch in range(epochs):
            ds.set_epoch(epoch)
            host = crops_data.collate([ds[i] for i in range(len(ds))])
            card, ref = ds.to_device(host, dev), ds.to_device(host, cpu)
            for k in shares:
                a, b = card[k].cpu(), ref[k]
                assert a.shape == b.shape and a.dtype == b.dtype, k
                shares[k] = min(shares[k], float((a == b).float().mean()))
            rgb_diff = max(rgb_diff, int((card["rgb"].cpu().int()
                                          - ref["rgb"].int()).abs().max()))
        chain = "fast" if fast else "pil"
        print(f"train {chain} chain: the card against the CPU over "
              f"{len(ds)} crops x {epochs} epochs, RGB max diff {rgb_diff} "
              f"LSB, equal shares {json.dumps(shares)} (need RGB <= "
              f"{tol[fast][0]} LSB with >= {tol[fast][1]:.1%} equal, UVW and "
              f"mask >= 99.5% equal)")
        assert rgb_diff <= tol[fast][0] and shares["rgb"] >= tol[fast][1]
        assert shares["uvw"] >= 0.995 and shares["mask"] >= 0.995
        out[chain] = dict(rgb_max_diff=rgb_diff, equal_share=shares)
    return out


def fused_phase(dev, state, fixed, fp32_fixed_ms: list, steps: int = 2):
    """Phase 6c: the fused-head net (models/css_fused.py) from phase 6's
    trained fp32 network: its eval outputs on the fixed batch within 2e-4
    of each output's scale (max(|output|, 1)) of the unfused net's, then
    `steps` train steps on that batch with the CE kernels."""
    model = state.model
    if model.conv1.weight.shape[0] != 64:  # the CPU rehearsal's width 8
        model = train_pipe.setup_css(None, width=64, device=dev)
    model.eval()
    fused = css_fused.fused_from_css(model)
    x = crops_data.normalize_rgb(fixed["rgb"])
    with torch.no_grad():
        a, b = model(x), fused(x)
    model.train()
    errs = {k: float((b[k] - a[k]).abs().max()) for k in a}
    worst = max(errs[k] / max(float(a[k].abs().max()), 1.0) for k in a)
    print(f"train fused: the fused-head net against the unfused one on "
          f"{len(x)} crops, max_abs_err by output "
          f"{json.dumps({k: round(v, 8) for k, v in errs.items()})}, "
          f"largest over its output's scale {worst:.3g} (need <= 2e-4)")
    assert worst <= 2e-4
    fstate = css_train.init_train_state(fused, 1e-3)
    step = css_train.make_train_step(fused_ce=True, direct_ce=True)
    reset_counts()
    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(step(fstate, fixed)["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    launched = counts()
    print(f"train fused: {steps} steps on the fixed batch of "
          f"{len(x)}, step ms {[round(t, 3) for t in ms]} (the unfused "
          f"net's on the same batch, phase 6: "
          f"{[round(t, 3) for t in fp32_fixed_ms]}), losses "
          f"{[round(v, 5) for v in losses]}, launches {launched}")
    assert np.isfinite(losses).all()
    if dev.type == "cuda":
        assert launched["ce_fwd"] == launched["ce_bwd"] == 4 * steps
    return launched, dict(max_abs_err=errs, max_scaled_err=worst,
                          step_ms=ms, losses=losses,
                          unfused_fixed_batch_step_ms=fp32_fixed_ms)


# ---------------------------------------------------------------- phase 8

def dsdf_experiment(out_dir: str, n_scenes: int, rows: int, dims: tuple,
                    scenes_per_batch: int, samples: int) -> str:
    """A DeepSDF experiment directory in out_dir: `n_scenes` analytic
    scenes (spheres and rounded boxes of seeded sizes) of `rows` sample
    rows each from sample_analytic_sdf, written as SdfSamples npz files,
    a split and the specs of the reference decoder at width `dims` (weight
    norm, latent_in 4, latent 3, dropout 0.2 on every layer)."""
    rng = np.random.RandomState(21)
    names = [f"scene{i:04d}" for i in range(n_scenes)]
    for i, name in enumerate(names):
        r = rng.uniform(0.3, 0.7)
        half = rng.uniform(0.2, 0.5, 3)
        if i % 2:
            def sdf(p, r=r):
                return np.linalg.norm(p, axis=-1) - r
        else:
            def sdf(p, h=half):
                q = np.abs(p) - h
                return (np.linalg.norm(np.maximum(q, 0), axis=-1)
                        + np.minimum(q.max(-1), 0) - 0.05)
        pos, neg = sdf_samples.sample_analytic_sdf(sdf, rng, rows)
        sdf_samples.write_sdf_samples(os.path.join(
            out_dir, "SdfSamples", "synthetic", "car", name + ".npz"),
            pos, neg)
    exp = os.path.join(out_dir, "exp")
    os.makedirs(exp, exist_ok=True)
    with open(os.path.join(exp, "split.json"), "w") as f:
        json.dump({"synthetic": {"car": names}}, f)
    cfg = deepsdf.DeepSDFConfig(
        latent_size=3, dims=dims, dropout=tuple(range(len(dims))),
        dropout_prob=0.2, norm_layers=tuple(range(len(dims))),
        latent_in=(4,), weight_norm=True)
    specs = deepsdf.specs_from_config(cfg)
    specs.update({"TrainSplit": "split.json", "DataSource": out_dir,
                  "SamplesPerScene": samples,
                  "ScenesPerBatch": scenes_per_batch,
                  "CodeRegularizationLambda": 1e-4, "CodeBound": 1.0})
    with open(os.path.join(exp, "specs.json"), "w") as f:
        json.dump(specs, f)
    return exp


def deepsdf_train_phase(dev, out_dir: str, small: bool = False):
    """Phase 8: train_deepsdf at the reference batch through the reference
    8x512 decoder (dropout 0.2 on all layers): 128 analytic scenes, 64 a
    step x 16384 samples = 1,048,576 rows a step, 2 epochs of 2 steps; the
    batch is halved until the step fits the card, and the cut printed.
    ms/step, rows/s, peak memory; the loss finite and falling; no CPU
    operator in the first two steps; one step on the card against the same
    step on the CPU (same state, the same drawn rows, dropout off) on 8
    scenes; the exported deepsdf.pt reloaded to equal SDFs. The loss
    must fall from the first step to the last (each step's own scenes and
    dropout masks); a fixed draw's loss without dropout is printed
    beside."""
    n_scenes, bsz, samples, dims = ((8, 4, 256, (32,) * 8) if small
                                    else (128, 64, 16384, (512,) * 8))
    root = os.path.join(out_dir, "dsdf")
    exp = dsdf_experiment(root, n_scenes, 2 * samples, dims, bsz, samples)
    watch = _cpu_op_watch()
    while True:
        steps = []

        def timed(step_fn):
            def step(state, scene_idx):
                t0 = time.perf_counter()
                if len(steps) < 2:
                    with watch:
                        out = step_fn(state, scene_idx)
                else:
                    out = step_fn(state, scene_idx)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                steps.append((time.perf_counter() - t0,
                              float(out[1]["loss"])))
                return out
            return step

        for name in os.listdir(exp):
            if name in ("Checkpoints", "ModelParameters", "LatentCodes"):
                shutil.rmtree(os.path.join(exp, name))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            state = dsdf_pipe.train_deepsdf(exp, num_epochs=2, device=dev,
                                            log_every=1, step_wrapper=timed)
            break
        except torch.cuda.OutOfMemoryError:
            if bsz == 1:
                raise
            bsz //= 2
            print(f"deepsdf train: out of memory, the batch cut to {bsz} "
                  f"scenes x {samples} samples")
            with open(os.path.join(exp, "specs.json")) as f:
                specs = json.load(f)
            specs["ScenesPerBatch"] = bsz
            with open(os.path.join(exp, "specs.json"), "w") as f:
                json.dump(specs, f)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rows = bsz * samples
    step_ms = [t * 1e3 for t, _ in steps]
    losses = [x for _, x in steps]
    steady = statistics.median(step_ms[2:] or step_ms)
    _, spe = deepsdf_train.epoch_steps(n_scenes, bsz)
    print(f"deepsdf train: {len(steps)} steps of {bsz} scenes x {samples} "
          f"samples = {rows} rows through {len(dims)}x{dims[0]} (dropout "
          f"0.2), {wall:.3f} s wall, step ms "
          f"{[round(t, 3) for t in step_ms]} (the first two watched), "
          f"steady {steady:.3f} ms/step = {rows / steady * 1e3:.0f} rows/s, "
          f"peak memory {peak / 2**30:.2f} GiB, losses "
          f"{[round(x, 6) for x in losses]}")
    assert len(steps) == 2 * spe and state.step == 2 * spe
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    if dev.type == "cuda":
        print(f"deepsdf train: CPU operators in the step: "
              f"{dict(watch.cpu_ops)}")
        assert not watch.cpu_ops

    # one step on the card and on the CPU from the same state and rows
    cfg = deepsdf.DeepSDFConfig.from_specs(json.load(open(os.path.join(
        exp, "specs.json"))))
    tcfg = deepsdf_train.DeepSDFTrainConfig.from_specs(json.load(open(
        os.path.join(exp, "specs.json"))))
    pack = sdf_samples.load_scene_pack(root, {"synthetic": {"car": [
        f"scene{i:04d}" for i in range(n_scenes)]}})
    tensors = deepsdf_train.TrainTensors(pack, dev)
    idx = torch.arange(min(8, n_scenes), device=dev)
    rows_cmp = deepsdf_train.draw(tensors, idx, samples,
                                  dsdf_pipe.step_generator(9, 0, dev))
    # beside the steps' own losses (with dropout, each on its scenes):
    # the loss of one fixed draw, dropout off, from the initial state
    # (train_deepsdf's seed 0) and from the trained one
    init = deepsdf_train.init_train_state(
        cfg, tcfg, n_scenes, torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        loss0 = float(deepsdf_train.losses(
            cfg, tcfg, init.params, init.codes, rows_cmp, idx,
            tensors.scales, 0)["loss"])
    t0 = time.perf_counter()
    on_card, m_card = deepsdf_train.step_on_samples(
        cfg, tcfg, spe, state, rows_cmp, idx, tensors.scales)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    card_s = time.perf_counter() - t0

    cpu_state = deepsdf_train.state_from_tree(_to(
        deepsdf_train.state_tree(state), "cpu"))
    t0 = time.perf_counter()
    on_cpu, m_cpu = deepsdf_train.step_on_samples(
        cfg, tcfg, spe, cpu_state, rows_cmp.cpu(), idx.cpu(),
        tensors.scales.cpu())
    cpu_s = time.perf_counter() - t0
    a = deepsdf_train._leaves(deepsdf_train.state_tree(on_card))
    c = deepsdf_train._leaves(deepsdf_train.state_tree(on_cpu))
    step_err = max(float((x.cpu().float() - y.float()).abs().max())
                   for x, y in zip(a, c) if torch.is_tensor(x))
    loss_rel = abs(float(m_card["loss"]) - float(m_cpu["loss"])) / abs(
        float(m_cpu["loss"]))
    print(f"deepsdf train: loss of one fixed draw {loss0:.6f} at the start, "
          f"{float(m_card['loss']):.6f} after {len(steps)} steps (dropout "
          f"off)")
    assert np.isfinite(float(m_card["loss"]))
    print(f"deepsdf train: one step on {len(idx)} scenes x {samples} "
          f"samples, card ({card_s:.3f} s) against CPU ({cpu_s:.3f} s): "
          f"loss relative {loss_rel:.3g} (need <= 1e-5), state max_abs_err "
          f"{step_err:.3g} (need <= 1e-5)")
    assert loss_rel <= 1e-5 and step_err <= 1e-5

    # the exported single-file pair reloads to the same decoder
    cfg2, params2 = deepsdf.load_torch_checkpoint(
        os.path.join(exp, "deepsdf.pt"), device=dev)
    assert cfg2 == cfg
    pts = torch.rand(4096, 3, generator=torch.Generator().manual_seed(3)
                     ).to(dev) * 2 - 1
    with torch.no_grad():
        want = deepsdf.sdf_fn(cfg, state.params)(state.codes[:2], pts)
        got = deepsdf.sdf_fn(cfg, params2)(state.codes[:2], pts)
    export_err = float((want - got).abs().max())
    print(f"deepsdf train: deepsdf.pt reloaded by load_torch_checkpoint, "
          f"SDFs max_abs_err {export_err:.3g} (need <= 1e-6)")
    assert export_err <= 1e-6
    handles = dict(exp=exp, root=root, state=state, samples=samples,
                   scenes=n_scenes, batch=bsz, spe=spe)
    return handles, dict(scenes=n_scenes, scenes_per_batch=bsz,
                batch_cut=bsz != (4 if small else 64),
                samples_per_scene=samples, rows_per_step=rows,
                dims=list(dims), steps=len(steps), wall_s=wall,
                step_ms=step_ms, steady_ms_per_step=steady,
                rows_per_s=rows / steady * 1e3, peak_memory_bytes=peak,
                losses=losses, fixed_draw_loss=[loss0, float(m_card["loss"])],
                card_vs_cpu_step_err=step_err,
                card_vs_cpu_loss_rel=loss_rel, export_err=export_err)


# ------------------------------------------------------ phases 6d and 8b

def _css_record(state, metrics) -> dict:
    """A CSS step's metrics, parameters, gradients and statistics (numpy,
    by parameter name)."""
    model = state.model
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {n: p.detach().cpu().numpy()
                       for n, p in model.named_parameters()},
            "grads": {n: p.grad.cpu().numpy()
                      for n, p in model.named_parameters()
                      if p.grad is not None},
            "stats": {n: b.cpu().numpy() for n, b in model.named_buffers()}}


def _css_dp_step(css: dict, dev, mesh=None) -> dict:
    """One CSS step of phase 6d's job from its carried variables, plain
    (no mesh) or data-parallel over `mesh` on the global batch."""
    model = css_mod.params_from_jax(css["vars"], css["width"],
                                    css["latent"], dev)
    state = css_train.init_train_state(model, css["lr"])
    step = css_train.make_train_step(fused_ce=css["fused"], direct_ce=True)
    if mesh is not None:
        step = css_train.shard_train_step(step, mesh)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in css["batch"].items()}
    return _css_record(state, step(state, batch))


def _dsdf_tree(state) -> list:
    return [x.cpu() if torch.is_tensor(x) else x
            for x in deepsdf_train._leaves(deepsdf_train.state_tree(state))]


def _dsdf_inputs(job: dict, dev):
    specs = json.load(open(os.path.join(job["exp"], "specs.json")))
    cfg = deepsdf.DeepSDFConfig.from_specs(specs)
    tcfg = deepsdf_train.DeepSDFTrainConfig.from_specs(specs)
    split = json.load(open(os.path.join(job["exp"], "split.json")))
    tensors = deepsdf_train.TrainTensors(
        sdf_samples.load_scene_pack(job["root"], split), dev)
    return cfg, tcfg, tensors


def dp_rank(rank: int, out_dir: str, job: dict) -> None:
    """One rank of phases 6d and 8b (a process of mesh.spawn_ranks): the
    data-parallel CSS step, and train_deepsdf over the mesh ('train') or
    one data-parallel DeepSDF step ('step'); the results go to
    out_dir/dp_<rank>.pt."""
    dev = torch.device(job["devices"][rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    mesh = mesh_mod.make_mesh()
    out = {"css": _css_dp_step(job["css"], dev, mesh)}
    d = job["dsdf"]
    if d["mode"] == "train":
        state = dsdf_pipe.train_deepsdf(d["exp"], num_epochs=d["epochs"],
                                        mesh=mesh, device=dev,
                                        log_every=1000, resume=False)
    else:
        cfg, tcfg, tensors = _dsdf_inputs(d, dev)
        state = deepsdf_train.state_from_tree(
            _to(d["state"], dev))
        step = deepsdf_train.shard_train_step(deepsdf_train.train_step, mesh)
        state, m = step(cfg, tcfg, d["spe"], state, tensors,
                        torch.as_tensor(d["scenes"], device=dev),
                        dsdf_pipe.step_generator(d["seed"], 0, dev))
        out["dsdf_metrics"] = {k: float(v) for k, v in m.items()}
    out["dsdf"] = _dsdf_tree(state)
    torch.save(out, os.path.join(out_dir, f"dp_{rank}.pt"))


def _run_dp(out_dir: str, job: dict, world: int, backend: str) -> list:
    """Spawn `world` ranks of dp_rank; their results, which must agree
    bit for bit."""
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    t0 = time.perf_counter()
    mesh_mod.spawn_ranks(dp_rank, world, (out_dir, job), backend=backend)
    res = [torch.load(os.path.join(out_dir, f"dp_{r}.pt"),
                      weights_only=False) for r in range(world)]
    for r in res[1:]:
        assert _css_gaps(r["css"], res[0]["css"])["bit_equal"]
        assert all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                   for x, y in zip(r["dsdf"], res[0]["dsdf"]))
    return res[0], time.perf_counter() - t0


def _css_gaps(got: dict, want: dict) -> dict:
    """The DP step against the one-rank step: loss relative; gradients
    relative in L2 over every leaf ('grads_max': max_abs_err over the
    largest element: the fast variance E[x^2] - E[x]^2 of a channel with
    a large mean cancels, so single elements part further); statistics
    and
    parameters (where |g| >= 1e-5; elsewhere Adam's first step turns
    rounding-level gradients into +-lr) max_abs_err; all the parameters'
    max_abs_err (<= 2 lr); whether every value is bit-equal."""
    gm, wm = got["metrics"]["loss"], want["metrics"]["loss"]
    out = {"loss_rel": abs(gm - wm) / abs(wm),
           "grads_max": max(float(np.abs(got["grads"][k] - g).max())
                            for k, g in want["grads"].items()) / max(
                                float(np.abs(g).max())
                                for g in want["grads"].values()),
           "grads": float(np.sqrt(
               sum(((got["grads"][k] - g) ** 2).sum()
                   for k, g in want["grads"].items())
               / sum((g ** 2).sum() for g in want["grads"].values()))),
           "stats": max(float(np.abs(got["stats"][k] - v).max())
                        for k, v in want["stats"].items()),
           "params_all": max(float(np.abs(got["params"][k] - v).max())
                             for k, v in want["params"].items())}
    out["params"] = max(
        float(np.abs(got["params"][k] - v)[np.abs(want["grads"][k]) >= 1e-5]
              .max(initial=0)) for k, v in want["params"].items()
        if k in want["grads"])
    out["bit_equal"] = all(
        np.array_equal(got[g][k], want[g][k])
        for g in ("params", "grads", "stats") for k in want[g]) and all(
        got["metrics"][k] == want["metrics"][k] for k in want["metrics"])
    return out


def dp_phases(dev, out_dir: str, crops_dir: str, dsdf: dict,
              small: bool = False) -> dict:
    """Phases 6d and 8b: the data-parallel CSS and DeepSDF steps
    (parallel/mesh.py over torch.distributed, spawned ranks).

    6d: the width-64 CSS net from a seeded init on 12 phase-5 crops (2
    ranks x 6): one rank on NCCL (gloo without a card) must equal the
    plain step bit for bit (the CE kernels on, as at world 1 in JAX); two
    ranks sharing the card over gloo (the CE kernels off, as JAX keeps
    them off a mesh) must be within 1e-5 of the one-rank step: the loss
    (relative), the statistics, and the parameters wherever |g| >= 1e-5
    (all within 2 lr); the gradients within 1e-3 relative in L2 (2e-5 on
    the CPU rehearsal's crops, where the fast variance of a channel with
    a large mean cancels; 0.78 without the backward all-reduce of the
    statistics, whose loss is unchanged). 8b: one NCCL rank's train_deepsdf(mesh=) must
    equal phase 8's run bit for bit; two gloo ranks' step on 16 scenes x
    phase 8's samples (a cut: two full-batch ranks would need ~77 GiB)
    from phase 8's state must equal the one-rank step to JAX's
    sharded-vs-single bounds (loss 1e-6 relative, state rtol 2e-5, atol
    1e-7). With two or more cards, two NCCL ranks, one card each, are
    held to the same bounds."""
    cuda = dev.type == "cuda"
    here = f"cuda:{torch.cuda.current_device()}" if cuda else "cpu"
    width, n, lr = (8, 4, 1e-3) if small else (64, 12, 1e-3)
    ds = crops_data.Crops(crops_dir, augment=False, stage="uint8")
    latent = len(ds.gt["0"][0]["latent"])
    batch = ds.to_device(crops_data.collate([ds[i % len(ds)]
                                             for i in range(n)]), "cpu")
    init = train_pipe.setup_css(None, width=width, latent_size=latent,
                                device="cpu")
    css = dict(vars=css_mod.state_to_flax(init), width=width, latent=latent,
               lr=lr, batch={k: v.numpy() for k, v in batch.items()})
    torch.backends.cudnn.deterministic = True
    one_fused = _css_dp_step(dict(css, fused=True), dev)
    one_plain = _css_dp_step(dict(css, fused=False), dev)
    torch.backends.cudnn.deterministic = False

    # 8b's inputs: phase 8's experiment (a copy: rank 0 writes there) and
    # its final state
    exp = dsdf["exp"] + "_dp"
    os.makedirs(exp, exist_ok=True)
    for name in ("specs.json", "split.json"):
        shutil.copy(os.path.join(dsdf["exp"], name), exp)
    state8 = dsdf["state"]
    scenes = list(range(4 if small else 16))
    cfg, tcfg, tensors = _dsdf_inputs(dict(exp=exp, root=dsdf["root"]), dev)
    one_dsdf, one_m = deepsdf_train.train_step(
        cfg, tcfg, dsdf["spe"], state8, tensors,
        torch.as_tensor(scenes, device=dev),
        dsdf_pipe.step_generator(5, 0, dev))
    one_dsdf = _dsdf_tree(one_dsdf)
    del tensors
    if cuda:
        torch.cuda.empty_cache()
    step_job = dict(mode="step", exp=exp, root=dsdf["root"],
                    state=_to(deepsdf_train.state_tree(state8), "cpu"),
                    scenes=scenes, spe=dsdf["spe"], seed=5)
    dp_dir = os.path.join(out_dir, "dp")
    os.makedirs(dp_dir, exist_ok=True)
    summary = {}

    # one rank on the production backend
    backend1 = "nccl" if cuda else "gloo"
    job = dict(devices=[here], css=dict(css, fused=True),
               dsdf=dict(mode="train", exp=exp, epochs=2))
    res, secs = _run_dp(dp_dir, job, 1, backend1)
    gaps = _css_gaps(res["css"], one_fused)
    dsdf_equal = all(torch.equal(x, y.cpu()) if torch.is_tensor(x)
                     else x == y for x, y in zip(res["dsdf"],
                                                 _dsdf_tree(state8)))
    print(f"6d: the CSS step over a 1-rank {backend1} mesh (fused CE) "
          f"against the plain step: bit-equal {gaps['bit_equal']} "
          f"({secs:.1f} s with 8b's run)")
    print(f"8b: train_deepsdf(mesh=) on a 1-rank {backend1} mesh against "
          f"phase 8's run: state bit-equal {dsdf_equal}")
    assert gaps["bit_equal"] and dsdf_equal
    summary["css_world1"] = dict(backend=backend1, **gaps)
    summary["dsdf_world1"] = dict(backend=backend1, bit_equal=dsdf_equal)

    # two ranks: on the one card over gloo, and one card each over NCCL
    runs = [("gloo", [here] * 2)]
    if cuda and torch.cuda.device_count() >= 2:
        runs.append(("nccl", ["cuda:0", "cuda:1"]))
    for backend, devices in runs:
        job = dict(devices=devices, css=dict(css, fused=False),
                   dsdf=step_job)
        res, secs = _run_dp(dp_dir, job, 2, backend)
        g = _css_gaps(res["css"], one_plain)
        print(f"6d: 2 ranks ({backend}, {devices}) of {n // 2} crops against "
              f"one rank's step on the {n}: loss relative "
              f"{g['loss_rel']:.3g}, gradients relative (L2) "
              f"{g['grads']:.3g} (need <= 1e-3; the largest element's error "
              f"over the largest gradient {g['grads_max']:.3g}), statistics "
              f"{g['stats']:.3g}, "
              f"parameters where |g| >= 1e-5 {g['params']:.3g} (need <= "
              f"1e-5 each), all parameters {g['params_all']:.3g} (need <= "
              f"2 lr) ({secs:.1f} s with 8b's step)")
        assert max(g["loss_rel"], g["stats"], g["params"]) <= 1e-5
        assert g["params_all"] <= 2 * lr * 1.01 and g["grads"] <= 1e-3
        loss_rel = abs(res["dsdf_metrics"]["loss"] - float(one_m["loss"])) \
            / abs(float(one_m["loss"]))
        state_err = [float(((x.float() - y.float()).abs()
                            - 2e-5 * y.float().abs()).max())
                     for x, y in zip(res["dsdf"], one_dsdf)
                     if torch.is_tensor(x) and x.is_floating_point()]
        print(f"8b: 2 ranks ({backend}) of {len(scenes) // 2} scenes x "
              f"{dsdf['samples']} samples against one rank's step on "
              f"{len(scenes)} (cut from phase 8's batch of "
              f"{dsdf['batch']} of {dsdf['scenes']} scenes: two full-batch "
              f"ranks would need ~77 GiB): loss "
              f"relative {loss_rel:.3g} (need <= 1e-6), state |err| - 2e-5 "
              f"|x| at most {max(state_err):.3g} (need <= 1e-7)")
        assert loss_rel <= 1e-6 and max(state_err) <= 1e-7
        summary[f"css_world2_{backend}"] = dict(devices=devices, **g)
        summary[f"dsdf_world2_{backend}"] = dict(
            devices=devices, scenes=len(scenes), samples=dsdf["samples"],
            loss_rel=loss_rel, state_excess=max(state_err))
    return summary


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
    meta = quality_suite.build_suite(suite, n_frames, profile="v2",
                                     device=dev)
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

    route = pipe.setup_runtime(quality_cfgp(suite, out_dir),
                               device=dev).stage2_route
    runs = {}
    # the default (batched, what main.py --refine runs), then one crop
    # after another over the same frames
    for mode, batched in (("batched", True), ("sequential", False)):
        labels = os.path.join(out_dir, f"labels_{mode}")
        cfgp = quality_cfgp(suite, labels, iters)
        reset_counts()
        t0 = time.perf_counter()
        annos, ests = pipe.refine_css(cfgp, batched=batched, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        dumps = sorted(f for f in os.listdir(labels) if f.endswith(".pkl"))
        n_gt = sum(len(a["location"]) for a in annos.values())
        n_est = sum(len(e["location"]) for e in ests.values())
        print(f"driver, {mode}: stage 2 {route} (the 3x96 quality decoder "
              f"is outside the packer), {len(dumps)} dumps, {n_gt} crops, "
              f"{n_est} labels, {wall:.3f} s wall (in-process evaluation "
              f"included), {wall / max(n_gt, 1):.3f} s/crop, "
              f"{n_frames / wall:.4f} frames/s, launches {launched}")
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
        print(f"evaluation, {mode}: {eval_s:.3f} s; AP per difficulty (at "
              f"the two thresholds) {json.dumps(ap)}")
        if dev.type == "cuda":
            hold_against_jax(ap, n_frames)
        runs[mode] = (launched, dict(
            driver_s=wall, crops=n_gt, labels=n_est,
            s_per_crop=wall / max(n_gt, 1), frames_per_s=n_frames / wall,
            eval_s=eval_s, **ap))
    print(f"driver: {runs['batched'][1]['s_per_crop']:.4f} s/crop batched, "
          f"{runs['sequential'][1]['s_per_crop']:.4f} s/crop sequential")
    launched, batched_summary = runs["batched"]
    return launched, dict(frames=n_frames, cars=meta["objects"],
                          tiers=meta["difficulty_tiers"], build_s=build_s,
                          stage2_route=route, **batched_summary,
                          sequential=runs["sequential"][1])


# --------------------------------------------------------------- phase 10

def _max_gap(a: dict, b: dict) -> float:
    la, lb = deepsdf_train._leaves(a), deepsdf_train._leaves(b)
    assert len(la) == len(lb)
    return max(float((x.cpu() - y.cpu()).abs().max()) for x, y in
               zip(la, lb))


def _fit_step_card_vs_cpu(dev, params, steps: int = 5, cfg=None,
                          shapes=quality_suite.SHAPES) -> dict:
    """From the fitted decoder `cfg` (by default the suite's) with a fresh
    Adam state, `steps` fit steps on `shapes` on the card (draws from a
    seeded CPU generator), then one more step on the card and on the CPU
    from that same state and draws: parameters within 1e-5 (1% of the
    learning rate; the matmuls sum in other orders), the L1 within 1e-6
    relative."""
    qs = quality_suite
    gen = torch.Generator().manual_seed(qs.SEED + 5)
    state = qs.fit_state(params)

    def draw():
        return qs.fit_draw(gen, "cpu", len(shapes))

    for _ in range(steps):
        state, _ = qs.fit_step(state, *(d.to(dev) for d in draw()), cfg,
                               shapes)
    draws = draw()
    cpu_state = qs.FitState(
        deepsdf._map_tree(lambda t: t.cpu(), state.params),
        deepsdf_train.AdamState(
            state.opt.count.cpu(),
            deepsdf._map_tree(lambda t: t.cpu(), state.opt.mu),
            deepsdf._map_tree(lambda t: t.cpu(), state.opt.nu)), state.step)
    card, l_card = qs.fit_step(state, *(d.to(dev) for d in draws), cfg,
                               shapes)
    cpu, l_cpu = qs.fit_step(cpu_state, *draws, cfg, shapes)
    gap = _max_gap(card.params, cpu.params)
    rel = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    assert gap <= 1e-5 and rel <= 1e-6, (gap, rel)
    return dict(param_gap=gap, l1_rel=rel)


def _css_step_card_vs_cpu(dev, draw, width: int, batch: int,
                          seed: int) -> dict:
    """One CSS step (quality_suite.css_step) from the init seeded with
    `seed` on the same batch of `draw()`s, on the card (cuDNN convolutions
    without TF32, kernel 5) and on the CPU (the plain cross-entropy): the
    loss within 1e-4 relative, >= 99.5% of the parameters within 1e-5 and
    all within 2 lr (Adam's first step is lr x sign(g): the biases that a
    BatchNorm follows have no true gradient, and their fp32 noise takes
    either sign), the batch statistics within 1e-4 relative and 1e-5."""
    qs = quality_suite
    samples = [draw() for _ in range(batch)]
    out = {}
    for d in (dev, torch.device("cpu")):
        model = css_mod.init_params(css_mod.CSSNet(width=width),
                                    torch.Generator().manual_seed(seed))
        model = model.to(d).train()
        opt = css_train.Adam(model.named_parameters(), qs.LR)
        loss = qs.css_step(model, opt, qs.stack_batch(samples, d))
        out[d.type] = (float(loss), {k: v.cpu() for k, v in
                                     model.state_dict().items()})
    (l_card, card), (l_cpu, cpu) = out[dev.type], out["cpu"]
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    params = torch.cat([(card[k] - cpu[k]).abs().flatten() for k in card
                        if not k.endswith((".mean", ".var"))])
    share = float((params <= 1e-5).float().mean())
    for k in card:
        if k.endswith((".mean", ".var")):
            torch.testing.assert_close(card[k], cpu[k], rtol=1e-4,
                                       atol=1e-5)
    assert rel <= 1e-4 and share >= 0.995, (rel, share)
    assert float(params.max()) <= 2 * qs.LR * 1.01, float(params.max())
    return dict(loss_rel=rel, share_within_1e5=share,
                param_max_gap=float(params.max()))


def suite_remake_phase(dev, out_dir: str, small: bool = False):
    """Phase 10: tools/quality_suite.py remakes the suite's nets: 300 fit
    steps of the 4-shape DeepSDF, 4 v1 frames from the fitted decoder
    (each car's 320^2 render through the bins kernel and 1c), 20 suite-CSS
    steps at width 16 and batch 8 (kernel 5 forward and backward on each of
    the four cross-entropy terms), the nets written under the run's
    temporary directory. Every number finite, the L1 and the loss falling;
    one fit step and one CSS step card against CPU; the written nets read
    back by the driver's loaders equal to what was trained."""
    qs = quality_suite
    fit_steps, n_frames, css_steps, width, batch = (
        (20, 1, 2, 8, 2) if small else (300, 4, 20, 16, 8))
    work = os.path.join(out_dir, "suite_remake")
    suite, nets = os.path.join(work, "suite"), os.path.join(work, "nets")
    os.makedirs(nets)
    seconds, launched = {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        return out

    cfg, params, fit_l1 = timed("fit", lambda: qs.fit_deepsdf(
        fit_steps, device=dev, log_every=100))
    fit_l1 = fit_l1.cpu().numpy()
    k = max(1, fit_steps // 6)
    eval_l1 = qs.fit_eval_l1(cfg, params)
    eval_l1_init = qs.fit_eval_l1(cfg, qs.init_fit(dev).params)
    assert np.isfinite(fit_l1).all() and np.isfinite(eval_l1)
    assert fit_l1[-k:].mean() < fit_l1[:k].mean() and eval_l1 < eval_l1_init
    fit_check = _fit_step_card_vs_cpu(dev, params)

    reset_counts()
    rend = qs.Renderer(deepsdf.sdf_fn(cfg, params), dev)
    frames_meta, _ = timed("frames", lambda: qs.build_frames(
        suite, n_frames, rend, "v1"))
    launched["suite_v1"] = counts()
    cars = sum(len(m[1]) for m in frames_meta)
    assert len(frames_meta) == n_frames and cars > 0
    for _name, annos, nocs, mask in frames_meta:
        assert np.isfinite(nocs).all() and mask.any()
        for a in annos:
            assert np.isfinite(a["location"] + a["dimensions"]).all()

    reset_counts()
    model, css_loss = timed("css", lambda: qs.train_suite_css(
        frames_meta, suite, width=width, steps=css_steps, batch=batch,
        device=dev, log_every=10))
    launched["suite_css"] = counts()
    css_loss = css_loss.cpu().numpy()
    k = max(1, css_steps // 4)
    assert np.isfinite(css_loss).all()
    # (a rehearsal's 2 steps of 2 crops are too few to fall surely)
    assert small or css_loss[-k:].mean() < css_loss[:k].mean(), css_loss
    css_check = _css_step_card_vs_cpu(
        dev, qs.crop_sampler(frames_meta, suite, device="cpu"), width, batch,
        qs.SEED)

    # written, then read back by the loaders the driver uses
    dsdf_path = os.path.join(nets, "deepsdf_quality.pt")
    css_path = os.path.join(nets, "css_quality.msgpack")
    deepsdf.save_torch_checkpoint(dsdf_path, cfg, params)
    qs.save_css(css_path, model)
    _, back = deepsdf.load_torch_checkpoint(dsdf_path, device=dev)
    assert _max_gap(back, params) == 0.0
    css_back = css_mod.load_css(css_path, width, device=dev)
    trained = model.state_dict()
    assert all(torch.equal(v, trained[k])
               for k, v in css_back.state_dict().items())
    print(f"10: suite remake: fit {fit_steps} steps L1 {fit_l1[0]:.5f} -> "
          f"{fit_l1[-1]:.5f}, fixed-set L1 {eval_l1:.5f} (init "
          f"{eval_l1_init:.5f}); {n_frames} v1 frames, {cars} cars; CSS "
          f"{css_steps} steps loss {css_loss[0]:.4f} -> {css_loss[-1]:.4f}; "
          f"card against CPU: fit {json.dumps(fit_check)}, CSS "
          f"{json.dumps(css_check)}; nets read back equal; seconds "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}; "
          f"launches {json.dumps(launched)}")
    if dev.type == "cuda":
        assert launched["suite_v1"]["splat_bins"] > 0
        assert launched["suite_v1"]["splat_fwd_binned"] > 0
        assert launched["suite_css"]["ce_fwd"] > 0
        assert launched["suite_css"]["ce_bwd"] > 0
    return launched, dict(
        fit_steps=fit_steps, fit_l1_first=float(fit_l1[0]),
        fit_l1_last=float(fit_l1[-1]), fit_eval_l1=eval_l1,
        fit_eval_l1_init=eval_l1_init, frames=n_frames, cars=cars,
        css_steps=css_steps, css_loss_first=float(css_loss[0]),
        css_loss_last=float(css_loss[-1]), fit_card_vs_cpu=fit_check,
        css_card_vs_cpu=css_check, seconds=seconds)


# --------------------------------------------------------------- phase 11

# JAX's 800 CSS steps took 101.3 s of the phase's 122.8 s on the H100
# (126.7 ms a step, held by the host's launches): the phase takes 500
DEMO_CSS_STEPS = 500

def demo_assets_phase(dev, out_dir: str, small: bool = False):
    """Phase 11: tools/demo_assets.py remakes the demo's assets on the card
    (JAX's 2500 fit steps of the 3x64 decoder, the scene, DEMO_CSS_STEPS
    of JAX's 800 CSS steps at width 8, batch 4) under the run's temporary
    directory.
    The scene's crop box, visible points and NOCS image against the same
    scene rendered on the CPU from the fitted decoder; one fit step and
    one CSS step card against CPU (phase 10's helpers). The launches on
    the `demo_assets` path: the bins and 1c once for the scene's render,
    kernel 5 four times forward and backward a CSS step. The written
    assets read back by the driver's loaders equal to what was made, then
    refine_css_demo on them for 60 iterations: the label's gap to the
    remade ground truth within phase 3's criterion (location < 0.1 m,
    yaw < 0.05 rad)."""
    da = demo_assets
    fit_steps, css_steps, iters = ((20, 2, 2) if small else
                                   (da.FIT_STEPS, DEMO_CSS_STEPS, None))
    out = os.path.join(out_dir, "demo_assets")
    seconds = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        res = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        return res

    dcfg, dparams, fit_l1 = timed("fit", lambda: da.fit_deepsdf(
        fit_steps, device=dev))
    fit_l1 = fit_l1.cpu().numpy()
    k = max(1, fit_steps // 6)
    assert np.isfinite(fit_l1).all() and fit_l1[-k:].mean() < \
        fit_l1[:k].mean(), fit_l1

    def scene(device, params):
        rend = quality_suite.Renderer(deepsdf.sdf_fn(dcfg, params), device,
                                      da.CAPACITY)
        crop_box, nocs, mask, vis_cam = da.render_gt(rend)
        sample = da.build_sample(crop_box, nocs, mask, vis_cam)
        return (crop_box, nocs, mask, vis_cam, sample,
                da.gt_label(rend, crop_box, sample))

    reset_counts()
    crop_box, nocs, mask, vis_cam, sample, anno = timed(
        "scene", lambda: scene(dev, dparams))
    scene_launched = counts()
    cpu_params = deepsdf._map_tree(lambda t: t.cpu(), dparams)
    c_box, c_nocs, c_mask, c_vis, _, c_anno = scene(torch.device("cpu"),
                                                     cpu_params)
    nocs_share = (float((np.abs(nocs - c_nocs) <= 2e-4).all(0).mean())
                  if nocs.shape == c_nocs.shape else 0.0)
    mask_share = (float((mask == c_mask).mean())
                  if mask.shape == c_mask.shape else 0.0)
    label_gap_cpu = max(float(np.abs(np.asarray(anno[f]) -
                                     np.asarray(c_anno[f])).max())
                        for f in ("location", "dimensions", "rotation_y"))
    vs_cpu = dict(crop_box=list(crop_box), crop_box_cpu=list(c_box),
                  n_vis=len(vis_cam), n_vis_cpu=len(c_vis),
                  nocs_within_2e4=nocs_share, mask_equal=mask_share,
                  label_gap=label_gap_cpu)
    print(f"11: demo scene card against CPU: {json.dumps(vs_cpu)}")
    assert tuple(crop_box) == tuple(c_box)
    assert abs(len(vis_cam) - len(c_vis)) <= 2, vs_cpu
    assert nocs_share >= 0.995 and mask_share >= 0.995, vs_cpu
    assert label_gap_cpu <= 1e-5, vs_cpu
    fit_check = _fit_step_card_vs_cpu(dev, dparams, cfg=dcfg,
                                      shapes=da.SHAPES)

    reset_counts()
    model, css_loss = timed("css", lambda: da.train_css(
        sample, anno, nocs, mask, steps=css_steps, device=dev))
    css_launched = counts()
    launched = {k: scene_launched[k] + css_launched[k]
                for k in scene_launched}
    css_loss = css_loss.cpu().numpy()
    k = max(1, css_steps // 4)
    assert np.isfinite(css_loss).all()
    assert small or css_loss[-k:].mean() < css_loss[:k].mean(), css_loss
    css_check = _css_step_card_vs_cpu(
        dev, da.crop_sampler(sample, anno, nocs, mask, device="cpu"),
        da.CSS_WIDTH, da.CSS_BATCH, da.SEED)

    # written, read back by the driver's loaders, then refined
    da.write_assets(out, dcfg, dparams, model, sample, anno,
                    da.maskrcnn_labels(anno, mask))
    cfg = cfg_mod.RefineCfg.from_ini(cfg_mod.load_ini(
        os.path.join(out, "config_demo.ini")))
    back_sample = pipe.load_demo_sample(out)
    maskrcnn = pipe.load_demo_maskrcnn(out)
    assert back_sample["gt"] == [anno]
    assert all(np.array_equal(back_sample[f], sample[f])
               for f in ("image", "depth", "lidar"))
    assert maskrcnn["masks"][0].sum() > 0
    _, back = deepsdf.load_torch_checkpoint(cfg.deepsdf_path, device=dev)
    assert _max_gap(back, dparams) == 0.0
    css_back = css_mod.load_css(cfg.css_path, cfg.css_width, device=dev)
    trained = model.state_dict()
    assert all(torch.equal(v, trained[k])
               for k, v in css_back.state_dict().items())
    cfg = dataclasses.replace(cfg, viz_type="none",
                              **({"iters": iters} if iters else {}))
    rt = pipe.setup_runtime(cfg, device=dev)
    annos, ests = timed("refine", lambda: pipe.refine_css_demo(
        cfg, sample=back_sample, device=dev, rt=rt, maskrcnn=maskrcnn))
    # (a rehearsal's 2 CSS steps may leave RANSAC without a pose)
    assert small or len(ests["location"]) == 1, ests
    loc_err = dyaw = float("nan")
    if len(ests["location"]):
        loc_err = float(np.linalg.norm(
            np.asarray(ests["location"][0], float)
            - np.asarray(anno["location"], float)))
        dyaw = abs(float(ests["rotation_y"][0]) - anno["rotation_y"])
        dyaw = min(dyaw, abs(dyaw - 2 * np.pi))
    print(f"11: demo assets remade: fit {fit_steps} steps L1 "
          f"{fit_l1[0]:.5f} -> {fit_l1[-1]:.5f}; scene box {list(crop_box)}"
          f", {len(vis_cam)} visible points, {int(mask.sum())} mask px, "
          f"GT location {anno['location']}; CSS {css_steps} steps loss "
          f"{css_loss[0]:.4f} -> {css_loss[-1]:.4f}; card against CPU: fit "
          f"{json.dumps(fit_check)}, CSS {json.dumps(css_check)}; assets "
          f"read back equal; refine_css_demo {cfg.iters} iterations: "
          f"location {np.asarray(ests['location']).tolist()}, "
          f"|d location| {loc_err:.4f} m, "
          f"|d yaw| {dyaw:.4f} rad; seconds "
          f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}; "
          f"launches {json.dumps(launched)}")
    if not small:  # the full 60 iterations land on the annotation
        assert loc_err < 0.1 and dyaw < 0.05, (loc_err, dyaw)
    if dev.type == "cuda":
        assert scene_launched["splat_bins"] == 1
        assert scene_launched["splat_fwd_binned"] == 1
        assert css_launched["ce_fwd"] == css_launched["ce_bwd"] \
            == 4 * css_steps
    return {"demo_assets": launched}, dict(
        fit_steps=fit_steps, fit_l1_first=float(fit_l1[0]),
        fit_l1_last=float(fit_l1[-1]), scene_vs_cpu=vs_cpu,
        css_steps=css_steps, css_loss_first=float(css_loss[0]),
        css_loss_last=float(css_loss[-1]), fit_card_vs_cpu=fit_check,
        css_card_vs_cpu=css_check, refine_iters=cfg.iters,
        label_location_gap_m=loc_err, label_yaw_gap_rad=dyaw,
        seconds=seconds)


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


def profile_all(out_dir: str, rt512, rt_stage2, prep, sample, state, fixed,
                summary) -> None:
    """--profile: the full-width crop and two train steps on one fixed
    batch under the profiler (in fp32, and with bf16 convolutions, whose
    ten costliest kernels are printed), the device busy time of each; the
    full-width
    crop again with the first dense splat forward, and phase 4c's crop with
    the new designs and again with the first designs of the dense splat
    forward and kernel 4b; then the same steps timed with cuDNN's autotuner
    on (set for this measurement only; the port leaves it off)."""
    profile_phase("full-width crop", lambda: rt512.run_refine(prep),
                  summary["full_width_crop"]["wall_s"], rt512.cfg.iters,
                  "iteration", os.path.join(out_dir, "profile.json"))
    crops = shifted_crops(prep)
    profile_phase("batched full width, 4 crops",
                  lambda: pipe.refine_crops_batched(rt512, sample, crops),
                  summary["batched_full_width"]["wall_s"], rt512.cfg.iters,
                  "iteration", os.path.join(out_dir, "profile_4d.json"))
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
    # the same two steps with the convolutions in bf16 (phase 6b's model)
    state.model.compute_dtype = torch.bfloat16
    try:
        path = os.path.join(out_dir, "profile_train_bf16.json")
        profile_phase("train bf16, 2 steps", two_steps,
                      2e-3 * summary["train_bf16"]["steady_ms_per_step"], 2,
                      "step", path)
    finally:
        state.model.compute_dtype = torch.float32
    with open(path) as f:
        top = json.load(f)["kernels"][:10]
    for k in top:
        print(f"profile: train bf16, 2 steps: {k['ms']:9.3f} ms "
              f"{k['count']:5d} x {k['name'][:150]}")
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
    """Phases 3 to 11, each timed; `small` cuts them to a CPU rehearsal's
    size. Returns what --profile drives again, the launches of each path
    and its summary."""
    tiny = dict(iters=2) if small else {}
    seconds = {}
    t0 = time.perf_counter()
    rt, sample, prep, demo = demo_phase(dev, **tiny)
    seconds["3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    viz_launched, demo_viz = demo_viz_phase(dev, out_dir, demo, **tiny)
    seconds["3b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pnp_bf16 = pnp_bf16_phase(dev, demo, **tiny)
    seconds["3c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt512, full_launched, full = full_width_phase(dev, rt, sample, prep,
                                                  **tiny)
    seconds["4"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    batched_launched, batched = batched_full_width_phase(
        dev, rt512, sample, prep, full, full_launched)
    seconds["4d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cells_launched, cells = coarse_full_width_phase(dev, rt512, sample, prep,
                                                    full)
    seconds["4e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rt_stage2, stage2_launched, stage2 = full_width_stage2_phase(
        dev, rt512, prep, sample, full)
    seconds["4c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b_stage2_launched, b_stage2 = batched_stage2_phase(
        dev, rt_stage2, sample, prep, stage2, stage2_launched)
    seconds["4f"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    b_binned_launched, b_binned = batched_binned_phase(
        dev, rt, rt512, sample, prep, iters=1 if small else 10)
    seconds["4g"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    binned_launched, binned, binned_prep = binned_refine_phase(
        dev, rt, sample, prep["anno"], iters=1 if small else 10)
    seconds["4b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_launched, meshes = rays_data_phases(
        dev, out_dir, rt512, sample, prep, full, batched,
        binned_rays_job(rt, binned_prep, iters=1 if small else 10), binned)
    seconds["4h+4i"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    demo9_launched, demo9 = render_demo_phase(dev, out_dir, small=small)
    seconds["9"] = time.perf_counter() - t0
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
    _, _, bf16_launched, train_bf16 = train_phase(
        dev, crops_dir, os.path.join(out_dir, "log_bf16"),
        precision="bfloat16",
        **(dict(width=8, batch=2, epochs=1) if small else {}))
    train_bf16["card_vs_cpu"] = bf16_card_vs_cpu(dev, crops_dir,
                                                 width=8 if small else 64)
    print(f"train bf16: steady {train_bf16['steady_ms_per_step']:.3f} "
          f"ms/step beside phase 6's fp32 "
          f"{train['steady_ms_per_step']:.3f} ms/step; kernel 5 launches "
          f"{bf16_launched['ce_fwd']} forward, {bf16_launched['ce_bwd']} "
          f"backward")
    seconds["6b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused_launched, fused = fused_phase(dev, state, fixed,
                                        train["fixed_batch_step_ms"])
    seconds["6c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, fast_launched, train_fast = train_phase(
        dev, crops_dir, os.path.join(out_dir, "log_fast"), fast_input=True,
        **(dict(width=8, batch=2, epochs=1) if small else dict(epochs=1)))
    train_fast["chains_card_vs_cpu"] = input_chains_card_vs_cpu(dev,
                                                                crops_dir)
    seconds["6e"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reset_counts()
    dsdf_handles, dsdf_train = deepsdf_train_phase(dev, out_dir, small=small)
    dsdf_launched = counts()
    seconds["8"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data_parallel = dp_phases(dev, out_dir, crops_dir, dsdf_handles,
                              small=small)
    seconds["6d+8b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kitti_launched, kitti = kitti_phase(
        dev, out_dir, **(dict(n_frames=2, iters=2) if small
                         else dict(n_frames=quality_frames)))
    seconds["7"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    remake_launched, remake = suite_remake_phase(dev, out_dir, small=small)
    seconds["10"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    assets_launched, assets = demo_assets_phase(dev, out_dir, small=small)
    seconds["11"] = time.perf_counter() - t0
    print(f"phase seconds: {json.dumps(seconds)}")
    launched = {"full_width": full_launched, "binned_refine": binned_launched,
                "crops": crops_launched, "train": train_launched,
                "train_bf16": bf16_launched, "train_fused": fused_launched,
                "train_fast": fast_launched,
                "full_width_stage2": stage2_launched, "kitti": kitti_launched,
                "batched_full_width": batched_launched,
                "batched_stage2": b_stage2_launched,
                "batched_binned": b_binned_launched,
                "demo_viz": viz_launched, "render_demo": demo9_launched,
                "deepsdf_train": dsdf_launched,
                **mesh_launched, **cells_launched, **remake_launched,
                **assets_launched}
    summary = {"demo_crop": demo, "demo_viz": demo_viz,
               "pnp_select_bf16": pnp_bf16, "full_width_crop": full,
               "batched_full_width": batched, "coarse_cells": cells,
               "full_width_stage2": stage2, "batched_stage2": b_stage2,
               "batched_binned": b_binned, "binned_refine": binned,
               "rays_sharded": meshes["rays"],
               "data_mesh": meshes["data_mesh"], "render_demo": demo9,
               "crops": crops, "train": train, "train_bf16": train_bf16,
               "train_fused": fused, "train_fast": train_fast,
               "data_parallel": data_parallel,
               "deepsdf_train": dsdf_train,
               "kitti_driver": kitti, "suite_remake": remake,
               "demo_assets": assets, "phase_seconds": seconds}
    handles = dict(rt512=rt512, rt_stage2=rt_stage2, prep=prep,
                   sample=sample, state=state, fixed=fixed)
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
            + check_splat_binned(dev) + check_ce(dev) + check_stage2(dev)
            + check_bias_relu_dropout(dev))
    crop_axes = {**check_crop_axis(dev), **check_crop_axis_stage2_binned(dev)}
    for name, crop_axis in crop_axes.items():
        next(r for r in rows if r["name"] == name)["crop_axis"] = crop_axis
    next(r for r in rows if r["name"] == "select_mlp")["cells"] = \
        check_select_cells(dev)
    print(f"phase 2: {time.perf_counter() - t0:.1f} s; kernel_ms captures "
          f"taken again (kernel: captures): {json.dumps(EMPTY_CAPTURES)}")
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
    missing += [f"{k} (rays_sharded, rank {r})"
                for k in RAYS_KERNELS + BINNED_KERNELS
                for r, n in enumerate(launched["rays_sharded"][k]) if not n]
    assert not missing, f"kernels not launched on their path: {missing}"
    if args.profile:
        profile_all(args.profile, summary=summary, **handles)
    for row in rows:
        _, source, replaces = KERNELS[row["name"]]
        path = PATHS[row["name"]]
        row.update(route="cuda", source=source, replaces=replaces,
                   path=path, launches=launched[path][row["name"]])
        if "crop_axis" in row:  # its launches on the batched path (4d,
            # 4f for 4a and 4b, 4g for the binned trio)
            batched_path = {"stage2_fwd": "batched_stage2",
                            "stage2_bwd": "batched_stage2",
                            "splat_bins": "batched_binned",
                            "splat_fwd_binned": "batched_binned",
                            "splat_bwd_binned": "batched_binned"}.get(
                                row["name"], "batched_full_width")
            row["crop_axis"]["launches"] = \
                launched[batched_path][row["name"]]
            row["crop_axis"]["path"] = batched_path
        # the launches on the later slices' paths: the viz of the demo as
        # written (3b), the coarse cells (4e), bf16 training (6b) and the
        # fused-head net (6c), the fast input chain (6e), the render demo
        # (9), the suite's v1 frames and its CSS training (10); by rank,
        # the rays axis (4h) and the data axis (4i)
        row["launches_by_path"] = {
            path: launched[path].get(row["name"], 0)
            for path in ("demo_viz", "warm_refresh_cells", "coarse_cells",
                         "batched_warm_refresh_cells", "train_bf16",
                         "train_fused", "train_fast", "render_demo",
                         "suite_v1", "suite_css", "demo_assets")
            if launched[path].get(row["name"], 0)}
        for path in ("rays_sharded", "data_mesh"):
            if row["name"] in launched[path]:
                row["launches_by_path"][path] = launched[path][row["name"]]
    print(json.dumps({"card": card, **summary}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
