"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Four phases; any failure exits non-zero and no phase's error is caught.

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
   weight-norm, latent 3) with seeded random weights.

The line before the last is a JSON ``kernels`` record; the last line is
``{"ok": true, "device": {...}}``. Without a card the script exits 2 and
prints no result. ``--profile DIR`` adds one more full-width crop under
torch.profiler: device time by kernel group, the device's busy share of
the wall time, and DIR/profile.json with every kernel.
``--rehearse-cpu`` runs phases 3 and 4 on the CPU with
the kernels' plain versions (a few iterations), then exits 3 without a
result: a dry run of the control flow for machines without a card.
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
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from sdflabel_tpu_torch import config as cfg_mod  # noqa: E402
from sdflabel_tpu_torch.models import deepsdf  # noqa: E402
from sdflabel_tpu_torch.ops import (  # noqa: E402
    _cuda, grid as grid_ops, knn, mlp_cuda, nn_cuda, splat, splat_cuda)
from sdflabel_tpu_torch.pipelines import refine_css as pipe  # noqa: E402
from sdflabel_tpu_torch.renderer.rasterer import (  # noqa: E402
    calibration_matrix)

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
}


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
    K = torch.as_tensor(calibration_matrix(res), device=dev)
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

    # tolerance: a footprint bit may flip at the disc boundary between the
    # kernel's expanded distance and the plain version's explicit one, so
    # >= 99.5% of pixels within 2e-4 and >= 99% of points' gradient rows
    # within 1e-3 of the largest gradient
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
    print(f"splat fwd: max_abs_err {fwd_err:.3g}, pixels within 2e-4: "
          f"{px_ok:.4f} (need >= 0.995)")
    print(f"splat bwd: max_abs_err {bwd_err:.3g}, gradient rows within "
          f"1e-3 relative: {[round(r, 4) for r in row_ok]} (need >= 0.99)")
    assert px_ok >= 0.995 and min(row_ok) >= 0.99

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
    kg4 = torch.cat([kg, (kg * kg).sum(-1, keepdim=True)], 1).contiguous()
    img, m, d, zn = splat_cuda._fwd(pk, feats, kg4, 0.04 * 0.04, 150.0)
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[:, None], d[:, None], zn[:, None], corr, g],
                    1).contiguous()
    fwd_ms = time_ms(lambda: splat_cuda._fwd(pk, feats, kg4, 0.04 * 0.04,
                                             150.0))
    bwd_ms = time_ms(lambda: splat_cuda._bwd(pk, feats, pix, 0.04 * 0.04,
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
    anno = pipe.kitti_mod.get_annos(cfg.diff_annos, sample)[0]
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
    return rt, launched, dict(wall_s=wall, iters=stock.iters)


# ------------------------------------------------------- --profile (option)

def _kernel_group(name: str) -> str:
    for key, group in (("splat_fwd_kernel", "splat_fwd"),
                       ("splat_bwd_kernel", "splat_bwd"),
                       ("nn_kernel", "nn"), ("select_mlp_kernel", "select_mlp"),
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


def profile_phase(rt, prep, wall_unprofiled: float, out_dir: str) -> None:
    """Phase 4's crop once more under torch.profiler: device time by kernel
    group, and the device's busy share of the crop's wall time, with and
    without the profiler (kernels on one stream do not overlap, so their
    sum is the busy time; user annotations such as Optimizer.step span
    kernels and are left out of it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.run_refine(prep)
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
    iters = rt.cfg.iters
    print(f"profile: full-width crop {wall * 1e3:.3f} ms wall under the "
          f"profiler ({wall_unprofiled * 1e3:.3f} ms without), device busy "
          f"{busy:.3f} ms ({busy / wall / 10:.1f}% of the one, "
          f"{busy / wall_unprofiled / 10:.1f}% of the other), {launches} "
          f"device launches ({launches / iters:.1f} per iteration)")
    for name, (count, ms) in sorted(groups.items(), key=lambda kv: -kv[1][1]):
        print(f"profile: {name:12s} {count:6d} launches {ms:9.3f} ms "
              f"({100 * ms / busy:.1f}% of busy)")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile.json"), "w") as f:
        json.dump({"card": gpu_line(), "wall_ms": wall * 1e3,
                   "wall_unprofiled_ms": wall_unprofiled * 1e3,
                   "busy_ms": busy, "iters": iters,
                   "kernels": sorted(kernels, key=lambda k: -k["ms"])}, f,
                  indent=1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rehearse-cpu", action="store_true")
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile the full-width crop and write "
                         "DIR/profile.json")
    args = ap.parse_args()
    if args.rehearse_cpu:
        cpu = torch.device("cpu")
        rt, sample, prep, _ = demo_phase(cpu, iters=2)
        full_width_phase(cpu, rt, sample, prep, iters=2)
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

    rows = check_splat(dev) + [check_nn(dev), check_select(dev)]
    rt, sample, prep, demo = demo_phase(dev)
    rt512, launched, full = full_width_phase(dev, rt, sample, prep)
    missing = [k for k, v in launched.items() if v == 0]
    assert not missing, f"kernels not launched on the main path: {missing}"
    if args.profile:
        profile_phase(rt512, prep, full["wall_s"], args.profile)
    for row in rows:
        _, source, replaces = KERNELS[row["name"]]
        row.update(route="cuda", source=source, replaces=replaces,
                   launches=launched[row["name"]])
    print(json.dumps({"card": card, "demo_crop": demo,
                      "full_width_crop": full}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
