"""Kernels 1b and 2 by cluster size: the split dense splat backward and the
split nearest neighbour against their first designs, on one NVIDIA card.

    python3 scripts/split_sweep.py [--nn-variants]

Inputs are chip_smoke.py's phase-2 ones: 8192 surfels (40% masked) onto a
32x32 crop with a seeded cotangent for the backward; 8192 queries against
8192 data points on a 0.25 lattice (30% masked) for the nearest neighbour,
and RANSAC's 567 x 2048 queries against 2048 model points. For every
cluster size S = 1..8 the device time of one launch (the profiler's kernel
time over 20 launches, without the wrapper's host work), that of the first
design beside it, and the size the wrappers' rule takes. Each output is
held against the first design's: the nearest neighbour bit for bit; the
backward's d_points, d_normals and d_features are reported by their
largest difference over the tensor's largest magnitude, for the phase-2
cotangent and three more seeded ones. ``--nn-variants`` also builds
csrc/nn.cu with other threads a CTA, queries a thread and largest cluster
(nvcc -D NN_SPLIT_THREADS / NN_SPLIT_R / NN_SPLIT_MAX, into a temporary
directory) and times each at the 3D loss's shape, bit-equal to the first
design. Prints one line per case and, last, one JSON object.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from sdflabel_tpu_torch.ops import (  # noqa: E402
    _cuda, nn_cuda, splat, splat_cuda)
from sdflabel_tpu_torch.renderer import rasterer  # noqa: E402


def splat_inputs(dev, n=8192, res=(32, 32), seed=3):
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
    pk = splat_cuda._pack_points(pts, nrm, mask)
    kg4 = splat_cuda._pack_rays(kg)
    img, m, d, zn = splat_cuda._fwd(pk, feats, kg4, 0.04, 150.0)
    g = torch.randn(img.shape, generator=torch.Generator().manual_seed(seed)
                    ).to(dev)
    corr = (g * img).sum(-1, keepdim=True)
    pix = torch.cat([kg4, m[:, None], d[:, None], zn[:, None], corr, g],
                    1).contiguous()
    return pk, feats.contiguous(), pix


def nn_inputs(dev, n, m, seed):
    rng = np.random.RandomState(seed)
    q = rng.randint(-8, 9, (n, 3)).astype(np.float32) * 0.25
    d = rng.randint(-8, 9, (m, 3)).astype(np.float32) * 0.25
    mask = rng.uniform(size=m) > 0.3
    return tuple(torch.as_tensor(a, device=dev) for a in (q, d, mask))


# (threads a CTA, queries a thread, largest cluster) -> cluster sizes
NN_VARIANTS = {(128, 2, 8): (4, 6, 7, 8), (128, 1, 8): (4, 6, 7, 8),
               (64, 2, 8): (4, 6, 7, 8), (128, 4, 8): (4, 6, 7, 8),
               (256, 1, 8): (4, 6, 7, 8), (128, 2, 16): (8, 12, 16)}


def nn_variants(dev, q, d, mask, first) -> dict:
    """Each NN_VARIANTS build of csrc/nn.cu, timed at each cluster size."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for v in NN_VARIANTS:
            lib = os.path.join(tmp, "libnn_%d_%d_%d.so" % v)
            flags = ["-DNN_SPLIT_THREADS=%d" % v[0], "-DNN_SPLIT_R=%d" % v[1],
                     "-DNN_SPLIT_MAX=%d" % v[2]]
            procs[v] = (lib, subprocess.Popen(
                [_cuda._nvcc(), *_cuda._COMMON_FLAGS, *flags, "-o", lib,
                 os.path.join(_cuda.CSRC, "nn.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for v, (lib, proc) in procs.items():
            log = proc.communicate()[0]
            assert proc.returncode == 0, log
            fn = ctypes.CDLL(lib).nn_fwd
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
            n, m = q.shape[0], d.shape[0]
            d2 = torch.empty(n, device=dev)
            idx = torch.empty(n, device=dev, dtype=torch.int64)

            def launch(s):
                err = fn(q.data_ptr(), d.data_ptr(), mask.data_ptr(), 1, n,
                         m, s, d2.data_ptr(), idx.data_ptr(),
                         _cuda.stream(q))
                assert err == 0, err

            times = {}
            for s in NN_VARIANTS[v]:
                launch(s)
                torch.cuda.synchronize()
                assert torch.equal(d2, first[0]) and torch.equal(idx, first[1])
                times[s] = chip_smoke.kernel_ms(lambda: launch(s),
                                                "nn_split_kernel", reps=10)
            name = "threads %d, R %d, clusters up to %d" % v
            print(f"nn variant {name}: " + ", ".join(
                f"S = {s} {t:.4f} ms" for s, t in times.items()), flush=True)
            out[name] = times
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("split_sweep: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = chip_smoke.gpu_line()
    result = {"card": card}

    inputs = {seed: splat_inputs(dev, seed=seed) for seed in (3, 4, 5, 6)}
    pk, fk, pix = inputs[3]
    n, p = pk.shape[0], pix.shape[0]

    def bwd(inp, **kw):
        return splat_cuda._bwd(*inp, 0.04, 150.0, **kw)

    firsts = {k: bwd(v, kernel=splat_cuda.SPLAT_BWD_FIRST)
              for k, v in inputs.items()}
    rows = {"rule": splat_cuda.bwd_split_slices(n, p),
            "first_ms": chip_smoke.kernel_ms(
                lambda: bwd(inputs[3], kernel=splat_cuda.SPLAT_BWD_FIRST),
                "splat_bwd_kernel"), "rel_vs_first": {}}
    for s in range(1, 9):
        rel = [[float((a - b).abs().max() / b.abs().max())
                for a, b in zip(bwd(inp, slices=s), firsts[k])]
               for k, inp in inputs.items()]
        rows["rel_vs_first"][s] = rel
        rows[s] = chip_smoke.kernel_ms(lambda: bwd(inputs[3], slices=s),
                                       "splat_bwd_split_kernel")
        print(f"splat_bwd {n} points x {p} px, S = {s}: {rows[s]:.4f} ms "
              f"(first design {rows['first_ms']:.4f}); largest difference "
              f"from the first design over the largest magnitude (d_points, "
              f"d_normals, d_features) per cotangent seed: "
              f"{[[f'{x:.3g}' for x in r] for r in rel]}", flush=True)
    result["splat_bwd"] = rows

    for label, (nq, nd, seed) in (("nn", (8192, 8192, 1)),
                                  ("nn_ransac", (567 * 2048, 2048, 2))):
        q, d, mask = nn_inputs(dev, nq, nd, seed)
        first = nn_cuda.nearest_neighbor_fused(q, d, mask, nn_cuda.NN_FIRST)
        rows = {"rule": nn_cuda.split_slices(nq, nd),
                "first_ms": chip_smoke.kernel_ms(
                    lambda: nn_cuda.nearest_neighbor_fused(
                        q, d, mask, nn_cuda.NN_FIRST), "nn_kernel", reps=10)}
        for s in range(1, 9):
            got = nn_cuda.nearest_neighbor_fused(q, d, mask, slices=s)
            assert all(torch.equal(a, b) for a, b in zip(got, first)), s
            rows[s] = chip_smoke.kernel_ms(
                lambda: nn_cuda.nearest_neighbor_fused(q, d, mask, slices=s),
                "nn_split_kernel", reps=10)
            print(f"{label} {nq} x {nd}, S = {s}: {rows[s]:.4f} ms (first "
                  f"design {rows['first_ms']:.4f}), bit-equal", flush=True)
        result[label] = rows
        if label == "nn" and "--nn-variants" in sys.argv:
            result["nn_variants"] = nn_variants(dev, q, d, mask, first)
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
