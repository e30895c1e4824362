"""How far the order of the sums over pixels alone moves the dense splat
backward (kernel 1b), on the CPU.

    python scripts/splat_bwd_sum_order.py

On chip_smoke.py's phase-2 scene (8192 surfels, 40% masked, onto a 32x32
crop; cotangent seeds 3 to 6) it takes every (point, pixel) pair's
PointGrads terms from the plain formulas (tests/test_torch_splat_bwd_split.py
::pair_terms, fp32) and sums them over the 1024 pixels four ways: in pixel
order one after another (the first design, splat_bwd_kernel), in the split
design's order at S = 1, 4 and 8 slices (four warp groups a CTA, then the
ranks), and in fp64. For d_points, d_normals and d_features it prints the
largest difference of each order from the fp64 sum and from the first
design's, over the tensor's largest magnitude. d_normals = dnv_sum * v +
sum(dnk * g) is a difference of two nearly equal sums on the footprint
(v ~ z g), so a last-ulp change of dnv_sum moves it by orders more than
d_points = dnv_sum * n. Last line: one JSON object.
"""

import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import test_torch_splat_bwd_split as model  # noqa: E402
from sdflabel_tpu_torch.ops import splat  # noqa: E402
from sdflabel_tpu_torch.renderer import rasterer  # noqa: E402

NAMES = ("d_points", "d_normals", "d_features")


def scene(n=8192, res=(32, 32)):
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] += 4.0
    nrm = rng.randn(n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    feats = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    mask = rng.uniform(size=n) > 0.4
    K = torch.as_tensor(rasterer.calibration_matrix(res))
    kg = splat.kinv_pixel_rays(K, splat.pixel_grid(*res))
    return [torch.as_tensor(a) for a in (pts, nrm, feats, mask)] + [kg]


def in_order(x):
    """Row sums of (N, P) x, one pixel after another in fp32."""
    return torch.as_tensor(np.cumsum(x.numpy(), axis=1,
                                     dtype=np.float32)[:, -1])


def split_order(terms, p, slices):
    total = None
    for parts in model._rows(p, slices, 4):
        cta = None
        for rows in parts:
            idx = torch.as_tensor(rows, dtype=torch.long)
            part = [in_order(t[:, idx]) for t in terms]
            cta = part if cta is None else [a + b for a, b in zip(cta, part)]
        total = cta if total is None else [a + b for a, b in zip(total, cta)]
    return total


def finish(sums, pts, nrm):
    dnv, dnk = sums[0], torch.stack(sums[1:4], 1)
    return (dnv[:, None] * nrm, dnv[:, None] * pts + dnk,
            torch.stack(sums[4:], 1))


def rel(a, b):
    return [float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b)]


def main() -> int:
    pts, nrm, feats, mask, kg = scene()
    p = kg.shape[0]
    out = {}
    for seed in (3, 4, 5, 6):
        g = torch.randn(p, 8, generator=torch.Generator().manual_seed(seed))
        terms = model.pair_terms(pts, nrm, feats, kg, mask, g)
        exact = finish([t.double().sum(1).float() for t in terms], pts, nrm)
        first = finish([in_order(t) for t in terms], pts, nrm)
        row = {"first": {"vs_fp64": rel(first, exact)}}
        for s in (1, 4, 8):
            got = finish(split_order(terms, p, s), pts, nrm)
            row[f"split_{s}"] = {"vs_fp64": rel(got, exact),
                                 "vs_first": rel(got, first)}
        for k, v in row.items():
            print(f"seed {seed} {k}: " + ", ".join(
                f"{name} {kind} {x:.3g}" for kind, vals in v.items()
                for name, x in zip(NAMES, vals)), flush=True)
        out[seed] = row
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
