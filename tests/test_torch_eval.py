"""The port's evaluator (eval/detection3d.py, eval/native.py) against
sdflabel_tpu's on the same seeded ground truth and detections: KITTI and
nuScenes, difficulties 0-2, both difficulty filters. Every AP array and
every precision, recall and orientation curve within 1e-6: the same host
arithmetic on rotated IoUs that agree to 1e-5 (none near a threshold). The
curves' tp_mean_error, a mean of matched IoUs, within 1e-5."""

import numpy as np
import pytest

from sdflabel_tpu.eval import detection3d as jdet
from sdflabel_tpu.eval import native as jnative
from sdflabel_tpu_torch.eval import detection3d as tdet
from sdflabel_tpu_torch.eval import native as tnative

NAMES = ("Car", "Car", "Car", "Van", "Pedestrian", "DontCare")


def _frames(seed=0, n_frames=9):
    """Cars with every difficulty tier, other classes, DontCare boxes, and
    detections: perturbed copies of the cars (some far off), misses and
    false positives, with scores."""
    rng = np.random.RandomState(seed)
    gts, dts = [], []
    for f in range(n_frames):
        n = rng.randint(1, 6)
        names = [NAMES[rng.randint(len(NAMES))] for _ in range(n)]
        if f == 0:
            names[0] = "Car"
        loc = np.stack([rng.uniform(-8, 8, n), rng.uniform(1.4, 1.8, n),
                        rng.uniform(6, 60, n)], 1)
        dims = np.stack([rng.uniform(1.4, 1.7, n), rng.uniform(1.5, 1.9, n),
                         rng.uniform(3.5, 4.6, n)], 1)
        ry = rng.uniform(-np.pi, np.pi, n)
        left = rng.uniform(0, 1000, n)
        top = rng.uniform(100, 200, n)
        height = rng.choice([20.0, 30.0, 50.0, 80.0], n)
        bbox = np.stack([left, top, left + height * 1.6, top + height], 1)
        gt = {"name": np.array(names), "location": loc, "dimensions": dims,
              "rotation_y": ry, "alpha": ry - 0.1, "bbox": bbox,
              "score": np.ones(n),
              "occluded": rng.randint(0, 3, n),
              "truncated": rng.choice([0.0, 0.2, 0.4, 0.7], n)}
        keep = rng.uniform(size=n) < 0.8
        k = int(keep.sum())
        jitter = rng.choice([0.05, 0.3, 2.0], (k, 1))
        d_loc = loc[keep] + rng.randn(k, 3) * jitter
        d_dims = dims[keep] * rng.uniform(0.9, 1.1, (k, 3))
        d_ry = ry[keep] + rng.randn(k) * 0.2
        d_bbox = bbox[keep] + rng.randn(k, 4) * 3
        n_fp = rng.randint(0, 2)
        fp_loc = np.stack([rng.uniform(-8, 8, n_fp), np.full(n_fp, 1.6),
                           rng.uniform(6, 60, n_fp)], 1)
        fp_left = rng.uniform(0, 1000, n_fp)
        dt = {"name": np.array(["Car"] * (k + n_fp)),
              "location": np.concatenate([d_loc, fp_loc]),
              "dimensions": np.concatenate([d_dims, np.tile(
                  [[1.5, 1.6, 4.0]], (n_fp, 1))]),
              "rotation_y": np.concatenate([d_ry, rng.uniform(-3, 3, n_fp)]),
              "bbox": np.concatenate([d_bbox, np.stack(
                  [fp_left, np.full(n_fp, 150.0), fp_left + 60,
                   np.full(n_fp, 190.0)], 1)]),
              "score": rng.uniform(0.1, 1.0, k + n_fp)}
        dt["alpha"] = dt["rotation_y"] - 0.1
        gts.append(gt)
        dts.append(dt)
    return gts, dts


@pytest.mark.parametrize("filter_name", ["kitti", "distance"])
@pytest.mark.parametrize("nuscenes", [False, True])
def test_evaluator_matches_jax(filter_name, nuscenes):
    gts, dts = _frames()
    jfilter = {"kitti": jdet.clean_kitti_data,
               "distance": jdet.difficulty_by_distance}[filter_name]
    tfilter = {"kitti": tdet.clean_kitti_data,
               "distance": tdet.difficulty_by_distance}[filter_name]
    kw = dict(compute_nuscenes=nuscenes,
              coordinate_frame=jdet.CoordinateFrame.CAMERA)
    jtext, jres = jdet.Detection3DEvaluator(jfilter, **kw).\
        evaluate_detection_3d(gts, dts, ["Car"], difficulties=[0, 1, 2])
    ttext, tres = tdet.Detection3DEvaluator(
        tfilter, device="cpu", **kw).evaluate_detection_3d(
            gts, dts, ["Car"], difficulties=[0, 1, 2])
    assert tres.keys() == jres.keys()
    for key, want in jres.items():
        # the AP arrays, and the PR curves as dicts of arrays
        pairs = ([(key, tres[key], want)] if not isinstance(want, dict)
                 else [(f"{key}/{k}", tres[key][k], v)
                       for k, v in want.items()])
        for name, got, ref in pairs:
            tol = 1e-5 if name.endswith("tp_mean_error") else 1e-6
            np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                       atol=tol, err_msg=name)
    assert ttext == jtext
    ap = np.asarray(jres["Box3DAP_Nu" if nuscenes else "Box3DAP"])
    assert ap.max() > 0  # matches happen


def test_native_statistics_match_jax():
    rng = np.random.RandomState(2)
    for metric, n_gt, n_dt, n_dc in ((0, 5, 7, 2), (1, 4, 3, 0),
                                     (2, 6, 6, 1), (3, 3, 5, 0)):
        overlaps = rng.uniform(0, 1, (n_dt, n_gt))
        if metric == 3:
            overlaps = -rng.uniform(0, 3, (n_dt, n_gt))
        gt = np.concatenate([rng.uniform(0, 100, (n_gt, 4)),
                             rng.uniform(-3, 3, (n_gt, 2))], 1)
        gt[:, 2:4] += gt[:, :2]
        dt = np.concatenate([rng.uniform(0, 100, (n_dt, 4)),
                             rng.uniform(-3, 3, (n_dt, 2)),
                             rng.uniform(0, 1, (n_dt, 1))], 1)
        dt[:, 2:4] += dt[:, :2]
        ig_gt = rng.choice([-1, 0, 0, 1], n_gt)
        ig_dt = rng.choice([-1, 0, 0, 1], n_dt)
        dc = rng.uniform(0, 100, (n_dc, 4))
        dc[:, 2:] += dc[:, :2]
        for compute_fp, angular in ((False, False), (True, True)):
            args = (overlaps, gt, dt, ig_gt, ig_dt, dc, metric)
            kw = dict(min_overlap=-0.5 if metric == 3 else 0.5, thresh=0.2,
                      compute_fp=compute_fp, compute_angular=angular)
            want = jnative.compute_statistics(*args, **kw)
            got = tnative.compute_statistics(*args, **kw)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
