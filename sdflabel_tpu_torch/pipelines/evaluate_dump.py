"""Evaluate stored autolabel dumps.

Counterpart of sdflabel_tpu/pipelines/evaluate_dump.py (reference
pipelines/evaluate_dump.py:11-62): load the ``<frame>.pkl`` dumps of a
labels directory (either package's, the format is shared), backfill empty
predictions, run the KITTI and nuScenes evaluators, and save the results
to ``eval_results.npz`` beside the dumps.
"""

from __future__ import annotations

import glob
import os
import pickle
from collections import OrderedDict

import numpy as np

from sdflabel_tpu_torch import config as cfg_mod
from sdflabel_tpu_torch.eval.detection3d import (
    CoordinateFrame,
    Detection3DEvaluator,
    clean_kitti_data,
    difficulty_by_distance,
)

FILTER_FNS = {"kitti": clean_kitti_data, "distance": difficulty_by_distance}


def backfill_empty(est: dict) -> dict:
    """Empty-array fields for a frame without estimations, so that the
    evaluator's format check passes (evaluate_dump.py:37-44)."""
    if "name" in est and len(est["name"]):
        return est
    est = dict(est)
    est["name"] = []
    est["location"] = np.zeros((0, 3))
    est["dimensions"] = np.zeros((0, 3))
    est["bbox"] = np.zeros((0, 4))
    est["rotation_y"] = np.zeros((0,))
    est["alpha"] = np.zeros((0,))
    est["score"] = np.zeros((0,))
    return est


def evaluate_annotations(gt_list, est_list, filter_name="kitti",
                         difficulties=(0,), device="cuda", verbose=True):
    """KITTI then nuScenes evaluation of per-frame annotation dicts;
    returns the two result dicts."""
    results = []
    for compute_nuscenes in (False, True):
        evaluator = Detection3DEvaluator(
            FILTER_FNS[filter_name], compute_nuscenes=compute_nuscenes,
            coordinate_frame=CoordinateFrame.CAMERA, device=device)
        formatted, result = evaluator.evaluate_detection_3d(
            list(gt_list), [backfill_empty(e) for e in est_list], ["Car"],
            difficulties=list(difficulties))
        if verbose:
            print(formatted)
        results.append(result)
    return results


def evaluate(cfgp, difficulties=(0, 1), device="cuda"):
    """Evaluate every dump under the config's labels directory; writes
    eval_results.npz there and returns [kitti result, nuscenes result]."""
    cfg = cfg_mod.RefineCfg.from_ini(cfgp)
    path_autolabels = cfg.labels_out
    gt_annotations, pred_annotations = OrderedDict(), OrderedDict()
    for f in sorted(glob.glob(os.path.join(path_autolabels, "*.pkl"))):
        if "skipped_frames" in f:
            continue
        with open(f, "rb") as fh:
            gt, estimations = pickle.load(fh)
        frame_id = int(os.path.basename(f).split(".")[0])
        gt_annotations[frame_id] = gt
        pred_annotations[frame_id] = estimations
    results = evaluate_annotations(
        gt_annotations.values(), pred_annotations.values(), cfg.eval_filter,
        difficulties, device=device)
    out = {}
    for tag, result in zip(("kitti", "nuscenes"), results):
        for k, v in result.items():
            out[f"{tag}/{k}"] = np.asarray(v)
    np.savez(os.path.join(path_autolabels, "eval_results.npz"), **out)
    return results
