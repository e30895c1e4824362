"""ctypes bindings for the evaluator's greedy matching.

Counterpart of sdflabel_tpu/eval/native.py. The sequential greedy matching
of detections to ground truth (loop-carried `assigned` state, reference
detection_3d.py:1098-1294) is C++ in ``csrc/eval_match.cpp``, a copy of
the repository's root ``csrc/eval_match.cpp``. At first use it is built
with ``g++ -O3 -shared -fPIC`` into ``csrc/build/libeval_match-<hash>.so``
(the hash covers the source and the flags, so an edited source rebuilds);
a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
_SRC = os.path.join(_CSRC, "eval_match.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_lib = None


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_CSRC, "build",
                        f"libeval_match-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless it is there; returns its path."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        out = subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed for {_SRC}:\n{out.stderr}")
        os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int64)
        i64, f64 = ctypes.c_int64, ctypes.c_double
        lib.sdfl_compute_statistics.restype = i64
        lib.sdfl_compute_statistics.argtypes = [
            dp, dp, dp, ip, ip, dp, i64, i64, i64, i64, f64, f64, i64, i64,
            dp, dp]
        lib.sdfl_fused_compute_statistics.restype = None
        lib.sdfl_fused_compute_statistics.argtypes = [
            dp, dp, ip, ip, ip, dp, dp, dp, ip, ip, i64, i64, i64, f64, dp,
            i64, i64]
        _lib = lib
        return lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def compute_statistics(overlaps, gt_datas, dt_datas, ignored_gt, ignored_det,
                       dc_bboxes, metric, min_overlap, thresh=0.0,
                       compute_fp=False, compute_angular=False):
    """Single-frame greedy matching (detection_3d.py:1098-1233)."""
    lib = get_lib()
    overlaps = np.ascontiguousarray(overlaps, np.float64)
    gt_datas = np.ascontiguousarray(gt_datas, np.float64).reshape(-1, 6)
    dt_datas = np.ascontiguousarray(dt_datas, np.float64).reshape(-1, 7)
    ignored_gt = np.ascontiguousarray(ignored_gt, np.int64)
    ignored_det = np.ascontiguousarray(ignored_det, np.int64)
    dc_bboxes = np.ascontiguousarray(dc_bboxes, np.float64).reshape(-1, 4)
    num_gt, num_dt, num_dc = len(gt_datas), len(dt_datas), len(dc_bboxes)
    thresholds = np.zeros(max(num_gt, 1), np.float64)
    out = np.zeros(7, np.float64)
    n_thr = lib.sdfl_compute_statistics(
        _dptr(overlaps), _dptr(gt_datas), _dptr(dt_datas),
        _iptr(ignored_gt), _iptr(ignored_det), _dptr(dc_bboxes),
        num_gt, num_dt, num_dc, int(metric), float(min_overlap),
        float(thresh), int(bool(compute_fp)), int(bool(compute_angular)),
        _dptr(thresholds), _dptr(out))
    return {
        "tp": int(out[0]), "fp": int(out[1]), "fn": int(out[2]),
        "error_yaw": out[3], "similarity": out[4],
        "match_degree": out[5], "confidence_error": out[6],
        "thresholds": thresholds[:n_thr].copy(),
    }


def fused_compute_statistics(overlaps, pr, gt_nums, dt_nums, dc_nums,
                             gt_datas, dt_datas, dontcares, ignored_gts,
                             ignored_dets, metric, min_overlap, thresholds,
                             compute_angular_metrics=False):
    """Shard-fused matching over frames x thresholds, accumulating `pr`
    in place (detection_3d.py:1236-1294)."""
    lib = get_lib()
    overlaps = np.ascontiguousarray(overlaps, np.float64)
    pr_c = np.ascontiguousarray(pr, np.float64)
    gt_nums = np.ascontiguousarray(gt_nums, np.int64)
    dt_nums = np.ascontiguousarray(dt_nums, np.int64)
    dc_nums = np.ascontiguousarray(dc_nums, np.int64)
    gt_datas = np.ascontiguousarray(gt_datas, np.float64).reshape(-1, 6)
    dt_datas = np.ascontiguousarray(dt_datas, np.float64).reshape(-1, 7)
    dontcares = np.ascontiguousarray(dontcares, np.float64).reshape(-1, 4)
    ignored_gts = np.ascontiguousarray(ignored_gts, np.int64)
    ignored_dets = np.ascontiguousarray(ignored_dets, np.int64)
    thresholds = np.ascontiguousarray(thresholds, np.float64)
    lib.sdfl_fused_compute_statistics(
        _dptr(overlaps), _dptr(pr_c), _iptr(gt_nums), _iptr(dt_nums),
        _iptr(dc_nums), _dptr(gt_datas), _dptr(dt_datas), _dptr(dontcares),
        _iptr(ignored_gts), _iptr(ignored_dets),
        len(gt_nums), int(gt_nums.sum()), int(metric), float(min_overlap),
        _dptr(thresholds), len(thresholds),
        int(bool(compute_angular_metrics)))
    pr[...] = pr_c
