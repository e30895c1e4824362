"""KITTI-protocol 3D detection evaluator (2D/BEV/3D/nuScenes mAP + AOS/AOE).

Counterpart of sdflabel_tpu/eval/detection3d.py (reference
pipelines/detection_3d.py): the 41-point PR sampling, threshold selection,
difficulty cleaning, sharded IoU, greedy matching and mAP integration, in
the same numpy arithmetic. The rotated-IoU matrices come from
ops/rotated_iou.py (torch, on the card by default); the greedy matching
from eval/native.py (C++ through ctypes).
"""

from __future__ import annotations

import math
from enum import IntEnum

import numpy as np
from scipy.spatial.distance import cdist

from sdflabel_tpu_torch.eval import native
from sdflabel_tpu_torch.eval.constants import (
    KITTI_CLASS_NAMES,
    KITTI_OVERLAP_THRESHOLDS,
    NU_OVERLAP_THRESHOLDS,
)
from sdflabel_tpu_torch.ops import rotated_iou as riou


class Metrics(IntEnum):
    BBOX_2D_AP = 0
    BEV_3D_AP = 1
    BBOX_3D_KITTI_AP = 2
    BBOX_3D_NU_AP = 3


class CoordinateFrame(IntEnum):
    LIDAR = 0
    VEHICLE = 1
    CAMERA = 2


def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = 41) -> list[float]:
    """Recall-spaced score thresholds (detection_3d.py:991-1025)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1 / (num_sample_pts - 1.0)
    return thresholds


def clean_kitti_data(gt_anno, dt_anno, current_class, difficulty, id_to_name,
                     coordinate_frame=CoordinateFrame.CAMERA):
    """KITTI difficulty/class filtering (detection_3d.py:871-985)."""
    MAX_OCCLUSION = (0, 1, 2)
    MAX_TRUNCATION = (0.15, 0.3, 0.5)
    MIN_HEIGHT = (40, 25, 25)
    ignored_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = id_to_name[current_class].lower()
    num_valid_gt = 0

    for i in range(len(gt_anno["name"])):
        bbox = gt_anno["bbox"][i]
        gt_name = str(gt_anno["name"][i]).lower()
        height = bbox[3] - bbox[1]
        if gt_name == current_cls_name:
            valid_class = 1
        elif current_cls_name == "pedestrian" and gt_name == "person_sitting":
            valid_class = 0
        elif current_cls_name == "car" and gt_name == "van":
            valid_class = 0
        else:
            valid_class = -1
        ignore = (
            gt_anno["occluded"][i] > MAX_OCCLUSION[difficulty]
            or gt_anno["truncated"][i] > MAX_TRUNCATION[difficulty]
            or height <= MIN_HEIGHT[difficulty]
        ) if ("occluded" in gt_anno and "truncated" in gt_anno) else (
            height <= MIN_HEIGHT[difficulty]
        )
        if valid_class == 1 and not ignore:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif valid_class == 0 or (ignore and valid_class == 1):
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
        if gt_name == "dontcare":
            ignored_bboxes.append(bbox)

    for i in range(len(dt_anno["name"])):
        valid_class = 1 if str(dt_anno["name"][i]).lower() == current_cls_name \
            else -1
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < MIN_HEIGHT[difficulty]:
            ignored_dt.append(1)
        elif valid_class == 1:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)

    return num_valid_gt, ignored_gt, ignored_dt, ignored_bboxes


def difficulty_by_distance(gt_anno, dt_anno, current_class, difficulty,
                           id_to_name,
                           coordinate_frame=CoordinateFrame.LIDAR,
                           max_depth=(30, 80, 150), min_height=20):
    """Depth-binned filtering variant (detection_3d.py:760-868)."""
    ignored_bboxes, ignored_gt, ignored_dt = [], [], []
    current_cls_name = id_to_name[current_class].lower()
    num_valid_gt = 0
    for i in range(len(gt_anno["name"])):
        gt_name = str(gt_anno["name"][i]).lower()
        if coordinate_frame == CoordinateFrame.CAMERA:
            distance = gt_anno["location"][i][2]
        else:
            distance = math.sqrt(
                gt_anno["location"][i][0] ** 2 + gt_anno["location"][i][1] ** 2
            )
        ignore_for_depth = distance > max_depth[difficulty]
        if gt_name == current_cls_name and not ignore_for_depth:
            ignored_gt.append(0)
            num_valid_gt += 1
        elif gt_name == current_cls_name:
            ignored_gt.append(1)
        else:
            ignored_gt.append(-1)
    for i in range(len(dt_anno["name"])):
        height = abs(dt_anno["bbox"][i, 3] - dt_anno["bbox"][i, 1])
        if height < min_height:
            ignored_dt.append(1)
        elif str(dt_anno["name"][i]).lower() == current_cls_name:
            ignored_dt.append(0)
        else:
            ignored_dt.append(-1)
    return num_valid_gt, ignored_gt, ignored_dt, ignored_bboxes


class Detection3DEvaluator:
    """KITTI-style detection evaluation (detection_3d.py:61-243 API)."""

    def __init__(
        self,
        filter_data_fn,
        id_to_name=KITTI_CLASS_NAMES,
        per_class_iou_overlap_thresholds=KITTI_OVERLAP_THRESHOLDS,
        per_class_dist_thresholds=NU_OVERLAP_THRESHOLDS,
        coordinate_frame=CoordinateFrame.LIDAR,
        compute_angular_metrics=True,
        compute_nuscenes=True,
        sample_points=41,
        # Accepted for reference API parity but UNUSED — the reference
        # stores and never reads it either (detection_3d.py:119,121).
        sampling_frequency=1,
        device="cuda",
    ):
        self.filter_data_fn = filter_data_fn
        self.sample_points = sample_points
        self.compute_angular_metrics = compute_angular_metrics
        self.coordinate_frame = coordinate_frame
        self.compute_nuscenes = compute_nuscenes
        self.sampling_frequency = sampling_frequency
        self.id_to_name = id_to_name
        self.name_to_id = {v: n for n, v in id_to_name.items()}
        self.overlap_thresholds = per_class_iou_overlap_thresholds
        self.dist_thresholds = per_class_dist_thresholds
        self.device = device  # where the rotated IoU matrices are computed

    # ------------------------------------------------------------------
    def validate_anno_format(self, gt_annos, dt_annos):
        necessary_keys = ["name", "alpha", "bbox", "dimensions", "location",
                          "rotation_y", "score"]
        for i, (gt, dt) in enumerate(zip(gt_annos, dt_annos)):
            for key in necessary_keys:
                assert key in gt, f"{key} not present in GT {i}"
                assert key in dt, f"{key} not present in prediction {i}"
                if key in ("bbox", "dimensions", "location"):
                    # fail FAST on non-arrays (the reference's gt[key].shape
                    # would too); checking np.asarray copies would let a
                    # list-valued anno pass here and crash deep inside the
                    # sharded matcher instead
                    assert isinstance(gt[key], np.ndarray) and \
                        gt[key].ndim == 2, \
                        f"GT {i} {key} must be a 2D ndarray, got " \
                        f"{type(gt[key]).__name__}"
                    assert isinstance(dt[key], np.ndarray) and \
                        dt[key].ndim == 2, \
                        f"prediction {i} {key} must be a 2D ndarray, got " \
                        f"{type(dt[key]).__name__}"

    def evaluate_detection_3d(self, gt_annos, dt_annos, classes_for_eval=None,
                              difficulties=(0,)):
        # NOTE (reference parity, detection_3d.py:149): difficulty VALUES
        # must be valid axis indices for the cleaning tables, while the
        # threshold tensor below is indexed by POSITION in `difficulties`
        # (all_thresholds[:, ld, m]) — with a per-difficulty (non-tiled)
        # threshold table, pass difficulties in full (0, 1, 2) order. The
        # bundled KITTI tables tile identical thresholds across the axis.
        assert max(difficulties) < self.overlap_thresholds.shape[2]
        self.validate_anno_format(gt_annos, dt_annos)

        class_ids = []
        assert isinstance(classes_for_eval, (list, tuple))
        for c in classes_for_eval:
            if c not in self.name_to_id:
                raise KeyError(f"{c} is not a valid class in the ontology")
            class_ids.append(self.name_to_id[c])

        if self.compute_angular_metrics:
            for anno in dt_annos:
                assert "rotation_y" in anno and "alpha" in anno

        overlap_thresholds = self.overlap_thresholds[:, :, :, class_ids]
        dist_thresholds = (
            self.dist_thresholds[:, :, :, class_ids]
            if self.compute_nuscenes else None
        )

        (mAPbbox, mAPbev, mAP3d, mAPaoe_iou, mAPaoe_dist, mAPaos_iou,
         mAPaos_dist, mAPnu3d, bbox_2d_pr, bev_pr, bbox_3d_kitti_pr,
         bbox_3d_nu_pr) = self.do_eval(
            gt_annos, dt_annos, class_ids, difficulties, overlap_thresholds,
            dist_thresholds,
        )

        formatted = ""
        for k, difficulty in enumerate(difficulties):
            formatted += "============================\n"
            formatted += f"Difficuty Level {difficulty}:\n"
            formatted += "============================\n"
            for j, curcls in enumerate(class_ids):
                if self.compute_nuscenes:
                    for i in range(dist_thresholds.shape[1]):
                        formatted += f"{self.id_to_name[curcls]} AP: \n"
                        formatted += "NuScenes 3D   @ {:.2f}: {:.4f}\n".format(
                            dist_thresholds[Metrics.BBOX_3D_NU_AP, i, k, j],
                            mAPnu3d[j, k, i],
                        )
                        if self.compute_angular_metrics:
                            formatted += "AOE_dist  @ {:.2f}: {:.2f}\n".format(
                                dist_thresholds[Metrics.BBOX_3D_NU_AP, i, k, j],
                                mAPaoe_dist[j, k, i],
                            )
                else:
                    for i in range(overlap_thresholds.shape[1]):
                        formatted += f"{self.id_to_name[curcls]} AP: \n"
                        formatted += "Bbox @ {:.2f}: {:.4f}\n".format(
                            overlap_thresholds[Metrics.BBOX_2D_AP, i, k, j],
                            mAPbbox[j, k, i],
                        )
                        formatted += "BEV  @ {:.2f}: {:.4f}\n".format(
                            overlap_thresholds[Metrics.BEV_3D_AP, i, k, j],
                            mAPbev[j, k, i],
                        )
                        formatted += "3D   @ {:.2f}: {:.4f}\n".format(
                            overlap_thresholds[Metrics.BBOX_3D_KITTI_AP, i, k, j],
                            mAP3d[j, k, i],
                        )
                        if self.compute_angular_metrics:
                            formatted += "AOE_iou  @ {:.2f}: {:.2f}\n".format(
                                overlap_thresholds[Metrics.BBOX_3D_KITTI_AP, i, k, j],
                                mAPaoe_iou[j, k, i],
                            )
                            formatted += "AOS_iou  @ {:.2f}: {:.2f}\n".format(
                                overlap_thresholds[Metrics.BBOX_3D_KITTI_AP, i, k, j],
                                mAPaos_iou[j, k, i],
                            )

        result = {}
        for name, metric in zip(
            ["Box2DAP", "BevAP", "Box3DAP", "AoeAP_iou", "AoeAP_dist",
             "AosAP_iou", "AosAP_dist", "Box3DAP_Nu"],
            [mAPbbox, mAPbev, mAP3d, mAPaoe_iou, mAPaoe_dist, mAPaos_iou,
             mAPaos_dist, mAPnu3d],
        ):
            if metric is not None:
                result[name] = metric
        for name, metric in zip(
            ["bbox_2d_pre_curves", "bev_pre_curves",
             "bbox_3d_kitti_pre_curves", "bbox_3d_nu_pre_curves"],
            [bbox_2d_pr, bev_pr, bbox_3d_kitti_pr, bbox_3d_nu_pr],
        ):
            if metric is not None:
                result[name] = metric
        return formatted, result

    # ------------------------------------------------------------------
    def do_eval(self, gt_annos, dt_annos, class_ids, difficulties,
                overlap_thresholds, dist_thresholds):
        bbox_2d_pr = self.eval_metric(
            gt_annos, dt_annos, class_ids, difficulties, Metrics.BBOX_2D_AP,
            overlap_thresholds, dist_thresholds,
        )
        mAP_bbox = self.get_mAP(bbox_2d_pr["precision"], bbox_2d_pr["recall"])

        bev_pr = self.eval_metric(
            gt_annos, dt_annos, class_ids, difficulties, Metrics.BEV_3D_AP,
            overlap_thresholds, dist_thresholds,
        )
        mAP_bev = self.get_mAP(bev_pr["precision"], bev_pr["recall"])

        mAP_3d = mAPnu_3d = mAP_aos_iou = mAP_aos_dist = None
        mAP_aoe_iou = mAP_aoe_dist = kitti_pr = nu_pr = None

        if self.compute_nuscenes:
            nu_pr = self.eval_metric(
                gt_annos, dt_annos, class_ids, difficulties,
                Metrics.BBOX_3D_NU_AP, overlap_thresholds, dist_thresholds,
                self.compute_angular_metrics,
            )
            mAPnu_3d = self.get_mAP(nu_pr["precision"], nu_pr["recall"])
            if self.compute_angular_metrics:
                mAP_aoe_dist = self.get_mAP(nu_pr["orientation_aoe"],
                                            nu_pr["recall"])
                mAP_aos_dist = self.get_mAP(nu_pr["orientation_aos"],
                                            nu_pr["recall"])
        else:
            kitti_pr = self.eval_metric(
                gt_annos, dt_annos, class_ids, difficulties,
                Metrics.BBOX_3D_KITTI_AP, overlap_thresholds, dist_thresholds,
                self.compute_angular_metrics,
            )
            mAP_3d = self.get_mAP(kitti_pr["precision"], kitti_pr["recall"])
            if self.compute_angular_metrics:
                mAP_aoe_iou = self.get_mAP(kitti_pr["orientation_aoe"],
                                           kitti_pr["recall"])
                mAP_aos_iou = self.get_mAP(kitti_pr["orientation_aos"],
                                           kitti_pr["recall"])

        return (mAP_bbox, mAP_bev, mAP_3d, mAP_aoe_iou, mAP_aoe_dist,
                mAP_aos_iou, mAP_aos_dist, mAPnu_3d, bbox_2d_pr, bev_pr,
                kitti_pr, nu_pr)

    # ------------------------------------------------------------------
    def eval_metric(self, gt_annos, dt_annos, class_ids, difficulties, metric,
                    overlap_thresholds, dist_thresholds,
                    compute_angular_metrics=False, num_shards=50):
        assert len(gt_annos) == len(dt_annos)
        shards = self.get_shards(len(gt_annos), num_shards)

        overlaps, overlaps_by_shard, total_gt_num, total_dt_num = \
            self.calculate_match_degree_sharded(gt_annos, dt_annos, metric,
                                                num_shards)

        if metric == Metrics.BBOX_3D_NU_AP:
            all_thresholds = -1.0 * dist_thresholds[metric, :, :, :]
        else:
            all_thresholds = overlap_thresholds[metric, :, :, :]

        num_minoverlap = len(all_thresholds)
        num_classes = len(class_ids)
        num_difficulties = len(difficulties)
        shape = [num_classes, num_difficulties, num_minoverlap,
                 self.sample_points]
        precision = np.zeros(shape)
        recall = np.zeros(shape)
        orientation_aoe = np.zeros(shape)
        orientation_aos = np.zeros(shape)
        tp_mean_error = np.zeros(shape)
        tp_mean_confidence_error = np.zeros(shape)

        for m, current_class in enumerate(class_ids):
            for ld, difficulty in enumerate(difficulties):
                (gt_data_list, dt_data_list, ignored_gts, ignored_dets,
                 dontcares, ignores_per_sample, total_num_valid_gt) = \
                    self.prepare_data(gt_annos, dt_annos, current_class,
                                      difficulty)
                for k, min_overlap in enumerate(all_thresholds[:, ld, m]):
                    thresholds_list = []
                    for i in range(len(gt_annos)):
                        res = native.compute_statistics(
                            overlaps[i], gt_data_list[i], dt_data_list[i],
                            ignored_gts[i], ignored_dets[i], dontcares[i],
                            int(metric), min_overlap=min_overlap,
                            thresh=0.0, compute_fp=False,
                        )
                        thresholds_list += res["thresholds"].tolist()
                    thresholds = np.array(get_thresholds(
                        np.array(thresholds_list), total_num_valid_gt,
                        self.sample_points,
                    ))
                    pr = np.zeros([len(thresholds), 7])
                    idx = 0
                    for j, n_samp in enumerate(shards):
                        gt_part = np.concatenate(
                            gt_data_list[idx:idx + n_samp], 0)
                        dt_part = np.concatenate(
                            dt_data_list[idx:idx + n_samp], 0)
                        dc_part = np.concatenate(
                            dontcares[idx:idx + n_samp], 0)
                        ig_dets = np.concatenate(
                            ignored_dets[idx:idx + n_samp], 0)
                        ig_gts = np.concatenate(
                            ignored_gts[idx:idx + n_samp], 0)
                        native.fused_compute_statistics(
                            overlaps_by_shard[j], pr,
                            total_gt_num[idx:idx + n_samp],
                            total_dt_num[idx:idx + n_samp],
                            ignores_per_sample[idx:idx + n_samp],
                            gt_part, dt_part, dc_part, ig_gts, ig_dets,
                            int(metric), min_overlap=min_overlap,
                            thresholds=thresholds,
                            compute_angular_metrics=compute_angular_metrics,
                        )
                        idx += n_samp

                    with np.errstate(divide="ignore", invalid="ignore"):
                        for i in range(len(thresholds)):
                            recall[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 2])
                            precision[m, ld, k, i] = pr[i, 0] / (pr[i, 0] + pr[i, 1])
                            tp_mean_error[m, ld, k, i] = pr[i, 5] / pr[i, 0]
                            tp_mean_confidence_error[m, ld, k, i] = \
                                pr[i, 6] / pr[i, 0]
                            if metric != Metrics.BBOX_3D_NU_AP:
                                tp_mean_error[m, ld, k, i] = abs(
                                    1.0 - tp_mean_error[m, ld, k, i])
                            if compute_angular_metrics:
                                orientation_aoe[m, ld, k, i] = \
                                    pr[i, 3] / (pr[i, 0] + pr[i, 1])
                                orientation_aos[m, ld, k, i] = \
                                    pr[i, 4] / (pr[i, 0] + pr[i, 1])
        return {
            "recall": recall,
            "precision": precision,
            "orientation_aoe": orientation_aoe,
            "orientation_aos": orientation_aos,
            "tp_mean_error": tp_mean_error,
            "tp_mean_confidence_error": tp_mean_confidence_error,
        }

    # ------------------------------------------------------------------
    def calculate_match_degree_sharded(self, gt_annos, dt_annos, metric,
                                       num_shards):
        assert len(gt_annos) == len(dt_annos)
        total_dt_num = np.stack([len(a["name"]) for a in dt_annos], 0)
        total_gt_num = np.stack([len(a["name"]) for a in gt_annos], 0)

        overlaps_by_shard = []
        sample_idx = 0
        shards = self.get_shards(len(gt_annos), num_shards)
        camera = self.coordinate_frame == CoordinateFrame.CAMERA

        for n_samp in shards:
            gt_part = gt_annos[sample_idx:sample_idx + n_samp]
            dt_part = dt_annos[sample_idx:sample_idx + n_samp]

            if metric == Metrics.BBOX_2D_AP:
                gt_boxes = np.concatenate([a["bbox"] for a in gt_part], 0)
                dt_boxes = np.concatenate([a["bbox"] for a in dt_part], 0)
                shard_match = riou.image_box_overlap(dt_boxes, gt_boxes,
                                                     device=self.device)
            elif metric == Metrics.BEV_3D_AP:
                cols = [0, 2] if camera else [0, 1]
                def bev(ann):
                    loc = np.concatenate([a["location"][:, cols] for a in ann], 0)
                    dims = np.concatenate([a["dimensions"][:, cols] for a in ann], 0)
                    rots = np.concatenate([a["rotation_y"] for a in ann], 0)
                    return np.concatenate([loc, dims, rots[..., None]], 1)
                shard_match = riou.rotate_iou(
                    bev(dt_part), bev(gt_part),
                    device=self.device).astype(np.float64)
            elif metric == Metrics.BBOX_3D_KITTI_AP:
                def full(ann):
                    loc = np.concatenate([a["location"] for a in ann], 0)
                    dims = np.concatenate([a["dimensions"] for a in ann], 0)
                    rots = np.concatenate([a["rotation_y"] for a in ann], 0)
                    return np.concatenate([loc, dims, rots[..., None]], 1)
                dt_boxes, gt_boxes = full(dt_part), full(gt_part)
                shard_match = self.box_3d_overlap(dt_boxes, gt_boxes) \
                    .astype(np.float64)
            elif metric == Metrics.BBOX_3D_NU_AP:
                cols = [0, 2] if camera else [0, 1]
                loc_gt = np.concatenate([a["location"][:, cols] for a in gt_part], 0)
                loc_dt = np.concatenate([a["location"][:, cols] for a in dt_part], 0)
                shard_match = -1 * cdist(loc_dt, loc_gt)
            else:
                raise ValueError("Unknown metric")

            overlaps_by_shard.append(shard_match)
            sample_idx += n_samp

        overlaps = []
        sample_idx = 0
        for j, n_samp in enumerate(shards):
            gt_num_idx, dt_num_idx = 0, 0
            for i in range(n_samp):
                gt_box_num = total_gt_num[sample_idx + i]
                dt_box_num = total_dt_num[sample_idx + i]
                overlaps.append(
                    overlaps_by_shard[j][
                        dt_num_idx:dt_num_idx + dt_box_num,
                        gt_num_idx:gt_num_idx + gt_box_num,
                    ]
                )
                gt_num_idx += gt_box_num
                dt_num_idx += dt_box_num
            sample_idx += n_samp
        return overlaps, overlaps_by_shard, total_gt_num, total_dt_num

    def get_shards(self, num, num_shards):
        assert num_shards > 0
        per = num // num_shards
        rem = num % num_shards
        full = num_shards * (per > 0)
        if rem == 0:
            return [per] * full
        return [per] * full + [rem]

    def bev_box_overlap(self, boxes, qboxes, criterion=-1):
        return riou.rotate_iou(boxes, qboxes, criterion, device=self.device)

    def box_3d_overlap(self, boxes, qboxes, criterion=-1):
        camera = self.coordinate_frame == CoordinateFrame.CAMERA
        cols = [0, 2, 3, 5, 6] if camera else [0, 1, 3, 4, 6]
        rinc = riou.rotate_iou(boxes[:, cols], qboxes[:, cols], 2,
                               device=self.device)
        return riou.d3_box_overlap(boxes, qboxes, rinc, criterion, camera,
                                   device=self.device)

    def prepare_data(self, gt_annos, dt_annos, current_class, difficulty):
        gt_list, dt_list = [], []
        ignores_per_sample = []
        ignored_gts, ignored_dets, dontcares = [], [], []
        total_num_valid_gt = 0
        for gt_anno, dt_anno in zip(gt_annos, dt_annos):
            num_valid_gt, ignored_gt, ignored_det, ignored_bboxes = \
                self.filter_data_fn(gt_anno, dt_anno, current_class,
                                    difficulty, self.id_to_name,
                                    self.coordinate_frame)
            ignored_gts.append(np.array(ignored_gt, np.int64))
            ignored_dets.append(np.array(ignored_det, np.int64))
            if len(ignored_bboxes) == 0:
                ignored_bboxes = np.zeros((0, 4), np.float64)
            else:
                ignored_bboxes = np.stack(ignored_bboxes, 0).astype(np.float64)
            ignores_per_sample.append(ignored_bboxes.shape[0])
            dontcares.append(ignored_bboxes)
            total_num_valid_gt += num_valid_gt
            gt_list.append(np.concatenate([
                np.asarray(gt_anno["bbox"], np.float64),
                np.asarray(gt_anno["rotation_y"], np.float64)[..., None],
                np.asarray(gt_anno["alpha"], np.float64)[..., None],
            ], 1))
            dt_list.append(np.concatenate([
                np.asarray(dt_anno["bbox"], np.float64),
                np.asarray(dt_anno["rotation_y"], np.float64)[..., None],
                np.asarray(dt_anno["alpha"], np.float64)[..., None],
                np.asarray(dt_anno["score"], np.float64)[..., None],
            ], 1))
        ignores_per_sample = np.stack(ignores_per_sample, 0)
        return (gt_list, dt_list, ignored_gts, ignored_dets, dontcares,
                ignores_per_sample, total_num_valid_gt)

    def get_mAP(self, precision, recall):
        """41-point interpolated mAP (detection_3d.py:711-740)."""
        precisions = []
        recall_spacing = [1.0 / (self.sample_points - 1) * i
                          for i in range(1, self.sample_points)]
        for r in recall_spacing:
            precisions_above = (recall >= r) * precision
            precisions.append(precisions_above.max(axis=3))
        return 100.0 * sum(precisions) / (self.sample_points - 1)
