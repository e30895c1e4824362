"""KITTI/nuScenes evaluation constants.

A copy of sdflabel_tpu/eval/constants.py (reference pipelines/
constants.py): the ontology and the IoU and distance threshold tensors,
laid out [num_metrics, num_thresholds, num_difficulties, num_classes].
"""

import numpy as np

KITTI_CLASS_NAMES = {
    0: "Cyclist",
    1: "Van",
    2: "Car",
    3: "Truck",
    4: "Pedestrian",
    5: "Person_sitting",
    6: "Tram",
}

# [num_difficulties=3, num_classes=7]
KITTI_OVERLAP_MODERATE = np.tile(
    np.array([0.5, 0.7, 0.7, 0.5, 0.5, 0.7, 0.5]), (3, 1)
)
KITTI_OVERLAP_EASY_2D = np.tile(
    np.array([0.5, 0.7, 0.7, 0.5, 0.5, 0.5, 0.5]), (3, 1)
)
KITTI_OVERLAP_EASY_BEV = np.tile(
    np.array([0.25, 0.5, 0.5, 0.25, 0.25, 0.5, 0.5]), (3, 1)
)
KITTI_OVERLAP_EASY_3D = np.tile(
    np.array([0.25, 0.5, 0.5, 0.25, 0.25, 0.5, 0.5]), (3, 1)
)

KITTI_OVERLAPS_2D = np.stack([KITTI_OVERLAP_MODERATE, KITTI_OVERLAP_EASY_2D])
KITTI_OVERLAPS_BEV = np.stack([KITTI_OVERLAP_MODERATE, KITTI_OVERLAP_EASY_BEV])
KITTI_OVERLAPS_3D = np.stack([KITTI_OVERLAP_MODERATE, KITTI_OVERLAP_EASY_3D])

# [metric, threshold-level, difficulty, class]
KITTI_OVERLAP_THRESHOLDS = np.stack(
    [KITTI_OVERLAPS_2D, KITTI_OVERLAPS_BEV, KITTI_OVERLAPS_3D,
     KITTI_OVERLAPS_3D]
)

NU_OVERLAP_MODERATE = np.full((3, 7), 0.5)
NU_OVERLAP_EASY = np.full((3, 7), 1.0)
NU_OVERLAP = np.stack([NU_OVERLAP_MODERATE, NU_OVERLAP_EASY])
NU_OVERLAP_THRESHOLDS = np.stack([NU_OVERLAP] * 4)
